"""The port's pipeline (``parallel/pipeline.py``: the GPipe schedule and
the wavefront decode, through ``parallel/api.py``'s pipelined
``ParallelModel``) against the JAX package's, on the same numpy weights
and inputs: the counterpart of tests/parallel/test_parallel.py's pipeline
cases.

The JAX side runs on the conftest's host CPU devices (a mesh of 2 for
pipe=2, of 4 for pipe=2 x model=2 and data=2 x pipe=2); the port side on
spawned gloo worlds of 2 and 4 ranks (``tests/torch_world.py``), one
process a stage, each case run on every rank.  Activations and caches are
held to 1e-5 (float32, as tests/test_torch_parallel.py); generated tokens
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.parallel import pipeline as jpl
from distributed_llms_tpu.runtime import generate as jgen
from distributed_llms_tpu.runtime.tokenizer import pad_batch
from distributed_llms_tpu_torch.checkpoint.quantize import quantize
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.core.mesh import build_mesh
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.parallel import api as tapi
from distributed_llms_tpu_torch.parallel import pipeline as tpl
from torch_world import World

ATOL = 1e-5
ROWS = [[7, 1, 9], [4, 4, 4, 4, 4, 4], [100, 3, 5, 2], [9, 8, 7, 6, 5]]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("pipe_world2")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("pipe_world4")))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODELS = {
    "gpt2": ("gpt2-tiny", {}),
    "llama": ("llama-tiny", {"vocab_size": 512}),
    "window": ("llama-tiny", {"vocab_size": 512, "sliding_window": 4}),
}


def _model(key, *worlds):
    """(JAX config, port config, numpy params) of ``key``, loaded on the
    ranks of ``worlds``."""
    name, kw = MODELS[key]
    cfg_j, cfg_t = jax_preset(name, **kw), get_preset(name, **kw)
    pj = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), cfg_j))
    for w in worlds:
        w.run(cases.load, key, cfg_t, pj)
    return cfg_j, cfg_t, pj


def _jpm(cfg_j, microbatches, **axes):
    mesh = JMeshConfig(**axes)
    return japi.make_parallel_model(cfg_j, mesh, num_microbatches=microbatches,
                                    devices=jax.devices()[:mesh.num_devices])


def _reference_tokens(cfg_j, pj, microbatches, n_new, eos_id=-1, **axes):
    """JAX generate_tokens through the pipelined mesh's forward, cache and
    wavefront decode."""
    arr, lens = pad_batch(ROWS, pad_id=0)
    pm = _jpm(cfg_j, microbatches, **axes)
    out = jgen.generate_tokens(
        pm.shard_params(pj), cfg_j, jnp.asarray(arr), jnp.asarray(lens),
        jax.random.key(0), max_new_tokens=n_new, eos_id=eos_id, pad_id=0,
        forward_fn=pm.as_forward_fn(), make_cache=pm.as_make_cache(),
        decode_fn=pm.as_decode_fn())
    return np.asarray(out).tolist(), arr, lens


# -- staging ---------------------------------------------------------------

def test_stage_split_round_trip_and_partition():
    """split_stages / merge_stages round-trip (a quantized leaf's codes
    and scales alike) and equal the reference's; a stage's placement
    holds its layers and its end of the head."""
    from distributed_llms_tpu_torch.parallel import stages

    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 8, 32)).astype(np.float32)
    tree = {"a": {"w": torch.from_numpy(w)},
            "q": quantize(torch.from_numpy(w), bits=4, block=16)}
    staged = tpl.split_stages(tree, 2)
    assert tuple(staged["a"]["w"].shape) == (2, 2, 8, 32)
    np.testing.assert_array_equal(
        staged["a"]["w"].numpy(),
        np.asarray(jpl.split_stages({"w": jnp.asarray(w)}, 2)["w"]))
    assert tuple(staged["q"].data.shape) == (2, 2, 4, 32)
    back = tpl.merge_stages(staged)
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert torch.equal(back["q"].data, tree["q"].data)
    assert torch.equal(back["q"].scale, tree["q"].scale)
    with pytest.raises(ValueError, match="not divisible by stages 3"):
        tpl.split_stages(tree, 3)
    a = stages.partition_contiguous([10, 1, 1, 10, 1, 1, 10, 2], 3)
    assert a.boundaries == (0, 3, 6, 8) and a.stage_of(7) == 2

    cfg = get_preset("llama-tiny", vocab_size=512)
    from distributed_llms_tpu_torch.models.model import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0))
    for r in range(2):
        mcfg = MeshConfig(pipe=2)
        pm = tapi.make_parallel_model(cfg, mcfg, mesh=build_mesh(
            mcfg, rank=r, world_size=2))
        local = pm.shard_params(params)
        assert sorted(local) == (["blocks", "embed"] if r == 0
                                 else ["blocks", "final_norm", "lm_head"])
        assert torch.equal(local["blocks"]["attn"]["wq"],
                           params["blocks"]["attn"]["wq"][2 * r:2 * r + 2])


# -- the GPipe schedule ------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_pipeline_blocks_match_the_reference(world2, cached):
    cfg_j, cfg_t, pj = _model("llama", world2)
    b, t, s_len, m = 4, 5, 8, 2
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (b, t))
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    x = np.asarray(jm.embed(pj, cfg_j, jnp.asarray(toks), jnp.asarray(pos)))
    pm = _jpm(cfg_j, m, pipe=2)
    staged = pm.shard_params(pj)
    kw = {}
    if cached:
        c = pm.init_cache(b, s_len)
        kw = dict(cache_k=c.k, cache_v=c.v, cache_index=jnp.int32(0))
    y, caches = jpl.pipeline_blocks(pm.mesh, cfg_j, staged["blocks"],
                                    jnp.asarray(x), jnp.asarray(pos), m, **kw)
    outs = world2.run(cases.pipe_blocks, "llama", m, x, pos,
                      cache_len=s_len if cached else None)
    assert [o["stage"] for o in outs] == [0, 1]
    assert outs[0]["y"] is None
    np.testing.assert_allclose(outs[1]["y"], np.asarray(y), rtol=0, atol=ATOL)
    for o in outs:
        # M + P - 1 ticks, a ring shift between two.
        assert o["shifts"] == o["ticks"] - 1
        if cached:
            s = o["stage"]
            np.testing.assert_allclose(o["k"], np.asarray(caches[0])[s],
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(o["v"], np.asarray(caches[1])[s],
                                       rtol=0, atol=ATOL)


# -- the wavefront decode ----------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_wavefront_decode_is_token_exact(world2, microbatches):
    """M below, at and above P: tokens equal to the reference's pipelined
    generate_tokens(decode_fn=...), on both ranks."""
    cfg_j, _, pj = _model("gpt2", world2)
    want, arr, lens = _reference_tokens(cfg_j, pj, microbatches, 5, pipe=2)
    for out in world2.run(cases.pipe_generate, "gpt2", 1, 2, 1, microbatches,
                          arr, lens, 5):
        assert out["tokens"] == want
        q = max(microbatches, 2)
        # The prefill's M + P - 1 ticks, then (N-1) Q + M + P - 1.
        ticks = (microbatches + 1) + (4 * q + microbatches + 1)
        assert out["shifts"] == ticks - 2


def test_wavefront_decode_freezes_rows_at_eos(world2):
    cfg_j, _, pj = _model("gpt2", world2)
    plain, arr, lens = _reference_tokens(cfg_j, pj, 2, 6, pipe=2)
    eos = int(plain[0][1])  # a token greedy decoding emits
    want, _, _ = _reference_tokens(cfg_j, pj, 2, 6, eos_id=eos, pipe=2)
    assert eos in want[0] and 0 in want[0]  # frozen, then pad-filled
    for out in world2.run(cases.pipe_generate, "gpt2", 1, 2, 1, 2, arr, lens,
                          6, eos_id=eos):
        assert out["tokens"] == want


def test_wavefront_decode_windows_by_key_position(world2):
    """A sliding window of 4 under the right-padded layout: the stage's
    mask reads each slot's true position (kpos), past the window."""
    cfg_j, _, pj = _model("window", world2)
    want, arr, lens = _reference_tokens(cfg_j, pj, 2, 7, pipe=2)
    for out in world2.run(cases.pipe_generate, "window", 1, 2, 1, 2, arr,
                          lens, 7):
        assert out["tokens"] == want


def test_sampled_wavefront_agrees_across_ranks(world2):
    """Sampling draws on the last stage; every rank returns its bank."""
    _, _, _ = _model("gpt2", world2)
    arr, lens = pad_batch(ROWS, pad_id=0)
    outs = world2.run(cases.pipe_generate, "gpt2", 1, 2, 1, 2, arr, lens, 6,
                      temperature=0.8, top_k=50)
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert np.asarray(outs[0]["tokens"]).shape == (4, 6)


@pytest.mark.parametrize("axes", [dict(pipe=2, model=2), dict(data=2, pipe=2)],
                         ids=["pp2tp2", "dp2pp2"])
def test_wavefront_decode_composes_with_model_and_data(world4, axes):
    cfg_j, _, pj = _model("gpt2", world4)
    want, arr, lens = _reference_tokens(cfg_j, pj, 2, 5, **axes)
    for out in world4.run(cases.pipe_generate, "gpt2", axes.get("data", 1),
                          2, axes.get("model", 1), 2, arr, lens, 5):
        assert out["tokens"] == want


# -- rejections --------------------------------------------------------------

def test_pipelined_meshes_refuse_batching_and_paged_decode():
    from distributed_llms_tpu_torch.models.model import init_params
    from distributed_llms_tpu_torch.runtime.batcher import ContinuousBatcher

    cfg = get_preset("llama-tiny", vocab_size=512)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mcfg = MeshConfig(pipe=2, model=4)
    pm = tapi.make_parallel_model(cfg, mcfg, mesh=build_mesh(
        mcfg, rank=0, world_size=8))
    with pytest.raises(ValueError, match="data/tensor-parallel"):
        ContinuousBatcher(cfg, params, parallel=pm, batch_slots=2, max_len=32)
    with pytest.raises(ValueError, match="data/tensor-parallel"):
        ContinuousBatcher(cfg, params, parallel=pm, batch_slots=2, max_len=64,
                          paged_pages=16, page_size=16)
    with pytest.raises(NotImplementedError, match="contiguous caches"):
        pm.forward(params, torch.zeros((2, 1), dtype=torch.long),
                   kv_tables=torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="cannot combine"):
        tapi.make_parallel_model(cfg, MeshConfig(pipe=2, seq=2), mesh=build_mesh(
            MeshConfig(pipe=2, seq=2), rank=0, world_size=4))
    # Training on a pipelined mesh is the port's next slice.
    from distributed_llms_tpu_torch.runtime.train import Trainer

    with pytest.raises(NotImplementedError,
                       match="pipelined and sequence-parallel training"):
        Trainer(cfg, parallel=pm)


def test_server_refuses_a_pipelined_mesh_before_joining():
    """dlt-serve-torch serves through the batcher, which refuses a
    pipelined mesh: the server refuses before it joins the group."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.config import load_config

    for axis in ("pipe", "seq"):
        cfg = load_config(None, [f"mesh.{axis}=2",
                                 "cluster.num_processes=2"])
        with pytest.raises(ValueError, match="no pipe/seq axes"):
            serve_main._join_mesh(None, cfg)
