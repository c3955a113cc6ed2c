"""The port's data x tensor-parallel forward (``parallel/api.py`` over the
explicit collectives of ``models/model.py`` / ``models/layers.py``)
against the JAX package's forward, on the same numpy weights and tokens.

One world of 4 gloo ranks on the CPU (``tests/torch_world.py``) is
spawned for the module; each case runs on every rank over a 4-rank mesh
(data x model = 1 x 4, 2 x 2 or 4 x 1) and every rank must return the
full-batch logits within 1e-5 of the reference (float32).  The cases:
llama-tiny with KV heads that do not divide over 'model' (2 KV heads,
tp 4: local Q head j of rank r reads KV head (r + j) // 2), gpt2-tiny and
neox-tiny with random biases (row-parallel ``bo``/``b_out`` added once,
after the sum), a vocabulary that does not divide (replicated, no
gather), an MoE model (rows never split over 'data'), and a prefill into a
contiguous cache followed by a decode step (each step's K/V gathered over
'data' into every rank's cache).
"""

import numpy as np
import pytest
import torch

import jax

import torch_mesh_cases as cases
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from torch_world import World

MESHES = [(1, 4), (2, 2), (4, 1)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("parallel_world")))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name, seed=0, biases=False, **overrides):
    cfg_j = jax_preset(name, **overrides)
    cfg_t = get_preset(name, **overrides)
    pj = jax.tree.map(np.asarray, jm.init_params(jax.random.key(seed), cfg_j))
    if biases:
        rng = np.random.default_rng(seed)

        def perturb(tree, path=""):
            if isinstance(tree, dict):
                return {k: perturb(v, f"{path}/{k}") for k, v in tree.items()}
            if path.rsplit("/", 1)[-1] in ("bq", "bk", "bv", "bo", "b_in",
                                            "b_out"):
                return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(
                    tree.dtype)
            return tree

        pj = perturb(pj)
    return cfg_j, cfg_t, pj


def _tokens(cfg, b=4, t=7, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


MODELS = {
    "llama": dict(name="llama-tiny", vocab_size=512),
    "gpt2": dict(name="gpt2-tiny", biases=True),
    "neox": dict(name="neox-tiny", biases=True),
    "odd_vocab": dict(name="llama-tiny", vocab_size=258),
    "moe": dict(name="moe-tiny"),
}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}tp{m[1]}")
@pytest.mark.parametrize("key", sorted(MODELS))
def test_forward_logits_match_the_reference(world, key, mesh):
    spec = dict(MODELS[key])
    cfg_j, cfg_t, pj = _model(spec.pop("name"), **spec)
    world.run(cases.load, key, cfg_t, pj)
    toks = _tokens(cfg_t)
    want = np.asarray(jm.forward(pj, cfg_j, toks)[0])
    outs = world.run(cases.forward_logits, key, *mesh, toks)
    for out in outs:
        np.testing.assert_allclose(out["logits"], want, rtol=0, atol=1e-5)
    if mesh[1] > 1:
        assert all(o["collectives"] > 0 for o in outs)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}tp{m[1]}")
@pytest.mark.parametrize("key", ["llama", "gpt2"])
def test_prefill_and_decode_step_match_one_device(world, key, mesh):
    """A prefill into the mesh's contiguous cache (every rank its KV heads
    of every row) and one per-row decode step through the ragged decode
    attention: logits within 1e-5 of the single-device port, which the
    reference holds (tests/test_torch_model.py)."""
    spec = dict(MODELS[key])
    cfg_j, cfg_t, pj = _model(spec.pop("name"), **spec)
    world.run(cases.load, key, cfg_t, pj)
    toks = _tokens(cfg_t)
    params = params_from_numpy(pj, cfg_t, device="cpu")
    b, t = toks.shape
    cache = tm.init_cache(cfg_t, b, t + 4)
    tt = torch.as_tensor(toks)
    logits, cache = tm.forward(params, cfg_t, tt, cache=cache, cache_index=0)
    ci = torch.full((b,), t, dtype=torch.int32)
    step, _ = tm.forward(params, cfg_t, logits[:, -1].argmax(-1)[:, None],
                         positions=ci[:, None], cache=cache, cache_index=ci)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm.forward(pj, cfg_j, toks)[0]),
                               rtol=0, atol=1e-5)
    for out in world.run(cases.forward_logits, key, *mesh, toks,
                         with_cache=True):
        np.testing.assert_allclose(out["logits"], logits.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(out["step"], step.numpy(), rtol=0,
                                   atol=1e-5)
        want_heads = (cfg_t.num_kv_heads // mesh[1]
                      if cfg_t.num_kv_heads % mesh[1] == 0
                      else cfg_t.num_kv_heads)
        assert out["cache_heads"] == want_heads


def test_rank_blocks_are_the_local_shapes(world):
    cfg_j, cfg_t, pj = _model("llama-tiny", vocab_size=512)
    world.run(cases.load, "shapes", cfg_t, pj)
    shapes = world.run(cases.local_shapes, "shapes", 2, 2)
    for s in shapes:
        assert s["/blocks/attn/wq"] == (4, 64, 2, 16)
        assert s["/blocks/attn/wk"] == (4, 64, 1, 16)
        assert s["/blocks/attn/wo"] == (4, 2, 16, 64)
        assert s["/blocks/mlp/w_gate"] == (4, 64, 88)
        assert s["/blocks/mlp/w_down"] == (4, 88, 64)
        assert s["/embed/wte"] == (256, 64)
        assert s["/lm_head/w"] == (64, 256)
        assert s["/final_norm/scale"] == (64,)


def test_world_is_a_gloo_group(world):
    info = world.run(cases.rank_info)
    assert [i["rank"] for i in info] == [0, 1, 2, 3]
    assert {i["backend"] for i in info} == {"gloo"}
