"""The port's expert axis (expert-parallel MoE) against the JAX package's,
on the CPU: the counterparts of tests/models/test_moe.py's expert-parallel
case and of the reference's mesh batcher on ``MeshConfig(expert=...)``.

The reference runs on its CPU fake mesh (tests/conftest.py); the port on
worlds of spawned gloo ranks (``torch_world.py``: 2, 3 and 4 ranks), each
rank fed the same inputs.  moe-tiny (2 layers, d_model 64, 4 experts top
2, float32), vocab 512, weights from the reference's ``init_params``.

- The forward's logits and MoE term at ``expert=2``, ``(data=2,
  expert=2)`` and ``(model=2, expert=2)`` against the reference's
  ``make_parallel_model`` forward (atol = rtol = 1e-5); at ``expert=2``
  and ``(data=2, expert=2)`` equal to the port's one-device forward to the
  bit (each claim's row is non-zero on one rank only, so the combine over
  'expert' is exact).  Each rank holds its block of the experts and takes
  one combine a layer over its 'expert' line.
- The replicated fallback: at ``expert=3`` the 4 experts do not divide,
  the rule keeps them whole, and no combine runs: the same output as one
  device, not three times it.
- The paged and the contiguous ``ContinuousBatcher`` at ``expert=2``: the
  greedy streams of the reference's batcher on ``MeshConfig(expert=2)``,
  under the same ``overlap`` (junk rows claim expert capacity).
- An int4 store served with ``serve_quantized``: at ``expert=2`` and at
  ``expert=4`` (one expert a rank) each rank's expert stacks stay
  ``QuantizedTensor`` cut along ``E`` (their int4 pairs run along ``D``
  or ``F``, never along ``E``); a legacy store (pairs along the last
  axis) at ``model=2``: ``w_gate`` and ``w_up`` cannot cut their last
  axis, stay whole on every rank, and each rank rehydrates its block.
  The streams equal the reference's mesh batcher's over the reference
  engine's quantized weights placed on the same mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_expert_cases as cases
from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.core.config import RuntimeConfig as JRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from torch_world import World

TOL = dict(atol=1e-5, rtol=1e-5)
MESHES = {"ep2": {"expert": 2}, "dp2ep2": {"data": 2, "expert": 2},
          "tp2ep2": {"model": 2, "expert": 2}}
KW = dict(batch_slots=3, max_len=96, chunk_steps=4)
PAGED = dict(KW, paged_pages=24, page_size=16, prefix_cache=True)
BUDGETS = [10, 7, 10, 6, 9, 8]


@pytest.fixture(scope="module")
def moe():
    cfg_j = jax_preset("moe-tiny", vocab_size=512)
    cfg_t = get_preset("moe-tiny", vocab_size=512)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    pn = jax.tree.map(np.asarray, pj)
    return cfg_j, cfg_t, pj, pn


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, moe):
    """One world of each size, spawned on first use."""
    made: dict = {}

    def get(n):
        if n not in made:
            w = World(n, str(tmp_path_factory.mktemp(f"expert_world{n}")))
            w.run(cases.load, "moe", moe[1], moe[3])
            made[n] = w
        return made[n]

    yield get
    for w in made.values():
        w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _size(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def _jpm(cfg_j, devices8, mesh: dict):
    return japi.make_parallel_model(cfg_j, JMeshConfig(**mesh),
                                    devices=devices8[:_size(mesh)])


def _tokens(seed=8, b=2, t=13):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


def _one_device(moe, toks):
    _, cfg_t, _, pn = moe
    pt = params_from_numpy(pn, cfg_t, device="cpu")
    with torch.no_grad():
        logits, _, aux = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                                    return_aux=True)
    return logits, float(aux)


@pytest.mark.parametrize("name", list(MESHES))
def test_forward_matches_the_reference_mesh(moe, worlds, devices8, name):
    cfg_j, cfg_t, pj, _ = moe
    mesh = MESHES[name]
    toks = _tokens()
    jpm = _jpm(cfg_j, devices8, mesh)
    lj, _, aux_j = jpm.forward(jpm.shard_params(pj), jnp.asarray(toks),
                               return_aux=True)
    one, aux_one = _one_device(moe, toks)
    outs = worlds(_size(mesh)).run(cases.moe_forward, "moe", mesh, toks)
    ep = mesh["expert"]
    per = cfg_t.num_experts // ep
    f = cfg_t.intermediate_size // mesh.get("model", 1)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["logits"], np.asarray(lj), **TOL)
        assert abs(out["aux"] - float(aux_j)) <= TOL["atol"]
        # The rank's block of the experts, one combine a layer.
        e_coord = r % ep
        assert out["experts"] == (e_coord * per, (e_coord + 1) * per)
        assert out["w_gate"] == (cfg_t.num_layers, per, cfg_t.hidden_size, f)
        assert out["expert_calls"] == cfg_t.num_layers
        if "model" not in mesh:
            # The combine is exact: the one-device forward to the bit.
            assert torch.equal(torch.from_numpy(out["logits"]), one)
            assert out["aux"] == aux_one
        else:
            np.testing.assert_allclose(out["logits"], one.numpy(), **TOL)


@pytest.mark.parametrize("name", ["pp2ep2", "sp2ep2"])
def test_forward_composes_with_pipe_and_seq(moe, worlds, devices8, name):
    """The combine runs inside the pipeline's stages and the seq forwards
    (each rank of an 'expert' line computes the same stage or block): the
    logits of the reference's fake-mesh forward, whose pipe and seq
    schedules return an MoE term of 0."""
    cfg_j, _, pj, _ = moe
    mesh = {"pp2ep2": {"pipe": 2, "expert": 2},
            "sp2ep2": {"seq": 2, "expert": 2}}[name]
    toks = _tokens(10, t=12)
    jpm = _jpm(cfg_j, devices8, mesh)
    lj, _, aux_j = jpm.forward(jpm.shard_params(pj), jnp.asarray(toks),
                               return_aux=True)
    assert float(aux_j) == 0.0
    for out in worlds(4).run(cases.moe_forward, "moe", mesh, toks):
        np.testing.assert_allclose(out["logits"], np.asarray(lj), **TOL)
        assert out["aux"] == 0.0 and out["expert_calls"] > 0


def test_replicated_experts_take_no_combine(moe, worlds, devices8):
    """E = 4 over expert = 3: the rule keeps the experts whole, every rank
    computes them all and no sum over 'expert' multiplies the output."""
    cfg_j, cfg_t, pj, _ = moe
    mesh = {"expert": 3}
    toks = _tokens(9)
    jpm = _jpm(cfg_j, devices8, mesh)
    lj, _, aux_j = jpm.forward(jpm.shard_params(pj), jnp.asarray(toks),
                               return_aux=True)
    one, aux_one = _one_device(moe, toks)
    for out in worlds(3).run(cases.moe_forward, "moe", mesh, toks):
        assert out["experts"] is None and out["expert_calls"] == 0
        assert out["w_gate"][1] == cfg_t.num_experts
        assert torch.equal(torch.from_numpy(out["logits"]), one)
        assert out["aux"] == aux_one
        np.testing.assert_allclose(out["logits"], np.asarray(lj), **TOL)
        assert abs(out["aux"] - float(aux_j)) <= TOL["atol"]


def _requests(seed=10):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    prompts = [shared + pick(5), pick(7), shared + pick(9), pick(30),
               pick(3), shared + pick(20)]
    return list(zip(prompts, BUDGETS))


def _jstreams(b, reqs):
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("mode", ["paged", "paged_overlap", "contiguous"])
def test_batcher_streams_match_the_reference_mesh(moe, worlds, devices8,
                                                  mode):
    cfg_j, _, pj, _ = moe
    mesh = {"expert": 2}
    kw = dict(PAGED if mode.startswith("paged") else KW,
              overlap=mode == "paged_overlap")
    reqs = _requests()
    jpm = _jpm(cfg_j, devices8, mesh)
    want = _jstreams(JBatcher(cfg_j, jpm.shard_params(pj), parallel=jpm,
                              **kw), reqs)
    assert [len(s) for s in want] == BUDGETS
    for out in worlds(2).run(cases.moe_batcher, "moe", mesh, reqs, kw):
        assert out["streams"] == want
        assert out["overlap"] == kw["overlap"] and out["loop"] == "eager"
        assert out["expert_calls"] > 0


@pytest.fixture(scope="module")
def int4_stores(tmp_path_factory):
    """moe-tiny as an int4 store, and the same as a legacy store (written
    before ``pack_axis`` was recorded: pairs along the last axis)."""
    import json
    import os

    cfg = jax_preset("moe-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(11), cfg)
    out = {}
    for kind in ("current", "legacy"):
        path = str(tmp_path_factory.mktemp(f"moe_int4_{kind}"))
        if kind == "current":
            jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                               quantization="int4")
        else:
            from distributed_llms_tpu.checkpoint import quantize as jq

            blocks = jax.tree.map(
                lambda x: (jq.quantize(x, bits=4, pack_axis=-1)
                           if x.ndim >= 3 else x), params["blocks"])
            jstore.save_shards({**params, "blocks": blocks}, path,
                               num_shards=2, model_config=cfg)
            man_path = os.path.join(path, "manifest.json")
            man = json.load(open(man_path))
            man["quantization"] = "int4"
            for entry in man["params"].values():
                entry.pop("pack_axis", None)
            json.dump(man, open(man_path, "w"))
        out[kind] = path
    return out


# (store, mesh, the expert leaves' type on a rank, their E per rank)
STORE_CASES = {
    "ep2": ("current", {"expert": 2}, "QuantizedTensor", 2),
    "ep4": ("current", {"expert": 4}, "QuantizedTensor", 1),
    "tp2_legacy": ("legacy", {"model": 2}, None, 4),
}


@pytest.mark.parametrize("name", list(STORE_CASES))
def test_int4_store_serves_on_the_expert_mesh(int4_stores, worlds, devices8,
                                              name):
    kind, mesh, leaf_type, per = STORE_CASES[name]
    kw = dict(PAGED, overlap=False)
    reqs = _requests(12)
    jeng = JEngine.from_store(int4_stores[kind],
                              rt=JRuntimeConfig(serve_quantized=True))
    jpm = _jpm(jeng.cfg, devices8, mesh)
    want = _jstreams(JBatcher(jeng.cfg, jpm.shard_params(jeng.params),
                              parallel=jpm, **kw), reqs)
    cfg = get_preset("moe-tiny", vocab_size=512)
    d, f = cfg.hidden_size, cfg.intermediate_size
    n = _size(mesh)
    for r, out in enumerate(worlds(n).run(cases.store_batcher,
                                          int4_stores[kind], mesh, reqs,
                                          kw)):
        assert out["streams"] == want
        leaves = out["leaves"]
        assert leaves["router"]["type"] == "QuantizedTensor"
        if leaf_type is not None:
            # Cut along E (one expert a rank at expert=4: the pairs run
            # along D, never along the expert axis), still int4.
            assert out["experts"] == (r * per, (r + 1) * per)
            for leaf, shape in (("w_gate", (per, d, f)),
                                ("w_up", (per, d, f)),
                                ("w_down", (per, f, d))):
                assert leaves[leaf] == {
                    "type": leaf_type, "bits": 4,
                    "unpacked": (cfg.num_layers, *shape)}
        else:
            # A legacy stack's pairs run along its last axis: w_gate and
            # w_up cannot cut their last (hidden) axis over 'model', stay
            # whole on every rank, and each rank rehydrates its block;
            # w_down cuts its hidden axis.
            assert out["experts"] is None
            assert leaves["w_gate"]["type"] == "ReplicatedQuantized"
            assert leaves["w_up"]["type"] == "ReplicatedQuantized"
            assert leaves["w_down"] == {
                "type": "QuantizedTensor", "bits": 4,
                "unpacked": (cfg.num_layers, per, f // 2, d)}


def test_a_worker_and_the_server_take_the_expert_mesh(int4_stores, worlds):
    """``mesh.expert`` under ``cluster.num_processes`` reaches the
    engine: a control-plane worker on ``expert=2`` serves its batch
    through the mesh batcher with the one-device worker's texts, and
    ``dlt-serve-torch`` joins an expert mesh (only pipe and seq are
    refused before joining)."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.config import load_config

    reqs = [{"prompt": p, "max_new_tokens": n} for p, n in
            (("expert note one", 6), ("a longer second note", 3),
             ("three", 8))]
    want = cases.worker_requests(int4_stores["current"], None, reqs)
    for r, out in enumerate(worlds(2).run(cases.worker_requests,
                                          int4_stores["current"],
                                          {"expert": 2}, reqs)):
        assert out["text"] == want["text"]
        assert out["generated_tokens"] == want["generated_tokens"]
        assert out["experts"] == (2 * r, 2 * r + 2)
    import types

    cfg = load_config(None, ["mesh.expert=2"])
    with pytest.raises(ValueError, match="needs 2 processes, got 1"):
        serve_main._join_mesh(types.SimpleNamespace(device="cpu"), cfg)
