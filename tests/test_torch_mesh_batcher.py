"""The port's continuous batcher on a data x tensor-parallel mesh
(``ContinuousBatcher(parallel=)``) against the JAX package's mesh
batcher: the counterparts of tests/parallel/test_mesh_batcher.py and
tests/runtime/test_mesh_paged.py.

The reference runs its mesh batcher on the 4-device CPU fake mesh (data 2
x model 2, tests/conftest.py); the port runs the same batcher
configuration on one world of 4 spawned gloo ranks (``torch_world.py``),
every rank fed the same requests.  Every rank must return the
reference's greedy streams exactly: contiguous mixed budgets with slot
reuse, a named prefix, plain paged decode, prefix-cache hits across 'data'
ranks (each step's K/V reaches every rank's copy of the pool, so a row on
'data' rank 1 reuses a page that rank 0's row wrote: equal cached-token
counts, and the pools of one 'model' coordinate byte-equal across 'data'),
chunked prefill, preemption with the host-tier swap, the int8 pool, the
dispatch-ahead loop on and off, penalties; and the engine's mesh policy
(slots round up to the 'data' axis, paged mode degrades or raises when
the KV heads do not divide).  The rejections keep the reference's
messages.  On the CPU the mesh runs the eager step loop
(``loop_kind``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.core.config import RuntimeConfig as JRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.runtime import generate as jgen
from distributed_llms_tpu.runtime.batcher import ContinuousBatcher as JBatcher
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.core.mesh import build_mesh
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.parallel import api as tapi
from distributed_llms_tpu_torch.runtime.batcher import ContinuousBatcher
from torch_world import World

PAGED_KW = dict(batch_slots=2, max_len=64, chunk_steps=4, page_size=16,
                paged_pages=14)
REQS = [([7, 1, 9], 6), ([4, 4, 4, 4, 4, 4], 12), ([100, 3, 5, 2], 3),
        ([11, 12], 15)]


@pytest.fixture(scope="module")
def tiny():
    cfg_j = jax_preset("llama-tiny", vocab_size=512)  # 2 KV heads
    cfg_t = get_preset("llama-tiny", vocab_size=512)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    return cfg_j, cfg_t, pj, jax.tree.map(np.asarray, pj)


@pytest.fixture(scope="module")
def world(tmp_path_factory, tiny):
    w = World(4, str(tmp_path_factory.mktemp("mesh_batcher_world")))
    w.run(cases.load, "tiny", tiny[1], tiny[3])
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh_batcher(tiny, devices8, data=2, model=2, **kw):
    cfg_j, _, pj, _ = tiny
    pm = japi.make_parallel_model(cfg_j, JMeshConfig(data=data, model=model),
                                  devices=devices8[: data * model])
    return JBatcher(cfg_j, pm.shard_params(pj), parallel=pm, **kw)


def _jdrive(b, reqs):
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    return [res[r] for r in rids]


def _solo(tiny, ids, n):
    cfg_j, _, pj, _ = tiny
    out = jgen.generate_tokens(
        pj, cfg_j, jnp.asarray([ids], jnp.int32),
        jnp.asarray([len(ids)], jnp.int32), jax.random.key(9),
        max_new_tokens=n, eos_id=-1, pad_id=0)
    return np.asarray(out)[0].tolist()


def _port(world, reqs, kw, data=2, model=2, **extra):
    return world.run(cases.batcher_streams, "tiny", data, model, reqs, kw,
                     **extra)


def _same_pools_across_data(outs):
    """Ranks (d, m) and (d', m) hold byte-equal pools."""
    by_model: dict[int, set] = {}
    for r, o in enumerate(outs):
        by_model.setdefault(r % 2, set()).add(o["pool_sum"])
    assert all(len(v) == 1 for v in by_model.values()), by_model


# -- byte-exactness -------------------------------------------------------------

def test_contiguous_mixed_budgets_match_the_reference_mesh(tiny, world,
                                                           devices8):
    reqs = REQS + [([9, 8, 7, 6, 5], 9), ([42], 8)]
    kw = dict(batch_slots=4, max_len=64, chunk_steps=4)
    want = _jdrive(_jmesh_batcher(tiny, devices8, **kw), reqs)
    for out in _port(world, reqs, kw):
        assert out["streams"] == want
        assert out["loop"] == "eager"
        assert out["pool_heads"] == 1  # 2 KV heads over model 2
    for got, (ids, n) in zip(want, reqs):
        assert got == _solo(tiny, ids, n)


def test_named_prefix_matches_solo(tiny, world):
    prefix, suffix = [3, 1, 4, 1, 5], [9, 2, 6]
    kw = dict(batch_slots=2, max_len=64, chunk_steps=4)
    for out in _port(world, [(suffix, 8, {"prefix": "sys"})], kw,
                     prefix=prefix):
        assert out["streams"] == [_solo(tiny, prefix + suffix, 8)]


def test_paged_dp_x_tp_matches_the_reference_mesh(tiny, world, devices8):
    want = _jdrive(_jmesh_batcher(tiny, devices8, **PAGED_KW), REQS)
    outs = _port(world, REQS, PAGED_KW)
    for out in outs:
        assert out["streams"] == want
    _same_pools_across_data(outs)


def test_prefix_hit_across_data_ranks_byte_exact(tiny, world, devices8):
    """Slots 0 and 1 split over 'data': the second request (slot 1, data
    rank 1) hits the prefix pages the first (slot 0, data rank 0) wrote."""
    shared = list(range(40, 58)) + [3, 3]
    reqs = [(shared + [11, 12], 6), (shared + [42], 8), ([4, 4, 4], 4)]
    kw = dict(PAGED_KW, prefix_cache=True)
    ref = _jmesh_batcher(tiny, devices8, **kw)
    want = _jdrive(ref, reqs)
    outs = _port(world, reqs, kw)
    for out in outs:
        assert out["streams"] == want
        assert out["hit_tokens"] > 0
        assert out["cached"] == {int(k): int(v) for k, v in
                                 ref.prefix_cached_tokens.items()}
    _same_pools_across_data(outs)


def test_chunked_prefill_byte_exact(tiny, world, devices8):
    reqs = [(list(range(1, 40)), 8), ([7, 7, 7], 6)]
    kw = dict(PAGED_KW, prefill_chunk=8)
    want = _jdrive(_jmesh_batcher(tiny, devices8, **kw), reqs)
    for out in _port(world, reqs, kw):
        assert out["streams"] == want


def test_preempt_swap_byte_exact(tiny, world, devices8):
    storm = [([7, 1, 9, 2], 40), ([4, 4, 4, 4], 40), ([9, 8, 7, 3], 40),
             ([5, 5, 1], 30)]
    kw = dict(PAGED_KW, batch_slots=4, paged_pages=9, host_pages=16)
    ref = _jmesh_batcher(tiny, devices8, **kw)
    want = _jdrive(ref, storm)
    outs = _port(world, storm, kw)
    for out in outs:
        assert out["streams"] == want
        assert out["preemptions"] == ref.preemptions >= 1
    _same_pools_across_data(outs)


def test_int8_pool_streams_match_the_reference_mesh(tiny, world, devices8):
    kw = dict(PAGED_KW, kv_bits=8)
    want = _jdrive(_jmesh_batcher(tiny, devices8, **kw), REQS)
    outs = _port(world, REQS, kw)
    for out in outs:
        assert out["streams"] == want
    _same_pools_across_data(outs)


def test_overlap_on_off_byte_exact(tiny, world, devices8):
    reqs = [([7, 1, 9], 24), ([4, 4, 4, 4], 24)]
    on = _port(world, reqs, dict(PAGED_KW, overlap=True))
    off = _port(world, reqs, dict(PAGED_KW, overlap=False))
    want = _jdrive(_jmesh_batcher(tiny, devices8, **PAGED_KW, overlap=True),
                   reqs)
    for a, b in zip(on, off):
        assert a["streams"] == b["streams"] == want
        assert a["overlap"] and a["dispatched_ahead"] >= 1
        assert b["dispatched_ahead"] == 0


def test_penalties_match_one_device(tiny, world):
    """The [B, V] histogram rides every rank's decode identically: the
    penalized row matches the reference's single-device penalized batcher
    (its mesh leg is marked fragile on XLA:CPU) and its neighbour stays
    solo-exact."""
    cfg_j, _, pj, _ = tiny
    ids, n = [7, 1, 9], 20
    other = ([4, 4, 4, 4], 9)
    ref = JBatcher(cfg_j, pj, batch_slots=2, max_len=96, chunk_steps=4)
    r_pen = ref.submit(ids, max_new_tokens=n, presence_penalty=1.5,
                       frequency_penalty=1.5)
    r_other = ref.submit(*other[:1], max_new_tokens=other[1])
    ref_res = ref.run()
    reqs = [(ids, n, {"presence_penalty": 1.5, "frequency_penalty": 1.5}),
            other]
    for out in _port(world, reqs, dict(batch_slots=2, max_len=96,
                                       chunk_steps=4)):
        assert out["streams"] == [ref_res[r_pen], ref_res[r_other]]


# -- the engine on a mesh -----------------------------------------------------------

@pytest.fixture(scope="module")
def store(tiny, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_store"))
    jstore.save_shards(tiny[2], path, num_shards=2, model_config=tiny[0])
    return path


def test_engine_mesh_continuous_batcher(tiny, world, store):
    outs = world.run(cases.engine_batcher, store, 2, 2, [([5, 6, 7], 5)], 3)
    for out in outs:
        assert out["pm"] and out["slots"] == 4  # 3 rounds up over data 2
        assert out["streams"] == [_solo(tiny, [5, 6, 7], 5)]


def test_engine_policy_explicit_vs_inherited(tiny, world, store):
    """Paged mode passes through on a mesh whose KV heads divide; on one
    where they do not, a config-inherited pool degrades to contiguous and
    an explicit one raises."""
    outs = world.run(cases.engine_batcher, store, 2, 2, [([5, 6, 7], 5)], 4,
                     paged_pages=14, page_size=16, prefix_cache=True)
    for out in outs:
        assert out["paged"] and out["prefix"]
        assert out["streams"] == [_solo(tiny, [5, 6, 7], 5)]
    rt = dict(paged_pages=14, page_size=16)
    for out in world.run(cases.engine_batcher, store, 1, 4, [([5, 6, 7], 5)],
                         2, rt=rt):
        assert not out["paged"]
        assert out["streams"] == [_solo(tiny, [5, 6, 7], 5)]
    for out in world.run(cases.engine_batcher, store, 1, 4, [], 2,
                         paged_pages=14):
        assert "does not divide" in out["error"]


def test_reference_engine_policy_agrees(store, devices8):
    eng = JEngine.from_store(store, rt=JRuntimeConfig(max_decode_steps=8),
                             mesh_cfg=JMeshConfig(data=2, model=4))
    assert eng.continuous_batcher(batch_slots=3, max_len=64).b == 4


# -- rejections (layout-only meshes: the checks precede any collective) ----------

def _layout_pm(cfg, rank=0, **axes):
    mcfg = MeshConfig(**axes)
    return tapi.make_parallel_model(
        cfg, mcfg, mesh=build_mesh(mcfg, rank=rank,
                                   world_size=mcfg.num_devices))


def test_rejections_keep_the_reference_messages(tiny):
    _, cfg, _, pn = tiny
    params = params_from_numpy(pn, cfg, device="cpu")
    pm = _layout_pm(cfg, model=4)
    with pytest.raises(ValueError, match=r"num_kv_heads 2.*'model' \(4\)"):
        ContinuousBatcher(cfg, pm.shard_params(params), parallel=pm,
                          **PAGED_KW)
    pm = _layout_pm(cfg, pipe=2, model=4)
    with pytest.raises(ValueError, match="data/tensor-parallel"):
        ContinuousBatcher(cfg, params, parallel=pm, batch_slots=2,
                          max_len=32)
    pm = _layout_pm(cfg, data=8)
    with pytest.raises(ValueError, match="'data' axis"):
        ContinuousBatcher(cfg, params, parallel=pm, batch_slots=6,
                          max_len=32)
    pm = _layout_pm(cfg, model=2)
    with pytest.raises(ValueError, match="draft/verify chain"):
        ContinuousBatcher(cfg, pm.shard_params(params), parallel=pm,
                          draft_params=params, draft_cfg=cfg, batch_slots=2,
                          max_len=32)
    # An expert mesh serves like a data/model mesh; with 'pipe' beside it
    # the batcher refuses it as it refuses any pipelined mesh.
    from distributed_llms_tpu_torch.models.model import init_params

    moe = get_preset("moe-tiny")
    moe_params = init_params(moe, torch.Generator().manual_seed(0))
    pm = _layout_pm(moe, expert=2)
    b = ContinuousBatcher(moe, pm.shard_params(moe_params), parallel=pm,
                          batch_slots=2, max_len=32)
    assert b.pm is pm and pm.plan.experts == (0, 2)
    pm = _layout_pm(moe, pipe=2, expert=2)
    with pytest.raises(ValueError, match="data/tensor-parallel"):
        ContinuousBatcher(moe, moe_params, parallel=pm, batch_slots=2,
                          max_len=32)


def test_reference_rejections_agree(tiny, devices8):
    cfg_j, _, pj, _ = tiny
    pm = japi.make_parallel_model(cfg_j, JMeshConfig(model=4),
                                  devices=devices8[:4])
    with pytest.raises(ValueError, match=r"num_kv_heads 2.*'model' \(4\)"):
        JBatcher(cfg_j, pm.shard_params(pj), parallel=pm, **PAGED_KW)


# -- lockstep: requests reaching rank 0 only ----------------------------------------

def test_lockstep_followers_match_spmd_fed_ranks(tiny, world, devices8):
    """Rank 0 journals its submissions and a cancellation; the other ranks
    follow its broadcasts and hold the same pools, and rank 0's streams
    are the reference mesh's."""
    shared = list(range(40, 58)) + [3, 3]
    reqs = [(shared + [11, 12], 6), (shared + [42], 8), ([4, 4, 4], 4),
            ([9, 9], 5)]
    kw = dict(PAGED_KW, prefix_cache=True)
    want = _jdrive(_jmesh_batcher(tiny, devices8, **kw), reqs[:3])
    outs = world.run(cases.lockstep_streams, "tiny", 2, 2, reqs, kw,
                     cancel=3)
    assert outs[0]["streams"][:3] == want
    assert outs[0]["streams"][3] == []
    assert len({o["syncs"] for o in outs}) == 1 and outs[0]["syncs"] > 1
    _same_pools_across_data(outs)
    assert outs[0]["pool_sum"] != outs[1]["pool_sum"]  # other KV head
