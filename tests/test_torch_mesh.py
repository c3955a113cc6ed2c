"""The port's mesh layout and shard rules against the JAX package's, with
no processes: ``parallel/stages.py`` (a copy), ``parallel/specs.py``'s
rules for every preset over the reference's mesh ladder
(``tools/graftcheck``'s: tp2, tp4, tp8, pp2, pp2tp4, ep2tp2) and the page
pool's over the paged ladder, each rank's block of a leaf, the quantized
placement (scale refinement exact, an unshardable int4 leaf kept whole),
``core/mesh.py``'s coordinates and groups' lines, and the reference's
``ValueError`` for a mesh whose size is not the world's.

The reference runs on the 8-device CPU fake mesh of tests/conftest.py; the
port's layout-only meshes carry a rank and a world size and need no
process group.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from distributed_llms_tpu.checkpoint import quantize as jq
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.models.presets import PRESETS as JPRESETS
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.parallel import specs as jspecs
from distributed_llms_tpu.parallel import stages as jstages
from distributed_llms_tpu_torch.checkpoint import quantize as tq
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.core.mesh import build_mesh
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import PRESETS, get_preset
from distributed_llms_tpu_torch.parallel import api as tapi
from distributed_llms_tpu_torch.parallel import specs as tspecs
from distributed_llms_tpu_torch.parallel import stages as tstages

MESH_LADDER = (
    ("tp2", dict(model=2)),
    ("tp4", dict(model=4)),
    ("tp8", dict(model=8)),
    ("pp2", dict(pipe=2)),
    ("pp2tp4", dict(pipe=2, model=4)),
    ("ep2tp2", dict(expert=2, model=2)),
)
PAGED_LADDER = (("tp2", dict(model=2)), ("tp4", dict(model=4)),
                ("dp2tp2", dict(data=2, model=2)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(devices8, axes):
    cfg = JMeshConfig(**axes)
    devs = np.asarray(devices8[: cfg.num_devices]).reshape(cfg.shape)
    return JMesh(devs, cfg.axis_names)


def _tmesh(axes, rank=0):
    cfg = MeshConfig(**axes)
    return build_mesh(cfg, rank=rank, world_size=cfg.num_devices)


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _strip(t):
    """A rule with trailing Nones dropped (equal sharding either way)."""
    t = list(t)
    while t and t[-1] is None:
        t.pop()
    return tuple(t)


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    return _strip(tree)


# -- stages ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_stages_agree_with_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 100, 12)]
    for n in (1, 2, 3, 5, 12):
        assert tstages.partition_contiguous(sizes, n) == \
            tstages.StageAssignment(**vars(jstages.partition_contiguous(
                sizes, n)))
    a = tstages.uniform_stages(12, 4)
    assert a.boundaries == jstages.uniform_stages(12, 4).boundaries
    assert a.uniform and a.stage_of(5) == 1 and list(a.layers_of(2)) == [6, 7, 8]
    with pytest.raises(ValueError, match="not divisible"):
        tstages.uniform_stages(10, 4)
    items = {f"x{i}": int(s) for i, s in enumerate(rng.integers(1, 9, 9))}
    assert tstages.pack_greedy(items, 3) == jstages.pack_greedy(items, 3)


def test_store_packs_with_the_stages_copy():
    from distributed_llms_tpu_torch.checkpoint import store as tstore

    assert tstore.pack_greedy is tstages.pack_greedy


# -- parameter and pool rules ----------------------------------------------------

@pytest.mark.parametrize("mesh", MESH_LADDER, ids=lambda m: m[0])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_param_rules_match_the_reference(name, mesh, devices8):
    _, axes = mesh
    want = jspecs.param_specs(JPRESETS[name], _jmesh(devices8, axes))
    got = tspecs.param_specs(PRESETS[name], _tmesh(axes))
    assert _norm(_as_tuples(got)) == _norm(_as_tuples(want))


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("mesh", PAGED_LADDER, ids=lambda m: m[0])
@pytest.mark.parametrize("name", ["llama-tiny", "gpt2-tiny"])
def test_page_pool_rules_match_the_reference(name, mesh, bits, devices8):
    _, axes = mesh
    want = jspecs.page_pool_specs(JPRESETS[name], _jmesh(devices8, axes),
                                  kv_bits=bits)
    got = tspecs.page_pool_specs(PRESETS[name], _tmesh(axes), kv_bits=bits)
    fields = ("k", "v", "k_scale", "v_scale") if bits == 8 else ("k", "v")
    for f in fields:
        assert tuple(getattr(got, f)) == tuple(getattr(want, f)), f


def test_staged_rules_lead_with_pipe(devices8):
    """The reference shards a staged tree [pipe, L/pipe, ...] with 'pipe'
    leading; a pipelined rank takes its stage first, then cuts the rest
    under the same rules (its layer axis no longer cut)."""
    cfg = PRESETS["llama-tiny"]
    pm = tapi.make_parallel_model(cfg, MeshConfig(pipe=2, model=2),
                                  mesh=_tmesh(dict(pipe=2, model=2)))
    want = _as_tuples(japi.staged_param_specs(
        JPRESETS["llama-tiny"], _jmesh(devices8, dict(pipe=2, model=2))))

    def lead(t):
        if isinstance(t, dict):
            return {k: lead(v) for k, v in t.items()}
        return ("pipe", None) + t[1:]

    got = _as_tuples(pm.rules)
    got["blocks"] = lead(got["blocks"])
    assert _norm(got) == _norm(want)


@pytest.mark.parametrize("axes", [dict(model=2), dict(model=4),
                                  dict(data=2, model=2)])
def test_rank_blocks_tile_every_leaf(axes):
    """The blocks of every rank of a 'model' line concatenate back to the
    leaf along its sharded axis (and 'data' ranks hold the same block)."""
    cfg = get_preset("llama-tiny", vocab_size=512)
    g = torch.Generator()
    g.manual_seed(0)
    params = tm.init_params(cfg, generator=g)
    n = MeshConfig(**axes).num_devices
    ranks = [tapi.make_parallel_model(cfg, MeshConfig(**axes),
                                      mesh=_tmesh(axes, r)) for r in range(n)]
    rules = tspecs.param_specs(cfg, ranks[0].mesh)
    blocks = [pm.shard_params(params) for pm in ranks]

    def walk(full, rule, parts, path):
        if isinstance(full, dict):
            for k in full:
                walk(full[k], rule[k], [p[k] for p in parts], f"{path}/{k}")
            return
        sharded = [ax for ax, a in enumerate(rule) if a == "model"]
        line = [parts[pm.mesh.rank] for pm in ranks
                if pm.mesh.coord("data") == 0]
        if not sharded:
            for p in parts:
                assert torch.equal(p, full), path
            return
        assert torch.equal(torch.cat(line, dim=sharded[0]), full), path
        assert all(p.is_contiguous() for p in parts)

    walk(params, rules, blocks, "")


def test_local_config_and_kv_map():
    cfg = get_preset("llama-tiny")  # 4 q heads, 2 KV heads, F 176
    pm = tapi.make_parallel_model(cfg, MeshConfig(model=2),
                                  mesh=_tmesh(dict(model=2), 1))
    assert (pm.local_cfg.num_heads, pm.local_cfg.num_kv_heads,
            pm.local_cfg.intermediate_size) == (2, 1, 88)
    assert pm.plan.kv_map is None
    # KV heads that do not divide replicate; local Q head j of rank r
    # reads global KV head (r * H/tp + j) // (H/KVH).
    for r in range(4):
        pm4 = tapi.make_parallel_model(cfg, MeshConfig(model=4),
                                       mesh=_tmesh(dict(model=4), r))
        assert pm4.local_cfg.num_kv_heads == 2
        assert pm4.plan.kv_map == ((r * 1) // 2,)


# -- the mesh itself ---------------------------------------------------------

def test_mesh_coordinates_and_lines():
    cfg = MeshConfig(data=2, model=4)
    for r in range(8):
        m = build_mesh(cfg, rank=r, world_size=8)
        assert (m.coord("data"), m.coord("model")) == divmod(r, 4)
        assert m._line("model", m.coords) == [4 * (r // 4) + i for i in range(4)]
        assert m._line("data", m.coords) == [r % 4, 4 + r % 4]


def test_mesh_size_must_be_the_world():
    with pytest.raises(ValueError, match=r"needs 4 devices, got 2"):
        build_mesh(MeshConfig(data=2, model=2), rank=0, world_size=2)


def test_pipe_seq_expert_build_but_refuse_to_run():
    """An expert mesh builds and runs: an MoE model's rank holds its block
    of the experts (``Plan.experts``), its cache is the whole one, its
    forwards take the plan, and a training step builds on it, while
    training on a pipelined mesh is refused, naming what is left; a seq
    mesh runs: its cache is the two-region one (this rank's block of the
    prompt, the whole decode region), it needs the prompt length, and it
    has no fused decode loop; a pipe mesh runs: a stage's cache holds its
    layers, and it has the wavefront decode loop."""
    from distributed_llms_tpu_torch.parallel import plan as plan_lib
    from distributed_llms_tpu_torch.runtime.train import Trainer

    cfg = get_preset("llama-tiny")
    moe = get_preset("moe-tiny")
    pm = tapi.make_parallel_model(moe, MeshConfig(expert=2),
                                  mesh=_tmesh(dict(expert=2), rank=1))
    assert pm.plan.experts == (2, 4)
    cache = pm.init_cache(2, 16)
    assert tuple(cache.k.shape) == (moe.num_layers, 2, 16, moe.num_kv_heads,
                                    moe.head_dim_)
    with pm.activate():
        assert plan_lib.current() is pm.plan
    assert pm.as_decode_fn() is None
    assert Trainer(moe, parallel=pm).parallel is pm
    piped = tapi.make_parallel_model(moe, MeshConfig(pipe=2, expert=2),
                                     mesh=_tmesh(dict(pipe=2, expert=2)))
    with pytest.raises(NotImplementedError, match="later slices"):
        Trainer(moe, parallel=piped)
    pm = tapi.make_parallel_model(cfg, MeshConfig(seq=2),
                                  mesh=_tmesh(dict(seq=2)))
    with pytest.raises(ValueError, match="needs prompt_len"):
        pm.init_cache(2, 16)
    cache = pm.init_cache(2, 16, prompt_len=6)
    shape = (cfg.num_layers, 2, 3, cfg.num_kv_heads, cfg.head_dim_)
    assert [tuple(t.shape) for t in cache.k] == [shape, shape[:2] + (10,)
                                                 + shape[3:]]
    assert cache.max_len == 13
    with pm.activate():
        pass
    assert pm.as_decode_fn() is None
    pm = tapi.make_parallel_model(cfg, MeshConfig(pipe=2),
                                  mesh=_tmesh(dict(pipe=2)))
    cache = pm.init_cache(2, 16)
    assert tuple(cache.k.shape) == (cfg.num_layers // 2, 2, 16,
                                    cfg.num_kv_heads, cfg.head_dim_)
    with pm.activate():
        pass
    assert callable(pm.as_decode_fn())
    with pytest.raises(ValueError, match="not divisible by pipe"):
        tapi.make_parallel_model(get_preset("neox-tiny"), MeshConfig(pipe=2),
                                 mesh=_tmesh(dict(pipe=2)))
    with pytest.raises(ValueError, match="cannot combine"):
        tapi.make_parallel_model(cfg, MeshConfig(pipe=2, seq=2),
                                 mesh=_tmesh(dict(pipe=2, seq=2)))


# -- quantized placement -----------------------------------------------------

def test_scale_refinement_is_exact(devices8):
    """Sharding the blocked axis finer than its blocks refines the scales;
    every rank's dequantized block equals the reference's placement's."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    qt = tq.quantize(torch.from_numpy(w), bits=8, block=128)  # 2 blocks
    jmesh = JMesh(np.asarray(devices8).reshape(8), ("model",))
    jplaced = japi._place_quantized(jq.quantize(jax.numpy.asarray(w), bits=8,
                                                block=128),
                                    jax.sharding.PartitionSpec(None, "model"),
                                    jmesh, "w")
    want = np.asarray(jq.dequantize(jplaced))
    for r in range(8):
        placed = tspecs.place_quantized(qt, tspecs.P(None, "model"),
                                        _tmesh(dict(model=8), r), "w")
        assert placed.scale.shape == (64, 1)  # 32-wide blocks, one a rank
        np.testing.assert_array_equal(tq.dequantize(placed).numpy(),
                                      want[:, 32 * r:32 * (r + 1)])
        np.testing.assert_array_equal(tq.dequantize(placed).numpy(),
                                      tq.dequantize(qt).numpy()[:, 32 * r:32 * (r + 1)])


@pytest.mark.parametrize("axis", [0, 1])
def test_int4_pack_axis_shards_in_pairs(axis):
    """int4 codes shard along their pack axis in whole pairs: each rank's
    block dequantizes to the same rows of the weight."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    qt = tq.quantize(w, bits=4, block=32, pack_axis=-2)
    full = tq.dequantize(qt)
    spec = tspecs.P("model", None) if axis == 0 else tspecs.P(None, "model")
    for r in range(4):
        placed = tspecs.place_quantized(qt, spec, _tmesh(dict(model=4), r))
        part = full.narrow(axis, r * full.shape[axis] // 4,
                           full.shape[axis] // 4)
        assert torch.equal(tq.dequantize(placed), part)
        assert placed.orig_shape == tuple(part.shape)


def test_unshardable_leaf_replicates_and_still_contracts(monkeypatch):
    """An int4 leaf packed along the last axis (a legacy layout) under a
    rule that shards that axis stays whole, with a warning; its
    contraction still gives this rank's columns."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    qt = tq.quantize(w, bits=4, block=128, pack_axis=-1)
    warned = []
    monkeypatch.setattr(tspecs.log, "warning",
                        lambda msg, *a: warned.append(msg % a))
    for r in range(2):
        placed = tspecs.place_quantized(qt, tspecs.P(None, "model"),
                                        _tmesh(dict(model=2), r), "w")
        assert isinstance(placed, tspecs.ReplicatedQuantized)
        assert torch.equal(tq.dequantize(placed.qt), tq.dequantize(qt))
        y = placed.contract(x, 1)
        want = x @ tq.dequantize(qt)
        torch.testing.assert_close(y, want[:, 128 * r:128 * (r + 1)],
                                   rtol=1e-5, atol=1e-5)
    assert len(warned) == 2 and "cannot shard" in warned[0]


def test_quantized_block_shapes_follow_the_rules():
    """A quantized Llama-shaped tree keeps every block leaf quantized on
    the mesh, at the rank's local shape."""
    cfg = get_preset("llama-tiny", vocab_size=512)
    g = torch.Generator()
    g.manual_seed(0)
    params = tm.init_params(cfg, generator=g)
    qtree = dict(params, blocks=tq.quantize_tree(params["blocks"], bits=8,
                                                 block=32))
    pm = tapi.make_parallel_model(cfg, MeshConfig(model=2),
                                  mesh=_tmesh(dict(model=2), 1))
    local = pm.shard_params(qtree)
    mlp = local["blocks"]["mlp"]
    assert isinstance(mlp["w_gate"], tq.QuantizedTensor)
    assert mlp["w_gate"].unpacked_shape == (4, 64, 88)
    assert mlp["w_down"].unpacked_shape == (4, 88, 64)
    assert local["blocks"]["attn"]["wo"].unpacked_shape == (4, 2, 16, 64)
    assert math.prod(local["embed"]["wte"].shape) == 256 * 64
