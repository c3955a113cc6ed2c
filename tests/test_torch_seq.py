"""The port's sequence parallelism (``ops/ring.py``, ``ops/ulysses.py``,
the two-region cache of ``models/model.py`` and the seq paths of
``parallel/api.py``) against the JAX package's, on the same numpy inputs
and weights: the counterpart of tests/ops/test_ring.py,
tests/ops/test_ulysses.py and tests/parallel/test_parallel.py's seq cases.

The JAX side runs under ``shard_map`` on the conftest's host CPU devices;
the port side on spawned gloo worlds of 2 and 4 ranks
(``tests/torch_world.py``), one process a mesh position.  Activations and
logits are held to 1e-5 (float32); generated tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_mesh_cases as cases
from distributed_llms_tpu.core import jaxcompat
from distributed_llms_tpu.core.config import MeshConfig as JMeshConfig
from distributed_llms_tpu.core.mesh import mesh_from_devices
from distributed_llms_tpu.models import layers as jl
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.ops import ring as jring
from distributed_llms_tpu.ops import ulysses as julysses
from distributed_llms_tpu.parallel import api as japi
from distributed_llms_tpu.runtime import generate as jgen
from distributed_llms_tpu_torch.core.config import MeshConfig
from distributed_llms_tpu_torch.core.mesh import build_mesh
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.parallel import api as tapi
from torch_world import World

ATOL = 1e-5
SH, PS = P(None, "seq", None, None), P(None, "seq")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    w = World(2, str(tmp_path_factory.mktemp("seq_world2")))
    yield w
    w.close()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    w = World(4, str(tmp_path_factory.mktemp("seq_world4")))
    yield w
    w.close()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, t, h, kvh, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((b, t, h, d), (b, t, kvh, d), (b, t, kvh, d)))


def _jax_seq(fn, n, *args, in_specs, out_specs=SH):
    """``fn`` under the reference's shard_map over a 'seq' mesh of ``n``
    CPU devices (jitted: eager shard_map runs several times slower)."""
    mesh = mesh_from_devices({"seq": n}, jax.devices()[:n])
    return np.asarray(jax.jit(jaxcompat.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        axis_names={"seq"}))(*(jnp.asarray(a) for a in args)))


def _jax_ring(n, q, k, v, qp, kp, kv, causal):
    return _jax_seq(
        lambda q, k, v, qp, kp, kv: jring.ring_attention(
            q, k, v, qp, kp, axis_name="seq", causal=causal, k_valid=kv),
        n, q, k, v, qp, kp, kv, in_specs=(SH, SH, SH, PS, PS, PS))


def _blocks(outs):
    return np.concatenate([o["out"] for o in outs], axis=1)


# -- the seq line's collectives -------------------------------------------------

@pytest.mark.parametrize("piece_bytes", [1 << 28, 40],
                         ids=["whole", "in_pieces"])
def test_seq_collectives(world4, piece_bytes):
    """The reference's pmax / psum, tiled all_to_all and ppermute on the
    'seq' line (rank r holds x + 100 r), whole or in 40-byte pieces; each
    kind counted apart."""
    n = 4
    xs = [np.arange(2 * 3 * 4 * n, dtype=np.float32).reshape(2, 3, 4 * n)
          + 100 * r for r in range(n)]
    outs = world4.run(cases.seq_collectives, piece_bytes)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["max"], xs[-1])
        np.testing.assert_array_equal(o["sum"], sum(xs))
        want = np.concatenate([x[:, :, 4 * r:4 * r + 4] for x in xs], axis=1)
        np.testing.assert_array_equal(o["a2a"], want)
        np.testing.assert_array_equal(o["back"], xs[r])
        np.testing.assert_array_equal(o["gather"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(o["shift"], xs[(r - 1) % n])
        assert "'sum' or 'max'" in o["bad_op"]
        st = o["stats"]
        assert (st["reduce_max_calls"], st["reduce_sum_calls"],
                st["a2a_calls"], st["shift_calls"]) == (1, 1, 3, 1)
        assert st["calls"] == 7


# -- ring attention ------------------------------------------------------------

@pytest.mark.parametrize("n,heads,kv_heads,causal", [
    (2, 4, 4, True), (2, 4, 4, False), (4, 8, 2, True), (4, 4, 1, True),
], ids=["seq2_mha", "seq2_mha_noncausal", "seq4_gqa", "seq4_mqa"])
def test_ring_attention_matches_the_reference(world2, world4, n, heads,
                                              kv_heads, causal):
    """Each rank's block of the output equals the reference's ring under
    shard_map, with shuffled positions and a key validity mask; one shift
    of K/V and one of positions/validity per hop (S - 1 hops)."""
    world = world2 if n == 2 else world4
    b, t, d = 2, 16, 8
    q, k, v = _qkv(0, b, t, heads, kv_heads, d)
    rng = np.random.default_rng(1)
    pos = np.stack([rng.permutation(t) for _ in range(b)]).astype(np.int32)
    kv = rng.random((b, t)) > 0.2
    want = _jax_ring(n, q, k, v, pos, pos, kv, causal)
    outs = world.run(cases.seq_attention, "ring", q, k, v, pos, pos, kv,
                     causal)
    np.testing.assert_allclose(_blocks(outs), want, rtol=0, atol=ATOL)
    assert all(o["stats"]["shift_calls"] == 2 * (n - 1) for o in outs)


def test_ring_fully_masked_rows_are_zero(world2):
    """No live key for the first queries (the first 5 keys invalid,
    causal): those rows are exactly 0, never NaN, as in the reference."""
    b, t, h, d = 1, 8, 2, 4
    q, k, v = _qkv(2, b, t, h, h, d)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    kv = np.broadcast_to(np.arange(t) >= 5, (b, t)).copy()
    want = _jax_ring(2, q, k, v, pos, pos, kv, True)
    got = _blocks(world2.run(cases.seq_attention, "ring", q, k, v, pos, pos,
                             kv))
    assert np.isfinite(got).all()
    assert (got[:, :5] == 0).all() and (want[:, :5] == 0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    none = np.zeros((b, t), bool)
    got = _blocks(world2.run(cases.seq_attention, "ring", q, k, v, pos, pos,
                             none))
    assert (got == 0).all()


def test_ring_self_attention_gathers_the_whole_sequence(world4):
    b, t, h, d = 2, 16, 4, 8
    q, k, v = _qkv(3, b, t, h, 2, d)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    mesh = mesh_from_devices({"seq": 4}, jax.devices()[:4])
    want = np.asarray(jax.jit(
        lambda *a: jring.ring_self_attention(mesh, *a))(
            *(jnp.asarray(a) for a in (q, k, v, pos))))
    for got in world4.run(cases.ring_self, q, k, v, pos):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


# -- Ulysses -------------------------------------------------------------------

@pytest.mark.parametrize("n,heads,kv_heads,causal", [
    (2, 4, 2, True), (4, 8, 4, True), (4, 8, 4, False),
], ids=["seq2", "seq4", "seq4_noncausal"])
def test_ulysses_attention_matches_the_reference(world2, world4, n, heads,
                                                 kv_heads, causal):
    """Two all-to-alls a call (scatter, gather back) and the gathered
    positions and validity into the plain flash version, against the
    reference's Ulysses under shard_map."""
    world = world2 if n == 2 else world4
    b, t, d = 2, 16, 8
    q, k, v = _qkv(4, b, t, heads, kv_heads, d)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)).copy()
    kv = np.random.default_rng(5).random((b, t)) > 0.25
    want = _jax_seq(
        lambda q, k, v, p, kv: julysses.ulysses_attention(
            q, k, v, p, axis_name="seq", causal=causal, k_valid=kv),
        n, q, k, v, pos, kv, in_specs=(SH, SH, SH, PS, PS))
    outs = world.run(cases.seq_attention, "ulysses", q, k, v, pos, pos, kv,
                     causal)
    np.testing.assert_allclose(_blocks(outs), want, rtol=0, atol=ATOL)
    assert all(o["stats"]["a2a_calls"] == 4 for o in outs)


def test_ulysses_refuses_indivisible_heads(world2):
    q, k, v = _qkv(6, 1, 8, 4, 1, 4)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (1, 8)).copy()
    with pytest.raises(ValueError, match="ring") as e:
        _jax_seq(lambda q, k, v, p: julysses.ulysses_attention(
            q, k, v, p, axis_name="seq"), 2, q, k, v, pos,
            in_specs=(SH, SH, SH, PS))
    outs = world2.run(cases.seq_attention, "ulysses", q, k, v, pos, pos,
                      None)
    assert [o["error"] for o in outs] == [str(e.value)] * 2


# -- the one-reduce decode -----------------------------------------------------

def test_seq_cached_decode_matches_the_reference(world2):
    """One query over a prompt region cut over the line (one rank's block
    wholly masked in row 1) and a replicated decode region: one max and
    one packed sum over 'seq'."""
    b, s, n_dec, h, kvh, d = 2, 16, 4, 4, 2, 8
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, s, kvh, d)).astype(np.float32)
              for _ in range(2))
    dk, dv = (rng.standard_normal((b, n_dec, kvh, d)).astype(np.float32)
              for _ in range(2))
    m_pref = rng.random((b, s)) > 0.3
    m_pref[1, s // 2:] = False
    m_dec = np.array([[True, True, False, False], [True, False, False, False]])
    want = _jax_seq(
        lambda *a: jring.seq_cached_decode_attention(*a, axis_name="seq"),
        2, q, ck, cv, dk, dv, m_pref, m_dec,
        in_specs=(P(), SH, SH, P(), P(), PS, P()), out_specs=P())
    outs = world2.run(cases.seq_decode, q, ck, cv, dk, dv, m_pref, m_dec)
    for o in outs:
        np.testing.assert_allclose(o["out"], want, rtol=0, atol=ATOL)
        assert (o["stats"]["reduce_max_calls"],
                o["stats"]["reduce_sum_calls"]) == (1, 1)


# -- ParallelModel on a seq mesh -------------------------------------------------

MODELS = {
    "gpt2": ("gpt2-tiny", {}),
    "llama": ("llama-tiny", {"vocab_size": 512}),
}


def _model(key, *worlds):
    name, kw = MODELS[key]
    cfg_j, cfg_t = jax_preset(name, **kw), get_preset(name, **kw)
    pj = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0), cfg_j))
    for w in worlds:
        w.run(cases.load, key, cfg_t, pj)
    return cfg_j, pj


def _jpm(cfg_j, attn_impl, **axes):
    mesh = JMeshConfig(**axes)
    return japi.make_parallel_model(
        dataclasses.replace(cfg_j, attn_impl=attn_impl), mesh,
        devices=jax.devices()[:mesh.num_devices])


@pytest.mark.parametrize("key,impl,axes", [
    ("gpt2", "ring", dict(data=2, seq=2)),
    ("llama", "ring", dict(data=2, seq=2)),
    ("llama", "ulysses", dict(data=2, seq=2)),
    ("gpt2", "ulysses", dict(seq=2, model=2)),
], ids=["gpt2_ring_dp2sp2", "llama_ring_dp2sp2", "llama_ulysses_dp2sp2",
        "gpt2_ulysses_sp2tp2"])
def test_no_cache_seq_forward_matches_the_reference(world4, key, impl, axes):
    """Every rank returns the whole [B, T, V], equal to the reference's
    seq forward on the same mesh."""
    cfg_j, pj = _model(key, world4)
    toks = np.random.default_rng(8).integers(0, cfg_j.vocab_size, (2, 16))
    pm = _jpm(cfg_j, impl, **axes)
    want = jax.jit(lambda p, t: pm.forward(p, t)[0])(pm.shard_params(pj),
                                                     jnp.asarray(toks))
    outs = world4.run(cases.seq_forward, key, axes.get("data", 1),
                      axes["seq"], axes.get("model", 1), impl, toks)
    for o in outs:
        np.testing.assert_allclose(o["logits"], np.asarray(want), rtol=0,
                                   atol=ATOL)
        assert o["cache"] is None
        kind = "shift" if impl == "ring" else "a2a"
        assert o["stats"][f"{kind}_calls"] > 0


def test_custom_mask_falls_back_to_the_dense_path(world4):
    """A caller's mask is not dropped: the forward runs dense on every
    rank (no ring shift), equal to the reference's fallback."""
    cfg_j, pj = _model("gpt2", world4)
    b, t = 2, 16
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (b, t))
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    mask = jl.causal_mask(pos, pos, jnp.broadcast_to(jnp.arange(t) >= 4,
                                                     (b, t)))
    pm = _jpm(cfg_j, "dot", data=2, seq=2)
    want = jax.jit(lambda p, t, m: pm.forward(p, t, attn_mask=m)[0])(
        pm.shard_params(pj), jnp.asarray(toks), mask)
    for o in world4.run(cases.seq_forward, "gpt2", 2, 2, 1, "ring", toks,
                        np.asarray(mask)):
        np.testing.assert_allclose(o["logits"], np.asarray(want), rtol=0,
                                   atol=ATOL)
        assert o["stats"]["shift_calls"] == 0


@pytest.mark.parametrize("impl,axes,lens,seed", [
    ("ring", dict(data=2, seq=2), [16, 11], 5),
    ("ulysses", dict(seq=2, model=2), [16, 9], 6),
], ids=["ring_dp2sp2", "ulysses_sp2tp2"])
def test_cached_generation_is_token_exact(world4, impl, axes, lens, seed):
    """Prefill into the two-region cache, then the one-reduce decode:
    tokens equal to the reference's generate_tokens on the same mesh;
    each rank holds its half of the prompt region and the whole decode
    region."""
    cfg_j, pj = _model("gpt2", world4)
    b, t, n_new = 2, 16, 6
    prompt = np.random.default_rng(seed).integers(0, cfg_j.vocab_size,
                                                  (b, t)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    pm = _jpm(cfg_j, impl, **axes)
    want = np.asarray(jgen.generate_tokens(
        pm.shard_params(pj), pm.cfg, jnp.asarray(prompt), jnp.asarray(lens),
        jax.random.key(0), max_new_tokens=n_new,
        forward_fn=pm.as_forward_fn(), make_cache=pm.as_make_cache(),
    )).tolist()
    outs = world4.run(cases.seq_generate, "gpt2", axes.get("data", 1), 2,
                      axes.get("model", 1), impl, prompt, lens, n_new)
    kvh = cfg_j.num_kv_heads // axes.get("model", 1)
    for o in outs:
        assert o["tokens"] == want
        assert o["regions"] == [(cfg_j.num_layers, b, t // 2, kvh, 16),
                                (cfg_j.num_layers, b, n_new, kvh, 16)]
        # n_new decode steps of one max (and one sum) a layer.
        assert o["stats"]["reduce_max_calls"] == n_new * cfg_j.num_layers


# -- what a seq mesh refuses --------------------------------------------------

def _layout_pm(cfg, **axes):
    m = MeshConfig(**axes)
    return tapi.make_parallel_model(cfg, m, mesh=build_mesh(
        m, rank=0, world_size=m.num_devices))


def test_seq_mesh_refusals_keep_the_reference_messages():
    """prompt_len missing, seq with pipe, a windowed model's decode,
    kv_tables and key_positions: refused with the reference's messages
    (the reference raises each on its own seq mesh)."""
    cfg = get_preset("gpt2-tiny")
    jcfg = jax_preset("gpt2-tiny")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    pm, jpm = _layout_pm(cfg, seq=2), _jpm(jcfg, "dot", seq=2)

    def msg(fn):
        with pytest.raises(Exception) as e:
            fn()
        return type(e.value), str(e.value)

    assert msg(lambda: pm.init_cache(2, 32)) == msg(
        lambda: jpm.init_cache(batch=2, max_len=32))
    assert msg(lambda: pm.init_cache(2, 32, prompt_len=7)) == msg(
        lambda: jpm.init_cache(batch=2, max_len=32, prompt_len=7))
    assert msg(lambda: _layout_pm(cfg, pipe=2, seq=2)) == msg(
        lambda: _jpm(jcfg, "dot", pipe=2, seq=2))
    win, jwin = (dataclasses.replace(c, sliding_window=4)
                 for c in (cfg, jcfg))
    for adapter in ("as_forward_fn", "as_make_cache", "as_decode_fn"):
        assert msg(getattr(_layout_pm(win, seq=2), adapter)) == msg(
            getattr(_jpm(jwin, "dot", seq=2), adapter))
    toks = torch.zeros((2, 1), dtype=torch.long)
    jtoks = jnp.zeros((2, 1), jnp.int32)
    assert msg(lambda: pm.forward(params, toks, kv_tables=torch.zeros(
        (2, 1), dtype=torch.int32))) == msg(lambda: jpm.forward(
            {}, jtoks, kv_tables=jnp.zeros((2, 1), jnp.int32)))
    assert msg(lambda: pm.forward(params, toks, key_positions=torch.zeros(
        (2, 4), dtype=torch.int32))) == msg(lambda: jpm.forward(
            {}, jtoks, key_positions=jnp.zeros((2, 4), jnp.int32)))
    # The cached prefill refuses a caller's mask.
    cache = pm.init_cache(2, 8, prompt_len=4)
    with pytest.raises(NotImplementedError, match="causal masking only"):
        pm.forward(params, torch.zeros((2, 4), dtype=torch.long),
                   cache=cache, cache_index=0,
                   attn_mask=torch.ones((2, 1, 4, 8), dtype=torch.bool))
    # Training on a seq mesh is refused, naming what is left.
    from distributed_llms_tpu_torch.runtime.train import Trainer

    with pytest.raises(NotImplementedError, match="later slices"):
        Trainer(cfg, parallel=_layout_pm(cfg, seq=2))
