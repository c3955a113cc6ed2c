"""The port's host tier (``runtime/kv_tier.py``) and parcel format against
the JAX package's, on the CPU.

- The same script of ``park_swap`` / ``take_swap`` / ``drop_swap`` /
  ``park_spill`` / ``has_spill`` / ``take_spill`` / ``can_fit`` /
  ``stats`` / ``assert_consistent`` calls on the reference's ``HostTier``
  and the port's gives the same returns: handles, page counts, stats, the
  parcels' bytes (exactly), ``None`` where the reference returns it.
  Cases: swaps evict spills oldest first and never the other way, an
  over-budget park returns None, a parcel corrupted through ``corrupt=``
  (at park or at take, swap or spill) fails verification, a stranded
  handle fails the audit, a re-spilled digest counts once.
- The port's arena: the budget is its slots (every slot free or held by
  exactly one parcel), so parking never allocates.
- ``_export_pages_raw`` gathers the same bytes as the reference's from the
  same pool, bf16 and int8 with its f32 scales, and ``_import_pages_raw``
  of the export restores a pool to the byte.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.models.model import KVCache as JKV
from distributed_llms_tpu.models.model import QuantKVCache as JQKV
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.kv_tier import HostTier as RefTier
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.models.model import KVCache, QuantKVCache
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.kv_tier import HostParcel, HostTier

L, BLK, KVH, HD = 2, 4, 2, 8
LAYOUT = [((L, BLK, KVH, HD), torch.float32)] * 2


def payload(n, seed):
    """A parcel of ``n`` pages in export layout: numpy for the reference,
    the same values as CPU tensors for the port."""
    rng = np.random.default_rng(seed)
    arrays = tuple(rng.standard_normal((L, n, BLK, KVH, HD)).astype(
        np.float32) for _ in range(2))
    return arrays, tuple(torch.from_numpy(a.copy()) for a in arrays)


def plain(x):
    """A take's return, comparable across the stacks."""
    if isinstance(x, HostParcel):
        return tuple(a.contiguous().numpy() for a in x.to("cpu"))
    return x


def same(a, b):
    """Equal results; a parcel's arrays byte-equal (the reference returns a
    spilled page without its page axis, the port a one-page parcel)."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(
            np.array_equal(np.ravel(x), np.ravel(y)) for x, y in zip(a, b))
    return a == b


def script(tier, port: bool):
    """One sequence of tier calls; returns every call's result."""
    pick = 1 if port else 0
    out = []
    park = lambda n, seed, **kw: tier.park_swap(  # noqa: E731
        payload(n, seed)[pick], n, **kw)
    h0 = park(3, 0)
    out += [h0, tier.park_spill([b"a", b"b", b"c"], payload(3, 1)[pick]),
            tier.stats(), tier.can_fit(5), tier.can_fit(6)]
    # A swap of 4 pages needs 2 more than are free: the two OLDEST spills
    # go, the youngest stays.
    h1 = park(4, 2)
    out += [h1, tier.stats(), tier.has_spill(b"a"), tier.has_spill(b"b"),
            tier.has_spill(b"c")]
    # Over budget even with every spill evicted: None (and "c" is gone).
    out += [park(5, 3), tier.stats(), tier.has_spill(b"c")]
    # Swaps are never evicted for spills: a full tier parks no spill.
    out += [tier.park_spill([b"x"], payload(1, 9)[pick]), tier.stats()]
    out += [plain(tier.take_swap(h0)), tier.take_swap(h0), tier.stats()]
    # A re-spilled digest replaces its entry and counts one page.
    out += [tier.park_spill([b"e"], payload(1, 4)[pick]),
            tier.park_spill([b"e", b"f"], payload(2, 5)[pick]),
            tier.stats(), plain(tier.take_spill(b"e")),
            tier.take_spill(b"e"), tier.has_spill(b"f")]
    # Corruption caught at verification, park side and take side; the
    # budget is released either way.
    out += [tier.park_spill([b"d"], payload(1, 6)[pick], corrupt=True),
            tier.take_spill(b"d")]
    hc = park(2, 7, corrupt=True)
    out += [hc, tier.take_swap(hc)]
    ht = park(2, 8)
    out += [ht, tier.take_swap(ht, corrupt=True), tier.stats()]
    # The audit: the queued owner of h1 passes, a stranded h1 fails.
    tier.assert_consistent([h1])
    with pytest.raises(AssertionError, match="swap handles"):
        tier.assert_consistent([])
    tier.drop_swap(h1)
    tier.drop_swap(h1)  # idempotent
    tier.assert_consistent([])
    out += [tier.stats(), plain(tier.take_spill(b"f")), tier.stats()]
    return out


def test_tier_script_matches_the_reference():
    want = script(RefTier(8), port=False)
    port = HostTier(8, LAYOUT)
    got = script(port, port=True)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert same(g, w), f"call {i}: port {g!r} != reference {w!r}"
    port.assert_consistent([])


def test_tier_counts_spill_evictions_like_the_reference():
    from distributed_llms_tpu.core.observability import METRICS as JM

    j0 = JM.get_counter("batcher.host_tier.spill_evictions")
    t0 = METRICS.get_counter("batcher.host_tier.spill_evictions")
    script(RefTier(8), port=False)
    script(HostTier(8, LAYOUT), port=True)
    assert (METRICS.get_counter("batcher.host_tier.spill_evictions") - t0
            == JM.get_counter("batcher.host_tier.spill_evictions") - j0 > 0)


def test_arena_slots_bound_the_budget():
    """Every slot is free or held by exactly one parcel; a taken parcel's
    slots are reused by the next park; a run of consecutive slots keeps
    the parcel's page order."""
    tier = HostTier(6, LAYOUT)
    _, p3 = payload(3, 0)
    h = tier.park_swap(p3, 3)
    tier.park_spill([b"s"], payload(1, 1)[1])
    assert tier.take_swap(h).slots == [0, 1, 2]
    _, p4 = payload(4, 2)
    h2 = tier.park_swap(p4, 4)
    assert sorted(tier._swaps[h2].slots) == [0, 1, 2, 4]
    parcel = tier.take_swap(h2)
    got = parcel.to("cpu")
    for a, b in zip(got, p4):
        assert torch.equal(a, b)
    tier.assert_consistent([])
    assert tier.pinned_bytes == 0  # the CPU arena is not pinned
    assert tier._arena[0].shape == (6, L, BLK, KVH, HD)


def test_tier_refuses_an_empty_budget():
    with pytest.raises(ValueError, match=">= 1 page"):
        HostTier(0, LAYOUT)


def _pools(kv_bits, seed=0, pages=7):
    """The same pool in both stacks: bf16 K/V, or int8 codes + f32 scales."""
    rng = np.random.default_rng(seed)
    shape = (L, pages, BLK, KVH, HD)
    if kv_bits == 16:
        k, v = (rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
                for _ in range(2))
        bf = lambda a: torch.from_numpy(  # noqa: E731
            a.view(np.int16).copy()).view(torch.bfloat16)
        return (JKV(k=jnp.asarray(k), v=jnp.asarray(v)),
                KVCache(k=bf(k), v=bf(v)))
    k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.random(shape[:-1]).astype(np.float32) for _ in range(2))
    return (JQKV(k=jnp.asarray(k), v=jnp.asarray(v), k_scale=jnp.asarray(ks),
                 v_scale=jnp.asarray(vs), row_dtype="bfloat16"),
            QuantKVCache(k=torch.from_numpy(k), v=torch.from_numpy(v),
                         k_scale=torch.from_numpy(ks),
                         v_scale=torch.from_numpy(vs),
                         row_dtype="bfloat16"))


def _bits(a):
    """Raw bytes of a JAX array or a tensor, for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype == ml_dtypes.bfloat16
            else a).view(np.uint8)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_export_matches_the_reference_and_import_restores(kv_bits):
    jpool, tpool = _pools(kv_bits)
    pages = [5, 2, 6]
    want = jb._export_pages_raw(jpool, jnp.asarray(pages, jnp.int32))
    got = tb._export_pages_raw(tpool, torch.tensor(pages, dtype=torch.int32))
    assert len(got) == len(want) == (4 if kv_bits == 8 else 2)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) == (
            (L, 3, BLK, KVH, HD) if g.dim() == 5 else (L, 3, BLK, KVH))
        assert np.array_equal(_bits(g), _bits(w))
    # Through the tier (a slot per page) and back into other pages of a
    # zeroed pool: those pages equal the originals to the byte, the rest
    # stay zero.
    tier = HostTier(4, tb.page_layout(tpool))
    h = tier.park_swap(got, 3)
    _, fresh = _pools(kv_bits, seed=1)
    arrays = (fresh.k, fresh.v) + ((fresh.k_scale, fresh.v_scale)
                                   if kv_bits == 8 else ())
    for a in arrays:
        a.zero_()
    dest = [1, 3, 4]
    tb._import_pages_raw(fresh, torch.tensor(dest, dtype=torch.int32),
                         *tier.take_swap(h).to("cpu"))
    src = (tpool.k, tpool.v) + ((tpool.k_scale, tpool.v_scale)
                                if kv_bits == 8 else ())
    for a, b in zip(arrays, src):
        assert torch.equal(a[:, dest], b[:, pages])
        assert not a[:, [0, 2, 5, 6]].any()
    # The reference's import of its own export writes the same bytes.
    jfresh = jb._import_pages_raw(
        _pools(kv_bits, seed=1)[0], jnp.asarray(dest, jnp.int32), *want)
    jarrays = (jfresh.k, jfresh.v) + ((jfresh.k_scale, jfresh.v_scale)
                                      if kv_bits == 8 else ())
    for a, j in zip(arrays, jarrays):
        assert np.array_equal(_bits(a[:, dest]),
                              _bits(np.asarray(j)[:, dest]))
