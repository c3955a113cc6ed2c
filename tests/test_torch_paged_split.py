"""The split-K plan of the paged decode kernels (K1, K1q), on the CPU.

The CUDA kernel (``ops/csrc/paged_decode_attn.cu`` on
``ops/csrc/split_decode.cuh``) cuts the table's reach ``P * BLK`` into
splits of whole pages that separate blocks attend, then merges their
partial softmax states.  What of that design the CPU can check, it checks
here; the kernel itself is held against the plain version on the card
(tests/test_torch_gpu_kernels.py, chip_smoke.py).

(a) The planner (``paged_split_plan``, ``paged_split_bounds``): for random
    B, KVH, P, BLK (1, 16, 48, 64 and others) and SM counts the split
    length is a multiple of BLK, the splits cover ``[0, min(len, P *
    BLK))`` exactly once (lengths 0, 1, page edges +- 1, split edges +- 1,
    P * BLK and P * BLK + 1), no split reaches a table entry past the
    row's depth, the grid comes near the target block count, and the plans
    at the served shapes are the ones the design states.  The wrapper
    plans without reading ``lengths``: its CUDA branch, driven with a fake
    kernel entry on CPU tensors, runs with a ``lengths`` whose values
    cannot be read.

(b) A numpy model of split-over-pages and merge, written here, that
    gathers each slot through the table: per split its local max m_s, sum
    l_s and unnormalized accumulator, then out = sum_s exp(m_s - M) acc_s /
    max(sum_s exp(m_s - M) l_s, 1e-37).  It is held against the JAX
    package's Pallas kernel in interpret mode on bf16 and int8 pools, page
    sizes 16 and 48, at splits of 1, 2 and 4 pages, with in-pool garbage
    in the table past each row's depth (the model asserts it never reads
    one):
    - float32 queries: the JAX kernel rounds nothing, so the model matches
      to 1e-5 (summation order);
    - bf16 queries: both round p (times v_scale in the int8 leg) to bf16 —
      the kernel under its running max per page, the model under the
      split's max — and round the output to bf16, so each output row (one
      query, one head) is held to an L2 error of 1e-2 of its norm; a row
      of length 0 must be exactly zero in both.

(c) The bf16 comparison fails a merge that drops exp(m_s - M).
"""

import math
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.ops import decode_attn as jax_decode_attn
from distributed_llms_tpu_torch.checkpoint import quantize as tq
from distributed_llms_tpu_torch.ops import decode_attn

TOL_F32 = 1e-5
ROW_REL_BF16 = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the planner -----------------------------------------------------------

def _edge_lengths(p, blk, split_len, n_splits):
    reach = p * blk
    lengths = {0, 1, blk - 1, blk, blk + 1, reach - 1, reach, reach + 1}
    for i in range(1, n_splits + 1):
        for delta in (-1, 0, 1):
            lengths.add(i * split_len + delta)
    for page in range(1, min(p, 40) + 1):
        for delta in (-1, 0, 1):
            lengths.add(page * blk + delta)
    return sorted(x for x in lengths if x >= 0)


@pytest.mark.parametrize("seed", range(6))
def test_plan_covers_every_row_once_in_whole_pages(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        b = int(rng.integers(1, 65))
        kvh = int(rng.choice([1, 2, 8, 32]))
        blk = int(rng.choice([1, 16, 48, 64, int(rng.integers(2, 200))]))
        p = int(rng.integers(1, 600))
        sm = int(rng.choice([1, 16, 132, 144]))
        split_len, n_splits = decode_attn.paged_split_plan(b, kvh, p, blk, sm)
        reach = p * blk
        assert split_len % blk == 0 and split_len >= blk
        assert split_len // blk <= decode_attn.MAX_SPLIT_PAGES
        assert (n_splits - 1) * split_len < reach <= n_splits * split_len
        # At least SPLIT_UNIT slots a split where the table reaches that far.
        assert split_len >= min(decode_attn.SPLIT_UNIT, reach)
        # Near the target grid: at most the target (or what the page cap
        # forces), at least half of it unless the table has fewer
        # smallest splits than wanted.
        want = -(-decode_attn.BLOCKS_PER_SM * sm // (b * kvh))
        unit = max(1, -(-decode_attn.SPLIT_UNIT // blk))
        units = -(-p // unit)
        assert n_splits <= max(want, -(-p // decode_attn.MAX_SPLIT_PAGES), 1)
        assert 2 * n_splits >= min(want, units)
        for length in _edge_lengths(p, blk, split_len, n_splits):
            end = min(length, reach)
            depth = -(-end // blk)  # table entries the row may read
            runs = [decode_attn.paged_split_bounds(length, p, blk, split_len,
                                                   i) for i in range(n_splits)]
            live = [(a, z) for a, z in runs if a < z]
            covered = [x for a, z in live for x in range(a, z)]
            assert covered == list(range(end)), (length, blk, split_len)
            for i, (a, z) in enumerate(runs):
                if a < z:  # starts on its own page run, ends inside depth
                    assert a == i * split_len and a % blk == 0
                    assert (z - 1) // blk < depth
                    assert z - a <= split_len


def test_plan_at_the_served_shapes():
    """On an H100's 132 SMs: path a (Llama-3-8B, 8 rows, max_len 1024 over
    64-slot pages), the smoke's timing shape (2048-slot tables), one
    8192-slot row at batch 1, and 16-slot pages over 2048 slots."""
    assert decode_attn.paged_split_plan(8, 8, 16, 64, 132) == (64, 16)
    assert decode_attn.paged_split_plan(8, 8, 32, 64, 132) == (128, 16)
    assert decode_attn.paged_split_plan(1, 8, 128, 64, 132) == (64, 128)
    assert decode_attn.paged_split_plan(8, 8, 128, 16, 132) == (128, 16)
    # A table narrower than SPLIT_UNIT slots is one split of its reach.
    assert decode_attn.paged_split_plan(1, 1, 9, 1, 132) == (9, 1)


class _Unreadable(torch.Tensor):
    """A tensor whose values cannot be read: any operation but the
    metadata a launch passes along raises."""

    _ALLOWED = {"shape", "dtype", "device", "is_contiguous", "data_ptr",
                "dim", "size", "__get__", "ndim"}

    @classmethod
    def __torch_function__(cls, func, types_, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name not in cls._ALLOWED:
            raise AssertionError(f"the wrapper read lengths ({name})")
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("quant", [False, True])
def test_wrapper_plans_from_shapes_without_reading_lengths(monkeypatch,
                                                           quant):
    """The CUDA branch of the wrapper, driven on CPU tensors with a fake
    kernel entry: the plan it launches is the shape plan, every argument
    list matches the entry's declared types, and ``lengths`` is never
    read (its values differ between the two calls; the launches match)."""
    calls = []

    def entry(source, name, argtypes):
        def launch(*args):
            assert source == decode_attn.PAGED_SOURCE
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(decode_attn, "_route", lambda name, tensors: "cuda")
    monkeypatch.setattr(decode_attn, "_sm_count", lambda device: 132)
    monkeypatch.setattr(decode_attn.build, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    b, h, kvh, d, blk, p = 8, 32, 8, 128, 64, 16
    q = torch.zeros(b, 1, h, d, dtype=torch.bfloat16)
    pool = torch.zeros(b * p + 1, blk, kvh, d, dtype=torch.bfloat16)
    scales = {}
    if quant:
        pool = pool.to(torch.int8)
        sc = torch.ones(b * p + 1, blk, kvh)
        scales = {"k_scale": sc, "v_scale": sc}
    tables = torch.arange(1, b * p + 1, dtype=torch.int32).reshape(b, p)
    launches = decode_attn.paged_decode_attention.launches
    for fill in (0, p * blk):
        lengths = torch.full((b,), fill, dtype=torch.int32).as_subclass(
            _Unreadable)
        decode_attn.paged_decode_attention(q, pool, pool, lengths, tables,
                                           **scales)
    names = {name for name, _ in calls}
    assert names == {"dlt_paged_decode_attention_int8" if quant
                     else "dlt_paged_decode_attention"}
    # The trailing (..., P, split_len, n_splits, scale, stream) of both.
    tails = [args[-5:-2] for _, args in calls]
    assert tails[0] == tails[1] == (p, 64, 16)
    assert decode_attn.paged_decode_attention.launches == launches + (
        0 if quant else 2)


# -- (b) split-over-pages and merge against the JAX kernel ---------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def paged_split_merge_model(q, k, v, lengths, tables, split_len, ks=None,
                            vs=None, round_p=False, rescale=True):
    """out [B, 1, H, D] float32: each split's (m_s, l_s, acc_s) over its
    slots, each slot gathered through the row's table, then the merge.
    ``round_p`` rounds the value product's weights (p, times v_scale in
    the int8 leg) to bf16, as the kernels do; ``rescale=False`` plants a
    fault: the merge weighs every live split 1 instead of exp(m_s - M)."""
    b, _, h, d = q.shape
    blk, kvh = k.shape[1], k.shape[2]
    p = tables.shape[1]
    g = h // kvh
    n_splits = math.ceil(p * blk / split_len)
    out = np.zeros((b, 1, h, d), np.float32)
    for bi in range(b):
        depth = -(-min(max(int(lengths[bi]), 0), p * blk) // blk)
        for hh in range(kvh):
            qg = q[bi, 0, hh * g:(hh + 1) * g].astype(np.float32)
            parts = []
            for i in range(n_splits):
                a, z = decode_attn.paged_split_bounds(
                    int(lengths[bi]), p, blk, split_len, i)
                if a == z:
                    parts.append((np.full(g, -np.inf, np.float32),
                                  np.zeros(g, np.float32),
                                  np.zeros((g, d), np.float32)))
                    continue
                slots = np.arange(a, z)
                entry = slots // blk
                assert entry.max() < depth  # never past the row's depth
                page, row = tables[bi, entry], slots % blk
                kk = k[page, row, hh].astype(np.float32)
                vv = v[page, row, hh].astype(np.float32)
                sc = (qg @ kk.T) * np.float32(d ** -0.5)
                if ks is not None:
                    sc = sc * ks[page, row, hh][None, :]
                m = sc.max(axis=-1)
                pr = np.exp(sc - m[:, None])
                l = pr.sum(axis=-1)
                if vs is not None:
                    pr = pr * vs[page, row, hh][None, :]
                if round_p:
                    pr = _bf16(pr)
                parts.append((m, l, pr @ vv))
            m_all = np.stack([x[0] for x in parts])  # [n, g]
            mm = m_all.max(axis=0)
            live = mm > -np.inf
            w = np.exp(m_all - np.where(live, mm, 0.0)[None, :])
            if not rescale:
                w = np.isfinite(m_all).astype(np.float32)
            w[:, ~live] = 0.0
            num = sum(w[i][:, None] * parts[i][2] for i in range(n_splits))
            den = sum(w[i] * parts[i][1] for i in range(n_splits))
            out[bi, 0, hh * g:(hh + 1) * g] = (
                num / np.maximum(den, 1e-37)[:, None])
    return out


P = 6  # table entries per row


def _lengths(blk):
    reach = P * blk
    return [0, 1, blk - 1, blk, blk + 1, 2 * blk - 1, 2 * blk + 1,
            4 * blk - 1, 4 * blk + 1, reach - 1, reach, reach + 1,
            3 * blk + 5]


def _inputs(seed, blk, quant, q_dtype):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(_lengths(blk), np.int32)
    b, h, kvh, d = len(lengths), 8, 2, 128
    nb = b * P + 1
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = _bf16(rng.standard_normal((nb, blk, kvh, d)))
    v = _bf16(rng.standard_normal((nb, blk, kvh, d)))
    if q_dtype == "bf16":
        q = _bf16(q)
    tables = (rng.permutation(nb - 1)[: b * P] + 1).reshape(b, P)
    # Garbage past each row's depth — kept inside the pool, since the JAX
    # kernel's index map reads entry 0 of a length-0 row.
    depth = -(-np.clip(lengths, 0, P * blk) // blk)
    past = np.arange(P)[None, :] >= depth[:, None]
    tables = np.where(past, rng.integers(0, nb, (b, P)), tables)
    ks = vs = None
    if quant:
        kq, kss = tq.kv_quantize(torch.from_numpy(k))
        vq, vss = tq.kv_quantize(torch.from_numpy(v))
        k, v, ks, vs = (t.numpy() for t in (kq, vq, kss, vss))
    return q, k, v, lengths, tables.astype(np.int32), ks, vs


def _jax_kernel(q, k, v, lengths, tables, ks, vs, q_dtype):
    jq = jnp.asarray(q)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if q_dtype == "bf16":
        jq = jq.astype(jnp.bfloat16)
    if ks is None:  # a bf16 pool (its values are bf16 already)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    scales = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    out = jax_decode_attn._paged_impl(jq, jk, jv, jnp.asarray(lengths),
                                      jnp.asarray(tables), *scales,
                                      mode="interpret")
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("blk", [16, 48])
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_pool",
                                                       "int8_pool"])
def test_split_merge_model_matches_jax_interpret_kernel(quant, q_dtype, blk):
    q, k, v, lengths, tables, ks, vs = _inputs(30 + quant, blk, quant,
                                               q_dtype)
    want = _jax_kernel(q, k, v, lengths, tables, ks, vs, q_dtype)
    empty = lengths <= 0
    assert empty[0] and not np.isnan(want).any()
    assert (want[empty] == 0).all()
    for pages in (1, 2, 4):
        got = paged_split_merge_model(q, k, v, lengths, tables, pages * blk,
                                      ks, vs, round_p=q_dtype == "bf16")
        assert not np.isnan(got).any() and (got[empty] == 0).all()
        if q_dtype == "f32":
            np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=TOL_F32)
            continue
        got = _bf16(got)
        diff = np.linalg.norm(got - want, axis=-1)[~empty]
        ref = np.linalg.norm(want, axis=-1)[~empty]
        assert (diff / ref).max() <= ROW_REL_BF16, (pages,
                                                    (diff / ref).max())


def test_merge_without_rescale_is_caught():
    """(c) The bf16 comparison above fails a merge that drops
    exp(m_s - M): the splits of one row have different maxima."""
    q, k, v, lengths, tables, ks, vs = _inputs(32, 16, False, "bf16")
    want = _jax_kernel(q, k, v, lengths, tables, ks, vs, "bf16")
    got = _bf16(paged_split_merge_model(q, k, v, lengths, tables, 16,
                                        round_p=True, rescale=False))
    live = np.linalg.norm(want, axis=-1) > 0
    rel = (np.linalg.norm(got - want, axis=-1)[live]
           / np.linalg.norm(want, axis=-1)[live])
    assert rel.max() > 10 * ROW_REL_BF16
