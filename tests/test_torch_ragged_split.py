"""The split-K plan of the contiguous decode kernels (K2, K2q), on the CPU.

The CUDA kernel (``ops/csrc/split_decode.cuh``) cuts each row's band into
splits that separate blocks attend, then merges their partial softmax
states.  What of that design the CPU can check, it checks here; the kernel
itself is held against the plain version on the card
(tests/test_torch_gpu_kernels.py, chip_smoke.py).

(a) The planner (``ragged_split_plan``, ``ragged_split_bounds``,
    ``split_scratch``): for random shapes, windows and SM counts the
    split length is a multiple of 64, the splits cover every possible row's
    band ``[lo, len)`` exactly once (lengths 0, 1, S, S + 1 and multiples
    of the split length +- 1), the grid comes near the target block count,
    and the scratch shapes follow from the plan alone.

(b) A numpy model of split-and-merge, written here: per split its local
    max m_s, sum l_s and unnormalized accumulator, then out = sum_s
    exp(m_s - M) acc_s / max(sum_s exp(m_s - M) l_s, 1e-37).  It is held
    against the JAX package's Pallas kernel in interpret mode on bf16 and
    int8 caches, at split lengths 64, 128 and 192, over rows of length 0,
    1, past the cache and at each split edge, with windows none, 1, 100
    and longer than every row:
    - float32 queries: the JAX kernel rounds nothing (p is cast to the
      float32 value dtype), so the model matches to 1e-5 (summation order);
    - bf16 queries: both round p (times v_scale in the int8 leg) to bf16 —
      the kernel under its running max per 128-slot block, the model under
      the split's max — and round the output to bf16, so each output row
      (one query, one head) is held to an L2 error of 1e-2 of its norm; a
      row with no live slot must be exactly zero in both.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.ops import decode_attn as jax_decode_attn
from distributed_llms_tpu_torch.checkpoint import quantize as tq
from distributed_llms_tpu_torch.ops import decode_attn

UNIT = decode_attn.SPLIT_UNIT
TOL_F32 = 1e-5
ROW_REL_BF16 = 1e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the planner -----------------------------------------------------------

def _band(length, s, window):
    """[lo, len) of a row, computed independently of the port."""
    end = min(max(length, 0), s)
    lo = 0 if window is None else max(0, min(end, length - window))
    return lo, end


def _edge_lengths(s, split_len, n_splits, window):
    lengths = {0, 1, s, s + 1, s - 1}
    lo_shift = 0 if window is None else window
    for i in range(1, n_splits + 1):
        for delta in (-1, 0, 1):
            lengths.add(i * split_len + delta)
            lengths.add(lo_shift + i * split_len + delta)
    return sorted(x for x in lengths if x >= 0)


@pytest.mark.parametrize("seed", range(6))
def test_plan_covers_every_band_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(6):
        b = int(rng.integers(1, 65))
        kvh = int(rng.choice([1, 2, 8, 32]))
        s = int(rng.integers(1, 40000))
        sm = int(rng.choice([1, 16, 132, 144]))
        for window in (None, 1, 64, 4096, s + int(rng.integers(1, 100))):
            split_len, n_splits = decode_attn.ragged_split_plan(
                b, kvh, s, window, sm)
            span = s if window is None else min(s, window)
            assert split_len % UNIT == 0 and split_len >= UNIT
            assert (n_splits - 1) * split_len < span <= n_splits * split_len
            # Near the target grid: at most the target, at least half of
            # it unless the band has fewer 64-slot units than wanted.
            want = -(-decode_attn.BLOCKS_PER_SM * sm // (b * kvh))
            units = -(-span // UNIT)
            assert n_splits <= max(want, 1)
            assert 2 * n_splits >= min(want, units)
            for length in _edge_lengths(s, split_len, n_splits, window):
                lo, end = _band(length, s, window)
                runs = [decode_attn.ragged_split_bounds(
                    length, s, window, split_len, i) for i in range(n_splits)]
                live = [(a, z) for a, z in runs if a < z]
                covered = [x for a, z in live for x in range(a, z)]
                assert covered == list(range(lo, end)), (length, window)
                assert all(z - a <= split_len for a, z in live)


def test_plan_at_the_served_shapes():
    """Mistral-7B at batch 8 (paths c and f) and one long row at batch 1,
    on an H100's 132 SMs."""
    assert decode_attn.ragged_split_plan(8, 8, 6144, 4096, 132) == (256, 16)
    assert decode_attn.ragged_split_plan(8, 8, 32768, 4096, 132) == (256, 16)
    assert decode_attn.ragged_split_plan(1, 8, 32768, 4096, 132) == (64, 64)
    assert decode_attn.ragged_split_plan(8, 8, 6144, None, 132) == (384, 16)


def test_scratch_follows_from_the_plan():
    for b, kvh, g, d, s, window, sm in ((8, 8, 4, 128, 6144, 4096, 132),
                                        (1, 8, 4, 128, 32768, None, 132),
                                        (3, 2, 16, 256, 300, 5000, 8)):
        _, n = decode_attn.ragged_split_plan(b, kvh, s, window, sm)
        shapes = decode_attn.split_scratch(b, kvh, g, d, n)
        assert shapes == {"acc": (b, kvh, n, g, d), "m": (b, kvh, n, g),
                          "l": (b, kvh, n, g)}
    # One split: the blocks write the output, no partials.
    assert decode_attn.ragged_split_plan(2, 2, 64, None, 132) == (64, 1)
    assert decode_attn.split_scratch(2, 2, 4, 128, 1) == {}


# -- (b) split-and-merge against the JAX kernel ------------------------------

def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def split_merge_model(q, k, v, lengths, window, split_len, ks=None, vs=None,
                      round_p=False, rescale=True):
    """out [B, 1, H, D] float32: each split's (m_s, l_s, acc_s) over its
    slots of the band, then the merge.  ``round_p`` rounds the value
    product's weights (p, times v_scale in the int8 leg) to bf16, as the
    kernels do; ``rescale=False`` plants a fault: the merge weighs every
    live split 1 instead of exp(m_s - M)."""
    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    span = s if window is None else min(s, window)
    n_splits = math.ceil(span / split_len)
    out = np.zeros((b, 1, h, d), np.float32)
    for bi in range(b):
        for hh in range(kvh):
            qg = q[bi, 0, hh * g:(hh + 1) * g].astype(np.float32)
            parts = []
            for i in range(n_splits):
                a, z = decode_attn.ragged_split_bounds(
                    int(lengths[bi]), s, window, split_len, i)
                if a == z:
                    parts.append((np.full(g, -np.inf, np.float32),
                                  np.zeros(g, np.float32),
                                  np.zeros((g, d), np.float32)))
                    continue
                kk = k[bi, a:z, hh].astype(np.float32)
                vv = v[bi, a:z, hh].astype(np.float32)
                sc = (qg @ kk.T) * np.float32(d ** -0.5)
                if ks is not None:
                    sc = sc * ks[bi, a:z, hh][None, :]
                m = sc.max(axis=-1)
                p = np.exp(sc - m[:, None])
                l = p.sum(axis=-1)
                if vs is not None:
                    p = p * vs[bi, a:z, hh][None, :]
                if round_p:
                    p = _bf16(p)
                parts.append((m, l, p @ vv))
            m_all = np.stack([p[0] for p in parts])  # [n, g]
            mm = m_all.max(axis=0)
            live = mm > -np.inf
            w = np.exp(m_all - np.where(live, mm, 0.0)[None, :])
            if not rescale:
                w = np.isfinite(m_all).astype(np.float32)
            w[:, ~live] = 0.0
            num = sum(w[i][:, None] * parts[i][2] for i in range(n_splits))
            den = sum(w[i] * parts[i][1] for i in range(n_splits))
            out[bi, 0, hh * g:(hh + 1) * g] = num / np.maximum(den, 1e-37)[:, None]
    return out


S = 384  # three 128-slot blocks of the JAX kernel
LENGTHS = [0, 1, 63, 64, 65, 127, 128, 129, 191, 192, 193, 255, 257, 383,
           384, 385, 100]


def _inputs(seed, quant, q_dtype):
    rng = np.random.default_rng(seed)
    b, h, kvh, d = len(LENGTHS), 8, 2, 128
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = _bf16(rng.standard_normal((b, S, kvh, d)))
    v = _bf16(rng.standard_normal((b, S, kvh, d)))
    if q_dtype == "bf16":
        q = _bf16(q)
    ks = vs = None
    if quant:
        kq, kss = tq.kv_quantize(torch.from_numpy(k))
        vq, vss = tq.kv_quantize(torch.from_numpy(v))
        k, v, ks, vs = (t.numpy() for t in (kq, vq, kss, vss))
    return q, k, v, np.asarray(LENGTHS, np.int32), ks, vs


def _jax_kernel(q, k, v, lengths, window, ks, vs, q_dtype):
    jq = jnp.asarray(q)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if q_dtype == "bf16":
        jq = jq.astype(jnp.bfloat16)
    if ks is None:  # a bf16 cache (its values are bf16 already)
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    scales = () if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    out = jax_decode_attn._ragged_impl(jq, jk, jv, jnp.asarray(lengths),
                                       *scales, window=window,
                                       mode="interpret")
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("window", [None, 1, 100, 1000])
@pytest.mark.parametrize("q_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_cache",
                                                       "int8_cache"])
def test_split_merge_model_matches_jax_interpret_kernel(quant, q_dtype,
                                                        window):
    q, k, v, lengths, ks, vs = _inputs(20 + quant, quant, q_dtype)
    want = _jax_kernel(q, k, v, lengths, window, ks, vs, q_dtype)
    empty = np.array([_band(int(x), S, window)[0] == _band(int(x), S, window)[1]
                      for x in lengths])
    assert empty[0] and not np.isnan(want).any()
    assert (want[empty] == 0).all()
    for split_len in (64, 128, 192):
        got = split_merge_model(q, k, v, lengths, window, split_len, ks, vs,
                                round_p=q_dtype == "bf16")
        assert not np.isnan(got).any() and (got[empty] == 0).all()
        if q_dtype == "f32":
            np.testing.assert_allclose(got, want, atol=TOL_F32, rtol=TOL_F32)
            continue
        got = _bf16(got)
        diff = np.linalg.norm(got - want, axis=-1)[~empty]
        ref = np.linalg.norm(want, axis=-1)[~empty]
        assert (diff / ref).max() <= ROW_REL_BF16, (split_len,
                                                    (diff / ref).max())


def test_merge_without_rescale_is_caught():
    """The bf16 comparison above fails a merge that drops exp(m_s - M):
    the splits of one row have different maxima."""
    q, k, v, lengths, ks, vs = _inputs(22, False, "bf16")
    want = _jax_kernel(q, k, v, lengths, None, ks, vs, "bf16")
    got = _bf16(split_merge_model(q, k, v, lengths, None, 64, round_p=True,
                                  rescale=False))
    live = np.linalg.norm(want, axis=-1) > 0
    rel = (np.linalg.norm(got - want, axis=-1)[live]
           / np.linalg.norm(want, axis=-1)[live])
    assert rel.max() > 10 * ROW_REL_BF16
