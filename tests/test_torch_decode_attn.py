"""Decode attention of the PyTorch/CUDA port against the JAX package.

CPU: the port's plain versions (the path a CPU tensor takes) against the
JAX Pallas kernels run in interpret mode and against the JAX dense
reference, on the same numpy inputs, float32:

- paged bf16 leg (K1) and contiguous ragged leg with a sliding window
  (K2): atol = rtol = 1e-5 — the kernel's online softmax and the dense
  softmax differ only in summation order;
- paged int8 leg (K1q) and contiguous int8 leg (K2q): atol = rtol = 1e-5
  as well — the kernel folds the absmax scales into the score and the
  probabilities, the plain version dequantizes first (float32(data) *
  scale); in float32 both differ only by rounding order.

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_gpu_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.checkpoint import quantize as jq
from distributed_llms_tpu.ops import decode_attn as jax_decode_attn
from distributed_llms_tpu_torch.checkpoint import quantize as tq
from distributed_llms_tpu_torch.ops import decode_attn

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # Tiny ops: the default thread pool only contends with the other test
    # workers on the host.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paged_inputs(seed, b, h, kvh, d, blk, p, lengths, dtype=np.float32,
                  garbage=True):
    rng = np.random.default_rng(seed)
    nb = b * p + 1
    q = rng.standard_normal((b, 1, h, d)).astype(dtype)
    k = rng.standard_normal((nb, blk, kvh, d)).astype(dtype)
    v = rng.standard_normal((nb, blk, kvh, d)).astype(dtype)
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p)
    lengths = np.asarray(lengths, np.int32)
    if garbage:
        # Entries past each row's depth are arbitrary — but kept inside the
        # pool, since the JAX fallback gathers every entry.
        depth = -(-lengths // blk)
        past = np.arange(p)[None, :] >= depth[:, None]
        tables = np.where(past, rng.integers(0, nb, (b, p)), tables)
    return q, k, v, lengths, tables.astype(np.int32)


CASES = [
    # b, h, kvh, d, blk, p, lengths
    (2, 4, 2, 128, 16, 4, [1, 64]),
    (3, 8, 2, 128, 8, 6, [5, 17, 48]),
    (1, 4, 4, 128, 16, 3, [33]),
]


@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", CASES)
def test_plain_matches_jax_interpret_kernel(b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(0, b, h, kvh, d, blk, p, lengths)
    want = jax_decode_attn._paged_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        jnp.asarray(tables), mode="interpret",
    )
    got = decode_attn.paged_decode_attention(*map(torch.from_numpy,
                                                  (q, k, v, ln, tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", CASES)
def test_plain_matches_jax_dense_reference(b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(1, b, h, kvh, d, blk, p, lengths)
    k_rows = k[tables].reshape(b, p * blk, kvh, d)
    v_rows = v[tables].reshape(b, p * blk, kvh, d)
    want = jax_decode_attn._dense_reference(
        jnp.asarray(q), jnp.asarray(k_rows), jnp.asarray(v_rows),
        jnp.asarray(ln),
    )
    got = decode_attn.paged_reference(*map(torch.from_numpy,
                                           (q, k, v, ln, tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, ln, tables = map(torch.from_numpy, _paged_inputs(
        2, 2, 4, 2, 128, 16, 3, [10, 40]))
    before = decode_attn.paged_decode_attention.launches
    got = decode_attn.paged_decode_attention(q, k, v, ln, tables)
    assert torch.equal(got, decode_attn.paged_reference(q, k, v, ln, tables))
    assert decode_attn.paged_decode_attention.launches == before


def test_table_entries_past_depth_are_never_read():
    """Out-of-pool garbage past a row's depth must not matter (the CUDA
    kernel never reads it; the plain version replaces it before the
    gather)."""
    q, k, v, ln, tables = _paged_inputs(3, 2, 4, 2, 128, 16, 4, [3, 20],
                                        garbage=False)
    bad = tables.copy()
    bad[0, 1:] = -7
    bad[1, 2:] = 10 ** 6
    args = list(map(torch.from_numpy, (q, k, v, ln, tables)))
    got = decode_attn.paged_decode_attention(*args[:4], torch.from_numpy(bad))
    assert torch.equal(got, decode_attn.paged_decode_attention(*args))


def test_wrapper_rejects_bad_shapes():
    q, k, v, ln, tables = map(torch.from_numpy, _paged_inputs(
        4, 2, 4, 2, 128, 16, 3, [10, 40]))
    with pytest.raises(ValueError):
        decode_attn.paged_decode_attention(q[:, :, :3], k, v, ln, tables)
    with pytest.raises(ValueError):
        decode_attn.paged_decode_attention(q, k, v, ln[:1], tables)
    with pytest.raises(ValueError):
        decode_attn.paged_decode_attention(
            torch.cat([q, q], dim=1), k, v, ln, tables)


# -- the int8 leg (K1q) -------------------------------------------------------

def _quantized(k, v):
    kq, ks = tq.kv_quantize(torch.from_numpy(k))
    vq, vs = tq.kv_quantize(torch.from_numpy(v))
    return [t.numpy() for t in (kq, vq, ks, vs)]


@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", CASES)
def test_int8_plain_matches_jax_interpret_kernel(b, h, kvh, d, blk, p,
                                                 lengths):
    q, k, v, ln, tables = _paged_inputs(5, b, h, kvh, d, blk, p, lengths)
    kq, vq, ks, vs = _quantized(k, v)
    want = jax_decode_attn._paged_impl(
        *map(jnp.asarray, (q, kq, vq, ln, tables, ks, vs)), mode="interpret",
    )
    got = decode_attn.paged_decode_attention(
        *map(torch.from_numpy, (q, kq, vq, ln, tables)),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_int8_plain_is_dequantize_then_dense():
    b, h, kvh, d, blk, p, lengths = CASES[1]
    q, k, v, ln, tables = _paged_inputs(6, b, h, kvh, d, blk, p, lengths)
    kq, vq, ks, vs = _quantized(k, v)
    kr = np.asarray(jq.kv_dequantize(jnp.asarray(kq[tables]),
                                     jnp.asarray(ks[tables]), jnp.float32))
    vr = np.asarray(jq.kv_dequantize(jnp.asarray(vq[tables]),
                                     jnp.asarray(vs[tables]), jnp.float32))
    want = jax_decode_attn._dense_reference(
        jnp.asarray(q), jnp.asarray(kr.reshape(b, p * blk, kvh, d)),
        jnp.asarray(vr.reshape(b, p * blk, kvh, d)), jnp.asarray(ln))
    got = decode_attn.paged_reference(
        *map(torch.from_numpy, (q, kq, vq, ln, tables, ks, vs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_int8_cpu_call_counts_no_launch():
    q, k, v, ln, tables = _paged_inputs(7, 2, 4, 2, 128, 16, 3, [10, 40])
    kq, vq, ks, vs = map(torch.from_numpy, _quantized(k, v))
    before = (decode_attn.paged_decode_attention.launches,
              decode_attn.paged_decode_attention.int8_launches)
    decode_attn.paged_decode_attention(
        torch.from_numpy(q), kq, vq, torch.from_numpy(ln),
        torch.from_numpy(tables), k_scale=ks, v_scale=vs)
    assert (decode_attn.paged_decode_attention.launches,
            decode_attn.paged_decode_attention.int8_launches) == before


def test_quant_argument_contract():
    """The JAX package's _check_quant: both scales or neither, int8 data
    when scales are given (and, in the port, scales shaped like the pool's
    leading axes)."""
    q, k, v, ln, tables = map(torch.from_numpy, _paged_inputs(
        8, 2, 4, 2, 128, 16, 3, [10, 40]))
    kq, vq, ks, vs = map(torch.from_numpy, _quantized(k.numpy(), v.numpy()))
    with pytest.raises(ValueError, match="both"):
        decode_attn.paged_decode_attention(q, kq, vq, ln, tables, k_scale=ks)
    with pytest.raises(ValueError, match="not int8"):
        decode_attn.paged_decode_attention(q, k, v, ln, tables, k_scale=ks,
                                           v_scale=vs)
    with pytest.raises(ValueError, match="scales must be"):
        decode_attn.paged_decode_attention(q, kq, vq, ln, tables,
                                           k_scale=ks[:, :4], v_scale=vs)


# -- the contiguous ragged leg with a sliding window (K2) --------------------

def _ragged_inputs(seed, b, h, kvh, d, s, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


RAGGED_CASES = [
    # b, h, kvh, d, s, lengths
    (3, 4, 2, 128, 256, [1, 17, 256]),
    (2, 8, 2, 128, 128, [3, 100]),
    (4, 4, 4, 128, 256, [40, 200, 2, 129]),
]


@pytest.mark.parametrize("window", [None, 3, 17])
@pytest.mark.parametrize("b,h,kvh,d,s,lengths", RAGGED_CASES)
def test_ragged_plain_matches_jax_interpret_kernel(b, h, kvh, d, s, lengths,
                                                   window):
    q, k, v, ln = _ragged_inputs(10, b, h, kvh, d, s, lengths)
    want = jax_decode_attn._ragged_impl(
        *map(jnp.asarray, (q, k, v, ln)), window=window, mode="interpret")
    got = decode_attn.ragged_decode_attention(
        *map(torch.from_numpy, (q, k, v, ln)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("window", [None, 3, 17])
def test_ragged_plain_matches_jax_dense_reference(window):
    q, k, v, ln = _ragged_inputs(11, *RAGGED_CASES[0])
    want = jax_decode_attn._dense_reference(
        *map(jnp.asarray, (q, k, v, ln)), window=window)
    got = decode_attn.dense_reference(*map(torch.from_numpy, (q, k, v, ln)),
                                      window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_ragged_length_past_the_cache_stops_at_the_cache():
    """A length past the cache (S + 1): without a window the whole row is
    read; with one, the band [S + 1 - W, S) — the JAX kernel's mask, which
    the CUDA kernel follows too."""
    q, k, v, ln = _ragged_inputs(12, 2, 4, 2, 128, 128, [128, 128])
    over = np.array([129, 128], np.int32)
    args = list(map(torch.from_numpy, (q, k, v)))
    assert torch.equal(
        decode_attn.ragged_decode_attention(*args, torch.from_numpy(over)),
        decode_attn.ragged_decode_attention(*args, torch.from_numpy(ln)))
    want = jax_decode_attn._ragged_impl(
        *map(jnp.asarray, (q, k, v, over)), window=5, mode="interpret")
    got = decode_attn.ragged_decode_attention(*args, torch.from_numpy(over),
                                              window=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_ragged_cpu_call_counts_no_launch_and_checks_arguments():
    q, k, v, ln = map(torch.from_numpy, _ragged_inputs(
        13, 2, 4, 2, 128, 64, [10, 40]))
    before = decode_attn.ragged_decode_attention.launches
    decode_attn.ragged_decode_attention(q, k, v, ln, window=8)
    assert decode_attn.ragged_decode_attention.launches == before
    for window in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="window"):
            decode_attn.ragged_decode_attention(q, k, v, ln, window=window)
    with pytest.raises(ValueError):
        decode_attn.ragged_decode_attention(q, k[:1], v[:1], ln)
    with pytest.raises(ValueError):
        decode_attn.ragged_decode_attention(q[:, :, :3], k, v, ln)


# -- the contiguous int8 leg (K2q) -------------------------------------------

@pytest.mark.parametrize("window", [None, 3, 17])
@pytest.mark.parametrize("b,h,kvh,d,s,lengths", RAGGED_CASES)
def test_ragged_int8_plain_matches_jax_interpret_kernel(b, h, kvh, d, s,
                                                        lengths, window):
    q, k, v, ln = _ragged_inputs(14, b, h, kvh, d, s, lengths)
    kq, vq, ks, vs = _quantized(k, v)
    want = jax_decode_attn._ragged_impl(
        *map(jnp.asarray, (q, kq, vq, ln, ks, vs)), window=window,
        mode="interpret")
    got = decode_attn.ragged_decode_attention(
        *map(torch.from_numpy, (q, kq, vq, ln)), window=window,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_ragged_int8_plain_is_dequantize_then_dense():
    q, k, v, ln = _ragged_inputs(15, *RAGGED_CASES[0])
    kq, vq, ks, vs = _quantized(k, v)
    kr, vr = (jq.kv_dequantize(jnp.asarray(a), jnp.asarray(sc), jnp.float32)
              for a, sc in ((kq, ks), (vq, vs)))
    want = jax_decode_attn._dense_reference(jnp.asarray(q), kr, vr,
                                            jnp.asarray(ln), window=5)
    got = decode_attn.ragged_reference(
        *map(torch.from_numpy, (q, kq, vq, ln)), 5, torch.from_numpy(ks),
        torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_ragged_int8_cpu_call_counts_no_launch_and_checks_arguments():
    q, k, v, ln = _ragged_inputs(16, 2, 4, 2, 128, 64, [10, 40])
    kq, vq, ks, vs = map(torch.from_numpy, _quantized(k, v))
    q, k, v, ln = map(torch.from_numpy, (q, k, v, ln))
    fn = decode_attn.ragged_decode_attention
    before = (fn.launches, fn.int8_launches)
    fn(q, kq, vq, ln, window=8, k_scale=ks, v_scale=vs)
    assert (fn.launches, fn.int8_launches) == before
    with pytest.raises(ValueError, match="both"):
        fn(q, kq, vq, ln, k_scale=ks)
    with pytest.raises(ValueError, match="not int8"):
        fn(q, k, v, ln, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="scales must be"):
        fn(q, kq, vq, ln, k_scale=ks[:, :4], v_scale=vs)
