"""Int8 KV quantization of the PyTorch port against the JAX package.

``kv_quantize`` must be BIT-exact (int8 data and float32 scales equal to
the last bit) on the same numpy inputs: the prefix-cache digests are
salted by the KV width, so an int8 page has to hold the same bytes in both
stacks.  Covered: random float32 and bfloat16 vectors, all-zero vectors
(scale 1), and values exactly half a quantization step apart (round half
to even).  ``kv_dequantize`` is float32(data) * scale in both, cast to the
target dtype — also bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

from distributed_llms_tpu.checkpoint import quantize as jq
from distributed_llms_tpu_torch.checkpoint import quantize as tq


def _both(x: np.ndarray):
    dj, sj = jq.kv_quantize(jnp.asarray(x))
    if x.dtype == ml_dtypes.bfloat16:
        xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        xt = torch.from_numpy(x)
    dt, st = tq.kv_quantize(xt)
    return (np.asarray(dj), np.asarray(sj)), (dt.numpy(), st.numpy())


def _assert_bit_exact(x):
    (dj, sj), (dt, st) = _both(x)
    assert dt.dtype == np.int8 and st.dtype == np.float32
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3, 2, 16), (7, 128)])
def test_kv_quantize_is_bit_exact(dtype, shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1] + (1,)))
    _assert_bit_exact(x.astype(dtype))


def test_all_zero_vectors_get_scale_one():
    x = np.zeros((3, 2, 8), np.float32)
    x[1, 1] = np.linspace(-1, 1, 8)
    _assert_bit_exact(x)
    _, st = tq.kv_quantize(torch.from_numpy(x))
    assert st[0, 0] == 1.0 and st[2, 1] == 1.0


def test_half_step_ties_round_to_even():
    # absmax 127 -> scale 1: x / scale lands exactly on k + 0.5.
    ties = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]],
                    np.float32)
    # absmax 254 -> scale 2: 5 -> 2.5, 7 -> 3.5.
    ties2 = np.array([[254.0, 5.0, 7.0, -5.0, -7.0, 1.0, 3.0, -1.0]],
                     np.float32)
    for x in (ties, ties2):
        _assert_bit_exact(x)
    dt, _ = tq.kv_quantize(torch.from_numpy(ties))
    assert dt[0].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_dequantize_matches(dtype):
    rng = np.random.default_rng(1)
    data = rng.integers(-127, 128, (5, 2, 16)).astype(np.int8)
    scale = rng.uniform(0.001, 2.0, (5, 2)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jq.kv_dequantize(jnp.asarray(data), jnp.asarray(scale),
                                       jdt)).astype(np.float32)
    got = tq.kv_dequantize(torch.from_numpy(data), torch.from_numpy(scale),
                           dtype).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_round_trip_is_stable():
    """Quantizing a dequantized vector reproduces the data and scale (the
    reference's round-trip property, held by the port too)."""
    x = np.random.default_rng(2).standard_normal((6, 4, 32)).astype(np.float32)
    d, s = tq.kv_quantize(torch.from_numpy(x))
    d2, s2 = tq.kv_quantize(tq.kv_dequantize(d, s, torch.float32))
    assert torch.equal(d, d2) and torch.equal(s, s2)
