"""The port's weight-only dequant-matmul against the JAX package's Pallas
kernel program, on the CPU.

``quant_contract`` of the port (on CPU tensors: its plain version,
dequantize then a float32-accumulated product) against the JAX
``quant_contract(..., interpret=True)``, which runs the TPU kernel's own
program in Pallas interpret mode — a spy asserts the kernel path was
taken.  The weights are quantized by each stack's own ``quantize`` (bit-
exact, tests/test_torch_quantize.py) from the same numpy values.  Cases
mirror the JAX package's own kernel tests: a 2-D ``[K, N]`` weight with
decode-shaped M = 1 and odd M = 7, the qkv layout ``[D, H, hd]`` (int4
packed along -3), wo ``[H, hd, D]`` with ``k_lead=2`` (int4 packed along
-2), a product several tiles wide on every axis, and bf16 activations.

Tolerance: float32 within 1e-4 |want| + 1e-4 (both accumulate in float32;
the kernel sums K in 512-wide tiles, the port in one product), bf16
within 2^-7 |want| + 2e-2 (one bf16 output ulp on top of that).  The
port's wrappers raise on what they do not take: an int4 weight packed
along any axis but its last contracted one, mismatched K, scales that do
not divide N, non-int8 codes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llms_tpu.checkpoint.quantize import quantize as jax_quantize
from distributed_llms_tpu.ops import quant_matmul as jqm
from distributed_llms_tpu_torch.checkpoint.quantize import dequantize, quantize
from distributed_llms_tpu_torch.ops import quant_matmul as tqm


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the JAX Pallas kernel's calls, so each case proves the
    reference ran its kernel program and not its dequantize fallback."""
    calls = []
    orig = jqm._quant_matmul_2d

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jqm, "_quant_matmul_2d", spy)
    return calls


def _both(w_shape, x_shape, bits, pack_axis, k_lead, seed, x_dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(w_shape).astype(np.float32)
    x = rng.standard_normal(x_shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x)
    if x_dtype == "bf16":
        tx = tx.to(torch.bfloat16)
    want = jqm.quant_contract(
        jx, jax_quantize(jnp.asarray(w), bits=bits, block=128,
                         pack_axis=pack_axis), k_lead, interpret=True)
    got = tqm.quant_contract(
        tx, quantize(torch.from_numpy(w), bits=bits, block=128,
                     pack_axis=pack_axis), k_lead)
    return got, np.asarray(want.astype(jnp.float32))


def _close(got, want, rel, tol):
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_less(np.abs(got - want) - rel * np.abs(want), tol)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [1, 7, 16])
def test_2d_klead1_matches_jax_kernel(bits, m, kernel_calls):
    got, want = _both((256, 256), (m, 256), bits, -2, 1, seed=m)
    assert len(kernel_calls) == 1
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("bits,pack_axis", [(8, -2), (4, -3)])
def test_qkv_layout_matches_jax_kernel(bits, pack_axis, kernel_calls):
    got, want = _both((256, 2, 128), (4, 9, 256), bits, pack_axis, 1, seed=2)
    assert len(kernel_calls) == 1
    assert got.shape == (4, 9, 2, 128)
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_wo_layout_klead2_matches_jax_kernel(bits, kernel_calls):
    got, want = _both((2, 128, 256), (4, 9, 2, 128), bits, -2, 2, seed=3)
    assert len(kernel_calls) == 1
    assert got.shape == (4, 9, 256)
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_multitile_matches_jax_kernel(bits, kernel_calls):
    """M, K and N each wider than one of the reference kernel's tiles."""
    got, want = _both((1024, 384), (300, 1024), bits, -2, 1, seed=4)
    assert len(kernel_calls) == 1
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_activations_match_jax_kernel(bits, kernel_calls):
    got, want = _both((256, 256), (8, 256), bits, -2, 1, seed=5,
                      x_dtype="bf16")
    assert len(kernel_calls) == 1
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0 ** -7, 2e-2)


def test_plain_version_is_dequantize_then_matmul():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    for bits in (8, 4):
        qt = quantize(w, bits=bits, block=16)
        want = x @ dequantize(qt)
        got = tqm.quant_matmul(x, qt.data, qt.scale, bits)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert tqm.quant_matmul.launches == tqm.quant_matmul.int4_launches == 0


def test_wrappers_raise_on_what_they_do_not_take():
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    legacy = quantize(w, bits=4, pack_axis=-1)  # pairs along N
    # A legacy packing is no longer refused: it is repacked (exactly) onto
    # the contracted axis and contracts as dequantize-then-matmul.
    torch.testing.assert_close(tqm.quant_contract(x, legacy, 1),
                               x @ dequantize(legacy), rtol=1e-5, atol=1e-5)
    qt = quantize(w, bits=8, block=16)  # two scale blocks per row
    with pytest.raises(ValueError, match="K disagrees"):
        tqm.quant_matmul(x[:, :32], qt.data, qt.scale, 8)
    with pytest.raises(ValueError, match="do not divide"):
        tqm.quant_matmul(x, qt.data[:, :31], qt.scale, 8)
    with pytest.raises(TypeError, match="int8"):
        tqm.quant_matmul(x, qt.data.int(), qt.scale, 8)
    with pytest.raises(ValueError, match="bits"):
        tqm.quant_matmul(x, qt.data, qt.scale, 2)
