"""Layer primitives of the PyTorch/CUDA port against the JAX package.

Same numpy inputs (seeded) through ``distributed_llms_tpu.models.layers``
and ``distributed_llms_tpu_torch.models.layers``, float32 on the CPU, at
llama-tiny width (d_model 64, 4 query heads over 2 KV heads, head_dim 16,
intermediate 176).  Tolerance atol = rtol = 1e-5: the same float32 math,
summed in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.models import layers as jl
from distributed_llms_tpu.models.presets import get_preset
from distributed_llms_tpu_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = get_preset("llama-tiny")
B, T, D, H, KVH, HD, F = 2, 7, 64, 4, 2, 16, 176


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*map(jnp.asarray, arrays), **kw))
    got = fn_t(*map(torch.from_numpy, arrays), **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rms_norm():
    r = _rng(0)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    scale = r.standard_normal((D,)).astype(np.float32)
    _both(jl.rms_norm, tl.rms_norm, x, scale, eps=1e-5)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
@pytest.mark.parametrize("head_dim,theta", [(16, 10000.0), (128, 500000.0)])
def test_rope_frequencies(head_dim, theta, scaling):
    want = np.asarray(jl.rope_frequencies(head_dim, theta, scaling))
    got = tl.rope_frequencies(head_dim, theta, scaling).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
def test_apply_rope_including_llama31_rescale(scaling):
    r = _rng(1)
    x = r.standard_normal((B, T, H, HD)).astype(np.float32)
    # Positions past the 3.1 rescale's original context exercise the
    # stretched low-frequency band.
    pos = r.integers(0, 20000, (B, T)).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                                    scaling))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0,
                        scaling).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_repeat_kv():
    x = _rng(2).standard_normal((B, T, KVH, HD)).astype(np.float32)
    _both(jl.repeat_kv, tl.repeat_kv, x, q_per_kv=H // KVH)


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention(masked):
    r = _rng(3)
    q = r.standard_normal((B, T, H, HD)).astype(np.float32)
    k = r.standard_normal((B, 11, H, HD)).astype(np.float32)
    v = r.standard_normal((B, 11, H, HD)).astype(np.float32)
    mask = r.random((B, 1, T, 11)) < 0.7 if masked else None
    if masked:
        mask[..., 0] = True  # every query attends something
        want = jl.dot_product_attention(*map(jnp.asarray, (q, k, v, mask)))
        got = tl.dot_product_attention(*map(torch.from_numpy, (q, k, v, mask)))
    else:
        want = jl.dot_product_attention(*map(jnp.asarray, (q, k, v)), None)
        got = tl.dot_product_attention(*map(torch.from_numpy, (q, k, v)), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_causal_mask():
    r = _rng(4)
    qp = r.integers(0, 20, (B, T)).astype(np.int32)
    kp = r.integers(0, 20, (B, 13)).astype(np.int32)
    valid = r.random((B, 13)) < 0.8
    want = np.asarray(jl.causal_mask(*map(jnp.asarray, (qp, kp, valid))))
    got = tl.causal_mask(*map(torch.from_numpy, (qp, kp, valid))).numpy()
    np.testing.assert_array_equal(got, want)


def test_qkv_and_out_project():
    r = _rng(5)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    p = {
        "wq": r.standard_normal((D, H, HD)).astype(np.float32),
        "wk": r.standard_normal((D, KVH, HD)).astype(np.float32),
        "wv": r.standard_normal((D, KVH, HD)).astype(np.float32),
        "wo": r.standard_normal((H, HD, D)).astype(np.float32),
    }
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    for a, b in zip(jl.qkv_project(jnp.asarray(x), pj, CFG),
                    tl.qkv_project(torch.from_numpy(x), pt, CFG)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    o = r.standard_normal((B, T, H, HD)).astype(np.float32)
    np.testing.assert_allclose(
        tl.out_project(torch.from_numpy(o), pt).numpy(),
        np.asarray(jl.out_project(jnp.asarray(o), pj)), **TOL,
    )


@pytest.mark.parametrize("gate_act", ["silu", "gelu_tanh"])
def test_mlp_swiglu(gate_act):
    r = _rng(6)
    x = r.standard_normal((B, T, D)).astype(np.float32)
    p = {
        "w_gate": (r.standard_normal((D, F)) / 8).astype(np.float32),
        "w_up": (r.standard_normal((D, F)) / 8).astype(np.float32),
        "w_down": (r.standard_normal((F, D)) / 8).astype(np.float32),
    }
    want = jl.mlp_swiglu(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                         gate_act)
    got = tl.mlp_swiglu(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()}, gate_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
