"""Flash attention of the PyTorch/CUDA port against the JAX package.

CPU: the port's plain version (:func:`flash_reference`, the path a CPU
tensor takes) against the JAX Pallas kernels run in interpret mode
(``flash_attention(..., interpret=True)``, as tests/ops/test_flash.py runs
them), on the same numpy inputs:

- K3 routes (causal, no position vectors, Tq == S): windows none / 3 / 17,
  GQA groups 1 and 4, lengths that are not a multiple of any tile;
- K4 routes: offset positions, a padded cache with ``k_valid``,
  ``causal=False``, a window, and a query row with no live key (zeros in
  both, where the JAX dense reference would average uniformly);
- gradients of q, k and v through the port (the dense-recompute backward)
  against ``jax.grad`` through the JAX kernel's custom VJP;
- the llama forward with ``attn_impl="flash"``: the no-cache forward (K3
  route) and the cached prefill (K4 route), windowed included, against the
  JAX forward on the same weights.

Tolerances: float32 atol = rtol = 1e-5 (blockwise online softmax against
the one-pass plain version: summation order only); bfloat16 atol 2e-2
(probabilities rounded to bf16 per 128-slot tile in the JAX kernel, per
row in the plain version, then the bf16 output rounding); model logits
atol = rtol = 1e-4 (four float32 layers).  The CUDA kernels themselves
are held against the plain version on the card by
tests/test_torch_gpu_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.ops import flash as jflash
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.ops import flash

TOL32 = dict(atol=1e-5, rtol=1e-5)
TOL16 = dict(atol=2e-2, rtol=0)
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, b, tq, h, kvh, d, s=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    s = s or tq
    return (rng.standard_normal((b, tq, h, d)).astype(dtype),
            rng.standard_normal((b, s, kvh, d)).astype(dtype),
            rng.standard_normal((b, s, kvh, d)).astype(dtype))


def _jax(q, k, v, dtype=jnp.float32, **kw):
    """The JAX kernel in interpret mode; block_q 16 so the longer cases
    walk several query tiles."""
    vecs = {n: jnp.asarray(a) for n, a in kw.items()
            if n in ("q_positions", "k_positions", "k_valid") and a is not None}
    rest = {n: a for n, a in kw.items() if n in ("causal", "window")}
    out = jflash.flash_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), **vecs, **rest,
        block_q=16, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, dtype=torch.float32, **kw):
    vecs = {n: torch.from_numpy(np.asarray(a)) for n, a in kw.items()
            if n in ("q_positions", "k_positions", "k_valid") and a is not None}
    rest = {n: a for n, a in kw.items() if n in ("causal", "window")}
    out = flash.flash_attention(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)), **vecs, **rest)
    return out.float().numpy()


# -- K3: the static-causal route ---------------------------------------------

@pytest.mark.parametrize("window", [None, 3, 17])
@pytest.mark.parametrize("b,t,h,kvh,d", [
    (2, 37, 4, 4, 16),    # group 1
    (1, 70, 8, 2, 32),    # group 4, T not a multiple of any tile
])
def test_static_route_matches_jax_kernel(b, t, h, kvh, d, window):
    q, k, v = _qkv(0, b, t, h, kvh, d)
    assert flash.is_static(torch.from_numpy(q), torch.from_numpy(k), None,
                           None, None, True)
    np.testing.assert_allclose(_port(q, k, v, window=window),
                               _jax(q, k, v, window=window), **TOL32)


@pytest.mark.parametrize("window", [None, 17])
def test_static_route_bf16_matches_jax_kernel(window):
    q, k, v = _qkv(1, 1, 70, 8, 2, 32)
    np.testing.assert_allclose(
        _port(q, k, v, torch.bfloat16, window=window),
        _jax(q, k, v, jnp.bfloat16, window=window), **TOL16)


# -- K4: the dynamic route ----------------------------------------------------

def _dynamic_cases():
    rng = np.random.default_rng(7)
    b, tq, s = 2, 23, 64
    qpos = (np.arange(tq) + np.array([[0], [30]])).astype(np.int32)
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = kpos < np.array([[23], [53]])
    masked_row = kpos < 30  # row 0 of batch 1 sees no key: zeros
    masked_row[1] = kpos[1] >= 31
    return {
        "offset_positions": dict(q_positions=qpos, k_positions=kpos),
        "padded_cache": dict(q_positions=qpos, k_positions=kpos,
                             k_valid=valid),
        "not_causal": dict(k_valid=valid, causal=False),
        "window": dict(q_positions=qpos, k_positions=kpos, k_valid=valid,
                       window=9),
        "shuffled_positions": dict(
            q_positions=rng.permutation(s)[:tq][None].repeat(b, 0)
            .astype(np.int32),
            k_positions=np.stack([rng.permutation(s) for _ in range(b)])
            .astype(np.int32)),
        "row_without_keys": dict(q_positions=qpos, k_positions=kpos,
                                 k_valid=masked_row),
    }


@pytest.mark.parametrize("case", sorted(_dynamic_cases()))
def test_dynamic_route_matches_jax_kernel(case):
    kw = _dynamic_cases()[case]
    q, k, v = _qkv(2, 2, 23, 8, 2, 16, s=64)
    got = _port(q, k, v, **kw)
    np.testing.assert_allclose(got, _jax(q, k, v, **kw), **TOL32)
    if case == "row_without_keys":
        assert np.all(got[1, 0] == 0)
        dense = flash.dense_reference(
            *map(torch.from_numpy, (q, k, v)), torch.from_numpy(kw["q_positions"]),
            torch.from_numpy(kw["k_positions"]), torch.from_numpy(kw["k_valid"]))
        assert np.abs(dense[1, 0].numpy()).max() > 0.01  # uniform average


def test_dynamic_route_bf16_matches_jax_kernel():
    kw = _dynamic_cases()["window"]
    q, k, v = _qkv(3, 2, 23, 8, 2, 16, s=64)
    np.testing.assert_allclose(_port(q, k, v, torch.bfloat16, **kw),
                               _jax(q, k, v, jnp.bfloat16, **kw), **TOL16)


def test_route_selection_follows_the_reference():
    q, k, _ = (torch.from_numpy(x) for x in _qkv(4, 1, 8, 2, 1, 16))
    pos = torch.arange(8)[None]
    assert flash.is_static(q, k, None, None, None, True)
    assert not flash.is_static(q, k, pos, None, None, True)
    assert not flash.is_static(q, k, None, None, torch.ones(1, 8, dtype=bool),
                               True)
    assert not flash.is_static(q, k, None, None, None, False)
    assert not flash.is_static(q, torch.cat([k, k], 1), None, None, None, True)


def test_validation_and_cpu_calls_count_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 8, 2, 1, 16))
    before = (flash.flash_attention.static_launches,
              flash.flash_attention.dynamic_launches)
    flash.flash_attention(q, k, v)
    flash.flash_attention(q, k, v, causal=False)
    assert (flash.flash_attention.static_launches,
            flash.flash_attention.dynamic_launches) == before
    with pytest.raises(ValueError, match="causal"):
        flash.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match=">= 1"):
        flash.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="head shapes"):
        flash.flash_attention(q[:, :, :1], k[:, :, :, :8], v[:, :, :, :8])


# -- gradients: the dense-recompute backward -----------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"window": 5},
    {"causal": False},
    "padded_cache",
])
def test_gradients_match_jax_grad(kw):
    if kw == "padded_cache":
        kw = _dynamic_cases()["padded_cache"]
        q, k, v = _qkv(6, 2, 23, 8, 2, 16, s=64)
    else:
        q, k, v = _qkv(6, 2, 19, 4, 2, 16)
    cot = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    vecs = {n: a for n, a in kw.items()
            if n in ("q_positions", "k_positions", "k_valid")}
    rest = {n: a for n, a in kw.items() if n in ("causal", "window")}

    def jloss(q_, k_, v_):
        out = jflash.flash_attention(
            q_, k_, v_, **{n: jnp.asarray(a) for n, a in vecs.items()},
            **rest, interpret=True)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash.flash_attention(
        qt, kt, vt, **{n: torch.from_numpy(a) for n, a in vecs.items()},
        **rest)
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL32)


# -- the llama forward with attn_impl="flash" ----------------------------------

def _pair(**overrides):
    cfg_j = jax_preset("llama-tiny", vocab_size=512, attn_impl="flash",
                       **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, attn_impl="flash",
                       **overrides)
    pj = jm.init_params(jax.random.key(3), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


class _Spy:
    """Records the route of every flash call the model makes."""

    def __init__(self, monkeypatch):
        self.routes = []
        real = flash.flash_attention

        def spy(q, k, v, q_positions=None, k_positions=None, k_valid=None,
                causal=True, window=None):
            self.routes.append(
                ("static" if flash.is_static(q, k, q_positions, k_positions,
                                             k_valid, causal) else "dynamic",
                 window))
            return real(q, k, v, q_positions, k_positions, k_valid, causal,
                        window)

        monkeypatch.setattr(flash, "flash_attention", spy)


@pytest.mark.parametrize("window", [None, 6])
def test_no_cache_forward_takes_the_static_route(monkeypatch, window):
    cfg_j, cfg_t, pj, pt = _pair(sliding_window=window)
    toks = np.random.default_rng(0).integers(0, 512, (2, 19)).astype(np.int32)
    want, _ = jm.forward(pj, cfg_j, jnp.asarray(toks))
    spy = _Spy(monkeypatch)
    got, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
    assert spy.routes == [("static", window)] * cfg_t.num_layers
    # Explicit positions: the dynamic kernel at those positions.
    pos = np.broadcast_to(np.arange(19, dtype=np.int32) + 5, (2, 19))
    want, _ = jm.forward(pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(pos))
    got, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                        positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
    assert spy.routes[cfg_t.num_layers:] == [("dynamic", window)] * cfg_t.num_layers


@pytest.mark.parametrize("window", [None, 6])
def test_cached_prefill_takes_the_dynamic_route(monkeypatch, window):
    cfg_j, cfg_t, pj, pt = _pair(sliding_window=window)
    prompt = np.random.default_rng(1).integers(0, 512, (1, 14)).astype(np.int32)
    pos = np.arange(14, dtype=np.int32)[None]
    cj = jm.init_cache(cfg_j, 1, 40)
    ct = tm.init_cache(cfg_t, 1, 40)
    want, cj = jm.forward(pj, cfg_j, jnp.asarray(prompt),
                          positions=jnp.asarray(pos), cache=cj,
                          cache_index=jnp.int32(0))
    spy = _Spy(monkeypatch)
    got, ct = tm.forward(pt, cfg_t, torch.from_numpy(prompt),
                         positions=torch.from_numpy(pos), cache=ct,
                         cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_LOGITS)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL_LOGITS)
    assert spy.routes == [("dynamic", window)] * cfg_t.num_layers
    # One token: the dense path, as in the reference.
    tm.forward(pt, cfg_t, torch.from_numpy(prompt[:, :1]),
               positions=torch.from_numpy(pos[:, :1] + 14), cache=ct,
               cache_index=14)
    assert len(spy.routes) == cfg_t.num_layers


def test_dot_models_never_reach_the_kernels(monkeypatch):
    cfg_t = get_preset("llama-tiny", vocab_size=512)
    pt = tm.init_params(cfg_t, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    spy = _Spy(monkeypatch)
    tm.forward(pt, cfg_t, torch.zeros(1, 9, dtype=torch.int64))
    assert spy.routes == []
