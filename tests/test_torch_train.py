"""The port's training step against the JAX package's, on the same weights
and batches.

- ``cross_entropy_loss`` and ``lm_loss`` (with and without a mask) against
  the JAX functions: atol = rtol = 1e-5.
- The optimizer alone: three steps of ``default_optimizer(1e-2)``
  (global-norm clip 1.0, then AdamW with weight decay 0.01) on the same
  numpy gradients against optax's ``chain(clip_by_global_norm(1.0),
  adamw(1e-2, weight_decay=0.01))``: every parameter within atol = rtol =
  1e-6 (float32 rounding), a clipped and an unclipped step included.
- Three ``Trainer`` steps with ``default_optimizer(1e-2)`` on llama-tiny
  in float32, ``attn_impl`` "dot" and "flash", remat off and on, against
  the JAX ``Trainer`` with optax: every step's loss within 1e-5 relative;
  after the third step every parameter leaf within 5e-4 of the JAX one
  element-wise and within 1e-3 of the three steps' total update in norm.
  Why not 1e-4 element-wise: the two stacks' float32 gradients agree to
  ~2e-7 absolute (summation order), which is a few percent of the
  smallest gradient entries (~1e-7); Adam normalises each entry by its own
  sqrt(nu), so those few percent become a few percent of the step size
  lr = 1e-2 — measured: 3 of 250432 parameters differ by 1.8e-4 to
  2.8e-4, all others by under 1e-4.
- The knobs of later slices raise: a training step on a pipelined or
  sequence-parallel mesh (MoE losses are ported and add their
  load-balance term).

The batch is numpy-seeded; weights come from the JAX ``init_params``
through ``checkpoint.from_jax``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import train as jt
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import train as tt


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **overrides):
    cfg_j = jax_preset("llama-tiny", vocab_size=512, **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, **overrides)
    pj = jm.init_params(jax.random.key(seed), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def _batch(seed=0, b=2, t=25):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    return toks, mask


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_loss_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    targets = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.4) if with_mask else None
    want = jt.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(targets),
        None if mask is None else jnp.asarray(mask))
    got = tt.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), atol=1e-5, rtol=1e-5)
    # An all-zero mask divides by max(sum, 1): a zero loss, not a NaN.
    zero = tt.cross_entropy_loss(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 torch.zeros(2, 7))
    assert float(zero) == 0.0


@pytest.mark.parametrize("attn_impl", ["dot", "flash"])
def test_lm_loss_matches_jax(attn_impl):
    cfg_j, cfg_t, pj, pt = _pair(1, attn_impl=attn_impl)
    toks, mask = _batch(2)
    for m in (None, mask):
        want = jt.lm_loss(pj, cfg_j, jnp.asarray(toks),
                          None if m is None else jnp.asarray(m))
        got = tt.lm_loss(pt, cfg_t, torch.from_numpy(toks),
                         None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("attn_impl", ["dot", "flash"])
def test_three_steps_match_the_jax_trainer(attn_impl, remat):
    cfg_j, cfg_t, pj, pt = _pair(0, attn_impl=attn_impl)
    p0 = jax.tree.map(np.asarray, pj)
    toks, mask = _batch(0)
    trj = jt.Trainer(cfg_j, jt.default_optimizer(1e-2), remat=remat)
    trt = tt.Trainer(cfg_t, tt.default_optimizer(1e-2), remat=remat)
    step_j, step_t = trj.make_step(), trt.make_step()
    state_j, state_t = trj.init(pj), trt.init(pt)
    wq = pt["blocks"]["attn"]["wq"]
    losses = []
    for _ in range(3):
        pj, state_j, loss_j = step_j(pj, state_j, jnp.asarray(toks),
                                     jnp.asarray(mask))
        pt, state_t, loss_t = step_t(pt, state_t, torch.from_numpy(toks),
                                     torch.from_numpy(mask))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
        losses.append(float(loss_t))
    assert losses[2] < losses[1] < losses[0]
    assert pt["blocks"]["attn"]["wq"] is wq  # updated in place
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        got, before = pt, p0
        for key in path:
            got, before = got[key.key], before[key.key]
        want = np.asarray(leaf)
        diff = got.numpy() - want
        assert np.abs(diff).max() <= 5e-4, path
        assert np.linalg.norm(diff) <= 1e-3 * np.linalg.norm(want - before), path
    assert not any(p.requires_grad for p in tt._leaves(pt))


def test_optimizer_matches_optax_on_equal_gradients():
    import optax

    rng = np.random.default_rng(3)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    # Step 1's gradients have global norm > 1 (clipped), steps 2-3 < 1.
    grads = [jax.tree.map(lambda p, sc=sc: (rng.standard_normal(p.shape)
                                            * sc).astype(np.float32), params)
             for sc in (1.0, 0.05, 0.01)]
    opt_j = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(1e-2, weight_decay=0.01))
    pj = jax.tree.map(jnp.asarray, params)
    state_j = opt_j.init(pj)
    opt_t = tt.default_optimizer(1e-2)
    pt = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)
    state_t = opt_t.init(pt)
    for g in grads:
        upd, state_j = opt_j.update(jax.tree.map(jnp.asarray, g), state_j, pj)
        pj = optax.apply_updates(pj, upd)
        state_t = opt_t.update(
            [torch.from_numpy(x) for x in tt._leaves(g)], state_t, pt)
    assert state_t["count"] == 3
    for got, want in zip(tt._leaves(pt), tt._leaves(
            jax.tree.map(np.asarray, pj))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_later_slice_training_knobs_raise():
    """Training on a pipelined or sequence-parallel mesh is refused,
    naming the slices left (data x model x expert meshes train:
    tests/test_torch_parallel_train.py)."""
    from distributed_llms_tpu_torch.core.config import MeshConfig
    from distributed_llms_tpu_torch.core.mesh import build_mesh
    from distributed_llms_tpu_torch.parallel import api as tapi

    cfg = get_preset("llama-tiny", vocab_size=512)
    for axes in (dict(pipe=2), dict(seq=2), dict(pipe=2, model=2)):
        m = MeshConfig(**axes)
        pm = tapi.make_parallel_model(cfg, m, mesh=build_mesh(
            m, rank=0, world_size=m.num_devices))
        with pytest.raises(NotImplementedError,
                           match="pipelined and sequence-parallel training"):
            tt.Trainer(cfg, parallel=pm)
    pm = tapi.make_parallel_model(cfg, MeshConfig(model=2), mesh=build_mesh(
        MeshConfig(model=2), rank=0, world_size=2))
    assert tt.Trainer(cfg, parallel=pm).parallel is pm
    # MoE losses are ported: lm_loss adds the weighted load-balance term.
    moe = get_preset("moe-tiny")
    params = tm.init_params(moe, torch.Generator().manual_seed(0))
    toks = torch.randint(0, moe.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    with_aux = tt.lm_loss(params, moe, toks)
    without = tt.lm_loss(params, dataclasses.replace(
        moe, moe_aux_loss_weight=0.0), toks)
    assert float(with_aux) != float(without)
