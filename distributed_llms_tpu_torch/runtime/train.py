"""Training step: next-token cross-entropy and an AdamW step with global
gradient clipping (PyTorch port of ``distributed_llms_tpu/runtime/train.py``).

The step is the reference's ``(params, opt_state, tokens, mask) ->
(params, opt_state, loss)``.  Parameters are the JAX package's tree as a
dictionary of leaf tensors; the step updates them IN PLACE (the JAX step
donates them) and returns the same objects.  With ``attn_impl="flash"``
the forward's attention is the static-causal flash kernel (K3) and its
backward the dense recompute of ``ops/flash.py``.

With ``parallel=`` (a ``parallel.api.ParallelModel`` on a data x model x
expert mesh, ``params`` this rank's blocks) the step is the reference's
GSPMD step written out: the loss runs through ``pm.forward`` (its
collectives carry the gradient, ``core/mesh.py``), the gradients of a
step whose rows split over 'data' are summed over that line, the global
norm of the clip is that of the whole unsharded tree (each sharded leaf's
sum of squares summed over the lines that shard it, each replicated leaf
counted once), and AdamW updates each rank's own blocks.  A pipelined or
sequence-parallel mesh is refused: its training is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..core.config import ModelConfig
from ..models import model as model_lib

Params = Any

# optax.adamw's defaults and the reference's clip_by_global_norm(1.0).
B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_NORM = 1.0


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, T, V] float32
    targets: torch.Tensor,  # [B, T] int
    mask: torch.Tensor | None = None,  # [B, T] float/bool; 0 => ignore
) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)


def lm_loss(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T+1]: input = [:, :-1], target = [:, 1:]
    mask: torch.Tensor | None = None,
    remat: bool = False,
    forward_fn=None,
) -> torch.Tensor:
    """Next-token cross-entropy; an MoE model adds its Switch-style
    load-balance term, ``cfg.moe_aux_loss_weight * aux``, so the router
    cannot collapse onto a few experts and capacity-drop the rest.
    ``forward_fn(params, cfg, inputs, remat=, return_aux=)`` replaces
    ``models.model.forward`` (the mesh's forward)."""
    fwd = forward_fn or model_lib.forward
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.num_experts > 0:
        logits, _, aux = fwd(params, cfg, inputs, remat=remat,
                             return_aux=True)
    else:
        logits, _ = fwd(params, cfg, inputs, remat=remat)
        aux = 0.0
    tmask = mask[:, 1:] if mask is not None else None
    return (cross_entropy_loss(logits, targets, tmask)
            + cfg.moe_aux_loss_weight * aux)


def _leaves(tree: Params) -> list[torch.Tensor]:
    """The tree's tensors in a fixed (key-sorted) order."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    return [tree]


@dataclass
class AdamW:
    """optax's ``chain(clip_by_global_norm(MAX_NORM), adamw(lr, B1, B2, EPS,
    weight_decay))``, written out over the parameter leaves:

    - clip: with ``norm = sqrt(sum of every gradient's squares)``, each
      gradient becomes ``(g / norm) * MAX_NORM`` when ``norm >= MAX_NORM``
      (optax's rule; ``torch.nn.utils.clip_grad_norm_`` would add 1e-6);
    - Adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the
      update ``mu_hat / (sqrt(nu_hat) + eps)`` with ``mu_hat = mu / (1 -
      b1^t)`` and ``nu_hat = nu / (1 - b2^t)``;
    - decoupled decay on EVERY leaf, norm scales included: ``+ wd * p``;
    - ``p += -lr * update``.

    Moments are kept in each parameter's dtype, as optax does without
    ``mu_dtype``.  Matches optax to float32 rounding (the tests hold it to
    the JAX ``Trainer``)."""

    lr: float
    weight_decay: float = 1e-4

    def init(self, params: Params) -> dict:
        leaves = _leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves]}

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: dict,
               params: Params, norm: torch.Tensor | None = None) -> dict:
        """Apply one step to ``params`` in place; returns the new state.
        ``norm``: the gradients' global norm when ``grads`` are one rank's
        blocks of a larger tree (:func:`global_norm`)."""
        leaves = _leaves(params)
        if norm is None:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        clipped = norm >= MAX_NORM
        count = state["count"] + 1
        c1 = 1 - B1 ** count
        c2 = 1 - B2 ** count
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            g = torch.where(clipped, (g / norm.to(g.dtype)) * MAX_NORM, g)
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * g ** 2 + B2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            u = u + self.weight_decay * p
            p.copy_(p + (-self.lr) * u)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.01) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay)


def _sharding_axes(rule, mesh) -> tuple:
    """The mesh axes above 1 that a leaf's rule shards it over."""
    return tuple(sorted({a for a in rule if a is not None
                         and mesh.size(a) > 1}))


def global_norm(grads: list[torch.Tensor], rules: list, mesh) -> torch.Tensor:
    """The global norm of a tree of which ``grads`` are this rank's blocks
    (``rules`` their shard rules, in the same order): the sums of squares
    of the leaves sharded over the same axes are added, and each such sum
    is summed over those axes' lines (the whole leaf's), while a leaf
    replicated on every rank counts once.  Equal on every rank."""
    by_axes: dict[tuple, torch.Tensor] = {}
    for g, rule in zip(grads, rules):
        axes = _sharding_axes(rule, mesh)
        sq = torch.sum(g.float() ** 2)
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    total = None
    for axes in sorted(by_axes):
        part = by_axes[axes]
        for a in axes:
            part = mesh.all_reduce(part, a)
        total = part if total is None else total + part
    return torch.sqrt(total)


def _sum_over(grads: list[torch.Tensor], mesh, axis: str) -> list:
    """Every gradient summed over the ``axis`` line, one collective per
    dtype (the gradients packed into one flat buffer)."""
    out = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = mesh.all_reduce(torch.cat([grads[i].reshape(-1)
                                          for i in idx]), axis)
        at = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[at:at + n].view_as(grads[i])
            at += n
    return out


@dataclass
class Trainer:
    """Holds the optimizer and builds the step, on one device or, with
    ``parallel`` (a ``parallel.api.ParallelModel``; ``params`` then this
    rank's blocks, ``ParallelModel.shard_params``), over a data x model x
    expert mesh: every rank is fed the same batch and returns the same
    loss."""

    cfg: ModelConfig
    optimizer: AdamW = field(default_factory=default_optimizer)
    parallel: Any = None
    remat: bool = False

    def __post_init__(self) -> None:
        model_lib.check_supported(self.cfg)
        pm = self.parallel
        if pm is not None and (pm.pipelined or pm.seq_parallel):
            from ..parallel.api import _LATER_SLICES

            raise NotImplementedError(
                f"training on a mesh with pipe={pm.mesh.size('pipe')} and "
                f"seq={pm.mesh.size('seq')} is not ported yet: "
                f"{_LATER_SLICES}")

    def init(self, params: Params) -> dict:
        return self.optimizer.init(params)

    def gradients(self, params: Params, tokens: torch.Tensor,
                  mask: torch.Tensor | None = None) -> tuple:
        """``(loss, grads, norm)`` at ``params``: the loss (detached), the
        gradients in ``_leaves`` order (this rank's blocks, summed over
        'data' when the rows split there) and their global norm (None on
        one device: the optimizer takes it from ``grads``)."""
        cfg, remat, pm = self.cfg, self.remat, self.parallel
        fwd = None
        if pm is not None:
            def fwd(params, cfg, inputs, remat=False, return_aux=False):
                return pm.forward(params, inputs, remat=remat,
                                  return_aux=return_aux)

        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = lm_loss(params, cfg, tokens, mask, remat=remat,
                           forward_fn=fwd)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        norm = None
        if pm is not None:
            if pm.splits_rows(tokens.shape[0]):
                # Each 'data' rank differentiated its own rows.
                grads = _sum_over(grads, pm.mesh, "data")
            norm = global_norm(grads, _leaves(pm.rules), pm.mesh)
        return loss.detach(), grads, norm

    def make_step(self):
        """Returns ``step(params, opt_state, tokens, mask) -> (params,
        opt_state, loss)``; ``params`` is updated in place and returned."""
        opt = self.optimizer

        def step(params, opt_state, tokens, mask=None):
            loss, grads, norm = self.gradients(params, tokens, mask)
            opt_state = opt.update(grads, opt_state, params, norm=norm)
            return params, opt_state, loss

        return step
