"""Training step: next-token cross-entropy and an AdamW step with global
gradient clipping (PyTorch port of ``distributed_llms_tpu/runtime/train.py``).

The step is the reference's ``(params, opt_state, tokens, mask) ->
(params, opt_state, loss)``.  Parameters are the JAX package's tree as a
dictionary of leaf tensors; the step updates them IN PLACE (the JAX step
donates them) and returns the same objects.  With ``attn_impl="flash"``
the forward's attention is the static-causal flash kernel (K3) and its
backward the dense recompute of ``ops/flash.py``.

Not ported yet: the mesh-parallel step (``parallel=``) and training
checkpoints (``train_ckpt.py``).
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
) -> torch.Tensor:
    """Next-token cross-entropy; an MoE model adds its Switch-style
    load-balance term, ``cfg.moe_aux_loss_weight * aux``, so the router
    cannot collapse onto a few experts and capacity-drop the rest."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.num_experts > 0:
        logits, _, aux = model_lib.forward(params, cfg, inputs, remat=remat,
                                           return_aux=True)
    else:
        logits, _ = model_lib.forward(params, cfg, inputs, remat=remat)
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
               params: Params) -> dict:
        """Apply one step to ``params`` in place; returns the new state."""
        leaves = _leaves(params)
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


@dataclass
class Trainer:
    """Holds the optimizer and builds the step.  Single device; the
    mesh-parallel ``parallel=`` of the reference is the port's last
    slice."""

    cfg: ModelConfig
    optimizer: AdamW = field(default_factory=default_optimizer)
    parallel: Any = None
    remat: bool = False

    def __post_init__(self) -> None:
        model_lib.check_supported(self.cfg)
        if self.parallel is not None:
            raise NotImplementedError(
                "the mesh-parallel training step (ParallelModel) is not "
                "ported yet: it comes in a later slice of the port, "
                "pipelined training (gradients through the ring shift) "
                "with it"
            )

    def init(self, params: Params) -> dict:
        return self.optimizer.init(params)

    def make_step(self):
        """Returns ``step(params, opt_state, tokens, mask) -> (params,
        opt_state, loss)``; ``params`` is updated in place and returned."""
        cfg, remat, opt = self.cfg, self.remat, self.optimizer

        def step(params, opt_state, tokens, mask=None):
            leaves = _leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = lm_loss(params, cfg, tokens, mask, remat=remat)
                grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, loss.detach()

        return step

