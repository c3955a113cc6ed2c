"""Core transformer layer primitives (PyTorch port of
``distributed_llms_tpu/models/layers.py``).

Plain functions over tensors and the SAME parameter layouts as the JAX
package — stacked-layer dictionaries, ``wq [D, H, hd]`` / ``wo [H, hd, D]``
— so one numpy tree feeds both stacks (``checkpoint/from_jax.py``).
Numerics follow the reference: norms, RoPE and softmax compute in float32;
attention scores accumulate in float32 and the probabilities are cast to
V's dtype before the value product.  Every projection goes through
:func:`_contract`: ``torch.matmul`` for a plain weight (the JAX package
leaves those products to XLA, outside any Pallas kernel), the
dequant-matmul kernel for a quantized one.

On a mesh (``parallel/plan.py``) the parameters are a rank's local block
and the row-parallel products (``wo``, ``w_down``, ``w_out``) are
partial sums: :func:`_tp_sum` adds them over the 'model' line before any
bias, which every rank holds whole and adds once.  Under autograd (a
training step) that sum passes the gradient through, and
:func:`_tp_entry` sums over the line the gradient that enters each
column-parallel region (``Mesh.sum_reduce`` / ``Mesh.copy_in``); a
forward that records no gradient takes the detached collectives.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..checkpoint.quantize import QuantizedTensor, dequantize
from ..ops.quant_matmul import quant_contract
from ..parallel import plan as plan_lib
from ..parallel.specs import ReplicatedQuantized, local_slice

Params = dict[str, Any]

_F32_MIN = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to ``x.dtype``."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (llama and neox families)
# ---------------------------------------------------------------------------

def rope_frequencies(
    head_dim: int, theta: float,
    scaling: tuple[float, float, float, int] | None = None,
    device: "torch.device | None" = None,
) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32.  ``scaling`` =
    (factor, low_freq_factor, high_freq_factor, original_max_len) applies
    Llama-3.1's piecewise rescale (see the JAX counterpart)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is not None:
        factor, low, high, old_len = scaling
        wavelen = 2.0 * math.pi / inv_freq
        smooth = ((old_len / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        inv_freq = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
    return inv_freq


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, theta: float,
    scaling: tuple[float, float, float, int] | None = None,
) -> torch.Tensor:
    """Rotate half-pairs (HF/Llama convention).  x: [B, T, H, D];
    positions: [B, T] int."""
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, scaling, device=x.device)
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1f = x[..., :half].float()
    x2f = x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, S, KVH, D] -> [B, S, KVH*q_per_kv, D] for grouped-query
    attention (head h reads kv head h // q_per_kv)."""
    if q_per_kv == 1:
        return x
    b, s, kvh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kvh, q_per_kv, d).reshape(
        b, s, kvh * q_per_kv, d
    )


def dot_product_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, Tk, H, D]
    v: torch.Tensor,  # [B, Tk, H, D]
    mask: torch.Tensor | None,  # broadcastable to [B, H, Tq, Tk]; True = attend
) -> torch.Tensor:
    """Softmax(QK^T)V: float32 scores and softmax, probabilities cast to
    ``v.dtype`` before the value product (the JAX reference's numerics)."""
    scale = q.shape[-1] ** -0.5
    # bf16 x bf16 products are exact in float32, so upcasting the operands
    # reproduces XLA's preferred_element_type=f32 contraction.
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, _F32_MIN)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def causal_mask(
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    k_valid: torch.Tensor | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Boolean mask [B, 1, Tq, Tk]: query at position p attends keys at
    positions <= p; ``k_valid`` ([B, Tk] bool) masks unwritten slots;
    ``window`` (sliding-window attention) further restricts keys to
    positions in (p - window, p]."""
    mask = k_positions[:, None, None, :] <= q_positions[:, None, :, None]
    if k_valid is not None:
        mask = mask & k_valid[:, None, None, :]
    if window is not None:
        mask = and_window(mask, q_positions, k_positions, window)
    return mask


def and_window(
    mask: torch.Tensor,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    window: int,
) -> torch.Tensor:
    """AND the sliding-window lower bound (keys in (p - window, p]) into an
    existing attention mask — the one definition of the window, shared by
    :func:`causal_mask` and the caller-supplied-mask paths of
    ``models.model._attention``."""
    return mask & (
        k_positions[:, None, None, :] > q_positions[:, None, :, None] - window
    )


# ---------------------------------------------------------------------------
# Projections (einsum conventions shared with the JAX package)
# ---------------------------------------------------------------------------

# How many leading axes of each projection weight contract against x: 2 for
# wo [H, hd, D], 1 for the others.  The store loader reads it too, to refuse
# an int4 weight packed along another axis.  An MoE block's expert leaves
# share the dense MLP's names but never reach the dequant-matmul: they are
# rehydrated in :func:`moe_swiglu` (see :func:`kernel_leaves`).
K_LEAD = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
          "w_down": 1, "w_in": 1, "w_out": 1}


def kernel_leaves(blocks: Params):
    """(name, leaf) of every stacked block weight that :func:`_contract`
    hands to the dequant-matmul when it is quantized: the projections,
    not an MoE block's router and experts (rehydrated per layer) and not
    the norms or biases."""
    for group in blocks.values():
        if "router" in group:
            continue
        for name, leaf in group.items():
            if name in K_LEAD:
                yield name, leaf


def _contract(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """Contract x's trailing ``K_LEAD[name]`` axes against the weight's
    leading ones, keeping its other axes: a matrix product for a tensor,
    the dequant-matmul (``ops/quant_matmul.py``, K5 on CUDA) for a
    ``QuantizedTensor`` under weight-only quantized serving."""
    w, k_lead = p[name], K_LEAD[name]
    if isinstance(w, QuantizedTensor):
        return quant_contract(x, w, k_lead)
    if isinstance(w, ReplicatedQuantized):
        return w.contract(x, k_lead)
    lead = x.shape[: x.dim() - k_lead]
    k = math.prod(x.shape[x.dim() - k_lead:])
    return (x.reshape(-1, k) @ w.reshape(k, -1)).reshape(
        *lead, *w.shape[k_lead:])


def _tp_sum(y: torch.Tensor, sharded: str) -> torch.Tensor:
    """Sum a row-parallel product's partial sums over the 'model' line
    when the plan shards ``sharded`` ("heads" or "ffn"); as it is
    otherwise (one device, or a replicated leaf)."""
    plan = plan_lib.current()
    if plan is None or not getattr(plan, sharded):
        return y
    return plan.mesh.sum_reduce(y, "model")


def _tp_entry(x: torch.Tensor, sharded: str) -> torch.Tensor:
    """``x`` entering a region the plan shards over 'model' (``sharded``:
    "heads" or "ffn"): each rank's gradient with respect to it
    covers only its own shard's products, so the backward sums it over
    the line."""
    plan = plan_lib.current()
    if plan is None or not getattr(plan, sharded):
        return x
    return plan.mesh.copy_in(x, "model")


def qkv_project(x: torch.Tensor, p: Params, cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> q [B, T, H, hd], k/v [B, T, KVH, hd].  Weight
    layout: wq [D, H, hd], wk/wv [D, KVH, hd].  On a mesh whose Q heads
    shard while the KV heads stay whole (``Plan.kv_map``), each rank reads
    only its Q heads' KV heads, so the KV weights' gradients are summed
    over 'model' too."""
    x = _tp_entry(x, "heads")
    plan = plan_lib.current()
    if plan is not None and plan.kv_map is not None:
        p = {k: (plan.mesh.copy_in(v, "model")
                 if k in ("wk", "wv", "bk", "bv") and torch.is_tensor(v)
                 else v) for k, v in p.items()}
    q = _contract(x, p, "wq")
    k = _contract(x, p, "wk")
    v = _contract(x, p, "wv")
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def out_project(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x: [B, T, H, hd] -> [B, T, D].  wo: [H, hd, D]."""
    out = _tp_sum(_contract(x, p, "wo"), "heads")
    if "bo" in p:
        out = out + p["bo"]
    return out


def mlp_gelu(x: torch.Tensor, p: Params, activation: str = "gelu") -> torch.Tensor:
    """GPT-2-layout MLP: act(x W_in + b) W_out + b.  ``activation``:
    "relu" (OPT), "gelu_exact" (erf gelu, Pythia), "gelu" / "gelu_new"
    the tanh approximation (GPT-2); anything else raises."""
    h = _contract(_tp_entry(x, "ffn"), p, "w_in") + p["b_in"]
    if activation == "relu":
        h = torch.relu(h)
    elif activation == "gelu_exact":
        h = torch.nn.functional.gelu(h)
    elif activation in ("gelu", "gelu_new"):
        h = torch.nn.functional.gelu(h, approximate="tanh")
    else:  # loud, not silently gelu: a wrong activation is wrong logits
        raise ValueError(f"unsupported MLP activation {activation!r}")
    return _tp_sum(_contract(h, p, "w_out"), "ffn") + p["b_out"]


def mlp_swiglu(x: torch.Tensor, p: Params, gate_act: str = "silu") -> torch.Tensor:
    """Gated MLP: (act(x W_gate) * (x W_up)) W_down, no biases.
    ``gate_act``: "silu" (Llama/Qwen2) or "gelu_tanh" (Gemma's GeGLU)."""
    x = _tp_entry(x, "ffn")
    gate = _contract(x, p, "w_gate")
    up = _contract(x, p, "w_up")
    if gate_act == "silu":
        act = torch.nn.functional.silu(gate)
    else:
        act = torch.nn.functional.gelu(gate, approximate="tanh")
    return _tp_sum(_contract(act * up, p, "w_down"), "ffn")


def moe_capacity(cfg, s: int) -> int:
    """Expert capacity for ``s`` routed rows: ceil(capacity_factor * k * s
    / E), at least 1 — computed on the host from static shapes, the
    reference's expression to the float."""
    e, k = cfg.num_experts, cfg.num_experts_per_token
    return max(1, int(-(-cfg.moe_capacity_factor * k * s // e)))


def moe_route(logits: torch.Tensor, cfg, cap: int) -> tuple:
    """The router's decisions for float32 logits [s, E] at capacity
    ``cap``: (gates [s, k] float32, eid [k*s] the expert of each claim in
    choice-major order, its one-hot [k*s, E], keep [k*s] whether the
    claim found a place, slot [k*s] its row of the ``[E*cap + 1, D]``
    dispatch buffer — the last, a dump row, for a dropped claim)."""
    e, k = cfg.num_experts, cfg.num_experts_per_token
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(topv[:, :k], dim=-1)
    eid = topi[:, :k].T.reshape(-1)
    oh = torch.nn.functional.one_hot(eid, e).float()
    pos = ((oh.cumsum(dim=0) - 1.0) * oh).sum(dim=-1)
    keep = pos < cap
    slot = torch.where(keep, eid * cap + pos.long(), e * cap)
    return gates, eid, oh, keep, slot


def _expert_leaf(w: Any, dtype: torch.dtype) -> Any:
    """An MoE block's leaf as the products read it: a quantized leaf
    rehydrated to ``dtype`` (the reference's ``dequantize_tree``, per
    layer); one that could not shard under its rule (kept whole on every
    rank, :class:`ReplicatedQuantized`) rehydrated whole, then cut to this
    rank's block under that rule."""
    if isinstance(w, ReplicatedQuantized):
        return local_slice(dequantize(w.qt, dtype), w.spec, w.mesh)
    if isinstance(w, QuantizedTensor):
        return dequantize(w, dtype)
    return w


def moe_swiglu(x: torch.Tensor, p: Params, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Mixture-of-experts SwiGLU MLP (Mixtral-style top-k routing with the
    reference's GShard capacity).  Returns (output, the Switch aux term).

    - router: top-k over float32 logits, the lower expert first on equal
      logits (``lax.top_k``'s order; a stable descending sort gives it);
      gates are the softmax over the k logits;
    - capacity: :func:`moe_capacity` over ``s = B*T``, every row passed in
      (padded and idle rows claim places too, as in the reference);
    - dispatch: claims in choice-major order (every row's first choice
      before any second), a claim's place in its expert from the one-hot
      cumsum; a kept claim scatters its row into its own slot of the
      ``[E*C + 1, D]`` buffer, an overflow claim into the last (dump) row
      with weight 0 — kept slots are distinct, so ``index_add_`` is exact
      and deterministic;
    - experts: one batched SwiGLU over ``[E, C, D]`` (the reference's
      einsums; no Pallas kernel there, so none here);
    - aux: ``E * sum_e importance_e * load_e``.

    On a mesh whose expert stacks shard over 'expert' (``Plan.experts``,
    ``[lo, hi)``), every rank routes every row exactly as above (so the
    aux term is the one-device term, with no collective), scatters only
    the claims of its own experts into a ``[E_local * C + 1, D]`` buffer,
    runs its experts, and gathers its claims' rows into ``[k*s, D]``, the
    rows of other ranks' claims and of dropped claims zero.  Those rows
    are summed over the 'expert' line BEFORE the gate weighting: each
    claim's row is non-zero on one rank only, so the sum is exact (the
    mesh output is the one-device output to the bit without 'model'), and
    under autograd each rank's router and aux gradients are whole.  The
    dispatch's entry sums its gradient over 'expert' (each rank's
    gradient of x from its own experts is a partial sum).  With the
    experts whole on every rank no sum is taken.  Under 'model' the
    expert hidden axis is column-parallel and ``w_down``'s product is
    summed over the line, as in the dense MLP.

    p: router [D, E], w_gate/w_up [E, D, F], w_down [E, F, D] (this rank's
    block on a mesh).  Quantized leaves (a ``serve_quantized`` store) are
    rehydrated here, per layer, as the reference rehydrates them inside
    its scan."""
    p = {k: _expert_leaf(w, x.dtype) for k, w in p.items()}
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    s = b * t
    cap = moe_capacity(cfg, s)
    xf = x.reshape(s, d)

    logits = xf.float() @ p["router"].float()  # [s, e]
    gates, eid, oh, keep, slot = moe_route(logits, cfg, cap)

    plan = plan_lib.current()
    split = plan is not None and plan.experts is not None
    token_idx = torch.arange(s, device=x.device).repeat(k)
    if split:
        lo, hi = plan.experts
        n_loc = hi - lo
        mine = keep & (eid >= lo) & (eid < hi)
        slot = torch.where(mine, slot - lo * cap, n_loc * cap)
        xd = plan.mesh.copy_in(xf, "expert")
    else:
        n_loc, mine, xd = e, keep, xf
    buf = torch.zeros((n_loc * cap + 1, d), dtype=xf.dtype, device=x.device)
    buf.index_add_(0, slot, xd[token_idx] * mine[:, None].to(xf.dtype))
    xe = _tp_entry(buf[:-1].reshape(n_loc, cap, d), "ffn")

    g = torch.bmm(xe, p["w_gate"].to(xe.dtype))
    u = torch.bmm(xe, p["w_up"].to(xe.dtype))
    ye = _tp_sum(torch.bmm(torch.nn.functional.silu(g) * u,
                           p["w_down"].to(xe.dtype)), "ffn")

    yflat = torch.cat([ye.reshape(n_loc * cap, d), ye.new_zeros((1, d))])
    gathered = yflat[slot]  # dropped (and other ranks') claims: zero rows
    if split:
        gathered = plan.mesh.sum_reduce(gathered, "expert")
    w = (gates.T.reshape(k * s) * keep).to(gathered.dtype)
    y = (gathered * w[:, None]).reshape(k, s, d).sum(dim=0)

    probs = torch.softmax(logits, dim=-1)
    importance = probs.mean(dim=0)
    load = (oh * keep[:, None].float()).sum(dim=0) / (s * k)
    aux = e * (importance * load).sum()
    return y.reshape(b, t, d).to(x.dtype), aux
