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
bias, which every rank holds whole and adds once.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..checkpoint.quantize import QuantizedTensor
from ..ops.quant_matmul import quant_contract
from ..parallel import plan as plan_lib
from ..parallel.specs import ReplicatedQuantized

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
    return plan.mesh.all_reduce(y, "model")


def qkv_project(x: torch.Tensor, p: Params, cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> q [B, T, H, hd], k/v [B, T, KVH, hd].  Weight
    layout: wq [D, H, hd], wk/wv [D, KVH, hd]."""
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
    h = _contract(x, p, "w_in") + p["b_in"]
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

    p: router [D, E], w_gate/w_up [E, D, F], w_down [E, F, D].  Quantized
    leaves (a ``serve_quantized`` store) are rehydrated here, per layer,
    as the reference rehydrates them inside its scan."""
    if any(isinstance(w, ReplicatedQuantized) for w in p.values()):
        raise NotImplementedError(
            "an MoE block's quantized experts must shard under their rules "
            "on a mesh; a replicated expert leaf is not supported")
    if any(isinstance(w, QuantizedTensor) for w in p.values()):
        from ..checkpoint.quantize import dequantize_tree

        p = dequantize_tree(p, x.dtype)
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_token
    s = b * t
    cap = moe_capacity(cfg, s)
    xf = x.reshape(s, d)

    logits = xf.float() @ p["router"].float()  # [s, e]
    gates, eid, oh, keep, slot = moe_route(logits, cfg, cap)

    token_idx = torch.arange(s, device=x.device).repeat(k)
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=x.device)
    buf.index_add_(0, slot, xf[token_idx] * keep[:, None].to(xf.dtype))
    xe = buf[:-1].reshape(e, cap, d)

    g = torch.bmm(xe, p["w_gate"].to(xe.dtype))
    u = torch.bmm(xe, p["w_up"].to(xe.dtype))
    ye = _tp_sum(torch.bmm(torch.nn.functional.silu(g) * u,
                           p["w_down"].to(xe.dtype)), "ffn")

    yflat = torch.cat([ye.reshape(e * cap, d), ye.new_zeros((1, d))])
    gathered = yflat[slot]  # dropped claims read the zero row
    w = (gates.T.reshape(k * s) * keep).to(gathered.dtype)
    y = (gathered * w[:, None]).reshape(k, s, d).sum(dim=0)

    probs = torch.softmax(logits, dim=-1)
    importance = probs.mean(dim=0)
    load = (oh * keep[:, None].float()).sum(dim=0) / (s * k)
    aux = e * (importance * load).sum()
    return y.reshape(b, t, d).to(x.dtype), aux
