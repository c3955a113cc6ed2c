"""Token sampling: greedy, temperature, top-k, top-p (PyTorch port of
``distributed_llms_tpu/runtime/sampling.py``).

The masks are the reference's to the element: for the same logits the
top-k and top-p survivor sets are identical (ties included).  The draw is
Gumbel-max over the warped logits — ``jax.random.categorical``'s method —
with noise from an explicit ``torch.Generator``; the two frameworks'
random streams differ, so sampled tokens are held to the mask semantics,
never to the bytes.

Everything here can be captured in a CUDA graph (runtime/chunk_graph.py):
no host copy, no host sync; the generator is registered with the graph,
so each replay draws as the eager chunk would.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B] int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _mask_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0:
        return logits
    cutoff = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < cutoff, -torch.inf, logits)


def _top_p_cutoff(logits: torch.Tensor,
                  p: "torch.Tensor | float") -> torch.Tensor:
    """Smallest kept logit per row: keep the shortest prefix of the sorted
    distribution whose mass reaches ``p`` (top-1 always kept).  p: [B, 1],
    or a float compared at the logits' dtype."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p
    return torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True
    )


def _mask_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    # A Python float, not a tensor made from it: a decode chunk captured
    # as a CUDA graph may not copy from the host.
    cutoff = _top_p_cutoff(logits, float(p))
    return torch.where(logits < cutoff, -torch.inf, logits)


def warp_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                top_p: float = 1.0) -> torch.Tensor:
    """Temperature/top-k/top-p warp (masked entries at -inf); requires
    temperature > 0."""
    logits = logits / temperature
    logits = _mask_top_k(logits, top_k)
    return _mask_top_p(logits, top_p)


def _categorical(generator: torch.Generator | None,
                 logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def sample(
    generator: torch.Generator | None,
    logits: torch.Tensor,  # [B, V] float32
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Sample next tokens [B].  temperature == 0 -> greedy (no noise drawn)."""
    if temperature == 0.0:
        return greedy(logits)
    return _categorical(generator, warp_logits(logits, temperature, top_k, top_p))


def _mask_top_k_rows(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Top-k mask with a per-row ``k`` [B] (rows with k <= 0 keep the full
    vocabulary); the cutoff equals :func:`_mask_top_k`'s for a uniform
    batch."""
    k = k.to(device=logits.device, dtype=torch.int64)[:, None]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    ranks = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    keep_sorted = ranks < torch.clamp(k, min=1)
    cutoff = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True
    )
    return torch.where((k > 0) & (logits < cutoff), -torch.inf, logits)


def _mask_top_p_rows(logits: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Top-p mask with a per-row ``p`` [B]."""
    p = p.to(device=logits.device, dtype=logits.dtype).expand(
        logits.shape[0]
    )[:, None]
    return torch.where(logits < _top_p_cutoff(logits, p), -torch.inf, logits)


def sample_rows(
    generator: torch.Generator | None,
    logits: torch.Tensor,        # [B, V] float32
    temperature: torch.Tensor,   # [B] — 0 means greedy for that row
    top_k: int = 0,
    top_p: "torch.Tensor | float" = 1.0,  # [B] or scalar
    top_k_rows: torch.Tensor | None = None,  # [B] int — overrides top_k
    mask_rows: torch.Tensor | None = None,  # [B, V] additive token mask
) -> torch.Tensor:
    """Per-row sampling: each row draws with its OWN temperature, top-p,
    (via ``top_k_rows``) top-k and (via ``mask_rows``) token mask, in the
    reference's warp order.  ``mask_rows`` (grammar-constrained / biased
    rows, runtime/constrain.py: 0 keeps a token, -1e30 forbids it; free
    rows carry an all-zero row) applies BEFORE the temperature warp and
    before the greedy fallback, so a constrained greedy row takes the
    masked argmax.  Rows with temperature == 0 take the greedy token."""
    if mask_rows is not None:
        logits = logits + mask_rows
    temperature = temperature.to(device=logits.device, dtype=logits.dtype)
    safe_t = torch.where(temperature > 0, temperature, 1.0)[:, None]
    warped = logits / safe_t
    if top_k_rows is not None:
        warped = _mask_top_k_rows(warped, top_k_rows)
    else:
        warped = _mask_top_k(warped, top_k)
    if not (isinstance(top_p, (int, float)) and float(top_p) >= 1.0):
        if not torch.is_tensor(top_p):
            top_p = torch.tensor(top_p)
        warped = _mask_top_p_rows(warped, top_p)
    drawn = _categorical(generator, warped)
    return torch.where(temperature > 0, drawn, greedy(logits))
