"""Int8 KV quantization (PyTorch port of the KV part of
``distributed_llms_tpu/checkpoint/quantize.py``).

One float32 absmax scale per trailing head-dim vector, so the decode
kernel can fold the scales into the attention contraction itself:
score = (q . k_int8) * k_scale and out = sum((p * v_scale) . v_int8) —
per-(slot, head) scales sit outside the head-dim dot product, which is
what lets the int8 leg of ``ops/decode_attn.py`` read the pool at 1 byte
per element and never materialize a dequantized page.

Bit-exact with the JAX package's functions on the same inputs: the
prefix-cache digests are salted by the KV width, so an int8 page must hold
the same bytes in both stacks.  Hence the float32 division ``x / scale``
(not a multiply by the reciprocal) and ``torch.round``'s round half to
even, which is ``jnp.round``'s.
"""

from __future__ import annotations

import torch

KV_QMAX = 127.0  # int8 absmax grid


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize KV vectors to int8 with one absmax scale per trailing
    head-dim vector.  ``x`` is [..., HD]; returns (data int8 [..., HD],
    scale float32 [...]).  An all-zero vector gets scale 1."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / KV_QMAX, torch.ones_like(absmax))
    data = torch.clamp(torch.round(xf / scale[..., None]), -KV_QMAX, KV_QMAX)
    return data.to(torch.int8), scale


def kv_dequantize(data: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Restore int8 KV vectors: ``float32(data) * scale`` cast to
    ``dtype``."""
    return (data.float() * scale[..., None]).to(dtype)
