"""Weight and KV quantization (PyTorch port of
``distributed_llms_tpu/checkpoint/quantize.py``).

Weights: int8 and packed int4 with blockwise absmax scales along the LAST
axis of each weight — the reduction axis for most weights, the output head
dim for wq/wk/wv ``[D, H, hd]``.  Only matmul weights (ndim >= 2) quantize;
norms and biases stay in the model dtype (:func:`leaf_plan`).  A quantized
tree holds :class:`QuantizedTensor` leaves that :func:`dequantize_tree`
restores, or that the dequant-matmul kernel (``ops/quant_matmul.py``)
consumes directly.  int4 packs two values per byte along ``pack_axis``,
the weight's reduction axis: rows k and k+1 share a byte, low nibble =
even row.

KV: int8 with one float32 absmax scale per trailing head-dim vector, so
the decode kernel can fold the scales into the attention contraction
itself: score = (q . k_int8) * k_scale and out = sum((p * v_scale) .
v_int8) — per-(slot, head) scales sit outside the head-dim dot product,
which is what lets the int8 leg of ``ops/decode_attn.py`` read the pool at
1 byte per element and never materialize a dequantized page.

Both are bit-exact with the JAX package's functions on the same inputs:
the prefix-cache digests are salted by the KV width, so an int8 page must
hold the same bytes in both stacks, and the shard stores of the two stacks
must hold the same codes.  Hence the float32 division ``x / scale`` (not a
multiply by the reciprocal) and ``torch.round``'s round half to even,
which is ``jnp.round``'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class QuantizedTensor:
    """Blockwise-quantized weight.

    data: int8; for int4, two values packed per byte along ``pack_axis``
    (low nibble = even index, high nibble = odd index along that axis).
    scale: float32, the unpacked shape with the last axis divided into
    blocks.  pack_axis: negative axis the int4 pairs run along — negative
    so slicing off a leading stacked-layer axis (``qt[i]``) keeps it
    valid.  Unused for int8.  ``orig_shape`` is the shape at quantization
    and goes stale on a per-layer slice; shapes derive from data/scale.
    """

    data: torch.Tensor
    scale: torch.Tensor
    bits: int
    orig_shape: tuple[int, ...]
    pack_axis: int = -2

    @property
    def unpacked_shape(self) -> tuple[int, ...]:
        """Shape of the dequantized weight, derived from ``data``."""
        shape = list(self.data.shape)
        if self.bits == 4:
            shape[self.pack_axis] *= 2
        return tuple(shape)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.data.to(device), self.scale.to(device),
                               self.bits, self.orig_shape, self.pack_axis)

    def __getitem__(self, i) -> "QuantizedTensor":
        """Layer ``i`` of a stacked ``[L, ...]`` leaf (views)."""
        return QuantizedTensor(self.data[i], self.scale[i], self.bits,
                               self.orig_shape, self.pack_axis)


def quant_block(n: int, block: int = 128) -> int:
    """The scale block along a last axis of width ``n``: ``block``, capped
    at ``n`` and shrunk to gcd(n, block) when it does not divide ``n``."""
    block = min(block, n)
    return block if n % block == 0 else math.gcd(n, block)


def quantize(x: torch.Tensor, bits: int = 8, block: int = 128,
             pack_axis: int = -2) -> QuantizedTensor:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    orig_shape = tuple(x.shape)
    n = x.shape[-1]
    block = quant_block(n, block)
    xb = x.float().reshape(*x.shape[:-1], n // block, block)
    qmax = 127.0 if bits == 8 else 7.0
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(xb / scale), -qmax, qmax).to(torch.int8)
    q = q.reshape(orig_shape)
    scale = scale[..., 0]  # [..., n_blocks]
    if bits == 4:
        if not -x.dim() <= pack_axis < 0:
            raise ValueError(f"pack_axis must be negative, got {pack_axis}")
        a = x.dim() + pack_axis
        if x.shape[a] % 2:
            raise ValueError(
                f"int4 packing requires even size along pack_axis {pack_axis} "
                f"(shape {orig_shape})"
            )
        q = pack_int4(q, pack_axis)
    return QuantizedTensor(data=q, scale=scale, bits=bits,
                           orig_shape=orig_shape, pack_axis=pack_axis)


def pack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """int8 values in [-8, 7] -> packed int4 bytes, pairs along ``axis``
    (negative, even size): low nibble = even index, high = odd."""
    lead = (slice(None),) * (q.dim() + axis)
    q32 = q.to(torch.int32)
    lo = q32[lead + (slice(0, None, 2),)] & 0x0F
    hi = (q32[lead + (slice(1, None, 2),)] & 0x0F) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(q: torch.Tensor, axis: int) -> torch.Tensor:
    """Packed int4 bytes -> int8 values, pairs interleaved back along
    ``axis`` (negative): the sign-extended low nibble is the even index,
    the high nibble the odd one.  Written straight into the interleaved
    int8 output (a byte an element), so rehydrating an expert stack makes
    no wider temporaries."""
    a = q.dim() + axis
    out = torch.empty((*q.shape[:a + 1], 2, *q.shape[a + 1:]),
                      dtype=torch.int8, device=q.device)
    lo, hi = out.select(a + 1, 0), out.select(a + 1, 1)
    torch.bitwise_left_shift(q, 4, out=lo)
    lo.bitwise_right_shift_(4)  # the arithmetic shift sign-extends
    torch.bitwise_right_shift(q, 4, out=hi)
    shape = list(q.shape)
    shape[a] *= 2
    return out.reshape(shape)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``float32(q) * scale`` rounded to ``dtype``, in one pass: the
    product is computed in float32 and only its rounding is stored.
    Shapes derive from data/scale, so a per-layer slice of a stacked leaf
    dequantizes."""
    q = unpack_int4(qt.data, qt.pack_axis) if qt.bits == 4 else qt.data
    n = q.shape[-1]
    n_blocks = qt.scale.shape[-1]
    blocked = (*q.shape[:-1], n_blocks, n // n_blocks)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    torch.mul(q.reshape(blocked), qt.scale[..., None], out=out.view(blocked))
    return out


# Weights whose trailing TWO axes are output axes ([D, H, hd]): their
# reduction axis sits at -3, everything else contracts at -2.
_PACK_AXIS_BY_NAME = {"wq": -3, "wk": -3, "wv": -3}

# Bias leaves by exact name (not by a "b" prefix), so a weight whose name
# starts with "b" still quantizes.
_BIAS_NAMES = frozenset({"bq", "bk", "bv", "bo", "b_in", "b_out", "b_gate",
                         "b_up", "b_down"})


def _should_quantize(path: str, x: Any) -> bool:
    if getattr(x, "ndim", 0) < 2:
        return False
    leaf = path.split("/")[-1]
    if "norm" in path or "ln" in path.split("/")[-2:][0]:
        return False
    return leaf not in _BIAS_NAMES


def leaf_plan(path: str, x: Any) -> tuple[bool, int]:
    """(quantize?, pack_axis) for a leaf named by its "/"-joined path —
    the one source of the decisions, shared by :func:`quantize_tree` and
    the store's leaf-by-leaf save."""
    if not _should_quantize(path, x):
        return False, -2
    return True, _PACK_AXIS_BY_NAME.get(path.split("/")[-1], -2)


def quantize_tree(params: Any, bits: int = 8, block: int = 128,
                  _path: str = "") -> Any:
    """Quantize the matmul weights of a parameter tree; other leaves pass
    through."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, bits, block, f"{_path}/{k}" if _path
                                 else str(k))
                for k, v in params.items()}
    should, pack_axis = leaf_plan(_path, params)
    if should:
        return quantize(params, bits=bits, block=block, pack_axis=pack_axis)
    return params


def dequantize_tree(params: Any, dtype: torch.dtype | None = None) -> Any:
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if isinstance(params, QuantizedTensor):
        return dequantize(params, dtype or torch.float32)
    return params


def tree_bytes(params: Any) -> int:
    """Bytes a parameter tree holds: codes and scales of quantized leaves,
    the elements of the others."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return (params.data.numel() * params.data.element_size()
                + params.scale.numel() * params.scale.element_size())
    return params.numel() * params.element_size()


# ---------------------------------------------------------------------------
# KV-cache quantization (int8 KV pages)
# ---------------------------------------------------------------------------

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
