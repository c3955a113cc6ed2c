"""Paged decode attention: one query token per row over a shared KV page
pool (PyTorch/CUDA port of ``distributed_llms_tpu/ops/decode_attn.py``
``paged_decode_attention``).

Contract (the JAX package's): row ``b`` attends pool slots
``[0, lengths[b])`` through its page table — slot ``s`` lives at
``(tables[b, s // BLK], s % BLK)``.  Table entries past the row's depth
are arbitrary and never read.  Returns ``[B, 1, H, D]`` in q's dtype.

The device decides the implementation:

- CUDA tensors launch the hand-written Hopper kernel
  (``csrc/paged_decode_attn.cu``), or raise — there is no fallback;
- CPU tensors take the plain version (:func:`paged_reference`): gather the
  row's pages, then masked ``dot_product_attention`` — the JAX package's
  own fallback math (``_paged_impl``'s gather + ``_dense_reference``).
"""

from __future__ import annotations

import ctypes

import torch

from ..models import layers

KERNEL_SOURCE = "paged_decode_attn.cu"
MAX_GROUP = 16  # query heads per KV head the kernel takes
MAX_HEAD_DIM = 256


def dense_reference(q, k, v, lengths):
    """Masked prefix attention over contiguous rows: row b attends slots
    [0, lengths[b]).  q [B, 1, H, D]; k/v [B, S, KVH, D]."""
    h = q.shape[2]
    s = k.shape[1]
    g = h // k.shape[2]
    kf = layers.repeat_kv(k.to(q.dtype), g)
    vf = layers.repeat_kv(v.to(q.dtype), g)
    slots = torch.arange(s, device=q.device)
    mask = slots[None, :] < lengths.to(q.device).long()[:, None]  # [B, S]
    return layers.dot_product_attention(q, kf, vf, mask[:, None, None, :])


def paged_reference(q, k_pages, v_pages, lengths, tables):
    """The plain version: gather each row's pages into a contiguous row,
    then :func:`dense_reference`.  Entries past a row's depth are replaced
    by page 0 before the gather, so they are never dereferenced."""
    b, _, _, d = q.shape
    _, blk, kvh, _ = k_pages.shape
    p = tables.shape[1]
    lengths = lengths.long()
    depth = (lengths + blk - 1) // blk  # pages each row needs
    needed = torch.arange(p, device=tables.device)[None, :] < depth[:, None]
    safe = torch.where(needed, tables.long(), 0)
    k_rows = k_pages[safe].reshape(b, p * blk, kvh, d)
    v_rows = v_pages[safe].reshape(b, p * blk, kvh, d)
    return dense_reference(q, k_rows, v_rows, lengths)


def _check(q, k_pages, v_pages, lengths, tables) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"k/v pages must be matching [NB, BLK, KVH, D], got "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}"
        )
    kvh = k_pages.shape[2]
    if k_pages.shape[3] != d or h % kvh:
        raise ValueError(
            f"head shapes disagree: q heads {h} x dim {d}, pool kv heads "
            f"{kvh} x dim {k_pages.shape[3]}"
        )
    if lengths.shape != (b,) or tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(
            f"lengths must be [B] and tables [B, P] for B={b}, got "
            f"{tuple(lengths.shape)} / {tuple(tables.shape)}"
        )


def paged_decode_attention(
    q: torch.Tensor,        # [B, 1, H, D]
    k_pages: torch.Tensor,  # [NB, BLK, KVH, D] — the shared page pool
    v_pages: torch.Tensor,  # [NB, BLK, KVH, D]
    lengths: torch.Tensor,  # [B] int32 — row b attends its first lengths[b] slots
    tables: torch.Tensor,   # [B, P] int32 page ids
) -> torch.Tensor:
    """See the module docstring.  ``paged_decode_attention.launches`` counts
    the CUDA kernel launches made through this wrapper."""
    _check(q, k_pages, v_pages, lengths, tables)
    tensors = (q, k_pages, v_pages, lengths, tables)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return paged_reference(q, k_pages, v_pages, lengths, tables)
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"paged_decode_attention needs every tensor on one CUDA device "
            f"(or all on the CPU), got {[str(t.device) for t in tensors]}"
        )
    b, _, h, d = q.shape
    nb, blk, kvh, _ = k_pages.shape
    p = tables.shape[1]
    if not (q.dtype == k_pages.dtype == v_pages.dtype == torch.bfloat16):
        raise TypeError(
            f"the CUDA kernel takes bfloat16 q and pools, got {q.dtype} / "
            f"{k_pages.dtype} / {v_pages.dtype}"
        )
    if lengths.dtype != torch.int32 or tables.dtype != torch.int32:
        raise TypeError(
            f"lengths and tables must be int32, got {lengths.dtype} / "
            f"{tables.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention needs contiguous tensors")
    if d % 8 or d > MAX_HEAD_DIM or h // kvh > MAX_GROUP or b > 65535:
        raise ValueError(
            f"the CUDA kernel takes head_dim a multiple of 8 up to "
            f"{MAX_HEAD_DIM}, at most {MAX_GROUP} query heads per KV head "
            f"and batch <= 65535; got D={d}, H/KVH={h // kvh}, B={b}"
        )
    out = torch.empty_like(q)
    lib = _kernel_library()
    err = lib.dlt_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), tables.data_ptr(), out.data_ptr(),
        b, h, kvh, d, nb, blk, p, float(d) ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"paged decode attention kernel launch failed (cudaError {err})"
        )
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def _kernel_library() -> ctypes.CDLL:
    from . import build

    lib = build.load(KERNEL_SOURCE)
    fn = lib.dlt_paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
