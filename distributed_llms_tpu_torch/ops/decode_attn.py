"""Decode attention: one query token per row over a KV cache that reads only
each row's real depth (PyTorch/CUDA port of
``distributed_llms_tpu/ops/decode_attn.py``).

Two cache layouts, as in the JAX package:

- :func:`paged_decode_attention` — a shared page pool: row ``b`` attends
  pool slots ``[0, lengths[b])`` through its page table, slot ``s`` living
  at ``(tables[b, s // BLK], s % BLK)``.  Table entries past the row's
  depth are arbitrary and never read.  The pool is bf16, or int8 with one
  float32 absmax scale per (slot, head) (``k_scale``/``v_scale``, the
  ``checkpoint.quantize.kv_quantize`` layout).
- :func:`ragged_decode_attention` — a contiguous per-row cache
  ``[B, S, KVH, D]``: row ``b`` attends slots ``[0, lengths[b])``, or only
  ``[lengths[b] - window, lengths[b])`` with a sliding window (exact
  because the contiguous layout keeps slot == position).  The cache is
  bf16, or int8 with ``[B, S, KVH]`` float32 scales — a leg no serving
  path reaches, as in the reference, where int8 KV is paged-only.

Both return ``[B, 1, H, D]`` in q's dtype.  The device decides the
implementation:

- CUDA tensors launch the hand-written Hopper kernels
  (``csrc/paged_decode_attn.cu``: K1 and its int8 leg K1q;
  ``csrc/ragged_decode_attn.cu``: K2 and its int8 leg K2q), or raise —
  there is no fallback;
- CPU tensors take the plain versions: masked ``dot_product_attention``
  over the row (:func:`dense_reference`, the JAX package's
  ``_dense_reference``), after ``kv_dequantize`` to q's dtype in the int8
  legs, and after a gather of the row's pages for the pool
  (:func:`paged_reference`).

Every kernel is split-K, as in flash-decoding (``csrc/split_decode.cuh``):
separate blocks attend runs of a row's slots — runs of whole pages for K1
and K1q, runs of the band for K2 and K2q — and a second kernel merges
their partial softmax states.  :func:`paged_split_plan` and
:func:`ragged_split_plan` pick the split length from shapes alone (and the
card's SM count), never from ``lengths``, so a decode step does not wait
on the device to plan.

Each kernel counts its launches: ``paged_decode_attention.launches`` (K1),
``paged_decode_attention.int8_launches`` (K1q),
``ragged_decode_attention.launches`` (K2) and
``ragged_decode_attention.int8_launches`` (K2q).  A call counts one launch,
whether or not its merge kernel runs.  Every launch goes to
``torch.cuda.current_stream()``, so a decode chunk captured as a CUDA graph
records it (``runtime/chunk_graph.py``); a capture launches nothing, so its
count is taken back there, and each replay adds the launches it recorded.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..checkpoint.quantize import kv_dequantize
from ..models import layers
from . import build

PAGED_SOURCE = "paged_decode_attn.cu"
RAGGED_SOURCE = "ragged_decode_attn.cu"
MAX_GROUP = 16  # query heads per KV head the kernels take
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "dlt_paged_decode_attention": [_P] * 9 + [_I] * 9 + [_F, _P],
    "dlt_paged_decode_attention_int8": [_P] * 11 + [_I] * 9 + [_F, _P],
    "dlt_paged_decode_resources": [_I] * 3 + [_P],
    "dlt_ragged_decode_attention": [_P] * 8 + [_I] * 8 + [_F, _P],
    "dlt_ragged_decode_attention_int8": [_P] * 10 + [_I] * 8 + [_F, _P],
    "dlt_ragged_decode_resources": [_I] * 3 + [_P],
}

# The split-K plans (csrc/split_decode.cuh): a split is a multiple of
# SPLIT_UNIT slots (K2/K2q), or of whole pages spanning at least that many
# slots and at most MAX_SPLIT_PAGES pages (K1/K1q: csrc/paged_decode_attn.cu
# kMaxSplitPages), and the plan aims at BLOCKS_PER_SM blocks per SM over
# the whole grid — a few waves, so blocks that find their split short or
# past a row's depth give their SM to the next one.
SPLIT_UNIT = 64
BLOCKS_PER_SM = 8
MAX_SPLIT_PAGES = 256


def ragged_split_plan(b: int, kvh: int, s: int, window: int | None,
                      sm_count: int) -> tuple[int, int]:
    """``(split_len, n_splits)`` for a [B, S, KVH, D] cache: the longest
    band a row can have (``min(S, window)``) cut into ``n_splits`` runs of
    ``split_len`` slots, a multiple of SPLIT_UNIT, so that the
    ``n_splits * KVH * B`` blocks come near ``BLOCKS_PER_SM * sm_count``.
    Shapes only: the row lengths are on the device."""
    span = s if window is None else min(s, window)
    units = -(-span // SPLIT_UNIT)
    want = -(-(BLOCKS_PER_SM * sm_count) // (b * kvh))
    split_len = -(-units // max(1, min(units, want))) * SPLIT_UNIT
    return split_len, -(-span // split_len)


def ragged_split_bounds(length: int, s: int, window: int | None,
                        split_len: int, split: int) -> tuple[int, int]:
    """Slots ``[start, end)`` that split ``split`` attends for a row of
    ``length`` (the kernel's arithmetic: the band [length - window,
    length) cut to the cache's S slots); ``start == end`` when the split
    lies past the band."""
    raw = max(0, length)
    end = min(raw, s)
    lo = 0 if window is None else min(end, max(0, raw - window))
    start = lo + split * split_len
    return (start, min(end, start + split_len)) if start < end else (end, end)


def paged_split_plan(b: int, kvh: int, p: int, blk: int,
                     sm_count: int) -> tuple[int, int]:
    """``(split_len, n_splits)`` for a [B, P] page table over pages of BLK
    slots: the table's reach ``P * BLK`` cut into ``n_splits`` runs of
    ``split_len`` slots, each a run of whole pages (at least SPLIT_UNIT
    slots where the table reaches that far, at most MAX_SPLIT_PAGES
    pages), so that the ``n_splits * KVH * B`` blocks come near
    ``BLOCKS_PER_SM * sm_count``.  Shapes only: the row lengths are on the
    device."""
    unit = max(1, -(-SPLIT_UNIT // blk))  # pages of the smallest split
    units = -(-p // unit)
    want = -(-(BLOCKS_PER_SM * sm_count) // (b * kvh))
    pages = max(1, min(-(-units // max(1, min(units, want))) * unit, p,
                       MAX_SPLIT_PAGES))
    return pages * blk, -(-p // pages)


def paged_split_bounds(length: int, p: int, blk: int, split_len: int,
                       split: int) -> tuple[int, int]:
    """Slots ``[start, end)`` that split ``split`` attends for a row of
    ``length`` (the kernel's arithmetic: the length clamped to the
    table's reach ``[0, P * BLK]``); ``start == end`` when the split lies
    past the row's depth.  The split reads the table entries of pages
    ``start // blk`` to ``(end - 1) // blk``."""
    end = max(0, min(length, p * blk))
    start = split * split_len
    return (start, min(end, start + split_len)) if start < end else (end, end)


def split_scratch(b: int, kvh: int, g: int, d: int, n_splits: int) -> dict:
    """Shapes of the float32 partials a split launch needs: the
    unnormalized accumulators and the running max / sum of every (row,
    KV head, split, query head of the group); none with one split, whose
    blocks write the output directly."""
    if n_splits == 1:
        return {}
    return {"acc": (b, kvh, n_splits, g, d), "m": (b, kvh, n_splits, g),
            "l": (b, kvh, n_splits, g)}


_sm_count = build.sm_count


def _split_parts(q: torch.Tensor, kvh: int, n_splits: int):
    """(acc, m, l) pointers into one float32 scratch for a split launch's
    partials — null with one split — and the scratch, which the caller
    holds until the launch is enqueued."""
    b, _, h, d = q.shape
    shapes = split_scratch(b, kvh, h // kvh, d, n_splits)
    if not shapes:
        return [0, 0, 0], None
    sizes = [math.prod(shapes[name]) for name in ("acc", "m", "l")]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
    base = scratch.data_ptr()
    return [base, base + 4 * sizes[0], base + 4 * (sizes[0] + sizes[1])], scratch


def _check_aligned(name: str, tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            f"{name}: the CUDA kernel reads q and the K/V with 16-byte "
            "loads; pass 16-byte aligned tensors"
        )


def dense_reference(q, k, v, lengths, window=None):
    """Masked prefix attention over contiguous rows: row b attends slots
    [0, lengths[b]), narrowed to [lengths[b] - window, lengths[b]) by a
    window.  q [B, 1, H, D]; k/v [B, S, KVH, D].  The plain version of
    :func:`ragged_decode_attention`."""
    h = q.shape[2]
    s = k.shape[1]
    g = h // k.shape[2]
    kf = layers.repeat_kv(k.to(q.dtype), g)
    vf = layers.repeat_kv(v.to(q.dtype), g)
    slots = torch.arange(s, device=q.device)[None, :]
    lengths = lengths.to(q.device).long()[:, None]
    mask = slots < lengths  # [B, S]
    if window is not None:
        mask = mask & (slots >= lengths - window)
    return layers.dot_product_attention(q, kf, vf, mask[:, None, None, :])


def ragged_reference(q, k, v, lengths, window=None, k_scale=None,
                     v_scale=None):
    """The plain version of :func:`ragged_decode_attention`: an int8 cache
    dequantized to q's dtype at ``kv_dequantize`` numerics, then
    :func:`dense_reference`."""
    if k_scale is not None:
        k = kv_dequantize(k, k_scale, q.dtype)
        v = kv_dequantize(v, v_scale, q.dtype)
    return dense_reference(q, k, v, lengths, window)


def paged_reference(q, k_pages, v_pages, lengths, tables, k_scale=None,
                    v_scale=None):
    """The plain version of :func:`paged_decode_attention`: gather each
    row's pages into a contiguous row (int8 pools dequantized to q's dtype
    at ``kv_dequantize`` numerics), then :func:`dense_reference`.  Entries
    past a row's depth are replaced by page 0 before the gather, so they
    are never dereferenced."""
    b, _, _, d = q.shape
    _, blk, kvh, _ = k_pages.shape
    p = tables.shape[1]
    lengths = lengths.long()
    depth = (lengths + blk - 1) // blk  # pages each row needs
    needed = torch.arange(p, device=tables.device)[None, :] < depth[:, None]
    safe = torch.where(needed, tables.long(), 0)
    k_rows = k_pages[safe].reshape(b, p * blk, kvh, d)
    v_rows = v_pages[safe].reshape(b, p * blk, kvh, d)
    if k_scale is not None:
        k_rows = kv_dequantize(k_rows, k_scale[safe].reshape(b, p * blk, kvh),
                               q.dtype)
        v_rows = kv_dequantize(v_rows, v_scale[safe].reshape(b, p * blk, kvh),
                               q.dtype)
    return dense_reference(q, k_rows, v_rows, lengths)


def _check_heads(q, k, what: str) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, D], got {tuple(q.shape)}")
    h, d = q.shape[2], q.shape[3]
    if k.dim() != 4:
        raise ValueError(f"{what} must be 4-d, got {tuple(k.shape)}")
    kvh = k.shape[2]
    if k.shape[3] != d or h % kvh:
        raise ValueError(
            f"head shapes disagree: q heads {h} x dim {d}, {what} kv heads "
            f"{kvh} x dim {k.shape[3]}"
        )


def _check_quant(k, k_scale, v_scale) -> bool:
    """The int8 leg's argument contract (the JAX package's): both scales or
    neither, and int8 data when scales are given.  Returns whether the
    call is quantized."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is not None and k.dtype != torch.int8:
        raise ValueError(f"KV scales given but pages are {k.dtype}, not int8")
    if k_scale is not None and not (
            k_scale.shape == v_scale.shape == k.shape[:3]):
        raise ValueError(
            f"scales must be {tuple(k.shape[:3])}, got "
            f"{tuple(k_scale.shape)} / {tuple(v_scale.shape)}"
        )
    return k_scale is not None


def _route(name: str, tensors) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when all lie on one
    CUDA device; raises otherwise."""
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return "cpu"
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name} needs every tensor on one CUDA device (or all on the "
            f"CPU), got {[str(t.device) for t in tensors]}"
        )
    return "cuda"


def _check_launchable(name, q, kv, index_tensors) -> None:
    """What every CUDA launch needs: bf16 queries, int32 indices,
    contiguous tensors, and head shapes the kernels take."""
    b, _, h, d = q.shape
    kvh = kv[0].shape[2]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 q, got {q.dtype}")
    if any(t.dtype != torch.int32 for t in index_tensors):
        raise TypeError(
            f"{name}: lengths/tables must be int32, got "
            f"{[t.dtype for t in index_tensors]}"
        )
    if not all(t.is_contiguous() for t in (q, *kv, *index_tensors)):
        raise ValueError(f"{name} needs contiguous tensors")
    if d % 8 or d > MAX_HEAD_DIM or h // kvh > MAX_GROUP or b > 65535:
        raise ValueError(
            f"{name}: the CUDA kernel takes head_dim a multiple of 8 up to "
            f"{MAX_HEAD_DIM}, at most {MAX_GROUP} query heads per KV head "
            f"and batch <= 65535; got D={d}, H/KVH={h // kvh}, B={b}"
        )


def paged_decode_attention(
    q: torch.Tensor,        # [B, 1, H, D]
    k_pages: torch.Tensor,  # [NB, BLK, KVH, D] — the shared page pool
    v_pages: torch.Tensor,  # [NB, BLK, KVH, D]
    lengths: torch.Tensor,  # [B] int32 — row b attends its first lengths[b] slots
    tables: torch.Tensor,   # [B, P] int32 page ids
    k_scale: torch.Tensor | None = None,  # [NB, BLK, KVH] float32 — int8
    #   leg: pages are int8 and the kernel folds the scales into the
    #   contraction, so the pool is read at 1 byte per element
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """See the module docstring."""
    _check_heads(q, k_pages, "pool")
    if v_pages.shape != k_pages.shape:
        raise ValueError(
            f"k/v pages must match, got {tuple(k_pages.shape)} / "
            f"{tuple(v_pages.shape)}"
        )
    b = q.shape[0]
    if lengths.shape != (b,) or tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(
            f"lengths must be [B] and tables [B, P] for B={b}, got "
            f"{tuple(lengths.shape)} / {tuple(tables.shape)}"
        )
    quant = _check_quant(k_pages, k_scale, v_scale)
    scales = (k_scale, v_scale) if quant else ()
    tensors = (q, k_pages, v_pages, lengths, tables, *scales)
    if _route("paged_decode_attention", tensors) == "cpu":
        return paged_reference(q, k_pages, v_pages, lengths, tables, *scales)
    _check_launchable("paged_decode_attention", q, (k_pages, v_pages, *scales),
                      (lengths, tables))
    want = torch.int8 if quant else torch.bfloat16
    if not (k_pages.dtype == v_pages.dtype == want) or any(
            s.dtype != torch.float32 for s in scales):
        raise TypeError(
            f"the CUDA kernel takes {want} pools"
            + (" with float32 scales" if quant else "")
            + f", got {k_pages.dtype} / {v_pages.dtype}"
            + "".join(f" / {s.dtype}" for s in scales)
        )
    _check_aligned("paged_decode_attention", (q, k_pages, v_pages))
    h, d = q.shape[2], q.shape[3]
    nb, blk, kvh, _ = k_pages.shape
    p = tables.shape[1]
    split_len, n_splits = paged_split_plan(b, kvh, p, blk,
                                           _sm_count(q.device))
    out = torch.empty_like(q)
    parts, _scratch = _split_parts(q, kvh, n_splits)
    shape = (b, h, kvh, d, nb, blk, p, split_len, n_splits,
             float(d) ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if quant:
        err = build.entry(PAGED_SOURCE, "dlt_paged_decode_attention_int8",
                          _ARGTYPES["dlt_paged_decode_attention_int8"])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
            tables.data_ptr(), out.data_ptr(), *parts, *shape)
    else:
        err = build.entry(PAGED_SOURCE, "dlt_paged_decode_attention",
                          _ARGTYPES["dlt_paged_decode_attention"])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            lengths.data_ptr(), tables.data_ptr(), out.data_ptr(), *parts,
            *shape)
    if err != 0:
        raise RuntimeError(
            f"paged decode attention kernel launch failed (cudaError {err})"
        )
    if quant:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.int8_launches = 0


def ragged_decode_attention(
    q: torch.Tensor,        # [B, 1, H, D]
    k: torch.Tensor,        # [B, S, KVH, D] — the full cache width
    v: torch.Tensor,        # [B, S, KVH, D]
    lengths: torch.Tensor,  # [B] int32 — row b attends slots [0, lengths[b])
    window: int | None = None,  # sliding window: only
    #   [lengths[b] - window, lengths[b]) — the kernel reads just that band
    k_scale: torch.Tensor | None = None,  # [B, S, KVH] float32 — int8 leg
    #   (K2q): k/v are int8 and the kernel folds the scales into the
    #   contraction, so the cache is read at 1 byte per element
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """See the module docstring."""
    _check_heads(q, k, "cache")
    b = q.shape[0]
    if v.shape != k.shape or k.shape[0] != b:
        raise ValueError(
            f"k/v must be matching [B={b}, S, KVH, D], got "
            f"{tuple(k.shape)} / {tuple(v.shape)}"
        )
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be an int >= 1 or None, got {window!r}")
    quant = _check_quant(k, k_scale, v_scale)
    scales = (k_scale, v_scale) if quant else ()
    if _route("ragged_decode_attention", (q, k, v, lengths, *scales)) == "cpu":
        return ragged_reference(q, k, v, lengths, window, *scales)
    _check_launchable("ragged_decode_attention", q, (k, v, *scales), (lengths,))
    want = torch.int8 if quant else torch.bfloat16
    if not (k.dtype == v.dtype == want) or any(
            sc.dtype != torch.float32 for sc in scales):
        raise TypeError(
            f"the CUDA kernel takes a {want} cache"
            + (" with float32 scales" if quant else "")
            + f", got {k.dtype} / {v.dtype}"
            + "".join(f" / {sc.dtype}" for sc in scales)
        )
    _check_aligned("ragged_decode_attention", (q, k, v))
    h, d = q.shape[2], q.shape[3]
    _, s, kvh, _ = k.shape
    split_len, n_splits = ragged_split_plan(b, kvh, s, window,
                                            _sm_count(q.device))
    out = torch.empty_like(q)
    parts, _scratch = _split_parts(q, kvh, n_splits)
    shape = (b, h, kvh, d, s, min(window or 0, 2**31 - 1),  # 0: no window
             split_len, n_splits, float(d) ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if quant:
        err = build.entry(RAGGED_SOURCE, "dlt_ragged_decode_attention_int8",
                          _ARGTYPES["dlt_ragged_decode_attention_int8"])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(), *parts,
            *shape)
    else:
        err = build.entry(RAGGED_SOURCE, "dlt_ragged_decode_attention",
                          _ARGTYPES["dlt_ragged_decode_attention"])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), *parts, *shape)
    if err != 0:
        raise RuntimeError(
            f"ragged decode attention kernel launch failed (cudaError {err})"
        )
    if quant:
        ragged_decode_attention.int8_launches += 1
    else:
        ragged_decode_attention.launches += 1
    return out


def _kernel_resources(source: str, name: str, d: int, g: int,
                      quant: bool) -> dict:
    info = (ctypes.c_int * 7)()
    err = build.entry(source, name, _ARGTYPES[name])(
        d, g, int(quant), ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{name} failed ({err})")
    keys = ("threads", "tile_slots", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes", "merge_registers")
    return dict(zip(keys, info))


def ragged_kernel_resources(d: int, g: int, quant: bool) -> dict:
    """What the K2 (``quant=False``) or K2q split kernel takes on the
    current card at head dim ``d`` and group ``g``: threads and tile slots
    per block, dynamic shared memory, resident blocks per SM, registers and
    local (spill) bytes per thread, and the merge kernel's registers."""
    return _kernel_resources(RAGGED_SOURCE, "dlt_ragged_decode_resources",
                             d, g, quant)


def paged_kernel_resources(d: int, g: int, quant: bool) -> dict:
    """The same for the K1 (``quant=False``) or K1q split kernel; its
    shared memory includes the split's page ids."""
    return _kernel_resources(PAGED_SOURCE, "dlt_paged_decode_resources",
                             d, g, quant)


ragged_decode_attention.launches = 0
ragged_decode_attention.int8_launches = 0
