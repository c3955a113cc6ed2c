"""Weight-only quantized matrix products (PyTorch/CUDA port of
``distributed_llms_tpu/ops/quant_matmul.py``).

:func:`quant_contract` computes ``x @ dequant(W)`` for a blockwise-quantized
weight (``checkpoint.quantize.QuantizedTensor``, int8 or row-packed int4):
the leading ``k_lead`` axes of the weight contract against x's trailing
axes, flattened to ``[K, N]`` exactly as the JAX package's ``flatten_qt``
does.  :func:`quant_matmul` is the 2-D product on those flat operands.
The device decides the implementation:

- CUDA tensors launch the hand-written Hopper kernel K5
  (``csrc/quant_matmul.cu``), or raise — there is no fallback;
- CPU tensors take the plain version, :func:`quant_matmul_plain`: the
  weight dequantized to x's dtype (``float32(q) * scale``, cast), then a
  product accumulated in float32.

An int4 weight must pack its pairs along its last contracted axis (the
layout ``checkpoint.quantize.quantize_tree`` writes); any other packing
raises ``NotImplementedError``.  The kernel counts its launches per width:
``quant_matmul.launches`` (int8) and ``quant_matmul.int4_launches``, one
a call.

On bf16 activations the kernel splits K over separate blocks where the
output alone would not fill the card (decode): :func:`qmm_plan` picks the
tile and the split from the shapes and the card's SM count.  The splits of
a tile run as one thread-block cluster and sum their float32 partials in
split order — the same inputs give the same bits on every call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..checkpoint.quantize import QuantizedTensor, unpack_int4
from . import build

SOURCE = "quant_matmul.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "dlt_quant_matmul": [_P] * 4 + [_I] * 9 + [_P],
    "dlt_quant_matmul_f32": [_P] * 4 + [_I] * 5 + [_P],
    "dlt_quant_matmul_resources": [_I] * 4 + [_P],
}

# The bf16 kernel's tiles (csrc/quant_matmul.cu DLT_QMM_TILES): rows of x
# and output columns a block owns, widest first for each row count, and
# the blocks per SM the split plan aims at — a few of the decode tiles,
# two of the prefill tiles of 64 and 128 rows.  K runs in BK-row steps;
# a split walks at least MIN_SPLIT_TILES of them, and the splits of a
# tile (one thread-block cluster) number at most MAX_SPLITS.  A narrower
# tile is taken where the wider one cannot reach WAVES blocks per SM even
# split MAX_SPLITS ways.
TILES = ((8, 128, 4), (8, 64, 4), (16, 128, 4), (16, 64, 4), (64, 128, 2),
         (128, 128, 2))
BK = 64
MIN_SPLIT_TILES = 2
MAX_SPLITS = 16
WAVES = 2


def qmm_tile(m: int, n: int, sm_count: int) -> tuple[int, int, int]:
    """``(tile_m, tile_n, blocks per SM aimed at)`` for M rows and N
    columns: the smallest tile row count that holds M (128 above 64), and
    of its tiles the widest whose grid split MAX_SPLITS ways reaches WAVES
    blocks per SM (else the narrowest)."""
    rows = next((t[0] for t in TILES if m <= t[0]), TILES[-1][0])
    tiles = [t for t in TILES if t[0] == rows]
    for tile in tiles:
        blocks = -(-m // tile[0]) * -(-n // tile[1])
        if blocks * MAX_SPLITS >= WAVES * sm_count:
            return tile
    return tiles[-1]


@functools.lru_cache(maxsize=4096)
def qmm_plan(m: int, k: int, n: int,
             sm_count: int) -> tuple[int, int, int, int]:
    """``(tile_m, tile_n, k_per_split, n_splits)`` of the bf16 kernel for
    ``[M, K] @ [K, N]``: the tile of :func:`qmm_tile`, and K cut into
    ``n_splits`` runs of ``k_per_split`` rows — whole BK-row tiles, so
    every split edge falls on an int4 pair, the last run the shortest — so
    that the ``m_tiles * n_tiles * n_splits`` blocks come near the tile's
    blocks per SM times ``sm_count``, with at most MAX_SPLITS splits.
    Shapes only."""
    tile_m, tile_n, per_sm = qmm_tile(m, n, sm_count)
    k_tiles = -(-k // BK)
    blocks = -(-m // tile_m) * -(-n // tile_n)
    want = -(-(per_sm * sm_count) // blocks)
    per_split = min(k_tiles, max(MIN_SPLIT_TILES, -(-k_tiles // want),
                                 -(-k_tiles // MAX_SPLITS)))
    return tile_m, tile_n, per_split * BK, -(-k_tiles // per_split)


def qmm_split_bounds(k: int, k_per_split: int, split: int) -> tuple[int, int]:
    """K rows ``[start, end)`` that split ``split`` of a plan sums."""
    start = split * k_per_split
    return start, min(k, start + k_per_split)


_sm_count = build.sm_count


def flatten_qt(qt: QuantizedTensor, k_lead: int):
    """(q2 [K or K/2, N] int8, s2 [K, N / block] float32) of a weight whose
    first ``k_lead`` axes contract.  Scale blocks run along the last axis
    only, so flattening the trailing axes keeps them contiguous; int4 data
    rows are packed pairs, scale rows stay per unpacked row."""
    kq = math.prod(qt.data.shape[:k_lead])
    ks = math.prod(qt.scale.shape[:k_lead])
    return qt.data.reshape(kq, -1), qt.scale.reshape(ks, -1)


def dequant_flat(q2: torch.Tensor, s2: torch.Tensor, bits: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """The flat weight ``[K, N]`` in ``dtype``: ``float32(q) * s`` per (row,
    block of N), cast — ``checkpoint.quantize.dequantize``'s numerics."""
    q = unpack_int4(q2, -2) if bits == 4 else q2
    k, n = q.shape
    nb = s2.shape[1]
    w = q.float().reshape(k, nb, n // nb) * s2[:, :, None]
    return w.reshape(k, n).to(dtype)


def quant_matmul_plain(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                       bits: int) -> torch.Tensor:
    """The plain version of K5: dequantize, then ``x2 @ w`` with products
    and sums in float32, cast to x's dtype."""
    w = dequant_flat(q2, s2, bits, x2.dtype)
    return (x2.float() @ w.float()).to(x2.dtype)


def _check_operands(x2, q2, s2, bits) -> None:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if x2.dim() != 2 or q2.dim() != 2 or s2.dim() != 2:
        raise ValueError(
            f"x, q and s must be 2-d, got {tuple(x2.shape)} / "
            f"{tuple(q2.shape)} / {tuple(s2.shape)}")
    if q2.dtype != torch.int8 or s2.dtype != torch.float32:
        raise TypeError(
            f"codes must be int8 and scales float32, got {q2.dtype} / "
            f"{s2.dtype}")
    m, k = x2.shape
    kq, n = q2.shape
    if kq * (2 if bits == 4 else 1) != k or s2.shape[0] != k:
        raise ValueError(
            f"K disagrees: x {tuple(x2.shape)}, int{bits} codes "
            f"{tuple(q2.shape)}, scales {tuple(s2.shape)}")
    if s2.shape[1] < 1 or n % s2.shape[1]:
        raise ValueError(
            f"{s2.shape[1]} scale blocks do not divide N = {n}")


def _route(tensors) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when all lie on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return "cpu"
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            "quant_matmul needs every tensor on one CUDA device (or all on "
            f"the CPU), got {[str(d) for d in devices]}")
    return "cuda"


def quant_matmul(x2: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """``x2 [M, K] @ dequant(q2, s2) -> [M, N]`` in x's dtype (K5)."""
    _check_operands(x2, q2, s2, bits)
    if _route((x2, q2, s2)) == "cpu":
        return quant_matmul_plain(x2, q2, s2, bits)
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"the CUDA kernel takes bfloat16 or float32 x, got {x2.dtype}")
    m, k = x2.shape
    n, nb = q2.shape[1], s2.shape[1]
    if max(m, k, n) >= 2**31:  # the kernel's sizes are 32-bit ints
        raise ValueError(f"shape [{m}, {k}] x [{k}, {n}] exceeds the kernel")
    x2, q2, s2 = (t.contiguous() for t in (x2, q2, s2))
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if x2.dtype == torch.float32:
        err = build.entry(SOURCE, "dlt_quant_matmul_f32",
                          _ARGTYPES["dlt_quant_matmul_f32"])(
            x2.data_ptr(), q2.data_ptr(), s2.data_ptr(), out.data_ptr(),
            m, k, n, nb, bits, stream)
    else:
        # 16-byte loads of x rows (K % 8 == 0) and code rows (N % 16 == 0)
        # need 16-byte aligned bases; odd shapes load element by element.
        if (k % 8 == 0 and x2.data_ptr() % 16) or (
                n % 16 == 0 and q2.data_ptr() % 16):
            raise ValueError(
                "quant_matmul: the CUDA kernel reads x and the codes with "
                "16-byte loads; pass 16-byte aligned tensors")
        err = build.entry(SOURCE, "dlt_quant_matmul",
                          _ARGTYPES["dlt_quant_matmul"])(
            x2.data_ptr(), q2.data_ptr(), s2.data_ptr(), out.data_ptr(),
            m, k, n, nb, bits, *qmm_plan(m, k, n, _sm_count(x2.device)),
            stream)
    if err != 0:
        raise RuntimeError(
            f"quant matmul kernel launch failed (cudaError {err})")
    if bits == 4:
        quant_matmul.int4_launches += 1
    else:
        quant_matmul.launches += 1
    return out


def quant_matmul_resources(m: int, n: int, bits: int,
                           block: int = 128) -> dict:
    """What the bf16 kernel a product of M rows and N columns launches
    takes on the current card (int8 codes with ``bits=8``, int4 with 4;
    scale blocks of ``block`` columns): threads, tile rows and columns,
    dynamic shared memory of its stages, resident blocks per SM, and
    registers and local (spill) bytes per thread."""
    tile_m, tile_n, _ = qmm_tile(m, n, _sm_count(torch.device("cuda")))
    info = (ctypes.c_int * 7)()
    err = build.entry(SOURCE, "dlt_quant_matmul_resources",
                      _ARGTYPES["dlt_quant_matmul_resources"])(
        tile_m, tile_n, bits, block, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"dlt_quant_matmul_resources failed ({err})")
    keys = ("threads", "tile_m", "tile_n", "smem_bytes", "blocks_per_sm",
            "registers", "local_bytes")
    return dict(zip(keys, info))


quant_matmul.launches = 0
quant_matmul.int4_launches = 0


def check_pack_axis(qt: QuantizedTensor, k_lead: int, stacked: int = 0) -> None:
    """Raise ``NotImplementedError`` unless an int4 weight's pairs run
    along its last contracted axis (``stacked`` leading layer axes not
    counted) — the only packing whose flat rows are pairs of K rows.
    Stores written before ``pack_axis`` was recorded packed along the last
    axis, and are refused here."""
    want = k_lead - 1 - (qt.data.dim() - stacked)
    if qt.bits == 4 and qt.pack_axis != want:
        raise NotImplementedError(
            f"int4 weight of shape {tuple(qt.unpacked_shape)} packed along "
            f"axis {qt.pack_axis}; the dequant-matmul takes pairs along its "
            f"last contracted axis ({want}) — re-save the store")


def quant_contract(x: torch.Tensor, qt: QuantizedTensor,
                   k_lead: int) -> torch.Tensor:
    """``x[..., K-axes] @ dequant(W)[K-axes, N-axes]``: the trailing
    ``k_lead`` axes of ``x`` contract against the weight's leading ones
    (1 for wq/wk/wv/w_gate/w_up/w_down, 2 for wo ``[H, hd, D]``); the
    weight's remaining axes are restored on the output."""
    check_pack_axis(qt, k_lead)
    q2, s2 = flatten_qt(qt, k_lead)
    lead = x.shape[: x.dim() - k_lead]
    k = math.prod(x.shape[x.dim() - k_lead:])
    y2 = quant_matmul(x.reshape(-1, k), q2, s2, qt.bits)
    return y2.reshape(*lead, *qt.data.shape[k_lead:])
