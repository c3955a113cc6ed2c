"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device (the kernels have no
CPU mode).  Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Paged decode attention (K1, bf16; K1q, int8 pools with float32 scales;
the split-K kernel over page runs) at shapes that walk the kernel's edges
(group size 1 and 16, head dims 64/72/256, page sizes 1/16/48/64/128 —
tiles that straddle pages —, lengths 0, 1, page edges +- 1, split edges
+- 1, past the table's reach, one 8192-slot row at batch 1, garbage
table entries past each row's depth), with no local-memory spill in
either leg; and ragged decode attention (K2, a contiguous bf16 cache;
the split-K kernel) over group sizes 1/3/4/16, head dims 64/72/128/256,
windows none / 1 / 300 / 4096 / longer than the cache, and lengths 0, 1,
S, S + 1 and 64-slot split edges +- 1, and one 32768-slot row at batch 1
(window 4096 and none).

Tolerance per output row (one query, one head): L2 error <= 1e-2 x the
plain row's L2 norm (``GPU_DECODE_ROW_REL``, chip_smoke.py's
``DECODE_ROW_REL``), because a row over n slots is only ~sqrt(e / n) in
size and an absolute limit would pass a wrong band edge over thousands of
slots.  bf16 probabilities round at different points (per 8-slot update
and unnormalized in the kernels, normalized in the plain versions), then
the bf16 output rounds.  The int8 legs (K1q, K2q) add one bf16 ulp, 2^-7
of each term: their plain version rounds the dequantized V to bf16 where
the kernel (like the TPU kernel) rounds p * v_scale to bf16 and multiplies
the int8 value exactly (``GPU_DECODE_ROW_REL_INT8`` = 1e-2 + 2^-7).  A row
with no live slot (length 0) must be exactly zero: the kernels give zeros
where the plain version averages every slot (as the JAX package's kernel
and dense reference do).

The weight-only dequant-matmul (K5, int8 and row-packed int4 codes with
float32 scales per (K row, block of N)) over M = 1 / 8 / 17 / 300, K and N
off the kernel's 64-row K tiles and 64- to 256-column tiles, scale blocks
32 / 64 / 128 (and 8, 40 and 130: narrower than a lane's 4 columns, or not
a multiple of 4, which takes the kernel's scale per column), Llama-3-8B's
six projection shapes (decode M = 8 and prefill M = 512), the edges of the
split plan (M of 1, 16, 17, 64 and 65; a K off the tiles in uneven
splits), the wo layout through ``k_lead=2``, bf16 and float32
activations.  Tolerance: bf16 outputs within 2^-7 |out| + 1e-2 (one
output ulp plus summation order: both sides round the weight to bf16 and
accumulate in float32), float32 within 1e-4 |out| + 1e-4.  Two calls on
the same inputs give the same bits (the split reduction has a fixed
order), the served instantiations keep their state in registers, and
wrong dtypes, a misaligned base and a legacy int4 pack axis raise.

The int8 leg of the contiguous decode kernel (K2q: int8 cache with
[B, S, KVH] float32 scales from ``kv_quantize``) over K2's shapes, with
K1q's tolerance.

Flash attention: the static-causal kernel (K3) over lengths 1 to 4097,
most off the 128-row query tiles (127, 129, 4097), groups 1 / 4 / 16, head
dims 64 / 128 / 256 and windows none / 1 / 17 / 100; the dynamic kernel
(K4) over a padded cache prefill (``k_valid`` past the written slots,
window in position space), rows written to different lengths, a single
query, ``causal=False``, shuffled positions, ragged query counts and a
query row with no live key (zeros).  Tolerance per output row (one query,
one head) against ``flash_reference``: L2 error <= 1e-2 x the row's L2
norm, scaled to the row because a row over n keys is only ~sqrt(e / n) in
size.  Probabilities are rounded to bf16 per key tile (64 or 128 slots)
under the running max in the kernels, under the row's final max in the
plain version, then the bf16 output rounding.  K4's pre-pass equals its
plain version exactly; two calls give the same bits (no atomics); the
served instantiations (head dim 128) keep their state in registers.
Gradients through the kernel's autograd function equal autograd through
``dense_reference`` (the backward IS that recompute).  float32 inputs and
an unsupported head dim raise; each call counts one launch of its kernel.
"""

import numpy as np
import pytest
import torch

from distributed_llms_tpu_torch.checkpoint.quantize import (kv_quantize,
                                                            quantize)
from distributed_llms_tpu_torch.ops import decode_attn, flash, quant_matmul

GPU_DECODE_ROW_REL = 1e-2  # as chip_smoke.py's DECODE_ROW_REL
GPU_DECODE_ROW_REL_INT8 = 1e-2 + 2.0 ** -7  # ... DECODE_ROW_REL_INT8
GPU_FLASH_ROW_REL = 1e-2  # as chip_smoke.py's FLASH_ROW_REL


def _paged_inputs(seed, b, h, kvh, d, blk, p, lengths):
    rng = np.random.default_rng(seed)
    nb = b * p + 1
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, blk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((nb, blk, kvh, d)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p)
    return q, k, v, np.asarray(lengths, np.int32), tables.astype(np.int32)


def _decode_held(got, want, limit, dead_rows=None):
    """Row by row (one query, one head): L2 error <= ``limit`` x the plain
    row's L2 norm.  ``dead_rows`` ([B] bool): rows with no live slot, which
    must be exactly zero (the plain version averages every slot there)."""
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    if dead_rows is not None and bool(dead_rows.any()):
        assert float(got[dead_rows].float().abs().max()) == 0.0
        got, want = got[~dead_rows], want[~dead_rows]
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    rel = (diff / ref).max().item()
    assert rel <= limit, rel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# On 132 SMs the first case plans 2-page splits (the smoke's timing
# shape), the second 4-page splits of 256 slots, the 8192-slot row 128
# one-page splits, and 16-slot pages over 2048 slots 8-page splits whose
# 32-slot bf16 and 64-slot int8 tiles span 2 and 4 pages.
PAGED_EDGES = [0, 1, 63, 64, 65, 127, 129, 255, 256, 257, 511, 513, 2047,
               2048, 2049, 1000]
GPU_CASES = [
    # b, h, kvh, d, blk, p, lengths
    (8, 32, 8, 128, 64, 32, [1, 77, 640, 2048, 1000, 64, 65, 1500]),
    (16, 32, 8, 128, 64, 32, PAGED_EDGES),
    (1, 32, 8, 128, 64, 128, [8192]),         # one long row, batch 1
    (8, 32, 8, 128, 16, 128, [2048, 0, 15, 16, 17, 127, 129, 1000]),
    (3, 8, 8, 64, 16, 7, [1, 50, 112]),        # group 1
    (2, 12, 4, 72, 48, 5, [200, 49]),          # D not a multiple of 32
    (2, 32, 2, 256, 128, 3, [300, 129]),       # group 16, D 256
    (1, 4, 1, 128, 1, 9, [9]),                 # one slot per page
]


def _junk_past_depth(tables, lengths, blk, fill):
    """The table with every entry past each row's depth replaced by an id
    outside the pool: the kernel must never read one."""
    p = tables.shape[1]
    depth = -(-np.clip(np.asarray(lengths), 0, p * blk) // blk)
    past = np.arange(p)[None, :] >= depth[:, None]
    return np.where(past, fill, tables).astype(np.int32)


def _paged_dead(lengths, cuda):
    return torch.tensor([x <= 0 for x in lengths], device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", GPU_CASES)
def test_cuda_kernel_matches_plain(cuda, b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(5, b, h, kvh, d, blk, p, lengths)
    junk = _junk_past_depth(tables, lengths, blk, -(2 ** 30))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    args = [a.to(torch.bfloat16).to(cuda) for a in args]
    ln_t = torch.from_numpy(ln).to(cuda)
    before = decode_attn.paged_decode_attention.launches
    got = decode_attn.paged_decode_attention(
        *args, ln_t, torch.from_numpy(junk).to(cuda))
    torch.cuda.synchronize()
    assert decode_attn.paged_decode_attention.launches == before + 1
    want = decode_attn.paged_reference(
        *args, ln_t, torch.from_numpy(tables).to(cuda))
    _decode_held(got, want, GPU_DECODE_ROW_REL, _paged_dead(lengths, cuda))


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, ln, tables = (torch.from_numpy(x).to(cuda) for x in
                           _paged_inputs(6, 2, 4, 2, 128, 16, 3, [5, 9]))
    with pytest.raises(TypeError):  # float32 pools: the kernel is bf16
        decode_attn.paged_decode_attention(q, k, v, ln, tables)
    with pytest.raises(ValueError):  # mixed devices
        decode_attn.paged_decode_attention(
            q.bfloat16(), k.bfloat16(), v.bfloat16(), ln.cpu(), tables)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", GPU_CASES)
def test_cuda_int8_kernel_matches_plain(cuda, b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(7, b, h, kvh, d, blk, p, lengths)
    junk = _junk_past_depth(tables, lengths, blk, 2 ** 30)
    kq, ks = kv_quantize(torch.from_numpy(k).to(cuda))
    vq, vs = kv_quantize(torch.from_numpy(v).to(cuda))
    qb = torch.from_numpy(q).to(torch.bfloat16).to(cuda)
    ln_t = torch.from_numpy(ln).to(cuda)
    before = (decode_attn.paged_decode_attention.launches,
              decode_attn.paged_decode_attention.int8_launches)
    got = decode_attn.paged_decode_attention(
        qb, kq, vq, ln_t, torch.from_numpy(junk).to(cuda), k_scale=ks,
        v_scale=vs)
    torch.cuda.synchronize()
    assert (decode_attn.paged_decode_attention.launches,
            decode_attn.paged_decode_attention.int8_launches) == (
                before[0], before[1] + 1)
    want = decode_attn.paged_reference(
        qb, kq, vq, ln_t, torch.from_numpy(tables).to(cuda), ks, vs)
    _decode_held(got, want, GPU_DECODE_ROW_REL_INT8,
                 _paged_dead(lengths, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["K1", "K1q"])
def test_cuda_paged_kernel_does_not_spill(cuda, quant):
    """The split kernel keeps its state in registers at Llama-3-8B's heads
    (D 128, group 4): no local memory, and at least one block per SM."""
    got = decode_attn.paged_kernel_resources(128, 4, quant)
    assert got["local_bytes"] == 0, got
    assert got["blocks_per_sm"] >= 1, got


# Split and tile edges: on 132 SMs the B=8 cases below plan 64-slot
# splits, the B=16 ones 128 (no window) and 64 (window 300).
EDGES = [0, 1, 63, 64, 65, 127, 129, 1023, 1024, 1025, 77, 640, 1000, 365,
         363, 364]
RAGGED_GPU_CASES = [
    # b, h, kvh, d, s, lengths, window
    (8, 32, 8, 128, 1024, [1, 77, 640, 1024, 1000, 64, 65, 1025], None),
    (8, 32, 8, 128, 1024, [1, 77, 640, 1024, 1000, 64, 65, 1025], 300),
    (16, 32, 8, 128, 1024, EDGES, None),
    (16, 32, 8, 128, 1024, EDGES, 300),         # band edges at 300 +- 64k
    (3, 8, 8, 64, 200, [1, 50, 200], 1),        # group 1, window 1
    (2, 32, 2, 256, 300, [300, 129], 5000),     # group 16, window > S
    (2, 16, 4, 128, 129, [129, 1], 64),
    (3, 12, 4, 72, 130, [130, 0, 65], None),    # group 3, D 72
    (1, 32, 8, 128, 32768, [32768], 4096),      # one long row, batch 1
    (1, 32, 8, 128, 32768, [32768], None),
    (8, 32, 8, 128, 6144, [1, 4095, 4096, 4097, 6144, 6145, 0, 5000],
     4096),                                     # path c's band
]


def _dead(lengths, s, cuda):
    return torch.tensor([min(max(x, 0), s) == 0 for x in lengths],
                        device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,d,s,lengths,window", RAGGED_GPU_CASES)
def test_cuda_ragged_kernel_matches_plain(cuda, b, h, kvh, d, s, lengths,
                                          window):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).to(cuda)
               for shape in ((b, 1, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = decode_attn.ragged_decode_attention.launches
    got = decode_attn.ragged_decode_attention(q, k, v, ln, window=window)
    torch.cuda.synchronize()
    assert decode_attn.ragged_decode_attention.launches == before + 1
    want = decode_attn.dense_reference(q, k, v, ln, window)
    _decode_held(got, want, GPU_DECODE_ROW_REL, _dead(lengths, s, cuda))


@pytest.mark.gpu
def test_cuda_new_kernels_raise_on_wrong_dtypes(cuda):
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 128)).astype(
        np.float32)).to(cuda)
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 128)).astype(
        np.float32)).to(cuda)
    ln = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # float32 cache: K2 is bf16
        decode_attn.ragged_decode_attention(q.bfloat16(), k, k, ln)
    with pytest.raises(TypeError):  # int64 lengths
        decode_attn.ragged_decode_attention(q.bfloat16(), k.bfloat16(),
                                            k.bfloat16(), ln.long())
    pool = k.reshape(8, 16, 2, 128)
    kq, ks = kv_quantize(pool)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # float64 scales: K1q takes float32
        decode_attn.paged_decode_attention(q.bfloat16(), kq, kq, ln, tables,
                                           k_scale=ks.double(),
                                           v_scale=ks.double())
    with pytest.raises(TypeError):  # float32 q
        decode_attn.paged_decode_attention(q, kq, kq, ln, tables, k_scale=ks,
                                           v_scale=ks)


QMM_GPU_CASES = [
    # m, k, n, block, bits
    (8, 4096, 1024, 128, 8),    # decode wk/wv
    (8, 4096, 1024, 128, 4),
    (1, 320, 200, 40, 8),       # K, N off the 64-wide tiles, N % 16 != 0
    (17, 192, 96, 32, 4),
    (300, 512, 384, 64, 8),     # prefill-shaped, several tiles each way
    (300, 512, 384, 64, 4),
    (8, 96, 72, 8, 4),          # block narrower than a 16-byte load
    (33, 130, 130, 130, 8),     # K, N not multiples of 16
    # Llama-3-8B's projections (flat [K, N]): decode M = 8, prefill 512.
    *[(m, k, n, 128, bits) for bits in (8, 4) for m, k, n in (
        (8, 4096, 4096), (8, 4096, 14336), (8, 14336, 4096),
        (512, 4096, 14336))],
    # The plan's edges on 132 SMs: M of 1, 16 (decode tiles), 17, 64
    # (the 64-row prefill tile), 65 (the 128-row one); K = 4320 in 14 splits
    # of 320 rows but the last of 160, whose last 64-row tile is half
    # (uneven splits, a K tail off the tiles, int4 at split edges).
    *[(m, k, n, 128, bits) for bits in (8, 4) for m, k, n in (
        (1, 4096, 4096), (16, 4096, 4096), (17, 4096, 1024),
        (64, 4096, 4096), (65, 4096, 1024), (8, 4320, 4096))],
]


def _qmm_case(cuda, m, k, n, block, bits, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    qt = quantize(w, bits=bits, block=block, pack_axis=-2)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    return x.to(dtype).to(cuda), qt.to(cuda)


def _held(got, want, rel, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    over = diff - rel * want.float().abs() - tol
    assert over.max().item() <= 0, diff.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,block,bits", QMM_GPU_CASES)
def test_cuda_quant_matmul_matches_plain(cuda, m, k, n, block, bits):
    x, qt = _qmm_case(cuda, m, k, n, block, bits, seed=10)
    attr = "int4_launches" if bits == 4 else "launches"
    before = getattr(quant_matmul.quant_matmul, attr)
    got = quant_matmul.quant_contract(x, qt, 1)
    assert getattr(quant_matmul.quant_matmul, attr) == before + 1
    want = quant_matmul.quant_matmul_plain(x, qt.data, qt.scale, bits)
    _held(got, want, 2.0 ** -7, 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_quant_matmul_is_deterministic(cuda, bits):
    """Two calls on the same inputs give the same bits: the split-K
    partials are summed in split order, with no atomics (down's 16
    splits and a prefill tile)."""
    for m, k, n in ((8, 14336, 4096), (512, 4096, 1024)):
        x, qt = _qmm_case(cuda, m, k, n, 128, bits, seed=14)
        first = quant_matmul.quant_contract(x, qt, 1)
        second = quant_matmul.quant_contract(x, qt, 1)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,n", [(8, 14336), (8, 1024), (64, 14336),
                                 (512, 14336)])
def test_cuda_quant_matmul_does_not_spill(cuda, bits, m, n):
    """The instantiations the served shapes launch (decode's 128- and
    64-column tiles, the 64- and 128-row tiles of prefill)
    keep their state in registers: no local memory, and at least one
    block per SM."""
    got = quant_matmul.quant_matmul_resources(m, n, bits)
    assert got["local_bytes"] == 0, got
    assert got["blocks_per_sm"] >= 1, got


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_quant_matmul_float32_activations(cuda, bits):
    x, qt = _qmm_case(cuda, 5, 256, 192, 64, bits, seed=11,
                      dtype=torch.float32)
    got = quant_matmul.quant_contract(x, qt, 1)
    want = quant_matmul.quant_matmul_plain(x, qt.data, qt.scale, bits)
    _held(got, want, 1e-4, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_quant_matmul_wo_layout(cuda, bits):
    """wo [H, hd, D] contracts two axes (k_lead=2); int4 packs along hd."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.standard_normal((4, 128, 256)).astype(np.float32))
    qt = quantize(w, bits=bits, pack_axis=-2).to(cuda)
    x = torch.from_numpy(rng.standard_normal((3, 5, 4, 128)).astype(
        np.float32)).to(torch.bfloat16).to(cuda)
    got = quant_matmul.quant_contract(x, qt, 2)
    assert got.shape == (3, 5, 256)
    q2, s2 = quant_matmul.flatten_qt(qt, 2)
    want = quant_matmul.quant_matmul_plain(x.reshape(15, 512), q2, s2, bits)
    _held(got.reshape(15, 256), want, 2.0 ** -7, 1e-2)


@pytest.mark.gpu
def test_cuda_quant_matmul_raises_on_wrong_inputs(cuda):
    x, qt = _qmm_case(cuda, 4, 256, 128, 128, 8, seed=13)
    with pytest.raises(TypeError):  # float16 activations
        quant_matmul.quant_contract(x.half(), qt, 1)
    with pytest.raises(TypeError):  # float64 scales
        quant_matmul.quant_matmul(x, qt.data, qt.scale.double(), 8)
    with pytest.raises(ValueError):  # mixed devices
        quant_matmul.quant_matmul(x, qt.data.cpu(), qt.scale, 8)
    w = torch.randn(256, 128, device=cuda)
    legacy = quantize(w, bits=4, pack_axis=-1)  # pairs along N, not K
    with pytest.raises(NotImplementedError):
        quant_matmul.quant_contract(x, legacy, 1)
    buf = torch.empty(4 * 256 + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):  # x 2 bytes past a 16-byte boundary
        quant_matmul.quant_matmul(buf[1:1 + 4 * 256].view(4, 256), qt.data,
                                  qt.scale, 8)


# -- K2q: the contiguous decode kernel's int8 leg -----------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,d,s,lengths,window", RAGGED_GPU_CASES)
def test_cuda_ragged_int8_kernel_matches_plain(cuda, b, h, kvh, d, s,
                                               lengths, window):
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16).to(cuda)
               for shape in ((b, 1, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    fn = decode_attn.ragged_decode_attention
    before = (fn.launches, fn.int8_launches)
    got = fn(q, kq, vq, ln, window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (fn.launches, fn.int8_launches) == (before[0], before[1] + 1)
    want = decode_attn.ragged_reference(q, kq, vq, ln, window, ks, vs)
    _decode_held(got, want, GPU_DECODE_ROW_REL_INT8, _dead(lengths, s, cuda))


@pytest.mark.gpu
def test_cuda_ragged_int8_raises_on_wrong_dtypes(cuda):
    q = torch.zeros(2, 1, 4, 128, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(2, 64, 2, 128, dtype=torch.int8, device=cuda)
    sc = torch.ones(2, 64, 2, device=cuda)
    ln = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):  # float64 scales
        decode_attn.ragged_decode_attention(q, k, k, ln, k_scale=sc.double(),
                                            v_scale=sc.double())
    with pytest.raises(TypeError):  # float32 q
        decode_attn.ragged_decode_attention(q.float(), k, k, ln, k_scale=sc,
                                            v_scale=sc)


# -- K3 / K4: flash attention ---------------------------------------------------

def _flash_inputs(cuda, seed, b, tq, h, kvh, d, s=None):
    rng = np.random.default_rng(seed)
    s = s or tq
    return tuple(
        torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        .to(torch.bfloat16).to(cuda)
        for shape in ((b, tq, h, d), (b, s, kvh, d), (b, s, kvh, d)))


def _flash_held(got, want):
    """Row by row (one query, one head): L2 error <= GPU_FLASH_ROW_REL x
    the plain row's L2 norm; a zero plain row (no live key) must be
    zero."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    assert bool((diff[ref == 0] == 0).all())
    rel = (diff[ref > 0] / ref[ref > 0]).max().item()
    assert rel <= GPU_FLASH_ROW_REL, rel


FLASH_STATIC_CASES = [
    # b, t, h, kvh, d, window
    (1, 1, 2, 1, 64, None),
    (2, 200, 8, 2, 128, None),     # group 4, T off the 64-row tiles
    (1, 333, 4, 4, 64, 17),        # group 1
    (3, 65, 8, 8, 128, 1),         # window 1: the diagonal only
    (1, 1000, 32, 2, 256, 100),    # group 16, D 256
    (1, 1024, 32, 8, 128, None),
    (1, 127, 4, 1, 128, None),     # one row short of a query tile
    (2, 129, 8, 2, 64, None),      # one row past it
    (1, 4097, 32, 8, 128, None),   # path g's sequence, one row past
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,kvh,d,window", FLASH_STATIC_CASES)
def test_cuda_flash_static_matches_plain(cuda, b, t, h, kvh, d, window):
    q, k, v = _flash_inputs(cuda, 11, b, t, h, kvh, d)
    fn = flash.flash_attention
    before = (fn.static_launches, fn.dynamic_launches)
    got = fn(q, k, v, window=window)
    torch.cuda.synchronize()
    assert (fn.static_launches, fn.dynamic_launches) == (before[0] + 1,
                                                         before[1])
    _flash_held(got, flash.flash_reference(q, k, v, window=window))


def _dynamic_case(cuda, name, b, tq, s):
    rng = np.random.default_rng(12)
    offset = torch.tensor([[0], [s - tq]][:b], device=cuda)
    qpos = torch.arange(tq, device=cuda)[None] + offset
    kpos = torch.arange(s, device=cuda).expand(b, s)
    if name == "padded_prefill":
        return dict(q_positions=qpos, k_positions=kpos,
                    k_valid=kpos < offset + tq)
    if name == "padded_prefill_window":
        return dict(q_positions=qpos, k_positions=kpos,
                    k_valid=kpos < offset + tq, window=37)
    if name == "not_causal":
        return dict(k_valid=kpos < offset + tq, causal=False)
    if name == "shuffled":
        perm = torch.from_numpy(np.stack([rng.permutation(s)
                                          for _ in range(b)])).to(cuda)
        return dict(q_positions=perm[:, :tq], k_positions=perm, window=200)
    if name == "row_without_keys":
        valid = kpos >= 5
        return dict(q_positions=qpos, k_positions=kpos, k_valid=valid)
    if name == "per_row_lengths":  # written to s // 2 and s; the last tq
        written = torch.tensor([[s // 2], [s]][:b], device=cuda)
        return dict(q_positions=written - tq + torch.arange(tq, device=cuda),
                    k_positions=kpos, k_valid=kpos < written, window=700)
    if name == "single_query":  # one new token over each row's cache
        return dict(q_positions=offset + tq - 1 - torch.arange(b, device=cuda)
                    [:, None] * 3, k_positions=kpos, k_valid=kpos < offset + tq)
    raise KeyError(name)


FLASH_DYNAMIC_CASES = [
    # case, b, tq, s, h, kvh, d
    ("padded_prefill", 2, 200, 1024, 32, 8, 128),
    ("padded_prefill_window", 2, 100, 700, 8, 2, 64),
    ("not_causal", 2, 77, 300, 8, 8, 128),
    ("shuffled", 2, 130, 500, 16, 1, 128),
    ("row_without_keys", 1, 64, 128, 4, 2, 256),
    ("per_row_lengths", 2, 300, 2048, 32, 8, 128),
    ("single_query", 2, 1, 777, 8, 2, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case,b,tq,s,h,kvh,d", FLASH_DYNAMIC_CASES)
def test_cuda_flash_dynamic_matches_plain(cuda, case, b, tq, s, h, kvh, d):
    q, k, v = _flash_inputs(cuda, 13, b, tq, h, kvh, d, s)
    kw = _dynamic_case(cuda, case, b, tq, s)
    fn = flash.flash_attention
    before = (fn.static_launches, fn.dynamic_launches)
    got = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fn.static_launches, fn.dynamic_launches) == (before[0],
                                                         before[1] + 1)
    _flash_held(got, flash.flash_reference(q, k, v, **kw))
    if case == "row_without_keys":  # positions 0..4 see only slots < 5
        assert float(got[0, :5].float().abs().max()) == 0.0


@pytest.mark.gpu
def test_cuda_flash_is_deterministic(cuda):
    """Two calls on the same inputs give the same bits (K3 and K4: one
    block per query tile and head, no atomics)."""
    q, k, v = _flash_inputs(cuda, 16, 1, 1000, 32, 8, 128)
    kpos = torch.arange(1000, device=cuda)[None]
    for kw in ({}, {"q_positions": kpos, "k_positions": kpos,
                    "window": 300}):
        first = flash.flash_attention(q, k, v, **kw)
        second = flash.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("dynamic", [False, True])
def test_cuda_flash_does_not_spill(cuda, dynamic):
    """The served instantiations (head dim 128: K3 on path g, K4 on path
    f) keep their state in registers: no local memory, one block per
    SM."""
    got = flash.flash_kernel_resources(128, dynamic)
    assert got["local_bytes"] == 0, got
    assert got["blocks_per_sm"] >= 1, got


@pytest.mark.gpu
@pytest.mark.parametrize("s,bk", [(1, 128), (777, 64), (32768, 128)])
def test_cuda_flash_tile_summary_matches_plain(cuda, s, bk):
    """K4's pre-pass equals its plain version bit for bit: shuffled
    positions near the int32 limits, random validity, a partial tile."""
    rng = np.random.default_rng(s)
    kpos = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (3, s))
                            .astype(np.int32)).to(cuda)
    kval = torch.from_numpy((rng.random((3, s)) < 0.6).astype(np.int32)).to(cuda)
    kval[1] = 1
    kval[2] = 0
    got = flash.tile_summary(kpos, kval, bk)
    torch.cuda.synchronize()
    assert torch.equal(got, flash.tile_summary_reference(kpos, kval, bk))


@pytest.mark.gpu
def test_cuda_flash_gradients_are_the_dense_recompute(cuda):
    q, k, v = _flash_inputs(cuda, 14, 1, 300, 8, 2, 128)
    cot = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    grads = []
    for f in (flash.flash_attention, flash.dense_reference):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        (f(*args, window=50).float() * cot.float()).sum().backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want)


@pytest.mark.gpu
def test_cuda_flash_raises_on_what_it_does_not_build(cuda):
    q, k, v = _flash_inputs(cuda, 15, 1, 64, 4, 2, 128)
    with pytest.raises(TypeError):  # float32
        flash.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(TypeError):  # float16
        flash.flash_attention(q.half(), k.half(), v.half())
    q96, k96, v96 = _flash_inputs(cuda, 15, 1, 64, 4, 2, 96)
    with pytest.raises(ValueError, match="head_dim"):
        flash.flash_attention(q96, k96, v96)


@pytest.mark.gpu
def test_cuda_training_step_runs_through_k3(cuda):
    """A bf16 flash model's loss differentiates on the card: K3 in the
    forward, the dense recompute and a float32 unembedding product in the
    backward (the bf16 -> float32 ``out_dtype`` product has no
    derivative)."""
    from distributed_llms_tpu_torch.core.config import ModelConfig
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import train

    cfg = ModelConfig(family="llama", vocab_size=512, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=64, max_seq_len=256,
                      tie_embeddings=False, dtype="bfloat16",
                      attn_impl="flash")
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda)
    tokens = torch.randint(0, 512, (2, 130), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    trainer = train.Trainer(cfg, train.default_optimizer(1e-3))
    step, state = trainer.make_step(), trainer.init(params)
    before = flash.flash_attention.static_launches
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, tokens)
        losses.append(float(loss))
    assert flash.flash_attention.static_launches == before + 3 * cfg.num_layers
    assert all(np.isfinite(losses)) and losses[2] < losses[0]
