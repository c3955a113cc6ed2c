"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device (the kernels have no
CPU mode).  Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Paged decode attention (K1, bf16; K1q, int8 pools with float32 scales)
at shapes that walk the kernel's edges (group size 1 and 16, head dims
64/72/256, odd page sizes, length 1, garbage table entries past each
row's depth), and ragged decode attention (K2, a contiguous bf16 cache)
over group sizes 1/4/16, head dims 64/128/256, windows none / 1 / longer
than the cache, length 1 and a length past the cache (S + 1).

Tolerance |err| <= 2e-2 for all three: bf16 probabilities round at
different points (per tile and unnormalized in the kernels, normalized in
the plain versions).  K1q adds one bf16 ulp of the output, 2^-7 |out|:
its plain version rounds the dequantized V to bf16 where the kernel (like
the TPU kernel) rounds p * v_scale to bf16 and multiplies the int8 value
exactly (chip_smoke.py prints the errors measured at the main path's
shapes).
"""

import numpy as np
import pytest
import torch

from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize
from distributed_llms_tpu_torch.ops import decode_attn

GPU_TOL = 2e-2


def _paged_inputs(seed, b, h, kvh, d, blk, p, lengths):
    rng = np.random.default_rng(seed)
    nb = b * p + 1
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((nb, blk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((nb, blk, kvh, d)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p)
    return q, k, v, np.asarray(lengths, np.int32), tables.astype(np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


GPU_CASES = [
    # b, h, kvh, d, blk, p, lengths
    (8, 32, 8, 128, 64, 32, [1, 77, 640, 2048, 1000, 64, 65, 1500]),
    (3, 8, 8, 64, 16, 7, [1, 50, 112]),        # group 1
    (2, 12, 4, 72, 48, 5, [200, 49]),          # D not a multiple of 32
    (2, 32, 2, 256, 128, 3, [300, 129]),       # group 16, D 256
    (1, 4, 1, 128, 1, 9, [9]),                 # one slot per page
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", GPU_CASES)
def test_cuda_kernel_matches_plain(cuda, b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(5, b, h, kvh, d, blk, p, lengths)
    depth = -(-np.asarray(lengths) // blk)
    past = np.arange(p)[None, :] >= depth[:, None]
    junk = np.where(past, -(2 ** 30), tables).astype(np.int32)
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
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL, err


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
    depth = -(-np.asarray(lengths) // blk)
    past = np.arange(p)[None, :] >= depth[:, None]
    junk = np.where(past, 2 ** 30, tables).astype(np.int32)
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
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    over = diff - 2.0 ** -7 * want.float().abs() - GPU_TOL
    assert over.max().item() <= 0, diff.max().item()


RAGGED_GPU_CASES = [
    # b, h, kvh, d, s, lengths, window
    (8, 32, 8, 128, 1024, [1, 77, 640, 1024, 1000, 64, 65, 1025], None),
    (8, 32, 8, 128, 1024, [1, 77, 640, 1024, 1000, 64, 65, 1025], 300),
    (3, 8, 8, 64, 200, [1, 50, 200], 1),        # group 1, window 1
    (2, 32, 2, 256, 300, [300, 129], 5000),     # group 16, window > S
    (2, 16, 4, 128, 129, [129, 1], 64),
]


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
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= GPU_TOL, err


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
