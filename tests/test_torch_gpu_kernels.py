"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips without a CUDA device (the kernels have no
CPU mode).  Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Paged decode attention: bf16, at shapes that walk the kernel's edges
(group size 1 and 16, head dims 64/72/256, odd page sizes, length 1,
garbage table entries past each row's depth); max |err| <= 2e-2 from bf16
probabilities rounded at different points (per tile and unnormalized in
the kernel, normalized in the plain version).
"""

import numpy as np
import pytest
import torch

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
