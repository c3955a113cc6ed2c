"""Paged decode attention of the PyTorch/CUDA port against the JAX package.

CPU: the port's plain version (the path a CPU tensor takes) against the
JAX Pallas kernel run in interpret mode and against the JAX dense
reference, on the same numpy inputs, float32, atol = rtol = 1e-5 (the
kernel's online softmax and the dense softmax differ only in summation
order).

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.ops import decode_attn as jax_decode_attn
from distributed_llms_tpu_torch.ops import decode_attn

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # Tiny ops: the default thread pool only contends with the other test
    # workers on the host.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paged_inputs(seed, b, h, kvh, d, blk, p, lengths, dtype=np.float32,
                  garbage=True):
    rng = np.random.default_rng(seed)
    nb = b * p + 1
    q = rng.standard_normal((b, 1, h, d)).astype(dtype)
    k = rng.standard_normal((nb, blk, kvh, d)).astype(dtype)
    v = rng.standard_normal((nb, blk, kvh, d)).astype(dtype)
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p)
    lengths = np.asarray(lengths, np.int32)
    if garbage:
        # Entries past each row's depth are arbitrary — but kept inside the
        # pool, since the JAX fallback gathers every entry.
        depth = -(-lengths // blk)
        past = np.arange(p)[None, :] >= depth[:, None]
        tables = np.where(past, rng.integers(0, nb, (b, p)), tables)
    return q, k, v, lengths, tables.astype(np.int32)


CASES = [
    # b, h, kvh, d, blk, p, lengths
    (2, 4, 2, 128, 16, 4, [1, 64]),
    (3, 8, 2, 128, 8, 6, [5, 17, 48]),
    (1, 4, 4, 128, 16, 3, [33]),
]


@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", CASES)
def test_plain_matches_jax_interpret_kernel(b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(0, b, h, kvh, d, blk, p, lengths)
    want = jax_decode_attn._paged_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
        jnp.asarray(tables), mode="interpret",
    )
    got = decode_attn.paged_decode_attention(*map(torch.from_numpy,
                                                  (q, k, v, ln, tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("b,h,kvh,d,blk,p,lengths", CASES)
def test_plain_matches_jax_dense_reference(b, h, kvh, d, blk, p, lengths):
    q, k, v, ln, tables = _paged_inputs(1, b, h, kvh, d, blk, p, lengths)
    k_rows = k[tables].reshape(b, p * blk, kvh, d)
    v_rows = v[tables].reshape(b, p * blk, kvh, d)
    want = jax_decode_attn._dense_reference(
        jnp.asarray(q), jnp.asarray(k_rows), jnp.asarray(v_rows),
        jnp.asarray(ln),
    )
    got = decode_attn.paged_reference(*map(torch.from_numpy,
                                           (q, k, v, ln, tables)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v, ln, tables = map(torch.from_numpy, _paged_inputs(
        2, 2, 4, 2, 128, 16, 3, [10, 40]))
    before = decode_attn.paged_decode_attention.launches
    got = decode_attn.paged_decode_attention(q, k, v, ln, tables)
    assert torch.equal(got, decode_attn.paged_reference(q, k, v, ln, tables))
    assert decode_attn.paged_decode_attention.launches == before


def test_table_entries_past_depth_are_never_read():
    """Out-of-pool garbage past a row's depth must not matter (the CUDA
    kernel never reads it; the plain version replaces it before the
    gather)."""
    q, k, v, ln, tables = _paged_inputs(3, 2, 4, 2, 128, 16, 4, [3, 20],
                                        garbage=False)
    bad = tables.copy()
    bad[0, 1:] = -7
    bad[1, 2:] = 10 ** 6
    args = list(map(torch.from_numpy, (q, k, v, ln, tables)))
    got = decode_attn.paged_decode_attention(*args[:4], torch.from_numpy(bad))
    assert torch.equal(got, decode_attn.paged_decode_attention(*args))


def test_wrapper_rejects_bad_shapes():
    q, k, v, ln, tables = map(torch.from_numpy, _paged_inputs(
        4, 2, 4, 2, 128, 16, 3, [10, 40]))
    with pytest.raises(ValueError):
        decode_attn.paged_decode_attention(q[:, :, :3], k, v, ln, tables)
    with pytest.raises(ValueError):
        decode_attn.paged_decode_attention(q, k, v, ln[:1], tables)
    with pytest.raises(ValueError):
        decode_attn.paged_decode_attention(
            torch.cat([q, q], dim=1), k, v, ln, tables)
