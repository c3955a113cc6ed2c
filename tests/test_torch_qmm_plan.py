"""The split-K plan of the weight-only dequant-matmul (K5), on the CPU.

The CUDA kernel (``ops/csrc/quant_matmul.cu``) cuts K into runs of whole
64-row tiles that separate blocks of one thread-block cluster sum, then
adds their float32 partials in split order.  What of that design the CPU
can check, it checks here; the kernel itself is held against the plain
version on the card (tests/test_torch_gpu_kernels.py, chip_smoke.py).

(a) The planner (``qmm_plan``, ``qmm_tile``, ``qmm_split_bounds``): over
    random shapes and SM counts, and over every Llama-3-8B / Mistral-7B
    projection at M of 1, 8, 16 and 512, the splits cover K exactly once
    in whole BK-row tiles (so each split edge falls on an int4 pair), at
    most MAX_SPLITS of them, the last one the shortest; the tile is one
    the kernel instantiates and holds M; and the plans at the served
    shapes on 132 SMs are the ones the design states, each decode grid
    at least ~2 waves of blocks.

(b) A numpy model of the algorithm, written here: int4 codes unpacked
    from their row pairs (low nibble the even row), each weight
    ``float32(q) * s[k, n // block]`` rounded to x's dtype, one float32
    partial product per split over its K rows, then the partials summed
    in split order and rounded.  It is held against the JAX package's
    Pallas kernel (``_quant_matmul_2d(..., interpret=True)``) at splits
    of 1, 2, 4 and 8 K tiles:
    - float32 x: neither side rounds the weight, so they agree to 1e-5
      (summation order);
    - bf16 x: both round the weight to bf16 and the output once, so they
      agree within 2e-2 + 2^-7 |out|, the limit the card's checks hold
      the kernel to.
    The bf16 comparison fails a model that drops its last split.

(c) The wrapper's CUDA branch, driven on CPU tensors with a fake kernel
    entry: every argument list matches the entry's declared types, the
    launch carries the shape plan and no workspace (the splits reduce
    inside their cluster), each call counts one launch of its width, a
    base off 16 bytes raises where the kernel would read 16-byte chunks,
    and odd shapes (N % 16 != 0) are taken at any alignment.
"""

import math
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.ops import quant_matmul as jax_qmm
from distributed_llms_tpu_torch.checkpoint.quantize import quantize
from distributed_llms_tpu_torch.ops import quant_matmul as qmm

TOL_F32 = 1e-5
TOL_BF16, REL_BF16 = 2e-2, 2.0 ** -7


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the planner -----------------------------------------------------------

def _check_plan(m, k, n, sm):
    tile_m, tile_n, k_per_split, n_splits = qmm.qmm_plan(m, k, n, sm)
    assert (tile_m, tile_n) in {t[:2] for t in qmm.TILES}
    assert m <= tile_m or tile_m == max(t[0] for t in qmm.TILES)
    assert k_per_split % qmm.BK == 0 and k_per_split % 2 == 0
    assert 1 <= n_splits <= qmm.MAX_SPLITS
    assert n_splits == -(-k // k_per_split)  # the kernel's own check
    runs = [qmm.qmm_split_bounds(k, k_per_split, i) for i in range(n_splits)]
    covered = [r for a, z in runs for r in range(a, z)]
    assert covered == list(range(k))
    lengths = [z - a for a, z in runs]
    assert all(a % qmm.BK == 0 for a, _ in runs)
    assert lengths[-1] == min(lengths) and lengths[-1] > 0
    assert all(x == k_per_split for x in lengths[:-1])
    return tile_m, tile_n, k_per_split, n_splits


@pytest.mark.parametrize("seed", range(6))
def test_plan_covers_k_once_in_whole_tiles(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        m = int(rng.choice([1, 7, 8, 9, 16, 17, 64, 65, 300, 512,
                            int(rng.integers(1, 3000))]))
        k = 2 * int(rng.integers(1, 20000))
        n = int(rng.integers(1, 30000))
        sm = int(rng.choice([1, 16, 132, 144]))
        _check_plan(m, k, n, sm)


# (K, N) of every projection of Llama-3-8B and Mistral-7B (d_model 4096,
# 32 query / 8 KV heads of 128, FFN 14336): wq, wk/wv, w_gate/w_up, w_down,
# wo (flattened [H * hd, D]).
PROJECTIONS = {"wq": (4096, 4096), "wk_wv": (4096, 1024),
               "gate_up": (4096, 14336), "down": (14336, 4096),
               "wo": (4096, 4096)}


@pytest.mark.parametrize("m", [1, 8, 16, 512])
@pytest.mark.parametrize("proj", sorted(PROJECTIONS))
def test_plan_at_every_served_projection(m, proj):
    k, n = PROJECTIONS[proj]
    tile_m, tile_n, _, n_splits = _check_plan(m, k, n, 132)
    blocks = -(-m // tile_m) * -(-n // tile_n) * n_splits
    if m <= 16:  # decode: at least ~2 waves of blocks on 132 SMs
        assert blocks >= 256, (proj, blocks)


def test_plan_at_the_served_shapes():
    """On an H100's 132 SMs: the decode step of 8 rows, and path d's
    512-row admission."""
    plan = lambda m, proj: qmm.qmm_plan(m, *PROJECTIONS[proj], 132)
    assert plan(8, "wq") == (8, 128, 256, 16)
    assert plan(8, "wo") == (8, 128, 256, 16)
    assert plan(8, "wk_wv") == (8, 64, 256, 16)
    assert plan(8, "gate_up") == (8, 128, 832, 5)
    assert plan(8, "down") == (8, 128, 896, 16)
    assert plan(512, "gate_up") == (128, 128, 4096, 1)
    assert plan(64, "gate_up") == (64, 128, 1408, 3)  # 112 tiles: split
    # A K off the tiles: 67.5 tiles, 14 splits of 5, the last of 2.5.
    assert qmm.qmm_plan(8, 4320, 4096, 132) == (8, 128, 320, 14)
    # The SM count is read once per device, not per call.
    assert qmm._sm_count.cache_info().maxsize is None


# -- (b) the algorithm against the JAX kernel ----------------------------------

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _unpack_int4_rows(packed):
    """[K/2, N] int8 bytes -> [K, N] int32: the low nibble of byte r is row
    2r, the high nibble row 2r + 1, both sign-extended."""
    b = packed.astype(np.int32) & 0xFF
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return np.stack([lo, hi], axis=1).reshape(2 * packed.shape[0], -1)


def split_k_model(x, q2, s2, bits, k_per_split, round_w, drop_last=False):
    """out [M, N] float32: the weight dequantized per (k, n-block) scale
    (rounded to bf16 with ``round_w``), one float32 partial per split of
    ``k_per_split`` K rows, summed in split order.  ``drop_last`` plants a
    fault: the last split's partial is left out."""
    q = _unpack_int4_rows(q2) if bits == 4 else q2.astype(np.int32)
    k, n = q.shape
    block = n // s2.shape[1]
    w = q.astype(np.float32) * np.repeat(s2, block, axis=1)
    if round_w:
        w = _bf16(w)
    n_splits = -(-k // k_per_split)
    out = np.zeros((x.shape[0], n), np.float32)
    for split in range(n_splits - (1 if drop_last else 0)):
        a, z = qmm.qmm_split_bounds(k, k_per_split, split)
        out = out + x[:, a:z].astype(np.float32) @ w[a:z]
    return out


def _jax_kernel(x, q2, s2, bits, dtype):
    """The JAX package's Pallas kernel in interpret mode: M padded to its
    16-row tile, scales regrouped per 128-column tile as its caller
    does."""
    m, k = x.shape
    n, nb = q2.shape[1], s2.shape[1]
    bm, bk, bn = 16, 128, 128
    xp = np.zeros((-(-m // bm) * bm, k), np.float32)
    xp[:m] = x
    s3 = s2.reshape(k, n // bn, bn * nb // n).transpose(1, 0, 2)
    out = jax_qmm._quant_matmul_2d(
        jnp.asarray(xp, dtype), jnp.asarray(q2), jnp.asarray(s3), bits=bits,
        block=n // nb, bm=bm, bk=bk, bn=bn, interpret=True)
    return np.asarray(out.astype(jnp.float32))[:m]


def _operands(seed, m, k, n, bits):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    qt = quantize(torch.from_numpy(w), bits=bits, block=128, pack_axis=-2)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return x, qt.data.numpy(), qt.scale.numpy()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("split_tiles", [1, 2, 4, 8])
def test_split_k_model_matches_jax_kernel_float32(bits, split_tiles):
    x, q2, s2 = _operands(bits + split_tiles, 8, 512, 256, bits)
    want = _jax_kernel(x, q2, s2, bits, jnp.float32)
    got = split_k_model(x, q2, s2, bits, split_tiles * qmm.BK, round_w=False)
    np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


def _bf16_excess(got, want):
    return (np.abs(got - want) - REL_BF16 * np.abs(want) - TOL_BF16).max()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("split_tiles", [1, 2, 4, 8])
def test_split_k_model_matches_jax_kernel_bf16(bits, split_tiles):
    x, q2, s2 = _operands(10 + bits + split_tiles, 8, 512, 256, bits)
    xb = _bf16(x)
    want = _jax_kernel(xb, q2, s2, bits, jnp.bfloat16)
    got = _bf16(split_k_model(xb, q2, s2, bits, split_tiles * qmm.BK,
                              round_w=True))
    assert _bf16_excess(got, want) <= 0


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_comparison_fails_a_dropped_split(bits):
    x, q2, s2 = _operands(30 + bits, 8, 512, 256, bits)
    xb = _bf16(x)
    want = _jax_kernel(xb, q2, s2, bits, jnp.bfloat16)
    got = _bf16(split_k_model(xb, q2, s2, bits, 2 * qmm.BK, round_w=True,
                              drop_last=True))
    assert _bf16_excess(got, want) > 0


# -- (c) the wrapper's CUDA branch ---------------------------------------------

@pytest.fixture
def fake_launch(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors; each launch records (entry
    name, arguments).  The launch counters are restored afterwards, so no
    later test sees these fake launches."""
    calls = []
    monkeypatch.setattr(qmm.quant_matmul, "launches", 0)
    monkeypatch.setattr(qmm.quant_matmul, "int4_launches", 0)

    def entry(source, name, argtypes):
        def launch(*args):
            assert source == qmm.SOURCE
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(qmm, "_route", lambda tensors: "cuda")
    monkeypatch.setattr(qmm, "_sm_count", lambda device: 132)
    monkeypatch.setattr(qmm.build, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def _flat(m, k, n, bits, dtype=torch.bfloat16):
    x, q2, s2 = _operands(0, m, k, n, bits)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(q2),
            torch.from_numpy(s2))


@pytest.mark.parametrize("bits", [8, 4])
def test_wrapper_launches_the_shape_plan(fake_launch, bits):
    before = (qmm.quant_matmul.launches, qmm.quant_matmul.int4_launches)
    for m, k, n in ((8, 4096, 1024), (512, 1024, 256)):
        x, q2, s2 = _flat(m, k, n, bits)
        out = qmm.quant_matmul(x, q2, s2, bits)
        assert out.shape == (m, n) and out.dtype == torch.bfloat16
        name, args = fake_launch[-1]
        assert name == "dlt_quant_matmul"
        # (x, q, s, out): four pointers and no workspace.
        assert args[:4] == (x.data_ptr(), q2.data_ptr(), s2.data_ptr(),
                            out.data_ptr())
        assert args[4:-1] == (m, k, n, s2.shape[1], bits,
                              *qmm.qmm_plan(m, k, n, 132))
    after = (qmm.quant_matmul.launches, qmm.quant_matmul.int4_launches)
    assert after == ((before[0] + 2, before[1]) if bits == 8
                     else (before[0], before[1] + 2))


def test_wrapper_float32_takes_the_scalar_entry(fake_launch):
    x, q2, s2 = _flat(5, 256, 192, 8, torch.float32)
    qmm.quant_matmul(x, q2, s2, 8)
    name, args = fake_launch[-1]
    assert name == "dlt_quant_matmul_f32"
    assert args[4:-1] == (5, 256, 192, s2.shape[1], 8)


def _off16(t):
    """A copy of ``t`` whose base lies 2 bytes past a 16-byte boundary."""
    elems = 16 // t.element_size() + 2 // t.element_size() + t.numel()
    buf = torch.empty(elems, dtype=t.dtype)
    skip = (-buf.data_ptr() % 16 + 2) // t.element_size()
    view = buf[skip:skip + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


def test_wrapper_raises_on_a_base_the_kernel_cannot_take(fake_launch):
    x, q2, s2 = _flat(8, 512, 256, 8)
    with pytest.raises(ValueError, match="16-byte"):
        qmm.quant_matmul(_off16(x), q2, s2, 8)
    with pytest.raises(ValueError, match="16-byte"):
        qmm.quant_matmul(x, _off16(q2), s2, 8)
    assert not fake_launch
    # Odd shapes load element by element: any base is taken.
    x, q2, s2 = _flat(8, 130, 136, 8)
    qmm.quant_matmul(_off16(x), _off16(q2), s2, 8)
    assert fake_launch[-1][0] == "dlt_quant_matmul"


def test_wrapper_raises_where_a_launch_is_refused(monkeypatch, fake_launch):
    monkeypatch.setattr(qmm.build, "entry",
                        lambda source, name, argtypes: lambda *a: 1)
    x, q2, s2 = _flat(8, 512, 256, 8)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        qmm.quant_matmul(x, q2, s2, 8)


def test_planner_rejects_nothing_it_plans():
    """Every plan of (a) passes the kernel's own argument check (mirrored
    from dlt_quant_matmul): k_per_split a positive multiple of 64, at most
    16 splits, and n_splits == ceil(K / k_per_split)."""
    for m, k, n in ((1, 2, 1), (8, 64, 8), (8, 66, 8), (512, 14336, 14336),
                    (3000, 130, 130)):
        _, _, kps, ns = qmm.qmm_plan(m, k, n, 132)
        assert kps >= 64 and kps % 64 == 0 and 1 <= ns <= 16
        assert ns == math.ceil(k / kps)
