"""The tile walk of the flash kernels (K3, K4), on the CPU.

The CUDA body (``ops/csrc/flash_attn.cu``) gives each block 128 query
rows and walks key tiles of ``KEY_TILE[D]`` slots: K3 over its arithmetic
live range, K4 over the tiles that a per-tile summary (the pre-pass
``flash_kernel_tile_summary``) does not class dead; only boundary tiles
are masked.  What of that design the CPU can check, it checks here; the
kernels themselves are held against the plain version on the card
(tests/test_torch_gpu_kernels.py, chip_smoke.py).

(a) The summary's plain version (``tile_summary_reference``, which the
    card's pre-pass must equal bit for bit) against a brute-force count
    over each tile's slots.

(b) The tile rule (``_classify`` below, written as the kernel's
    ``classify``): over random positions (shuffled, negative, near the
    int32 limits), validity, causality, windows up to 2**31 - 1 and tile
    sizes, no tile classed dead holds a live (query row, key slot) pair of
    its query tile, and every tile classed fully visible holds only live
    pairs.

(c) A torch model of the walk, written here: 128-row query tiles, the key
    tiles of each head dim in ascending order, K3's live range or K4's
    summary-driven skipping, scores pre-multiplied by ``D**-0.5 *
    log2(e)`` and taken through ``exp2``, a shift of 0 while a row has
    seen no live key, ``l`` from the float32 probabilities, the
    probabilities rounded to v's dtype per tile before the value product.
    It is held against the JAX package's Pallas kernel
    (``flash_attention(..., interpret=True)``) on the cases of
    tests/test_torch_flash.py: float32 within atol = rtol = 1e-5 (the
    summation order and exp2 against exp), bfloat16 within atol 2e-2 (the
    probabilities rounded per tile under different running maxima, then
    the output), and rows with no live key exactly zero.

(d) The wrapper's CUDA branch, driven on CPU tensors with a fake kernel
    entry: K3 launches one entry with its arguments, K4 the pre-pass and
    then the kernel on the pre-pass's table, each call counts one launch
    of its kernel (and K4 one of its pre-pass), and a refused launch or a
    base off 16 bytes raises.
"""

import math
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from distributed_llms_tpu.ops import flash as jflash
from distributed_llms_tpu_torch.ops import flash

QT = 128  # query rows a block (flash_attn.cu kBQ)
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
TOL32 = dict(atol=1e-5, rtol=1e-5)
TOL16 = dict(atol=2e-2, rtol=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) the summary ------------------------------------------------------------

def _brute_summary(kpos, kval, bk):
    b, s = kval.shape
    n = -(-s // bk)
    out = np.zeros((b, n, 4), np.int64)
    for r in range(b):
        for t in range(n):
            slots = range(t * bk, (t + 1) * bk)
            valid = [j for j in slots if j < s and kval[r, j]]
            flags = (1 if valid else 0) | (2 if len(valid) == bk else 0)
            lo = min((int(kpos[r, j]) for j in valid), default=INT32_MAX)
            hi = max((int(kpos[r, j]) for j in valid), default=INT32_MIN)
            out[r, t] = (flags, lo, hi, 0)
    return out


@pytest.mark.parametrize("b,s,bk,seed", [
    (1, 1, 64, 0), (2, 300, 64, 1), (3, 257, 128, 2), (2, 1024, 128, 3),
])
def test_summary_matches_a_brute_force_count(b, s, bk, seed):
    rng = np.random.default_rng(seed)
    kpos = rng.integers(INT32_MIN, INT32_MAX, (b, s), endpoint=True)
    kval = rng.random((b, s)) < 0.7
    kval[0, : min(s, bk)] = True  # one full tile
    if s > 2 * bk:
        kval[-1, bk:2 * bk] = False  # one empty tile
    got = flash.tile_summary_reference(
        torch.from_numpy(kpos.astype(np.int32)), torch.from_numpy(kval), bk)
    assert got.dtype == torch.int32 and got.shape == (b, -(-s // bk), 4)
    np.testing.assert_array_equal(got.numpy(), _brute_summary(kpos, kval, bk))


# -- (b) the tile rule -------------------------------------------------------

def _classify(entry, qmin, qmax, causal, window):
    """The kernel's ``classify``: 0 dead, 1 boundary, 2 fully visible
    (Python ints: the kernel compares in 64 bits)."""
    flags, kmin, kmax = (int(x) for x in entry[:3])
    if (not flags & 1 or (causal and kmin > qmax)
            or (window and kmax <= qmin - window)):
        return 0
    if (flags & 2 and (not causal or kmax <= qmin)
            and (not window or kmin > qmax - window)):
        return 2
    return 1


def _live(qpos, kpos, kval, causal, window):
    """[B, Tq, S] live pairs (int64 positions: no overflow)."""
    qp = torch.as_tensor(qpos, dtype=torch.int64)[:, :, None]
    kp = torch.as_tensor(kpos, dtype=torch.int64)[:, None, :]
    live = torch.as_tensor(kval, dtype=torch.bool)[:, None, :].expand(
        qp.shape[0], qp.shape[1], kp.shape[2])
    if causal:
        live = live & (kp <= qp)
    if window:
        live = live & (kp > qp - window)
    return live


def _positions(draw, shape, kind):
    if kind == "dense":
        lo = draw(st.integers(-50, 5000))
        return lo + np.arange(shape[1])[None].repeat(shape[0], 0)
    if kind == "shuffled":
        rng = np.random.default_rng(draw(st.integers(0, 2**31)))
        return np.stack([rng.permutation(shape[1]) for _ in range(shape[0])])
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    return rng.integers(INT32_MIN, INT32_MAX, shape, endpoint=True)


@st.composite
def _tile_cases(draw):
    b = draw(st.integers(1, 2))
    tq = draw(st.integers(1, 70))
    s = draw(st.integers(1, 200))
    bq = draw(st.sampled_from([16, 32, QT]))
    bk = draw(st.sampled_from([8, 16, 64, 128]))
    kind = draw(st.sampled_from(["dense", "shuffled", "wide"]))
    kpos = _positions(draw, (b, s), kind)
    qpos = (kpos[:, :tq] if kind == "shuffled" and tq <= s
            else _positions(draw, (b, tq), kind))
    p_valid = draw(st.sampled_from([0.0, 0.5, 0.9, 1.0]))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    kval = rng.random((b, s)) < p_valid
    causal = draw(st.booleans())
    window = draw(st.sampled_from([None, 1, 3, 37, 1000, 2**31 - 1]))
    return qpos, kpos, kval, causal, window, bq, bk


@settings(max_examples=150, deadline=None)
@given(_tile_cases())
def test_dead_tiles_hold_no_live_pair_and_full_tiles_only_live(case):
    qpos, kpos, kval, causal, window, bq, bk = case
    b, tq = qpos.shape
    s = kpos.shape[1]
    summary = flash.tile_summary_reference(
        torch.from_numpy(kpos.astype(np.int32)), torch.from_numpy(kval), bk)
    live = _live(qpos, kpos, kval, causal, window)
    for r in range(b):
        for q0 in range(0, tq, bq):
            rows = qpos[r, q0:q0 + bq]
            qmin, qmax = int(rows.min()), int(rows.max())
            for t in range(summary.shape[1]):
                cls = _classify(summary[r, t], qmin, qmax, causal, window)
                block = live[r, q0:q0 + bq, t * bk:(t + 1) * bk]
                if cls == 0:
                    assert not bool(block.any())
                elif cls == 2:
                    assert t * bk + bk <= s and bool(block.all())


# -- (c) a model of the walk against the JAX kernel --------------------------

def _tiles_of(q0, rows, tq, s, bk, static, summary, b, qpos, causal, window):
    """(key tile, fully visible) in walk order for one query tile."""
    if static:
        q_last = min(q0 + QT, tq) - 1
        t_lo = max(0, q0 - window + 1) // bk if window else 0
        for t in range(t_lo, q_last // bk + 1):
            k0 = t * bk
            yield t, (k0 + bk - 1 <= q0
                      and (not window or k0 > q_last - window))
        return
    qmin, qmax = int(qpos[b, rows].min()), int(qpos[b, rows].max())
    for t in range(summary.shape[1]):
        cls = _classify(summary[b, t], qmin, qmax, causal, window)
        if cls:
            yield t, cls == 2


def walk_model(q, k, v, q_positions=None, k_positions=None, k_valid=None,
               causal=True, window=None):
    """The kernels' walk in torch (see the module docstring, (c))."""
    bsz, tq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    bk = flash.KEY_TILE.get(d, 64)
    static = flash.is_static(q, k, q_positions, k_positions, k_valid, causal)
    qpos = (torch.arange(tq).expand(bsz, tq) if q_positions is None
            else q_positions).long()
    kpos = (torch.arange(s).expand(bsz, s) if k_positions is None
            else k_positions).long()
    kval = (torch.ones(bsz, s, dtype=torch.bool) if k_valid is None
            else k_valid.bool())
    summary = flash.tile_summary_reference(kpos.int(), kval, bk)
    scale = np.float32(np.float32(d ** -0.5) * np.float32(math.log2(math.e)))
    neg = torch.finfo(torch.float32).min
    out = torch.zeros(bsz, tq, h, d, dtype=q.dtype)
    for b in range(bsz):
        for q0 in range(0, tq, QT):
            rows = slice(q0, min(q0 + QT, tq))
            n = rows.stop - rows.start
            qb = q[b, rows].float()  # [n, H, D]
            m = torch.full((h, n), neg)
            l = torch.zeros(h, n)
            acc = torch.zeros(h, n, d)
            for t, full in _tiles_of(q0, rows, tq, s, bk, static, summary, b,
                                     qpos, causal, window):
                cols = slice(t * bk, min(t * bk + bk, s))
                kt = k[b, cols].float().repeat_interleave(h // kvh, 1)
                vt = v[b, cols].repeat_interleave(h // kvh, 1)
                x = torch.einsum("qhd,khd->hqk", qb, kt) * float(scale)
                if not full:
                    qp = qpos[b, rows][:, None]
                    kp = kpos[b, cols][None, :]
                    keep = kval[b, cols][None, :].expand(n, -1)
                    if causal:
                        keep = keep & (kp <= qp)
                    if window:
                        keep = keep & (kp > qp - window)
                    x = torch.where(keep[None], x, neg)
                m_new = torch.maximum(m, x.amax(-1))
                shift = torch.where(m_new <= neg * 0.5, 0.0, m_new)
                alpha = torch.exp2(m - shift)
                p = torch.exp2(x - shift[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hqk,khd->hqd", p.to(v.dtype).float(), vt.float())
                m = m_new
            res = acc / l.clamp(min=1e-37)[..., None]
            out[b, rows] = res.permute(1, 0, 2).to(q.dtype)
    return out


def _qkv(seed, b, tq, h, kvh, d, s=None):
    rng = np.random.default_rng(seed)
    s = s or tq
    return (rng.standard_normal((b, tq, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


def _dynamic_cases():
    """tests/test_torch_flash.py's K4 cases (B=2, Tq=23, S=64)."""
    rng = np.random.default_rng(7)
    b, tq, s = 2, 23, 64
    qpos = (np.arange(tq) + np.array([[0], [30]])).astype(np.int32)
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    valid = kpos < np.array([[23], [53]])
    masked_row = kpos < 30
    masked_row[1] = kpos[1] >= 31
    return {
        "offset_positions": dict(q_positions=qpos, k_positions=kpos),
        "padded_cache": dict(q_positions=qpos, k_positions=kpos,
                             k_valid=valid),
        "not_causal": dict(k_valid=valid, causal=False),
        "window": dict(q_positions=qpos, k_positions=kpos, k_valid=valid,
                       window=9),
        "shuffled_positions": dict(
            q_positions=rng.permutation(s)[:tq][None].repeat(b, 0)
            .astype(np.int32),
            k_positions=np.stack([rng.permutation(s) for _ in range(b)])
            .astype(np.int32)),
        "row_without_keys": dict(q_positions=qpos, k_positions=kpos,
                                 k_valid=masked_row),
    }


def _both(q, k, v, dtype, **kw):
    """(the model, the JAX interpret kernel) on the same inputs."""
    vecs = {n: kw[n] for n in ("q_positions", "k_positions", "k_valid")
            if kw.get(n) is not None}
    rest = {n: kw[n] for n in ("causal", "window") if n in kw}
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    got = walk_model(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                     **{n: torch.from_numpy(np.asarray(a))
                        for n, a in vecs.items()}, **rest)
    want = jflash.flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        **{n: jnp.asarray(a) for n, a in vecs.items()}, **rest,
        block_q=16, interpret=True)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,t,h,kvh,d,window", [
    (1, 200, 4, 2, 64, None),   # two query tiles; key tiles of 128
    (2, 150, 4, 1, 128, 3),
    (1, 140, 2, 2, 256, 70),    # key tiles of 64
    (1, 300, 2, 1, 64, 129),    # the window's edge inside a key tile
])
def test_model_of_the_static_walk_matches_jax_kernel(b, t, h, kvh, d, window,
                                                     dtype):
    q, k, v = _qkv(0, b, t, h, kvh, d)
    got, want = _both(q, k, v, dtype, window=window)
    np.testing.assert_allclose(got, want,
                               **(TOL32 if dtype == np.float32 else TOL16))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("case", sorted(_dynamic_cases()))
def test_model_of_the_dynamic_walk_matches_jax_kernel(case, dtype):
    kw = _dynamic_cases()[case]
    q, k, v = _qkv(2, 2, 23, 4, 2, 64, s=64)
    got, want = _both(q, k, v, dtype, **kw)
    np.testing.assert_allclose(got, want,
                               **(TOL32 if dtype == np.float32 else TOL16))
    if case == "row_without_keys":
        assert np.all(got[1, 0] == 0) and np.all(want[1, 0] == 0)


def test_model_skips_tiles_past_the_written_slots():
    """A cached prefill over a long, mostly unwritten row: the summary
    classes every tile past the written slots (and below the window)
    dead, and the walk still matches the JAX kernel."""
    s, tq, first = 1024, 40, 300
    kpos = np.arange(s, dtype=np.int32)[None]
    kw = dict(q_positions=(first + np.arange(tq, dtype=np.int32))[None],
              k_positions=kpos, k_valid=kpos < first + tq, window=100)
    summary = flash.tile_summary_reference(
        torch.from_numpy(kpos), torch.from_numpy(kw["k_valid"]), 128)
    walked = [t for t, _ in _tiles_of(
        0, slice(0, tq), tq, s, 128, False, summary, 0,
        torch.from_numpy(kw["q_positions"]).long(), True, 100)]
    assert walked == [1, 2]  # positions 201..339 lie in tiles 1 and 2
    q, k, v = _qkv(3, 1, tq, 2, 1, 128, s=s)
    got, want = _both(q, k, v, np.float32, **kw)
    np.testing.assert_allclose(got, want, **TOL32)


# -- (d) the wrapper's CUDA branch ---------------------------------------------

@pytest.fixture
def fake_launch(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors; each launch records (entry
    name, arguments).  The launch counters are restored afterwards."""
    calls = []
    monkeypatch.setattr(flash.flash_attention, "static_launches", 0)
    monkeypatch.setattr(flash.flash_attention, "dynamic_launches", 0)
    monkeypatch.setattr(flash.tile_summary, "launches", 0)

    def entry(source, name, argtypes):
        def launch(*args):
            assert source == flash.SOURCE
            assert len(args) == len(argtypes)
            calls.append((name, args))
            return 0
        return launch

    monkeypatch.setattr(flash, "_route", lambda name, tensors: "cuda")
    monkeypatch.setattr(flash.build, "entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    return calls


def _bf16(seed, b, tq, h, kvh, d, s=None):
    return tuple(torch.from_numpy(x).to(torch.bfloat16)
                 for x in _qkv(seed, b, tq, h, kvh, d, s))


def _counts():
    return (flash.flash_attention.static_launches,
            flash.flash_attention.dynamic_launches,
            flash.tile_summary.launches)


def test_wrapper_launches_k3_with_its_arguments(fake_launch):
    q, k, v = _bf16(0, 2, 100, 8, 2, 128)
    out = flash.flash_attention(q, k, v, window=2**40)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (name, args), = fake_launch
    assert name == "dlt_flash_attention_static"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    # B, T, H, KVH, D, window (clipped to int32), scale, stream
    assert args[4:10] == (2, 100, 8, 2, 128, 2**31 - 1)
    assert args[10] == pytest.approx(128 ** -0.5) and args[11] == 0
    assert _counts() == (1, 0, 0)


def test_wrapper_launches_the_prepass_then_k4(fake_launch):
    q, k, v = _bf16(1, 2, 30, 4, 1, 64, s=300)
    kpos = torch.arange(300).expand(2, 300)
    valid = kpos < torch.tensor([[100], [300]])
    out = flash.flash_attention(q, k, v, q_positions=kpos[:, :30] + 70,
                                k_positions=kpos, k_valid=valid, window=50)
    (pre, pre_args), (main, args) = fake_launch
    bk = flash.KEY_TILE[64]
    assert pre == "dlt_flash_tile_summary"
    assert pre_args[3:] == (2, 300, bk, 0)  # B, S, key tile, stream
    assert main == "dlt_flash_attention_dynamic"
    # q, k, v, qpos, kpos, kval, summary, out: the summary is the
    # pre-pass's table, the vectors the same int32 copies.
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[4:7] == (pre_args[0], pre_args[1], pre_args[2])
    assert args[7] == out.data_ptr()
    # B, Tq, S, H, KVH, D, key tile, causal, window, scale, stream
    assert args[8:17] == (2, 30, 300, 4, 1, 64, bk, 1, 50)
    assert args[17] == pytest.approx(64 ** -0.5) and args[18] == 0
    assert _counts() == (0, 1, 1)
    flash.flash_attention(q, k, v, causal=False)
    assert fake_launch[-1][1][15:17] == (0, 0)  # not causal, no window
    assert _counts() == (0, 2, 2)


def _off16(t):
    """A copy of ``t`` whose base lies 2 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype)
    skip = (-buf.data_ptr() % 16 + 2) // t.element_size()
    view = buf[skip:skip + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


def test_wrapper_raises_on_a_base_the_kernel_cannot_take(fake_launch):
    q, k, v = _bf16(2, 1, 64, 4, 2, 128)
    for args in ((_off16(q), k, v), (q, _off16(k), v), (q, k, _off16(v))):
        with pytest.raises(ValueError, match="16-byte"):
            flash.flash_attention(*args)
    assert not fake_launch and _counts() == (0, 0, 0)


@pytest.mark.parametrize("refused", ["dlt_flash_attention_static",
                                     "dlt_flash_tile_summary",
                                     "dlt_flash_attention_dynamic"])
def test_wrapper_raises_where_a_launch_is_refused(monkeypatch, fake_launch,
                                                  refused):
    def entry(source, name, argtypes):
        return lambda *a: 1 if name == refused else 0

    monkeypatch.setattr(flash.build, "entry", entry)
    q, k, v = _bf16(3, 1, 64, 4, 2, 128)
    kw = {} if refused.endswith("static") else {"causal": False}
    with pytest.raises(RuntimeError, match="cudaError 1"):
        flash.flash_attention(q, k, v, **kw)
    assert _counts()[:2] == (0, 0)
