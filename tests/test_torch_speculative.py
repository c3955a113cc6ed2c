"""Speculative decoding's building blocks in the port against the JAX
package, on the CPU.

- ``runtime/speculative.py``: ``greedy_accept_commit``, ``commit_clamp`` and
  ``backfill_coords`` equal the reference's on seeded numpy inputs,
  exactly, over k, per-row clamps ``k_row``, EOS, budgets and dead rows.
- A draft step (the port's per-row single-token step, read by the decode
  kernel's prefix contract) against the reference's masked read
  ``valid | [real_lens, idx]`` on the same cache, within 1e-4.
- ``models/model.py``'s multi-token windows through ``forward`` against
  the reference's ``forward``: the paged window (float32 pool and int8
  pool) and the contiguous per-row window under the caller's mask (with
  and without a sliding window) — logits and the written cache within
  atol = rtol = 1e-4 (the port's model tolerance, tests/test_torch_model.py;
  int8 codes within one step).  The paged window runs ONE paged
  decode-attention call a layer, and that call equals the T single-offset
  calls of the reference's formulation within 1e-6 (the plain version on
  both sides; summation order only).
- One ``spec_chunk`` round of the port against the reference's on the
  same weights and caches: committed tokens, commit counts and the carry
  exactly, logprobs and every written cache slot within 1e-4 — paged,
  contiguous, penalized, a per-row ``k_row`` clamp, an EOS cut inside the
  round, a budget clamp and a dead row on a scratch table.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32; the
draft is an unrelated 2-layer model or the target itself; weights drawn
with numpy and loaded into both stacks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import speculative as jspec
from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.ops import decode_attn
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import speculative as tspec

from test_torch_overlap import numpy_weights

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def target():
    return numpy_weights(3)


@pytest.fixture(scope="module")
def draft():
    return numpy_weights(4, num_layers=2)


# -- the three shared functions ----------------------------------------------

def _accept_inputs(seed, b, k, v=6):
    """Drafts and target tokens over a small vocabulary, so leads of every
    length occur; budgets from 1 to k+2; one dead row."""
    rng = np.random.default_rng(seed)
    greedy = rng.integers(0, v, (b, k + 1)).astype(np.int32)
    drafts = greedy[:, :k].copy()
    # Row r disagrees first at position r % (k + 1) (never, at r % = k).
    for r in range(b):
        j = r % (k + 1)
        if j < k:
            drafts[r, j] = (drafts[r, j] + 1 + rng.integers(0, v - 1)) % v
    live = np.ones(b, bool)
    live[-1] = False
    budget = rng.integers(1, k + 3, b).astype(np.int32)
    return drafts, greedy, live, budget


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("clamp", [False, True], ids=["full_k", "k_row"])
@pytest.mark.parametrize("eos_id", [-1, 2])
def test_shared_functions_equal_the_reference(k, clamp, eos_id):
    b = 12
    drafts, greedy, live, budget = _accept_inputs(k * 10 + clamp, b, k)
    k_row = (np.random.default_rng(k).integers(1, k + 1, b).astype(np.int32)
             if clamp else None)
    jk = None if k_row is None else jnp.asarray(k_row)
    want = jspec.greedy_accept_commit(
        jnp.asarray(drafts), jnp.asarray(greedy), jnp.asarray(live),
        jnp.asarray(budget), eos_id, k, k_row=jk)
    got = tspec.greedy_accept_commit(
        torch.from_numpy(drafts), torch.from_numpy(greedy),
        torch.from_numpy(live), torch.from_numpy(budget), eos_id, k,
        k_row=None if k_row is None else torch.from_numpy(k_row))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cand, m = got[0], got[1]
    assert (m.numpy()[~live] == 0).all()
    assert (m.numpy() <= budget).all()
    # commit_clamp alone, on other accepted counts.
    a = np.random.default_rng(k + 7).integers(0, k + 1, b).astype(np.int32)
    want_m = jspec.commit_clamp(jnp.asarray(cand.numpy()), jnp.asarray(a),
                                jnp.asarray(live), jnp.asarray(budget),
                                eos_id, k)
    got_m = tspec.commit_clamp(cand, torch.from_numpy(a),
                               torch.from_numpy(live),
                               torch.from_numpy(budget), eos_id, k)
    for g, w in zip(got_m, want_m):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # backfill_coords at the new frontier.
    frontier = (np.arange(b) * 3 + m.numpy()).astype(np.int32)
    want_bf = jspec.backfill_coords(jnp.asarray(cand.numpy()),
                                    jnp.asarray(m.numpy()),
                                    jnp.asarray(frontier))
    got_bf = tspec.backfill_coords(cand, m, torch.from_numpy(frontier))
    for g, w in zip(got_bf, want_bf):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the multi-token windows through forward ----------------------------------

def _pool(rng, cfg, nb, blk, quant):
    shape = (cfg.num_layers, nb, blk, cfg.num_kv_heads, cfg.head_dim_)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if not quant:
        return (k, v)
    (kq, ks), (vq, vs) = (kv_quantize(torch.from_numpy(a)) for a in (k, v))
    return (kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy())


def _jax_cache(arrays):
    a = [jnp.asarray(x) for x in arrays]
    if len(a) == 4:
        return jm.QuantKVCache(*a, row_dtype="float32")
    return jm.KVCache(k=a[0], v=a[1])


def _torch_cache(arrays):
    a = [torch.from_numpy(x.copy()) for x in arrays]
    if len(a) == 4:
        return tm.QuantKVCache(*a, row_dtype="float32")
    return tm.KVCache(k=a[0], v=a[1])


def _held_cache(got, want, skip_page0=False):
    for name in (("k", "v", "k_scale", "v_scale")
                 if isinstance(got, tm.QuantKVCache) else ("k", "v")):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if skip_page0:  # the scratch page: any duplicate write may win
            g, w = g[:, 1:], w[:, 1:]
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - w).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, **TOL, err_msg=name)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_paged_window_equals_the_reference(target, quant, monkeypatch):
    """A 4-token window a row through the page tables: rows at different
    depths, one crossing a page boundary inside its window, one freed row
    on the scratch page."""
    cfg_j, cfg_t, pj, pt = target
    rng = np.random.default_rng(11 + quant)
    b, t, nb, blk, p = 4, 4, 17, 8, 4
    pools = _pool(rng, cfg_t, nb, blk, quant)
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p).astype(np.int32)
    tables[3] = 0  # a freed row
    cache_index = np.array([3, 6, 20, 11], np.int32)
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    pos = cache_index[:, None] + np.arange(t, dtype=np.int32)[None]
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(pos),
                        cache=_jax_cache(pools),
                        cache_index=jnp.asarray(cache_index),
                        kv_tables=jnp.asarray(tables))
    calls = []
    real = decode_attn.paged_decode_attention

    def counted(q, *a, **kw):
        calls.append(q.shape[0])
        return real(q, *a, **kw)

    monkeypatch.setattr(decode_attn, "paged_decode_attention", counted)
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                        positions=torch.from_numpy(pos),
                        cache=_torch_cache(pools),
                        cache_index=torch.from_numpy(cache_index),
                        kv_tables=torch.from_numpy(tables))
    assert calls == [b * t] * cfg_t.num_layers  # one call a layer, B*T rows
    np.testing.assert_allclose(lt.numpy()[:3], np.asarray(lj)[:3], **TOL)
    _held_cache(ct, cj, skip_page0=True)


@pytest.mark.parametrize("window", [None, 5], ids=["global", "window5"])
def test_contiguous_window_equals_the_reference(window):
    """A 4-token per-row window over a contiguous cache under the caller's
    [B, 1, T, S] prefix mask (the contiguous verify pass), the sliding
    window ANDed in; one row's window ends on the last slot."""
    cfg_j, cfg_t, pj, pt = numpy_weights(5, sliding_window=window)
    rng = np.random.default_rng(12)
    b, t, s = 3, 4, 24
    arrays = _pool(rng, cfg_t, b, s, False)
    cache_index = np.array([2, 13, s - t], np.int32)
    toks = rng.integers(0, 512, (b, t)).astype(np.int32)
    pos = cache_index[:, None] + np.arange(t, dtype=np.int32)[None]
    mask = (np.arange(s)[None, None, :] <= pos[:, :, None])[:, None]
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(pos),
                        cache=_jax_cache(arrays),
                        cache_index=jnp.asarray(cache_index),
                        attn_mask=jnp.asarray(mask))
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                        positions=torch.from_numpy(pos),
                        cache=_torch_cache(arrays),
                        cache_index=torch.from_numpy(cache_index),
                        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _held_cache(ct, cj)
    with pytest.raises(ValueError, match="attn_mask"):
        tm.forward(pt, cfg_t, torch.from_numpy(toks),
                   positions=torch.from_numpy(pos), cache=_torch_cache(arrays),
                   cache_index=torch.from_numpy(cache_index))


@pytest.mark.parametrize("j", [0, 2])
def test_draft_step_equals_the_masked_reference_read(draft, j):
    """Draft step j of a round: the port's per-row single-token step (the
    decode kernel's prefix contract, lengths ``idx + 1``) against the
    reference's masked read ``valid | [real_lens, idx]`` at ``idx =
    real_lens + j`` (``valid`` the prefix ``[0, real_lens)``) on the same
    cache."""
    cfg_j, cfg_t, pj, pt = draft
    rng = np.random.default_rng(14 + j)
    b, s = 3, 32
    arrays = _pool(rng, cfg_t, b, s, False)
    real_lens = np.array([4, 11, 20], np.int32)
    idx = real_lens + j
    slots = np.arange(s)
    valid = slots[None, :] < real_lens[:, None]
    own = (slots[None, :] >= real_lens[:, None]) & (slots[None, :] <= idx[:, None])
    mask = (valid | own)[:, None, None, :]
    toks = rng.integers(0, 512, (b, 1)).astype(np.int32)
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(toks),
                        positions=jnp.asarray(idx[:, None]),
                        cache=_jax_cache(arrays), cache_index=jnp.asarray(idx),
                        attn_mask=jnp.asarray(mask))
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                        positions=torch.from_numpy(idx[:, None]),
                        cache=_torch_cache(arrays),
                        cache_index=torch.from_numpy(idx))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _held_cache(ct, cj)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_one_launch_window_equals_single_offset_calls(quant):
    """The verify window's one call over B*T virtual rows (lengths
    ``cache_index + 1 + j``, each row's table repeated T times) against
    the reference's T calls, query offset j over lengths
    ``cache_index + 1 + j``."""
    rng = np.random.default_rng(13)
    b, t, h, kvh, d, nb, blk, p = 3, 5, 8, 2, 128, 14, 16, 4
    pool = [torch.from_numpy(rng.standard_normal((nb, blk, kvh, d)).astype(
        np.float32)) for _ in range(2)]
    if quant:
        (kq, ks), (vq, vs) = (kv_quantize(a) for a in pool)
        pool = [kq, vq, ks, vs]
    tables = torch.from_numpy(
        (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p).astype(np.int32))
    cache_index = torch.tensor([0, 17, 40], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32))
    scales = dict(k_scale=pool[2], v_scale=pool[3]) if quant else {}
    page, off, lengths, rep = tm.paged_window_rows(tables, cache_index, t, blk)
    assert torch.equal(rep, tables.repeat_interleave(t, dim=0))
    one = decode_attn.paged_decode_attention(
        q.reshape(b * t, 1, h, d), pool[0], pool[1], lengths, rep, **scales)
    each = torch.cat([decode_attn.paged_decode_attention(
        q[:, j:j + 1], pool[0], pool[1], cache_index + 1 + j, tables,
        **scales) for j in range(t)], dim=1)
    np.testing.assert_allclose(one.reshape(b, t, h, d).numpy(), each.numpy(),
                               atol=1e-6, rtol=1e-6)
    want_idx = cache_index[:, None].long() + torch.arange(t)[None]
    assert torch.equal(off, want_idx % blk)
    assert torch.equal(page, torch.gather(tables.long(), 1, want_idx // blk))


# -- one speculative round -----------------------------------------------------

K = 3


def _round_state(rng, cfg_t, dcfg_t, self_draft, paged, b=4, s=40, blk=8):
    """Random caches, a carry with rows at different depths (one with a
    budget of 2, one dead on a scratch table) and page tables covering each
    live row's window.  A self-draft's cache holds the target's rows (its
    pages gathered, an int8 pool dequantized), so its drafts mostly agree;
    an unrelated draft's cache is random too."""
    real_lens = np.array([5, 12, 23, 9], np.int32)
    last_tok = rng.integers(0, 512, b).astype(np.int32)
    active = np.array([True, True, True, False])
    budget = np.array([9, 2, 7, 0], np.int32)
    if paged:
        p = s // blk
        nb = b * p + 1
        target = _pool(rng, cfg_t, nb, blk, paged == "int8")
        tables = (np.arange(b * p) + 1).reshape(b, p).astype(np.int32)
        tables = tables[rng.permutation(b)]
        rows = [a[:, tables].reshape(a.shape[0], b, s, *a.shape[3:])
                for a in target]
        if paged == "int8":
            rows = [(rows[0] * rows[2][..., None]).astype(np.float32),
                    (rows[1] * rows[3][..., None]).astype(np.float32)]
        tables[3] = 0
    else:
        target = rows = _pool(rng, cfg_t, b, s, False)
        tables = None
    draft = (tuple(a.copy() for a in rows[:2]) if self_draft
             else _pool(rng, dcfg_t, b, s, False))
    valid = np.arange(s)[None, :] < real_lens[:, None]
    return dict(last_tok=last_tok, real_lens=real_lens, active=active,
                budget=budget, valid=valid, target=target, draft=draft,
                tables=tables)


def _jax_round(w, dw, st, k_row, eos_id, counts=None, pen=None):
    cfg_j, _, pj, _ = w
    dcfg_j, _, dpj, _ = dw
    kw = {}
    if counts is not None:
        kw = dict(counts=jnp.asarray(counts), pres_row=jnp.asarray(pen[0]),
                  freq_row=jnp.asarray(pen[1]))
    out = jb.spec_chunk(
        pj, cfg_j, dpj, dcfg_j, _jax_cache(st["target"]),
        _jax_cache(st["draft"]), jnp.asarray(st["last_tok"]),
        jnp.asarray(st["real_lens"]), jnp.asarray(st["valid"]),
        jnp.asarray(st["active"]), jnp.asarray(st["budget"]), k=K,
        eos_id=eos_id, pad_id=0,
        tables=None if st["tables"] is None else jnp.asarray(st["tables"]),
        k_row=jnp.asarray(k_row), **kw)
    return out


def _torch_round(w, dw, st, k_row, eos_id, counts=None, pen=None):
    _, cfg_t, _, pt = w
    _, dcfg_t, _, dpt = dw
    cache, dcache = _torch_cache(st["target"]), _torch_cache(st["draft"])
    carry = torch.from_numpy(np.stack([
        st["last_tok"], st["real_lens"], st["active"].astype(np.int32),
        st["budget"]]).astype(np.int32))
    kw = {}
    cnt = None
    if counts is not None:
        cnt = torch.from_numpy(counts.copy())
        kw = dict(counts=cnt, pres_row=torch.from_numpy(pen[0]),
                  freq_row=torch.from_numpy(pen[1]))
    packed = tb.spec_chunk(
        pt, cfg_t, dpt, dcfg_t, cache, dcache, carry, torch.Generator(), K,
        eos_id=eos_id, pad_id=0,
        tables=None if st["tables"] is None else torch.from_numpy(st["tables"]),
        k_row=torch.from_numpy(k_row), **kw)
    toks, lps, m, carry = tb.unpack_chunk(packed.numpy(), 4, K + 1,
                                          commits=True)
    return toks, lps, m, carry, cache, dcache, cnt


ROUNDS = {
    # case: (paged, draft is the target, k_row, penalized)
    "contiguous": (False, False, [3, 3, 3, 3], False),
    "contiguous_self_draft": (False, True, [3, 3, 3, 3], False),
    "paged_self_draft_clamped": ("float", True, [1, 3, 2, 3], False),
    "paged_penalized": ("float", False, [3, 3, 3, 3], True),
    "paged_int8": ("int8", True, [3, 2, 3, 3], False),
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_round_equals_the_reference(target, draft, case):
    paged, self_draft, k_row, penalized = ROUNDS[case]
    dw = target if self_draft else draft
    rng = np.random.default_rng(len(case))
    st = _round_state(rng, target[1], dw[1], self_draft, paged)
    k_row = np.asarray(k_row, np.int32)
    counts = pen = None
    if penalized:
        counts = rng.integers(0, 3, (4, 512)).astype(np.int32)
        pen = (np.array([0.6, 0.0, -0.5, 1.0], np.float32),
               np.array([0.4, 1.2, 0.0, 0.3], np.float32))
    eos_id = -1
    if self_draft:
        # An EOS inside row 0's committed run: the token the target
        # commits second there (found by a first round without EOS).
        first = _torch_round(target, dw, st, k_row, -1)
        eos_id = int(first[0][0, 1])
    (jtoks, jm_, jlps, jcache, jdcache, jlast, jlens, _jvalid, jact, jbud,
     jcnt) = _jax_round(target, dw, st, k_row, eos_id, counts, pen)
    toks, lps, m, carry, cache, dcache, cnt = _torch_round(
        target, dw, st, k_row, eos_id, counts, pen)
    np.testing.assert_array_equal(m, np.asarray(jm_))
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    np.testing.assert_array_equal(carry, np.stack([
        np.asarray(jlast), np.asarray(jlens),
        np.asarray(jact).astype(np.int32), np.asarray(jbud)]))
    committed = np.arange(K + 1)[None, :] < m[:, None]
    np.testing.assert_allclose(lps[committed], np.asarray(jlps)[committed],
                               **TOL)
    _held_cache(cache, jcache, skip_page0=bool(paged))
    _held_cache(dcache, jdcache)
    if penalized:
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert m[3] == 0 and m[1] <= 2  # the dead row, the budget clamp
    if self_draft:
        assert m[0] == 2 and toks[0, 1] == eos_id  # the EOS cut
        assert (m[:3] <= k_row[:3] + 1).all()
