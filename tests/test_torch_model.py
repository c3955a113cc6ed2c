"""The port's llama forward against the JAX package's, on the same weights.

Weights come from ``distributed_llms_tpu.models.model.init_params`` and
cross through ``checkpoint.from_jax.params_from_numpy``; tokens, pools and
page tables are numpy-seeded.  float32 on the CPU at llama-tiny width
(4 layers, d_model 64, 4 query heads over 2 KV heads) with vocab 512.
Tolerance on logits and on the updated KV: atol = rtol = 1e-4 (four
layers of float32 matmuls summed in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **overrides):
    cfg_j = jax_preset("llama-tiny", vocab_size=512, **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, **overrides)
    pj = jm.init_params(jax.random.key(seed), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("overrides", [
    {},
    # Llama-3.1 rope rescale, a 3-slot context so positions cross it.
    {"rope_scaling_factor": 8.0, "rope_original_max_len": 16,
     "rope_theta": 500000.0},
])
def test_forward_logits_without_cache(overrides):
    cfg_j, cfg_t, pj, pt = _pair(**overrides)
    toks = np.random.default_rng(0).integers(0, 512, (2, 19)).astype(np.int32)
    lj, _ = jm.forward(pj, cfg_j, jnp.asarray(toks))
    lt, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks))
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 19, 512)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_prefill_into_row_cache_and_continuation():
    """Admission's two prefill legs: causal prefill into a padded row
    cache, then a suffix under an explicit continuation mask."""
    from distributed_llms_tpu.runtime.session import continuation_mask as jcm
    from distributed_llms_tpu_torch.runtime.session import continuation_mask as tcm

    cfg_j, cfg_t, pj, pt = _pair(1)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 512, (1, 12)).astype(np.int32)
    s = 32
    cj = jm.init_cache(cfg_j, 1, s)
    ct = tm.init_cache(cfg_t, 1, s)
    pos = np.arange(12, dtype=np.int32)[None]
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(prompt), positions=jnp.asarray(pos),
                        cache=cj, cache_index=jnp.int32(0))
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(prompt),
                        positions=torch.from_numpy(pos), cache=ct, cache_index=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL)
    # Suffix of 5 real + 3 pad tokens at slot 12.
    chunk = rng.integers(0, 512, (1, 8)).astype(np.int32)
    slots = np.arange(s, dtype=np.int32)
    valid = (slots < 12)[None]
    mj = jcm(jnp.asarray(valid), jnp.int32(12), 8, jnp.asarray(slots))
    mt = tcm(torch.from_numpy(valid), 12, 8, torch.from_numpy(slots))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    pos2 = (12 + np.arange(8, dtype=np.int32))[None]
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(chunk), positions=jnp.asarray(pos2),
                        cache=cj, cache_index=jnp.int32(12), attn_mask=mj)
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(chunk),
                        positions=torch.from_numpy(pos2), cache=ct,
                        cache_index=12, attn_mask=mt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), **TOL)


def test_paged_decode_step():
    """One paged decode step: per-row positions and write slots, the KV
    written through the page table, attention over each row's prefix
    (the port's plain paged attention vs the JAX paged leg)."""
    cfg_j, cfg_t, pj, pt = _pair(2)
    rng = np.random.default_rng(2)
    L, KVH, HD = cfg_t.num_layers, cfg_t.num_kv_heads, cfg_t.head_dim_
    nb, blk, p, b = 13, 8, 4, 3
    k_pool = rng.standard_normal((L, nb, blk, KVH, HD)).astype(np.float32)
    v_pool = rng.standard_normal((L, nb, blk, KVH, HD)).astype(np.float32)
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p).astype(np.int32)
    tables[2, 2:] = 0  # a shallow row whose later entries are scratch
    real_lens = np.array([20, 31, 9], np.int32)
    toks = rng.integers(0, 512, (b, 1)).astype(np.int32)
    lj, cj = jm.forward(
        pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(real_lens[:, None]),
        cache=jm.KVCache(k=jnp.asarray(k_pool), v=jnp.asarray(v_pool)),
        cache_index=jnp.asarray(real_lens), kv_tables=jnp.asarray(tables),
    )
    ct = tm.KVCache(k=torch.from_numpy(k_pool.copy()),
                    v=torch.from_numpy(v_pool.copy()))
    lt, ct = tm.forward(
        pt, cfg_t, torch.from_numpy(toks),
        positions=torch.from_numpy(real_lens[:, None]), cache=ct,
        cache_index=torch.from_numpy(real_lens),
        kv_tables=torch.from_numpy(tables),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), **TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_contiguous_decode_step(window):
    """One contiguous decode step (the batcher's default mode): per-row
    positions and write slots into a [L, B, S, KVH, HD] cache, attention
    over each row's prefix — or its window band — through the port's
    ragged route vs the JAX masked dense path.  Row 2 sits at the last
    slot, row 3 one past it (a finished row's idle write, which the JAX
    package's dynamic_update_slice clamps to slot S - 1)."""
    cfg_j, cfg_t, pj, pt = _pair(5, sliding_window=window)
    rng = np.random.default_rng(5)
    L, KVH, HD = cfg_t.num_layers, cfg_t.num_kv_heads, cfg_t.head_dim_
    b, s = 4, 24
    k = rng.standard_normal((L, b, s, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((L, b, s, KVH, HD)).astype(np.float32)
    real_lens = np.array([5, 17, s - 1, s], np.int32)
    toks = rng.integers(0, 512, (b, 1)).astype(np.int32)
    slots = np.arange(s)
    mask = (slots[None, :] <= real_lens[:, None])[:, None, None, :]
    lj, cj = jm.forward(
        pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(real_lens[:, None]),
        cache=jm.KVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
        cache_index=jnp.asarray(real_lens), attn_mask=jnp.asarray(mask),
    )
    ct = tm.KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    lt, ct = tm.forward(
        pt, cfg_t, torch.from_numpy(toks),
        positions=torch.from_numpy(real_lens[:, None]), cache=ct,
        cache_index=torch.from_numpy(real_lens),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), **TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_windowed_prefill(cached):
    """Sliding window 5 over a 19-token prompt: the no-cache causal path
    and the cached admission prefill (padded row cache) both AND in the
    window."""
    cfg_j, cfg_t, pj, pt = _pair(6, sliding_window=5)
    toks = np.random.default_rng(6).integers(0, 512, (1, 19)).astype(np.int32)
    if not cached:
        lj, _ = jm.forward(pj, cfg_j, jnp.asarray(toks))
        lt, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks))
    else:
        pos = np.arange(19, dtype=np.int32)[None]
        lj, _ = jm.forward(pj, cfg_j, jnp.asarray(toks),
                           positions=jnp.asarray(pos),
                           cache=jm.init_cache(cfg_j, 1, 32),
                           cache_index=jnp.int32(0))
        lt, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                           positions=torch.from_numpy(pos),
                           cache=tm.init_cache(cfg_t, 1, 32), cache_index=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    full, _ = tm.forward(pt, get_preset("llama-tiny", vocab_size=512),
                         torch.from_numpy(toks))
    assert not torch.allclose(full[:, -1], lt[:, -1])  # the window bit


def test_int8_paged_decode_step():
    """One decode step over an int8 pool: this step's K/V quantized per
    (row, head) and written with its scale, attention through the int8
    leg (the port's dequantize-then-dense plain version vs the JAX
    package's on the CPU)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize

    cfg_j, cfg_t, pj, pt = _pair(7)
    rng = np.random.default_rng(7)
    L, KVH, HD = cfg_t.num_layers, cfg_t.num_kv_heads, cfg_t.head_dim_
    nb, blk, p, b = 13, 8, 4, 3
    pools = [kv_quantize(torch.from_numpy(rng.standard_normal(
        (L, nb, blk, KVH, HD)).astype(np.float32))) for _ in range(2)]
    (kq, ks), (vq, vs) = [(d.numpy(), sc.numpy()) for d, sc in pools]
    tables = (rng.permutation(nb - 1)[: b * p] + 1).reshape(b, p).astype(np.int32)
    real_lens = np.array([20, 31, 9], np.int32)
    toks = rng.integers(0, 512, (b, 1)).astype(np.int32)
    lj, cj = jm.forward(
        pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(real_lens[:, None]),
        cache=jm.QuantKVCache(k=jnp.asarray(kq), v=jnp.asarray(vq),
                              k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                              row_dtype="float32"),
        cache_index=jnp.asarray(real_lens), kv_tables=jnp.asarray(tables),
    )
    ct = tm.QuantKVCache(*(torch.from_numpy(a.copy()) for a in (kq, vq, ks, vs)),
                         row_dtype="float32")
    lt, ct = tm.forward(
        pt, cfg_t, torch.from_numpy(toks),
        positions=torch.from_numpy(real_lens[:, None]), cache=ct,
        cache_index=torch.from_numpy(real_lens),
        kv_tables=torch.from_numpy(tables),
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # The written codes agree within one step (float32 K/V of the two
    # stacks differ in the last digits; see test_torch_batcher_modes.py).
    assert np.abs(ct.k.numpy().astype(int) - np.asarray(cj.k)).max() <= 1
    np.testing.assert_allclose(ct.v_scale.numpy(), np.asarray(cj.v_scale),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="paged decode only"):
        tm.forward(pt, cfg_t, torch.from_numpy(toks), cache=ct, cache_index=0)


def test_init_params_keeps_the_stacked_layout():
    cfg = get_preset("llama-tiny", qkv_bias=True)
    g = torch.Generator().manual_seed(0)
    pt = tm.init_params(cfg, generator=g, device="cpu")
    pj = jm.init_params(jax.random.key(0), jax_preset("llama-tiny",
                                                      qkv_bias=True))
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), pj)
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), pt)
    assert shapes_t == shapes_j
    # Reproducible from the generator's seed.
    again = tm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["blocks"]["attn"]["wq"], pt["blocks"]["attn"]["wq"])


def test_params_from_numpy_maps_every_leaf_and_checks_shapes():
    cfg_j, cfg_t, pj, pt = _pair(3)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, pj))
    for path, leaf in flat_j:
        node = pt
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf)
    tree = jax.tree.map(np.asarray, pj)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"][:, :, :2]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(tree, cfg_t, device="cpu")
    del tree["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, cfg_t, device="cpu")


def test_bf16_tree_round_trips_exactly():
    cfg_j = jax_preset("llama-tiny", dtype="bfloat16")
    cfg_t = get_preset("llama-tiny", dtype="bfloat16")
    pj = jm.init_params(jax.random.key(4), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    wq = pt["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(pj["blocks"]["attn"]["wq"], np.float32)
    )


@pytest.mark.parametrize("change", [
    {"family": "gpt2", "attn_impl": "ring"},
    {"num_experts": 4, "attn_impl": "ulysses"},
    {"family": "neox", "attn_impl": "ulysses"},
    {"attn_impl": "ring"},
])
def test_later_slice_models_are_refused(change):
    """Every block family and MoE are served, the sequence-parallel
    attentions too, whatever the family; outside a seq mesh their forward
    raises the reference's RuntimeError, a cached one too."""
    cfg = dataclasses.replace(get_preset("llama-tiny"), **change)
    tm.check_supported(cfg)
    tm.check_supported(dataclasses.replace(cfg, attn_impl="dot"))
    params = tm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="needs a bound 'seq' mesh axis"):
        tm.forward(params, cfg, toks)
    with pytest.raises(RuntimeError, match="needs a bound 'seq' mesh axis"):
        tm.forward(params, cfg, toks, cache=tm.init_cache(cfg, 1, 8),
                   cache_index=0)


def test_sliding_window_models_are_served():
    tm.check_supported(get_preset("mistral-7b"))
    tm.check_supported(get_preset("llama-tiny", sliding_window=8))


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("per_row", [True, False])
def test_gapped_decode_step_under_the_callers_mask(window, per_row):
    """The right-padded generate layout: two rows padded to T=8 (lengths 5
    and 8), prefilled at slot 0, then one decode step writing slot 8 for
    both rows at positions [5, 8] under the gapped mask (real prompt slots
    plus slot 8).  The per-row leg (a [B] cache_index: the speculative
    draft step) must attend under that mask, not the prefix [0, 8] — the
    pad slots 5..7 of row 0 are not keys; the scalar leg (generate's
    decode) likewise.  Windowed, the window compares the slots' true
    positions (``key_positions``: slot 8 is position 5 on row 0)."""
    from distributed_llms_tpu.runtime.generate import window_key_positions

    cfg_j, cfg_t, pj, pt = _pair(8, sliding_window=window)
    rng = np.random.default_rng(8)
    b, t, s = 2, 8, 12
    lens = np.array([5, 8], np.int32)
    prompt = rng.integers(1, 512, (b, t)).astype(np.int32)
    prompt[0, 5:] = 0
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    cj = jm.init_cache(cfg_j, b, s)
    ct = tm.init_cache(cfg_t, b, s)
    _, cj = jm.forward(pj, cfg_j, jnp.asarray(prompt), positions=jnp.asarray(pos),
                       cache=cj, cache_index=jnp.int32(0))
    tm.forward(pt, cfg_t, torch.from_numpy(prompt),
               positions=torch.from_numpy(pos.copy()), cache=ct, cache_index=0)
    slots = np.arange(s)
    mask = ((slots[None, :] < lens[:, None]) | (slots[None, :] == t))
    mask = mask[:, None, None, :]
    tok = rng.integers(1, 512, (b, 1)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if window is not None:
        kp = np.array(window_key_positions(t, jnp.asarray(lens), s))
        kw_j["key_positions"] = jnp.asarray(kp)
        kw_t["key_positions"] = torch.from_numpy(kp)
    idx = np.full((b,), t, np.int32)
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(tok),
                        positions=jnp.asarray(lens[:, None]), cache=cj,
                        cache_index=jnp.asarray(idx) if per_row else t,
                        attn_mask=jnp.asarray(mask), **kw_j)
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(tok),
                        positions=torch.from_numpy(lens[:, None].copy()),
                        cache=ct,
                        cache_index=torch.from_numpy(idx) if per_row else t,
                        attn_mask=torch.from_numpy(mask), **kw_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL)


def test_windowed_flash_prefill_with_key_positions_stays_dense():
    """A windowed flash model's cached prefill with a ``key_positions`` map
    (a gapped layout) takes the dense window path, as the reference's
    condition says; without the map it takes the dynamic flash kernel."""
    from distributed_llms_tpu_torch.ops import flash

    cfg_j, cfg_t, pj, pt = _pair(9, sliding_window=4, attn_impl="flash")
    toks = np.random.default_rng(9).integers(0, 512, (1, 10)).astype(np.int32)
    pos = np.arange(10, dtype=np.int32)[None]
    kp = np.arange(16, dtype=np.int32)[None] + 3  # a shifted map
    lj, _ = jm.forward(pj, cfg_j, jnp.asarray(toks), positions=jnp.asarray(pos),
                       cache=jm.init_cache(cfg_j, 1, 16),
                       cache_index=jnp.int32(0), key_positions=jnp.asarray(kp))
    calls = []
    real = flash.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    flash.flash_attention = spy
    try:
        lt, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                           positions=torch.from_numpy(pos),
                           cache=tm.init_cache(cfg_t, 1, 16), cache_index=0,
                           key_positions=torch.from_numpy(kp))
        assert not calls
        tm.forward(pt, cfg_t, torch.from_numpy(toks),
                   positions=torch.from_numpy(pos),
                   cache=tm.init_cache(cfg_t, 1, 16), cache_index=0)
        assert len(calls) == cfg_t.num_layers
    finally:
        flash.flash_attention = real
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
