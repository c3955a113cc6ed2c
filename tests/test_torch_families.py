"""The gpt2, opt and neox block families in the port against the JAX
package, on the CPU.

- Layers: ``layer_norm`` (float32 statistics), ``mlp_gelu`` under its
  three activations (relu for OPT, erf gelu for Pythia, the tanh
  approximation for GPT-2's "gelu"/"gelu_new") and its ``ValueError`` on
  any other, partial rotary (``rotary_pct``: only the first dims of a
  head rotate).
- ``forward`` logits for gpt2-tiny, opt-tiny and neox-tiny with parallel
  and sequential residual, uncached and through a cached prefill and a
  per-row decode step.
- Learned positions past the table: inside it (-1 included, the last
  row) ``embed`` reads what the reference's ``jnp.take`` reads; past the
  end the port reads the last row (finite), where ``jnp.take`` fills
  NaN — no committed token reads those positions (ROADMAP, Queue 3) —
  and nothing asserts on the device.
- Temperature-0 streams of the paged, prefix-cached batcher equal the
  reference batcher's for gpt2-tiny and neox-tiny at the same slot count,
  and a row that runs to the last learned position.
- ``generate_text`` on gpt2-tiny equals the reference engine's, one
  prompt reaching the last learned position; two session turns on
  opt-tiny equal the reference's.
- Stores of every family: ``leaf_plan`` as the reference's, raw shards
  byte-equal to the reference's, int8 and int4.
- A gpt2-tiny int8 store served with ``serve_quantized`` (``w_in`` /
  ``w_out`` through the dequant-matmul's plain version) equals the
  reference's streams, and its int4 self-draft builds.
- ``dlt-serve-torch --preset <family>-tiny`` boots for every family.

float32 at the tiny presets' widths (3-4 layers, d_model 64, 4 heads),
vocab 512 so the byte tokenizer's ids fit; weights from the reference's
``init_params`` through ``params_from_numpy``, inputs from numpy seeds.
Tolerance on logits: atol = rtol = 1e-4 (float32 sums in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.core.config import RuntimeConfig as JaxRuntimeConfig
from distributed_llms_tpu.models import layers as jl
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.engine import InferenceEngine as JaxEngine
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.models import layers as tl
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(preset, seed=0, **overrides):
    """(cfg_j, cfg_t, params_j, params_t): the reference's init_params in
    both stacks, non-zero biases and norms so that every leaf counts."""
    overrides.setdefault("vocab_size", 512)
    cfg_j = jax_preset(preset, **overrides)
    cfg_t = get_preset(preset, **overrides)
    pj = jm.init_params(jax.random.key(seed), cfg_j)
    rng = np.random.default_rng(seed)

    def jitter(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if "bias" in name or name.endswith(("bq", "bk", "bv", "bo", "b_in",
                                            "b_out")):
            return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        if "scale" in name:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x

    pj = jax.tree_util.tree_map_with_path(jitter, pj)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


# -- layers ---------------------------------------------------------------------

def test_layer_norm_equals_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jl.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                         1e-5)
    got = tl.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16 in, bf16 out, statistics in float32.
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = tl.layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias),
                       1e-5)
    assert yb.dtype == torch.bfloat16


@pytest.mark.parametrize("activation", ["relu", "gelu_exact", "gelu",
                                        "gelu_new"])
def test_mlp_gelu_each_activation(activation):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    p = {"w_in": rng.standard_normal((16, 40)).astype(np.float32) / 4,
         "b_in": rng.standard_normal(40).astype(np.float32),
         "w_out": rng.standard_normal((40, 16)).astype(np.float32) / 6,
         "b_out": rng.standard_normal(16).astype(np.float32)}
    want = jl.mlp_gelu(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                       activation)
    got = tl.mlp_gelu(torch.from_numpy(x),
                      {k: torch.from_numpy(v) for k, v in p.items()},
                      activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlp_gelu_refuses_an_unknown_activation():
    p = {"w_in": torch.ones(4, 8), "b_in": torch.zeros(8),
         "w_out": torch.ones(8, 4), "b_out": torch.zeros(4)}
    with pytest.raises(ValueError, match="silu"):
        tl.mlp_gelu(torch.ones(1, 1, 4), p, "silu")
    with pytest.raises(ValueError, match="swish"):
        jl.mlp_gelu(jnp.ones((1, 1, 4)), jax.tree.map(
            lambda t: jnp.asarray(t.numpy()), p), "swish")


def test_partial_rotary_rotates_only_the_leading_dims():
    """rotary_pct 0.25 of head_dim 16: 4 dims rotate, 12 pass through —
    the reference's split of apply_rope."""
    cfg = get_preset("neox-tiny")
    rot = int(cfg.head_dim_ * cfg.rotary_pct)
    assert rot == 4
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 7
    gq, gk = tm._rotate(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(pos), cfg)
    for got, x in ((gq, q), (gk, k)):
        want = np.concatenate([np.asarray(jl.apply_rope(
            jnp.asarray(x[..., :rot]), jnp.asarray(pos), cfg.rope_theta)),
            x[..., rot:]], axis=-1)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


# -- the forward ------------------------------------------------------------------

FAMILIES = [("gpt2-tiny", {}), ("opt-tiny", {}),
            ("neox-tiny", {"parallel_residual": True}),
            ("neox-tiny", {"parallel_residual": False})]


@pytest.mark.parametrize("preset,overrides", FAMILIES)
def test_forward_logits_equal_the_reference(preset, overrides):
    cfg_j, cfg_t, pj, pt = _pair(preset, 3, **overrides)
    toks = np.random.default_rng(3).integers(0, 512, (2, 17)).astype(np.int32)
    lj, _ = jm.forward(pj, cfg_j, jnp.asarray(toks))
    lt, _ = tm.forward(pt, cfg_t, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("preset,overrides", FAMILIES[:3])
def test_cached_prefill_and_decode_step_equal_the_reference(preset, overrides):
    """A prefill into a row cache at cache_index 0, then one per-row
    decode step at ragged depths under the caller's mask (positions
    index the learned table at the rows' own depths)."""
    cfg_j, cfg_t, pj, pt = _pair(preset, 4, **overrides)
    rng = np.random.default_rng(4)
    s = 24
    toks = rng.integers(0, 512, (2, 9)).astype(np.int32)
    cj = jm.init_cache(cfg_j, 2, s)
    ct = tm.init_cache(cfg_t, 2, s)
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(toks), cache=cj,
                        cache_index=jnp.int32(0))
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(toks), cache=ct,
                        cache_index=0)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    idx = np.array([9, 6], np.int32)  # row 1 overwrites its slot 6
    nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
    mask = (np.arange(s)[None, :] <= idx[:, None])[:, None, None, :]
    lj, cj = jm.forward(pj, cfg_j, jnp.asarray(nxt),
                        positions=jnp.asarray(idx[:, None]), cache=cj,
                        cache_index=jnp.asarray(idx), attn_mask=jnp.asarray(mask))
    lt, ct = tm.forward(pt, cfg_t, torch.from_numpy(nxt),
                        positions=torch.from_numpy(idx[:, None]), cache=ct,
                        cache_index=torch.from_numpy(idx),
                        attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), **TOL)


@pytest.mark.parametrize("preset", ["gpt2-tiny", "opt-tiny"])
def test_learned_positions_past_the_table_read_as_the_reference(preset):
    """The table has max_seq_len rows (+2 for OPT's offset).  Positions
    at the first and last row and -1 (-3 for OPT: -1 after the offset)
    read what ``jnp.take`` reads (-1 wraps to the last row); positions
    past the end read the last row, finite, where ``jnp.take`` fills NaN
    (no committed token reads them: see the speculative test below)."""
    cfg_j, cfg_t, pj, pt = _pair(preset, 5)
    last = cfg_t.max_seq_len - 1
    off = 2 if preset == "opt-tiny" else 0
    pos = np.array([[0, last, last + 1, last + 40, -1 - off]], np.int32)
    toks = np.full((1, 5), 7, np.int32)
    want = np.asarray(jm.embed(pj, cfg_j, jnp.asarray(toks), jnp.asarray(pos)))
    got = tm.embed(pt, cfg_t, torch.from_numpy(toks),
                   torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got[0, [0, 1, 4]], want[0, [0, 1, 4]], **TOL)
    assert np.isnan(want[0, 2:4]).all()
    end = np.asarray(pj["embed"]["wte"][7] + pj["embed"]["wpe"][-1])
    np.testing.assert_allclose(got[0, 2], end, **TOL)
    np.testing.assert_allclose(got[0, 3], end, **TOL)
    np.testing.assert_allclose(got[0, 4], end, **TOL)


def test_speculative_rows_at_the_end_of_the_learned_table():
    """opt-tiny with max_seq_len == max_len == 64, a paged speculative
    batcher (k 3, the target as its own draft): row 0's prompt + budget
    fills the table, so its last verify windows reach positions past it.
    The port's greedy streams, under either engine loop, equal the
    reference's PLAIN batcher's (speculation is greedy-exact).  The
    reference's speculative batcher fills those positions with NaN rows,
    which reach the scratch page and, through its plain attention's
    masked products, turn the other row's stream to token 0 — a fault of
    the reference (ROADMAP, Queue 3), kept in view here."""
    cfg_j, cfg_t, pj, pt = _pair("opt-tiny", 7, max_seq_len=64)
    kw = dict(batch_slots=2, max_len=64, chunk_steps=5, paged_pages=12,
              page_size=16, prefix_cache=True)
    prompts, budgets = [list(range(1, 41)), list(range(50, 60))], [24, 54]

    def run(mod, cfg, params, tok, **extra):
        b = mod.ContinuousBatcher(cfg, params, tok, **kw, **extra)
        for prompt, n in zip(prompts, budgets):
            b.submit(prompt, max_new_tokens=n)
        return b.run()

    want = run(jb, cfg_j, pj, JaxByteTokenizer(), overlap=False)
    spec = dict(draft_params=pt, draft_cfg=cfg_t, spec_k=3)
    for overlap in (False, True):
        got = run(tb, cfg_t, pt, ByteTokenizer(), overlap=overlap, **spec)
        assert got == want
    assert [len(want[0]), len(want[1])] == budgets
    ref_spec = run(jb, cfg_j, pj, JaxByteTokenizer(), overlap=False,
                   draft_params=pj, draft_cfg=cfg_j, spec_k=3)
    assert ref_spec[0] == want[0]
    assert ref_spec[1] != want[1] and ref_spec[1][-10:] == [0] * 10


def test_init_params_refusals_and_layouts():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="llama"):
        tm.init_params(get_preset("gpt2-tiny", num_experts=4), gen)
    with pytest.raises(ValueError, match="untie"):
        tm.init_params(get_preset("neox-tiny", tie_embeddings=True), gen)
    for preset in ("gpt2-tiny", "opt-tiny", "neox-tiny"):
        cfg_j = jax_preset(preset)
        want = jax.tree.map(lambda a: tuple(a.shape),
                            jm.init_params(jax.random.key(0), cfg_j))
        got = jax.tree.map(lambda a: tuple(a.shape),
                           tm.init_params(get_preset(preset), gen),
                           is_leaf=torch.is_tensor)
        assert got == want, preset
    for preset in ("ring", "ulysses"):
        # Served on a seq mesh only: outside one the first attention
        # raises the reference's RuntimeError.
        cfg = get_preset("gpt2-tiny", attn_impl=preset)
        tm.check_supported(cfg)
        with pytest.raises(RuntimeError, match="needs a bound 'seq' mesh"):
            tm.forward(tm.init_params(cfg, gen), cfg,
                       torch.zeros((1, 4), dtype=torch.long))


# -- serving ------------------------------------------------------------------------

def _prompts(seed):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    return [shared + pick(5), pick(7), shared + pick(9), pick(30), pick(3),
            shared + pick(20)]


def _run_both(w, budgets, prompts, **kw):
    cfg_j, cfg_t, pj, pt = w
    jbat = jb.ContinuousBatcher(cfg_j, pj, JaxByteTokenizer(),
                                **{"overlap": False, **kw})
    tbat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), **kw)
    for prompt, n in zip(prompts, budgets):
        assert jbat.submit(prompt, max_new_tokens=n) == tbat.submit(
            prompt, max_new_tokens=n)
    return jbat, jbat.run(), tbat, tbat.run()


PAGED = dict(batch_slots=3, max_len=96, chunk_steps=4, paged_pages=24,
             page_size=16, prefix_cache=True)


@pytest.mark.parametrize("preset", ["gpt2-tiny", "neox-tiny"])
def test_paged_streams_identical_to_the_reference(preset):
    budgets = [12, 9, 12, 6, 10, 8]
    jbat, want, tbat, got = _run_both(_pair(preset, 6), budgets,
                                      _prompts(6), **PAGED)
    assert got == want
    assert [len(got[rid]) for rid in range(6)] == budgets
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits >= 2
    tbat.assert_pool_consistent()


def test_rows_run_to_the_last_learned_position():
    """max_len == max_seq_len == 64 on opt-tiny: prompt + budget fills
    the table (OPT's offset included), and a finished row idles at the
    last slot while the other decodes — equal to the reference."""
    w = _pair("opt-tiny", 7, max_seq_len=64)
    prompts = [list(range(1, 41)), list(range(50, 60))]
    jbat, want, tbat, got = _run_both(
        w, [24, 54], prompts, batch_slots=2, max_len=64, chunk_steps=5,
        paged_pages=10, page_size=16, prefix_cache=True)
    assert got == want
    assert [len(got[0]), len(got[1])] == [24, 54]


def test_generate_text_reaches_the_last_learned_position():
    """gpt2-tiny with max_seq_len 32: a 7-token prompt (with BOS) and 25
    new tokens end on position 31, the table's last row; equal to the
    reference engine's tokens and text."""
    cfg_j, cfg_t, pj, pt = _pair("gpt2-tiny", 8, max_seq_len=32)
    rt = dict(max_decode_steps=25, max_seq_len=32)
    jeng = JaxEngine(cfg_j, JaxRuntimeConfig(**rt), pj)
    teng = InferenceEngine(cfg_t, RuntimeConfig(**rt), pt, device="cpu")
    prompts = ["abcdef", "hi"]
    want = jeng.generate_text(prompts)
    got = teng.generate_text(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.text == want.text
    assert got.tokens.shape == (2, 25)


def test_opt_session_turns_equal_the_reference():
    """Two turns of a session on opt-tiny: the padded multi-turn layout
    feeds the learned table positions that differ from the slots."""
    cfg_j, cfg_t, pj, pt = _pair("opt-tiny", 11, max_seq_len=64)
    rt = dict(max_decode_steps=5, max_seq_len=64)
    jeng = JaxEngine(cfg_j, JaxRuntimeConfig(**rt), pj)
    teng = InferenceEngine(cfg_t, RuntimeConfig(**rt), pt, device="cpu")
    turns = (["abcd", "a longer first turn"], ["efgh", "x"])
    jsid, want = jeng.start_session(list(turns[0]))
    sid, got = teng.start_session(list(turns[0]))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    want = jeng.continue_session(jsid, list(turns[1]))
    got = teng.continue_session(sid, list(turns[1]))
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("preset", ["gpt2-tiny", "opt-tiny", "neox-tiny",
                                    "moe-tiny"])
def test_family_stores_round_trip(preset, quant, tmp_path):
    """``leaf_plan`` decides every leaf of each family as the reference
    does (LayerNorm biases, b_in/b_out/bo and the other biases stay,
    embed/wpe, the router and the 4-D expert stacks quantize); the port's
    raw shards equal the reference's byte for byte, and the reference's
    store reconstructed by the port gives the reference's logits."""
    import filecmp
    import os

    from distributed_llms_tpu.checkpoint import quantize as jquant
    from distributed_llms_tpu.checkpoint import store as jstore
    from distributed_llms_tpu_torch.checkpoint import quantize as tquant
    from distributed_llms_tpu_torch.checkpoint import store as tstore

    cfg_j, cfg_t, pj, pt = _pair(preset, 12)
    plans = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(pj)[0]:
        name = "/".join(k.key for k in path)
        plans[name] = tquant.leaf_plan(name, np.asarray(leaf))
        assert plans[name] == jquant.leaf_plan(name, leaf), name
    assert not any(plans[n][0] for n in plans
                   if n.split("/")[-1] in ("bias", "bq", "bk", "bv", "bo",
                                           "b_in", "b_out", "scale"))
    assert plans.get("embed/wpe", (True,))[0]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save_shards(pj, jdir, num_shards=2, model_config=cfg_j,
                       quantization=quant)
    tstore.save_shards(pt, tdir, num_shards=2, model_config=cfg_t,
                       quantization=quant)
    assert tstore.load_manifest(tdir) == jstore.load_manifest(jdir)
    for i in range(2):
        assert filecmp.cmp(os.path.join(jdir, f"shard_{i}.bin"),
                           os.path.join(tdir, f"shard_{i}.bin"),
                           shallow=False), f"shard {i} differs"
    toks = np.random.default_rng(12).integers(0, 512, (1, 9)).astype(np.int32)
    want, _ = jm.forward(jstore.reconstruct(jdir, dtype=jnp.float32), cfg_j,
                         jnp.asarray(toks))
    got, _ = tm.forward(tstore.reconstruct(jdir, dtype="float32",
                                           device="cpu"), cfg_t,
                        torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def gpt2_int8_store(tmp_path_factory):
    from distributed_llms_tpu.checkpoint import store as jstore

    cfg = jax_preset("gpt2-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(9), cfg)
    path = str(tmp_path_factory.mktemp("gpt2_int8"))
    jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                       quantization="int8")
    return path


def test_gpt2_int8_store_serves_quantized_as_the_reference(gpt2_int8_store):
    jeng = JaxEngine.from_store(gpt2_int8_store,
                                rt=JaxRuntimeConfig(serve_quantized=True))
    teng = InferenceEngine.from_store(
        gpt2_int8_store, rt=RuntimeConfig(serve_quantized=True), device="cpu")
    mlp = teng.params["blocks"]["mlp"]
    assert isinstance(mlp["w_in"], QuantizedTensor)
    assert isinstance(mlp["w_out"], QuantizedTensor)
    assert not isinstance(mlp["b_in"], QuantizedTensor)
    assert not isinstance(teng.params["embed"]["wpe"], QuantizedTensor)
    budgets = [10, 8, 10, 6, 9, 7]
    jbat = jb.ContinuousBatcher(jeng.cfg, jeng.params, JaxByteTokenizer(),
                                overlap=False, **PAGED)
    tbat = tb.ContinuousBatcher(teng.cfg, teng.params, ByteTokenizer(),
                                **PAGED)
    for prompt, n in zip(_prompts(9), budgets):
        jbat.submit(prompt, max_new_tokens=n)
        tbat.submit(prompt, max_new_tokens=n)
    assert tbat.run() == jbat.run()


def test_gpt2_int4_self_draft_builds_and_keeps_the_stream():
    """``attach_draft(quantize_bits=4)`` quantizes w_in/w_out with the
    projections (their packing checked against K_LEAD), and the
    speculative batcher's greedy streams equal the plain one's."""
    _, cfg_t, _, pt = _pair("gpt2-tiny", 10)
    eng = InferenceEngine(cfg_t, RuntimeConfig(), pt, device="cpu")
    eng.attach_draft(quantize_bits=4)
    dm = eng.draft_params["blocks"]["mlp"]
    assert dm["w_in"].bits == 4 and dm["w_out"].bits == 4
    assert dm["w_in"].pack_axis == -2
    kw = dict(batch_slots=2, max_len=64, paged_pages=12, page_size=16)
    prompts = _prompts(10)[:3]
    outs = []
    for spec in (False, True):
        b = eng.continuous_batcher(speculative=spec, **kw)
        rids = [b.submit(p, max_new_tokens=9) for p in prompts]
        res = b.run()
        outs.append([res[r] for r in rids])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("preset", ["gpt2-tiny", "opt-tiny", "neox-tiny",
                                    "moe-tiny"])
def test_serve_main_boots_every_family(preset):
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args(
        ["--preset", preset, "--device", "cpu", "--paged-pages", "12",
         "--page-size", "16", "--prefix-cache", "--max-len", "64",
         "--slots", "2", "--port", "0"])
    server = serve_main.build_server(args)
    b = server.batcher
    assert b.cfg.family == get_preset(preset).family and b.paged
    rid = b.submit("hello", max_new_tokens=4)
    assert len(b.run()[rid]) == 4
