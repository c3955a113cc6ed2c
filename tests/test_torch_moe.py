"""Mixtral-style MoE in the port against the JAX package, on the CPU.

- ``moe_swiglu``: with a lossless capacity it equals a per-token top-k
  mix; at the default capacity (1.25) over a batch whose experts
  overflow it equals the reference's output and aux term, drops
  included; the selected experts equal ``lax.top_k``'s, ties broken to
  the lower expert; a tiny capacity drops rows to exactly zero.
- ``forward`` logits and aux on moe-tiny, ``lm_loss`` and a ``Trainer``
  step (loss and aux), and MoE refused outside the llama family.
- ``cap`` counts every row, so the streams depend on the batch's shape:
  temperature-0 streams of the port's batcher equal the reference
  batcher's at the same slot count — paged and prefix-cached (bucketed
  admissions, hits), under chunked prefill (padded bites), and
  speculative (the (k+1)-token verify window) — and ``generate_text``
  equals the reference engine's.
- An int4 moe-tiny store served with ``serve_quantized`` (experts
  rehydrated per layer, the projections through the dequant-matmul's
  plain version) equals the reference's streams; the int4 self-draft of
  moe-tiny builds (its 4-D expert leaves quantized, not packing-checked
  against the dequant-matmul).

float32 at moe-tiny's width (2 layers, d_model 64, 4 experts, top 2),
vocab 512; weights from the reference's ``init_params`` through
``params_from_numpy``.  Tolerances: outputs and logits atol = rtol =
1e-4, the aux term 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.core.config import ModelConfig as JaxModelConfig
from distributed_llms_tpu.core.config import RuntimeConfig as JaxRuntimeConfig
from distributed_llms_tpu.models import layers as jl
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import train as jt
from distributed_llms_tpu.runtime.engine import InferenceEngine as JaxEngine
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
from distributed_llms_tpu_torch.core.config import ModelConfig
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.models import layers as tl
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import train as tt
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_params(seed, d, e, f):
    rng = np.random.default_rng(seed)
    return {
        "router": rng.standard_normal((d, e)).astype(np.float32) * d ** -0.5,
        "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5,
        "w_up": rng.standard_normal((e, d, f)).astype(np.float32) * d ** -0.5,
        "w_down": rng.standard_normal((e, f, d)).astype(np.float32) * f ** -0.5,
    }


def _both(x, p, **cfg_kw):
    """(port out, port aux, reference out, reference aux)."""
    out_t, aux_t = tl.moe_swiglu(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
        ModelConfig(family="llama", **cfg_kw))
    out_j, aux_j = jl.moe_swiglu(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p),
        JaxModelConfig(family="llama", **cfg_kw))
    return out_t.numpy(), float(aux_t), np.asarray(out_j), float(aux_j)


def _per_token(x, p, k):
    """The top-k expert mix of each row alone: no capacity, no dispatch."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    logits = xf @ p["router"]
    out = np.zeros_like(xf)
    for s in range(xf.shape[0]):
        idx = np.argsort(-logits[s], kind="stable")[:k]
        g = np.exp(logits[s][idx] - logits[s][idx].max())
        for w, ei in zip(g / g.sum(), idx):
            gate, up = xf[s] @ p["w_gate"][ei], xf[s] @ p["w_up"][ei]
            out[s] += w * (((gate / (1 + np.exp(-gate))) * up) @ p["w_down"][ei])
    return out.reshape(x.shape)


def test_lossless_routing_equals_the_per_token_mix():
    p = _moe_params(0, 16, 4, 32)
    x = np.random.default_rng(1).standard_normal((2, 5, 16)).astype(np.float32)
    out, aux, out_j, aux_j = _both(x, p, num_experts=4,
                                   num_experts_per_token=2,
                                   moe_capacity_factor=4.0)
    np.testing.assert_allclose(out, _per_token(x, p, 2), **TOL)
    np.testing.assert_allclose(out, out_j, **TOL)
    assert abs(aux - aux_j) <= AUX_TOL and 0.5 < aux < 2.0


@pytest.mark.parametrize("shape", [(1, 40), (8, 1), (3, 5)])
def test_capacity_drops_equal_the_reference(shape):
    """Default capacity 1.25 at k=2, E=8: 40 rows of one sequence, a
    decode step over 8 slots (cap 3, 16 claims for 24 places), a (k+1)
    window over 3 rows — inputs skewed towards expert 0 so claims
    overflow.  Same outputs and aux as the reference."""
    p = _moe_params(2, 32, 8, 48)
    p["router"][:, 0] += 0.3  # skew: expert 0 oversubscribed
    x = np.random.default_rng(3).standard_normal(
        (*shape, 32)).astype(np.float32) + 0.5
    cfg_kw = dict(num_experts=8, num_experts_per_token=2)
    out, aux, out_j, aux_j = _both(x, p, **cfg_kw)
    np.testing.assert_allclose(out, out_j, **TOL)
    assert abs(aux - aux_j) <= AUX_TOL
    # The overflow is real: the lossless mix differs on some row.
    lossless = _per_token(x, p, 2)
    assert np.abs(out - lossless).max() > 1e-3
    s = shape[0] * shape[1]
    assert tl.moe_capacity(ModelConfig(family="llama", **cfg_kw), s) == \
        max(1, int(np.ceil(1.25 * 2 * s / 8)))


def test_selected_experts_equal_lax_top_k_with_ties():
    """Router columns 1 and 2 equal, 3 a copy of 0: every row's logits
    tie in pairs.  ``lax.top_k`` keeps the lower expert first; the port
    selects the same sets, so the outputs agree."""
    p = _moe_params(4, 16, 4, 24)
    p["router"][:, 2] = p["router"][:, 1]
    p["router"][:, 3] = p["router"][:, 0]
    x = np.random.default_rng(5).standard_normal((2, 6, 16)).astype(np.float32)
    logits = x.reshape(-1, 16) @ p["router"]
    want = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1])
    got = torch.sort(torch.from_numpy(logits), dim=-1, descending=True,
                     stable=True)[1][:, :2].numpy()
    np.testing.assert_array_equal(got, want)
    out, aux, out_j, aux_j = _both(x, p, num_experts=4,
                                   num_experts_per_token=2)
    np.testing.assert_allclose(out, out_j, **TOL)
    assert abs(aux - aux_j) <= AUX_TOL


def test_tiny_capacity_drops_rows_to_zero():
    p = _moe_params(6, 8, 2, 16)
    x = np.random.default_rng(7).standard_normal((1, 16, 8)).astype(np.float32)
    out, _, out_j, _ = _both(x, p, num_experts=2, num_experts_per_token=1,
                             moe_capacity_factor=0.01)
    assert np.isfinite(out).all()
    assert int(np.all(out[0] == 0.0, axis=-1).sum()) >= 14
    np.testing.assert_allclose(out, out_j, **TOL)


def _pair(seed=0, **overrides):
    overrides.setdefault("vocab_size", 512)
    cfg_j = jax_preset("moe-tiny", **overrides)
    cfg_t = get_preset("moe-tiny", **overrides)
    pj = jm.init_params(jax.random.key(seed), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def moe():
    return _pair(0)


def test_forward_logits_and_aux_equal_the_reference(moe):
    cfg_j, cfg_t, pj, pt = moe
    toks = np.random.default_rng(8).integers(0, 512, (2, 13)).astype(np.int32)
    lj, _, aux_j = jm.forward(pj, cfg_j, jnp.asarray(toks), return_aux=True)
    lt, _, aux_t = tm.forward(pt, cfg_t, torch.from_numpy(toks),
                              return_aux=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert abs(float(aux_t) - float(aux_j)) <= AUX_TOL
    assert aux_t.dtype == torch.float32 and aux_t.dim() == 0


def test_moe_is_refused_outside_llama():
    cfg = get_preset("gpt2-tiny", num_experts=4)
    with pytest.raises(ValueError, match="llama"):
        tm.init_params(cfg, torch.Generator().manual_seed(0))


def test_lm_loss_and_a_trainer_step_equal_the_reference():
    """lm_loss = cross-entropy + 0.02 * aux on both stacks; one AdamW step
    from the same weights gives the same loss, and the next loss (after
    the update) agrees too."""
    cfg_j, cfg_t, pj, pt = _pair(0)  # the JAX step donates its params
    toks = np.random.default_rng(9).integers(0, 512, (2, 11)).astype(np.int32)
    lj = float(jt.lm_loss(pj, cfg_j, jnp.asarray(toks)))
    lt = float(tt.lm_loss(pt, cfg_t, torch.from_numpy(toks)))
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    aux = float(tm.forward(pt, cfg_t, torch.from_numpy(toks[:, :-1]),
                           return_aux=True)[2])
    no_aux = float(tt.lm_loss(pt, dataclasses.replace(
        cfg_t, moe_aux_loss_weight=0.0), torch.from_numpy(toks)))
    assert abs(lt - (no_aux + cfg_t.moe_aux_loss_weight * aux)) <= 1e-5
    trj = jt.Trainer(cfg_j, jt.default_optimizer(1e-2))
    trt = tt.Trainer(cfg_t, tt.default_optimizer(1e-2))
    step_j, step_t = trj.make_step(), trt.make_step()
    sj, st = trj.init(pj), trt.init(pt)
    for _ in range(2):
        pj, sj, loss_j = step_j(pj, sj, jnp.asarray(toks), None)
        pt, st, loss_t = step_t(pt, st, torch.from_numpy(toks))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(
        pt["blocks"]["mlp"]["router"].numpy(),
        np.asarray(pj["blocks"]["mlp"]["router"]), atol=5e-4)


def _prompts(seed):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 40)]
    pick = lambda n: [int(t) for t in rng.integers(0, 256, n)]  # noqa: E731
    return [shared + pick(5), pick(7), shared + pick(9), pick(30), pick(3),
            shared + pick(20)]


BUDGETS = [10, 7, 10, 6, 9, 8]
PAGED = dict(batch_slots=3, max_len=96, chunk_steps=4, paged_pages=24,
             page_size=16, prefix_cache=True)


@pytest.mark.parametrize("mode", ["paged", "paged_overlap", "chunked",
                                  "speculative"])
def test_batcher_streams_identical_to_the_reference(moe, mode):
    """Each mode on both stacks with the same engine loop: the
    dispatch-ahead loop (``overlap``) feeds idle rows other junk than the
    synchronous one, and junk rows claim expert capacity, so an MoE
    stream may differ between the two loops — in the reference as in the
    port (ROADMAP, Queue 3)."""
    cfg_j, cfg_t, pj, pt = moe
    kw = dict(PAGED, overlap=mode == "paged_overlap")
    if mode == "chunked":
        kw.update(prefill_chunk=16)
    if mode == "speculative":
        kw.update(spec_k=3)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "speculative":
        # The target drafts for itself: the verify window is [B, k+1].
        jkw.update(draft_params=pj, draft_cfg=cfg_j)
        tkw.update(draft_params=pt, draft_cfg=cfg_t)
    jbat = jb.ContinuousBatcher(cfg_j, pj, JaxByteTokenizer(), **jkw)
    tbat = tb.ContinuousBatcher(cfg_t, pt, ByteTokenizer(), **tkw)
    for prompt, n in zip(_prompts(10), BUDGETS):
        assert jbat.submit(prompt, max_new_tokens=n) == tbat.submit(
            prompt, max_new_tokens=n)
    want, got = jbat.run(), tbat.run()
    assert got == want
    assert [len(got[rid]) for rid in range(6)] == BUDGETS
    assert tbat.prefix_cache.hits == jbat.prefix_cache.hits
    assert tbat.prefix_cache.hits >= (0 if mode == "chunked" else 2)
    tbat.assert_pool_consistent()


def test_generate_text_equals_the_reference(moe):
    cfg_j, cfg_t, pj, pt = moe
    rt = dict(max_decode_steps=8, max_seq_len=64)
    jeng = JaxEngine(cfg_j, JaxRuntimeConfig(**rt), pj)
    teng = InferenceEngine(cfg_t, RuntimeConfig(**rt), pt, device="cpu")
    prompts = ["hello", "a longer prompt of text", "mid size"]
    want, got = jeng.generate_text(prompts), teng.generate_text(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.text == want.text


@pytest.fixture(scope="module")
def moe_int4_store(tmp_path_factory):
    from distributed_llms_tpu.checkpoint import store as jstore

    cfg = jax_preset("moe-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(11), cfg)
    path = str(tmp_path_factory.mktemp("moe_int4"))
    jstore.save_shards(params, path, num_shards=2, model_config=cfg,
                       quantization="int4")
    return path


def test_int4_store_serves_quantized_as_the_reference(moe_int4_store):
    jeng = JaxEngine.from_store(moe_int4_store,
                                rt=JaxRuntimeConfig(serve_quantized=True))
    teng = InferenceEngine.from_store(
        moe_int4_store, rt=RuntimeConfig(serve_quantized=True), device="cpu")
    mlp = teng.params["blocks"]["mlp"]
    assert isinstance(mlp["w_gate"], QuantizedTensor)
    assert mlp["w_gate"].data.dim() == 4 and mlp["w_gate"].bits == 4
    assert isinstance(mlp["router"], QuantizedTensor)
    assert isinstance(teng.params["blocks"]["attn"]["wo"], QuantizedTensor)
    jbat = jb.ContinuousBatcher(jeng.cfg, jeng.params, JaxByteTokenizer(),
                                overlap=False, **PAGED)
    tbat = tb.ContinuousBatcher(teng.cfg, teng.params, ByteTokenizer(),
                                overlap=False, **PAGED)
    for prompt, n in zip(_prompts(12), BUDGETS):
        jbat.submit(prompt, max_new_tokens=n)
        tbat.submit(prompt, max_new_tokens=n)
    assert tbat.run() == jbat.run()


def test_int4_self_draft_builds_for_moe(moe):
    _, cfg_t, _, pt = moe
    eng = InferenceEngine(cfg_t, RuntimeConfig(), pt, device="cpu")
    eng.attach_draft(quantize_bits=4)
    dm = eng.draft_params["blocks"]["mlp"]
    assert dm["w_gate"].bits == 4 and dm["w_gate"].data.shape == (2, 4, 32, 128)
    assert dm["router"].bits == 4
    b = eng.continuous_batcher(speculative=True, batch_slots=2, max_len=64,
                               paged_pages=12, page_size=16)
    rid = b.submit(_prompts(13)[1], max_new_tokens=6)
    assert len(b.run()[rid]) == 6
