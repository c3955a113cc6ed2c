"""One-shot generation in the port against the JAX package, on the CPU.

- ``runtime/generate.py``'s ``generate_tokens`` (one prefill of the
  right-padded batch, then the decode loop writing slot T + j for every
  row under the gapped mask) gives temperature-0 tokens EQUAL to the
  reference's: a ragged batch, an EOS that freezes a row to pad_id
  mid-stream, a sliding window of 4 over a ragged batch (the window
  compared by ``window_key_positions``, not by slot), and a flash model
  (its prefill through the dynamic flash kernel's route, the reference's
  Pallas kernel in interpret mode).
- ``InferenceEngine.generate_text`` equals the reference engine's, at the
  same bucketed width (``_bucket_prompt`` pads both alike), with the
  reference's metric names; the budget check, the mesh decode's refusal
  and the ``rt.profile_dir`` trace.
- Sampling: top-k 1 and a vanishing top-p reduce to greedy, the same seed
  repeats its stream, and every sampled token lies in the top-k support.
- ``core/profiling.py``: ``StepTimer`` with an injected clock, and
  ``record_memory_stats`` (nothing without CUDA).

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32;
weights from the reference's ``init_params`` through
``params_from_numpy``, prompts from numpy seeds.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.core.config import RuntimeConfig as JaxRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import generate as jgen
from distributed_llms_tpu.runtime.engine import InferenceEngine as JaxEngine
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core import profiling
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import generate as tgen
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(seed=0, **overrides):
    """(cfg_j, cfg_t, params_j, params_t): the reference's init_params in
    both stacks."""
    cfg_j = jax_preset("llama-tiny", vocab_size=512, **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, **overrides)
    pj = jm.init_params(jax.random.key(seed), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def ragged_prompts(seed, lens, width=None):
    rng = np.random.default_rng(seed)
    t = width or max(lens)
    arr = np.zeros((len(lens), t), np.int32)
    for i, n in enumerate(lens):
        arr[i, :n] = rng.integers(1, 512, n)
    return arr, np.asarray(lens, np.int32)


def both_generate(w, prompt, lens, n, **kw):
    cfg_j, cfg_t, pj, pt = w
    want = np.asarray(jgen.generate_tokens(
        pj, cfg_j, jnp.asarray(prompt), jnp.asarray(lens), jax.random.key(0),
        max_new_tokens=n, **kw))
    got = tgen.generate_tokens(pt, cfg_t, torch.from_numpy(prompt),
                               torch.from_numpy(lens), None,
                               max_new_tokens=n, **kw)
    return got.numpy(), want


@pytest.mark.parametrize("case", ["ragged", "eos", "window", "flash_window"])
def test_generate_tokens_equal_the_reference(case):
    """Temperature 0: the port's tokens equal the reference's exactly."""
    overrides = {"window": {"sliding_window": 4},
                 "flash_window": {"sliding_window": 4,
                                  "attn_impl": "flash"}}.get(case, {})
    w = weights(1, **overrides)
    prompt, lens = ragged_prompts(1, [3, 9, 6], width=12)
    kw = dict(pad_id=0)
    if case == "eos":
        free, _ = both_generate(w, prompt, lens, 10, **kw)
        kw["eos_id"] = int(free[0, 3])  # row 0 stops mid-stream
    got, want = both_generate(w, prompt, lens, 10, **kw)
    assert got.dtype == np.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)
    if case == "eos":
        row = got[0].tolist()
        stop = row.index(kw["eos_id"])
        assert stop <= 3 and row[stop + 1:] == [0] * (9 - stop)


def test_windowed_ragged_rows_equal_their_solo_runs():
    """The gapped layout's window: each padded row of a windowed batch
    emits its own pad-free solo run (the reference's regression)."""
    _, cfg_t, _, pt = weights(2, sliding_window=3)
    prompts = [[7, 1, 9], [4, 4, 4, 4, 4, 4, 4, 4]]
    padded = torch.tensor([p + [0] * (8 - len(p)) for p in prompts])
    lens = torch.tensor([3, 8])
    batch = tgen.generate_tokens(pt, cfg_t, padded, lens, None,
                                 max_new_tokens=12)
    for i, p in enumerate(prompts):
        solo = tgen.generate_tokens(pt, cfg_t, torch.tensor([p]),
                                    torch.tensor([len(p)]), None,
                                    max_new_tokens=12)
        assert batch[i].tolist() == solo[0].tolist()


def test_sampled_generation_semantics():
    """Sampled streams are held to the reference's semantics, not its
    random bytes: top-k 1 and top-p -> 0 are greedy, one seed repeats
    itself, and each top-k 3 token lies in the 3 best of its step."""
    _, cfg_t, _, pt = weights(3)
    prompt, lens = ragged_prompts(3, [5, 7])
    p, n = torch.from_numpy(prompt), torch.from_numpy(lens)
    greedy = tgen.generate_tokens(pt, cfg_t, p, n, None, max_new_tokens=8)

    def gen(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return tgen.generate_tokens(pt, cfg_t, p, n, g, max_new_tokens=8,
                                    temperature=1.0, **kw)

    assert torch.equal(gen(1, top_k=1), greedy)
    assert torch.equal(gen(1, top_p=1e-6), greedy)
    assert torch.equal(gen(5, top_k=3), gen(5, top_k=3))
    sampled = gen(6, top_k=3)
    # Teacher-force the sampled stream: each token is in its step's top 3.
    from distributed_llms_tpu_torch.models import model as tm

    for r in range(2):
        ctx = torch.cat([p[r, :lens[r]], sampled[r]])[None]
        logits, _ = tm.forward(pt, cfg_t, ctx)
        top3 = torch.topk(logits[0, lens[r] - 1:-1], 3).indices
        assert (top3 == sampled[r][:, None].long()).any(dim=1).all()


def test_generate_wrapper_budget_and_mesh_decode():
    _, cfg_t, _, pt = weights(4)
    rt = RuntimeConfig(max_decode_steps=5, max_seq_len=16)
    out = tgen.generate(pt, cfg_t, rt, torch.tensor([[5, 6, 7]]))
    assert out.shape == (1, 5)
    with pytest.raises(ValueError, match="exceeds sequence limit 16"):
        tgen.check_sequence_budget(12, 5, rt, cfg_t)
    # A decode_fn takes over after the prefill and the first token, with
    # the reference's arguments (the pipelined mesh's wavefront loop).
    seen = {}

    def decode_fn(params, tok0, lens, t, cache, gen, n, *knobs):
        seen.update(tok0=tok0.tolist(), t=t, n=n, knobs=knobs,
                    slots=cache.k.shape[2])
        return torch.full((1, n), 7, dtype=torch.int32)

    out = tgen.generate_tokens(pt, cfg_t, torch.tensor([[5, 6]]),
                               torch.tensor([2]), None, 3, eos_id=9,
                               pad_id=1, decode_fn=decode_fn)
    assert out.tolist() == [[7, 7, 7]]
    first = tgen.generate_tokens(pt, cfg_t, torch.tensor([[5, 6]]),
                                 torch.tensor([2]), None, 1)
    assert seen == {"tok0": first[:, 0].tolist(), "t": 2, "n": 3,
                    "knobs": (0.0, 0, 1.0, 9, 1), "slots": 5}


def engines(w, **rt_kw):
    cfg_j, cfg_t, pj, pt = w
    return (JaxEngine(cfg_j, JaxRuntimeConfig(**rt_kw), pj),
            InferenceEngine(cfg_t, RuntimeConfig(**rt_kw), pt, device="cpu"))


@pytest.mark.parametrize("overrides", [{}, {"sliding_window": 4}])
def test_engine_generate_text_equals_the_reference(overrides):
    """``generate_text`` through the bucket ladder (prompts of 6-21
    tokens pad to T = 32 on both sides) equals the reference engine's
    tokens and texts; the metrics move under the reference's names."""
    jeng, teng = engines(weights(5, **overrides), max_decode_steps=7,
                         max_seq_len=64)
    prompts = ["hello", "a longer prompt of text", "mid size"]
    assert teng._bucket_prompt(teng._encode_rows(prompts, None)[0],
                               7).shape[1] == 32
    before = METRICS.snapshot()["counters"].get("engine.generated_tokens", 0)
    got = teng.generate_text(prompts)
    want = jeng.generate_text(prompts)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.text == want.text
    assert got.prompt_tokens == want.prompt_tokens == sum(
        len(p) + 1 for p in prompts)
    assert got.generated_tokens == 21 and got.tokens_per_second > 0
    snap = METRICS.snapshot()
    assert snap["counters"]["engine.generated_tokens"] == before + 21
    assert snap["histograms"]["engine.generate_seconds"]["count"] >= 1
    assert snap["histograms"]["engine.generate.step_seconds"]["count"] >= 1
    assert "engine.generate.tokens_per_second" in snap["gauges"]


def test_engine_budget_and_profile_trace(tmp_path):
    _, teng = engines(weights(6), max_decode_steps=4, max_seq_len=24)
    with pytest.raises(ValueError, match="exceeds sequence limit"):
        teng.generate_text(["x" * 22])
    teng.rt = RuntimeConfig(max_decode_steps=4, max_seq_len=24,
                            profile_dir=str(tmp_path / "trace"))
    teng.generate_text(["trace me"])
    names = os.listdir(tmp_path / "trace")
    assert len(names) == 1 and names[0].endswith(".json")


def test_step_timer_and_memory_stats():
    ticks = iter([10.0, 10.5, 20.0, 20.25])
    timer = profiling.StepTimer("engine.generate", clock=lambda: next(ticks))
    with timer.step(tokens=10):
        pass
    with timer.step(tokens=5):
        pass
    assert timer.steps == 2
    assert timer.tokens_per_second == pytest.approx(15 / 0.75)
    if not torch.cuda.is_available():
        assert profiling.record_memory_stats() == {}
