"""The port's chunked prefill, mixed fused step and token budget against
monolithic admission and against the JAX package, on the CPU.

- Chunked admission (chunks of 3, 8 and 16 tokens) gives temperature-0
  streams identical to monolithic admission in the port and to the JAX
  package's chunked batcher; logprobs within float drift of monolithic
  (the chunks reduce the same attention in other shapes: 1e-3, the JAX
  package's own bound in tests/runtime/test_chunked_prefill.py) and within
  the port's model tolerance of the JAX chunked run (1e-4).
- A chunked paged admission on an automatic prefix hit seeds its row from
  the cached pages and bites only the suffix; the hit is accounted as in
  the JAX package.
- ``prefill_concurrency=2`` interleaves two long prompts; 1 serializes.
- A cancel mid-prefill releases the retained pages
  (``assert_pool_consistent``) and frees the slot.
- The guards raise with the reference's messages.
- The mixed schedule equals the alternate one (contiguous and paged with
  the prefix cache), ``token_budget`` auto-chunks, and decode rows emit a
  token at every fused step while a prefill rides (no stall round).
- A windowed contiguous prompt chunked past its window equals monolithic
  and the JAX package.

The contracts mirror the JAX package's tests/runtime/test_chunked_prefill.py
and tests/runtime/test_mixed_step.py.  float32 on the CPU, llama-tiny
width, vocab 512, numpy-drawn weights in both stacks.
"""

import numpy as np
import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

from test_torch_overlap import TOK, TOL, numpy_weights

DRIFT = 1e-3  # chunked vs monolithic logprobs


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return numpy_weights(seed=1)


@pytest.fixture(scope="module")
def windowed():
    return numpy_weights(seed=1, sliding_window=8)


def seq(start, n):
    return [(start + 7 * i) % 250 + 1 for i in range(n)]


REQS = [(seq(7, 20), 6), ([4, 4, 4], 5), (seq(40, 35), 8), ([11, 12], 9)]


def port(w, **kw):
    kw = {"batch_slots": 2, "max_len": 96, "chunk_steps": 4, **kw}
    return tb.ContinuousBatcher(w[1], w[3], TOK, eos_id=TOK.eos_id,
                                pad_id=TOK.pad_id, **kw)


def jax_batcher(w, **kw):
    kw = {"batch_slots": 2, "max_len": 96, "chunk_steps": 4, **kw}
    return jb.ContinuousBatcher(w[0], w[2], JaxByteTokenizer(),
                                eos_id=TOK.eos_id, pad_id=TOK.pad_id, **kw)


def drive(bat, reqs):
    rids = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
    res = bat.run()
    return [res[r] for r in rids], [bat.result_logprobs[r] for r in rids]


def close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=atol)


@pytest.mark.parametrize("chunk", [3, 8, 16])
def test_chunked_matches_monolithic_and_jax(weights, chunk):
    """More requests than slots, prompts that chunk and ones that do not:
    every stream equals monolithic admission and the JAX chunked run."""
    mono, mono_lps = drive(port(weights), REQS)
    c0 = METRICS.get_counter("batcher.prefill_chunks")
    got, got_lps = drive(port(weights, prefill_chunk=chunk), REQS)
    bites = METRICS.get_counter("batcher.prefill_chunks") - c0
    want, want_lps = drive(jax_batcher(weights, prefill_chunk=chunk), REQS)
    assert got == mono == want
    assert bites >= -(-35 // chunk)  # the 35-token prompt really chunked
    close(got_lps, mono_lps, DRIFT)
    close(got_lps, want_lps, TOL["atol"])


def test_chunked_paged_prefix_hit(weights):
    """A chunked paged admission whose leading pages are cached seeds its
    row from them and bites only the suffix: the JAX package's hit
    accounting, monolithic streams, a clean pool."""
    shared = seq(3, 36)
    first = (shared + [7, 1, 9], 6)
    second = (shared + [4, 4, 2, 8], 5)
    mono, _ = drive(port(weights), [first, second])
    kw = dict(prefill_chunk=6, paged_pages=16, page_size=16,
              prefix_cache=True)
    legs = []
    for bat in (port(weights, **kw), jax_batcher(weights, **kw)):
        r1 = bat.submit(first[0], max_new_tokens=first[1])
        out = [bat.run()[r1]]
        c0 = METRICS.get_counter("batcher.prefill_chunks")
        r2 = bat.submit(second[0], max_new_tokens=second[1])
        out.append(bat.run()[r2])
        legs.append((out, bat.prefix_cache.hit_tokens,
                     bat.prefix_cached_tokens[r2]))
        bat.assert_pool_consistent()
        if isinstance(bat, tb.ContinuousBatcher):
            # 2 cached pages (32 tokens); the 8-token suffix in 2 bites.
            assert METRICS.get_counter("batcher.prefill_chunks") - c0 == 2
    (got, hits, cached), (want, jhits, jcached) = legs
    assert got == want == mono
    assert hits == jhits == 32 and cached == jcached == 32


def test_prefill_concurrency_interleaves_long_prompts(weights):
    """Two long prompts chunk at once under prefill_concurrency=2 (both
    pending after one round); 1 keeps one in flight.  Streams unchanged."""
    reqs = [(seq(7, 20), 6), (seq(40, 22), 5), ([4, 4, 4], 7)]
    mono, _ = drive(port(weights, batch_slots=3), reqs)
    bat = port(weights, batch_slots=3, prefill_chunk=3)
    rids = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
    bat._admit_pending()
    assert len(bat._prefills) == 2
    assert sum(r.prefilling for r in bat.rows) == 2
    res = bat.run()
    assert [res[r] for r in rids] == mono
    one = port(weights, batch_slots=3, prefill_chunk=3, prefill_concurrency=1)
    for p, n in reqs[:2]:
        one.submit(p, max_new_tokens=n)
    one._admit_pending()
    assert len(one._prefills) == 1
    assert list(one.run().values()) == mono[:2]


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_mid_prefill_releases(weights, paged):
    """A cancel while the prompt still chunks drops the transient row,
    releases the cached pages it retained, frees the slot; the next request
    has its solo stream."""
    kw = dict(paged_pages=16, page_size=16, prefix_cache=True) if paged \
        else {}
    bat = port(weights, batch_slots=1, prefill_chunk=6, **kw)
    shared = seq(5, 36)
    if paged:  # publish the shared pages, so the prefill retains two
        r0 = bat.submit(shared + [1], max_new_tokens=2)
        bat.run()
    rid = bat.submit(shared + [9, 9, 9], max_new_tokens=4)
    bat._admit_pending()  # one bite of the prompt: still pending
    assert bat.rows[0].prefilling and bat._prefills
    assert len(bat.rows[0].pages) == (2 if paged else 0)
    assert bat.cancel_row(rid)
    assert not bat._prefills and bat.rows[0].rid is None
    assert bat.results[rid] == []
    bat.assert_pool_consistent()
    follow = bat.submit([4, 4, 4], max_new_tokens=5)
    solo = port(weights, batch_slots=1)
    srid = solo.submit([4, 4, 4], max_new_tokens=5)
    assert bat.run()[follow] == solo.run()[srid]
    bat.assert_pool_consistent()
    if paged:
        assert r0 in bat.results


def test_guards(weights):
    """The reference's checks and messages; the engine plumbs the knobs."""
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        port(weights, prefill_chunk=0)
    with pytest.raises(ValueError, match="prefill_concurrency must be >= 1"):
        port(weights, prefill_concurrency=0)
    with pytest.raises(ValueError, match="token_budget must be >= 1"):
        port(weights, token_budget=0)
    with pytest.raises(ValueError, match="unknown schedule"):
        port(weights, schedule="fifo")
    eng = InferenceEngine.from_preset("llama-tiny", device="cpu",
                                      vocab_size=512)
    cb = eng.continuous_batcher(batch_slots=2, max_len=64, prefill_chunk=4,
                                prefill_concurrency=1)
    assert cb.prefill_chunk == 4 and cb.prefill_concurrency == 1
    prompt = "hello world, a long-ish prompt"
    rid = cb.submit(prompt, max_new_tokens=5)
    plain = eng.continuous_batcher(batch_slots=2, max_len=64)
    prid = plain.submit(prompt, max_new_tokens=5)
    assert cb.run()[rid] == plain.run()[prid]
    # token_budget=0 is the config's "off" spelling.
    assert eng.continuous_batcher(batch_slots=2, max_len=64,
                                  token_budget=0).sched.token_budget is None


LONG = seq(9, 70)
MIXED_REQS = [(LONG, 10), ([30, 31, 32], 8), (LONG[:55], 12)]


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_matches_alternate(weights, paged):
    """The fused mixed step and the serialized alternate rounds: identical
    streams (and to monolithic and to the JAX mixed run); the mixed leg
    really fused and the alternate one really stalled."""
    kw = dict(paged_pages=24, page_size=16, prefix_cache=True) if paged \
        else {}
    mono, _ = drive(port(weights, **kw), MIXED_REQS)
    s0 = METRICS.get_counter("batcher.sched.stall_rounds")
    alt, _ = drive(port(weights, schedule="alternate", prefill_chunk=8,
                        **kw), MIXED_REQS)
    stalls = METRICS.get_counter("batcher.sched.stall_rounds") - s0
    b0 = METRICS.get_counter("batcher.sched.budget_tokens")
    s1 = METRICS.get_counter("batcher.sched.stall_rounds")
    bm = port(weights, schedule="mixed", prefill_chunk=8, **kw)
    mixed, _ = drive(bm, MIXED_REQS)
    assert METRICS.get_counter("batcher.sched.stall_rounds") == s1
    want, _ = drive(jax_batcher(weights, schedule="mixed", prefill_chunk=8,
                                **kw), MIXED_REQS)
    assert alt == mixed == mono == want
    assert stalls > 0
    assert METRICS.get_counter("batcher.sched.budget_tokens") > b0
    bm.assert_pool_consistent()


def test_token_budget_auto_chunks(weights):
    """A token budget alone (no prefill_chunk) chunks prompts longer than
    it, and resizes bites; streams equal monolithic and the JAX run."""
    mono, _ = drive(port(weights), MIXED_REQS)
    c0 = METRICS.get_counter("batcher.prefill_chunks")
    bat = port(weights, token_budget=16)
    assert bat.sched.chunk_threshold() == 16
    got, _ = drive(bat, MIXED_REQS)
    assert METRICS.get_counter("batcher.prefill_chunks") - c0 >= 70 // 16
    want, _ = drive(jax_batcher(weights, token_budget=16), MIXED_REQS)
    budgeted, _ = drive(port(weights, prefill_chunk=8, token_budget=12),
                        MIXED_REQS)
    assert got == mono == want == budgeted


def test_decode_rows_emit_every_fused_step(weights):
    """While a long prompt prefills beside live decode rows under the mixed
    schedule, every fused step delivers chunk_steps tokens to each live
    row: no decode round is spent on a serialized bite."""
    bat = port(weights, batch_slots=3, prefill_chunk=6, chunk_steps=4,
               overlap=False)
    busy = bat.submit([5, 6, 7], max_new_tokens=60)
    bat.submit([8, 9], max_new_tokens=60)
    deliveries = []
    started = []

    def cb(rid, toks, done, lps):
        if rid == busy:
            deliveries.append((len(toks), bool(bat._prefills)))
            if not started and len(bat.rows[0].emitted) >= 5:
                started.append(bat.submit(LONG, max_new_tokens=4))

    s0 = METRICS.get_counter("batcher.sched.stall_rounds")
    res = bat.run(on_tokens=cb)
    assert started and len(res[started[0]]) == 4
    riding = [n for n, pending in deliveries if pending]
    assert len(riding) >= 70 // 6 - 1  # one delivery per fused step
    assert all(n == 4 for n in riding)
    assert METRICS.get_counter("batcher.sched.stall_rounds") == s0


def test_windowed_prompt_chunked_past_its_window(windowed):
    """Sliding window 8, a 60-token prompt chunked by 8 (every bite's keys
    reach back past the window): monolithic and the JAX package agree."""
    reqs = [(seq(11, 60), 10), ([3, 1, 4], 6)]
    mono, _ = drive(port(windowed), reqs)
    got, _ = drive(port(windowed, prefill_chunk=8), reqs)
    want, _ = drive(jax_batcher(windowed, prefill_chunk=8), reqs)
    assert got == mono == want
