"""The port's dispatch-ahead engine loop (``overlap``) against its own
synchronous loop and against the JAX package, on the CPU.

- Temperature-0 streams are identical with the overlap on and off, and
  identical to the JAX ``ContinuousBatcher`` with ``overlap=True``, in four
  modes: paged with the prefix cache, contiguous, contiguous with a sliding
  window (prompts past it), and int8 pages.  Logprobs: on and off equal to
  the bit; against the JAX package within the port's model tolerance
  (atol = rtol = 1e-4, tests/test_torch_model.py).
- The loop engages: chunks dispatched ahead are counted (> 0, all but the
  first of a steady span), each with a device gap of 0, one carry sync a
  span, no ghost chunk on a budget-bounded run, the ``batcher.overlap.*``
  metrics move.
- Sync triggers: an arrival mid-span is admitted at the next sync (with
  its solo stream), a cancel mid-span stops the row, growth under pool
  pressure syncs and preempts with identical streams.
- After an all-EOS chunk the ghost behind it refunds its draws: a later
  sampled request's stream equals the overlap-off one.
- ``_prehash_queued`` fills queued requests' digests; deliveries to
  ``on_tokens`` are identical on and off.
- Plumbing: ``RuntimeConfig().overlap`` is True, the engine and
  ``dlt-serve-torch`` follow it, ``--overlap off`` turns it off.

The contracts mirror the JAX package's tests/runtime/test_overlap.py.
float32 on the CPU, llama-tiny width (4 layers, d_model 64, GQA 4/2),
vocab 512, weights drawn with numpy and loaded into both stacks
(``checkpoint/from_jax.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime.tokenizer import ByteTokenizer as JaxByteTokenizer
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)
TOK = ByteTokenizer()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_weights(seed=0, **overrides):
    """(cfg_j, cfg_t, params_j, params_t): one numpy-drawn tree in both
    stacks — each leaf normal at the JAX initializer's scale, norms 1."""
    cfg_j = jax_preset("llama-tiny", vocab_size=512, **overrides)
    cfg_t = get_preset("llama-tiny", vocab_size=512, **overrides)
    rng = np.random.default_rng(seed)
    shapes = jm.init_params(jax.random.key(seed), cfg_j)

    def draw(leaf):
        a = np.asarray(leaf)
        if a.std() == 0:
            return a
        return (rng.standard_normal(a.shape) * a.std()).astype(a.dtype)

    tree = jax.tree.map(draw, shapes)
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, cfg_t, device="cpu"))


@pytest.fixture(scope="module")
def weights():
    return numpy_weights()


@pytest.fixture(scope="module")
def windowed():
    return numpy_weights(sliding_window=8)


def prompts(seed, n_long=0):
    rng = np.random.default_rng(seed)
    pick = lambda n: [int(t) for t in rng.integers(1, 256, n)]  # noqa: E731
    shared = pick(40)
    out = [shared + pick(5), pick(7), shared + pick(9), pick(30), pick(3)]
    return out + [pick(45) for _ in range(n_long)]


PAGED = dict(paged_pages=24, page_size=16, prefix_cache=True)
MODES = {
    "paged_prefix_cache": ("weights", PAGED),
    "contiguous": ("weights", {}),
    "windowed": ("windowed", {}),
    "int8_pages": ("weights", {**PAGED, "kv_bits": 8}),
}
BUDGETS = [17, 9, 23, 12, 6, 14]


def port(w, overlap, **kw):
    kw = {"batch_slots": 3, "max_len": 96, "chunk_steps": 4, **kw}
    return tb.ContinuousBatcher(w[1], w[3], TOK, eos_id=TOK.eos_id,
                                pad_id=TOK.pad_id, overlap=overlap, **kw)


def drive(bat, reqs, **submit_kw):
    rids = [bat.submit(p, max_new_tokens=n, **submit_kw) for p, n in reqs]
    res = bat.run()
    return ([res[r] for r in rids],
            [bat.result_logprobs[r] for r in rids])


@pytest.mark.parametrize("mode", list(MODES))
def test_streams_identical_on_off_and_to_jax(mode, request):
    w = request.getfixturevalue(MODES[mode][0])
    kw = MODES[mode][1]
    reqs = list(zip(prompts(1, n_long=1), BUDGETS))
    jbat = jb.ContinuousBatcher(
        w[0], w[2], JaxByteTokenizer(), batch_slots=3, max_len=96,
        chunk_steps=4, eos_id=TOK.eos_id, pad_id=TOK.pad_id, overlap=True,
        **kw)
    want_toks, want_lps = drive(jbat, reqs)
    b_on = port(w, True, **kw)
    on_toks, on_lps = drive(b_on, reqs)
    b_off = port(w, False, **kw)
    off_toks, off_lps = drive(b_off, reqs)
    assert on_toks == off_toks == want_toks
    assert [len(t) for t in on_toks] == BUDGETS
    assert on_lps == off_lps  # the same chunks, bit for bit
    for got, want in zip(on_lps, want_lps):
        np.testing.assert_allclose(got, want, **TOL)
    assert b_on.overlap_stats["dispatched_ahead"] > 0
    assert b_off.overlap_stats["dispatched_ahead"] == 0
    if b_on.prefix_cache is not None:
        assert (b_on.prefix_cache.hit_tokens == b_off.prefix_cache.hit_tokens
                == jbat.prefix_cache.hit_tokens > 0)
    b_on.assert_pool_consistent()


def test_dispatch_ahead_engages_and_counts(weights):
    """One steady row, nothing queued: every chunk but the first is
    dispatched ahead with a device gap of 0, the span ends in one carry
    sync, and no ghost chunk runs past the budget."""
    ahead0 = METRICS.get_counter("batcher.overlap.dispatched_ahead")
    syncs0 = METRICS.get_counter("batcher.overlap.carry_syncs")
    b_off = port(weights, False)
    drive(b_off, [(prompts(2)[0], 33)])
    b_on = port(weights, True)
    drive(b_on, [(prompts(2)[0], 33)])
    s = b_on.overlap_stats
    assert s["chunks"] == b_off.overlap_stats["chunks"] == 8  # 32 / 4
    assert s["dispatched_ahead"] == s["chunks"] - 1
    assert s["carry_syncs"] == 1
    assert s["device_gap_s"] == 0.0 and s["gap_samples"] == s["chunks"] - 1
    assert s["host_lag_s"] > 0.0
    assert b_off.overlap_stats["dispatched_ahead"] == 0
    assert METRICS.get_counter(
        "batcher.overlap.dispatched_ahead") - ahead0 == s["dispatched_ahead"]
    assert METRICS.get_counter("batcher.overlap.carry_syncs") - syncs0 == 1
    text = METRICS.prometheus_text()
    assert "batcher_overlap_dispatched_ahead" in text
    assert "batcher_overlap_device_gap_seconds" in text


def test_arrival_mid_span_syncs_and_admits(weights):
    """A request submitted from the delivery callback (a dispatched-ahead
    chunk's host window) is admitted at the next sync, with the stream it
    has alone."""
    late_prompt = prompts(3)[1]
    solo = port(weights, True)
    r = solo.submit(late_prompt, max_new_tokens=8)
    want_late = solo.run()[r]
    bat = port(weights, True)
    first = bat.submit(prompts(3)[0], max_new_tokens=24)
    late = []

    def cb(rid, toks, done, lps):
        if rid == first and not late and len(bat.rows[0].emitted) >= 9:
            late.append(bat.submit(late_prompt, max_new_tokens=8))

    res = bat.run(on_tokens=cb)
    assert late and res[late[0]] == want_late
    assert bat.overlap_stats["carry_syncs"] >= 2  # the arrival split it


def test_cancel_mid_span_stops_row(weights):
    """cancel_row from the callback while the carry is on the device: the
    span syncs at the next boundary (the device still runs the row until
    then, writing into pages the cancel released), the row stops, the
    other row keeps its solo stream, and the pool audits clean."""
    other_prompt = prompts(4)[3]
    solo = port(weights, True, **PAGED)
    r = solo.submit(other_prompt, max_new_tokens=40)
    want_other = solo.run()[r]
    bat = port(weights, True, **PAGED)
    rid = bat.submit(prompts(4)[1], max_new_tokens=64)
    other = bat.submit(other_prompt, max_new_tokens=40)
    seen = []

    def cb(r, toks, done, lps):
        if r == rid:
            seen.extend(toks)
            if len(seen) >= 6 and bat.rows[0].rid == rid:
                bat.cancel_row(rid)

    res = bat.run(on_tokens=cb)
    assert 6 <= len(res[rid]) <= 6 + 3 * bat.chunk_steps
    assert res[other] == want_other
    # The cancel ended its span: one sync for it, one at the end.
    assert bat.overlap_stats["carry_syncs"] >= 2
    assert not bat.active.any() and all(r.rid is None for r in bat.rows)
    bat.assert_pool_consistent()


def test_growth_and_preemption_exact_under_pressure(weights):
    """A pool too small for both rows' full depth: growth needs pressure,
    the span syncs, rows preempt for exact recompute — identical streams
    on and off and to the JAX batcher with the overlap on."""
    reqs = [([65] * 20, 40), ([66] * 25, 40)]
    kw = dict(paged_pages=8, page_size=16, prefix_cache=True, batch_slots=2)
    jbat = jb.ContinuousBatcher(
        weights[0], weights[2], JaxByteTokenizer(), max_len=96,
        chunk_steps=4, eos_id=TOK.eos_id, pad_id=TOK.pad_id, overlap=True,
        **kw)
    want, _ = drive(jbat, reqs)
    on, _ = drive(b_on := port(weights, True, **kw), reqs)
    off, _ = drive(port(weights, False, **kw), reqs)
    assert on == off == want
    assert b_on.preemptions == jbat.preemptions > 0
    b_on.assert_pool_consistent()


def test_rng_stream_aligned_after_eos_ghost(weights):
    """A sampled row hits EOS mid-span: the chunk dispatched behind the one
    where every row died is a GHOST, and its draws are refunded, so a LATER
    sampled request gives the same tokens with the overlap on and off."""
    first_prompt, second_prompt = prompts(5)[0], prompts(5)[1]

    def leg(overlap, eos_id):
        bat = port(weights, overlap)
        bat.eos_id = eos_id
        r1 = bat.submit(first_prompt, max_new_tokens=33, temperature=0.9)
        first = bat.run()[r1]
        r2 = bat.submit(second_prompt, max_new_tokens=12, temperature=0.9)
        return first, bat.run()[r2], bat

    # A token the sampled stream emits mid-span becomes the EOS id.
    probe, _, _ = leg(False, -1)
    eos_tok = probe[9]
    first_off, second_off, b_off = leg(False, eos_tok)
    first_on, second_on, b_on = leg(True, eos_tok)
    assert first_on == first_off
    assert first_on[-1] == eos_tok and len(first_on) < 33  # EOS really hit
    # The ghost ran (one chunk more than the synchronous loop) and drew
    # noise, and the sampled follow-up is identical all the same.
    assert b_on.overlap_stats["chunks"] == b_off.overlap_stats["chunks"] + 1
    assert second_on == second_off


def test_per_request_sampling_exact(weights):
    """Per-row sampling with a seeded generator: the span plan keeps one
    program and the draws are chunk-aligned, so sampled outputs match."""
    reqs = [(prompts(6)[0], 12), (prompts(6)[1], 12)]
    on = drive(port(weights, True), reqs, temperature=0.8, top_k=7)
    off = drive(port(weights, False), reqs, temperature=0.8, top_k=7)
    assert on == off


def test_streaming_deliveries_identical(weights):
    """The on_tokens sequence — rids, token groups, done flags, logprobs
    — is identical on and off (a delivery moves one dispatch later in
    time, never in content)."""
    streams = []
    for overlap in (False, True):
        bat = port(weights, overlap)
        sink = []
        for p, n in ((prompts(7)[0], 10), (prompts(7)[1], 14)):
            bat.submit(p, max_new_tokens=n)
        bat.run(on_tokens=lambda rid, t, d, lp, s=sink:
                s.append((rid, tuple(t), d, tuple(lp or []))))
        streams.append(sink)
    assert streams[0] == streams[1]


def test_prehash_fills_queued_digests(weights):
    """The overlapped host window pre-hashes queued prompts; the admission
    then serves the same hit (pre-hashing only moves when the hash runs)."""
    bat = port(weights, True, **PAGED)
    bat.submit([7] * 40, max_new_tokens=4)
    req = bat.queue_snapshot()[0]
    assert req.digests is None
    bat._prehash_queued()
    want = bat._page_digests(req.ids, len(req.ids) // 16)
    assert req.digests == want == jb.PrefixCache.page_digests(
        req.ids, 16, len(req.ids) // 16)
    bat._prehash_queued()  # idempotent
    assert req.digests == want
    assert len(bat.run()[req.rid]) == 4
    bat.assert_pool_consistent()


def test_config_and_cli_plumbing():
    """``runtime.overlap`` defaults to True, as in the reference; the engine
    and the CLI follow it, an explicit argument or ``--overlap off``
    wins."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    assert RuntimeConfig().overlap is True
    eng = InferenceEngine.from_preset("llama-tiny", device="cpu",
                                      vocab_size=512)
    assert eng.continuous_batcher(batch_slots=2, max_len=64).overlap
    assert not eng.continuous_batcher(batch_slots=2, max_len=64,
                                      overlap=False).overlap
    base = ["--preset", "llama-tiny", "--device", "cpu", "--slots", "2",
            "--max-len", "64", "--port", "0", "--host", "127.0.0.1"]
    assert serve_main.parser().parse_args(base).overlap is None
    assert serve_main.build_server(
        serve_main.parser().parse_args(base)).batcher.overlap
    assert not serve_main.build_server(serve_main.parser().parse_args(
        base + ["--overlap", "off"])).batcher.overlap
