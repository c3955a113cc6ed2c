"""Speculative continuous batching in the port, on the CPU (the reference's
tests/runtime/test_spec_batcher.py and test_spec_paged.py cases).

- Temperature 0: the speculative batcher's streams equal the plain
  batcher's, exactly, for an unrelated 2-layer draft and for the int4
  self-draft, in each mode: contiguous, paged, an EOS inside a round with
  slots reused, a prefix-cache hit, a named prefix, int8 pages, the
  overlap on and off, swap preemption (the draft rebuilt at the restore),
  recompute preemption, requests at capacity, a windowed target
  (contiguous).  The pool-and-tier audit holds after each.
- Adaptive k: a cold draft's downshift is deterministic and exact,
  ``spec_adaptive_k=False`` never downshifts, a token budget clamps the
  rounds, the ``SpecMixedScheduler`` hooks, the scratch-tail geometry, and
  the ``batcher.spec.*`` counters accrue (and render on /metrics).
- Guards: per-request sampling overrides raise (400 over HTTP); explicit
  speculation with chunked prefill raises, inherited from the config it
  serves plain; a quantized-store engine with ``spec_decode`` serves plain;
  the engine's ``spec_decode`` attaches the int4 self-draft.
- Sampling: one round over 4096 identical rows at vocab 16 (temperature
  0.8, top-p 0.9), a second round for the rows that committed one token:
  the empirical distribution of the first committed token and of the first
  pair is within total variation 2 x E_bound of the target's warped
  distribution, computed exactly (E_bound = 0.5 * sum sqrt(p (1 - p) / N),
  a bound on the expected TV of N draws), at k_row = k and k_row = 1; the
  draft's own distribution lies farther than that (the test can fail).
  Per-seed determinism, and the sampled batcher's streams equal with the
  overlap on and off.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
random weights from ``torch.Generator`` seeds (no JAX here: nothing is
compared with the reference package).
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.models import model as tm
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import sampling
from distributed_llms_tpu_torch.runtime.engine import (InferenceEngine,
                                                       _quantize_blocks)
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer
from distributed_llms_tpu_torch.runtime.scheduler import (MixedScheduler,
                                                          Scheduler,
                                                          SpecMixedScheduler,
                                                          make_scheduler)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed, **overrides):
    cfg = get_preset("llama-tiny", vocab_size=512, **overrides)
    return cfg, tm.init_params(cfg, generator=torch.Generator().manual_seed(
        seed))


@pytest.fixture(scope="module")
def models():
    cfg, params = _params(0)
    dcfg, dparams = _params(99, num_layers=2)  # an unrelated draft
    self4 = {**params, "blocks": _quantize_blocks(params["blocks"], 4)}
    return cfg, params, dcfg, dparams, self4


def _mk(models, spec="unrelated", **kw):
    cfg, params, dcfg, dparams, self4 = models
    kw = {"batch_slots": 2, "max_len": 64, "chunk_steps": 4, **kw}
    if spec == "unrelated":
        kw.update(draft_params=dparams, draft_cfg=dcfg)
    elif spec == "self_int4":
        kw.update(draft_params=self4, draft_cfg=cfg)
    elif spec == "self":
        kw.update(draft_params=params, draft_cfg=cfg)
    if spec is not None:
        kw.setdefault("spec_k", 3)
    return tb.ContinuousBatcher(cfg, params, **kw)


def _run(b, reqs, **submit_kw):
    rids = [b.submit(ids, max_new_tokens=n, **submit_kw) for ids, n in reqs]
    res = b.run()
    b.assert_pool_consistent()
    return [res[r] for r in rids]


REQS = [([7, 1, 9, 4, 2], 9), ([4, 4, 4], 5), ([11, 12], 12), ([42], 7),
        ([3, 1], 1)]
PAGED = dict(paged_pages=24, page_size=16)
STORM = [([7, 1, 9, 2], 44), ([4, 4, 4, 4], 44), ([9, 8, 7, 3], 44)]
SHARED = list(range(100, 118))  # 18 tokens: two full 8-token pages


def _eos_case(models, draft):
    """EOS at a token the plain stream emits inside a round: rows end
    mid-round and their slots take the queued requests."""
    plain = _run(_mk(models, spec=None), REQS)
    eos = plain[0][3]
    got = _run(_mk(models, spec=draft, eos_id=eos), REQS)
    want = _run(_mk(models, spec=None, eos_id=eos), REQS)
    assert len(want[0]) == plain[0].index(eos) + 1
    return got, want


def _prefix_hit_case(models, draft):
    def leg(spec):
        b = _mk(models, spec=spec, paged_pages=30, page_size=8,
                prefix_cache=True)
        first = _run(b, [(SHARED + [11], 6)])
        second = _run(b, [(SHARED + [12], 6)])
        return first + second, b.prefix_cached_tokens[b.next_rid - 1]

    (got, got_hit), (want, want_hit) = leg(draft), leg(None)
    assert got_hit == want_hit == 16
    return got, want


def _named_prefix_case(models, draft, **mode):
    def leg(spec):
        b = _mk(models, spec=spec, **mode)
        b.register_prefix("sys", SHARED)
        return _run(b, REQS[:3], prefix="sys")
    return leg(draft), leg(None)


def _swap_case(models, draft):
    kw = dict(batch_slots=3, page_size=16)
    in0 = METRICS.get_counter("batcher.kv_swaps.in")
    b = _mk(models, spec=draft, paged_pages=9, host_pages=16, **kw)
    got = _run(b, STORM)
    assert b.preemptions >= 1
    assert METRICS.get_counter("batcher.kv_swaps.in") - in0 >= 1
    return got, _run(_mk(models, spec=None, paged_pages=22, **kw), STORM)


def _recompute_case(models, draft):
    kw = dict(batch_slots=3, page_size=16)
    b = _mk(models, spec=draft, paged_pages=9, **kw)
    got = _run(b, STORM)
    assert b.preemptions >= 1
    return got, _run(_mk(models, spec=None, paged_pages=22, **kw), STORM)


def _capacity_case(models, draft, **mode):
    reqs = [([5] * 10, 22), ([6, 7], 30)]  # prompt + budget == max_len
    return (_run(_mk(models, spec=draft, max_len=32, **mode), reqs),
            _run(_mk(models, spec=None, max_len=32, **mode), reqs))


def _windowed_case(models, draft):
    cfg, params = _params(7, sliding_window=8)
    w = (cfg, params, models[2], models[3],
         {**params, "blocks": _quantize_blocks(params["blocks"], 4)})
    reqs = [([3, 9, 27] * 5, 20), ([8] * 4, 16)]  # decodes past the window
    return _run(_mk(w, spec=draft), reqs), _run(_mk(w, spec=None), reqs)


def _plain_pair(models, draft, **kw):
    return (_run(_mk(models, spec=draft, **kw), REQS),
            _run(_mk(models, spec=None, **kw), REQS))


CASES = {
    "contiguous": lambda m, d: _plain_pair(m, d),
    "paged": lambda m, d: _plain_pair(m, d, **PAGED),
    "eos_mid_round_slot_reuse": _eos_case,
    "prefix_cache_hit": _prefix_hit_case,
    "named_prefix_paged": lambda m, d: _named_prefix_case(m, d, **PAGED),
    "named_prefix_contiguous": lambda m, d: _named_prefix_case(m, d),
    "int8_pages": lambda m, d: _plain_pair(m, d, kv_bits=8, **PAGED),
    "overlap_off": lambda m, d: _plain_pair(m, d, overlap=False, **PAGED),
    "overlap_on": lambda m, d: _plain_pair(m, d, overlap=True, **PAGED),
    "swap_preemption": _swap_case,
    "recompute_preemption": _recompute_case,
    "at_capacity_paged": lambda m, d: _capacity_case(
        m, d, paged_pages=9, page_size=8),
    "at_capacity_contiguous": lambda m, d: _capacity_case(m, d),
    "windowed_contiguous": _windowed_case,
}


@pytest.mark.parametrize("draft", ["unrelated", "self_int4"])
@pytest.mark.parametrize("case", list(CASES))
def test_greedy_streams_equal_the_plain_batcher(models, case, draft):
    got, want = CASES[case](models, draft)
    assert got == want


def test_self_draft_accepts_and_backfills(models):
    """The bf16-exact self-draft (the target itself) accepts every draft a
    round can commit: the backfill runs every round, and rounds equal
    ceil(budget / (k + 1)) for a lone row (the synchronous loop: the
    dispatch-ahead one may add a ghost round past the end)."""
    b = _mk(models, spec="self", spec_k=3, overlap=False, **PAGED)
    got = _run(b, [([7, 1, 9], 13)])
    assert got == _run(_mk(models, spec=None, **PAGED), [([7, 1, 9], 13)])
    assert b.spec_stats["rejected"] == 0
    assert b.spec_stats["rounds"] == 3  # 12 decode tokens, 4 a round


# -- adaptive k ----------------------------------------------------------------

def test_adaptive_k_downshift_is_deterministic_and_exact(models):
    reqs = [([7, 1, 9, 4, 2], 24), ([4, 4, 4], 20)]
    plain = _run(_mk(models, spec=None, **PAGED), reqs)

    def leg():
        b = _mk(models, spec_k=4, **PAGED)
        return _run(b, reqs), dict(b.spec_stats)

    (got1, stats1), (got2, stats2) = leg(), leg()
    assert got1 == got2 == plain
    assert stats1 == stats2
    assert stats1["downshifts"] >= 1 and stats1["rejected"] > 0


def test_adaptive_k_off_never_downshifts(models):
    reqs = [([7, 1, 9, 4, 2], 16)]
    b = _mk(models, spec_k=4, spec_adaptive_k=False, **PAGED)
    assert _run(b, reqs) == _run(_mk(models, spec=None, **PAGED), reqs)
    assert b.spec_stats["downshifts"] == 0


def test_token_budget_clamps_rounds(models):
    reqs = [([7, 1, 9], 12), ([5, 5], 12)]
    free = _run(_mk(models, spec="self", spec_k=4, **PAGED), reqs)
    d0 = METRICS.get_counter("batcher.spec.k_downshifts")
    b = _mk(models, spec="self", spec_k=4, token_budget=6, **PAGED)
    assert _run(b, reqs) == free
    assert b.spec_stats["downshifts"] >= 1
    assert METRICS.get_counter("batcher.spec.k_downshifts") > d0


def test_spec_round_k_policy_hooks():
    s = make_scheduler("mixed", speculative=True, token_budget=8)
    assert isinstance(s, SpecMixedScheduler)
    assert s.spec_round_k(4, (1.0, 1.0), 2) == [3, 3]  # 2 x (3+1) <= 8
    assert s.spec_round_k(4, (1.0, 0.1), 2) == [3, 1]
    assert s.spec_round_k(4, (0.0, 0.5), 1) == [1, 2]
    s2 = make_scheduler("mixed", speculative=True)
    assert s2.spec_round_k(4, (1.0, 0.4), 4) == [4, 2]
    s3 = make_scheduler("mixed", speculative=True, spec_adaptive=False)
    assert s3.spec_round_k(4, (0.0, 0.0), 2) == [4, 4]
    s4 = make_scheduler("alternate", speculative=True, token_budget=4)
    assert type(s4) is Scheduler
    assert s4.spec_round_k(4, (0.0,), 3) == [4]
    assert type(make_scheduler("mixed")) is MixedScheduler
    assert s.chunk_threshold() is None  # the draft admission cannot chunk


def test_scratch_tail_geometry(models):
    b = _mk(models, spec_k=3, **PAGED)
    assert b.pages_per_row == -(-(64 + 3 + 1) // 16) == 5
    assert b.draft_cache.k.shape[2] == 64 + 3 + 1
    assert _mk(models, spec=None, **PAGED).pages_per_row == 4
    assert _mk(models).cache.k.shape[2] == 68  # contiguous headroom
    with pytest.raises(ValueError, match="full-depth row"):
        _mk(models, spec_k=3, paged_pages=5, page_size=16)
    _mk(models, spec=None, paged_pages=5, page_size=16)  # plain fits


def test_spec_counters_accrue_and_render(models):
    from distributed_llms_tpu_torch.runtime.server import InferenceServer

    r0 = METRICS.get_counter("batcher.spec.rounds")
    a0 = METRICS.get_counter("batcher.spec.accepted_tokens")
    b = _mk(models, spec="self_int4", tokenizer=ByteTokenizer(), **PAGED)
    _run(b, [([7, 1, 9], 10)])
    assert METRICS.get_counter("batcher.spec.rounds") - r0 == \
        b.spec_stats["rounds"] > 0
    assert METRICS.get_counter("batcher.spec.accepted_tokens") - a0 == \
        b.spec_stats["accepted"] > 0
    assert 0.0 <= METRICS.get_gauge("batcher.spec.acceptance") <= 1.0
    text = METRICS.prometheus_text()
    for name in ("batcher_spec_rounds", "batcher_spec_accepted_tokens",
                 "batcher_spec_acceptance"):
        assert name in text
    assert InferenceServer(b).batcher.speculative


# -- guards ----------------------------------------------------------------------

def test_guards(models):
    cfg, params, dcfg, dparams, _ = models
    b = _mk(models, **PAGED)
    for kw in (dict(temperature=0.9), dict(top_p=0.5), dict(top_k=5)):
        with pytest.raises(ValueError, match="engine-wide"):
            b.submit([1, 2], max_new_tokens=4, **kw)
    b.submit([1, 2], max_new_tokens=4, temperature=0.0)  # the engine's own
    spec = dict(draft_params=dparams, draft_cfg=dcfg)
    with pytest.raises(ValueError, match="chunked prefill"):
        tb.ContinuousBatcher(cfg, params, max_len=64, prefill_chunk=8, **spec)
    with pytest.raises(ValueError, match="draft vocab"):
        tb.ContinuousBatcher(cfg, params, max_len=64, draft_params=dparams,
                             draft_cfg=get_preset("llama-tiny",
                                                  num_layers=2))
    with pytest.raises(ValueError, match="spec_k"):
        tb.ContinuousBatcher(cfg, params, max_len=64, spec_k=0, **spec)
    with pytest.raises(ValueError, match="draft_cfg"):
        tb.ContinuousBatcher(cfg, params, max_len=64, draft_params=dparams)


def _engine(rt, **kw):
    return InferenceEngine.from_preset("llama-tiny", rt=rt, device="cpu",
                                       vocab_size=512, **kw)


def test_engine_spec_decode_policy(caplog):
    rt = RuntimeConfig(spec_decode=True, spec_k=3)
    eng = _engine(rt)
    wq = eng.draft_params["blocks"]["attn"]["wq"]
    assert isinstance(wq, QuantizedTensor) and wq.bits == 4
    assert eng.draft_params["embed"]["wte"] is eng.params["embed"]["wte"]
    b = eng.continuous_batcher(batch_slots=2, max_len=64, paged_pages=24,
                               page_size=16)
    assert b.speculative and b.spec_k == 3
    plain = _engine(RuntimeConfig()).continuous_batcher(
        batch_slots=2, max_len=64, paged_pages=24, page_size=16)
    assert _run(b, REQS) == _run(plain, REQS)
    # Inherited from the config, speculation yields to chunked prefill.
    with caplog.at_level("WARNING"):
        b2 = eng.continuous_batcher(batch_slots=2, max_len=64,
                                    prefill_chunk=8)
    assert not b2.speculative
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.continuous_batcher(batch_slots=2, max_len=64, prefill_chunk=8,
                               speculative=True)
    # A sampled engine speculates only when asked.
    eng_t = _engine(RuntimeConfig(spec_decode=True, temperature=0.8))
    assert not eng_t.continuous_batcher(batch_slots=2, max_len=64).speculative
    assert eng_t.continuous_batcher(batch_slots=2, max_len=64,
                                    speculative=True).speculative
    with pytest.raises(ValueError, match="attach_draft"):
        _engine(RuntimeConfig()).continuous_batcher(speculative=True)
    with pytest.raises(ValueError, match="ragged_decode"):
        _engine(rt, ragged_decode=True)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(RuntimeConfig(spec_decode=True, spec_k=0))


def test_quantized_store_engine_serves_plain(models):
    cfg, params, _, _, self4 = models
    eng = InferenceEngine(cfg, RuntimeConfig(spec_decode=True), self4,
                          device="cpu")
    assert eng.draft_params is None and eng._serves_quantized()
    assert not eng.continuous_batcher(batch_slots=2, max_len=64).speculative
    with pytest.raises(ValueError, match="quantized"):
        eng.attach_draft(quantize_bits=4)
    eng.attach_draft(models[2], models[3])  # an explicit draft still works
    assert eng.continuous_batcher(batch_slots=2, max_len=64,
                                  speculative=True).speculative


async def _post(port, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(rest)


async def test_gateway_answers_400_to_a_sampling_override(models):
    from distributed_llms_tpu_torch.runtime.server import InferenceServer

    server = InferenceServer(_mk(models, spec="self_int4",
                                 tokenizer=ByteTokenizer(), **PAGED),
                             host="127.0.0.1", port=0)
    await server.start()
    try:
        bad = await _post(server.bound_port, {
            "prompt": "ab", "max_tokens": 4, "temperature": 0.7})
        good = await _post(server.bound_port, {"prompt": "ab",
                                               "max_tokens": 4})
    finally:
        await server.stop()
    assert bad[0] == 400 and "engine-wide" in bad[1]["error"]["message"]
    assert good[0] == 200 and good[1]["usage"]["completion_tokens"] == 4


# -- sampling ----------------------------------------------------------------

TEMP, TOP_P, N_ROWS, SK = 0.8, 0.9, 4096, 2


@pytest.fixture(scope="module")
def tiny16():
    cfg = get_preset("llama-tiny", vocab_size=16, num_layers=2)
    dcfg = get_preset("llama-tiny", vocab_size=16, num_layers=1)
    return (cfg, tm.init_params(cfg, generator=torch.Generator().manual_seed(3)),
            dcfg, tm.init_params(dcfg,
                                 generator=torch.Generator().manual_seed(4)))


PROMPT, T0 = [1, 2, 3], 5


def _exact(cfg, params):
    """The model's warped distribution of the first token after PROMPT +
    T0, and of the pair: P(t1, t2) = p(t1) p(t2 | t1), by full forwards."""
    def dist(ctx):
        logits, _ = tm.forward(params, cfg, torch.tensor(ctx))
        return torch.softmax(sampling.warp_logits(
            logits[:, -1], TEMP, 0, TOP_P), dim=-1).double()

    p1 = dist([PROMPT + [T0]])[0]
    p2 = dist([PROMPT + [T0, t] for t in range(cfg.vocab_size)])
    return p1.numpy(), (p1[:, None] * p2).numpy()


def _rows(cfg, params, n, s):
    """A contiguous cache of n identical rows holding PROMPT's KV."""
    row = tm.init_cache(cfg, 1, s)
    tm.forward(params, cfg, torch.tensor([PROMPT]),
               positions=torch.arange(len(PROMPT))[None], cache=row,
               cache_index=0)
    return tm.KVCache(k=row.k.expand(-1, n, -1, -1, -1).clone(),
                      v=row.v.expand(-1, n, -1, -1, -1).clone())


def _sampled_pairs(tiny16, seed, k_row, n=N_ROWS):
    cfg, params, dcfg, dparams = tiny16
    s = len(PROMPT) + 2 * (SK + 1) + 2
    cache, dcache = _rows(cfg, params, n, s), _rows(dcfg, dparams, n, s)
    carry = torch.tensor([[T0] * n, [len(PROMPT)] * n, [1] * n, [8] * n],
                         dtype=torch.int32)
    gen = torch.Generator().manual_seed(seed)
    got = []
    for _ in range(2):
        packed = tb.spec_chunk(params, cfg, dparams, dcfg, cache, dcache,
                               carry, gen, SK, temperature=TEMP, top_p=TOP_P,
                               k_row=torch.full((n,), k_row, dtype=torch.int32))
        toks, _, m, c = tb.unpack_chunk(packed.numpy(), n, SK + 1,
                                        commits=True)
        got.append((toks.copy(), m.copy()))
        carry = torch.from_numpy(c.copy())
    (t1, m1), (t2, _) = got
    assert (m1 >= 1).all()
    second = np.where(m1 >= 2, t1[:, 1], t2[:, 0])
    return t1[:, 0], second


def _tv(counts, p):
    return 0.5 * np.abs(counts / counts.sum() - p).sum()


def _e_bound(p, n):
    return 0.5 * np.sqrt(p * (1 - p) / n).sum()


@pytest.mark.parametrize("k_row", [SK, 1])
def test_sampled_round_keeps_the_target_distribution(tiny16, k_row):
    cfg, params, dcfg, dparams = tiny16
    v = cfg.vocab_size
    p1, p12 = _exact(cfg, params)
    q1, q12 = _exact(dcfg, dparams)
    first, second = _sampled_pairs(tiny16, seed=11, k_row=k_row)
    c1 = np.bincount(first, minlength=v)
    c12 = np.bincount(first * v + second, minlength=v * v)
    lim1, lim12 = 2 * _e_bound(p1, N_ROWS), 2 * _e_bound(p12.ravel(), N_ROWS)
    assert _tv(c1, p1) <= lim1
    assert _tv(c12, p12.ravel()) <= lim12
    # Power: the draft's distribution is farther than the limits.
    assert 0.5 * np.abs(q1 - p1).sum() > 3 * lim1
    assert 0.5 * np.abs(q12 - p12).sum() > 3 * lim12


def test_sampled_rounds_are_deterministic_per_seed(tiny16):
    a = _sampled_pairs(tiny16, seed=5, k_row=SK, n=64)
    b = _sampled_pairs(tiny16, seed=5, k_row=SK, n=64)
    c = _sampled_pairs(tiny16, seed=6, k_row=SK, n=64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_sampled_batcher_streams_equal_overlap_on_and_off(models):
    def leg(overlap):
        b = _mk(models, spec="self_int4", temperature=0.8, top_p=0.9,
                seed=3, overlap=overlap, eos_id=7, **PAGED)
        return _run(b, REQS)

    assert leg(True) == leg(False)
