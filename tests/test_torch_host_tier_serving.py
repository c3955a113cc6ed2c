"""Swap preemption and prefix-cache spill on the port's batcher against the
JAX package's (``tests/runtime/test_kv_tiering.py``'s cases), on the CPU.

Every case runs the port with the dispatch-ahead loop on and off, against
the reference batcher in the same configuration (the same pool, host
budget, chunking and KV width), and holds it to:

- temperature-0 streams identical to the reference's (and, where the
  reference test compares with an unpressured or untiered run, to the
  port's own such run), exactly;
- the same ``batcher.kv_swaps.*`` and ``batcher.host_tier.*`` counter
  deltas, preemption count and prefix-cache hits;
- a clean pool-and-tier audit after every workload.

Cases: swap-preempted streams (bf16, int8), swap restore equal to
recompute with each token delivered once, a dry host budget falling back
to recompute, a cancelled swapped request freeing its parcel, a spilled run
restored as a device hit would serve it, a spilled head bridged to a
resident tail, spill under chunked prefill, int8 chunked prefill under
preemption.  One more holds the dispatch-ahead loop's junk writes away from
published pages (every chunk's write targets, and released rows' tables).

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import numpy as np
import pytest
import torch

from distributed_llms_tpu.core.observability import METRICS as JM
from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu_torch.core.observability import METRICS as TM
from distributed_llms_tpu_torch.runtime import batcher as tb

from test_torch_overlap import numpy_weights

COUNTERS = (
    "batcher.kv_swaps.out", "batcher.kv_swaps.in", "batcher.kv_swaps.fallback",
    "batcher.host_tier.spilled_pages", "batcher.host_tier.restored_pages",
    "batcher.host_tier.hits",
)
STORM = [([7, 1, 9, 2], 44), ([4, 4, 4, 4], 44), ([9, 8, 7, 3], 44)]
SHARED = list(range(40, 60)) + [3] * 5  # 25 tokens: 3 full pages of 8
OVERLAP = pytest.mark.parametrize("overlap", [True, False],
                                  ids=["overlap", "sync"])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def paged(mod, w, overlap, **kw):
    """The reference test's ``_paged`` batcher in either stack."""
    kw = {"batch_slots": 3, "max_len": 64, "chunk_steps": 4,
          "page_size": 16, "paged_pages": 9, **kw}
    if mod is jb:
        return jb.ContinuousBatcher(w[0], w[2], **kw)
    return tb.ContinuousBatcher(w[1], w[3], overlap=overlap, **kw)


def measured(metrics, fn):
    before = {n: metrics.get_counter(n) for n in COUNTERS}
    out = fn()
    return out, {n: metrics.get_counter(n) - before[n] for n in COUNTERS}


_REFERENCE: dict = {}


def against_reference(case, w, overlap, fn):
    """``fn(module, weights, overlap)`` on the port equals it on the JAX
    package (run once per case), results and counter deltas alike.
    Returns (port's result, its counter deltas)."""
    if case not in _REFERENCE:
        _REFERENCE[case] = measured(JM, lambda: fn(jb, w, None))
    want, want_c = _REFERENCE[case]
    got, got_c = measured(TM, lambda: fn(tb, w, overlap))
    assert got == want, f"{case}: port {got} != reference {want}"
    assert got_c == want_c, f"{case}: counters {got_c} != {want_c}"
    return got, got_c


def storm(mod, w, overlap, reqs=STORM, **kw):
    b = paged(mod, w, overlap, **kw)
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in reqs]
    res = b.run()
    b.assert_pool_consistent()
    return [res[r] for r in rids], b.preemptions, sorted(b.pool.free_pages)


# -- swap preemption ----------------------------------------------------------


@OVERLAP
def test_swap_preempt_streams(w, overlap):
    (toks, preempted, free), c = against_reference(
        "swap", w, overlap, lambda m, w, o: storm(m, w, o, host_pages=16))
    assert preempted >= 1 and free == list(range(1, 9))
    assert c["batcher.kv_swaps.out"] >= 1 and c["batcher.kv_swaps.in"] >= 1
    assert c["batcher.kv_swaps.fallback"] == 0


def test_tier_gauges_render_beside_the_counters(w):
    """The tier's ``stats()`` become ``batcher.host_tier.*`` gauges whose
    names no counter shares (one series, one TYPE on /metrics)."""
    b = paged(tb, w, True, host_pages=16)
    b.submit(STORM[0][0], max_new_tokens=8)
    b.run()
    b.pool.publish_gauges()
    assert TM.get_gauge("batcher.host_tier.pages") == 16
    assert TM.get_gauge("batcher.host_tier.used", -1) == 0
    text = TM.prometheus_text()
    for line in text.splitlines():
        if line.startswith("# TYPE batcher_host_tier_"):
            name, kind = line.split()[2:4]
            assert f"# TYPE {name} " not in text.replace(line, ""), name
    assert "batcher_host_tier_spill_entries" in text


@OVERLAP
def test_int8_swap_equals_the_unpressured_int8_run(w, overlap):
    """int8 parcels carry the codes and scales verbatim: the swapped run
    equals the int8 run that was never under pressure."""
    (toks, _, _), c = against_reference(
        "swap_int8", w, overlap,
        lambda m, w, o: storm(m, w, o, kv_bits=8, host_pages=16))
    assert c["batcher.kv_swaps.out"] >= 1
    calm, preempted, _ = storm(tb, w, overlap, kv_bits=8, paged_pages=17)
    assert preempted == 0 and toks == calm


@OVERLAP
def test_swap_restore_equals_recompute_and_streams_once(w, overlap):
    against_reference("swap", w, overlap,
                      lambda m, w, o: storm(m, w, o, host_pages=16))
    recompute, preempted, _ = storm(tb, w, overlap)
    assert preempted >= 1
    b = paged(tb, w, overlap, host_pages=16)
    deliveries: dict[int, list[int]] = {}
    dones: dict[int, int] = {}

    def on_tokens(rid, toks, done, lps):
        deliveries.setdefault(rid, []).extend(toks)
        if done:
            dones[rid] = dones.get(rid, 0) + 1

    rids = [b.submit(ids, max_new_tokens=n) for ids, n in STORM]
    res = b.run(on_tokens=on_tokens)
    b.assert_pool_consistent()
    assert [res[r] for r in rids] == recompute
    for rid in rids:
        assert deliveries[rid] == res[rid] and dones[rid] == 1


@OVERLAP
def test_dry_host_budget_falls_back_to_recompute(w, overlap):
    (toks, preempted, _), c = against_reference(
        "dry", w, overlap, lambda m, w, o: storm(m, w, o, host_pages=1))
    assert preempted >= 1
    assert c["batcher.kv_swaps.fallback"] >= 1
    assert c["batcher.kv_swaps.in"] == 0


def cancel_swapped(mod, w, overlap):
    b = paged(mod, w, overlap, host_pages=16)
    rids = [b.submit(ids, max_new_tokens=n) for ids, n in STORM]
    b._admit_pending()
    victim = next(i for i in range(b.b)
                  if b.rows[i].rid is not None and b.rows[i].pages)
    vrid = b.rows[victim].rid
    b._preempt_row(victim, "test")
    queued = [r for r in b.queue_snapshot() if r.rid == vrid]
    assert queued and queued[0].swap_handle is not None
    b.assert_pool_consistent()  # the queued request owns the parcel
    assert b.cancel_row(vrid)
    assert b.host_tier.stats()["swap_parcels"] == 0
    b.assert_pool_consistent()
    res = b.run()
    b.assert_pool_consistent()
    return vrid, [res[r] for r in rids if r != vrid], b.host_tier.stats()


@OVERLAP
def test_cancelled_swapped_request_frees_its_parcel(w, overlap):
    (_, _, stats), _ = against_reference("cancel", w, overlap, cancel_swapped)
    assert stats["used"] == 0


# -- prefix-cache spill --------------------------------------------------------


def spill(mod, w, overlap, evict_len=30, **kw):
    """Warm the cache, push unrelated prompts through until shared pages
    fall off the device LRU, then hit the shared prompt again."""
    b = paged(mod, w, overlap, batch_slots=2, page_size=8, paged_pages=17,
              prefix_cache=True, **kw)
    b.submit(SHARED + [9, 9], max_new_tokens=12)
    b.run()
    for i in range(3):
        b.submit([200 + i] * evict_len + [i], max_new_tokens=20)
    b.run()
    r2 = b.submit(SHARED + [9, 9], max_new_tokens=12)
    out = b.run()[r2]
    b.assert_pool_consistent()
    return out, b.prefix_cached_tokens[r2], b.host_tier.stats()["used"] > 0


def device_hit(w, overlap, **kw):
    """The port's plain device hit on the shared prompt (no eviction)."""
    b = paged(tb, w, overlap, batch_slots=2, page_size=8, paged_pages=17,
              prefix_cache=True, **kw)
    b.submit(SHARED + [9, 9], max_new_tokens=12)
    b.run()
    r = b.submit(SHARED + [9, 9], max_new_tokens=12)
    return b.run()[r], b.prefix_cached_tokens[r]


@OVERLAP
def test_spilled_run_restores_as_a_device_hit(w, overlap):
    """The whole cached run spilled and restored: the hit's stream and its
    cached-token count equal a plain device hit's."""
    (out, cached, _), c = against_reference(
        "spill", w, overlap,
        lambda m, w, o: spill(m, w, o, evict_len=42, host_pages=32))
    assert c["batcher.host_tier.restored_pages"] == 3
    assert (out, cached) == device_hit(w, overlap)
    assert cached == 24


@OVERLAP
def test_spilled_head_bridges_to_a_resident_tail(w, overlap):
    """LRU evicts a run's head first: the tiered match restores it from the
    host and goes on matching the tail still on the device."""
    (out, cached, _), c = against_reference(
        "bridge", w, overlap, lambda m, w, o: spill(m, w, o, host_pages=32))
    assert 1 <= c["batcher.host_tier.restored_pages"] < 3
    assert c["batcher.host_tier.hits"] >= 1
    assert (out, cached) == device_hit(w, overlap) and cached == 24


@OVERLAP
def test_spill_composes_with_chunked_prefill(w, overlap):
    (out, cached, _), c = against_reference(
        "spill_chunked", w, overlap,
        lambda m, w, o: spill(m, w, o, evict_len=42, host_pages=32,
                              prefill_chunk=8))
    assert c["batcher.host_tier.restored_pages"] >= 1
    assert (out, cached) == device_hit(w, overlap, prefill_chunk=8)


@OVERLAP
def test_int8_chunked_prefill_under_preemption(w, overlap):
    """int8 pages, chunked prefill and swaps under pressure: streams equal
    the int8 monolithic unpressured run."""
    reqs = [(list(range(30)), 30), ([4, 4, 4, 4], 40), ([9, 8, 7, 3], 40)]
    (toks, preempted, _), c = against_reference(
        "int8_chunked", w, overlap,
        lambda m, w, o: storm(m, w, o, reqs, kv_bits=8, host_pages=24,
                              prefill_chunk=8, paged_pages=9))
    assert preempted >= 1
    calm, _, _ = storm(tb, w, overlap, reqs, kv_bits=8, paged_pages=33)
    assert toks == calm


# -- the dispatch-ahead loop's junk writes -------------------------------------


def test_no_chunk_writes_a_published_page(w, monkeypatch):
    """With the overlap on, an idle row's K/V still lands somewhere each
    step (at its ``real_lens``).  Under spills and swaps, every page any
    chunk can write — each row's table entries from ``real_lens`` over the
    chunk's steps — is never a published page (so never one a spill or a
    later hit reads), and a row the host has released has an all-scratch
    table in every chunk dispatched after the release."""
    seen = {"chunks": 0, "released_checked": 0}
    real = tb.decode_chunk

    def checked(params, cfg, cache, carry, generator, chunk_steps, **kw):
        tables = kw["tables"].numpy()
        lens = carry[1].numpy()
        published = set(bat.prefix_cache.page_hash)
        for r in range(bat.b):
            for s in range(chunk_steps):
                pos = int(lens[r]) + s
                if pos // bat.page_size >= tables.shape[1]:
                    break
                page = int(tables[r, pos // bat.page_size])
                assert page == 0 or page not in published, (
                    f"row {r} may write published page {page}")
            if bat.rows[r].rid is None:
                assert not tables[r].any(), f"released row {r} kept pages"
                seen["released_checked"] += 1
        seen["chunks"] += 1
        return real(params, cfg, cache, carry, generator, chunk_steps, **kw)

    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(1, 256, 24)]
    pick = lambda n: [int(t) for t in rng.integers(1, 256, n)]  # noqa: E731
    # A wave under pressure (spills, swaps), then a trio over the published
    # shared pages with nothing queued, so that its spans run ahead.
    waves = [[(shared + pick(n % 11), n) for n in (12, 30, 7, 20, 16, 9)],
             [(shared + pick(3), 36) for _ in range(3)]]
    kw = dict(batch_slots=3, page_size=8, paged_pages=17, prefix_cache=True,
              host_pages=24)

    def drive(b):
        out = []
        for wave in waves:
            rids = [b.submit(p, max_new_tokens=n) for p, n in wave]
            got = b.run()
            out.append([got[r] for r in rids])
        b.assert_pool_consistent()
        return out

    # An EOS the trio's first stream emits once, past its first chunks:
    # that row then ends inside a span (a budget's end is foreseen and
    # syncs; an EOS is not) while the chunk behind it is in flight.
    probe = drive(paged(tb, w, True, **kw))
    every = [t for wave in probe for s in wave for t in s]
    eos = next(t for t in probe[1][0][12:] if every.count(t) == 1)
    monkeypatch.setattr(tb, "decode_chunk", checked)
    bat = paged(tb, w, True, eos_id=eos, **kw)
    drive(bat)
    assert seen["chunks"] > 5 and seen["released_checked"] > 0
    assert bat.overlap_stats["dispatched_ahead"] > 0
