"""Disaggregated prefill/decode and the batcher's KV page export/import on
the port, held against the JAX package on the CPU.

- Across the two stacks: pages exported by the reference batcher and
  imported by the port's (and the other way round) give decode streams
  equal to the reference's colocated streams, and the importer serves the
  shipped run as a prefix-cache hit.
- The same exported pages (from either stack) imported by both stacks land
  as the same pool bytes, an int8 pool's f32 scales to 1 ulp (XLA:CPU's
  reciprocal multiply in the reference's quantizer); the port's export ->
  import round trip is byte-stable at float32 and bf16 rows, full width and
  int8 (codes and scales).
- The import contract: a duplicate acks "duplicate", a partial overlap
  imports only the missing pages, first writer wins, a dry pool answers
  "no capacity", a wrong geometry "pool shape mismatch".
- Behind the port's router (1 prefill + 1 decode replica, deterministic
  health ticks, the probe loop idle): every stream equals a single reference
  engine's; the handoff ladder — ``prefill.crash:close`` (colocated
  fallback), ``xfer.send:corrupt`` (a NACK, the retry lands), a frame over
  ``MAX_FRAME`` (colocated fallback) — keeps every stream exact and counts
  each fallback by reason.
- ``dlt-serve-torch --device cpu --preset llama-tiny --disaggregate`` boots
  and hands off; without ``--paged-pages``/``--prefix-cache`` it refuses.

llama-tiny width (4 layers, d_model 64, GQA 4/2), vocab 512, float32,
weights drawn with numpy and loaded into both stacks.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu_torch.cluster import protocol as tproto
from distributed_llms_tpu_torch.cluster.fleet import ReplicaFleet
from distributed_llms_tpu_torch.core.observability import METRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime.faults import FaultPlane
from distributed_llms_tpu_torch.runtime.router import ReplicaRouter
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights

TOK = ByteTokenizer()
PAGE = 16
RNG = np.random.default_rng(7)
SHARED = [int(t) for t in RNG.integers(1, 256, 40)]
PROMPTS = [SHARED + [int(t) for t in RNG.integers(1, 256, n)]
           for n in (3, 9, 14)]  # 43-54 tokens: 2-3 full pages each
N_NEW = 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def batcher(mod, w, pages=24, **kw):
    kw = {**dict(tokenizer=TOK, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
                 batch_slots=2, max_len=96, chunk_steps=4,
                 paged_pages=pages, page_size=PAGE, prefix_cache=True), **kw}
    if mod is jb:
        return jb.ContinuousBatcher(w[0], w[2], **kw)
    return tb.ContinuousBatcher(w[1], w[3], **kw)


@pytest.fixture(scope="module")
def expected(w):
    """The reference engine's colocated streams, no cache involved."""
    b = batcher(jb, w, pages=40, prefix_cache=False)
    rids = [b.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
    res = b.run()
    return [res[r] for r in rids]


def _export(b, prompt):
    b.submit(prompt, max_new_tokens=1)
    b.run()
    return b.export_prefix_pages(prompt)


def _import(b, digests, k, v):
    got = []
    b.submit_kv_import(digests, k, v, lambda ok, why: got.append((ok, why)))
    b.run()
    return got[0]


def _serve_stream(b, prompt):
    rid = b.submit(prompt, max_new_tokens=N_NEW)
    res = b.run()
    return res[rid], b.prefix_cached_tokens.get(rid, 0)


# -- across the stacks --------------------------------------------------------

@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_pages_cross_the_stacks(w, expected, direction):
    src, dst = (jb, tb) if direction == "ref_to_port" else (tb, jb)
    for prompt, want in zip(PROMPTS, expected):
        digests, k, v = _export(batcher(src, w), prompt)
        assert len(digests) == (len(prompt) - 1) // PAGE
        if dst is tb:
            k, v = torch.from_numpy(np.array(k)), torch.from_numpy(
                np.array(v))
        else:
            k, v = k.numpy(), v.numpy()
        b = batcher(dst, w)
        assert _import(b, digests, k, v) == (True, "imported")
        stream, cached = _serve_stream(b, prompt)
        assert stream == want
        assert cached == len(digests) * PAGE
        b.assert_pool_consistent()


def _pool_pages(b, digests):
    pages = b.prefix_cache.match(digests)
    assert len(pages) == len(digests)
    idx = np.asarray(pages)
    arrays = [b.cache.k, b.cache.v]
    if hasattr(b.cache, "k_scale"):
        arrays += [b.cache.k_scale, b.cache.v_scale]
    return [np.asarray(a)[:, idx] if not isinstance(a, torch.Tensor)
            else a[:, torch.as_tensor(idx)].float().numpy() for a in arrays]


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("source", ["ref", "port"])
def test_import_lands_as_the_reference_import(w, kv_bits, source):
    """The same exported pages imported by both stacks land as the same
    page data (int8 codes included).  An int8 pool's float32 scales agree
    to 1 ulp: XLA:CPU compiles the reference's ``absmax / 127`` as a
    multiply by the reciprocal, the port divides.  For the same reason the
    reference's own float32 int8 round trip moves scales by 1 ulp while its
    codes are byte-stable; the port's round trip is byte-stable."""
    src = jb if source == "ref" else tb
    a = batcher(src, w, kv_bits=kv_bits)
    digests, k, v = _export(a, PROMPTS[2])
    k, v = np.array(k), np.array(v)
    sent = _pool_pages(a, digests)
    landed = []
    for mod in (jb, tb):
        b = batcher(mod, w, kv_bits=kv_bits)
        pay = (k, v) if mod is jb else (torch.from_numpy(k),
                                        torch.from_numpy(v))
        assert _import(b, digests, *pay) == (True, "imported")
        landed.append(_pool_pages(b, digests))
    assert len(landed[0]) == (4 if kv_bits == 8 else 2)
    for n, (ref_arr, port_arr) in enumerate(zip(*landed)):
        if n < 2:
            np.testing.assert_array_equal(port_arr, ref_arr)
        else:
            np.testing.assert_array_max_ulp(port_arr, ref_arr, maxulp=1)
    mine = landed[1] if src is tb else landed[0]
    for n, (s_arr, got) in enumerate(zip(sent, mine)):
        if src is tb or n < 2:
            np.testing.assert_array_equal(got, s_arr)
        else:
            np.testing.assert_array_max_ulp(got, s_arr, maxulp=1)


@pytest.mark.parametrize("kv_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_port_round_trip_is_byte_stable(w, kv_bits, kv_dtype):
    kw = dict(kv_bits=kv_bits, **({"kv_dtype": kv_dtype} if kv_dtype
                                  else {}))
    a = batcher(tb, w, **kw)
    row = torch.bfloat16 if kv_dtype else torch.float32
    assert tb._row_dtype_of(a.cache) == row
    digests, k, v = _export(a, PROMPTS[1])
    assert k.dtype == row
    b = batcher(tb, w, **kw)
    assert _import(b, digests, k, v) == (True, "imported")
    pa, pb = (a.prefix_cache.match(digests), b.prefix_cache.match(digests))
    names = ["k", "v"] + (["k_scale", "v_scale"] if kv_bits == 8 else [])
    for name in names:
        sa = getattr(a.cache, name)[:, torch.tensor(pa)]
        sb = getattr(b.cache, name)[:, torch.tensor(pb)]
        assert torch.equal(sa, sb), name


def test_import_contract(w):
    a = batcher(tb, w)
    digests, k, v = _export(a, PROMPTS[2])
    b = batcher(tb, w, pages=5, max_len=48)  # 4 usable pages
    # A partial overlap imports only the missing pages.
    assert _import(b, digests[:1], k[:, :1], v[:, :1]) == (True, "imported")
    imported0 = METRICS.get_counter("batcher.kv_pages_imported")
    assert _import(b, digests, k, v) == (True, "imported")
    assert METRICS.get_counter("batcher.kv_pages_imported") == \
        imported0 + len(digests) - 1
    assert _import(b, digests, k, v) == (True, "duplicate")
    # First writer wins: a different payload under resident digests is a
    # duplicate, and the pool keeps the first bytes.
    before = b.cache.k.clone()
    assert _import(b, digests, k + 1, v) == (True, "duplicate")
    assert torch.equal(before, b.cache.k)
    other = batcher(tb, w)
    d2, k2, v2 = _export(other, [t + 1 for t in PROMPTS[0]])
    assert _import(b, d2, k2[:, :, :4], v2[:, :, :4]) == \
        (False, "pool shape mismatch")
    b.assert_pool_consistent()
    small = batcher(tb, w, pages=3, max_len=32)  # 2 usable pages
    assert _import(small, digests, k, v) == (False, "no capacity")
    small.assert_pool_consistent()
    contiguous = tb.ContinuousBatcher(w[1], w[3], batch_slots=2, max_len=64)
    assert contiguous.export_prefix_pages(PROMPTS[0]) is None
    assert _import(contiguous, d2, k2, v2) == \
        (False, "not a decode-role engine")


# -- the disaggregated fleet --------------------------------------------------

def _factory(w, role, **srv_kw):
    def make():
        return InferenceServer(
            batcher(tb, w), model_name="tiny", host="127.0.0.1", port=0,
            batcher_factory=lambda: batcher(tb, w), role=role, **srv_kw)

    return make


async def _post(port, body):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(rest)


async def tick(fleet):
    """One deterministic health round (the probe loop never ticks)."""
    for h in fleet.replicas:
        await fleet._tick_one(h)


def run_disagg(w, fn, faults=None, router_kw=None):
    async def main():
        fleet = ReplicaFleet([_factory(w, "prefill"), _factory(w, "decode")],
                             names=["p0", "d0"], faults=faults,
                             probe_interval_s=3600.0)
        router = ReplicaRouter(fleet, host="127.0.0.1", port=0,
                               tokenizer=TOK, page_size=PAGE, handoff=True,
                               faults=faults, **(router_kw or {}))
        await fleet.start()
        if faults is not None:
            for h in fleet.replicas:
                h.server.batcher.faults = faults
        await router.start()
        try:
            await tick(fleet)
            assert fleet.report()["healthy"] == 2
            return await fn(router.bound_port, fleet, router)
        finally:
            await router.stop()
            await fleet.stop()

    return asyncio.run(main())


def _text(tokens):
    return TOK.decode(tokens)


def test_disagg_streams_equal_reference(w, expected):
    async def fn(port, fleet, router):
        out = []
        for p in PROMPTS:
            status, body = await _post(port, {"prompt": p,
                                              "max_tokens": N_NEW})
            assert status == 200, body
            out.append((body["choices"][0]["text"], body["usage"]))
        return out, fleet["d0"].server.kv_stats

    h0 = METRICS.get_counter("router.handoffs")
    imp0 = METRICS.get_counter("batcher.kv_pages_imported")
    out, stats = run_disagg(w, fn)
    assert [o[0] for o in out] == [_text(e) for e in expected]
    # The first prompt is handed off; the repeats of its shared pages are
    # hits, so each later prompt ships only what d0 lacks.
    assert METRICS.get_counter("router.handoffs") - h0 == len(PROMPTS)
    assert METRICS.get_counter("batcher.kv_pages_imported") > imp0
    assert stats.imported >= 1
    for _, usage in out:
        assert usage["prompt_tokens_details"]["cached_tokens"] >= 2 * PAGE


@pytest.mark.parametrize("drill", ["prefill_crash", "xfer_corrupt",
                                   "frame_too_large"])
def test_handoff_ladder_keeps_streams_exact(w, expected, drill,
                                            monkeypatch):
    faults = None
    if drill == "prefill_crash":
        faults = FaultPlane.parse("prefill.crash:close@1", strict=True)
    elif drill == "xfer_corrupt":
        faults = FaultPlane.parse("xfer.send:corrupt@1", strict=True)
    else:
        monkeypatch.setattr(tproto, "MAX_FRAME", 4096)
    counters = ("router.handoff_fallbacks.error",
                "router.handoff_fallbacks.rejected", "xfer.retries",
                "xfer.verify_failures", "router.handoff_bytes")
    before = {c: METRICS.get_counter(c) for c in counters}

    async def fn(port, fleet, router):
        status, body = await _post(port, {"prompt": PROMPTS[0],
                                          "max_tokens": N_NEW})
        assert status == 200, body
        # The drill killed p0 (server-side, as a crashed process): its
        # engine is reaped and its port closed.
        return body["choices"][0]["text"], body["usage"], \
            fleet["p0"].server._engine.is_alive()

    text, usage, p0_alive = run_disagg(w, fn, faults=faults)
    assert text == _text(expected[0])
    delta = {c: METRICS.get_counter(c) - before[c] for c in counters}
    cached = usage.get("prompt_tokens_details", {}).get("cached_tokens", 0)
    if drill == "prefill_crash":
        assert faults.rules[0].fired == 1 and not p0_alive
        assert delta["router.handoff_fallbacks.error"] == 1
        assert cached == 0  # colocated prefill on d0
    elif drill == "xfer_corrupt":
        assert faults.rules[0].fired == 1
        assert delta["xfer.retries"] == 1
        assert delta["xfer.verify_failures"] == 1
        assert delta["router.handoff_bytes"] > 0
        assert cached == 2 * PAGE  # the retry landed
    else:
        assert delta["router.handoff_fallbacks.rejected"] == 1
        assert cached == 0


def test_cli_disaggregate_boots_and_hands_off():
    from distributed_llms_tpu_torch.cli import serve_main

    base = ["--preset", "llama-tiny", "--device", "cpu", "--slots", "2",
            "--max-len", "128", "--host", "127.0.0.1", "--port", "0",
            "--disaggregate", "--decode-replicas", "1",
            "--probe-interval", "3600"]
    with pytest.raises(SystemExit, match="--paged-pages and --prefix-cache"):
        serve_main.build_fleet(serve_main.parser().parse_args(base))
    args = serve_main.parser().parse_args(
        base + ["--paged-pages", "24", "--page-size", "16",
                "--prefix-cache"])
    fleet, router, _ = serve_main.build_fleet(args)
    assert [h.name for h in fleet.replicas] == ["p0", "d0"]
    assert router.handoff

    async def main():
        await fleet.start()
        await router.start()
        try:
            await tick(fleet)
            assert {h.name: h.role for h in fleet.replicas} == {
                "p0": "prefill", "d0": "decode"}
            assert fleet["d0"].kv_port is not None
            assert fleet["p0"].kv_port is None
            return await _post(router.bound_port, {
                "prompt": "disaggregate this considerable prompt please! "
                          * 2, "max_tokens": 4})
        finally:
            await router.stop()
            await fleet.stop()

    h0 = METRICS.get_counter("router.handoff_bytes")
    status, body = asyncio.run(main())
    assert status == 200, body
    assert METRICS.get_counter("router.handoff_bytes") > h0
