"""A replica fleet behind the port's router (``cluster/fleet.py``,
``runtime/router.py``), held against the JAX package on the CPU.

Two replicas share one copy of the weights (numpy-drawn, loaded into
both stacks); every stream is held against a single reference engine's
temperature-0 stream for the same prompt.  Health is driven by explicit
ticks (``ReplicaFleet._tick_one``; the probe loop's interval is an hour,
so it never ticks) and every drill fires by count, so no case races a
probe interval:

- prefix affinity: a repeat of a shared prefix lands on the replica that
  holds it and is served as a cache hit;
- the cross-replica pull: ``router.place:drop`` vetoes the sticky replica,
  the router pulls the run from it into the cold sibling
  (``directory.hits``, ``batcher.kv_pages_imported``), the stream is exact;
- exact failover of a zero-streamed request on ``replica.crash:close``
  (the replica's engine is held at a gate so the request is provably in
  flight), and on ``replica.partition:drop``; a ``replica.stall`` wedge
  past the watchdog fails over too; the killed replica respawns with a
  bumped epoch and serves again;
- a rolling restart keeps serving exactly;
- the fleet tenant ledger admits one quota across two replicas, with the
  ``Retry-After`` the reference's ledger computes on the same state;
- ``dlt-serve-torch --device cpu --preset llama-tiny --replicas 2`` boots.
"""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_llms_tpu.runtime import batcher as jb
from distributed_llms_tpu.runtime import router as jrouter
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
RNG = np.random.default_rng(11)
SHARED = [int(t) for t in RNG.integers(1, 256, 36)]
PROMPTS = {
    "a": SHARED + [int(t) for t in RNG.integers(1, 256, 5)],
    "b": SHARED + [int(t) for t in RNG.integers(1, 256, 9)],
    "c": SHARED + [int(t) for t in RNG.integers(1, 256, 12)],
    "d": [int(t) for t in RNG.integers(1, 256, 20)],
}
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


def _batcher(mod, w, **kw):
    kw = {**dict(tokenizer=TOK, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
                 batch_slots=2, max_len=96, chunk_steps=4, paged_pages=24,
                 page_size=PAGE, prefix_cache=True), **kw}
    if mod is jb:
        return jb.ContinuousBatcher(w[0], w[2], **kw)
    return tb.ContinuousBatcher(w[1], w[3], **kw)


@pytest.fixture(scope="module")
def expected(w):
    """One reference engine's streams (as text), no cache involved."""
    b = _batcher(jb, w, paged_pages=40, prefix_cache=False)
    rids = {k: b.submit(p, max_new_tokens=N_NEW) for k, p in PROMPTS.items()}
    res = b.run()
    return {k: TOK.decode(res[r]) for k, r in rids.items()}


def _factory(w, **srv_kw):
    srv_kw.setdefault("watchdog_timeout_s", 5.0)

    def make():
        return InferenceServer(
            _batcher(tb, w), model_name="tiny", host="127.0.0.1", port=0,
            batcher_factory=lambda: _batcher(tb, w), **srv_kw)

    return make


async def _post(port, body, tenant=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    hdr = f"X-Tenant: {tenant}\r\n" if tenant else ""
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n{hdr}"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = dict(line.split(": ", 1) for line in lines[1:])
    return int(lines[0].split()[1]), headers, json.loads(rest)


async def _complete(port, key, **kw):
    status, _, body = await _post(
        port, {"prompt": PROMPTS[key], "max_tokens": N_NEW}, **kw)
    assert status == 200, body
    return body["choices"][0]["text"], body["usage"].get(
        "prompt_tokens_details", {}).get("cached_tokens", 0)


async def tick(fleet):
    """One deterministic health round (the probe loop never ticks)."""
    for h in list(fleet.replicas):
        await fleet._tick_one(h)


def run_fleet(w, fn, faults=None, probe_s=3600.0, srv_kw=None,
              router_kw=None):
    async def main():
        fleet = ReplicaFleet([_factory(w, **(srv_kw or {}))] * 2,
                             faults=faults, probe_interval_s=probe_s)
        router = ReplicaRouter(fleet, host="127.0.0.1", port=0,
                               tokenizer=TOK, page_size=PAGE, faults=faults,
                               **(router_kw or {}))
        await fleet.start()
        await router.start()
        try:
            await tick(fleet)
            assert fleet.report()["healthy"] == 2
            return await fn(router.bound_port, fleet, router)
        finally:
            await router.stop()
            await fleet.stop()

    return asyncio.run(main())


def _gate(server):
    """Hold the replica's engine before its next run: a request sent now
    is provably in flight and has streamed nothing."""
    gate = threading.Event()
    run = server.batcher.run

    def gated(on_tokens=None):
        gate.wait(30)
        return run(on_tokens=on_tokens)

    server.batcher.run = gated
    return gate


async def _in_flight(h):
    for _ in range(2000):
        if h.inflight and h.server._inflight():
            return
        await asyncio.sleep(0.005)
    raise AssertionError(f"no request went in flight on {h.name}")


# -- placement ----------------------------------------------------------------

def test_affinity_and_directory_pull_are_exact(w, expected):
    plane = FaultPlane()

    async def fn(port, fleet, router):
        out = {"a": await _complete(port, "a")}
        holder = router._affinity_lookup(router._digests(PROMPTS["a"])[-1])
        assert holder == "r0"  # least committed, ties by name
        hits0 = METRICS.get_counter("router.affinity_hits")
        out["b"] = await _complete(port, "b")
        assert METRICS.get_counter("router.affinity_hits") == hits0 + 1
        # Veto the sticky replica once: c lands cold on r1, which pulls
        # the shared run from r0 instead of prefilling it.
        rule = plane.add("router.place", "drop", when="1", tag="r0")
        counters = ("directory.hits", "directory.pulls",
                    "batcher.kv_pages_imported", "batcher.kv_pages_exported")
        before = {c: METRICS.get_counter(c) for c in counters}
        out["c"] = await _complete(port, "c")
        assert rule.fired == 1
        delta = {c: METRICS.get_counter(c) - before[c] for c in counters}
        assert delta["directory.hits"] == 1 and delta["directory.pulls"] == 1
        assert delta["batcher.kv_pages_imported"] == 2
        assert delta["batcher.kv_pages_exported"] == 2
        assert fleet["r1"].server.kv_stats.imported == 1
        out["d"] = await _complete(port, "d")
        for h in fleet.replicas:
            h.server.batcher.assert_pool_consistent()
        return out

    out = run_fleet(w, fn, faults=plane)
    assert {k: t for k, (t, _) in out.items()} == expected
    assert out["a"][1] == 0
    assert out["b"][1] == 2 * PAGE  # affinity: the shared pages hit
    assert out["c"][1] == 2 * PAGE  # pulled from the sibling


# -- exact failover -------------------------------------------------------------

@pytest.mark.parametrize("drill", ["crash", "partition"])
def test_zero_streamed_request_fails_over_exactly(w, expected, drill):
    plane = FaultPlane()

    async def fn(port, fleet, router):
        r0 = fleet["r0"]
        gate = _gate(r0.server)
        f0 = METRICS.get_counter("router.failovers")
        task = asyncio.create_task(_complete(port, "a"))
        await _in_flight(r0)
        if drill == "crash":
            rule = plane.add("replica.crash", "close", when="1", tag="r0")
        else:
            rule = plane.add("replica.partition", "drop", when="1", tag="r0")
        ticker = asyncio.create_task(fleet._tick_one(r0))
        text, cached = await task  # served by r1 while r0's engine waits
        gate.set()
        await ticker
        assert rule.fired == 1
        assert METRICS.get_counter("router.failovers") == f0 + 1
        assert r0.state == ("dead" if drill == "crash" else "healthy")
        assert not r0.routable(asyncio.get_running_loop().time())
        assert fleet["r1"].server.batcher.prefix_cached_tokens is not None
        epoch = r0.epoch
        # Respawn: a fresh stack, its epoch bumped, serving again.
        await fleet.respawn("r0", wait_healthy_s=0)
        await tick(fleet)
        assert r0.epoch == epoch + 1 and r0.state == "healthy"
        assert r0.restarts == 1
        again = await _complete(port, "d")
        return text, again

    text, again = run_fleet(w, fn, faults=plane)
    assert text == expected["a"] and again[0] == expected["d"]


def test_stalled_replica_fails_over_past_the_watchdog(w, expected):
    plane = FaultPlane()

    async def fn(port, fleet, router):
        r0 = fleet["r0"]
        rule = plane.add("replica.stall", "delay", when="1", arg=1.5,
                         tag="r0")
        await fleet._tick_one(r0)  # arms one 1.5 s decode stall on r0
        assert rule.fired == 1
        assert r0.server.batcher.faults is not plane  # its own plane
        f0 = METRICS.get_counter("router.failovers")
        task = asyncio.create_task(_complete(port, "b"))
        await _in_flight(r0)
        await asyncio.sleep(0.5)  # the stall is under way, past 0.2 s
        await fleet._tick_one(r0)  # /healthz 503 -> unhealthy, aborted
        assert r0.state == "unhealthy"
        text, _ = await task
        assert METRICS.get_counter("router.failovers") == f0 + 1
        return text

    text = run_fleet(w, fn, faults=plane,
                     srv_kw=dict(watchdog_timeout_s=0.2))
    assert text == expected["b"]


def test_rolling_restart_serves_exactly(w, expected):
    async def fn(port, fleet, router):
        first = await _complete(port, "a")
        epochs = [h.epoch for h in fleet.replicas]
        await fleet.rolling_restart(drain_timeout_s=5.0)
        assert [h.restarts for h in fleet.replicas] == [1, 1]
        assert [h.epoch for h in fleet.replicas] == [e + 1 for e in epochs]
        # The old affinity reads stale: the repeat lands cold.
        second = await _complete(port, "a")
        return first, second

    # The drain's respawn waits for a probe: the loop ticks here.
    first, second = run_fleet(w, fn, probe_s=0.05)
    assert first[0] == second[0] == expected["a"]
    assert second[1] == 0


# -- the fleet tenant ledger ----------------------------------------------------

def test_fleet_ledger_admits_one_quota(w, monkeypatch):
    # 6 tokens/s x 10 s window, weight 1: 60 tokens a tenant, fleet-wide.
    # Each request is len(prompt) + 6 tokens; the replicas' own gates are
    # 2x backstops.
    body = {"prompt": PROMPTS["d"], "max_tokens": 6}  # 26 tokens

    async def fn(port, fleet, router):
        got = []
        for tenant in ("t", "t", "t", "u"):
            status, headers, resp = await _post(port, body, tenant=tenant)
            got.append((tenant, status, headers.get("Retry-After"),
                        resp.get("error", {}).get("reason")))
        placed = {h.name: h.server.batcher.results for h in fleet.replicas}
        return got, router, placed

    sheds0 = METRICS.get_counter("router.ledger.sheds")
    got, router, _ = run_fleet(
        w, fn, srv_kw=dict(tenant_quota_tps=6.0, tenant_backstop_x=2.0),
        router_kw=dict(tenant_quota_tps=6.0, tenant_weights={"t": 1.0}))
    assert [g[:2] for g in got] == [("t", 200), ("t", 200), ("t", 429),
                                   ("u", 200)]
    assert got[2][3] == "tenant_quota"
    assert METRICS.get_counter("router.ledger.sheds") == sheds0 + 1
    # The same ledger state under one frozen clock: the port's gate and
    # the reference's give the same Retry-After.
    now = time.perf_counter()
    monkeypatch.setattr(time, "perf_counter", lambda: now)
    for tenant, est in (("t", 26), ("t", 8), ("u", 40), ("u", 26)):
        assert router._ledger_retry_after(tenant, est) == \
            jrouter.ReplicaRouter._ledger_retry_after(router, tenant, est)
    assert 1 <= int(got[2][2]) <= 10


def test_cli_replicas_boot():
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args([
        "--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "24",
        "--page-size", "16", "--prefix-cache", "--slots", "2",
        "--max-len", "96", "--host", "127.0.0.1", "--port", "0",
        "--replicas", "2", "--failover-retries", "1", "--probe-interval",
        "3600",
        "--fault", "replica.partition/r9:drop@1"])
    fleet, router, _ = serve_main.build_fleet(args)
    assert [h.name for h in fleet.replicas] == ["r0", "r1"]
    assert router.max_failover_retries == 1 and not router.handoff

    async def main():
        await fleet.start()
        await router.start()
        try:
            await tick(fleet)
            planes = [h.server.batcher.faults for h in fleet.replicas]
            # One plane per replica, parsed from the same spec, and the
            # shared one on the fleet and router.
            assert planes[0] is not planes[1]
            assert fleet.faults is router.faults
            assert fleet.faults not in planes
            engines = {id(h.server.batcher.params) for h in fleet.replicas}
            return await _post(router.bound_port,
                               {"prompt": "hello fleet", "max_tokens": 4}), \
                engines
        finally:
            await router.stop()
            await fleet.stop()

    (status, _, body), engines = asyncio.run(main())
    assert status == 200, body
    assert len(engines) == 1  # one copy of the weights
