"""The port's autoscaler (``cluster/autoscale.py``) and its wiring in
``dlt-serve-torch``, held against the JAX package's on the CPU.

1. DECISIONS (no servers): the reference's stub-fleet tests — load
   arithmetic, hysteresis, cooldown, the min/max clamps, the
   least-committed victim, the ``fleet.scale_up`` / ``fleet.scale_down``
   drills — run on both stacks' ``Autoscaler``; and one scripted signal
   sequence (load, handles, the loop's clock, failed provisions, drills)
   fed to both stacks' ``Autoscaler`` and ``TieredAutoscaler``, which
   must take the identical action sequence.  Exact.
2. ACCEPTANCE (live port fleet and router, a tiny model): a bursty
   three-tenant storm drives an elastic min=1/max=2 fleet; one injected
   ``fleet.scale_up`` failure is absorbed, the retry scales up, the idle
   tail drains a replica away gracefully.  Every completed request is
   byte-exact against a fixed batcher's temperature-0 stream, every shed
   is a structured 429/503 with ``Retry-After``, and every surviving pool
   audits clean.
3. ``dlt-serve-torch``: the nine flags arm the flat and the tiered
   autoscaler over the boot-time factory (one copy of the weights).

float32 on the CPU, llama-tiny width, weights drawn with numpy
(tests/test_torch_overlap.py).
"""

import asyncio
import json
import random

import pytest
import torch

from distributed_llms_tpu.cluster import autoscale as jas
from distributed_llms_tpu.core.observability import METRICS as JMETRICS
from distributed_llms_tpu.runtime import faults as jfaults
from distributed_llms_tpu_torch.cluster import autoscale as tas
from distributed_llms_tpu_torch.cluster.fleet import ReplicaFleet
from distributed_llms_tpu_torch.core.observability import METRICS as TMETRICS
from distributed_llms_tpu_torch.runtime import batcher as tb
from distributed_llms_tpu_torch.runtime import faults as tfaults
from distributed_llms_tpu_torch.runtime.router import ReplicaRouter
from distributed_llms_tpu_torch.runtime.server import InferenceServer
from distributed_llms_tpu_torch.runtime.tokenizer import ByteTokenizer

from test_torch_overlap import numpy_weights

PAGE = 16
TOK = ByteTokenizer()
STACKS = {"jax": (jas, JMETRICS, jfaults), "torch": (tas, TMETRICS, tfaults)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- decisions against a stub fleet (no servers) ------------------------------


class _StubHandle:
    def __init__(self, name, committed=0, inflight=0, state="healthy",
                 role="colocated", handoffs=0):
        self.name = name
        self.committed_tokens = committed
        self.inflight = set(range(inflight))
        self.state = state
        self.role = role
        self.handoffs = handoffs

    def routable(self, now):
        return self.state == "healthy"


class _StubFleet:
    """The surface an autoscaler consumes: handles + add/remove."""

    def __init__(self, *handles):
        self.replicas = list(handles)
        self.added = 0
        self.removed: list[str] = []
        self.fail_adds = 0  # > 0: the next add_replica raises

    async def add_replica(self, factory=None, name=None, role=None):
        if self.fail_adds > 0:
            self.fail_adds -= 1
            raise RuntimeError("provision failed")
        self.added += 1
        prefix = {"prefill": "p", "decode": "d"}.get(role, "r")
        h = _StubHandle(name or f"{prefix}{len(self.replicas)}",
                        role=role or "colocated")
        self.replicas.append(h)
        return h

    async def remove_replica(self, name, drain_timeout_s=30.0):
        self.removed.append(name)
        self.replicas = [h for h in self.replicas if h.name != name]


class _Clock:
    """A loop stand-in whose time the test sets: cooldowns compare against
    it, so both stacks see the same instants."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        return self.t


def _scaler(mod, fleet, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("up_load", 0.8)
    kw.setdefault("down_load", 0.2)
    kw.setdefault("hysteresis", 2)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("replica_capacity_tokens", 100)
    return mod.Autoscaler(fleet, **kw)


async def _ticks(sc, n, settle=0.0):
    sc._loop = asyncio.get_running_loop()
    out = []
    for _ in range(n):
        out.append(await sc.tick())
        if settle:
            await asyncio.sleep(settle)
    return out


@pytest.mark.parametrize("stack", STACKS)
async def test_signals_and_load_arithmetic(stack):
    mod, metrics, _ = STACKS[stack]
    fleet = _StubFleet(_StubHandle("a", committed=60, inflight=2),
                       _StubHandle("b", committed=20, inflight=1),
                       _StubHandle("dead", state="dead"))
    sc = _scaler(mod, fleet)
    sc._loop = asyncio.get_running_loop()
    sig = sc.signals()
    assert sig == {"replicas": 2, "routable": 2, "committed_tokens": 80,
                   "queue_depth": 3, "load": pytest.approx(80 / 200)}
    assert metrics.get_gauge("autoscale.load") == pytest.approx(0.4)
    assert metrics.get_gauge("autoscale.replicas") == 2


@pytest.mark.parametrize("stack", STACKS)
async def test_hysteresis_then_scale_up_and_max_clamp(stack):
    mod = STACKS[stack][0]
    fleet = _StubFleet(_StubHandle("a", committed=95))
    sc = _scaler(mod, fleet, max_replicas=2, hysteresis=3)
    assert await _ticks(sc, 2) == [None, None]
    assert (await _ticks(sc, 1)) == ["up"]
    assert fleet.added == 1 and len(fleet.replicas) == 2
    fleet.replicas[1].committed_tokens = 95
    assert all(a is None for a in await _ticks(sc, 5))
    assert len(fleet.replicas) == 2


@pytest.mark.parametrize("stack", STACKS)
async def test_scale_down_graceful_least_committed_and_min_clamp(stack):
    mod = STACKS[stack][0]
    fleet = _StubFleet(_StubHandle("busy", committed=30, inflight=2),
                       _StubHandle("idle", committed=1))
    sc = _scaler(mod, fleet, hysteresis=2)
    assert await _ticks(sc, 2) == [None, "down"]
    assert fleet.removed == ["idle"]
    assert all(a is None for a in await _ticks(sc, 5))
    assert len(fleet.replicas) == 1


@pytest.mark.parametrize("stack", STACKS)
async def test_cooldown_spaces_actions(stack):
    mod = STACKS[stack][0]
    fleet = _StubFleet(_StubHandle("a", committed=95))
    sc = _scaler(mod, fleet, max_replicas=4, hysteresis=1, cooldown_s=5.0)
    clock = _Clock()
    sc._loop = clock
    assert await sc.tick() == "up"
    fleet.replicas[-1].committed_tokens = 95
    for t in (1.0, 2.0, 4.9):
        clock.t = t
        assert await sc.tick() is None
    clock.t = 5.0
    assert await sc.tick() == "up"
    assert fleet.added == 2


@pytest.mark.parametrize("stack", STACKS)
async def test_scale_up_drill_and_real_failure_degrade_cleanly(stack):
    mod, metrics, faults = STACKS[stack]
    plane = faults.FaultPlane.parse("fleet.scale_up:raise@1", strict=True)
    fleet = _StubFleet(_StubHandle("a", committed=95))
    sc = _scaler(mod, fleet, max_replicas=3, hysteresis=1, cooldown_s=1.0,
                 faults=plane)
    clock = _Clock()
    sc._loop = clock
    f0 = metrics.get_counter("autoscale.scale_failures")
    assert await sc.tick() is None  # the drill ate attempt 1
    assert fleet.added == 0 and plane.rules[0].fired == 1
    assert metrics.get_counter("autoscale.scale_failures") == f0 + 1
    clock.t = 1.0
    fleet.fail_adds = 1  # a real provision failure: the same degrade
    assert await sc.tick() is None
    assert metrics.get_counter("autoscale.scale_failures") == f0 + 2
    assert len(fleet.replicas) == 1
    clock.t = 2.0
    assert await sc.tick() == "up"
    assert fleet.added == 1


@pytest.mark.parametrize("stack", STACKS)
async def test_scale_down_veto_drill(stack):
    mod, _, faults = STACKS[stack]
    plane = faults.FaultPlane.parse("fleet.scale_down:drop@1", strict=True)
    fleet = _StubFleet(_StubHandle("a"), _StubHandle("b"))
    sc = _scaler(mod, fleet, hysteresis=1, faults=plane)
    assert (await _ticks(sc, 1))[0] is None  # vetoed
    assert len(fleet.replicas) == 2
    assert (await _ticks(sc, 1))[0] == "down"
    assert len(fleet.replicas) == 1


@pytest.mark.parametrize("stack", STACKS)
async def test_scale_down_raise_drill_counts_failure_and_retries(stack):
    mod, metrics, faults = STACKS[stack]
    plane = faults.FaultPlane.parse("fleet.scale_down:raise@1", strict=True)
    fleet = _StubFleet(_StubHandle("a"), _StubHandle("b"))
    sc = _scaler(mod, fleet, hysteresis=1, faults=plane)
    f0 = metrics.get_counter("autoscale.scale_failures")
    assert (await _ticks(sc, 1))[0] is None
    assert len(fleet.replicas) == 2 and plane.rules[0].fired == 1
    assert metrics.get_counter("autoscale.scale_failures") == f0 + 1
    assert (await _ticks(sc, 1))[0] == "down"
    assert len(fleet.replicas) == 1


@pytest.mark.parametrize("stack", STACKS)
def test_autoscaler_validation(stack):
    mod = STACKS[stack][0]
    fleet = _StubFleet(_StubHandle("a"))
    for kw, match in ((dict(min_replicas=0), "min_replicas"),
                      (dict(min_replicas=3, max_replicas=2), "max_replicas"),
                      (dict(up_load=0.5, down_load=0.6), "down_load"),
                      (dict(hysteresis=0), "hysteresis")):
        with pytest.raises(ValueError, match=match):
            mod.Autoscaler(fleet, **kw)
        with pytest.raises(ValueError, match=match):
            mod.TierPolicy(**kw)


def _script(seed, steps=120, tiered=False):
    """A scripted run: per tick the committed mass (and prefill handoffs)
    of every handle, the clock, a real provision failure now and then.
    Returned as plain data so both stacks replay it."""
    rng = random.Random(seed)
    out = []
    t = 0.0
    for _ in range(steps):
        t += rng.choice((0.2, 0.5, 1.0))
        out.append(dict(
            t=t, level=rng.choice((0, 0, 1, 2, 2, 3)),
            handoffs=rng.choice((0, 0, 1, 3)), fail=rng.random() < 0.08,
            jitter=[rng.randint(0, 9) for _ in range(8)],
        ))
    return out


def _replay_flat(mod, faults, script, spec):
    plane = faults.FaultPlane.parse(spec, strict=True)
    fleet = _StubFleet(_StubHandle("r0"))
    sc = mod.Autoscaler(fleet, min_replicas=1, max_replicas=3, up_load=0.6,
                        down_load=0.2, hysteresis=2, cooldown_s=1.5,
                        replica_capacity_tokens=100, faults=plane)
    clock = _Clock()
    sc._loop = clock
    acts = []

    async def run():
        for step in script:
            clock.t = step["t"]
            load = (0, 10, 50, 95)[step["level"]]
            for h, j in zip(fleet.replicas, step["jitter"]):
                h.committed_tokens = load + j
            fleet.fail_adds = int(step["fail"])
            act = await sc.tick()
            acts.append((act, len(fleet.replicas),
                         tuple(h.name for h in fleet.replicas)))
        return acts

    asyncio.run(run())
    return acts, fleet.removed, [r.fired for r in plane.rules]


def _replay_tiered(mod, faults, script, spec):
    plane = faults.FaultPlane.parse(spec, strict=True)
    fleet = _StubFleet(_StubHandle("p0", role="prefill"),
                       _StubHandle("d0", role="decode"))
    pol = dict(up_load=0.6, down_load=0.2, hysteresis=2, cooldown_s=1.5)
    sc = mod.TieredAutoscaler(
        fleet, prefill=mod.TierPolicy(min_replicas=1, max_replicas=2,
                                      **{**pol, "up_load": 1.5}),
        decode=mod.TierPolicy(min_replicas=1, max_replicas=3, **pol),
        replica_capacity_tokens=100, faults=plane)
    clock = _Clock()
    sc._loop = clock
    acts = []

    async def run():
        for step in script:
            clock.t = step["t"]
            load = (0, 10, 50, 95)[step["level"]]
            for h, j in zip(fleet.replicas, step["jitter"]):
                h.committed_tokens = load + j
                h.handoffs = step["handoffs"] if h.role == "prefill" else 0
            fleet.fail_adds = int(step["fail"])
            act = await sc.tick()
            acts.append((tuple(sorted(act.items())), tuple(
                (h.name, h.role) for h in fleet.replicas)))
        return acts

    asyncio.run(run())
    return acts, fleet.removed, [r.fired for r in plane.rules]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tiered", [False, True], ids=["flat", "tiered"])
def test_decision_sequence_equals_the_reference(seed, tiered):
    """The same signal sequence through both stacks' autoscalers: the
    same action at every tick, the same fleet after it, the same victims,
    the same drills fired."""
    spec = ("fleet.scale_up:raise@2,fleet.scale_down:drop@1,"
            "fleet.scale_up:drop@5")
    script = _script(seed)
    replay = _replay_tiered if tiered else _replay_flat
    got = replay(tas, tfaults, script, spec)
    want = replay(jas, jfaults, script, spec)
    assert got == want
    acts = [a[0] for a in got[0]]
    if not tiered:
        assert "up" in acts and "down" in acts


# -- acceptance: a live elastic fleet under a three-tenant storm -------------


@pytest.fixture(scope="module")
def w():
    return numpy_weights()


def _replica_batcher(w, **kw):
    kw = {**dict(tokenizer=TOK, eos_id=TOK.eos_id, pad_id=TOK.pad_id,
                 batch_slots=2, max_len=96, chunk_steps=4, paged_pages=8,
                 page_size=PAGE, prefix_cache=True,
                 tenant_weights="gold:4,agg:1,free:1", tenant_max_rows=2),
          **kw}
    return tb.ContinuousBatcher(w[1], w[3], **kw)


def _server_factory(w):
    def make_server():
        return InferenceServer(
            _replica_batcher(w), model_name="tiny", host="127.0.0.1",
            port=0, batcher_factory=lambda: _replica_batcher(w),
            watchdog_timeout_s=5.0,
            tenant_weights={"gold": 4.0, "agg": 1.0, "free": 1.0},
            # agg's allowance: 1 x 30 tok/s x 2 s = 60 tokens a window; the
            # storm offers it ~5x that, so it is quota-shed mid-storm.
            tenant_quota_tps=30.0, tenant_rate_window_s=2.0,
        )

    return make_server


async def _request(host, port, body, tenant=None):
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode()
    hdr = f"X-Tenant: {tenant}\r\n" if tenant else ""
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n{hdr}"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    raw = await reader.read()
    writer.close()
    return status, headers, json.loads(raw) if raw.strip() else {}


def _expected_texts(w, reqs):
    """The fixed reference: one roomy batcher serves every prompt.  At
    temperature 0 a stream does not depend on batching, replica or fleet
    size, so every storm completion must match these bytes whichever
    replica (first or scaled up) served it."""
    b = _replica_batcher(w, batch_slots=4, paged_pages=40,
                         prefix_cache=False, tenant_weights=None,
                         tenant_max_rows=None)
    rids = [b.submit(p, max_new_tokens=n) for p, n in reqs]
    res = b.run()
    return {p: TOK.decode(res[rid]) for rid, (p, n) in zip(rids, reqs)}


def test_elastic_fleet_chaos_storm(w):
    gold = [(f"gold tenant request {i} !!", 8) for i in range(3)]
    free = [(f"free rider number {i}", 6) for i in range(3)]
    agg = [(f"aggressor flood item {i} padded out to length", 10)
           for i in range(8)]
    trickle = [(f"tail trickle {i}", 4) for i in range(3)]
    wants = _expected_texts(w, gold + free + agg + trickle)
    plane = tfaults.FaultPlane.parse("fleet.scale_up:raise@1", strict=True)

    async def drive():
        fleet = ReplicaFleet([_server_factory(w)], probe_interval_s=0.05,
                             probe_timeout_s=2.0, faults=plane)
        router = ReplicaRouter(fleet, host="127.0.0.1", port=0,
                               tokenizer=TOK, page_size=PAGE, faults=plane)
        await fleet.start()
        host, port = await router.start()
        scaler = tas.Autoscaler(
            fleet, min_replicas=1, max_replicas=2, up_load=0.15,
            down_load=0.05, hysteresis=2, cooldown_s=0.05,
            drain_timeout_s=20.0, replica_capacity_tokens=112,
            faults=plane,
        )
        scaler._loop = asyncio.get_running_loop()
        sizes = []
        try:
            assert await fleet.wait_healthy(timeout_s=60.0)
            results = {}

            async def one(prompt, n, tenant):
                results[prompt] = await _request(
                    host, port, {"prompt": prompt, "max_tokens": n},
                    tenant=tenant)

            tasks = []

            async def storm():
                for p, n in agg:  # the aggressor BURSTS
                    tasks.append(asyncio.ensure_future(one(p, n, "agg")))
                    await asyncio.sleep(0.03)
                for (p, n), (q, m) in zip(gold, free):
                    tasks.append(asyncio.ensure_future(one(p, n, "gold")))
                    tasks.append(asyncio.ensure_future(one(q, m, "free")))
                    await asyncio.sleep(0.05)

            storm_task = asyncio.ensure_future(storm())
            f0 = TMETRICS.get_counter("autoscale.scale_failures")
            for _ in range(300):
                await asyncio.sleep(0.02)
                await scaler.tick()
                sizes.append(len(fleet.replicas))
                if len(fleet.replicas) == 2:
                    break
            assert len(fleet.replicas) == 2, "the storm never scaled up"
            assert plane.rules[0].fired == 1, "the drill never fired"
            assert TMETRICS.get_counter("autoscale.scale_failures") >= f0 + 1
            await storm_task
            await asyncio.gather(*tasks)

            async def tail():
                for p, n in trickle:
                    await one(p, n, "gold")
                    await asyncio.sleep(0.1)

            tail_task = asyncio.ensure_future(tail())
            downs0 = TMETRICS.get_counter("autoscale.scale_downs")
            for _ in range(400):
                await asyncio.sleep(0.02)
                await scaler.tick()
                sizes.append(len(fleet.replicas))
                if len(fleet.replicas) == 1:
                    break
            assert len(fleet.replicas) == 1, "the idle tail never scaled down"
            assert TMETRICS.get_counter("autoscale.scale_downs") == downs0 + 1
            await tail_task
            assert set(sizes) <= {1, 2}
            completed = 0
            for prompt, (status, headers, body) in results.items():
                if status == 200:
                    completed += 1
                    assert body["choices"][0]["text"] == wants[prompt], prompt
                else:
                    assert status in (429, 503), (prompt, status)
                    assert "retry-after" in headers, prompt
                    assert body["error"]["type"] == "overloaded_error"
            assert completed >= len(gold) + len(free) + len(trickle)
            assert any(r[0] == 429
                       and r[2]["error"].get("reason") == "tenant_quota"
                       for r in results.values()), "agg never quota-shed"
            for h in fleet.replicas:
                b = h.server.batcher
                b.assert_pool_consistent()
                assert not b.page_refs  # every row released its pages
                assert len(b.free_pages) + len(
                    b.pool.prefix_cache.lru) == b.pool.num_pages - 1
        finally:
            await router.stop()
            await fleet.stop()

    asyncio.run(asyncio.wait_for(drive(), 300))


def test_fleet_add_remove_replica_live(w):
    """add_replica boots and registers a routable replica, served through
    the router; remove_replica drains it away and returns the capacity;
    scaled-up names never collide with drained-away ones."""

    async def drive():
        fleet = ReplicaFleet([_server_factory(w)], probe_interval_s=0.05,
                             probe_timeout_s=2.0)
        router = ReplicaRouter(fleet, host="127.0.0.1", port=0,
                               tokenizer=TOK, page_size=PAGE)
        await fleet.start()
        host, port = await router.start()
        try:
            assert await fleet.wait_healthy(timeout_s=60.0)
            h = await fleet.add_replica()
            assert h.name == "r1" and h.state == "healthy"
            assert len(fleet.replicas) == 2
            s, _, b = await _request(host, port, {
                "prompt": "served elastically", "max_tokens": 4})
            assert s == 200, b
            await fleet.remove_replica("r1", drain_timeout_s=10.0)
            assert len(fleet.replicas) == 1 and "r1" not in fleet._by_name
            s, _, _ = await _request(host, port, {"prompt": "still here",
                                                  "max_tokens": 4})
            assert s == 200
            h2 = await fleet.add_replica()
            assert h2.name == "r2"
            await fleet.remove_replica("r2")
        finally:
            await router.stop()
            await fleet.stop()

    asyncio.run(asyncio.wait_for(drive(), 120))


# -- dlt-serve-torch ----------------------------------------------------------

_BASE = ["--preset", "llama-tiny", "--device", "cpu", "--paged-pages", "12",
         "--page-size", "16", "--prefix-cache", "--slots", "2", "--host",
         "127.0.0.1", "--port", "0", "--max-len", "64"]


def test_cli_arms_the_flat_autoscaler_over_the_shared_weights():
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args(_BASE + [
        "--replicas-min", "1", "--replicas-max", "2",
        "--autoscale-interval", "0.3", "--autoscale-up-load", "0.5",
        "--autoscale-down-load", "0.1", "--autoscale-hysteresis", "2",
        "--autoscale-cooldown", "4", "--fault", "fleet.scale_up:raise@1"])
    serve_main.check_fleet_flags(args)
    fleet, router, sc = serve_main.build_fleet(args)
    assert isinstance(sc, tas.Autoscaler)
    assert (sc.min_replicas, sc.max_replicas, sc.interval_s, sc.up_load,
            sc.down_load, sc.hysteresis, sc.cooldown_s) == (
        1, 2, 0.3, 0.5, 0.1, 2, 4.0)
    assert len(fleet.replicas) == 1
    # Scale-ups go through the boot-time factory: the same weights.
    assert sc.factory is fleet.replicas[0].factory
    assert sc.faults is fleet.faults and sc.faults.rules[0].site == \
        "fleet.scale_up"
    s1, s2 = sc.factory(), sc.factory()
    assert s1.batcher.params["embed"]["wte"] is \
        s2.batcher.params["embed"]["wte"]
    with pytest.raises(SystemExit, match="--replicas fixes"):
        serve_main.build_fleet(serve_main.parser().parse_args(
            _BASE + ["--replicas", "2", "--replicas-max", "3"]))
    with pytest.raises(SystemExit, match="< --replicas-min"):
        serve_main.build_fleet(serve_main.parser().parse_args(
            _BASE + ["--replicas-min", "3", "--replicas-max", "2"]))


def test_cli_arms_the_tiered_autoscaler():
    from distributed_llms_tpu_torch.cli import serve_main

    args = serve_main.parser().parse_args(_BASE + [
        "--disaggregate", "--prefill-replicas", "1", "--decode-replicas",
        "1", "--decode-replicas-max", "2"])
    serve_main.check_fleet_flags(args)
    fleet, router, sc = serve_main.build_fleet(args)
    assert isinstance(sc, tas.TieredAutoscaler)
    assert sc.policies["prefill"].max_replicas == 1
    assert sc.policies["decode"].max_replicas == 2
    assert [h.name for h in fleet.replicas] == ["p0", "d0"]
    assert sc.factories["decode"]().role == "decode"
    # Fixed tiers arm nothing.
    args = serve_main.parser().parse_args(_BASE + [
        "--disaggregate", "--decode-replicas", "1"])
    assert serve_main.build_fleet(args)[2] is None
    with pytest.raises(SystemExit, match="--replicas-min sizes"):
        serve_main.check_fleet_flags(serve_main.parser().parse_args(
            _BASE + ["--disaggregate", "--replicas-min", "2",
                     "--replicas-max", "3"]))
