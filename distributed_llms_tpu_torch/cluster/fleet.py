"""Replica fleet: lifecycle and health of N serving replicas in one
process (PyTorch port of ``distributed_llms_tpu/cluster/fleet.py``).

Each replica is a full server/batcher stack (``runtime/server.py``) over
the SAME engine weights, with its own page pool, caches, supervisor and
engine thread.  This module owns everything about replicas that is not
request routing (``runtime/router.py``):

- **Lifecycle.**  Each :class:`ReplicaHandle` wraps a factory that builds a
  fresh server; :meth:`ReplicaFleet.start` boots them all (concurrently,
  each factory off the event loop), and :meth:`respawn` rebuilds one from
  scratch (new pool, new caches, new port), bumping its epoch.
- **Health.**  A probe loop GETs every replica's ``/healthz`` on a fixed
  interval: 200 marks it routable; a 503 (stalled engine, draining, dead
  supervisor) or ``probe_failures`` consecutive unreachable probes marks it
  un-routable AND aborts the router's in-flight requests on it, so
  zero-streamed work fails over instead of hanging.
- **Rolling drain/respawn.**  :meth:`drain` stops new placement, lets the
  in-flight requests finish (stragglers past the deadline are aborted and
  fail over), stops the server and respawns it; :meth:`rolling_restart`
  walks the whole fleet one replica at a time.
- **Replica-scoped chaos** (runtime/faults.py), consulted once per probe
  tick per replica, tag = replica name:

  - ``replica.crash`` — ``close`` (or ``raise``): the replica dies abruptly
    (``InferenceServer.kill``: sockets severed unflushed, engine reaped);
  - ``replica.stall`` — ``delay:<s>``: the replica's engine wedges for
    ``<s>`` seconds (one blocking stall armed on its own fault plane at
    ``batcher.decode``), past the watchdog, so ``/healthz`` flips;
  - ``replica.partition`` — ``drop[:<s>]``: the replica is unreachable FROM
    THE ROUTER for ``<s>`` seconds (no arg: until respawn) while its engine
    keeps running.

Tests drive :meth:`ReplicaFleet._tick_one` directly (under a probe
interval long enough that the loop never ticks) for drills that must not
race a wall-clock probe interval.

All fleet state is confined to the asyncio event loop; the replicas'
engine threads never touch it.  Elastic scaling (``add_replica`` /
``remove_replica`` are here; the autoscaler that drives them is not
ported yet).
"""

from __future__ import annotations

import asyncio
import json
import math

from ..core.observability import METRICS, get_logger

log = get_logger("fleet")


class ReplicaHandle:
    """One replica as the fleet/router sees it.  ``committed_tokens`` and
    ``inflight`` are ROUTER-side accounting (the router is the only writer;
    both confined to the event loop): estimated token mass placed on the
    replica and the in-flight proxy records, each carrying an ``abort``
    event the fleet sets when the replica stops being trustworthy."""

    def __init__(self, name: str, factory) -> None:
        self.name = name
        self.factory = factory  # () -> InferenceServer (unstarted, port 0)
        self.server = None
        self.host: str | None = None
        self.port: int | None = None
        # Disaggregated serving: the replica's role ("colocated" /
        # "prefill" / "decode") and, on decode replicas, where its KV
        # import listener landed — both read off the server at boot.
        self.role = "colocated"
        self.kv_port: int | None = None
        # Cache-lifetime epoch: bumped every (re)boot.  A respawned
        # replica's pool and prefix cache are COLD — router-side prefix
        # affinity entries recorded against an older epoch are stale and
        # must not beat least-loaded placement.
        self.epoch = 0
        # starting | healthy | unhealthy | draining | dead
        self.state = "starting"
        self.partitioned_until = 0.0  # loop-clock; math.inf = until respawn
        self.probe_failures = 0
        self.restarts = 0
        self.committed_tokens = 0
        self.inflight: set = set()  # router _Inflight records
        # In-flight prefill handoff RPCs the router has outstanding on
        # this handle (prefill role only) — the prefill tier's
        # queue-depth signal for cluster/autoscale.py.
        self.handoffs = 0
        self.last_report: dict = {}

    def routable(self, now: float) -> bool:
        """Whether the router may place NEW work here."""
        return self.state == "healthy" and now >= self.partitioned_until

    def reachable(self, now: float) -> bool:
        return self.state != "dead" and now >= self.partitioned_until

    def abort_inflight(self) -> None:
        """Wake every in-flight proxy on this replica: zero-streamed
        requests fail over to a healthy replica, streamed ones fail with a
        structured engine_error (the router's call, mirroring the server
        supervisor's triage one level up)."""
        for rec in list(self.inflight):
            rec.abort.set()


class ReplicaFleet:
    """Owns N replica handles, their probe loop, and drain/respawn.

    ``factories`` builds each replica's :class:`InferenceServer` (bound to
    an ephemeral port; the fleet records where it actually landed).  The
    optional ``faults`` plane is consulted once per probe tick per replica
    at the ``replica.*`` sites (module docstring)."""

    def __init__(self, factories, names=None, probe_interval_s: float = 0.25,
                 probe_failures: int = 2, probe_timeout_s: float = 2.0,
                 faults=None) -> None:
        names = names or [f"r{i}" for i in range(len(factories))]
        if len(names) != len(factories):
            raise ValueError(f"{len(names)} names for {len(factories)} factories")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.replicas = [ReplicaHandle(n, f) for n, f in zip(names, factories)]
        self._by_name = {h.name: h for h in self.replicas}
        # Elastic serving (cluster/autoscale.py): the factory new
        # replicas boot from when add_replica is called without one, and
        # a monotone counter so scaled-up names never collide with a
        # drained-away predecessor's.
        self._default_factory = factories[0] if factories else None
        self._next_name = len(self.replicas)
        self.probe_interval_s = probe_interval_s
        self.probe_failures = probe_failures
        self.probe_timeout_s = probe_timeout_s
        self.faults = faults
        self._probe_task: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    def __getitem__(self, name: str) -> ReplicaHandle:
        return self._by_name[name]

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Boot every replica, all at once (each factory runs off the event
        loop), then start the probe loop."""
        self._loop = asyncio.get_running_loop()
        await asyncio.gather(*[self._boot(h) for h in self.replicas])
        self._probe_task = asyncio.create_task(self._probe_loop())

    async def _boot(self, h: ReplicaHandle) -> None:
        # The factory builds a full server/batcher stack — model jits and
        # pool allocation measured in wall-clock — so it runs OFF the
        # event loop: probing, routing, and failure detection for every
        # OTHER replica must not freeze while a new one warms up (the
        # autoscaler boots replicas while the fleet is at its busiest).
        h.server = await asyncio.to_thread(h.factory)
        h.host, h.port = await h.server.start()
        h.role = getattr(h.server, "role", "colocated")
        h.kv_port = getattr(h.server, "kv_bound_port", None)
        h.epoch += 1  # fresh pool + prefix cache: older affinity is stale
        h.state = "starting"
        h.probe_failures = 0
        h.partitioned_until = 0.0
        log.info("replica %s (%s) serving on %s:%s", h.name, h.role,
                 h.host, h.port)

    async def stop(self) -> None:
        if self._probe_task is not None:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except asyncio.CancelledError:
                pass
            self._probe_task = None
        for h in self.replicas:
            if h.state != "dead" and h.server is not None:
                await h.server.stop()
                h.state = "dead"

    # -- chaos + probing ---------------------------------------------------

    async def kill(self, name_or_handle) -> None:
        """Kill one replica abruptly (process-death semantics — see
        ``InferenceServer.kill``).  The replica stays ``dead`` until an
        explicit :meth:`respawn`; its in-flight router requests abort so
        the zero-streamed ones migrate immediately, not at probe time."""
        h = (name_or_handle if isinstance(name_or_handle, ReplicaHandle)
             else self._by_name[name_or_handle])
        if h.state == "dead":
            return
        log.warning("replica %s killed", h.name)
        h.state = "dead"
        METRICS.inc("router.replica_kills")
        h.abort_inflight()
        if h.server is not None:
            await h.server.kill()
        self._publish_health()

    def _wedge(self, h: ReplicaHandle, seconds: float) -> None:
        """Wedge the replica's engine: one blocking ``seconds``-long stall
        armed on its own fault plane at ``batcher.decode`` — its watchdog
        then flips ``/healthz`` unhealthy while work is in flight, exactly
        like a stuck device call.  The rule must land on a plane PRIVATE
        to THIS replica's batcher: the fleet's own plane is traversed by
        the event loop and (if shared across batchers) by every engine
        thread at once, so arming an untagged ``batcher.decode`` rule
        there would stall whichever replica decodes next, not the drill's
        target — the CLI gives each replica its own plane for exactly
        this reason."""
        from ..runtime.faults import FaultPlane

        batcher = h.server.batcher
        if batcher.faults is None or batcher.faults is self.faults:
            batcher.faults = FaultPlane()
        batcher.faults.add("batcher.decode", "stall", when="1", arg=seconds)
        log.warning("replica %s: engine wedge armed (%.2fs)", h.name, seconds)

    def _partition(self, h: ReplicaHandle, seconds: float | None) -> None:
        now = self._loop.time()
        h.partitioned_until = (math.inf if seconds is None
                               else now + seconds)
        log.warning("replica %s partitioned from the router (%s)",
                    h.name, "until respawn" if seconds is None
                    else f"{seconds:g}s")
        h.abort_inflight()
        self._publish_health()

    async def _chaos(self, h: ReplicaHandle) -> None:
        """Consult the replica-scoped fault sites for one tick.  These
        sites are traversed by the EVENT LOOP, so every fire() defers
        stall application — a blocking sleep here would freeze probing
        for the whole fleet and the router with it; a ``stall`` rule at
        ``replica.stall`` gets the same wedge semantics as ``delay``."""
        from ..runtime.faults import InjectedFault

        plane = self.faults
        if plane is None:
            return
        try:
            rule = plane.fire("replica.crash", tag=h.name, defer_stall=True)
        except InjectedFault:
            rule = None
            await self.kill(h)
        else:
            if rule is not None and rule.action == "close":
                await self.kill(h)
        rule = plane.fire("replica.stall", tag=h.name, defer_stall=True)
        if (rule is not None and rule.action in ("delay", "stall")
                and h.state != "dead"):
            self._wedge(h, rule.arg or 0.0)
        rule = plane.fire("replica.partition", tag=h.name, defer_stall=True)
        if rule is not None and rule.action == "drop" and h.state != "dead":
            self._partition(h, rule.arg)

    async def _probe(self, h: ReplicaHandle) -> tuple[int, dict]:
        reader, writer = await asyncio.open_connection(h.host, h.port)
        try:
            writer.write(b"GET /healthz HTTP/1.1\r\nHost: fleet\r\n\r\n")
            await writer.drain()
            status = int((await reader.readline()).split()[1])
            clen = 0
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                if name.strip().lower() == "content-length":
                    clen = int(value.strip())
            body = await reader.readexactly(clen) if clen else b""
            return status, (json.loads(body) if body else {})
        finally:
            writer.close()

    async def _probe_loop(self) -> None:
        while True:
            await asyncio.sleep(self.probe_interval_s)
            # One task per replica: a slow/unreachable probe (up to
            # probe_timeout_s) or a chaos kill awaiting an engine join
            # must not delay every OTHER replica's failure detection —
            # serial ticks would couple failover latency to the slowest
            # replica in the fleet.
            # ONE snapshot for both the gather and the attribution zip:
            # the autoscaler may add/remove replicas mid-gather, and a
            # re-snapshot would misalign handles with results (a probe
            # failure logged against the wrong replica, or dropped).
            handles = list(self.replicas)
            results = await asyncio.gather(
                *[self._tick_one(h) for h in handles],
                return_exceptions=True,
            )
            for h, r in zip(handles, results):
                if isinstance(r, BaseException):
                    log.error("probe tick for replica %s failed",
                              h.name, exc_info=r)
            self._publish_health()

    async def _tick_one(self, h: ReplicaHandle) -> None:
        await self._chaos(h)
        await self._tick(h)

    async def wait_healthy(self, n: int | None = None,
                           timeout_s: float = 60.0) -> bool:
        """Block until ``n`` replicas (default: all) probe healthy, or the
        timeout lapses.  Boot-time convenience: replicas start in state
        ``starting`` and only the probe loop flips them routable — serving
        before the first healthy probe sheds 503s from an idle fleet."""
        want = len(self.replicas) if n is None else n
        deadline = self._loop.time() + timeout_s
        while self._loop.time() < deadline:
            now = self._loop.time()
            if sum(1 for h in self.replicas if h.routable(now)) >= want:
                return True
            await asyncio.sleep(min(0.02, self.probe_interval_s / 2))
        return False

    async def _tick(self, h: ReplicaHandle) -> None:
        """One probe of one replica.  Only ``starting``/``healthy``/
        ``unhealthy`` transition here — ``draining`` and ``dead`` are
        operator states the probe must not overwrite."""
        if h.state in ("dead", "draining"):
            return
        now = self._loop.time()
        if now < h.partitioned_until:
            # The router cannot reach it; neither can this probe (the
            # probe IS the router's view).
            self._note_unreachable(h)
            return
        try:
            code, report = await asyncio.wait_for(
                self._probe(h), self.probe_timeout_s
            )
        except (OSError, ConnectionError, EOFError, ValueError, IndexError,
                asyncio.TimeoutError, asyncio.IncompleteReadError):
            self._note_unreachable(h)
            return
        h.last_report = report
        if code == 200:
            h.probe_failures = 0
            if h.state != "healthy":
                log.info("replica %s healthy", h.name)
                h.state = "healthy"
        else:
            # The replica itself says not-ready (stalled past the
            # watchdog, draining, dead engine): believe it immediately.
            self._mark_unhealthy(h, report.get("status", str(code)))

    def _note_unreachable(self, h: ReplicaHandle) -> None:
        h.probe_failures += 1
        if h.probe_failures >= self.probe_failures:
            self._mark_unhealthy(h, "unreachable")

    def _mark_unhealthy(self, h: ReplicaHandle, reason: str) -> None:
        if h.state in ("starting", "healthy"):
            log.warning("replica %s unhealthy (%s)", h.name, reason)
            h.state = "unhealthy"
            # In-flight proxies must not wait out a wedged replica:
            # zero-streamed requests migrate NOW.
            h.abort_inflight()

    def _publish_health(self) -> None:
        now = self._loop.time() if self._loop is not None else 0.0
        METRICS.set_gauge(
            "router.replicas_healthy",
            sum(1 for h in self.replicas if h.routable(now)),
        )

    # -- elastic scaling (cluster/autoscale.py drives these) ---------------

    def _fresh_name(self, prefix: str = "r") -> str:
        while True:
            name = f"{prefix}{self._next_name}"
            self._next_name += 1
            if name not in self._by_name:
                return name

    async def add_replica(self, factory=None, name: str | None = None,
                          wait_healthy_s: float = 60.0,
                          role: str | None = None) -> ReplicaHandle:
        """Scale UP: boot one more replica (fresh server/batcher stack on
        an ephemeral port) and register it with the fleet once its boot
        SUCCEEDED — a factory/start failure raises with nothing
        registered, so a failed scale-up leaves the fleet exactly as it
        was (no half-booted handle for the router to trip on).  Returns
        after the replica's first healthy probe (or ``wait_healthy_s``;
        the caller reads ``handle.state``).  ``role`` only picks the
        minted name's prefix (``p``/``d`` for prefill/decode, matching
        the CLI's boot-time names) — the handle's actual role is read
        off the server the factory builds, same as every boot."""
        factory = factory or self._default_factory
        if factory is None:
            raise ValueError("fleet has no replica factory to scale with")
        if name is not None and name in self._by_name:
            raise ValueError(f"replica name {name!r} already exists")
        prefix = {"prefill": "p", "decode": "d"}.get(role, "r")
        h = ReplicaHandle(name or self._fresh_name(prefix), factory)
        await self._boot(h)  # raises -> nothing registered (clean failure)
        self.replicas.append(h)
        self._by_name[h.name] = h
        METRICS.inc("autoscale.replicas_added")
        self._publish_health()
        deadline = self._loop.time() + wait_healthy_s
        while h.state != "healthy" and self._loop.time() < deadline:
            await asyncio.sleep(self.probe_interval_s / 2)
        return h

    async def remove_replica(self, name: str,
                             drain_timeout_s: float = 30.0) -> None:
        """Scale DOWN, gracefully: stop new placement (state
        ``draining``), let the router's in-flight requests on the replica
        FINISH (byte-exact — nothing is cut mid-decode), abort stragglers
        at the deadline (zero-streamed ones migrate via the router's
        exact failover), stop the server, and drop the handle from the
        fleet.  Unlike :meth:`drain`, nothing respawns — the capacity is
        returned."""
        h = self._by_name[name]
        log.info("scaling down: draining replica %s away", h.name)
        h.state = "draining"
        METRICS.inc("autoscale.replicas_removed")
        self._publish_health()
        deadline = self._loop.time() + drain_timeout_s
        while h.inflight and self._loop.time() < deadline:
            await asyncio.sleep(0.02)
        h.abort_inflight()
        try:
            if h.server is not None:
                await h.server.stop(
                    drain_timeout=max(0.0, deadline - self._loop.time())
                )
        finally:
            # The handle leaves the fleet even if the server's stop
            # raised — a zombie entry would keep the router placing
            # against a dead replica forever.
            h.state = "dead"
            self.replicas.remove(h)
            del self._by_name[h.name]
            self._publish_health()

    # -- rolling drain/respawn ---------------------------------------------

    async def respawn(self, name: str, wait_healthy_s: float = 60.0) -> None:
        """Replace one replica's server with a fresh build (new pool,
        caches, port) and wait for its first healthy probe."""
        h = self._by_name[name]
        old = h.server
        if h.state != "dead" and old is not None:
            await old.stop()
        h.state = "dead"
        await self._boot(h)
        h.restarts += 1
        METRICS.inc("router.respawns")
        deadline = self._loop.time() + wait_healthy_s
        while h.state != "healthy" and self._loop.time() < deadline:
            await asyncio.sleep(self.probe_interval_s / 2)
        self._publish_health()

    async def drain(self, name: str, drain_timeout_s: float = 30.0) -> None:
        """Zero-downtime restart of ONE replica: stop new placement
        (state ``draining``), let the router's in-flight requests finish,
        abort stragglers at the deadline (zero-streamed ones migrate),
        stop the server gracefully, respawn it, and wait until it probes
        healthy again."""
        h = self._by_name[name]
        log.info("draining replica %s", h.name)
        h.state = "draining"
        METRICS.inc("router.drains")
        self._publish_health()
        deadline = self._loop.time() + drain_timeout_s
        while h.inflight and self._loop.time() < deadline:
            await asyncio.sleep(0.02)
        h.abort_inflight()
        await h.server.stop(
            drain_timeout=max(0.0, deadline - self._loop.time())
        )
        await self.respawn(name)

    async def rolling_restart(self, drain_timeout_s: float = 30.0) -> None:
        """Drain + respawn every replica, one at a time — the whole fleet
        restarts with zero downtime as long as N >= 2."""
        for h in list(self.replicas):
            await self.drain(h.name, drain_timeout_s=drain_timeout_s)

    # -- reporting ---------------------------------------------------------

    def report(self) -> dict:
        """Fleet view for the router's /healthz."""
        now = self._loop.time() if self._loop is not None else 0.0
        return {
            "replicas": {
                h.name: {
                    "state": h.state,
                    "role": h.role,
                    "routable": h.routable(now),
                    "partitioned": now < h.partitioned_until,
                    "committed_tokens": h.committed_tokens,
                    "inflight": len(h.inflight),
                    "restarts": h.restarts,
                }
                for h in self.replicas
            },
            "healthy": sum(1 for h in self.replicas if h.routable(now)),
        }
