"""Signal-driven autoscaler (PyTorch port of
``distributed_llms_tpu/cluster/autoscale.py``): the fleet grows and shrinks
with load, a control loop over :class:`~.fleet.ReplicaFleet`'s
``add_replica`` / ``remove_replica``.

- **Signals.**  The router's committed-token mass (prompt + budget of
  every in-flight request, the accounting placement uses) and its queue
  depth (in-flight proxies), summed over the ROUTABLE replicas' handles.
  ``load`` is committed tokens over the fleet's aggregate KV capacity
  (``batcher.capacity_tokens()`` a replica): the fraction of the fleet's
  token budget already spoken for.
- **Decisions.**  Scale UP when load has been at or above ``up_load`` for
  ``hysteresis`` consecutive ticks; scale DOWN at or below ``down_load``
  the same way; never outside ``[min_replicas, max_replicas]``; and a
  ``cooldown_s`` quiet period follows every action, a FAILED one
  included.  Hysteresis filters noise; the cooldown stops oscillation
  while a new replica captures its graphs.
- **Mechanics.**  Up = ``fleet.add_replica`` (the factory builds off the
  event loop; a failed boot registers nothing).  Down =
  ``fleet.remove_replica``: GRACEFUL drain only — in-flight requests
  finish byte-exact, stragglers past the deadline fail over through the
  router's exact path, and the replica's pool returns to the allocator.
  The least-committed routable replica drains (the cheapest), never
  below the floor.
- **Drills.**  The ``fleet.scale_up`` / ``fleet.scale_down`` fault sites
  fire before each action (tag = replica name or role): ``raise`` /
  ``drop`` fail or veto it, and the loop degrades cleanly (counts the
  failure, keeps serving at the current size, retries after the
  cooldown), as a failed provision call must be absorbed.  ``delay`` is
  returned unslept: this loop never blocks.

Everything here is confined to the event loop (the fleet's model): factory
builds ride ``asyncio.to_thread`` inside ``fleet._boot`` and every fault
fire defers stalls.

**Disaggregated fleets** scale per TIER: :class:`TieredAutoscaler` runs one
control loop per role over the same fleet.  The prefill tier scales off
queue depth (in-flight handoff RPCs per routable prefill replica, counted
by the router on the handle), the decode tier off committed-token mass
over the tier's KV capacity; each tier has its own
``min/max/hysteresis/cooldown`` (:class:`TierPolicy`).  Scale-downs stay
graceful and role-scoped.  A saturated prefill tier pinned at its ceiling
degrades through the router's handoff ladder to colocated prefill on the
decode replica, counted at ``router.handoff_fallbacks.*``.
"""

from __future__ import annotations

import asyncio

from ..core.observability import METRICS, get_logger
from ..runtime.faults import InjectedFault

log = get_logger("autoscale")


class Autoscaler:
    """Control loop over a :class:`~.fleet.ReplicaFleet`.

    ``replica_capacity_tokens`` is one replica's KV capacity (the
    denominator of the load signal); None reads it off the first live
    replica's batcher at tick time — a host read of a static number.
    ``factory`` overrides the fleet's default replica factory for
    scale-ups (tests inject light stubs)."""

    def __init__(
        self,
        fleet,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 1.0,
        up_load: float = 0.8,
        down_load: float = 0.25,
        hysteresis: int = 3,
        cooldown_s: float = 10.0,
        drain_timeout_s: float = 30.0,
        replica_capacity_tokens: int | None = None,
        factory=None,
        faults=None,
    ) -> None:
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas {min_replicas}"
            )
        if not 0.0 <= down_load < up_load:
            raise ValueError(
                f"need 0 <= down_load < up_load, got "
                f"{down_load} / {up_load}"
            )
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.fleet = fleet
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.interval_s = interval_s
        self.up_load = up_load
        self.down_load = down_load
        self.hysteresis = hysteresis
        self.cooldown_s = cooldown_s
        self.drain_timeout_s = drain_timeout_s
        self.replica_capacity_tokens = replica_capacity_tokens
        self.factory = factory
        self.faults = faults
        self._up_streak = 0      # consecutive ticks above up_load
        self._down_streak = 0    # consecutive ticks below down_load
        self._cooldown_until = 0.0  # loop-clock quiet period
        self._task: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.create_task(self._run())
        log.info(
            "autoscaler on: %d..%d replicas, up at load>%.2f, down at "
            "load<%.2f (x%d ticks, %.1fs cooldown)",
            self.min_replicas, self.max_replicas, self.up_load,
            self.down_load, self.hysteresis, self.cooldown_s,
        )

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                # The controller must outlive any one bad tick: a scale
                # action failing mid-flight is a degraded fleet, not a
                # dead autoscaler.
                log.exception("autoscaler tick failed")

    # -- signals -----------------------------------------------------------

    def _capacity(self) -> int:
        if self.replica_capacity_tokens is not None:
            return self.replica_capacity_tokens
        for h in self.fleet.replicas:
            server = getattr(h, "server", None)
            if server is not None and getattr(server, "batcher", None) \
                    is not None:
                return max(1, server.batcher.capacity_tokens())
        return 1

    def signals(self) -> dict:
        """The tick's inputs, also published as gauges: committed token
        mass and queue depth summed over ROUTABLE replicas (the work the
        router can actually spread), live replica count, and the load
        fraction against aggregate capacity."""
        now = self._loop.time() if self._loop is not None else 0.0
        live = [h for h in self.fleet.replicas if h.state != "dead"]
        routable = [h for h in live if h.routable(now)]
        committed = sum(h.committed_tokens for h in routable)
        depth = sum(len(h.inflight) for h in routable)
        cap = self._capacity() * max(1, len(routable))
        load = committed / cap
        METRICS.set_gauges({
            "autoscale.replicas": len(live),
            "autoscale.load": load,
            "autoscale.queue_depth": depth,
        })
        return {"replicas": len(live), "routable": len(routable),
                "committed_tokens": committed, "queue_depth": depth,
                "load": load}

    # -- the control loop --------------------------------------------------

    async def tick(self) -> str | None:
        """One decision: returns "up"/"down" when an action was TAKEN,
        None otherwise (tests drive this directly for determinism —
        tick() binds the loop itself, no start() required)."""
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        sig = self.signals()
        n = sig["replicas"]
        self._up_streak = self._up_streak + 1 \
            if sig["load"] >= self.up_load else 0
        self._down_streak = self._down_streak + 1 \
            if sig["load"] <= self.down_load else 0
        now = self._loop.time()
        if now < self._cooldown_until:
            return None
        if (self._up_streak >= self.hysteresis and n < self.max_replicas
                and sig["routable"] > 0):
            self._up_streak = 0
            self._cooldown_until = now + self.cooldown_s
            return "up" if await self._scale_up(sig) else None
        if self._down_streak >= self.hysteresis and n > self.min_replicas:
            self._down_streak = 0
            self._cooldown_until = now + self.cooldown_s
            return "down" if await self._scale_down(sig) else None
        return None

    @staticmethod
    def _vetoed(fire_one) -> bool:
        """Whether a scale-action fault rule vetoed/failed the action
        (``raise``, ``drop``, or ``close`` — the caller degrades
        cleanly); every other outcome proceeds."""
        try:
            rule = fire_one()
        except InjectedFault:
            return True
        return rule is not None and rule.action in ("drop", "close")

    async def _scale_up(self, sig: dict) -> bool:
        # defer_stall on every scale-site fire: this loop runs next to
        # probing and routing — a stall rule must not freeze failure
        # detection; chaos drills stall replicas, not the controller.
        if self.faults is not None and self._vetoed(
            lambda: self.faults.fire("fleet.scale_up", defer_stall=True)
        ):
            METRICS.inc("autoscale.scale_failures")
            log.warning(
                "scale-up failed (injected); serving at %d replica(s), "
                "retry after cooldown", sig["replicas"],
            )
            return False
        t0 = self._loop.time()
        try:
            h = await self.fleet.add_replica(factory=self.factory)
        except Exception:
            # A real provision failure (factory OOM, port exhaustion):
            # same degrade as the drill — the fleet is unchanged
            # (add_replica registers nothing on failure), serving
            # continues at the current size, the cooldown spaces retries.
            METRICS.inc("autoscale.scale_failures")
            log.exception("scale-up failed; serving at current size")
            return False
        METRICS.inc("autoscale.scale_ups")
        METRICS.observe("autoscale.scale_seconds", self._loop.time() - t0)
        log.info(
            "scaled up: replica %s joined (%s) at load %.2f — %d live",
            h.name, h.state, sig["load"], len(self.fleet.replicas),
        )
        return True

    async def _scale_down(self, sig: dict) -> bool:
        now = self._loop.time()
        cands = [h for h in self.fleet.replicas if h.routable(now)]
        if len(cands) <= self.min_replicas:
            return False  # only unroutable excess — draining those is
            #               the probe/respawn plane's job, not scaling's
        victim = min(cands, key=lambda h: (h.committed_tokens,
                                           len(h.inflight), h.name))
        if self.faults is not None and self._vetoed(
            lambda: self.faults.fire("fleet.scale_down", tag=victim.name,
                                     defer_stall=True)
        ):
            METRICS.inc("autoscale.scale_failures")
            log.warning("scale-down of %s vetoed (injected)", victim.name)
            return False
        t0 = self._loop.time()
        await self.fleet.remove_replica(
            victim.name, drain_timeout_s=self.drain_timeout_s
        )
        METRICS.inc("autoscale.scale_downs")
        METRICS.observe("autoscale.scale_seconds", self._loop.time() - t0)
        log.info(
            "scaled down: replica %s drained away at load %.2f — %d live",
            victim.name, sig["load"], len(self.fleet.replicas),
        )
        return True


class TierPolicy:
    """One tier's scaling knobs for :class:`TieredAutoscaler` — pure
    configuration (no per-run state), so a policy may be shared across
    autoscaler instances.  Validation mirrors :class:`Autoscaler` so a
    bad per-tier flag fails the same way a bad flat flag does."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 up_load: float = 0.8, down_load: float = 0.25,
                 hysteresis: int = 3, cooldown_s: float = 10.0) -> None:
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas {min_replicas}"
            )
        if not 0.0 <= down_load < up_load:
            raise ValueError(
                f"need 0 <= down_load < up_load, got "
                f"{down_load} / {up_load}"
            )
        if hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {hysteresis}")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_load = up_load
        self.down_load = down_load
        self.hysteresis = hysteresis
        self.cooldown_s = cooldown_s


class _TierState:
    """Per-tier control-loop state (streaks + cooldown), kept off the
    shareable :class:`TierPolicy`."""

    __slots__ = ("up_streak", "down_streak", "cooldown_until")

    def __init__(self) -> None:
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown_until = 0.0


class TieredAutoscaler:
    """Per-role control loops over one DISAGGREGATED fleet.

    Two tiers, two signals (module docstring): prefill scales off
    in-flight handoffs per routable prefill replica, decode off
    committed-token mass over the tier's aggregate KV capacity.  Each
    tier keeps its own hysteresis streaks and cooldown clock — a decode
    scale-up never resets the prefill tier's streak or quiets its
    actions.  ``prefill_factory``/``decode_factory`` build role-pinned
    replicas (the CLI partials its replica factory per role); scaled-up
    names mint as ``p<n>``/``d<n>`` alongside the boot-time tiers."""

    ROLES = ("prefill", "decode")

    def __init__(
        self,
        fleet,
        *,
        prefill: TierPolicy | None = None,
        decode: TierPolicy | None = None,
        prefill_factory=None,
        decode_factory=None,
        interval_s: float = 1.0,
        drain_timeout_s: float = 30.0,
        replica_capacity_tokens: int | None = None,
        faults=None,
    ) -> None:
        self.fleet = fleet
        self.policies = {
            # Prefill work is transient (prompt+1 per handoff): a small
            # tier saturates later than decode, so its default ceiling
            # stays low.
            "prefill": prefill or TierPolicy(max_replicas=2),
            "decode": decode or TierPolicy(),
        }
        self.factories = {"prefill": prefill_factory,
                          "decode": decode_factory}
        self.interval_s = interval_s
        self.drain_timeout_s = drain_timeout_s
        self.replica_capacity_tokens = replica_capacity_tokens
        self.faults = faults
        self._state = {role: _TierState() for role in self.ROLES}
        self._task: asyncio.Task | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.create_task(self._run())
        for role in self.ROLES:
            pol = self.policies[role]
            log.info(
                "tiered autoscaler on: %s %d..%d replicas, up at "
                "load>%.2f, down at load<%.2f (x%d ticks, %.1fs cooldown)",
                role, pol.min_replicas, pol.max_replicas, pol.up_load,
                pol.down_load, pol.hysteresis, pol.cooldown_s,
            )

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                # One tier's bad tick must not kill the other tier's
                # controller: degraded fleet, not dead autoscaler.
                log.exception("tiered autoscaler tick failed")

    # -- signals -----------------------------------------------------------

    def _capacity(self, role: str) -> int:
        if self.replica_capacity_tokens is not None:
            return self.replica_capacity_tokens
        for h in self.fleet.replicas:
            if getattr(h, "role", "colocated") != role:
                continue
            server = getattr(h, "server", None)
            if server is not None and getattr(server, "batcher", None) \
                    is not None:
                return max(1, server.batcher.capacity_tokens())
        return 1

    def signals(self, role: str) -> dict:
        """One tier's tick inputs, published as role-keyed gauges.
        Decode load = committed-token mass over the tier's routable KV
        capacity (the flat autoscaler's signal, scoped to the role);
        prefill load = in-flight handoff RPCs per routable prefill
        replica — handoff charges are transient, so token mass would
        flap where the outstanding-RPC count tracks the actual queue."""
        now = self._loop.time() if self._loop is not None else 0.0
        live = [h for h in self.fleet.replicas
                if h.state != "dead"
                and getattr(h, "role", "colocated") == role]
        routable = [h for h in live if h.routable(now)]
        committed = sum(h.committed_tokens for h in routable)
        if role == "prefill":
            depth = sum(getattr(h, "handoffs", 0) for h in routable)
            load = depth / max(1, len(routable))
        else:
            depth = sum(len(h.inflight) for h in routable)
            cap = self._capacity(role) * max(1, len(routable))
            load = committed / cap
        METRICS.set_gauges({
            f"autoscale.{role}.replicas": len(live),
            f"autoscale.{role}.load": load,
        })
        return {"replicas": len(live), "routable": len(routable),
                "committed_tokens": committed, "queue_depth": depth,
                "load": load}

    # -- the control loops -------------------------------------------------

    async def tick(self) -> dict:
        """One decision per tier: ``{"prefill": ..., "decode": ...}``
        with "up"/"down" where an action was TAKEN, None otherwise
        (tests drive this directly for determinism — binds the loop
        itself, no start() required)."""
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        return {role: await self.tick_tier(role) for role in self.ROLES}

    async def tick_tier(self, role: str) -> str | None:
        if self._loop is None:
            self._loop = asyncio.get_running_loop()
        pol, st = self.policies[role], self._state[role]
        sig = self.signals(role)
        n = sig["replicas"]
        st.up_streak = st.up_streak + 1 \
            if sig["load"] >= pol.up_load else 0
        st.down_streak = st.down_streak + 1 \
            if sig["load"] <= pol.down_load else 0
        now = self._loop.time()
        if now < st.cooldown_until:
            return None
        if (st.up_streak >= pol.hysteresis and n < pol.max_replicas
                and sig["routable"] > 0):
            st.up_streak = 0
            st.cooldown_until = now + pol.cooldown_s
            return "up" if await self._scale_up(role, sig) else None
        if st.down_streak >= pol.hysteresis and n > pol.min_replicas:
            st.down_streak = 0
            st.cooldown_until = now + pol.cooldown_s
            return "down" if await self._scale_down(role, sig) else None
        return None

    async def _scale_up(self, role: str, sig: dict) -> bool:
        # Same scale sites as the flat loop, tag = role, so a drill can
        # veto one tier's growth while the other keeps scaling; every
        # fire defers stalls (this loop runs next to probing/routing).
        if self.faults is not None and Autoscaler._vetoed(
            lambda: self.faults.fire("fleet.scale_up", tag=role,
                                     defer_stall=True)
        ):
            METRICS.inc("autoscale.scale_failures")
            METRICS.inc(f"autoscale.{role}.scale_failures")
            log.warning(
                "%s scale-up failed (injected); serving at %d "
                "replica(s), retry after cooldown", role, sig["replicas"],
            )
            return False
        t0 = self._loop.time()
        try:
            h = await self.fleet.add_replica(
                factory=self.factories[role], role=role
            )
        except Exception:
            METRICS.inc("autoscale.scale_failures")
            METRICS.inc(f"autoscale.{role}.scale_failures")
            log.exception("%s scale-up failed; serving at current size",
                          role)
            return False
        METRICS.inc("autoscale.scale_ups")
        METRICS.inc(f"autoscale.{role}.scale_ups")
        METRICS.observe("autoscale.scale_seconds", self._loop.time() - t0)
        log.info(
            "scaled up: %s replica %s joined (%s) at load %.2f",
            role, h.name, h.state, sig["load"],
        )
        return True

    async def _scale_down(self, role: str, sig: dict) -> bool:
        now = self._loop.time()
        cands = [h for h in self.fleet.replicas
                 if h.routable(now)
                 and getattr(h, "role", "colocated") == role]
        if len(cands) <= self.policies[role].min_replicas:
            return False
        victim = min(cands, key=lambda h: (h.committed_tokens,
                                           getattr(h, "handoffs", 0),
                                           len(h.inflight), h.name))
        if self.faults is not None and Autoscaler._vetoed(
            lambda: self.faults.fire("fleet.scale_down", tag=victim.name,
                                     defer_stall=True)
        ):
            METRICS.inc("autoscale.scale_failures")
            METRICS.inc(f"autoscale.{role}.scale_failures")
            log.warning("%s scale-down of %s vetoed (injected)",
                        role, victim.name)
            return False
        t0 = self._loop.time()
        await self.fleet.remove_replica(
            victim.name, drain_timeout_s=self.drain_timeout_s
        )
        METRICS.inc("autoscale.scale_downs")
        METRICS.inc(f"autoscale.{role}.scale_downs")
        METRICS.observe("autoscale.scale_seconds", self._loop.time() - t0)
        log.info(
            "scaled down: %s replica %s drained away at load %.2f",
            role, victim.name, sig["load"],
        )
        return True
