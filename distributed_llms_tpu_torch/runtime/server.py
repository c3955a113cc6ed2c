"""HTTP serving gateway: an OpenAI-style REST front door over the
continuous batcher (PyTorch port of ``distributed_llms_tpu/runtime/
server.py``).

- the asyncio event loop owns every connection and all request bookkeeping;
- ONE engine thread owns the ``ContinuousBatcher`` and therefore the
  device — the batcher's host scheduling mirrors are single-writer;
- requests cross from loop to engine through the batcher's FIFO queue;
  token deliveries cross back via ``loop.call_soon_threadsafe`` from the
  batcher's ``on_tokens`` streaming callback;
- client disconnects and stop-sequence hits cancel lazily at the engine's
  next chunk boundary (``ContinuousBatcher.cancel_row``).

Endpoints: ``POST /v1/completions`` and ``POST /v1/chat/completions``
(``stream: true`` serves SSE), ``GET /v1/models``, ``GET /healthz`` and
``GET /metrics`` (Prometheus: the reference's names, the batcher's
dispatch-ahead loop included — ``batcher_overlap_dispatched_ahead``,
``batcher_overlap_carry_syncs``, ``batcher_overlap_device_gap_seconds``,
``batcher_overlap_host_lag_seconds`` — and its chunked prefill —
``batcher_prefill_chunks``, ``batcher_sched_*``).

Kept from the reference: the crash supervisor (a crashed ``batcher.run``
respawns the batcher, carries its named prefixes over and re-admits
zero-streamed requests), per-request deadlines, the engine watchdog,
priority admission, presence/frequency penalties, named prefixes
(``prefix``: a name given to ``batcher.register_prefix``), constrained
output (``response_format`` as a JSON schema or a regex, ``logit_bias``,
``banned_tokens``: compiled to a token-mask automaton off the event loop
and handed to the batcher; a malformed one answers a structured 400
before any admission state exists; ``constrained=False`` refuses them
all), the queue-full and estimated-cost shed gates with ``Retry-After``,
graceful drain.  A batcher armed with a fault plane
(runtime/faults.py) crashes or stalls at its sites, and the supervisor
and the watchdog answer as they do for a real fault.

Disaggregated serving and the fleet (cluster/fleet.py, runtime/router.py):
a server has a ``role`` — ``colocated`` (the default), ``prefill`` (serves
``POST /v1/prefill``: admits the prompt, exports its finished KV pages and
ships them over cluster/kv_transfer.py to the decode replica named in the
request) or ``decode``.  A decode replica, and a paged prefix-cached
colocated one, listens for ``KV_PAGES`` frames on an ephemeral port
(``kv_bound_port``) and adopts verified pages into its pool; ``POST
/v1/kv_export`` ships a prompt's cached run to a sibling (the router's
cross-replica pull).  :meth:`InferenceServer.kill` is abrupt death:
sockets severed unflushed, the engine reaped.

Tenant QoS: a request names its tenant by the ``X-Tenant`` header or the
``tenant`` field (header wins); ``tenant_weights`` x ``tenant_quota_tps``
is each tenant's token rate over a trailing window, and a tenant past it
sheds 429 with its own ``Retry-After``.  Behind a router (which holds the
fleet's ledger) the gate is a looser backstop (``tenant_backstop_x``).
"""

from __future__ import annotations

import asyncio
import functools
import json
import math
import threading
import time
import uuid

from ..core.observability import METRICS, get_logger
from . import lockstep as lockstep_lib
from .scheduler import ANON_TENANT

log = get_logger("server")

# How long a timed-out request waits for the engine to ack its cancel flag
# (one chunk away on a healthy engine) before answering the client anyway.
_TIMEOUT_ACK_GRACE_S = 10.0

# Structured error message partially-streamed requests receive when the
# engine restarts under them (their deltas cannot be retracted).
_RESTART_ERR = "engine restarted mid-stream; partial output could not be resumed"

# Mailbox-delivered error prefix for load-shed requests (queue deadline
# expired before admission): answered 503 with a Retry-After.
_SHED_ERR = "shed before admission: "

_MAX_REQUEST_LINE = 8192
_MAX_HEADERS = 100
_MAX_BODY = 8 * 1024 * 1024
_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}


class _Mailbox:
    """Per-request delivery queue, filled by the engine thread via
    call_soon_threadsafe, drained by the owning handler coroutine.
    ``finished`` flips once generation concluded; ``t0``/``first_seen``
    drive the TTFT histogram; ``cached_tokens`` is filled by the engine
    thread on first delivery; ``deadline`` is the absolute perf_counter
    deadline (None = none).  ``meta``/``delivered``/``retries`` are the
    supervisor's per-request state: the submit arguments, the tokens the
    ENGINE delivered (the zero-streamed test) and re-admissions used.
    ``export_ids``/``export_result`` serve the prefill-role handoff: a
    /v1/prefill request sets ``export_ids`` so the engine thread gathers
    the prompt's cached KV pages at the done delivery and stashes them in
    ``export_result`` BEFORE the done notify."""

    __slots__ = ("queue", "finished", "t0", "first_seen", "cached_tokens",
                 "deadline", "meta", "delivered", "retries",
                 "export_ids", "export_result")

    def __init__(self) -> None:
        self.queue: asyncio.Queue = asyncio.Queue()
        self.finished = False
        self.t0 = time.perf_counter()
        self.first_seen = False
        self.cached_tokens: int | None = None
        self.deadline: float | None = None
        self.meta: dict | None = None
        self.delivered = 0
        self.retries = 0
        self.export_ids: list[int] | None = None
        self.export_result: tuple | None = None  # ("done", payload|None)


class BadRequest(ValueError):
    pass


# The ONE tenant-id charset, shared with the router (which forwards valid
# ids verbatim and 400s the rest — never rewrites, so router and replica
# agree on what a malformed id means).  ASCII-only on purpose: an id is a
# metric label, a scheduler key, and a header value — Unicode lookalikes
# would split one tenant's accounting into mojibake buckets.
_TENANT_CHARS = frozenset(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789._-"
)

# Rate-ledger cardinality cap: admitting a NEW tenant id past this first
# ages every ledger and drops the empties (see _tenant_charge) — ids are
# client-minted, so the map must not grow with distinct-id count.
_TENANT_LEDGER_CAP = 4096


def valid_tenant_id(tenant) -> bool:
    # "-" (scheduler.ANON_TENANT) is reserved: a client claiming it would
    # alias its quota/fairness accounting onto all untagged traffic.
    return (isinstance(tenant, str) and 0 < len(tenant) <= 64
            and tenant != ANON_TENANT
            and all(c in _TENANT_CHARS for c in tenant))


def _field(req: dict, name: str, default, kind, *, minimum=None):
    v = req.get(name, default)
    if kind is int and isinstance(v, bool):  # bool passes isinstance(int)
        raise BadRequest(f"{name!r} must be an integer")
    if not isinstance(v, kind):
        raise BadRequest(f"{name!r} must be {kind.__name__}")
    if minimum is not None and v < minimum:
        raise BadRequest(f"{name!r} must be >= {minimum}")
    return v


def _stop_list(req: dict) -> list[str]:
    stop = req.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if (
        not isinstance(stop, list)
        or len(stop) > 4
        or not all(isinstance(s, str) and s for s in stop)
    ):
        raise BadRequest("'stop' must be a non-empty string or up to 4 of them")
    return stop


class InferenceServer:
    """Serve a ContinuousBatcher over HTTP.  See module docstring."""

    def __init__(
        self,
        batcher,
        model_name: str = "dlt-model",
        host: str = "0.0.0.0",
        port: int = 8000,
        max_pending: int = 256,
        batcher_factory=None,  # () -> fresh batcher; default batcher.respawn
        request_timeout_s: float | None = None,  # default per-request deadline
        watchdog_timeout_s: float = 30.0,  # /healthz stall threshold
        max_request_retries: int = 2,  # restart re-admissions per request
        # Estimated-cost admission gate: 429 (with Retry-After) when the
        # token mass already queued + resident would exceed this multiple
        # of the batcher's KV capacity.  None/0 disables the gate.
        shed_cost_factor: float | None = 2.0,
        # Grammar-constrained output (runtime/constrain.py): the
        # response_format / logit_bias / banned_tokens request fields.
        # False answers 400 to any constrained request (the operator
        # kill-switch: runtime.constrained_decoding / --no-constrained).
        constrained: bool = True,
        # Disaggregated serving role: "colocated" (prefill and decode in
        # one engine), "prefill" (serves /v1/prefill handoffs and ships
        # finished KV pages to decode engines over cluster/kv_transfer.py)
        # or "decode" (listens for KV_PAGES transfers and adopts verified
        # pages).  Both disaggregated roles need a paged batcher with the
        # automatic prefix cache: the handoff ships content-addressed
        # pool pages.
        role: str = "colocated",
        # Sender-side transfer hardening: per-attempt deadline, bounded
        # jittered-exponential retries, and a cap on concurrent in-flight
        # transfers.
        xfer_attempt_s: float = 5.0,
        xfer_max_retries: int = 3,
        max_inflight_transfers: int = 4,
        # Multi-tenant QoS (the gateway half; runtime/scheduler.py
        # TenantScheduler owns admission fairness): a tenant whose admitted
        # token mass (prompt + budget) over the trailing window would
        # exceed weight * tenant_quota_tps tokens/s sheds 429 with its own
        # Retry-After.  tenant_weights: {name: weight}, "*" the default.
        # None disables the rate gate.
        tenant_weights: "dict[str, float] | None" = None,
        tenant_quota_tps: float | None = None,
        tenant_rate_window_s: float = 10.0,
        # Behind a router that holds the fleet-wide tenant ledger, this
        # gateway's ledger is a LOOSE backstop: its allowance is multiplied
        # by this factor, so a bypassed router gate still meters.  None =
        # this gateway is the authority.
        tenant_backstop_x: float | None = None,
    ) -> None:
        if batcher.tokenizer is None:
            raise ValueError(
                "InferenceServer needs a batcher with a tokenizer "
                "(the completion API speaks text)"
            )
        if request_timeout_s is not None and request_timeout_s <= 0:
            raise ValueError(
                f"request_timeout_s must be > 0, got {request_timeout_s}"
            )
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"role must be colocated/prefill/decode, got {role!r}"
            )
        if role != "colocated" and (
            getattr(batcher, "pool", None) is None
            or getattr(batcher, "prefix_cache", None) is None
        ):
            raise ValueError(
                f"role {role!r} needs a paged batcher with the automatic "
                "prefix cache (paged_pages= + prefix_cache=True) — the "
                "KV handoff ships content-addressed pool pages"
            )
        self.batcher = batcher
        self.model_name = model_name
        self.host = host
        self.port = port
        self.max_pending = max_pending
        self._batcher_factory = batcher_factory
        self.request_timeout_s = request_timeout_s
        self.watchdog_timeout_s = watchdog_timeout_s
        self.max_request_retries = max_request_retries
        self.shed_cost_factor = shed_cost_factor
        self.role = role
        self.xfer_attempt_s = xfer_attempt_s
        self.xfer_max_retries = xfer_max_retries
        self.max_inflight_transfers = max_inflight_transfers
        self.constrained = bool(constrained)
        if tenant_quota_tps is not None and tenant_quota_tps <= 0:
            tenant_quota_tps = None  # the CLI/config "disable" spelling
        if tenant_rate_window_s <= 0:
            raise ValueError(
                f"tenant_rate_window_s must be > 0, got {tenant_rate_window_s}"
            )
        if tenant_backstop_x is not None and tenant_backstop_x < 1.0:
            raise ValueError(
                f"tenant_backstop_x must be >= 1 (a backstop looser than "
                f"the authority) or None, got {tenant_backstop_x}"
            )
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_default_weight = self.tenant_weights.pop("*", 1.0)
        self.tenant_quota_tps = tenant_quota_tps
        self.tenant_rate_window_s = tenant_rate_window_s
        self.tenant_backstop_x = tenant_backstop_x
        # Trailing-window admitted-token-mass ledger per tenant, for the
        # rate quota: deque of (perf_counter ts, est tokens), appended at
        # admission, aged out lazily.  Only the loop thread touches it.
        from collections import deque

        self._tenant_window: dict[str, "deque[tuple[float, int]]"] = {}  # guarded-by: event-loop
        self._xfer_sem: asyncio.Semaphore | None = None  # made on start()
        self._kv_server: asyncio.base_events.Server | None = None
        from ..cluster.kv_transfer import ReceiverStats

        self.kv_stats = ReceiverStats()  # KV listener: import accounting
        # Serializes (next_rid + submit) on the loop thread against the
        # supervisor's batcher swap on the engine thread, and guards the
        # mailbox registry and cancel-flag set.  Held only for host
        # bookkeeping; lock order is _submit_lock -> batcher._lock.
        self._submit_lock = threading.Lock()
        # A mailbox registered here and then stranded by an exception
        # blocks its handler forever; every raising path pops it.
        # graftflow: cleanup-required
        self._requests: dict[int, _Mailbox] = {}  # guarded-by: self._submit_lock
        self._cancelled: set[int] = set()  # guarded-by: self._submit_lock
        self._restarts = 0
        self._engine_dead = False  # respawn itself failed; serve errors
        self._last_progress = time.monotonic()  # engine watchdog stamp
        self._recover_t0: float | None = None  # crash time, for recovery_seconds
        self._work = threading.Event()
        self._stopping = False
        self._draining = False  # graceful stop: reject new, finish in-flight
        self._server: asyncio.base_events.Server | None = None
        self._engine: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._conns: set[asyncio.StreamWriter] = set()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self._xfer_sem = asyncio.Semaphore(self.max_inflight_transfers)
        if self.role == "decode" or (
            self.role == "colocated"
            and getattr(self.batcher, "pool", None) is not None
            and getattr(self.batcher, "prefix_cache", None) is not None
        ):
            # The KV import listener (always an ephemeral port; the fleet
            # records where it landed): prefill peers ship finished pages
            # here, and a paged prefix-cached COLOCATED replica is a
            # cross-replica pull target.
            self._kv_server = await asyncio.start_server(
                self._handle_kv, self.host, 0
            )
        self._engine = threading.Thread(
            target=self._engine_loop, name="dlt-serve-engine", daemon=True
        )
        self._engine.start()
        addr = self._server.sockets[0].getsockname()
        log.info(
            "serving %s (%s) on http://%s:%s/v1/completions",
            self.model_name, self.role, addr[0], addr[1],
        )
        return addr[0], addr[1]

    @property
    def kv_bound_port(self) -> int | None:
        """Where the KV import listener landed (None when this replica
        cannot import pages)."""
        if self._kv_server is None:
            return None
        return self._kv_server.sockets[0].getsockname()[1]

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self, drain_timeout: float = 0.0) -> None:
        """Stop serving.  ``drain_timeout > 0``: graceful — new requests
        get 503 while in-flight ones run to completion (up to the
        deadline), then the engine stops.  ``0``: immediate — in-flight
        rows are cancel-flagged and the engine drains within one chunk."""
        self._draining = True
        if drain_timeout > 0:
            loop = asyncio.get_running_loop()
            deadline = loop.time() + drain_timeout
            while (self._inflight() and loop.time() < deadline
                   and not self._stopping):
                await asyncio.sleep(0.05)
        self._stopping = True
        with self._submit_lock:
            for rid in list(self._requests):
                self._cancelled.add(rid)
        self._work.set()
        if self._engine is not None:
            await asyncio.to_thread(self._engine.join, 60.0)
        # Give handler coroutines a bounded window to flush their (partial)
        # responses before the connections are torn down.
        if self._loop is not None:
            deadline = self._loop.time() + 5.0
            while self._inflight() and self._loop.time() < deadline:
                await asyncio.sleep(0.02)
        if self._kv_server is not None:
            self._kv_server.close()
        if self._server is not None:
            self._server.close()
        # Sever every open connection (HTTP and KV) BEFORE awaiting
        # wait_closed: an open KV connection from a stalled peer would
        # otherwise hold shutdown.
        for w in list(self._conns):
            w.close()
        if self._server is not None:
            await self._server.wait_closed()
        if self._kv_server is not None:
            await self._kv_server.wait_closed()

    def force_stop(self) -> None:
        """Cut a graceful drain short (second SIGTERM/Ctrl-C)."""
        self._stopping = True

    async def kill(self) -> None:
        """Abrupt death (replica chaos drills, cluster/fleet.py): sever
        every open connection WITHOUT flushing, stop accepting, and reap
        the engine thread — the closest an in-process replica gets to
        SIGKILL.  Clients observe reset sockets mid-response, so a
        fronting router exercises its real failover path.  The engine
        thread waits for the batcher's device work before it exits
        (``ContinuousBatcher.quiesce``): a replica respawned after this
        is handed no memory a dead replay still writes."""
        self._draining = True
        self._stopping = True
        if self._server is not None:
            self._server.close()
        if self._kv_server is not None:
            self._kv_server.close()
        for w in list(self._conns):
            w.close()
        with self._submit_lock:
            for rid in list(self._requests):
                self._cancelled.add(rid)
        self._work.set()
        if self._engine is not None:
            # Cancel flags drain run() within one chunk; never block the loop.
            await asyncio.to_thread(self._engine.join, 60.0)
        if self._server is not None:
            await self._server.wait_closed()

    # -- engine thread -----------------------------------------------------

    def _inflight(self) -> int:
        """Registered (mailbox-holding) requests, from any thread."""
        with self._submit_lock:
            return len(self._requests)

    def _pending(self) -> bool:
        b = self.batcher
        # A verified KV handoff awaiting adoption, or a sibling's export,
        # counts as work too (the engine must wake to serve it).
        # Under lockstep a submission waits in the journal until the next
        # engine iteration queues it on every rank.
        lockstep = getattr(b, "lockstep", None)
        return (b.has_queued() or b.has_kv_imports() or b.has_kv_exports()
                or any(r.rid is not None for r in list(b.rows))
                or (lockstep is not None and bool(lockstep.pending())))

    def _pending_token_mass(self) -> int:
        """Estimated token mass the engine still has to absorb: every
        queued or resident request's prompt + budget."""
        b = self.batcher
        mass = 0
        for r in b.queue_snapshot():
            mass += len(r.ids) + r.max_new_tokens
        for row in list(b.rows):
            req = row.req
            if row.rid is not None and req is not None:
                mass += len(req.ids) + req.max_new_tokens
        return mass

    def _retry_after_s(self) -> int:
        """Retry-After hint for 429/503 answers: roughly how many
        pool-capacity drains of work are already committed, in [1, 30]."""
        cap = max(1, self.batcher.capacity_tokens())
        return int(min(30, max(1, -(-self._pending_token_mass() // cap))))

    # -- multi-tenant QoS: the gateway's rate-quota half -------------------

    @staticmethod
    def _parse_tenant(req: dict, tenant_hdr: str | None) -> str | None:
        """The request's tenant id: X-Tenant header first (proxies stamp
        identity), "tenant" body field as the fallback.  None = the
        anonymous bucket.  Malformed ids 400 — a tenant id becomes a
        metric label and a scheduler key, so the charset is tight."""
        tenant = tenant_hdr if tenant_hdr else req.get("tenant")
        if tenant is None or tenant == "":
            return None
        if not valid_tenant_id(tenant):
            raise BadRequest(
                "'tenant' must be 1-64 chars of [A-Za-z0-9._-] "
                "(X-Tenant header or body field)"
            )
        return tenant

    def _tenant_weight(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, self.tenant_default_weight)

    def _tenant_allowance(self, tenant: str) -> float:
        """Token mass the tenant's trailing window may hold HERE.  With a
        fronting router running the authoritative fleet ledger, the
        backstop factor loosens this gateway's cap (~2x fair share): it
        only trips when the router gate was bypassed or drilled — never
        a silent unmetered path, never a double gate at full strictness."""
        allowed = (self._tenant_weight(tenant) * self.tenant_quota_tps
                   * self.tenant_rate_window_s)
        if self.tenant_backstop_x is not None:
            allowed *= self.tenant_backstop_x
        return allowed

    # graftlint: holds(event-loop)
    def _tenant_retry_after(self, tenant: str, est: int) -> int | None:
        """Per-tenant token-rate gate (loop thread only).  Returns None
        when ``est`` more admission tokens fit the tenant's trailing-
        window quota (weight x tenant_quota_tps tokens/s), else the
        PER-TENANT Retry-After: when the tenant's own window has aged
        out enough room — unlike the global ``_retry_after_s`` hint,
        this is a promise about this tenant's ledger, not fleet load.
        The ``tenant.quota`` fault site (tag = tenant) can force the
        over-quota path for drills (action ``exhaust``)."""
        if self.tenant_quota_tps is None:
            return None
        win = self.tenant_rate_window_s
        allowed = self._tenant_allowance(tenant)
        now = time.perf_counter()
        ledger = self._tenant_window.get(tenant)
        forced = False
        plane = self.batcher.faults
        if plane is not None:
            # defer_stall: this gate runs on the event loop (a stall rule
            # must not freeze every handler and the fleet's probes).
            rule = plane.fire("tenant.quota", tag=tenant, defer_stall=True)
            forced = rule is not None and rule.action == "exhaust"
        if ledger:
            while ledger and ledger[0][0] <= now - win:
                ledger.popleft()
            if not ledger:  # fully aged out: drop the deque itself too
                del self._tenant_window[tenant]
                ledger = None
        used = sum(n for _, n in ledger) if ledger else 0
        if not forced and used + est <= allowed:
            return None
        # Walk the tenant's own ledger oldest-first: the hint is when
        # enough of ITS charges age out that est fits again.
        room_needed = used + est - allowed
        freed = 0.0
        hint = win
        for ts, n in (ledger or ()):
            freed += n
            if freed >= room_needed:
                hint = ts + win - now
                break
        return int(min(60, max(1, math.ceil(hint))))

    # graftlint: holds(event-loop)
    def _tenant_charge(self, tenant: str | None, est: int) -> None:
        """Record an accepted request's admission-time token mass on its
        tenant's trailing window (loop thread only) + per-tenant
        counters.  Anonymous requests bill the shared ANON bucket's
        ledger (the rate gate checks it) but mint no per-tenant
        metrics."""
        if tenant is not None:
            METRICS.inc(f"tenant.requests.{tenant}")
            METRICS.inc(f"tenant.admitted_tokens.{tenant}", est)
        if self.tenant_quota_tps is None:
            return  # no rate gate -> nothing ever ages the ledger; keep none
        from collections import deque

        key = tenant if tenant is not None else ANON_TENANT
        if key not in self._tenant_window \
                and len(self._tenant_window) >= _TENANT_LEDGER_CAP:
            # Cardinality bound: tenant ids are client-minted, so a new id
            # must not grow the map past the cap without first aging every
            # ledger and dropping the empties.  Ids still inside their
            # window are genuine concurrent tenants — those stay.
            cutoff = time.perf_counter() - self.tenant_rate_window_s
            for t in list(self._tenant_window):
                d = self._tenant_window[t]
                while d and d[0][0] <= cutoff:
                    d.popleft()
                if not d:
                    del self._tenant_window[t]
        ledger = self._tenant_window.setdefault(key, deque())
        ledger.append((time.perf_counter(), est))

    def _engine_loop(self) -> None:
        while True:
            lockstep = getattr(self.batcher, "lockstep", None)
            if lockstep is not None and lockstep.leader:
                # Rank 0 of a mesh: an idle beat now and then keeps the
                # following ranks' waits under the group's timeout.
                if not self._work.wait(timeout=lockstep_lib.BEAT_S):
                    lockstep.beat()
                    continue
            else:
                self._work.wait()
            self._work.clear()
            if self._stopping:
                # Drain before exiting: a request submitted between the last
                # run and stop() would otherwise block its handler forever.
                with self._submit_lock:
                    for rid in list(self._requests):
                        self.batcher.cancel_row(rid)
                        self._cancelled.discard(rid)
                        self._notify(rid, [], True,
                                     err="server is shutting down")
                # The device work this batcher enqueued runs out before the
                # thread ends: stop() and kill() join it, and whatever is
                # allocated after that may reuse this batcher's memory.
                self.batcher.quiesce()
                if lockstep is not None and lockstep.leader:
                    lockstep.stop()  # the following ranks' loops end
                return
            if not self._pending():
                continue
            self._last_progress = time.monotonic()
            try:
                self.batcher.run(on_tokens=self._deliver)
            except Exception:
                log.exception("batcher.run crashed; supervising a restart")
                try:
                    self._recover_engine()
                except Exception:
                    log.exception(
                        "engine recovery failed; failing in-flight requests"
                    )
                    self._engine_dead = True
                    with self._submit_lock:
                        for rid in list(self._requests):
                            self._cancelled.discard(rid)
                            self._notify(rid, [], True,
                                         err="engine unrecoverable")
                    return
                continue
            # run() accumulated per-rid results we already streamed; drop
            # them so a long-lived server's memory stays flat.
            self.batcher.results.clear()
            self.batcher.result_logprobs.clear()
            self.batcher.prefix_cached_tokens.clear()
            self.batcher.shed.clear()

    def _recover_engine(self) -> None:
        """Supervisor (engine thread): replace the crashed batcher with a
        fresh one.  Zero-streamed requests re-admit under their ORIGINAL
        rid with a bounded retry budget (temperature-0 recompute is
        exact); partially-streamed ones fail with a structured error."""
        crash_t = time.monotonic()
        old = self.batcher
        try:
            # The crashed batcher's chunks in flight run out before its
            # successor allocates from the same caching allocator.
            old.quiesce()
        except Exception:
            log.exception("waiting for the crashed batcher's device work")
        new = (self._batcher_factory() if self._batcher_factory is not None
               else old.respawn())
        # Named prefixes are device KV the batcher only reads; carry them
        # over so registered system prompts survive the restart.
        new.prefixes.update(old.prefixes)
        retried: list[int] = []
        failed: list[int] = []
        with self._submit_lock:
            for rid in sorted(self._requests):
                mbox = self._requests[rid]
                meta = mbox.meta
                if rid in self._cancelled:
                    self._cancelled.discard(rid)
                    self._notify(rid, [], True)
                    continue
                if (meta is not None
                        and mbox.delivered == 0
                        and mbox.retries < self.max_request_retries):
                    mbox.retries += 1
                    new._next_rid = rid
                    try:
                        got = new.submit(meta["ids"], **{
                            k: v for k, v in meta.items() if k != "ids"
                        })
                        assert got == rid
                        retried.append(rid)
                        continue
                    except (ValueError, KeyError):
                        log.exception("re-admission of rid %d failed", rid)
                failed.append(rid)
                self._cancelled.discard(rid)
                self._notify(rid, [], True, err=_RESTART_ERR)
            new._next_rid = old._next_rid  # rid continuity across the swap
            # Transplant VERIFIED KV imports awaiting adoption: their
            # payloads are host-side and their KV-listener coroutines are
            # waiting.  Queued EXPORTS cannot transplant (the crashed
            # pool's pages died with it): answer each "nothing to export"
            # now instead of stranding it for the export timeout.
            with old._lock:
                pending_imports = list(old._kv_imports)
                old._kv_imports.clear()
                pending_exports = list(old._kv_exports)
                old._kv_exports.clear()
            if pending_imports:
                with new._lock:
                    new._kv_imports.extend(pending_imports)
            for _ids, on_done in pending_exports:
                try:
                    on_done(None)
                except Exception:
                    log.exception("kv-export completion callback raised")
            self.batcher = new
        self._restarts += 1
        if retried:
            self._recover_t0 = crash_t
        else:
            METRICS.observe(
                "server.recovery_seconds", time.monotonic() - crash_t
            )
            self._recover_t0 = None
        METRICS.inc("server.engine_restarts")
        if retried:
            METRICS.inc("server.requests_retried", len(retried))
        new.assert_pool_consistent()
        log.warning(
            "engine restarted (#%d): %d request(s) re-admitted, %d failed "
            "partially-streamed", self._restarts, len(retried), len(failed),
        )
        self._last_progress = time.monotonic()
        if retried or self._pending():
            self._work.set()

    def _deliver(self, rid: int, toks: list[int], done: bool,
                 lps: list[float] | None = None) -> None:
        # Engine thread, between device chunks: the one safe point to act
        # on loop-side cancel flags.
        self._last_progress = time.monotonic()  # watchdog: engine is moving
        if self._recover_t0 is not None:
            METRICS.observe(
                "server.recovery_seconds", time.monotonic() - self._recover_t0
            )
            self._recover_t0 = None
        # A done delivery for a rid the batcher SHED carries the shed
        # reason as a structured error (503 + Retry-After, not empty 200).
        shed = self.batcher.shed.pop(rid, None) if done else None
        err = (_SHED_ERR + shed) if shed is not None else None
        if done:
            # Prefill-role handoff: gather the finished prompt's cached
            # pages HERE, on the engine thread (the only thread that may
            # touch the device), OUTSIDE the submission lock, and stash the
            # payload before the done notify is queued.
            with self._submit_lock:
                mb = self._requests.get(rid)
                export_ids = mb.export_ids if mb is not None else None
            if export_ids is not None and err is None:
                try:
                    payload = self.batcher.export_prefix_pages(export_ids)
                except Exception:
                    log.exception("kv page export failed for rid %d", rid)
                    payload = None
                with self._submit_lock:
                    mb = self._requests.get(rid)
                    if mb is not None:
                        mb.export_result = ("done", payload)
        with self._submit_lock:
            mbox = self._requests.get(rid)
            if mbox is not None and toks:
                mbox.delivered += len(toks)
            if mbox is not None and mbox.cached_tokens is None:
                mbox.cached_tokens = \
                    self.batcher.prefix_cached_tokens.get(rid, 0)
            cancelled = rid in self._cancelled
            self._cancelled.discard(rid)
            if cancelled and not done:
                self.batcher.cancel_row(rid)
            self._notify(rid, toks, True if cancelled else done,
                         err=err, lps=lps)
            self._sweep_cancelled(exclude=rid)

    # graftlint: holds(self._submit_lock)
    def _sweep_cancelled(self, exclude: int) -> None:
        """Consume cancel flags for OTHER rids at this chunk boundary (a
        QUEUED request has no deliveries of its own to see its flag).
        Caller holds _submit_lock."""
        for other in list(self._cancelled):
            if other == exclude:
                continue
            if self.batcher.cancel_row(other):
                self._cancelled.discard(other)
                self._notify(other, [], True)

    # graftlint: holds(self._submit_lock)
    def _notify(self, rid: int, toks: list[int], done: bool,
                err: str | None = None, lps: list[float] | None = None):
        """Queue one delivery onto the rid's mailbox (caller holds
        _submit_lock)."""
        mbox = self._requests.get(rid)
        if mbox is not None and self._loop is not None:
            self._loop.call_soon_threadsafe(
                mbox.queue.put_nowait,
                (list(toks), done, err, list(lps) if lps else None),
            )

    # -- HTTP plumbing -----------------------------------------------------

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._conns.add(writer)
        t0 = time.perf_counter()  # request receipt: latency clocks start here
        try:
            try:
                method, path, body, tenant_hdr = await asyncio.wait_for(
                    self._read_request(writer, reader), 30.0
                )
            except _Responded:
                return
            await self._route(writer, method, path, body, t0,
                              tenant_hdr=tenant_hdr)
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError,
                EOFError):  # IncompleteReadError: client hung up mid-body
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _read_request(
        self, writer, reader
    ) -> tuple[str, str, bytes, str | None]:
        line = await reader.readline()
        if len(line) > _MAX_REQUEST_LINE:
            await self._plain(writer, 431, "request line too long")
            raise _Responded
        parts = line.decode("latin-1", "replace").split()
        if len(parts) < 2:
            await self._plain(writer, 400, "bad request")
            raise _Responded
        method, path = parts[0], parts[1]
        content_len = 0
        tenant_hdr: str | None = None
        for _ in range(_MAX_HEADERS):
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1", "replace").partition(":")
            hname = name.strip().lower()
            if hname == "content-length":
                try:
                    content_len = int(value.strip())
                except ValueError:
                    await self._plain(writer, 400, "bad content-length")
                    raise _Responded
            elif hname == "transfer-encoding":
                await self._plain(writer, 501, "chunked bodies not supported")
                raise _Responded
            elif hname == "x-tenant":
                tenant_hdr = value.strip()
        else:
            await self._plain(writer, 431, "too many headers")
            raise _Responded
        if content_len > _MAX_BODY:
            await self._plain(writer, 413, "body too large")
            raise _Responded
        body = await reader.readexactly(content_len) if content_len else b""
        return method, path, body, tenant_hdr

    def health(self) -> tuple[int, dict]:
        """Readiness/liveness report behind GET /healthz: non-200 while
        draining or when the engine is dead/stalled (in-flight work but no
        delivery within ``watchdog_timeout_s``)."""
        age = time.monotonic() - self._last_progress
        alive = (not self._engine_dead
                 and self._engine is not None and self._engine.is_alive())
        with self._submit_lock:
            inflight = len(self._requests)
            cancels = bool(self._cancelled)
        busy = inflight > 0 or cancels or self._pending()
        stalled = busy and age > self.watchdog_timeout_s
        healthy = alive and not stalled and not self._draining
        METRICS.set_gauge("server.engine_last_chunk_age_s", age)
        status = ("ok" if healthy
                  else "draining" if self._draining and alive and not stalled
                  else "unhealthy")
        return (200 if healthy else 503), {
            "status": status,
            # The router places completions only on decode-capable
            # replicas and handoffs only on prefill ones.
            "role": self.role,
            "engine_alive": alive,
            "engine_stalled": stalled,
            "seconds_since_last_chunk": round(age, 3),
            "draining": self._draining,
            "inflight_requests": inflight,
            "engine_restarts": self._restarts,
            "committed_tokens": self._pending_token_mass(),
        }

    async def _route(self, writer, method: str, path: str, body: bytes,
                     t0: float, tenant_hdr: str | None = None) -> None:
        if method == "GET" and path == "/healthz":
            code, report = self.health()
            await self._json(writer, code, report, headers=(
                None if code == 200
                else {"Retry-After": str(self._retry_after_s())}
            ))
        elif method == "GET" and path == "/metrics":
            METRICS.set_gauge(
                "server.engine_last_chunk_age_s",
                time.monotonic() - self._last_progress,
            )
            if self.batcher.pool is not None:  # contiguous mode has none
                self.batcher.pool.publish_gauges()
            await self._respond(
                writer, 200, "text/plain; version=0.0.4; charset=utf-8",
                METRICS.prometheus_text().encode(),
            )
        elif method == "GET" and path == "/v1/models":
            await self._json(writer, 200, {
                "object": "list",
                "data": [{
                    "id": self.model_name, "object": "model",
                    "owned_by": "distributed-llms-tpu",
                }],
            })
        elif method == "POST" and path in ("/v1/completions", "/v1/chat/completions"):
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise BadRequest("request body must be a JSON object")
                await self._completions(writer, req, chat="chat" in path,
                                        t0=t0, tenant_hdr=tenant_hdr)
            except (BadRequest, json.JSONDecodeError) as e:
                await self._json(writer, 400, _err_body(str(e)))
        elif method == "POST" and path == "/v1/prefill":
            if self.role != "prefill":
                await self._json(writer, 404, _err_body(
                    "this replica does not serve prefill handoffs "
                    f"(role {self.role!r})"
                ))
                return
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise BadRequest("request body must be a JSON object")
                await self._prefill(writer, req)
            except (BadRequest, json.JSONDecodeError) as e:
                await self._json(writer, 400, _err_body(str(e)))
        elif method == "POST" and path == "/v1/kv_export":
            # Cross-replica pull source (any role with a paged prefix
            # cache): export a prompt's CACHED page run to a sibling's KV
            # listener — no admission, no recompute; "nothing to export"
            # when the run is not resident.
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise BadRequest("request body must be a JSON object")
                await self._kv_export(writer, req)
            except (BadRequest, json.JSONDecodeError) as e:
                await self._json(writer, 400, _err_body(str(e)))
        elif method not in ("GET", "POST"):
            await self._plain(writer, 405, "method not allowed")
        else:
            await self._plain(writer, 404, "not found")

    # -- the completion core ----------------------------------------------

    def _parse_prompt(self, req: dict, chat: bool) -> tuple[list[int], str]:
        tok = self.batcher.tokenizer
        if chat:
            messages = req.get("messages")
            if (
                not isinstance(messages, list) or not messages
                or not all(
                    isinstance(m, dict)
                    and isinstance(m.get("role"), str)
                    and isinstance(m.get("content"), str)
                    for m in messages
                )
            ):
                raise BadRequest(
                    "'messages' must be a non-empty list of "
                    "{role, content} objects"
                )
            text = tok.apply_chat_template(messages)
            return tok.encode(text), text
        prompt = req.get("prompt")
        if isinstance(prompt, str) and prompt:
            return tok.encode(prompt), prompt
        if (
            isinstance(prompt, list) and prompt
            and all(isinstance(t, int) and not isinstance(t, bool) for t in prompt)
        ):
            return list(prompt), ""
        raise BadRequest("'prompt' must be a non-empty string or token-id list")

    def _parse_sampling(self, req: dict):
        """Per-request temperature/top_p/top_k ride the batcher's per-row
        sampling path; presence/frequency penalties its penalized plan.
        Returns (temperature, top_p, top_k, presence_penalty,
        frequency_penalty)."""
        out = []
        for name in ("temperature", "top_p"):
            want = req.get(name)
            if want is None:
                out.append(None)
                continue
            if not isinstance(want, (int, float)) or isinstance(want, bool):
                raise BadRequest(f"{name!r} must be a number")
            want = float(want)
            if not math.isfinite(want):  # json.loads accepts Infinity/NaN
                raise BadRequest(f"{name!r} must be finite")
            if name == "temperature" and not 0.0 <= want:
                raise BadRequest("'temperature' must be >= 0")
            if name == "top_p" and not 0.0 < want <= 1.0:
                raise BadRequest("'top_p' must be in (0, 1]")
            out.append(want)
        for name in ("presence_penalty", "frequency_penalty"):
            pen = req.get(name)
            if pen is None:
                out.append(0.0)
                continue
            if not isinstance(pen, (int, float)) or isinstance(pen, bool):
                raise BadRequest(f"{name!r} must be a number")
            # The range is submit()'s to check: its ValueError becomes a
            # 400 at the call site.
            out.append(float(pen))
        want_k = req.get("top_k")
        if want_k is not None:
            if not isinstance(want_k, int) or isinstance(want_k, bool) \
                    or want_k < 0:
                raise BadRequest("'top_k' must be an integer >= 0")
        return out[0], out[1], want_k, out[2], out[3]

    async def _completions(self, writer, req: dict, chat: bool,
                           t0: float | None = None,
                           tenant_hdr: str | None = None) -> None:
        if t0 is None:
            t0 = time.perf_counter()
        prompt_ids, _ = self._parse_prompt(req, chat)
        max_tokens = _field(
            req, "max_completion_tokens" if chat else "max_tokens",
            req.get("max_tokens", 16), int, minimum=1,
        )
        stream = bool(req.get("stream", False))
        stop = _stop_list(req)
        prefix = req.get("prefix")
        if prefix is not None and not isinstance(prefix, str):
            raise BadRequest("'prefix' must be the name of a registered "
                             "prefix")
        use_cache = req.get("prefix_cache", True)
        if not isinstance(use_cache, bool):
            raise BadRequest("'prefix_cache' must be a boolean")
        temperature, top_p, top_k, pres_pen, freq_pen = \
            self._parse_sampling(req)
        response_format = req.get("response_format")
        logit_bias = req.get("logit_bias")
        banned_tokens = req.get("banned_tokens")
        dfa = None
        if (response_format is not None or logit_bias is not None
                or banned_tokens is not None):
            if not self.constrained:
                raise BadRequest(
                    "constrained decoding is disabled on this server "
                    "(runtime.constrained_decoding / --no-constrained)"
                )
            from . import constrain as constrain_lib

            b = self.batcher
            try:
                # Compile (or hit the LRU) OFF the event loop: a large
                # schema's automaton is host numpy work measured in wall
                # time.  The automaton itself goes to submit(): a second
                # lookup could miss after an eviction and rebuild here.
                dfa = await asyncio.to_thread(
                    constrain_lib.compile_request,
                    response_format, logit_bias, banned_tokens,
                    tokenizer=b.tokenizer, vocab_size=b.cfg.vocab_size,
                    eos_id=b.eos_id,
                )
            except constrain_lib.ConstraintError as e:
                # Malformed schema / regex / bias: a structured 400 before
                # any admission state exists.
                raise BadRequest(str(e)) from None
        lp_req = req.get("logprobs")
        if lp_req is None or lp_req is False:
            want_lp = False
        elif lp_req is True or (isinstance(lp_req, int)
                                and not isinstance(lp_req, bool)
                                and lp_req == 0):
            want_lp = True
        else:
            raise BadRequest(
                "'logprobs' top-alternatives are not supported; pass true "
                "(or 0) for chosen-token logprobs"
            )
        n = _field(req, "n", 1, int, minimum=1)
        if n > 8:
            raise BadRequest("'n' must be <= 8")
        timeout_s = req.get("timeout_s")
        if timeout_s is not None:
            if (not isinstance(timeout_s, (int, float))
                    or isinstance(timeout_s, bool)
                    or not math.isfinite(float(timeout_s))
                    or float(timeout_s) <= 0):
                raise BadRequest("'timeout_s' must be a positive number")
            timeout_s = float(timeout_s)
        else:
            timeout_s = self.request_timeout_s  # server-wide default (maybe None)
        priority = req.get("priority", 0)
        if (isinstance(priority, bool) or not isinstance(priority, int)
                or not -(2**31) <= priority < 2**31):
            raise BadRequest("'priority' must be an integer")
        tenant = self._parse_tenant(req, tenant_hdr)
        # THE admission-token estimate (prompt + budget per choice): the
        # cost gate, the tenant rate gate and the ledger charge all read
        # it, so what is gated is exactly what is billed.
        est = n * (len(prompt_ids) + max_tokens)
        # Shed gates, all BEFORE any delivery state is registered.
        if self._inflight() + n > self.max_pending:
            await self._shed_json(
                writer, 429, "server request queue is full", "queue_full"
            )
            return
        if self.shed_cost_factor:
            mass = self._pending_token_mass() + est
            cap = self.batcher.capacity_tokens()
            if mass > self.shed_cost_factor * cap:
                await self._shed_json(
                    writer, 429,
                    f"server overloaded: {mass} tokens of work queued "
                    f"against {cap}-token KV capacity", "cost_gate",
                )
                return
        if self.tenant_quota_tps is not None:
            # Per-tenant token-rate quota: shed with the TENANT's own
            # Retry-After (when its trailing window frees) — the other
            # tenants' headroom is none of this request's business.
            # Untagged requests bill the shared ANONYMOUS bucket at the
            # default weight (scheduler parity) — dropping the X-Tenant
            # header is not an escape hatch from the rate gate.
            key = tenant if tenant is not None else ANON_TENANT
            allowed = self._tenant_allowance(key)
            if est > allowed:
                # Bigger than the tenant's ENTIRE window allowance: a 429
                # would promise a Retry-After that can never come true
                # (the ledger can't free room the quota doesn't hold) —
                # this is a malformed-for-this-tenant request, not load.
                await self._json(writer, 400, _err_body(
                    f"request needs {est} admission tokens but tenant "
                    f"{key!r}'s quota window holds at most {int(allowed)}"
                ))
                return
            hint = self._tenant_retry_after(key, est)
            if hint is not None:
                if tenant is not None:
                    METRICS.inc(f"tenant.shed.{tenant}")
                # A backstop trip is a DIFFERENT event from an ordinary
                # quota shed: the authoritative (router) gate let ~2x
                # fair share through — it was bypassed, drilled, or is
                # misconfigured — and dashboards must see that class.
                await self._shed_json(
                    writer, 429,
                    f"tenant {key!r} over its token-rate quota "
                    f"({est} tokens would exceed the "
                    f"{self.tenant_rate_window_s:g}s window)",
                    "tenant_backstop" if self.tenant_backstop_x is not None
                    else "tenant_quota", retry_after=hint,
                )
                return
        if self._draining and not self._stopping:
            await self._json(
                writer, 503, _err_body("server is draining"),
                headers={"Retry-After": str(self._retry_after_s())},
            )
            return
        if self._stopping:
            await self._json(writer, 500, _err_body("server is shutting down"))
            return
        if self._engine_dead:
            await self._json(
                writer, 500, _err_body("engine unrecoverable", "engine_error")
            )
            return
        # One batcher request per choice.  Register each mailbox BEFORE its
        # submit: the engine thread may admit + deliver the moment the
        # request hits the queue.
        deadline = t0 + timeout_s if timeout_s is not None else None
        meta = dict(
            ids=list(prompt_ids), max_new_tokens=max_tokens, prefix=prefix,
            temperature=temperature, top_p=top_p, top_k=top_k,
            presence_penalty=pres_pen, frequency_penalty=freq_pen,
            prefix_cache=use_cache, priority=priority, deadline=deadline,
            response_format=response_format, logit_bias=logit_bias,
            banned_tokens=banned_tokens, constraint=dfa, tenant=tenant,
        )
        subs: list[tuple[int, int, _Mailbox]] = []  # (choice index, rid, mbox)
        sub_err: Exception | None = None
        mboxes: list[_Mailbox] = []
        for _ in range(n):
            mbox = _Mailbox()
            mbox.t0 = t0  # latency clocks run from request receipt
            mbox.deadline = deadline
            mbox.meta = meta
            mboxes.append(mbox)
        with self._submit_lock:
            for idx, mbox in enumerate(mboxes):
                rid = self.batcher.next_rid
                self._requests[rid] = mbox
                try:
                    got = self.batcher.submit(
                        prompt_ids, max_new_tokens=max_tokens, prefix=prefix,
                        temperature=temperature, top_p=top_p, top_k=top_k,
                        presence_penalty=pres_pen, frequency_penalty=freq_pen,
                        prefix_cache=use_cache, priority=priority,
                        deadline=deadline, response_format=response_format,
                        logit_bias=logit_bias, banned_tokens=banned_tokens,
                        constraint=dfa, tenant=tenant,
                    )
                    assert got == rid
                except (ValueError, KeyError) as e:
                    self._requests.pop(rid, None)
                    for _, r, _m in subs:
                        self._cancelled.add(r)
                        self._requests.pop(r, None)
                    sub_err = e
                    break
                except BaseException:
                    self._requests.pop(rid, None)
                    for _, r, _m in subs:
                        self._cancelled.add(r)
                        self._requests.pop(r, None)
                    raise
                subs.append((idx, rid, mbox))
        if sub_err is not None:
            self._work.set()  # let an idle engine drain the flags
            await self._json(writer, 400, _err_body(str(sub_err)))
            return
        # The rate ledger charges the ACCEPTED request: after the last gate
        # and a fully successful submit.
        self._tenant_charge(tenant, est)
        self._work.set()
        METRICS.inc("server.requests")
        try:
            oid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
            created = int(time.time())
            if stream:
                await self._serve_stream(
                    writer, subs, stop, chat, oid, created, want_lp
                )
            else:
                await self._serve_blocking(
                    writer, subs, stop, chat, oid, created,
                    len(prompt_ids), want_lp
                )
        except (ConnectionError, OSError, asyncio.TimeoutError):
            METRICS.inc("server.disconnects")
        finally:
            METRICS.observe(
                "server.request_seconds",
                time.perf_counter() - subs[0][2].t0,
            )
            # Rows still generating get cancel-flagged; the engine consumes
            # the flag at its next delivery.
            with self._submit_lock:
                for _, rid, mbox in subs:
                    if mbox.finished:
                        self._cancelled.discard(rid)
                    else:
                        self._cancelled.add(rid)
                    self._requests.pop(rid, None)

    # -- disaggregated serving: prefill handoff + KV import ---------------

    async def _prefill(self, writer, req: dict) -> None:
        """Prefill-role front door (``POST /v1/prefill``): run the
        prompt through this engine's ordinary admission (max_new_tokens=1,
        automatic prefix caching ON — the prompt's full pages publish
        content-addressed), export the cached run, and SHIP it to the
        requesting decode engine's KV listener over cluster/kv_transfer.py
        — per-attempt deadline, bounded jittered-exponential retries,
        bounded in-flight transfers.  Every outcome is a structured JSON
        answer; the router treats anything but ``ok: true`` as a handoff
        failure and degrades to colocated prefill."""
        from ..cluster import kv_transfer
        from .faults import InjectedFault

        plane = self.batcher.faults
        if plane is not None:
            # Injection site "prefill.crash": the mid-handoff death drill.
            # close/raise = abrupt replica death (sockets severed
            # unflushed) — the router observes a reset, not an answer.
            try:
                rule = plane.fire("prefill.crash", defer_stall=True)
            except InjectedFault:
                rule = None
                await self.kill()
                return
            if rule is not None and rule.action == "close":
                await self.kill()
                return
            if rule is not None and rule.action in ("delay", "stall"):
                await asyncio.sleep(rule.arg or 0.0)
        prompt_ids, _ = self._parse_prompt(req, chat=False)
        kv_host = req.get("kv_host")
        kv_port = req.get("kv_port")
        transfer_id = req.get("transfer_id")
        if not isinstance(kv_host, str) or not kv_host:
            raise BadRequest("'kv_host' must be a non-empty string")
        if (isinstance(kv_port, bool) or not isinstance(kv_port, int)
                or not 0 < kv_port < 65536):
            raise BadRequest("'kv_port' must be a TCP port")
        if not isinstance(transfer_id, str) or not transfer_id:
            raise BadRequest("'transfer_id' must be a non-empty string")
        if self._inflight() + 1 > self.max_pending:
            await self._shed_json(
                writer, 429, "server request queue is full", "queue_full"
            )
            return
        if self._draining and not self._stopping:
            await self._json(
                writer, 503, _err_body("server is draining"),
                headers={"Retry-After": str(self._retry_after_s())},
            )
            return
        if self._stopping:
            await self._json(writer, 500, _err_body("server is shutting down"))
            return
        if self._engine_dead:
            await self._json(
                writer, 500, _err_body("engine unrecoverable", "engine_error")
            )
            return
        METRICS.inc("server.prefill_requests")
        meta = dict(ids=list(prompt_ids), max_new_tokens=1,
                    prefix_cache=True)
        with self._submit_lock:
            rid = self.batcher.next_rid
            mbox = _Mailbox()
            mbox.meta = meta
            mbox.export_ids = list(prompt_ids)
            self._requests[rid] = mbox
            try:
                got = self.batcher.submit(
                    prompt_ids, max_new_tokens=1, prefix_cache=True
                )
                assert got == rid
            except (ValueError, KeyError) as e:
                self._requests.pop(rid, None)
                await self._json(writer, 400, _err_body(str(e)))
                return
            except BaseException:
                self._requests.pop(rid, None)
                raise
        self._work.set()
        try:
            fail = None
            while True:
                try:
                    _toks, done, err, _lps = await asyncio.wait_for(
                        mbox.queue.get(), 60.0
                    )
                except asyncio.TimeoutError:
                    fail = "prefill timed out"
                    break
                if done:
                    mbox.finished = True
                    if err is not None:
                        fail = err
                    break
        finally:
            with self._submit_lock:
                if not mbox.finished:
                    self._cancelled.add(rid)
                self._requests.pop(rid, None)
        if fail is not None:
            await self._json(writer, 500, _err_body(fail, _err_type(fail)))
            return
        export = mbox.export_result
        payload = export[1] if export is not None else None
        if payload is None:
            # Nothing shipped: prompt under one full page, caching off,
            # or the run was evicted before the gather.  Not an error —
            # the router simply serves the request colocated.
            await self._json(writer, 200, {
                "ok": False, "reason": "nothing to export", "pages": 0,
            })
            return
        digests, k_pages, v_pages = payload
        # b64 of a multi-MB payload runs off the loop: this same loop
        # answers the fleet's /healthz probes.
        msg = await asyncio.to_thread(
            kv_transfer.encode_kv_pages, kv_transfer.KVTransferPayload(
                transfer_id=transfer_id,
                token_ids=list(
                    prompt_ids[: len(digests) * self.batcher.page_size]
                ),
                page_size=self.batcher.page_size,
                digests=digests, k_pages=k_pages, v_pages=v_pages,
            ),
        )
        async with self._xfer_sem:
            res = await kv_transfer.send_kv_pages(
                kv_host, kv_port, msg, faults=plane,
                attempt_s=self.xfer_attempt_s,
                max_retries=self.xfer_max_retries,
            )
        await self._json(writer, 200, {
            "ok": res.ok, "reason": res.reason, "attempts": res.attempts,
            "pages": len(digests),
            "tokens": len(digests) * self.batcher.page_size,
            "bytes": res.bytes_sent,
            "digests": [d.hex() for d in digests],
        })

    async def _kv_export(self, writer, req: dict) -> None:
        """Cross-replica pull source (``POST /v1/kv_export``, from the
        router's fleet digest directory): gather the prompt's longest
        CACHED page run — engine thread, at a round boundary; nothing is
        admitted or recomputed here — and ship it to the pulling decode
        replica's KV listener over cluster/kv_transfer.py, verified and
        retried exactly like a prefill handoff.  The ``xfer.pull`` fault
        site (tag = transfer id) drills the ship path: 'drop' refuses the
        export, 'corrupt' flips payload bytes after the checksum (the
        puller-side verify NACKs every attempt), 'dup' ships the verified
        frame twice (the receiver absorbs the duplicate), 'delay' stalls
        toward the router's pull deadline.  Every outcome is a structured
        JSON answer; anything but ``ok: true`` makes the router degrade
        to local recompute — byte-exact regardless."""
        from ..cluster import kv_transfer

        prompt_ids, _ = self._parse_prompt(req, chat=False)
        kv_host = req.get("kv_host")
        kv_port = req.get("kv_port")
        transfer_id = req.get("transfer_id")
        if not isinstance(kv_host, str) or not kv_host:
            raise BadRequest("'kv_host' must be a non-empty string")
        if (isinstance(kv_port, bool) or not isinstance(kv_port, int)
                or not 0 < kv_port < 65536):
            raise BadRequest("'kv_port' must be a TCP port")
        if not isinstance(transfer_id, str) or not transfer_id:
            raise BadRequest("'transfer_id' must be a non-empty string")
        if self._stopping or self._draining or self._engine_dead:
            await self._json(writer, 200, {
                "ok": False, "reason": "replica unavailable", "pages": 0,
            })
            return
        plane = self.batcher.faults
        rule = None
        if plane is not None:
            # defer_stall: this handler runs on the serving event loop —
            # a delay/stall rule is applied as an awaited sleep below.
            rule = plane.fire("xfer.pull", tag=transfer_id,
                              defer_stall=True)
        if rule is not None and rule.action == "drop":
            await self._json(writer, 200, {
                "ok": False, "reason": "pull dropped (drill)", "pages": 0,
            })
            return
        if rule is not None and rule.action in ("delay", "stall"):
            await asyncio.sleep(rule.arg or 0.0)
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def on_done(payload) -> None:
            # Engine thread -> loop: same crossing as mailbox deliveries.
            def settle() -> None:
                if not fut.done():
                    fut.set_result(payload)

            loop.call_soon_threadsafe(settle)

        with self._submit_lock:
            self.batcher.submit_kv_export(list(prompt_ids), on_done)
        self._work.set()
        try:
            # Bounded so a crashed engine cannot wedge the router's pull
            # (which has its own, shorter deadline) or leak this handler.
            payload = await asyncio.wait_for(fut, 30.0)
        except asyncio.TimeoutError:
            await self._json(writer, 200, {
                "ok": False, "reason": "export timed out", "pages": 0,
            })
            return
        if payload is None:
            # Run not resident: prompt under one full page, caching off,
            # or the pages were evicted since the directory entry was
            # recorded (a stale answer).  Not an error — the router
            # recomputes locally.
            await self._json(writer, 200, {
                "ok": False, "reason": "nothing to export", "pages": 0,
            })
            return
        digests, k_pages, v_pages = payload
        # b64 of a multi-MB payload runs off the loop: this same loop
        # answers the fleet's /healthz probes.
        msg = await asyncio.to_thread(
            kv_transfer.encode_kv_pages, kv_transfer.KVTransferPayload(
                transfer_id=transfer_id,
                token_ids=list(
                    prompt_ids[: len(digests) * self.batcher.page_size]
                ),
                page_size=self.batcher.page_size,
                digests=digests, k_pages=k_pages, v_pages=v_pages,
            ),
        )
        if rule is not None and rule.action == "corrupt":
            # Post-checksum bit-flip: the frame parses but can never
            # verify — the pull target NACKs every attempt and the
            # router degrades to local recompute, cache unpoisoned.
            msg = kv_transfer.corrupt_payload(msg)
        async with self._xfer_sem:
            res = await kv_transfer.send_kv_pages(
                kv_host, kv_port, msg, faults=plane,
                attempt_s=self.xfer_attempt_s,
                max_retries=self.xfer_max_retries,
            )
            if res.ok and rule is not None and rule.action == "dup":
                # Deliver the verified frame AGAIN: the receiver's digest
                # check absorbs it ("duplicate" ack), pinning pull-path
                # idempotence.
                await kv_transfer.send_kv_pages(
                    kv_host, kv_port, msg, faults=plane,
                    attempt_s=self.xfer_attempt_s,
                    max_retries=self.xfer_max_retries,
                )
        await self._json(writer, 200, {
            "ok": res.ok, "reason": res.reason, "attempts": res.attempts,
            "pages": len(digests),
            "tokens": len(digests) * self.batcher.page_size,
            "bytes": res.bytes_sent,
            "digests": [d.hex() for d in digests],
        })

    async def _handle_kv(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        """Decode-role KV listener: verify each KV_PAGES frame (checksum +
        digest-chain recompute, the ``xfer.recv``/``xfer.verify`` sites)
        and hand verified payloads to the engine thread for adoption."""
        from ..cluster import kv_transfer
        from .batcher import PrefixCache

        self._conns.add(writer)
        try:
            await kv_transfer.handle_kv_connection(
                reader, writer,
                # Digest recompute must use the engine's salt: pool
                # digests fold in the KV width (--kv-bits), so a frame
                # from a differently-configured sender reads as a chain
                # mismatch instead of poisoning the cache.
                page_digests_fn=functools.partial(
                    PrefixCache.page_digests,
                    kv_bits=getattr(self.batcher, "kv_bits", 16),
                ),
                import_fn=self._kv_import,
                faults=self.batcher.faults,
                stats=self.kv_stats,
            )
        except (ConnectionError, OSError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _kv_import(self, payload) -> tuple[bool, str]:
        """Bridge one verified transfer to the engine thread: queue it on
        the batcher (under the submit lock, so the supervisor's batcher
        swap cannot strand it unseen), wake the engine, await the
        engine-side completion."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def on_done(ok: bool, reason: str) -> None:
            # Engine thread -> loop: same crossing as mailbox deliveries.
            def settle() -> None:
                if not fut.done():
                    fut.set_result((ok, reason))

            loop.call_soon_threadsafe(settle)

        with self._submit_lock:
            self.batcher.submit_kv_import(
                payload.digests, payload.k_pages, payload.v_pages, on_done
            )
        self._work.set()
        return await fut

    async def _collect_until_done(self, mbox, rid, stop, need_text=True):
        """Drain the mailbox; yield (text_so_far, ids_so_far, lps, done,
        err).  ``err`` is "stopped" when a stop sequence truncated the text
        (the rid is then flagged for engine-side cancel, and the generator
        keeps draining until the cancel ack), "timeout" at the deadline.
        ``need_text=False`` skips the per-delivery decode until the final
        delivery."""
        tok = self.batcher.tokenizer
        ids: list[int] = []
        lps: list[float] = []
        stopped_at: int | None = None
        timed_out = False
        scanned = 0  # chars already known stop-free
        hold = max((len(s) for s in stop), default=1) - 1
        while True:
            try:
                if timed_out:
                    toks, done, err, new_lps = await asyncio.wait_for(
                        mbox.queue.get(), _TIMEOUT_ACK_GRACE_S
                    )
                elif mbox.deadline is not None:
                    try:
                        toks, done, err, new_lps = mbox.queue.get_nowait()
                    except asyncio.QueueEmpty:
                        remaining = mbox.deadline - time.perf_counter()
                        if remaining <= 0:
                            raise asyncio.TimeoutError from None
                        toks, done, err, new_lps = await asyncio.wait_for(
                            mbox.queue.get(), remaining
                        )
                else:
                    toks, done, err, new_lps = await mbox.queue.get()
            except asyncio.TimeoutError:
                if timed_out:
                    if stopped_at is not None:
                        yield None, ids, lps, True, "stopped"
                    else:
                        yield tok.decode(ids), ids, lps, True, "timeout"
                    return
                timed_out = True
                if stopped_at is None:
                    with self._submit_lock:
                        self._cancelled.add(rid)
                    self._work.set()
                    METRICS.inc("server.request_timeouts")
                continue
            if timed_out:
                if done:
                    mbox.finished = True
                    if err is not None and err.startswith(_SHED_ERR):
                        yield "", ids, lps, True, err
                    elif stopped_at is not None:
                        yield None, ids, lps, True, "stopped"
                    else:
                        yield tok.decode(ids), ids, lps, True, "timeout"
                    return
                continue
            if err is None and not mbox.first_seen:
                # Time to first token, from request receipt.
                mbox.first_seen = True
                METRICS.observe(
                    "server.ttft_seconds", time.perf_counter() - mbox.t0
                )
            if err is not None:
                mbox.finished = True
                yield "", ids, lps, True, err
                return
            if stopped_at is None:
                ids.extend(toks)
                if new_lps is not None:
                    lps.extend(new_lps)
                text = tok.decode(ids) if (need_text or stop or done) else None
                hit = -1
                if text is not None and stop:
                    start = max(0, scanned - hold)
                    hit = min(
                        (i for i in (text.find(s, start) for s in stop) if i >= 0),
                        default=-1,
                    )
                    scanned = len(text)
                if hit >= 0:
                    stopped_at = hit
                    text = text[:hit]
                    keep = 0
                    while (keep < len(ids)
                           and len(tok.decode(ids[: keep + 1])) <= hit):
                        keep += 1
                    del ids[keep:]
                    del lps[keep:]
                    if not done:
                        with self._submit_lock:
                            self._cancelled.add(rid)
                if done:
                    mbox.finished = True
                yield text, ids, lps, done, (
                    "stopped" if stopped_at is not None and done else None
                )
                if done:
                    return
            elif done:
                mbox.finished = True
                yield None, ids, lps, True, "stopped"
                return

    async def _gather_choice(self, mbox, rid, stop):
        """Drain one choice to completion.  Returns
        (text, ids, lps, finish_reason, fatal_err)."""
        text = ""
        ids: list[int] = []
        lps: list[float] = []
        reason = "length"
        async for t, ids, lps, done, err in self._collect_until_done(
            mbox, rid, stop, need_text=bool(stop)
        ):
            if err == "stopped":
                if t is not None:
                    text = t
                reason = "stop"
                break
            if err == "timeout":
                if t is not None:
                    text = t
                reason = "timeout"
                break
            if err is not None:
                return text, ids, lps, reason, err
            text = t
            if done:
                break
        if reason == "timeout" and not ids and mbox.delivered == 0:
            return text, ids, lps, reason, \
                _SHED_ERR + "deadline expired before any output was produced"
        if reason == "length" and self.batcher.eos_id >= 0 and (
            ids and ids[-1] == self.batcher.eos_id
        ):
            reason = "stop"
        return text, ids, lps, reason, None

    async def _serve_blocking(
        self, writer, subs, stop, chat, oid, created, n_prompt,
        want_lp=False,
    ) -> None:
        outs = await asyncio.gather(*[
            self._gather_choice(mbox, rid, stop) for _, rid, mbox in subs
        ])
        fatal = next((e for *_x, e in outs if e is not None), None)
        if fatal is not None:
            if fatal.startswith(_SHED_ERR):
                await self._shed_json(writer, 503, fatal, "queue_deadline")
            else:
                await self._json(
                    writer, 500, _err_body(fatal, _err_type(fatal))
                )
            return
        choices = []
        total_completion = 0
        cached = [m.cached_tokens for _, _, m in subs
                  if m.cached_tokens is not None]
        for (idx, _rid, _mbox), (text, ids, lps, reason, _e) in zip(subs, outs):
            choice = (
                {"index": idx,
                 "message": {"role": "assistant", "content": text},
                 "finish_reason": reason}
                if chat else
                {"index": idx, "text": text, "logprobs": None,
                 "finish_reason": reason}
            )
            if want_lp:
                choice["logprobs"] = _lp_field(
                    self.batcher.tokenizer, ids, lps, chat
                )
            choices.append(choice)
            total_completion += len(ids)
        await self._json(writer, 200, {
            "id": oid,
            "object": "chat.completion" if chat else "text_completion",
            "created": created,
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": total_completion,
                "total_tokens": n_prompt + total_completion,
                # Prompt tokens served from the automatic prefix cache.
                **({"prompt_tokens_details": {"cached_tokens": max(cached)}}
                   if cached else {}),
            },
        })

    async def _stream_choice(
        self, writer, wlock, mbox, rid, index, stop, chat, oid, created,
        want_lp
    ) -> None:
        """Stream one choice's SSE chunks; ``wlock`` serializes write+drain
        across sibling choices (drain is not reentrant)."""

        async def emit(data: bytes) -> None:
            async with wlock:
                writer.write(data)
                await writer.drain()

        sent = 0
        lp_sent = 0
        reason = "length"
        stop_hold = max((len(s) for s in stop), default=1) - 1

        def chunk(delta: str, finish: str | None,
                  lp_items: tuple | None = None) -> bytes:
            choice = (
                {"index": index, "delta": ({"content": delta} if delta else {}),
                 "finish_reason": finish}
                if chat else
                {"index": index, "text": delta, "logprobs": None,
                 "finish_reason": finish}
            )
            if lp_items is not None:
                choice["logprobs"] = _lp_field(
                    self.batcher.tokenizer, lp_items[0], lp_items[1], chat
                )
            payload = {
                "id": oid,
                "object": "chat.completion.chunk" if chat else "text_completion",
                "created": created,
                "model": self.model_name,
                "choices": [choice],
            }
            return b"data: " + json.dumps(payload).encode() + b"\n\n"

        if chat:
            # OpenAI stream fidelity: the first chunk announces the role.
            await emit(
                b"data: " + json.dumps({
                    "id": oid, "object": "chat.completion.chunk",
                    "created": created, "model": self.model_name,
                    "choices": [{"index": index,
                                 "delta": {"role": "assistant"},
                                 "finish_reason": None}],
                }).encode() + b"\n\n"
            )
        stopped = False
        last_text = None  # survives the cancel-ack yield (text=None)
        async for text, ids, lps, done, err in self._collect_until_done(mbox, rid, stop):
            if err == "stopped":
                stopped = True
            elif err == "timeout":
                reason = "timeout"  # final chunk carries it below
            elif err is not None:
                await emit(
                    b"data: "
                    + json.dumps(_err_body(err, _err_type(err))).encode()
                    + b"\n\n"
                )
                break
            if text is not None:
                last_text = text
            else:
                text = last_text
            if text is None:
                delta = ""
            else:
                # Hold back text that may still change: a trailing U+FFFD
                # (a partially-decoded multi-byte sequence) and a tail that
                # could become the head of a stop sequence.
                if done:
                    emit_src = text
                else:
                    emit_src = text.rstrip("\ufffd")
                    if stop_hold:
                        emit_src = emit_src[: max(sent, len(emit_src) - stop_hold)]
                delta = emit_src[sent:]
                sent = max(sent, len(emit_src))

            def lp_slice():
                nonlocal lp_sent
                if not want_lp:
                    return None
                items = (ids[lp_sent:len(lps)], lps[lp_sent:])
                lp_sent = len(lps)
                return items

            if delta and not done:
                await emit(chunk(delta, None, lp_slice()))
            if done:
                if reason == "length" and (stopped or (
                    self.batcher.eos_id >= 0 and ids
                    and ids[-1] == self.batcher.eos_id
                )):
                    reason = "stop"
                await emit(chunk(delta, reason, lp_slice()))
                break

    async def _serve_stream(
        self, writer, subs, stop, chat, oid, created, want_lp=False
    ) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        await writer.drain()
        wlock = asyncio.Lock()
        results = await asyncio.gather(*[
            self._stream_choice(writer, wlock, mbox, rid, idx, stop, chat,
                                oid, created, want_lp)
            for idx, rid, mbox in subs
        ], return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()

    # -- response helpers --------------------------------------------------

    async def _plain(self, writer, code: int, body: str) -> None:
        await self._respond(writer, code, "text/plain", body.encode())

    async def _json(self, writer, code: int, obj: dict,
                    headers: dict[str, str] | None = None) -> None:
        await self._respond(
            writer, code, "application/json",
            (json.dumps(obj) + "\n").encode(), headers=headers,
        )

    async def _shed_json(self, writer, code: int, msg: str,
                         reason: str, retry_after: int | None = None) -> None:
        """Answer a shed request (429 too-busy / 503 not-yet-admitted):
        structured overloaded_error body + a Retry-After header so clients
        and load balancers back off instead of retrying hot, and the shed
        counters the dashboards alarm on.  The body carries the machine-
        readable ``reason`` (queue_full / cost_gate / tenant_quota / ...)
        so clients can distinguish "the server is busy" from "MY quota is
        exhausted"; ``retry_after`` overrides the global hint with a
        per-tenant one."""
        METRICS.inc("server.requests_shed_total")
        METRICS.inc(f"server.requests_shed.{reason}")
        body = _err_body(msg, "overloaded_error")
        body["error"]["reason"] = reason
        await self._json(
            writer, code, body,
            headers={"Retry-After": str(
                retry_after if retry_after is not None
                else self._retry_after_s()
            )},
        )

    async def _respond(self, writer, code: int, ctype: str, payload: bytes,
                       headers: dict[str, str] | None = None) -> None:
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        writer.write(
            (
                f"HTTP/1.1 {code} {_REASONS.get(code, '')}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"{extra}"
                "Connection: close\r\n\r\n"
            ).encode()
            + payload
        )
        await writer.drain()


class _Responded(Exception):
    """Internal: the parse phase already wrote an error response."""


def _err_body(msg: str, type_: str = "invalid_request_error") -> dict:
    return {"error": {"message": msg, "type": type_}}


def _err_type(msg: str) -> str:
    """Error class for a mailbox-delivered failure."""
    if msg in (_RESTART_ERR, "engine unrecoverable"):
        return "engine_error"
    if msg.startswith(_SHED_ERR):
        return "overloaded_error"
    return "server_error"


def _lp_field(tok, ids: list[int], lps: list[float], chat: bool) -> dict:
    """OpenAI logprobs shapes: completions carries parallel arrays, chat
    carries per-token objects."""
    pieces = [tok.decode([i]) for i in ids[: len(lps)]]
    lps = [round(v, 6) for v in lps]
    if chat:
        return {"content": [
            {"token": p, "logprob": v} for p, v in zip(pieces, lps)
        ]}
    return {"tokens": pieces, "token_logprobs": lps,
            "top_logprobs": None, "text_offset": None}
