"""Replica router: health-aware placement with EXACT failover over a
fleet of serving replicas (PyTorch port of ``distributed_llms_tpu/runtime/
router.py``; the fleet is ``cluster/fleet.py``).

The server makes one engine crash-safe and overload-safe; this tier makes
the SERVICE replica-safe.  N full server/batcher stacks (each with its own
supervisor, watchdog and overload plane; on one GPU they share one copy of
the weights) sit behind one HTTP front door that:

- **Forwards bodies VERBATIM.**  The proxy ships the request's exact
  bytes to the chosen replica, so every per-request serving field —
  sampling knobs, penalties, priorities, and the constrained-decoding
  surface (``response_format`` / ``logit_bias`` / ``banned_tokens``,
  runtime/constrain.py) — passes through untouched and is validated
  where it is served (the replica's own 400-before-admission gate).
- **Places health-aware.**  Candidates are the replicas the fleet's
  ``/healthz`` probes currently call routable.  Among them, placement
  follows PREFIX AFFINITY first: the router hashes the request's prompt
  with the same chained page digests the automatic prefix cache uses
  (``PrefixCache.page_digests``), and a replica that recently served the
  longest matching page-run gets the request — its pool already holds
  those pages, so admission prefills only the suffix.  A sticky replica
  substantially hotter than the least-loaded one is skipped (affinity
  must not defeat load balancing); everything else goes LEAST COMMITTED
  first, by the router's own token-mass accounting (prompt + budget per
  in-flight request, the same estimate the server's cost gate uses).
- **Fails over EXACTLY.**  A replica dying (connection reset), wedging
  past its watchdog (probe 503 -> fleet aborts its in-flight proxies), or
  partitioning mid-request fails the upstream leg.  If ZERO payload bytes
  reached the client, the request is re-sent VERBATIM (same body bytes) to
  another healthy replica — at temperature 0 the re-decode is
  token-identical, the same recompute-is-exact contract the
  server's supervisor keeps in-process, now one level up.  Retries are bounded
  (``max_failover_retries``); exhaustion answers 503 + ``Retry-After``
  with a structured ``engine_error``.  If bytes HAD streamed, the deltas
  cannot be retracted: the stream ends with a structured ``engine_error``
  event — the mailbox contract, mirrored at the fleet tier.  (SSE
  responses hold the client's headers until the first upstream payload
  byte, so "zero-streamed" stays decidable per request.)
- **Sheds like the replicas do.**  A replica's own structured 429/503
  (cost gate, queue full, queue-deadline shed — type ``overloaded_error``)
  passes through untouched WITH its ``Retry-After``; an infrastructure 503
  (draining / unhealthy gate) is a placement mistake and fails over
  instead.  No routable replica at all answers 503 + ``Retry-After``.

- **Disaggregates prefill from decode** (``handoff=True``).  With a
  prefill tier in the fleet (replicas of role ``"prefill"``), a request
  whose prompt spans at least one full page is first handed to the
  least-loaded prefill replica (``POST /v1/prefill``): that replica runs
  the prompt through its own admission, exports the finished KV pages,
  and ships them to the chosen DECODE replica's KV listener over
  ``cluster/kv_transfer.py`` (verified, deadline'd, retried).  The decode
  replica's admission then prefix-cache-hits the imported pages and
  decodes immediately — a long prompt never stalls another request's
  decode tokens on the decode tier.  The DEGRADATION LADDER makes the
  handoff safe: a prefill replica crash/stall/partition mid-handoff, a
  digest mismatch, transfer-retry exhaustion, a handoff deadline, or an
  empty prefill tier all fall back to COLOCATED prefill — the request is
  forwarded to the decode replica verbatim, which prefills it itself,
  byte-exact either way (imported pages hold exactly the content their
  digests commit to; a miss just recomputes it).  Completions never
  place on prefill-role replicas.

Rolling drain/respawn and replica-scoped chaos (``replica.crash`` /
``replica.stall`` / ``replica.partition``) live with the fleet; the
router's own injection site is ``router.place`` (tag = chosen replica;
``drop`` vetoes the choice).  Everything here is event-loop confined —
the router owns no engine thread.
"""

from __future__ import annotations

import asyncio
import json
import time

from ..core.observability import METRICS, get_logger
from .batcher import PrefixCache
# One definition of the HTTP front-door limits/reasons/error shape for
# both tiers — the router must shed/parse exactly like the replicas do.
from .server import (
    _MAX_BODY, _MAX_HEADERS, _MAX_REQUEST_LINE, _REASONS,
    _TENANT_LEDGER_CAP, ANON_TENANT, _err_body, valid_tenant_id,
)

log = get_logger("router")


class _UpstreamFailed(Exception):
    """One upstream leg failed (connection error, abort, infrastructure
    503).  Whether the request may fail over is the caller's decision,
    keyed on how many payload bytes already reached the client."""


class _Inflight:
    """One proxied request's registration on a replica handle: the fleet
    sets ``abort`` when the replica stops being trustworthy; ``streamed``
    flips once payload bytes reached the client (the point of no return
    for failover)."""

    __slots__ = ("abort", "streamed")

    def __init__(self) -> None:
        self.abort = asyncio.Event()
        self.streamed = False


# The fleet tenant ledger's contract (``_ledger_retry_after`` /
# ``_ledger_charge`` / ``_ledger_refund``): a charge on placement and only
# there, a refund on every failure edge and only there, the gated window
# never over quota, and a gate bypass (``router.ledger:drop``) always
# metered by the replica gateways' backstop — never a silent unmetered
# path.  The reference declares it as a transition system its model
# checker explores; the port keeps the code and the tests.


class ReplicaRouter:
    """HTTP front door over a :class:`cluster.fleet.ReplicaFleet`."""

    def __init__(
        self,
        fleet,
        host: str = "127.0.0.1",
        port: int = 0,
        tokenizer=None,  # for prompt hashing/cost on text prompts
        page_size: int = 64,  # affinity block size — match the replicas'
        max_failover_retries: int = 2,
        affinity_max: int = 4096,  # digest -> replica entries kept (LRU)
        # Affinity yields to load balance once the sticky replica's
        # committed mass exceeds spill_factor * least-loaded + request.
        spill_factor: float = 2.0,
        faults=None,
        # Disaggregated prefill/decode: hand prompts to the fleet's
        # prefill tier and ship finished KV pages to the decode replica
        # before forwarding (module docstring).  ``handoff_deadline_s``
        # bounds the WHOLE prefill+transfer leg — past it the request
        # degrades to colocated prefill.
        handoff: bool = False,
        handoff_deadline_s: float = 15.0,
        kv_bits: int = 16,  # the replicas' pool width — page digests are
        #   salted by it (PrefixCache.page_digests), and router-side
        #   affinity/handoff digests must match the fleet's
        # Fleet-wide tenant ledger: the router is the ONE admission-commit
        # point, so a tenant's token-rate quota holds at any fleet size
        # (elastic scale-up must not multiply it).  Same knobs and
        # semantics as the replica gateway's rate gate — which, behind
        # this ledger, should run as a LOOSE BACKSTOP (the server's
        # tenant_backstop_x) so a bypassed or drilled router gate still
        # never yields a silent unmetered path.  None disables the gate.
        tenant_weights: "dict[str, float] | None" = None,
        tenant_quota_tps: float | None = None,
        tenant_rate_window_s: float = 10.0,
        # Cross-replica KV reuse: on an affinity miss, pull the prompt's
        # cached page run from the sibling the digest directory says
        # holds it (over the checksummed KV_PAGES plane) instead of
        # re-prefilling; every failure degrades to local recompute.
        pull: bool = True,
        pull_deadline_s: float = 5.0,
    ) -> None:
        self.fleet = fleet
        self.host = host
        self.port = port
        self.tokenizer = tokenizer
        self.page_size = page_size
        self.kv_bits = kv_bits
        self.max_failover_retries = max_failover_retries
        self.affinity_max = affinity_max
        self.spill_factor = spill_factor
        self.faults = faults
        self.handoff = handoff
        self.handoff_deadline_s = handoff_deadline_s
        if tenant_quota_tps is not None and tenant_quota_tps <= 0:
            tenant_quota_tps = None  # the CLI/config "disable" spelling
        if tenant_rate_window_s <= 0:
            raise ValueError(
                f"tenant_rate_window_s must be > 0, got {tenant_rate_window_s}"
            )
        self.tenant_weights = dict(tenant_weights or {})
        self.tenant_default_weight = self.tenant_weights.pop("*", 1.0)
        self.tenant_quota_tps = tenant_quota_tps
        self.tenant_rate_window_s = tenant_rate_window_s
        self.pull = pull
        self.pull_deadline_s = pull_deadline_s
        # digest -> (replica name, replica epoch), most-recently-used
        # last; event-loop confined like every router/fleet structure (no
        # engine thread ever touches it).  The epoch pins the entry to
        # ONE cache lifetime: a drained/respawned replica comes back with
        # a cold pool under a bumped epoch, so its stale entries read as
        # misses instead of steering traffic at a cache that no longer
        # holds the pages.
        from collections import OrderedDict

        self._affinity: "OrderedDict[bytes, tuple[str, int]]" = OrderedDict()
        # The FLEET tenant ledger: trailing-window (ts, est) charges per
        # tenant, the same shape as the replica gateway's — but there is
        # exactly ONE of these per fleet, so what it admits is what the
        # fleet admits.  Charged after the gate passes, REFUNDED when the
        # request ends shed/failed without service (a shed must not burn
        # the tenant's window).  Cardinality-capped like the replica's
        # (_TENANT_LEDGER_CAP): ids are client-minted.
        self._tenant_window: "dict[str, object]" = {}  # guarded-by: event-loop
        self._server: asyncio.base_events.Server | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._conns: set[asyncio.StreamWriter] = set()

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        addr = self._server.sockets[0].getsockname()
        log.info("router fronting %d replica(s) on http://%s:%s",
                 len(self.fleet.replicas), addr[0], addr[1])
        return addr[0], addr[1]

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()

    # -- placement ---------------------------------------------------------

    def _digests(self, prompt_ids: list[int] | None) -> list[bytes]:
        """Chained page digests of the prompt's FULL pages, capped one
        page short (the replica-side cache caps hits the same way)."""
        if not prompt_ids or self.page_size <= 0:
            return []
        n = max(0, (len(prompt_ids) - 1) // self.page_size)
        return PrefixCache.page_digests(prompt_ids, self.page_size, n,
                                        kv_bits=self.kv_bits)

    def _affinity_lookup(self, d: bytes) -> str | None:
        """The replica a digest is sticky to — IF that replica's cache
        lifetime still matches.  An entry recorded against an older epoch
        (the replica drained/respawned since: fresh pool, cold cache) is
        dropped here, so stale affinity can never beat least-loaded
        placement."""
        got = self._affinity.get(d)
        if got is None:
            return None
        name, epoch = got
        h = self.fleet._by_name.get(name)
        if h is None or h.epoch != epoch:
            # Epoch mismatch = the replica drained/respawned since this
            # entry was recorded: its pool is cold, the entry is a lie.
            # This is also the digest DIRECTORY's self-invalidation (the
            # cross-replica pull plane reads the same map).
            del self._affinity[d]
            METRICS.inc("directory.stale_drops")
            return None
        return name

    def _place(self, digests: list[bytes], est_tokens: int,
               exclude: set) -> "object | None":
        """Pick a DECODE-CAPABLE replica (prefill-role replicas never
        serve completions): prefix affinity on the longest known digest
        run, spilling to least-committed when the sticky replica runs
        hot; the ``router.place`` fault site (tag = choice) can veto a
        pick.  Returns None when no routable replica remains."""
        now = self._loop.time()
        cands = [h for h in self.fleet.replicas
                 if h.routable(now) and h.name not in exclude
                 and h.role != "prefill"]
        while cands:
            pick, hit = None, False
            for d in reversed(digests):  # longest cached run first
                name = self._affinity_lookup(d)
                if name is None:
                    continue
                h = next((c for c in cands if c.name == name), None)
                if h is not None:
                    pick, hit = h, True
                    break
            least = min(cands, key=lambda h: (h.committed_tokens, h.name))
            if pick is None:
                pick = least
            elif (pick.committed_tokens
                  > self.spill_factor * least.committed_tokens + est_tokens):
                pick, hit = least, False  # affinity must not defeat balance
            if self.faults is not None:
                # defer_stall: placement runs on the event loop (inside
                # _proxy).  The site's documented action is 'drop' (veto);
                # a stall/delay rule is returned un-slept and ignored here
                # — this sync helper cannot await, and blocking would
                # freeze routing and failure detection at once.
                rule = self.faults.fire("router.place", tag=pick.name,
                                        defer_stall=True)
                if rule is not None and rule.action == "drop":
                    cands = [c for c in cands if c.name != pick.name]
                    continue
            METRICS.inc("router.placements")
            if hit:
                METRICS.inc("router.affinity_hits")
            return pick
        return None

    def _record_affinity(self, digests: list[bytes], h) -> None:
        for d in digests:
            self._affinity[d] = (h.name, h.epoch)
            self._affinity.move_to_end(d)
        while len(self._affinity) > self.affinity_max:
            self._affinity.popitem(last=False)

    def _estimate(self, req: dict, chat: bool) -> tuple[list[int] | None, int]:
        """(prompt token ids or None, estimated prompt+budget token mass).
        Pure best-effort — bad fields fall back to coarse estimates and
        the replica's own validation answers the client."""
        ids: list[int] | None = None
        try:
            if chat:
                msgs = req.get("messages")
                text = " ".join(
                    m.get("content", "") for m in msgs
                ) if isinstance(msgs, list) else ""
                if self.tokenizer is not None and text:
                    ids = self.tokenizer.encode(text)
                n_prompt = len(ids) if ids is not None else len(text) // 4
            else:
                prompt = req.get("prompt")
                if isinstance(prompt, list):
                    ids = [t for t in prompt if isinstance(t, int)]
                    n_prompt = len(ids)
                elif isinstance(prompt, str) and self.tokenizer is not None:
                    ids = self.tokenizer.encode(prompt)
                    n_prompt = len(ids)
                else:
                    n_prompt = len(prompt) // 4 if isinstance(prompt, str) else 0
            budget = req.get(
                "max_completion_tokens" if chat else "max_tokens", 16)
            budget = budget if isinstance(budget, int) \
                and not isinstance(budget, bool) and budget > 0 else 16
        except (TypeError, AttributeError):
            return None, 16
        return ids, n_prompt + budget

    # -- the fleet tenant ledger (the one admission-commit point) ----------

    def _tenant_weight(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, self.tenant_default_weight)

    def _tenant_allowance(self, tenant: str) -> float:
        """Token mass the tenant's trailing window may hold, FLEET-WIDE —
        the same weight x quota x window product the replica gateways
        compute, held once for all of them."""
        return (self._tenant_weight(tenant) * self.tenant_quota_tps
                * self.tenant_rate_window_s)

    # graftlint: holds(event-loop)
    def _ledger_retry_after(self, tenant: str, est: int,
                            forced: bool = False) -> int | None:
        """The fleet-ledger rate gate (loop thread only).  None = ``est``
        more tokens fit the tenant's window; else the PER-TENANT
        Retry-After walked off the FLEET ledger oldest-first — a promise
        about when this tenant's own fleet-wide charges age out, not a
        load guess.  ``forced`` is the ``router.ledger:exhaust`` drill."""
        import math

        win = self.tenant_rate_window_s
        allowed = self._tenant_allowance(tenant)
        now = time.perf_counter()
        ledger = self._tenant_window.get(tenant)
        if ledger:
            while ledger and ledger[0][0] <= now - win:
                ledger.popleft()
            if not ledger:  # fully aged out: drop the deque itself too
                del self._tenant_window[tenant]
                ledger = None
        used = sum(n for _, n in ledger) if ledger else 0
        if not forced and used + est <= allowed:
            return None
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
    def _ledger_charge(self, tenant: str, est: int) -> None:
        """Commit an admitted request's token mass to the fleet ledger
        (loop thread only) — charged once placement is about to happen,
        refunded by ``_ledger_refund`` if the request ends shed or failed
        without service."""
        from collections import deque

        if tenant not in self._tenant_window \
                and len(self._tenant_window) >= _TENANT_LEDGER_CAP:
            # Cardinality bound, exactly like the replica gateway's: age
            # every ledger first; ids still inside their window are
            # genuine concurrent tenants and stay.
            cutoff = time.perf_counter() - self.tenant_rate_window_s
            for t in list(self._tenant_window):
                d = self._tenant_window[t]
                while d and d[0][0] <= cutoff:
                    d.popleft()
                if not d:
                    del self._tenant_window[t]
        self._tenant_window.setdefault(tenant, deque()).append(
            (time.perf_counter(), est)
        )
        METRICS.inc("router.ledger.charges")
        METRICS.inc("router.ledger.charged_tokens", est)
        METRICS.set_gauge("router.ledger.tenants", len(self._tenant_window))

    # graftlint: holds(event-loop)
    def _ledger_refund(self, tenant: str, est: int) -> None:
        """Give a charge back (loop thread only): the request was shed or
        failed before any service — billed tokens that bought nothing
        would silently shrink the tenant's real quota.  Walks the
        tenant's ledger NEWEST-first (the refund undoes the charge just
        taken, not some hours-old admission)."""
        ledger = self._tenant_window.get(tenant)
        remaining = est
        while ledger and remaining > 0:
            ts, n = ledger.pop()
            if n > remaining:
                ledger.append((ts, n - remaining))
                remaining = 0
            else:
                remaining -= n
        if ledger is not None and not ledger:
            del self._tenant_window[tenant]
        METRICS.inc("router.ledger.refunds")
        METRICS.set_gauge("router.ledger.tenants", len(self._tenant_window))

    # -- disaggregated prefill handoff -------------------------------------

    def _pick_prefill(self, exclude: set) -> "object | None":
        """Least-committed routable prefill-role replica (None = the
        prefill tier is empty, dead, or partitioned — serve colocated)."""
        now = self._loop.time()
        cands = [h for h in self.fleet.replicas
                 if h.routable(now) and h.role == "prefill"
                 and h.name not in exclude]
        if not cands:
            return None
        return min(cands, key=lambda h: (h.committed_tokens, h.name))

    def _handoff_fallback(self, reason: str, detail: str) -> bool:
        METRICS.inc("router.handoff_fallbacks")
        METRICS.inc(f"router.handoff_fallbacks.{reason}")
        log.warning("prefill handoff degraded to colocated (%s): %s",
                    reason, detail)
        return False

    async def _handoff(self, decode_h, prompt_ids: list[int] | None,
                       digests: list[bytes]) -> bool:
        """One prefill handoff for the request about to be forwarded to
        ``decode_h``: pick a prefill replica, POST it /v1/prefill (the
        decode replica's KV listener coordinates as the transfer target),
        and verify END-TO-END that the digests it shipped are a prefix of
        the digests THIS router computed from the prompt — a prefill-tier
        hashing bug must not poison the decode cache.  Returns True when
        pages landed; every failure (crash, stall past the deadline,
        partition, digest mismatch, retry exhaustion, no prefill tier,
        no KV listener) returns False — the caller serves the request
        colocated on the decode replica, byte-exact regardless."""
        import uuid

        if prompt_ids is None or decode_h.kv_port is None:
            return self._handoff_fallback(
                "no_kv_target",
                f"decode replica {decode_h.name} has no KV listener"
                if decode_h.kv_port is None else "prompt not tokenizable",
            )
        p = self._pick_prefill(exclude={decode_h.name})
        if p is None:
            return self._handoff_fallback(
                "no_prefill_replica", "prefill tier empty or unhealthy"
            )
        METRICS.inc("router.handoffs")
        transfer_id = uuid.uuid4().hex[:16]
        body = json.dumps({
            "prompt": list(prompt_ids),
            "kv_host": decode_h.host,
            "kv_port": decode_h.kv_port,
            "transfer_id": transfer_id,
        }).encode()
        t0 = time.perf_counter()
        # The prefill tier does prompt + 1 token of work — charging the
        # request's full decode budget would let a huge max_tokens field
        # steer prefill placement away from the replica doing the LEAST
        # prefill work.
        charge = len(prompt_ids) + 1
        p.committed_tokens += charge
        # Handoff count doubles as the prefill tier's queue-depth signal
        # (cluster/autoscale.py TieredAutoscaler reads it off the handle).
        p.handoffs += 1
        METRICS.set_gauge(
            f"router.committed_tokens.{p.name}", p.committed_tokens
        )
        try:
            out = await asyncio.wait_for(
                self._rpc(p, "/v1/prefill", body), self.handoff_deadline_s
            )
        except asyncio.TimeoutError:
            return self._handoff_fallback(
                "timeout",
                f"prefill replica {p.name} exceeded the "
                f"{self.handoff_deadline_s:g}s handoff deadline",
            )
        except (ConnectionError, OSError, EOFError, ValueError, IndexError,
                asyncio.IncompleteReadError) as e:
            # Crash / partition / kill mid-handoff all surface here as a
            # severed or unreachable connection (an empty status line
            # from a half-dead socket parses as IndexError/ValueError).
            return self._handoff_fallback(
                "error", f"prefill replica {p.name}: "
                f"{type(e).__name__}: {e}",
            )
        finally:
            p.committed_tokens -= charge
            p.handoffs -= 1
            METRICS.set_gauge(
                f"router.committed_tokens.{p.name}", p.committed_tokens
            )
        status, resp = out
        if status != 200 or not isinstance(resp, dict):
            return self._handoff_fallback(
                "rejected", f"prefill replica {p.name} answered {status}"
            )
        if not resp.get("ok"):
            return self._handoff_fallback(
                "rejected",
                f"prefill replica {p.name}: "
                f"{resp.get('reason') or resp.get('error', 'rejected')}",
            )
        shipped = resp.get("digests") or []
        want = [d.hex() for d in digests[: len(shipped)]]
        if not shipped or shipped != want:
            # The transfer itself verified on the decode side, but it does
            # not commit to the prompt THIS router hashed: stale pages
            # under our digests would be worse than no pages.
            return self._handoff_fallback(
                "digest_mismatch",
                f"prefill replica {p.name} shipped {len(shipped)} page(s) "
                "whose digests diverge from the request's",
            )
        el = time.perf_counter() - t0
        METRICS.observe("router.handoff_seconds", el)
        METRICS.inc("router.handoff_bytes", int(resp.get("bytes", 0)))
        log.info(
            "handoff %s: %d page(s), %d token(s) prefilled on %s -> %s "
            "in %.1f ms (%d transfer attempt(s))", transfer_id,
            int(resp.get("pages", 0)), int(resp.get("tokens", 0)),
            p.name, decode_h.name, el * 1e3, int(resp.get("attempts", 1)),
        )
        return True

    async def _rpc(self, p, path: str, body: bytes) -> tuple[int, dict]:
        """POST one control-plane JSON RPC (/v1/prefill, /v1/kv_export)
        to a replica; returns (status, JSON)."""
        reader, writer = await asyncio.open_connection(p.host, p.port)
        try:
            writer.write(
                f"POST {path} HTTP/1.1\r\nHost: router\r\n"
                f"Content-Length: {len(body)}\r\n\r\n".encode() + body
            )
            await writer.drain()
            status = int((await reader.readline()).split()[1])
            clen = 0
            for _ in range(_MAX_HEADERS):
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1", "replace").partition(":")
                if name.strip().lower() == "content-length":
                    clen = int(value.strip())
            raw = await reader.readexactly(clen) if clen else b""
            try:
                resp = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                resp = {}
            return status, resp if isinstance(resp, dict) else {}
        finally:
            writer.close()

    # -- cross-replica KV reuse (the fleet prefix-digest directory) --------

    def _pull_fallback(self, reason: str, detail: str) -> bool:
        METRICS.inc("directory.pull_fallbacks")
        METRICS.inc(f"directory.pull_fallbacks.{reason}")
        log.warning("cross-replica pull degraded to local recompute "
                    "(%s): %s", reason, detail)
        return False

    async def _directory_pull(self, decode_h, prompt_ids: list[int],
                              digests: list[bytes]) -> bool:
        """Cross-replica KV reuse for a request about to land COLD on
        ``decode_h``: ask the fleet-wide prefix-digest directory (the
        affinity map itself — epoch-keyed, so a drained/respawned sibling
        self-invalidates into a miss) which SIBLING already holds the
        prompt's cached page run, and have that sibling ship the pages to
        ``decode_h``'s KV listener (``POST /v1/kv_export`` -> the
        checksummed KV_PAGES plane) instead of re-prefilling content the
        fleet already computed.  The shipped digests must be a prefix of
        the digests THIS router hashed from the prompt, exactly like the
        prefill handoff — a mis-steered or lying source must not poison
        the decode cache.  Returns True when pages landed; EVERY failure
        — stale directory answer (``directory.lookup:drop``), mis-steer
        (``:corrupt``), nothing cached, corrupt frame, sender crash
        mid-pull, deadline — returns False and the caller forwards the
        request unchanged: local recompute, byte-exact either way."""
        import uuid

        METRICS.inc("directory.lookups")
        now = self._loop.time()
        src = None
        for i in range(len(digests) - 1, -1, -1):  # longest cached run first
            name = self._affinity_lookup(digests[i])
            if name is not None and name != decode_h.name:
                h = self.fleet._by_name.get(name)
                if h is not None and h.reachable(now):
                    src = h
                    break
        if src is None:
            return False  # a plain miss: nothing to pull, nothing to count
        METRICS.inc("directory.hits")
        if self.faults is not None:
            # defer_stall: this plane runs on the router's event loop; a
            # stall rule is applied as an awaited delay below, never a
            # blocking sleep.
            rule = self.faults.fire("directory.lookup", tag=src.name,
                                    defer_stall=True)
            if rule is not None and rule.action == "drop":
                METRICS.inc("directory.stale_drops")
                return self._pull_fallback(
                    "stale",
                    f"directory answer for {src.name} read stale (drill)",
                )
            if rule is not None and rule.action == "corrupt":
                # Mis-steer: the lookup answers a sibling that does NOT
                # hold the pages — its export finds nothing (or ships a
                # run whose digests diverge) and the pull degrades.
                wrong = [h for h in self.fleet.replicas
                         if h.name not in (src.name, decode_h.name)
                         and h.reachable(now)]
                if not wrong:
                    METRICS.inc("directory.stale_drops")
                    return self._pull_fallback(
                        "stale", "mis-steer drill found no other replica"
                    )
                src = min(wrong, key=lambda h: h.name)
            if rule is not None and rule.action in ("delay", "stall"):
                await asyncio.sleep(rule.arg or 0.0)
        if decode_h.kv_port is None:
            return self._pull_fallback(
                "no_kv_target",
                f"decode replica {decode_h.name} has no KV listener",
            )
        METRICS.inc("directory.pulls")
        transfer_id = uuid.uuid4().hex[:16]
        body = json.dumps({
            "prompt": list(prompt_ids),
            "kv_host": decode_h.host,
            "kv_port": decode_h.kv_port,
            "transfer_id": transfer_id,
        }).encode()
        t0 = time.perf_counter()
        try:
            status, resp = await asyncio.wait_for(
                self._rpc(src, "/v1/kv_export", body), self.pull_deadline_s
            )
        except asyncio.TimeoutError:
            return self._pull_fallback(
                "timeout",
                f"source replica {src.name} exceeded the "
                f"{self.pull_deadline_s:g}s pull deadline",
            )
        except (ConnectionError, OSError, EOFError, ValueError, IndexError,
                asyncio.IncompleteReadError) as e:
            # Sender crash / partition mid-pull surfaces as a severed or
            # unreachable connection (an empty status line from a
            # half-dead socket parses as IndexError/ValueError).
            return self._pull_fallback(
                "error",
                f"source replica {src.name}: {type(e).__name__}: {e}",
            )
        if status != 200 or not isinstance(resp, dict) or not resp.get("ok"):
            why = resp.get("reason") if isinstance(resp, dict) else None
            reason = ("not_cached" if why == "nothing to export"
                      else "rejected")
            return self._pull_fallback(
                reason, f"source replica {src.name}: {why or status}"
            )
        shipped = resp.get("digests") or []
        want = [d.hex() for d in digests[: len(shipped)]]
        if not shipped or shipped != want:
            return self._pull_fallback(
                "rejected",
                f"source replica {src.name} shipped {len(shipped)} page(s) "
                "whose digests diverge from the request's",
            )
        el = time.perf_counter() - t0
        METRICS.observe("directory.pull_seconds", el)
        METRICS.inc("directory.pulled_pages", int(resp.get("pages", 0)))
        METRICS.inc("directory.pull_bytes", int(resp.get("bytes", 0)))
        log.info(
            "pull %s: %d page(s), %d token(s) shipped %s -> %s in %.1f ms "
            "(%d transfer attempt(s))", transfer_id,
            int(resp.get("pages", 0)), int(resp.get("tokens", 0)),
            src.name, decode_h.name, el * 1e3, int(resp.get("attempts", 1)),
        )
        return True

    # -- the proxy core ----------------------------------------------------

    async def _proxy(self, writer, method: str, path: str, body: bytes,
                     chat: bool, tenant: str | None = None) -> None:
        try:
            req = json.loads(body or b"{}")
            req = req if isinstance(req, dict) else {}
        except json.JSONDecodeError:
            req = {}  # the replica answers the 400; placement needs no parse
        prompt_ids, est = self._estimate(req, chat)
        digests = self._digests(prompt_ids)
        # The X-Tenant header rides the re-built upstream request (bodies
        # forward verbatim, headers do not): the replica's tenant gate and
        # weighted-fair scheduler must see the same identity the client
        # sent.  A malformed id 400s HERE with the replica's own message —
        # rewriting it could collapse onto (and bill) a DIFFERENT tenant,
        # and the shared charset is header-safe by construction, so the
        # router cannot become a header-injection vector either way.
        tenant_line = ""
        if tenant:
            if not valid_tenant_id(tenant):
                await self._json(writer, 400, _err_body(
                    "'tenant' must be 1-64 chars of [A-Za-z0-9._-] "
                    "(X-Tenant header or body field)"
                ))
                return
            tenant_line = f"X-Tenant: {tenant}\r\n"
        payload = (
            f"{method} {path} HTTP/1.1\r\nHost: replica\r\n"
            f"{tenant_line}"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode() + body
        METRICS.inc("router.requests")
        # The FLEET tenant-ledger gate — the one admission-commit point.
        # Charged here (before placement), refunded on every outcome that
        # served the tenant nothing; the replica gateways behind it run
        # their own ledgers as a LOOSE backstop only.
        key = tenant if tenant else ANON_TENANT
        charged = False
        if self.tenant_quota_tps is not None and method == "POST":
            rule = None
            if self.faults is not None:
                # defer_stall: the gate runs on the router's event loop —
                # a stall rule slows THIS admission as an awaited delay,
                # never the loop (probes and other tenants keep moving).
                rule = self.faults.fire("router.ledger", tag=key,
                                       defer_stall=True)
            if rule is not None and rule.action in ("delay", "stall"):
                await asyncio.sleep(rule.arg or 0.0)
            if rule is not None and rule.action == "drop":
                # The drill that bypasses the gate AND its charge: the
                # replica gateways' backstop is now the only meter — the
                # ladder's "never a silent unmetered path" leg.
                METRICS.inc("router.ledger.bypasses")
                log.warning(
                    "fleet ledger gate bypassed for tenant %r (drill); "
                    "replica backstop still meters", key,
                )
            else:
                forced = rule is not None and rule.action == "exhaust"
                allowed = self._tenant_allowance(key)
                if est > allowed:
                    # Bigger than the tenant's ENTIRE fleet window: no
                    # Retry-After could come true — malformed for this
                    # tenant, not load (the replica gate's own contract).
                    await self._json(writer, 400, _err_body(
                        f"request needs {est} admission tokens but tenant "
                        f"{key!r}'s fleet quota window holds at most "
                        f"{int(allowed)}"
                    ))
                    return
                hint = self._ledger_retry_after(key, est, forced=forced)
                if hint is not None:
                    METRICS.inc("router.ledger.sheds")
                    METRICS.inc(f"router.ledger.shed.{key}")
                    shed = _err_body(
                        f"tenant {key!r} over its fleet token-rate quota "
                        f"({est} tokens would exceed the "
                        f"{self.tenant_rate_window_s:g}s window)",
                        "overloaded_error",
                    )
                    shed["error"]["reason"] = "tenant_quota"
                    await self._json(writer, 429, shed,
                                     headers={"Retry-After": str(hint)})
                    return
                self._ledger_charge(key, est)
                charged = True
        tried: set[str] = set()
        attempts = 0
        t_fail: float | None = None
        while True:
            h = self._place(digests, est, exclude=tried)
            if h is None:
                if charged:
                    charged = False
                    self._ledger_refund(key, est)
                if attempts:
                    # The request actually FAILED on a replica and no
                    # healthy candidate remains: that is an engine
                    # failure (the documented exhaustion contract), not
                    # ordinary overload.
                    await self._exhausted(
                        writer, attempts,
                        f"request failed on {attempts} replica(s) and no "
                        "healthy replica remains; retry later",
                    )
                else:
                    await self._shed(writer, "no healthy replica available")
                return
            rec = _Inflight()
            h.inflight.add(rec)
            h.committed_tokens += est
            METRICS.set_gauge(
                f"router.committed_tokens.{h.name}", h.committed_tokens
            )
            # Does the chosen replica already hold this prompt's full
            # page run (epoch-valid affinity — recorded whether the pages
            # arrived by handoff OR by a colocated prefill there)?  Then
            # shipping it again would only earn a "duplicate" ack for a
            # multi-MB transfer.  Read BEFORE recording this placement,
            # which would trivially satisfy the check.
            warm = bool(digests) and \
                self._affinity_lookup(digests[-1]) == h.name
            try:
                if digests and method == "POST" and not chat and not warm:
                    # The request lands COLD here.  Cheapest source of its
                    # pages first: a SIBLING's cache via the fleet digest
                    # directory (cross-replica pull), then the prefill
                    # tier (disaggregated handoff).  Both are best-effort
                    # BY DESIGN — every failure mode inside degrades to
                    # colocated prefill on this replica; the verbatim
                    # forward below is identical either way (byte-exact
                    # all three paths).  Chat requests skip both planes:
                    # the replica tokenizes them through its chat
                    # template, so router-side ids (and therefore the
                    # shipped digests) would never match the admission's
                    # — pages would import dead.
                    pulled = False
                    if self.pull and prompt_ids is not None:
                        pulled = await self._directory_pull(
                            h, prompt_ids, digests
                        )
                    if not pulled and self.handoff:
                        await self._handoff(h, prompt_ids, digests)
                elif warm and self.handoff and digests \
                        and method == "POST" and not chat:
                    METRICS.inc("router.handoff_skips")
                # Record AFTER sourcing: the directory lookup above must
                # see who held the pages BEFORE this placement — writing
                # first would overwrite the source entry with the cold
                # replica and turn every pull into a self-referential
                # miss.
                self._record_affinity(digests, h)
                status = await self._forward(writer, h, payload, rec)
                if charged and status >= 400:
                    # The replica answered but served nothing (its own
                    # structured shed passing through, or a 400): the
                    # fleet ledger must not bill tokens that bought no
                    # service.
                    charged = False
                    self._ledger_refund(key, est)
                if t_fail is not None:
                    # Failover recovery latency: failure observed ->
                    # re-placed request fully answered.
                    METRICS.observe(
                        "router.failover_seconds",
                        time.perf_counter() - t_fail,
                    )
                return
            except _UpstreamFailed as e:
                if rec.streamed:
                    # Deltas already reached the client — the server's
                    # mailbox contract one level up: structured
                    # engine_error, never a silent truncation.
                    METRICS.inc("router.failed_streamed")
                    await self._stream_error(writer)
                    return
                tried.add(h.name)
                attempts += 1
                if t_fail is None:
                    t_fail = time.perf_counter()
                METRICS.inc("router.failovers")
                log.warning(
                    "replica %s failed zero-streamed request (%s); "
                    "failover attempt %d", h.name, e, attempts,
                )
                if attempts > self.max_failover_retries:
                    if charged:
                        charged = False
                        self._ledger_refund(key, est)
                    await self._exhausted(
                        writer, attempts,
                        f"request failed on {attempts} replica(s); "
                        "retry later",
                    )
                    return
            finally:
                h.inflight.discard(rec)
                h.committed_tokens -= est
                METRICS.set_gauge(
                    f"router.committed_tokens.{h.name}", h.committed_tokens
                )

    async def _up(self, awaitable, rec: _Inflight):
        """Await one upstream read, racing the replica's abort signal —
        the fleet sets it when the replica dies, wedges past the watchdog,
        partitions, or drains out from under us."""
        read_t = asyncio.ensure_future(awaitable)
        abort_t = asyncio.ensure_future(rec.abort.wait())
        try:
            done, _ = await asyncio.wait(
                {read_t, abort_t}, return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            abort_t.cancel()
        if read_t not in done:
            read_t.cancel()
            try:
                await read_t
            except (Exception, asyncio.CancelledError):
                pass
            raise _UpstreamFailed("replica became unhealthy mid-request")
        try:
            return read_t.result()
        except (ConnectionError, OSError, EOFError,
                asyncio.IncompleteReadError) as e:
            raise _UpstreamFailed(f"{type(e).__name__}: {e}") from e

    async def _forward(self, writer, h, payload: bytes,
                       rec: _Inflight) -> int:
        """One upstream leg; returns the upstream HTTP status (the fleet
        ledger refunds on >= 400 — the replica served nothing).  Raises
        :class:`_UpstreamFailed` when the replica failed us; client-side
        socket errors propagate as-is (they must never trigger a failover
        re-send)."""
        now = self._loop.time()
        if not h.reachable(now) or rec.abort.is_set():
            raise _UpstreamFailed("replica unreachable")
        try:
            up_r, up_w = await asyncio.open_connection(h.host, h.port)
        except (ConnectionError, OSError) as e:
            raise _UpstreamFailed(f"connect: {e}") from e
        try:
            up_w.write(payload)
            await self._up(up_w.drain(), rec)
            status_line = await self._up(up_r.readline(), rec)
            try:
                status = int(status_line.split()[1])
            except (IndexError, ValueError) as e:
                raise _UpstreamFailed("bad upstream status line") from e
            raw_head = [status_line]
            headers: dict[str, str] = {}
            for _ in range(_MAX_HEADERS):
                line = await self._up(up_r.readline(), rec)
                raw_head.append(line)
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1", "replace").partition(":")
                headers[name.strip().lower()] = value.strip()
            head = b"".join(raw_head)
            if "text/event-stream" in headers.get("content-type", ""):
                # SSE: forward incrementally.  The client's headers are
                # HELD until the first upstream payload byte, so a replica
                # dying pre-first-token still fails over exactly.
                first = True
                while True:
                    chunk = await self._up(up_r.read(65536), rec)
                    if not chunk:
                        if first:
                            raise _UpstreamFailed("stream died before data")
                        return status
                    if first:
                        writer.write(head)
                        first = False
                    rec.streamed = True
                    writer.write(chunk)
                    await writer.drain()
            clen = headers.get("content-length")
            if clen is not None:
                body = await self._up(up_r.readexactly(int(clen)), rec)
            else:
                body = await self._up(up_r.read(), rec)
            if status == 503 and b"overloaded_error" not in body:
                # Infrastructure 503 (draining / unhealthy gate): a
                # placement mistake, not an answer — fail over.  A
                # structured shed IS the replica's answer and passes
                # through with its Retry-After.
                raise _UpstreamFailed("replica not ready (503)")
            if status == 500 and (b"engine_error" in body
                                  or b"shutting down" in body):
                # Dead supervisor / replica mid-shutdown: nothing streamed
                # (buffered path), so the request is safe to re-place.
                raise _UpstreamFailed("replica engine dead (500)")
            writer.write(head + body)
            await writer.drain()
            rec.streamed = True
            return status
        finally:
            up_w.close()

    async def _stream_error(self, writer) -> None:
        """Terminate a partially-forwarded SSE stream with the structured
        mid-stream error event (the replica server's own idiom)."""
        try:
            writer.write(
                b"data: " + json.dumps(_err_body(
                    "replica failed mid-stream; partial output could not "
                    "be resumed", "engine_error",
                )).encode() + b"\n\n"
            )
            await writer.drain()
        except (ConnectionError, OSError):
            pass

    def _retry_after_s(self) -> int:
        """Coarse back-off hint: one tick when replicas are merely busy,
        scaling with how much of the fleet is unavailable."""
        now = self._loop.time() if self._loop is not None else 0.0
        total = max(1, len(self.fleet.replicas))
        down = sum(1 for h in self.fleet.replicas if not h.routable(now))
        return int(min(30, max(1, 1 + 4 * down * down / total)))

    async def _shed(self, writer, msg: str) -> None:
        await self._json(
            writer, 503, _err_body(msg, "overloaded_error"),
            headers={"Retry-After": str(self._retry_after_s())},
        )

    async def _exhausted(self, writer, attempts: int, msg: str) -> None:
        """Failover budget (or candidate pool) exhausted on a request that
        actually FAILED on >= 1 replica: structured, retryable
        ``engine_error`` + Retry-After."""
        METRICS.inc("router.retries_exhausted")
        await self._json(
            writer, 503, _err_body(msg, "engine_error"),
            headers={"Retry-After": str(self._retry_after_s())},
        )

    # -- HTTP plumbing -----------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            parsed = await asyncio.wait_for(
                self._read_request(writer, reader), 30.0
            )
            if parsed is None:
                return
            method, path, body, tenant = parsed
            await self._route(writer, method, path, body, tenant)
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError,
                EOFError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _read_request(self, writer, reader):
        line = await reader.readline()
        if len(line) > _MAX_REQUEST_LINE:
            await self._plain(writer, 431, "request line too long")
            return None
        parts = line.decode("latin-1", "replace").split()
        if len(parts) < 2:
            await self._plain(writer, 400, "bad request")
            return None
        method, path = parts[0], parts[1]
        content_len = 0
        tenant: str | None = None
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
                    return None
            elif hname == "transfer-encoding":
                # Only Content-Length bodies are read (the replica server
                # enforces the same): a chunked POST would forward an
                # EMPTY body and surface as a misleading replica-side 400.
                await self._plain(writer, 501, "chunked bodies not supported")
                return None
            elif hname == "x-tenant":
                # Forwarded to the chosen replica (bodies are verbatim;
                # headers are re-built) — tenant QoS is decided there.
                tenant = value.strip()
        else:
            await self._plain(writer, 431, "too many headers")
            return None
        if content_len > _MAX_BODY:
            await self._plain(writer, 413, "body too large")
            return None
        body = await reader.readexactly(content_len) if content_len else b""
        return method, path, body, tenant

    async def _route(self, writer, method: str, path: str,
                     body: bytes, tenant: str | None = None) -> None:
        if method == "GET" and path == "/healthz":
            report = self.fleet.report()
            code = 200 if report["healthy"] > 0 else 503
            report["status"] = "ok" if code == 200 else "unhealthy"
            await self._json(writer, code, report, headers=(
                None if code == 200
                else {"Retry-After": str(self._retry_after_s())}
            ))
        elif method == "GET" and path == "/metrics":
            await self._respond(
                writer, 200, "text/plain; version=0.0.4; charset=utf-8",
                METRICS.prometheus_text().encode(),
            )
        elif method == "GET" and path == "/v1/models":
            await self._proxy(writer, method, path, b"", chat=False)
        elif method == "POST" and path in ("/v1/completions",
                                           "/v1/chat/completions"):
            await self._proxy(writer, method, path, body,
                              chat="chat" in path, tenant=tenant)
        elif method not in ("GET", "POST"):
            await self._plain(writer, 405, "method not allowed")
        else:
            await self._plain(writer, 404, "not found")

    async def _plain(self, writer, code: int, body: str) -> None:
        await self._respond(writer, code, "text/plain", body.encode())

    async def _json(self, writer, code: int, obj: dict,
                    headers: dict[str, str] | None = None) -> None:
        await self._respond(
            writer, code, "application/json",
            (json.dumps(obj) + "\n").encode(), headers=headers,
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
