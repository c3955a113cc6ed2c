"""Deterministic fault injection (PyTorch port of
``distributed_llms_tpu/runtime/faults.py``).

A ``FaultPlane`` holds named injection rules that the hot paths consult at
fixed sites, so a test (or an operator drill via ``dlt-serve-torch
--fault``) can crash the Nth decode chunk, dry up the KV page pool, stall
the engine under the watchdog, or drop / corrupt a host-tier transfer —
deterministically, with no timing dependence.  Recovery is the ordinary,
tested path: the serving supervisor (runtime/server.py) respawns a crashed
batcher and re-admits the requests that had streamed nothing.

Spec grammar (comma-separated rules), the reference's::

    rule   := site[/tag] ":" action ["@" when] [":" arg]
    when   := N        fire on the Nth matching hit only (default: 1)
            | N+       fire on every matching hit from the Nth on
            | *        fire on every matching hit
    arg    := seconds (stall / delay)

Examples::

    batcher.decode:raise@3            crash the 3rd decode chunk
    batcher.page_alloc:exhaust@1+     every admission sees a dry page pool
    batcher.decode:stall@2:1.5        sleep 1.5 s before the 2nd chunk
    kv.swap_out:drop@1                the first swap-out recomputes instead

The sites wired in the port are :data:`FAULT_SITES`, every site of the
reference, at the same points of the same code paths: the batcher and host
tier, the KV-handoff plane (``proto.*``, ``xfer.*``, ``prefill.crash``),
the fleet, router and autoscaler (``replica.*``, ``router.*``,
``directory.lookup``, ``fleet.scale_*``), the tenant gate
(``tenant.quota``) and the coordinator/worker control plane
(``worker.*``, ``coordinator.dispatch``).  A strict parse
(``dlt-serve-torch --fault``) refuses any other site rather than arming a
rule that would never fire.

Actions ``raise`` (raises :class:`InjectedFault`) and ``stall`` (blocking
sleep) are applied by :meth:`FaultPlane.fire` itself; the context-specific
actions (``exhaust``, ``drop``, ``corrupt``, ...) are returned to the
caller, which knows what they mean at its site.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.observability import METRICS, get_logger

log = get_logger("faults")

ACTIONS = frozenset({"raise", "exhaust", "stall", "drop", "delay", "close",
                     "corrupt", "dup"})

# The injection sites wired in the port: every site string a hot path
# passes to fire(), and every site a strict parse accepts.
FAULT_SITES: dict[str, str] = {
    "batcher.admit":
        "each admission round (ContinuousBatcher._admit_pending)",
    "batcher.decode":
        "before each decode/speculative chunk is dispatched (host side, "
        "never inside a graph capture)",
    "batcher.page_alloc":
        "paged-pool allocation check; tag 'admit' (reservation) or 'grow' "
        "(chunk-boundary growth) — 'exhaust' forces the pressure path",
    "batcher.preempt":
        "one hit per row preemption, BEFORE the victim's pages are freed",
    "batcher.spec_verify":
        "each speculative round about to dispatch (one captured graph): "
        "tag 'draft' = the k draft steps, 'verify' = the (k+1)-token "
        "target pass",
    "batcher.mixed_step":
        "each mixed-schedule dispatch: tag 'prefill' when the step carries "
        "a fused prefill bite, 'decode' for a budget-only decode dispatch",
    "kv.swap_out":
        "a preemption victim about to swap its pages to the host tier: "
        "'drop' skips the swap (exact recompute), 'corrupt' stores a "
        "parcel its checksum cannot match",
    "kv.swap_in":
        "one swap-restore attempt: 'drop' abandons the parcel (exact "
        "recompute), 'corrupt' mangles it at take time",
    "kv.spill":
        "host-tier spill plane; tag 'out' (cold cached pages about to be "
        "captured ahead of LRU eviction) or 'restore' (a prefix-cache hit "
        "about to restore spilled pages): 'drop' skips the movement, "
        "'corrupt' flips spilled bytes so restore verification rejects "
        "them",
    "worker.heartbeat":
        "one worker heartbeat tick ('drop' skips the send)",
    "worker.result":
        "a worker about to answer (tag = command type)",
    "worker.handle":
        "a worker command handler about to run (tag = command type)",
    "coordinator.dispatch":
        "a task about to be sent to a worker (tag = task type)",
    "proto.send":
        "cluster protocol frame about to be written (tag = message type)",
    "proto.recv":
        "cluster protocol frame just read (tag = message type)",
    "router.place":
        "each router placement decision (tag = chosen replica name); "
        "'drop' vetoes the choice and spills to the next-best replica",
    "replica.crash":
        "one fleet probe tick per replica (tag = replica name); 'close' "
        "(or 'raise') kills the replica process-style — connections "
        "severed unflushed, engine reaped, no drain",
    "replica.stall":
        "one fleet probe tick per replica (tag = replica name); "
        "'delay:<s>' (or 'stall:<s>' — deferred, never blocks the fleet "
        "loop) wedges the replica's engine for <s> seconds (one blocking "
        "stall on its next decode chunk — the watchdog drill)",
    "replica.partition":
        "one fleet probe tick per replica (tag = replica name); "
        "'drop[:<s>]' makes the replica unreachable from the router for "
        "<s> seconds (no arg: until respawn) while it keeps running",
    "xfer.send":
        "one KV-handoff transfer attempt about to be sent "
        "(cluster/kv_transfer.py): 'drop' swallows the frame (the sender "
        "waits out its ack deadline and retries), 'corrupt' flips payload "
        "bytes in flight (the receiver's verify rejects), 'dup' delivers "
        "the frame twice (the import must be idempotent), 'delay:<s>' "
        "stalls the attempt",
    "xfer.recv":
        "one KV_PAGES frame just received by a decode-role engine: 'drop' "
        "ignores it (no ack — the sender times out and retries), "
        "'corrupt' mangles the payload before verification, 'delay:<s>' "
        "stalls the receive path",
    "xfer.verify":
        "KV-handoff payload verification (checksum + chained page "
        "digests): 'corrupt' forces a verification failure — the "
        "receiver NACKs and the sender retries or degrades to colocated "
        "prefill",
    "prefill.crash":
        "a prefill-role replica about to serve a /v1/prefill handoff "
        "request: 'close' (or 'raise') kills the replica abruptly "
        "mid-handoff — the router's degradation ladder must fall back to "
        "colocated prefill on the decode replica",
    "fleet.scale_up":
        "the autoscaler about to boot one more replica "
        "(cluster/autoscale.py): 'raise' or 'drop' fails the provision — "
        "the controller degrades cleanly (counts the failure, keeps "
        "serving at the current size, retries after its cooldown), the "
        "cloud-API-errored drill",
    "fleet.scale_down":
        "the autoscaler about to drain a replica away (tag = the chosen "
        "replica): 'raise'/'drop' vetoes the drain — the fleet keeps its "
        "size; scale-down is graceful-only, so there is no abrupt leg to "
        "drill here (replica.crash covers that)",
    "tenant.quota":
        "the serving gateway's per-tenant token-rate gate (tag = "
        "tenant): 'exhaust' forces the over-quota path — the request "
        "sheds 429 with the tenant's own Retry-After even under its "
        "rate, the per-tenant-shed drill",
    "router.ledger":
        "the router's fleet-wide tenant-ledger gate, the one admission-"
        "commit point (tag = tenant): 'exhaust' forces the over-quota "
        "path (429 + the tenant's fleet-ledger Retry-After), 'stall:<s>' "
        "wedges the gate (deferred — the admission path slows, never the "
        "event loop), 'drop' BYPASSES the gate and its charge — the "
        "replica gateways' loose backstop must still meter, never a "
        "silent unmetered path",
    "directory.lookup":
        "the router's fleet-wide prefix-digest directory about to answer "
        "a placement lookup: 'drop' makes every entry read stale (a "
        "directory miss — the decode replica recomputes locally, "
        "exactly), 'corrupt' mis-steers the lookup to a sibling that "
        "does not hold the pages (the pull finds nothing exportable and "
        "degrades to local recompute)",
    "xfer.pull":
        "a cross-replica KV pull about to ship off the source replica's "
        "cache (tag = transfer id): 'drop' refuses the export (the "
        "router degrades to local recompute), 'corrupt' flips payload "
        "bytes post-checksum so the pull target's verify NACKs every "
        "attempt, 'dup' ships the verified frame twice (idempotent "
        "absorb), 'delay:<s>' stalls the pull toward the router's "
        "deadline (deferred)",
}

class InjectedFault(RuntimeError):
    """Raised by a ``raise`` rule: its own type, so recovery tests can
    assert the injected path (and only it) was taken."""


@dataclass
class FaultRule:
    """One armed injection point.  ``hits`` counts matching traversals,
    ``fired`` how many times the rule actually triggered."""

    site: str
    action: str
    tag: str | None = None     # None matches any tag at the site
    first: int = 1             # fire from the Nth matching hit ...
    last: int | None = 1       # ... through this one (None = open-ended)
    arg: float | None = None   # seconds for stall/delay
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def matches(self, site: str, tag: str | None) -> bool:
        return self.site == site and (self.tag is None or self.tag == tag)

    def due(self) -> bool:
        """Whether the CURRENT hit count falls in the firing window."""
        if self.hits < self.first:
            return False
        return self.last is None or self.hits <= self.last

    def describe(self) -> str:
        site = self.site if self.tag is None else f"{self.site}/{self.tag}"
        when = ("*" if (self.first, self.last) == (1, None)
                else f"{self.first}+" if self.last is None
                else str(self.first))
        out = f"{site}:{self.action}@{when}"
        return out if self.arg is None else f"{out}:{self.arg:g}"


def _parse_rule(text: str) -> FaultRule:
    parts = text.strip().split(":")
    if len(parts) < 2:
        raise ValueError(
            f"fault rule {text!r} must look like site[/tag]:action[@when][:arg]"
        )
    site_tag, action_when = parts[0], parts[1]
    site, _, tag = site_tag.partition("/")
    if not site:
        raise ValueError(f"fault rule {text!r}: empty site")
    action, _, when = action_when.partition("@")
    if action not in ACTIONS:
        raise ValueError(
            f"fault rule {text!r}: unknown action {action!r} "
            f"(choose from {sorted(ACTIONS)})"
        )
    first, last = 1, 1
    if when:
        if when == "*":
            first, last = 1, None
        elif when.endswith("+"):
            first, last = int(when[:-1]), None
        else:
            first = last = int(when)
    if first < 1:
        raise ValueError(f"fault rule {text!r}: hit index must be >= 1")
    arg: float | None = None
    if len(parts) > 2:
        arg = float(parts[2])
        if arg < 0:
            raise ValueError(f"fault rule {text!r}: arg must be >= 0")
    if action in ("stall", "delay") and arg is None:
        raise ValueError(
            f"fault rule {text!r}: {action} needs a seconds arg "
            f"(e.g. {site}:{action}@1:0.5)"
        )
    return FaultRule(site=site, action=action, tag=tag or None,
                     first=first, last=last, arg=arg)


class FaultPlane:
    """A set of :class:`FaultRule`\\ s consulted by instrumented hot paths.

    Thread contract: each rule's counters are touched only by the
    thread(s) traversing its site (the engine thread for ``batcher.*`` /
    ``kv.*``, the event loop for ``proto.*``, ``xfer.*``, ``replica.*``,
    ``router.*``); a fleet gives each replica a plane of its own.  ``add``
    from another thread is a GIL-atomic list append, so tests may arm new
    rules mid-run.  A respawned batcher shares its predecessor's plane by
    reference, so a rule that fired stays fired across the restart.
    """

    def __init__(self, rules: list[FaultRule] | None = None) -> None:
        self.rules: list[FaultRule] = list(rules or [])

    @classmethod
    def parse(cls, spec: str | None, strict: bool = False) -> "FaultPlane":
        """Build a plane from the comma-separated spec grammar above.
        ``None``/empty parses to an empty (never-firing) plane.
        ``strict=True`` additionally rejects sites absent from
        :data:`FAULT_SITES`: operator entry points use it so a rule that
        could never fire fails the boot instead of parsing into a no-op."""
        rules = [
            _parse_rule(part)
            for part in (spec or "").split(",") if part.strip()
        ]
        if strict:
            sites = {r.site for r in rules}
            unknown = sorted(sites - set(FAULT_SITES))
            if unknown:
                raise ValueError(
                    f"unknown fault site(s) {unknown}; wired sites: "
                    f"{sorted(FAULT_SITES)}"
                )
        return cls(rules)

    def add(self, site: str, action: str, when: str = "1",
            arg: float | None = None, tag: str | None = None) -> FaultRule:
        """Arm one rule programmatically (``when`` uses the spec grammar:
        ``"3"``, ``"2+"``, ``"*"``).  Returns the rule for later
        inspection (``rule.fired``)."""
        text = f"{site}{'/' + tag if tag else ''}:{action}@{when}"
        if arg is not None:
            text += f":{arg}"
        rule = _parse_rule(text)
        self.rules.append(rule)
        return rule

    def fire(self, site: str, tag: str | None = None,
             defer_stall: bool = False) -> FaultRule | None:
        """Record a traversal of ``site`` and trigger the first due rule.

        ``raise`` rules raise :class:`InjectedFault`; ``stall`` rules sleep
        ``arg`` seconds here (blocking: they model a wedged device call).
        Every other action is returned as the rule for the call site to
        apply.  Returns ``None`` when nothing fired.  ``defer_stall=True``
        returns a due ``stall`` rule instead of sleeping."""
        hit: FaultRule | None = None
        for rule in self.rules:
            if not rule.matches(site, tag):
                continue
            rule.hits += 1
            if hit is None and rule.due():
                hit = rule
        if hit is None:
            return None
        hit.fired += 1
        METRICS.inc("faults.fired")
        METRICS.inc(f"faults.fired.{hit.action}")
        log.warning("fault injected: %s (hit %d at %s%s)", hit.describe(),
                    hit.hits, site, f"/{tag}" if tag else "")
        if hit.action == "raise":
            raise InjectedFault(
                f"injected fault at {site}"
                f"{'/' + tag if tag else ''} (rule {hit.describe()})"
            )
        if hit.action == "stall" and not defer_stall:
            # graftlint: ignore[GL401](stall deliberately blocks the engine thread — it models a wedged device call for the watchdog)
            time.sleep(hit.arg or 0.0)
        return hit

    def describe(self) -> str:
        return ",".join(r.describe() for r in self.rules)
