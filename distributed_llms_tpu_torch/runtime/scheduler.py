"""Scheduling policy for continuous batching (PyTorch port of
``distributed_llms_tpu/runtime/scheduler.py``).

Every scheduling DECISION the engine loop takes — admission order, prefill
chunk sizing, preemption victim selection, the memory-pressure ladder and
the dispatch-ahead sync-trigger list — is a declared hook on a policy
object; the batcher (``runtime/batcher.py``) owns the mechanism.  The two
base policies are copied unchanged:

- ``mixed`` (default) — pending prefill bites fuse into the decode step;
- ``alternate`` — chunked prefills run as their own serialized forwards.

The batcher's chunked prefill, mixed step and dispatch-ahead loop
consult these hooks (``chunk_threshold``, ``prefill_bite``,
``fuse_prefill``, ``sync_triggers``); a speculative batcher's ``mixed``
policy is :class:`SpecMixedScheduler`, whose ``spec_round_k`` sizes each
row's rounds, and a ``mixed`` policy with tenant weights or a tenant row
cap is :class:`TenantScheduler` (weighted-fair admission by virtual token
counter).  Hooks are model-free: plain host data in, decisions out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

from ..core.observability import METRICS

# Rung names of the declared pressure ladder.  "evict_spill" is implicit in
# pool accounting (available() counts evictable cached pages); the preempt
# rungs gate whether a victim swaps out or requeues for exact recompute;
# "back_pressure" is the terminal rung (admission waits).
PRESSURE_LADDER = (
    "evict_spill", "swap_preempt", "recompute_preempt", "back_pressure",
)


@dataclass(frozen=True)
class SyncView:
    """Host-state snapshot ``sync_triggers`` decides from — everything is
    deterministic scheduling state (never wall clocks), so a multi-process
    mesh evaluates identical views in lockstep.  ``grow_blocked`` is a
    thunk (page growth probes pool accounting and allocates from spare
    capacity) evaluated only when no cheaper trigger already fired."""

    any_active: bool          # last-known activity vector has a live row
    cancel_dirty: bool        # resident-row cancel taken mid-span
    queued: bool              # a request awaits admission
    kv_imports: bool          # a verified KV handoff awaits adoption
    prefills: int             # chunked prefills in flight (started)
    head_prefill_left: int    # prompt tokens the head prefill still owes
    #                           (after already-dispatched bites)
    live_budgets: tuple[int, ...]  # device-budget mirrors of live rows
    chunks_ahead: int         # chunks already dispatched this span
    grow_blocked: Callable[[], bool]  # paged growth needs PRESSURE


class Scheduler:
    """The ``alternate`` policy: chunked prefills advance as serialized
    ``prefill_chunk_step`` rounds (decode stalls for each bite) and any
    pending prefill parks the dispatch-ahead plane — exactly the PR-3..12
    inline behavior, now behind the declared hooks."""

    name = "alternate"

    def __init__(self, *, chunk_steps: int = 8,
                 prefill_chunk: int | None = None,
                 prefill_concurrency: int = 2,
                 token_budget: int | None = None,
                 speculative: bool = False,
                 spec_adaptive: bool = True) -> None:
        if token_budget is not None and token_budget < 1:
            raise ValueError(
                f"token_budget must be >= 1, got {token_budget}"
            )
        self.chunk_steps = chunk_steps
        self.prefill_chunk = prefill_chunk
        self.prefill_concurrency = prefill_concurrency
        self.token_budget = token_budget
        self.speculative = speculative
        self.spec_adaptive = spec_adaptive

    # -- admission order ---------------------------------------------------

    def admission_order(self, queue: Sequence[Any]) -> Any | None:
        """Highest priority first, FIFO (rid) within a priority.  A
        preempted request keeps its original rid, so it resumes ahead of
        later same-priority arrivals.  Deterministic in the queue contents
        alone, so multi-process meshes stay lockstep."""
        if not queue:
            return None
        return max(queue, key=lambda r: (r.priority, -r.rid))

    # -- chunk sizing against the token budget -----------------------------

    def chunk_threshold(self) -> int | None:
        """Prompts longer than this take the chunked path; None = every
        prompt admits monolithically.  Alternate chunks only when the
        operator configured ``prefill_chunk``."""
        return self.prefill_chunk

    def prefill_bite(self, remaining: int, n_active: int) -> int:
        """Prompt tokens the next prefill step consumes.  Alternate spends
        a full ``prefill_chunk`` per round regardless of how many decode
        rows it stalls — the over-spend the mixed policy exists to bound."""
        return min(remaining, self.prefill_chunk or remaining)

    def fuse_prefill(self) -> bool:
        """Alternate dispatches prefill bites as their own forwards."""
        return False

    # -- victim selection --------------------------------------------------

    def select_victim(self, candidates: Sequence[tuple[int, int, int]],
                      below_priority: int | None = None) -> int | None:
        """The row to preempt under pool pressure: lowest priority first,
        most-recently-admitted among equals (its lost work is smallest —
        vLLM's recompute-preemption policy).  ``candidates`` are
        ``(slot, priority, admit_seq)`` tuples for the preemptable rows;
        ``below_priority`` restricts to STRICTLY lower-priority victims
        (the admission path: a newcomer never preempts its own class,
        which would livelock two requests trading the same pages)."""
        best: int | None = None
        best_key: tuple[int, int] | None = None
        for slot, priority, admit_seq in candidates:
            if below_priority is not None and priority >= below_priority:
                continue
            key = (priority, -admit_seq)
            if best is None or key < best_key:
                best, best_key = slot, key
        return best

    # -- pressure ladder ---------------------------------------------------

    def pressure_rungs(self) -> tuple[str, ...]:
        """The ordered ladder a dry pool escalates through
        (:data:`PRESSURE_LADDER`).  The batcher consults membership:
        dropping ``swap_preempt`` from a policy would send every victim
        straight to exact recompute."""
        return PRESSURE_LADDER

    # -- tenant accounting (no-ops on the base policies) -------------------

    def note_admitted(self, req: Any, est_tokens: int) -> None:
        """A request left the queue for a slot.  ``est_tokens`` is the
        admission-time upper bound (prompt + decode budget); tenant-fair
        subclasses charge it against the request's tenant.  Base
        policies keep no per-tenant accounts."""

    def note_freed(self, req: Any, emitted: int) -> None:
        """An admitted row released its slot (completion, cancel, or
        preemption) having actually emitted ``emitted`` tokens this
        residency.  Tenant-fair subclasses refund the unspent part of
        the admission charge and decrement residency.  Base: no-op."""

    # -- speculative round sizing ------------------------------------------

    def spec_round_k(self, k_max: int, emas: Sequence[float],
                     n_active: int) -> list[int]:
        """Per-row draft length for the next speculative round.  The
        alternate policy never downshifts: every row drafts the full k
        (the PR-6..16 behavior), and the batcher's traced clamp is inert.
        ``emas`` is one acceptance-rate EMA per batch slot (1.0 for
        non-live slots)."""
        return [k_max] * len(emas)

    # -- overlap sync triggers ---------------------------------------------

    def sync_triggers(self, view: SyncView) -> list[str]:
        """The conditions that END a dispatch-ahead span (empty list =
        the next chunk may dispatch from the device-resident carry).
        THE sync-trigger list (README "Engine overlap"):

        - ``all_idle``: every row already idle as of the last-known
          activity vector — never chain behind a possibly-all-idle chunk;
        - ``cancel``: a resident-row cancel taken while the carry was
          device-resident;
        - ``queued`` / ``kv_import``: admission work is waiting;
        - ``prefill``: a chunked prefill is in flight (alternate parks
          the overlap plane for the whole prefill; the mixed policy
          narrows this to the finishing splice);
        - ``budget_certain``: every live row will have exhausted its
          budget within the chunks already dispatched — the next chunk
          could only be a ghost;
        - ``page_pressure``: a row near its page horizon could not grow
          from spare pool capacity (preemption must run on fresh
          mirrors).
        """
        out: list[str] = []
        if not view.any_active:
            out.append("all_idle")
        if view.cancel_dirty:
            out.append("cancel")
        if view.queued:
            out.append("queued")
        if view.kv_imports:
            out.append("kv_import")
        if view.prefills:
            out.append(self._prefill_trigger(view))
        if self._budget_certain(view):
            out.append("budget_certain")
        out = [t for t in out if t]
        if not out and view.grow_blocked():
            out.append("page_pressure")
        return out

    def _prefill_trigger(self, view: SyncView) -> str | None:
        return "prefill"

    def _budget_certain(self, view: SyncView) -> bool:
        """Whether every live row will be done within the chunks already
        dispatched.  Plain chunks commit exactly ``chunk_steps`` tokens
        per active row; a speculative round commits at least one.  EOS
        finishes are not host-predictable, so a rare ghost behind an EOS
        remains (it pads nothing into the stream)."""
        per_chunk = 1 if self.speculative else self.chunk_steps
        return all(
            b <= view.chunks_ahead * per_chunk for b in view.live_budgets
        )


class MixedScheduler(Scheduler):
    """The ``mixed`` policy: one fused token-budget step.  Pending prefill
    chunks become budgeted work INSIDE the decode step — each dispatch
    runs K decode tokens for every active slot plus up to
    ``token_budget - n_active`` prompt tokens of the head pending prefill
    in the same compiled program — so decode never stalls for a
    serialized prefill forward, and a pending prefill no longer parks
    the dispatch-ahead span (it syncs only for the finishing splice,
    which is an admission decision).  With ``token_budget`` unset the
    bite falls back to ``prefill_chunk`` (fusion without re-budgeting);
    with it set, prompts longer than the budget auto-chunk even when
    ``prefill_chunk`` was never configured."""

    name = "mixed"

    def chunk_threshold(self) -> int | None:
        if self.prefill_chunk is not None:
            return self.prefill_chunk
        if self.token_budget is not None and not self.speculative:
            # Auto-chunk: any prompt the budget cannot cover in one step
            # takes the fused path (speculative admission stays
            # monolithic — its draft prefill cannot chunk).
            return self.token_budget
        return None

    def prefill_bite(self, remaining: int, n_active: int) -> int:
        if self.token_budget is None:
            return super().prefill_bite(remaining, n_active)
        # Decode rows claim their legs first; the floor of 1 keeps a
        # fully-busy batch from starving the prefill outright (one token
        # per step still makes progress toward the finishing splice).
        return min(remaining, max(1, self.token_budget - n_active))

    def fuse_prefill(self) -> bool:
        return True

    def _prefill_trigger(self, view: SyncView) -> str | None:
        # A prefill with work left feeds the NEXT fused chunk — keep
        # dispatching ahead.  Only the finishing splice (an admission:
        # first-token sample + pool scatter, a host decision) syncs.
        return None if view.head_prefill_left > 0 else "prefill_finish"


class SpecMixedScheduler(MixedScheduler):
    """Budget-aware speculative rounds: the ``mixed`` policy of a
    speculative batcher (:func:`make_scheduler` picks it).  A round
    charges ``k_row + 1`` committable tokens a live row to the token
    budget, and two clamps size each row's bound:

    - the budget (engine-wide): k shrinks until the round's committable
      sum fits ``token_budget``;
    - the acceptance (per row): ``max(1, round(ema * k_max))`` — a cold
      draft's rounds shrink toward plain-decode granularity.

    These bound commits, not work: the round always drafts ``k_max``
    tokens and verifies ``k_max + 1`` (one captured graph for every
    clamp), and the forced stop emits the target's own token, so streams
    are the same at any clamp.  ``spec_adaptive=False`` keeps the full k.
    """

    name = "mixed"

    def spec_round_k(self, k_max: int, emas: Sequence[float],
                     n_active: int) -> list[int]:
        if not self.spec_adaptive:
            return [k_max] * len(emas)
        kb = k_max
        if self.token_budget is not None and n_active:
            while kb > 1 and n_active * (kb + 1) > self.token_budget:
                kb -= 1
        return [min(kb, max(1, int(e * k_max + 0.5))) for e in emas]


# Queue entries with no tenant id share one anonymous bucket: they are
# fair-shared against named tenants at the default weight, so an operator
# can turn fairness on without forcing every client to tag its traffic.
ANON_TENANT = "-"


def parse_tenant_weights(spec: "str | dict | None") -> dict[str, float]:
    """Parse the ``--tenant-weights`` / ``RuntimeConfig.tenant_weights``
    spelling (``"gold:4,free:1"``) into {tenant: weight}.  A ``*`` entry
    sets the DEFAULT weight unknown (and anonymous) tenants serve at;
    absent, it is 1.0.  Dicts pass through validated.  Weights must be
    finite and > 0 — a zero weight is a starvation knob, not a share."""
    import math

    if spec is None:
        return {}
    if isinstance(spec, dict):
        items = list(spec.items())
    else:
        items = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, w = part.partition(":")
            if not sep or not name.strip():
                raise ValueError(
                    f"tenant weight entry {part!r} must look like "
                    "name:weight (e.g. gold:4,free:1)"
                )
            items.append((name.strip(), w.strip()))
    out: dict[str, float] = {}
    for name, w in items:
        try:
            weight = float(w)
        except (TypeError, ValueError):
            raise ValueError(
                f"tenant {name!r}: weight {w!r} is not a number"
            ) from None
        if not math.isfinite(weight) or weight <= 0:
            raise ValueError(
                f"tenant {name!r}: weight must be finite and > 0, "
                f"got {weight}"
            )
        out[name] = weight
    return out


class TenantScheduler(MixedScheduler):
    """Weighted-fair multi-tenant admission — the ``mixed`` policy a
    tenant-QoS engine schedules under (selected by :func:`make_scheduler`
    when ``tenant_weights`` is set).  The fairness design is the virtual
    token counter of *Fairness in Serving Large Language Models* (VTC,
    OSDI '24), lifted from the request-level priority machinery to
    the TENANT level:

    - every admission charges its tenant's counter ``est / weight``
      tokens (est = prompt + decode budget, the same upper bound the
      router and cost gate use), and the release true-up refunds the
      unspent budget — so the counter tracks WEIGHTED SERVICE RECEIVED;
    - :meth:`admission_order` serves the backlogged tenant with the
      LOWEST counter first (then the base priority-desc / FIFO order
      within that tenant), so a tenant flooding the queue advances its
      own counter and cannot crowd out a lighter tenant's share;
    - the STARVATION GUARD is VTC's counter lift: a tenant returning
      from idle is lifted to the minimum counter among currently-live
      tenants, so idling never banks unbounded credit (it would
      otherwise monopolize the engine for its whole deficit) and a
      continuously-backlogged tenant can never be starved by returning
      ones — each admission strictly advances the minimum;
    - ``tenant_max_rows`` caps RESIDENT rows per tenant: a tenant at its
      cap defers (its queue entries wait; others admit past them), so
      one tenant can never hold every batch slot no matter its weight.

    Token-RATE quotas live one layer up at the serving gateway (the
    cheap place to shed: 429 + per-tenant Retry-After before any state
    exists); this class owns what must be decided at admission time.
    Deterministic in (queue contents, admission history) alone — no
    wall clocks — so multi-process meshes stay lockstep."""

    def __init__(self, *, tenant_weights: dict[str, float] | None = None,
                 tenant_max_rows: int | None = None, **kw: Any) -> None:
        super().__init__(**kw)
        if tenant_max_rows is not None and tenant_max_rows < 1:
            raise ValueError(
                f"tenant_max_rows must be >= 1, got {tenant_max_rows}"
            )
        self.tenant_weights = dict(tenant_weights or {})
        self.default_weight = self.tenant_weights.pop("*", 1.0)
        self.tenant_max_rows = tenant_max_rows
        self._vtc: dict[str, float] = {}       # weighted service received
        self._resident: dict[str, int] = {}    # rows currently in slots
        self._charged: dict[int, tuple[str, float]] = {}  # rid -> charge
        self._live: set[str] = set()           # tenants seen since idle

    def weight(self, tenant: "str | None") -> float:
        return self.tenant_weights.get(tenant or ANON_TENANT,
                                       self.default_weight)

    @staticmethod
    def _tenant_of(req: Any) -> str:
        return getattr(req, "tenant", None) or ANON_TENANT

    def _publish(self, tenant: str) -> None:
        METRICS.set_gauge(f"tenant.vtc.{tenant}",
                          self._vtc.get(tenant, 0.0))
        METRICS.set_gauge(f"tenant.resident_rows.{tenant}",
                          self._resident.get(tenant, 0))

    def admission_order(self, queue: Sequence[Any]) -> Any | None:
        if not queue:
            return None
        by_tenant: dict[str, list[Any]] = {}
        for r in queue:
            by_tenant.setdefault(self._tenant_of(r), []).append(r)
        # Starvation guard (the VTC lift): a tenant re-entering from idle
        # is lifted to the minimum counter among tenants already live —
        # idle time banks no credit, and the lift never REDUCES anyone.
        # sorted(): _live is a set, and this list feeds a decision —
        # iteration order must not depend on PYTHONHASHSEED / insertion
        # history, or lockstep processes could diverge (graftsync GS301;
        # min() below is order-insensitive today, but keep the closure
        # deterministic by construction, not by accident).
        live_counters = [
            self._vtc.get(t, 0.0)
            for t in sorted(self._live)
            if t in by_tenant or self._resident.get(t, 0) > 0
        ]
        floor = min(live_counters, default=0.0)
        for t in by_tenant:
            if t not in self._live:
                self._vtc[t] = max(self._vtc.get(t, 0.0), floor)
                self._publish(t)
        # Live = backlogged or resident; everyone else re-lifts on return.
        self._live = {t for t in set(self._live) | set(by_tenant)
                      if t in by_tenant or self._resident.get(t, 0) > 0}
        # Cardinality bound: tenant ids are client-minted, so idle entries
        # must not accumulate forever.  An idle tenant AT OR BELOW the
        # floor carries no information — its return is lifted to the floor
        # anyway — so dropping it is semantically a no-op; an overserved
        # idle tenant (counter above floor) keeps its debt until the floor
        # catches up.
        for t in [t for t, v in self._vtc.items()
                  if t not in self._live and v <= floor]:
            del self._vtc[t]
            self._resident.pop(t, None)
            self._publish(t)  # gauges read 0 for the dropped tenant
        cap = self.tenant_max_rows
        eligible = [
            t for t in by_tenant
            if cap is None or self._resident.get(t, 0) < cap
        ]
        if not eligible:
            # Every backlogged tenant sits at its resident-row cap: defer
            # admission (rows free at chunk boundaries and re-trigger it).
            return None
        pick = min(eligible, key=lambda t: (self._vtc.get(t, 0.0), t))
        return super().admission_order(by_tenant[pick])

    def note_admitted(self, req: Any, est_tokens: int) -> None:
        t = self._tenant_of(req)
        charge = est_tokens / self.weight(t)
        self._vtc[t] = self._vtc.get(t, 0.0) + charge
        self._resident[t] = self._resident.get(t, 0) + 1
        self._charged[req.rid] = (t, charge)
        self._live.add(t)
        self._publish(t)

    def note_freed(self, req: Any, emitted: int) -> None:
        got = self._charged.pop(req.rid, None)
        if got is None:  # unpaired release (defensive: never double-free)
            return
        t, charge = got
        # True-up: the admission charged prompt + FULL budget; refund the
        # budget tokens never emitted so a short completion is not billed
        # like a long one.  actual = prompt + emitted, never below 0.
        actual = (len(req.ids) + emitted) / self.weight(t)
        self._vtc[t] = max(0.0, self._vtc[t] - max(0.0, charge - actual))
        self._resident[t] = max(0, self._resident.get(t, 0) - 1)
        self._publish(t)


POLICIES: dict[str, type[Scheduler]] = {
    "alternate": Scheduler,
    "mixed": MixedScheduler,
}


def make_scheduler(name: str, **knobs: Any) -> Scheduler:
    """Build the named policy (``--schedule`` / ``RuntimeConfig.schedule``).
    Unknown names fail loudly — a typo'd schedule must not silently serve
    the default.  A speculative engine's ``mixed`` policy resolves to the
    :class:`SpecMixedScheduler` subclass (budget-aware spec rounds), and
    a ``tenant_weights``-carrying ``mixed`` policy to
    :class:`TenantScheduler` (weighted-fair tenant admission) — new
    scheduling behaviors land as subclasses here, not batcher branches."""
    tenant_weights = knobs.pop("tenant_weights", None)
    tenant_max_rows = knobs.pop("tenant_max_rows", None)
    tenant_fair = bool(tenant_weights) or tenant_max_rows is not None
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; known: {sorted(POLICIES)}"
        ) from None
    if tenant_fair:
        if cls is not MixedScheduler:
            raise ValueError(
                "tenant weighted-fair scheduling rides the mixed policy; "
                "use --schedule mixed (the default) with tenant weights"
            )
        if knobs.get("speculative"):
            raise ValueError(
                "tenant weighted-fair scheduling does not compose with "
                "speculative batching yet (the spec round ledger and the "
                "tenant counters would double-charge the budget); serve "
                "tenant-fair traffic through a plain engine"
            )
        return TenantScheduler(
            tenant_weights=parse_tenant_weights(tenant_weights),
            tenant_max_rows=tenant_max_rows, **knobs,
        )
    if knobs.get("speculative") and cls is MixedScheduler:
        cls = SpecMixedScheduler
    return cls(**knobs)
