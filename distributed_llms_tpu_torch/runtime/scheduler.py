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
row's rounds.  The tenant-fair policy is a later slice.  Hooks are
model-free: plain host data in, decisions out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

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


POLICIES: dict[str, type[Scheduler]] = {
    "alternate": Scheduler,
    "mixed": MixedScheduler,
}


def make_scheduler(name: str, **knobs: Any) -> Scheduler:
    """Build the named policy (``--schedule`` / ``RuntimeConfig.schedule``).
    Unknown names fail loudly — a typo'd schedule must not silently serve
    the default.  A speculative batcher's ``mixed`` policy is
    :class:`SpecMixedScheduler`."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; known: {sorted(POLICIES)}"
        ) from None
    if knobs.get("speculative") and cls is MixedScheduler:
        cls = SpecMixedScheduler
    return cls(**knobs)
