"""Lockstep serving on a mesh: rank 0 owns the front end, the other ranks
follow.

A mesh batcher takes every scheduling decision on every rank from the
same host state (admission, preemption, swaps, growth, the decode loop),
so its ranks stay in step as long as they see the same requests at the
same points of the engine loop.  When the requests reach only rank 0 (the
HTTP gateway, ``dlt-serve-torch`` under ``torchrun``), its batcher does
not queue a submission or apply a cancellation when they arrive: it
journals them, and at the top of every engine iteration
(:meth:`Lockstep.sync`) broadcasts the journal to every rank, where each
event is applied, in journal order, before the iteration's decisions.
The other ranks run :func:`follow`: the same engine loop, fed only by the
broadcasts.  Between runs rank 0 broadcasts an idle beat every
:data:`BEAT_S` seconds so that no rank's wait reaches the process
group's timeout, and a stop at shutdown.

When every rank is fed the same requests itself (the control plane's
``generate_spmd``), no journal is needed and the batcher runs without
one.
"""

from __future__ import annotations

import threading
from typing import Any

from ..core.observability import get_logger

log = get_logger("lockstep")

ITER, IDLE, STOP = "iter", "idle", "stop"
BEAT_S = 5.0


class LockstepStopped(Exception):
    """Rank 0 stopped serving: a follower's engine loop ends."""


class Lockstep:
    """The journal of one mesh batcher (one per rank)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.leader = mesh.rank == 0
        self._lock = threading.Lock()
        self._journal: list[tuple] = []  # guarded-by: self._lock
        self.syncs = 0

    def record(self, event: tuple) -> None:
        """Journal an event on rank 0 (a submission or a cancellation)."""
        with self._lock:
            self._journal.append(event)

    def pending(self) -> list[tuple]:
        with self._lock:
            return list(self._journal)

    def sync(self, batcher) -> None:
        """The top of an engine iteration: rank 0 broadcasts its journal,
        and every rank applies it to ``batcher`` in order.  A follower
        skips idle beats; a stop raises :class:`LockstepStopped`."""
        if self.leader:
            with self._lock:
                events, self._journal = self._journal, []
            self.mesh.broadcast_object((ITER, events), src=0)
        else:
            while True:
                kind, events = self.mesh.broadcast_object(None, src=0)
                if kind == STOP:
                    raise LockstepStopped()
                if kind == ITER:
                    break
        self.syncs += 1
        for ev in events:
            batcher._apply_event(ev)

    def beat(self) -> None:
        """Rank 0, between runs: tell the followers it is still there."""
        self.mesh.broadcast_object((IDLE, []), src=0)

    def stop(self) -> None:
        """Rank 0, at shutdown: end the followers' loops."""
        self.mesh.broadcast_object((STOP, []), src=0)


def follow(batcher: Any) -> None:
    """A follower rank's engine: the batcher's loop, run after run, fed
    by rank 0's broadcasts, until rank 0 stops."""
    while True:
        try:
            batcher.run()
        except LockstepStopped:
            log.info("rank %d: rank 0 stopped serving", batcher.pm.mesh.rank)
            return
        batcher.results.clear()
        batcher.result_logprobs.clear()
        batcher.prefix_cached_tokens.clear()
        batcher.shed.clear()
