"""Host-RAM KV page tier behind the paged pool (``--host-pages``): the
PyTorch port of ``distributed_llms_tpu/runtime/kv_tier.py``'s
:class:`HostTier`, with the same contract and names.

Two kinds of parcels share one page budget:

- **swap parcels**: a preempted row's pages, raw pool bytes, keyed by an
  opaque handle carried on the requeued request; restore scatters them back
  instead of recomputing the prefix;
- **spilled pages**: cold prefix-cache pages captured just before LRU
  eviction, keyed by content digest; a later cache hit restores them
  instead of prefilling them again.

Where the card differs from the reference: the reference's worker thread
runs ``np.asarray`` on a device array, which is the device-to-host
transfer.  Here the host memory is ONE arena of ``pages`` page slots
allocated at construction (pinned when the pool lives on CUDA), so the
budget bounds real host bytes and no parking allocates.  A slot holds one
page in pool layout: K and V, plus the f32 scales of an int8 pool.  A park
enqueues its copies into the slots on the engine's current stream
(``copy_(..., non_blocking=True)``) and records an event; the worker
thread waits on that event, then computes the blake2b-16 checksum.  The
engine never waits for a device-to-host copy at preemption time.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any

import torch

from ..core.observability import METRICS, get_logger

log = get_logger("kv_tier")


def _runs(slots: list[int]):
    """(parcel offset, first slot, length) of each run of consecutive
    slots: one copy per run instead of one per page."""
    j = 0
    while j < len(slots):
        k = j + 1
        while k < len(slots) and slots[k] == slots[k - 1] + 1:
            k += 1
        yield j, slots[j], k - j
        j = k


@dataclass
class HostParcel:
    """The slots of a parcel taken out of the tier: ``arrays`` are the
    arena tensors ``[pages, L, BLK, ...]``, ``slots`` the parcel's pages
    in order.  The slots are free again once taken: read them (``to``)
    before the next park, which on CUDA is stream order (both copies are
    enqueued on the engine's one stream)."""

    arrays: tuple
    slots: list[int]

    def to(self, device) -> tuple:
        """The parcel on ``device`` in export layout ``[L, n, BLK, ...]``
        (views of one staged ``[n, L, BLK, ...]`` tensor per array),
        copied run by run; from pinned memory the copies do not block."""
        out = []
        for arena in self.arrays:
            staged = torch.empty((len(self.slots),) + tuple(arena.shape[1:]),
                                 dtype=arena.dtype, device=device)
            for j, s, n in _runs(self.slots):
                staged[j:j + n].copy_(arena[s:s + n], non_blocking=True)
            out.append(staged.transpose(0, 1))
        return tuple(out)


@dataclass
class _HostEntry:
    """One parcel: its arena slots and the worker's future, which resolves
    to the blake2b-16 checksum of the slots' bytes once the copy into them
    has completed."""

    slots: list[int]
    future: Any

    @property
    def n_pages(self) -> int:
        return len(self.slots)


class HostTier:
    """Host-RAM KV page tier behind the :class:`PagePool`.

    Swaps outrank spills: parking a swap may evict spilled pages (they are
    only a cache), never the other way.  ``park_*`` enqueues the copy into
    the arena and hands the checksum to a single worker thread;
    ``take_*`` joins it and VERIFIES the checksum: a corrupted parcel
    degrades to exact recompute / cold prefill rather than poisoning the
    cache.  ``layout`` is one ``(page shape, dtype)`` per parcel array
    (``batcher.page_layout``).

    Thread contract: park/take/drop run under ``_lock`` (engine thread,
    plus the serving thread's cancel path); the worker thread reads only
    its own parcel's slots."""

    def __init__(self, pages: int, layout, pin: bool = False) -> None:
        if pages < 1:
            raise ValueError(f"host tier needs >= 1 page, got {pages}")
        self.pages = pages
        self._arena = tuple(
            torch.zeros((pages,) + tuple(shape), dtype=dtype, pin_memory=pin)
            for shape, dtype in layout
        )
        self.pinned_bytes = (sum(a.numel() * a.element_size()
                                 for a in self._arena) if pin else 0)
        self._lock = threading.Lock()
        # graftflow: cleanup-required
        self._swaps: dict[int, _HostEntry] = {}  # guarded-by: self._lock
        self._spills: OrderedDict[bytes, _HostEntry] = OrderedDict()  # guarded-by: self._lock
        self._free_slots: list[int] = list(range(pages))  # guarded-by: self._lock
        self.used = 0  # guarded-by: self._lock
        self._next_handle = 0  # guarded-by: self._lock
        self._workers = None  # lazy single-thread executor

    # graftlint: holds(self._lock)
    def _executor(self):
        if self._workers is None:
            import concurrent.futures

            self._workers = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kv-host-tier"
            )
        return self._workers

    def _checksum(self, slots: list[int]) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for arena in self._arena:
            for _, s, n in _runs(slots):
                h.update(arena[s:s + n].view(torch.uint8).numpy())
        return h.digest()

    def _flip_byte(self, slots: list[int]) -> None:
        """Corrupt a parcel in host storage (the ``corrupt`` drill): flip
        the first byte of its first array; verification must catch it."""
        raw = self._arena[0][slots[0]].view(torch.uint8).view(-1)
        raw[0] ^= 0xFF

    def _seal(self, slots: list[int], done, corrupt: bool) -> bytes:
        """WORKER THREAD: wait for the copy into ``slots``, then checksum
        them.  ``corrupt`` stores a checksum the bytes cannot match (the
        reference flips a byte of its private host copy; here the slots
        may already belong to a newer parcel when an evicted entry's task
        runs, so the drill never writes them)."""
        if done is not None:
            done.synchronize()
        checksum = self._checksum(slots)
        if corrupt:
            checksum = bytes([checksum[0] ^ 0xFF]) + checksum[1:]
        return checksum

    # graftlint: holds(self._lock)
    def _copy_in(self, payload, slots: list[int]):
        """Enqueue the copy of ``payload`` (export layout ``[L, n, BLK,
        ...]``, its first ``len(slots)`` pages) into ``slots`` on the
        current stream; returns the event that marks it done (None on the
        CPU, where the copy has run)."""
        for arena, a in zip(self._arena, payload):
            staged = a[:, :len(slots)].transpose(0, 1).contiguous()
            for j, s, n in _runs(slots):
                arena[s:s + n].copy_(staged[j:j + n], non_blocking=True)
        if not payload[0].is_cuda:
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    # graftlint: holds(self._lock)
    def _fit_locked(self, n: int) -> bool:
        """Make room for ``n`` pages, evicting spilled pages (oldest
        first) if needed — spills are only a cache.  Swap parcels are
        never evicted: their content is the ONLY copy of a live request's
        KV."""
        while self.pages - self.used < n and self._spills:
            _, entry = self._spills.popitem(last=False)
            self._free_slots.extend(entry.slots)
            self.used -= 1
            METRICS.inc("batcher.host_tier.spill_evictions")
        return self.pages - self.used >= n

    # graftlint: holds(self._lock)
    def _alloc_slots(self, n: int) -> list[int]:
        """The ``n`` lowest free slots (runs stay long, copies few)."""
        self._free_slots.sort()
        slots = self._free_slots[:n]
        del self._free_slots[:n]
        self.used += n
        return slots

    def can_fit(self, n: int) -> bool:
        """Whether ``n`` pages could be parked right now (spills count as
        evictable).  Engine-thread advisory — the authoritative check is
        park's own."""
        with self._lock:
            return self.pages - self.used + len(self._spills) >= n

    def park_swap(self, payload, n_pages: int,
                  corrupt: bool = False) -> int | None:
        """Park a preempted row's raw page export; returns the handle the
        resume request carries, or None when the budget cannot fit it
        (the caller falls back to exact recompute)."""
        with self._lock:
            if not self._fit_locked(n_pages):
                return None
            slots = self._alloc_slots(n_pages)
            done = self._copy_in(payload, slots)
            fut = self._executor().submit(self._seal, slots, done, corrupt)
            handle = self._next_handle
            self._next_handle += 1
            self._swaps[handle] = _HostEntry(slots, fut)
        return handle

    def _verified(self, entry: _HostEntry, what: str, corrupt: bool = False):
        """The entry's parcel if its bytes match their checksum, else None
        (its slots are free again either way).  ``corrupt`` flips a byte
        of the parcel first (the take-side drill)."""
        try:
            checksum = entry.future.result()
        except Exception:
            # A failed copy (a device error surfacing on the event) must
            # degrade to exact recompute, not crash the engine — the same
            # contract as a checksum mismatch.
            log.exception("host-tier %s copy failed", what)
            return None
        if corrupt:
            self._flip_byte(entry.slots)
        if self._checksum(entry.slots) != checksum:
            log.warning("host-tier %s failed verification", what)
            return None
        return HostParcel(self._arena, entry.slots)

    def take_swap(self, handle: int, corrupt: bool = False):
        """Resolve and REMOVE a swap parcel: returns its
        :class:`HostParcel`, or None when the handle is unknown or the
        checksum fails (the caller falls back to exact recompute either
        way).  Budget is released even on verification failure — the
        parcel is gone."""
        with self._lock:
            entry = self._swaps.pop(handle, None)
            if entry is None:
                return None
            self._free_slots.extend(entry.slots)
            self.used -= entry.n_pages
        return self._verified(entry, f"swap parcel {handle}", corrupt)

    def drop_swap(self, handle: int) -> None:
        """Free a swap parcel whose request will never resume (cancelled
        or shed while queued)."""
        with self._lock:
            entry = self._swaps.pop(handle, None)
            if entry is not None:
                self._free_slots.extend(entry.slots)
                self.used -= entry.n_pages

    def park_spill(self, digests: list[bytes], payload,
                   corrupt: bool = False) -> int:
        """Park soon-to-be-evicted cached pages (export layout, one digest
        per page).  Best-effort: parks the prefix that fits after evicting
        older spills; returns how many pages were parked.  Each page is an
        entry of its own (one slot, its own checksum), so evicting it
        frees exactly its slot."""
        with self._lock:
            room = 0
            for _ in digests:
                if not self._fit_locked(1):
                    break
                self.used += 1
                room += 1
            if not room:
                return 0
            self.used -= room
            slots = self._alloc_slots(room)
            done = self._copy_in(payload, slots)
            for i, d in enumerate(digests[:room]):
                fut = self._executor().submit(
                    self._seal, [slots[i]], done, corrupt and i == 0
                )
                # Re-spilling content already parked would double-count
                # its budget page: drop the stale entry and free its slot.
                stale = self._spills.pop(d, None)
                if stale is not None:
                    self._free_slots.extend(stale.slots)
                    self.used -= 1
                self._spills[d] = _HostEntry([slots[i]], fut)
        return room

    def has_spill(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._spills

    def take_spill(self, digest: bytes):
        """Resolve and REMOVE one spilled page: returns its one-slot
        :class:`HostParcel`, or None when absent or corrupted (the caller
        prefills cold — correct, just slower)."""
        with self._lock:
            entry = self._spills.pop(digest, None)
            if entry is None:
                return None
            self._free_slots.extend(entry.slots)
            self.used -= 1
        return self._verified(entry, "spilled page")

    def stats(self) -> dict[str, int]:
        # Key names become batcher.host_tier.* GAUGES on /metrics
        # (publish_gauges): none may collide with a same-named counter —
        # "spill_entries" here vs the "spilled_pages" cumulative counter,
        # or the exposition renders one series under two TYPEs and the
        # whole scrape fails to parse.
        with self._lock:
            return {
                "pages": self.pages,
                "used": self.used,
                "swap_parcels": len(self._swaps),
                "spill_entries": len(self._spills),
            }

    def assert_consistent(self, swap_handles=()) -> None:
        """Audit the tier: budget accounting must equal the parcels held,
        every slot is free or held by exactly one parcel, and every parked
        swap handle must be owned by exactly one queued resume request
        (``swap_handles``) — a handle nobody will ever restore or free is
        a host-RAM leak, the tier's analogue of the pool's dangling
        refcount."""
        with self._lock:
            swaps = {h: list(e.slots) for h, e in self._swaps.items()}
            spill_slots = [s for e in self._spills.values() for s in e.slots]
            free = list(self._free_slots)
            used = self.used
        expect = set(swap_handles)
        held = set(swaps)
        n_swapped = sum(len(s) for s in swaps.values())
        assert used == n_swapped + len(spill_slots), (
            f"host tier budget diverged: used={used}, swaps="
            f"{ {h: len(s) for h, s in swaps.items()} }, "
            f"spilled={len(spill_slots)}"
        )
        assert used <= self.pages, (
            f"host tier over budget: {used} > {self.pages}"
        )
        owned = [s for sl in swaps.values() for s in sl] + spill_slots
        assert sorted(owned + free) == list(range(self.pages)), (
            f"host tier slots diverged: held={sorted(owned)} "
            f"free={sorted(free)}"
        )
        assert held == expect, (
            f"host-tier swap handles diverge from queued resume requests: "
            f"parked={sorted(held)} expected={sorted(expect)}"
        )
