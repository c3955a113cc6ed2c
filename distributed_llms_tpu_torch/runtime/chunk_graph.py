"""The decode chunk as a captured CUDA graph.

No module of the reference corresponds to this one: its counterpart is
``jax.jit`` of ``distributed_llms_tpu/runtime/batcher.py``
``decode_chunk``, the compiled program the host dispatches with one call.
Eagerly, the port's chunk costs the host one launch per kernel (about 20 a
layer, every layer, every step), far more than the chunk costs the card;
a replay of a captured graph costs one.

:class:`ChunkGraphs` holds one graph per plan key (batch, steps, cache
kind, the per-row sampling arrays present, the sampling scalars: see
``batcher.decode_chunk``).  A graph is captured at the first chunk of its
key and replayed after that:

- its inputs are static buffers, allocated outside the capture; each call
  copies its inputs into them on the current stream (the carry of the
  previous chunk device to device, host arrays from pinned memory);
- its output is one packed buffer, cloned after each replay, so the
  caller may dispatch the next chunk before it reads this one;
- it is captured after one eager run of the same chunk on the same
  inputs, which sets up every kernel outside the capture (attributes,
  lazy loading, library workspaces);  the eager run's cache writes are
  the ones the first replay repeats.  A buffer the chunk accumulates into
  (the penalty histogram: ``carried``) is saved before that run and put
  back after it, so only replays count;
- the batcher's ``torch.Generator`` is registered with it, so each replay
  advances the generator as the eager chunk would;
- the kernels' launch counters count at capture only; the capture's own
  increments are taken back, and each replay adds them again.  The
  counters are process-wide: with several engine threads (a replica
  fleet) they sum every replica's launches, and the replays other threads
  add during a capture are kept out of the capture's count (their eager
  kernel calls in that window would not be: the serving decode path has
  none on CUDA, where every chunk replays).

The graphs of one :class:`ChunkGraphs` share one memory pool.  A capture
that fails raises; nothing falls back to the eager chunk.

One capture runs in the process at a time (:data:`_CAPTURE_LOCK`): a
replica fleet runs one engine thread per replica, and torch's capture
context shares one side stream among every capture that names none and
empties the allocator's cache on entry, which may not run while another
thread captures.  Only the captures serialize; replays and eager work of
the other engine threads go on, on the current (legacy default) stream.  There is no
switch: the batcher's device decides (CUDA tensors replay, CPU tensors run
the eager chunk).
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from ..ops import decode_attn, flash, quant_matmul

# Every kernel launch counter of the port: (wrapper, attribute).
LAUNCH_COUNTERS = (
    (decode_attn.paged_decode_attention, "launches"),
    (decode_attn.paged_decode_attention, "int8_launches"),
    (decode_attn.ragged_decode_attention, "launches"),
    (decode_attn.ragged_decode_attention, "int8_launches"),
    (quant_matmul.quant_matmul, "launches"),
    (quant_matmul.quant_matmul, "int4_launches"),
    (flash.flash_attention, "static_launches"),
    (flash.flash_attention, "dynamic_launches"),
    (flash.tile_summary, "launches"),
)


# Held across a capture and its warm-up: at most one in the process.
_CAPTURE_LOCK = threading.Lock()
# Guards the counters' read-modify-writes from replays and the capture
# window's tally: what other threads' replays add while a capture runs
# (``_foreign``: [thread id, counts], or None) is not the capture's.
_COUNT_LOCK = threading.Lock()
_foreign: list | None = None


def read_launches() -> list[int]:
    return [getattr(fn, attr) for fn, attr in LAUNCH_COUNTERS]


def add_launches(counts: list[int]) -> None:
    with _COUNT_LOCK:
        for (fn, attr), n in zip(LAUNCH_COUNTERS, counts):
            setattr(fn, attr, getattr(fn, attr) + n)
        if _foreign is not None and _foreign[0] != threading.get_ident():
            _foreign[1] = [a + n for a, n in zip(_foreign[1], counts)]


class _Graph:
    def __init__(self, graph, static, out, launches) -> None:
        self.graph = graph
        self.static = static      # name -> static input buffer
        self.out = out            # the packed output buffer
        self.launches = launches  # kernel launches per replay


class ChunkGraphs:
    """Captured decode chunks of one batcher (one cache, one set of
    weights), keyed by plan."""

    def __init__(self) -> None:
        self._graphs: dict = {}
        self._pool = None
        self.captures = 0
        self.replays = 0

    def run(self, key, fn: Callable[[dict], torch.Tensor],
            inputs: dict[str, torch.Tensor],
            generator: torch.Generator, carried=()) -> torch.Tensor:
        """``fn(inputs)`` — the chunk, reading only ``inputs`` and the
        tensors it closes over — by replay of the graph of ``key``,
        captured now if this is the key's first call.  ``carried``: the
        closed-over tensors the chunk updates by accumulation (not
        idempotent, unlike the cache writes), restored after the warm-up.
        Returns a fresh copy of the packed output."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(fn, inputs, generator,
                                                  carried)
        for name, src in inputs.items():
            g.static[name].copy_(src, non_blocking=True)
        g.graph.replay()
        add_launches(g.launches)
        self.replays += 1
        return g.out.clone()

    def _capture(self, fn, inputs, generator, carried=()) -> _Graph:
        with _CAPTURE_LOCK:
            return self._capture_locked(fn, inputs, generator, carried)

    def _capture_locked(self, fn, inputs, generator, carried=()) -> _Graph:
        static = {name: t.clone() for name, t in inputs.items()}
        rng = generator.get_state()
        saved = [t.clone() for t in carried]
        fn(static)  # the warm-up run: its launches are real, and count
        generator.set_state(rng)
        for t, s in zip(carried, saved):
            t.copy_(s)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        global _foreign
        with _COUNT_LOCK:
            before = read_launches()
            _foreign = [threading.get_ident(), [0] * len(before)]
        try:
            # "thread_local": the serving front end's own thread, and the
            # other replicas' engine threads, touch the runtime while this
            # engine thread captures.
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = fn(static)
        finally:
            with _COUNT_LOCK:
                after, foreign = read_launches(), _foreign[1]
                _foreign = None
        launches = [a - b - f for a, b, f in zip(after, before, foreign)]
        add_launches([-n for n in launches])  # a capture launches nothing
        self.captures += 1
        return _Graph(graph, static, out, launches)
