"""What a forward on a mesh shards, for the model code that runs it.

``models/model.py`` and ``models/layers.py`` take the rank's LOCAL
parameters (``parallel/specs.py``) and the local config; the collectives
that GSPMD inserts in the reference are written out there, and they read
this rank's :class:`Plan` from :func:`current` (thread-local, set by
``ParallelModel`` for the forwards it runs).  Without a plan a forward is
the single-device one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_local = threading.local()


def current() -> "Plan | None":
    """The plan of the forward running on this thread, or None."""
    return getattr(_local, "plan", None)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One rank's share of a forward.

    - ``heads``: Q heads shard over 'model', so ``wo`` is row-parallel and
      its partial products are summed over the 'model' line;
    - ``kv_map``: with KV heads replicated (they do not divide over
      'model'), the global KV head each local Q head reads (local Q head j
      of rank r reads ``(r * H/tp + j) // (H/KVH)``); None when KV heads
      shard with the Q heads;
    - ``ffn``: the MLP hidden axis shards, so ``w_down`` / ``w_out`` (and
      an MoE block's expert ``w_down``) are row-parallel;
    - ``vocab``: the embedding and unembedding shard the vocabulary (a
      masked local lookup summed over 'model'; logits gathered over it);
    - ``rows``: the batch rows ``[lo, hi)`` this rank computes when the
      forward splits rows over 'data' (set per forward by
      :meth:`with_rows`); every row's new K/V is gathered over 'data'
      before the cache write, so each rank's cache holds every row;
    - ``seq``: a sequence-parallel forward of ``ParallelModel`` (the
      port's counterpart of the reference's ``shard_map`` over 'seq'):
      "block" when x holds this rank's block of the tokens (the no-cache
      forward and the prefill: the final hidden states are gathered over
      'seq' before the unembedding, so every rank returns the whole
      sequence's logits), "whole" when every rank holds the whole input
      (the one-token decode); None outside them.  Ring and Ulysses
      attention and the seq-cached decode take their 'seq' line from
      here, and refuse to run without it;
    - ``experts``: ``[lo, hi)`` of the ``E`` experts this rank holds when
      the expert stacks shard over 'expert' (``models/layers.py``
      ``moe_swiglu`` runs those and sums the claims' rows over the
      'expert' line); None when they are whole on every rank (one
      'expert' rank, a dense model, or ``E`` not dividing over the axis,
      where the rule replicates them).
    """

    mesh: object  # core.mesh.Mesh
    heads: bool
    kv_map: tuple | None
    ffn: bool
    vocab: bool
    rows: tuple | None = None
    seq: str | None = None
    experts: tuple | None = None

    @contextlib.contextmanager
    def active(self):
        prev = current()
        _local.plan = self
        try:
            yield self
        finally:
            _local.plan = prev

    def row_split(self, b: int, moe: bool) -> tuple | None:
        """``[lo, hi)`` of a ``b``-row forward on this rank, or None when
        every rank of the 'data' line computes all rows (one 'data' rank,
        rows that do not divide, or an MoE model, whose expert capacity
        counts every row of the batch: each rank routes every row, the
        reference's capacity semantics)."""
        dp = self.mesh.size("data")
        if dp == 1 or b % dp or moe:
            return None
        per = b // dp
        i = self.mesh.coord("data")
        return (i * per, (i + 1) * per)

    def with_rows(self, rows: tuple | None) -> "Plan":
        return dataclasses.replace(self, rows=rows)

    def kv_index(self, device) -> torch.Tensor:
        return torch.tensor(self.kv_map, dtype=torch.long, device=device)
