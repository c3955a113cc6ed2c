"""Stage assignment: pack layers into pipeline stages (a copy of
``distributed_llms_tpu/parallel/stages.py``, which is pure numpy).

- `partition_contiguous`: optimal contiguous split (DP over prefix sums)
  minimizing the max stage byte size, the policy a `pipe` mesh axis needs;
- `uniform_stages`: the equal split the stacked-layer pipeline reshapes to;
- `pack_greedy`: greedy largest-first min-bin packing of whole items,
  kept for non-pipelined placement (the shard store's layout,
  ``checkpoint/store.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StageAssignment:
    """boundaries[i] = first layer of stage i; stage i owns
    layers[boundaries[i]:boundaries[i+1]]."""

    num_layers: int
    boundaries: tuple[int, ...]  # length num_stages + 1; [0, ..., num_layers]

    @property
    def num_stages(self) -> int:
        return len(self.boundaries) - 1

    def layers_of(self, stage: int) -> range:
        return range(self.boundaries[stage], self.boundaries[stage + 1])

    def stage_of(self, layer: int) -> int:
        return int(np.searchsorted(self.boundaries, layer, side="right") - 1)

    @property
    def uniform(self) -> bool:
        sizes = {len(self.layers_of(s)) for s in range(self.num_stages)}
        return len(sizes) == 1


def partition_contiguous(layer_bytes: list[int], num_stages: int) -> StageAssignment:
    """Optimal contiguous partition minimizing max stage bytes (linear
    partition problem, O(L^2 * S) DP — L is tens of layers, cost trivial)."""
    n = len(layer_bytes)
    if num_stages <= 0 or num_stages > n:
        raise ValueError(f"num_stages {num_stages} must be in [1, {n}]")
    prefix = np.concatenate([[0], np.cumsum(layer_bytes)])

    def seg(i: int, j: int) -> int:  # bytes of layers [i, j)
        return int(prefix[j] - prefix[i])

    INF = float("inf")
    # dp[s][j] = minimal max-stage-cost splitting first j layers into s stages
    dp = np.full((num_stages + 1, n + 1), INF)
    cut = np.zeros((num_stages + 1, n + 1), dtype=int)
    dp[0][0] = 0
    for s in range(1, num_stages + 1):
        for j in range(s, n + 1):
            for i in range(s - 1, j):
                cost = max(dp[s - 1][i], seg(i, j))
                if cost < dp[s][j]:
                    dp[s][j] = cost
                    cut[s][j] = i
    bounds = [n]
    j = n
    for s in range(num_stages, 0, -1):
        j = int(cut[s][j])
        bounds.append(j)
    return StageAssignment(num_layers=n, boundaries=tuple(reversed(bounds)))


def uniform_stages(num_layers: int, num_stages: int) -> StageAssignment:
    """Equal split; requires divisibility (the stacked-param pipeline reshapes
    [L, ...] -> [stages, L/stages, ...])."""
    if num_layers % num_stages:
        raise ValueError(f"{num_layers} layers not divisible by {num_stages} stages")
    per = num_layers // num_stages
    return StageAssignment(
        num_layers=num_layers,
        boundaries=tuple(range(0, num_layers + 1, per)),
    )


def pack_greedy(item_bytes: dict[str, int], num_bins: int) -> dict[str, int]:
    """Greedy largest-first min-bin packing: returns {item: bin}.  Ties
    keep the items' order and the lowest bin wins."""
    bins = [0] * num_bins
    out: dict[str, int] = {}
    for name in sorted(item_bytes, key=item_bytes.__getitem__, reverse=True):
        b = int(np.argmin(bins))
        bins[b] += item_bytes[name]
        out[name] = b
    return out
