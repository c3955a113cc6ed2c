"""Continuation masking (PyTorch port of the part of
``distributed_llms_tpu/runtime/session.py`` the batcher uses).

Multi-turn sessions with host-DRAM KV spill are a later slice; the
prefix-cached admission path needs only :func:`continuation_mask`.
"""

from __future__ import annotations

import torch


def continuation_mask(
    valid_mask: torch.Tensor,  # [B, S] (or [1, S]) prior-content slots
    base: int,                 # first padded slot of the new chunk
    t: int,                    # chunk length (padded)
    slots: torch.Tensor,       # [S] = arange(S)
) -> torch.Tensor:
    """[B, 1, T, S] attention mask for prefilling a chunk at slots
    [base, base+t) against existing cache content: query i attends prior
    valid slots plus chunk slots j <= i (right padding means pad slots have
    j greater than every real query's i)."""
    rel = slots[None, :] - base  # [1, S]: slot index within the chunk
    chunk_causal = (rel[:, None, :] >= 0) & (
        rel[:, None, :] <= torch.arange(t, device=slots.device)[None, :, None]
    )  # [1, T, S]
    return (valid_mask[:, None, :] | chunk_causal)[:, None, :, :]
