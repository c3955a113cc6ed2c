"""Speculative decoding's accept/commit bookkeeping (PyTorch port of the
three functions of ``distributed_llms_tpu/runtime/speculative.py`` that the
continuous batcher shares with the reference's standalone loop).

A round drafts k tokens a row with a cheap model, verifies all of them in
ONE (k+1)-token target forward and commits the longest agreeing prefix
plus one token (the target's own: the bonus after k acceptances, the
correction at the first disagreement).  At temperature 0 every committed
token is the target's greedy token in its context, for any draft (the
plain greedy stream wherever the verify's logits round as a plain step's),
and the draft only changes how many tokens arrive a round.  The round
itself is ``runtime/batcher.py``'s :func:`~.batcher.spec_chunk`; these are
the plain tensor functions it calls, with the reference's names and
contracts.

The reference's standalone loop (``speculative_generate_tokens`` and the
engine's ``generate_text_speculative``) runs on ``generate_tokens``'s
right-padded layout, which the port does not have yet: it is ported with
``runtime/generate.py`` (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import torch


def greedy_accept_commit(
    drafts: torch.Tensor,   # [B, k] draft tokens d_1..d_k
    greedy: torch.Tensor,   # [B, k+1] target greedy tokens g_1..g_{k+1}
    live: torch.Tensor,     # [B] bool — rows that may commit this round
    budget: torch.Tensor,   # [B] int32 — tokens each row may still emit
    eos_id: int,
    k: int,
    k_row: torch.Tensor | None = None,  # [B] int32 per-row draft length:
    #   acceptance stops at j < k_row[b], so a row commits at most
    #   k_row[b] + 1 tokens; the forced stop emits greedy[j], the token the
    #   sequential greedy decode emits there, so the stream is the same at
    #   any clamp
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy acceptance and commit bookkeeping.  Returns (cand [B, k+1],
    m [B], has_eos [B], a [B]): commit ``cand[:m]`` per row; ``m`` counts
    the EOS cut, the budget clamp and dead rows; ``a`` is the raw count of
    accepted drafts."""
    agree = drafts == greedy[:, :k]
    if k_row is not None:
        jk = torch.arange(k, device=drafts.device)
        agree = agree & (jk[None, :] < k_row[:, None])
    lead = torch.cumprod(agree.to(torch.int32), dim=1)
    a = lead.sum(dim=1, dtype=torch.int32)               # [B] in 0..k
    j_ar = torch.arange(k + 1, device=drafts.device)
    # Accepted drafts, then the bonus / correction (greedy[j] at j == a).
    cand = torch.where(j_ar[None, :] < a[:, None],
                       torch.cat([drafts, drafts[:, -1:]], dim=1),
                       greedy).to(torch.int32)
    m, has_eos = commit_clamp(cand, a, live, budget, eos_id, k)
    return cand, m, has_eos, a


def commit_clamp(
    cand: torch.Tensor,    # [B, k+1] committed candidates
    a: torch.Tensor,       # [B] accepted-draft counts
    live: torch.Tensor,    # [B] bool
    budget: torch.Tensor,  # [B] int32
    eos_id: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The commit count: a+1 candidates, cut after the first committed EOS
    (inclusive), clamped to the row's budget, zero for dead rows.  Shared
    by the greedy and the rejection-sampling rounds.  Returns (m [B]
    int32, has_eos [B] bool)."""
    j_ar = torch.arange(k + 1, device=cand.device)
    m = a.to(torch.int32) + 1
    if eos_id >= 0:
        is_eos = (cand == eos_id) & (j_ar[None, :] < m[:, None])
        # argmax of the first True: int casts keep it well defined on
        # every backend.
        eos_pos = torch.argmax(is_eos.to(torch.int32), dim=1).to(torch.int32)
        has_eos = is_eos.any(dim=1)
        m = torch.where(has_eos, torch.minimum(m, eos_pos + 1), m)
    else:
        has_eos = torch.zeros(cand.shape[0], dtype=torch.bool,
                              device=cand.device)
    m = torch.minimum(m, budget.to(torch.int32))
    m = torch.where(live, m, torch.zeros_like(m))
    return m, has_eos


def backfill_coords(
    cand: torch.Tensor,      # [B, k+1] committed candidates
    m: torch.Tensor,         # [B] committed counts
    frontier: torch.Tensor,  # [B] the slot the NEXT round's first feed writes
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draft-backfill coordinates: after a fully accepted round the draft
    never consumed the last accepted draft, leaving a hole in its cache
    one slot below the new frontier.  Rounds with 2 <= m <= k rewrite an
    already-correct slot with the same token (harmless); m < 2 points at
    the frontier slot, which the next round's first draft step overwrites
    before any query reads it.  Returns (bf_idx [B], bf_tok [B])."""
    bf_idx = torch.where(m >= 2, frontier - 1, frontier).to(torch.int32)
    bf_tok = torch.gather(
        cand, 1, torch.clamp(m - 2, min=0).long()[:, None])[:, 0]
    return bf_idx, bf_tok
