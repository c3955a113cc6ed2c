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

The standalone loop, :func:`speculative_generate_tokens` (the engine's
``generate_text_speculative`` and ``generate_text``'s transparent
routing), runs on ``generate_tokens``'s right-padded layout: emitted token
i of row b lives at cache slot T + i with RoPE position prompt_lens[b] + i,
and a token's KV is written by the forward call that CONSUMES it.  Rows
advance by different amounts a round, so every cache write takes the
per-row ``cache_index`` with an explicit mask (``models.model``'s per-row
legs, dense under the mask).  Rollback is free: a rejected slot is never
undone — the masks cap every read at the row's committed frontier, and
the slot is overwritten when the frontier reaches it.  At temperature 0
the tokens are ``generate_tokens``' for any draft; above it, rejection
sampling (Leviathan et al. 2023) draws an exact sample of the target's
warped distribution.
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.config import ModelConfig
from ..models import model as model_lib
from . import sampling
from .generate import last_logits, window_key_positions


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


def _prefill(params, cfg, prompt, prompt_lens, max_len):
    b, t = prompt.shape
    cache = model_lib.init_cache(cfg, b, max_len, device=prompt.device)
    positions = torch.arange(t, device=prompt.device,
                             dtype=torch.int32).expand(b, t)
    logits, cache = model_lib.forward(params, cfg, prompt,
                                      positions=positions, cache=cache,
                                      cache_index=0)
    return last_logits(logits, prompt_lens), cache


@torch.no_grad()
def speculative_generate_tokens(
    target_params: Any,
    target_cfg: ModelConfig,
    draft_params: Any,
    draft_cfg: ModelConfig,
    prompt: torch.Tensor,        # [B, T] int32, right-padded with pad_id
    prompt_lens: torch.Tensor,   # [B] int32 true lengths
    k: int = 4,                  # draft tokens a round
    max_new_tokens: int = 32,
    eos_id: int = -1,            # -1 => never stops early
    pad_id: int = 0,
    return_stats: bool = False,
    temperature: float = 0.0,    # 0 => greedy (exact); > 0 => speculative
    #                              sampling (distribution-preserving)
    top_k: int = 0,
    top_p: float = 1.0,
    generator: torch.Generator | None = None,  # required when temperature > 0
) -> "torch.Tensor | tuple[torch.Tensor, dict[str, int]]":
    """Speculative decode.  Returns new tokens [B, max_new_tokens]
    (positions after a row's EOS hold pad_id).  Temperature 0: greedy,
    the tokens of ``generate_tokens(..., temperature=0.0)`` on the target
    alone.  Temperature > 0: rejection sampling — an exact sample of the
    target's warped distribution, from another random stream than
    ``generate_tokens``' (so per-seed tokens differ, the distribution does
    not).

    With ``return_stats``: also ``{"rounds", "drafted", "accepted"}``
    summed over the batch, counted as the reference counts them.  The loop
    reads one flag from the device a round (whether any row still runs)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    sampled = temperature > 0.0
    if sampled and generator is None:
        raise ValueError("temperature > 0 requires a generator")
    for cfg, who in ((target_cfg, "target"), (draft_cfg, "draft")):
        if cfg.ragged_decode:
            # The ragged kernel reads each row's full slot prefix —
            # including right-pad slots the masks here exclude.
            raise ValueError(f"{who} cfg.ragged_decode is unsupported here")
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            "draft and target must share a vocabulary: "
            f"{draft_cfg.vocab_size} != {target_cfg.vocab_size}"
        )

    b, t = prompt.shape
    dev = prompt.device
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    # The verify can write up to k+1 slots past the last in-budget frontier.
    max_len = t + max_new_tokens + k + 1
    tgt_logits0, tgt_cache = _prefill(target_params, target_cfg, prompt,
                                      prompt_lens, max_len)
    _, drf_cache = _prefill(draft_params, draft_cfg, prompt, prompt_lens,
                            max_len)

    slots = torch.arange(max_len, device=dev)            # [S]
    prompt_valid = slots[None, :] < prompt_lens[:, None]  # [B, S]
    rows = torch.arange(b, device=dev)
    kpos = window_key_positions(t, prompt_lens, max_len)
    tgt_win = ({} if target_cfg.sliding_window is None
               else {"key_positions": kpos})
    drf_win = ({} if draft_cfg.sliding_window is None
               else {"key_positions": kpos})

    def gen_mask(e, q_off):
        """[B, 1, 1, S] valid keys of a query at emitted index
        e - 1 + q_off (its own write slot included)."""
        hi = t + e - 1 + q_off
        gen = (slots[None, :] >= t) & (slots[None, :] <= hi[:, None])
        return (prompt_valid | gen)[:, None, None, :]

    if sampled:
        tok0 = sampling.sample(generator, tgt_logits0, temperature, top_k,
                               top_p)
    else:
        tok0 = sampling.greedy(tgt_logits0)
    del tgt_logits0
    width = max_new_tokens + k + 1
    out = torch.full((b, width), pad_id, dtype=torch.int32, device=dev)
    out[:, 0] = tok0
    e = torch.ones(b, dtype=torch.int32, device=dev)   # tokens emitted
    done = (tok0 == eos_id) if eos_id >= 0 else torch.zeros(
        b, dtype=torch.bool, device=dev)
    y = tok0
    stats = torch.zeros(3, dtype=torch.int64, device=dev)  # rounds,
    #   drafted, accepted
    j_ar = torch.arange(k + 1, device=dev)

    while bool((~done & (e < max_new_tokens)).any()):
        # -- draft: k single-token steps (per-row index).  Sampling keeps
        # each step's post-warp distribution q_j: the rejection test needs
        # q_j(d_j), the residual the whole vector.
        cur, drafts, qs = y, [], []
        for j in range(k):
            logits, drf_cache = model_lib.forward(
                draft_params, draft_cfg, cur[:, None],
                positions=(prompt_lens + e - 1 + j)[:, None],
                cache=drf_cache, cache_index=t + e - 1 + j,
                attn_mask=gen_mask(e, j), **drf_win,
            )
            step = logits[:, 0]
            if sampled:
                warped = sampling.warp_logits(step, temperature, top_k, top_p)
                cur = sampling._categorical(generator, warped)
                qs.append(torch.softmax(warped, dim=-1))
            else:
                cur = sampling.greedy(step)
            drafts.append(cur)
        drafts = torch.stack(drafts, dim=1)                   # [B, k]

        # -- verify: ONE target forward over [y, d_1..d_k] (k+1 tokens).
        vtoks = torch.cat([y[:, None], drafts], dim=1)
        vmask = torch.cat([gen_mask(e, q) for q in range(k + 1)], dim=2)
        vlogits, tgt_cache = model_lib.forward(
            target_params, target_cfg, vtoks,
            positions=prompt_lens[:, None] + e[:, None] - 1 + j_ar[None, :],
            cache=tgt_cache, cache_index=t + e - 1, attn_mask=vmask,
            **tgt_win,
        )
        budget = max_new_tokens - e                           # pre-commit
        if sampled:
            ps = torch.softmax(
                sampling.warp_logits(vlogits, temperature, top_k, top_p),
                dim=-1)                                       # [B, k+1, V]
            qs = torch.stack(qs, dim=1)                       # [B, k, V]
            di = drafts.long()[..., None]
            p_at = torch.gather(ps[:, :k], 2, di)[..., 0]
            q_at = torch.gather(qs, 2, di)[..., 0]
            # Accept d_j iff u_j < p_j(d_j) / q_j(d_j).
            u = torch.rand((b, k), generator=generator, device=dev)
            accept = u * torch.clamp(q_at, min=1e-20) < p_at
            a = torch.cumprod(accept.to(torch.int32), dim=1).sum(
                dim=1, dtype=torch.int32)                     # [B] in 0..k
            # The unified residual: q zero-extended, so position k's
            # "residual" is p_{k+1} itself (the bonus draw).
            q_ext = torch.cat([qs, torch.zeros_like(ps[:, :1])], dim=1)
            ai = a.long()[:, None, None].expand(b, 1, ps.shape[-1])
            p_a = torch.gather(ps, 1, ai)[:, 0]
            q_a = torch.gather(q_ext, 1, ai)[:, 0]
            resid = torch.clamp(p_a - q_a, min=0.0)
            norm = resid.sum(dim=-1, keepdim=True)
            # p == q on the whole support leaves no residual: any draw
            # from p is valid there.
            resid = torch.where(norm > 1e-9,
                                resid / torch.clamp(norm, min=1e-9), p_a)
            corr = sampling._categorical(
                generator, torch.where(
                    resid > 0, torch.log(torch.clamp(resid, min=1e-30)),
                    -torch.inf))
            cand = torch.where(j_ar[None, :] < a[:, None],
                               torch.cat([drafts, drafts[:, -1:]], dim=1),
                               corr[:, None]).to(torch.int32)
            m, has_eos = commit_clamp(cand, a, ~done, budget, eos_id, k)
        else:
            cand, m, has_eos, a = greedy_accept_commit(
                drafts, sampling.greedy(vlogits), ~done, budget, eos_id, k)
        del vlogits

        # Scatter the committed tokens into the (padded-wide) output; the
        # uncommitted go to a scratch column, reset to pad_id.
        valid = j_ar[None, :] < m[:, None]                    # [B, k+1]
        idx = torch.where(valid, e[:, None] + j_ar[None, :], width - 1)
        out[rows[:, None].expand(b, k + 1), idx.long()] = torch.where(
            valid, cand, pad_id)
        out[:, width - 1] = pad_id

        y = torch.where(m > 0, torch.gather(
            cand, 1, torch.clamp(m - 1, min=0).long()[:, None])[:, 0], y)
        e = e + m
        done = done | (has_eos & (m > 0))

        # -- draft backfill: after a FULLY accepted round the draft never
        # consumed d_k, leaving a hole one slot below the new frontier
        # (backfill_coords).
        bf_idx, bf_tok = backfill_coords(cand, m, frontier=t + e - 1)
        bf_gen = (slots[None, :] >= t) & (slots[None, :] <= bf_idx[:, None])
        model_lib.forward(
            draft_params, draft_cfg, bf_tok[:, None],
            positions=(prompt_lens + bf_idx - t)[:, None], cache=drf_cache,
            cache_index=bf_idx,
            attn_mask=(prompt_valid | bf_gen)[:, None, None, :], **drf_win,
        )
        # Drafted counts only drafts that could commit (at most
        # min(k, budget) a live row); accepted counts every committed
        # token when a clamp cut the round short of its bonus, else the
        # accepted drafts.
        stats[0] += 1
        stats[1] += torch.where(m > 0, torch.clamp(budget, max=k), 0).sum()
        stats[2] += torch.minimum(a, m).sum()

    toks = out[:, :max_new_tokens]
    if return_stats:
        r, d, acc = stats.tolist()
        return toks, {"rounds": r, "drafted": d, "accepted": acc}
    return toks
