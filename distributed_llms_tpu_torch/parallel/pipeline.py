"""Pipeline parallelism over a ``pipe`` mesh axis (PyTorch port of
``distributed_llms_tpu/parallel/pipeline.py``).

Each rank is one stage: it holds the contiguous block of ``L/P`` layers
at its pipe coordinate (``split_stages``) and that block's KV cache
``[L/P, B, S, KVH, HD]``.  Activations hop stage to stage around the
ring (``core.mesh.Mesh.shift``, the reference's ``ppermute``):

- :func:`pipeline_blocks` runs the GPipe schedule: ``M + P - 1`` ticks,
  at tick ``t`` stage ``s`` runs microbatch ``t - s`` through its layers
  (its cache rows written only then), the last stage banks the result;
- :func:`pipeline_decode` runs the whole autoregressive loop as one
  wavefront that never drains between tokens: ``(N - 1) * Q + M + P - 1``
  ticks with ``Q = max(M, P)``.

The reference gates every stage's duties branchlessly inside one SPMD
program (``jnp.where(stage == 0, ...)``); here each rank branches on its
own pipe coordinate in Python, and every rank runs the same ticks and
enters the same ring shifts in the same order, whatever its role.  A tick
on which a stage has no microbatch computes nothing.

The head is split between the ends of the pipe
(``ParallelModel.place_leaf``): stage 0 holds the embedding, the last
stage the final norm and the unembedding.  So the wavefront's sampling
runs where the logits are, on the last stage, and the sampled tokens
ride the ring's last hop to stage 0 (packed bit for bit into the
activation buffer the hop carries), which embeds them; the reference's
stage 0 does both ends itself from a replicated head.  The schedule,
the ticks and the cache slots are the reference's.

Inside a stage the ``model`` axis runs its collectives as on a data x
tensor-parallel mesh (``parallel/plan.py``), and a microbatch whose rows
divide over ``data`` runs each rank's block of rows, gathered after the
stage (:func:`stage_forward`).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.config import ModelConfig
from ..models import model as model_lib
from ..runtime import sampling
from . import plan as plan_lib

Params = Any


def map_leaves(fn, t):
    if isinstance(t, dict):
        return {k: map_leaves(fn, v) for k, v in t.items()}
    return fn(t)


def _reshape(t, shape_fn):
    from ..checkpoint.quantize import QuantizedTensor

    if isinstance(t, QuantizedTensor):
        return QuantizedTensor(_reshape(t.data, shape_fn),
                               _reshape(t.scale, shape_fn), t.bits,
                               t.orig_shape, t.pack_axis)
    return t.reshape(shape_fn(t.shape))


def split_stages(blocks: Params, num_stages: int) -> Params:
    """[L, ...] stacked block params -> [P, L/P, ...] (a ``QuantizedTensor``
    leaf splits its codes and scales alike)."""
    def shape(s):
        if s[0] % num_stages:
            raise ValueError(
                f"layers {s[0]} not divisible by stages {num_stages}")
        return (num_stages, s[0] // num_stages, *s[1:])

    return map_leaves(lambda a: _reshape(a, shape), blocks)


def merge_stages(blocks: Params) -> Params:
    """[P, L/P, ...] -> [L, ...]."""
    return map_leaves(
        lambda a: _reshape(a, lambda s: (s[0] * s[1], *s[2:])), blocks)


def _split_mb(x: torch.Tensor, m: int) -> torch.Tensor:
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    return x.reshape(m, b // m, *x.shape[1:])


def stage_forward(x: torch.Tensor, blocks: Params, cfg: ModelConfig,
                  positions: torch.Tensor, cache_k, cache_v, cache_index,
                  attn_mask=None, key_positions=None, remat: bool = False,
                  std_layout: bool = False) -> torch.Tensor:
    """One stage's layers over one microbatch ``x`` [mb, T, D] (every
    row).  Under a plan whose 'data' line splits ``mb`` rows, this rank
    runs its block of rows (the new K/V of every row gathered before the
    cache writes, ``models/model.py``) and the stage's output is gathered
    over 'data', so every rank of a stage leaves it with every row."""
    plan = plan_lib.current()
    split = (plan.row_split(x.shape[0], moe=cfg.num_experts > 0)
             if plan is not None and plan.rows is None else None)
    if split is None:
        return model_lib.run_blocks(
            x, blocks, cfg, positions, cache_k, cache_v, cache_index,
            attn_mask, remat=remat, std_layout=std_layout,
            key_positions=key_positions)[0]
    lo, hi = split
    with plan.with_rows(split).active():
        y, _ = model_lib.run_blocks(
            x[lo:hi], blocks, cfg, positions[lo:hi], cache_k, cache_v,
            cache_index, attn_mask, remat=remat, std_layout=std_layout,
            key_positions=key_positions)
    return plan.mesh.all_gather(y, 0, "data")


def _rows(t, lo: int, hi: int):
    return None if t is None else t[lo:hi]


def pipeline_blocks(
    mesh,
    cfg: ModelConfig,
    blocks: Params,  # this stage's [L/P, ...] block params
    x: torch.Tensor | None,  # [B, T, D] after embed (read on stage 0 only)
    positions: torch.Tensor,  # [B, T]
    num_microbatches: int,
    cache_k: torch.Tensor | None = None,  # this stage's [L/P, B, S, KVH, HD]
    cache_v: torch.Tensor | None = None,
    cache_index: int | None = None,  # scalar write offset
    attn_mask: torch.Tensor | None = None,  # [B, 1, Tq, S]
    remat: bool = False,
    key_positions: torch.Tensor | None = None,  # [B, S] slot->position map
    #   for sliding-window models under the right-padded decode layout
    std_layout: bool = False,  # positions are the standard arange (see
    #   models.model._attention)
) -> torch.Tensor | None:
    """Run the decoder blocks through the pipeline (GPipe schedule).  The
    stage's cache rows are written in place.  Returns the blocks' output
    [B, T, D] on the last stage, None on the others."""
    p, s = mesh.size("pipe"), mesh.coord("pipe")
    m = num_microbatches
    b, t = positions.shape
    pos_mb = _split_mb(positions, m)
    mb = b // m
    if cache_k is not None and cache_index is None:
        raise ValueError("a cached pipeline forward needs cache_index")
    dtype = model_lib.torch_dtype(cfg.dtype)
    dev = positions.device
    idle = torch.zeros((mb, t, cfg.hidden_size), dtype=dtype, device=dev)
    out = (torch.empty((b, t, cfg.hidden_size), dtype=dtype, device=dev)
           if s == p - 1 else None)
    state = idle
    ticks = m + p - 1
    for tick in range(ticks):
        i = tick - s
        send = idle
        if 0 <= i < m:
            lo, hi = i * mb, (i + 1) * mb
            x_in = x[lo:hi] if s == 0 else state
            ck = cache_k[:, lo:hi] if cache_k is not None else None
            cv = cache_v[:, lo:hi] if cache_v is not None else None
            y = stage_forward(x_in, blocks, cfg, pos_mb[i], ck, cv,
                              cache_index, _rows(attn_mask, lo, hi),
                              _rows(key_positions, lo, hi), remat=remat,
                              std_layout=std_layout)
            if out is not None:
                out[lo:hi] = y
            send = y
        if tick < ticks - 1:
            # The activations move one stage forward; stage 0 ignores what
            # the last stage sends and reads its next microbatch instead.
            state = mesh.shift(send, "pipe")
    return out


def _pack_tokens(tok: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The hop's buffer (``like``'s shape and dtype) carrying ``tok`` [mb]
    int32 bit for bit in its first 4 bytes a row."""
    buf = torch.zeros_like(like)
    buf.view(torch.int32).reshape(buf.shape[0], -1)[:, 0] = tok.to(torch.int32)
    return buf


def _unpack_tokens(buf: torch.Tensor) -> torch.Tensor:
    return buf.view(torch.int32).reshape(buf.shape[0], -1)[:, 0]


def pipeline_decode(
    mesh,
    cfg: ModelConfig,
    params: Params,  # this stage's tree (ParallelModel.shard_params)
    tok0: torch.Tensor,  # [B] int32: first token, sampled from the prefill
    prompt_lens: torch.Tensor,  # [B] int32 true prompt lengths
    prompt_pad_len: int,  # T: padded prompt length = cache write base
    cache_k: torch.Tensor,  # this stage's [L/P, B, S, KVH, HD] (prefilled)
    cache_v: torch.Tensor,
    num_new_tokens: int,
    num_microbatches: int,
    generator: torch.Generator | None,  # the sampling stream (last stage)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int = -1,
    pad_id: int = 0,
) -> torch.Tensor:
    """Fused wavefront decode: the whole autoregressive loop as one
    schedule that never drains between tokens.

    Stage 0 starts microbatch ``m``'s token ``j`` at tick ``j*Q + m``
    (``Q = max(M, P)``).  The last stage finishes it at tick
    ``j*Q + m + P - 1``, applies the final norm and unembedding, samples
    token ``j+1`` (EOS-frozen rows pad-filled), banks it and sends it
    around the ring's last hop; stage 0 embeds it on arrival and parks it
    until its start tick.  ``Q`` ticks a token round: with ``M >= P``
    microbatches in flight every stage is busy every tick.

    Exactness: the per-token path's math (masks, cache slots, stage
    partition); greedy streams are exact.  Sampling draws from
    ``generator`` one microbatch at a time in the schedule's order (the
    reference keys each draw ``fold_in(fold_in(rng, j), m)``): the same
    distribution, another stream.

    Returns tokens [B, N] int32 on every rank (the last stage's bank,
    broadcast over 'pipe'); each stage's cache is updated in place."""
    p, s = mesh.size("pipe"), mesh.coord("pipe")
    m_, n_ = num_microbatches, num_new_tokens
    q = max(m_, p)
    b = tok0.shape[0]
    tok0_mb = _split_mb(tok0.to(torch.int32), m_)
    plens_mb = _split_mb(prompt_lens.to(device=tok0.device,
                                        dtype=torch.int32), m_)
    mb = b // m_
    t_base = prompt_pad_len
    s_len = cache_k.shape[2]
    ticks = (n_ - 1) * q + m_ + p - 1
    dev = tok0.device
    dtype = model_lib.torch_dtype(cfg.dtype)
    blocks = params["blocks"]
    first, last = s == 0, s == p - 1
    slots = torch.arange(s_len, device=dev)
    idle = torch.zeros((mb, 1, cfg.hidden_size), dtype=dtype, device=dev)

    def emb(tok, pos):  # [mb], [mb] -> [mb, 1, D]
        return model_lib.embed(params, cfg, tok[:, None], pos[:, None])

    if first:  # next-token embeddings, one buffer a microbatch
        buf = [emb(tok0_mb[i], plens_mb[i]) for i in range(m_)]
    if last:  # the token bank and the EOS state
        out = torch.zeros((n_, m_, mb), dtype=torch.int32, device=dev)
        out[0] = tok0_mb
        done = ((tok0_mb == eos_id) if eos_id >= 0
                else torch.zeros((m_, mb), dtype=torch.bool, device=dev))
        pad = torch.full((mb,), pad_id, dtype=torch.int32, device=dev)
    state = idle
    for t in range(ticks):
        # -- stage-0 arrival: the token the last stage sampled at tick t-1
        # for (m', j'), u' = t - P, becomes microbatch m''s next input.
        up = t - p
        if first and up >= 0 and up % q < m_ and up // q + 1 < n_:
            mp, jp = up % q, up // q
            buf[mp] = emb(_unpack_tokens(state), plens_mb[mp] + jp + 1)
        # -- this tick's stage compute: (m, j) with u = t - stage.
        u = t - s
        send = idle
        if u >= 0 and u % q < m_ and u // q < n_:
            m_idx, j = u % q, u // q
            lo, hi = m_idx * mb, (m_idx + 1) * mb
            x_in = buf[m_idx] if first else state
            plens = plens_mb[m_idx]
            prompt_valid = slots[None, :] < plens[:, None]
            gen_valid = (slots[None, :] >= t_base) & (slots[None, :] <= t_base + j)
            mask = (prompt_valid | gen_valid)[:, None, None, :]
            kpos = None
            if cfg.sliding_window is not None:
                # Prompt slot i holds position i; generated slot t_base + i
                # holds position len + i (runtime.generate's map).
                kpos = torch.where(slots[None, :] < t_base, slots[None, :],
                                   plens[:, None] + (slots[None, :] - t_base))
            y = stage_forward(x_in, blocks, cfg, (plens + j)[:, None],
                              cache_k[:, lo:hi], cache_v[:, lo:hi],
                              t_base + j, mask, kpos)
            send = y
            if last and j + 1 < n_:
                logits = model_lib.unembed(params, cfg, y)[:, 0]
                tok = sampling.sample(generator, logits, temperature, top_k,
                                      top_p)
                tok = torch.where(done[m_idx], pad, tok)
                if eos_id >= 0:
                    done[m_idx] = done[m_idx] | (tok == eos_id)
                out[j + 1, m_idx] = tok
                send = _pack_tokens(tok, idle)
        if t < ticks - 1:
            state = mesh.shift(send, "pipe")
    bank = (out.reshape(n_, b).T.contiguous() if last
            else torch.empty((b, n_), dtype=torch.int32, device="meta"))
    return mesh.broadcast(bank, p - 1, "pipe")
