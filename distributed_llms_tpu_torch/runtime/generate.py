"""Autoregressive one-shot generation: one prefill, then a decode loop
(PyTorch port of ``distributed_llms_tpu/runtime/generate.py``).

Prefill fills the KV cache for the whole right-padded prompt in one pass;
then each step emits one token a row with EOS-aware freezing.  The JAX
package runs the loop as a ``lax.scan`` inside one jit; here it is a plain
Python loop over the same static shapes.

Ragged batches: prompts are right-padded to T.  Every decode step writes
all rows' K/V at the SAME cache slot (T + step), so the write is one slice
assignment; per-row token positions (``prompt_lens + step``) feed RoPE,
and an explicit attention mask keeps each row on its own real prompt slots
plus the generated slots.  Slot != position in this gapped layout, so a
sliding-window model is handed each slot's true position
(:func:`window_key_positions`).
"""

from __future__ import annotations

from typing import Any

import torch

from ..core.config import ModelConfig, RuntimeConfig
from ..models import model as model_lib
from . import sampling


def _default_forward(params, cfg, tokens, positions=None, cache=None,
                     cache_index=None, attn_mask=None, key_positions=None):
    return model_lib.forward(
        params, cfg, tokens, positions=positions, cache=cache,
        cache_index=cache_index, attn_mask=attn_mask,
        key_positions=key_positions,
    )


def window_key_positions(t: int, prompt_lens: torch.Tensor,
                         max_len: int) -> torch.Tensor:
    """[B, S] true RoPE position of every cache slot under the right-padded
    generate layout (prompt slots 0..t-1, generated token j at slot t+j,
    position len+j): the one definition of the slot -> position map the
    sliding-window mask needs (``models.model._attention``
    ``key_positions``).  Shared by :func:`generate_tokens` and
    ``runtime.speculative``."""
    slots = torch.arange(max_len, dtype=torch.int32,
                         device=prompt_lens.device)[None, :]
    return torch.where(slots < t, slots,
                       prompt_lens[:, None].to(torch.int32) + (slots - t))


def last_logits(logits: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[B, T, V] -> [B, V]: each row's logits at its last real token."""
    last = torch.clamp(lens.long() - 1, min=0)
    return logits[torch.arange(logits.shape[0], device=logits.device), last]


@torch.no_grad()
def generate_tokens(
    params: Any,
    cfg: ModelConfig,
    prompt: torch.Tensor,       # [B, T] int32, right-padded with pad_id
    prompt_lens: torch.Tensor,  # [B] int32 true lengths
    generator: torch.Generator | None,  # the sampling stream; unused (and
    #   may be None) at temperature 0, where no noise is drawn
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int = -1,  # -1 => never stops early
    pad_id: int = 0,
    forward_fn: Any = None,  # (params, cfg, tokens, positions=, cache=,
    #   cache_index=, attn_mask=, key_positions=) -> (logits, cache)
    make_cache: Any = None,  # (cfg, batch, max_len, prompt_len=) -> KVCache
    decode_fn: Any = None,  # the fused decode loop of a pipelined mesh
    #   (ParallelModel.as_decode_fn()): (params, tok0, prompt_lens, T,
    #   cache, generator, max_new_tokens, temperature, top_k, top_p,
    #   eos_id, pad_id) -> tokens [B, N]
) -> torch.Tensor:
    """Generate.  Returns new tokens [B, max_new_tokens] int32; positions
    after a row's EOS hold pad_id.

    ``forward_fn``/``make_cache`` default to the single-device model on
    the prompt's device.  ``runtime.session.session_step`` is the
    multi-turn generalization of this loop; the two stay separate (this
    prefill's ``attn_mask=None`` lets a flash model take the flash kernel)
    and are held equal by the tests — a change to the decode loop lands in
    both.  The KV cache holds T + max_new_tokens slots exactly."""
    if forward_fn is None:
        forward_fn = _default_forward
    dev = prompt.device
    if make_cache is None:
        def make_cache(cfg_, b_, s_, prompt_len=None):
            return model_lib.init_cache(cfg_, b_, s_, device=dev)
    b, t = prompt.shape
    max_len = t + max_new_tokens
    cache = make_cache(cfg, b, max_len, prompt_len=t)
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)

    # -- prefill: causal attention over the prompt slots (pad queries give
    # logits nobody reads; pad K/V slots are masked during decode).
    positions = torch.arange(t, device=dev, dtype=torch.int32).expand(b, t)
    logits, cache = forward_fn(params, cfg, prompt, positions=positions,
                               cache=cache, cache_index=0)
    cur_logits = last_logits(logits, prompt_lens)
    del logits

    if decode_fn is not None:
        # The fused wavefront decode of a pipelined mesh: the whole loop is
        # one schedule that never drains the pipeline between tokens,
        # max(M, P) ticks a token round instead of M + P - 1.
        tok0 = sampling.sample(generator, cur_logits, temperature, top_k,
                               top_p)
        return decode_fn(params, tok0, prompt_lens, t, cache, generator,
                         max_new_tokens, temperature, top_k, top_p, eos_id,
                         pad_id)

    slots = torch.arange(max_len, device=dev)
    prompt_valid = slots[None, :] < prompt_lens[:, None]  # [B, S]
    # Sliding-window models: the mask carries causality and validity by
    # SLOT, the window compares POSITIONS, and generated slot T+j sits at
    # position len+j — hand the forward the true map or the window widens
    # by the pad.
    win_kwargs = {}
    if cfg.sliding_window is not None:
        win_kwargs["key_positions"] = window_key_positions(t, prompt_lens,
                                                           max_len)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pad = torch.full((b,), pad_id, dtype=torch.int32, device=dev)
    toks = []
    for j in range(max_new_tokens):
        tok = sampling.sample(generator, cur_logits, temperature, top_k, top_p)
        tok = torch.where(done, pad, tok)
        if eos_id >= 0:
            done = done | (tok == eos_id)
        toks.append(tok)
        # Valid keys: real prompt slots + generated slots up to and
        # including this step's write slot (t + j).
        gen_valid = (slots[None, :] >= t) & (slots[None, :] <= t + j)
        mask = (prompt_valid | gen_valid)[:, None, None, :]  # [B, 1, 1, S]
        logits, cache = forward_fn(
            params, cfg, tok[:, None], positions=(prompt_lens + j)[:, None],
            cache=cache, cache_index=t + j, attn_mask=mask, **win_kwargs,
        )
        cur_logits = logits[:, 0]
    return torch.stack(toks, dim=1)  # [B, N]


def check_sequence_budget(prompt_len: int, max_new_tokens: int,
                          rt: RuntimeConfig, cfg: ModelConfig) -> None:
    """Prompt + decode budget must fit both the runtime limit and the
    model's position table."""
    limit = min(rt.max_seq_len, cfg.max_seq_len)
    if prompt_len + max_new_tokens > limit:
        raise ValueError(
            f"prompt len {prompt_len} + {max_new_tokens} new tokens exceeds "
            f"sequence limit {limit} (min of runtime {rt.max_seq_len} and "
            f"model {cfg.max_seq_len})"
        )


def generate(
    params: Any,
    cfg: ModelConfig,
    rt: RuntimeConfig,
    prompt: torch.Tensor,
    prompt_lens: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    eos_id: int = -1,
    pad_id: int = 0,
) -> torch.Tensor:
    """Convenience wrapper binding the knobs of a RuntimeConfig; the
    generator defaults to one on the prompt's device seeded with
    ``rt.seed``."""
    b, t = prompt.shape
    if prompt_lens is None:
        prompt_lens = torch.full((b,), t, dtype=torch.int32,
                                 device=prompt.device)
    if generator is None:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(rt.seed)
    check_sequence_budget(t, rt.max_decode_steps, rt, cfg)
    return generate_tokens(
        params, cfg, prompt, prompt_lens, generator,
        max_new_tokens=rt.max_decode_steps,
        temperature=rt.temperature, top_k=rt.top_k, top_p=rt.top_p,
        eos_id=eos_id, pad_id=pad_id,
    )
