"""Decode sessions with host-RAM KV spill (PyTorch port of
``distributed_llms_tpu/runtime/session.py``).

A *session* keeps its KV cache alive across turns — a continuation
prefills only the new chunk — and a bounded number of sessions stay
resident on the device: the rest are spilled to host memory and copied
back when the conversation resumes.  Every session's cache holds a fixed
``max_len`` slots.

:func:`continuation_mask` is also the continuous batcher's prefix-cached
admission mask.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Any

import torch

from ..core.config import ModelConfig
from ..core.observability import METRICS, get_logger
from ..models import model as model_lib
from . import sampling
from .generate import last_logits

log = get_logger("session")


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


def _default_forward(params, cfg, tokens, positions=None, cache=None,
                     cache_index=None, attn_mask=None, key_positions=None):
    return model_lib.forward(
        params, cfg, tokens, positions=positions, cache=cache,
        cache_index=cache_index, attn_mask=attn_mask,
        key_positions=key_positions,
    )


@torch.no_grad()
def session_step(
    params: Any,
    cfg: ModelConfig,
    chunk: torch.Tensor,        # [B, T] int32 new tokens, right-padded
    chunk_lens: torch.Tensor,   # [B] int32 true lengths
    real_lens: torch.Tensor,    # [B] int32 tokens already in the session
    valid_mask: torch.Tensor,   # [B, S] bool — cache slots of prior turns
    cache: Any,                 # KVCache of S = the session's max_len
    base: int,                  # first free padded cache slot
    generator: torch.Generator | None,  # unused at temperature 0
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: int = -1,
    pad_id: int = 0,
    forward_fn: Any = None,
    slot_positions: torch.Tensor | None = None,  # [B, S] true RoPE position
    #   of each cache slot — REQUIRED state for sliding-window models: the
    #   padded multi-turn layout makes slot != position, and the map
    #   depends on every earlier turn's base and lengths, so it is carried,
    #   not recomputed.  None for global attention.
) -> tuple:
    """Append a chunk to the session and decode.

    Generalizes ``runtime.generate.generate_tokens`` (the one-shot case is
    ``base=0``, ``valid_mask`` all False, ``real_lens`` 0); the two stay
    separate and are held equal by the tests.  All rows write the chunk
    at the same padded slots [base, base+T); per-row masks keep attention
    on real slots; per-row positions (``real_lens + i``) keep RoPE right
    across turns.  Returns (new_tokens [B, N], cache, valid_mask',
    real_lens', slot_positions' | None)."""
    if forward_fn is None:
        forward_fn = _default_forward
    b, t = chunk.shape
    dev = chunk.device
    s = cache.k.shape[-3]  # [..., B, S, KVH, HD] -> S
    slots = torch.arange(s, device=dev)
    windowed = cfg.sliding_window is not None
    if windowed and slot_positions is None:
        raise ValueError(
            "sliding-window sessions need the slot_positions state (the "
            "padded multi-turn layout makes slot != position; engine "
            "sessions allocate and carry it)"
        )
    real_lens = real_lens.to(torch.int32)
    chunk_lens = chunk_lens.to(device=dev, dtype=torch.int32)

    # -- chunk prefill at padded slots [base, base+t)
    ar_t = torch.arange(t, device=dev, dtype=torch.int32)
    positions = real_lens[:, None] + ar_t[None, :]
    mask = continuation_mask(valid_mask, base, t, slots)  # [B, 1, T, S]
    chunk_kw = {}
    rel = (slots[None, :] - base).to(torch.int32)  # [1, S]: index in chunk
    if windowed:
        slot_positions = torch.where(
            (rel >= 0) & (rel < t),
            real_lens[:, None] + torch.clamp(rel, 0, t - 1), slot_positions,
        )
        chunk_kw["key_positions"] = slot_positions
    logits, cache = forward_fn(params, cfg, chunk, positions=positions,
                               cache=cache, cache_index=base, attn_mask=mask,
                               **chunk_kw)
    cur_logits = last_logits(logits, chunk_lens)
    del logits

    # Slots valid after the chunk: prior turns + this chunk's real tokens.
    chunk_valid = (rel >= 0) & (rel < chunk_lens[:, None])  # [B, S]
    valid_after_chunk = valid_mask | chunk_valid
    real_after_chunk = real_lens + chunk_lens

    gen_base = base + t  # padded slot where generated tokens start
    gen_kw = {}
    if windowed:
        # Generated slot gen_base + j holds position real_after_chunk + j:
        # fill the whole generated region once (slots past the current
        # step are masked invalid, so their early values are never read).
        gen_rel = (slots[None, :] - gen_base).to(torch.int32)
        slot_positions = torch.where(
            gen_rel >= 0, real_after_chunk[:, None] + gen_rel, slot_positions)
        gen_kw["key_positions"] = slot_positions

    done = torch.zeros(b, dtype=torch.bool, device=dev)
    pad = torch.full((b,), pad_id, dtype=torch.int32, device=dev)
    toks = []
    for j in range(max_new_tokens):
        tok = sampling.sample(generator, cur_logits, temperature, top_k, top_p)
        tok = torch.where(done, pad, tok)
        if eos_id >= 0:
            done = done | (tok == eos_id)
        toks.append(tok)
        gen_valid = (slots[None, :] >= gen_base) & (slots[None, :] <= gen_base + j)
        mask = (valid_after_chunk | gen_valid)[:, None, None, :]
        logits, cache = forward_fn(
            params, cfg, tok[:, None],
            positions=(real_after_chunk + j)[:, None], cache=cache,
            cache_index=gen_base + j, attn_mask=mask, **gen_kw,
        )
        cur_logits = logits[:, 0]

    gen_valid_final = (slots[None, :] >= gen_base) & (
        slots[None, :] < gen_base + max_new_tokens)
    return (torch.stack(toks, dim=1), cache,
            valid_after_chunk | gen_valid_final,
            real_after_chunk + max_new_tokens,
            slot_positions if windowed else None)


# ---------------------------------------------------------------------------
# Session state + host spill
# ---------------------------------------------------------------------------

@dataclass
class Session:
    sid: str
    cache: Any  # KVCache on the device when resident; _HostCache when spilled
    valid_mask: torch.Tensor
    real_lens: torch.Tensor
    base: int  # next free padded slot
    max_len: int
    n_real: int = 0  # the caller's row count
    # [B, S] true RoPE position per cache slot — sliding-window models only
    # (session_step carries it turn to turn; None for global attention).
    slot_positions: torch.Tensor | None = None
    last_used: float = field(default_factory=time.monotonic)

    @property
    def spilled(self) -> bool:
        return isinstance(self.cache, _HostCache)


@dataclass
class _HostCache:
    """A cache's tensors copied to host memory, with the cache's type and
    each tensor's device remembered for the restore."""

    leaves: dict[str, torch.Tensor]
    kind: type
    devices: dict[str, torch.device]

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.leaves.values())


class SessionManager:
    """LRU residency manager: at most ``max_resident`` session caches live
    in device memory; the rest live in host memory until their next turn."""

    def __init__(self, max_resident: int = 4) -> None:
        if max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        self.max_resident = max_resident
        self.sessions: dict[str, Session] = {}
        self._counter = 0

    # -- bookkeeping -------------------------------------------------------

    def new_session(self, cache: Any, valid_mask, real_lens, base: int,
                    max_len: int) -> Session:
        self._counter += 1
        sid = f"session-{self._counter}"
        sess = Session(sid, cache, valid_mask, real_lens, base, max_len)
        self.sessions[sid] = sess
        self._enforce_residency(keep=sid)
        return sess

    def get(self, sid: str) -> Session:
        sess = self.sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown session {sid!r}")
        return sess

    def touch(self, sess: Session) -> None:
        sess.last_used = time.monotonic()
        self._enforce_residency(keep=sess.sid)

    def drop(self, sid: str) -> None:
        self.sessions.pop(sid, None)
        self._update_gauges()

    # -- spill / restore ---------------------------------------------------

    def make_room(self, keep: str | None = None) -> None:
        """Spill LRU residents until one more cache can come in WITHOUT
        exceeding max_resident — called before allocating or restoring a
        cache, so device memory never holds max_resident + 1 caches."""
        resident = sorted(
            (s for s in self.sessions.values() if not s.spilled),
            key=lambda s: s.last_used,
        )
        excess = len(resident) - (self.max_resident - 1)
        for sess in resident:
            if excess <= 0:
                break
            if sess.sid == keep:
                continue
            log.info("spilling %s to host to make room", sess.sid)
            self._spill(sess)
            excess -= 1

    def ensure_resident(self, sess: Session) -> None:
        """Copy a spilled cache back onto the device it was spilled from
        (making room first).  The restored tensors are byte copies of the
        spilled ones, on that device or not at all."""
        if not sess.spilled:
            return
        self.make_room(keep=sess.sid)
        hc: _HostCache = sess.cache
        leaves = {}
        for name, host in hc.leaves.items():
            dev = hc.devices[name]
            leaves[name] = host.to(dev)
            if leaves[name].device != dev:
                raise RuntimeError(
                    f"session {sess.sid}: restored {name} landed on "
                    f"{leaves[name].device}, not {dev}")
        sess.cache = hc.kind(**leaves)
        METRICS.inc("kv_spill.restores")
        self._update_gauges()

    def _spill(self, sess: Session) -> None:
        names = [f.name for f in fields(sess.cache)
                 if torch.is_tensor(getattr(sess.cache, f.name))]
        tensors = {n: getattr(sess.cache, n) for n in names}
        host = {n: a.to("cpu", copy=True) for n, a in tensors.items()}
        sess.cache = _HostCache(host, type(sess.cache),
                                {n: a.device for n, a in tensors.items()})
        METRICS.inc("kv_spill.spills")
        self._update_gauges()

    def _enforce_residency(self, keep: str) -> None:
        resident = [s for s in self.sessions.values() if not s.spilled]
        resident.sort(key=lambda s: s.last_used)
        excess = len(resident) - self.max_resident
        for sess in resident:
            if excess <= 0:
                break
            if sess.sid == keep:
                continue
            log.info("spilling %s to host (%d resident > %d)",
                     sess.sid, len(resident), self.max_resident)
            self._spill(sess)
            excess -= 1
        self._update_gauges()

    def _update_gauges(self) -> None:
        METRICS.set_gauge("kv_spill.host_bytes", sum(
            s.cache.nbytes for s in self.sessions.values() if s.spilled))
        METRICS.set_gauge(
            "kv_spill.resident_sessions",
            sum(1 for s in self.sessions.values() if not s.spilled))
        METRICS.set_gauge(
            "kv_spill.spilled_sessions",
            sum(1 for s in self.sessions.values() if s.spilled))
