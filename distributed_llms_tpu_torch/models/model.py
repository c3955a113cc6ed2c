"""Decoder-only transformer forward pass (PyTorch port of
``distributed_llms_tpu/models/model.py``): the llama family (GQA, RoPE,
SwiGLU or Mixtral-style MoE, RMSNorm), gpt2 and opt (LayerNorm, learned
positions, a biased GELU/ReLU MLP) and neox (LayerNorm, partial rotary,
parallel or sequential residual) — :data:`BLOCK_FNS`.

Parameters are the JAX package's pytree as plain dictionaries of tensors,
stacked over the layer axis (``params["blocks"][...]`` leaves lead with
L); :func:`run_blocks` walks the layers in a Python loop where the JAX
package runs ``lax.scan``, summing the MoE blocks' load-balance terms.
Three cache layouts, as in the reference:

- a contiguous row cache ``[L, B, S, KVH, HD]``: a scalar ``cache_index``
  (admission prefill, causal or caller-supplied mask), or per-row
  ``cache_index`` (contiguous decode, one token per row: without a
  caller mask, or under ``cfg.ragged_decode``, read by the ragged
  decode-attention kernel with the model's sliding window, else dense
  under the caller's mask; or a T-token window a row, the speculative
  verify pass, dense under the caller's mask).  A caller's mask carries
  causality and validity by slot; the window is ANDed in by position,
  from ``key_positions`` where the layout is gapped (the right-padded
  generate and session layouts: slot != position);
- a paged pool ``[L, NB, BLK, KVH, HD]`` addressed through ``kv_tables``
  (paged decode: per-row ``cache_index``, one token per row, or a T-token
  window a row), read by the paged decode-attention kernel
  (``ops/decode_attn.py``): a window's T query offsets are B*T virtual
  rows of ONE launch a layer, offset j reading its row's prefix through
  slot ``cache_index + j``;
- the same pool in int8 with float32 absmax scales
  (:class:`QuantKVCache`), quantized at the write and read by the
  kernel's int8 leg;
- on a sequence-parallel mesh, the two-region cache (k and v each a
  ``(prefill, decode)`` pair, :func:`_seq_cached_attention`): this rank's
  block of the prompt's K/V, and the generated tokens' K/V that every rank
  of the 'seq' line holds whole.

With ``attn_impl="flash"`` two more attention paths take the flash kernels
(``ops/flash.py``), under the reference's exact conditions: the no-cache
forward (training; the static-causal kernel K3 when :func:`forward` made
the positions itself) and the multi-token cached prefill without a
caller mask (the dynamic kernel K4 over the whole row cache, masking the
unwritten tail).  Everything else stays on the dense path.

With ``attn_impl="ring"`` or ``"ulysses"`` the forward runs one rank's
block of the sequence inside a sequence-parallel forward of
``parallel/api.py`` (``ops/ring.py``, ``ops/ulysses.py``); outside one
they raise the reference's ``RuntimeError``.

Both caches are UPDATED IN PLACE: the JAX code writes into donated
buffers (``dynamic_update_slice`` / ``.at[].set``), the port writes the
same slots with ``index_put_`` / slice assignment instead of copying.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.utils.checkpoint

from ..core.config import ModelConfig
from ..parallel import plan as plan_lib
from . import layers
from .layers import Params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: "str | torch.dtype") -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def check_supported(cfg: ModelConfig) -> None:
    """Every block family of the reference is ported, dense and MoE,
    with attention dense (``attn_impl="dot"``), through the flash kernels
    (``"flash"``) or sequence-parallel (``"ring"``, ``"ulysses"``: on a
    'seq' mesh only, see the module docstring; ``ModelConfig`` refuses
    any other)."""
    if cfg.family not in BLOCK_FNS:
        raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Per-layer KV cache: a contiguous ``[L, B, S, KVH, HD]`` pair, or a
    page pool ``[L, NB, BLK, KVH, HD]`` pair in paged mode.  On a
    sequence-parallel mesh ``k`` and ``v`` are two-region tuples
    ``(prefill, decode)`` instead (:func:`_seq_cached_attention`), and
    :attr:`max_len` counts this rank's slots."""

    k: Any
    v: Any

    @property
    def max_len(self) -> int:
        if isinstance(self.k, tuple):  # the two-region seq cache
            return self.k[0].shape[2] + self.k[1].shape[2]
        return self.k.shape[2]


@dataclass
class QuantKVCache:
    """Int8 KV page pool (``--kv-bits 8``): ``k``/``v`` hold the pool pages
    at int8 ``[L, NB, BLK, KVH, HD]`` and ``k_scale``/``v_scale`` one
    float32 absmax scale per head-dim vector ``[L, NB, BLK, KVH]``
    (``checkpoint.quantize.kv_quantize``'s layout).  Pages are quantized
    ONCE at the write (admission splice, decode-step write) and read by the
    decode kernel's int8 leg, which folds the scales into the contraction.
    ``row_dtype`` names the full-width dtype transient row caches and
    prefix gathers restore to.  Decode-only through :func:`forward`
    (``kv_tables`` required)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    row_dtype: str = "bfloat16"


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: Any = None,
               device: "torch.device | str | None" = None) -> KVCache:
    dtype = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attention(
    x: torch.Tensor,
    p: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,
    layer_cache: tuple[torch.Tensor, ...] | None,  # (k, v) views of the
    #   layer's cache, or (k, v, k_scale, v_scale) of an int8 pool
    cache_index: torch.Tensor | int | None,
    use_rope: bool = True,  # False for the learned-position families
    attn_mask: torch.Tensor | None = None,  # broadcastable to [B, H, Tq, S]
    kv_tables: torch.Tensor | None = None,  # [B, P] int32 page table: the
    #   layer cache is a PAGE POOL [NB, BLK, KVH, HD] and row b's slot s
    #   lives at (tables[b, s // BLK], s % BLK).  Per-row cache_index; the
    #   mask is implicitly the prefix [0, cache_index[b] + j] for query j.
    std_layout: bool = False,  # positions are the standard arange (forward
    #   made them itself): the no-cache flash path takes the static-causal
    #   kernel
    paged_window: tuple | None = None,  # a T-token paged window's
    #   coordinates (:func:`paged_window_rows`), built once per forward
    key_positions: torch.Tensor | None = None,  # [B, S] true RoPE position
    #   of each cache slot, read ONLY by the sliding-window mask: gapped
    #   layouts (the right-padded generate / speculative layout, where
    #   generated token j sits at slot T + j but position len + j, and
    #   multi-turn sessions) pass it, or the window widens by the pad;
    #   contiguous layouts (slot == position) leave it None
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...] | None]:
    q, k, v = layers.qkv_project(x, p, cfg)
    if use_rope:
        q, k = _rotate(q, k, positions, cfg)
    window = cfg.sliding_window
    per_row = torch.is_tensor(cache_index) and cache_index.dim() == 1
    # On a mesh whose forward splits rows over 'data', x holds this rank's
    # rows: every row's new K/V is gathered before the cache write (each
    # rank's cache holds every row, so a page written by one rank's row is
    # there for another's prefix hit), and the reads take this rank's rows
    # of the caller's full-batch indices (``loc``).
    loc = _Rows.current(k.shape[0])
    if loc.split and layer_cache is not None:
        k, v = loc.gather(k), loc.gather(v)
    q_rows = x.shape[0]

    if kv_tables is not None:
        if layer_cache is None or not per_row:
            raise ValueError(
                "paged attention is per-row decode (a per-row cache_index "
                "over a page-pool cache)"
            )
        if window is not None:
            raise ValueError(
                "paged decode attends each row's full cache prefix; it "
                "cannot honor sliding_window"
            )
        if x.shape[1] > 1:
            # The speculative verify pass: row b's T tokens write through
            # the page table at slots cache_index[b]..+T-1, and query j
            # reads the row's prefix through slot cache_index[b] + j.
            return _paged_window_attention(q, k, v, p, layer_cache,
                                           paged_window, loc)
        from ..ops import decode_attn

        ck, cv = layer_cache[:2]  # [NB, BLK, KVH, HD] views into the pool
        blk = ck.shape[1]
        rows = torch.arange(k.shape[0], device=x.device)
        page = kv_tables[rows, (cache_index // blk).long()].long()
        off = (cache_index % blk).long()
        lengths = loc(cache_index + 1).to(torch.int32)
        tables = loc(kv_tables)
        # Per-row single-slot write, in place.  Live rows own distinct
        # pages; freed rows' tables point at the shared scratch page 0, so
        # two inactive rows CAN write the same (page, off) — any winner is
        # fine, no live row ever reads the scratch page.
        if len(layer_cache) == 4:
            # Int8 pool: quantize this step's K/V vector per (row, head),
            # write data and scale in place, and hand the kernel the
            # scales — it folds them into the contraction.
            from ..checkpoint.quantize import kv_quantize

            sk, sv = layer_cache[2:]
            ck[page, off], sk[page, off] = kv_quantize(k[:, 0])
            cv[page, off], sv[page, off] = kv_quantize(v[:, 0])
            out = decode_attn.paged_decode_attention(
                q, ck, cv, lengths, tables, k_scale=sk, v_scale=sv
            )
            return layers.out_project(out, p), layer_cache
        ck[page, off] = k[:, 0].to(ck.dtype)
        cv[page, off] = v[:, 0].to(cv.dtype)
        # (A paged pool's KV heads always shard with the Q heads: the
        # batcher refuses a mesh they do not divide over.)
        out = decode_attn.paged_decode_attention(q, ck, cv, lengths, tables)
        return layers.out_project(out, p), (ck, cv)

    if cfg.attn_impl in ("ring", "ulysses"):
        # Sequence parallelism: this rank holds one block of the sequence,
        # with global positions, inside ParallelModel's seq forwards.
        if layer_cache is not None:
            return _seq_cached_attention(q, k, v, p, cfg, positions,
                                         layer_cache, cache_index, attn_mask,
                                         loc)
        if attn_mask is not None:
            raise NotImplementedError(
                f"{cfg.attn_impl} attention supports causal masking only"
            )
        return layers.out_project(_seq_attention(q, k, v, positions, cfg),
                                  p), None

    if layer_cache is not None:
        ck, cv = layer_cache  # [B, S, KVH, HD] views into the row cache
        s = ck.shape[1]
        if per_row:
            # Per-row write slots: rows sit at different depths.  Each row
            # writes its slots in place — the start clamped as the JAX
            # package's dynamic_update_slice clamps it (the batcher never
            # passes S: a finished row idles at S - 1 at most).
            if x.shape[1] > 1:
                return _row_window_attention(q, k, v, p, cfg, positions,
                                             (ck, cv), cache_index,
                                             attn_mask, key_positions, loc)
            rows = torch.arange(k.shape[0], device=x.device)
            slot = cache_index.long().clamp(0, s - 1)
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
            if attn_mask is None or cfg.ragged_decode:
                # The prefix contract: row b attends [0, cache_index + 1),
                # or the window band of it, through the ragged kernel.  No
                # mask (the port batcher's call) or cfg.ragged_decode (the
                # caller's promise that its mask IS that prefix) — slot ==
                # position in both.
                from ..ops import decode_attn

                out = decode_attn.ragged_decode_attention(
                    q, _kv_select(loc(ck)), _kv_select(loc(cv)),
                    loc(cache_index + 1).to(torch.int32), window=window,
                )
                return layers.out_project(out, p), (ck, cv)
            # A caller's mask over a gapped layout (the speculative draft
            # steps and backfill): dense under that mask, the window
            # ANDed in by true key position.
            out = _dense_cached(q, p, cfg, positions, loc(ck), loc(cv),
                                loc(attn_mask), loc(key_positions))
            return out[0], (ck, cv)
        ci = int(cache_index)
        t = x.shape[1]
        if ci < 0 or ci + t > s:
            # The JAX package's dynamic_update_slice would CLAMP the start
            # and silently misalign the chunk; refuse instead.
            raise ValueError(
                f"cache write [{ci}, {ci + t}) outside a {s}-slot cache"
            )
        ck[:, ci:ci + t] = k.to(ck.dtype)
        cv[:, ci:ci + t] = v.to(cv.dtype)
        # Causality and validity compare slots, the window positions; the
        # caller-supplied masks (prefix continuation, the gapped generate
        # and session layouts) carry the first two, and every path ANDs
        # in the window — by ``key_positions`` where the caller gives them.
        k_positions = torch.arange(s, device=x.device).expand(q_rows, s)
        if (cfg.attn_impl == "flash" and attn_mask is None and t > 1
                and (window is None or key_positions is None)):
            # Prefill into the (longer, padded) row cache: the flash kernel
            # masks the unwritten tail instead of computing a dense
            # [T, S] score matrix; its one k_positions vector drives
            # causality and the window, exact because slot == position
            # here (a windowed caller with a key_positions map takes the
            # dense window path below).  Single-token prefill stays dense,
            # as in the reference.
            from ..ops import flash

            out = flash.flash_attention(
                q, _kv_select(loc(ck)).to(q.dtype),
                _kv_select(loc(cv)).to(q.dtype), q_positions=positions,
                k_positions=k_positions, k_valid=k_positions < ci + t,
                causal=True, window=window,
            )
            return layers.out_project(out, p), (ck, cv)
        attn_mask = loc(attn_mask)
        if attn_mask is None:
            attn_mask = layers.causal_mask(positions, k_positions,
                                           k_positions < ci + t)
        out = _dense_cached(q, p, cfg, positions, loc(ck), loc(cv),
                            attn_mask, loc(key_positions))
        return out[0], (ck, cv)

    if cfg.attn_impl == "flash" and attn_mask is None:
        # Self-attention over the input block (training, no-cache eval):
        # the static-causal kernel when the positions are the standard
        # arange, else the dynamic one at these positions; a sliding window
        # rides the kernels' window band.
        from ..ops import flash

        out = flash.flash_attention(
            q, _kv_select(k), _kv_select(v),
            q_positions=None if std_layout else positions,
            k_positions=None if std_layout else positions, causal=True,
            window=window,
        )
        return layers.out_project(out, p), None

    attn_mask = loc(attn_mask)
    if attn_mask is None:
        mask = layers.causal_mask(positions, positions, window=window)
    elif window is not None:
        mask = layers.and_window(attn_mask, positions, positions, window)
    else:
        mask = attn_mask
    out = layers.dot_product_attention(
        q, _expand_kv(k, cfg), _expand_kv(v, cfg), mask,
    )
    return layers.out_project(out, p), None


class _Rows:
    """The rows of a forward this rank computes: all of them, or its
    'data' block ``[lo, hi)`` of a batch of ``b`` rows (``parallel/
    plan.py``).  Calling it takes a full-batch tensor's block (tensors of
    another leading size, and None, pass through)."""

    def __init__(self, plan, b: int) -> None:
        self.plan = plan
        self.split = plan is not None and plan.rows is not None
        self.lo, self.hi = plan.rows if self.split else (0, b)
        self.b = (b * plan.mesh.size("data")) if self.split else b

    @classmethod
    def current(cls, b: int) -> "_Rows":
        return cls(plan_lib.current(), b)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.plan.mesh.all_gather(t, 0, "data")

    def __call__(self, t):
        if not self.split or t is None or t.shape[0] != self.b:
            return t
        return t[self.lo:self.hi]

    def flat(self, t: torch.Tensor, per: int) -> torch.Tensor:
        """This rank's block of a ``[b * per, ...]`` tensor."""
        if not self.split:
            return t
        return t[self.lo * per:self.hi * per]


def _kv_select(t: torch.Tensor) -> torch.Tensor:
    """K/V ``[..., KVH, HD]`` for this rank's Q heads: as they are, or,
    when the KV heads are replicated over 'model' while the Q heads shard,
    the KV head of each local Q head (group 1; ``Plan.kv_map``)."""
    plan = plan_lib.current()
    if plan is None or plan.kv_map is None:
        return t
    return t.index_select(-2, plan.kv_index(t.device))


def _expand_kv(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``[B, S, KVH, HD]`` -> one KV head per Q head (dense attention)."""
    plan = plan_lib.current()
    if plan is not None and plan.kv_map is not None:
        return _kv_select(t)
    return layers.repeat_kv(t, cfg.q_per_kv)


def _rotate(q, k, positions, cfg):
    """RoPE on q and k; with ``rotary_pct < 1`` (GPT-NeoX/Pythia) only
    the first ``int(head_dim * rotary_pct)`` dims of each head rotate and
    the rest pass through."""
    rope_scale = (
        (cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
         cfg.rope_high_freq_factor, cfg.rope_original_max_len)
        if cfg.rope_scaling_factor != 1.0 else None  # Llama-3.1 rescale
    )
    if cfg.rotary_pct < 1.0:
        rot = int(cfg.head_dim_ * cfg.rotary_pct)

        def part(t):
            return torch.cat([layers.apply_rope(t[..., :rot], positions,
                                                cfg.rope_theta, rope_scale),
                              t[..., rot:]], dim=-1)

        return part(q), part(k)
    return (layers.apply_rope(q, positions, cfg.rope_theta, rope_scale),
            layers.apply_rope(k, positions, cfg.rope_theta, rope_scale))


def paged_window_rows(kv_tables: torch.Tensor, cache_index: torch.Tensor,
                      t: int, blk: int) -> tuple:
    """Coordinates of a T-token paged window (the speculative verify pass),
    shared by every layer of one forward: the write's (page, offset) of
    each row's slots ``cache_index..cache_index+T-1`` ([B, T] each), and
    the read's B*T virtual rows — lengths ``cache_index + 1 + j`` and the
    row's table repeated T times.  Table columns past the table clamp to
    its last (the JAX package's gather clamps the same way); the batcher
    grows a row's pages over its whole window before the round."""
    idx = cache_index.long()[:, None] + torch.arange(
        t, device=kv_tables.device)[None, :]                   # [B, T]
    col = torch.clamp(idx // blk, max=kv_tables.shape[1] - 1)
    page = torch.gather(kv_tables.long(), 1, col)
    lengths = (idx + 1).reshape(-1).to(torch.int32)
    # kv_tables.repeat_interleave(t, dim=0), spelled as an expand so that
    # no backend computes the output size on the host (a captured graph
    # may not sync).
    b, p = kv_tables.shape
    tables = kv_tables[:, None, :].expand(b, t, p).reshape(b * t, p)
    return page, idx % blk, lengths, tables


def _paged_window_attention(q, k, v, p, layer_cache, window, loc):
    """T-token paged attention (T >= 2): the window's K/V scatter through
    the page table first, then ONE paged decode-attention launch over B*T
    virtual rows reads, for query offset j of row b, the row's prefix
    through slot cache_index + j — the reference's T per-offset launches
    (``_paged_window_attention``) in one call of the same kernel.  Freed
    rows' tables point at the scratch page 0, so duplicate scatter targets
    are possible and tolerated as in the single-token leg.  An int8 pool
    quantizes the whole window once at the write and hands the kernel the
    scales."""
    from ..ops import decode_attn

    page, off, lengths, tables = window
    b, t, h, d = q.shape
    qr = q.reshape(b * t, 1, h, d)
    lengths, tables = loc.flat(lengths, t), loc.flat(tables, t)
    if len(layer_cache) == 4:
        from ..checkpoint.quantize import kv_quantize

        ck, cv, sk, sv = layer_cache
        ck[page, off], sk[page, off] = kv_quantize(k)
        cv[page, off], sv[page, off] = kv_quantize(v)
        out = decode_attn.paged_decode_attention(qr, ck, cv, lengths, tables,
                                                 k_scale=sk, v_scale=sv)
    else:
        ck, cv = layer_cache
        ck[page, off] = k.to(ck.dtype)
        cv[page, off] = v.to(cv.dtype)
        out = decode_attn.paged_decode_attention(qr, ck, cv, lengths, tables)
    return layers.out_project(out.reshape(b, t, h, d), p), layer_cache


def _dense_cached(q, p, cfg, positions, ck, cv, attn_mask, key_positions):
    """Dense attention over a whole row cache ``[B, S, KVH, HD]`` under
    ``attn_mask`` (causality and validity, by slot), the sliding window
    ANDed in by each slot's true position (``key_positions``, or the slot
    itself).  The JAX package computes it outside any Pallas kernel."""
    if cfg.sliding_window is not None:
        if key_positions is None:
            b, s = ck.shape[:2]
            key_positions = torch.arange(s, device=q.device).expand(b, s)
        attn_mask = layers.and_window(attn_mask, positions, key_positions,
                                      cfg.sliding_window)
    k_full = _expand_kv(ck.to(q.dtype), cfg)
    v_full = _expand_kv(cv.to(q.dtype), cfg)
    out = layers.dot_product_attention(q, k_full, v_full, attn_mask)
    return layers.out_project(out, p), (ck, cv)


def _row_window_attention(q, k, v, p, cfg, positions, layer_cache,
                          cache_index, attn_mask, key_positions=None,
                          loc=None):
    """T-token per-row window over a contiguous cache (the contiguous
    speculative verify pass, the reference's masked per-row branch): each
    row writes its T slots in place from ``cache_index`` — the start
    clamped to S - T, as the JAX package's dynamic_update_slice clamps it
    (the batcher's k+1 headroom slots keep it from clamping) — then dense
    attention under the caller's [B, 1, T, S] mask, the sliding window
    ANDed in.  The JAX package computes it outside any Pallas kernel."""
    if attn_mask is None:
        raise ValueError("per-row cache_index requires an explicit attn_mask")
    ck, cv = layer_cache
    b, t = k.shape[:2]
    s = ck.shape[1]
    start = cache_index.long().clamp(0, s - t)
    idx = start[:, None] + torch.arange(t, device=q.device)[None, :]
    rows = torch.arange(b, device=q.device)[:, None]
    ck[rows, idx] = k.to(ck.dtype)
    cv[rows, idx] = v.to(cv.dtype)
    loc = loc or _Rows(None, b)
    out = _dense_cached(q, p, cfg, positions, loc(ck), loc(cv),
                        loc(attn_mask), loc(key_positions))
    return out[0], layer_cache


def _seq_attention(q, k, v, positions, cfg):
    """Causal attention of this rank's sequence block over its 'seq' line:
    the ring, or Ulysses' head scatter (K4 on CUDA)."""
    k, v = _kv_select(k), _kv_select(v)
    if cfg.attn_impl == "ring":
        from ..ops import ring

        return ring.ring_attention(q, k, v, positions, positions,
                                   axis_name="seq")
    from ..ops import ulysses

    return ulysses.ulysses_attention(q, k, v, positions, axis_name="seq")


def _seq_cached_attention(q, k, v, p, cfg, positions, layer_cache,
                          cache_index, attn_mask, loc):
    """Cached attention under sequence parallelism, on the two-region
    cache ``((ck_pref, ck_dec), (cv_pref, cv_dec))``: the prefill region
    holds this rank's block of the prompt's K/V (written once, never
    moved), the decode region the generated tokens' K/V, whole on every
    rank of the 'seq' line (bounded by the new tokens, a sliver next to a
    long prompt).  Every row of both is on every rank (``loc`` picks this
    rank's rows on a 'data' split, as in :func:`_attention`).

    Prefill (Tq > 1): this rank's block fills its prefill region whole and
    attention is the ring or Ulysses pass.  Decode (Tq == 1): the token's
    K/V lands in the decode region at ``cache_index - T_prefill`` on every
    rank, and the statistics of each rank's prompt block merge over the
    line (``ops/ring.py`` ``seq_cached_decode_attention``), the K/V
    staying put.  Both regions are written in place."""
    from ..ops import ring

    mesh = ring.seq_mesh("seq", f"{cfg.attn_impl} attention")
    (ck_pref, ck_dec), (cv_pref, cv_dec) = layer_cache
    tq = q.shape[1]
    if tq > 1:
        if attn_mask is not None:
            raise NotImplementedError(
                "sequence-parallel prefill supports causal masking only"
            )
        if tq != ck_pref.shape[1]:
            raise ValueError(
                f"seq-parallel prefill expects the full prompt at once: got "
                f"{tq} local tokens for a {ck_pref.shape[1]}-slot local "
                "prefill region (chunked prefill is unsupported here)"
            )
        ck_pref.copy_(k)
        cv_pref.copy_(v)
        out = _seq_attention(q, loc(k), loc(v), positions, cfg)
        return layers.out_project(out, p), layer_cache

    if not isinstance(attn_mask, tuple):
        raise ValueError(
            "seq-parallel cached decode needs attn_mask=(prefill_mask, "
            "decode_mask) — ParallelModel.forward splits the global mask"
        )
    di = int(cache_index) - ck_pref.shape[1] * mesh.size("seq")
    if not 0 <= di < ck_dec.shape[1]:
        raise ValueError(
            f"decode slot {int(cache_index)} outside the "
            f"{ck_dec.shape[1]}-slot decode region"
        )
    ck_dec[:, di] = k[:, 0].to(ck_dec.dtype)
    cv_dec[:, di] = v[:, 0].to(cv_dec.dtype)
    m_pref, m_dec = attn_mask
    out = ring.seq_cached_decode_attention(
        q, _kv_select(loc(ck_pref)).to(q.dtype),
        _kv_select(loc(cv_pref)).to(q.dtype),
        _kv_select(loc(ck_dec)).to(q.dtype),
        _kv_select(loc(cv_dec)).to(q.dtype), loc(m_pref), loc(m_dec),
        axis_name="seq",
    )
    return layers.out_project(out, p), layer_cache


def _ln(x, p, cfg):
    return layers.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


def gpt2_block(x, p, cfg, positions, layer_cache, cache_index,
               attn_mask=None, kv_tables=None, std_layout=False,
               paged_window=None, key_positions=None):
    """-> (x, new_cache, aux): aux is the MoE load-balance term (None
    here).  Shared by the gpt2 and opt families (pre-LN, learned
    positions); ``cfg.activation`` picks the MLP's nonlinearity."""
    attn_out, new_cache = _attention(
        _ln(x, p["ln1"], cfg), p["attn"], cfg, positions, layer_cache,
        cache_index, use_rope=False, attn_mask=attn_mask,
        kv_tables=kv_tables, std_layout=std_layout,
        paged_window=paged_window, key_positions=key_positions,
    )
    x = x + attn_out
    return (x + layers.mlp_gelu(_ln(x, p["ln2"], cfg), p["mlp"],
                                cfg.activation), new_cache, None)


def llama_block(x, p, cfg, positions, layer_cache, cache_index,
                attn_mask=None, kv_tables=None, std_layout=False,
                paged_window=None, key_positions=None):
    """-> (x, new_cache, aux): aux is the MoE load-balance term (None for
    a dense MLP)."""
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    attn_out, new_cache = _attention(
        h, p["attn"], cfg, positions, layer_cache, cache_index,
        attn_mask=attn_mask, kv_tables=kv_tables, std_layout=std_layout,
        paged_window=paged_window, key_positions=key_positions,
    )
    x = x + attn_out
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    if "router" in p["mlp"]:  # MoE block (cfg.num_experts > 0)
        mlp_out, aux = layers.moe_swiglu(h, p["mlp"], cfg)
        return x + mlp_out, new_cache, aux
    return x + layers.mlp_swiglu(h, p["mlp"], cfg.gate_act), new_cache, None


def neox_block(x, p, cfg, positions, layer_cache, cache_index,
               attn_mask=None, kv_tables=None, std_layout=False,
               paged_window=None, key_positions=None):
    """GPT-NeoX/Pythia: LayerNorm, (partial) rotary, and with
    ``cfg.parallel_residual`` x + attn(ln1 x) + mlp(ln2 x), both norms
    reading the same input; sequential pre-LN otherwise.  -> (x,
    new_cache, None)."""
    attn_out, new_cache = _attention(
        _ln(x, p["ln1"], cfg), p["attn"], cfg, positions, layer_cache,
        cache_index, attn_mask=attn_mask, kv_tables=kv_tables,
        std_layout=std_layout, paged_window=paged_window,
        key_positions=key_positions,
    )
    mlp_in = x if cfg.parallel_residual else x + attn_out
    mlp_out = layers.mlp_gelu(_ln(mlp_in, p["ln2"], cfg), p["mlp"],
                              cfg.activation)
    return x + attn_out + mlp_out, new_cache, None


BLOCK_FNS = {"gpt2": gpt2_block, "opt": gpt2_block, "llama": llama_block,
             "neox": neox_block}


def layer_params(blocks: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the stacked ``[L, ...]`` leaves
    (a ``QuantizedTensor`` leaf slices its codes and scales alike)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in blocks.items()}


def run_blocks(
    x: torch.Tensor,
    blocks: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,
    cache_k: torch.Tensor | None,  # [L, ...] cache or pool for these blocks
    cache_v: torch.Tensor | None,
    cache_index,
    attn_mask: torch.Tensor | None = None,
    kv_tables: torch.Tensor | None = None,
    cache_sk: torch.Tensor | None = None,  # [L, NB, BLK, KVH] scales of an
    cache_sv: torch.Tensor | None = None,  #   int8 pool
    remat: bool = False,  # recompute each block in the backward pass
    std_layout: bool = False,  # see _attention
    key_positions: torch.Tensor | None = None,  # [B, S]; see _attention
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked blocks over x, layer by layer (the JAX package's
    ``lax.scan``).  Returns (x, aux): aux sums the MoE blocks'
    load-balance terms (a float32 zero without experts).  Cache writes land in place in ``cache_k``/``cache_v``
    (and the scales of an int8 pool).  Under weight-only quantized serving
    the blocks' matmul weights are ``QuantizedTensor`` leaves: they stay
    int8/int4 in device memory and reach the dequant-matmul kernel through
    ``layers._contract``.  ``remat`` checkpoints each block
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    scan body): its activations are recomputed in the backward pass
    instead of kept."""
    block_fn = BLOCK_FNS[cfg.family]
    n_layers = blocks["ln1"]["scale"].shape[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    window = None
    if kv_tables is not None and x.shape[1] > 1 and cache_k is not None:
        window = paged_window_rows(kv_tables, cache_index, x.shape[1],
                                   cache_k.shape[2])
    for i in range(n_layers):
        if cache_k is None:
            layer_cache = None
        elif isinstance(cache_k, tuple):  # the two-region seq cache
            layer_cache = (tuple(t[i] for t in cache_k),
                           tuple(t[i] for t in cache_v))
        elif cache_sk is None:
            layer_cache = (cache_k[i], cache_v[i])
        else:
            layer_cache = (cache_k[i], cache_v[i], cache_sk[i], cache_sv[i])
        args = (x, layer_params(blocks, i), cfg, positions, layer_cache,
                cache_index, attn_mask, kv_tables, std_layout, window,
                key_positions)
        if remat:
            x, _, layer_aux = torch.utils.checkpoint.checkpoint(
                block_fn, *args, use_reentrant=False)
        else:
            x, _, layer_aux = block_fn(*args)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

def layernorm_family(cfg: ModelConfig) -> bool:
    """Whether ``cfg``'s norms are LayerNorms with biases and its blocks
    carry projection biases (gpt2, opt, neox), not llama's RMSNorms."""
    return cfg.family in ("gpt2", "opt", "neox")


def learned_pos_offset(cfg: ModelConfig) -> int | None:
    """The offset of ``cfg``'s learned position table (OPT's 2, as HF
    stores it; GPT-2's 0), or None for a family that rotates positions."""
    return {"gpt2": 0, "opt": 2}.get(cfg.family)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a learned position table: an index in [-n, n) reads its
    row (a negative one from the end), as the reference's ``jnp.take``
    reads it; an index past either end reads the nearest end row, where
    ``jnp.take`` fills a row of NaN.  Only the speculative verify window's
    headroom slots of a row at the table's end reach past it, and no
    committed token is read from them; a NaN row there would be written
    into the scratch page and leak into live rows through the masked
    products of the plain attention paths (ROADMAP, Queue 3).  Nothing
    here syncs with the host or asserts on the device, so a captured
    decode step may feed it any position."""
    n = table.shape[0]
    return table[idx.long().clamp(-n, n - 1).remainder(n)]


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
          positions: torch.Tensor | None = None) -> torch.Tensor:
    """Token embeddings, plus the learned position table of the gpt2 and
    opt families (``positions`` [B, T]; OPT's table carries HF's offset
    of 2), read by :func:`take_rows`."""
    plan = plan_lib.current()
    wte = params["embed"]["wte"]
    if plan is not None and plan.vocab:
        # Vocabulary-parallel table: this rank holds rows [lo, lo + n); a
        # token outside them reads zeros, and the sum over 'model' is the
        # one row that holds it (exact: every other term is zero).
        n = wte.shape[0]
        t = tokens.long() - plan.mesh.coord("model") * n
        inside = (t >= 0) & (t < n)
        x = wte[t.clamp(0, n - 1)] * inside[..., None].to(wte.dtype)
        x = plan.mesh.sum_reduce(x, "model")
    else:
        x = wte[tokens.long()]
    off = learned_pos_offset(cfg)
    if off is not None:
        x = x + take_rows(params["embed"]["wpe"], positions + off)
    x = x.to(torch_dtype(cfg.dtype))
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
    return x


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[N, D] @ [D, V] with a float32 result computed from ``x.dtype``
    operands (XLA's preferred_element_type=f32)."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w
    needs_grad = torch.is_grad_enabled() and (x.requires_grad
                                              or w.requires_grad)
    if x.is_cuda and not needs_grad:
        # Half-width operands, float32 accumulation AND output: a float32
        # copy of the (vocab-sized) weight per step would cost more than
        # the product itself.  (``out_dtype`` has no derivative, so a
        # training step takes the float32 product below: the same values,
        # bf16 products being exact in float32.)
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    plan = plan_lib.current()
    if plan is not None and plan.seq == "block":
        # This rank ran its block of the sequence: gather the final hidden
        # states over 'seq' ([B, T, D], not the [B, T, V] logits), so
        # every rank unembeds, and returns, the whole sequence.
        x = plan.mesh.all_gather(x, 1, "seq")
    if layernorm_family(cfg):
        x = _ln(x, params["final_norm"], cfg)
    else:
        x = layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    w = params["embed"]["wte"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    vocab = plan is not None and plan.vocab
    if vocab:
        # Each rank's gradient of x comes from its own columns only.
        x = plan.mesh.copy_in(x, "model")
    b, t, d = x.shape
    logits = _matmul_f32(x.reshape(b * t, d), w).reshape(b, t, -1)
    if vocab:
        # Vocabulary-parallel unembedding: every rank gets every column, so
        # each samples from (and, training, differentiates) the same logits.
        logits = plan.mesh.gather(logits, -1, "model")
    return logits


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor | None = None,  # [B, T] int
    cache: "KVCache | QuantKVCache | None" = None,
    cache_index=None,  # int/scalar write offset, or [B] per-row offsets
    #   (contiguous or paged decode: one token a row, or a T-token window
    #   a row — the speculative verify pass)
    attn_mask: torch.Tensor | None = None,  # broadcastable to [B, H, Tq, S]
    kv_tables: torch.Tensor | None = None,  # [B, P] page table: the cache
    #   holds page POOLS [L, NB, BLK, KVH, HD] (paged decode)
    remat: bool = False,  # recompute each block in the backward pass
    key_positions: torch.Tensor | None = None,  # [B, S] true RoPE position
    #   of each cache slot, for the sliding-window mask of gapped layouts
    #   (see _attention)
    return_aux: bool = False,  # also return the summed MoE aux term
) -> tuple:
    """Full forward.  Returns (logits [B, T, V] float32, the cache — the
    same object, updated in place), plus the summed MoE load-balance term
    when ``return_aux`` (scale by ``cfg.moe_aux_loss_weight`` and add it
    to the task loss when training an MoE model).  A
    :class:`QuantKVCache` serves paged decode only (``kv_tables``
    required)."""
    check_supported(cfg)
    b, t = tokens.shape
    # Standard layout: forward made the positions itself with no cache
    # offset, so query rows align with key slots (the flash static path).
    std_layout = positions is None and (cache_index is None or cache is None)
    given = positions
    if positions is None:
        base = 0 if cache_index is None else int(cache_index)
        positions = (torch.arange(t, device=tokens.device) + base).expand(b, t)
    plan = plan_lib.current()
    if plan is not None and plan.rows is None:
        split = plan.row_split(b, moe=cfg.num_experts > 0)
        if split is not None:
            # Rows split over 'data': this rank embeds and runs its block
            # of rows; the blocks gather K/V for the cache writes and the
            # logits gather at the end.
            # (An MoE model never splits, so the aux term is zero here.)
            lo, hi = split
            with plan.with_rows(split).active():
                out = forward(params, cfg, tokens[lo:hi],
                              None if given is None else given[lo:hi],
                              cache, cache_index, attn_mask, kv_tables,
                              remat, key_positions, return_aux=True)
            logits = plan.mesh.gather(out[0], 0, "data")
            return (logits, *out[1:]) if return_aux else (logits, out[1])
    x = embed(params, cfg, tokens, positions)
    if cache is None:
        x, aux = run_blocks(x, params["blocks"], cfg, positions, None, None,
                            None, attn_mask, remat=remat,
                            std_layout=std_layout)
    elif isinstance(cache, QuantKVCache):
        # Int8 page pool: the quantized write and the scale-fused read both
        # live on the kv_tables path.
        if kv_tables is None:
            raise ValueError(
                "QuantKVCache serves paged decode only (pass kv_tables); "
                "prefill runs against full-width transient rows"
            )
        x, aux = run_blocks(x, params["blocks"], cfg, positions, cache.k,
                            cache.v, cache_index, attn_mask, kv_tables,
                            cache_sk=cache.k_scale, cache_sv=cache.v_scale,
                            remat=remat, std_layout=std_layout)
    else:
        x, aux = run_blocks(x, params["blocks"], cfg, positions, cache.k,
                            cache.v, cache_index, attn_mask, kv_tables,
                            remat=remat, std_layout=std_layout,
                            key_positions=key_positions)
    out = (unembed(params, cfg, x), cache)
    return (*out, aux) if return_aux else out


# ---------------------------------------------------------------------------
# Random init (tests, smoke serving; real weights come from checkpoint/)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype: Any = None,
                device: "torch.device | str | None" = None) -> Params:
    """Random parameters of any family in the JAX package's stacked
    layout, drawn from ``generator`` (a ``torch.Generator`` on
    ``device``): normal weights scaled by fan_in^-0.5, unit norm scales,
    zero biases.  The values differ from ``jax.random``'s; tests share
    weights through ``checkpoint.from_jax`` instead.  Refuses what the
    reference refuses: MoE outside the llama family, tied neox
    embeddings."""
    check_supported(cfg)
    if cfg.num_experts > 0 and cfg.family != "llama":
        raise ValueError(
            "MoE (num_experts > 0) is supported for the llama family")
    if cfg.family == "neox" and cfg.tie_embeddings:
        raise ValueError("neox checkpoints untie embeddings (embed_out)")
    dtype = torch_dtype(dtype or cfg.dtype)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KVH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    attn = {
        "wq": dense((L, D, H, HD), D),
        "wk": dense((L, D, KVH, HD), D),
        "wv": dense((L, D, KVH, HD), D),
        "wo": dense((L, H, HD, D), H * HD),
    }
    params: Params = {
        "embed": {"wte": dense((cfg.vocab_size, D), D)},
        "final_norm": {"scale": ones((D,))},
    }
    if layernorm_family(cfg):
        off = learned_pos_offset(cfg)
        if off is not None:  # neox rotates; the others learn positions
            params["embed"]["wpe"] = dense((cfg.max_seq_len + off, D), D)
        params["final_norm"]["bias"] = zeros((D,))
        attn.update(bq=zeros((L, H, HD)), bk=zeros((L, KVH, HD)),
                    bv=zeros((L, KVH, HD)), bo=zeros((L, D)))
        norm = {"scale": ones((L, D)), "bias": zeros((L, D))}
        params["blocks"] = {
            "ln1": dict(norm), "ln2": {k: v.clone() for k, v in norm.items()},
            "attn": attn,
            "mlp": {"w_in": dense((L, D, F), D), "b_in": zeros((L, F)),
                    "w_out": dense((L, F, D), F), "b_out": zeros((L, D))},
        }
    else:
        if cfg.qkv_bias:  # Qwen2-style llama blocks
            attn.update(bq=zeros((L, H, HD)), bk=zeros((L, KVH, HD)),
                        bv=zeros((L, KVH, HD)))
        if cfg.num_experts > 0:
            E = cfg.num_experts
            mlp = {"router": dense((L, D, E), D),
                   "w_gate": dense((L, E, D, F), D),
                   "w_up": dense((L, E, D, F), D),
                   "w_down": dense((L, E, F, D), F)}
        else:
            mlp = {"w_gate": dense((L, D, F), D), "w_up": dense((L, D, F), D),
                   "w_down": dense((L, F, D), F)}
        params["blocks"] = {"ln1": {"scale": ones((L, D))},
                            "ln2": {"scale": ones((L, D))},
                            "attn": attn, "mlp": mlp}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense((D, cfg.vocab_size), D)}
    return params
