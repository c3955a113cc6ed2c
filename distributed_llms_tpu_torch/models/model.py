"""Decoder-only transformer forward pass, llama family (PyTorch port of
``distributed_llms_tpu/models/model.py``).

Parameters are the JAX package's pytree as plain dictionaries of tensors,
stacked over the layer axis (``params["blocks"][...]`` leaves lead with
L); :func:`run_blocks` walks the layers in a Python loop where the JAX
package runs ``lax.scan``.  Three cache layouts, as in the reference:

- a contiguous row cache ``[L, B, S, KVH, HD]``: a scalar ``cache_index``
  (admission prefill, causal or caller-supplied mask), or per-row
  ``cache_index`` (contiguous decode, one token per row, read by the
  ragged decode-attention kernel with the model's sliding window; or a
  T-token window a row, the speculative verify pass, dense under the
  caller's mask with the window ANDed in);
- a paged pool ``[L, NB, BLK, KVH, HD]`` addressed through ``kv_tables``
  (paged decode: per-row ``cache_index``, one token per row, or a T-token
  window a row), read by the paged decode-attention kernel
  (``ops/decode_attn.py``): a window's T query offsets are B*T virtual
  rows of ONE launch a layer, offset j reading its row's prefix through
  slot ``cache_index + j``;
- the same pool in int8 with float32 absmax scales
  (:class:`QuantKVCache`), quantized at the write and read by the
  kernel's int8 leg.

With ``attn_impl="flash"`` two more attention paths take the flash kernels
(``ops/flash.py``), under the reference's exact conditions: the no-cache
forward (training; the static-causal kernel K3 when :func:`forward` made
the positions itself) and the multi-token cached prefill without a
caller mask (the dynamic kernel K4 over the whole row cache, masking the
unwritten tail).  Everything else stays on the dense path.

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
    """The port serves the llama family (GQA + RoPE, SwiGLU, RMSNorm),
    with global or sliding-window attention, dense (``attn_impl="dot"``)
    or through the flash kernels (``"flash"``); the other families, MoE
    and the sequence-parallel attentions (``"ring"``, ``"ulysses"``) are
    later slices and are refused loudly."""
    if cfg.family != "llama":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (llama only)"
        )
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE blocks are not ported yet")
    if cfg.attn_impl not in ("dot", "flash"):
        raise NotImplementedError(
            f"attn_impl {cfg.attn_impl!r} is not ported yet (dot and flash "
            "only)"
        )


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Per-layer KV cache: a contiguous ``[L, B, S, KVH, HD]`` pair, or a
    page pool ``[L, NB, BLK, KVH, HD]`` pair in paged mode."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
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
) -> tuple[torch.Tensor, tuple[torch.Tensor, ...] | None]:
    q, k, v = layers.qkv_project(x, p, cfg)
    rope_scale = (
        (cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
         cfg.rope_high_freq_factor, cfg.rope_original_max_len)
        if cfg.rope_scaling_factor != 1.0 else None  # Llama-3.1 rescale
    )
    q = layers.apply_rope(q, positions, cfg.rope_theta, rope_scale)
    k = layers.apply_rope(k, positions, cfg.rope_theta, rope_scale)
    window = cfg.sliding_window
    per_row = torch.is_tensor(cache_index) and cache_index.dim() == 1

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
                                           paged_window)
        from ..ops import decode_attn

        ck, cv = layer_cache[:2]  # [NB, BLK, KVH, HD] views into the pool
        blk = ck.shape[1]
        rows = torch.arange(x.shape[0], device=x.device)
        page = kv_tables[rows, (cache_index // blk).long()].long()
        off = (cache_index % blk).long()
        lengths = (cache_index + 1).to(torch.int32)
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
                q, ck, cv, lengths, kv_tables, k_scale=sk, v_scale=sv
            )
            return layers.out_project(out, p), layer_cache
        ck[page, off] = k[:, 0].to(ck.dtype)
        cv[page, off] = v[:, 0].to(cv.dtype)
        out = decode_attn.paged_decode_attention(q, ck, cv, lengths, kv_tables)
        return layers.out_project(out, p), (ck, cv)

    if layer_cache is not None:
        ck, cv = layer_cache  # [B, S, KVH, HD] views into the row cache
        s = ck.shape[1]
        if per_row:
            # Contiguous batching: rows admitted at different times sit at
            # different depths.  Each row writes its one slot in place —
            # clamped to the last slot, as the JAX package's
            # dynamic_update_slice clamps a start past S - 1 (the batcher
            # never passes S: a finished row idles at S - 1 at most) — and
            # attends its prefix [0, cache_index + 1), or the window band
            # of it, through the ragged kernel.
            if x.shape[1] > 1:
                return _row_window_attention(q, k, v, p, cfg, positions,
                                             (ck, cv), cache_index,
                                             attn_mask)
            from ..ops import decode_attn

            rows = torch.arange(x.shape[0], device=x.device)
            slot = cache_index.long().clamp(0, s - 1)
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
            out = decode_attn.ragged_decode_attention(
                q, ck, cv, (cache_index + 1).to(torch.int32), window=window
            )
            return layers.out_project(out, p), (ck, cv)
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
        # caller-supplied masks (prefix continuation) carry the first two,
        # and every path ANDs in the window.  Slot == position here.
        k_positions = torch.arange(s, device=x.device).expand(x.shape[0], s)
        if cfg.attn_impl == "flash" and attn_mask is None and t > 1:
            # Prefill into the (longer, padded) row cache: the flash kernel
            # masks the unwritten tail instead of computing a dense
            # [T, S] score matrix; its one k_positions vector drives
            # causality and the window, exact because slot == position
            # here.  Single-token prefill stays dense, as in the reference.
            from ..ops import flash

            out = flash.flash_attention(
                q, ck.to(q.dtype), cv.to(q.dtype), q_positions=positions,
                k_positions=k_positions, k_valid=k_positions < ci + t,
                causal=True, window=window,
            )
            return layers.out_project(out, p), (ck, cv)
        if attn_mask is None:
            attn_mask = layers.causal_mask(
                positions, k_positions, k_positions < ci + t, window=window
            )
        elif window is not None:
            attn_mask = layers.and_window(attn_mask, positions, k_positions,
                                          window)
        k_full = layers.repeat_kv(ck.to(q.dtype), cfg.q_per_kv)
        v_full = layers.repeat_kv(cv.to(q.dtype), cfg.q_per_kv)
        out = layers.dot_product_attention(q, k_full, v_full, attn_mask)
        return layers.out_project(out, p), (ck, cv)

    if cfg.attn_impl == "flash" and attn_mask is None:
        # Self-attention over the input block (training, no-cache eval):
        # the static-causal kernel when the positions are the standard
        # arange, else the dynamic one at these positions; a sliding window
        # rides the kernels' window band.
        from ..ops import flash

        out = flash.flash_attention(
            q, k, v, q_positions=None if std_layout else positions,
            k_positions=None if std_layout else positions, causal=True,
            window=window,
        )
        return layers.out_project(out, p), None

    if attn_mask is None:
        mask = layers.causal_mask(positions, positions, window=window)
    elif window is not None:
        mask = layers.and_window(attn_mask, positions, positions, window)
    else:
        mask = attn_mask
    out = layers.dot_product_attention(
        q, layers.repeat_kv(k, cfg.q_per_kv),
        layers.repeat_kv(v, cfg.q_per_kv), mask,
    )
    return layers.out_project(out, p), None


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


def _paged_window_attention(q, k, v, p, layer_cache, window):
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


def _row_window_attention(q, k, v, p, cfg, positions, layer_cache,
                          cache_index, attn_mask):
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
    b, t = q.shape[:2]
    s = ck.shape[1]
    start = cache_index.long().clamp(0, s - t)
    idx = start[:, None] + torch.arange(t, device=q.device)[None, :]
    rows = torch.arange(b, device=q.device)[:, None]
    ck[rows, idx] = k.to(ck.dtype)
    cv[rows, idx] = v.to(cv.dtype)
    if cfg.sliding_window is not None:
        k_positions = torch.arange(s, device=q.device).expand(b, s)
        attn_mask = layers.and_window(attn_mask, positions, k_positions,
                                      cfg.sliding_window)
    k_full = layers.repeat_kv(ck.to(q.dtype), cfg.q_per_kv)
    v_full = layers.repeat_kv(cv.to(q.dtype), cfg.q_per_kv)
    out = layers.dot_product_attention(q, k_full, v_full, attn_mask)
    return layers.out_project(out, p), (ck, cv)


def llama_block(x, p, cfg, positions, layer_cache, cache_index,
                attn_mask=None, kv_tables=None, std_layout=False,
                paged_window=None):
    """-> (x, new_cache)."""
    h = layers.rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
    attn_out, new_cache = _attention(
        h, p["attn"], cfg, positions, layer_cache, cache_index,
        attn_mask=attn_mask, kv_tables=kv_tables, std_layout=std_layout,
        paged_window=paged_window,
    )
    x = x + attn_out
    h = layers.rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
    return x + layers.mlp_swiglu(h, p["mlp"], cfg.gate_act), new_cache


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
) -> torch.Tensor:
    """Run the stacked blocks over x, layer by layer (the JAX package's
    ``lax.scan``).  Cache writes land in place in ``cache_k``/``cache_v``
    (and the scales of an int8 pool).  Under weight-only quantized serving
    the blocks' matmul weights are ``QuantizedTensor`` leaves: they stay
    int8/int4 in device memory and reach the dequant-matmul kernel through
    ``layers._contract``.  ``remat`` checkpoints each block
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
    scan body): its activations are recomputed in the backward pass
    instead of kept."""
    n_layers = blocks["ln1"]["scale"].shape[0]
    window = None
    if kv_tables is not None and x.shape[1] > 1 and cache_k is not None:
        window = paged_window_rows(kv_tables, cache_index, x.shape[1],
                                   cache_k.shape[2])
    for i in range(n_layers):
        if cache_k is None:
            layer_cache = None
        elif cache_sk is None:
            layer_cache = (cache_k[i], cache_v[i])
        else:
            layer_cache = (cache_k[i], cache_v[i], cache_sk[i], cache_sv[i])
        args = (x, layer_params(blocks, i), cfg, positions, layer_cache,
                cache_index, attn_mask, kv_tables, std_layout, window)
        if remat:
            x, _ = torch.utils.checkpoint.checkpoint(
                llama_block, *args, use_reentrant=False)
        else:
            x, _ = llama_block(*args)
    return x


# ---------------------------------------------------------------------------
# Full model forward
# ---------------------------------------------------------------------------

def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["wte"][tokens.long()].to(torch_dtype(cfg.dtype))
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
    x = layers.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    w = params["embed"]["wte"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    b, t, d = x.shape
    return _matmul_f32(x.reshape(b * t, d), w).reshape(b, t, -1)


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
) -> tuple[torch.Tensor, "KVCache | QuantKVCache | None"]:
    """Full forward.  Returns (logits [B, T, V] float32, the cache — the
    same object, updated in place).  A :class:`QuantKVCache` serves paged
    decode only (``kv_tables`` required)."""
    check_supported(cfg)
    b, t = tokens.shape
    # Standard layout: forward made the positions itself with no cache
    # offset, so query rows align with key slots (the flash static path).
    std_layout = positions is None and (cache_index is None or cache is None)
    if positions is None:
        base = 0 if cache_index is None else int(cache_index)
        positions = (torch.arange(t, device=tokens.device) + base).expand(b, t)
    x = embed(params, cfg, tokens)
    if cache is None:
        x = run_blocks(x, params["blocks"], cfg, positions, None, None, None,
                       attn_mask, remat=remat, std_layout=std_layout)
    elif isinstance(cache, QuantKVCache):
        # Int8 page pool: the quantized write and the scale-fused read both
        # live on the kv_tables path.
        if kv_tables is None:
            raise ValueError(
                "QuantKVCache serves paged decode only (pass kv_tables); "
                "prefill runs against full-width transient rows"
            )
        x = run_blocks(x, params["blocks"], cfg, positions, cache.k, cache.v,
                       cache_index, attn_mask, kv_tables,
                       cache_sk=cache.k_scale, cache_sv=cache.v_scale,
                       remat=remat, std_layout=std_layout)
    else:
        x = run_blocks(x, params["blocks"], cfg, positions, cache.k, cache.v,
                       cache_index, attn_mask, kv_tables, remat=remat,
                       std_layout=std_layout)
    return unembed(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Random init (tests, smoke serving; real weights come from checkpoint/)
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                dtype: Any = None,
                device: "torch.device | str | None" = None) -> Params:
    """Random llama parameters in the JAX package's stacked layout, drawn
    from ``generator`` (a ``torch.Generator`` on ``device``): normal
    weights scaled by fan_in^-0.5, unit norm scales.  The values differ
    from ``jax.random``'s; tests share weights through
    ``checkpoint.from_jax`` instead."""
    check_supported(cfg)
    dtype = torch_dtype(dtype or cfg.dtype)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KVH, HD = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    attn = {
        "wq": dense((L, D, H, HD), D),
        "wk": dense((L, D, KVH, HD), D),
        "wv": dense((L, D, KVH, HD), D),
        "wo": dense((L, H, HD, D), H * HD),
    }
    if cfg.qkv_bias:  # Qwen2-style llama blocks
        attn["bq"] = torch.zeros((L, H, HD), dtype=dtype, device=device)
        attn["bk"] = torch.zeros((L, KVH, HD), dtype=dtype, device=device)
        attn["bv"] = torch.zeros((L, KVH, HD), dtype=dtype, device=device)
    params: Params = {
        "embed": {"wte": dense((cfg.vocab_size, D), D)},
        "final_norm": {"scale": ones((D,))},
        "blocks": {
            "ln1": {"scale": ones((L, D))},
            "ln2": {"scale": ones((L, D))},
            "attn": attn,
            "mlp": {
                "w_gate": dense((L, D, F), D),
                "w_up": dense((L, D, F), D),
                "w_down": dense((L, F, D), F),
            },
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense((D, cfg.vocab_size), D)}
    return params
