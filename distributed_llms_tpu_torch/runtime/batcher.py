"""Continuous batching over a contiguous or paged, prefix-cached KV cache
(PyTorch port of the single-device subset of
``distributed_llms_tpu/runtime/batcher.py``).

A fixed set of batch SLOTS decodes at all times; a queued request is
prefilled into a free slot between decode chunks while the other rows keep
generating.  Two cache modes, as in the reference:

- contiguous (``paged_pages=None``, the default): each slot owns a
  ``max_len``-slot row of the cache ``[L, B, S, KVH, HD]``; decode reads
  each row's prefix — or its sliding-window band — through the ragged
  decode kernel.  The one mode that serves sliding-window models.
- paged: a shared page pool ``[L, NB, BLK, KVH, HD]``, bf16 or int8 with
  absmax scales (``kv_bits=8``).  Rows admit with pages for the prompt
  plus one decode page and grow on demand at chunk boundaries; a dry pool
  evicts LRU-cold cached pages, then preempts the lowest-priority /
  most-recently-admitted row, then back-pressures admission.  Automatic
  prefix caching content-hashes every full prompt page (the reference's
  blake2b chain, salted by the KV width, byte-identical digests) and later
  admissions reuse the longest cached run copy-free through their page
  tables, prefilling only the suffix.
- the host tier (``host_pages``, ``runtime/kv_tier.py``) behind the pool: a
  preempted row's raw pages swap out to host RAM and scatter back at its
  resume (no recompute; exact recompute when the budget is dry), and an
  LRU-evicted cached page spills there, so a later hit restores it instead
  of prefilling it again.

Requests may carry presence/frequency penalties (OpenAI semantics: the
logits less ``freq * counts + pres * (counts > 0)`` over the request's own
output, a ``[B, V]`` histogram carried on the device) and a named prefix
(``register_prefix``: prefilled once, its KV seeds every admission that
names it).

A prompt longer than the scheduler's chunk threshold (``prefill_chunk``,
or ``token_budget`` under the mixed schedule) prefills in bites into a
transient row, ``prefill_concurrency`` prompts at a time, and splices
into the cache only when complete.  The mixed schedule (the default) runs
each bite in the same step as the decode chunk of the live rows; the
alternate schedule runs bites as rounds of their own.

The engine loop dispatches ahead (``overlap=True``, the default): while no
scheduling work is pending, chunk N+1 is dispatched from chunk N's carry on
the device, and chunk N's host work (its one batched copy to the host,
delivery, digest hashing, metrics) runs while N+1 executes.  Every
scheduling decision still runs against host mirrors synced at the span's
end, so temperature-0 outputs are identical with the overlap off.

Device programs (the JAX package's jitted functions, same names):
``admit_row`` (prefill into a transient row, spliced into the slot's
row), ``admit_row_paged`` / ``admit_row_auto_paged`` (the same, spliced
into pool pages — quantized once there in an int8 pool),
``admit_row_with_prefix(_paged)`` (a named prefix's KV seeds the row),
``_export_pages_raw`` / ``_import_pages_raw`` (host-tier parcels),
``prefill_chunk_step`` / ``finish_chunked_admission(_paged)`` (one bite;
the finishing splice), ``decode_chunk`` (K decode steps for every slot;
each step's attention is a decode kernel of ``ops/decode_attn.py``; on
CUDA tensors a replay of a captured graph, ``runtime/chunk_graph.py``) and
``mixed_step`` (one bite, then a decode chunk).  Caches are updated IN
PLACE where the JAX programs donate them.  Host scheduling state lives in
numpy mirrors synced once per span.

Invariant (tests/test_torch_batcher_modes.py, tests/test_torch_serving.py,
tests/test_torch_overlap.py, tests/test_torch_chunked_prefill.py,
tests/test_torch_host_tier_serving.py, tests/test_torch_penalties.py,
tests/test_torch_named_prefix.py): at temperature 0 the token streams
equal the JAX batcher's on the same weights and prompts.

Speculative batching (``draft_params``/``draft_cfg``/``spec_k``): every
round drafts ``spec_k`` tokens a row with a draft model over its own
contiguous cache and verifies them in ONE (k+1)-token target forward
(:func:`spec_chunk`), in either cache mode; at temperature 0 every
committed token is the target's greedy token (the plain batcher's stream,
to the token where the verify's wider products round as a plain step's:
always in float32, up to near-ties in bf16), above it rejection sampling
keeps the target's distribution.  A per-row acceptance EMA lets the scheduler shorten a cold
row's rounds (``spec_adaptive_k``).

Constrained output (``response_format`` / ``logit_bias`` /
``banned_tokens``, runtime/constrain.py): a constrained row's first token
draws under its automaton's start-state mask, and every decode step adds
the row's state mask to the sampling logits (after the penalties, before
the warps and the draw) and advances the row's state on the token it drew.
The live rows' automata stack into one (bias, next) pair per span, padded
up the bucket ladder and read in place by the step; the states ride the
device carry.  Free rows ride state 0, whose mask row is all zeros, so
their tokens and logprobs equal a batch without constrained neighbours.

A :class:`~.faults.FaultPlane` (``faults=``) arms the reference's
injection sites: ``batcher.admit``, ``batcher.decode``,
``batcher.page_alloc``, ``batcher.preempt``, ``batcher.spec_verify``,
``batcher.mixed_step``, ``kv.swap_out``, ``kv.swap_in`` and ``kv.spill``.

Tenants (``tenant_weights`` / ``tenant_max_rows``, ``submit(tenant=)``):
the mixed policy becomes :class:`~.scheduler.TenantScheduler`, weighted-fair
admission by virtual token counter with a resident-row cap per tenant.

The KV handoff (disaggregated prefill/decode and the fleet's cross-replica
pull, ``cluster/kv_transfer.py``): :meth:`ContinuousBatcher.
export_prefix_pages` gathers a prompt's cached full-page run as
``[L, P, BLK, KVH, HD]`` k/v stacks at the pool's row dtype (an int8 pool
dequantizes), :meth:`~ContinuousBatcher.submit_kv_import` queues verified
pages for adoption at the next round boundary (an int8 pool requantizes;
digests already resident ack "duplicate"; first writer wins on publish),
and :meth:`~ContinuousBatcher.submit_kv_export` serves a sibling's pull
there.

On a data x tensor x expert-parallel mesh (``parallel=``, a
``parallel.api.ParallelModel`` without pipe/seq axes) every rank runs
this batcher over its local weights: its KV heads of the pool (or of the
contiguous cache), its experts, the reference's checks and messages (KV heads
divide over 'model' for a paged pool, ``batch_slots`` over 'data', no
speculation).  Every rank's cache holds every row (the forward gathers
each step's K/V over 'data', ``models/model.py``), the logits reach every
rank whole, and every scheduling decision runs on host mirrors equal on
every rank, so the ranks stay in lockstep; with requests reaching rank 0
only, ``runtime/lockstep.py`` broadcasts them at each engine iteration.
The decode chunk replays a captured graph under NCCL; a gloo collective
cannot be captured, so under gloo the eager step loop runs
(:attr:`ContinuousBatcher.loop_kind`), the kernels launching from it.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.observability import METRICS, get_logger
from ..models import model as model_lib
from ..checkpoint.quantize import QuantizedTensor, kv_dequantize, kv_quantize
from ..models.model import KVCache, QuantKVCache
from . import chunk_graph, constrain as constrain_lib, sampling
from .lockstep import Lockstep
from .kv_tier import HostTier
from .scheduler import SyncView, make_scheduler
from .session import continuation_mask
from .shapes import BUCKET_FLOOR, bucket_length as _bucket

log = get_logger("batcher")

# Acceptance-EMA smoothing for the adaptive spec_k downshift: ~5 rounds of
# history (the reference's constant).
_SPEC_EMA_ALPHA = 0.2


def _sample_first(logits, last_idx, generator, temperature, top_k, top_p,
                  temp_req=None, topp_req=None, topk_req=None,
                  mask_req=None):
    """Sample the admitted row's first token from the last real position's
    logits — the one sampling tail shared by every admission path.
    ``temp_req``/``topp_req``/``topk_req`` override the batcher-wide knobs
    for a per-request sampled row.  ``mask_req`` [V] is a constrained or
    biased request's start-state token mask (runtime/constrain.py): added
    before the draw AND the greedy argmax, never to the logprob.  Returns
    (token, its raw logprob)."""
    next_logits = logits[:, max(last_idx - 1, 0)]  # [1, V]
    src = next_logits if mask_req is None else next_logits + mask_req[None, :]
    if temp_req is None:
        tok = sampling.sample(generator, src, temperature, top_k, top_p)[0]
    else:
        dev = next_logits.device
        tok = sampling.sample_rows(
            generator, src, torch.tensor([temp_req], device=dev),
            top_k, torch.tensor([topp_req], device=dev),
            top_k_rows=(None if topk_req is None
                        else torch.tensor([topk_req], device=dev)),
        )[0]
    # Chosen-token logprob under the RAW model distribution (the OpenAI
    # logprobs contract).
    lp = torch.log_softmax(next_logits[0].float(), dim=-1)[tok.long()]
    return tok, lp


def _prefill_row(params, cfg, cache_dtype, s, prompt):
    """Dense causal prefill of one request into a transient single-row
    cache of width ``s``."""
    (tp,) = prompt.shape
    row_cache = model_lib.init_cache(cfg, 1, s, dtype=cache_dtype,
                                     device=prompt.device)
    positions = torch.arange(tp, device=prompt.device)[None, :]
    return model_lib.forward(params, cfg, prompt[None, :], positions=positions,
                             cache=row_cache, cache_index=0)


def _prefill_row_with_prefix(params, cfg, prefix_k, prefix_v, prefix_len,
                             chunk):
    """Prefix-seeded prefill: only the request's suffix runs through the
    model, attending the prefix slots plus its own causal chunk."""
    (tc,) = chunk.shape
    s = prefix_k.shape[-3]
    slots = torch.arange(s, device=chunk.device)
    row_cache = KVCache(k=prefix_k, v=prefix_v)
    positions = (prefix_len + torch.arange(tc, device=chunk.device))[None, :]
    prefix_valid = (slots < prefix_len)[None, :]  # [1, S]
    mask = continuation_mask(prefix_valid, prefix_len, tc, slots)
    return model_lib.forward(params, cfg, chunk[None, :], positions=positions,
                             cache=row_cache, cache_index=prefix_len,
                             attn_mask=mask)


def _finish_admission(cache, slot, row_cache, logits, last_idx, generator,
                      temperature, top_k, top_p, total_len, temp_req=None,
                      topp_req=None, topk_req=None, mask_req=None):
    """Contiguous admission tail: sample the first token from the last
    real position's logits, copy the prefilled row into the shared cache's
    row ``slot`` (in place: the JAX program splices into the donated
    cache), report the row's valid slots (a prefix)."""
    tok, lp = _sample_first(logits, last_idx, generator, temperature, top_k,
                            top_p, temp_req, topp_req, topk_req, mask_req)
    w = row_cache.k.shape[2]  # a speculative cache's headroom slots stay
    cache.k[:, slot, :w] = row_cache.k[:, 0].to(cache.k.dtype)
    cache.v[:, slot, :w] = row_cache.v[:, 0].to(cache.v.dtype)
    row_valid = np.arange(cache.k.shape[2]) < total_len
    return cache, tok, row_valid, lp


def admit_row(params, cfg, cache, slot, prompt, plen, generator,
              temperature=0.0, top_k=0, top_p=1.0, temp_req=None,
              topp_req=None, topk_req=None, width=None, mask_req=None):
    """Prefill one request into batch row ``slot`` of a contiguous cache.
    ``prompt`` [Tp] right-padded, ``plen`` its true length; ``width`` the
    transient row's slots (default the cache's: a speculative batcher
    passes its ``max_len``, so the prefill has the plain batcher's
    shapes); ``mask_req`` [V] a constrained request's first-token mask.
    Returns (cache, first_token, row_valid [S] bool, first_token_logprob)."""
    logits, row_cache = _prefill_row(params, cfg, cache.k.dtype,
                                     width or cache.k.shape[2], prompt)
    return _finish_admission(cache, slot, row_cache, logits, plen, generator,
                             temperature, top_k, top_p, plen, temp_req,
                             topp_req, topk_req, mask_req)


def admit_row_kv(params, cfg, cache, slot, prompt, plen):
    """KV-only admission: prefill one row and copy it into row ``slot`` of
    a contiguous cache, sampling nothing.  Speculative batching seeds the
    DRAFT cache with it for every admitted row (the prefix cache and named
    prefixes hold target KV only, so the draft prefills the whole
    prompt).  The transient prefill writes all ``Tp`` slots; slots past
    ``plen`` are junk that the draft's steps overwrite before any read."""
    del plen
    _, row_cache = _prefill_row(params, cfg, cache.k.dtype, cache.k.shape[2],
                                prompt)
    cache.k[:, slot] = row_cache.k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = row_cache.v[:, 0].to(cache.v.dtype)
    return cache


def _gather_row_pages(cache, read_list: torch.Tensor):
    """Gather a row's pages out of the pool into a transient contiguous row
    cache ([L, 1, P*BLK, KVH, HD] k/v pair) — fresh tensors the suffix
    prefill then writes into.  An int8 pool dequantizes the gathered pages
    to its full-width ``row_dtype``: transient rows always run full width;
    only pool storage is quantized."""
    l, _, blk, kvh, hd = cache.k.shape
    p = read_list.shape[0]
    idx = read_list.long()
    if isinstance(cache, QuantKVCache):
        dt = model_lib.torch_dtype(cache.row_dtype)

        def gather_q(pool, scale):
            full = kv_dequantize(pool[:, idx], scale[:, idx], dt)
            return full.reshape(l, 1, p * blk, kvh, hd)

        return (gather_q(cache.k, cache.k_scale),
                gather_q(cache.v, cache.v_scale))
    return (cache.k[:, idx].reshape(l, 1, p * blk, kvh, hd),
            cache.v[:, idx].reshape(l, 1, p * blk, kvh, hd))


def _paged_pool(cfg: ModelConfig, num_pages: int, page_size: int, dtype=None,
                device=None, kv_bits: int = 16):
    """KV page pools [L, NB, BLK, KVH, HD] (distinct k/v buffers).
    ``kv_bits=8`` builds an int8 :class:`QuantKVCache` pool (data int8 +
    one float32 absmax scale per head-dim vector) at about half the bytes
    per token; the full-width dtype survives as ``row_dtype``."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim_)
    dt = model_lib.torch_dtype(dtype or cfg.dtype)
    if kv_bits == 8:
        sshape = shape[:-1]
        return QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            v_scale=torch.ones(sshape, dtype=torch.float32, device=device),
            row_dtype=str(dt).removeprefix("torch."),
        )
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))


def _row_dtype_of(cache) -> torch.dtype:
    """Dtype transient single-row caches (and pool gathers) use: the
    cache's own dtype, or the declared full-width dtype of an int8 pool."""
    if isinstance(cache, QuantKVCache):
        return model_lib.torch_dtype(cache.row_dtype)
    return cache.k.dtype


def pool_page_bytes(cfg: ModelConfig, page_size: int, kv_bits: int = 16,
                    dtype=None) -> int:
    """Bytes one pool page costs (k + v, plus the int8 pool's scales)."""
    elems = cfg.num_layers * page_size * cfg.num_kv_heads * cfg.head_dim_
    if kv_bits == 8:
        return 2 * (elems + cfg.num_layers * page_size * cfg.num_kv_heads * 4)
    dt = model_lib.torch_dtype(dtype or cfg.dtype)
    return 2 * elems * dt.itemsize


def _paged_splice(cache, page_list, row_cache, logits, last_idx, generator,
                  temperature, top_k, top_p, temp_req=None, topp_req=None,
                  topk_req=None, mask_req=None):
    """Admission tail for the paged pool: sample the first token, then
    write the contiguous transient row's pages into the pool through
    ``page_list`` [P].  Past the allocation the list is padded with the
    scratch page 0, and a prefix-cache hit routes its CACHED positions
    there too (shared pages are never rewritten); those duplicate targets
    leave the scratch page with some winner, which no live row reads."""
    tok, lp = _sample_first(logits, last_idx, generator, temperature, top_k,
                            top_p, temp_req, topp_req, topk_req, mask_req)
    p = page_list.shape[0]
    blk = cache.k.shape[2]
    idx = page_list.long()

    def pages_of(row):  # row: [L, 1, P*BLK, KVH, HD]
        l, _, _, kvh, hd = row.shape
        return row[:, 0].reshape(l, p, blk, kvh, hd)

    # In place: the JAX program scatters into the donated pool.
    if isinstance(cache, QuantKVCache):
        # Quantize ONCE at the write: each head-dim vector gets int8 data
        # + one float32 absmax scale; the pool never holds the full-width
        # row.
        cache.k[:, idx], cache.k_scale[:, idx] = kv_quantize(
            pages_of(row_cache.k))
        cache.v[:, idx], cache.v_scale[:, idx] = kv_quantize(
            pages_of(row_cache.v))
    else:
        cache.k[:, idx] = pages_of(row_cache.k).to(cache.k.dtype)
        cache.v[:, idx] = pages_of(row_cache.v).to(cache.v.dtype)
    return cache, tok, lp


def admit_row_paged(params, cfg, cache, page_list, prompt, plen, generator,
                    temperature=0.0, top_k=0, top_p=1.0, temp_req=None,
                    topp_req=None, topk_req=None, mask_req=None):
    """Paged admission: dense causal prefill on a transient contiguous row
    cache, then splice its pages into the pool.  ``page_list`` [P] int32
    (scratch-padded), ``prompt`` [Tp] right-padded, ``plen`` its true
    length.  Returns (cache, tok, logprob)."""
    logits, row_cache = _prefill_row(
        params, cfg, _row_dtype_of(cache),
        page_list.shape[0] * cache.k.shape[2], prompt,
    )
    return _paged_splice(cache, page_list, row_cache, logits, plen, generator,
                         temperature, top_k, top_p, temp_req, topp_req,
                         topk_req, mask_req)


def admit_row_auto_paged(params, cfg, cache, read_list, write_list,
                         prefix_len, chunk, clen, generator, temperature=0.0,
                         top_k=0, top_p=1.0, temp_req=None, topp_req=None,
                         topk_req=None, mask_req=None):
    """AUTOMATIC prefix-cache admission: the row's cached prefix KV is
    gathered out of its shared pool pages (``read_list``: the full page
    table) into the transient row, only the un-cached suffix ``chunk``
    runs through the model, and the result splices back through
    ``write_list`` (cached positions routed to the scratch page).  The
    gather reads the pool before the splice writes it.  Returns (cache,
    tok, logprob)."""
    row_k, row_v = _gather_row_pages(cache, read_list)
    logits, row_cache = _prefill_row_with_prefix(
        params, cfg, row_k, row_v, prefix_len, chunk
    )
    return _paged_splice(cache, write_list, row_cache, logits, clen,
                         generator, temperature, top_k, top_p, temp_req,
                         topp_req, topk_req, mask_req)


def admit_row_with_prefix(params, cfg, cache, slot, prefix_k, prefix_v,
                          prefix_len, chunk, clen, generator,
                          temperature=0.0, top_k=0, top_p=1.0, temp_req=None,
                          topp_req=None, topk_req=None, mask_req=None):
    """Named-prefix admission into row ``slot`` of a contiguous cache: the
    prefix's KV (computed once by ``register_prefix``) seeds a copy of the
    row, only the request's suffix ``chunk`` (right-padded, ``clen`` real
    tokens) prefills.  Returns (cache, tok, row_valid, logprob)."""
    logits, row_cache = _prefill_row_with_prefix(
        params, cfg, prefix_k.clone(), prefix_v.clone(), prefix_len, chunk)
    return _finish_admission(cache, slot, row_cache, logits, clen, generator,
                             temperature, top_k, top_p, prefix_len + clen,
                             temp_req, topp_req, topk_req, mask_req)


def admit_row_with_prefix_paged(params, cfg, cache, page_list, prefix_k,
                                prefix_v, prefix_len, chunk, clen, generator,
                                temperature=0.0, top_k=0, top_p=1.0,
                                temp_req=None, topp_req=None, topk_req=None,
                                mask_req=None):
    """Named-prefix admission into the paged pool: the prefix's KV seeds a
    copy of the transient row, only the suffix prefills, then the row's
    pages scatter into the pool through ``page_list``.  Returns (cache,
    tok, logprob)."""
    logits, row_cache = _prefill_row_with_prefix(
        params, cfg, prefix_k.clone(), prefix_v.clone(), prefix_len, chunk)
    return _paged_splice(cache, page_list, row_cache, logits, clen,
                         generator, temperature, top_k, top_p, temp_req,
                         topp_req, topk_req, mask_req)


def page_layout(cache) -> tuple:
    """(shape, dtype) of each array of one pool page, in parcel order:
    K and V ``[L, BLK, KVH, HD]``, plus the int8 pool's f32 scales
    ``[L, BLK, KVH]`` — a host-tier slot's layout."""
    arrays = ((cache.k, cache.v, cache.k_scale, cache.v_scale)
              if isinstance(cache, QuantKVCache) else (cache.k, cache.v))
    return tuple(((a.shape[0],) + tuple(a.shape[2:]), a.dtype)
                 for a in arrays)


def _export_pages_raw(cache, page_list: torch.Tensor) -> tuple:
    """Gather pages VERBATIM in pool layout and pool dtype: (k, v) page
    stacks ``[L, n, BLK, ...]``, plus the scale stacks of an int8 pool.
    This is the host-tier parcel format (swap preemption, prefix-cache
    spill): importing the same bytes through :func:`_import_pages_raw`
    restores the pool to the bit, at either KV width."""
    idx = page_list.long()
    if isinstance(cache, QuantKVCache):
        return (cache.k[:, idx], cache.v[:, idx], cache.k_scale[:, idx],
                cache.v_scale[:, idx])
    return (cache.k[:, idx], cache.v[:, idx])


def _import_pages_raw(cache, page_list: torch.Tensor, k_pages, v_pages,
                      k_scale=None, v_scale=None):
    """Scatter a raw parcel (:func:`_export_pages_raw` layout) into pool
    pages ``page_list``, in place and verbatim: no quantize step, so the
    restore is exact."""
    idx = page_list.long()
    cache.k[:, idx] = k_pages
    cache.v[:, idx] = v_pages
    if isinstance(cache, QuantKVCache):
        cache.k_scale[:, idx] = k_scale
        cache.v_scale[:, idx] = v_scale
    return cache


def _import_pages(cache, page_list: torch.Tensor, k_pages, v_pages):
    """Scatter HANDED-OFF KV pages into the pool, in place (the reference's
    ``_import_pages``): ``k_pages``/``v_pages`` are [L, P, BLK, KVH, HD]
    stacks at the pool's row dtype, ``page_list`` [P] the freshly
    allocated destination pages.  An int8 pool quantizes the full-width
    payload on the way in (the reference's ``kv_quantize`` numerics)."""
    idx = page_list.long()
    if isinstance(cache, QuantKVCache):
        cache.k[:, idx], cache.k_scale[:, idx] = kv_quantize(k_pages)
        cache.v[:, idx], cache.v_scale[:, idx] = kv_quantize(v_pages)
    else:
        cache.k[:, idx] = k_pages.to(cache.k.dtype)
        cache.v[:, idx] = v_pages.to(cache.v.dtype)
    return cache


def prefill_chunk_step(params, cfg, row_k, row_v, done, chunk, clen):
    """One bite of a CHUNKED prefill — the one definition shared by the
    alternate schedule's rounds and the fused :func:`mixed_step` (the
    reference's ``prefill_chunk_step`` and ``_prefill_leg``): consume
    ``chunk`` [Tc] (right-padded, ``clen`` real tokens) into the transient
    row at offset ``done`` (host ints) — the prefix-cached admission's
    continuation math, the "prefix" being the row's own partial prompt.
    The row is updated in place.  Returns (row_k, row_v, last_logits [1, V]
    at the bite's last real position)."""
    logits, row_cache = _prefill_row_with_prefix(params, cfg, row_k, row_v,
                                                 done, chunk)
    return row_cache.k, row_cache.v, logits[:, max(clen - 1, 0)]


def finish_chunked_admission(cache, slot, row_k, row_v, last_logits,
                             total_len, generator, temperature=0.0, top_k=0,
                             top_p=1.0, temp_req=None, topp_req=None,
                             topk_req=None, mask_req=None):
    """Tail of a chunked admission: sample the first token from the last
    bite's logits and splice the prefilled transient row into row
    ``slot`` — the monolithic paths' :func:`_finish_admission`.  Returns
    (cache, tok, row_valid, logprob)."""
    return _finish_admission(cache, slot, KVCache(k=row_k, v=row_v),
                             last_logits[:, None, :], 1, generator,
                             temperature, top_k, top_p, total_len, temp_req,
                             topp_req, topk_req, mask_req)


def finish_chunked_admission_paged(cache, page_list, row_k, row_v,
                                   last_logits, generator, temperature=0.0,
                                   top_k=0, top_p=1.0, temp_req=None,
                                   topp_req=None, topk_req=None,
                                   mask_req=None):
    """Tail of a chunked admission in paged mode: the first token from the
    last bite's logits, the transient row's pages scattered into the pool
    through ``page_list`` — :func:`_paged_splice`, as every monolithic
    paged admission.  Pages are allocated only here: a long prompt pins no
    pool page while it chunks in.  Returns (cache, tok, logprob)."""
    return _paged_splice(cache, page_list, KVCache(k=row_k, v=row_v),
                         last_logits[:, None, :], 1, generator, temperature,
                         top_k, top_p, temp_req, topp_req, topk_req, mask_req)


# The scheduling carry of a decode chunk: one [4, B] int32 tensor whose rows
# are (last_tok, real_lens, active as 0/1, budget), so a chunk's carry feeds
# the next chunk, or returns to the host, in one copy.  A span with
# constrained rows carries a fifth row: each row's automaton state (an
# absolute index into the span's stack; 0 = free).
CARRY_ROWS = 4


def unpack_chunk(packed: np.ndarray, b: int, k: int, commits: bool = False,
                 dfa: bool = False):
    """A chunk's packed output on the host, [2*B*K (+ B) + R*B] int32 ->
    (toks [B, K] int32, logprobs [B, K] float32, m, carry [R, B] int32):
    views; R is :data:`CARRY_ROWS`, plus one with the automaton states
    (``dfa``).  A speculative round (``commits``; K = spec_k + 1) packs
    each row's commit count ``m`` [B] between the logprobs and the carry —
    row b's tokens are ``toks[b, :m[b]]``; a plain chunk has none (m
    None)."""
    n = b * k
    rows = CARRY_ROWS + int(dfa)
    m = packed[2 * n:2 * n + b] if commits else None
    return (packed[:n].reshape(b, k),
            packed[n:2 * n].view(np.float32).reshape(b, k), m,
            packed[-rows * b:].reshape(rows, b))


def _decode_steps(params, cfg, cache, carry, generator, chunk_steps,
                  temperature=0.0, top_k=0, top_p=1.0, eos_id=-1, pad_id=0,
                  tables=None, temp_row=None, topp_row=None, topk_row=None,
                  counts=None, pres_row=None, freq_row=None, mask_stack=None,
                  next_stack=None):
    """K decode steps for every slot, on device with no host sync, each
    kernel launched from here (:func:`decode_chunk` replays them from a
    graph on the card).  Each step is ONE batched forward with per-row
    positions and write slots.  Validity is implicit in ``real_lens`` (the
    decode kernels' prefix contract): paged mode reads and writes through
    the page table; contiguous mode writes slot ``real_lens[b]`` of row b
    and attends its prefix (or window band) through the ragged kernel.
    ``counts`` [B, V] int32 (with ``pres_row``/``freq_row`` [B]) engages
    the presence/frequency penalties: each step samples from ``logits -
    freq * counts - pres * (counts > 0)`` and adds the pre-step-active
    rows' tokens to ``counts`` in place (a scatter-add, one index a row).
    Logprobs stay those of the raw logits.  A carry with a fifth row (the
    automaton states) engages constrained output: each step adds
    ``mask_stack[state]`` [B, V] to the (penalized) logits it samples from
    and moves each pre-step-active row to ``next_stack[state, tok]``;
    free rows ride state 0, whose mask row is zeros.  Returns the packed
    output (:func:`unpack_chunk`)."""
    last_tok, real_lens, active, budget = (carry[0], carry[1],
                                           carry[2].bool(), carry[3])
    dstate = carry[CARRY_ROWS] if carry.shape[0] > CARRY_ROWS else None
    toks, lps = [], []
    for _ in range(chunk_steps):
        was_active = active
        logits, cache = model_lib.forward(
            params, cfg, last_tok[:, None], positions=real_lens[:, None],
            cache=cache, cache_index=real_lens, kv_tables=tables,
        )
        logits = logits[:, 0]
        real_lens = real_lens + active.to(torch.int32)
        if counts is not None:
            sample_from = (
                logits - freq_row[:, None] * counts.to(logits.dtype)
                - pres_row[:, None] * (counts > 0).to(logits.dtype)
            )
        else:
            sample_from = logits
        # The grammar mask after the penalties: its -1e30 entries dominate
        # any finite adjustment.
        bias = (constrain_lib.gather_bias(mask_stack, dstate)
                if dstate is not None else None)
        if temp_row is None:
            src = sample_from if bias is None else sample_from + bias
            tok = sampling.sample(generator, src, temperature, top_k, top_p)
        else:
            tok = sampling.sample_rows(
                generator, sample_from, temp_row, top_k,
                1.0 if topp_row is None else topp_row, top_k_rows=topk_row,
                mask_rows=bias,
            )
        if dstate is not None:
            # Only pre-step-active rows advance: an idle row's junk token
            # moves no automaton.
            dstate = torch.where(
                was_active,
                constrain_lib.advance_states(next_stack, dstate, tok),
                dstate)
        if counts is not None:
            counts.scatter_add_(1, tok.long()[:, None],
                                was_active.to(torch.int32)[:, None])
        budget = budget - active.to(torch.int32)
        if eos_id >= 0:
            active = active & (tok != eos_id)
        active = active & (budget > 0)
        # Mask with the PRE-step activity: a row that just finished still
        # emits this step's token.
        toks.append(torch.where(was_active, tok, pad_id))
        lp = torch.log_softmax(logits.float(), dim=-1).gather(
            -1, tok[:, None].long()
        )[:, 0]
        lps.append(torch.where(was_active, lp, 0.0))
        last_tok = torch.where(was_active, tok, last_tok)
    return torch.cat([torch.stack(toks, dim=1).reshape(-1),
                      torch.stack(lps, dim=1).reshape(-1).view(torch.int32),
                      last_tok, real_lens, active.to(torch.int32), budget]
                     + ([] if dstate is None else [dstate.to(torch.int32)]))


def _weights_key(params) -> tuple:
    """The weights' quantization as a graph key: None for plain blocks,
    else the bits of the projections' ``QuantizedTensor`` leaves."""
    wq = params["blocks"]["attn"]["wq"]
    return (wq.bits,) if isinstance(wq, QuantizedTensor) else (None,)


def decode_chunk(params, cfg, cache, carry, generator, chunk_steps,
                 temperature=0.0, top_k=0, top_p=1.0, eos_id=-1, pad_id=0,
                 tables=None, temp_row=None, topp_row=None, topk_row=None,
                 counts=None, pres_row=None, freq_row=None, mask_stack=None,
                 next_stack=None, graphs=None, eager=False):
    """K decode steps with per-row positions over the page pool
    (``tables``) or the contiguous cache (``tables=None``), from ``carry``
    [4, B] int32 (:data:`CARRY_ROWS`).  Returns the packed output (see
    :func:`unpack_chunk`); the cache is written in place.
    ``temp_row``/``topp_row``/``topk_row`` switch to per-row sampling
    (sampling.sample_rows); ``counts``/``pres_row``/``freq_row`` to the
    penalized sampler, ``counts`` updated in place like the cache;
    ``mask_stack``/``next_stack`` [S, V] with a five-row carry to
    constrained output (:func:`_decode_steps`).

    On CPU tensors the steps run eagerly.  On CUDA tensors they replay the
    captured graph of this plan in ``graphs`` (a
    :class:`~.chunk_graph.ChunkGraphs` tied to this cache and these
    weights; the JAX package's counterpart is the jitted program): the
    key is the batch and step count, the cache kind and table width, the
    weights' quantization, the per-row arrays present, whether the
    penalty histogram is, and the sampling scalars.  The histogram is
    carried, not copied: the graph reads and writes the batcher's one
    ``counts`` buffer, so a row's counts set before a replay (device ops,
    stream-ordered) are the ones it reads.  The automaton stacks are read
    in place the same way: a graph closes over the batcher's buffer of the
    stack's padded state count (the key carries that shape), and a stack
    rebuilt into it before a replay is the one the replay reads.
    ``eager`` runs the steps eagerly on CUDA too (a mesh whose collectives
    cannot be captured)."""
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              eos_id=eos_id, pad_id=pad_id)
    if (carry.shape[0] > CARRY_ROWS) != (mask_stack is not None):
        raise ValueError(
            "constrained decode needs both the automaton-state carry row "
            "and the mask/next stacks"
        )
    if not carry.is_cuda or eager:
        return _decode_steps(params, cfg, cache, carry, generator,
                             chunk_steps, tables=tables, temp_row=temp_row,
                             topp_row=topp_row, topk_row=topk_row,
                             counts=counts, pres_row=pres_row,
                             freq_row=freq_row, mask_stack=mask_stack,
                             next_stack=next_stack, **kw)
    if graphs is None:
        raise ValueError(
            "a decode chunk on CUDA tensors replays a captured graph; pass "
            "graphs (runtime.chunk_graph.ChunkGraphs)"
        )
    inputs = {"carry": carry}
    for name, t in (("tables", tables), ("temp_row", temp_row),
                    ("topp_row", topp_row), ("topk_row", topk_row),
                    ("pres_row", pres_row), ("freq_row", freq_row)):
        if t is not None:
            inputs[name] = t
    key = (chunk_steps, tuple(sorted(kw.items())), type(cache).__name__,
           cache.k.dtype, _weights_key(params),
           None if counts is None else ("counts", tuple(counts.shape)),
           # The stacks' buffer itself: a graph reads the one it closed
           # over, so another buffer of the same shape is another graph.
           None if mask_stack is None
           else ("constrain", tuple(mask_stack.shape), mask_stack.data_ptr(),
                 next_stack.data_ptr()),
           tuple((n, tuple(t.shape), t.dtype) for n, t in inputs.items()))

    def chunk(ins):
        return _decode_steps(params, cfg, cache, ins["carry"], generator,
                             chunk_steps, tables=ins.get("tables"),
                             temp_row=ins.get("temp_row"),
                             topp_row=ins.get("topp_row"),
                             topk_row=ins.get("topk_row"), counts=counts,
                             pres_row=ins.get("pres_row"),
                             freq_row=ins.get("freq_row"),
                             mask_stack=mask_stack, next_stack=next_stack,
                             **kw)

    carried = () if counts is None else (counts,)
    return graphs.run(key, chunk, inputs, generator, carried=carried)


def _spec_steps(params, cfg, draft_params, draft_cfg, cache, draft_cache,
                carry, generator, k, temperature=0.0, top_k=0, top_p=1.0,
                eos_id=-1, pad_id=0, tables=None, k_row=None, counts=None,
                pres_row=None, freq_row=None):
    """ONE speculative round for every slot, on the device with no host
    sync, each kernel launched from here (:func:`spec_chunk` replays them
    from a graph on the card) — the reference's ``spec_chunk``:

    - the draft: k single-token steps against its contiguous cache, row
      b's step j at slot ``real_lens[b] + j`` reading the prefix through
      it (the decode kernel's prefix contract: the reference's row masks
      are ``valid | [real_lens, idx]``, and ``valid`` is the prefix
      ``[0, real_lens)``);
    - the verify: one (k+1)-token target forward over ``[last_tok,
      d_1..d_k]`` — through the page tables (``tables``: one paged
      decode-attention launch a layer over B*(k+1) virtual rows) or the
      contiguous cache (dense, row b's query j masked to the prefix
      ``[0, real_lens + j]``);
    - the commit: greedy (temperature 0: the target's own argmax at every
      committed position, whatever the draft) or rejection sampling (``u_j < p_j(d_j) / q_j(d_j)``, the residual
      ``normalize(max(p - q, 0))`` at the first rejection, a bonus draw
      from p after k acceptances: the target's warped distribution,
      exactly), clamped by ``k_row`` [B] (acceptance stops at
      ``j < k_row``; the forced stop emits the target's own token);
    - the backfill: one draft step at :func:`~.speculative.backfill_coords`,
      the slot a fully accepted round left unwritten.

    ``counts``/``pres_row``/``freq_row`` engage the penalties: draft step j
    and verify position j penalize with the histogram plus the one-hots of
    ``d_1..d_j``, and the committed tokens are added to ``counts`` in
    place.  Random draws, in this order, from ``generator`` (sampled rounds
    only): each draft step's, the k uniforms, the residual's.  Logprobs
    are the target's raw log-softmax of each committed token.  Returns the
    packed round (:func:`unpack_chunk` with ``commits``)."""
    from .speculative import backfill_coords, commit_clamp, greedy_accept_commit

    last_tok, real_lens, active, budget = (carry[0], carry[1],
                                           carry[2].bool(), carry[3])
    b = last_tok.shape[0]
    dev = last_tok.device
    penalized = counts is not None
    sampled = temperature > 0.0

    def pen(logits, cnt):  # [B(, T), V] logits and int32 counts
        if not penalized:
            return logits
        extra = (1,) * (logits.dim() - 1)
        f = freq_row.reshape(-1, *extra)
        p = pres_row.reshape(-1, *extra)
        return (logits - f * cnt.to(logits.dtype)
                - p * (cnt > 0).to(logits.dtype))

    # -- the draft: k single-token steps, the histogram carried along.
    cnt = counts.clone() if penalized else None
    cur = last_tok
    drafts, qs = [], []
    for j in range(k):
        idx = real_lens + j
        logits, _ = model_lib.forward(
            draft_params, draft_cfg, cur[:, None], positions=idx[:, None],
            cache=draft_cache, cache_index=idx)
        step = pen(logits[:, 0], cnt)
        if sampled:
            warped = sampling.warp_logits(step, temperature, top_k, top_p)
            cur = sampling._categorical(generator, warped)
            qs.append(torch.softmax(warped, dim=-1))
        else:
            cur = sampling.greedy(step)
        if penalized:
            cnt.scatter_add_(1, cur.long()[:, None],
                             torch.ones_like(cur)[:, None])
        drafts.append(cur)
    drafts = torch.stack(drafts, dim=1)                       # [B, k]

    # -- the verify: one (k+1)-token target forward.
    vtoks = torch.cat([last_tok[:, None], drafts], dim=1)
    j_ar = torch.arange(k + 1, device=dev)
    vpos = real_lens[:, None] + j_ar[None, :]                 # [B, k+1]
    if tables is not None:
        vlogits, _ = model_lib.forward(params, cfg, vtoks, positions=vpos,
                                       cache=cache, cache_index=real_lens,
                                       kv_tables=tables)
    else:
        slots = torch.arange(cache.k.shape[2], device=dev)
        vmask = (slots[None, None, :] <= vpos[:, :, None])[:, None]
        vlogits, _ = model_lib.forward(params, cfg, vtoks, positions=vpos,
                                       cache=cache, cache_index=real_lens,
                                       attn_mask=vmask)
    if penalized:
        # Position j consumed [last_tok, d_1..d_j]: its histogram is the
        # base plus the one-hots of d_1..d_j.
        oneh = torch.zeros((b, k, counts.shape[1]), dtype=torch.int32,
                           device=dev).scatter_(2, drafts.long()[..., None], 1)
        c = torch.cat([torch.zeros_like(oneh[:, :1]),
                       torch.cumsum(oneh, dim=1, dtype=torch.int32)], dim=1)
        pen_v = pen(vlogits, counts[:, None, :] + c)
    else:
        pen_v = vlogits

    if sampled:
        ps = torch.softmax(
            sampling.warp_logits(pen_v, temperature, top_k, top_p), dim=-1)
        qs = torch.stack(qs, dim=1)                           # [B, k, V]
        di = drafts.long()[..., None]
        p_at = torch.gather(ps[:, :k], 2, di)[..., 0]
        q_at = torch.gather(qs, 2, di)[..., 0]
        u = torch.rand((b, k), generator=generator, device=dev)
        accept = u * torch.clamp(q_at, min=1e-20) < p_at
        if k_row is not None:
            # A forced stop at j == k_row with the draft distribution
            # zeroed past it: the "residual" there is p itself, a fresh
            # target sample, so the output distribution is unchanged.
            accept = accept & (j_ar[None, :k] < k_row[:, None])
        a = torch.cumprod(accept.to(torch.int32), dim=1).sum(
            dim=1, dtype=torch.int32)
        q_ext = torch.cat([qs, torch.zeros_like(ps[:, :1])], dim=1)
        if k_row is not None:
            q_ext = q_ext * (j_ar[None, :] < k_row[:, None]).to(
                q_ext.dtype)[..., None]
        ai = a.long()[:, None, None].expand(b, 1, ps.shape[-1])
        p_a = torch.gather(ps, 1, ai)[:, 0]
        q_a = torch.gather(q_ext, 1, ai)[:, 0]
        resid = torch.clamp(p_a - q_a, min=0.0)
        norm = resid.sum(dim=-1, keepdim=True)
        # p == q on the whole support leaves no residual: any draw from p.
        resid = torch.where(norm > 1e-9, resid / torch.clamp(norm, min=1e-9),
                            p_a)
        corr = sampling._categorical(
            generator, torch.where(resid > 0,
                                   torch.log(torch.clamp(resid, min=1e-30)),
                                   -torch.inf))
        cand = torch.where(j_ar[None, :] < a[:, None],
                           torch.cat([drafts, drafts[:, -1:]], dim=1),
                           corr[:, None]).to(torch.int32)
        m, has_eos = commit_clamp(cand, a, active, budget, eos_id, k)
    else:
        cand, m, has_eos, _ = greedy_accept_commit(
            drafts, sampling.greedy(pen_v), active, budget, eos_id, k,
            k_row=k_row)
    # Raw target log-softmax of each committed token: vlogits[:, j]
    # predicts the token committed at offset j.
    lps = torch.gather(torch.log_softmax(vlogits.float(), dim=-1), 2,
                       cand.long()[..., None])[..., 0]       # [B, k+1]
    committed = j_ar[None, :] < m[:, None]
    toks = torch.where(committed, cand, pad_id)
    if penalized:
        # Every committed token, EOS included (the plain chunk's rule).
        counts.scatter_add_(1, cand.long(), committed.to(torch.int32))
    new_last = torch.gather(cand, 1, torch.clamp(m - 1, min=0).long()[:, None])
    last_tok = torch.where(m > 0, new_last[:, 0], last_tok)
    real_lens = real_lens + m
    budget = budget - m
    active = active & ~has_eos & (budget > 0)
    # -- the backfill: the draft's KV at the slot a fully accepted round
    # left unwritten (one slot below the new frontier).
    bf_idx, bf_tok = backfill_coords(cand, m, real_lens)
    model_lib.forward(draft_params, draft_cfg, bf_tok[:, None],
                      positions=bf_idx[:, None], cache=draft_cache,
                      cache_index=bf_idx)
    return torch.cat([toks.reshape(-1), lps.reshape(-1).view(torch.int32), m,
                      last_tok, real_lens, active.to(torch.int32), budget])


def spec_chunk(params, cfg, draft_params, draft_cfg, cache, draft_cache,
               carry, generator, k, temperature=0.0, top_k=0, top_p=1.0,
               eos_id=-1, pad_id=0, tables=None, k_row=None, counts=None,
               pres_row=None, freq_row=None, graphs=None):
    """ONE speculative round (:func:`_spec_steps`) from ``carry`` [4, B]
    int32 over the target's page pool (``tables``) or contiguous cache
    and the draft's contiguous cache, both written in place.  Returns the
    packed round (:func:`unpack_chunk` with ``commits``).

    On CPU tensors the round runs eagerly.  On CUDA tensors it replays the
    captured graph of its plan in ``graphs``, keyed as
    :func:`decode_chunk`'s plus k, the draft's quantization and the draft
    cache's kind and shape; ``k_row`` is an input buffer, so every clamp
    value replays one graph, and ``counts`` is carried as in
    :func:`decode_chunk`.  A capture that fails raises."""
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p,
              eos_id=eos_id, pad_id=pad_id)
    if not carry.is_cuda:
        return _spec_steps(params, cfg, draft_params, draft_cfg, cache,
                           draft_cache, carry, generator, k, tables=tables,
                           k_row=k_row, counts=counts, pres_row=pres_row,
                           freq_row=freq_row, **kw)
    if graphs is None:
        raise ValueError(
            "a speculative round on CUDA tensors replays a captured graph; "
            "pass graphs (runtime.chunk_graph.ChunkGraphs)"
        )
    inputs = {"carry": carry}
    for name, t in (("tables", tables), ("k_row", k_row),
                    ("pres_row", pres_row), ("freq_row", freq_row)):
        if t is not None:
            inputs[name] = t
    key = ("spec", k, tuple(sorted(kw.items())), type(cache).__name__,
           cache.k.dtype, _weights_key(params), _weights_key(draft_params),
           type(draft_cache).__name__, tuple(draft_cache.k.shape),
           draft_cache.k.dtype,
           None if counts is None else ("counts", tuple(counts.shape)),
           tuple((n, tuple(t.shape), t.dtype) for n, t in inputs.items()))

    def round_(ins):
        return _spec_steps(params, cfg, draft_params, draft_cfg, cache,
                           draft_cache, ins["carry"], generator, k,
                           tables=ins.get("tables"), k_row=ins.get("k_row"),
                           counts=counts, pres_row=ins.get("pres_row"),
                           freq_row=ins.get("freq_row"), **kw)

    carried = () if counts is None else (counts,)
    return graphs.run(key, round_, inputs, generator, carried=carried)


def mixed_step(params, cfg, cache, carry, generator, chunk_steps, row_k,
               row_v, done, pchunk, pclen, graphs=None, **decode_kw):
    """ONE fused token-budget step (``schedule=mixed``): a bite of the head
    pending prefill (:func:`prefill_chunk_step`, launched eagerly: its offset
    ``done`` is a host int and its width varies) and then
    :func:`decode_chunk` for every slot, on one stream with no host sync
    between them.  The legs touch disjoint buffers (the transient row vs
    the shared cache), so fusion changes dispatch, never bytes.  Returns
    (packed decode output, row_k, row_v, last_logits [1, V])."""
    prow_k, prow_v, plast = prefill_chunk_step(params, cfg, row_k, row_v,
                                               done, pchunk, pclen)
    packed = decode_chunk(params, cfg, cache, carry, generator, chunk_steps,
                          graphs=graphs, **decode_kw)
    return packed, prow_k, prow_v, plast


@dataclass(eq=False)  # identity equality: deque.remove compares pointers
class _Request:
    rid: int
    ids: list[int]  # the full prompt (+ emitted prefix when resuming)
    max_new_tokens: int
    temperature: float | None = None  # None -> the batcher's config
    top_p: float | None = None
    top_k: int | None = None
    prefix_cache: bool = True  # per-request opt-out of AUTOMATIC caching
    digests: list | None = None  # memoized page digests (a back-pressured
    #   request retries admission every round; its prompt hash never changes)
    # Admission order is (priority desc, rid asc); higher priority is
    # preempted last.
    priority: int = 0
    # Absolute time.perf_counter() deadline: a request still QUEUED past it
    # is shed (results empty, shed[rid] set) instead of admitted doomed.
    deadline: float | None = None
    # Preemption-with-recompute state: tokens already emitted (and
    # streamed) in a previous residency; ``ids`` then holds prompt +
    # resume_emitted and the admission token continues the sequence.
    resume_emitted: list[int] | None = None
    resume_lps: list[float] | None = None
    # A registered prefix (register_prefix) whose KV seeds the row; ``ids``
    # holds only what follows it.
    prefix: str | None = None
    # OpenAI presence/frequency penalties over this request's own output.
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # Grammar-constrained output / logit bias / banned tokens: ONE compiled
    # token-mask automaton (constrain.TokenDFA) or None.  Its state is a
    # function of the emitted tokens, so a resume replays them.
    constraint: Any = None
    # Swap-preemption state (host tier): the victim's raw pages are parked
    # under ``swap_handle``; restore scatters them back and rebuilds the
    # row's scheduling state from ``swap_pages``/``swap_last_tok``/
    # ``swap_pos`` (no admission token: ``max_new_tokens`` already holds
    # the remaining budget).  A failed restore clears swap_handle and the
    # request takes the recompute path (``ids`` is prompt + emitted).
    swap_handle: int | None = None
    swap_pages: int = 0
    swap_last_tok: int = 0
    swap_pos: int = 0
    # Multi-tenant QoS (runtime/scheduler.py TenantScheduler): the tenant
    # this request bills against.  None = the anonymous bucket.  The
    # weighted-fair admission order, virtual token counters, and
    # resident-row caps all key on it; a preempted resume keeps it.
    tenant: str | None = None


@dataclass
class _Prefix:
    ids: list[int]
    k: Any  # [L, 1, S, KVH, HD] single-row KV holding the prefix
    v: Any


class PrefixCache:
    """Content-addressed index of pool pages for AUTOMATIC prefix caching:
    every FULL page of an admitted prompt is keyed by a chained content
    digest (a page's digest commits to every token before it), and later
    admissions reuse the longest cached page-run copy-free.  Refcounts live
    with the :class:`PagePool`; this class maps digests <-> pages and keeps
    the LRU of unreferenced pages whose content is still resident."""

    def __init__(self) -> None:
        self.by_hash: dict[bytes, int] = {}
        self.page_hash: dict[int, bytes] = {}
        self.lru: OrderedDict[int, None] = OrderedDict()  # oldest first
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.lookups = 0
        self.hits = 0
        self.evictions = 0

    @staticmethod
    def page_digests(ids: list[int], page_size: int, n_pages: int,
                     kv_bits: int = 16) -> list[bytes]:
        """Chained blake2b digests of the first ``n_pages`` full pages:
        digest_i = H(digest_{i-1} || int64 tokens of page i), seeded
        ``dlt-prefix-cache-v1`` (salted by the KV width off 16 bits) —
        byte-identical to the JAX package's, so digests compare across
        the two stacks."""
        digests: list[bytes] = []
        prev = (b"dlt-prefix-cache-v1" if kv_bits == 16
                else b"dlt-prefix-cache-v1:kv%d" % kv_bits)
        flat = np.asarray(ids[: n_pages * page_size], np.int64)
        for i in range(n_pages):
            h = hashlib.blake2b(prev, digest_size=16)
            h.update(flat[i * page_size: (i + 1) * page_size].tobytes())
            prev = h.digest()
            digests.append(prev)
        return digests

    def match(self, digests: list[bytes]) -> list[int]:
        """Pages of the longest cached run from the start (maybe empty)."""
        pages: list[int] = []
        for d in digests:
            p = self.by_hash.get(d)
            if p is None:
                break
            pages.append(p)
        return pages

    def register(self, page: int, digest: bytes) -> None:
        """Publish ``page`` as the holder of ``digest``; first writer wins."""
        if digest not in self.by_hash:
            self.by_hash[digest] = page
            self.page_hash[page] = digest

    def forget(self, page: int) -> None:
        """Drop a page's cache entry (eviction)."""
        d = self.page_hash.pop(page, None)
        if d is not None:
            self.by_hash.pop(d, None)
        self.lru.pop(page, None)

    def record_lookup(self, hit_tokens: int, miss_tokens: int) -> None:
        self.lookups += 1
        self.hits += hit_tokens > 0
        self.hit_tokens += hit_tokens
        self.miss_tokens += miss_tokens
        METRICS.inc("batcher.prefix_cache.lookups")
        if hit_tokens > 0:
            METRICS.inc("batcher.prefix_cache.hits")
        METRICS.inc("batcher.prefix_cache.hit_tokens", hit_tokens)
        METRICS.inc("batcher.prefix_cache.miss_tokens", miss_tokens)
        total = self.hit_tokens + self.miss_tokens
        if total:
            METRICS.set_gauge(
                "batcher.prefix_cache.hit_rate", self.hit_tokens / total
            )


class PagePool:
    """Refcounted KV page allocator.  Owns the free list and per-page
    refcounts and cooperates with an optional :class:`PrefixCache` whose
    LRU parks unreferenced-but-cached pages (still serving hits,
    reclaimable under pressure).  Page 0 is the permanent scratch page:
    never allocated, never freed, never read by a live row."""

    def __init__(self, num_pages: int,
                 prefix_cache: "PrefixCache | None" = None,
                 host_tier: "HostTier | None" = None) -> None:
        self.num_pages = num_pages
        # The host tier BEHIND the pool: the batcher spills eviction
        # candidates into it before alloc reclaims them and parks swapped
        # rows there.  The pool only audits and reports it; every data
        # move is the batcher's (no device call under the allocator lock).
        self.host_tier = host_tier
        # Mutation happens on the engine thread; the occupancy view
        # (stats/publish_gauges behind /metrics, the supervisor's audit)
        # reads from the serving loop thread.  The PrefixCache LRU is
        # covered by this lock too.
        self._lock = threading.Lock()
        self.free_pages: list[int] = list(range(1, num_pages))  # guarded-by: self._lock
        self.page_refs: dict[int, int] = {}  # guarded-by: self._lock
        self.prefix_cache = prefix_cache
        # Watermarks: the least headroom an admission has seen and the most
        # pages rows have held at once.
        self.min_available = num_pages - 1  # guarded-by: self._lock
        self.peak_held = 0  # guarded-by: self._lock

    # graftlint: holds(self._lock)
    def _note_watermarks(self) -> None:
        avail = self._available_locked()
        if avail < self.min_available:
            self.min_available = avail
        held = len(self.page_refs)
        if held > self.peak_held:
            self.peak_held = held

    def stats(self) -> dict[str, int]:
        """Occupancy snapshot (free / LRU-cached / row-held partition).
        Safe from any thread."""
        pc = self.prefix_cache
        with self._lock:
            return {
                "total_pages": self.num_pages - 1,  # page 0 is scratch
                "free_pages": len(self.free_pages),
                "cached_pages": len(pc.lru) if pc is not None else 0,
                "held_pages": len(self.page_refs),
                "min_available": self.min_available,
                "peak_held": self.peak_held,
            }

    def publish_gauges(self) -> None:
        """Mirror the occupancy view into METRICS (batcher_pool_*); the
        host tier's occupancy rides along as batcher_host_tier_*."""
        METRICS.set_gauges({
            f"batcher.pool.{k}": float(v) for k, v in self.stats().items()
        })
        if self.host_tier is not None:
            METRICS.set_gauges({
                f"batcher.host_tier.{k}": float(v)
                for k, v in self.host_tier.stats().items()
            })

    def eviction_candidates(self, n: int) -> list[tuple[int, bytes]]:
        """The (page, digest) pairs :meth:`alloc`\\ (n) would evict from
        the LRU, oldest first — the spill reads these BEFORE the alloc so
        their content can move to the host tier.  Engine thread only:
        nothing may mutate the pool between this and the alloc."""
        pc = self.prefix_cache
        with self._lock:
            if pc is None:
                return []
            m = max(0, n - len(self.free_pages))
            out: list[tuple[int, bytes]] = []
            for p in pc.lru:
                if len(out) >= m:
                    break
                out.append((p, pc.page_hash[p]))
            return out

    # graftlint: holds(self._lock)
    def _available_locked(self) -> int:
        pc = self.prefix_cache
        return len(self.free_pages) + (len(pc.lru) if pc else 0)

    def available(self) -> int:
        """Pages an admission could obtain: the free list plus every
        LRU-parked cached page (reclaimable under pressure)."""
        with self._lock:
            return self._available_locked()

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` pages at refcount 1, evicting LRU-cold cached
        pages when the free list runs dry (callers check available())."""
        pc = self.prefix_cache
        out: list[int] = []
        with self._lock:
            for _ in range(n):
                if self.free_pages:
                    p = self.free_pages.pop()
                else:
                    p, _ = pc.lru.popitem(last=False)  # the coldest entry
                    pc.forget(p)
                    pc.evictions += 1
                    METRICS.inc("batcher.prefix_cache.evicted_pages")
                self.page_refs[p] = 1
                out.append(p)
            self._note_watermarks()
        return out

    def retain(self, p: int) -> None:
        """Take a reference on a cached page (a prefix-cache hit)."""
        with self._lock:
            if p in self.page_refs:
                self.page_refs[p] += 1
            else:
                del self.prefix_cache.lru[p]
                self.page_refs[p] = 1
            self._note_watermarks()

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page.  At refcount 0 a cached page parks
        at the LRU's most-recently-used end; an uncached page frees."""
        pc = self.prefix_cache
        with self._lock:
            for p in pages:
                left = self.page_refs[p] - 1
                if left:
                    self.page_refs[p] = left
                    continue
                del self.page_refs[p]
                if pc is not None and p in pc.page_hash:
                    pc.lru[p] = None
                else:
                    self.free_pages.append(p)

    def publish_prefix(self, page: int, digest: bytes) -> None:
        """Publish a page's cached content under the allocator lock."""
        with self._lock:
            self.prefix_cache.register(page, digest)

    def assert_consistent(self, live_rows=(), swap_handles=()) -> None:
        """Audit the allocator's partition invariants; AssertionError on the
        first violation.  ``live_rows`` is the page lists of resident rows:
        per-page refcounts must EQUAL the row-hold counts.  With a host
        tier the audit spans it: ``swap_handles`` (those of queued resume
        requests) must own every parked parcel."""
        if self.host_tier is not None:
            self.host_tier.assert_consistent(swap_handles)
        pc = self.prefix_cache
        with self._lock:
            lru = set(pc.lru) if pc is not None else set()
            hashed = set(pc.page_hash) if pc is not None else set()
            free_list = list(self.free_pages)
            refs = dict(self.page_refs)
        free = set(free_list)
        refed = set(refs)
        assert len(free) == len(free_list), (
            f"free list holds duplicates: {sorted(free_list)}"
        )
        assert 0 not in (free | refed | lru), "scratch page 0 escaped the pool"
        for a, b, what in ((free, refed, "free and refcounted"),
                           (free, lru, "free and LRU-parked"),
                           (refed, lru, "refcounted and LRU-parked")):
            assert not (a & b), f"pages both {what}: {sorted(a & b)}"
        accounted = free | refed | lru
        expect = set(range(1, self.num_pages))
        assert accounted == expect, (
            f"pages leaked (neither free, refcounted, nor LRU-parked): "
            f"{sorted(expect - accounted)}; "
            f"foreign pages: {sorted(accounted - expect)}"
        )
        assert all(v >= 1 for v in refs.values()), (
            f"non-positive refcounts: {refs}"
        )
        holds: dict[int, int] = {}
        for pages in live_rows:
            for p in pages:
                holds[p] = holds.get(p, 0) + 1
        assert holds == refs, (
            f"refcounts diverge from live-row holds: refs={refs} "
            f"holds={holds}"
        )
        for p in lru:
            assert p in hashed, f"LRU-parked page {p} has no cached content"


@dataclass
class _PendingPrefill:
    """A chunked prefill in flight: the prompt enters the row's TRANSIENT
    single-row cache a bite per scheduling round (decode interleaves) and
    splices into the shared cache only when complete."""

    req: _Request
    row_k: Any          # transient [L, 1, S, KVH, HD] accumulating KV
    row_v: Any
    done: int           # prompt tokens already consumed (incl. cached ones
    #                     and a named prefix's)
    ids: list[int]      # the request's own ids (a named prefix pre-seeded)
    total_len: int
    last_logits: Any | None = None  # [1, V] after the latest bite
    # Automatic prefix-cache hit (paged mode): the cached page run seeding
    # the transient row, RETAINED for the whole prefill (mirrored into the
    # reserving row's ``pages`` so cancel / preemption release them); the
    # finishing splice routes their positions to the scratch page.
    cached_pages: list[int] = field(default_factory=list)
    cached_len: int = 0
    digests: list = field(default_factory=list)


@dataclass
class _RowState:
    rid: int | None = None
    prefilling: bool = False  # chunked prefill in flight: the slot is
    #                           reserved but must not publish or decode yet
    req: "_Request | None" = None  # as admitted — preemption rebuilds from it
    priority: int = 0   # mirror of req.priority (victim selection)
    admit_seq: int = 0  # among equal priorities the MOST recently admitted
    #                     row is preempted first (its lost work is smallest)
    emitted: list[int] = field(default_factory=list)
    lps: list[float] = field(default_factory=list)  # per-token logprobs
    remaining: int = 0  # decode tokens this row may still emit
    pages: list[int] = field(default_factory=list)  # pool pages held
    streamed: int = 0  # tokens already delivered to run()'s on_tokens


class ContinuousBatcher:
    """Slot-based continuous batching over a contiguous cache or a paged,
    prefix-cached pool.

    Usage::

        batcher = ContinuousBatcher(cfg, params, tokenizer, batch_slots=8,
                                    max_len=512, paged_pages=64,
                                    page_size=16, prefix_cache=True)
        rids = [batcher.submit(p, max_new_tokens=64) for p in prompts]
        results = batcher.run()   # {rid: token list}

    Runs on the device ``params`` live on.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        tokenizer: Any = None,
        batch_slots: int = 8,
        max_len: int = 512,
        chunk_steps: int = 8,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: int = -1,
        pad_id: int = 0,
        kv_dtype: Any = None,
        seed: int = 0,
        paged_pages: int | None = None,  # KV page-pool size (pages); None
        #   = contiguous mode (each slot owns a max_len-slot cache row)
        page_size: int = 64,
        prefix_cache: bool = False,  # automatic prefix caching (paged)
        # Speculative batching: every round drafts spec_k tokens a row
        # with the draft model and verifies them in ONE target forward;
        # temperature 0 commits the target's greedy tokens, temperature > 0
        # samples the target's distribution by rejection sampling.
        draft_params: Any = None,
        draft_cfg: ModelConfig | None = None,
        spec_k: int = 4,
        # Adaptive per-row spec_k downshift (greedy, schedule=mixed): a
        # row's acceptance EMA shortens its rounds; streams are unchanged.
        spec_adaptive_k: bool = True,
        # Dispatch-ahead engine loop: while no scheduling work is pending
        # (nothing queued, no prefill to finish, no growth under pressure,
        # no cancel), chunk N+1 dispatches from chunk N's carry on the
        # device while chunk N's host work runs.  Temp-0 outputs are
        # identical with it off.
        overlap: bool = True,
        # "mixed" fuses pending prefill bites into the decode step;
        # "alternate" runs them as serialized rounds (runtime/scheduler.py).
        schedule: str = "mixed",
        # Chunked prefill: a prompt longer than this prefills at most this
        # many tokens per round (None = monolithic admission), up to
        # ``prefill_concurrency`` prompts at once.
        prefill_chunk: int | None = None,
        prefill_concurrency: int = 2,
        # The mixed step's per-step token budget: one decode leg per live
        # row plus up to token_budget - n_active prompt tokens; set, it
        # also auto-chunks prompts longer than the budget.
        token_budget: int | None = None,
        kv_bits: int = 16,                 # 8 = int8 pool pages (paged)
        # Host-RAM KV tier behind the paged pool (pages of host RAM, one
        # pinned arena): swap preemption and prefix-cache spill.  0 = off.
        host_pages: int = 0,
        # The lockstep clock: the one time source scheduling DECISIONS may
        # consult (queue-deadline shedding).  Defaults to perf_counter.
        clock: "Callable[[], float] | None" = None,
        # Deterministic fault injection (runtime/faults.py FaultPlane): the
        # hot paths consult it at the reference's sites.  A respawn shares
        # it by reference, so a rule that fired stays fired.
        faults: Any = None,
        # Multi-tenant weighted-fair admission (runtime/scheduler.py
        # TenantScheduler): "gold:4,free:1"-style weights (or a parsed
        # dict) turn the mixed policy into per-tenant virtual-token-
        # counter fairness; submit(tenant=) bills each request against its
        # tenant's counter.  None keeps the tenant-blind policies.
        tenant_weights: "str | dict | None" = None,
        # Per-tenant RESIDENT-row cap: a tenant at the cap defers
        # admission (others admit past it).  None = uncapped.
        tenant_max_rows: int | None = None,
        # A data x tensor-parallel mesh (parallel.api.ParallelModel): params
        # are this rank's (ParallelModel.shard_params).
        parallel: Any = None,
    ) -> None:
        # Snapshot the constructor arguments FIRST so respawn() can rebuild
        # an identical fresh batcher after an engine crash.
        self._ctor_args = {
            k: v for k, v in locals().items() if k not in ("self", "__class__")
        }
        self._clock = clock if clock is not None else time.perf_counter
        self.faults = faults  # FaultPlane | None
        model_lib.check_supported(cfg)
        # The reference's checks, with its messages.
        if max_len > cfg.max_seq_len:
            raise ValueError(
                f"max_len {max_len} exceeds model max_seq_len {cfg.max_seq_len}"
            )
        if kv_bits not in (16, 8):
            raise ValueError(f"kv_bits must be 16 or 8, got {kv_bits}")
        if kv_bits == 8 and paged_pages is None:
            raise ValueError(
                "int8 KV pages live in the paged pool; pass paged_pages "
                "(contiguous caches stay full-width)"
            )
        if host_pages < 0:
            raise ValueError(f"host_pages must be >= 0, got {host_pages}")
        if host_pages and paged_pages is None:
            raise ValueError(
                "the host-RAM KV tier backs the paged pool; pass paged_pages"
            )
        if paged_pages is not None:
            if cfg.sliding_window is not None:
                raise ValueError(
                    "paged KV cannot serve sliding-window models (the paged "
                    "decode kernel attends the full cache prefix); use "
                    "contiguous mode, which serves windowed models through "
                    "the ragged kernel's window band"
                )
            if max_len % page_size:
                raise ValueError(
                    f"max_len {max_len} must be a multiple of page_size "
                    f"{page_size}"
                )
            if parallel is not None and not (
                parallel.pipelined or parallel.seq_parallel
            ):
                # The pool shards its KV-head axis over 'model'
                # (parallel.specs.page_pool_specs): each rank holds whole
                # heads, so the head count must divide.
                tp = parallel.mesh.size("model")
                if tp > 1 and cfg.num_kv_heads % tp:
                    raise ValueError(
                        f"paged KV on a tensor-parallel mesh shards the "
                        f"pool on the KV-head axis: num_kv_heads "
                        f"{cfg.num_kv_heads} must divide over 'model' "
                        f"({tp})"
                    )
            # Speculative rows hold scratch-TAIL pages past max_len: the
            # verify window writes up to spec_k + 1 slots past the row's
            # frontier (the contiguous cache's headroom slots, as pages).
            tail = spec_k + 1 if draft_params is not None else 0
            if paged_pages < -(-(max_len + tail) // page_size) + 1:
                raise ValueError(
                    f"paged_pages {paged_pages} cannot hold even one "
                    f"full-depth row (+1 scratch page)"
                )
        if parallel is not None:
            if parallel.pipelined or parallel.seq_parallel:
                raise ValueError(
                    "continuous batching supports pure data/tensor-parallel "
                    "meshes; pipelined (wavefront) and sequence-parallel "
                    "(ring) meshes bring their own decode schedules"
                )
            dp = parallel.mesh.size("data")
            if batch_slots % dp:
                raise ValueError(
                    f"batch_slots {batch_slots} must divide over the mesh "
                    f"'data' axis ({dp})"
                )
        self.speculative = draft_params is not None
        if self.speculative:
            if draft_cfg is None:
                raise ValueError("draft_params needs draft_cfg")
            if parallel is not None:
                raise ValueError(
                    "speculative batching runs single-device (contiguous "
                    "or paged); serve mesh engines through the plain "
                    "batcher — the draft/verify chain has no SPMD rule"
                )
            model_lib.check_supported(draft_cfg)
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}"
                )
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if prefill_chunk is not None:
                raise ValueError(
                    "chunked prefill does not compose with speculative "
                    "batching (the draft admission prefills the full "
                    "prompt monolithically)"
                )
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {prefill_chunk}"
            )
        if prefill_concurrency < 1:
            raise ValueError(
                f"prefill_concurrency must be >= 1, got "
                f"{prefill_concurrency}"
            )
        if prefix_cache and paged_pages is None:
            raise ValueError(
                "automatic prefix caching runs over the paged KV pool; "
                "pass paged_pages"
            )
        self.prefill_chunk = prefill_chunk
        self.prefill_concurrency = prefill_concurrency
        self.sched = make_scheduler(
            schedule, chunk_steps=chunk_steps, prefill_chunk=prefill_chunk,
            prefill_concurrency=prefill_concurrency,
            token_budget=token_budget, speculative=self.speculative,
            spec_adaptive=bool(spec_adaptive_k),
            tenant_weights=tenant_weights, tenant_max_rows=tenant_max_rows,
        )
        self._prefills: dict[int, _PendingPrefill] = {}  # slot -> pending
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        # Per-row acceptance-rate EMA (optimistic 1.0 at admission: a fresh
        # row drafts the full k) and cumulative accounting — functions of
        # the committed stream, so downshifts repeat run to run.
        self.spec_ema = np.ones((batch_slots,), np.float64)
        self.spec_stats = {
            "rounds": 0, "accepted": 0, "rejected": 0, "downshifts": 0,
        }
        # On a mesh the device work runs at the rank's local widths (its
        # heads, its MLP columns); ``model_cfg`` keeps the model's own.
        self.pm = parallel
        self.model_cfg = cfg
        if parallel is not None:
            cfg = parallel.local_cfg
            if kv_dtype is None and parallel.kv_dtype is not None:
                kv_dtype = parallel.kv_dtype
        self.cfg = cfg
        self.params = params
        self.device = params["embed"]["wte"].device
        # Lockstep journal (runtime/lockstep.py), armed by
        # enable_lockstep() when requests reach rank 0 only.
        self.lockstep: Lockstep | None = None
        # The decode loop: a captured graph replayed on CUDA, the eager
        # step loop on the CPU and on a mesh whose collectives run on gloo
        # (which a CUDA graph cannot capture).
        self.loop_kind = ("eager" if self.device.type != "cuda" or (
            parallel is not None and parallel.mesh.world_size > 1
            and parallel.mesh.backend != "nccl") else "graph")
        self.tokenizer = tokenizer
        self.b = batch_slots
        self.s = max_len
        self.chunk_steps = chunk_steps
        self.sampling = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.paged = paged_pages is not None
        self.kv_bits = kv_bits
        self.page_size = page_size
        self.prefix_cache: PrefixCache | None = None
        self.pool: PagePool | None = None
        self.tables: np.ndarray | None = None
        self.host_tier: HostTier | None = None
        # Speculative mode reserves k+1 HEADROOM slots past max_len: a
        # near-capacity row's verify window writes up to k+1 slots past
        # its frontier; they are never valid, only overwritten.
        cache_len = max_len + (spec_k + 1 if self.speculative else 0)
        self.draft_cache: KVCache | None = None
        if self.speculative:
            self.draft_cache = model_lib.init_cache(
                draft_cfg, batch_slots, cache_len, dtype=kv_dtype,
                device=self.device)
        if self.paged:
            self.cache = _paged_pool(cfg, paged_pages, page_size,
                                     dtype=kv_dtype, device=self.device,
                                     kv_bits=kv_bits)
            # A speculative table reaches past max_len by the k+1-token
            # window (the scratch tail); admissions address the first
            # max_len // page_size entries, as on a plain batcher.
            self.pages_per_row = -(-cache_len // page_size)
            if prefix_cache:
                self.prefix_cache = PrefixCache()
            if host_pages:
                # One arena of page slots, pinned when the pool is on the
                # card: allocated once, so parking never allocates.
                self.host_tier = HostTier(
                    host_pages, page_layout(self.cache),
                    pin=self.device.type == "cuda",
                )
            # Page 0 is the permanent scratch page: fixed-shape admissions
            # pad their page lists with it, and no live row ever reads it.
            self.pool = PagePool(paged_pages, prefix_cache=self.prefix_cache,
                                 host_tier=self.host_tier)
            self.tables = np.zeros((batch_slots, self.pages_per_row),
                                   np.int32)
        else:
            self.cache = model_lib.init_cache(cfg, batch_slots, cache_len,
                                              dtype=kv_dtype,
                                              device=self.device)
        # Scheduling state lives as HOST numpy mirrors, synced from the
        # device once per decode chunk.
        self.last_tok = np.zeros((batch_slots,), np.int32)
        self.real_lens = np.zeros((batch_slots,), np.int32)
        # Contiguous mode: the slots each row has written (the cache's
        # width, headroom included).  It is always a prefix [0, real_lens)
        # of a resident row — the contract the decode kernels read by
        # (lengths = real_lens + 1 after the step's write), and the masks
        # of a speculative round; _sync_carry checks it.
        self.valid = np.zeros((batch_slots, 0 if self.paged else cache_len),
                              bool)
        self.active = np.zeros((batch_slots,), bool)
        self.budget = np.zeros((batch_slots,), np.int32)
        # Per-row sampling mirrors: a row admitted with its own knobs
        # switches decode to the per-row sampling path while it is live.
        self.temp_row = np.full((batch_slots,), temperature, np.float32)
        self.topp_row = np.full((batch_slots,), top_p, np.float32)
        self.topk_row = np.full((batch_slots,), top_k, np.int32)
        self.pres_row = np.zeros((batch_slots,), np.float32)
        self.freq_row = np.zeros((batch_slots,), np.float32)
        # Constrained output: each constrained row's automaton state,
        # relative to its own automaton (synced from the carry at span
        # end; 0 for free rows).  ``_con_stack`` memoizes the span's stack
        # (key, padded state count, offsets) while the constraint mix is
        # unchanged; ``_con_bufs`` holds one device buffer pair per padded
        # state count, allocated once and rewritten in place, because the
        # decode graphs read the stack they closed over.
        self.dfa_row = np.zeros((batch_slots,), np.int32)
        self._con_stack: tuple | None = None
        self._con_bufs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # Output-token histogram [B, V] int32 on the device, allocated at
        # the first penalized admission (a server that never sees a penalty
        # pays nothing) and never replaced: the decode graphs carry it.
        self.tok_counts: torch.Tensor | None = None
        # Named prefixes (register_prefix): name -> its prefilled KV row.
        self.prefixes: dict[str, _Prefix] = {}
        self.rows = [_RowState() for _ in range(batch_slots)]
        # Decode forward steps dispatched (chunks x chunk_steps; one a
        # speculative round, its verify forward): every step runs each
        # layer's decode attention once.
        self.decode_steps = 0
        # Submission lock: the ONE cross-thread boundary of this class
        # (serving front-ends submit() from their own thread while the
        # engine thread admits).  Never held across a device call.
        self._lock = threading.Lock()
        self.queue: deque[_Request] = deque()  # guarded-by: self._lock
        # The KV handoff plane: verified transfers awaiting adoption
        # (digests, k pages, v pages, on_done) and cached-run exports
        # awaiting the engine (ids, on_done), queued by the serving loop
        # and drained by the engine thread at a round boundary.
        self._kv_imports: deque = deque()  # guarded-by: self._lock
        self._kv_exports: deque = deque()  # guarded-by: self._lock
        self.shed: dict[int, str] = {}  # rid -> reason, queued past deadline
        self.preemptions = 0
        self._admit_seq = 0
        self.results: dict[int, list[int]] = {}
        self.result_logprobs: dict[int, list[float]] = {}
        # Prompt tokens served from the prefix cache, per rid (usage
        # reporting: prompt_tokens_details.cached_tokens).
        self.prefix_cached_tokens: dict[int, int] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._next_rid = 0  # guarded-by: self._lock
        self._on_tokens = None  # set per run() call (streaming callback)
        # The decode chunks' CUDA graphs (runtime/chunk_graph.py): tied to
        # this cache and these weights, so they live and die with them.
        self._graphs = chunk_graph.ChunkGraphs()
        # Dispatch-ahead engine loop: per-batcher counters (mirrored into
        # METRICS as batcher.overlap.*).  ``_cancel_dirty`` flags a
        # resident-row cancel taken while the carry was on the device (the
        # next boundary must sync); ``_tables_dirty`` a table grown inside
        # a span; ``_t_complete`` when the host last saw a chunk complete
        # (the device-gap metric's reference point).
        self.overlap = bool(overlap)
        self.overlap_stats = {
            "chunks": 0, "dispatched_ahead": 0, "carry_syncs": 0,
            "host_lag_s": 0.0, "device_gap_s": 0.0, "gap_samples": 0,
        }
        self._cancel_dirty = False
        self._tables_dirty = False
        self._t_complete: float | None = None
        # True from a span's first dispatch to its carry sync: chunks may
        # be in flight and the mirrors stale.  Swap-out (a gather of a
        # victim's pages) happens only outside it.
        self._span_open = False

    # -- paged pool (PagePool: refcounted, prefix-cache LRU) ---------------

    @property
    def free_pages(self) -> list[int]:
        """The pool's free list (paged mode), forwarded as the reference's
        batcher does, so pool audits read it off the batcher."""
        return self.pool.free_pages

    @property
    def page_refs(self) -> dict[int, int]:
        return self.pool.page_refs

    def capacity_tokens(self) -> int:
        """KV capacity in tokens — the denominator of the serving gateway's
        cost gate.  Paged mode counts usable pool pages (page 0 is
        scratch); contiguous mode counts slot-owned width."""
        if self.paged:
            return (self.pool.num_pages - 1) * self.page_size
        return self.b * self.s

    def assert_pool_consistent(self) -> None:
        """Audit the page pool against the resident rows (no-op in
        contiguous mode), and the host tier against the queued resume
        requests: every swap parcel must be owned by exactly one of them."""
        if self.pool is not None:
            self.pool.assert_consistent(
                [r.pages for r in self.rows if r.pages],
                swap_handles=[
                    r.swap_handle for r in self.queue_snapshot()
                    if r.swap_handle is not None
                ],
            )

    def register_prefix(self, name: str, prefix: str | list[int]) -> None:
        """Prefill a shared prefix (e.g. a system prompt) ONCE; requests
        submitted with ``prefix=name`` reuse its KV instead of recomputing
        it — admission then prefills only the request's suffix."""
        ids = (
            self.tokenizer.encode(prefix)
            if isinstance(prefix, str)
            else list(prefix)
        )
        if len(ids) >= self.s:
            raise ValueError(
                f"prefix ({len(ids)} tokens) does not fit slot capacity {self.s}"
            )
        with self._on_mesh():
            _, row_cache = _prefill_row(
                self.params, self.cfg, _row_dtype_of(self.cache), self.s,
                self._dev(np.asarray(ids, np.int32)),
            )
        self.prefixes[name] = _Prefix(ids, row_cache.k, row_cache.v)

    # -- the mesh ---------------------------------------------------------

    def _on_mesh(self):
        """The mesh plan for the forwards of this block (a no-op off a
        mesh)."""
        return (self.pm.activate() if self.pm is not None
                else contextlib.nullcontext())

    def enable_lockstep(self) -> Lockstep:
        """Journal this mesh batcher's submissions and cancellations on
        rank 0 and broadcast them at every engine iteration
        (runtime/lockstep.py): for a front end that only rank 0 runs."""
        if self.pm is None:
            raise ValueError("lockstep serving needs a mesh batcher")
        self.lockstep = Lockstep(self.pm.mesh)
        return self.lockstep

    def _apply_event(self, ev: tuple) -> None:
        """Apply one journaled event on every rank (Lockstep.sync)."""
        kind = ev[0]
        if kind == "submit":
            req = ev[1]
            with self._lock:
                self._next_rid = max(self._next_rid, req.rid + 1)
                self.queue.append(req)
        elif kind == "cancel":
            self._cancel_now(ev[1])
        else:
            raise ValueError(f"unknown lockstep event {kind!r}")

    # -- the host tier (swap preemption, prefix-cache spill) ----------------

    def _alloc_pages(self, n: int) -> list[int]:
        """Pool allocation with the spill tier in front: any LRU-cached
        page this alloc would evict first has its content parked in the
        host tier (keyed by digest), so a later hit restores it instead of
        prefilling it again.  Best effort: a dry host budget degrades to
        plain eviction."""
        if (self.host_tier is not None and n
                and "evict_spill" in self.sched.pressure_rungs()):
            self._spill_cold_pages(n)
        return self.pool.alloc(n)

    def _spill_cold_pages(self, n: int) -> None:
        """ENGINE THREAD, just before an alloc(n): park the eviction
        candidates' raw pages in the host tier.  The gather and the copy
        to host RAM are enqueued here; the tier's worker thread waits for
        them.  Inside a span this runs behind the chunk in flight: an LRU
        page has refcount 0 and is published, and no decode step writes a
        published page (a row writes at ``real_lens``, past its full prompt
        pages; a released row's table is scratch from the next chunk on)."""
        cand = self.pool.eviction_candidates(n)
        if not cand or not self.host_tier.can_fit(1):
            # Saturated with swap parcels (never evicted for spills):
            # skip the gather park_spill would refuse.
            return
        rule = (self.faults.fire("kv.spill", tag="out")
                if self.faults is not None else None)
        if rule is not None and rule.action == "drop":
            return
        corrupt = rule is not None and rule.action == "corrupt"
        payload = _export_pages_raw(
            self.cache, self._dev(np.asarray([p for p, _ in cand], np.int32)))
        parked = self.host_tier.park_spill([d for _, d in cand], payload,
                                           corrupt=corrupt)
        if parked:
            METRICS.inc("batcher.host_tier.spilled_pages", parked)

    def _drop_req_swap(self, req: "_Request") -> None:
        """Free a queued resume request's swap parcel (cancel / shed:
        nothing will ever restore it)."""
        if req.swap_handle is not None and self.host_tier is not None:
            self.host_tier.drop_swap(req.swap_handle)
            req.swap_handle = None

    def _page_digests(self, ids: list[int], n_pages: int) -> list[bytes]:
        """This pool's content digests: chained over token ids AND the KV
        width (kv_bits salts the chain), so an int8 page can never alias
        a bf16 page."""
        return PrefixCache.page_digests(ids, self.page_size, n_pages,
                                        kv_bits=self.kv_bits)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A device copy of a host array: on CUDA through pinned memory
        without a host sync (the pinned block is not reused before the
        copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- KV handoff (disaggregated prefill/decode, cross-replica pull) ------

    def export_prefix_pages(
        self, ids: list[int]
    ) -> "tuple[list[bytes], torch.Tensor, torch.Tensor] | None":
        """ENGINE THREAD: gather the prompt's longest cached full-page run
        out of the pool for handoff to another engine.  Returns (chained
        page digests, k pages [L, P, BLK, KVH, HD], v pages) as host
        tensors at the pool's row dtype (an int8 pool dequantizes), or None
        when nothing exportable is resident (prompt shorter than a page,
        caching off, or the run was evicted).  The run is capped one page
        short of the prompt, as the importer's matcher caps hits.  Pages
        are retained across the gather so pool pressure cannot reclaim
        them mid-export."""
        pc = self.prefix_cache
        if self.pool is None or pc is None:
            return None
        blk = self.page_size
        n = (len(ids) - 1) // blk
        if n < 1:
            return None
        digests = self._page_digests(ids, n)
        pages = pc.match(digests)
        if not pages:
            return None
        for p in pages:
            self.pool.retain(p)
        try:
            row_k, row_v = _gather_row_pages(
                self.cache, self._dev(np.asarray(pages, np.int32)))
            l, _one, _w, kvh, hd = row_k.shape
            k = row_k.reshape(l, len(pages), blk, kvh, hd).cpu()
            v = row_v.reshape(l, len(pages), blk, kvh, hd).cpu()
        finally:
            self.pool.release(pages)
        METRICS.inc("batcher.kv_pages_exported", len(pages))
        return digests[: len(pages)], k, v

    def has_kv_imports(self) -> bool:
        """Whether a verified handoff awaits adoption (any thread)."""
        with self._lock:
            return bool(self._kv_imports)

    def submit_kv_import(self, digests: list[bytes], k_pages, v_pages,
                         on_done) -> None:
        """Queue a VERIFIED transfer's pages for adoption (any thread: the
        server's KV listener calls this from the event loop).  The engine
        thread applies it at its next round boundary and calls
        ``on_done(ok, reason)`` from there; the caller wakes the engine."""
        with self._lock:
            self._kv_imports.append((digests, k_pages, v_pages, on_done))

    def _drain_kv_imports(self) -> None:
        """ENGINE THREAD, at a round boundary: adopt every queued handoff.
        Device work and pool bookkeeping happen outside the submission
        lock."""
        while True:
            with self._lock:
                if not self._kv_imports:
                    return
                digests, k_pages, v_pages, on_done = \
                    self._kv_imports.popleft()
            ok, reason = self._import_kv_pages(digests, k_pages, v_pages)
            try:
                on_done(ok, reason)
            except Exception:
                log.exception("kv-import completion callback raised")

    def has_kv_exports(self) -> bool:
        """Whether a cached-run export awaits the engine (any thread)."""
        with self._lock:
            return bool(self._kv_exports)

    def submit_kv_export(self, ids: list[int], on_done) -> None:
        """Queue a cached-run export for the engine thread (any thread: the
        server's /v1/kv_export handler).  The engine gathers the prompt's
        longest cached run at its next round boundary and calls
        ``on_done(payload_or_None)`` (the :meth:`export_prefix_pages`
        result) from there; the caller wakes the engine."""
        with self._lock:
            self._kv_exports.append((list(ids), on_done))

    def _drain_kv_exports(self) -> None:
        """ENGINE THREAD, at a round boundary: serve every queued export —
        a cache read; nothing is admitted and no row changes."""
        while True:
            with self._lock:
                if not self._kv_exports:
                    return
                ids, on_done = self._kv_exports.popleft()
            payload = self.export_prefix_pages(ids)
            try:
                on_done(payload)
            except Exception:
                log.exception("kv-export completion callback raised")

    def _import_kv_pages(self, digests, k_pages, v_pages):
        """Adopt one transfer: allocate pool pages, scatter the payload,
        publish the digests and park the pages in the prefix-cache LRU,
        content-addressed and unreferenced like a finished local prompt's
        pages; the handed-off request's admission then hits them.
        Idempotent: digests already resident ack "duplicate" without
        touching the pool, and only the missing pages of a partial overlap
        are imported."""
        pc = self.prefix_cache
        if self.pool is None or pc is None:
            return False, "not a decode-role engine"
        l, _nb, blk, kvh, hd = self.cache.k.shape
        if (tuple(k_pages.shape) != (l, len(digests), blk, kvh, hd)
                or tuple(v_pages.shape) != tuple(k_pages.shape)):
            return False, "pool shape mismatch"
        missing = [i for i, d in enumerate(digests) if d not in pc.by_hash]
        if not missing:
            return True, "duplicate"
        if self.pool.available() < len(missing):
            return False, "no capacity"
        sel = torch.tensor(missing, dtype=torch.long)
        dt = _row_dtype_of(self.cache)
        pages = self._alloc_pages(len(missing))
        try:
            self.cache = _import_pages(
                self.cache, self._dev(np.asarray(pages, np.int32)),
                k_pages[:, sel].to(device=self.device, dtype=dt),
                v_pages[:, sel].to(device=self.device, dtype=dt),
            )
            for p, i in zip(pages, missing):
                # First writer wins: a digest published since the scan
                # above leaves ours private (it frees on the release).
                self.pool.publish_prefix(p, digests[i])
        finally:
            self.pool.release(pages)
        METRICS.inc("batcher.kv_pages_imported", len(pages))
        log.info("imported %d handed-off KV page(s) (%d already resident)",
                 len(pages), len(digests) - len(pages))
        return True, "imported"

    # -- crash recovery ----------------------------------------------------

    def respawn(self) -> "ContinuousBatcher":
        """A fresh batcher from this one's construction arguments: new pool
        and prefix cache, empty queue and rows.  Weights and tokenizer carry
        over by reference."""
        return ContinuousBatcher(**self._ctor_args)

    def quiesce(self) -> None:
        """Wait until every device operation this batcher enqueued has
        run (a no-op on the CPU).  The server calls it on the engine thread
        before the batcher is dropped (stop, kill, a crash's respawn), so
        no replay or copy of a dead batcher can write into memory the
        caching allocator has handed to a successor."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- submission --------------------------------------------------------

    @property
    def next_rid(self) -> int:
        """The rid the next ``submit`` call will return (serving front-ends
        register delivery state under it BEFORE submitting)."""
        with self._lock:
            return self._next_rid

    def has_queued(self) -> bool:
        with self._lock:
            return bool(self.queue)

    def queue_snapshot(self) -> "list[_Request]":
        with self._lock:
            return list(self.queue)

    def submit(
        self, prompt: str | list[int], max_new_tokens: int = 32,
        prefix: str | None = None, temperature: float | None = None,
        top_p: float | None = None, top_k: int | None = None,
        presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
        prefix_cache: bool = True, priority: int = 0,
        deadline: float | None = None,
        response_format: dict | None = None,
        logit_bias: dict | None = None,
        banned_tokens: list[int] | None = None,
        constraint: Any = None,
        tenant: str | None = None,
    ) -> int:
        """Queue a request; the same validation as the JAX batcher.
        ``prefix`` names a registered prefix whose KV seeds the row;
        ``temperature``/``top_p``/``top_k`` override the batcher's sampling
        config for this request; ``presence_penalty``/``frequency_penalty``
        (OpenAI semantics, [-2, 2]) adjust the logits against the
        request's own output; ``prefix_cache=False`` opts it out of
        automatic prefix caching; ``priority`` orders admission and shields
        from preemption; ``deadline`` (absolute perf_counter) sheds it if
        still queued past it.  ``response_format`` (``{"type":
        "json_schema", "json_schema": {...}}`` or ``{"type": "regex",
        "regex": ...}``) constrains the output to a grammar, and
        ``logit_bias`` (token id -> [-100, 100]) / ``banned_tokens`` ride
        the same token-mask automaton (runtime/constrain.py, LRU-cached);
        ``constraint`` is one the caller already compiled (the gateway
        compiles off its event loop).  A malformed constraint raises
        :class:`~.constrain.ConstraintError` (a ValueError) before
        anything is queued.  ``tenant`` names the tenant the request bills
        against (weighted-fair admission; None = the anonymous bucket)."""
        ids = (
            self.tokenizer.encode(prompt)
            if isinstance(prompt, str)
            else list(prompt)
        )
        if not ids:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature is not None and not (
            math.isfinite(temperature) and temperature >= 0.0
        ):
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        # A speculative round warps target and draft with ONE engine-wide
        # config (the rejection test compares the two distributions), so
        # per-request overrides are refused (the gateway answers 400).
        if (self.speculative and temperature is not None
                and temperature != self.sampling["temperature"]):
            raise ValueError(
                "speculative batching samples with the engine-wide "
                f"temperature ({self.sampling['temperature']}); per-request "
                "overrides are not supported"
            )
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if (self.speculative and top_p is not None
                and top_p != self.sampling["top_p"]):
            raise ValueError(
                "speculative batching samples with the engine-wide top_p "
                f"({self.sampling['top_p']}); per-request overrides are "
                "not supported"
            )
        if top_k is not None:
            if isinstance(top_k, bool) or not isinstance(top_k, int) \
                    or not 0 <= top_k <= 2**31 - 1:
                raise ValueError(
                    f"top_k must be an int in [0, 2**31), got {top_k!r}"
                )
            if self.speculative and top_k != self.sampling["top_k"]:
                raise ValueError(
                    "speculative batching samples with the engine-wide "
                    f"top_k ({self.sampling['top_k']}); per-request "
                    "overrides are not supported"
                )
            eff_t = (self.sampling["temperature"] if temperature is None
                     else temperature)
            if eff_t == 0.0:
                # A greedy row takes the argmax regardless of top_k.
                top_k = None
        if not isinstance(prefix_cache, bool):
            raise ValueError(
                f"prefix_cache must be a bool, got {prefix_cache!r}"
            )
        if isinstance(priority, bool) or not isinstance(priority, int) \
                or not -(2**31) <= priority < 2**31:
            raise ValueError(
                f"priority must be an int in [-2**31, 2**31), got {priority!r}"
            )
        if tenant is not None and (
            not isinstance(tenant, str) or not tenant or len(tenant) > 64
        ):
            raise ValueError(
                f"tenant must be a non-empty string of <= 64 chars, "
                f"got {tenant!r}"
            )
        if deadline is not None:
            if isinstance(deadline, bool) \
                    or not isinstance(deadline, (int, float)) \
                    or not math.isfinite(float(deadline)):
                raise ValueError(
                    f"deadline must be a finite perf_counter timestamp, "
                    f"got {deadline!r}"
                )
            deadline = float(deadline)
        for name, pen in (("presence_penalty", presence_penalty),
                          ("frequency_penalty", frequency_penalty)):
            if not -2.0 <= pen <= 2.0:  # also rejects NaN/inf
                raise ValueError(f"{name} must be in [-2, 2], got {pen}")
        if (response_format is not None or logit_bias is not None
                or banned_tokens is not None or constraint is not None):
            if self.speculative:
                raise ValueError(
                    "speculative batching does not support constrained or "
                    "biased sampling (response_format/logit_bias/"
                    "banned_tokens) yet — the draft/verify chain would "
                    "need the mask on both models; serve constrained "
                    "traffic through a plain engine"
                )
            if constraint is None:
                constraint = constrain_lib.compile_request(
                    response_format, logit_bias, banned_tokens,
                    tokenizer=self.tokenizer,
                    vocab_size=self.cfg.vocab_size, eos_id=self.eos_id,
                )
        pfx_len = 0
        if prefix is not None:
            if prefix not in self.prefixes:
                raise KeyError(
                    f"unknown prefix {prefix!r} (register_prefix first)")
            pfx_len = len(self.prefixes[prefix].ids)
        if pfx_len + len(ids) + max_new_tokens > self.s:
            raise ValueError(
                f"prompt ({pfx_len}+{len(ids)} tokens) + {max_new_tokens} "
                f"new exceeds slot capacity {self.s}"
            )
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            req = _Request(
                rid, ids, max_new_tokens, prefix=prefix,
                temperature=temperature, top_p=top_p, top_k=top_k,
                presence_penalty=float(presence_penalty),
                frequency_penalty=float(frequency_penalty),
                constraint=constraint,
                prefix_cache=prefix_cache, priority=priority,
                deadline=deadline, tenant=tenant,
            )
            if self.lockstep is None:
                self.queue.append(req)
        if self.lockstep is not None:
            # Every rank queues it at the next engine iteration.
            self.lockstep.record(("submit", req))
        return rid

    def cancel_row(self, rid: int) -> bool:
        """Cancel a submitted request: a queued one is dropped, an admitted
        row is deactivated and its pages released.  ``results[rid]``
        records the committed tokens and NO done callback fires.  Call from
        ``run()``'s ``on_tokens`` callback or while ``run()`` is idle.
        Returns True if the rid was found queued or resident.  Under
        lockstep the cancellation is journaled and lands on every rank at
        the next engine iteration."""
        if self.lockstep is not None:
            with self._lock:
                known = any(r.rid == rid for r in self.queue) or any(
                    ev[0] == "submit" and ev[1].rid == rid
                    for ev in self.lockstep.pending())
            if known or any(r.rid == rid for r in self.rows):
                self.lockstep.record(("cancel", rid))
                return True
            return False
        return self._cancel_now(rid)

    def _cancel_now(self, rid: int) -> bool:
        dropped: _Request | None = None
        with self._lock:
            for req in self.queue:
                if req.rid == rid:
                    dropped = req
                    break
            if dropped is not None:
                self.queue.remove(dropped)
        if dropped is not None:
            # A swap-preempted request also frees its host parcel: nothing
            # will ever restore it (the tier audit would catch the leak).
            self._drop_req_swap(dropped)
            self.results[rid] = list(dropped.resume_emitted or [])
            self.result_logprobs[rid] = list(dropped.resume_lps or [])
            METRICS.inc("batcher.cancelled")
            return True
        for i in range(self.b):
            row = self.rows[i]
            if row.rid == rid:
                if self.eos_id >= 0 and self.eos_id in row.emitted:
                    cut = row.emitted.index(self.eos_id) + 1
                    row.emitted = row.emitted[:cut]
                    row.lps = row.lps[:cut]
                self.results[rid] = row.emitted
                self.result_logprobs[rid] = row.lps
                if row.pages:
                    self.pool.release(row.pages)
                    self.tables[i] = 0
                    self._tables_dirty = True
                # A chunked prefill in flight drops its transient row:
                # nothing reached the shared cache yet.
                self._prefills.pop(i, None)
                if row.req is not None:
                    self.sched.note_freed(row.req, len(row.emitted))
                self.rows[i] = _RowState()
                self.active[i] = False
                self.budget[i] = 0
                # With the carry on the device (a span dispatching ahead)
                # the device still runs this row: the next chunk boundary
                # must sync, so the cancel lands there as it does on the
                # synchronous loop.
                self._cancel_dirty = True
                METRICS.inc("batcher.cancelled")
                return True
        return False

    # -- scheduling loop ---------------------------------------------------

    def _free_slot(self) -> int | None:
        for i in range(self.b):
            if not self.active[i] and self.rows[i].rid is None:
                return i
        return None

    def _next_request(self) -> "_Request | None":
        with self._lock:
            return self.sched.admission_order(self.queue)

    def _unqueue(self, req: "_Request") -> None:
        """The ONE admission-commit point."""
        with self._lock:
            self.queue.remove(req)
        self.sched.note_admitted(req, len(req.ids) + req.max_new_tokens)

    def _shed_expired_queued(self) -> None:
        """Drop queued requests whose deadline already passed (a preempted
        one finishes with the tokens it already streamed).  Reads the
        injected lockstep clock, never the wall clock directly.  A mesh
        batcher skips it, as the reference does: its ranks' clocks
        differ, and a decision must be the same on every rank."""
        if self.pm is not None:
            return
        now = self._clock()
        expired: list[_Request] = []
        with self._lock:
            for req in list(self.queue):
                if req.deadline is None or req.deadline > now:
                    continue
                self.queue.remove(req)
                expired.append(req)
        for req in expired:
            self._drop_req_swap(req)
            self.results[req.rid] = list(req.resume_emitted or [])
            self.result_logprobs[req.rid] = list(req.resume_lps or [])
            if req.resume_emitted:
                METRICS.inc("batcher.cancelled")
                log.info(
                    "finished preempted request %d at deadline with %d "
                    "token(s)", req.rid, len(req.resume_emitted),
                )
            else:
                self.shed[req.rid] = "queue deadline expired before admission"
                METRICS.inc("batcher.shed_total")
                log.info("shed queued request %d (deadline expired)", req.rid)
            if self._on_tokens is not None:
                self._on_tokens(req.rid, [], True, None)

    # -- overload plane: preemption + on-demand growth ---------------------

    def _pick_victim(self, below_priority: int | None = None) -> int | None:
        """The scheduler's ``select_victim`` over active page-holding rows."""
        cands = [
            (i, r.priority, r.admit_seq) for i, r in enumerate(self.rows)
            if r.rid is not None and r.pages and self.active[i]
        ]
        return self.sched.select_victim(cands, below_priority=below_priority)

    def _preempt_row(self, i: int, reason: str) -> None:
        """Preempt resident row ``i``: free its pages now, keep the tokens it
        emitted, and requeue it.  With the host tier its raw pages swap out
        and its resume scatters them back; otherwise (or when the tier
        cannot take them) the resume RECOMPUTES — it prefills prompt +
        emitted prefix (cheap while the prefix cache still holds the
        prompt pages) and its admission token continues the sequence.
        Either way temperature-0 streams stay exact."""
        if self.faults is not None:
            # Injection site "batcher.preempt": one hit per preemption,
            # before the victim's pages are freed.
            self.faults.fire("batcher.preempt")
        row = self.rows[i]
        req = row.req
        if self._prefills.pop(i, None) is not None or row.prefilling:
            # A chunked prefill in flight: nothing reached the pool yet —
            # drop the transient row and requeue the request as it was.
            resume = req
        else:
            prior = list(req.resume_emitted or [])
            base_ids = (req.ids[: len(req.ids) - len(prior)] if prior
                        else req.ids)
            resume = _Request(
                req.rid, list(base_ids) + list(row.emitted),
                max(1, row.remaining), prefix=req.prefix,
                temperature=req.temperature, top_p=req.top_p,
                top_k=req.top_k, presence_penalty=req.presence_penalty,
                frequency_penalty=req.frequency_penalty,
                constraint=req.constraint,
                prefix_cache=req.prefix_cache, priority=req.priority,
                deadline=req.deadline, tenant=req.tenant,
                resume_emitted=list(row.emitted),
                resume_lps=list(row.lps),
            )
            # The swap rung is the scheduler's to declare: a policy
            # without it sends every victim to exact recompute.
            handle = (self._swap_out_row(i, row)
                      if "swap_preempt" in self.sched.pressure_rungs()
                      else None)
            if handle is not None:
                resume.swap_handle = handle
                resume.swap_pages = len(row.pages)
                resume.swap_last_tok = int(self.last_tok[i])
                resume.swap_pos = int(self.real_lens[i])
        freed = len(row.pages)
        if row.pages:
            self.pool.release(row.pages)
            self.tables[i] = 0
        self.sched.note_freed(req, len(row.emitted))
        self.rows[i] = _RowState()
        self.active[i] = False
        self.budget[i] = 0
        with self._lock:
            self.queue.append(resume)
        self.preemptions += 1
        METRICS.inc("batcher.preemptions_total")
        log.info(
            "preempted rid %d from slot %d (%s): freed %d page(s), %d "
            "token(s) kept for %s", resume.rid, i, reason, freed,
            len(resume.resume_emitted or []),
            "swap restore" if resume.swap_handle is not None else "recompute",
        )

    def _swap_out_row(self, i: int, row: "_RowState") -> int | None:
        """Park resident row ``i``'s raw pages in the host tier (swap
        preemption).  Returns the parcel handle, or None to fall back to
        exact recompute (no tier, or its budget cannot fit the row).  The
        gather and the copy to host RAM are enqueued on the stream after
        the last chunk that wrote the row (preemption runs only at a sync
        point) and before any admission scatter into the freed pages."""
        tier = self.host_tier
        if tier is None or not row.pages:
            return None
        assert not self._span_open, "swap-out inside a decode span"
        rule = (self.faults.fire("kv.swap_out")
                if self.faults is not None else None)
        corrupt = False
        if rule is not None:
            if rule.action == "drop":
                METRICS.inc("batcher.kv_swaps.fallback")
                return None
            corrupt = rule.action == "corrupt"
        if not tier.can_fit(len(row.pages)):
            METRICS.inc("batcher.kv_swaps.fallback")
            return None
        payload = _export_pages_raw(
            self.cache, self._dev(np.asarray(row.pages, np.int32)))
        handle = tier.park_swap(payload, len(row.pages), corrupt=corrupt)
        if handle is None:
            METRICS.inc("batcher.kv_swaps.fallback")
            return None
        METRICS.inc("batcher.kv_swaps.out")
        return handle

    def _set_count_row(self, i: int, tokens: list[int]) -> None:
        """Row ``i`` of the penalty histogram := the counts of ``tokens``
        (every token the request has emitted), by device ops enqueued
        before the next chunk; the histogram never visits the host."""
        if self.tok_counts is None:
            self.tok_counts = torch.zeros((self.b, self.cfg.vocab_size),
                                          dtype=torch.int32,
                                          device=self.device)
        row = self.tok_counts[i]
        row.zero_()
        idx = self._dev(np.asarray(tokens, np.int64))
        row.index_put_((idx,), torch.ones_like(idx, dtype=torch.int32),
                       accumulate=True)

    def _try_restore_swapped(self, i: int, req: "_Request") -> bool | None:
        """Restore a swap-preempted request into free slot ``i``: its parked
        raw pages scatter back into fresh pool pages, with no model call
        and no token sampled — the row's scheduling state is rebuilt and
        decode continues from ``swap_last_tok``, so the stream equals the
        never-preempted run's at either KV width.

        Returns True on restore, False after degrading the request to
        exact recompute (parcel dropped, missing or corrupted: swap_handle
        cleared, the request stays queued), None on back-pressure (nothing
        consumed; the caller stops admitting this round)."""
        tier = self.host_tier
        rule = (self.faults.fire("kv.swap_in")
                if self.faults is not None else None)
        if rule is not None and rule.action == "drop":
            tier.drop_swap(req.swap_handle)
            req.swap_handle = None
            METRICS.inc("batcher.kv_swaps.fallback")
            log.warning("swap restore for rid %d dropped; recomputing",
                        req.rid)
            return False
        corrupt = rule is not None and rule.action == "corrupt"
        n = req.swap_pages
        if not self._ensure_pages(n, "admit", below_priority=req.priority):
            return None  # the parcel stays parked; retry next round
        parcel = tier.take_swap(req.swap_handle, corrupt=corrupt)
        req.swap_handle = None
        if parcel is None:
            METRICS.inc("batcher.kv_swaps.fallback")
            log.warning("swap restore for rid %d failed verification; "
                        "recomputing", req.rid)
            return False
        self._unqueue(req)
        # Read the freed slots BEFORE the alloc: its spill may park into
        # them (on the card the two copies are stream-ordered).
        arrays = parcel.to(self.device)
        # Table first, allocation last: nothing between the pool handing
        # out pages and the row table owning them may raise.
        page_list = np.zeros((self.pages_per_row,), np.int32)
        pages = self._alloc_pages(n)
        page_list[:n] = pages
        self.tables[i] = page_list
        self._tables_dirty = True
        self.cache = _import_pages_raw(
            self.cache, self._dev(np.asarray(pages, np.int32)), *arrays)
        req_t, req_p, req_k, _ = self._request_sampling(req)
        self.temp_row[i] = req_t
        self.topp_row[i] = req_p
        self.topk_row[i] = req_k
        self.pres_row[i] = req.presence_penalty
        self.freq_row[i] = req.frequency_penalty
        emitted = list(req.resume_emitted or [])
        if req.presence_penalty or req.frequency_penalty:
            # The histogram must see every token this request emitted
            # across residencies, as the recompute resume rebuilds it.
            self._set_count_row(i, emitted)
        # The automaton state is a function of the emitted tokens: the
        # replay puts the restored row under the masks the unpreempted
        # run would have seen.
        self.dfa_row[i] = (req.constraint.advance(0, emitted)
                           if req.constraint is not None else 0)
        if self.speculative:
            # The draft is never swapped: one KV-only prefill of the first
            # swap_pos tokens (the slots the target's parcel holds) rebuilds
            # its row.
            pfx = self.prefixes[req.prefix] if req.prefix is not None else None
            self._seed_draft(i, (pfx.ids if pfx else []) + req.ids,
                             req.swap_pos)
        self.last_tok[i] = req.swap_last_tok
        self.real_lens[i] = req.swap_pos
        self.active[i] = True
        # No admission token on a swap restore: max_new_tokens IS the
        # remaining budget (set by _preempt_row from row.remaining).
        self.budget[i] = req.max_new_tokens
        self._admit_seq += 1
        self.rows[i] = _RowState(
            rid=req.rid, emitted=emitted, lps=list(req.resume_lps or []),
            remaining=req.max_new_tokens, pages=pages, req=req,
            priority=req.priority, admit_seq=self._admit_seq,
            streamed=len(emitted),
        )
        METRICS.inc("batcher.kv_swaps.in")
        log.info("restored swapped rid %d into slot %d (%d page(s))",
                 req.rid, i, n)
        return True

    def _ensure_pages(self, need: int, tag: str,
                      below_priority: int | None = None,
                      self_slot: int | None = None) -> bool:
        """THE pressure loop (admission and growth): fire the
        ``batcher.page_alloc`` site (tag ``admit`` or ``grow``; an
        ``exhaust`` rule makes the pool look dry), then preempt victims
        until available() covers ``need``.  ``below_priority`` restricts
        victims to STRICTLY lower priority (admission); ``self_slot`` lets
        the grower itself yield when no other victim exists.  Returns True
        when ``need`` pages are obtainable (the caller allocs)."""
        rule = (self.faults.fire("batcher.page_alloc", tag=tag)
                if self.faults is not None else None)
        avail = (0 if rule is not None and rule.action == "exhaust"
                 else self.pool.available())
        while avail < need:
            v = self._pick_victim(below_priority=below_priority)
            if v is None:
                if self_slot is None:
                    return False
                v = self_slot  # no other victim: the grower itself yields
            self._preempt_row(
                v, "admission" if below_priority is not None else "growth"
            )
            if v == self_slot:
                return False
            avail = self.pool.available()
        return True

    def _host_restorable(self, digests: list[bytes], start: int,
                         cap: int) -> list[bytes]:
        """The consecutive digest run PAST the device-cached run whose
        pages are parked in the host spill tier."""
        if self.host_tier is None:
            return []
        out: list[bytes] = []
        for d in digests[start:cap]:
            if not self.host_tier.has_spill(d):
                break
            out.append(d)
        return out

    def _match_tiered(self, digests: list[bytes], cap: int,
                      n_init: int = 0) -> list[int]:
        """The longest cached page run across BOTH tiers: alternate device
        matches (retained) and host-tier restores until the chain breaks.
        LRU eviction reclaims a run's head pages first, so a host-parked
        head often sits in front of a still-resident tail.  Restores use
        spare capacity only (``n_init`` is what the admission itself still
        needs; a restore never preempts a live row), and restored pages
        come back row-held and published, so a back-pressured caller
        releasing them parks them in the device LRU."""
        pc = self.prefix_cache
        pages = pc.match(digests[:cap])
        for p in pages:
            self.pool.retain(p)
        k = len(pages)
        while k < cap:
            run = self._host_restorable(digests, k, cap)
            if not run:
                break
            spare = self.pool.available() - max(0, n_init - k - len(run))
            restored = self._restore_spilled_run(run[: max(spare, 0)])
            if not restored:
                break
            pages += restored
            k += len(restored)
            if len(restored) < len(run):
                break
            more = pc.match(digests[k:cap])
            if not more:
                break
            for p in more:
                self.pool.retain(p)
            pages += more
            k += len(more)
        return pages

    def _restore_spilled_run(self, run: list[bytes]) -> list[int]:
        """Scatter a host-spilled digest run back into fresh pool pages and
        publish the digests: the pages come back exactly as they left, so
        a hit over them is a hit over never-evicted pages.  The caller
        guarantees pool availability.  Returns the restored pages (a
        prefix of ``run``; empty when a ``kv.spill`` restore drill drops it
        or the first page fails verification)."""
        if not run:
            return []
        rule = (self.faults.fire("kv.spill", tag="restore")
                if self.faults is not None else None)
        if rule is not None and rule.action == "drop":
            return []
        parcels = []
        for d in run:
            got = self.host_tier.take_spill(d)
            if got is None:
                break
            parcels.append(got)
        if not parcels:
            return []
        # The freed slots are read BEFORE the alloc, whose spill may park
        # into them; one scatter for the run: the one-slot parcels' device
        # copies stacked along the page axis.
        parts = [p.to(self.device) for p in parcels]
        pages = self._alloc_pages(len(parcels))
        self.cache = _import_pages_raw(
            self.cache, self._dev(np.asarray(pages, np.int32)),
            *(torch.cat([p[j] for p in parts], dim=1)
              for j in range(len(parts[0]))))
        for pg, d in zip(pages, run):
            self.pool.publish_prefix(pg, d)
        METRICS.inc("batcher.host_tier.restored_pages", len(pages))
        METRICS.inc("batcher.host_tier.hits")
        return pages

    def _reserve_row_pages(self, i, req, total_len, pfx=None):
        """Paged admission reservation, ON-DEMAND: pages for the prompt plus
        one decode page (growth allocates the rest at chunk boundaries).
        With the prefix cache (and no named prefix), the longest cached run
        of the prompt's full pages across both tiers is retained or
        restored (capped one page short of the prompt, so at least one
        real token prefills).  Returns (page_list, pages, cached_pages,
        cached_len, digests), or None on back-pressure."""
        blk = self.page_size
        n_full = -(-(total_len + req.max_new_tokens) // blk)
        n_init = min(n_full, -(-total_len // blk) + 1)
        pc = self.prefix_cache
        auto = pc is not None and pfx is None and req.prefix_cache
        cached_pages: list[int] = []
        cached_len = 0
        digests: list[bytes] = []
        if auto:
            if req.digests is None:
                req.digests = self._page_digests(req.ids, len(req.ids) // blk)
            digests = req.digests
            cap = (len(req.ids) - 1) // blk
            cached_pages = self._match_tiered(digests, cap, n_init=n_init)
            cached_len = len(cached_pages) * blk
        need = n_init - len(cached_pages)
        if not self._ensure_pages(need, "admit", below_priority=req.priority):
            # Restored pages release to the device LRU (still addressable);
            # retained hits just drop the reference.
            self.pool.release(cached_pages)
            return None
        if auto:
            pc.record_lookup(cached_len, total_len - cached_len)
        # Table first, allocation last: nothing between the pool handing
        # out pages and the row table owning them may raise.
        page_list = np.zeros((self.pages_per_row,), np.int32)
        page_list[: len(cached_pages)] = cached_pages
        pages = self._alloc_pages(need)
        page_list[len(cached_pages): n_init] = pages  # + scratch pad
        self.tables[i] = page_list
        return page_list, pages, cached_pages, cached_len, digests

    def _grow_rows(self) -> None:
        """Chunk-boundary page growth: every active row that will write past
        its pages this chunk gets them now — evicting LRU-cold cached pages
        first, then preempting a victim (possibly the grower itself).
        Contiguous rows own their whole width already."""
        if not self.paged:
            return
        blk = self.page_size
        for i in range(self.b):
            row = self.rows[i]
            if row.rid is None or not self.active[i] or row.prefilling:
                continue
            if self.speculative:
                # The verify window writes slots real_lens..real_lens+k
                # whatever the budget (the commit clamps, not the write).
                horizon = int(self.real_lens[i]) + self.spec_k + 1
            else:
                horizon = int(self.real_lens[i]) + min(
                    self.chunk_steps, int(self.budget[i])
                )
            need_pages = -(-horizon // blk)
            have = len(row.pages)
            if need_pages <= have:
                continue
            n = need_pages - have
            if not self._ensure_pages(n, "grow", self_slot=i):
                continue  # the grower itself was preempted
            fresh = self._alloc_pages(n)
            row.pages.extend(fresh)
            self.tables[i][have:need_pages] = fresh
            METRICS.inc("batcher.pages_grown", n)

    def _request_sampling(self, req: "_Request"):
        """(req_t, req_p, req_k, extra): the request's effective knobs and
        the per-request overrides to pass when they diverge from the
        batcher-wide config."""
        req_t = (self.sampling["temperature"] if req.temperature is None
                 else float(req.temperature))
        req_p = (self.sampling["top_p"] if req.top_p is None
                 else float(req.top_p))
        req_k = (self.sampling["top_k"] if req.top_k is None
                 else int(req.top_k))
        custom = (req_t != self.sampling["temperature"]
                  or req_p != self.sampling["top_p"]
                  or req_k != self.sampling["top_k"])
        extra = dict(temp_req=req_t, topp_req=req_p) if custom else {}
        if custom and req_k != self.sampling["top_k"]:
            extra["topk_req"] = req_k
        return req_t, req_p, req_k, extra

    def _first_mask(self, req: "_Request", extra: dict) -> None:
        """A constrained request's admission token draws under its
        automaton's state after the tokens it already emitted (a resume
        replays them): ``extra["mask_req"]``, that state's [V] bias row."""
        if req.constraint is not None:
            st0 = req.constraint.advance(0, req.resume_emitted or [])
            extra["mask_req"] = self._dev(req.constraint.bias[st0])

    def _admit_pending(self) -> None:
        if self.faults is not None:
            # Injection site "batcher.admit": one hit per admission round.
            self.faults.fire("batcher.admit")
        # Adopt handed-off KV pages FIRST: a transfer that raced this
        # round's admissions should be matchable by them.  Then serve
        # cross-replica exports, so a freshly landed run is re-exportable.
        self._drain_kv_imports()
        self._drain_kv_exports()
        self._shed_expired_queued()
        # Advance the pending chunked prefills.  ALTERNATE: one serialized
        # bite per prefill per round.  MIXED: while decode rows are live
        # the bites ride the fused step (_dispatch_mixed), so only a
        # completed prompt's finishing splice runs here; with no decode
        # row live the bite runs here.  Decided per slot: a splice earlier
        # in this loop activates a decode row.
        for slot in list(self._prefills):
            fused = self.sched.fuse_prefill() and bool(self.active.any())
            self._advance_chunk(slot, advance=not fused)
        while True:
            i = self._free_slot()
            if i is None:
                return
            req = self._next_request()
            if req is None:
                return
            if req.swap_handle is not None:
                # Swap-preempted resume: scatter the parked pages back
                # instead of recomputing.  True = restored; False = the
                # parcel was unusable and the request fell through to
                # recompute (still queued, swap_handle cleared: selected
                # again next iteration); None = back-pressure.
                if self._try_restore_swapped(i, req) is None:
                    return
                continue
            pfx = self.prefixes[req.prefix] if req.prefix is not None else None
            pfx_len = len(pfx.ids) if pfx else 0
            total_len = pfx_len + len(req.ids)
            thr = self.sched.chunk_threshold()
            if thr is not None and len(req.ids) > thr:
                if len(self._prefills) >= self.prefill_concurrency:
                    # Prefill slots full; admission order is strict, so
                    # the selected request is never jumped.
                    return
                self._unqueue(req)
                self._start_chunked(i, req, pfx)
                continue
            cached_pages: list[int] = []
            pages: list[int] = []
            cached_len = 0
            digests: list[bytes] = []
            if self.paged:
                got = self._reserve_row_pages(i, req, total_len, pfx)
                if got is None:
                    # Dry pool with no preemptable victim: back-pressure.
                    # The request stays queued; admission stops this round.
                    return
                page_list, pages, cached_pages, cached_len, digests = got
            self._unqueue(req)
            req_t, req_p, req_k, extra = self._request_sampling(req)
            self._first_mask(req, extra)
            # Bucket for shape reuse, never past what fits after the prefix.
            tp = min(_bucket(len(req.ids)), self.s - pfx_len)
            prompt = np.full((tp,), self.pad_id, np.int32)
            prompt[: len(req.ids)] = req.ids
            if self.paged:
                # Admissions address max_len's pages (all the pages a row
                # admits with): a speculative table's scratch tail is the
                # verify window's, so the prefill keeps the plain shapes.
                page_list = page_list[: self.s // self.page_size]
            if self.paged and pfx is not None:
                self.cache, tok, lp = admit_row_with_prefix_paged(
                    self.params, self.cfg, self.cache, self._dev(page_list),
                    pfx.k, pfx.v, pfx_len, self._dev(prompt), len(req.ids),
                    self._gen, **self.sampling, **extra,
                )
            elif self.paged and cached_len:
                # Prefix-cache HIT: the cached run seeds the row through a
                # pool gather; only the suffix prefills.  Writes for the
                # cached positions go to the scratch page.
                write_list = page_list.copy()
                write_list[: len(cached_pages)] = 0
                suffix = req.ids[cached_len:]
                tc = min(_bucket(len(suffix)), self.s - cached_len)
                chunk = np.full((tc,), self.pad_id, np.int32)
                chunk[: len(suffix)] = suffix
                self.cache, tok, lp = admit_row_auto_paged(
                    self.params, self.cfg, self.cache, self._dev(page_list),
                    self._dev(write_list), cached_len, self._dev(chunk),
                    len(suffix), self._gen, **self.sampling, **extra,
                )
            elif self.paged:
                self.cache, tok, lp = admit_row_paged(
                    self.params, self.cfg, self.cache, self._dev(page_list),
                    self._dev(prompt), len(req.ids), self._gen,
                    **self.sampling, **extra,
                )
            elif pfx is not None:
                self.cache, tok, row_valid, lp = admit_row_with_prefix(
                    self.params, self.cfg, self.cache, i, pfx.k, pfx.v,
                    pfx_len, self._dev(prompt), len(req.ids), self._gen,
                    **self.sampling, **extra,
                )
                self.valid[i] = row_valid
            else:
                self.cache, tok, row_valid, lp = admit_row(
                    self.params, self.cfg, self.cache, i, self._dev(prompt),
                    total_len, self._gen, **self.sampling, **extra,
                    width=self.s,
                )
                self.valid[i] = row_valid
            # Publish the row's fresh full prompt pages (first writer
            # wins); the cached run is already published.
            for j in range(len(cached_pages), len(digests)):
                self.pool.publish_prefix(int(page_list[j]), digests[j])
            if self.speculative:
                # The draft prefills the whole prompt (prefix included):
                # the prefix cache and named prefixes hold target KV only.
                full_ids = (pfx.ids if pfx else []) + req.ids
                self._seed_draft(i, full_ids, len(full_ids))
            self._activate_row(i, req, tok, lp, total_len, req_t, req_p,
                               cached_pages + pages, req_k=req_k,
                               cached_len=cached_len)

    # -- chunked prefill ---------------------------------------------------

    def _start_chunked(self, i: int, req: _Request, pfx=None) -> None:
        """Reserve slot ``i`` and begin a chunked prefill.  A named prefix
        seeds the transient row with a copy of its KV.  Otherwise, with the
        automatic prefix cache, the prompt's full pages are hashed, the
        longest cached run across both tiers is retained (or restored from
        the host) for the whole prefill and gathered into the transient row
        once, and only the un-cached suffix chunks through the model
        (capped one page short of the prompt, so at least one real token
        prefills)."""
        cached_pages: list[int] = []
        cached_len = 0
        digests: list[bytes] = []
        total_len = len(req.ids)
        done = 0
        pc = self.prefix_cache
        if pfx is not None:
            row_k, row_v = pfx.k.clone(), pfx.v.clone()
            done = len(pfx.ids)
            total_len += done
        else:
            if pc is not None and req.prefix_cache:
                blk = self.page_size
                if req.digests is None:
                    req.digests = self._page_digests(req.ids,
                                                     total_len // blk)
                digests = req.digests
                # A chunked prefill holds no pages of its own yet, so host
                # restores take spare capacity alone.
                cached_pages = self._match_tiered(
                    digests, (total_len - 1) // blk)
                cached_len = done = len(cached_pages) * blk
                pc.record_lookup(cached_len, total_len - cached_len)
            if cached_pages:
                read_list = np.zeros((self.pages_per_row,), np.int32)
                read_list[: len(cached_pages)] = cached_pages
                row_k, row_v = _gather_row_pages(self.cache,
                                                 self._dev(read_list))
            else:
                rc = model_lib.init_cache(self.cfg, 1, self.s,
                                          dtype=_row_dtype_of(self.cache),
                                          device=self.device)
                row_k, row_v = rc.k, rc.v
        self._admit_seq += 1
        # The reserving row holds the cached pages, so cancel / preemption
        # release them and the pool audit sees the references (a
        # prefilling row stays inactive: never a victim).
        self.rows[i] = _RowState(rid=req.rid, prefilling=True,
                                 remaining=req.max_new_tokens, req=req,
                                 priority=req.priority,
                                 admit_seq=self._admit_seq,
                                 pages=list(cached_pages))
        self._prefills[i] = _PendingPrefill(
            req=req, row_k=row_k, row_v=row_v, done=done,
            ids=list(req.ids), total_len=total_len, cached_pages=cached_pages,
            cached_len=cached_len, digests=digests,
        )
        # Alternate runs the first bite now; mixed defers it to the fused
        # step whenever decode rows are live to stall.
        self._advance_chunk(i, advance=not (self.sched.fuse_prefill()
                                            and bool(self.active.any())))

    def _mixed_width(self, done: int) -> int:
        """Width of a bite's chunk, for both schedules: ONE bucket sized to
        the policy's largest bite, so the mixed and alternate schedules
        compute the same shapes (and on the card the same bits).  At the
        row's tail, where done + width <= S must hold, the width shrinks
        down the bucket ladder (:meth:`_clamp_bite` keeps every bite
        boundary off the last sub-floor slots)."""
        cap = self.sched.token_budget or self.sched.prefill_chunk or self.s
        w = _bucket(min(cap, self.s))
        room = self.s - done
        while w > room and w > BUCKET_FLOOR:
            w //= 2
        return min(w, room)

    def _clamp_bite(self, done: int, bite: int, total_len: int) -> int:
        """Keep every bite boundary off the row's last sub-floor slots
        (s - 8 < done' < total_len would force the next width off the
        ladder): a bite ending there shortens to end on s - 8, and a bite
        starting there finishes the prompt (at most 7 tokens)."""
        if self.s - BUCKET_FLOOR <= done:
            return total_len - done
        end = done + bite
        if end < total_len and self.s - end < BUCKET_FLOOR:
            bite = (self.s - BUCKET_FLOOR) - done
        return bite

    def _next_bite(self, pp: _PendingPrefill, n_active: int):
        """(bite, chunk) of ``pp``'s next prefill step: the scheduler's
        bite against ``n_active`` decode rows, in a right-padded chunk of
        :meth:`_mixed_width` tokens (a host array)."""
        tw = self._mixed_width(pp.done)
        bite = self._clamp_bite(
            pp.done,
            min(self.sched.prefill_bite(pp.total_len - pp.done, n_active),
                tw),
            pp.total_len,
        )
        bite = min(bite, tw)
        off = pp.done - (pp.total_len - len(pp.ids))  # past a named prefix
        chunk = np.full((tw,), self.pad_id, np.int32)
        chunk[:bite] = pp.ids[off: off + bite]
        return bite, chunk

    def _advance_chunk(self, i: int, advance: bool = True) -> None:
        """Consume one bite of slot ``i``'s pending prompt (``advance=False``
        — the mixed schedule's fused step runs the bites — only checks for
        the finish); finish the admission once the prompt is in.  In paged
        mode the finish allocates the row's pages (prompt + one decode
        page): a dry pool preempts a strictly lower-priority victim, else
        the finish retries next round with the prefilled row kept."""
        pp = self._prefills[i]
        if advance and pp.done < pp.total_len:
            bite, chunk = self._next_bite(pp, int(self.active.sum()))
            pp.row_k, pp.row_v, pp.last_logits = prefill_chunk_step(
                self.params, self.cfg, pp.row_k, pp.row_v, pp.done,
                self._dev(chunk), bite,
            )
            pp.done += bite
            METRICS.inc("batcher.prefill_chunks")
            METRICS.inc("batcher.sched.prefill_tokens", bite)
            if bool(self.active.any()):
                # Live decode rows waited out this serialized bite: the
                # stall the mixed schedule exists to remove.
                METRICS.inc("batcher.sched.stall_rounds")
        if pp.done < pp.total_len:
            return
        req = pp.req
        req_t, req_p, req_k, extra = self._request_sampling(req)
        self._first_mask(req, extra)
        if self.paged:
            blk = self.page_size
            n_cached = len(pp.cached_pages)
            n_full = -(-(pp.total_len + req.max_new_tokens) // blk)
            n_init = min(n_full, -(-pp.total_len // blk) + 1)
            if not self._ensure_pages(n_init - n_cached, "admit",
                                      below_priority=req.priority):
                return  # retry the finish next round; the prefill is kept
            # Table first, allocation last: nothing between the pool
            # handing out pages and the table owning them may raise.
            page_list = np.zeros((self.pages_per_row,), np.int32)
            page_list[:n_cached] = pp.cached_pages
            pages = self._alloc_pages(n_init - n_cached)
            page_list[n_cached:n_init] = pages
            self.tables[i] = page_list
            # Cached positions scatter to the scratch page: the shared
            # pages already hold that KV and other rows may read them.
            write_list = page_list.copy()
            write_list[:n_cached] = 0
            self.cache, tok, lp = finish_chunked_admission_paged(
                self.cache, self._dev(write_list), pp.row_k, pp.row_v,
                pp.last_logits, self._gen, **self.sampling, **extra,
            )
            for j in range(n_cached, len(pp.digests)):
                self.pool.publish_prefix(int(page_list[j]), pp.digests[j])
            pages = pp.cached_pages + pages
        else:
            pages = []
            self.cache, tok, row_valid, lp = finish_chunked_admission(
                self.cache, i, pp.row_k, pp.row_v, pp.last_logits,
                pp.total_len, self._gen, **self.sampling, **extra,
            )
            self.valid[i] = row_valid
        del self._prefills[i]
        self._activate_row(i, req, tok, lp, pp.total_len, req_t, req_p,
                           pages, req_k=req_k, cached_len=pp.cached_len)

    def _seed_draft(self, i: int, ids: list[int], n: int) -> None:
        """Speculative mode: prefill the draft cache's row ``i`` with the
        first ``n`` of ``ids`` (:func:`admit_row_kv`, bucketed like an
        admission) and reset the row's acceptance EMA (a fresh row drafts
        the full k)."""
        seed = ids[:n]
        td = min(_bucket(len(seed)), self.s)
        dprompt = np.full((td,), self.pad_id, np.int32)
        dprompt[: len(seed)] = seed
        self.draft_cache = admit_row_kv(self.draft_params, self.draft_cfg,
                                        self.draft_cache, i,
                                        self._dev(dprompt), len(seed))
        self.spec_ema[i] = 1.0

    def _activate_row(self, i, req, tok, lp, total_len, req_t, req_p, pages,
                      req_k=None, cached_len=0):
        """Host bookkeeping tail of every admission: record the sampled
        first token, arm the row's scheduling state, stream the token."""
        tok = int(tok)
        lp = float(lp)
        self.last_tok[i] = tok
        if req.constraint is not None:
            # The automaton state after the admission token: a host replay
            # of (the resumed prefix and) the token.
            self.dfa_row[i] = req.constraint.advance(
                0, list(req.resume_emitted or []) + [tok])
            METRICS.inc("batcher.constrain.rows")
        else:
            self.dfa_row[i] = 0
        self.temp_row[i] = req_t
        self.topp_row[i] = req_p
        self.topk_row[i] = (self.sampling["top_k"] if req_k is None
                            else req_k)
        self.pres_row[i] = req.presence_penalty
        self.freq_row[i] = req.frequency_penalty
        if self.prefix_cache is not None:
            self.prefix_cached_tokens[req.rid] = cached_len
        prior = list(req.resume_emitted or [])
        prior_lps = list(req.resume_lps or [])
        if req.presence_penalty or req.frequency_penalty:
            # A resumed request's histogram counts every token it emitted
            # across residencies, or the recompute would sample from other
            # logits than the unpreempted run.
            self._set_count_row(i, prior + [tok])
        self.real_lens[i] = total_len
        self.active[i] = True
        # The first token came out of admission; decode may emit
        # budget - 1 more.
        self.budget[i] = req.max_new_tokens - 1
        self._admit_seq += 1
        self.rows[i] = _RowState(
            rid=req.rid, emitted=prior + [tok], lps=prior_lps + [lp],
            remaining=req.max_new_tokens - 1, pages=pages,
            req=req, priority=req.priority, admit_seq=self._admit_seq,
        )
        log.debug("admitted request %d into slot %d", req.rid, i)
        if req.max_new_tokens == 1 or tok == self.eos_id:
            self.active[i] = False
        if self._on_tokens is not None:
            # Stream the admission token (state advances BEFORE the
            # callback, so a raising callback never re-delivers).  A
            # resumed row's prior tokens were streamed already.
            self.rows[i].streamed = len(prior) + 1
            self._on_tokens(req.rid, [tok], False, [lp])
        METRICS.inc("batcher.admitted")

    def _collect(self, toks: np.ndarray, was_active: np.ndarray,
                 lps: np.ndarray | None = None,
                 active_host: np.ndarray | None = None,
                 counts: np.ndarray | None = None) -> None:
        """Commit a chunk's tokens, publish the rows that finished, stream
        the rest.  ``active_host``: the post-chunk activity vector — a
        dispatched-ahead chunk passes its fetched one (the mirrors are
        stale while the carry is on the device); None reads the synced
        mirror.  ``counts``: a speculative round's commit counts (row i
        took ``toks[i, :counts[i]]``; the columns past it are padding)."""
        for i in range(self.b):
            row = self.rows[i]
            if row.rid is None or not was_active[i]:
                continue
            row_toks = toks[i] if counts is None else toks[i][: counts[i]]
            for j, t in enumerate(row_toks):
                if row.remaining <= 0:
                    break
                t = int(t)
                row.emitted.append(t)
                if lps is not None:
                    row.lps.append(float(lps[i][j]))
                row.remaining -= 1
                if t == self.eos_id:
                    break
        # Rows that finished this chunk publish their result and free up
        # (chunked prefills in flight are inactive but not finished).
        if active_host is None:
            active_host = self.active
        for i in range(self.b):
            row = self.rows[i]
            if row.rid is not None and not active_host[i] \
                    and not row.prefilling:
                if self.eos_id >= 0 and self.eos_id in row.emitted:
                    cut = row.emitted.index(self.eos_id) + 1
                    row.emitted = row.emitted[:cut]
                    row.lps = row.lps[:cut]
                self.results[row.rid] = row.emitted
                self.result_logprobs[row.rid] = row.lps
                rid, final = row.rid, row.emitted[row.streamed:]
                if row.pages:
                    self.pool.release(row.pages)
                    self.tables[i] = 0
                    # From the next dispatch on the released row's table is
                    # the scratch page: only the chunk already in flight
                    # writes its junk K/V into these pages, at real_lens,
                    # past every page the row published.
                    self._tables_dirty = True
                final_lps = row.lps[row.streamed:]
                if row.req is not None:
                    self.sched.note_freed(row.req, len(row.emitted))
                self.rows[i] = _RowState()
                METRICS.inc("batcher.completed")
                if self._on_tokens is not None:
                    # Final delivery with done=True exactly once.
                    self._on_tokens(rid, final, True, final_lps)
        if self._on_tokens is not None:
            for i in range(self.b):
                row = self.rows[i]
                if row.rid is not None and len(row.emitted) > row.streamed:
                    new = row.emitted[row.streamed:]
                    new_lps = row.lps[row.streamed:]
                    row.streamed = len(row.emitted)
                    self._on_tokens(row.rid, new, False, new_lps)

    def run(self, on_tokens=None) -> dict[int, list[int]]:
        """Drive until every submitted request has a result.

        ``on_tokens(rid, new_tokens, done, logprobs)`` streams
        incrementally: the admission token first, then each chunk's new
        tokens, and exactly once ``done=True`` with any final tokens.
        With ``overlap`` on, a callback sees each chunk one dispatch later
        than the synchronous loop would; the stream per rid is unchanged.
        Exceptions from the callback propagate (and abort the run); recover
        through :meth:`respawn`."""
        self._on_tokens = on_tokens
        try:
            with self._on_mesh():
                return self._run_loop()
        finally:
            self._on_tokens = None

    def _run_loop(self) -> dict[int, list[int]]:
        self._t_complete = None  # a fresh run's first chunk follows no
        #                          observed completion
        while True:
            if self.lockstep is not None:
                # The iteration's submissions and cancellations, on every
                # rank, before any decision reads the queue.
                self.lockstep.sync(self)
            if not (self.has_queued() or bool(self.active.any()) or any(
                r.rid is not None for r in self.rows
            ) or self.has_kv_imports() or self.has_kv_exports()):
                break
            self._admit_pending()
            # Rows about to write past their pages get them NOW (or
            # preempt / yield): a decode chunk must never scatter a live
            # row's KV into the scratch page.
            self._grow_rows()
            was_active = self.active.copy()
            if not was_active.any():
                self._t_complete = None  # idle boundary: no chunk to gap
                # Publish 1-token requests finished by admission alone.
                self._collect(np.zeros((self.b, 0), np.int32), was_active)
                if not self.has_queued() and not self.has_kv_imports() \
                        and not self.has_kv_exports() \
                        and all(r.rid is None for r in self.rows):
                    break
                continue
            self._decode_span(was_active)
        return dict(self.results)

    # -- dispatch-ahead decode (the overlap plane) -------------------------

    def _span_plan(self) -> dict:
        """The plan of ONE decode span, decided from the fresh host mirrors
        at span start and kept for every chunk the span dispatches ahead
        (row sampling state changes only at admission, and a span never
        admits): the per-row sampling path only while a custom-sampled
        row is live (the all-default batch keeps the plain sampler; greedy
        is a bare argmax), and under the mixed schedule the head pending
        prefill — the first with prompt left — whose bites ride every
        chunk."""
        plan: dict = {
            "tables": self._dev(self.tables) if self.paged else None
        }
        self._tables_dirty = False  # the plan holds the current tables
        rows_live = self.active & (
            (self.temp_row != self.sampling["temperature"])
            | (self.topp_row != self.sampling["top_p"])
            | (self.topk_row != self.sampling["top_k"])
        )
        per_row = {}
        if bool(rows_live.any()):
            per_row["temp_row"] = self._dev(self.temp_row)
            if not bool((self.topp_row[self.active] == 1.0).all()):
                per_row["topp_row"] = self._dev(self.topp_row)
            if not bool((
                self.topk_row[self.active] == self.sampling["top_k"]
            ).all()):
                per_row["topk_row"] = self._dev(self.topk_row)
        # The penalized plan only while a penalized row is live: the
        # default batch keeps the plain sampler (and its graph).
        pen_live = self.active & ((self.pres_row != 0.0)
                                  | (self.freq_row != 0.0))
        plan["counts"] = bool(pen_live.any())
        if plan["counts"]:
            per_row["pres_row"] = self._dev(self.pres_row)
            per_row["freq_row"] = self._dev(self.freq_row)
        plan["per_row"] = per_row
        self._plan_constraints(plan)
        if self.speculative:
            # The k_row clamp is not frozen with the plan: it is an input
            # buffer of the round's graph, re-planned at every dispatch
            # from the freshest EMAs; ``k_hist`` pairs each dispatched
            # clamp with its fetch (FIFO: rounds fetch in dispatch order).
            plan["k_hist"] = deque()
        plan["n_active"] = int(self.active.sum())
        plan["mixed"] = None
        if self.sched.fuse_prefill():
            for slot, pp in self._prefills.items():
                if pp.done < pp.total_len:
                    plan["mixed"] = slot
                    break
        return plan

    def _plan_constraints(self, plan: dict) -> None:
        """Constrained output for the span: the live constrained rows'
        automata stacked into ONE (bias, next) pair (state 0 free), padded
        up the bucket ladder so the graph key does not change with the mix
        of live schemas, and written into that padded size's device buffers
        (on the stream: a chunk already dispatched reads the stack it was
        planned with).  The stack is memoized by ``(slot, rid)`` per
        constrained row: a row's constraint is fixed for its residency and
        rids are never reused.  Sets ``plan["constrain"]`` to the rows'
        ``(slot, offset, rid)``, ``plan["stacks"]`` and the span's first
        absolute states ``plan["dfa0"]`` (the carry's fifth row)."""
        plan["constrain"] = []
        con = [
            i for i in range(self.b)
            if self.active[i] and self.rows[i].req is not None
            and self.rows[i].req.constraint is not None
        ]
        if not con:
            self._con_stack = None
            return
        key = tuple((i, self.rows[i].rid) for i in con)
        if self._con_stack is None or self._con_stack[0] != key:
            dfas = [self.rows[i].req.constraint for i in con]
            n = _bucket(1 + sum(d.n_states for d in dfas))
            bias, nxt, offs = constrain_lib.build_stack(
                dfas, self.cfg.vocab_size, pad_states_to=n)
            bufs = self._con_bufs.get(n)
            if bufs is None:
                bufs = self._con_bufs[n] = (
                    torch.empty(bias.shape, dtype=torch.float32,
                                device=self.device),
                    torch.empty(nxt.shape, dtype=torch.int32,
                                device=self.device))
            for buf, host in zip(bufs, (bias, nxt)):
                src = torch.from_numpy(host)
                if self.device.type == "cuda":
                    src = src.pin_memory()
                buf.copy_(src, non_blocking=True)
            self._con_stack = (key, n, offs)
        _, n, offs = self._con_stack
        dfa0 = np.zeros((self.b,), np.int32)
        for off, i in zip(offs, con):
            dfa0[i] = off + int(self.dfa_row[i])
        plan["constrain"] = [(i, off, self.rows[i].rid)
                             for off, i in zip(offs, con)]
        plan["stacks"] = self._con_bufs[n]
        plan["dfa0"] = dfa0

    def _dispatch_chunk(self, plan: dict, carry) -> torch.Tensor:
        """Dispatch one decode chunk (a fused mixed step when the plan's
        prefill still has prompt left) and return its packed output on the
        device; nothing synchronises here.  ``carry``: None for the host
        mirrors (a span's first chunk), else the previous chunk's carry on
        the device."""
        if carry is None:
            rows = [self.last_tok, self.real_lens,
                    self.active.astype(np.int32), self.budget]
            if plan["constrain"]:
                rows.append(plan["dfa0"])
            carry = self._dev(np.stack(rows).astype(np.int32))
        self.overlap_stats["chunks"] += 1
        kw = dict(eos_id=self.eos_id, pad_id=self.pad_id,
                  tables=plan["tables"], graphs=self._graphs,
                  eager=self.loop_kind == "eager",
                  **self.sampling, **plan["per_row"])
        if plan["counts"]:
            kw["counts"] = self.tok_counts
        if plan["constrain"]:
            kw["mask_stack"], kw["next_stack"] = plan["stacks"]
        if self.speculative:
            return self._dispatch_spec(plan, carry, kw)
        METRICS.inc("batcher.sched.decode_tokens",
                    plan["n_active"] * self.chunk_steps)
        pp = (self._prefills.get(plan["mixed"])
              if plan["mixed"] is not None else None)
        if pp is not None and pp.done < pp.total_len:
            packed = self._dispatch_mixed(plan, carry, pp, kw)
        else:
            if self.faults is not None and self.sched.fuse_prefill():
                # Injection site "batcher.mixed_step" tag "decode": a
                # mixed-schedule dispatch with no prefill bite riding.
                self.faults.fire("batcher.mixed_step", tag="decode")
            packed = decode_chunk(self.params, self.cfg, self.cache, carry,
                                  self._gen, self.chunk_steps, **kw)
        self.decode_steps += self.chunk_steps
        return packed

    def _dispatch_spec(self, plan: dict, carry, kw: dict) -> torch.Tensor:
        """Dispatch one speculative round.  The per-row draft length comes
        from the scheduler's ``spec_round_k`` (the token-budget clamp and
        the acceptance-EMA downshift; greedy engines only — a sampled
        forced stop changes the per-seed stream), always passed as the
        [B] ``k_row`` buffer (the full k when inert) so one graph serves
        every value.  Mid-span the activity mirrors are stale the same way
        every run, so the downshifts repeat.  A round charges ``k_row + 1``
        committable tokens a live row to the budget ledger."""
        live = self.active & np.asarray([r.rid is not None for r in self.rows])
        emas = tuple(float(self.spec_ema[i]) if live[i] else 1.0
                     for i in range(self.b))
        if self.sampling["temperature"] == 0.0:
            ks = self.sched.spec_round_k(self.spec_k, emas, int(live.sum()))
        else:
            ks = [self.spec_k] * self.b
        kh = np.clip(np.asarray(ks, np.int32), 1, self.spec_k)
        plan["k_hist"].append(kh)
        if self.faults is not None:
            # Injection site "batcher.spec_verify": the round is one graph,
            # so both tags fire at its dispatch ('draft' = the k draft
            # steps, 'verify' = the (k+1)-token target pass).
            self.faults.fire("batcher.spec_verify", tag="draft")
            self.faults.fire("batcher.spec_verify", tag="verify")
        METRICS.inc("batcher.spec.rounds")
        self.spec_stats["rounds"] += 1
        METRICS.inc("batcher.sched.decode_tokens", int(np.sum((kh + 1)[live])))
        if bool((kh[live] < self.spec_k).any()):
            METRICS.inc("batcher.spec.k_downshifts")
            self.spec_stats["downshifts"] += 1
        kw.pop("eager")  # a speculative batcher never runs on a mesh
        packed = spec_chunk(self.params, self.cfg, self.draft_params,
                            self.draft_cfg, self.cache, self.draft_cache,
                            carry, self._gen, self.spec_k,
                            k_row=self._dev(kh), **kw)
        self.decode_steps += 1  # one verify forward
        return packed

    def _spec_note(self, m, was_active: np.ndarray, plan: dict) -> None:
        """Per-round speculative accounting from a fetched round's commit
        counts: each row's acceptance EMA (the next dispatch's downshift
        reads it) and the ``batcher.spec.*`` counters and acceptance gauge.
        ``accepted`` counts committed drafts (the bonus / correction token
        excluded); EOS and budget cuts deflate it, as in the reference."""
        if m is None:
            return
        kh = (plan["k_hist"].popleft() if plan["k_hist"]
              else np.full((self.b,), self.spec_k, np.int32))
        acc = rej = 0
        for i in range(self.b):
            if not was_active[i] or m[i] <= 0:
                continue
            drafted = int(kh[i])
            accepted = min(int(m[i]) - 1, drafted)
            acc += accepted
            rej += drafted - accepted
            self.spec_ema[i] = ((1.0 - _SPEC_EMA_ALPHA) * float(self.spec_ema[i])
                                + _SPEC_EMA_ALPHA * (accepted / max(drafted, 1)))
        if acc:
            METRICS.inc("batcher.spec.accepted_tokens", acc)
        if rej:
            METRICS.inc("batcher.spec.rejected_tokens", rej)
        self.spec_stats["accepted"] += acc
        self.spec_stats["rejected"] += rej
        total = self.spec_stats["accepted"] + self.spec_stats["rejected"]
        if total:
            METRICS.set_gauge("batcher.spec.acceptance",
                              self.spec_stats["accepted"] / total)
        if acc + rej:
            METRICS.observe("engine.spec_acceptance", acc / (acc + rej))

    def _dispatch_mixed(self, plan: dict, carry, pp: _PendingPrefill,
                        kw: dict) -> torch.Tensor:
        """ONE fused token-budget step: the head pending prefill's next
        bite, then the decode chunk.  ``pp.done`` advances at dispatch; the
        transient row and its last logits stay on the device across
        dispatched-ahead chunks, like the decode carry."""
        bite, chunk = self._next_bite(pp, plan["n_active"])
        if self.faults is not None:
            # Injection site "batcher.mixed_step" tag "prefill": one hit
            # per fused dispatch carrying a prefill bite.
            self.faults.fire("batcher.mixed_step", tag="prefill")
        packed, pp.row_k, pp.row_v, pp.last_logits = mixed_step(
            self.params, self.cfg, self.cache, carry, self._gen,
            self.chunk_steps, pp.row_k, pp.row_v, pp.done, self._dev(chunk),
            bite, **kw,
        )
        pp.done += bite
        METRICS.inc("batcher.prefill_chunks")
        METRICS.inc("batcher.sched.prefill_tokens", bite)
        budget_t = self.sched.token_budget or (plan["n_active"] + bite)
        METRICS.inc("batcher.sched.budget_tokens", budget_t)
        METRICS.set_gauge("batcher.sched.budget_utilization",
                          (plan["n_active"] + bite) / max(budget_t, 1))
        return packed

    def _overlap_ok(self, was_active: np.ndarray, chunks: int) -> bool:
        """Whether the NEXT chunk may dispatch ahead from the device carry:
        nothing needs the host mirrors at this boundary — the scheduler's
        ``sync_triggers`` over a host-state snapshot.  ``head_left`` is the
        prompt the first prefill with work left still owes; any completed
        prefill awaiting its finishing splice forces 0, so the finish runs
        at the next boundary.  Under lockstep every boundary syncs: the
        following ranks learn of rank 0's new requests only at the top of
        an engine iteration."""
        if self.lockstep is not None:
            return False
        head_left = 0
        for pp in self._prefills.values():
            left = pp.total_len - pp.done
            if left <= 0:
                head_left = 0
                break
            if head_left == 0:
                head_left = left
        view = SyncView(
            any_active=bool(was_active.any()),
            cancel_dirty=self._cancel_dirty,
            queued=self.has_queued(),
            kv_imports=self.has_kv_imports(),
            prefills=len(self._prefills),
            head_prefill_left=head_left,
            live_budgets=tuple(
                int(self.budget[i]) for i in range(self.b)
                if self.rows[i].rid is not None and self.active[i]
                and not self.rows[i].prefilling
            ),
            chunks_ahead=chunks,
            grow_blocked=lambda: (
                self.paged and not self._grow_ahead(chunks + 1)
            ),
        )
        return not self.sched.sync_triggers(view)

    def _note_gap(self, gap_s: float) -> None:
        """Record one chunk's device gap: host time between the previous
        chunk completing and this one dispatching.  A dispatched-ahead
        chunk records 0: it was dispatched before its predecessor
        completed, so the stream runs back to back."""
        self.overlap_stats["device_gap_s"] += gap_s
        self.overlap_stats["gap_samples"] += 1
        METRICS.observe("batcher.overlap.device_gap_seconds", gap_s)

    def _grow_ahead(self, horizon_chunks: int) -> bool:
        """Page growth inside a span: rows grow against a CONSERVATIVE
        frontier off the stale mirrors (``horizon_chunks`` chunks may have
        advanced every row since the sync; the budget only shrinks, so
        ``min(..., budget)`` stays an upper bound).  A live row
        over-allocates at most one page; a row already dead on the device
        may hold pages it never writes until its fetch publishes it.  Only
        from spare capacity: growth that needs PRESSURE (preemption runs
        on fresh mirrors) returns False and the span syncs.  So does a
        fault-armed batcher: a ``batcher.page_alloc`` drill window counts
        exactly one hit per growth round."""
        if self.faults is not None:
            return False
        blk = self.page_size
        for i in range(self.b):
            row = self.rows[i]
            if row.rid is None or not self.active[i] or row.prefilling:
                continue
            if self.speculative:
                # A round commits at most spec_k + 1 tokens and writes a
                # spec_k + 1 window past its frontier.
                horizon = int(self.real_lens[i]) + min(
                    horizon_chunks * (self.spec_k + 1), int(self.budget[i])
                ) + self.spec_k + 1
            else:
                horizon = int(self.real_lens[i]) + min(
                    horizon_chunks * self.chunk_steps, int(self.budget[i])
                )
            need = -(-horizon // blk) - len(row.pages)
            if need <= 0:
                continue
            if self.pool.available() < need:
                return False  # pressure: sync and let _grow_rows preempt
            have = len(row.pages)
            fresh = self._alloc_pages(need)
            row.pages.extend(fresh)
            self.tables[i][have: have + need] = fresh
            self._tables_dirty = True
            METRICS.inc("batcher.pages_grown", need)
        return True

    def _fetch_chunk(self, packed: torch.Tensor, dfa: bool = False):
        """A chunk's packed output on the host — tokens, logprobs and the
        carry (with the automaton states: ``dfa``) in ONE copy (into pinned
        memory on CUDA) and one event wait, unpacked (:func:`unpack_chunk`).
        Blocks until the chunk completes; a dispatched-ahead chunk already
        runs behind it."""
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            packed = host
        width = self.spec_k + 1 if self.speculative else self.chunk_steps
        got = unpack_chunk(packed.numpy(), self.b, width,
                           commits=self.speculative, dfa=dfa)
        self._t_complete = time.perf_counter()
        return got

    def _sync_carry(self, packed: torch.Tensor, written: np.ndarray,
                    plan: dict) -> tuple:
        """Span end: the tokens, logprobs and the whole carry return to the
        host mirrors in one copy.  Slots whose host bookkeeping dropped the
        row while the carry was on the device (a cancel mid-span) are
        forced inactive: their device activity bit is stale.  The
        constrained rows still resident take their advanced automaton
        states back, relative to their own automaton."""
        con = plan["constrain"]
        toks_h, lps_h, m_h, carry = self._fetch_chunk(packed, dfa=bool(con))
        self.last_tok = carry[0].copy()
        self.real_lens = carry[1].copy()
        self.active = carry[2].astype(bool)
        self.budget = carry[3].copy()
        for i, off, rid in con:
            if self.rows[i].rid == rid:
                self.dfa_row[i] = int(carry[CARRY_ROWS][i]) - off
        for i in range(self.b):
            if self.rows[i].rid is None and self.active[i]:
                self.active[i] = False
                self.budget[i] = 0
        self._cancel_dirty = False
        if not self.paged:
            self._note_written(written, self.real_lens)
        return toks_h, lps_h, m_h

    def _note_written(self, before: np.ndarray,
                      after: np.ndarray) -> np.ndarray:
        """Contiguous mode: mark the slots a chunk's decode steps wrote (an
        active row writes slot real_lens, then advances it: slots [before,
        after)), and check the contract the ragged kernel reads by — a
        resident row's valid slots are exactly the prefix [0, after).
        Called for every fetched chunk, not only at the span's sync.
        Returns ``after``, the next chunk's ``before``."""
        slots = np.arange(self.valid.shape[1])[None, :]
        prefix = slots < after[:, None]
        self.valid |= prefix & (slots >= before[:, None])
        resident = np.array([r.rid is not None and not r.prefilling
                             for r in self.rows])
        assert (self.valid[resident] == prefix[resident]).all(), (
            "a resident row's valid slots are not the prefix "
            "[0, real_lens) the ragged decode kernel reads"
        )
        return after

    def _prehash_queued(self) -> None:
        """Overlapped host window: memoize the page digests of requests
        that arrived while the span ran, so the next admission round (a
        sync point: the device waits on it) finds the hashing done."""
        if self.prefix_cache is None:
            return
        for req in self.queue_snapshot():
            if (req.digests is None and req.prefix_cache
                    and req.prefix is None and req.swap_handle is None):
                req.digests = self._page_digests(
                    req.ids, len(req.ids) // self.page_size
                )

    def _decode_span(self, was_active: np.ndarray) -> None:
        """One decode SPAN: a first chunk dispatched from the fresh host
        mirrors, then — while :meth:`_overlap_ok` holds — chunk N+1
        dispatched from chunk N's carry on the device, with chunk N's host
        work (its copy to the host, delivery, digest pre-hashing, metrics)
        running while N+1 executes.  Every span ends by syncing the carry
        into the host mirrors, so code outside the span always sees fresh
        scheduling state: temperature-0 outputs are identical with the
        overlap off."""
        # Mirrors are fresh here (every span ends in _sync_carry): only a
        # cancel taken DURING the span must force the next sync.
        self._cancel_dirty = False
        plan = self._span_plan()
        if self._t_complete is not None:
            # The host time since the previous span's sync is device idle:
            # collect / admit / grow ran with nothing in flight.
            self._note_gap(max(0.0, time.perf_counter() - self._t_complete))
        written = self.real_lens.copy()
        self._span_open = True
        if self.faults is not None:
            # Injection site "batcher.decode": one hit per decode or
            # speculative chunk about to dispatch (dispatched-ahead chunks
            # too).  A "raise" is the canonical engine crash (out of run()
            # into the serving supervisor; a chunk in flight is dropped
            # with the batcher); "stall" models a wedged device call.
            self.faults.fire("batcher.decode")
        out = self._dispatch_chunk(plan, None)
        chunks = 1
        dfa = bool(plan["constrain"])
        rows = CARRY_ROWS + int(dfa)
        while self.overlap and self._overlap_ok(was_active, chunks):
            if self.faults is not None:
                self.faults.fire("batcher.decode")
            if self._tables_dirty:
                # In-span growth extended a table: the next chunk reads
                # and writes through the grown pages.
                plan["tables"] = self._dev(self.tables)
                self._tables_dirty = False
            rng_before = self._gen.get_state()  # the ghost refund point
            nxt = self._dispatch_chunk(
                plan, out[-rows * self.b:].view(rows, self.b))
            self._note_gap(0.0)
            chunks += 1
            self.overlap_stats["dispatched_ahead"] += 1
            METRICS.inc("batcher.overlap.dispatched_ahead")
            METRICS.set_gauge("batcher.overlap.depth", 1)
            # Chunk N's host work, while chunk N+1 runs on the device.
            host_t0 = time.perf_counter()
            toks, lps, m, carry = self._fetch_chunk(out, dfa=dfa)
            self._spec_note(m, was_active, plan)
            active_after = carry[2].astype(bool)
            if not active_after.any():
                # Every row died (EOS) in the chunk just fetched: the one
                # dispatched behind it is a GHOST that samples nothing.
                # Refund its draws, so the generator stays where the
                # synchronous loop (which never dispatches it) leaves it:
                # later sampled requests match overlap off.
                self._gen.set_state(rng_before)
            if not self.paged:
                written = self._note_written(written, carry[1])
            self._collect(toks, was_active, lps=lps, active_host=active_after,
                          counts=m)
            self._prehash_queued()
            lag = time.perf_counter() - host_t0
            self.overlap_stats["host_lag_s"] += lag
            METRICS.observe("batcher.overlap.host_lag_seconds", lag)
            was_active = active_after
            out = nxt
        # Sync exit: the mirrors refresh BEFORE _collect, so a cancel taken
        # in the delivery callbacks lands on fresh state.
        toks, lps, m = self._sync_carry(out, written, plan)
        self._spec_note(m, was_active, plan)
        self._span_open = False
        METRICS.set_gauge("batcher.overlap.depth", 0)
        if self.overlap:
            self.overlap_stats["carry_syncs"] += 1
            METRICS.inc("batcher.overlap.carry_syncs")
        self._collect(toks, was_active, lps=lps, counts=m)
