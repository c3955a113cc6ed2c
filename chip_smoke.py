#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``distributed_llms_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing result lines:

1. ``build``  — compile every kernel source under
   ``distributed_llms_tpu_torch/ops/csrc`` (one nvcc per source, started
   together) and print the build seconds and the register report; for the
   split-K decode kernels (K1, K1q, K2, K2q) and K5 also each function's
   registers, spills and static shared memory from ``-Xptxas -v`` and, at
   the served heads (D 128, group 4) or K5's served rows (M 8 and 512,
   int8 and int4) and the flash kernels K3 and K4 (head dims 64, 128 and
   256: threads, query and key tile, ring stages), the threads, dynamic
   shared memory, local (spill) bytes and resident blocks per SM.
2. ``kernel`` — hold each kernel against its plain PyTorch version on the
   card, at its path's shapes: K1 and K1q at Llama-3-8B's heads (H=32,
   KVH=8, D=128; K1q's pools quantized by the port's ``kv_quantize``):
   B=8, page size 64, ragged lengths 1..2048, a shuffled page table, with
   and without garbage past every row's depth; one 8192-slot row at batch
   1 (the model's published context); 16-slot pages over 2048 slots
   (tiles straddling pages); and rows at every edge of the split plan
   (lengths 0, 1, 63-65, each split edge +- 1, 2048, 2049), rows of
   length 0 exactly zero; K2 and its int8 leg K2q at
   Mistral-7B's (B=8, H=32, KVH=8, D=128, S=6144, ragged lengths 1..6144,
   window 4096 and none; and one row of 32768 slots at batch 1, window
   4096 and none), each decode output row within 1% of the plain row's L2
   norm (1% + 2^-7 for the int8 legs), K5 (int8 and int4 weights, bf16 x) at
   Llama-3-8B's projections: M=8 (decode) for wq, wk/wv, gate/up, down and
   wo through ``k_lead=2``, and M=512 (prefill) for gate/up, and at the
   edges of its split plan (M of 1, 16, 17, 64 and 65; a K off the tiles
   cut into uneven splits), each output within 2e-2 + 2^-7 |plain|
   elementwise; the flash
   kernels K3 at path g's shapes (B=1, T=4096, H=32, KVH=8, D=128, causal;
   and window 4096 at T=8192; T=4097 and 127, off the 128-row query
   tiles; head dims 64 and 256 at small sizes) and K4 at path f's
   admission (8192 queries over a 32768-slot row with the first 8192
   slots written, window 4096; the same without causality or window;
   1000 queries at positions 5000 and at 4097, where each query tile ends
   on a key tile's first slot; 16 queries over the 32768 slots; two rows
   written to different lengths; shuffled positions; rows with no live
   key, held to exact zeros; head dims 64 and 256), each output row within
   1% of the plain row's L2 norm; K4's pre-pass (the per-key-tile
   summary) equal to its plain version; and K3's backward (gradients
   through the kernel's autograd function, the bf16 dense recompute)
   within 1% of the float32 gradient.
3. ``timing`` — CUDA-event times of each kernel, its plain version and one
   PyTorch library call computing the same function, beside the least
   time the card could take (the byte and operation bounds).  The decode
   kernels' lines carry their split plan and profiler device time (split
   and merge kernels), the kernel and its SDPA rotated over copies of the
   cache or page pool so that no launch finds its rows in the 50 MB L2
   cache: K1 and K1q at the kernel phase's first shape and at path a's
   own (B=8, 16 pages, lengths 300..364; SDPA over rows gathered before
   the timer), K2 and K2q also at batch 1 over one 32768-slot row (window
   4096); K5 at each projection, int8 and int4, with its plan, profiler
   device time, host enqueue time and cuBLAS's device time over the
   dequantized bf16 weight, operands rotated over >= 150 MB; then, for
   information, K1, K2 and K2q at sweeps of split lengths and K5 at sweeps
   of split counts (down, wk/wv).  K3 and K4 carry their tile
   configuration and profiler device time by function (K4's pre-pass
   apart, and timed alone), SDPA's device time beside them, and K4 a
   short admission's time (16 queries over 32768 slots).
4. ``model``  — a small bf16 llama decoding through each kernel on the
   card against the same weights through the plain versions on the CPU:
   a paged bf16 pool (K1), an int8 pool (K1q), a contiguous cache with a
   64-slot sliding window, decoded past the window (K2), int8 and int4
   quantized blocks over a paged bf16 pool (K5 and K1), and with
   ``attn_impl="flash"`` contiguous admissions prefilled through K4
   (plain, and windowed past the window) and one training step's loss and
   gradients (K3 forward, dense-recompute backward).
5. ``serve``  — the port's paths as a user runs them, each through
   ``serve_main.build_server`` at full width with random seeded weights,
   answering concurrent HTTP requests:
   a. ``dlt-serve-torch --preset llama-3-8b --paged-pages 256 --page-size
      64 --prefix-cache`` (K1): completions and chat completions, greedy
      and sampled, one streamed over SSE, three sharing a long prompt
      prefix;
   b. the same with ``--kv-bits 8`` (K1q), the same requests;
   c. ``dlt-serve-torch --preset mistral-7b --max-len 6144`` (contiguous,
      sliding window 4096; K2): one request with a 4400-byte prompt, so
      its decode reads past the window, beside three short ones;
   d. ``dlt-serve-torch --store D8 --override runtime.serve_quantized=true
      --paged-pages 256 --page-size 64 --prefix-cache`` (K5 int8 and K1),
      path a's requests, where D8 is a Llama-3-8B store (random weights,
      seed 0) written by the port's ``save_shards`` with
      ``quantization="int8"``, 2 raw shards, into a temporary directory
      removed when the path ends;
   e. the same over an int4 store D4 (K5 int4 and K1);
   f. ``dlt-serve-torch --store DF --max-len 32768`` (contiguous, 8 slots,
      Mistral-7B's full context; K4 prefills every admission, K2 decodes),
      where DF is a Mistral-7B store (random weights, seed 0, ``attn_impl
      ="flash"`` in its model config) written with
      ``quantization="int8"`` and dequantized to bf16 at load: one
      streamed request with an 8000-byte prompt (an 8192-token
      admission, past the 4096 window) beside three short ones; then,
      outside HTTP, a prompt of that length admitted alone, its time to
      first token read engine-side from submit to the admission token;
   h. ``dlt-serve-torch --preset mistral-7b --max-len 32768 --slots 4
      --prefill-chunk 1024`` (contiguous, dense ``attn_impl="dot"``,
      window 4096, the mixed schedule; K2): three short greedy SSE
      streams decode while a 30000-byte prompt (30001 tokens, no cut)
      admits in 1024-token bites over its 32768-slot row; then, outside
      HTTP, the same traffic timed engine-side (the long prompt's time to
      first token, the short streams' delivery gaps before and while it
      admits, the peak memory), and again on a server booted with
      ``--schedule alternate``: the short greedy streams must be
      identical under the two schedules.
   i. (run by the ``tier`` phase) ``dlt-serve-torch --preset llama-3-8b
      --paged-pages 40 --page-size 64 --prefix-cache --host-pages 128
      --max-len 1024`` (K1): a pool of
      39 usable pages (8 MiB each) under 9 streamed greedy requests of
      300-400 bytes and 192 new tokens each — three over a shared
      256-byte prefix (the first alone until admitted), four more without
      it (one with presence/frequency penalties 0.6/0.4), one naming the
      prefix "sys" registered through ``batcher.register_prefix``, and
      after that wave one more over the shared prefix.  Rows must swap out
      and back (>= 2 each, no fallback to recompute), cached pages must
      spill and a hit be restored from the host tier, the pool-and-tier
      audit must pass with no swap parcel left, and every stream must
      equal the same requests' submitted in order engine-side to an
      unpressured batcher (256 pages, no tier) over the same weights; the
      same pair of runs engine-side with ``--kv-bits 8`` (K1q, int8 codes
      and scales swapped verbatim) too.  The penalized stream must differ
      from the plain one and be identical under the three engine loops
      (path i's batcher, pressured: swaps run under each loop); the named
      prefix's first-token logits (``admit_row_with_prefix_paged``'s
      prefill) must agree with the whole prompt's (``admit_row_paged``'s)
      within 5% of the logit scale; a 9-page parcel (bf16, and int8 codes
      with scales) must come back from the pinned host arena equal to the
      bit, its swap-out and restore timed in parts.
   j. (run by the ``spec`` phase) ``dlt-serve-torch --preset llama-3-8b
      --paged-pages 256 --page-size 64 --prefix-cache --spec-decode
      --max-len 1024`` (spec_k 4, the int4 self-draft: K5 for the draft's
      projections, K2 for its 4 steps and backfill over its contiguous
      cache, K1 once a layer for the 5-token verify window over 40
      virtual rows): path a's seven prompts, all greedy, 64 new tokens,
      three over the shared prefix, one over SSE, one naming the
      registered prefix "sys".  Then, engine-side over the same weights:
      (a) the HTTP streams against a plain batcher's; (b) the same with
      ``kv_bits=8`` (K1q's window) against the plain int8 batcher; (c)
      an explicit draft, ``attach_draft(cfg, params)`` with the bf16
      target itself, against the plain batcher (its acceptance printed),
      and its streams equal to the int4 self-draft's to the token (a
      greedy round commits the verify's tokens, whatever the draft);
      a greedy stream that leaves the plain one must stay within 4x the
      plain streams' own worst teacher-forced margin of the target's
      greedy choice at every position (the verify's 40-row products round
      differently from a plain step's 8); (d) a sampled batcher
      (temperature 0.8, seed 7): the same streams under the eager loop,
      the graph and the graph with the overlap; (e) the one-launch
      window against 5 single-offset K1 and K1q launches and the plain
      version at path j's shape, every row within 1% of its norm (+ 2^-7
      int8).  The round's cost: 8 requests (300-token prompts, 64 new)
      timed on the speculative batcher and on the plain one, and under
      the profiler the round's device split (draft K5, draft K2, verify
      K1, cuBLAS, the rest).  K1 must launch once a layer a round, K2
      5 times, K5 (int4) 35 times.  Path j's launches ride in the JSON
      line as ``spec_launches``.
   Every path runs the default engine loop: the decode chunk replays a
   captured CUDA graph (``runtime/chunk_graph.py``) and chunks are
   dispatched ahead (``overlap``).  A replay adds the launches its
   capture recorded to each kernel's count.  Paths a, d and i also run 8
   greedy requests (300-token prompts, 64 new tokens, cold admissions)
   on fresh batchers over the served weights under three engine loops —
   graphs with the overlap, graphs without it, and the eager synchronous
   loop (the batcher module's own ``_decode_steps``) — and their token
   streams must be identical.
   Every kernel's launch count is reset just before each path and read
   just after; the run fails unless the path's kernels launched at least
   layers x decode steps times (7 x that for K5, one per projection).
   Each engine is freed before the next boots.  The device memory an
   engine holds once booted (its weights and KV pool, measured with
   ``torch.cuda.memory_allocated``) must be below path a's on paths d and
   e by at least 90% of what their quantized block weights save over
   bf16 (computed from the served leaves), and path d must peak below
   path a.  Path f must launch K4 at least 32 times per admission, and
   K4's pre-pass once per K4 launch.
6. ``tier`` — path i (in ``serve``'s list above): the host tier, swap
   preemption, prefix-cache spill, penalties and named prefixes.
   ``--phases build,tier`` runs it alone.
6b. ``spec`` — path j (in ``serve``'s list above): speculative decoding.
   ``--phases build,spec`` runs it alone.
7. ``train`` — path g: ``runtime.train.Trainer`` on Llama-3-8B's width
   (d_model 4096, 32/8 heads, FFN 14336, vocab 128256) cut to 8 layers,
   ``attn_impl="flash"``, random weights from seed 0, AdamW at lr 1e-3:
   3 steps on one fixed batch [2, 4097], then one with ``remat=True``.
   The loss must be finite and fall over the 3 steps, and K3 must launch
   8 times per step (16 under remat).
8. ``profile`` — on paths a and d, the eager synchronous loop and the
   default loop (graphs and overlap) run the 8-request batch once more
   under ``torch.profiler``: device kernel time by class (K5, the
   decode-attention kernels, other matrix products, the rest) and the
   device's busy share, beside each loop's ms per decode step, chunks
   dispatched ahead, carry syncs and mean device gap; path f's weights
   admit one 8000-byte prompt, and path g takes one step, under the
   profiler too, split the same way with the flash kernels apart
   (information, not a gate).

Then the card's name and power limit (nvidia-smi), one JSON line of
per-kernel numbers, and last ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before that line; so does a machine without CUDA
or a directory without the repository.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bounds below are the least time for the work at these rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

_COMMON_ARGS = ["--slots", "8", "--host", "127.0.0.1", "--port", "0",
                "--seed", "0"]
SERVE_ARGS = ["--preset", "llama-3-8b", "--paged-pages", "256",
              "--page-size", "64", "--prefix-cache", *_COMMON_ARGS]
SERVE_INT8_ARGS = [*SERVE_ARGS, "--kv-bits", "8"]
SERVE_WINDOW_ARGS = ["--preset", "mistral-7b", "--max-len", "6144",
                     *_COMMON_ARGS]
# Paths d and e: SERVE_ARGS over a quantized store in place of the preset.
SERVE_STORE_ARGS = ["--override", "runtime.serve_quantized=true",
                    *SERVE_ARGS[2:]]
# Path h: Mistral-7B at its published context on the default dense
# attention, long prompts admitted by chunked prefill under the mixed
# schedule (and once more under --schedule alternate).
LONG_MAX_LEN = 32768
LONG_PROMPT_BYTES = 30000  # + BOS: 30001 prompt tokens, no cut
PREFILL_CHUNK = 1024
SERVE_LONG_ARGS = ["--preset", "mistral-7b", "--max-len", str(LONG_MAX_LEN),
                   "--slots", "4", "--prefill-chunk", str(PREFILL_CHUNK),
                   "--host", "127.0.0.1", "--port", "0", "--seed", "0"]
SHORT_NEW = 512  # the short streams decode through the long admission
# Path f: a flash-config Mistral-7B store at its published context.
FLASH_MAX_LEN = 32768
FLASH_PROMPT_BYTES = 8000  # + BOS: an 8192-token admission bucket
SERVE_FLASH_ARGS = ["--max-len", str(FLASH_MAX_LEN), *_COMMON_ARGS]

# The kernels of the port's paths: name -> (wrapper, counter attribute).
CSRC = "distributed_llms_tpu_torch/ops/csrc/"
KERNELS = {
    "paged_decode_attention": {
        "route": "cuda", "source": CSRC + "paged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:470"},
    "paged_decode_attention_int8": {
        "route": "cuda", "source": CSRC + "paged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:470"},
    "ragged_decode_attention": {
        "route": "cuda", "source": CSRC + "ragged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:338"},
    "ragged_decode_attention_int8": {
        "route": "cuda", "source": CSRC + "ragged_decode_attn.cu",
        "replaces": "distributed_llms_tpu/ops/decode_attn.py:338"},
    "flash_attention_static": {
        "route": "cuda", "source": CSRC + "flash_attn.cu",
        "replaces": "distributed_llms_tpu/ops/flash.py:291"},
    "flash_attention_dynamic": {
        "route": "cuda", "source": CSRC + "flash_attn.cu",
        "replaces": "distributed_llms_tpu/ops/flash.py:335"},
    # K4's pre-pass: the per-tile summary that stands in for the TPU
    # kernel's per-tile liveness test (pl.when(jnp.any(mask)), :201).
    "flash_tile_summary": {
        "route": "cuda", "source": CSRC + "flash_attn.cu",
        "replaces": "distributed_llms_tpu/ops/flash.py:335"},
    "quant_matmul": {
        "route": "cuda", "source": CSRC + "quant_matmul.cu",
        "replaces": "distributed_llms_tpu/ops/quant_matmul.py:139"},
    "quant_matmul_int4": {
        "route": "cuda", "source": CSRC + "quant_matmul.cu",
        "replaces": "distributed_llms_tpu/ops/quant_matmul.py:139"},
}


def _counters():
    from distributed_llms_tpu_torch.ops import decode_attn, flash, quant_matmul

    return {
        "quant_matmul": (quant_matmul.quant_matmul, "launches"),
        "quant_matmul_int4": (quant_matmul.quant_matmul, "int4_launches"),
        "paged_decode_attention": (decode_attn.paged_decode_attention,
                                   "launches"),
        "paged_decode_attention_int8": (decode_attn.paged_decode_attention,
                                        "int8_launches"),
        "ragged_decode_attention": (decode_attn.ragged_decode_attention,
                                    "launches"),
        "ragged_decode_attention_int8": (decode_attn.ragged_decode_attention,
                                         "int8_launches"),
        "flash_attention_static": (flash.flash_attention, "static_launches"),
        "flash_attention_dynamic": (flash.flash_attention,
                                    "dynamic_launches"),
        "flash_tile_summary": (flash.tile_summary, "launches"),
    }


def reset_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -- phase 1: build ---------------------------------------------------------

def phase_build() -> None:
    from distributed_llms_tpu_torch.ops import build

    sources = sorted(p.name for p in build.CSRC.glob("*.cu"))
    check(bool(sources), "no kernel sources found")
    t0 = time.perf_counter()
    built = build.build(sources)
    wall = time.perf_counter() - t0
    for src, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        emit("build", source=src, seconds=round(info["seconds"], 3),
             ptxas=regs)
    emit("build", ok=True, sources=len(sources), wall_s=round(wall, 3))
    from distributed_llms_tpu_torch.ops import decode_attn

    for source, kernel, resources in (
            (decode_attn.PAGED_SOURCE, "K1",
             decode_attn.paged_kernel_resources),
            (decode_attn.RAGGED_SOURCE, "K2",
             decode_attn.ragged_kernel_resources)):
        got = {kernel + ("q" if quant else "") + "_at_D128_G4":
               resources(128, 4, quant) for quant in (False, True)}
        emit("build", source=source,
             functions=ptxas_functions(built[source]["log"]), **got)
    from distributed_llms_tpu_torch.ops import flash

    emit("build", source=flash.SOURCE,
         functions=ptxas_functions(built[flash.SOURCE]["log"]),
         **{f"{'K4' if dynamic else 'K3'}_at_D{d}":
            flash.flash_kernel_resources(d, dynamic)
            for d in flash.HEAD_DIMS for dynamic in (False, True)})
    from distributed_llms_tpu_torch.ops import quant_matmul

    emit("build", source=quant_matmul.SOURCE,
         functions=ptxas_functions(built[quant_matmul.SOURCE]["log"]),
         **{f"K5_int{bits}_M{m}_N{n}":
            quant_matmul.quant_matmul_resources(m, n, bits)
            for m, n in ((8, 14336), (8, 1024), (512, 14336))
            for bits in (8, 4)})


def ptxas_functions(log: str) -> list:
    """Each kernel function's registers, spill stores / loads (bytes) and
    static shared memory from an ``nvcc -Xptxas -v`` report."""
    import re

    funcs, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            if not funcs or funcs[-1]["function"] != m.group(1):
                cur = {"function": m.group(1)}
                funcs.append(cur)
            continue
        if cur is None:
            continue
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return funcs


# -- phase 2/3: kernel checks and timing -----------------------------------

def paged_case(torch, *, b=8, h=32, kvh=8, d=128, blk=64, max_len=2048,
               seed=0, garbage=False, lengths=None):
    """Main-path inputs: bf16 q and pools, ragged lengths in [1, max_len]
    (both ends included; at B=1 the one row is max_len long) unless
    ``lengths`` gives them (B = their count), each row's pages a shuffled
    run of the pool; ``garbage`` puts ids outside the pool in every table
    entry past a row's depth."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = max_len // blk
    if lengths is None:
        lengths = torch.randint(1, max_len + 1, (b,), generator=g)
        lengths[0], lengths[-1] = 1, max_len
    else:
        lengths = torch.tensor(lengths)
        b = len(lengths)
    nb = b * p + 1  # + scratch page 0
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = perm[: b * p].reshape(b, p).to(torch.int32)
    if garbage:
        depth = (lengths.clamp(0, max_len) + blk - 1) // blk
        junk = torch.randint(-(2 ** 30), 2 ** 30, (b, p), generator=g,
                             dtype=torch.int32)
        past = torch.arange(p)[None, :] >= depth[:, None]
        tables = torch.where(past, junk, tables)
    q = torch.randn(b, 1, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(nb, blk, kvh, d, generator=g).to(torch.bfloat16)
    v = torch.randn(nb, blk, kvh, d, generator=g).to(torch.bfloat16)
    dev = torch.device("cuda")
    return (q.to(dev), k.to(dev), v.to(dev),
            lengths.to(torch.int32).to(dev), tables.to(dev))


def quantize_pools(torch, k, v):
    """The int8 leg's pools: the port's kv_quantize of the bf16 pools."""
    from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize

    kq, ks = kv_quantize(k)
    vq, vs = kv_quantize(v)
    return kq, vq, ks, vs


def ragged_case(torch, *, b=8, h=32, kvh=8, d=128, s=6144, seed=0):
    """Path c's inputs (Mistral-7B at --max-len 6144): bf16 q and a
    contiguous cache, ragged lengths in [1, S] (both ends included; at
    B=1 the one row is S long)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0], lengths[-1] = 1, s
    q = torch.randn(b, 1, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, kvh, d, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, kvh, d, generator=g).to(torch.bfloat16)
    dev = torch.device("cuda")
    return q.to(dev), k.to(dev), v.to(dev), lengths.to(torch.int32).to(dev)


WINDOW = 4096  # Mistral-7B's sliding window

# The flash kernels' main-path shapes: path g's training sequence (K3) and
# path f's admission (K4): a prompt bucket of 8192 tokens prefilled into a
# 32768-slot row, of which the first 8192 are written.
TRAIN_T = 4096
ADMIT_T = 8192


def flash_case(torch, *, b=1, tq, s=None, h=32, kvh=8, d=128, seed=0):
    """bf16 q [B, Tq, H, D] and k/v [B, S, KVH, D] on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = s or tq

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    return draw(b, tq, h, d), draw(b, s, kvh, d), draw(b, s, kvh, d)


def admission_args(torch, tq, s, first=0, window=WINDOW, causal=True):
    """K4's arguments as the cached prefill passes them: queries at
    positions first..first+tq-1 over slots 0..s-1, the first first+tq of
    them written."""
    qpos = (torch.arange(tq, device="cuda") + first)[None]
    kpos = torch.arange(s, device="cuda")[None]
    return {"q_positions": qpos, "k_positions": kpos,
            "k_valid": kpos < first + tq, "causal": causal, "window": window}


def live_pairs(torch, tq, s, kw=None) -> int:
    """(query row, key slot) pairs a flash call attends: K3's causal
    triangle in closed form, K4's counted from its vectors in row chunks."""
    if kw is None:
        return tq * (tq + 1) // 2
    total = 0
    kp = kw["k_positions"][0]
    for r0 in range(0, tq, 1024):
        qp = kw["q_positions"][0, r0:r0 + 1024, None]
        m = kw["k_valid"][0][None, :].expand(qp.shape[0], s)
        if kw["causal"]:
            m = m & (kp[None, :] <= qp)
        if kw["window"] is not None:
            m = m & (kp[None, :] > qp - kw["window"])
        total += int(m.sum())
    return total

# Absolute tolerance of a library yardstick against the plain version, and
# of K5 (plus TOL_REL_QMM below), on bf16 outputs of magnitude ~1.
TOL = 2e-2
# The decode kernels (K1, K1q, K2, K2q) against their plain versions, per
# output row (one query, one head): L2 error <= DECODE_ROW_REL x the plain
# row's L2 norm.  A row over n slots is ~sqrt(e / n) in size (0.026 over
# K2's 4096-slot band), so the absolute 2e-2 used before would pass a wrong
# band edge, a dropped split or a wrong merge.  Sound kernels differ from
# the plain versions by where bf16 rounds the probabilities (per 8-slot
# update and unnormalized in the split kernels, per 64-slot tile in K1,
# normalized in the plain versions) and by the bf16 output rounding.  The
# int8 legs add one bf16 ulp (2^-7) of each term: the plain version rounds
# the dequantized V (bf16(v_i8 * v_scale)) where the kernels, like the TPU
# kernel, round p * v_scale to bf16 and multiply v_i8 exactly.
# Measured on an H100 80GB HBM3 at 700 W (PERF.md): sound rows at most
# 0.0043 (K1, K2) and 0.0062 (K1q, K2q), so the limits keep 2.3x and 2.9x;
# each fault planted in K2/K2q by decode_mutations.py (a band or length
# edge off by one, a dropped split, a merge without its exp(m_s - M)
# rescale, K2q's sum taken after v_scale) reads 0.17-56 at some shape
# below, the weakest 0.028 (the band edge at batch 1).
DECODE_ROW_REL = 1e-2
DECODE_ROW_REL_INT8 = 1e-2 + 2.0 ** -7
# K5 against its plain version: both round the dequantized weight to bf16
# the same way (float32(q) * scale, round to nearest) and accumulate in
# float32, so they differ by the summation order (WMMA tiles of 16 against
# cuBLAS's float32 product, ~1e-6 relative) and then by at most one bf16
# ulp of the output, 2^-7 |out|; outputs here are of scale ~1-5.
TOL_REL_QMM = 2.0 ** -7
# The flash kernels against flash_reference, per output row (one query,
# one head): L2 error <= FLASH_ROW_REL x the row's L2 norm.  A row that
# averages n live keys is ~sqrt(e / n) in size (0.02 at path f's 4096-key
# window), so an absolute limit would pass a wrong key set at these
# lengths.  Sound kernels differ from the plain version by where bf16
# rounds the probabilities (per 128-slot tile under the running max in
# the kernels, under the row's final max in the plain version), exp2 of
# pre-scaled scores against exp, and the bf16 output rounding; planted
# faults are read by decode_mutations.py (PERF.md).
FLASH_ROW_REL = 1e-2
# K3's bf16 backward against the float32 gradient, relative L2 error of
# each of dq, dk, dv: 0.0023-0.0029 measured on the H100.
GRAD_REL = 1e-2

# K5 at Llama-3-8B's projections, in the weights' own layouts: (label, M,
# weight shape, k_lead, int4 pack axis).  M=8 is a decode step of 8 rows,
# M=512 an admission prefill.
QMM_SHAPES = [
    ("wq", 8, (4096, 32, 128), 1, -3),
    ("wk_wv", 8, (4096, 8, 128), 1, -3),
    ("gate_up", 8, (4096, 14336), 1, -2),
    ("down", 8, (14336, 4096), 1, -2),
    ("wo", 8, (32, 128, 4096), 2, -2),
    ("gate_up_prefill", 512, (4096, 14336), 1, -2),
]
QMM_REPORTED = "gate_up"  # the shape of K5's entries in the JSON line
QMM_ALSO_REPORTED = "down"  # ... and of the "down" entry inside each
QMM_NAMES = {8: "quant_matmul", 4: "quant_matmul_int4"}
# K5 at the edges of its plan (``qmm_plan`` on 132 SMs), each for int8 and
# int4 codes, block 128: (label, M, K, N).  M of 1 and 16 (the decode
# tiles' ends), 17 and 64 (the 64-row prefill tile's: its M tail, and
# full), 65 (the 128-row tile with one row of 65 past the first 64);
# K = 4320 at M = 8 is 67.5 K tiles, cut into 14 splits of 5 with a last
# split of 3 whose last tile is half (uneven splits, a K tail off the
# tiles, int4 pairs at every split edge); the prefill tiles at N = 1024
# split K 16 ways.
QMM_EDGES = [
    ("m1", 1, 4096, 4096),
    ("m16", 16, 4096, 4096),
    ("m17", 17, 4096, 1024),
    ("m64", 64, 4096, 4096),
    ("m65", 65, 4096, 1024),
    ("k_uneven", 8, 4320, 4096),
]


def _held(torch, name, got, want, rel=0.0, **info) -> float:
    """K5's output against its plain version: |err| <= TOL + rel x
    |plain| elementwise; returns the largest |err|.  The line also gives
    the largest |err| / (TOL + rel x |plain|), which passes at <= 1."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} output {tuple(got.shape)}/{got.dtype} vs plain "
          f"{tuple(want.shape)}/{want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} output not finite")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    ratio = (diff / (rel * want.float().abs() + TOL)).max().item()
    tol = f"{TOL} + {rel} * |plain|" if rel else TOL
    emit("kernel", name=name, max_abs_err=err, err_over_limit=ratio, tol=tol,
         **info)
    check(ratio <= 1, f"{name} |err| exceeds {tol} (max |err| {err})")
    return err


def qmm_case(torch, m, wshape, k_lead, pack_axis, bits, seed):
    """bf16 activations [M, K-axes] and a weight drawn like ``init_params``'
    (normal / sqrt(fan_in)), rounded to bf16 and quantized by the port's
    ``quantize``, as ``save_shards`` quantizes a bf16 model."""
    from distributed_llms_tpu_torch.checkpoint.quantize import quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    k = math.prod(wshape[:k_lead])
    w = torch.randn(wshape, generator=g, device="cuda") * k ** -0.5
    qt = quantize(w.to(torch.bfloat16), bits=bits, pack_axis=pack_axis)
    x = torch.randn((m, *wshape[:k_lead]), generator=g,
                    device="cuda").to(torch.bfloat16)
    return x, qt


def qmm_edge_case(torch, m, k, n, bits, seed):
    """bf16 x [M, K] and a [K, N] weight, block 128, as ``qmm_case``."""
    from distributed_llms_tpu_torch.checkpoint.quantize import quantize

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
    qt = quantize(w.to(torch.bfloat16), bits=bits, pack_axis=-2)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    return x, qt


def qmm_kernel_checks(torch) -> dict:
    """K5 (int8 and int4) against its plain version at every
    Llama-3-8B projection of QMM_SHAPES and every plan edge of QMM_EDGES;
    returns each width's largest |err|."""
    from distributed_llms_tpu_torch.ops import quant_matmul

    worst = {}
    for bits, name in QMM_NAMES.items():
        cases = [(label, *qmm_case(torch, m, wshape, k_lead, pack, bits,
                                   seed=20 + i), k_lead,
                  {"M": m, "weight": list(wshape), "k_lead": k_lead})
                 for i, (label, m, wshape, k_lead, pack)
                 in enumerate(QMM_SHAPES)]
        cases += [(label, *qmm_edge_case(torch, m, k, n, bits, seed=60 + i),
                   1, {"M": m, "K": k, "N": n})
                  for i, (label, m, k, n) in enumerate(QMM_EDGES)]
        for label, x, qt, k_lead, info in cases:
            q2, s2 = quant_matmul.flatten_qt(qt, k_lead)
            plan = quant_matmul.qmm_plan(
                x.shape[0], s2.shape[0], q2.shape[1],
                quant_matmul._sm_count(x.device))
            err = _held(torch, name,
                        quant_matmul.quant_contract(x, qt, k_lead),
                        qmm_plain(torch, x, qt, k_lead), rel=TOL_REL_QMM,
                        shape=label, plan=list(plan), **info)
            worst[name] = max(worst.get(name, 0.0), err)
        del cases
    _free(torch)
    return worst


def qmm_plain(torch, x, qt, k_lead):
    """K5's plain version on the flat operands, shaped like the output."""
    from distributed_llms_tpu_torch.ops import quant_matmul

    q2, s2 = quant_matmul.flatten_qt(qt, k_lead)
    out = quant_matmul.quant_matmul_plain(x.reshape(x.shape[0], -1), q2, s2,
                                          qt.bits)
    return out.reshape(x.shape[0], *qt.data.shape[k_lead:])


def paged_edge_lengths(torch, b0=8, p=32, blk=64) -> list:
    """Row lengths at every edge of K1's plan for a [B, p] table of
    ``blk``-slot pages: 0, 1, blk - 1, blk, blk + 1, each split edge +- 1,
    P x blk and P x blk + 1.  B is the count of these lengths (the plan
    follows B, so the edges are searched at the B they produce)."""
    from distributed_llms_tpu_torch.ops import decode_attn

    sm = decode_attn._sm_count(torch.device("cuda"))
    reach, n = p * blk, b0
    for _ in range(8):  # B -> plan -> edges -> B, to a fixed point
        split_len, n_splits = decode_attn.paged_split_plan(n, 8, p, blk, sm)
        lengths = {0, 1, blk - 1, blk, blk + 1, reach, reach + 1}
        for i in range(1, n_splits):
            lengths |= {i * split_len - 1, i * split_len + 1}
        if len(lengths) == n:
            break
        n = len(lengths)
    return sorted(lengths)


# K1/K1q kernel-check shapes: (label, paged_case arguments).  Path a's
# timing shape with and without garbage past each row's depth (2-page
# splits), one row at Llama-3-8B's published 8192-token context at batch 1
# (128 one-page splits), 16-slot pages over 2048 slots (8-page splits,
# tiles straddling pages), and every edge of the plan at the timing shape.
PAGED_CHECKS = [
    ("timing", dict(seed=1)),
    ("timing_garbage", dict(seed=2, garbage=True)),
    ("batch1_8192", dict(b=1, max_len=8192, seed=12, garbage=True)),
    ("page16", dict(blk=16, seed=13, garbage=True)),
    ("edges", dict(seed=14, garbage=True)),
]


def paged_kernel_checks(torch) -> dict:
    """K1 and K1q at PAGED_CHECKS' shapes; rows of length 0 must be exact
    zeros.  Returns the largest |err| of each."""
    from distributed_llms_tpu_torch.ops import decode_attn

    worst = {"paged_decode_attention": 0.0, "paged_decode_attention_int8": 0.0}
    for label, case in PAGED_CHECKS:
        if label == "edges":
            case = dict(case, lengths=paged_edge_lengths(torch))
        q, k, v, lengths, tables = paged_case(torch, **case)
        b, blk, p = q.shape[0], k.shape[1], tables.shape[1]
        info = {"shape": label, "B": b, "BLK": blk, "P": p,
                "split_plan": decode_attn.paged_split_plan(
                    b, k.shape[2], p, blk, decode_attn._sm_count(q.device)),
                "garbage_tables": bool(case.get("garbage"))}
        dead = lengths <= 0
        err = _row_held(torch, "paged_decode_attention",
                        decode_attn.paged_decode_attention(q, k, v, lengths,
                                                           tables),
                        decode_attn.paged_reference(q, k, v, lengths, tables),
                        DECODE_ROW_REL, dead=dead, **info)
        worst["paged_decode_attention"] = max(worst["paged_decode_attention"],
                                              err)
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        err = _row_held(torch, "paged_decode_attention_int8",
                        decode_attn.paged_decode_attention(
                            q, kq, vq, lengths, tables, k_scale=ks,
                            v_scale=vs),
                        decode_attn.paged_reference(q, kq, vq, lengths,
                                                    tables, ks, vs),
                        DECODE_ROW_REL_INT8, dead=dead, **info)
        worst["paged_decode_attention_int8"] = max(
            worst["paged_decode_attention_int8"], err)
        del q, k, v, kq, vq, ks, vs
    _free(torch)
    return worst


def ragged_kernel_checks(torch) -> dict:
    """K2 and K2q at path c's shapes and at batch 1 over one row at
    Mistral-7B's full context, window 4096 and none; returns the largest
    |err| of each."""
    from distributed_llms_tpu_torch.ops import decode_attn

    worst = {"ragged_decode_attention": 0.0,
             "ragged_decode_attention_int8": 0.0}
    for case in (dict(seed=4), dict(b=1, s=FLASH_MAX_LEN, seed=7)):
        q, k, v, lengths = ragged_case(torch, **case)
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        shape = {"B": q.shape[0], "S": k.shape[1]}
        for window in (WINDOW, None):
            plan = decode_attn.ragged_split_plan(
                q.shape[0], k.shape[2], k.shape[1], window,
                decode_attn._sm_count(q.device))
            err = _row_held(torch, "ragged_decode_attention",
                            decode_attn.ragged_decode_attention(
                                q, k, v, lengths, window=window),
                            decode_attn.dense_reference(q, k, v, lengths,
                                                        window),
                            DECODE_ROW_REL, window=window, split_plan=plan,
                            **shape)
            worst["ragged_decode_attention"] = max(
                worst["ragged_decode_attention"], err)
            err = _row_held(torch, "ragged_decode_attention_int8",
                            decode_attn.ragged_decode_attention(
                                q, kq, vq, lengths, window=window,
                                k_scale=ks, v_scale=vs),
                            decode_attn.ragged_reference(
                                q, kq, vq, lengths, window, ks, vs),
                            DECODE_ROW_REL_INT8, window=window,
                            split_plan=plan, **shape)
            worst["ragged_decode_attention_int8"] = max(
                worst["ragged_decode_attention_int8"], err)
        del q, k, v, kq, vq, ks, vs
    _free(torch)
    return worst


def phase_kernel(torch) -> dict:
    worst = {name: 0.0 for name in KERNELS}
    worst.update(paged_kernel_checks(torch))
    worst.update(ragged_kernel_checks(torch))
    worst.update(flash_kernel_checks(torch))
    worst.update(qmm_kernel_checks(torch))
    return {name: {"max_abs_err": e} for name, e in worst.items()}


def row_rel_err(torch, got, want) -> float:
    """The largest error of an attention output row (one query, one head:
    its D values) relative to that row of the plain version, in the L2
    norm.  A zero row of the plain version (a query with no live key)
    must be zero: its ratio is 0 if so, else infinite."""
    diff = (got.float() - want.float()).norm(dim=-1)
    ref = want.float().norm(dim=-1)
    ratio = torch.where(ref > 0, diff / ref.clamp_min(1e-30),
                        torch.where(diff > 0, math.inf, 0.0))
    return ratio.max().item()


def _row_held(torch, name, got, want, limit, dead=None, **info) -> float:
    """An attention kernel's output against its plain version, row by row:
    L2 error <= ``limit`` x the plain row's L2 norm; returns the largest
    |err| for the JSON line.  ``dead`` ([B] bool): rows with no live slot,
    which must be exact zeros (the plain version averages every slot
    there, so they are held apart)."""
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name} output {tuple(got.shape)}/{got.dtype} vs plain "
          f"{tuple(want.shape)}/{want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{name} output not finite")
    if dead is not None and bool(dead.any()):
        dead_max = got[dead].float().abs().max().item()
        info["dead_rows"], info["dead_rows_max_abs"] = int(dead.sum()), dead_max
        check(dead_max == 0.0, f"{name} row with no live slot is not zero "
              f"({dead_max})")
        got, want = got[~dead], want[~dead]
    err = (got.float() - want.float()).abs().max().item()
    rel = row_rel_err(torch, got, want)
    emit("kernel", name=name, max_abs_err=err, max_row_rel_err=rel,
         tol=f"row L2 error <= {limit} x row L2 norm",
         plain_mean_abs=want.float().abs().mean().item(), **info)
    check(rel <= limit, f"{name} row error {rel} exceeds {limit} of the row")
    return err


# K3 against flash_reference: (case, B, T, H, KVH, D, window).  Path g's
# sequence and twice it under Mistral-7B's window; lengths off the 128-row
# query tiles (4097: one row past, 127: one short); head dims 64 and 256.
FLASH_STATIC_CHECKS = [
    ("train", 1, TRAIN_T, 32, 8, 128, None),
    ("train_window", 1, 2 * TRAIN_T, 32, 8, 128, WINDOW),
    ("off_tiles_4097", 1, TRAIN_T + 1, 32, 8, 128, None),
    ("off_tiles_127", 1, 127, 32, 8, 128, None),
    ("d64", 2, 1000, 8, 2, 64, 300),
    ("d256", 1, 600, 16, 16, 256, None),
]


def flash_dynamic_checks(torch):
    """K4's cases: (case, B, Tq, S, KVH, D, keyword arguments).  Path f's
    admission, without causality or window, offset queries (first position
    5000, and 4097, where each 128-row query tile ends on the first slot
    of a key tile: a dead-tile rule that is off by one drops a live tile
    there), two rows written to different lengths (the summary is per
    row), shuffled positions (the summary is loose), a short admission of
    16 queries over 32768 slots, query rows with no live key, and head
    dims 64 and 256."""
    s = FLASH_MAX_LEN
    dev = "cuda"
    cases = [("admission", 1, ADMIT_T, s, 8, 128,
              admission_args(torch, ADMIT_T, s)),
             ("admission_not_causal", 1, ADMIT_T, s, 8, 128,
              admission_args(torch, ADMIT_T, s, 0, None, False)),
             ("offset_5000", 1, 1000, s, 8, 128,
              admission_args(torch, 1000, s, 5000)),
             ("first_off_tiles_4097", 1, 1000, s, 8, 128,
              admission_args(torch, 1000, s, 4097)),
             ("short_admission", 1, 16, s, 8, 128,
              admission_args(torch, 16, s, 8000))]
    # Rows written to 3000 and 8192 slots, each admitting its last 1024.
    written = torch.tensor([[3000], [8192]], device=dev)
    kpos = torch.arange(8192, device=dev).expand(2, 8192)
    cases.append(("per_row_lengths", 2, 1024, 8192, 8, 128, {
        "q_positions": written - 1024 + torch.arange(1024, device=dev),
        "k_positions": kpos, "k_valid": kpos < written, "window": WINDOW}))
    g = torch.Generator(device="cpu").manual_seed(70)
    perm = torch.randperm(8192, generator=g).to(dev)[None]
    cases.append(("shuffled", 1, 1024, 8192, 8, 128, {
        "q_positions": perm[:, :1024], "k_positions": perm, "window": 700}))
    # Row 0 sees slots from position 100 on: its queries at 0..99 have no
    # live key; row 1 is an ordinary prefill at an offset.
    kpos = torch.arange(2048, device=dev).expand(2, 2048)
    first = torch.tensor([[0], [1500]], device=dev)
    cases.append(("rows_without_keys", 2, 256, 2048, 8, 128, {
        "q_positions": first + torch.arange(256, device=dev),
        "k_positions": kpos,
        "k_valid": torch.stack([kpos[0] >= 100, kpos[1] < 1756])}))
    cases.append(("d64", 2, 300, 1500, 2, 64, {
        "q_positions": first + torch.arange(300, device=dev),
        "k_positions": kpos[:, :1500], "k_valid": kpos[:, :1500] < first + 300,
        "window": 100}))
    cases.append(("d256", 1, 200, 700, 4, 256, {
        "q_positions": 500 + torch.arange(200, device=dev)[None],
        "k_positions": kpos[:1, :700]}))
    return cases


def _dead_rows(torch, kw, b, tq, s):
    """[B, Tq] bool: query rows with no live key slot (small cases only)."""
    qp = kw["q_positions"].expand(b, tq).long()[:, :, None]
    kp = kw["k_positions"].expand(b, s).long()[:, None, :]
    live = kw.get("k_valid", torch.ones(b, s, dtype=torch.bool,
                                        device=qp.device))[:, None, :]
    if kw.get("causal", True):
        live = live & (kp <= qp)
    if kw.get("window") is not None:
        live = live & (kp > qp - kw["window"])
    return ~live.any(-1)


def flash_kernel_checks(torch) -> dict:
    """K3 (FLASH_STATIC_CHECKS) and K4 (flash_dynamic_checks) against
    ``flash_reference``, each output row within FLASH_ROW_REL of the plain
    row and rows with no live key exactly zero; K4's pre-pass against its
    plain version, exactly; K3's backward (bf16) against the float32
    gradient of ``dense_reference``."""
    from distributed_llms_tpu_torch.ops import flash

    worst = {"flash_attention_static": 0.0, "flash_attention_dynamic": 0.0,
             "flash_tile_summary": 0.0}
    for case, b, t, h, kvh, d, window in FLASH_STATIC_CHECKS:
        q, k, v = flash_case(torch, b=b, tq=t, h=h, kvh=kvh, d=d,
                             seed=30 + t)
        err = _row_held(torch, "flash_attention_static",
                        flash.flash_attention(q, k, v, window=window),
                        flash.flash_reference(q, k, v, window=window),
                        FLASH_ROW_REL, case=case, B=b, T=t, H=h, KVH=kvh,
                        D=d, window=window)
        worst["flash_attention_static"] = max(
            worst["flash_attention_static"], err)
        del q, k, v
    for case, b, tq, s, kvh, d, kw in flash_dynamic_checks(torch):
        q, k, v = flash_case(torch, b=b, tq=tq, s=s, kvh=kvh, d=d,
                             seed=40 + tq)
        dead = (_dead_rows(torch, kw, b, tq, s) if s * tq <= 1 << 24
                else None)
        err = _row_held(torch, "flash_attention_dynamic",
                        flash.flash_attention(q, k, v, **kw),
                        flash.flash_reference(q, k, v, **kw),
                        FLASH_ROW_REL, dead=dead, case=case, B=b, Tq=tq,
                        S=s, KVH=kvh, D=d, causal=kw.get("causal", True),
                        window=kw.get("window"))
        worst["flash_attention_dynamic"] = max(
            worst["flash_attention_dynamic"], err)
        kp = kw["k_positions"].expand(b, s).to(torch.int32).contiguous()
        kv = kw.get("k_valid", torch.ones(b, s, dtype=torch.bool,
                                          device="cuda")).to(torch.int32)
        got = flash.tile_summary(kp, kv, flash.KEY_TILE[d])
        want = flash.tile_summary_reference(kp, kv, flash.KEY_TILE[d])
        torch.cuda.synchronize()
        diff = (got.long() - want.long()).abs().max().item()
        emit("kernel", name="flash_tile_summary", case=case, B=b, S=s,
             key_tile=flash.KEY_TILE[d], tiles=got.shape[1],
             max_abs_err=diff, tol="exact")
        check(torch.equal(got, want),
              f"flash_tile_summary differs from its plain version ({case})")
        worst["flash_tile_summary"] = max(worst["flash_tile_summary"], diff)
        del q, k, v
    # K3's backward is the dense recompute in bf16; held against the exact
    # (float32) gradient of the same attention, it shows that the recompute
    # differentiates the attention the forward computed.
    q, k, v = flash_case(torch, tq=TRAIN_T, seed=50)
    cot = flash_case(torch, tq=TRAIN_T, seed=51)[0]
    grads = []
    for f, dtype in ((flash.flash_attention, torch.bfloat16),
                     (flash.dense_reference, torch.float32)):
        args = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        (f(*args).float() * cot.float()).sum().backward()
        grads.append([a.grad.float() for a in args])
        del args
    for name, got, want in zip("qkv", *grads):
        rel = ((got - want).norm() / want.norm()).item()
        emit("kernel", name="flash_attention_static_backward", grad_of=name,
             T=TRAIN_T, rel_err=rel, tol=GRAD_REL)
        check(rel <= GRAD_REL,
              f"K3 backward: d{name} off the float32 gradient by {rel}")
    del grads
    _free(torch)
    return worst


def cuda_ms(torch, fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(kv_bytes: int, io_bytes: int, flops: int) -> tuple[float, str]:
    """The least time for the work: the larger of its bytes over the
    memory rate and its operations over the bf16 peak."""
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _turns(torch, kernel, plain, library, plain_iters=20, iters=50,
           plain_warmup=5) -> dict:
    """Turns (plain, kernel, kernel, plain) in one call: compare within
    it.  The library yardstick last."""
    plain_a = cuda_ms(torch, plain, iters=plain_iters, warmup=plain_warmup)
    kern_a = cuda_ms(torch, kernel, iters=iters)
    kern_b = cuda_ms(torch, kernel, iters=iters)
    plain_b = cuda_ms(torch, plain, iters=plain_iters, warmup=plain_warmup)
    return {"ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
            "library_ms": (cuda_ms(torch, library, iters=iters)
                           if library else None),
            "kernel_ms_turns": [kern_a, kern_b],
            "plain_ms_turns": [plain_a, plain_b]}


def _timed(name, shapes, t, bound_ms, bound_by, data_bytes, **info) -> dict:
    """Emit one timing line; ``data_bytes`` is the bulk the kernel streams
    (K/V slots, or weight codes and scales)."""
    emit("timing", name=name, shapes=shapes, kernel_ms=t["kernel_ms_turns"],
         plain_ms=t["plain_ms_turns"], library_ms=t["library_ms"],
         bound_ms=bound_ms, bound_by=bound_by, data_bytes=data_bytes,
         achieved_tb_s=data_bytes / (t["ms"] * 1e-3) / 1e12, **info)
    return {"ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"]}


def phase_timing(torch) -> dict:
    out = {}
    out.update(paged_timing(torch))
    out.update(ragged_timing(torch))
    out.update(flash_timing(torch))
    out.update(qmm_timing(torch))
    return out


def _paged_timed(torch, name, q, k, v, lengths, tables, scales=(),
                 **info) -> dict:
    """K1 (or K1q, with ``scales``) on these inputs against its plain
    version and SDPA over each row's pages gathered and padded (over the
    dequantized rows for K1q), the kernel and SDPA rotated over copies of
    the pool holding >= L2_ROTATION_BYTES of live K/V.  SDPA's rows are
    gathered before the timer starts: it is spared the gather."""
    import torch.nn.functional as F

    from distributed_llms_tpu_torch.checkpoint.quantize import kv_dequantize
    from distributed_llms_tpu_torch.ops import decode_attn

    b, _, h, d = q.shape
    _, blk, kvh, _ = k.shape
    p = tables.shape[1]
    lens = lengths.long().clamp(0, p * blk)
    live = int(lens.sum())
    depth = (lens + blk - 1) // blk
    # Least work the function needs on these inputs: each live slot's K
    # and V once (and, int8, its two scales), q and out once, the lengths
    # and the table entries in reach; 2 operations per multiply-add for QK
    # and for PV.
    kv_bytes = live * kvh * ((d + 4) * 2 if scales else d * 2 * 2)
    io_bytes = 2 * q.numel() * 2 + b * 4 + int(depth.sum()) * 4
    copies = _kv_copies(torch, k, v, scales, kv_bytes)
    qt = q.transpose(1, 2).contiguous()  # [B, H, 1, D]
    safe = torch.where(torch.arange(p, device=q.device)[None, :]
                       < depth[:, None], tables.long(), 0)
    mask = (torch.arange(p * blk, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]

    def rows(kc, vc, *sc):  # each row's pages gathered, [B, KVH, S, D] bf16
        if sc:
            kc = kv_dequantize(kc, sc[0], torch.bfloat16)
            vc = kv_dequantize(vc, sc[1], torch.bfloat16)
        return tuple(pool[safe].reshape(b, p * blk, kvh, d).transpose(1, 2)
                     .contiguous() for pool in (kc, vc))

    def kern(c):
        kc, vc, *sc = c
        return lambda: decode_attn.paged_decode_attention(
            q, kc, vc, lengths, tables,
            **({"k_scale": sc[0], "v_scale": sc[1]} if sc else {}))

    def lib(kr, vr):
        return lambda: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=mask, enable_gqa=True)

    lib_kv = [rows(*c) for c in copies]
    ref = decode_attn.paged_reference(q, k, v, lengths, tables, *scales)
    lib_err = (lib(*lib_kv[0])().transpose(1, 2).float()
               - ref.float()).abs().max().item()
    check(lib_err <= TOL, f"{name} library yardstick disagrees ({lib_err})")
    del ref
    t = _turns(torch, _rotate([kern(c) for c in copies]),
               lambda: decode_attn.paged_reference(q, k, v, lengths, tables,
                                                   *scales),
               _rotate([lib(*kv) for kv in lib_kv]), plain_iters=5)
    split_len, n_splits = decode_attn.paged_split_plan(
        b, kvh, p, blk, decode_attn._sm_count(q.device))
    timed = _timed(
        name, {"B": b, "H": h, "KVH": kvh, "D": d, "BLK": blk, "P": p,
               "sum_lengths": live, "min_length": int(lens.min()),
               "max_length": int(lens.max())},
        t, *_bound(kv_bytes, io_bytes, 4 * live * h * d), kv_bytes,
        split_len=split_len, n_splits=n_splits, pool_copies=len(copies),
        device_ms_per_call=_device_ms(torch, _rotate([kern(c)
                                                      for c in copies])),
        host_enqueue_ms_per_call=_enqueue_ms(
            torch, _rotate([kern(c) for c in copies])),
        library="F.scaled_dot_product_attention(attn_mask=lengths, "
                "enable_gqa=True) over each row's pages gathered and "
                "padded before the timer (spared the gather)"
                + (", dequantized" if scales else ""), **info)
    del copies, lib_kv
    return timed


PAGED_SPLIT_SWEEP = (1, 2, 4, 8, 16, 32)  # pages a split


def paged_split_sweep(torch, q, k, v, lengths, tables) -> None:
    """K1 at each split of PAGED_SPLIT_SWEEP pages on these inputs, the
    pool rotated as in the timing lines: CUDA-event ms per call and the
    device ms of its two kernels — what the planner's choice costs against
    the others.  Information, not a gate."""
    from distributed_llms_tpu_torch.ops import decode_attn

    b, blk, kvh = q.shape[0], k.shape[1], k.shape[2]
    p = tables.shape[1]
    live = int(lengths.long().clamp(0, p * blk).sum())
    copies = _kv_copies(torch, k, v, (), live * kvh * k.shape[3] * 4)
    planner = decode_attn.paged_split_plan
    times, device = {}, {}
    try:
        for pages in PAGED_SPLIT_SWEEP:
            if pages > p:
                continue
            decode_attn.paged_split_plan = (
                lambda *a, _p=(pages * blk, -(-p // pages)): _p)
            run = _rotate([
                lambda c=c: decode_attn.paged_decode_attention(
                    q, c[0], c[1], lengths, tables) for c in copies])
            times[pages * blk] = cuda_ms(torch, run)
            device[pages * blk] = sum(_device_ms(torch, run).values())
    finally:
        decode_attn.paged_split_plan = planner
    emit("split_sweep", name="paged_decode_attention", B=b, BLK=blk, P=p,
         planned=planner(b, kvh, p, blk, decode_attn._sm_count(q.device)),
         kernel_ms_by_split_len=times, device_ms_by_split_len=device,
         pool_copies=len(copies))


# Path a's decode rows: 300-token prompts (the profile phase's) and up to
# 64 new tokens, in a table of max_len 1024 / 64 = 16 pages.
PATH_A_LENGTHS = (300, 364)


def paged_timing(torch) -> dict:
    """K1 and K1q at the smoke's timing shape (B=8, 2048-slot tables,
    lengths 1..2048) and at path a's own (B=8, 16 pages, lengths
    300..364), rotated over pool copies; the split-length sweep of K1 at
    both and at batch 1 over one 8192-slot row."""
    out = {}
    gen = torch.Generator().manual_seed(9)
    path_a = torch.randint(PATH_A_LENGTHS[0], PATH_A_LENGTHS[1] + 1, (8,),
                           generator=gen).tolist()
    for label, case in (("timing", dict(seed=3)),
                        ("path_a", dict(max_len=1024, lengths=path_a,
                                        seed=10))):
        q, k, v, lengths, tables = paged_case(torch, **case)
        timed = _paged_timed(torch, "paged_decode_attention", q, k, v,
                             lengths, tables, shape=label)
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        timed_q = _paged_timed(torch, "paged_decode_attention_int8", q, kq,
                               vq, lengths, tables, (ks, vs), shape=label)
        if label == "timing":
            out["paged_decode_attention"] = timed
            out["paged_decode_attention_int8"] = timed_q
        paged_split_sweep(torch, q, k, v, lengths, tables)
        del q, k, v, kq, vq, ks, vs
        _free(torch)
    q, k, v, lengths, tables = paged_case(torch, b=1, max_len=8192, seed=11)
    paged_split_sweep(torch, q, k, v, lengths, tables)
    del q, k, v
    _free(torch)
    return out


def _ragged_bytes(k, lengths, window, quant) -> tuple[int, int]:
    """(band slots summed over the rows, bytes of K/V the function must
    read): each row's band is [length - window, length) cut to the
    cache; a slot and head is D x 2 bytes of bf16 K and V, or D int8 bytes
    and a float32 scale of each for K2q."""
    s, kvh, d = k.shape[1], k.shape[2], k.shape[3]
    lens = lengths.long()
    end = lens.clamp(min=0, max=s)
    lo = 0 if window is None else (lens - window).clamp(min=0)
    band = int((end - lo).clamp(min=0).sum())
    return band, band * kvh * ((d + 4) * 2 if quant else d * 2 * 2)


def _kv_copies(torch, k, v, scales, kv_bytes):
    """The cache (or page pool) and its copies: enough that a rotation over
    them reads at least L2_ROTATION_BYTES of live K/V (``kv_bytes`` a
    call), so no launch finds its rows in the L2 cache, as a decode step
    finds each layer's cache cold."""
    n = max(1, math.ceil(L2_ROTATION_BYTES / kv_bytes))
    return [(k, v, *scales)] + [tuple(t.clone() for t in (k, v, *scales))
                                for _ in range(n - 1)]


def _ragged_timed(torch, name, q, k, v, lengths, window, scales=()) -> dict:
    """K2 (or K2q, with ``scales``) on these inputs against its plain
    version and SDPA with the band mask (over the dequantized cache for
    K2q), the kernel and SDPA rotated over copies of the cache."""
    import torch.nn.functional as F

    from distributed_llms_tpu_torch.checkpoint.quantize import kv_dequantize
    from distributed_llms_tpu_torch.ops import decode_attn

    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    lens = lengths.long()
    band, kv_bytes = _ragged_bytes(k, lengths, window, bool(scales))
    copies = _kv_copies(torch, k, v, scales, kv_bytes)
    slots = torch.arange(s, device=q.device)[None, :]
    m = slots < lens[:, None]
    if window is not None:
        m = m & (slots >= lens[:, None] - window)
    m = m[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()

    def dense(kc, vc, *sc):  # [B, KVH, S, D] bf16 for SDPA
        if sc:
            kc = kv_dequantize(kc, sc[0], torch.bfloat16)
            vc = kv_dequantize(vc, sc[1], torch.bfloat16)
        return (kc.transpose(1, 2).contiguous(),
                vc.transpose(1, 2).contiguous())

    lib_kv = [dense(*c) for c in copies]

    def kern(c):
        kc, vc, *sc = c
        return lambda: decode_attn.ragged_decode_attention(
            q, kc, vc, lengths, window=window,
            **({"k_scale": sc[0], "v_scale": sc[1]} if sc else {}))

    def lib(kr, vr):
        return lambda: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=m, enable_gqa=True)

    ref = decode_attn.ragged_reference(q, k, v, lengths, window, *scales)
    lib_err = (lib(*lib_kv[0])().transpose(1, 2).float()
               - ref.float()).abs().max().item()
    check(lib_err <= TOL, f"{name} library yardstick disagrees ({lib_err})")
    del ref
    t = _turns(torch, _rotate([kern(c) for c in copies]),
               lambda: decode_attn.ragged_reference(q, k, v, lengths, window,
                                                    *scales),
               _rotate([lib(*kv) for kv in lib_kv]), plain_iters=5)
    split_len, n_splits = decode_attn.ragged_split_plan(
        b, kvh, s, window, decode_attn._sm_count(q.device))
    device_ms = _device_ms(torch, _rotate([kern(c) for c in copies]))
    enqueue_ms = _enqueue_ms(torch, _rotate([kern(c) for c in copies]))
    timed = _timed(
        name, {"B": b, "H": h, "KVH": kvh, "D": d, "S": s, "window": window,
               "sum_band": band},
        t, *_bound(kv_bytes, 2 * q.numel() * 2 + b * 4, 4 * band * h * d),
        kv_bytes,
        split_len=split_len, n_splits=n_splits, cache_copies=len(copies),
        device_ms_per_call=device_ms, host_enqueue_ms_per_call=enqueue_ms,
        library="F.scaled_dot_product_attention(attn_mask=band, "
                "enable_gqa=True)" + (" over the dequantized cache"
                                      if scales else ""))
    del copies, lib_kv
    return timed


def _enqueue_ms(torch, fn, calls=50) -> float:
    """Host milliseconds per call of ``fn`` to enqueue its work (no
    synchronisation between calls): where it reaches the CUDA-event time,
    the calls are bound by the host, not the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def _device_ms(torch, fn, calls=20) -> dict:
    """Device milliseconds per call of ``fn``, by kernel (the profiler's
    CUDA events), beside the CUDA-event time of the calls, which also
    counts the gaps between kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = ("merge" if "split_decode_merge" in e.name else
                    "split" if "decode_kernel" in e.name else
                    _function_name(e.name))
            out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / calls
    return out


def _function_name(name: str) -> str:
    """A device function's name without its template arguments and
    parameters (the first 60 characters where none is found)."""
    import re

    m = re.search(r"(\w+)(?:<|\()", name)
    return m.group(1) if m else name[:60]


SPLIT_SWEEP = (64, 128, 256, 512, 1024, 4096)


def ragged_split_sweep(torch, name, q, k, v, lengths, window,
                       scales=()) -> None:
    """K2 (K2q) at each split length of SPLIT_SWEEP on these inputs, the
    cache rotated as in the timing lines: CUDA-event ms per call and the
    device ms of its two kernels — what the planner's choice costs against
    the others.  Information, not a gate."""
    from distributed_llms_tpu_torch.ops import decode_attn

    s, kvh = k.shape[1], k.shape[2]
    span = s if window is None else min(s, window)
    copies = _kv_copies(torch, k, v, scales,
                        _ragged_bytes(k, lengths, window, bool(scales))[1])
    kw = [{"k_scale": c[2], "v_scale": c[3]} if scales else {} for c in copies]
    planner = decode_attn.ragged_split_plan
    times, device = {}, {}
    try:
        for split_len in SPLIT_SWEEP:
            if split_len > span and split_len != SPLIT_SWEEP[0]:
                continue
            n_splits = math.ceil(span / split_len)
            decode_attn.ragged_split_plan = (
                lambda *a, _p=(split_len, n_splits): _p)
            run = _rotate([
                lambda c=c, x=x: decode_attn.ragged_decode_attention(
                    q, c[0], c[1], lengths, window=window, **x)
                for c, x in zip(copies, kw)])
            times[split_len] = cuda_ms(torch, run)
            device[split_len] = sum(_device_ms(torch, run).values())
    finally:
        decode_attn.ragged_split_plan = planner
    emit("split_sweep", name=name, B=q.shape[0], S=s, window=window,
         planned=planner(q.shape[0], kvh, s, window,
                         decode_attn._sm_count(q.device)),
         kernel_ms_by_split_len=times, device_ms_by_split_len=device,
         cache_copies=len(copies))


def ragged_timing(torch) -> dict:
    """K2 at path c's shapes (window 4096 and none) and at batch 1 over one
    row of Mistral-7B's full context (window 4096); K2q at both with the
    window; then the split-length sweep."""
    out = {}
    for case in (dict(seed=5), dict(b=1, s=FLASH_MAX_LEN, seed=8)):
        q, k, v, lengths = ragged_case(torch, **case)
        batch1 = q.shape[0] == 1
        for window in ((WINDOW,) if batch1 else (WINDOW, None)):
            timed = _ragged_timed(torch, "ragged_decode_attention", q, k, v,
                                  lengths, window)
            if window == WINDOW and not batch1:
                out["ragged_decode_attention"] = timed
        kq, vq, ks, vs = quantize_pools(torch, k, v)
        timed = _ragged_timed(torch, "ragged_decode_attention_int8", q, kq,
                              vq, lengths, WINDOW, (ks, vs))
        if not batch1:
            out["ragged_decode_attention_int8"] = timed
        ragged_split_sweep(torch, "ragged_decode_attention", q, k, v,
                           lengths, WINDOW)
        ragged_split_sweep(torch, "ragged_decode_attention_int8", q, kq, vq,
                           lengths, WINDOW, (ks, vs))
        del q, k, v, kq, vq, ks, vs
        _free(torch)
    return out


def flash_timing(torch) -> dict:
    """K3 at path g's shapes and K4 at path f's admission against the plain
    version and SDPA.  Bound: 4 operations (QK and PV, a multiply-add
    each) per live (row, key) pair, head dim and head at the bf16 peak,
    against q, k, v and out read or written once (and K4's vectors)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from distributed_llms_tpu_torch.ops import flash

    out = {}
    # K3: causal self-attention over the training sequence.  Library:
    # SDPA's causal kernel with grouped-query attention.
    q, k, v = flash_case(torch, tq=TRAIN_T, seed=60)
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    ref = flash.flash_reference(q, k, v)
    lib_err = (library().transpose(1, 2).float() - ref.float()).abs().max().item()
    check(lib_err <= TOL, f"K3 library yardstick disagrees ({lib_err})")
    pairs = live_pairs(torch, t, t)
    io = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    tm = _turns(torch, lambda: flash.flash_attention(q, k, v),
                lambda: flash.flash_reference(q, k, v), library,
                plain_iters=3, iters=20, plain_warmup=1)
    dev = _device_ms(torch, lambda: flash.flash_attention(q, k, v))
    out["flash_attention_static"] = _timed(
        "flash_attention_static",
        {"B": b, "T": t, "H": h, "KVH": kvh, "D": d, "causal": True,
         "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h * b), io,
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        achieved_tflop_s=4 * pairs * d * h * b / (tm["ms"] * 1e-3) / 1e12,
        device_ms_per_call=dev,
        device_tflop_s=4 * pairs * d * h * b / (dev["flash_kernel"] * 1e-3)
        / 1e12,
        library_device_ms_per_call=_device_ms(torch, library),
        tiles=_tile_config(flash, d, False))
    del q, k, v, qt, kt, vt, ref

    # K4: path f's admission.  Library: SDPA with the boolean mask of the
    # same live pairs, K/V heads expanded (SDPA's masked kernels take no
    # grouped heads); the expansion and the mask are built outside the
    # timed call.
    s = FLASH_MAX_LEN
    q, k, v = flash_case(torch, tq=ADMIT_T, s=s, seed=61)
    kw = admission_args(torch, ADMIT_T, s)
    g = h // kvh
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    kp = kw["k_positions"][0]
    qp = kw["q_positions"][0]
    mask = ((kp[None, :] <= qp[:, None]) & kw["k_valid"][0][None, :]
            & (kp[None, :] > qp[:, None] - WINDOW))[None, None]

    def library():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    ref = flash.flash_reference(q, k, v, **kw)
    try:
        lib_out = library()
    except RuntimeError as e:  # no masked kernel takes these shapes
        emit("timing", name="flash_attention_dynamic", library_error=str(e))
        library = lib_out = None
    if lib_out is not None:
        lib_err = (lib_out.transpose(1, 2).float() - ref.float()).abs().max().item()
        check(lib_err <= TOL, f"K4 library yardstick disagrees ({lib_err})")
    del ref, lib_out
    pairs = live_pairs(torch, ADMIT_T, s, kw)
    io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (ADMIT_T + 2 * s)
    tm = _turns(torch, lambda: flash.flash_attention(q, k, v, **kw),
                lambda: flash.flash_reference(q, k, v, **kw), library,
                plain_iters=1, iters=10, plain_warmup=1)
    # Device time by function: the kernel, its pre-pass, and the wrapper's
    # int32 conversions of the position and validity vectors.
    dev = _device_ms(torch, lambda: flash.flash_attention(q, k, v, **kw))
    out["flash_attention_dynamic"] = _timed(
        "flash_attention_dynamic",
        {"B": b, "Tq": ADMIT_T, "S": s, "H": h, "KVH": kvh, "D": d,
         "window": WINDOW, "written": ADMIT_T, "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h * b), io,
        library="F.scaled_dot_product_attention(attn_mask=bool) under "
                "EFFICIENT_ATTENTION/CUDNN_ATTENTION, K/V heads expanded",
        achieved_tflop_s=4 * pairs * d * h * b / (tm["ms"] * 1e-3) / 1e12,
        device_ms_per_call=dev,
        device_tflop_s=4 * pairs * d * h * b / (dev["flash_kernel"] * 1e-3)
        / 1e12,
        library_device_ms_per_call=(_device_ms(torch, library) if library
                                    else None),
        tiles=_tile_config(flash, d, True))
    del qt, kt, vt, mask

    # K4's pre-pass alone at the admission's vectors.  Plain version: the
    # same table from torch reductions on the card.  Bound: the vectors
    # read once and the table written once.
    bk = flash.KEY_TILE[d]
    kp = kw["k_positions"].to(torch.int32).contiguous()
    kv = kw["k_valid"].to(torch.int32).contiguous()
    n_tiles = -(-s // bk)
    io = 4 * 2 * s + 16 * n_tiles
    tm = _turns(torch, lambda: flash.tile_summary(kp, kv, bk),
                lambda: flash.tile_summary_reference(kp, kv, bk), None)
    out["flash_tile_summary"] = _timed(
        "flash_tile_summary", {"B": b, "S": s, "key_tile": bk,
                               "tiles": n_tiles},
        tm, *_bound(0, io, 0), io,
        device_ms_per_call=_device_ms(
            torch, lambda: flash.tile_summary(kp, kv, bk)))

    # A short admission (information): 16 queries over the 32768 slots
    # launch one query tile a head, 32 blocks on 132 SMs.
    q16 = q[:, :16].contiguous()
    kw16 = admission_args(torch, 16, s, 8000)
    pairs = live_pairs(torch, 16, s, kw16)
    emit("timing", name="flash_attention_dynamic", shape="short_admission",
         shapes={"B": b, "Tq": 16, "S": s, "first_position": 8000,
                 "window": WINDOW, "live_pairs_per_head": pairs},
         kernel_ms=cuda_ms(torch, lambda: flash.flash_attention(
             q16, k, v, **kw16), iters=20),
         device_ms_per_call=_device_ms(torch, lambda: flash.flash_attention(
             q16, k, v, **kw16)),
         bound_ms=_bound(0, 2 * (2 * q16.numel() + k.numel() + v.numel()),
                         4 * pairs * d * h * b)[0])
    del q, k, v, q16
    _free(torch)
    return out


def _tile_config(flash, d, dynamic) -> dict:
    """The tile configuration of a flash kernel instantiation."""
    got = flash.flash_kernel_resources(d, dynamic)
    return {key: got[key] for key in ("threads", "query_tile", "key_tile",
                                      "stages", "smem_bytes")}


# A decode step reads each layer's weights once, cold; a weight that fits
# in the 50 MB L2 cache would time warm if launched on itself.  The K5
# timings rotate over copies of their operands that hold at least this
# many bytes in all.
L2_ROTATION_BYTES = 150e6


def _rotate(fns):
    """One callable that runs ``fns`` in turn."""
    state = {"i": 0}

    def run():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()

    return run


QMM_SPLIT_SWEEP = (1, 2, 4, 8, 16)  # splits of K (at most MAX_SPLITS)
QMM_SWEPT = ("down", "wk_wv")


def qmm_timing(torch) -> dict:
    """K5 at each Llama-3-8B projection shape, int8 and int4, against its
    plain version and cuBLAS over the pre-dequantized bf16 weight, each
    rotated over >= L2_ROTATION_BYTES of operand copies: CUDA-event times,
    the plan, the profiler's device time of K5 and of cuBLAS, and the
    host's enqueue time per call; then, at down and wk/wv, a sweep of split
    counts."""
    from distributed_llms_tpu_torch.checkpoint.quantize import (
        QuantizedTensor, dequantize)
    from distributed_llms_tpu_torch.ops import quant_matmul

    out, also = {}, {}
    for bits, name in QMM_NAMES.items():
        for i, (label, m, wshape, k_lead, pack) in enumerate(QMM_SHAPES):
            x, qt = qmm_case(torch, m, wshape, k_lead, pack, bits, seed=40 + i)
            q2, s2 = quant_matmul.flatten_qt(qt, k_lead)
            k, n = s2.shape[0], q2.shape[1]
            w_bytes = q2.numel() + s2.numel() * 4
            copies = max(1, math.ceil(L2_ROTATION_BYTES / w_bytes))
            qts = [qt] + [QuantizedTensor(qt.data.clone(), qt.scale.clone(),
                                          qt.bits, qt.orig_shape,
                                          qt.pack_axis)
                          for _ in range(copies - 1)]
            x2 = x.reshape(m, k)
            w16 = [dequantize(q, torch.bfloat16).reshape(k, n) for q in
                   qts[:math.ceil(L2_ROTATION_BYTES / (2 * k * n))]]
            plain = qmm_plain(torch, x, qt, k_lead).reshape(m, n).float()
            lib_err = ((torch.matmul(x2, w16[0]).float() - plain).abs()
                       - TOL_REL_QMM * plain.abs()).max().item()
            check(lib_err <= TOL, f"K5 library yardstick disagrees ({label})")

            def kern():
                return _rotate([lambda q=q: quant_matmul.quant_contract(
                    x, q, k_lead) for q in qts])

            def lib():
                return _rotate([lambda w=w: torch.matmul(x2, w) for w in w16])

            t = _turns(
                torch, kern(),
                _rotate([lambda q=q: qmm_plain(torch, x, q, k_lead)
                         for q in qts]), lib())
            io_bytes = 2 * m * k + 2 * m * n
            timed = _timed(
                name, {"shape": label, "M": m, "K": k, "N": n,
                       "weight": list(wshape), "k_lead": k_lead,
                       "bits": bits, "operand_copies": copies},
                t, *_bound(w_bytes, io_bytes, 2 * m * k * n), w_bytes,
                plan=list(quant_matmul.qmm_plan(
                    m, k, n, quant_matmul._sm_count(x.device))),
                device_ms_per_call=_device_ms(torch, kern()),
                library_device_ms_per_call=_device_ms(torch, lib()),
                host_enqueue_ms_per_call=_enqueue_ms(torch, kern()),
                library="torch.matmul over the pre-dequantized bf16 weight "
                        "(cuBLAS; reads 2 bytes per weight, twice int8's "
                        "codes and four times int4's)")
            if label == QMM_REPORTED:
                out[name] = timed
            elif label == QMM_ALSO_REPORTED:
                also[name] = timed
            if label in QMM_SWEPT:
                qmm_split_sweep(torch, name, label, x, qts, k_lead)
            del qts, w16
            _free(torch)
    for name, timed in out.items():
        timed[QMM_ALSO_REPORTED] = also[name]
    return out


def qmm_split_sweep(torch, name, label, x, qts, k_lead) -> None:
    """K5 at each split count of QMM_SPLIT_SWEEP on these operands (rotated
    as in the timing lines): CUDA-event and device ms per call — what the
    planner's choice costs against the others.  Information, not a gate."""
    from distributed_llms_tpu_torch.ops import quant_matmul

    q2, s2 = quant_matmul.flatten_qt(qts[0], k_lead)
    m, k, n = x.shape[0], s2.shape[0], q2.shape[1]
    planner = quant_matmul.qmm_plan
    planned = planner(m, k, n, quant_matmul._sm_count(x.device))
    k_tiles = -(-k // quant_matmul.BK)
    times, device = {}, {}
    try:
        for splits in QMM_SPLIT_SWEEP:
            per = -(-k_tiles // splits)
            plan = (*planned[:2], per * quant_matmul.BK, -(-k_tiles // per))
            quant_matmul.qmm_plan = lambda *a, _p=plan: _p
            run = _rotate([lambda q=q: quant_matmul.quant_contract(
                x, q, k_lead) for q in qts])
            times[plan[3]] = cuda_ms(torch, run)
            device[plan[3]] = sum(_device_ms(torch, run).values())
    finally:
        quant_matmul.qmm_plan = planner
    emit("split_sweep", name=name, shape=label, M=m, K=k, N=n,
         planned=list(planned), kernel_ms_by_splits=times,
         device_ms_by_splits=device, operand_copies=len(qts))


# -- phase 4: a small model through each kernel vs the plain version -------

def _small_cfg(**overrides):
    from distributed_llms_tpu_torch.core.config import ModelConfig

    return ModelConfig(family="llama", vocab_size=512, hidden_size=512,
                       intermediate_size=1024, num_layers=2, num_heads=8,
                       num_kv_heads=2, head_dim=128, max_seq_len=256,
                       tie_embeddings=False, dtype="bfloat16", **overrides)


def _decode_logits(torch, cfg, params_cpu, dev, mode, lens, toks, steps):
    """Admit each row's prompt through the batcher's own admission program
    (prefill + splice into the pool or the row), then decode ``steps``
    teacher-forced tokens; returns the logits of every step on the CPU."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    params = _tree_to(params_cpu, torch.device(dev))
    b = len(lens)
    gen = torch.Generator(device=dev).manual_seed(0)
    tables = None
    if mode == "contiguous":
        cache = model_lib.init_cache(cfg, b, 256, device=dev)
        for r in range(b):
            batcher_lib.admit_row(params, cfg, cache, r,
                                  toks[r, :lens[r]].to(dev), lens[r], gen)
    else:
        cache = batcher_lib._paged_pool(cfg, 1 + 4 * b, 64, device=dev,
                                        kv_bits=8 if mode == "int8" else 16)
        tables = torch.arange(1, 1 + 4 * b, dtype=torch.int32,
                              device=dev).reshape(b, 4)
        for r in range(b):
            batcher_lib.admit_row_paged(params, cfg, cache, tables[r],
                                        toks[r, :lens[r]].to(dev), lens[r],
                                        gen)
    out = []
    pos = torch.tensor(lens, dtype=torch.int32)
    for j in range(steps):
        last = toks[torch.arange(b), pos.long()].to(dev)
        logits, cache = model_lib.forward(
            params, cfg, last[:, None], positions=pos.to(dev)[:, None],
            cache=cache, cache_index=pos.to(dev), kv_tables=tables)
        out.append(logits.float().cpu())
        pos = pos + 1
    return torch.cat(out, dim=1)


def phase_model(torch) -> None:
    """Same bf16 weights and tokens on the card (kernels) and on the CPU
    (plain versions): paged bf16 (K1), int8 pages (K1q), a contiguous
    cache with a 64-slot sliding window decoded past it (K2), and int8 and
    int4 quantized blocks over a paged bf16 pool (K5 for every projection
    of every admission and decode step, K1).  Logits must agree to bf16
    noise, and each kernel must have run for every layer of every step."""
    from distributed_llms_tpu_torch.checkpoint.quantize import quantize_tree
    from distributed_llms_tpu_torch.models import model as model_lib

    legs = [  # (decode kernel, cache, config overrides, weight bits)
        ("paged_decode_attention", "paged", {}, None),
        ("paged_decode_attention_int8", "int8", {}, None),
        ("ragged_decode_attention", "contiguous", {"sliding_window": 64},
         None),
        ("paged_decode_attention", "paged", {}, 8),
        ("paged_decode_attention", "paged", {}, 4),
        # attn_impl="flash": each admission prefills through K4.
        ("ragged_decode_attention", "contiguous", {"attn_impl": "flash"},
         None),
        ("ragged_decode_attention", "contiguous",
         {"attn_impl": "flash", "sliding_window": 64}, None),
    ]
    steps = 3
    for name, mode, overrides, bits in legs:
        cfg = _small_cfg(**overrides)
        params_cpu = model_lib.init_params(
            cfg, generator=torch.Generator(device="cpu").manual_seed(7),
            device="cpu")
        if bits:  # quantized blocks, as serve_quantized loads a store
            params_cpu["blocks"] = quantize_tree(params_cpu["blocks"],
                                                 bits=bits)
        gen = torch.Generator(device="cpu").manual_seed(11)
        lens = [97, 150] if overrides else [37, 50]
        toks = torch.randint(0, 512, (2, 200), generator=gen)
        logits = {}
        for dev in ("cpu", "cuda"):
            reset_launches()
            logits[dev] = _decode_logits(torch, cfg, params_cpu, dev, mode,
                                         lens, toks, steps)
        launched = read_launches()
        check(bool(torch.isfinite(logits["cuda"]).all()),
              f"model logits not finite ({name})")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        scale = logits["cpu"].abs().max().item()
        agree = (logits["cuda"].argmax(-1)
                 == logits["cpu"].argmax(-1)).float().mean().item()
        emit("model", kernel=name, cache=mode, attn_impl=cfg.attn_impl,
             window=cfg.sliding_window,
             weight_bits=bits, lengths=lens, decode_steps=steps,
             launches={k: v for k, v in launched.items() if v},
             max_abs_logit_err=err, logit_scale=scale, argmax_agree=agree)
        check(launched[name] == cfg.num_layers * steps,
              f"{name} launched {launched[name]} times for {steps} steps x "
              f"{cfg.num_layers} layers")
        if cfg.attn_impl == "flash":  # one K4 launch per layer per admission
            want = cfg.num_layers * len(lens)
            check(launched["flash_attention_dynamic"] == want,
                  f"K4 launched {launched['flash_attention_dynamic']} times, "
                  f"not {want}")
        if bits:
            # 7 projections per layer per forward: each row's admission
            # prefill and each decode step.
            want = 7 * cfg.num_layers * (steps + len(lens))
            qname = QMM_NAMES[bits]
            check(launched[qname] == want,
                  f"{qname} launched {launched[qname]} times, not {want}")
        # Tolerance: 5% of the logit scale — bf16 activations round
        # differently through cuBLAS and the CPU's matmuls, on top of the
        # kernels' own bf16-probability rounding.
        check(err <= 0.05 * max(scale, 1.0),
              f"model logits disagree ({name}: {err})")
    model_train_step(torch)


# A training step on the card (K3) against the CPU (plain versions), the
# small bf16 llama: relative loss error and the worst leaf's relative L2
# gradient error.  On the H100 the sound kernel reads at most 1.2e-4 and
# 0.013; K3 with a planted fault (a key off by one at the diagonal or the
# window edge, a skipped edge tile, a zeroed output) 1.8e-3..1.9e-2 and
# 0.18..10.5.  Attention moves the loss of a random-init model little, so
# the gradients are the sharper test.
TRAIN_LOSS_REL = 5e-4
TRAIN_GRAD_REL = 5e-2


def model_train_step(torch) -> None:
    """One training step's loss and gradients on the small bf16 llama with
    attn_impl="flash", without and with a sliding window shorter than the
    batch: on the card (K3 forward, dense-recompute backward) against the
    CPU (plain versions), same weights and batch."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import train

    toks = torch.randint(0, 512, (2, 200),
                         generator=torch.Generator().manual_seed(12))
    for window in (None, 64):
        cfg = _small_cfg(attn_impl="flash", sliding_window=window)
        params_cpu = model_lib.init_params(
            cfg, generator=torch.Generator(device="cpu").manual_seed(8),
            device="cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            params = _tree_to(params_cpu, torch.device(dev))
            leaves = train._leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            reset_launches()
            loss = train.lm_loss(params, cfg, toks.to(dev))
            grads = torch.autograd.grad(loss, leaves)
            out[dev] = (loss.item(), [g.float().cpu() for g in grads],
                        read_launches()["flash_attention_static"])
        (loss_c, grads_c, _), (loss_g, grads_g, launched) = (out["cpu"],
                                                            out["cuda"])
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        rel = max((gg - gc).norm().item() / max(gc.norm().item(), 1e-30)
                  for gg, gc in zip(grads_g, grads_c))
        emit("model", kernel="flash_attention_static", training_step=True,
             window=window, loss_cuda=loss_g, loss_cpu=loss_c,
             loss_rel_err=loss_rel, worst_grad_rel_err=rel,
             tol={"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL},
             launches={"flash_attention_static": launched})
        check(math.isfinite(loss_g), "training loss not finite")
        check(launched == cfg.num_layers, f"K3 launched {launched} times, "
              f"not {cfg.num_layers} (one per layer)")
        check(loss_rel <= TRAIN_LOSS_REL,
              f"training loss disagrees ({loss_g} vs {loss_c})")
        check(rel <= TRAIN_GRAD_REL,
              f"gradients disagree (worst relative error {rel})")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- phase 5: serving --------------------------------------------------------

async def _http(port: int, path: str, body: dict, stream: bool = False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    writer.write(
        f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
        f"\r\nContent-Length: {len(payload)}\r\n\r\n".encode() + payload
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if not stream:
        return status, json.loads(rest)
    events = [json.loads(line[6:]) for line in rest.decode().split("\n\n")
              if line.startswith("data: ") and line != "data: [DONE]"]
    return status, {"events": events, "done": b"data: [DONE]" in rest}


PATH_A_PREFIX = (
    "You are a careful assistant for a logistics company. Answer in one "
    "short paragraph, cite the relevant policy number, and never invent "
    "shipment identifiers. Policy 12 covers delayed freight; policy 19 "
    "covers damaged goods; policy 31 covers customs holds; policy 44 covers "
    "refused deliveries at the dock. ")


async def _serve_requests(port: int) -> dict:
    prefix = PATH_A_PREFIX
    # Byte tokenizer: one token per byte (+ BOS).
    check(len(prefix) >= 256, "shared prefix under 256 tokens")
    reqs = [
        ("/v1/completions", {"prompt": prefix + "Case A: a pallet arrived late.",
                             "max_tokens": 48, "temperature": 0.0,
                             "logprobs": True}, False),
        ("/v1/completions", {"prompt": prefix + "Case B: a crate is dented.",
                             "max_tokens": 48, "temperature": 0.0}, False),
        ("/v1/completions", {"prompt": prefix + "Case A: a pallet arrived late.",
                             "max_tokens": 48, "temperature": 0.0,
                             "logprobs": True}, False),
        ("/v1/chat/completions", {"messages": [
            {"role": "user", "content": "Summarise policy 12 in a line."}],
            "max_tokens": 40, "temperature": 0.8, "top_p": 0.9}, False),
        ("/v1/completions", {"prompt": "Streaming check: count to ten.",
                             "max_tokens": 40, "stream": True,
                             "logprobs": True}, True),
        ("/v1/completions", {"prompt": "Top-k sampling check.",
                             "max_tokens": 32, "temperature": 1.0,
                             "top_k": 40, "logprobs": True}, False),
        ("/v1/chat/completions", {"messages": [
            {"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Name three ports."}],
            "max_tokens": 24}, False),
    ]
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[
        _http(port, path, body, stream) for path, body, stream in reqs
    ])
    wall = time.perf_counter() - t0
    n_tokens = 0
    for (path, body, stream), (status, resp) in zip(reqs, outs):
        check(status == 200, f"{path} answered {status}: {resp}")
        want = body["max_tokens"]
        if stream:
            check(resp["done"], "SSE stream did not end with [DONE]")
            finals = [e["choices"][0] for e in resp["events"]
                      if e["choices"][0].get("finish_reason")]
            check(len(finals) == 1, "SSE stream has no single final chunk")
            got = sum(len(e["choices"][0]["logprobs"]["tokens"])
                      for e in resp["events"]
                      if e["choices"][0].get("logprobs"))
            reason = finals[0]["finish_reason"]
        else:
            got = resp["usage"]["completion_tokens"]
            reason = resp["choices"][0]["finish_reason"]
            lp = resp["choices"][0].get("logprobs")
            if lp:
                vals = lp["token_logprobs"]
                check(all(math.isfinite(x) and x <= 0 for x in vals),
                      "non-finite or positive logprob")
        check(got == want or reason == "stop",
              f"{path} produced {got}/{want} tokens (finish {reason})")
        n_tokens += got
    # Greedy agreement of the two identical prompts, one prefilled cold and
    # the other over the cached prefix pages (information, not a gate):
    # the leading run of positions whose token piece and logprob (within
    # 0.1, bf16 noise) agree, over the budget.  The API exposes decoded
    # pieces, not ids, and random weights mostly pick pieces that decode
    # to nothing, so the logprob carries the identity.
    la = outs[0][1]["choices"][0]["logprobs"]
    lc = outs[2][1]["choices"][0]["logprobs"]
    run = 0
    for pa, pc, va, vc in zip(la["tokens"], lc["tokens"], la["token_logprobs"],
                              lc["token_logprobs"]):
        if pa != pc or abs(va - vc) > 0.1:
            break
        run += 1
    agree = run / reqs[0][1]["max_tokens"]
    return {"requests": len(reqs), "completion_tokens": n_tokens,
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "cached_vs_cold_greedy_agreement": agree,
            "cached_tokens": [o[1].get("usage", {}).get(
                "prompt_tokens_details", {}).get("cached_tokens")
                for o in outs if "usage" in o[1]]}


async def _serve_window_requests(port: int) -> dict:
    """Path c's burst: one request whose 4400-byte prompt (4401 tokens
    with BOS) puts every decode step past Mistral-7B's 4096-slot window,
    beside three short concurrent requests, greedy and sampled."""
    long_prompt = ("Freight log, dock 7, one line per pallet: " + "".join(
        f"pallet {i:04d} checked in at bay {i % 13:02d}; " for i in range(200)
    ))[:4400]
    check(len(long_prompt) == 4400, "long prompt under 4400 bytes")
    reqs = [
        {"prompt": long_prompt, "max_tokens": 48, "temperature": 0.0,
         "logprobs": True},
        {"prompt": "Short check one: name a colour.", "max_tokens": 32,
         "temperature": 0.0},
        {"prompt": "Short check two: count to five.", "max_tokens": 32,
         "temperature": 0.8, "top_p": 0.9},
        {"prompt": "Short check three.", "max_tokens": 24, "top_k": 40,
         "temperature": 1.0},
    ]

    async def one(body):
        t0 = time.perf_counter()
        status, resp = await _http(port, "/v1/completions", body)
        return status, resp, time.perf_counter() - t0

    t0 = time.perf_counter()
    outs = await asyncio.gather(*[one(body) for body in reqs])
    wall = time.perf_counter() - t0
    n_tokens = 0
    for body, (status, resp, _) in zip(reqs, outs):
        check(status == 200, f"window request answered {status}: {resp}")
        got = resp["usage"]["completion_tokens"]
        reason = resp["choices"][0]["finish_reason"]
        check(got == body["max_tokens"] or reason == "stop",
              f"window request produced {got}/{body['max_tokens']} tokens")
        n_tokens += got
    long_usage = outs[0][1]["usage"]
    check(long_usage["prompt_tokens"] > WINDOW,
          "the long request does not decode past the window")
    lp = outs[0][1]["choices"][0]["logprobs"]["token_logprobs"]
    check(all(math.isfinite(x) and x <= 0 for x in lp),
          "non-finite or positive logprob")
    return {"requests": len(reqs), "completion_tokens": n_tokens,
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "request_wall_s": [o[2] for o in outs],
            "long_prompt_tokens": long_usage["prompt_tokens"],
            "long_completion_tokens": long_usage["completion_tokens"]}


async def _serve_flash_requests(port: int) -> dict:
    """Path f's burst: one greedy request whose 8000-byte prompt (8001
    tokens with BOS, an 8192-token admission past the 4096 window) beside
    three short concurrent requests."""
    long_prompt = ("Warehouse ledger, aisle by aisle: " + "".join(
        f"crate {i:05d} holds {i % 97:02d} units of part {i % 211:03d}; "
        for i in range(400)))[:FLASH_PROMPT_BYTES]
    check(len(long_prompt) == FLASH_PROMPT_BYTES,
          f"long prompt under {FLASH_PROMPT_BYTES} bytes")
    short = [
        {"prompt": "Short check one: name a colour.", "max_tokens": 32,
         "temperature": 0.0},
        {"prompt": "Short check two: count to five.", "max_tokens": 32,
         "temperature": 0.8, "top_p": 0.9},
        {"prompt": "Short check three.", "max_tokens": 24, "top_k": 40,
         "temperature": 1.0},
    ]
    t0 = time.perf_counter()
    (status, long_resp), *outs = await asyncio.gather(*[
        _http(port, "/v1/completions", body) for body in
        [{"prompt": long_prompt, "max_tokens": 32, "temperature": 0.0,
          "logprobs": True}, *short]])
    wall = time.perf_counter() - t0
    check(status == 200, f"long request answered {status}: {long_resp}")
    n_tokens = long_resp["usage"]["completion_tokens"]
    check(n_tokens == 32, f"long request produced {n_tokens}/32 tokens")
    check(long_resp["usage"]["prompt_tokens"] > WINDOW,
          "the long request does not prefill past the window")
    lps = long_resp["choices"][0]["logprobs"]["token_logprobs"]
    check(all(math.isfinite(x) and x <= 0 for x in lps),
          "non-finite or positive logprob")
    for body, (status, resp) in zip(short, outs):
        check(status == 200, f"short request answered {status}: {resp}")
        n = resp["usage"]["completion_tokens"]
        check(n == body["max_tokens"]
              or resp["choices"][0]["finish_reason"] == "stop",
              f"short request produced {n}/{body['max_tokens']} tokens")
        n_tokens += n
    return {"requests": 1 + len(short), "admissions": 1 + len(short),
            "completion_tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall,
            "long_prompt_tokens": long_resp["usage"]["prompt_tokens"]}


def _free(torch) -> None:
    """Return the device memory of a dropped engine before the next boots."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def serve_path(torch, label, argv, kernels, requests, check_cfg,
               setup=None, **info) -> tuple:
    """Boot ``dlt-serve-torch argv`` in-process through the user's entry
    point, answer ``requests(port)`` over HTTP, and hold the path to its
    kernels: every count 0 just before, read just after, each of the
    path's ``kernels`` ({name: launches per layer per decode step}) at
    least that many times layers x decode steps.  ``setup(server)`` runs
    between the boot and the first request.  Returns (launches, server,
    {"resident_gb": device memory the booted engine holds, "peak_mem_gb":
    peak over boot and serving})."""
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.observability import METRICS

    args = serve_main.parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    server = serve_main.build_server(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    mem = {"resident_gb": (torch.cuda.memory_allocated() - before) / 1e9}
    cfg = server.batcher.cfg
    check_cfg(cfg)
    if setup is not None:
        setup(server)

    async def run():
        await server.start()
        try:
            return await requests(server.bound_port)
        finally:
            await server.stop()

    reset_launches()
    result = asyncio.run(run())
    launches = read_launches()
    b = server.batcher
    steps = b.decode_steps
    b.assert_pool_consistent()
    extra = {}
    if b.prefix_cache is not None:
        extra = {"prefix_cache_hits": b.prefix_cache.hits,
                 "prefix_hit_tokens": b.prefix_cache.hit_tokens}
    ttft = METRICS.snapshot()["histograms"].get("server.ttft_seconds", {})
    mem["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit("serve", path=label, argv=argv, boot_s=boot_s, decode_steps=steps,
         launches=launches, kv_bits=b.kv_bits, paged=b.paged,
         sliding_window=cfg.sliding_window, max_len=b.s,
         num_layers=cfg.num_layers,
         ttft_s_cumulative={k: ttft.get(k) for k in ("p50", "max", "count")},
         **mem, **info, **extra, **result)
    check(steps > 0, f"{label}: no decode step ran")
    for kernel, per_step in kernels.items():
        want = per_step * cfg.num_layers * steps
        check(launches[kernel] >= want,
              f"{label}: {kernel} launched {launches[kernel]} times, under "
              f"{per_step} x {steps} decode steps x {cfg.num_layers} layers")
    return launches, server, mem


def _llama_3_8b(cfg) -> None:
    check(cfg.hidden_size == 4096 and cfg.num_layers == 32
          and cfg.vocab_size == 128256, "not the full-width llama-3-8b")


def _mistral_7b(cfg) -> None:
    check(cfg.hidden_size == 4096 and cfg.num_layers == 32
          and cfg.num_kv_heads == 8 and cfg.vocab_size == 32000
          and cfg.sliding_window == WINDOW, "not the full-width mistral-7b")


def _mistral_7b_flash(cfg) -> None:
    _mistral_7b(cfg)
    check(cfg.attn_impl == "flash", "the store's model is not flash")


def serve_flash(torch, profile: bool) -> dict:
    """Path f: write the flash-config Mistral-7B store into a temporary
    directory, serve it at 32768 slots, remove it.  Returns the launches
    of K4 and of its pre-pass on the path."""
    tmp = tempfile.mkdtemp(prefix="dlt_store_flash_")
    try:
        info = write_store(torch, "int8", tmp, "mistral-7b",
                           attn_impl="flash")
        launches, server, _ = serve_path(
            torch, "flash_prefill", ["--store", tmp, *SERVE_FLASH_ARGS],
            {"ragged_decode_attention": 1}, _serve_flash_requests,
            _mistral_7b_flash, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b = server.batcher
    check(not b.paged and b.s == FLASH_MAX_LEN,
          f"flash_prefill: not contiguous at {FLASH_MAX_LEN} slots")
    admissions = 4  # every admission is multi-token (a bucket of >= 16)
    want = b.cfg.num_layers * admissions
    check(launches["flash_attention_dynamic"] >= want,
          f"flash_prefill: K4 launched {launches['flash_attention_dynamic']}"
          f" times, under {want} (32 layers x {admissions} admissions)")
    check(launches["flash_tile_summary"] ==
          launches["flash_attention_dynamic"],
          f"flash_prefill: K4's pre-pass launched "
          f"{launches['flash_tile_summary']} times, not once per K4 launch")
    flash_admission(torch, b, profile)
    del server, b
    _free(torch)
    return {name: launches[name]
            for name in ("flash_attention_dynamic", "flash_tile_summary")}


def write_store(torch, quantization: str, out_dir: str,
                preset: str = "llama-3-8b", **overrides) -> dict:
    """A store of ``preset`` (random weights drawn on the card from seed
    0; ``overrides`` land in its model config) written by the port's
    ``save_shards``: 2 raw shards, quantized leaf by leaf on the card.
    Returns what it cost."""
    from distributed_llms_tpu_torch.checkpoint.store import save_shards
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset

    cfg = get_preset(preset, **overrides)
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    t0 = time.perf_counter()
    save_shards(params, out_dir, num_shards=2, model_config=cfg,
                quantization=quantization, storage="raw")
    write_s = time.perf_counter() - t0
    del params
    _free(torch)
    disk = sum(p.stat().st_size for p in Path(out_dir).iterdir())
    return {"store": quantization, "store_preset": preset,
            "store_bytes": disk, "store_write_s": write_s}


def serve_store(torch, label, quantization, bits, **info) -> tuple:
    """Path d or e: write the store into a temporary directory, serve it
    quantized, remove it.  Returns (launches, server, memory as
    :func:`serve_path`, with "saved_gb": the bytes its quantized block
    weights save over bf16)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor

    tmp = tempfile.mkdtemp(prefix=f"dlt_store_{quantization}_")
    try:
        info.update(write_store(torch, quantization, tmp))
        launches, server, mem = serve_path(
            torch, label, ["--store", tmp, *SERVE_STORE_ARGS],
            {QMM_NAMES[bits]: 7, "paged_decode_attention": 1},
            _serve_requests, _llama_3_8b, **info)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(server.batcher.prefix_cache.hits > 0, f"{label}: no prefix-cache hit")
    saved = 0
    for group in server.batcher.params["blocks"].values():
        for name, leaf in group.items():
            check(isinstance(leaf, QuantizedTensor) or name == "scale",
                  f"{label}: block weight {name} is not quantized")
            if isinstance(leaf, QuantizedTensor):
                saved += (2 * math.prod(leaf.unpacked_shape)
                          - leaf.data.nbytes - leaf.scale.nbytes)
    mem["saved_gb"] = saved / 1e9
    emit("serve_memory", path=label, **mem)
    return launches, server, mem


def _check_resident(label, mem, mem_a) -> None:
    """A quantized path holds less device memory than path a, by most of
    what its block weights save (the rest of both engines is alike)."""
    gained = mem_a["resident_gb"] - mem["resident_gb"]
    check(gained >= 0.9 * mem["saved_gb"],
          f"{label} holds {mem['resident_gb']:.3f} GB once booted, only "
          f"{gained:.3f} GB below the bf16 path's {mem_a['resident_gb']:.3f}"
          f" GB; its quantized blocks should save {mem['saved_gb']:.3f} GB")


def phase_serve(torch, profile: bool) -> dict:
    """The serving paths, one engine at a time.  Returns each kernel's
    launches on its own path."""
    lap = _lap("serve_time")
    launches, server, mem_a = serve_path(
        torch, "paged", SERVE_ARGS, {"paged_decode_attention": 1},
        _serve_requests, _llama_3_8b)
    check(server.batcher.prefix_cache.hits > 0, "paged: no prefix-cache hit")
    out = {"paged_decode_attention": launches["paged_decode_attention"]}
    loop_variants(torch, "paged", server.batcher, profile)
    del server
    _free(torch)
    lap("a")

    launches, server, _ = serve_path(
        torch, "paged_int8", SERVE_INT8_ARGS,
        {"paged_decode_attention_int8": 1}, _serve_requests, _llama_3_8b)
    check(server.batcher.kv_bits == 8, "paged_int8: the pool is not int8")
    check(server.batcher.prefix_cache.hits > 0,
          "paged_int8: no prefix-cache hit")
    out["paged_decode_attention_int8"] = launches["paged_decode_attention_int8"]
    del server
    _free(torch)
    lap("b")

    launches, server, _ = serve_path(
        torch, "windowed", SERVE_WINDOW_ARGS, {"ragged_decode_attention": 1},
        _serve_window_requests, _mistral_7b)
    check(not server.batcher.paged, "windowed: not contiguous mode")
    out["ragged_decode_attention"] = launches["ragged_decode_attention"]
    del server
    _free(torch)
    lap("c")

    launches, server, mem = serve_store(
        torch, "store_int8", "int8", 8, path_a_mem_gb=mem_a)
    _check_resident("store_int8", mem, mem_a)
    check(mem["peak_mem_gb"] < mem_a["peak_mem_gb"],
          f"store_int8 peaked at {mem['peak_mem_gb']:.2f} GB, not below the "
          f"bf16 path's {mem_a['peak_mem_gb']:.2f} GB")
    out["quant_matmul"] = launches["quant_matmul"]
    loop_variants(torch, "store_int8", server.batcher, profile)
    del server
    _free(torch)
    lap("d")

    launches, server, mem = serve_store(
        torch, "store_int4", "int4", 4, path_a_mem_gb=mem_a)
    _check_resident("store_int4", mem, mem_a)
    out["quant_matmul_int4"] = launches["quant_matmul_int4"]
    del server
    _free(torch)
    lap("e")

    out.update(serve_flash(torch, profile))
    lap("f")
    # Path h runs K2 too; path c's count stays the line's (its own path).
    serve_long(torch)
    lap("h")
    return out


# -- phase 6: path g, the training step ---------------------------------------

TRAIN_LAYERS = 8  # Llama-3-8B's width; AdamW state for 32 layers won't fit


def phase_train(torch, profile: bool) -> int:
    """Path g: three AdamW steps of ``runtime.train.Trainer`` on one fixed
    batch through K3, then one with ``remat=True``.  Returns K3's launches
    over the three steps."""
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import train

    cfg = get_preset("llama-3-8b", attn_impl="flash", num_layers=TRAIN_LAYERS)
    check(cfg.hidden_size == 4096 and cfg.num_heads == 32
          and cfg.num_kv_heads == 8 and cfg.intermediate_size == 14336
          and cfg.vocab_size == 128256, "not Llama-3-8B's width")
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    n_params = sum(p.numel() for p in train._leaves(params))
    batch = torch.randint(0, cfg.vocab_size, (2, TRAIN_T + 1), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1))
    trainer = train.Trainer(cfg, train.default_optimizer(1e-3))
    state = trainer.init(params)
    step = trainer.make_step()
    losses, times = [], []
    reset_launches()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, None)
        losses.append(float(loss))  # synchronises
        times.append(time.perf_counter() - t0)
    launched = read_launches()["flash_attention_static"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = batch.shape[0] * TRAIN_T
    # One step more with every block rematerialised in the backward.
    remat_step = train.Trainer(cfg, trainer.optimizer, remat=True).make_step()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, loss = remat_step(params, state, batch, None)
    remat_loss = float(loss)
    remat_s = time.perf_counter() - t0
    remat_launched = read_launches()["flash_attention_static"]
    remat_peak = torch.cuda.max_memory_allocated() / 1e9
    emit("train", config="llama-3-8b", num_layers=cfg.num_layers,
         params=n_params, batch=list(batch.shape), attn_impl=cfg.attn_impl,
         losses=losses, step_s=times, tokens_per_s=[tokens / t for t in times],
         peak_mem_gb=peak, launches={"flash_attention_static": launched},
         remat_loss=remat_loss, remat_step_s=remat_s,
         remat_peak_mem_gb=remat_peak,
         remat_launches={"flash_attention_static": remat_launched})
    check(all(math.isfinite(x) for x in losses + [remat_loss]),
          f"training loss not finite: {losses + [remat_loss]}")
    check(losses[0] > losses[1] > losses[2],
          f"training loss does not fall: {losses}")
    check(launched == 3 * cfg.num_layers,
          f"K3 launched {launched} times in 3 steps, not {3 * cfg.num_layers}")
    check(remat_launched == 2 * cfg.num_layers,
          f"K3 launched {remat_launched} times in a remat step, not "
          f"{2 * cfg.num_layers} (forward + recompute)")
    if profile:
        split, wall = _profiled(
            torch, lambda: step(params, state, batch, None))
        busy = sum(split.values())
        emit("profile", path="train", step_wall_ms=wall,
             device_kernel_ms=split,
             flash_share_of_device=split["flash_kernel"] / busy if busy else
             "not measured",
             decode_attention_share_of_device=(
                 split["decode_attention_kernel"] / busy if busy else
                 "not measured"),
             device_busy_share=busy / wall if busy else "not measured")
    del params, state, batch
    _free(torch)
    return launched


# -- phase 7: where a full-width batch's time goes ---------------------------

LOOP_PROMPT_TOKENS = 300
LOOP_NEW_TOKENS = 64
LOOP_TIMED_RUNS = 3  # host-clock walls vary run to run: the median
# The engine loops a served batcher is driven through: (name, overlap,
# eager).  "eager_sync" is the loop of the port before the chunk graphs:
# every kernel of a decode chunk launched from Python, one host round trip
# per chunk.  It is reached through the batcher module's own eager chunk
# (``_decode_steps``); nothing a user sets selects it.
LOOPS = (("graph_overlap", True, False), ("graph_sync", False, False),
         ("eager_sync", False, True))


def _eager_decode_chunk(*args, graphs=None, **kw):
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    return batcher_lib._decode_steps(*args, **kw)


def _run_batch(torch, b, prompts, penalties=None,
               new=LOOP_NEW_TOKENS) -> tuple:
    """Run ``prompts`` (greedy, ``new`` tokens each; the first with
    ``penalties``) to the end on batcher ``b``: (streams, wall seconds,
    decode steps, overlap counters)."""
    steps0 = b.decode_steps
    stats0 = dict(b.overlap_stats)
    # Cold admissions every run: a prefix-cache hit prefills only the
    # suffix, whose bf16 rounding differs from the cold prefill's.
    rids = [b.submit(p, max_new_tokens=new, prefix_cache=False,
                     **(penalties if penalties and j == 0 else {}))
            for j, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {k: v - stats0[k] for k, v in b.overlap_stats.items()}
    return [res[r] for r in rids], wall, b.decode_steps - steps0, stats


def loop_variants(torch, label, batcher, profile: bool, penalties=None,
                  timed_runs=LOOP_TIMED_RUNS) -> None:
    """Paths a, d and i: a fresh batcher over the served weights (and with
    the served batcher's options) runs 8 greedy requests (300-token
    prompts, 64 new tokens; on path i the first penalized) under each of
    LOOPS — once to capture the chunk graphs, then ``timed_runs`` times
    timed (the median kept; with none, the capturing run's wall) — and
    every run's token streams must be identical across runs and loops.
    With
    ``profile``, the eager synchronous loop and the default (graphs and
    overlap) run once more under the profiler: device kernel time by
    class and the device's busy share.  Each loop's line gives ms per
    decode step, chunks dispatched ahead, carry syncs and the mean device
    gap."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (LOOP_PROMPT_TOKENS,),
                             generator=g).tolist() for _ in range(batcher.b)]
    graph_chunk = batcher_lib.decode_chunk
    streams = {}
    for name, overlap, eager in LOOPS:
        b = batcher_lib.ContinuousBatcher(
            **{**batcher._ctor_args, "overlap": overlap})
        if eager:
            batcher_lib.decode_chunk = _eager_decode_chunk
        try:
            got, wall, steps, stats = _run_batch(torch, b, prompts,
                                                 penalties)
            first = got
            walls = []
            for _ in range(timed_runs):
                got, wall, steps, stats = _run_batch(torch, b, prompts,
                                                     penalties)
                check(got == first,
                      f"{label}/{name}: a second run gave other tokens")
                walls.append(wall)
            # timed_runs=0: the one run's wall, its graph captures included.
            wall = sorted(walls)[len(walls) // 2] if walls else wall
            line = {}
            if profile and name != "graph_sync":
                split, prof_wall = _profiled(
                    torch, lambda: _run_batch(torch, b, prompts, penalties))
                busy = sum(split.values())
                line = {"profiled_wall_ms": prof_wall,
                        "device_kernel_ms": split,
                        "device_busy_share": (busy / prof_wall if busy
                                              else "not measured")}
        finally:
            batcher_lib.decode_chunk = graph_chunk
        streams[name] = got
        gaps = stats["gap_samples"]
        emit("profile", path=label, loop=name, requests=len(prompts),
             penalties=penalties,
             prompt_tokens=LOOP_PROMPT_TOKENS, new_tokens=LOOP_NEW_TOKENS,
             decode_steps=steps, wall_ms=wall * 1e3,
             wall_ms_runs=[w * 1e3 for w in walls],
             wall_ms_per_decode_step=wall * 1e3 / max(steps, 1),
             chunks=stats["chunks"],
             dispatched_ahead=stats["dispatched_ahead"],
             carry_syncs=stats["carry_syncs"],
             mean_device_gap_ms=(stats["device_gap_s"] * 1e3 / gaps if gaps
                                 else "not measured"),
             host_lag_ms=stats["host_lag_s"] * 1e3,
             graph_captures=b._graphs.captures,
             graph_replays=b._graphs.replays, **line)
        check(all(len(t) == LOOP_NEW_TOKENS for t in got),
              f"{label}/{name}: a request ended early")
        if overlap:
            check(stats["dispatched_ahead"] > 0,
                  f"{label}/{name}: no chunk was dispatched ahead")
        check((b._graphs.replays > 0) != eager,
              f"{label}/{name}: graph replays {b._graphs.replays}")
        del b
        _free(torch)
    check(streams["graph_overlap"] == streams["graph_sync"]
          == streams["eager_sync"],
          f"{label}: temperature-0 streams differ between the engine loops")


# -- path h: long context through chunked dense prefill ----------------------

def _long_prompt() -> str:
    text = "Shipping manifest, container by container: " + "".join(
        f"container {i:05d} sealed at gate {i % 17:02d} with {i % 89:02d} "
        f"crates; " for i in range(600))
    check(len(text) >= LONG_PROMPT_BYTES, "long prompt under 30000 bytes")
    return text[:LONG_PROMPT_BYTES]


SHORT_PROMPTS = ("Short stream one: list the days of the week.",
                 "Short stream two: name the planets in order.",
                 "Short stream three: count from one to twenty.")


async def _serve_long_requests(port: int) -> dict:
    """Path h's burst over HTTP: three short greedy SSE streams start
    decoding, then a 30000-byte prompt (30001 tokens with BOS, past path
    c's 6144-slot cut) arrives and admits in 1024-token bites."""
    shorts = [asyncio.create_task(_http(port, "/v1/completions", {
        "prompt": p, "max_tokens": SHORT_NEW, "temperature": 0.0,
        "stream": True, "logprobs": True}, stream=True))
        for p in SHORT_PROMPTS]
    await asyncio.sleep(2.0)  # the shorts are admitted and decoding
    t0 = time.perf_counter()
    status, resp = await _http(port, "/v1/completions", {
        "prompt": _long_prompt(), "max_tokens": 16, "temperature": 0.0,
        "logprobs": True})
    long_s = time.perf_counter() - t0
    outs = await asyncio.gather(*shorts)
    check(status == 200, f"long request answered {status}: {resp}")
    usage = resp["usage"]
    check(usage["prompt_tokens"] == LONG_PROMPT_BYTES + 1,
          f"long prompt of {usage['prompt_tokens']} tokens")
    check(usage["completion_tokens"] == 16
          or resp["choices"][0]["finish_reason"] == "stop",
          f"long request produced {usage['completion_tokens']}/16 tokens")
    lps = resp["choices"][0]["logprobs"]["token_logprobs"]
    check(all(math.isfinite(x) and x <= 0 for x in lps),
          "non-finite or positive logprob")
    n_tokens = usage["completion_tokens"]
    for status, out in outs:
        check(status == 200 and out["done"], "a short stream did not end")
        finals = [e["choices"][0] for e in out["events"]
                  if e["choices"][0].get("finish_reason")]
        check(len(finals) == 1, "a short stream has no single final chunk")
        got = sum(len(e["choices"][0]["logprobs"]["tokens"])
                  for e in out["events"] if e["choices"][0].get("logprobs"))
        check(got == SHORT_NEW or finals[0]["finish_reason"] == "stop",
              f"a short stream produced {got}/{SHORT_NEW} tokens")
        n_tokens += got
    return {"requests": 1 + len(outs), "completion_tokens": n_tokens,
            "long_prompt_tokens": usage["prompt_tokens"],
            "long_request_s": long_s}


def long_context_run(torch, batcher, label) -> dict:
    """Path h's traffic outside HTTP, timed engine-side: the three short
    greedy streams admit, and once each has 16 tokens the long prompt is
    submitted from the delivery callback.  Returns the streams (rid order:
    the three shorts, then the long one) and emits the long prompt's time
    to first token and the short streams' delivery gaps before and while
    it admits."""
    tok = batcher.tokenizer
    # Warm-up: the decode chunk's graph is captured before the timed run.
    batcher.submit(tok.encode(SHORT_PROMPTS[0]), max_new_tokens=16)
    batcher.run()
    deliveries: dict = {}
    streams: dict = {}
    long = []
    shorts = [batcher.submit(tok.encode(p), max_new_tokens=SHORT_NEW)
              for p in SHORT_PROMPTS]

    def on_tokens(rid, toks, done, lps):
        now = time.perf_counter()
        if toks:
            deliveries.setdefault(rid, []).append(now)
        streams.setdefault(rid, []).extend(toks)
        if not long and all(len(streams.get(r, [])) >= 16 for r in shorts):
            long.append((batcher.submit(tok.encode(_long_prompt()),
                                        max_new_tokens=16),
                         time.perf_counter()))

    # Host time inside each fused dispatch (the bite's eager launches) and
    # each chunk fetch (the wait for the device): where the host spends a
    # step while a prompt admits.
    host = {"_dispatch_mixed": [], "_fetch_chunk": []}

    def timed(name):
        fn = getattr(batcher, name)

        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name].append(time.perf_counter() - t)
        return run

    for name in host:
        setattr(batcher, name, timed(name))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = batcher.run(on_tokens=on_tokens)
    finally:
        for name in host:
            delattr(batcher, name)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(long), f"{label}: the long prompt was never submitted")
    long_rid, t_sub = long[0]
    first = deliveries[long_rid][0]
    before, during, at = [], [], []
    for r in shorts:
        times = deliveries[r]
        for a, b in zip(times, times[1:]):
            if b <= t_sub:
                before.append(b - a)
            elif a < first:
                during.append(b - a)
                at.append(b - t_sub)
    check(bool(during), f"{label}: no short stream decoded while the long "
          "prompt admitted")
    out = [res[r] for r in shorts] + [res[long_rid]]
    check(all(len(t) == SHORT_NEW for t in out[:3]) and len(out[3]) == 16,
          f"{label}: a request ended early")
    emit("serve_long", path=label, schedule=batcher.sched.name,
         prompt_tokens=LONG_PROMPT_BYTES + 1, prefill_chunk=PREFILL_CHUNK,
         short_new_tokens=SHORT_NEW, ttft_s=first - t_sub, wall_s=wall,
         short_gap_ms_before={"median": 1e3 * sorted(before)[len(before) // 2]
                              if before else "not measured",
                              "max": 1e3 * max(before) if before else
                              "not measured"},
         short_gap_ms_while_admitting={
             "median": 1e3 * sorted(during)[len(during) // 2],
             "max": 1e3 * max(during), "deliveries": len(during),
             "max_ends_s_after_arrival": at[during.index(max(during))]},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         host_ms={name: {"calls": len(v), "first": 1e3 * v[0],
                         "median": 1e3 * sorted(v)[len(v) // 2],
                         "max": 1e3 * max(v)} if v else "none"
                  for name, v in host.items()},
         dispatched_ahead=batcher.overlap_stats["dispatched_ahead"],
         carry_syncs=batcher.overlap_stats["carry_syncs"])
    return out


def serve_long(torch) -> int:
    """Path h: ``dlt-serve-torch --preset mistral-7b --max-len 32768 --slots
    4 --prefill-chunk 1024`` (contiguous, dense ``attn_impl="dot"``,
    window 4096, the mixed schedule) answers the HTTP burst, then runs the
    engine-side traffic; then the same server with ``--schedule
    alternate`` runs the engine-side traffic too.  The short greedy
    streams must be identical under the two schedules.  Returns K2's
    launches on the HTTP burst."""
    from distributed_llms_tpu_torch.cli import serve_main

    launches, server, _ = serve_path(
        torch, "long_context", SERVE_LONG_ARGS, {"ragged_decode_attention": 1},
        _serve_long_requests, _mistral_7b)
    b = server.batcher
    check(not b.paged and b.s == LONG_MAX_LEN and b.cfg.attn_impl == "dot"
          and b.sched.name == "mixed" and b.overlap,
          "long_context: not contiguous dense mixed at 32768 slots")
    mixed = long_context_run(torch, b, "long_context")
    del server, b
    _free(torch)
    alt_server = serve_main.build_server(serve_main.parser().parse_args(
        SERVE_LONG_ARGS + ["--schedule", "alternate"]))
    check(alt_server.batcher.sched.name == "alternate",
          "long_context: --schedule alternate not taken")
    alternate = long_context_run(torch, alt_server.batcher,
                                 "long_context_alternate")
    del alt_server
    _free(torch)
    emit("serve_long_streams", short_streams_identical=mixed[:3] ==
         alternate[:3], long_stream_identical=mixed[3] == alternate[3])
    check(mixed[:3] == alternate[:3],
          "long_context: the short greedy streams differ between the mixed "
          "and alternate schedules")
    return launches["ragged_decode_attention"]


# -- path i: the host tier, penalties and named prefixes ----------------------

# Path i: Llama-3-8B at full width over a pool too small for its traffic (39
# usable pages of 8 MiB: 32 layers x 64 slots x 8 KV heads x 128 x bf16, K
# and V), with 128 pages of pinned host RAM behind it.
TIER_ARGS = ["--preset", "llama-3-8b", "--paged-pages", "40", "--page-size",
             "64", "--prefix-cache", "--host-pages", "128", "--max-len",
             "1024", *_COMMON_ARGS]
TIER_NEW = 192
TIER_PENALTIES = {"presence_penalty": 0.6, "frequency_penalty": 0.4}
# 4 full pages of 64 tokens with the BOS: the shared run of every request
# that starts with it, and the named prefix "sys".
TIER_PREFIX = ("You are a careful assistant for a logistics company. Answer "
               "in one short paragraph, cite the relevant policy number, and "
               "never invent shipment identifiers. Policy 12 covers delayed "
               "freight; policy 19 covers damaged goods; policy 31 covers "
               "customs holds; po")
PARCEL_PAGES = 9  # a row of path i at its full depth (576 slots)


def _tier_text(tag: str, n: int) -> str:
    """``n`` bytes of distinct filler for request ``tag``."""
    text = "".join(f"{tag} item {i:03d} waits at bay {i % 11:02d}; "
                   for i in range(40))
    return text[:n]


def tier_requests() -> list:
    """Path i's traffic in submission order: three requests over the
    shared prefix (300-400 bytes), four more of the same lengths without it
    (the second one penalized), one naming the prefix "sys", and, after
    that wave, one more over the shared prefix (the spill hit).  The four
    and the named one come at priority 1: once the pool is dry their
    admissions preempt the first three (an admission preempts only
    strictly lower priority), so the wave swaps rows out by design, not
    by the timing of growth."""
    check(len(TIER_PREFIX) == 256, "path i's prefix is not 256 bytes")
    shared = [TIER_PREFIX + _tier_text(f"case {c}", n)
              for c, n in (("A", 130), ("B", 136), ("C", 144))]
    pressure = [_tier_text(f"load {c}", n)
                for c, n in (("D", 384), ("E", 392), ("F", 400), ("G", 388))]
    reqs = [{"prompt": p, "max_tokens": TIER_NEW, "temperature": 0.0}
            for p in shared + pressure]
    reqs[4].update(TIER_PENALTIES)
    reqs.append({"prompt": _tier_text("named H", 90), "prefix": "sys",
                 "max_tokens": TIER_NEW, "temperature": 0.0})
    for r in reqs[3:]:
        r["priority"] = 1
    reqs.append({"prompt": TIER_PREFIX + _tier_text("case S", 120),
                 "max_tokens": TIER_NEW, "temperature": 0.0})
    return reqs


async def _sse(port: int, body: dict) -> tuple:
    """One streamed completion: (status, seconds to the first event, wall
    seconds).  An event carries text, so the first comes with the first
    token that decodes to some."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps({**body, "stream": True}).encode()
    t0 = time.perf_counter()
    writer.write(
        f"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
        f"application/json\r\nContent-Length: {len(payload)}\r\n\r\n"
        .encode() + payload)
    await writer.drain()
    raw, first = b"", None
    while True:
        got = await reader.read(1 << 16)
        if not got:
            break
        raw += got
        if first is None and b"data: " in raw:
            first = time.perf_counter() - t0
    writer.close()
    status = int(raw.split(b"\r\n", 1)[0].split()[1])
    check(status == 200 and b"data: [DONE]" in raw,
          f"a streamed request answered {status}: {raw[-300:]!r}")
    return status, first, time.perf_counter() - t0


def _record_streams(b) -> tuple:
    """Wrap the served batcher so every delivered token id is kept per
    request, {(prompt ids, prefix): ids}, and each request's time from its
    submit to its first token, engine-side (the SSE stream shows a token
    only once it decodes to text, which random weights rarely pick)."""
    rid_of, ids, t_submit, ttft = {}, {}, {}, {}
    submit, run = b.submit, b.run

    def submit_rec(prompt, *a, prefix=None, **kw):
        t0 = time.perf_counter()
        rid = submit(prompt, *a, prefix=prefix, **kw)
        rid_of[rid] = (tuple(prompt), prefix)
        t_submit[rid] = t0
        return rid

    def run_rec(on_tokens=None):
        def rec(rid, toks, done, lps):
            if toks and rid not in ttft:
                ttft[rid] = time.perf_counter() - t_submit[rid]
            ids.setdefault(rid_of[rid], []).extend(toks)
            return on_tokens(rid, toks, done, lps)

        return run(on_tokens=rec)

    b.submit, b.run = submit_rec, run_rec
    return ids, ttft


def _tier_key(b, body) -> tuple:
    return (tuple(b.tokenizer.encode(body["prompt"])), body.get("prefix"))


async def _serve_tier_requests(server, reqs) -> dict:
    """Path i over HTTP, every request streamed: the first shared-prefix
    request alone until it is admitted (its cold prefill publishes the
    prefix's pages), then the rest of the wave at once, then the spill
    hit."""
    from distributed_llms_tpu_torch.core.observability import METRICS

    port = server.bound_port
    admitted = METRICS.get_counter("batcher.admitted")
    t0 = time.perf_counter()
    first = asyncio.create_task(_sse(port, reqs[0]))
    while METRICS.get_counter("batcher.admitted") == admitted:
        await asyncio.sleep(0.005)
    outs = await asyncio.gather(first, *[_sse(port, r) for r in reqs[1:-1]])
    outs.append(await _sse(port, reqs[-1]))
    wall = time.perf_counter() - t0
    return {"requests": len(reqs), "wall_s": wall,
            "first_text_event_s": [o[1] for o in outs],
            "request_wall_s": [o[2] for o in outs]}


def _tier_engine_run(torch, b, reqs, extra=()) -> tuple:
    """``reqs`` submitted engine-side to batcher ``b`` as the HTTP run
    submits them: the first alone, the rest of the wave (and ``extra``)
    once the first has its admission token, the last once the wave is
    done.  Returns (streams in ``reqs + extra`` order, wall seconds,
    decode steps)."""
    if "sys" not in b.prefixes:
        b.register_prefix("sys", TIER_PREFIX)

    def submit(r):
        return b.submit(r["prompt"], max_new_tokens=r["max_tokens"],
                        prefix=r.get("prefix"),
                        presence_penalty=r.get("presence_penalty", 0.0),
                        frequency_penalty=r.get("frequency_penalty", 0.0),
                        priority=r.get("priority", 0))

    rids = [submit(reqs[0])]
    wave: set = set()
    streams: dict = {}

    def on_tokens(rid, toks, done, lps):
        streams.setdefault(rid, []).extend(toks)
        if rid == rids[0] and len(rids) == 1:
            rids.extend(submit(r) for r in [*reqs[1:-1], *extra])
            wave.update(rids)
        if done:
            wave.discard(rid)
            if not wave and len(rids) == len(reqs) + len(extra) - 1:
                rids.insert(len(reqs) - 1, submit(reqs[-1]))

    steps0 = b.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.run(on_tokens=on_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b.assert_pool_consistent()
    check(len(rids) == len(reqs) + len(extra), "path i: a request was "
          "never submitted engine-side")
    return [streams[r] for r in rids], wall, b.decode_steps - steps0


_TIER_COUNTERS = ("batcher.kv_swaps.out", "batcher.kv_swaps.in",
                  "batcher.kv_swaps.fallback",
                  "batcher.host_tier.spilled_pages",
                  "batcher.host_tier.restored_pages",
                  "batcher.host_tier.hits",
                  "batcher.host_tier.spill_evictions",
                  "batcher.preemptions_total")


def _tier_counts(before=None) -> dict:
    from distributed_llms_tpu_torch.core.observability import METRICS

    now = {n.removeprefix("batcher."): METRICS.get_counter(n)
           for n in _TIER_COUNTERS}
    return now if before is None else {k: v - before[k]
                                       for k, v in now.items()}


def _check_swapped(label, c) -> None:
    check(c["kv_swaps.out"] >= 2 and c["kv_swaps.in"] >= 2,
          f"{label}: swapped out {c['kv_swaps.out']} and in "
          f"{c['kv_swaps.in']} times, under 2")
    check(c["kv_swaps.fallback"] == 0,
          f"{label}: {c['kv_swaps.fallback']} swap(s) fell back to "
          f"recompute")


def _first_diff(got, want) -> str:
    for j, (a, w) in enumerate(zip(got, want)):
        if a != w:
            return f"token {j}: {a} vs {w}"
    return f"lengths {len(got)} vs {len(want)}"


def _same_streams(label, reqs, got, want) -> None:
    for r, g, w in zip(reqs, got, want):
        check(g == w, f"{label}: the stream of {r['prompt'][:24]!r} "
                      f"(prefix {r.get('prefix')}) differs from the "
                      f"unpressured run's at {_first_diff(g, w)}")


def serve_tiered(torch) -> dict:
    """Path i: ``dlt-serve-torch --preset llama-3-8b --paged-pages 40
    --page-size 64 --prefix-cache --host-pages 128 --max-len 1024`` answers
    :func:`tier_requests` over HTTP under pool pressure: rows swap out and
    back, the shared prefix's cached pages spill to the host tier and a
    later hit restores them, one request is penalized and one names a
    registered prefix.  Every stream must equal the same requests' on an
    unpressured batcher over the same weights (256 pages, no tier), at bf16
    (K1) and, engine-side, at int8 (K1q).  Then the penalized stream's
    eager and graph loops, the named prefix's first-token logits, and a
    parcel's round trip at full width.  Returns path i's K1 and K1q
    launches."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    reqs = tier_requests()
    parcel_round_trip(torch)
    box: dict = {}

    def setup(server) -> None:
        server.batcher.register_prefix("sys", TIER_PREFIX)
        box["streams"], box["ttft"] = _record_streams(server.batcher)
        box["server"] = server
        # The serving peak, not the boot's (random weights are drawn in
        # float32 leaf by leaf).
        torch.cuda.reset_peak_memory_stats()

    async def requests(_port):
        return await _serve_tier_requests(box["server"], reqs)

    counts0 = _tier_counts()
    launches, server, mem = serve_path(
        torch, "tiered", TIER_ARGS, {"paged_decode_attention": 1}, requests,
        _llama_3_8b, setup=setup)
    b = server.batcher
    streams = box.pop("streams")
    ttft = sorted(box.pop("ttft").values())
    box.clear()
    served = _tier_counts(counts0)
    tier = b.host_tier.stats()
    emit("serve_tier", path="tiered", counters=served, host_tier=tier,
         pinned_host_bytes=b.host_tier.pinned_bytes,
         http_decode_steps=b.decode_steps,
         ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
         ttft_s=ttft, serving_peak_mem_gb=mem["peak_mem_gb"])
    _check_swapped("tiered", served)
    check(served["host_tier.spilled_pages"] > 0,
          "tiered: no cached page spilled to the host tier")
    check(served["host_tier.hits"] > 0,
          "tiered: no prefix-cache hit was restored from the host tier")
    b.assert_pool_consistent()
    check(tier["swap_parcels"] == 0 and tier["used"] == tier["spill_entries"],
          f"tiered: the host tier still holds swap parcels: {tier}")
    got = [streams.get(_tier_key(b, r)) for r in reqs]
    check(all(g is not None for g in got), "tiered: a stream was not seen")

    ctor = dict(b._ctor_args)
    calm_b = batcher_lib.ContinuousBatcher(
        **{**ctor, "paged_pages": 256, "host_pages": 0})
    plain_pen = {k: v for k, v in reqs[4].items()
                 if k not in TIER_PENALTIES}
    calm, calm_wall, calm_steps = _tier_engine_run(
        torch, calm_b, reqs, extra=[plain_pen])
    _same_streams("tiered", reqs, got, calm[:-1])
    check(calm[4] != calm[-1], "tiered: the penalized stream equals the "
          "same prompt's without penalties")
    del calm_b
    _free(torch)
    c0 = _tier_counts()
    busy_b = batcher_lib.ContinuousBatcher(**ctor)
    pressed, pressed_wall, pressed_steps = _tier_engine_run(torch, busy_b,
                                                            reqs)
    _same_streams("tiered/engine-side", reqs, pressed, calm[:-1])
    emit("serve_tier_walls", path="tiered",
         pressured_ms_per_decode_step=pressed_wall * 1e3 / pressed_steps,
         unpressured_ms_per_decode_step=calm_wall * 1e3 / calm_steps,
         pressured_decode_steps=pressed_steps,
         unpressured_decode_steps=calm_steps,
         pressured_wall_s=pressed_wall, unpressured_wall_s=calm_wall,
         counters=_tier_counts(c0))
    del busy_b
    _free(torch)
    named_prefix_logits(torch, b)
    # The penalized request's three engine loops (and swaps under them),
    # one run each: the streams are the check here, not the walls.
    loop_variants(torch, "tiered", b, False, penalties=TIER_PENALTIES,
                  timed_runs=0)

    # The int8 leg (K1q): the same pair of runs, int8 codes and scales
    # swapped and spilled verbatim.
    reset_launches()
    c0 = _tier_counts()
    q_b = batcher_lib.ContinuousBatcher(**{**ctor, "kv_bits": 8})
    q_pressed, q_wall, q_steps = _tier_engine_run(torch, q_b, reqs)
    q_launches = read_launches()
    q_counts = _tier_counts(c0)
    del q_b
    _free(torch)
    q_calm_b = batcher_lib.ContinuousBatcher(
        **{**ctor, "kv_bits": 8, "paged_pages": 256, "host_pages": 0})
    q_calm, _, _ = _tier_engine_run(torch, q_calm_b, reqs)
    del q_calm_b
    _free(torch)
    emit("serve_tier_int8", path="tiered", counters=q_counts,
         decode_steps=q_steps, ms_per_decode_step=q_wall * 1e3 / q_steps,
         launches={k: v for k, v in q_launches.items() if v})
    _check_swapped("tiered/int8", q_counts)
    want = b.cfg.num_layers * q_steps
    check(q_launches["paged_decode_attention_int8"] >= want,
          f"tiered/int8: K1q launched "
          f"{q_launches['paged_decode_attention_int8']} times, under {want}")
    _same_streams("tiered/int8", reqs, q_pressed, q_calm)
    del server, b
    _free(torch)
    return {"paged_decode_attention": launches["paged_decode_attention"],
            "paged_decode_attention_int8":
                q_launches["paged_decode_attention_int8"]}


def named_prefix_logits(torch, b) -> None:
    """The named prefix at full width: the first-token logits of a
    prefix-seeded admission (``admit_row_with_prefix_paged``'s prefill)
    against the whole prompt's (``admit_row_paged``'s), by phase_model's
    rule; and each admission samples its logits' argmax."""
    from distributed_llms_tpu_torch.runtime import batcher as bl
    from distributed_llms_tpu_torch.runtime.shapes import bucket_length

    pfx = b.prefixes["sys"]
    suffix = b.tokenizer.encode(_tier_text("named H", 90))
    whole = pfx.ids + suffix
    chunk = torch.zeros(min(bucket_length(len(suffix)), b.s - len(pfx.ids)),
                        dtype=torch.int32)
    chunk[:len(suffix)] = torch.tensor(suffix)
    prompt = torch.zeros(min(bucket_length(len(whole)), b.s),
                         dtype=torch.int32)
    prompt[:len(whole)] = torch.tensor(whole)
    chunk, prompt = chunk.cuda(), prompt.cuda()
    with torch.no_grad():
        lp, _ = bl._prefill_row_with_prefix(b.params, b.cfg, pfx.k.clone(),
                                            pfx.v.clone(), len(pfx.ids),
                                            chunk)
        lw, _ = bl._prefill_row(b.params, b.cfg, pfx.k.dtype, b.s, prompt)
    lp, lw = lp[0, len(suffix) - 1].float(), lw[0, len(whole) - 1].float()
    err = (lp - lw).abs().max().item()
    scale = lw.abs().max().item()
    pool = bl._paged_pool(b.cfg, 1 + b.pages_per_row, b.page_size,
                          device="cuda")
    pages = torch.arange(1, 1 + b.pages_per_row, dtype=torch.int32,
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, tok_p, _ = bl.admit_row_with_prefix_paged(
        b.params, b.cfg, pool, pages, pfx.k, pfx.v, len(pfx.ids), chunk,
        len(suffix), gen)
    _, tok_w, _ = bl.admit_row_paged(b.params, b.cfg, pool, pages, prompt,
                                     len(whole), gen)
    emit("named_prefix", prefix_tokens=len(pfx.ids),
         suffix_tokens=len(suffix), max_abs_logit_err=err, logit_scale=scale,
         argmax_agree=int(lp.argmax()) == int(lw.argmax()))
    check(err <= 0.05 * max(scale, 1.0),
          f"named prefix: first-token logits off by {err} (scale {scale})")
    check(int(tok_p) == int(lp.argmax()) and int(tok_w) == int(lw.argmax()),
          "named prefix: an admission did not sample its logits' argmax")
    del pool
    _free(torch)


def parcel_round_trip(torch) -> None:
    """A 9-page parcel of Llama-3-8B pages (bf16, and int8 codes with
    their f32 scales) through the pinned arena and back into other pages
    of the pool: equal to the bit.  Timed in parts (median of 3): the
    swap-out's gather, device-to-host copy and checksum, the restore's
    verification, host-to-device copy and scatter."""
    from distributed_llms_tpu_torch.models.presets import get_preset
    from distributed_llms_tpu_torch.runtime import batcher as bl
    from distributed_llms_tpu_torch.runtime.kv_tier import HostTier

    cfg = get_preset("llama-3-8b")
    n = PARCEL_PAGES
    src = torch.arange(1, 1 + n, dtype=torch.int32, device="cuda")
    dest = torch.arange(1 + n, 1 + 2 * n, dtype=torch.int32, device="cuda")
    for kv_bits in (16, 8):
        pool = bl._paged_pool(cfg, 1 + 2 * n, 64, device="cuda",
                              kv_bits=kv_bits)
        g = torch.Generator(device="cuda").manual_seed(1)
        leaves = [pool.k, pool.v] + ([pool.k_scale, pool.v_scale]
                                     if kv_bits == 8 else [])
        for t in leaves:
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
            elif t.dtype == torch.float32:
                torch.nn.init.uniform_(t, generator=g)
            else:
                torch.nn.init.normal_(t, generator=g)
        tier = HostTier(n, bl.page_layout(pool), pin=True)
        parcel_bytes = sum(t[:, :n].numel() * t.element_size()
                           for t in leaves)
        parts: dict = {}
        for _ in range(3):
            for t in leaves:
                t[:, 1 + n:].zero_()
            marks = []
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            payload = bl._export_pages_raw(pool, src)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            h = tier.park_swap(payload, n)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            entry = tier._swaps[h]
            entry.future.result()
            t0 = time.perf_counter()
            tier._checksum(entry.slots)
            checksum = time.perf_counter() - t0
            t0 = time.perf_counter()
            parcel = tier.take_swap(h)
            verify = time.perf_counter() - t0
            check(parcel is not None, "parcel round trip: verification "
                                      "failed")
            t0 = time.perf_counter()
            arrays = parcel.to("cuda")
            torch.cuda.synchronize()
            h2d = time.perf_counter() - t0
            t0 = time.perf_counter()
            bl._import_pages_raw(pool, dest, *arrays)
            torch.cuda.synchronize()
            scatter = time.perf_counter() - t0
            for name, v in (("gather", marks[1] - marks[0]),
                            ("d2h", marks[2] - marks[1]),
                            ("checksum", checksum), ("verify", verify),
                            ("h2d", h2d), ("scatter", scatter)):
                parts.setdefault(name, []).append(v * 1e3)
            for t in leaves:
                check(torch.equal(t[:, dest.long()], t[:, src.long()]),
                      f"parcel round trip (kv_bits {kv_bits}): the pages "
                      f"came back changed")
        med = {k: sorted(v)[1] for k, v in parts.items()}
        emit("parcel", kv_bits=kv_bits, pages=n, parcel_bytes=parcel_bytes,
             pinned_host_bytes=tier.pinned_bytes,
             **{f"{k}_ms": v for k, v in med.items()},
             swap_out_ms=med["gather"] + med["d2h"] + med["checksum"],
             restore_ms=med["verify"] + med["h2d"] + med["scatter"],
             d2h_gb_per_s=parcel_bytes / med["d2h"] / 1e6,
             h2d_gb_per_s=parcel_bytes / med["h2d"] / 1e6)
        tier.assert_consistent([])
        del pool, tier, payload, parcel, arrays
        _free(torch)


# -- path j: speculative decoding on path a's model ---------------------------

SPEC_K = 4  # runtime.spec_k's default: --spec-decode alone gives it
SPEC_NEW = 64
SPEC_ARGS = ["--preset", "llama-3-8b", "--paged-pages", "256", "--page-size",
             "64", "--prefix-cache", "--spec-decode", "--max-len", "1024",
             *_COMMON_ARGS]
# Check (a)'s bound on a greedy stream that left the plain batcher's: at
# every position the committed token's logit under a teacher-forced
# reference forward (one no-cache forward over prompt + stream, dense
# attention) lies within this many times the plain stream's own worst
# margin under the same forward (the plain decode's bf16 rounding against
# the reference's) of the maximum.  A wrong commit lands O(1) logits
# below (random weights: logits ~N(0, 1), the top ~4.5 above the mean).
SPEC_MARGIN_FACTOR = 4.0
SPEC_SAMPLED_TEMPERATURE = 0.8
SPEC_WINDOW_LENGTHS = (0, 1, 63, 64, 303, 352, 700, 1023)  # cache_index
# The profiled batch of the round's cost: 16 new tokens (15 rounds, ~60k
# device kernels) keep the profiler's own host-side processing short.
SPEC_PROFILED_NEW = 16


def _lap(phase: str):
    """A stopwatch emitting ``{"phase": phase, "part": ..., "seconds":
    ...}`` lines: each call times the part since the previous one."""
    last = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        emit(phase, part=part, seconds=now - last[0])
        last[0] = now
    return lap


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def spec_requests() -> list:
    """Path j's traffic: path a's seven prompts, all greedy, 64 new tokens
    each — three over path a's 303-byte prefix, one over SSE, one naming
    the registered prefix "sys" (path a's top-p and top-k requests would
    now be refused: a speculative engine samples with its own config)."""
    def completion(prompt, **kw):
        return ("/v1/completions", {"prompt": prompt, "max_tokens": SPEC_NEW,
                                    "temperature": 0.0, **kw})

    def chat(*messages):
        return ("/v1/chat/completions", {
            "messages": [{"role": r, "content": c} for r, c in messages],
            "max_tokens": SPEC_NEW, "temperature": 0.0})

    return [
        completion(PATH_A_PREFIX + "Case A: a pallet arrived late.",
                   logprobs=True),
        completion(PATH_A_PREFIX + "Case B: a crate is dented."),
        completion(PATH_A_PREFIX + "Case A: a pallet arrived late.",
                   logprobs=True),
        completion("Summarise policy 12 in a line.", prefix="sys"),
        completion("Streaming check: count to ten.", stream=True),
        completion("Top-k sampling check."),
        chat(("system", "Be brief."), ("user", "Name three ports.")),
    ]


def _record_submits(b) -> tuple:
    """Wrap batcher ``b`` so that each submit's (rid, prompt ids, prefix) is
    kept in order, and each request's delivered token ids by rid."""
    subs, streams = [], {}
    submit, run = b.submit, b.run

    def submit_rec(prompt, *a, prefix=None, **kw):
        rid = submit(prompt, *a, prefix=prefix, **kw)
        ids = b.tokenizer.encode(prompt) if isinstance(prompt, str) else prompt
        subs.append((rid, list(ids), prefix))
        return rid

    def run_rec(on_tokens=None):
        def rec(rid, toks, done, lps):
            streams.setdefault(rid, []).extend(toks)
            return on_tokens(rid, toks, done, lps)
        return run(on_tokens=rec)

    b.submit, b.run = submit_rec, run_rec
    return subs, streams


async def _serve_spec_requests(port: int, reqs) -> dict:
    t0 = time.perf_counter()
    outs = await asyncio.gather(*[
        _sse(port, body) if body.get("stream") else _http(port, path, body)
        for path, body in reqs])
    wall = time.perf_counter() - t0
    n = 0
    for (path, body), out in zip(reqs, outs):
        if body.get("stream"):
            continue  # _sse checked the status and the [DONE]
        status, resp = out
        check(status == 200, f"spec: {path} answered {status}: {resp}")
        got = resp["usage"]["completion_tokens"]
        check(got == SPEC_NEW or resp["choices"][0]["finish_reason"] == "stop",
              f"spec: {path} produced {got}/{SPEC_NEW} tokens")
        n += got
        lp = resp["choices"][0].get("logprobs")
        if lp:
            check(all(math.isfinite(x) and x <= 0
                      for x in lp["token_logprobs"]),
                  "spec: non-finite or positive logprob")
    return {"requests": len(reqs), "completion_tokens_non_sse": n,
            "wall_s": wall}


def _engine_run(torch, b, subs, new=SPEC_NEW) -> tuple:
    """``subs`` [(rid, ids, prefix)] submitted to batcher ``b`` engine-side
    in order: (streams in that order, wall seconds)."""
    if "sys" not in b.prefixes:
        b.register_prefix("sys", PATH_A_PREFIX)
    rids = [b.submit(ids, max_new_tokens=new, prefix=pfx)
            for _, ids, pfx in subs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b.assert_pool_consistent()
    return [res[r] for r in rids], wall


def _margins(torch, b, ctx, stream) -> list:
    """Teacher-forced greedy margins of ``stream`` after context ``ctx``:
    at each position the maximum logit less the streamed token's, from one
    no-cache forward of the target over ctx + stream (dense attention)."""
    from distributed_llms_tpu_torch.models import model as model_lib

    toks = torch.tensor([ctx + stream[:-1]], device=b.device)
    with torch.no_grad():
        logits, _ = model_lib.forward(b.params, b.cfg, toks)
    lg = logits[0, len(ctx) - 1:]
    chosen = lg.gather(-1, torch.tensor(stream, device=b.device)[:, None])
    return (lg.max(-1).values - chosen[:, 0]).float().cpu().tolist()


def _held_to_plain(torch, label, b, subs, got, want) -> dict:
    """Check (a)/(b)/(c): the speculative streams ``got`` against the plain
    batcher's ``want`` for the same requests.  Identical streams pass; a
    stream that leaves the plain one must be the target's greedy stream up
    to rounding: its worst teacher-forced margin within SPEC_MARGIN_FACTOR
    x the plain streams' worst (both against the same reference forward).
    Returns what it measured."""
    identical = [g == w for g, w in zip(got, want)]
    first = [next((j for j, (x, y) in enumerate(zip(g, w)) if x != y),
                  None if len(g) == len(w) else min(len(g), len(w)))
             for g, w in zip(got, want)]
    out = {"streams": len(got), "identical": sum(identical),
           "first_divergence": first}
    if not all(identical):
        pfx = b.prefixes["sys"].ids
        spec_m, plain_m = [], []
        for (_, ids, p), g, w in zip(subs, got, want):
            ctx = (pfx if p else []) + ids
            spec_m += _margins(torch, b, ctx, g)
            plain_m += _margins(torch, b, ctx, w)
        bound = SPEC_MARGIN_FACTOR * max(max(plain_m), 1e-3)
        out.update(spec_margin_max=max(spec_m), plain_margin_max=max(plain_m),
                   margin_bound=bound,
                   spec_positions_off_argmax=sum(m > 0 for m in spec_m),
                   plain_positions_off_argmax=sum(m > 0 for m in plain_m),
                   positions=len(spec_m))
        check(max(spec_m) <= bound,
              f"{label}: a speculative stream commits a token "
              f"{max(spec_m):.4f} logits below the target's greedy choice "
              f"(plain streams' worst {max(plain_m):.4f}, bound {bound:.4f})")
    return out


def _spec_kernel_split(torch, prof) -> dict:
    """Device milliseconds of a speculative profile: draft K5, draft K2,
    verify K1 (each with its split-merge launches: a merge is charged to
    the decode kernel launched before it), cuBLAS, the rest."""
    split = {"draft_k5": 0.0, "draft_k2": 0.0, "verify_k1": 0.0,
             "cublas": 0.0, "rest": 0.0}
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    last = "rest"
    for e in events:
        name = e.name
        if "quant_matmul" in name:
            cls = "draft_k5"
        elif "ragged_decode_kernel" in name:
            cls = last = "draft_k2"
        elif "paged_decode_kernel" in name:
            cls = last = "verify_k1"
        elif "split_decode_merge" in name:
            cls = last
        elif _kernel_class(name) == "matmul":
            cls = "cublas"
        else:
            cls = "rest"
        split[cls] += e.device_time_total
    return {k: v / 1e3 for k, v in split.items()}


def _spec_loops(torch, label, ctor, subs) -> dict:
    """Check (d): a sampled speculative batcher (temperature 0.8, seed 7)
    gives the same streams under the eager loop (every kernel launched
    from Python, ``_spec_steps``), the graph without the overlap and the
    default (graph and overlap)."""
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    graph_round = batcher_lib.spec_chunk
    streams, stats = {}, {}
    for name, overlap, eager in LOOPS:
        b = batcher_lib.ContinuousBatcher(**{
            **ctor, "temperature": SPEC_SAMPLED_TEMPERATURE, "seed": 7,
            "overlap": overlap})
        if eager:
            batcher_lib.spec_chunk = (
                lambda *a, graphs=None, **kw: batcher_lib._spec_steps(*a, **kw))
        try:
            streams[name], wall = _engine_run(torch, b, subs)
        finally:
            batcher_lib.spec_chunk = graph_round
        stats[name] = {"rounds": b.spec_stats["rounds"], "wall_s": wall,
                       "graph_replays": b._graphs.replays,
                       "dispatched_ahead": b.overlap_stats["dispatched_ahead"]}
        check((b._graphs.replays > 0) != eager,
              f"{label}/{name}: graph replays {b._graphs.replays}")
        del b
        _free(torch)
    same = (streams["graph_overlap"] == streams["graph_sync"]
            == streams["eager_sync"])
    emit("serve_spec_sampled", path=label, card=_card(),
         temperature=SPEC_SAMPLED_TEMPERATURE, loops=stats,
         streams_identical=same)
    check(same, f"{label}: sampled streams differ between the engine loops")
    check(stats["graph_overlap"]["dispatched_ahead"] > 0,
          f"{label}: no round was dispatched ahead")
    return stats


def spec_window_checks(torch) -> dict:
    """Check (e): the verify window's one K1/K1q launch over B*T virtual
    rows at path j's shape (B=8, T=k+1, 32/8 heads of 128, 64-slot pages,
    a 17-page table: 1029 slots) against T single-offset launches (the
    reference's formulation) and the plain version, every row within 1%
    of its L2 norm (+ 2^-7 int8)."""
    from distributed_llms_tpu_torch.checkpoint.quantize import kv_quantize
    from distributed_llms_tpu_torch.models.model import paged_window_rows
    from distributed_llms_tpu_torch.ops import decode_attn

    gen = torch.Generator(device="cuda").manual_seed(21)
    b, t, h, kvh, d, blk = 8, SPEC_K + 1, 32, 8, 128, 64
    p = -(-(1024 + SPEC_K + 1) // blk)
    nb = 1 + b * p
    bf = [torch.randn((nb, blk, kvh, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16) for _ in range(2)]
    tables = (torch.randperm(nb - 1, generator=gen, device="cuda")[: b * p]
              .reshape(b, p).to(torch.int32) + 1)
    cache_index = torch.tensor(SPEC_WINDOW_LENGTHS, dtype=torch.int32,
                               device="cuda")
    q = torch.randn((b, t, h, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    _, _, lengths, rep = paged_window_rows(tables, cache_index, t, blk)
    out = {}
    for quant in (False, True):
        pool, scales = bf, {}
        if quant:
            (kq, ks), (vq, vs) = (kv_quantize(a) for a in bf)
            pool, scales = [kq, vq], dict(k_scale=ks, v_scale=vs)
        one = decode_attn.paged_decode_attention(
            q.reshape(b * t, 1, h, d), *pool, lengths, rep, **scales)
        each = torch.cat([decode_attn.paged_decode_attention(
            q[:, j:j + 1].contiguous(), *pool, cache_index + 1 + j, tables,
            **scales) for j in range(t)], dim=1)
        plain = decode_attn.paged_reference(
            q.reshape(b * t, 1, h, d), *pool, lengths, rep, *scales.values())
        limit = DECODE_ROW_REL + (2.0 ** -7 if quant else 0.0)
        vs_each = row_rel_err(torch, one.reshape(b, t, h, d), each)
        vs_plain = row_rel_err(torch, one, plain)
        name = ("paged_decode_attention_int8" if quant
                else "paged_decode_attention")
        emit("kernel", name=name, shape="spec_window", B=b, T=t,
             cache_index=list(SPEC_WINDOW_LENGTHS), pages=p,
             max_row_rel_err_vs_per_offset=vs_each,
             max_row_rel_err_vs_plain=vs_plain, limit=limit)
        check(vs_each <= limit and vs_plain <= limit,
              f"{name}: the one-launch window disagrees ({vs_each:.4g} vs "
              f"the per-offset launches, {vs_plain:.4g} vs plain)")
        out[name] = vs_plain
    return out


def _timed_batch(torch, b, prompts, profile) -> dict:
    """8 greedy requests (300-token prompts, 64 new, cold admissions) on
    batcher ``b``: wall, rounds or decode steps, committed tokens; with
    ``profile`` once more, with SPEC_PROFILED_NEW new tokens, under the
    profiler (its device split also per round or decode step)."""
    rounds0 = b.spec_stats["rounds"]
    steps0 = b.decode_steps
    stats0 = dict(b.spec_stats)
    got, wall, _, _ = _run_batch(torch, b, prompts)
    committed = sum(len(t) - 1 for t in got)  # decode tokens (admission's not)
    line = {"wall_ms": wall * 1e3, "decode_steps": b.decode_steps - steps0,
            "committed_decode_tokens": committed}
    if b.speculative:
        r = b.spec_stats["rounds"] - rounds0
        acc = b.spec_stats["accepted"] - stats0["accepted"]
        rej = b.spec_stats["rejected"] - stats0["rejected"]
        line.update(rounds=r, ms_per_round=wall * 1e3 / r,
                    tokens_per_round_per_row=committed / (r * len(prompts)),
                    acceptance=acc / max(acc + rej, 1),
                    ms_per_committed_token_per_row=(
                        wall * 1e3 * len(prompts) / committed))
    else:
        line.update(ms_per_decode_step=wall * 1e3 / max(line["decode_steps"],
                                                         1))
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as profiler

        steps0, rounds0 = b.decode_steps, b.spec_stats["rounds"]
        with profiler(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _run_batch(torch, b, prompts, new=SPEC_PROFILED_NEW)
            torch.cuda.synchronize()
            pwall = (time.perf_counter() - t0) * 1e3
        split = (_spec_kernel_split(torch, prof) if b.speculative
                 else _kernel_split(torch, prof))
        busy = sum(split.values())
        n = (b.spec_stats["rounds"] - rounds0 if b.speculative
             else b.decode_steps - steps0)
        line.update(profiled_new_tokens=SPEC_PROFILED_NEW,
                    profiled_wall_ms=pwall, profiled_steps=n,
                    device_kernel_ms=split,
                    device_kernel_ms_per_step={k: v / max(n, 1)
                                               for k, v in split.items()},
                    device_busy_share=busy / pwall if busy else "not measured")
    return line, got


def serve_spec(torch, profile: bool) -> dict:
    """Path j: ``dlt-serve-torch --preset llama-3-8b --paged-pages 256
    --page-size 64 --prefix-cache --spec-decode --max-len 1024 --slots 8``
    (spec_k 4, the int4 self-draft) answers :func:`spec_requests` over
    HTTP, then checks (a)-(e) engine-side over the same weights: (a) the
    HTTP streams against a plain batcher's; (b) the same with int8 pages
    (K1q's window) against the plain int8 batcher; (c) an explicit draft
    ``attach_draft(cfg, params)`` (the bf16 target itself); (d) a sampled
    batcher under the three engine loops; (e) the one-launch window
    against per-offset K1/K1q launches.  Then the round's cost: 8 requests
    timed on the speculative batcher and the plain one, and (with
    ``profile``) the round's device split.  Returns path j's launches of
    K1, K1q, K2 and K5 int4."""
    from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
    from distributed_llms_tpu_torch.core.config import RuntimeConfig
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib
    from distributed_llms_tpu_torch.runtime.engine import InferenceEngine

    card = _card()
    lap = _lap("spec_time")
    reqs = spec_requests()
    box: dict = {}

    def setup(server) -> None:
        b = server.batcher
        check(b.speculative and b.spec_k == SPEC_K and b.paged,
              "spec: the served batcher does not speculate")
        wq = b.draft_params["blocks"]["attn"]["wq"]
        check(isinstance(wq, QuantizedTensor) and wq.bits == 4,
              "spec: the draft is not the int4 self-draft")
        b.register_prefix("sys", PATH_A_PREFIX)
        box["subs"], box["streams"] = _record_submits(b)
        torch.cuda.reset_peak_memory_stats()

    per_round = {"paged_decode_attention": 1,
                 "ragged_decode_attention": SPEC_K + 1,
                 "quant_matmul_int4": 7 * (SPEC_K + 1)}
    launches, server, mem = serve_path(
        torch, "spec", SPEC_ARGS, per_round,
        lambda port: _serve_spec_requests(port, reqs), _llama_3_8b,
        setup=setup)
    b = server.batcher
    subs, streams = box.pop("subs"), box.pop("streams")
    got = [streams[rid] for rid, _, _ in subs]
    out = {k: launches[k] for k in per_round}
    acc, rej = b.spec_stats["accepted"], b.spec_stats["rejected"]
    emit("serve_spec", path="spec", card=card, rounds=b.spec_stats["rounds"],
         spec_stats=b.spec_stats, acceptance=acc / max(acc + rej, 1),
         committed_decode_tokens=sum(len(t) - 1 for t in got),
         tokens_per_round_per_row_http=(
             sum(len(t) - 1 for t in got) / max(b.spec_stats["rounds"], 1)
             / len(got)),
         serving_peak_mem_gb=mem["peak_mem_gb"],
         resident_gb=mem["resident_gb"],
         draft_cache_gb=2 * b.draft_cache.k.nbytes / 1e9,
         prefix_cache_hits=b.prefix_cache.hits)
    check(b.prefix_cache.hits > 0, "spec: no prefix-cache hit")
    lap("boot_and_http")
    ctor = dict(b._ctor_args)
    plain_ctor = {**ctor, "draft_params": None, "draft_cfg": None}

    # (a) the HTTP streams against the plain batcher's, engine-side.
    plain_b = batcher_lib.ContinuousBatcher(**plain_ctor)
    want, _ = _engine_run(torch, plain_b, subs)
    del plain_b
    _free(torch)
    emit("serve_spec_check", path="spec", check="a_http_vs_plain", card=card,
         **_held_to_plain(torch, "spec/a", b, subs, got, want))
    lap("a")

    # (b) int8 pages: the speculative int8 batcher (K1q's window) against
    # the plain int8 batcher.
    reset_launches()
    q_spec = batcher_lib.ContinuousBatcher(**{**ctor, "kv_bits": 8})
    q_got, _ = _engine_run(torch, q_spec, subs)
    q_launches = read_launches()
    q_rounds = q_spec.spec_stats["rounds"]
    del q_spec
    _free(torch)
    check(q_launches["paged_decode_attention_int8"]
          >= b.cfg.num_layers * q_rounds,
          f"spec/int8: K1q launched {q_launches['paged_decode_attention_int8']}"
          f" times, under {b.cfg.num_layers} x {q_rounds} rounds")
    q_plain = batcher_lib.ContinuousBatcher(**{**plain_ctor, "kv_bits": 8})
    q_want, _ = _engine_run(torch, q_plain, subs)
    del q_plain
    _free(torch)
    out["paged_decode_attention_int8"] = q_launches[
        "paged_decode_attention_int8"]
    emit("serve_spec_check", path="spec", check="b_int8_vs_plain_int8",
         card=card, rounds=q_rounds,
         launches={k: v for k, v in q_launches.items() if v},
         **_held_to_plain(torch, "spec/b", b, subs, q_got, q_want))
    lap("b")

    # (c) an explicit draft through attach_draft: the bf16 target itself.
    eng = InferenceEngine(b.cfg, RuntimeConfig(spec_k=SPEC_K), b.params,
                          tokenizer=b.tokenizer, device=b.device)
    eng.attach_draft(b.cfg, b.params)
    x_b = eng.continuous_batcher(batch_slots=b.b, max_len=b.s,
                                 paged_pages=ctor["paged_pages"],
                                 page_size=b.page_size, prefix_cache=True,
                                 speculative=True)
    x_got, _ = _engine_run(torch, x_b, subs)
    x_acc, x_rej = x_b.spec_stats["accepted"], x_b.spec_stats["rejected"]
    # A greedy round commits the verify's own tokens, so the stream does
    # not depend on the draft: the bf16 draft's streams equal the int4
    # self-draft's (path j's HTTP streams) to the token.
    emit("serve_spec_check", path="spec", check="c_explicit_draft_vs_plain",
         card=card, spec_stats=x_b.spec_stats,
         acceptance=x_acc / max(x_acc + x_rej, 1),
         streams_equal_the_int4_draft=x_got == got,
         **_held_to_plain(torch, "spec/c", b, subs, x_got, want))
    check(x_got == got, "spec/c: the bf16 draft's greedy streams differ from "
          "the int4 self-draft's")
    del x_b, eng
    _free(torch)
    lap("c")

    # (d) a sampled batcher under the three engine loops.
    _spec_loops(torch, "spec", ctor, subs)
    lap("d")

    # (e) the one-launch verify window at path j's shape.
    spec_window_checks(torch)
    lap("e")

    # The round's cost against a plain decode step at the same batch.
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 256, (LOOP_PROMPT_TOKENS,),
                             generator=g).tolist() for _ in range(b.b)]
    lines = {}
    for name, kw in (("spec", ctor), ("plain", plain_ctor)):
        tb_ = batcher_lib.ContinuousBatcher(**kw)
        _run_batch(torch, tb_, prompts)  # captures the graphs
        lines[name], _ = _timed_batch(torch, tb_, prompts, profile)
        if name == "spec":
            lines[name]["peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                          / 1e9)
        del tb_
        _free(torch)
    lap("cost")
    emit("serve_spec_cost", path="spec", card=card, requests=b.b,
         prompt_tokens=LOOP_PROMPT_TOKENS, new_tokens=LOOP_NEW_TOKENS,
         spec=lines["spec"], plain=lines["plain"],
         spec_ms_per_token_over_plain_ms_per_step=(
             lines["spec"]["ms_per_committed_token_per_row"]
             / lines["plain"]["ms_per_decode_step"]))
    del server, b
    _free(torch)
    return out


def _kernel_class(name: str) -> str:
    if "flash_kernel" in name:
        return "flash_kernel"
    if "quant_matmul" in name:
        return "quant_matmul_kernel"
    if any(k in name for k in ("paged_decode_kernel", "ragged_decode_kernel",
                               "split_decode_merge")):
        return "decode_attention_kernel"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "splitK",
                               "sm90_xmma")):
        return "matmul"
    return "other"


def _kernel_split(torch, prof) -> dict:
    """Device kernel milliseconds of a profile, by kernel class."""
    split = {"flash_kernel": 0.0, "quant_matmul_kernel": 0.0,
             "decode_attention_kernel": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            split[_kernel_class(e.name)] += e.device_time_total
    return {k: v / 1e3 for k, v in split.items()}


def _kernel_names(torch, prof, cls: str) -> dict:
    """Launches of each device function of class ``cls`` in a profile, by
    its name without template arguments: which kernels a class counted."""
    names = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and _kernel_class(e.name) == cls):
            key = _function_name(e.name)
            names[key] = names.get(key, 0) + 1
    return names


def _profiled(torch, fn) -> tuple[dict, float]:
    """Run ``fn`` once under the profiler: (device ms by kernel class,
    wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _kernel_split(torch, prof), wall * 1e3


def flash_admission(torch, batcher, profile: bool) -> None:
    """Path f's served batcher once more, outside HTTP (a second
    32768-slot cache would not fit beside it): one FLASH_PROMPT_BYTES-token
    prompt admitted alone and decoded 16 tokens.  The admission token's
    time from submit is the admission's time to first token (random
    weights mostly emit bytes that decode to no text, so an SSE client
    sees no early event to time).  Then, with ``profile``, the same under
    the profiler: K4's share of the admission.  Information, not a gate."""
    g = torch.Generator().manual_seed(6)

    def run():
        prompt = torch.randint(0, 256, (FLASH_PROMPT_BYTES,),
                               generator=g).tolist()
        first = []
        t0 = time.perf_counter()
        batcher.submit(prompt, max_new_tokens=16)
        batcher.run(on_tokens=lambda *a: first or first.append(
            time.perf_counter() - t0))
        torch.cuda.synchronize()
        return first[0], time.perf_counter() - t0

    ttft, total = run()
    emit("serve_ttft", path="flash_prefill", prompt_tokens=FLASH_PROMPT_BYTES,
         new_tokens=16, ttft_s=ttft, request_s=total)
    if profile:
        split, wall = _profiled(torch, run)
        busy = sum(split.values())
        emit("profile", path="flash_prefill", requests=1,
             prompt_tokens=FLASH_PROMPT_BYTES, new_tokens=16,
             profiled_wall_ms=wall, device_kernel_ms=split,
             flash_share_of_device=split["flash_kernel"] / busy if busy else
             "not measured",
             decode_attention_share_of_device=(
                 split["decode_attention_kernel"] / busy if busy else
                 "not measured"),
             device_busy_share=busy / wall if busy else "not measured")


# -- main -------------------------------------------------------------------

PHASES = ("build", "kernel", "timing", "model", "serve", "tier", "spec",
          "train", "profile")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    phases = ap.parse_args().phases.split(",")
    if not (REPO / "distributed_llms_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(distributed_llms_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    kernels = {name: {"name": name, **info, "launches": None,
                      "max_abs_err": None, "ms": None, "plain_ms": None,
                      "bound_ms": None, "bound_by": None, "library_ms": None}
               for name, info in KERNELS.items()}
    t_start = time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            emit("phase_time", name=phase,
                 seconds=time.perf_counter() - t0,
                 since_start_s=time.perf_counter() - t_start)

    profile = "profile" in phases
    try:
        if "build" in phases:
            timed("build", phase_build)
        if "kernel" in phases:
            for name, got in timed("kernel", phase_kernel, torch).items():
                kernels[name].update(got)
        if "timing" in phases:
            for name, got in timed("timing", phase_timing, torch).items():
                kernels[name].update(got)
        if "model" in phases:
            timed("model", phase_model, torch)
        if "serve" in phases:
            for name, n in timed("serve", phase_serve, torch,
                                 profile).items():
                kernels[name]["launches"] = n
        if "tier" in phases:
            # Path i runs K1 and K1q too; paths a and b keep the line's
            # counts (their own paths).
            emit("serve_tier_launches", **timed("tier", serve_tiered, torch))
        if "spec" in phases:
            # Path j's launches ride beside each kernel's own path's.
            for name, n in timed("spec", serve_spec, torch, profile).items():
                kernels[name]["spec_launches"] = n
        if "train" in phases:
            kernels["flash_attention_static"]["launches"] = timed(
                "train", phase_train, torch, profile)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    if set(phases) != set(PHASES):
        print("partial run: no result line", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
