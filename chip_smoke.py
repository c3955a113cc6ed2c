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
   int8 and int4), the threads, dynamic shared memory, local (spill)
   bytes and resident blocks per SM.
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
   and window 4096 at T=8192) and K4 at path f's admission (8192 queries
   over a 32768-slot row with the first 8192 slots written, window 4096;
   the same without causality or window; 1000 queries at positions
   5000..5999), each output row within 1% of the plain row's L2 norm;
   and K3's backward (gradients through the kernel's autograd function,
   the bf16 dense recompute) within 1% of the float32 gradient.
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
   of split counts (down, wk/wv).
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
      first token read engine-side from submit to the admission token.
   Every kernel's launch count is reset just before each path and read
   just after; the run fails unless the path's kernels launched at least
   layers x decode steps times (7 x that for K5, one per projection).
   Each engine is freed before the next boots.  The device memory an
   engine holds once booted (its weights and KV pool, measured with
   ``torch.cuda.memory_allocated``) must be below path a's on paths d and
   e by at least 90% of what their quantized block weights save over
   bf16 (computed from the served leaves), and path d must peak below
   path a.  Path f must launch K4 at least 32 times per admission.
6. ``train`` — path g: ``runtime.train.Trainer`` on Llama-3-8B's width
   (d_model 4096, 32/8 heads, FFN 14336, vocab 128256) cut to 8 layers,
   ``attn_impl="flash"``, random weights from seed 0, AdamW at lr 1e-3:
   3 steps on one fixed batch [2, 4097], then one with ``remat=True``.
   The loss must be finite and fall over the 3 steps, and K3 must launch
   8 times per step (16 under remat).
7. ``profile`` — path a's weights, and then path d's, serve a batch of 8
   requests once more under ``torch.profiler``: host wall time against
   device kernel time, split into K5, the decode-attention kernels (with
   the launches of each device function of both counted, by name), other
   matrix products and the rest; path f's weights admit one 8000-byte
   prompt, and path g takes one step, under the profiler too, split the
   same way with the flash kernels apart (information, not a gate).

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
# lengths.  On the H100 the sound kernels read 0.0044-0.0046 at every
# shape below; kernels with a planted fault (a key off by one at the
# diagonal or the window edge, a skipped edge tile, a zeroed output) read
# 0.26-1.9.
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


def flash_kernel_checks(torch) -> dict:
    """K3 at path g's shapes (and windowed at twice the length), K4 at
    path f's admission (and without causality or window, and a ragged
    query count at an offset), each against ``flash_reference``; K3's
    backward (bf16) against the float32 gradient of ``dense_reference``."""
    from distributed_llms_tpu_torch.ops import flash

    worst = {"flash_attention_static": 0.0, "flash_attention_dynamic": 0.0}
    for t, window in ((TRAIN_T, None), (2 * TRAIN_T, WINDOW)):
        q, k, v = flash_case(torch, tq=t, seed=30 + t)
        err = _row_held(torch, "flash_attention_static",
                        flash.flash_attention(q, k, v, window=window),
                        flash.flash_reference(q, k, v, window=window),
                        FLASH_ROW_REL, T=t, window=window)
        worst["flash_attention_static"] = max(
            worst["flash_attention_static"], err)
    s = FLASH_MAX_LEN
    for tq, first, causal, window in ((ADMIT_T, 0, True, WINDOW),
                                      (ADMIT_T, 0, False, None),
                                      (1000, 5000, True, WINDOW)):
        q, k, v = flash_case(torch, tq=tq, s=s, seed=40 + tq)
        kw = admission_args(torch, tq, s, first, window, causal)
        err = _row_held(torch, "flash_attention_dynamic",
                        flash.flash_attention(q, k, v, **kw),
                        flash.flash_reference(q, k, v, **kw),
                        FLASH_ROW_REL, Tq=tq, S=s, first_position=first,
                        causal=causal, window=window)
        worst["flash_attention_dynamic"] = max(
            worst["flash_attention_dynamic"], err)
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
    out["flash_attention_static"] = _timed(
        "flash_attention_static",
        {"B": b, "T": t, "H": h, "KVH": kvh, "D": d, "causal": True,
         "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h * b), io,
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True)",
        achieved_tflop_s=4 * pairs * d * h * b / (tm["ms"] * 1e-3) / 1e12)
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
    out["flash_attention_dynamic"] = _timed(
        "flash_attention_dynamic",
        {"B": b, "Tq": ADMIT_T, "S": s, "H": h, "KVH": kvh, "D": d,
         "window": WINDOW, "written": ADMIT_T, "live_pairs_per_head": pairs},
        tm, *_bound(0, io, 4 * pairs * d * h * b), io,
        library="F.scaled_dot_product_attention(attn_mask=bool) under "
                "EFFICIENT_ATTENTION/CUDNN_ATTENTION, K/V heads expanded",
        achieved_tflop_s=4 * pairs * d * h * b / (tm["ms"] * 1e-3) / 1e12)
    del q, k, v, qt, kt, vt, mask
    _free(torch)
    return out


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


async def _serve_requests(port: int) -> dict:
    prefix = ("You are a careful assistant for a logistics company. Answer "
              "in one short paragraph, cite the relevant policy number, and "
              "never invent shipment identifiers. Policy 12 covers delayed "
              "freight; policy 19 covers damaged goods; policy 31 covers "
              "customs holds; policy 44 covers refused deliveries at the "
              "dock. ")
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
               **info) -> tuple:
    """Boot ``dlt-serve-torch argv`` in-process through the user's entry
    point, answer ``requests(port)`` over HTTP, and hold the path to its
    kernels: every count 0 just before, read just after, each of the
    path's ``kernels`` ({name: launches per layer per decode step}) at
    least that many times layers x decode steps.  Returns (launches,
    server, {"resident_gb": device memory the booted engine holds,
    "peak_mem_gb": peak over boot and serving})."""
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


def serve_flash(torch, profile: bool) -> int:
    """Path f: write the flash-config Mistral-7B store into a temporary
    directory, serve it at 32768 slots, remove it.  Returns K4's launches
    on the path."""
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
    flash_admission(torch, b, profile)
    del server, b
    _free(torch)
    return launches["flash_attention_dynamic"]


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
    """The five paths, one engine at a time.  Returns each kernel's
    launches on its own path."""
    launches, server, mem_a = serve_path(
        torch, "paged", SERVE_ARGS, {"paged_decode_attention": 1},
        _serve_requests, _llama_3_8b)
    check(server.batcher.prefix_cache.hits > 0, "paged: no prefix-cache hit")
    out = {"paged_decode_attention": launches["paged_decode_attention"]}
    if profile:
        phase_profile(torch, "paged", server.batcher)
    del server
    _free(torch)

    launches, server, _ = serve_path(
        torch, "paged_int8", SERVE_INT8_ARGS,
        {"paged_decode_attention_int8": 1}, _serve_requests, _llama_3_8b)
    check(server.batcher.kv_bits == 8, "paged_int8: the pool is not int8")
    check(server.batcher.prefix_cache.hits > 0,
          "paged_int8: no prefix-cache hit")
    out["paged_decode_attention_int8"] = launches["paged_decode_attention_int8"]
    del server
    _free(torch)

    launches, server, _ = serve_path(
        torch, "windowed", SERVE_WINDOW_ARGS, {"ragged_decode_attention": 1},
        _serve_window_requests, _mistral_7b)
    check(not server.batcher.paged, "windowed: not contiguous mode")
    out["ragged_decode_attention"] = launches["ragged_decode_attention"]
    del server
    _free(torch)

    launches, server, mem = serve_store(
        torch, "store_int8", "int8", 8, path_a_mem_gb=mem_a)
    _check_resident("store_int8", mem, mem_a)
    check(mem["peak_mem_gb"] < mem_a["peak_mem_gb"],
          f"store_int8 peaked at {mem['peak_mem_gb']:.2f} GB, not below the "
          f"bf16 path's {mem_a['peak_mem_gb']:.2f} GB")
    out["quant_matmul"] = launches["quant_matmul"]
    if profile:
        phase_profile(torch, "store_int8", server.batcher)
    del server
    _free(torch)

    launches, server, mem = serve_store(
        torch, "store_int4", "int4", 4, path_a_mem_gb=mem_a)
    _check_resident("store_int4", mem, mem_a)
    out["quant_matmul_int4"] = launches["quant_matmul_int4"]
    del server
    _free(torch)

    out["flash_attention_dynamic"] = serve_flash(torch, profile)
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

def phase_profile(torch, label, batcher) -> None:
    """A fresh batcher over the served weights runs 8 requests (300-token
    prompts, 64 new tokens) once to warm up and once under the profiler:
    host wall time against device kernel time, split into K5, the decode-
    attention kernels, the other matrix products and everything else.
    Information for PERF.md, not a gate."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        b = batcher.respawn()
        g = torch.Generator().manual_seed(5)
        for _ in range(b.b):
            b.submit(torch.randint(0, 256, (300,), generator=g).tolist(),
                     max_new_tokens=64)
        t0 = time.perf_counter()
        b.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, b.decode_steps

    wall, steps = run()  # warm-up, and the unprofiled wall time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = run()
    split = _kernel_split(torch, prof)
    busy_ms = sum(split.values())
    emit("profile", path=label, requests=batcher.b, prompt_tokens=300,
         new_tokens=64, decode_steps=steps, wall_ms=wall * 1e3,
         wall_ms_per_decode_step=wall * 1e3 / max(steps, 1),
         profiled_wall_ms=prof_wall * 1e3, device_kernel_ms=split,
         device_busy_share=(busy_ms / (prof_wall * 1e3)) if busy_ms else
         "not measured",
         decode_attention_kernels=_kernel_names(
             torch, prof, "decode_attention_kernel"),
         quant_matmul_kernels=_kernel_names(torch, prof,
                                            "quant_matmul_kernel"))


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

PHASES = ("build", "kernel", "timing", "model", "serve", "train", "profile")


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
    try:
        if "build" in phases:
            phase_build()
        if "kernel" in phases:
            for name, got in phase_kernel(torch).items():
                kernels[name].update(got)
        if "timing" in phases:
            for name, got in phase_timing(torch).items():
                kernels[name].update(got)
        if "model" in phases:
            phase_model(torch)
        if "serve" in phases:
            for name, n in phase_serve(torch, "profile" in phases).items():
                kernels[name]["launches"] = n
        if "train" in phases:
            kernels["flash_attention_static"]["launches"] = phase_train(
                torch, "profile" in phases)
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
