#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``distributed_llms_tpu_torch``)
on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one result line:

1. ``build``  — compile every kernel source under
   ``distributed_llms_tpu_torch/ops/csrc`` (one nvcc per source, started
   together) and print the build seconds and the register report.
2. ``kernel`` — hold each kernel against its plain PyTorch version on the
   card, at the main path's shapes (Llama-3-8B: B=8, H=32, KVH=8, D=128,
   page size 64, ragged lengths 1..2048, a shuffled page table), plus a
   table holding garbage past every row's depth.
3. ``timing`` — CUDA-event times of each kernel, its plain version and one
   PyTorch library call computing the same function, beside the least
   time the card could take (the byte and operation bounds).
4. ``model``  — a small bf16 llama decoding through the kernel on the card
   against the same weights through the plain version on the CPU.
5. ``serve``  — the port's main path as a user runs it: ``dlt-serve-torch
   --preset llama-3-8b --paged-pages 256 --page-size 64 --prefix-cache``
   (full width, random seeded weights) in-process, answering concurrent
   HTTP completions and chat completions, greedy and sampled, one
   streamed over SSE, three sharing a long prompt prefix.  Every kernel's
   launch count is reset just before and read just after; the run fails
   unless each kernel of the path launched.
6. ``profile`` — the same weights serve a batch of 8 requests once more
   under ``torch.profiler``: host wall time against device kernel time,
   split into the paged decode kernel, matrix products and the rest
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
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the
# bounds below are the least time for the work at these rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

SERVE_ARGS = [
    "--preset", "llama-3-8b", "--paged-pages", "256", "--page-size", "64",
    "--prefix-cache", "--slots", "8", "--host", "127.0.0.1", "--port", "0",
    "--seed", "0",
]


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


# -- phase 2/3: kernel checks and timing -----------------------------------

def paged_case(torch, *, b=8, h=32, kvh=8, d=128, blk=64, max_len=2048,
               seed=0, garbage=False):
    """Main-path inputs: bf16 q and pools, ragged lengths in [1, max_len]
    (both ends included), each row's pages a shuffled run of the pool."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    p = max_len // blk
    nb = b * p + 1  # + scratch page 0
    lengths = torch.randint(1, max_len + 1, (b,), generator=g)
    lengths[0], lengths[-1] = 1, max_len
    perm = torch.randperm(nb - 1, generator=g) + 1
    tables = perm[: b * p].reshape(b, p).to(torch.int32)
    if garbage:
        depth = (lengths + blk - 1) // blk
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


PAGED_TOL = 2e-2  # bf16 probabilities round at different points in the
#   kernel (per tile, unnormalized) and the plain version (normalized)


def phase_kernel(torch) -> dict:
    from distributed_llms_tpu_torch.ops import decode_attn

    worst = 0.0
    for garbage in (False, True):
        args = paged_case(torch, garbage=garbage, seed=1 + garbage)
        got = decode_attn.paged_decode_attention(*args)
        torch.cuda.synchronize()
        want = decode_attn.paged_reference(*args)
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"kernel output {tuple(got.shape)}/{got.dtype} vs plain "
              f"{tuple(want.shape)}/{want.dtype}")
        check(bool(torch.isfinite(got.float()).all()), "kernel output not finite")
        err = (got.float() - want.float()).abs().max().item()
        emit("kernel", name="paged_decode_attention",
             garbage_tables=garbage, max_abs_err=err, tol=PAGED_TOL)
        check(err <= PAGED_TOL,
              f"paged_decode_attention max|err| {err} > {PAGED_TOL}")
        worst = max(worst, err)
    return {"max_abs_err": worst}


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


def phase_timing(torch) -> dict:
    import torch.nn.functional as F

    from distributed_llms_tpu_torch.ops import decode_attn

    q, k, v, lengths, tables = paged_case(torch, seed=3)
    b, _, h, d = q.shape
    _, blk, kvh, _ = k.shape
    lens = lengths.long().cpu()
    depth = (lens + blk - 1) // blk
    # Least work the function needs on these inputs: each live slot's K
    # and V once, q and out once, the lengths and the table entries in
    # reach; 2 operations per multiply-add for QK and for PV.
    kv_bytes = int(lens.sum()) * kvh * d * 2 * 2
    io_bytes = 2 * q.numel() * 2 + b * 4 + int(depth.sum()) * 4
    flops = 4 * int(lens.sum()) * h * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    # Library yardstick: SDPA over each row's pages gathered and padded.
    p = tables.shape[1]
    safe = torch.where(
        torch.arange(p, device=q.device)[None, :] < depth.to(q.device)[:, None],
        tables.long(), 0,
    )
    kr = k[safe].reshape(b, p * blk, kvh, d).transpose(1, 2).contiguous()
    vr = v[safe].reshape(b, p * blk, kvh, d).transpose(1, 2).contiguous()
    mask = (torch.arange(p * blk, device=q.device)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()  # [B, H, 1, D]

    def library():
        return F.scaled_dot_product_attention(qt, kr, vr, attn_mask=mask,
                                              enable_gqa=True)

    lib_out = library().transpose(1, 2)
    ref = decode_attn.paged_reference(q, k, v, lengths, tables)
    lib_err = (lib_out.float() - ref.float()).abs().max().item()
    check(lib_err <= PAGED_TOL, f"library yardstick disagrees ({lib_err})")

    # Turns (plain, kernel, kernel, plain) in one call: compare within it.
    plain_a = cuda_ms(torch, lambda: decode_attn.paged_reference(
        q, k, v, lengths, tables), iters=20)
    kern_a = cuda_ms(torch, lambda: decode_attn.paged_decode_attention(
        q, k, v, lengths, tables))
    kern_b = cuda_ms(torch, lambda: decode_attn.paged_decode_attention(
        q, k, v, lengths, tables))
    plain_b = cuda_ms(torch, lambda: decode_attn.paged_reference(
        q, k, v, lengths, tables), iters=20)
    library_ms = cuda_ms(torch, library)
    out = {
        "ms": min(kern_a, kern_b), "plain_ms": min(plain_a, plain_b),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }
    emit("timing", name="paged_decode_attention", shapes={
        "B": b, "H": h, "KVH": kvh, "D": d, "BLK": blk,
        "sum_lengths": int(lens.sum()),
    }, kernel_ms=[kern_a, kern_b], plain_ms=[plain_a, plain_b],
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        kv_bytes=kv_bytes, achieved_tb_s=kv_bytes / (out["ms"] * 1e-3) / 1e12)
    return out


# -- phase 4: a small model through the kernel vs the plain version --------

def phase_model(torch) -> None:
    """Same bf16 weights and tokens: paged decode on the card (kernel)
    against the CPU (plain version); logits must agree to bf16 noise."""
    from distributed_llms_tpu_torch.core.config import ModelConfig
    from distributed_llms_tpu_torch.models import model as model_lib
    from distributed_llms_tpu_torch.runtime import batcher as batcher_lib

    cfg = ModelConfig(family="llama", vocab_size=512, hidden_size=512,
                      intermediate_size=1024, num_layers=2, num_heads=8,
                      num_kv_heads=2, head_dim=128, max_seq_len=256,
                      tie_embeddings=False, dtype="bfloat16")
    g = torch.Generator(device="cpu").manual_seed(7)
    params_cpu = model_lib.init_params(cfg, generator=g, device="cpu")
    logits = {}
    for dev in ("cpu", "cuda"):
        params = _tree_to(params_cpu, torch.device(dev))
        pool = batcher_lib._paged_pool(cfg, 9, 16, device=dev)
        b = 2
        tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                              device=dev)
        gen = torch.Generator(device="cpu").manual_seed(11)
        lens = torch.tensor([37, 50], dtype=torch.int32)
        toks = torch.randint(0, 512, (b, 60), generator=gen)
        # Prefill each row's prompt, splice it into the pool, then decode.
        for r in range(b):
            n = int(lens[r])
            _, row = batcher_lib._prefill_row(
                params, cfg, pool.k.dtype, 64, toks[r, :n].to(dev))
            l, _, _, kvh, hd = row.k.shape
            pool.k[:, tables[r].long()] = row.k[:, 0].reshape(l, 4, 16, kvh, hd)
            pool.v[:, tables[r].long()] = row.v[:, 0].reshape(l, 4, 16, kvh, hd)
        last = toks[torch.arange(b), lens.long()].to(dev)
        out, _ = model_lib.forward(
            params, cfg, last[:, None], positions=lens.to(dev)[:, None],
            cache=pool, cache_index=lens.to(dev), kv_tables=tables,
        )
        logits[dev] = out.float().cpu()
    check(bool(torch.isfinite(logits["cuda"]).all()), "model logits not finite")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    agree = (logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).float().mean().item()
    emit("model", max_abs_logit_err=err, logit_scale=scale, argmax_agree=agree)
    # Tolerance: 5% of the logit scale — bf16 activations round differently
    # through cuBLAS and the CPU's matmuls, on top of the kernel's own
    # bf16-probability rounding.
    check(err <= 0.05 * max(scale, 1.0), f"model logits disagree ({err})")


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


def phase_serve(torch) -> dict:
    from distributed_llms_tpu_torch.cli import serve_main
    from distributed_llms_tpu_torch.core.observability import METRICS
    from distributed_llms_tpu_torch.ops import decode_attn

    args = serve_main.parser().parse_args(SERVE_ARGS)
    t0 = time.perf_counter()
    server = serve_main.build_server(args)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    cfg = server.batcher.cfg
    check(cfg.hidden_size == 4096 and cfg.num_layers == 32
          and cfg.vocab_size == 128256, "not the full-width llama-3-8b")

    async def run():
        await server.start()
        try:
            return await _serve_requests(server.bound_port)
        finally:
            await server.stop()

    # Every kernel count to 0 just before the main path, read just after.
    decode_attn.paged_decode_attention.launches = 0
    result = asyncio.run(run())
    launches = {"paged_decode_attention":
                decode_attn.paged_decode_attention.launches}
    b = server.batcher
    steps = b.decode_steps
    hits = b.prefix_cache.hits
    b.assert_pool_consistent()
    ttft = METRICS.snapshot()["histograms"].get("server.ttft_seconds", {})
    emit("serve", boot_s=boot_s, decode_steps=steps, launches=launches,
         prefix_cache_hits=hits, prefix_hit_tokens=b.prefix_cache.hit_tokens,
         ttft_s={k: ttft.get(k) for k in ("p50", "max", "count")},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **result)
    check(steps > 0, "no decode step ran")
    check(launches["paged_decode_attention"] >= cfg.num_layers * steps,
          f"paged kernel launched {launches['paged_decode_attention']} times "
          f"for {steps} decode steps x {cfg.num_layers} layers")
    check(hits > 0, "no prefix-cache hit")
    return launches, b


# -- phase 6: where a full-width batch's time goes ---------------------------

def phase_profile(torch, batcher) -> None:
    """A fresh batcher over the served weights runs 8 requests (300-token
    prompts, 64 new tokens) once to warm up and once under the profiler:
    host wall time against device kernel time, split into the paged
    decode kernel, the matrix products and everything else.  Information
    for PERF.md, not a gate."""
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
    split = {"paged_decode_kernel": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.device_time_total
        name = e.name
        if "paged_decode_kernel" in name:
            split["paged_decode_kernel"] += us
        elif any(k in name for k in ("gemm", "nvjet", "cutlass", "splitK",
                                     "sm90_xmma")):
            split["matmul"] += us
        else:
            split["other"] += us
    busy_ms = sum(split.values()) / 1e3
    emit("profile", requests=batcher.b, prompt_tokens=300, new_tokens=64,
         decode_steps=steps, wall_ms=wall * 1e3,
         wall_ms_per_decode_step=wall * 1e3 / max(steps, 1),
         profiled_wall_ms=prof_wall * 1e3,
         device_kernel_ms={k: v / 1e3 for k, v in split.items()},
         device_busy_share=(busy_ms / (prof_wall * 1e3)) if busy_ms else
         "not measured")


# -- main -------------------------------------------------------------------

PHASES = ("build", "kernel", "timing", "model", "serve", "profile")


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
    kernel = {"name": "paged_decode_attention", "route": "cuda",
              "source": "distributed_llms_tpu_torch/ops/csrc/paged_decode_attn.cu",
              "replaces": "distributed_llms_tpu/ops/decode_attn.py:470",
              "launches": None, "max_abs_err": None, "ms": None,
              "plain_ms": None, "bound_ms": None, "bound_by": None,
              "library_ms": None}
    try:
        if "build" in phases:
            phase_build()
        if "kernel" in phases:
            kernel.update(phase_kernel(torch))
        if "timing" in phases:
            kernel.update(phase_timing(torch))
        if "model" in phases:
            phase_model(torch)
        if "serve" in phases:
            launches, batcher = phase_serve(torch)
            kernel["launches"] = launches["paged_decode_attention"]
            if "profile" in phases:
                phase_profile(torch, batcher)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
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
