#!/usr/bin/env python3
"""Do the kernel checks fail a wrong kernel?  A mutation run of the split-K
decode kernels — paged (K1, K1q) and contiguous (K2, K2q) —, of the
split-K weight-only dequant-matmul (K5, int8 and int4 codes) and of the
flash-attention kernels (K3 static causal, K4 dynamic) on one NVIDIA GPU.

    python3 decode_mutations.py           # on the card; a few minutes

Each variant is a copy of ``distributed_llms_tpu_torch/`` and
``chip_smoke.py`` in a temporary directory outside the checkout, with one
fault planted in its kernel source (the sound variant has none).  Every
copy is built with its own ``nvcc`` per source it needs (all started
together), then runs, in a process of its own and with the checks
recorded instead of raised, the checks of the kernels its source holds:
``chip_smoke.paged_kernel_checks`` — K1 and K1q against their plain
versions at the smoke's timing shape (with and without garbage past each
row's depth), one 8192-slot row at batch 1, 16-slot pages over 2048
slots, and every edge of the plan —, ``chip_smoke.ragged_kernel_checks``
— K2 and K2q at path c's shapes and at batch 1 over 32768 slots, window
4096 and none — and ``chip_smoke.qmm_kernel_checks`` — K5 at Llama-3-8B's
six projection shapes and at the edges of its plan (M of 1, 16, 17, 64
and 65, a K off the tiles in uneven splits) — and
``chip_smoke.flash_kernel_checks`` — K3 at path g's sequence, windowed,
off the query tiles and at head dims 64 and 256, and K4 at path f's
admission and beside it (offset queries, one offset whose query tiles end
on a key tile's first slot, per-row lengths, shuffled positions, a short
admission, rows with no live key held to exact zeros), each per output
row.  The sound variant runs them all.  A variant that faults on the card (a trap on a page id it should
not have read) records the error and counts as caught for every kernel.
Prints one JSON line per variant (each check's largest per-row relative
error, or K5's largest |err| over its limit, and which checks failed),
then a summary line.  Exits 0 when the sound variant passes every check
and every planted fault fails at least one check of each kernel it
breaks; 1 otherwise.  The temporary directories are removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = "distributed_llms_tpu_torch/ops/csrc/"
K1, K1Q = "paged_decode_attention", "paged_decode_attention_int8"
K2, K2Q = "ragged_decode_attention", "ragged_decode_attention_int8"
K5, K5Q4 = "quant_matmul", "quant_matmul_int4"
K3, K4 = "flash_attention_static", "flash_attention_dynamic"
KERNELS = (K1, K1Q, K2, K2Q)

# name -> (file, text, replacement, the kernels it breaks).  Each text
# occurs exactly once in its file.
MUTATIONS = {
    "band_lower_edge_off_by_one": (
        "ragged_decode_attn.cu", "max(0, raw - window)",
        "max(0, raw - window + 1)", (K2, K2Q)),
    "length_edge_off_by_one": (
        "ragged_decode_attn.cu", "const int len = min(raw, S);",
        "const int len = min(raw + 1, S);", (K2, K2Q)),
    "dropped_split": (  # the last split's block attends nothing
        "ragged_decode_attn.cu", "first < len ?",
        "first < len && split + 1 < n_splits ?", (K2, K2Q)),
    "merge_without_rescale": (
        "split_decode.cuh",
        "expf(pm[(part + s) * G + g] - mm)", "1.f", KERNELS),
    "l_summed_after_v_scale": (
        "split_decode.cuh",
        "sum += p;\n        if (kQuant) p *= vs_s[r0 + t];",
        "if (kQuant) p *= vs_s[r0 + t];\n        sum += p;", (K1Q, K2Q)),
    "slot_group_merge_without_rescale": (
        "split_decode.cuh",
        "const float w = expf(red_m[z * G + ty] - safe);",
        "const float w = 1.f;", KERNELS),
    # The paged kernel's own faults.
    "page_run_off_by_one": (  # a split starts one table entry late
        "paged_decode_attn.cu", "const int page0 = (int)(first / BLK);",
        "const int page0 = (int)(first / BLK) + 1;", (K1, K1Q)),
    "paged_length_edge_off_by_one": (
        "paged_decode_attn.cu", "min(lengths[b], P * BLK)",
        "min(lengths[b] + 1, P * BLK)", (K1, K1Q)),
    "paged_dropped_split": (  # the last split's block attends nothing
        "paged_decode_attn.cu", "first < len ?",
        "first < len && split + 1 < n_splits ?", (K1, K1Q)),
    "page_run_edge": (  # every tile row reads its split's first page
        "split_decode.cuh", "(size_t)pages[i] * page_stride +",
        "(size_t)pages[0] * page_stride +", (K1, K1Q)),
    "paged_scale_contiguous_stride": (  # scales as if the run were contiguous
        "split_decode.cuh",
        "return (size_t)pages[i] * scale_page_stride +\n"
        "           (size_t)(t - i * blk) * scale_slot_stride;",
        "return (size_t)pages[0] * scale_page_stride +\n"
        "           (size_t)t * scale_slot_stride;", (K1Q,)),
    # K5's faults.
    "qmm_last_split_dropped": (  # the last split's block sums nothing
        "quant_matmul.cu",
        "const int kt1 = min(kt0 + a.tiles_per_split, k_tiles);",
        "const int kt1 = split + 1 < a.n_splits ? "
        "min(kt0 + a.tiles_per_split, k_tiles) : kt0;", (K5, K5Q4)),
    "qmm_reduce_split_twice": (  # the cluster sum counts split 0 twice
        "quant_matmul.cu", "for (int r = 1; r < a.n_splits; ++r) {",
        "for (int r = 0; r < a.n_splits; ++r) {", (K5, K5Q4)),
    "qmm_scale_block_off_by_one": (  # scales of column n / block + 1
        "quant_matmul.cu", "const int k = k0 + r, b = b0 + c;",
        "const int k = k0 + r, b = b0 + c + 1;", (K5, K5Q4)),
    "qmm_int4_nibbles_swapped": (
        "quant_matmul.cu",
        "w[i][2 * p] = i4_float(word, 8 * i);\n"
        "            w[i][2 * p + 1] = i4_float(word, 8 * i + 4);",
        "w[i][2 * p] = i4_float(word, 8 * i + 4);\n"
        "            w[i][2 * p + 1] = i4_float(word, 8 * i);", (K5Q4,)),
    "qmm_k_tail_unloaded": (  # a K off the tiles loses its last part tile
        "quant_matmul.cu", "const int k_tiles = (a.K + kBK - 1) / kBK;",
        "const int k_tiles = a.K / kBK;", (K5, K5Q4)),
    "qmm_m_tail_row_zero": (  # rows past the last full 8 load as zeros
        "quant_matmul.cu", "const bool valid = k_in && m0 + r < a.M;",
        "const bool valid = k_in && m0 + r < a.M / 8 * 8;", (K5, K5Q4)),
    # The flash kernels' faults.
    "k3_diagonal_off_by_one": (  # a row loses its own key
        "flash_attn.cu", "keep = kc <= rw.qp[i] &&",
        "keep = kc < rw.qp[i] &&", (K3,)),
    "k3_window_edge_off_by_one": (  # one key too many below the window
        "flash_attn.cu", "(long long)kc > (long long)rw.qp[i] - a.window",
        "(long long)kc >= (long long)rw.qp[i] - a.window", (K3,)),
    "k3_last_tile_dropped": (  # the diagonal tile is never walked
        "flash_attn.cu", "const int t_hi = q_last / T::kBK + 1;",
        "const int t_hi = q_last / T::kBK;", (K3,)),
    "k4_dead_rule_off_by_one": (  # a tile starting at qmax is skipped
        "flash_attn.cu", "(causal && kmin > qmax)",
        "(causal && kmin >= qmax)", (K4,)),
    "flash_rescale_omitted": (  # the accumulator keeps its old scale
        "flash_attn.cu",
        "      acc[n8 * 4 + 0] *= alpha[0];\n"
        "      acc[n8 * 4 + 1] *= alpha[0];\n"
        "      acc[n8 * 4 + 2] *= alpha[1];\n"
        "      acc[n8 * 4 + 3] *= alpha[1];\n", "", (K3, K4)),
    "flash_unseeded_shift_removed": (  # rows without keys average them
        "flash_attn.cu",
        "shift[i] = m_new <= kNegInf * 0.5f ? 0.f : m_new;",
        "shift[i] = m_new;", (K4,)),
}
# The sources each kernel's checks build, and the checks that hold it.
SOURCES = {"paged_decode_attn.cu": "paged_kernel_checks",
           "ragged_decode_attn.cu": "ragged_kernel_checks",
           "quant_matmul.cu": "qmm_kernel_checks",
           "flash_attn.cu": "flash_kernel_checks"}
OF_SOURCE = {K1: "paged_decode_attn.cu", K1Q: "paged_decode_attn.cu",
             K2: "ragged_decode_attn.cu", K2Q: "ragged_decode_attn.cu",
             K5: "quant_matmul.cu", K5Q4: "quant_matmul.cu",
             K3: "flash_attn.cu", K4: "flash_attn.cu"}

# Runs in each variant's copy: the named checks, recorded instead of
# raised.
RUNNER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs

lines, failed = [], []
cs.emit = lambda phase, **f: lines.append(f)
cs.check = lambda cond, what: None if cond else failed.append(what)
try:
    for checks in sys.argv[2:]:
        getattr(cs, checks)(torch)
    error = None
except Exception as e:  # a launch or shape fault is a failure too
    error = repr(e)
print(json.dumps({"lines": lines, "failed": failed, "error": error}))
"""


def sources_of(name: str) -> list:
    """The kernel sources a variant builds and checks: all for the sound
    variant, else those of the kernels its fault breaks."""
    if name not in MUTATIONS:
        return list(SOURCES)
    return sorted({OF_SOURCE[k] for k in MUTATIONS[name][3]})


def reading(line: dict):
    """(where, value) of one check line: K5's largest |err| over its
    limit at a shape, or an attention kernel's largest per-row relative
    error (a flash line by its case; K3's backward by its gradient)."""
    if "err_over_limit" in line:
        return f"shape={line['shape']}", line["err_over_limit"]
    if "case" in line:
        return (f"case={line['case']}",
                line.get("max_row_rel_err", line.get("max_abs_err")))
    if "grad_of" in line:
        return f"grad_of={line['grad_of']}", line["rel_err"]
    where = (f"shape={line['shape']}" if "shape" in line else
             f"B={line.get('B')} window={line.get('window')}")
    return where, line.get("max_row_rel_err")


def make_variant(root: Path, name: str) -> Path:
    dst = root / name
    shutil.copytree(REPO / "distributed_llms_tpu_torch",
                    dst / "distributed_llms_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", dst / "chip_smoke.py")
    if name in MUTATIONS:
        fname, old, new, _ = MUTATIONS[name]
        path = dst / CSRC / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {fname}, not once")
        path.write_text(text.replace(old, new))
    return dst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_mutations.py needs a CUDA device", file=sys.stderr)
        return 2
    names = ["sound", *MUTATIONS]
    root = Path(tempfile.mkdtemp(prefix="decode_mutations_"))
    try:
        dirs = {name: make_variant(root, name) for name in names}
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from distributed_llms_tpu_torch.ops import build; "
                 "build.build(sys.argv[2:])")
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", build, str(d), *sources_of(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, d in dirs.items()}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                print(out[-4000:], file=sys.stderr)
                raise SystemExit(f"{name}: build failed")
        verdict = {}
        for name in names:
            checks = [SOURCES[src] for src in sources_of(name)]
            run = subprocess.run([sys.executable, "-c", RUNNER,
                                  str(dirs[name]), *checks],
                                 capture_output=True, text=True, timeout=900)
            result = json.loads(run.stdout.strip().splitlines()[-1])
            worst = {}
            for line in result["lines"]:
                where, value = reading(line)
                worst[f"{line['name']} {where}"] = value
            caught = {k: any(f.startswith(k + " ") for f in result["failed"])
                      or result["error"] is not None for k in OF_SOURCE
                      if OF_SOURCE[k] in sources_of(name)}
            print(json.dumps({"variant": name, "worst_reading": worst,
                              "failed_checks": result["failed"],
                              "error": result["error"], "caught": caught}),
                  flush=True)
            if name == "sound":
                verdict[name] = not result["failed"] and not result["error"]
            else:
                verdict[name] = all(caught[k] for k in MUTATIONS[name][3])
        print(json.dumps({"mutation_run": verdict,
                          "ok": all(verdict.values())}))
        return 0 if all(verdict.values()) else 1
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
