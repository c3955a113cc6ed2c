#!/usr/bin/env python3
"""Do the decode-kernel checks fail a wrong kernel?  A mutation run of the
split-K decode kernels — paged (K1, K1q) and contiguous (K2, K2q) — on one
NVIDIA GPU.

    python3 decode_mutations.py           # on the card; a few minutes

Each variant is a copy of ``distributed_llms_tpu_torch/`` and
``chip_smoke.py`` in a temporary directory outside the checkout, with one
fault planted in its kernel source (the sound variant has none).  Every
copy is built with its own ``nvcc`` per source (all started together),
then each runs ``chip_smoke.paged_kernel_checks`` — K1 and K1q against
their plain versions at the smoke's timing shape (with and without
garbage past each row's depth), one 8192-slot row at batch 1, 16-slot
pages over 2048 slots, and every edge of the plan — and
``chip_smoke.ragged_kernel_checks`` — K2 and K2q at path c's shapes and
at batch 1 over 32768 slots, window 4096 and none — in a process of its
own, with the checks recorded instead of raised.  A variant that faults
on the card (a trap on a page id it should not have read) records the
error and counts as caught for every kernel.  Prints one JSON line per
variant (each check's largest per-row relative error, and which checks
failed), then a summary line.  Exits 0 when the sound variant passes
every check and every planted fault fails at least one check of each
kernel it breaks; 1 otherwise.  The temporary directories are removed at
the end.
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
}
SOURCES = ["paged_decode_attn.cu", "ragged_decode_attn.cu"]

# Runs in each variant's copy: the checks, recorded instead of raised.
RUNNER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs

lines, failed = [], []
cs.emit = lambda phase, **f: lines.append(f)
cs.check = lambda cond, what: None if cond else failed.append(what)
try:
    cs.paged_kernel_checks(torch)
    cs.ragged_kernel_checks(torch)
    error = None
except Exception as e:  # a launch or shape fault is a failure too
    error = repr(e)
print(json.dumps({"lines": lines, "failed": failed, "error": error}))
"""


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
                 f"build.build({SOURCES!r})")
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", build, str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                print(out[-4000:], file=sys.stderr)
                raise SystemExit(f"{name}: build failed")
        verdict = {}
        for name in names:
            run = subprocess.run([sys.executable, "-c", RUNNER,
                                  str(dirs[name])], capture_output=True,
                                 text=True, timeout=900)
            result = json.loads(run.stdout.strip().splitlines()[-1])
            worst = {}
            for line in result["lines"]:
                where = (f"shape={line['shape']}" if "shape" in line else
                         f"B={line.get('B')} window={line.get('window')}")
                worst[f"{line['name']} {where}"] = line.get("max_row_rel_err")
            caught = {k: any(f.startswith(k + " ") for f in result["failed"])
                      or result["error"] is not None for k in KERNELS}
            print(json.dumps({"variant": name, "max_row_rel_err": worst,
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
