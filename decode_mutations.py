#!/usr/bin/env python3
"""Do the decode-kernel checks fail a wrong kernel?  A mutation run of the
contiguous decode kernels (K2, K2q) on one NVIDIA GPU.

    python3 decode_mutations.py           # on the card; a few minutes

Each variant is a copy of ``distributed_llms_tpu_torch/`` and
``chip_smoke.py`` in a temporary directory outside the checkout, with one
fault planted in its kernel source (the sound variant has none).  Every
copy is built with its own ``nvcc`` (all started together), then each runs
``chip_smoke.ragged_kernel_checks`` — K2 and K2q against their plain
versions at path c's shapes and at batch 1 over 32768 slots, window 4096
and none — in a process of its own, with the checks recorded instead of
raised.  Prints one JSON line per variant (each check's largest per-row
relative error, and which checks failed), then a summary line.  Exits 0
when the sound variant passes every check and every planted fault fails
at least one of its kernel's checks; 1 otherwise.  The temporary
directories are removed at the end.
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
K2, K2Q = "ragged_decode_attention", "ragged_decode_attention_int8"

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
        "expf(pm[(part + s) * G + g] - mm)", "1.f", (K2, K2Q)),
    "l_summed_after_v_scale": (
        "split_decode.cuh",
        "sum += p;\n        if (kQuant) p *= vs_s[r0 + t];",
        "if (kQuant) p *= vs_s[r0 + t];\n        sum += p;", (K2Q,)),
    "slot_group_merge_without_rescale": (
        "split_decode.cuh",
        "const float w = expf(red_m[z * G + ty] - safe);",
        "const float w = 1.f;", (K2, K2Q)),
}

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
                 "build.build(['ragged_decode_attn.cu'])")
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
                key = (f"{line['name']} B={line.get('B')} "
                       f"window={line.get('window')}")
                worst[key] = line.get("max_row_rel_err")
            caught = {k: any(f.startswith(k + " ") for f in result["failed"])
                      or result["error"] is not None for k in (K2, K2Q)}
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
