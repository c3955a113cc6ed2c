#!/usr/bin/env python3
"""What the flash kernels' design choices are worth: device time of K3 and
K4 (``ops/csrc/flash_attn.cu``) against variants of the source, on one
NVIDIA GPU.

    python3 flash_variants.py            # on the card; a few minutes

Each variant is a copy of ``distributed_llms_tpu_torch/`` in a temporary
directory outside the checkout with one change of text in the kernel
source (or its wrapper's tile table); "shipped" has none:

- ``mask_test_in_every_tile``: the boundary tiles' mask test inside the
  loop that fully visible tiles take too, behind a condition that never
  holds (the shipped body gives them a loop of their own);
- ``key_tile_64``: 64-slot key tiles at every head dim (shipped: 128 at
  head dims 64 and 128);
- ``stages_3_at_d64``: a 3-stage K/V ring at head dim 64 (the only head
  dim whose three stages fit in shared memory);
- ``no_register_handover``: no ``setmaxnreg``: every thread keeps the 168
  registers of the launch (shipped: the producer warpgroup gives its
  registers to the consumers, 232 each).

Every copy is built with its own ``nvcc`` (all started together); then
each runs, in a process of its own, K3 at B=1, T=4096, H=32, KVH=8 and
head dims 64, 128 and 256 (causal), and K4 at path f's admission (8192
queries over 32768 slots, the first 8192 written, window 4096; head dim
128), and reports the profiler's device time of the kernel (the pre-pass
apart), the faster of two turns run in opposite orders, beside each
variant's ptxas spill bytes.  One JSON line per variant, then the card's
name and power limit.  The temporary directories are removed at the end.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = "distributed_llms_tpu_torch/ops/csrc/"

# name -> [(file under the package, text, replacement)]; each text occurs
# exactly once in its file.
VARIANTS = {
    "shipped": [],
    "mask_test_in_every_tile": [
        ("ops/csrc/flash_attn.cu", "        if (kMasked) {",
         "        if (kMasked || a.window == INT_MIN) {")],
    "key_tile_64": [
        ("ops/csrc/flash_attn.cu", "kBK = D == 256 ? 64 : 128;",
         "kBK = 64;"),
        ("ops/flash.py", "KEY_TILE = {64: 128, 128: 128, 256: 64}",
         "KEY_TILE = {64: 64, 128: 64, 256: 64}")],
    "stages_3_at_d64": [
        ("ops/csrc/flash_attn.cu", "kStages = 2;",
         "kStages = D == 64 ? 3 : 2;")],
    "no_register_handover": [
        ("ops/csrc/flash_attn.cu", "    reg_dealloc<kProducerRegs>();\n", ""),
        ("ops/csrc/flash_attn.cu", "    reg_alloc<kConsumerRegs>();\n", "")],
}

# Runs in each variant's copy: device ms per call of the flash kernel.
RUNNER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from distributed_llms_tpu_torch.ops import flash

def draw(g, *shape):
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

def device_ms(fn, calls=10):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "flash_kernel<" in e.name) / 1e3 / calls

g = torch.Generator(device="cuda").manual_seed(0)
out = {}
for d in (64, 128, 256):
    q, k, v = draw(g, 1, 4096, 32, d), draw(g, 1, 4096, 8, d), draw(g, 1, 4096, 8, d)
    out[f"K3_D{d}"] = device_ms(lambda: flash.flash_attention(q, k, v))
s = 32768
q, k, v = draw(g, 1, 8192, 32, 128), draw(g, 1, s, 8, 128), draw(g, 1, s, 8, 128)
kpos = torch.arange(s, device="cuda")[None]
kw = {"q_positions": kpos[:, :8192], "k_positions": kpos,
      "k_valid": kpos < 8192, "window": 4096}
out["K4_admission"] = device_ms(lambda: flash.flash_attention(q, k, v, **kw))
print(json.dumps(out))
"""


def make_variant(root: Path, name: str) -> Path:
    dst = root / name
    shutil.copytree(REPO / "distributed_llms_tpu_torch",
                    dst / "distributed_llms_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name]:
        path = dst / "distributed_llms_tpu_torch" / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {fname}, not once")
        path.write_text(text.replace(old, new))
    return dst


def spills(log: str) -> dict:
    """Spill-store bytes of each flash_kernel instantiation."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"flash_kernelILi(\d+)ELb(\d)", line)
        if m:
            cur = f"{'K4' if m.group(2) == '1' else 'K3'}_D{m.group(1)}"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out[cur] = int(m.group(1))
            cur = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants.py needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(tempfile.mkdtemp(prefix="flash_variants_"))
    try:
        dirs = {name: make_variant(root, name) for name in VARIANTS}
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from distributed_llms_tpu_torch.ops import build; "
                 "print(build.build(['flash_attn.cu'])['flash_attn.cu']"
                 "['log'])")
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", build, str(d)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for name, d in dirs.items()}
        logs = {}
        for name, proc in procs.items():
            logs[name], _ = proc.communicate()
            if proc.returncode != 0:
                print(logs[name][-4000:], file=sys.stderr)
                raise SystemExit(f"{name}: build failed")
        turns = {name: [] for name in VARIANTS}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                run = subprocess.run(
                    [sys.executable, "-c", RUNNER, str(dirs[name])],
                    capture_output=True, text=True, timeout=600)
                if run.returncode != 0:
                    raise SystemExit(f"{name}: {run.stderr[-2000:]}")
                turns[name].append(json.loads(run.stdout.strip()
                                              .splitlines()[-1]))
        for name, got in turns.items():
            print(json.dumps({
                "variant": name,
                "device_ms": {k: min(t[k] for t in got) for k in got[0]},
                "turns": got, "spill_store_bytes": spills(logs[name])}),
                flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
