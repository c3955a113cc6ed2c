"""Device selection for the port's entry points.

The port serves on an NVIDIA GPU.  Entry points take ``device=None`` and
resolve it here: no argument means CUDA, and a machine without CUDA
RAISES instead of quietly running the model on the CPU.  Callers that
want the CPU (the test suite, a laptop smoke run) ask for it by name.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); an explicit
    device passes through, after the same availability check for CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
