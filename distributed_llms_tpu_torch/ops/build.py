"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries land in ``build/torch_kernels/`` at the
repository root under a name keyed by the flags and the content of the
source and of every header under ``csrc/``, so an edited kernel or shared
header never loads a stale binary.  Nothing builds at import:
a kernel wrapper calls :func:`entry` on its first CUDA launch, and
``chip_smoke.py`` calls :func:`build` up front to time the builds (one
``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # guarded-by: _lock


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under $CUDA_HOME (default
    /usr/local/cuda).  Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME; the port's CUDA "
        "kernels build from source at first use"
    )


def library_path(source: str, csrc: Path = CSRC) -> Path:
    """Where ``source``'s library lives: keyed by the flags, the source's
    content and the content of every header under ``csrc`` (a header the
    kernels share may change while the source does not)."""
    src = csrc / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(sources: list[str]) -> dict[str, dict]:
    """Compile every source not yet built, all ``nvcc`` processes started
    together.  Returns {source: {"seconds": wall seconds (0 when already
    built), "log": the compiler's register/spill report}}.  Raises
    RuntimeError naming the source and compiler output on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    out: dict[str, dict] = {}
    try:
        for source in sources:
            lib = library_path(source)
            log_path = lib.with_suffix(".log")
            if lib.is_file():
                out[source] = {"seconds": 0.0, "log": _read(log_path)}
                continue
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            procs[source] = (proc, tmp, log_path, time.perf_counter())
        for source, (proc, tmp, log_path, t0) in procs.items():
            text, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source} (exit {proc.returncode}):\n{text}"
                )
            log_path.write_text(text)
            os.replace(tmp, library_path(source))
            out[source] = {"seconds": secs, "log": text}
    finally:
        for proc, tmp, _log, _t0 in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return out


def _read(path: Path) -> str:
    return path.read_text() if path.is_file() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = library_path(source)
            if not path.is_file():
                build([source])
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib


def entry(source: str, name: str, argtypes: list):
    """The C entry point ``name`` of ``source``'s library, built at first
    use, with its argument types declared.  Every entry point returns the
    ``cudaError_t`` of its launch as an int."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
