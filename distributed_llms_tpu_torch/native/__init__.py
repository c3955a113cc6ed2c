"""The native segment reader of the shard store (PyTorch port of
``distributed_llms_tpu/native/__init__.py``, with its own copy of
``csrc/dlt_io.cpp``).

``read_segments`` fans ``pread`` of byte segments over a C++ thread pool
and computes each segment's CRC32 in the same pass; ``crc32`` is the same
polynomial as ``zlib.crc32``.  The library builds at first use with
``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into ``build/native/`` at
the repository root, under a name keyed by the flags and the source, with
a per-process temporary name and an atomic rename, so ranks that start
together never load a half-written file.  A failed build RAISES: there
is no quiet fallback.  ``checkpoint/store.py``'s ``_read_checked`` stays
the plain reader the tests hold this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "dlt_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None  # guarded-by: _lock


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"dlt_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises RuntimeError with
    the compiler's output when the build fails."""
    so = library_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native reader build failed: {e}") from e
    try:
        if r.returncode != 0:
            raise RuntimeError(
                f"native reader build failed ({' '.join(cmd)}):\n"
                f"{r.stderr[-2000:]}")
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()
    return so


def get_lib() -> ctypes.CDLL:
    """The compiled library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dlt_crc32.restype = ctypes.c_uint32
            lib.dlt_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_uint32]
            lib.dlt_read_segments.restype = ctypes.c_int64
            lib.dlt_read_segments.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_int64,
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


def read_segments(
    tasks: Sequence[tuple[str, int, int]],  # (path, offset, nbytes)
    threads: int = 8,
    out: Sequence | None = None,
) -> tuple[list, list[int]]:
    """Read byte segments in parallel, each segment's CRC32 computed in
    the same pass.  ``out``: one destination a segment (a uint8 numpy
    array or torch tensor of ``nbytes``, e.g. pinned host memory), else
    fresh numpy buffers.  Returns (the buffers, their CRC32s).  A segment
    that cannot be read in full raises ``IOError``."""
    lib = get_lib()
    n = len(tasks)
    bufs = list(out) if out is not None else [
        np.empty(nb, dtype=np.uint8) for _, _, nb in tasks]
    if len(bufs) != n:
        raise ValueError(f"{len(bufs)} buffers for {n} segments")
    ptrs = []
    for b, (_, _, nb) in zip(bufs, tasks):
        size = b.nbytes if isinstance(b, np.ndarray) else \
            b.numel() * b.element_size()
        if size != nb:
            raise ValueError(f"a {size}-byte buffer for a {nb}-byte segment")
        ptrs.append(b.ctypes.data if isinstance(b, np.ndarray)
                    else b.data_ptr())
    if n == 0:
        return bufs, []
    paths = (ctypes.c_char_p * n)(*(os.fsencode(p) for p, _, _ in tasks))
    offs = (ctypes.c_uint64 * n)(*(o for _, o, _ in tasks))
    sizes = (ctypes.c_uint64 * n)(*(nb for _, _, nb in tasks))
    cptrs = (ctypes.c_void_p * n)(*ptrs)
    crcs = (ctypes.c_uint32 * n)()
    rc = lib.dlt_read_segments(paths, offs, sizes, cptrs, crcs, n,
                               max(1, threads))
    if rc != 0:
        i = int(rc) - 1
        raise IOError(f"native read failed (short read or unreadable file) "
                      f"for {tasks[i][0]} @ {tasks[i][1]} ({tasks[i][2]} "
                      "bytes)")
    return bufs, list(crcs)


def crc32(data: "bytes | np.ndarray") -> int:
    """CRC32 (zlib's polynomial) of bytes or an array's bytes, in place."""
    lib = get_lib()
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        return int(lib.dlt_crc32(arr.ctypes.data, arr.nbytes, 0))
    buf = ctypes.create_string_buffer(bytes(data), len(data))
    return int(lib.dlt_crc32(ctypes.addressof(buf), len(data), 0))
