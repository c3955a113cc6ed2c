"""Decode-shape policy: the bucketing ladder that bounds compile-cache keys.

Every jit entry point whose input widths follow request sizes must pad to a
shape from a SMALL, CLOSED ladder — otherwise each new prompt length traces
and compiles a fresh program ("recompile every new seq length", the classic
compiled-serving perf bug: a long compile in the middle of serving
traffic).

This module is the single definition of that ladder, shared by:

- ``runtime.batcher.ContinuousBatcher`` — admission prompt/suffix widths;
- ``runtime.engine.InferenceEngine.generate_text`` — the whole-batch
  generate path pads T up the ladder instead of to the batch's raw max;
- ``tools.graftcheck`` (GC4) — the recompilation gate traces the real jit
  entry points across a request-length sweep and fails if the distinct
  compile keys exceed what :func:`bucket_count` declares.

Padding farther right is exact by construction everywhere it is applied:
prompts are right-padded and masked (extra pad slots are never attended,
never sampled from), so a wider bucket changes compiled-program count, not
tokens.
"""

from __future__ import annotations

BUCKET_FLOOR = 8


def bucket_length(n: int, floor: int = BUCKET_FLOOR) -> int:
    """Smallest power-of-two bucket >= n (>= floor).  The ladder a raw
    request length pads up to; callers cap the result at whatever width
    actually fits their cache (``min(bucket_length(n), cap)``)."""
    b = floor
    while b < n:
        b *= 2
    return b


def bucket_ladder(cap: int, floor: int = BUCKET_FLOOR) -> list[int]:
    """Every width ``min(bucket_length(n), cap)`` can produce for
    n in [1, cap] — the CLOSED set of jit-visible prompt widths, and the
    compile-key budget the GC4 gate holds the trace ladder to."""
    out: list[int] = []
    b = floor
    while b < cap:
        out.append(b)
        b *= 2
    out.append(cap)
    return out


def bucket_count(cap: int, floor: int = BUCKET_FLOOR) -> int:
    """Declared compile-key bound for one request-length-following axis."""
    return len(bucket_ladder(cap, floor))


def generate_pad_len(t: int, n_new: int, limit: int,
                     floor: int = BUCKET_FLOOR) -> int:
    """The prompt width the whole-batch generate path pads to: up the
    ladder, but never past what leaves room for ``n_new`` decode slots
    under ``limit`` — and never BELOW the raw ``t`` (an over-budget prompt
    keeps its raw width so the sequence-budget check fails exactly as it
    would have unbucketed).  Single definition shared by
    InferenceEngine._bucket_prompt and the GC4 gate."""
    return min(bucket_length(t, floor), max(limit - n_new, t))
