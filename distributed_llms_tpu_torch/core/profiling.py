"""Profiling: ``torch.profiler`` capture, step timing, device memory
(PyTorch port of ``distributed_llms_tpu/core/profiling.py``).

- :func:`trace` captures a Chrome/Perfetto trace of everything run inside
  it (CPU ops, and the device's kernels and copies on CUDA);
- :func:`annotate` labels a host-side region on that trace;
- :class:`StepTimer` measures wall time per step and the derived
  throughput into the global METRICS registry (``<name>.step_seconds``,
  ``<name>.tokens_per_second``);
- :func:`record_memory_stats` snapshots the CUDA devices' memory gauges.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

from .observability import METRICS, get_logger

log = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace into ``log_dir`` (a Chrome trace JSON,
    viewable in Perfetto).  Usage:

        with profiling.trace("traces"):
            engine.generate_text([...])
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def annotate(name: str):
    """Label a host-side region on the profiler timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Times steps and feeds METRICS.

        timer = StepTimer("engine.generate")
        with timer.step(tokens=n):
            run_step()

    Records ``<name>.step_seconds`` (histogram -> p50/p95) and a
    ``<name>.tokens_per_second`` gauge over a sliding window.
    """

    def __init__(self, name: str, window: int = 32,
                 clock=time.perf_counter) -> None:
        self.name = name
        self._window = window
        self._samples: list[tuple[float, int]] = []  # (seconds, tokens)
        self.steps = 0
        # Injectable clock: tests drive a fake monotonic counter instead of
        # sleeping wall-clock time to make dt nonzero.
        self._clock = clock

    @contextlib.contextmanager
    def step(self, tokens: int = 0) -> Iterator[None]:
        t0 = self._clock()
        with annotate(f"{self.name}.step"):
            yield
        dt = self._clock() - t0
        self.steps += 1
        METRICS.observe(f"{self.name}.step_seconds", dt)
        if tokens:
            self._samples.append((dt, tokens))
            if len(self._samples) > self._window:
                self._samples = self._samples[-self._window:]
            total_t = sum(s for s, _ in self._samples)
            total_tok = sum(n for _, n in self._samples)
            METRICS.set_gauge(
                f"{self.name}.tokens_per_second", total_tok / max(total_t, 1e-9)
            )

    @property
    def tokens_per_second(self) -> float:
        return METRICS.snapshot()["gauges"].get(
            f"{self.name}.tokens_per_second", 0.0)


def record_memory_stats(prefix: str = "device") -> dict[str, float]:
    """Snapshot each CUDA device's memory occupancy into gauges.  Returns
    {gauge_name: bytes}; nothing on a machine without CUDA."""
    out: dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        values = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
        for key, value in values.items():
            if value is None:
                continue
            name = f"{prefix}{i}.{key}"
            # graftlint: ignore[GL302](gauge names are per-device — "<prefix><i>.bytes_in_use" — an open-ended family no registry entry can enumerate)
            METRICS.set_gauge(name, float(value))
            out[name] = float(value)
    return out
