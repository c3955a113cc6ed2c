"""Structured logging + metrics (PyTorch/CUDA port).

The port's own copy of ``distributed_llms_tpu/core/observability.py``'s
logger factory and in-process metrics registry.  Metric NAMES are the JAX
package's (its ``METRIC_DOCS`` registry is the one list of names), so a
dashboard reads either stack's ``/metrics`` unchanged; the port emits no
name of its own.  Kernel launch counts are plain integers on each kernel
wrapper (``ops/``), not metrics.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            out.update(extra)
        return json.dumps(out)


def get_logger(name: str, json_format: bool = False, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        if json_format:
            handler.setFormatter(JsonFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
            )
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


@dataclass
class _Histogram:
    values: list[float] = field(default_factory=list)
    max_keep: int = 4096
    # Cumulative across the full lifetime (Prometheus summary semantics);
    # the percentile window above slides, these never reset.
    total_count: int = 0
    total_sum: float = 0.0

    def observe(self, v: float) -> None:
        if len(self.values) >= self.max_keep:
            # Keep a sliding window: drop oldest half.
            self.values = self.values[self.max_keep // 2 :]
        self.values.append(v)
        self.total_count += 1
        self.total_sum += v

    def summary(self) -> dict[str, float]:
        if not self.values:
            return {"count": 0}
        vs = sorted(self.values)
        n = len(vs)

        def pct(p: float) -> float:
            return vs[min(n - 1, int(p * n))]

        return {
            "count": n,
            "mean": sum(vs) / n,
            "p50": pct(0.50),
            "p95": pct(0.95),
            "p99": pct(0.99),
            "min": vs[0],
            "max": vs[-1],
        }


class Metrics:
    """Thread-safe in-process metrics registry."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)  # guarded-by: self._lock
        self._gauges: dict[str, float] = {}  # guarded-by: self._lock
        self._hists: dict[str, _Histogram] = defaultdict(_Histogram)  # guarded-by: self._lock

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def set_gauges(self, values: dict[str, float]) -> None:
        """Set a family of gauges under one lock acquisition (the KV pool's
        batcher_pool_* snapshot lands atomically for a scrape)."""
        with self._lock:
            self._gauges.update(values)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists[name].observe(value)

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def get_counter(self, name: str) -> float:
        """Point read of one counter (0.0 when never incremented)."""
        with self._lock:
            return self._counters.get(name, 0.0)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.summary() for k, h in self._hists.items()},
            }

    def prometheus_text(self) -> str:
        """Render the registry in Prometheus exposition format (text/plain
        version 0.0.4).  Histograms export as summaries: quantile series plus
        cumulative _count/_sum."""

        def name_of(raw: str) -> str:
            # Prometheus names: [a-zA-Z_:][a-zA-Z0-9_:]*
            out = "".join(c if c.isalnum() or c == "_" else "_" for c in raw)
            return out if out[:1].isalpha() or out[:1] == "_" else "_" + out

        lines: list[str] = []
        with self._lock:
            for raw, v in sorted(self._counters.items()):
                n = name_of(raw)
                lines.append(f"# TYPE {n} counter")
                lines.append(f"{n} {v}")
            for raw, v in sorted(self._gauges.items()):
                n = name_of(raw)
                lines.append(f"# TYPE {n} gauge")
                lines.append(f"{n} {v}")
            for raw, h in sorted(self._hists.items()):
                n = name_of(raw)
                s = h.summary()
                lines.append(f"# TYPE {n} summary")
                for q in ("p50", "p95", "p99"):
                    if q in s:
                        lines.append(f'{n}{{quantile="0.{q[1:]}"}} {s[q]}')
                lines.append(f"{n}_count {h.total_count}")
                lines.append(f"{n}_sum {h.total_sum}")
        return "\n".join(lines) + "\n"


class _Timer:
    def __init__(self, metrics: Metrics, name: str) -> None:
        self._metrics = metrics
        self._name = name

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._metrics.observe(self._name, time.perf_counter() - self._t0)


METRICS = Metrics()
