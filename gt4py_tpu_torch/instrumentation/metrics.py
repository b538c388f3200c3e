"""Runtime metrics and profiling hooks.

Reference parity: src/gt4py/next/instrumentation/metrics.py:41-120
(levels, sample accumulators, per-program collections, JSON dump at exit)
and gpu_profiler.py trace ranges -- mapped to ``torch.profiler``
record_function ranges, and NVTX ranges on the card.
"""

from __future__ import annotations

import atexit
import contextlib
import enum
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from gt4py_tpu_torch import config


class MetricLevel(enum.IntEnum):
    DISABLED = 0
    MINIMAL = 10
    PERFORMANCE = 20
    INFO = 30
    VERBOSE = 40
    ALL = 50


def enabled(level: MetricLevel) -> bool:
    return config.COLLECT_METRICS_LEVEL >= level


@dataclass
class Metric:
    """A named sample accumulator (reference: metrics.Metric, :70-110)."""

    name: str
    samples: List[float] = field(default_factory=list)

    def add_sample(self, value: float) -> None:
        self.samples.append(value)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else 0.0

    @property
    def total(self) -> float:
        return sum(self.samples)


@dataclass
class MetricsCollection:
    """Per-stencil metrics keyed by metric name."""

    source: str
    metrics: Dict[str, Metric] = field(default_factory=dict)

    def metric(self, name: str) -> Metric:
        if name not in self.metrics:
            self.metrics[name] = Metric(name)
        return self.metrics[name]


_COLLECTIONS: Dict[str, MetricsCollection] = {}


def collection(source: str) -> MetricsCollection:
    if source not in _COLLECTIONS:
        _COLLECTIONS[source] = MetricsCollection(source)
    return _COLLECTIONS[source]


def collect_sample(source: str, metric: str, value: float,
                   level: MetricLevel = MetricLevel.PERFORMANCE) -> None:
    if enabled(level):
        collection(source).metric(metric).add_sample(value)


def dump_metrics(path: Optional[str] = None) -> Optional[str]:
    """Serialize all collected metrics to JSON (returns the text)."""
    data = {
        source: {
            name: {
                "count": m.count,
                "mean": m.mean,
                "total": m.total,
            }
            for name, m in coll.metrics.items()
        }
        for source, coll in _COLLECTIONS.items()
    }
    text = json.dumps(data, indent=2, sort_keys=True)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


@atexit.register
def _dump_at_exit() -> None:  # reference: config.DUMP_METRICS_AT_EXIT
    if config.DUMP_METRICS_AT_EXIT and _COLLECTIONS:
        try:
            dump_metrics(config.DUMP_METRICS_AT_EXIT)
        except OSError:
            pass


@contextlib.contextmanager
def profile_range(name: str):
    """Named trace range: shows up in ``torch.profiler`` traces, and once
    the process works on the card (``torch.cuda.is_initialized()``) it is
    also an NVTX range for the CUDA tools (the reference's NVTX ranges,
    instrumentation/gpu_profiler.py:33-60)."""
    import torch

    nvtx = torch.cuda.nvtx.range(name) if torch.cuda.is_initialized() else \
        contextlib.nullcontext()
    with torch.profiler.record_function(name), nvtx:
        yield


@contextlib.contextmanager
def timed_sample(source: str, metric: str, level: MetricLevel = MetricLevel.PERFORMANCE):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        collect_sample(source, metric, time.perf_counter() - t0, level)
