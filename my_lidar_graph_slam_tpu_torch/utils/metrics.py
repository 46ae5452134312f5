"""Prometheus-style metrics library.

Copy of ``my_lidar_graph_slam_tpu/utils/metrics.py`` (pure Python), under
the same metric names, so two ``metrics.json`` files compare key for key.

Mirror of the reference metric subsystem (metric.hpp:24-682, metric.cpp):
Counter, Gauge, Distribution (Welford streaming mean/variance), Histogram
(fixed- and exponential-width buckets), ValueSequence, each with a Null
variant, metric families, and a MetricManager singleton with JSON export
(the ptree export at metric.hpp:634).
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonic counter (metric.hpp Counter)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def increment(self, val: float = 1.0):
        self.value += val

    def reset(self):
        self.value = 0.0

    def to_dict(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Up/down gauge (metric.hpp Gauge)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0.0

    def set(self, val: float):
        self.value = val

    def increment(self, val: float = 1.0):
        self.value += val

    def decrement(self, val: float = 1.0):
        self.value -= val

    def reset(self):
        self.value = 0.0

    def to_dict(self):
        return {"type": "gauge", "value": self.value}


class Distribution:
    """Streaming mean/variance via Welford's algorithm
    (metric.hpp:288-340, metric.cpp Observe)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.num_samples = 0
        self.sum = 0.0
        self.mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, val: float):
        self.num_samples += 1
        self.sum += val
        delta = val - self.mean
        self.mean += delta / self.num_samples
        self._m2 += delta * (val - self.mean)
        self.min = min(self.min, val)
        self.max = max(self.max, val)

    @property
    def variance(self) -> float:
        return self._m2 / self.num_samples if self.num_samples else 0.0

    @property
    def standard_deviation(self) -> float:
        return math.sqrt(self.variance)

    def to_dict(self):
        return {
            "type": "distribution",
            "num_samples": self.num_samples,
            "sum": self.sum,
            "mean": self.mean,
            "standard_deviation": self.standard_deviation,
            "min": self.min if self.num_samples else None,
            "max": self.max if self.num_samples else None,
        }


class Histogram:
    """Bucketed histogram (metric.hpp:424-481).

    ``create_uniform``: fixed-width buckets; ``create_exponential``:
    exponential-width buckets (metric.cpp CreateFixedWidthHistogram /
    CreateExponentialWidthHistogram).
    """

    def __init__(self, name: str, boundaries: List[float]):
        self.name = name
        self.boundaries = list(boundaries)
        self.reset()

    @classmethod
    def create_uniform(cls, name: str, min_val: float, max_val: float,
                       bucket_width: float) -> "Histogram":
        bounds = []
        v = min_val
        while v < max_val + 1e-12:
            bounds.append(v)
            v += bucket_width
        return cls(name, bounds)

    @classmethod
    def create_exponential(cls, name: str, base_val: float,
                           max_power: int) -> "Histogram":
        bounds = [base_val * (2.0 ** p) for p in range(max_power + 1)]
        return cls(name, bounds)

    def reset(self):
        # counts[0] = below first boundary; counts[-1] = above last.
        self.counts = [0] * (len(self.boundaries) + 1)
        self.num_samples = 0
        self.sum = 0.0

    def observe(self, val: float):
        self.num_samples += 1
        self.sum += val
        idx = 0
        for b in self.boundaries:
            if val < b:
                break
            idx += 1
        self.counts[idx] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.num_samples if self.num_samples else 0.0

    def dump(self, stream=None):
        """Human-readable dump (the pattern used by
        PoseGraphOptimizerLM::DumpError, pose_graph_optimizer_lm.cpp:341)."""
        import sys
        stream = stream or sys.stderr
        print(f"Histogram {self.name}: n={self.num_samples} "
              f"mean={self.mean:.6g}", file=stream)
        for i, c in enumerate(self.counts):
            lo = self.boundaries[i - 1] if i > 0 else -math.inf
            hi = self.boundaries[i] if i < len(self.boundaries) else math.inf
            print(f"  [{lo:.4g}, {hi:.4g}): {c}", file=stream)

    def to_dict(self):
        return {
            "type": "histogram",
            "num_samples": self.num_samples,
            "sum": self.sum,
            "boundaries": self.boundaries,
            "counts": self.counts,
        }


class ValueSequence:
    """Append-only value sequence (metric.hpp ValueSequence)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.values: List[float] = []

    def observe(self, val: float):
        self.values.append(val)

    def reset(self):
        self.values.clear()

    def to_dict(self):
        return {"type": "value_sequence", "num_values": len(self.values),
                "values": self.values}


class NullMetric:
    """Null-object variant: all operations are no-ops
    (metric.hpp Null* classes)."""

    def __getattr__(self, _name):
        def noop(*args, **kwargs):
            return None
        return noop

    def to_dict(self):
        return {"type": "null"}


class MetricFamily:
    """Named registry of one metric kind (metric.hpp MetricFamily)."""

    def __init__(self, factory):
        self._factory = factory
        self._metrics: Dict[str, object] = {}

    def __call__(self, name: str, *args, **kwargs):
        if name not in self._metrics:
            self._metrics[name] = self._factory(name, *args, **kwargs)
        return self._metrics[name]

    def names(self):
        return list(self._metrics)

    def to_dict(self):
        return {name: m.to_dict() for name, m in self._metrics.items()}


class MetricManager:
    """Process-wide metric registry singleton (metric.hpp:604-682)."""

    _instance: Optional["MetricManager"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.counters = MetricFamily(Counter)
        self.gauges = MetricFamily(Gauge)
        self.distributions = MetricFamily(Distribution)
        self.histograms = MetricFamily(Histogram)
        self.value_sequences = MetricFamily(ValueSequence)

    @classmethod
    def instance(cls) -> "MetricManager":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_instance(cls):
        with cls._lock:
            cls._instance = None

    def to_dict(self):
        """JSON export (the ToPropertyTree equivalent, metric.hpp:634)."""
        return {
            "Counters": self.counters.to_dict(),
            "Gauges": self.gauges.to_dict(),
            "Distributions": self.distributions.to_dict(),
            "Histograms": self.histograms.to_dict(),
            "ValueSequences": self.value_sequences.to_dict(),
        }

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
