"""Prometheus-style metrics library, with the port's spans.

Copy of ``my_lidar_graph_slam_tpu/utils/metrics.py``, under the same
metric names, so two ``metrics.json`` files compare key for key; the
port's own counters (``HostSyncs.<layer>``, ``FrontendMatches``, ...)
come beside them.

Mirror of the reference metric subsystem (metric.hpp:24-682, metric.cpp):
Counter, Gauge, Distribution (Welford streaming mean/variance), Histogram
(fixed- and exponential-width buckets), ValueSequence, each with a Null
variant, metric families, and a MetricManager singleton with JSON export
(the ptree export at metric.hpp:634).

Spans (:meth:`MetricManager.span`) are host intervals of the program's
layers on ``time.perf_counter_ns``, kept in memory while a
``torch.profiler`` session is active (:func:`tracing`) and exported under
``Spans``. Each also opens a ``record_function`` range of its name, so a
profiler trace shows the layers on the device trace's clock. Without a
session a span site reads one flag; the layer spans (``frontend.*``,
``map_builder.*``, ``backend.*``) also set the thread's current layer,
under which ``utils/device.py`` counts host syncs.
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# The layers a host sync is counted under (``HostSyncs.<layer>``): the
# first part of the innermost open span's name among these, else "other".
LAYERS = ("frontend", "map_builder", "backend")
_local = threading.local()


def tracing() -> bool:
    """True while a ``torch.profiler`` session is active: torch's
    process-wide flag for such checks, set on entering any profiler and
    read on every thread."""
    return _autograd_profiler._is_profiler_enabled


def current_layer() -> str:
    """The calling thread's innermost open layer span, or "other"."""
    return getattr(_local, "layer", "other")


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


# A span site with tracing off, outside the layers: nothing.
_NULL_SPAN = contextlib.nullcontext()


class _LayerSpan:
    """A layer span with tracing off: sets the thread's current layer for
    its extent, and records nothing."""

    __slots__ = ("layer", "prev")

    def __init__(self, layer: str):
        self.layer = layer

    def __enter__(self):
        self.prev = getattr(_local, "layer", "other")
        _local.layer = self.layer
        return self

    def __exit__(self, *exc):
        _local.layer = self.prev
        return False


class _Span(_LayerSpan):
    """An open span with tracing on (see :meth:`MetricManager.span`)."""

    __slots__ = ("manager", "row", "index", "range")

    def __init__(self, manager: "MetricManager", name: str, keyframe,
                 attrs: dict):
        super().__init__(_layer_of(name))
        self.manager = manager
        self.row = [name, threading.get_ident(), 0, None, -1, keyframe,
                    attrs]

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        row = self.row
        if stack:
            parent = stack[-1]
            if row[5] is None:
                row[5] = parent.row[5]
            if parent.manager is self.manager:
                row[4] = parent.index
        stack.append(self)
        if self.layer is None:
            self.layer = getattr(_local, "layer", "other")
        super().__enter__()
        self.range = _autograd_profiler.record_function(row[0])
        self.range.__enter__()
        row[2] = time.perf_counter_ns()
        manager = self.manager
        with manager._trace_lock:
            self.index = len(manager._spans)
            manager._spans.append(row)
            manager._open.add(self.index)
        return self

    def __exit__(self, *exc):
        self.row[3] = time.perf_counter_ns()
        with self.manager._trace_lock:
            self.manager._open.discard(self.index)
        self.range.__exit__(None, None, None)
        _local.stack.pop()
        return super().__exit__(*exc)


def _layer_of(name: str) -> Optional[str]:
    layer = name.split(".", 1)[0]
    return layer if layer in LAYERS else None


class _DeviceTimer:
    """Times a block into a distribution: on a CUDA device by an event
    pair on the current stream, read once the end event has completed
    (:meth:`MetricManager.poll_device_timers`); elsewhere by the host
    clock."""

    def __init__(self, manager: "MetricManager", name: str, device):
        self.manager, self.name, self.device = manager, name, device

    def __enter__(self):
        self.manager.poll_device_timers()
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        else:
            self.start = None
            self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.start is None:
            self.manager.distributions(self.name).observe(
                time.time() - self.t0)
            return False
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        with self.manager._trace_lock:
            self.manager._device_timers.append((self.name, self.start, end))
        return False


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
        # Span rows [name, thread, start_ns, end_ns, parent, keyframe,
        # attrs], end_ns None while open (their indices in _open); a span
        # belongs to the instance current when it opened.
        self._spans: List[list] = []
        self._open = set()
        self._trace_lock = threading.Lock()
        # (distribution name, start event, end event) not yet completed.
        self._device_timers: List[tuple] = []

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

    @classmethod
    def span(cls, name: str, keyframe=None, **attrs):
        """A context manager that records one span while :func:`tracing`:
        ``name``, the thread (``threading.get_ident()``), start and end on
        ``time.perf_counter_ns``, the parent (the innermost span open on
        the same thread, if it belongs to this instance) and ``keyframe``
        (the parent's when not given), with ``attrs``; it also opens a
        ``torch.profiler.record_function`` range of ``name``. Without a
        profiler session it reads one flag, and a layer span (a name that
        starts with one of :data:`LAYERS` and a dot) sets the thread's
        current layer."""
        if not _autograd_profiler._is_profiler_enabled:
            layer = _layer_of(name)
            return _NULL_SPAN if layer is None else _LayerSpan(layer)
        return _Span(cls.instance(), name, keyframe, attrs)

    def device_timer(self, name: str, device):
        """A context manager that observes the block's time into the
        distribution ``name``: on a CUDA ``device`` the device's time from
        the start of the block's first work queued on the current stream
        to the end of its last (with whatever other threads queue on that
        stream between them), read without a sync once completed; on
        another device the host clock."""
        return _DeviceTimer(self, name, device)

    def poll_device_timers(self):
        """Observe every device timer whose end event has completed."""
        with self._trace_lock:
            pending, self._device_timers = self._device_timers, []
        left = []
        for name, start, end in pending:
            if end.query():
                self.distributions(name).observe(
                    start.elapsed_time(end) / 1e3)
            else:
                left.append((name, start, end))
        if left:
            with self._trace_lock:
                self._device_timers = left + self._device_timers

    def span_rows(self) -> List[list]:
        """The closed spans as ``[name, thread, start_ns, end_ns,
        parent_index, keyframe, attrs]`` rows, ``parent_index`` an index
        into these rows or -1. The rows before the first open span are
        exported as they are (a parent precedes its children), so an
        export at a window's end, where few spans are open, costs little
        host time."""
        with self._trace_lock:
            rows = list(self._spans)
            first = min(self._open, default=len(rows))
        out = rows[:first]
        index = {}
        for i in range(first, len(rows)):
            r = rows[i]
            if r[3] is None:
                continue
            index[i] = len(out)
            out.append(r if r[4] < first else
                       r[:4] + [index.get(r[4], -1)] + r[5:])
        return out

    def to_dict(self):
        """JSON export (the ToPropertyTree equivalent, metric.hpp:634),
        with ``Spans`` (:meth:`span_rows`) where any span was recorded."""
        self.poll_device_timers()
        out = {
            "Counters": self.counters.to_dict(),
            "Gauges": self.gauges.to_dict(),
            "Distributions": self.distributions.to_dict(),
            "Histograms": self.histograms.to_dict(),
            "ValueSequences": self.value_sequences.to_dict(),
        }
        spans = self.span_rows()
        if spans:
            out["Spans"] = spans
        return out

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
