"""Lightweight runtime metrics: counters, gauges, and latency histograms.

The reference has no metrics subsystem (its observability is the status
snapshot and the event log; see ``pkg/status/status.go`` and
``pkg/eventlog/``).  SURVEY.md §5 calls for adding counters here because the
framework's headline numbers — committed req/s, crypto batch sizes, device
dispatch latency — are continuous quantities a snapshot cannot capture.

Design: a process-local registry of named instruments with zero hot-path
allocation (counters are plain attribute increments; histograms append to a
float list and summarize lazily).  No background threads — the integration
surfaces are a ``snapshot()`` dict (tests, the bench harness, the node
runtime's status output) and ``render_prometheus()``, a text-exposition
renderer an external scraper can consume (docs/OBSERVABILITY.md).

Instruments may carry labels (e.g. ``{"node": "3"}``): label sets are part
of the instrument identity, so ``histogram("commit_latency_seconds",
labels={"node": "0"})`` and the node-1 twin are distinct series, rendered
with proper Prometheus label syntax.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def escape_label_value(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def format_labels(labels: Optional[Dict[str, str]]) -> str:
    """Canonical ``{k="v",...}`` rendering (sorted keys); "" for no labels."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels) if labels else {}
        self.value = 0

    def inc(self, delta: int = 1) -> None:
        self.value += delta


class Gauge:
    """Point-in-time value."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels) if labels else {}
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Records observations; summarizes percentiles lazily.

    Bounded: keeps the most recent ``max_samples`` observations (enough for
    stable p50/p99 of a dispatch-latency stream without unbounded growth).
    """

    __slots__ = (
        "name", "labels", "samples", "max_samples", "total_count", "total_sum"
    )

    def __init__(
        self,
        name: str,
        max_samples: int = 4096,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.name = name
        self.labels = dict(labels) if labels else {}
        self.samples: List[float] = []
        self.max_samples = max_samples
        self.total_count = 0
        self.total_sum = 0.0

    def observe(self, value: float) -> None:
        self.total_count += 1
        self.total_sum += value
        samples = self.samples
        if len(samples) >= self.max_samples:
            # Drop the oldest half in one slice (amortized O(1) per observe).
            del samples[: self.max_samples // 2]
        samples.append(value)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    def mean(self) -> float:
        if self.total_count == 0:
            return 0.0
        return self.total_sum / self.total_count


class Timer:
    """Context manager recording elapsed seconds into a histogram."""

    __slots__ = ("histogram", "_start")

    def __init__(self, histogram: Histogram):
        self.histogram = histogram
        self._start = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.histogram.observe(time.perf_counter() - self._start)


class Registry:
    """Named instrument registry.  Instruments are created on first use and
    shared thereafter; creation is locked, hot-path updates are not (CPython
    attribute increments are atomic enough for monitoring data, matching the
    design of mainstream client libraries)."""

    def __init__(self):
        # Creation-only lock; reads are deliberately lock-free (class
        # docstring: CPython attribute increments are atomic enough for
        # monitoring data).
        # mirlint: allow(lock-map)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # Highest value ever reported per monotonic key (counters and
        # histogram _count/_sum): snapshot() clamps to these so a scrape
        # racing an unlocked `value += delta` (a torn read-modify-write
        # can briefly publish a stale lower value) never shows a counter
        # going backward across two snapshots.
        self._last_mono: Dict[str, float] = {}

    def counter(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Counter:
        key = name + format_labels(labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(name, labels))
        return c

    def gauge(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> Gauge:
        key = name + format_labels(labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(name, labels))
        return g

    def histogram(
        self,
        name: str,
        max_samples: int = 4096,
        labels: Optional[Dict[str, str]] = None,
    ) -> Histogram:
        key = name + format_labels(labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    key, Histogram(name, max_samples, labels)
                )
        return h

    def timer(self, name: str) -> Timer:
        return Timer(self.histogram(name))

    def _instruments(
        self,
    ) -> Tuple[List[Counter], List[Gauge], List[Histogram]]:
        """Consistent instrument lists, taken under the creation lock so a
        concurrent first-use creation cannot mutate the dicts mid-iteration
        (``RuntimeError: dictionary changed size during iteration``)."""
        with self._lock:
            return (
                list(self._counters.values()),
                list(self._gauges.values()),
                list(self._histograms.values()),
            )

    def snapshot(self) -> Dict[str, float]:
        """Flat name -> value dict; histograms expand to
        _count/_sum/_mean/_p50/_p99.  Labeled instruments keep their label
        block in the key (``name{k="v"}``); ``render_prometheus`` is the
        properly-labeled exposition surface."""
        counters, gauges, histograms = self._instruments()
        out: Dict[str, float] = {}

        def mono(key: str, value: float) -> float:
            prev = self._last_mono.get(key)
            if prev is not None and value < prev:
                return prev
            self._last_mono[key] = value
            return value

        with self._lock:
            for c in counters:
                key = c.name + format_labels(c.labels)
                out[key] = mono(key, c.value)
            for h in histograms:
                key = h.name + format_labels(h.labels)
                out[f"{key}_count"] = mono(f"{key}_count", h.total_count)
                out[f"{key}_sum"] = mono(f"{key}_sum", h.total_sum)
                out[f"{key}_mean"] = h.mean()
                out[f"{key}_p50"] = h.percentile(50)
                out[f"{key}_p99"] = h.percentile(99)
        for g in gauges:
            out[g.name + format_labels(g.labels)] = g.value
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._last_mono.clear()


def _fmt_value(value: float) -> str:
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def render_prometheus(
    registry: Optional[Registry] = None,
    extra_labels: Optional[Dict[str, str]] = None,
) -> str:
    """Render a registry in the Prometheus text exposition format (0.0.4).

    Counters and gauges render as their own types; histograms render as
    ``summary`` series — our histograms are sample-windowed with lazy
    percentiles, which maps to quantile/sum/count, not to fixed buckets.
    ``extra_labels`` (e.g. ``{"node": "3"}``) are merged into every series,
    the per-node labeling the node runtime's exposition surface uses;
    instrument-level labels win on key collisions."""
    reg = registry if registry is not None else default_registry
    counters, gauges, histograms = reg._instruments()
    extra = dict(extra_labels) if extra_labels else {}
    lines: List[str] = []
    seen_types: Dict[str, str] = {}

    def type_line(name: str, kind: str) -> None:
        if name not in seen_types:
            seen_types[name] = kind
            lines.append(f"# TYPE {name} {kind}")

    def merged(labels: Dict[str, str]) -> Dict[str, str]:
        out = dict(extra)
        out.update(labels)
        return out

    for c in sorted(counters, key=lambda i: (i.name, sorted(i.labels.items()))):
        type_line(c.name, "counter")
        lines.append(
            f"{c.name}{format_labels(merged(c.labels))} {_fmt_value(c.value)}"
        )
    for g in sorted(gauges, key=lambda i: (i.name, sorted(i.labels.items()))):
        type_line(g.name, "gauge")
        lines.append(
            f"{g.name}{format_labels(merged(g.labels))} {_fmt_value(g.value)}"
        )
    for h in sorted(
        histograms, key=lambda i: (i.name, sorted(i.labels.items()))
    ):
        type_line(h.name, "summary")
        base = merged(h.labels)
        for q, pct in (("0.5", 50), ("0.99", 99)):
            labels = dict(base)
            labels["quantile"] = q
            lines.append(
                f"{h.name}{format_labels(labels)} "
                f"{_fmt_value(h.percentile(pct))}"
            )
        suffix_labels = format_labels(base)
        lines.append(f"{h.name}_sum{suffix_labels} {_fmt_value(h.total_sum)}")
        lines.append(
            f"{h.name}_count{suffix_labels} {_fmt_value(h.total_count)}"
        )
    return "\n".join(lines) + ("\n" if lines else "")


# Default process-wide registry (tests and embedders may build their own).
default_registry = Registry()


def counter(name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
    return default_registry.counter(name, labels)


def gauge(name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
    return default_registry.gauge(name, labels)


def histogram(
    name: str, labels: Optional[Dict[str, str]] = None
) -> Histogram:
    return default_registry.histogram(name, labels=labels)


def timer(name: str) -> Timer:
    return default_registry.timer(name)


def snapshot() -> Dict[str, float]:
    return default_registry.snapshot()
