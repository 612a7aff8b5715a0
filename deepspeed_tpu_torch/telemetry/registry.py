"""Process-wide metrics registry: typed counters / gauges / histograms
(counterpart of ``deepspeed_tpu/telemetry/registry.py``, a copy of that
framework-free file: the same names, values, locking and snapshots).

One :class:`MetricsRegistry` per process (module singleton in
``deepspeed_tpu_torch.telemetry``); every subsystem publishes into it —
StepTimeline phases, comm-layer strategy decisions and step bytes,
serving scheduler/engine stats, resilience events, and the flops
profiler's MFU accounting.

Design constraints (the hot path pays for every byte of this):

* **host-only**: a metric update is a couple of dict/deque operations —
  no tensor, no device sync.  Values handed in must already be host
  scalars (the publishing site owns any ``.item()`` and its cadence);
* **zero overhead when disabled**: every update starts with one
  ``enabled`` attribute check and returns.  Sources additionally gate
  their whole publish block on a local ``None`` check so a disabled
  plane costs one pointer comparison per step;
* **bounded**: histograms and the per-metric sample history live in
  ``deque(maxlen=ring)`` ring buffers — a week-long run holds the same
  memory as a minute-long one;
* **thread-safe**: the serving engine, the async checkpoint writer, and
  the fleet router's threads all publish concurrently.  Metric creation
  takes the registry lock; every update AND every read path (snapshot /
  compact / mean) takes the per-metric lock — a histogram's
  count/sum/min/max are one logical value, and the export thread must
  never observe a half-applied ``observe()`` (the torn-snapshot race
  ds_race flags as ``race-inconsistent-lockset``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Metric:
    """Base: identity + the shared ``enabled`` gate (delegated to the
    owning registry so a late ``configure()`` flips every cached handle
    at once)."""

    kind = "metric"

    def __init__(self, registry: "MetricsRegistry", name: str, labels: Dict[str, Any]):
        self._registry = registry
        self.name = name
        self.labels = dict(labels)
        self.updated_at: float = 0.0

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    def qualified(self) -> str:
        if not self.labels:
            return self.name
        inner = ",".join(f"{k}={v}" for k, v in sorted(self.labels.items()))
        return f"{self.name}{{{inner}}}"

    def compact_value(self) -> float:
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonic event count (retries, finished requests, dead ranks)."""

    kind = COUNTER

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:  # ds-race: entry
        if not self._registry.enabled:
            return
        with self._lock:
            self.value += n
            self.updated_at = time.monotonic()

    def compact_value(self) -> float:  # ds-race: entry
        with self._lock:
            return self.value

    def snapshot(self) -> Dict[str, Any]:  # ds-race: entry
        with self._lock:
            value = self.value
        return {"name": self.name, "kind": self.kind, "labels": self.labels,
                "value": value}


class Gauge(Metric):
    """Last-written level (queue depth, MFU, loss, comm bytes/step) with
    a bounded ring of recent values for window means."""

    kind = GAUGE

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._lock = threading.Lock()
        self.value: Optional[float] = None
        self._ring: deque = deque(maxlen=registry.ring)

    def set(self, value: float) -> None:  # ds-race: entry
        if not self._registry.enabled:
            return
        v = float(value)
        with self._lock:
            self.value = v
            self._ring.append(v)
            self.updated_at = time.monotonic()

    def window_mean(self) -> Optional[float]:
        # copy under the writer's lock: iterating a deque while the hot
        # path appends raises RuntimeError in the export thread
        with self._lock:
            ring = list(self._ring)
        return sum(ring) / len(ring) if ring else None

    def compact_value(self) -> float:  # ds-race: entry
        with self._lock:
            return self.value if self.value is not None else 0.0

    def snapshot(self) -> Dict[str, Any]:  # ds-race: entry
        with self._lock:
            value = self.value
        return {"name": self.name, "kind": self.kind, "labels": self.labels,
                "value": value, "window_mean": self.window_mean()}


class Histogram(Metric):
    """Cumulative count/sum/min/max plus a bounded ring of recent
    samples; percentiles are computed over the RING (the recent window),
    which is what an SLO dashboard wants and what keeps memory bounded."""

    kind = HISTOGRAM

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._ring: deque = deque(maxlen=registry.ring)

    def observe(self, value: float, n: int = 1) -> None:  # ds-race: entry
        """``n > 1`` records the value with multiplicity — a compiled
        multi-step run (``train_batches``) closes one window covering n
        identical per-step records, and the exported count/percentile
        weighting must match the per-step path's."""
        if not self._registry.enabled:
            return
        v = float(value)
        n = max(1, int(n))
        with self._lock:
            self.count += n
            self.sum += v * n
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self._ring.extend([v] * min(n, self._ring.maxlen or n))
            self.updated_at = time.monotonic()

    def percentile(self, q: float) -> Optional[float]:
        # copy under the writer's lock (see Gauge.window_mean)
        with self._lock:
            ring = sorted(self._ring)
        if not ring:
            return None
        idx = min(len(ring) - 1, max(0, int(round((q / 100.0) * (len(ring) - 1)))))
        return ring[idx]

    def mean(self) -> Optional[float]:
        with self._lock:
            return self.sum / self.count if self.count else None

    def window_mean(self) -> Optional[float]:
        """Mean over the RING (recent window) — what a load-tracking
        consumer wants (the serving admission controller estimates TTFT
        from the *current* decode wall, not the lifetime mean, which a
        warmup compile would skew forever)."""
        with self._lock:
            ring = list(self._ring)
        return sum(ring) / len(ring) if ring else None

    def compact_value(self) -> float:  # ds-race: entry
        m = self.mean()
        return m if m is not None else 0.0

    def snapshot(self) -> Dict[str, Any]:  # ds-race: entry
        # count/sum/min/max are one logical value: copy them under the
        # writer's lock so a concurrent observe() can't tear the export
        with self._lock:
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
        return {
            "name": self.name, "kind": self.kind, "labels": self.labels,
            "count": count, "sum": total, "min": lo, "max": hi,
            "mean": (total / count if count else None),
            "p50": self.percentile(50), "p99": self.percentile(99),
        }


_KINDS = {COUNTER: Counter, GAUGE: Gauge, HISTOGRAM: Histogram}


class MetricsRegistry:
    """The process-wide metric table.  ``counter()``/``gauge()``/
    ``histogram()`` are get-or-create and return the SAME object for the
    same (name, labels) — callers may cache handles; a handle created
    while disabled becomes live when :meth:`configure` enables the
    registry (updates check the registry flag, not a frozen copy)."""

    def __init__(self, enabled: bool = False, ring: int = 1024, rank: int = 0):
        self.enabled = bool(enabled)
        self.ring = max(16, int(ring))
        self.rank = int(rank)
        self.step = 0  # engine-advanced; exporters stamp records with it
        self.created_at = time.monotonic()
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str, tuple], Metric] = {}

    def configure(self, enabled: Optional[bool] = None, ring: Optional[int] = None,
                  rank: Optional[int] = None) -> "MetricsRegistry":
        """In-place reconfiguration of the process singleton (a second
        engine in the same process must not orphan cached handles).  A
        ring change resizes EXISTING metrics' windows too — the
        configured memory bound applies to the whole registry, not just
        metrics created afterwards."""
        if enabled is not None:
            self.enabled = bool(enabled)
        if ring is not None and max(16, int(ring)) != self.ring:
            self.ring = max(16, int(ring))
            for m in self.metrics():
                old = getattr(m, "_ring", None)
                if old is not None:
                    with m._lock:
                        m._ring = deque(old, maxlen=self.ring)
        if rank is not None:
            self.rank = int(rank)
        return self

    # -- get-or-create handles --------------------------------------------
    def _get(self, kind: str, name: str, labels: Dict[str, Any]) -> Metric:  # ds-race: entry
        # Fully locked (no double-checked fast path): two threads
        # creating the same key must agree on ONE Metric object, and a
        # concurrent reset()/snapshot() must never see the table
        # mid-insert.  Callers cache handles, so this is not hot.
        key = (kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = _KINDS[kind](self, name, labels)
                self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(COUNTER, name, labels)  # type: ignore[return-value]

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(GAUGE, name, labels)  # type: ignore[return-value]

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(HISTOGRAM, name, labels)  # type: ignore[return-value]

    def set_step(self, step: int) -> None:
        self.step = int(step)

    # -- introspection / export -------------------------------------------
    def metrics(self) -> List[Metric]:  # ds-race: entry
        with self._lock:
            return list(self._metrics.values())

    def size(self) -> int:
        with self._lock:
            return len(self._metrics)

    def snapshot(self) -> Dict[str, Any]:  # ds-race: entry
        """Full typed snapshot for the exporters (JSONL / Prometheus /
        TensorBoard sink)."""
        return {
            "ts": time.time(),
            "rank": self.rank,
            "step": self.step,
            "metrics": [m.snapshot() for m in self.metrics()],
        }

    def snapshot_compact(self) -> Dict[str, float]:  # ds-race: entry
        """One float per metric, keyed by the qualified name — the shape
        that piggybacks on the supervision heartbeat (counters: total;
        gauges: last; histograms: mean).  Kept deliberately small: a
        beat line must stay a beat, not a bulk transfer."""
        out: Dict[str, float] = {}
        for m in self.metrics():
            v = m.compact_value()
            if v is not None:
                out[m.qualified()] = round(float(v), 6)
        return out

    def reset(self) -> None:
        """Drop every metric (tests; a fresh engine in a long-lived
        process keeps the registry by default — labels disambiguate)."""
        with self._lock:
            self._metrics.clear()
