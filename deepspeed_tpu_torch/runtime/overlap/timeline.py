"""Step-phase timeline: honest per-step wall-time attribution (counterpart
of ``deepspeed_tpu/runtime/overlap/timeline.py``).

Every training step's wall time is split into named phases:

* ``data_wait``  — host blocked waiting for an input batch (loader pull,
  host-to-device copy, prefetch-queue wait);
* ``compute``    — the step's launches until the card has run them,
  recorded ONLY when the engine fences it with ``torch.cuda.synchronize``
  (``overlap.timeline.fence``) — CUDA launches are asynchronous, so an
  unfenced delta only measures the time to queue the work, and a
  per-step fence costs a host round trip the loop otherwise avoids;
* ``ckpt_stall`` — time training was stalled on checkpoint I/O (the
  full save for synchronous saves; snapshot+submit for async saves);
* ``compile``    — building a new executable: the JAX package's phase,
  which eager PyTorch never notes;
* ``other``      — whatever remains of the step wall (host bookkeeping,
  logging, monitor flushes).

Notes accumulate into a *pending* record; :meth:`end_step` closes it
against the wall clock since the previous step boundary, so host work
that happens between steps (e.g. a checkpoint save between two
``train_batch`` calls) is attributed to the step that paid for it.

The timeline itself is pure host bookkeeping (two ``perf_counter``
reads and a dict update per note): enabled without the fence it does
not change the hot path and still attributes every host-measurable
phase; the per-step device fence is the engine's (opt-in) choice.

Attached to the telemetry plane (:meth:`StepTimeline.attach_telemetry`),
every ``phase()`` block also lands as a trace span and every closed step
record publishes into the metrics registry.  Not ported: the JAX
timeline's comm-strategy metadata in its summaries (the engine's
``comm_summary()`` carries it).
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional

PHASES = ("data_wait", "compute", "ckpt_stall", "compile", "other")


class StepTimeline:
    """Rolling per-step phase attribution over the last ``window`` steps.

    ``phases`` customizes the attributed phase names (the serving engine
    uses ``prefill/decode/sched``); ``other`` is always present as the
    unattributed remainder.  :meth:`set_gauge` records per-step levels
    (e.g. queue depth) that are averaged — not ms-scaled — in
    :meth:`summary`."""

    def __init__(self, enabled: bool = True, window: int = 512, phases=None):
        self.enabled = bool(enabled)
        self.window = max(1, int(window))
        self.phases = tuple(phases) if phases is not None else PHASES
        if "other" not in self.phases:
            self.phases = self.phases + ("other",)
        self.records: Deque[Dict[str, float]] = deque(maxlen=self.window)
        self.total_steps = 0
        self._pending: Dict[str, float] = {}
        self._pending_gauges: Dict[str, float] = {}
        self._gauge_names: set = set()
        self._last_boundary: Optional[float] = None
        # telemetry plane attachment: None-checked on the hot path; when
        # attached, phases become trace spans and closed step records
        # publish into the registry
        self._telemetry = None
        self._t_prefix = "train"
        self._trace_pid = 0

    def attach_telemetry(self, manager, prefix: str = "train", trace_pid: int = 0) -> None:
        """Route this timeline into a
        :class:`~deepspeed_tpu_torch.telemetry.TelemetryManager`: every
        ``phase()`` block also lands as a span (when tracing is armed)
        and every ``end_step`` publishes the closed record as
        histograms/gauges.  Detach with ``manager=None``."""
        self._telemetry = manager
        self._t_prefix = prefix
        self._trace_pid = int(trace_pid)

    # -- recording --------------------------------------------------------
    def note(self, phase: str, seconds: float) -> None:
        """Accumulate ``seconds`` of ``phase`` into the pending step."""
        if not self.enabled:
            return
        self._pending[phase] = self._pending.get(phase, 0.0) + float(seconds)

    @contextmanager
    def phase(self, name: str):
        """Time a host block and note it under ``name`` (and as a trace
        span when the attached telemetry plane has tracing armed)."""
        if not self.enabled:
            yield
            return
        tm = self._telemetry
        tracer = tm.tracer if tm is not None and tm.tracer.enabled else None
        t0m = tracer.now() if tracer is not None else 0.0
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.note(name, dt)
            if tracer is not None:
                tracer.add_span(f"{self._t_prefix}/{name}", self._t_prefix, t0m, t0m + dt,
                                pid=self._trace_pid)

    def set_gauge(self, name: str, value: float) -> None:
        """Record a per-step level (queue depth, live slots, ...): kept
        as-is in the step record and reported as a window mean, not a
        millisecond phase."""
        if not self.enabled:
            return
        self._pending_gauges[name] = float(value)
        self._gauge_names.add(name)

    def end_step(self, count: int = 1) -> None:
        """Close the pending record against the wall clock.  ``count > 1``
        spreads the window evenly over ``count`` steps (one compiled
        multi-step run, e.g. ``train_batches``)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if self._last_boundary is None:
            # first boundary: no previous anchor, the wall is whatever
            # was explicitly noted (avoids charging engine build time
            # to step 1's "other")
            wall = sum(self._pending.values())
        else:
            wall = now - self._last_boundary
        self._last_boundary = now
        noted = sum(self._pending.values())
        other = max(0.0, wall - noted)
        count = max(1, int(count))
        rec = {p: self._pending.get(p, 0.0) / count for p in self.phases if p != "other"}
        rec["other"] = (self._pending.get("other", 0.0) + other) / count
        rec["wall"] = max(wall, noted) / count
        rec.update(self._pending_gauges)
        for _ in range(count):
            self.records.append(dict(rec))
        if self._telemetry is not None:
            # registry publish of the closed record (host dict ops; the
            # manager also derives the live MFU gauge from the wall)
            self._telemetry.publish_step(self._t_prefix, rec, count=count,
                                         gauge_names=self._gauge_names)
        self.total_steps += count
        self._pending = {}
        self._pending_gauges = {}

    def reset_window(self) -> None:
        """Drop recorded steps (keep the wall anchor); the next
        ``summary()`` covers only steps recorded after this call."""
        self.records.clear()

    # -- reporting --------------------------------------------------------
    def summary(self, last_n: Optional[int] = None) -> Dict[str, float]:
        """Mean per-step milliseconds per phase over the last ``last_n``
        recorded steps (default: the whole window), plus ``steps_per_s``
        derived from the mean step wall."""
        recs: List[Dict[str, float]] = list(self.records)
        if last_n is not None:
            recs = recs[-int(last_n):]
        out = {f"{p}_ms": 0.0 for p in self.phases}
        out["wall_ms"] = 0.0
        out["steps"] = len(recs)
        out["steps_per_s"] = 0.0
        for g in sorted(self._gauge_names):
            out[g] = 0.0
        if not recs:
            return out
        n = len(recs)
        for p in self.phases:
            out[f"{p}_ms"] = round(sum(r.get(p, 0.0) for r in recs) * 1000.0 / n, 3)
        for g in sorted(self._gauge_names):
            out[g] = round(sum(r.get(g, 0.0) for r in recs) / n, 3)
        wall = sum(r.get("wall", 0.0) for r in recs) / n
        out["wall_ms"] = round(wall * 1000.0, 3)
        out["steps_per_s"] = round(1.0 / wall, 3) if wall > 0 else 0.0
        return out

    def format_summary(self, last_n: Optional[int] = None) -> str:
        """One log line: phase means and their share of the step wall."""
        s = self.summary(last_n)
        if not s["steps"]:
            return "step timeline: no steps recorded"
        wall = max(s["wall_ms"], 1e-9)
        parts = [
            f"{p}: {s[f'{p}_ms']:.1f}ms ({100.0 * s[f'{p}_ms'] / wall:.0f}%)"
            for p in self.phases
            if s[f"{p}_ms"] > 0.0 or p in ("data_wait", "compute")
        ]
        parts += [f"{g}: {s[g]:.1f}" for g in sorted(self._gauge_names)]
        return (
            f"step timeline over {s['steps']} step(s): wall {s['wall_ms']:.1f}ms "
            f"({s['steps_per_s']:.2f} steps/s) | " + " | ".join(parts)
        )
