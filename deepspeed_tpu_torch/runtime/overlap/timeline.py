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

Not ported: the JAX timeline's telemetry attachment (spans and registry
publishing, ROADMAP A14) and its comm-strategy metadata (A6).
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

    # -- recording --------------------------------------------------------
    def note(self, phase: str, seconds: float) -> None:
        """Accumulate ``seconds`` of ``phase`` into the pending step."""
        if not self.enabled:
            return
        self._pending[phase] = self._pending.get(phase, 0.0) + float(seconds)

    @contextmanager
    def phase(self, name: str):
        """Time a host block and note it under ``name``."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note(name, time.perf_counter() - t0)

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
