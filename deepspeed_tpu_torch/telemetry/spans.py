"""Chrome-trace/Perfetto span buffer + ``trace.json`` export (counterpart
of ``deepspeed_tpu/telemetry/spans.py``: the same events, lanes and
schema check).

Every host-observable activity becomes a proper span in one
process-wide :class:`TraceBuffer`: StepTimeline phases (train AND
serving), async-checkpoint writer commits, comm decision instants, and
the serving per-request lifecycle (queue → prefill chunks → decode →
retire).  :meth:`TraceBuffer.export` writes the JSON-object form of the
Chrome trace-event format — load it in ``ui.perfetto.dev`` or
``chrome://tracing``.

**Spans of work on the card** (:meth:`TraceBuffer.add_device_span`)
take their times from two CUDA events recorded on the stream around the
work, never from the host clock at the moment the launches were queued.
They wait in a pending list until :meth:`TraceBuffer.resolve` (called by
:meth:`export` and :meth:`events`, i.e. at export or report cadence)
waits for their last event and places them on the buffer's clock: a
fresh event is recorded and waited for, the host reads ``now()``, and
every pending event's time is ``now() - elapsed(event -> fresh)``.

Event vocabulary (the subset of the trace-event spec we emit):

* ``"ph": "X"`` — complete span: ``ts``/``dur`` in **microseconds**
  against the buffer's monotonic epoch;
* ``"ph": "i"`` — instant (retire markers, comm decisions, SLO
  breaches), ``"s": "t"`` (thread scope);
* ``"ph": "M"`` — metadata (``process_name``/``thread_name`` rows so
  Perfetto labels the tracks).

Track layout: ``pid`` groups a subsystem (0 = engine step phases,
1 = serving requests, 2 = checkpoint writer); ``tid`` separates lanes
inside it (request id for serving, 0 otherwise; 1 = the card's spans of
the engine's steps, 3 = the KV tiers' jobs).

The buffer is a bounded ring (``maxlen`` events, oldest dropped,
``dropped`` counted) and every ``add_*`` starts with one ``enabled``
check — tracing off costs a pointer test at the call site.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# subsystem pid lanes (metadata names are registered on first use)
PID_ENGINE = 0
PID_REQUESTS = 1
PID_CHECKPOINT = 2

_PID_NAMES = {
    PID_ENGINE: "engine step phases",
    PID_REQUESTS: "serving requests",
    PID_CHECKPOINT: "checkpoint writer",
}

_VALID_PH = {"X", "i", "M", "C"}


class TraceBuffer:
    def __init__(self, enabled: bool = False, max_events: int = 100_000):
        self.enabled = bool(enabled)
        self.max_events = max(1000, int(max_events))
        self.epoch = time.monotonic()
        self.dropped = 0
        self._events: deque = deque(maxlen=self.max_events)
        # (pid, tid|None) -> track name; kept OUT of the ring so the
        # process/thread name rows survive ring eviction on long runs
        self._meta: Dict[tuple, str] = {}
        # CUDA-event spans not yet placed on the clock (resolve())
        self._pending: List[tuple] = []
        self._lock = threading.Lock()

    def configure(self, enabled: Optional[bool] = None,
                  max_events: Optional[int] = None) -> "TraceBuffer":
        if max_events is not None and int(max_events) != self.max_events:
            self.max_events = max(1000, int(max_events))
            with self._lock:
                self._events = deque(self._events, maxlen=self.max_events)
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        """The buffer's clock (``time.monotonic``) — span start/end
        stamps MUST come from this clock family or ordering breaks."""
        return time.monotonic()

    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    # -- recording ---------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        # the lock serializes writers against events()/clear() readers:
        # iterating a deque mid-append raises RuntimeError, which would
        # drop the atexit trace export
        with self._lock:
            if len(self._events) == self.max_events:
                self.dropped += 1
            self._events.append(ev)

    def _ensure_meta(self, pid: int, tid: int, tid_name: Optional[str] = None) -> None:
        # same lock as events(): the name table must not change size
        # under a concurrent export's iteration
        with self._lock:
            if (pid, None) not in self._meta:
                self._meta[(pid, None)] = _PID_NAMES.get(pid, f"pid {pid}")
            if tid_name and (pid, tid) not in self._meta:
                self._meta[(pid, tid)] = tid_name

    def _meta_events(self) -> List[Dict[str, Any]]:
        out = []
        for (pid, tid), name in sorted(self._meta.items(),
                                       key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            if tid is None:
                out.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                            "args": {"name": name}})
            else:
                out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                            "args": {"name": name}})
        return out

    def add_span(self, name: str, cat: str, start: float, end: float,
                 pid: int = PID_ENGINE, tid: int = 0,
                 args: Optional[Dict[str, Any]] = None,
                 tid_name: Optional[str] = None) -> None:
        """One complete "X" span; ``start``/``end`` are ``now()`` stamps."""
        if not self.enabled:
            return
        self._ensure_meta(pid, tid, tid_name)
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(self._us(start), 3),
              "dur": round(max(0.0, end - start) * 1e6, 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def add_device_span(self, name: str, cat: str, start_event, end_event,
                        pid: int = PID_ENGINE, tid: int = 1,
                        args: Optional[Dict[str, Any]] = None,
                        tid_name: Optional[str] = None) -> None:
        """One "X" span of work on the card between two CUDA events
        (``torch.cuda.Event(enable_timing=True)``, recorded on the stream
        before and after the work).  Nothing is read here: the span joins
        the pending list and gets its times at :meth:`resolve`."""
        if not self.enabled:
            return
        self._ensure_meta(pid, tid, tid_name)
        with self._lock:
            self._pending.append((name, cat, start_event, end_event, pid, tid, args))

    def resolve(self) -> int:
        """Place every pending device span on the buffer's clock (waits for
        the card to reach a fresh event: call it at export or report
        cadence, never per step).  Returns how many were placed."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        import torch

        # one process, one card (the current device): every pending span's
        # events were recorded on it
        try:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            mark.synchronize()
            t_mark = self.now()
            times = [(start.elapsed_time(end) / 1e3, end.elapsed_time(mark) / 1e3)
                     for _, _, start, end, *_ in pending]
        except RuntimeError:  # the card is gone (interpreter exit): drop them
            with self._lock:
                self.dropped += len(pending)
            return 0
        for (name, cat, _, _, pid, tid, args), (dur, before_mark) in zip(pending, times):
            t1 = t_mark - before_mark
            t0 = t1 - dur
            ev = {"name": name, "cat": cat, "ph": "X",
                  "ts": round(max(0.0, self._us(t0)), 3),
                  "dur": round(max(0.0, t1 - t0) * 1e6, 3),
                  "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            self._push(ev)
        return len(pending)

    def add_counter(self, name: str, series: Dict[str, float],
                    ts: Optional[float] = None, pid: int = PID_ENGINE,
                    tid: int = 0) -> None:
        """One "C" counter sample: Perfetto renders each ``series`` key
        as a stacked counter track under ``name`` (the attribution
        module emits per-bucket time-share tracks this way)."""
        if not self.enabled:
            return
        self._ensure_meta(pid, tid)
        self._push({
            "name": name, "ph": "C",
            "ts": round(self._us(self.now() if ts is None else ts), 3),
            "pid": pid, "tid": tid,
            "args": {str(k): float(v) for k, v in series.items()},
        })

    def add_instant(self, name: str, cat: str, ts: Optional[float] = None,
                    pid: int = PID_ENGINE, tid: int = 0,
                    args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        self._ensure_meta(pid, tid)
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round(self._us(self.now() if ts is None else ts), 3),
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self._push(ev)

    @contextmanager
    def span(self, name: str, cat: str, pid: int = PID_ENGINE, tid: int = 0,
             args: Optional[Dict[str, Any]] = None):
        """Time a host block into one span (no-op when disabled)."""
        if not self.enabled:
            yield
            return
        t0 = self.now()
        try:
            yield
        finally:
            self.add_span(name, cat, t0, self.now(), pid=pid, tid=tid, args=args)

    # -- export ------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Metadata rows first (rebuilt from the name table, immune to
        ring eviction), then the recorded span ring (pending device spans
        resolved first)."""
        self.resolve()
        with self._lock:
            return self._meta_events() + list(self._events)

    def export(self, path: str, metadata: Optional[Dict[str, Any]] = None) -> str:
        """Write the Chrome trace-event JSON object to ``path``
        (atomically: tmp + replace, so a reader never sees a torn
        trace).  Returns the path."""
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "deepspeed_tpu_torch.telemetry",
                "epoch_monotonic": self.epoch,
                "dropped_events": self.dropped,
                **(metadata or {}),
            },
        }
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._meta.clear()
            self._pending.clear()
            self.dropped = 0


def validate_chrome_trace(doc: Any) -> List[str]:
    """Validate a loaded ``trace.json`` against the Chrome trace-event
    schema (JSON-object form).  Returns a list of problems — empty means
    schema-valid.  Shared by the tests and ``chip_smoke.py``."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty 'name'")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: '{key}' must be an int")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: 'ts' must be a non-negative number")
            if not isinstance(ev.get("cat"), str):
                problems.append(f"{where}: spans need a 'cat' string")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: 'dur' must be a non-negative number")
        if ph == "i" and ev.get("s") not in (None, "t", "p", "g"):
            problems.append(f"{where}: instant scope 's' must be t/p/g")
        if ph == "C":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: 'ts' must be a non-negative number")
            if not isinstance(ev.get("args"), dict) or not ev["args"]:
                problems.append(f"{where}: counter events need a non-empty 'args' object")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: 'args' must be an object")
    return problems
