"""Pluggable metric exporters + the off-hot-path export loop (counterpart
of ``deepspeed_tpu/telemetry/exporters.py``: the same JSONL lines, the same
Prometheus exposition text, the same TensorBoard tags).

Exporters consume :meth:`MetricsRegistry.snapshot` dicts; none of them
ever runs on the training/serving thread — the :class:`ExportLoop`
background thread flushes on the configured cadence
(``telemetry.export_interval_seconds``) and once more at interpreter
exit, so the hot path's only telemetry cost is the registry's host dict
updates.

* :class:`JsonlExporter` — one JSON line per export: the full typed
  snapshot (ts, rank, step, every metric).  The historical stream; a
  notebook replays a run from it.
* :class:`PrometheusTextfileExporter` — the node-exporter textfile-
  collector contract: the CURRENT value set in Prometheus exposition
  format, rewritten atomically (tmp + rename) each export so a scraper
  never reads a torn file.
* :class:`TensorBoardSink` — the PR-existing
  :class:`~deepspeed_tpu_torch.utils.monitor.TensorBoardMonitor` rewired as a
  registry sink: counters/gauges land as scalars tagged
  ``Telemetry/<name>`` at the registry's current step.  (The engine's
  reference ``Train/Samples/*`` events keep their exact tags via the
  manager's direct forward — this sink is the everything-else stream.)
"""
from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")
_PROM_KINDS = {"counter": "counter", "gauge": "gauge", "histogram": "summary"}


def _prom_name(name: str) -> str:
    return "ds_" + _PROM_BAD.sub("_", name).strip("_")


def _prom_labels(labels: Dict[str, Any], rank: int) -> str:
    # a metric-level "rank" label wins over the snapshot's — duplicate
    # label names are invalid exposition format and would make the
    # collector reject the whole file
    items = sorted((str(k), str(v)) for k, v in labels.items())
    if not any(k == "rank" for k, _ in items):
        items.insert(0, ("rank", str(rank)))
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + inner + "}"


class JsonlExporter:
    name = "jsonl"

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(self.path, "a")

    def export(self, snapshot: Dict[str, Any]) -> None:
        self._fh.write(json.dumps(snapshot) + "\n")
        self._fh.flush()

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # pragma: no cover - double close on teardown
            pass


class PrometheusTextfileExporter:
    name = "prometheus"

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def export(self, snapshot: Dict[str, Any]) -> None:
        rank = int(snapshot.get("rank", 0))
        lines: List[str] = [
            # the JAX package's header line, so the two files read alike
            f"# deepspeed_tpu telemetry, ts={snapshot.get('ts', 0):.3f} "
            f"step={snapshot.get('step', 0)}"
        ]
        typed: set = set()
        for m in snapshot.get("metrics", []):
            pname = _prom_name(m["name"])
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {_PROM_KINDS.get(m['kind'], 'untyped')}")
            labels = _prom_labels(m.get("labels", {}), rank)
            if m["kind"] == "histogram":
                base = pname
                lines.append(f"{base}_count{labels} {m.get('count', 0)}")
                lines.append(f"{base}_sum{labels} {m.get('sum', 0.0)}")
                for q, key in ((0.5, "p50"), (0.99, "p99")):
                    v = m.get(key)
                    if v is not None:
                        qlabels = labels[:-1] + f',quantile="{q}"' + "}"
                        lines.append(f"{base}{qlabels} {v}")
            else:
                v = m.get("value")
                if v is None:
                    continue
                lines.append(f"{pname}{labels} {v}")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.replace(tmp, self.path)

    def close(self) -> None:
        pass


class TensorBoardSink:
    name = "tensorboard"

    def __init__(self, monitor):
        self.monitor = monitor

    def export(self, snapshot: Dict[str, Any]) -> None:
        mon = self.monitor
        if mon is None or not getattr(mon, "enabled", False):
            return
        step = int(snapshot.get("step", 0))
        for m in snapshot.get("metrics", []):
            if m["kind"] == "histogram":
                value = m.get("mean")
            else:
                value = m.get("value")
            if value is None:
                continue
            suffix = "".join(
                f"/{k}.{v}" for k, v in sorted(m.get("labels", {}).items())
            )
            mon.add_scalar(f"Telemetry/{m['name']}{suffix}", float(value), step)
        mon.flush()

    def close(self) -> None:
        pass


class ExportLoop:
    """One daemon thread flushing the registry to every exporter on a
    cadence; ``flush()`` forces an immediate export (bench records, the
    atexit hook).  Exporter failures are logged, never raised — losing a
    scrape must not take down the run."""

    def __init__(self, registry, exporters, interval_seconds: float = 10.0):
        self.registry = registry
        self.exporters = list(exporters)
        self.interval = max(0.05, float(interval_seconds))
        self.last_export_at: Optional[float] = None
        self.exports = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flush_lock = threading.Lock()

    def start(self) -> "ExportLoop":
        if self._thread is None and self.exporters:
            t = threading.Thread(target=self._loop, name="ds-telemetry-export", daemon=True)
            t.start()
            self._thread = t
            atexit.register(self.stop)
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush()

    def flush(self) -> None:
        if not self.exporters:
            return
        with self._flush_lock:
            try:
                snapshot = self.registry.snapshot()
            except Exception as e:  # noqa: BLE001 — one bad scrape must not kill the loop
                logger.warning(f"telemetry: registry snapshot failed: {e!r}")
                return
            for ex in self.exporters:
                try:
                    ex.export(snapshot)
                except Exception as e:  # noqa: BLE001 — an exporter must not kill the run
                    logger.warning(f"telemetry: {getattr(ex, 'name', ex)} export failed: {e!r}")
            self.last_export_at = time.monotonic()
            self.exports += 1

    def last_export_age(self) -> Optional[float]:
        # falsy (None OR a zero/unset stamp) means "never exported" —
        # returning a monotonic-epoch delta here is how ds_report once
        # printed a billions-of-seconds "age" for a loop that had not
        # flushed yet
        if not self.last_export_at:
            return None
        return time.monotonic() - self.last_export_at

    def stop(self) -> None:
        """Final flush + close (idempotent; registered atexit)."""
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self.flush()
        finally:
            for ex in self.exporters:
                try:
                    ex.close()
                except Exception:  # noqa: BLE001 — teardown must not raise
                    pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
