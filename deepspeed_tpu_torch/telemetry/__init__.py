"""Unified telemetry plane (counterpart of ``deepspeed_tpu/telemetry``).

One process-wide :class:`~.registry.MetricsRegistry` + one
:class:`~.spans.TraceBuffer`, armed by :func:`configure` (the train
engine calls it from the validated ``telemetry`` config block; tools
call it directly).  Sources publish through a per-engine
:class:`~.manager.TelemetryManager` or, for rare out-of-engine events
(retries, comm decisions, async saves), straight into
:func:`get_registry`.

Exporters (JSONL / Prometheus textfile / TensorBoard sink) run on a
background thread — never on the step; the trace buffer exports
``trace.json`` for Perfetto (its spans of work on the card placed by
CUDA events at export time).  Files go under ``telemetry.output_path``
(default ``./telemetry``): ``metrics_rank<r>.jsonl``,
``metrics_rank<r>.prom`` and ``trace.json``.  Cross-rank aggregation
rides the supervision heartbeat, which is not ported yet (ROADMAP A14
resilience/supervision/): :mod:`.aggregate` holds its encoding and
aggregator only.
"""
from __future__ import annotations

import atexit
import os
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.telemetry.aggregate import (
    CrossRankAggregator,
    decode_metrics,
    encode_metrics,
)
from deepspeed_tpu_torch.telemetry.attribution import BUCKETS, Attribution
from deepspeed_tpu_torch.telemetry.exporters import (
    ExportLoop,
    JsonlExporter,
    PrometheusTextfileExporter,
    TensorBoardSink,
)
from deepspeed_tpu_torch.telemetry.manager import TelemetryManager
from deepspeed_tpu_torch.telemetry.regression import (
    bench_diff,
    check_step_spike,
    find_stragglers,
    history_append,
    history_bless,
    history_load,
)
from deepspeed_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deepspeed_tpu_torch.telemetry.spans import (
    PID_CHECKPOINT,
    PID_ENGINE,
    PID_REQUESTS,
    TraceBuffer,
    validate_chrome_trace,
)

# process singletons: disabled at import; configure() arms them
_REGISTRY = MetricsRegistry(enabled=False)
_TRACER = TraceBuffer(enabled=False)
_EXPORT_LOOP: Optional[ExportLoop] = None
_CONFIG = None
_TRACE_PATH: Optional[str] = None
_ATEXIT_DONE = False
_MANAGERS: list = []  # managers with a profiler window to close at exit


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def get_tracer() -> TraceBuffer:
    return _TRACER


def default_output_path(cfg=None) -> str:
    p = getattr(cfg or _CONFIG, "output_path", "") or ""
    return p or "telemetry"


def configure(config=None, rank: int = 0, label: str = "train",
              monitor=None, device_name: Optional[str] = None) -> TelemetryManager:
    """Arm the process-wide plane from a validated
    :class:`~deepspeed_tpu_torch.config.config.TelemetryConfig` (or a
    dict, or None for defaults) and return the caller's
    :class:`TelemetryManager`.  ``device_name``: the engine's device, the
    key of the peak table (``profiling/flops_profiler.py``).

    Idempotent by design for multi-engine processes: a second call
    reconfigures the shared registry/tracer in place (cached metric
    handles stay live) and replaces the export loop."""
    global _EXPORT_LOOP, _CONFIG, _TRACE_PATH, _ATEXIT_DONE
    from deepspeed_tpu_torch.config.config import TelemetryConfig

    if config is None:
        config = TelemetryConfig()
    elif isinstance(config, dict):
        config = TelemetryConfig.from_dict(config)
    _CONFIG = config

    _REGISTRY.configure(enabled=config.enabled, ring=config.ring, rank=rank)
    _TRACER.configure(
        enabled=config.enabled and config.trace,
        max_events=config.trace_buffer_events,
    )
    out_dir = default_output_path(config)
    _TRACE_PATH = config.trace_path or os.path.join(out_dir, "trace.json")

    # (re)build the export loop for the configured sink set
    if _EXPORT_LOOP is not None:
        _EXPORT_LOOP.stop()
        _EXPORT_LOOP = None
    if config.enabled and config.exporters:
        exporters = []
        for name in config.exporters:
            if name == "jsonl":
                exporters.append(
                    JsonlExporter(os.path.join(out_dir, f"metrics_rank{rank}.jsonl"))
                )
            elif name == "prometheus":
                exporters.append(
                    PrometheusTextfileExporter(
                        os.path.join(out_dir, f"metrics_rank{rank}.prom")
                    )
                )
            elif name == "tensorboard":
                exporters.append(TensorBoardSink(monitor))
        _EXPORT_LOOP = ExportLoop(
            _REGISTRY, exporters, interval_seconds=config.export_interval_seconds
        ).start()
    if not _ATEXIT_DONE:
        _ATEXIT_DONE = True
        atexit.register(shutdown)
    return _manager(label, monitor, config, device_name)


def _manager(label, monitor, config, device_name) -> TelemetryManager:
    m = TelemetryManager(label, _REGISTRY, _TRACER, monitor=monitor, config=config,
                         device_name=device_name)
    _MANAGERS.append(m)
    del _MANAGERS[:-64]  # the open windows of the newest managers only
    return m


def manager_for(label: str, monitor=None, device_name: Optional[str] = None) -> TelemetryManager:
    """A manager bound to the current process plane WITHOUT
    reconfiguring it (serving and the fleet attach to whatever the
    process armed; a no-config process gets no-op publishes)."""
    return _manager(label, monitor, _CONFIG, device_name)


def flush() -> None:
    """Force an immediate export (a record read right after)."""
    if _EXPORT_LOOP is not None:
        _EXPORT_LOOP.flush()


def export_trace(path: Optional[str] = None,
                 metadata: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Write the span buffer as Chrome-trace JSON; returns the path or
    None when tracing never armed."""
    if not _TRACER.enabled and not _TRACER.events():
        return None
    return _TRACER.export(path or _TRACE_PATH or "trace.json", metadata=metadata)


def shutdown() -> None:
    """Atexit: open profiler windows closed, final metric export, trace
    flush (an exit must not drop the evidence)."""
    global _EXPORT_LOOP
    for m in list(_MANAGERS):
        m.poll_profile(force=True)
    if _EXPORT_LOOP is not None:
        _EXPORT_LOOP.stop()
        _EXPORT_LOOP = None
    if _TRACER.enabled and _TRACER.events():
        try:
            export_trace()
        except OSError:  # pragma: no cover - exit path best-effort
            pass


def status() -> Dict[str, Any]:
    """Report rows: enabled sinks, cadence, registry size, last export
    age, trace state (resolves pending device spans)."""
    loop = _EXPORT_LOOP
    return {
        "enabled": _REGISTRY.enabled,
        "rank": _REGISTRY.rank,
        "registry_size": _REGISTRY.size(),
        "ring": _REGISTRY.ring,
        "sinks": [getattr(e, "name", "?") for e in (loop.exporters if loop else [])],
        "export_interval_seconds": loop.interval if loop else None,
        "exports": loop.exports if loop else 0,
        "last_export_age_seconds": loop.last_export_age() if loop else None,
        "trace_enabled": _TRACER.enabled,
        "trace_events": len(_TRACER.events()),
        "trace_path": _TRACE_PATH,
    }


def reset_for_tests() -> None:
    """Tear the plane back to import state (tests only)."""
    global _EXPORT_LOOP, _CONFIG, _TRACE_PATH
    if _EXPORT_LOOP is not None:
        _EXPORT_LOOP.stop()
        _EXPORT_LOOP = None
    _REGISTRY.reset()
    _REGISTRY.configure(enabled=False)
    _TRACER.clear()
    _TRACER.enabled = False
    _MANAGERS.clear()
    _CONFIG = None
    _TRACE_PATH = None


__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TraceBuffer", "validate_chrome_trace",
    "PID_ENGINE", "PID_REQUESTS", "PID_CHECKPOINT",
    "JsonlExporter", "PrometheusTextfileExporter", "TensorBoardSink", "ExportLoop",
    "CrossRankAggregator", "encode_metrics", "decode_metrics",
    "TelemetryManager", "Attribution", "BUCKETS",
    "bench_diff", "history_append", "history_bless", "history_load",
    "check_step_spike", "find_stragglers",
    "configure", "manager_for", "get_registry", "get_tracer",
    "flush", "export_trace", "shutdown", "status", "reset_for_tests",
]
