"""TelemetryManager: the per-engine handle on the process-wide plane
(counterpart of ``deepspeed_tpu/telemetry/manager.py``).

``deepspeed_tpu_torch.telemetry.configure(cfg, ...)`` (called once by the
train engine, or explicitly by tools) arms the process singletons —
registry, trace buffer, export loop.  Each engine then owns one
:class:`TelemetryManager` labelled ``train`` / ``serving`` / ``fleet``:
it caches metric handles, publishes StepTimeline records and engine
progress events, carries the counted step's cost (the MFU gauge's
numerator) and its attribution table, forwards the reference
``Train/Samples/*`` TensorBoard events, and opens the on-demand /
on-SLO-breach ``torch.profiler`` window.

Everything here is host bookkeeping; the manager is ``None``-checked at
every engine call site, so a disabled plane costs one pointer test.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger


class TelemetryManager:
    def __init__(self, label: str, registry, tracer, monitor=None, config=None,
                 device_name: Optional[str] = None):
        self.label = label
        self.registry = registry
        self.tracer = tracer
        self.monitor = monitor
        self.config = config
        self.device_name = device_name  # the peak table's key (None: the current device)
        self._cost: Dict[str, float] = {}
        self._attribution = None  # per-bucket cost table (attribution.py)
        self._spikes = 0
        self._profiler_fired = False
        self._profile = None  # (profiler, deadline, logdir, reason) of an open window
        self._lock = threading.Lock()
        # per-step publish runs on the hot path: memoize metric handles
        # by bare name so each publish is dict-hit + deque-append, not a
        # label-tuple rebuild through the registry lock path
        self._hists: Dict[str, Any] = {}
        self._gauges: Dict[str, Any] = {}
        self._counters: Dict[str, Any] = {}

    def _hist(self, name: str):
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self.histogram(name)
        return h

    def _g(self, name: str):
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = self.gauge(name)
        return g

    def _c(self, name: str):
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = self.counter(name)
        return c

    # -- wiring -------------------------------------------------------------
    @property
    def collect(self) -> bool:
        return self.registry.enabled

    @property
    def monitor_enabled(self) -> bool:
        return self.monitor is not None and getattr(self.monitor, "enabled", False)

    @property
    def exports_armed(self) -> bool:
        """Whether any sink is actually flowing — what justifies a
        deliberate report-cadence read of a tensor (``.item()``).
        ``enabled: false`` wins over a listed exporter set: no loop was
        built, so no read may be charged for it."""
        return bool(
            self.config is not None
            and getattr(self.config, "enabled", True)
            and getattr(self.config, "exporters", ())
        )

    @property
    def attribution_armed(self) -> bool:
        """Whether the engine should count a step into the attribution
        table (``telemetry.attribution`` and a plane that publishes)."""
        cfg = self.config
        if cfg is not None and not getattr(cfg, "attribution", True):
            return False
        return self.registry.enabled or self.tracer.enabled

    def gauge(self, name: str, **labels):
        return self.registry.gauge(name, engine=self.label, **labels)

    def counter(self, name: str, **labels):
        return self.registry.counter(name, engine=self.label, **labels)

    def histogram(self, name: str, **labels):
        return self.registry.histogram(name, engine=self.label, **labels)

    # -- the counted step's cost (the MFU numerator) ------------------------
    def set_step_cost(self, cost: Dict[str, float]) -> None:
        """The counted step's cost (``flops``, ``bytes accessed``) —
        recorded once, free at publish time."""
        from deepspeed_tpu_torch.profiling.flops_profiler import cost_bytes

        self._cost = dict(cost or {})
        if not self.registry.enabled:
            return  # cost kept for summary(); no handles when disabled
        flops = self._cost.get("flops", 0.0)
        if flops:
            self.gauge("flops_per_step").set(flops)
        hbm = cost_bytes(self._cost)
        if hbm:
            self.gauge("hbm_bytes_per_step").set(hbm)

    def step_cost(self) -> Dict[str, float]:
        return dict(self._cost)

    # -- per-bucket attribution (attribution.py) ----------------------------
    def set_attribution(self, attribution) -> None:
        """Carry the step's per-bucket cost table: registry gauges +
        Perfetto counter tracks now, records on demand.  Never raises —
        attribution is evidence, not control."""
        if attribution is None:
            return
        self._attribution = attribution
        try:
            attribution.publish(self)
        except Exception as e:  # noqa: BLE001
            logger.warning(f"telemetry: attribution publish failed: {e!r}")

    def attribution(self):
        return self._attribution

    # -- per-step publish (StepTimeline hook) --------------------------------
    def publish_step(self, prefix: str, rec: Dict[str, float], count: int = 1,
                     gauge_names=()) -> None:
        """One closed StepTimeline record: phase histograms, wall/rate
        gauges, and the live MFU gauge (counted FLOPs over the measured
        step wall).  Host dict ops only."""
        self.poll_profile()
        if not self.registry.enabled:
            return
        wall = rec.get("wall", 0.0)
        for phase, v in rec.items():
            if phase == "wall" or phase in gauge_names:
                continue
            # count-weighted: one multi-step window must weigh the same
            # as `count` per-step windows in exported counts/percentiles
            self._hist(f"{prefix}/{phase}_ms").observe(v * 1e3, n=count)
        for g in gauge_names:
            if g in rec:
                self._g(f"{prefix}/{g}").set(rec[g])
        if wall > 0:
            wall_ms = wall * 1e3
            g_wall = self._g(f"{prefix}/step_wall_ms")
            # spike test against the window BEFORE this sample joins it
            # (a spike must not mask itself), then publish
            prev_mean = g_wall.window_mean()
            prev_count = len(g_wall._ring)
            g_wall.set(wall_ms)
            self._g(f"{prefix}/steps_per_s").set(1.0 / wall)
            self._check_spike(prefix, wall_ms, prev_mean, prev_count)
            if self._cost:
                from deepspeed_tpu_torch.profiling.flops_profiler import derive_step_stats

                stats = derive_step_stats(self._cost, wall, backend=self.device_name)
                if stats["flops_per_step"] and stats["mfu"] is not None:
                    self._g("mfu").set(stats["mfu"])
                if stats["hbm_bytes_per_step"]:
                    self._g("hbm_gbps").set(stats["hbm_gbps"])
        self._c(f"{prefix}/steps").inc(count)

    def _check_spike(self, prefix: str, wall_ms: float,
                     prev_mean: Optional[float], prev_count: int) -> None:
        """Runtime anomaly watch (regression.py): a step wall far above
        its own recent window becomes a structured event — counter,
        Perfetto instant, and a (rate-limited) log line."""
        from deepspeed_tpu_torch.telemetry.regression import check_step_spike

        cfg = self.config
        event = check_step_spike(
            wall_ms, prev_mean, prev_count,
            spike_factor=float(getattr(cfg, "spike_factor", 2.5) or 2.5),
            min_window=int(getattr(cfg, "spike_min_window", 8) or 8),
        )
        if event is None:
            return
        self._spikes += 1
        self._c(f"{prefix}/anomaly/step_spikes").inc()
        if self.tracer.enabled:
            self.tracer.add_instant("step_wall_spike", "anomaly", args=event)
        if self._spikes <= 3 or self._spikes % 32 == 0:
            # a sustained slowdown flags every step until the window
            # catches up; don't let the log become the second anomaly
            logger.warning(
                f"telemetry[{self.label}]: step wall spike — "
                f"{event['wall_ms']:.1f}ms vs window mean "
                f"{event['window_mean_ms']:.1f}ms ({event['factor']}x)"
            )

    # -- engine progress events ---------------------------------------------
    def publish_train_progress(self, step: int, samples: int, loss: Optional[float],
                               lr: float, loss_scale: float) -> None:
        """The reference engine's loss/lr/loss-scale event set, routed
        through the registry; the exact ``Train/Samples/*`` tags are
        forwarded to the TensorBoard monitor unchanged.  ``loss`` is None
        on the default path (the engine reads it off the card only when a
        monitor, a sink or ``wall_clock_breakdown`` is armed)."""
        if self.registry.enabled:
            self.registry.set_step(step)
            self.gauge("train/lr").set(lr)
            self.gauge("train/loss_scale").set(loss_scale)
            self.gauge("train/samples").set(samples)
            if loss is not None:
                self.gauge("train/loss").set(loss)
        if self.monitor_enabled:
            events = [("Train/Samples/lr", lr), ("Train/Samples/loss_scale", loss_scale)]
            if loss is not None:
                events.append(("Train/Samples/train_loss", loss))
            self.monitor.write_events(events, samples)
            self.monitor.flush()

    def set_comm(self, summary: Dict[str, Any]) -> None:
        """The comm layer's resolved strategy + per-step byte model
        (static per engine)."""
        if not self.registry.enabled:
            return
        self.gauge("comm/bytes_per_step",
                   strategy=summary.get("strategy", "?")).set(
            summary.get("grad_exchange_bytes", 0)
        )

    # -- summaries for records -----------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Compact per-engine roll-up: the live MFU gauge, the counted
        step's FLOPs/bytes, and the snapshot digest."""
        from deepspeed_tpu_torch.profiling.flops_profiler import cost_bytes

        mfu = self.registry.gauge("mfu", engine=self.label)
        out = {
            "mfu": None if mfu.value is None else round(mfu.value, 4),
            "flops_per_step": self._cost.get("flops"),
            "hbm_bytes_per_step": cost_bytes(self._cost) or None,
            "telemetry": self.digest(),
        }
        if self._attribution is not None:
            out["attribution_top"] = [
                {"bucket": b, "time_share_pct": s}
                for b, s in self._attribution.top_buckets(3)
            ]
        return out

    def digest(self) -> Dict[str, Any]:
        """Content digest of the current compact snapshot."""
        compact = self.registry.snapshot_compact()
        payload = json.dumps(compact, sort_keys=True).encode()
        return {
            "metrics": len(compact),
            "sha1": hashlib.sha1(payload).hexdigest()[:12],
        }

    # -- torch.profiler window capture ----------------------------------------
    def capture_profile(self, reason: str = "on-demand",
                        logdir: Optional[str] = None,
                        millis: Optional[int] = None) -> bool:
        """A ``torch.profiler`` window (CPU and CUDA activities) opened now
        and closed by the first :meth:`poll_profile` (every published
        step) after ``millis`` — the caller's loop keeps running, so the
        window holds real steps.  Its Chrome trace goes to
        ``<logdir>/profile_<label>_<pid>.json``.  One shot per manager;
        refused (counted and logged) while another profiler records in
        this process.  Returns whether a window opened."""
        cfg = self.config
        logdir = logdir or (getattr(cfg, "profiler_dir", "") or None)
        if logdir is None:
            return False
        from deepspeed_tpu_torch.telemetry.attribution import profiler_active

        with self._lock:
            if self._profiler_fired:
                return False
            if profiler_active():
                if self.registry.enabled:
                    self.counter("profiler_refusals").inc()
                logger.warning(f"telemetry: profiler window ({reason}) refused: another "
                               "torch.profiler is recording")
                return False
            self._profiler_fired = True
        millis = int(millis or getattr(cfg, "profiler_capture_ms", 2000))
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — profiling is best-effort
            logger.warning(f"telemetry: torch.profiler window failed to start: {e!r}")
            return False
        self._profile = (prof, time.monotonic() + millis / 1e3, logdir, reason)
        logger.warning(f"telemetry: torch.profiler window started ({reason}); {millis}ms -> {logdir}")
        if self.registry.enabled:
            self.counter("profiler_captures").inc()
        if self.tracer.enabled:
            self.tracer.add_instant("profiler_capture", "telemetry",
                                    args={"reason": reason, "millis": millis})
        return True

    def poll_profile(self, force: bool = False) -> Optional[str]:
        """Close an open profiler window whose time is up (or now, with
        ``force``) and write its trace; returns the path when it wrote."""
        window = self._profile
        if window is None:
            return None
        prof, deadline, logdir, _ = window
        if not force and time.monotonic() < deadline:
            return None
        self._profile = None
        try:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(logdir, f"profile_{self.label}_{os.getpid()}.json")
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001
            logger.warning(f"telemetry: torch.profiler window failed to close: {e!r}")
            return None
        logger.warning(f"telemetry: torch.profiler window finished -> {path}")
        return path

    def check_slo(self, ttft_ms: float) -> None:
        """Serving hook: one profiler window on the first TTFT SLO
        breach (``telemetry.slo_ttft_breach_ms``)."""
        threshold = float(getattr(self.config, "slo_ttft_breach_ms", 0.0) or 0.0)
        if threshold <= 0 or ttft_ms <= threshold:
            return
        if self.registry.enabled:
            self.counter("serving/slo_breaches").inc()
        if self.tracer.enabled:
            self.tracer.add_instant(
                "slo_breach", "serving",
                args={"ttft_ms": round(ttft_ms, 3), "threshold_ms": threshold},
            )
        self.capture_profile(reason=f"TTFT {ttft_ms:.0f}ms > SLO {threshold:.0f}ms")
