"""FLOPs profiler (counterpart of ``deepspeed_tpu/profiling/flops_profiler.py``).

The JAX package reads a compiled step's cost from XLA's
``cost_analysis()``.  Eager PyTorch has no compiled step: the cost comes
from the telemetry's counted step (``telemetry/attribution.py``: every
aten op's FLOPs and bytes from its shapes, and each hand kernel's own
formula), which the engine records once, on its first step.

* :func:`get_model_profile` counts one call of a model;
* :class:`FlopsProfiler` (the ``flops_profiler`` config block) times the
  engine's step ``profile_step`` with CUDA events around it and reports
  FLOPs, bytes, achieved FLOP/s and MFU against the card's peak;
* :data:`PEAKS` holds the cards' peaks, keyed by
  ``torch.cuda.get_device_name()``: a card missing from the table gets no
  MFU and no roofline (logged once), never another card's peak.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from deepspeed_tpu_torch.utils.logging import log_dist, logger

# dense bf16 FLOP/s and memory bytes/s per device name.  The H100 SXM5
# (80 GB HBM3): 989.4 TFLOPS dense BF16 and 3.35 TB/s, NVIDIA's "H100
# Tensor Core GPU" datasheet.  "cpu" is a nominal row (0.5 TFLOP/s,
# 100 GB/s, the JAX package's) so host runs and tests produce small, sane
# MFU numbers; it measures nothing.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
    "cpu": (0.5e12, 100e9),
}

_unknown_logged: set = set()


def device_name(device=None) -> str:
    """The peak table's key for ``device`` (default: the current card if
    torch sees one, else ``cpu``)."""
    import torch

    if device is None:
        return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def _peak(name: Optional[str], idx: int) -> Optional[float]:
    name = name or device_name()
    row = PEAKS.get(name)
    if row is None:
        if name not in _unknown_logged:
            _unknown_logged.add(name)
            logger.warning(f"flops profiler: no peak rates for device {name!r}; MFU and "
                           "rooflines are not published for it")
        return None
    return row[idx]


def peak_flops(backend: Optional[str] = None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of one device (None for a device missing
    from :data:`PEAKS`)."""
    return _peak(backend, 0)


def peak_hbm_bytes_per_s(backend: Optional[str] = None) -> Optional[float]:
    """Peak memory bytes/s of one device (None when unknown)."""
    return _peak(backend, 1)


def cost_bytes(cost: Optional[Dict[str, float]]) -> float:
    """Bytes from a cost dict (``bytes accessed``, the key the JAX
    package's ``cost_analysis()`` dicts use)."""
    cost = cost or {}
    return float(cost.get("bytes accessed", cost.get("bytes_accessed", 0.0)))


def derive_step_stats(cost: Optional[Dict[str, float]], wall_s: float,
                      backend: Optional[str] = None) -> Dict[str, Optional[float]]:
    """The one MFU / bytes-rate derivation (the profiler, the engine's
    gauges): a counted step's FLOPs and bytes over a measured step wall,
    against one device's peak.  ``mfu`` is None for a device without
    peaks."""
    cost = cost or {}
    flops = float(cost.get("flops", 0.0))
    hbm = cost_bytes(cost)
    peak = peak_flops(backend)
    ok = wall_s is not None and wall_s > 0
    achieved = flops / wall_s if ok else float("nan")
    return {
        "flops_per_step": flops,
        "hbm_bytes_per_step": hbm,
        "achieved_flops": achieved,
        "mfu": achieved / peak if peak else None,
        "hbm_gbps": hbm / wall_s / 1e9 if ok else float("nan"),
    }


def _fmt(n: float, unit: str = "") -> str:
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "K")):
        if abs(n) >= scale:
            return f"{n / scale:.2f} {suffix}{unit}"
    return f"{n:.2f} {unit}"


def _num_params(tree: Any) -> int:
    from deepspeed_tpu_torch.runtime.engine import tree_flatten

    leaves, _ = tree_flatten(tree)
    total = 0
    for x in leaves:
        n = 1
        for s in getattr(x, "shape", ()):
            n *= int(s)
        total += n
    return total


def get_model_profile(model_fn: Callable, args: Tuple = (), kwargs: Optional[dict] = None,
                      print_profile: bool = True, detailed: bool = True, warm_up: int = 1,
                      as_string: bool = False, params: Any = None):
    """Reference ``get_model_profile``: ``(flops, macs, params)`` of one
    call ``model_fn(*args, **kwargs)``, counted (it runs).  MACs are
    flops / 2."""
    from deepspeed_tpu_torch.telemetry.attribution import counting

    kwargs = kwargs or {}
    with counting("model") as count:
        model_fn(*args, **kwargs)
    attr = count.attribution()
    flops = attr.total_flops()
    macs = flops / 2.0
    n_params = _num_params(params) if params is not None else _num_params(args[0]) if args else 0
    if print_profile:
        logger.info(
            f"model profile: flops={_fmt(flops, 'FLOPs')} macs={_fmt(macs, 'MACs')} "
            f"params={_fmt(n_params)} bytes={_fmt(attr.total_bytes(), 'B')}"
        )
    if as_string:
        return _fmt(flops, "FLOPs"), _fmt(macs, "MACs"), _fmt(n_params)
    return flops, macs, n_params


class FlopsProfiler:
    """Engine-attached profiler (reference ``FlopsProfiler`` :11): the
    engine calls ``start_step`` / ``end_step`` around each step; at
    ``profile_step`` the step is timed (CUDA events around it on the card,
    read once at its end) and its counted cost reported."""

    def __init__(self, config, engine=None):
        self.cfg = config
        self.engine = engine
        self._t0: Any = None
        self.results: Dict[str, Any] = {}

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.cfg, "enabled", False))

    def _device(self):
        return getattr(self.engine, "device", None)

    def _cuda(self) -> bool:
        dev = self._device()
        return dev is not None and getattr(dev, "type", "") == "cuda"

    def start_step(self, step: int) -> None:
        if not (self.enabled and step == self.cfg.profile_step):
            return
        if self._cuda():
            import torch

            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def end_step(self, step: int, cost: Optional[Dict[str, float]] = None) -> None:
        """At ``profile_step``: the latency (the end event waited for: one
        wait, on this step only), the counted cost's FLOPs and bytes over
        it, into ``self.results`` and, with the registry armed, the
        ``profile/*`` gauges."""
        if not (self.enabled and step == self.cfg.profile_step) or self._t0 is None:
            return
        if self._cuda():
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            elapsed = self._t0.elapsed_time(end) / 1e3
        else:
            elapsed = time.perf_counter() - self._t0
        name = device_name(self._device())
        stats = derive_step_stats(cost, elapsed, backend=name)
        self.results = {"step": step, "latency_s": elapsed, **stats}
        params = _num_params(self.engine.params) if self.engine is not None else 0
        self.results["params"] = params
        from deepspeed_tpu_torch.telemetry import get_registry

        reg = get_registry()
        if reg.enabled:
            for key in ("flops_per_step", "hbm_bytes_per_step", "mfu", "hbm_gbps"):
                v = stats[key]
                if v is not None and v == v and abs(v) != float("inf"):
                    reg.gauge(f"profile/{key}").set(v)
        mfu = stats["mfu"]
        log_dist(
            f"flops profiler @ step {step}: params={_fmt(params)} "
            f"flops/step={_fmt(stats['flops_per_step'], 'FLOPs')} "
            f"hbm={_fmt(stats['hbm_bytes_per_step'], 'B')} "
            f"({stats['hbm_gbps']:.1f} GB/s) latency={elapsed * 1e3:.1f}ms "
            f"achieved={_fmt(stats['achieved_flops'], 'FLOPS')} "
            f"MFU={'n/a' if mfu is None else f'{100 * mfu:.1f}%'}"
        )


def see_memory_usage(message: str = "", force: bool = True) -> Dict[str, float]:
    """Reference ``see_memory_usage``: the card's allocated and peak bytes
    (``torch.cuda`` counters) and the host's peak RSS."""
    import resource

    import torch

    out: Dict[str, float] = {}
    if torch.cuda.is_available():
        out["0/bytes_in_use"] = float(torch.cuda.memory_allocated())
        out["0/peak_bytes_in_use"] = float(torch.cuda.max_memory_allocated())
    # ru_maxrss is KB on Linux — peak, not current
    out["host/peak_rss_gb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    logger.info(f"memory usage {message}: device={_fmt(out.get('0/bytes_in_use', 0.0), 'B')} "
                f"host_peak_rss={out['host/peak_rss_gb']:.1f}GB")
    return out
