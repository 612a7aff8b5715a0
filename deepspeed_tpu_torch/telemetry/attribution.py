"""Per-op cost attribution: which kernel family owns the step's cost
(counterpart of ``deepspeed_tpu/telemetry/attribution.py``, the torch
analog of its HLO walk).

The JAX package walks a compiled executable's HLO; eager PyTorch has no
executable, so the port counts one step as it runs, and times another:

* **Static part** (:func:`counting`): one step runs under a
  ``TorchDispatchMode`` that sees every aten op the step issues, forward
  and backward.  Each op's FLOPs and bytes are worked out from its
  shapes (matmuls ``2 m k n``; pointwise ops one FLOP per output element;
  reductions one per input element; views and fresh allocations move
  nothing; every other op reads its inputs and writes its outputs once)
  and the op goes to a bucket by the port module that issued it (the
  innermost ``deepspeed_tpu_torch`` frame on the Python stack: attention
  ops, the optimizer, the comm layer, the quantizer), else by the op
  (matmuls), else ``layernorm/other``.  A backward op that autograd's
  engine runs with no port frame on its stack takes the bucket its
  forward's module marked on the autograd node (a ``TorchFunctionMode``
  marks each call's new nodes).  The hand-written kernels are
  called through ``ctypes`` and are invisible to a dispatch mode: each
  wrapper hands the analytic FLOPs and bytes of its launch to
  ``ops.kernels.count_launch``, with the formulas of the kernels' bounds
  in ``PERF.md``.  Work that activation checkpointing recomputes in the
  backward (an op whose stack runs through ``torch.utils.checkpoint``'s
  recompute) is kept apart under ``meta["recompute"]``: the buckets hold
  the step's model work, each op once, as the JAX package's ``6N`` count
  and MFU read it.
* **Timed part** (:func:`timing`): device milliseconds per bucket from a
  ``torch.profiler`` window's kernel events, with the counted step's
  membership: the window runs the same modes, which open a profiler range
  naming each aten op's bucket around the op (:data:`RANGE`), and a
  kernel takes the bucket of the range around the op that launched it.
  A hand kernel, launched outside any aten op, takes its bucket by its
  name (:data:`KERNEL_CLASSES`), as its counted cost does; a kernel
  linked to no op falls back to its name too (cuBLAS GEMMs to
  ``matmul``, NCCL to ``comm-collective``, the rest to
  ``layernorm/other``).  The buckets' milliseconds therefore sum to the
  window's kernel time; the window's busy time is the union of the
  kernels' intervals (:func:`union_us`).

There is no calibration against a compiler's cost model (XLA's
``cost_analysis`` has no torch counterpart): ``unattributed_*`` are 0,
and the ``matmul`` bucket is held to :func:`analytic_matmul_flops` instead.

Rooflines use the card's peaks, keyed by ``torch.cuda.get_device_name()``
(``profiling/flops_profiler.py`` ``PEAKS``); a card missing from the
table gets no roofline and no MFU, and says so once in the log.

Publishing surfaces: registry gauges (``attribution/<bucket>/*``),
Perfetto counter tracks, and records for tools.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

BUCKETS = (
    "attention",
    "matmul",
    "optimizer-update",
    "comm-collective",
    "kv-dequant",
    "layernorm/other",
)
OTHER = "layernorm/other"

# ---------------------------------------------------------------------------
# kernel names (torch.profiler) -> classes -> buckets
# ---------------------------------------------------------------------------

# kernel-name patterns of each class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_tc_kernel")),
    ("flash_bwd", ("flash_bwd_kernel", "flash_bwd_tc_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel")),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_tc_kernel")),
    ("splash_fwd", ("splash_fwd_kernel", "splash_fwd_tc_kernel")),
    ("splash_bwd_dq", ("splash_dq_kernel", "splash_dq_tc_kernel")),
    ("splash_bwd_dkv", ("splash_dkv_kernel", "splash_dkv_sum_kernel", "splash_dkv_tc_kernel",
                        "splash_dkv_tc_sum_kernel")),
    ("fused_adam", ("fused_adam_kernel",)),
    ("fused_lamb_dir", ("lamb_dir_kernel",)),
    ("fused_lamb_apply", ("lamb_apply_kernel",)),
    # cuBLAS on Hopper names most of its GEMM kernels nvjet_*
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
    ("flash_decode_paged", ("flash_decode_paged_kernel",)),
    # the split decode's second kernel combines the chunks of either decode
    ("flash_decode", ("flash_decode_kernel", "decode_combine_kernel")),
    ("nccl", ("nccl",)),
)

_CLASS_BUCKET = {
    "gemm": "matmul",
    "fused_adam": "optimizer-update",
    "fused_lamb_dir": "optimizer-update",
    "fused_lamb_apply": "optimizer-update",
    "nccl": "comm-collective",
}


# the classes of kernels an aten op launches (every other class is a hand
# kernel, called outside any aten op)
_LIBRARY_CLASSES = ("gemm", "nccl", "other")


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, pats in KERNEL_CLASSES:
        if any(p in low for p in pats):
            return cls
    return "other"


def class_bucket(cls: str) -> str:
    """The bucket of a kernel class (or of a hand kernel's name)."""
    if cls in _CLASS_BUCKET:
        return _CLASS_BUCKET[cls]
    if cls.startswith(("flash_", "splash_")):
        return "attention"
    return OTHER


def kernel_bucket(name: str) -> str:
    return class_bucket(kernel_class(name))


def union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


# ---------------------------------------------------------------------------
# the cost table
# ---------------------------------------------------------------------------

@dataclass
class BucketCost:
    flops: float = 0.0
    bytes: float = 0.0
    ops: int = 0
    # hand-kernel launches by kernel name (recomputed ones included)
    launches: Dict[str, int] = field(default_factory=dict)


def _peaks(backend: Optional[str]) -> Optional[Tuple[float, float]]:
    from deepspeed_tpu_torch.profiling.flops_profiler import peak_flops, peak_hbm_bytes_per_s

    pk_f, pk_b = peak_flops(backend), peak_hbm_bytes_per_s(backend)
    if pk_f is None or pk_b is None:
        return None
    return pk_f, pk_b


@dataclass
class Attribution:
    """Per-bucket cost table of one counted step (and, once timed, the
    device milliseconds of another)."""

    label: str
    buckets: Dict[str, BucketCost]
    module_flops: float
    module_bytes: float
    unattributed_flops: float = 0.0  # no compiler cost model to calibrate against
    unattributed_bytes: float = 0.0
    backend: Optional[str] = None  # the device name the peaks are keyed by
    meta: Dict[str, Any] = field(default_factory=dict)
    timing: Optional[Dict[str, Any]] = None  # set_timing()

    # -- derived views ------------------------------------------------------
    def total_flops(self) -> float:
        return sum(b.flops for b in self.buckets.values())

    def total_bytes(self) -> float:
        return sum(b.bytes for b in self.buckets.values())

    def launches(self, bucket: str) -> Dict[str, int]:
        return dict(self.buckets[bucket].launches)

    def set_timing(self, timing: Optional[Dict[str, Any]]) -> None:
        """Attach a :func:`timing` window's tables (per step)."""
        self.timing = timing

    def roofline(self, backend: Optional[str] = None,
                 wall_s: Optional[float] = None) -> List[Dict[str, Any]]:
        """Per-bucket roofline rows: arithmetic intensity, the bound verdict
        against the card's machine balance, the least time at peak and
        its share.  Timed, each row also carries its measured
        ``device_ms`` and ``pct_peak`` (the binding resource's use over
        the measured time); else, with a measured ``wall_s``, the JAX
        package's time-share estimate of ``pct_peak``.  Empty for a
        device with no peaks in the table."""
        backend = backend or self.backend
        peaks = _peaks(backend)
        if peaks is None:
            return []
        pk_f, pk_b = peaks
        balance = pk_f / pk_b  # flops/byte at the roofline ridge
        times = {name: max(b.flops / pk_f, b.bytes / pk_b) for name, b in self.buckets.items()}
        t_total = sum(times.values()) or 1.0
        dev_ms = (self.timing or {}).get("device_ms") or {}
        rows = []
        for name in BUCKETS:
            b = self.buckets.get(name)
            if b is None or (b.flops == 0 and b.bytes == 0):
                continue
            ai = b.flops / b.bytes if b.bytes else float("inf")
            bound = "compute" if ai >= balance else "memory"
            t = times[name]
            row = {
                "bucket": name, "flops": b.flops, "bytes": b.bytes, "ops": b.ops,
                "ai": round(ai, 3), "bound": bound,
                "min_time_ms": round(t * 1e3, 6),
                "min_time_share_pct": round(100.0 * t / t_total, 2),
            }
            peak_rate = pk_f if bound == "compute" else pk_b
            used = b.flops if bound == "compute" else b.bytes
            if name in dev_ms:
                row["device_ms"] = dev_ms[name]
                if dev_ms[name] > 0:
                    row["pct_peak"] = round(100.0 * used / (dev_ms[name] / 1e3 * peak_rate), 2)
            elif wall_s and wall_s > 0:
                est_t = (t / t_total) * wall_s
                row["pct_peak"] = round(100.0 * used / (est_t * peak_rate), 2)
            rows.append(row)
        rows.sort(key=lambda r: -r["min_time_share_pct"])
        return rows

    def verdict(self, bucket: str, backend: Optional[str] = None) -> Optional[str]:
        for row in self.roofline(backend):
            if row["bucket"] == bucket:
                return row["bound"]
        return None

    def top_buckets(self, n: int = 3, backend: Optional[str] = None) -> List[Tuple[str, float]]:
        return [(r["bucket"], r["min_time_share_pct"]) for r in self.roofline(backend)[:n]]

    # -- serialization ------------------------------------------------------
    def to_record(self, backend: Optional[str] = None) -> Dict[str, Any]:
        return {
            "label": self.label,
            "backend": backend or self.backend,
            "module_flops": self.module_flops,
            "module_bytes": self.module_bytes,
            "unattributed_flops": self.unattributed_flops,
            "unattributed_bytes": self.unattributed_bytes,
            "buckets": {n: {"flops": b.flops, "bytes": b.bytes, "ops": b.ops,
                            "launches": dict(b.launches)}
                        for n, b in self.buckets.items()},
            "roofline": self.roofline(backend),
            "timing": self.timing,
            **self.meta,
        }

    def format_table(self, backend: Optional[str] = None) -> str:
        dev_ms = (self.timing or {}).get("device_ms") or {}
        lines = [
            f"attribution [{self.label}] step: "
            f"{self.module_flops / 1e9:.3f} GFLOPs, "
            f"{self.module_bytes / 1e6:.1f} MB accessed",
            f"{'bucket':18s} {'GFLOPs':>10s} {'MB':>9s} {'device-ms':>10s}",
        ]
        for name in BUCKETS:
            b = self.buckets[name]
            if b.flops == 0 and b.bytes == 0 and name not in dev_ms:
                continue
            ms = dev_ms.get(name)
            lines.append(f"{name:18s} {b.flops / 1e9:10.4f} {b.bytes / 1e6:9.2f} "
                         f"{'-' if ms is None else f'{ms:.3f}':>10s}")
        return "\n".join(lines)

    # -- publishing ---------------------------------------------------------
    def publish(self, manager) -> None:
        """Registry gauges + Perfetto counter tracks through a
        :class:`~deepspeed_tpu_torch.telemetry.TelemetryManager` (one-shot:
        nothing here runs on the hot path)."""
        rows = self.roofline()
        if manager.registry.enabled:
            present = set()
            for r in rows:
                present.add(r["bucket"])
                g = lambda name: manager.gauge(name, bucket=r["bucket"])  # noqa: E731
                g("attribution/flops").set(r["flops"])
                g("attribution/bytes").set(r["bytes"])
                g("attribution/time_share_pct").set(r["min_time_share_pct"])
                if "device_ms" in r:
                    g("attribution/device_ms").set(r["device_ms"])
            # a new table that drops a bucket must not leave its old
            # gauges reporting forever: zero EXISTING handles for buckets
            # absent from it (never create handles just to zero them)
            for m in manager.registry.metrics():
                if (
                    m.kind == "gauge"
                    and m.name.startswith("attribution/")
                    and m.labels.get("engine") == manager.label
                    and m.labels.get("bucket") not in present
                    and m.value
                ):
                    m.set(0.0)
        tracer = getattr(manager, "tracer", None)
        if tracer is not None and tracer.enabled and rows:
            tracer.add_counter(
                f"attribution/{self.label}/time_share_pct",
                {r["bucket"]: r["min_time_share_pct"] for r in rows},
            )


def analytic_matmul_flops(n_params: int, tokens: int, n_devices: int = 1) -> float:
    """The ``6N`` analytic training count for the parameter matmuls
    (forward 2N + backward 4N per token), per device — what the
    ``matmul`` bucket of a full train step should show (attention-score
    math lives in the ``attention`` bucket)."""
    return 6.0 * float(n_params) * float(tokens) / max(1, int(n_devices))


# ---------------------------------------------------------------------------
# the static part: one counted step
# ---------------------------------------------------------------------------

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_SELF = os.path.dirname(os.path.abspath(__file__)) + os.sep
_CHECKPOINT = os.path.join("torch", "utils", "checkpoint.py")
# the port's modules whose ops belong to a bucket whatever the op
_MODULE_BUCKETS = (
    ("ops/attention/", "attention"),
    ("ops/kernels/flash_decode", "attention"),
    ("parallel/sequence", "attention"),
    ("ops/kernels/fused_update", "optimizer-update"),
    ("ops/adam/", "optimizer-update"),
    ("ops/lamb/", "optimizer-update"),
    ("runtime/fp16/onebit/", "optimizer-update"),
    ("comm/", "comm-collective"),
    ("ops/quantizer/", "kv-dequant"),
    ("runtime/quantize", "kv-dequant"),
    ("runtime/weight_quantizer", "kv-dequant"),
)
# the matmul family; under ``torch.inference_mode`` the mode sees the
# composite ``matmul`` / ``linear`` / ``einsum`` calls, not their mm
_MATMULS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "_scaled_mm", "mv", "addmv", "dot",
            "vdot", "matmul", "linear", "einsum"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "norm", "linalg_vector_norm", "var_mean",
    "var", "std", "logsumexp", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_layer_norm", "native_layer_norm_backward",
    "nll_loss_forward", "nll_loss_backward", "cumsum", "prod", "argmax", "argmin", "all", "any",
    "topk", "sort",
}
# allocations that touch no memory
_NO_TRAFFIC = ("empty", "new_empty", "_local_scalar_dense", "detach", "alias", "lift_fresh")


def _tensors(tree) -> List[Any]:
    import torch

    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _einsum_flops(args) -> Optional[float]:
    """``2 x`` the product of every index's size of a two-operand einsum
    without an ellipsis (None otherwise)."""
    eq, ops = args[0], args[1:]
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = ops[0]
    lhs = eq.replace(" ", "").split("->")[0].split(",")
    if "." in eq or len(lhs) != 2 or len(ops) != 2:
        return None
    sizes: Dict[str, int] = {}
    for letters, t in zip(lhs, ops):
        sizes.update(zip(letters, t.shape))
    n = 1
    for v in sizes.values():
        n *= int(v)
    return 2.0 * n


def _matmul_flops(name: str, args, outs) -> float:
    """``2 x`` the output's elements ``x`` the contracted length (the
    first matrix operand's last dim; an einsum by its indices)."""
    if name == "einsum":
        flops = _einsum_flops(args)
        if flops is not None:
            return flops
        args = args[1:] if len(args) > 2 else list(args[1])
    ts = [a for a in args if hasattr(a, "shape")]
    if name in ("addmm", "baddbmm", "addbmm", "addmv"):
        ts = ts[1:]
    if not ts or not outs or ts[0].dim() == 0:
        return 0.0
    k = ts[0].shape[-1]
    batch = ts[0].shape[0] if name == "addbmm" else 1
    return 2.0 * batch * max(1, outs[0].numel()) * k


def _op_cost(func, args, kwargs, out) -> Tuple[str, float, float]:
    """``(op name, FLOPs, bytes)`` of one aten op from its shapes."""
    import torch

    name = func._overloadpacket.__name__
    if func.is_view or name.startswith(_NO_TRAFFIC):
        return name, 0.0, 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    # a composite call that handed back its input or a view of it (``to``,
    # ``reshape``, ``contiguous`` that had nothing to do) moves nothing
    stores = {t.untyped_storage().data_ptr() for t in ins}
    if outs and all(t.untyped_storage().data_ptr() in stores for t in outs) \
            and name not in _MATMULS and torch.Tag.inplace_view not in func.tags \
            and not name.endswith("_"):
        return name, 0.0, 0.0
    seen, nbytes = set(), 0
    for t in ins:
        if id(t) not in seen:
            seen.add(id(t))
            nbytes += _nbytes(t)
    nbytes += sum(_nbytes(t) for t in outs)
    if name in _MATMULS:
        flops = _matmul_flops(name, args, outs)
    elif torch.Tag.pointwise in func.tags:
        flops = float(sum(t.numel() for t in outs))
    elif name in _REDUCTIONS and ins:
        flops = float(ins[0].numel())
    else:
        flops = 0.0
    return name, flops, float(nbytes)


def _origin(frame) -> Tuple[Optional[str], bool]:
    """The innermost port module on the stack above ``frame`` (its path
    under the package, telemetry excluded) and whether the stack runs
    through activation checkpointing's recompute."""
    module, recompute = None, False
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if module is None and fn.startswith(_PKG) and not fn.startswith(_SELF):
            module = fn[len(_PKG):].replace(os.sep, "/")
        if fn.endswith(_CHECKPOINT) and f.f_code.co_name in ("recompute_fn", "backward"):
            recompute = True
            break
        f = f.f_back
    return module, recompute


def _module_of(frame) -> Optional[str]:
    """The innermost port module on the stack above ``frame``."""
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PKG) and not fn.startswith(_SELF):
            return fn[len(_PKG):].replace(os.sep, "/")
        f = f.f_back
    return None


_TAG = "ds_attribution_bucket"


def _tag_graph(out, bucket: str) -> None:
    """Mark the autograd nodes a torch call created with its module's
    bucket ("" for none): every node reachable from its outputs not yet
    marked by an earlier call (a composite call's inner nodes too).  The
    backward's ops read the mark of the node they run for."""
    stack = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        meta = node.metadata
        if _TAG in meta:
            continue
        meta[_TAG] = bucket
        stack.extend(n for n, _ in node.next_functions)


def _node_bucket() -> Optional[str]:
    """The bucket marked on the autograd node whose backward is running,
    if any (None outside a backward, or unmarked)."""
    import torch

    current = getattr(torch._C, "_current_autograd_node", None)
    node = current() if current is not None else None
    if node is None:
        return None
    return node.metadata.get(_TAG) or None


def _module_bucket(module: Optional[str]) -> Optional[str]:
    if module is None:
        return None
    for prefix, bucket in _MODULE_BUCKETS:
        if module.startswith(prefix):
            return bucket
    return None


def _op_bucket(func, frame) -> Tuple[str, bool]:
    """An aten op's bucket and whether activation checkpointing's
    recompute issued it: the bucket of the port module that issued the op,
    else the mark on the autograd node whose backward runs it, else the
    op's own (matmuls, collectives), else ``layernorm/other``.  The counted
    step and the timed window both bucket by this."""
    module, recompute = _origin(frame)
    bucket = _module_bucket(module) or _node_bucket()
    if bucket is None:
        name = func._overloadpacket.__name__
        bucket = ("matmul" if name in _MATMULS
                  else "comm-collective" if func.namespace == "c10d" else OTHER)
    return bucket, recompute


class StepCount:
    """What one counted region issued, bucket by bucket (thread-safe: the
    backward's ops arrive on autograd's threads)."""

    def __init__(self, label: str):
        self.label = label
        self.buckets = {b: BucketCost() for b in BUCKETS}
        self.recompute = {b: BucketCost() for b in BUCKETS}
        self.ops_by_name: Dict[str, int] = collections.Counter()
        # the aten ops each bucket holds (recompute included), by name
        self.ops_by_bucket: Dict[str, Dict[str, int]] = {b: collections.Counter()
                                                         for b in BUCKETS}
        self._lock = threading.Lock()

    def add_op(self, func, args, kwargs, out, frame) -> None:
        name, flops, nbytes = _op_cost(func, args, kwargs, out)
        bucket, recompute = _op_bucket(func, frame)
        with self._lock:
            bc = (self.recompute if recompute else self.buckets)[bucket]
            bc.flops += flops
            bc.bytes += nbytes
            bc.ops += 1
            self.ops_by_name[name] += 1
            self.ops_by_bucket[bucket][name] += 1

    def add_kernel(self, name: str, variant: Optional[str], flops: float, nbytes: float,
                   frame) -> None:
        _, recompute = _origin(frame)
        bucket = class_bucket(name)
        with self._lock:
            self.buckets[bucket].launches[name] = self.buckets[bucket].launches.get(name, 0) + 1
            bc = (self.recompute if recompute else self.buckets)[bucket]
            bc.flops += flops
            bc.bytes += nbytes
            bc.ops += 1

    def attribution(self, backend: Optional[str] = None) -> Attribution:
        buckets = {n: BucketCost(b.flops, b.bytes, b.ops, dict(b.launches))
                   for n, b in self.buckets.items()}
        recompute = {n: {"flops": b.flops, "bytes": b.bytes, "ops": b.ops}
                     for n, b in self.recompute.items() if b.ops}
        return Attribution(
            label=self.label, buckets=buckets,
            module_flops=sum(b.flops for b in buckets.values()),
            module_bytes=sum(b.bytes for b in buckets.values()),
            backend=backend, meta={"recompute": recompute},
        )


def _function_mode_class():
    from torch.overrides import TorchFunctionMode

    class _MarkingMode(TorchFunctionMode):
        """Marks each torch call's new autograd nodes with the bucket of
        the port module that made the call, so a backward that runs in
        autograd's engine (no port frame on its stack) finds it."""

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            try:
                _tag_graph(out, _module_bucket(_module_of(sys._getframe(1))) or "")
            except Exception:  # noqa: BLE001 — marking must never change the step
                pass
            return out

    return _MarkingMode


def _dispatch_mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CountingMode(TorchDispatchMode):
        def __init__(self, count: StepCount):
            super().__init__()
            self.count = count

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            try:
                self.count.add_op(func, args, kwargs, out, sys._getframe(1))
            except Exception:  # noqa: BLE001 — counting must never change the step
                pass
            return out

    return _CountingMode


@contextmanager
def counting(label: str = "step", backend: Optional[str] = None):
    """Count everything the block issues (aten ops and hand-kernel
    launches) into a :class:`StepCount`; ``count.attribution(backend)``
    gives the table.  The block runs as it would without the count."""
    from deepspeed_tpu_torch.ops import kernels as _kernels

    count = StepCount(label)

    def sink(name, variant, flops, nbytes):
        count.add_kernel(name, variant, flops, nbytes, sys._getframe(2))

    prev = _kernels.set_cost_sink(sink)
    try:
        with _function_mode_class()(), _dispatch_mode_class()(count):
            yield count
    finally:
        _kernels.set_cost_sink(prev)


# ---------------------------------------------------------------------------
# the timed part: a torch.profiler window
# ---------------------------------------------------------------------------

# the profiler range around each aten op of a timed window names its bucket
RANGE = "ds_bucket::"


def _range_mode_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _RangeMode(TorchDispatchMode):
        """Opens a profiler range naming each aten op's bucket
        (:func:`_op_bucket`) around the op: the kernels the op launches
        link to it, and through it to the bucket."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            try:
                bucket = _op_bucket(func, sys._getframe(1))[0]
            except Exception:  # noqa: BLE001 — naming must never change the step
                return func(*args, **kwargs)
            with torch.profiler.record_function(RANGE + bucket):
                return func(*args, **kwargs)

    return _RangeMode


def _range_bucket(event) -> Optional[str]:
    """The bucket of the range an op event ran in: the innermost
    :data:`RANGE` range holding it (the event itself included), else the
    first one opened inside it (the profiler also records an op around
    the dispatch mode's handler, which holds the op's own range); None
    where there is neither."""
    up = event
    while up is not None:
        if up.name.startswith(RANGE):
            return up.name[len(RANGE):]
        up = up.cpu_parent
    stack = list(reversed(event.cpu_children))
    while stack:
        e = stack.pop()
        if e.name.startswith(RANGE):
            return e.name[len(RANGE):]
        stack.extend(reversed(e.cpu_children))
    return None

def profiler_active() -> bool:
    """Whether a ``torch.profiler`` / autograd profiler is recording in
    this process (one profiler at a time)."""
    import torch

    return bool(torch.autograd._profiler_enabled())


def _repeats_ancestor(op) -> bool:
    """Whether a host event's kernels are an enclosing event's: the
    profiler hands a kernel to every host event that shares its launch's
    correlation id, and its own events nested in the op (module loading,
    buffer requests) repeat the op's list."""
    mine = [(k.name, k.duration) for k in op.kernels]
    up = op.cpu_parent
    while up is not None:
        if up.kernels and [(k.name, k.duration) for k in up.kernels] == mine:
            return True
        up = up.cpu_parent
    return False


def bucket_times(events, steps: int = 1) -> Dict[str, Any]:
    """Device milliseconds per bucket (per step) from a profiler's events:
    a hand kernel to its bucket by name, every other kernel to the bucket
    of the range around the op that launched it (by name where it links
    to none).  ``kernels_ms`` is the kernels' summed durations, ``busy_ms``
    their union, ``window_ms`` the whole window's span; with no kernel
    event (the profiler did not trace the card) the device numbers are
    None: not measured.  ``ops_by_bucket`` names the aten ops each
    bucket's ranges held (the op each range was opened around);
    ``unranged_kernels`` counts the kernels that fell back to their name
    though an aten op launches their class."""
    import torch

    events = list(events)
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == cpu]
    ops_by_bucket: Dict[str, Dict[str, int]] = {b: collections.Counter() for b in BUCKETS}
    for e in host:
        if e.name.startswith(RANGE):
            for child in e.cpu_children:  # the op itself; nested ranges are its own
                if not child.name.startswith(RANGE):
                    ops_by_bucket[e.name[len(RANGE):]][child.name.split("::")[-1]] += 1
    # the card's kernels (a host range also shows on the card as a user
    # annotation spanning its kernels: not a kernel)
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith(RANGE)]
    span = [(e.time_range.start, e.time_range.end) for e in events]
    window_us = (max(e for _, e in span) - min(s for s, _ in span)) if span else 0.0
    if not kern:
        return {"device_ms": None, "kernel_events": None, "kernels_ms": None, "busy_ms": None,
                "window_ms": window_us / 1e3 / steps, "steps": steps,
                "launches_by_class": None, "ops_by_bucket": ops_by_bucket}
    device_ms = {b: 0.0 for b in BUCKETS}
    n_events = {b: 0 for b in BUCKETS}
    unranged = 0
    # each kernel under the host op that launched it (torch.profiler's own
    # association, ``FunctionEvent.kernels``); what no op holds goes by name
    left_us: Dict[str, float] = collections.Counter()
    left_n: Dict[str, int] = collections.Counter()
    for e in kern:
        left_us[e.name] += e.time_range.elapsed_us()
        left_n[e.name] += 1
    for op in host:
        if op.is_async or getattr(op, "is_legacy", False) or not op.kernels \
                or _repeats_ancestor(op):
            continue
        ranged = _range_bucket(op)
        for k in op.kernels:
            if k.name not in left_n:  # a range's annotation on the card
                continue
            cls = kernel_class(k.name)
            b = class_bucket(cls)
            if cls in _LIBRARY_CLASSES:
                unranged += ranged is None
                b = ranged or b
            device_ms[b] += k.duration / 1e3 / steps
            n_events[b] += 1
            left_us[k.name] -= k.duration
            left_n[k.name] -= 1
    for name, n in left_n.items():
        cls = kernel_class(name)
        device_ms[class_bucket(cls)] += left_us[name] / 1e3 / steps
        n_events[class_bucket(cls)] += n
        unranged += n if cls in _LIBRARY_CLASSES else 0
    by_class = collections.Counter(kernel_class(e.name) for e in kern)
    total = sum(e.time_range.elapsed_us() for e in kern)
    return {
        "device_ms": device_ms, "kernel_events": n_events,
        "kernels_ms": total / 1e3 / steps,
        "busy_ms": union_us((e.time_range.start, e.time_range.end) for e in kern) / 1e3 / steps,
        "window_ms": window_us / 1e3 / steps, "steps": steps,
        "launches_by_class": dict(by_class), "ops_by_bucket": ops_by_bucket,
        "unranged_kernels": unranged,
    }


class _Window:
    timing: Optional[Dict[str, Any]] = None
    refused: bool = False


@contextmanager
def timing(steps: int = 1):
    """A ``torch.profiler`` window (CPU and CUDA activities) around the
    block, which runs under the counting step's node marking and the
    range mode (each aten op in a range naming its bucket); afterwards
    ``window.timing`` holds :func:`bucket_times` over ``steps`` steps.
    Refused (``window.refused``, nothing recorded) while another profiler
    is active."""
    import torch

    win = _Window()
    if profiler_active():
        win.refused = True
        yield win
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with _function_mode_class()(), _range_mode_class()():
            yield win
    win.timing = bucket_times(prof.events(), steps=steps)


__all__ = [
    "BUCKETS", "OTHER", "KERNEL_CLASSES", "kernel_class", "class_bucket", "kernel_bucket",
    "union_us", "BucketCost", "Attribution", "StepCount", "counting", "timing",
    "profiler_active", "bucket_times", "analytic_matmul_flops", "RANGE",
]
