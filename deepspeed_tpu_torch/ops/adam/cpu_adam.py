"""Host (CPU) Adam — the ZeRO-Offload optimizer (counterpart of
``deepspeed_tpu/ops/adam/cpu_adam.py``).

The update runs in ``csrc/host/cpu_adam.cpp`` (OpenMP over flat f32
buffers, vectorized by ``-O3 -march=native``), built with ``g++`` at first
use (``ops/op_builder.py``); a failed build raises.  Buffers are
contiguous f32 CPU tensors — on the card's host, pinned, so the same bytes
are the source and target of the device copies.

Every call passes its OpenMP thread count: ``num_threads`` (default: the
CPUs this process may run on), and one thread for a buffer under
``_MIN_PER_THREAD`` elements per thread, so small leaves do not wake a
team.  Each element is computed alone, so the count never changes a bit
of the result.

:func:`fp32_to_bf16` is the kernel's round-to-nearest-even cast of the
updated masters into a bf16 buffer for the copy back to the card.

The plain version of the update is
``ops/kernels/fused_update.py::adam_update_reference``.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch

_P, _L, _F, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
_MIN_PER_THREAD = 1 << 15

_counts: Dict[str, int] = {"ds_cpu_adam_step": 0, "ds_fp32_to_bf16": 0}


def counts() -> Dict[str, int]:
    """Calls of each host entry point since :func:`reset_counts`."""
    return dict(_counts)


def reset_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def default_threads() -> int:
    return len(os.sched_getaffinity(0))


def _lib() -> ctypes.CDLL:
    from deepspeed_tpu_torch.ops.op_builder import load_native

    lib = load_native("ds_cpu_adam", ["cpu_adam.cpp"])
    lib.ds_cpu_adam_step.argtypes = [_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _L, _I, _I]
    lib.ds_cpu_adam_step.restype = None
    lib.ds_fp32_to_bf16.argtypes = [_P, _P, _L, _I]
    lib.ds_fp32_to_bf16.restype = None
    return lib


def _threads(n: int, num_threads: Optional[int]) -> int:
    want = default_threads() if num_threads is None else int(num_threads)
    return max(1, min(want, n // _MIN_PER_THREAD))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, n: int) -> None:
    if t.device.type != "cpu" or t.dtype != dtype or not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"cpu_adam: {name} must be a contiguous {dtype} CPU tensor of {n} "
                         f"elements, got {t.dtype} {tuple(t.shape)} on {t.device}")


class DeepSpeedCPUAdam:
    """Flat-buffer host Adam (the reference's ``DeepSpeedCPUAdam``).

    ``step(params, grads, exp_avg, exp_avg_sq, step_count, lr=None)``
    updates ``params`` and the moments **in place**."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 num_threads: Optional[int] = None):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.num_threads = num_threads
        self._lib = _lib()

    def step(self, params: torch.Tensor, grads: torch.Tensor, exp_avg: torch.Tensor,
             exp_avg_sq: torch.Tensor, step_count: int, lr: Optional[float] = None) -> None:
        n = params.numel()
        for name, t in (("params", params), ("grads", grads), ("exp_avg", exp_avg),
                        ("exp_avg_sq", exp_avg_sq)):
            _check(name, t, torch.float32, n)
        b1, b2 = self.betas
        self._lib.ds_cpu_adam_step(
            params.data_ptr(), grads.data_ptr(), exp_avg.data_ptr(), exp_avg_sq.data_ptr(), n,
            self.lr if lr is None else float(lr), b1, b2, self.eps, self.weight_decay,
            int(step_count), int(bool(self.adamw_mode)), _threads(n, self.num_threads))
        _counts["ds_cpu_adam_step"] += 1


def fp32_to_bf16(src: torch.Tensor, out: torch.Tensor, num_threads: Optional[int] = None) -> torch.Tensor:
    """``out`` (bf16) = ``src`` (f32) rounded to nearest even, by the host
    kernel; both contiguous CPU tensors of one size."""
    n = src.numel()
    _check("src", src, torch.float32, n)
    _check("out", out, torch.bfloat16, n)
    _lib().ds_fp32_to_bf16(src.data_ptr(), out.data_ptr(), n, _threads(n, num_threads))
    _counts["ds_fp32_to_bf16"] += 1
    return out
