"""Where a training step spends its time on the card.

    python -m deepspeed_tpu_torch.tools.profile_training [--steps 2] [--trace out.json]

Builds ``initialize()`` for GPT-2 124M in bf16 over f32 masters (random
weights from ``--seed``), micro-batch 8, gradient accumulation 2, T 1024,
AdamW with clipping 1.0 (the ``train_bf16`` main path of
``chip_smoke.py``), runs two warm-up steps, then ``--steps`` steps of one
fixed batch under ``torch.profiler`` with CPU and CUDA activities.  Prints
one JSON line: the window, the device-busy time (the union of the
kernels' intervals) and the idle share, the device time by kernel class
(the port's kernels, GEMMs, everything else) and the top device kernels
and host ops.  Needs a CUDA card; it raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from deepspeed_tpu_torch.tools.profile_serving import _union_us

# kernel-name patterns of each class, first match wins
KERNEL_CLASSES = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_kernel",)),
    ("fused_adam", ("fused_adam_kernel",)),
    # cuBLAS on Hopper names most of its GEMM kernels nvjet_*
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, pats in KERNEL_CLASSES:
        if any(p in low for p in pats):
            return cls
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_training measures the card; torch.cuda.is_available() is False")

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.PRESETS["gpt2"]
    mb, gas, T = 8, 2, 1024
    model_fn, init_fn, _ = gpt2.make_model(cfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=args.seed),
        config={"train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
                "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                          "weight_decay": 0.1}}})
    batch = {"input_ids": np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (mb * gas, T), dtype=np.int32)}
    for _ in range(2):  # warm-up: kernel build and load, allocator
        float(engine.train_batch(batch))
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            float(engine.train_batch(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    window = [(e.time_range.start, e.time_range.end) for e in events]
    span_us = max(e for _, e in window) - min(s for s, _ in window)
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kern)
    by_kernel = defaultdict(lambda: [0, 0.0])
    by_class = defaultdict(lambda: [0, 0.0])
    for e in kern:
        us = e.time_range.elapsed_us()
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += us
        by_class[kernel_class(e.name)][0] += 1
        by_class[kernel_class(e.name)][1] += us
    host_self = defaultdict(float)
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CPU:
            host_self[a.key] += a.self_cpu_time_total
    steps = args.steps
    out = {
        "profile": "train_step", "model": "gpt2", "dtype": "bf16", "micro_batch": mb, "gas": gas,
        "T": T, "steps": steps, "wall_s": wall, "step_ms": wall / steps * 1e3,
        "tokens_per_s": mb * gas * T * steps / wall,
        # no kernel events means the profiler did not trace the card:
        # the device numbers are then not measured
        "window_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3 if kern else None,
        "device_idle_share": 1.0 - busy_us / span_us if kern else None,
        "kernel_events_per_step": len(kern) / steps,
        "device_ms_per_step_by_class": {
            cls: {"launches": n / steps, "ms": us / 1e3 / steps} for cls, (n, us) in
            sorted(by_class.items(), key=lambda kv: -kv[1][1])},
        "top_kernels_ms_per_step": sorted(
            ([name[:80], n / steps, us / 1e3 / steps] for name, (n, us) in by_kernel.items()),
            key=lambda r: -r[2])[:15],
        "top_host_self_ms_per_step": sorted(
            ([k, us / 1e3 / steps] for k, us in host_self.items()), key=lambda r: -r[1])[:12],
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
    }
    print(json.dumps(out), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return out


if __name__ == "__main__":
    main()
