"""Where a serving drain spends its time on the card.

    python -m deepspeed_tpu_torch.tools.profile_serving [--dtype bf16] [--trace out.json]

Builds ``init_serving`` for GPT-2 124M (random weights from ``--seed``,
8 slots, 64-token prefill chunks), warms it up, then drains 16 requests
(64..384-token prompts, 16..48 new tokens, the mix of ``chip_smoke.py``)
under ``torch.profiler`` with CPU and CUDA activities.  Prints one JSON
line: the drain's wall time, the device-busy time (the union of the
kernels' intervals) and the idle share of the window, the serving
engine's host phase split, and the top device kernels and host ops.
Needs a CUDA card; it raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


def request_mix(seed: int, n: int = 16):
    """``n`` (prompt, max_new_tokens) pairs: prompts of 64..384 tokens
    drawn from the GPT-2 vocabulary, 16..48 new tokens each."""
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(1, 50257, int(rng.integers(64, 385)), dtype=np.int32),
         int(rng.integers(16, 49)))
        for _ in range(n)
    ]


def _union_us(intervals) -> float:
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serving measures the card; torch.cuda.is_available() is False")

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params = gpt2.init_params(gpt2.PRESETS["gpt2"], seed=args.seed)
    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", params=params, dtype=dtype, serving={"num_slots": 8, "prefill_chunk": 64})
    reqs = request_mix(args.seed)
    for p, n in reqs[:2]:  # warm-up: kernel build and load, allocator
        srv.submit(p, max_new_tokens=4)
    srv.drain()
    torch.cuda.synchronize()
    phase0 = dict(srv._phase_seconds)
    steps0 = (srv.decode_steps, srv.prefill_chunks)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for p, n in reqs:
            srv.submit(p, max_new_tokens=n)
        done = srv.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    window = [(e.time_range.start, e.time_range.end) for e in events]
    span_us = max(e for _, e in window) - min(s for s, _ in window)
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in kern)
    by_kernel = defaultdict(lambda: [0, 0.0])
    for e in kern:
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += e.time_range.elapsed_us()
    host_self = defaultdict(float)
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CPU:
            host_self[a.key] += a.self_cpu_time_total
    tokens = int(sum(len(r.generated) for r in done.values()))
    out = {
        "profile": "serving_drain", "model": "gpt2", "dtype": args.dtype, "slots": 8,
        "chunk": 64, "requests": len(done), "tokens": tokens, "wall_s": wall,
        # no kernel events means the profiler did not trace the card:
        # the device numbers are then not measured
        "window_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3 if kern else None,
        "device_idle_share": 1.0 - busy_us / span_us if kern else None,
        "kernel_events": len(kern), "host_events": len(host),
        "decode_steps": srv.decode_steps - steps0[0],
        "prefill_chunks": srv.prefill_chunks - steps0[1],
        "host_phase_s": {k: srv._phase_seconds[k] - phase0[k] for k in phase0},
        "top_kernels_ms": sorted(
            ([name[:80], n, us / 1e3] for name, (n, us) in by_kernel.items()),
            key=lambda r: -r[2])[:12],
        "top_host_self_ms": sorted(
            ([k, us / 1e3] for k, us in host_self.items()), key=lambda r: -r[1])[:15],
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
