"""Where a serving drain spends its time on the card.

    python -m deepspeed_tpu_torch.tools.profile_serving [--dtype bf16] [--paged] [--trace out.json]

Builds ``init_serving`` for GPT-2 124M (random weights from ``--seed``,
8 slots, 64-token prefill chunks), warms it up, then drains 16 requests
(64..384-token prompts, 16..48 new tokens, the mix of ``chip_smoke.py``)
under ``torch.profiler`` with CPU and CUDA activities.  With ``--paged``
the engine serves through the paged pool (``page_len`` 128) and drains
:func:`paged_request_mix` instead: shared-prefix traffic and a 3-turn
session.  Prints one JSON line: the drain's wall time, the device-busy
time (the union of the kernels' intervals) and the idle share of the
window, the serving engine's host phase split, and the top device
kernels and host ops.  Needs a CUDA card; it raises without one.
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


def paged_request_mix(seed: int, n: int = 16):
    """Prefix-heavy traffic for the paged pool: ``n`` (prompt,
    max_new_tokens) pairs that share one 200-token system prompt, each
    with a 32..160-token tail and 16..48 new tokens, and one 3-turn chat
    session ``(first prompt, [tail of turn 2, tail of turn 3],
    max_new_tokens)``.  200 tokens is neither a 64-token chunk nor a
    128-token page multiple, so hits floor to 192 and the shared, partly
    filled second page is copied on write."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, 50257, 200, dtype=np.int32)
    reqs = [
        (np.concatenate([shared, rng.integers(1, 50257, int(rng.integers(32, 161)), dtype=np.int32)]),
         int(rng.integers(16, 49)))
        for _ in range(n)
    ]
    session = (rng.integers(1, 50257, 96, dtype=np.int32),
               [rng.integers(1, 50257, 24, dtype=np.int32) for _ in range(2)], 24)
    return reqs, session


def drain_paged_mix(srv, mix, session_id: str = "chat-1"):
    """Serve :func:`paged_request_mix` on ``srv``: ten requests, two
    steps, the rest (slots churn mid-decode), a drain; then the session's
    three turns, each prompt the previous turn's tokens plus its tail.
    Returns (the requests in order, the three turns' requests)."""
    reqs, (first, tails, n_new) = mix
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs[:10]]
    srv.step()
    srv.step()
    rids += [srv.submit(p, max_new_tokens=n) for p, n in reqs[10:]]
    res = srv.drain()
    done = [res[r] for r in rids]
    turns, prompt = [], first
    for tail in [None, *tails]:
        if tail is not None:
            prompt = np.concatenate([turns[-1].tokens(), tail])
        rid = srv.submit(prompt, max_new_tokens=n_new, session_id=session_id)
        turns.append(srv.drain()[rid])
    return done, turns


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
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged pool (page_len 128) on paged_request_mix")
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_serving measures the card; torch.cuda.is_available() is False")

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    params = gpt2.init_params(gpt2.PRESETS["gpt2"], seed=args.seed)
    serving = {"num_slots": 8, "prefill_chunk": 64}
    if args.paged:
        serving["kvcache"] = {"enabled": True, "page_len": 128}
    srv = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=dtype, serving=serving)
    reqs = request_mix(args.seed)
    # warm-up: kernel build and load, allocator (prompts the paged mix does
    # not share, so the profiled drain starts with a cold prefix index)
    for p, n in reqs[:2]:
        srv.submit(p, max_new_tokens=4)
    srv.drain()
    torch.cuda.synchronize()
    phase0 = dict(srv._phase_seconds)
    steps0 = (srv.decode_steps, srv.prefill_chunks)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if args.paged:
            done, turns = drain_paged_mix(srv, paged_request_mix(args.seed))
            done = done + turns
        else:
            for p, n in reqs:
                srv.submit(p, max_new_tokens=n)
            done = list(srv.drain().values())
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
    tokens = int(sum(len(r.generated) for r in done))
    out = {
        "profile": "serving_drain_paged" if args.paged else "serving_drain", "model": "gpt2",
        "dtype": args.dtype, "slots": 8,
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
        "kvcache": srv.stats().get("kvcache"),
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
