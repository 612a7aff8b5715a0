"""Where a serving drain spends its time on the card, on one card or
across the ranks of a tensor-parallel engine.

    python -m deepspeed_tpu_torch.tools.profile_serving [--dtype bf16] [--paged] [--trace out.json]
    python -m deepspeed_tpu_torch.tools.profile_serving --world N --mp M [--paged]
        [--preset gpt2] [--vocab 50304] [--layers L] [--init-on-device] [--device cuda|cpu]
        [--tokens-out f.json] [--tokens-ref f.json] [--profile]

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

With ``--world N`` it starts N ranks of ``tools/serve_worker.py`` under
the launcher environment (NCCL on cards, one card a rank; gloo with
``--device cpu``), builds ``init_serving(mp_size=M)`` for ``--preset``
(``--vocab`` replaces its vocabulary: GPT-2's 50257 does not divide over
``model``; ``--layers`` cuts its depth; ``--init-on-device`` draws the
weights on the card), drains
two warm-up requests, then the same mix without the profiler, and
prints one JSON line: decode tokens/s, TTFT p50/p99, peak GiB by rank,
the bytes counted by kind beside the inference byte model
(``InferenceEngine.comm_model``), and the served tokens' digest;
``--tokens-out`` writes rank 0's tokens, ``--tokens-ref`` counts the
requests whose tokens equal another run's (``mp_size`` 1's).
``--profile`` traces the drain on every rank under ``torch.profiler``
(device busy and idle share, top kernels and host ops), at the
profiler's cost: its numbers are not the unprofiled run's.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from deepspeed_tpu_torch.telemetry.attribution import union_us


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


def drain_request_mix(srv, reqs):
    """Serve :func:`request_mix` on ``srv``: ten requests, two steps, the
    rest (slots churn mid-decode), a drain.  Returns the requests in
    order."""
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs[:10]]
    srv.step()
    srv.step()
    rids += [srv.submit(p, max_new_tokens=n) for p, n in reqs[10:]]
    res = srv.drain()
    return [res[r] for r in rids]


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


def profile_summary(prof) -> dict:
    """A ``torch.profiler`` window: its span, the device-busy time (the
    union of the kernels' intervals) and idle share, and the top device
    kernels and host ops by self time.  No kernel events means the
    profiler did not trace the card: the device numbers are then None
    (not measured)."""
    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    window = [(e.time_range.start, e.time_range.end) for e in events]
    span_us = max(e for _, e in window) - min(s for s, _ in window)
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in kern)
    by_kernel = defaultdict(lambda: [0, 0.0])
    for e in kern:
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += e.time_range.elapsed_us()
    host_self = defaultdict(lambda: [0, 0.0])
    for a in prof.key_averages():
        if a.device_type == torch.autograd.DeviceType.CPU:
            host_self[a.key][0] += a.count
            host_self[a.key][1] += a.self_cpu_time_total
    return {
        "window_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3 if kern else None,
        "device_idle_share": 1.0 - busy_us / span_us if kern else None,
        "kernel_events": len(kern), "host_events": len(host),
        "top_kernels_ms": sorted(
            ([name[:80], n, us / 1e3] for name, (n, us) in by_kernel.items()),
            key=lambda r: -r[2])[:12],
        "top_host_self_ms": sorted(
            ([k, n, us / 1e3] for k, (n, us) in host_self.items()), key=lambda r: -r[2])[:15],
    }


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(args) -> dict:
    """``--world N``: the drain across N rank processes (module docstring)."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = tempfile.mkdtemp(prefix="profile_serving_")
    engine = {"preset": args.preset, "mp_size": args.mp, "seed": args.seed,
              "dtype": "bfloat16" if args.dtype == "bf16" else "float32",
              "init_on_device": args.init_on_device}
    cut = {"vocab_size": args.vocab, "n_layer": args.layers}
    if any(cut.values()):
        engine["model_cfg"] = {k: v for k, v in cut.items() if v}
    serving = {"num_slots": 8, "prefill_chunk": 64}
    if args.paged:
        serving["kvcache"] = {"enabled": True, "page_len": 128}
    case = {"name": "serve", "engine": engine, "drives": [{
        "kind": "serve", "serving": serving, "mix": "paged" if args.paged else "request",
        "mix_seed": args.seed, "warmup": 2, "profile": args.profile}]}
    spec = {"device": args.device, "deterministic": False, "threads": 4, "out": out,
            "cases": [case]}
    if args.device == "cpu":
        spec["init_method"] = f"file://{out}/store"
    path = os.path.join(out, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = str(_free_port())
    procs = []
    for r in range(args.world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.serve_worker", path], env=env,
            cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log[-3000:]}")
    ranks = []
    for r in range(args.world):
        with open(os.path.join(out, f"serve.r{r}.json")) as f:
            ranks.append(json.load(f))
    d = ranks[0]["drives"][0]
    tokens = d["tokens"]
    result = {
        "profile": "serving_tp_paged" if args.paged else "serving_tp", "preset": args.preset,
        "vocab": args.vocab or None, "layers": args.layers or None, "dtype": args.dtype,
        "world": args.world, "mp": args.mp,
        "init_on_device": args.init_on_device, "backend": ranks[0]["backend"],
        "mesh": ranks[0]["mesh"], "local_heads": ranks[0]["local_heads"],
        "requests": len(tokens), "tokens": d["tokens_generated"], "wall_s": d["wall_s"],
        "decode_tokens_per_s": d["decode_tokens_per_s"],
        "ttft_ms_p50": float(np.percentile(d["ttft_ms"], 50)),
        "ttft_ms_p99": float(np.percentile(d["ttft_ms"], 99)),
        "phase_seconds": d["stats"]["phase_seconds"],
        "decode_steps": d["stats"]["decode_steps"], "prefill_chunks": d["stats"]["prefill_chunks"],
        "peak_gib_by_rank": [(rk["drives"][0]["peak_bytes"] or 0) / 2**30 for rk in ranks],
        "pool_gib_a_rank": d["pool_bytes"] / 2**30,
        "comm_bytes": d["comm"], "model_bytes": d["model_bytes"],
        "bytes_equal_model": all(d["comm"].get(k, 0) == n for k, n in d["model_bytes"].items()),
        "launches": d["launches"],
        "ranks_equal": all(rk["drives"][0]["tokens"] == tokens for rk in ranks),
        "tokens_sha256": hashlib.sha256(json.dumps(tokens).encode()).hexdigest(),
        "kvcache": d["stats"].get("kvcache"),
        "card": _card() if args.device == "cuda" else None,
    }
    if args.profile:  # every rank's window
        result["profile_by_rank"] = [rk["drives"][0]["profile"] for rk in ranks]
    if args.tokens_out:
        with open(args.tokens_out, "w") as f:
            json.dump(tokens, f)
    if args.tokens_ref:
        with open(args.tokens_ref) as f:
            ref = json.load(f)
        flips = [{"request": i, "at": next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)}
                 for i, (g, w) in enumerate(zip(tokens, ref)) if g != w]
        result["tokens_equal_ref"] = len(tokens) - len(flips)
        result["flips_vs_ref"] = flips
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged pool (page_len 128) on paged_request_mix")
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the window here")
    ap.add_argument("--world", type=int, default=0,
                    help="serve across this many rank processes (tools/serve_worker.py)")
    ap.add_argument("--mp", type=int, default=1, help="mp_size of the ranks' engine")
    ap.add_argument("--preset", default="gpt2", help="a GPT-2 preset (gpt2, gpt-neo-2.7b, ...)")
    ap.add_argument("--vocab", type=int, default=0, help="replace the preset's vocabulary")
    ap.add_argument("--layers", type=int, default=0, help="cut the preset's depth")
    ap.add_argument("--init-on-device", action="store_true",
                    help="draw the random weights on the card (another stream)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="with --world: trace the drain on every rank with torch.profiler")
    ap.add_argument("--tokens-out", default=None)
    ap.add_argument("--tokens-ref", default=None)
    args = ap.parse_args(argv)
    if args.world:
        return run_ranks(args)
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

    tokens = int(sum(len(r.generated) for r in done))
    out = {
        "profile": "serving_drain_paged" if args.paged else "serving_drain", "model": "gpt2",
        "dtype": args.dtype, "slots": 8,
        "chunk": 64, "requests": len(done), "tokens": tokens, "wall_s": wall,
        **profile_summary(prof),
        "decode_steps": srv.decode_steps - steps0[0],
        "prefill_chunks": srv.prefill_chunks - steps0[1],
        "host_phase_s": {k: srv._phase_seconds[k] - phase0[k] for k in phase0},
        "kvcache": srv.stats().get("kvcache"),
        "card": _card(),
    }
    print(json.dumps(out), flush=True)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return out


if __name__ == "__main__":
    main()
