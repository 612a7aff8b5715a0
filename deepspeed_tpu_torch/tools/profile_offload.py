"""Peak device memory and step time of GPT-2 training with and without
ZeRO-Offload / ZeRO-Infinity on the card.

    python -m deepspeed_tpu_torch.tools.profile_offload [--model gpt2|gpt2-xl]
        [--mode device|offload|infinity|all] [--device cuda]

For each mode, ``initialize()`` builds GPT-2 (``--model``, full width and
depth; the random init drawn on the device from seed 0) in bf16 with
``chip_smoke.py``'s ``train_bf16`` config (micro-batch 8, gradient
accumulation 2, T 1024, AdamW, clipping 1.0): ``device`` keeps f32
masters and moments on the card (B3 steps them), ``offload`` puts them in
pinned host memory (``offload_optimizer: {device: cpu}``), ``infinity``
also streams the blocks one layer group at a time (``offload_param:
{device: cpu, buffer_count: 1}``: one-layer groups).  Runs two steps
of one fixed batch and prints one JSON line a mode: the peak device
memory (``torch.cuda.max_memory_allocated`` after a reset), the step
times and losses (the same bf16 weights and kernels in every mode: the
first loss is the same bits), the offload step's split (``offload``) or
the phases of one more step, serialized (``infinity``), and the host
Adam's GB/s (28 bytes a
parameter: p, m and v read and written, g read); then one line with the
host link's pinned GB/s each way (a 0.5 GB copy) and a 1 GB host
memcpy's GB/s.  Each line carries the card's name and power limit.

A mode whose host state (about 18 bytes a parameter pinned, plus the
step's buffers) would not fit the host's available memory is skipped
with the reason.  Needs a CUDA card; it raises without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

import numpy as np
import torch

# host bytes a parameter the offload engines pin: f32 master, m, v and
# gradient (16) and the bf16 staging (2)
HOST_BYTES_PER_PARAM = 18
ADAM_BYTES_PER_PARAM = 28
STEPS, SEED, BUFFER_COUNT = 2, 0, 1


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _available_host_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def host_rates(dev, reps: int = 3) -> dict:
    """The host link's pinned GB/s each way on a 0.5 GB copy (CUDA events,
    best of ``reps``) and a 1 GB host memcpy's GB/s (host clock)."""
    n = 512 << 20
    h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(n, dtype=torch.uint8, device=dev)
    out = {}
    for name, dst, src in (("h2d", d, h), ("d2h", h, d)):
        best = float("inf")
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        out[f"{name}_pinned_gbps"] = n / best / 1e6
    del h, d
    a = torch.ones(1 << 30, dtype=torch.uint8)
    b = torch.empty_like(a)
    b.copy_(a)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        b.copy_(a)
        best = min(best, time.perf_counter() - t0)
    out["host_memcpy_gbps"] = (1 << 30) / best / 1e9
    return out


def config_for(mode: str) -> dict:
    config = {
        "train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                  "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 6e-5,
            "warmup_max_lr": 6e-4}},
    }
    if mode == "offload":
        config["zero_optimization"] = {"offload_optimizer": {"device": "cpu"}}
    elif mode == "infinity":
        config["zero_optimization"] = {"offload_param": {"device": "cpu",
                                                         "buffer_count": BUFFER_COUNT}}
    return config


def run_mode(mode: str, args, card: str) -> dict:
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    dev = torch.device(args.device)
    cfg = gpt2.PRESETS[args.model]
    n = cfg.num_params()
    row = {"mode": mode, "model": args.model, "n_params": n, "card": card}
    if mode != "device":
        need = HOST_BYTES_PER_PARAM * n
        have = _available_host_bytes()
        if need > 0.9 * have:
            return {**row, "skipped": f"needs ~{need / 2**30:.1f} GiB of host memory, "
                                      f"{have / 2**30:.1f} GiB available"}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = gpt2.init_params_device(cfg, seed=SEED, device=dev)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=gpt2.make_model(cfg)[0], model_parameters=params,
        config=config_for(mode), device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (16, 1024), dtype=np.int32)}
    walls, losses, split = [], [], None
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        walls.append((time.perf_counter() - t0) * 1e3)
        if mode == "offload":
            split = engine.offload_breakdown()
    if mode == "infinity":  # one more step, serialized, for its phases
        split = {}
        engine.train_batch(batch, timing=split)
    row.update(init_s=init_s, step_ms=walls, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               losses=losses)
    if mode == "offload":
        row["split_ms"] = split
        row["host_adam_gbps"] = ADAM_BYTES_PER_PARAM * n / (split["adam_ms"] / 1e3) / 1e9
    elif mode == "infinity":
        row["serialized_last_step_s"] = split
        row["groups"] = engine.n_groups
        row["host_step_gbps"] = ADAM_BYTES_PER_PARAM * n / split["opt_s"] / 1e9
        row["stats"] = dict(engine.stats)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="gpt2-xl", choices=["gpt2", "gpt2-xl"])
    ap.add_argument("--mode", default="all", choices=["device", "offload", "infinity", "all"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("profile_offload measures the card: it needs --device cuda and a card")
    card = _card()
    modes = ["device", "offload", "infinity"] if args.mode == "all" else [args.mode]
    for mode in modes:
        print(json.dumps(run_mode(mode, args, card)), flush=True)
    print(json.dumps({"host": host_rates(torch.device(args.device)), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
