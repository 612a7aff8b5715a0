"""Where a training step spends its time on the card.

    python -m deepspeed_tpu_torch.tools.profile_training [--steps 2] [--trace out.json]
    python -m deepspeed_tpu_torch.tools.profile_training --model bert-large --optimizer lamb --seq 512
    python -m deepspeed_tpu_torch.tools.profile_training --model bert-large --dropout 0.1

Builds ``initialize()`` in bf16 over f32 masters (random weights from
``--seed``), micro-batch 8, gradient accumulation 2, clipping 1.0, for one
of two training main paths of ``chip_smoke.py``: GPT-2 124M at T 1024 with
AdamW (``train_bf16``, the default), or BERT-large MLM + NSP pretraining
at T 512 with LAMB (bing_bert's phase-2 settings) on a synthetic padded
batch (``train_bert_bf16``; with ``--dropout 0.1``, BERT-large's
published hidden and attention-probability dropout, ``train_bert_drop_bf16``).
Runs two warm-up steps, then ``--steps``
steps of one fixed batch under ``torch.profiler`` with CPU and CUDA
activities.  Prints one JSON line: the window, the device-busy time (the
union of the kernels' intervals) and the idle share, the device time by
kernel class (the port's kernels, GEMMs, everything else) and the top
device kernels and host ops.  Needs a CUDA card; it raises without one.
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
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("fused_adam", ("fused_adam_kernel",)),
    ("fused_lamb_dir", ("lamb_dir_kernel",)),
    ("fused_lamb_apply", ("lamb_apply_kernel",)),
    # cuBLAS on Hopper names most of its GEMM kernels nvjet_*
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, pats in KERNEL_CLASSES:
        if any(p in low for p in pats):
            return cls
    return "other"


# the key-padding pattern of the synthetic BERT batches: row b keeps
# KEEP_FRACTIONS[b % 4] of its T positions (512, 448, 300 and 129 at T 512)
KEEP_FRACTIONS = (1.0, 448 / 512, 300 / 512, 129 / 512)

# bing_bert's phase-2 LAMB settings (lr 2e-3, weight decay 0.01, no bias
# correction, trust ratio clamped to [0.01, 0.3])
BERT_LAMB = {"type": "Lamb", "params": {"lr": 2e-3, "weight_decay": 0.01,
                                        "bias_correction": False, "max_coeff": 0.3,
                                        "min_coeff": 0.01}}


def synthetic_mlm_batch(vocab_size: int, B: int, T: int, seed: int = 0) -> dict:
    """One MLM + NSP batch as numpy arrays: row b keeps
    ``KEEP_FRACTIONS[b % 4]`` of its positions (the rest padding, masked
    out by ``attention_mask``), two segments split at the row's middle,
    15 % of the real positions labelled and replaced by the [MASK] id 103,
    and an NSP label."""
    rng = np.random.default_rng(seed)
    keep = np.array([max(1, int(round(T * KEEP_FRACTIONS[b % 4]))) for b in range(B)])
    pos = np.arange(T)[None, :]
    mask = (pos < keep[:, None]).astype(np.int32)
    ids = rng.integers(0, vocab_size, (B, T), dtype=np.int32)
    labels = np.where((rng.random((B, T)) < 0.15) & (mask > 0), ids, -100).astype(np.int32)
    return {
        "input_ids": np.where(labels != -100, 103, ids * mask).astype(np.int32),
        "token_type_ids": ((pos >= keep[:, None] // 2) & (mask > 0)).astype(np.int32),
        "attention_mask": mask,
        "masked_lm_labels": labels,
        "next_sentence_label": rng.integers(0, 2, B).astype(np.int32),
    }


def build(model: str, optimizer: str, T: int, mb: int, gas: int, seed: int, dropout: float = 0.0):
    """``(engine, batch, cfg)`` of a bf16 training run: GPT-2 124M or
    BERT-large at width and depth, random weights from ``seed``, one
    fixed batch of ``gas * mb`` rows; ``dropout``: BERT's hidden and
    attention-probability dropout (GPT-2's ``dropout``)."""
    import dataclasses

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert, gpt2

    if model == "bert-large":
        cfg = dataclasses.replace(bert.PRESETS[model], hidden_dropout_prob=dropout,
                                  attention_probs_dropout_prob=dropout)
        model_fn, init_fn, _ = bert.make_model(cfg)
        batch = synthetic_mlm_batch(cfg.vocab_size, mb * gas, T, seed)
    else:
        cfg = dataclasses.replace(gpt2.PRESETS[model], dropout=dropout)
        model_fn, init_fn, _ = gpt2.make_model(cfg)
        batch = {"input_ids": np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (mb * gas, T), dtype=np.int32)}
    opt = BERT_LAMB if optimizer == "lamb" else {
        "type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}}
    config = {"train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
              "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": opt}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=seed), config=config)
    return engine, batch, cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt2", choices=["gpt2", "bert-large"])
    ap.add_argument("--optimizer", default=None, choices=["adamw", "lamb"],
                    help="default: adamw for gpt2, lamb for bert-large")
    ap.add_argument("--seq", type=int, default=None, help="default: 1024 for gpt2, 512 for bert")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="hidden (and BERT's attention) dropout; BERT-large publishes 0.1")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_training measures the card; torch.cuda.is_available() is False")

    bert_run = args.model == "bert-large"
    optimizer = args.optimizer or ("lamb" if bert_run else "adamw")
    T = args.seq or (512 if bert_run else 1024)
    mb, gas = 8, 2
    engine, batch, _ = build(args.model, optimizer, T, mb, gas, args.seed, args.dropout)
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
        "profile": "train_step", "model": args.model, "optimizer": optimizer, "dtype": "bf16",
        "dropout": args.dropout,
        "micro_batch": mb, "gas": gas,
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
