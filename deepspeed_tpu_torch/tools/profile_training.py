"""Where a training step spends its time on the card.

    python -m deepspeed_tpu_torch.tools.profile_training [--steps 2] [--trace out.json]
    python -m deepspeed_tpu_torch.tools.profile_training --model bert-large --optimizer lamb --seq 512
    python -m deepspeed_tpu_torch.tools.profile_training --model bert-large --dropout 0.1
    python -m deepspeed_tpu_torch.tools.profile_training --attention-mode sparse --seq 8192 --layers 8
    python -m deepspeed_tpu_torch.tools.profile_training --model transformer-layer --mask 4d
    python -m deepspeed_tpu_torch.tools.profile_training --model transformer-layer --seq 9216 --batch 1

Builds ``initialize()`` in bf16 over f32 masters (random weights from
``--seed``), micro-batch 8, gradient accumulation 2, clipping 1.0, for one
of two training main paths of ``chip_smoke.py``: GPT-2 124M at T 1024 with
AdamW (``train_bf16``, the default), or BERT-large MLM + NSP pretraining
at T 512 with LAMB (bing_bert's phase-2 settings) on a synthetic padded
batch (``train_bert_bf16``; with ``--dropout 0.1``, BERT-large's
published hidden and attention-probability dropout, ``train_bert_drop_bf16``).
With ``--attention-mode`` (``sparse`` or ``flash``) it runs the long-context
recipe of ``train_sparse_bf16`` instead: GPT-2 124M's width at ``--layers``
(default 8) and ``n_positions`` = ``--seq`` (default 8192), batch 1, Adam at
lr 1e-4, cross-entropy in chunks of 512, block-sparse attention (the
default BigBird layout) or dense flash attention.  With ``--model
transformer-layer`` a step is ``chip_smoke.py``'s ``transformer_layer``
pass: ``--layers`` (default 24) ``DeepSpeedTransformerLayer``s at
BERT-large width (pre-LN, dropout 0.1 and 0.1), bf16, ``--batch`` (default
8) rows of ``--seq`` (default 512) positions, forward and the backward of
a weighted sum, under a (B, T) key-padding mask (``--mask 2d``) or a (B,
1, T, T) seq2seq mask (``--mask 4d``); at ``--seq 9216`` with a (B, T)
mask the backward is the two-pass B6a/B6b.  The script uses only entry points
that every slice of the port since the transformer layer's has, so it can
profile an older checkout of the package (put it first on PYTHONPATH and
run this file by its path).
Runs two warm-up steps, ``--steps`` timed steps without the profiler,
then ``--steps`` steps of one fixed batch under ``torch.profiler`` with
CPU and CUDA activities.  Prints one JSON line: the unprofiled step
times, the window, the device-busy time (the
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
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.telemetry.attribution import kernel_class, union_us

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


# the long-context recipe (the JAX package's tools/bench_long_context.py)
LONG_ADAM = {"type": "Adam", "params": {"lr": 1e-4}}


def seq2seq_mask(kb, T: int):
    """A (B, 1, T, T) f32 mask: the key padding of ``kb`` (B, T), plus a
    seq2seq (UniLM) pattern, in which every query sees the first half of
    the row and a query in the second half sees the second half causally."""
    half = T // 2
    pos = torch.arange(T, device=kb.device)
    allowed = (pos[None, :] < half) | (pos[None, :] <= pos[:, None])  # (T, T)
    return torch.where(allowed[None, None], kb[:, None, None, :],
                       torch.full((), -1e9, device=kb.device)).float().contiguous()


def layer_step(mask_form: str, B: int, T: int, seed: int, layers: int = 24, device="cuda"):
    """A callable that runs one ``transformer_layer`` pass (the module
    docstring) and waits for the device; ``mask_form`` "2d" or "4d"."""
    from deepspeed_tpu_torch.ops.transformer.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer, draw_seeds)

    dev = torch.device(device)
    cfg = DeepSpeedTransformerConfig(
        batch_size=B, hidden_size=1024, intermediate_size=4096, heads=16, attn_dropout_ratio=0.1,
        hidden_dropout_ratio=0.1, num_hidden_layers=layers, pre_layer_norm=True,
        dtype=torch.bfloat16)
    stack = [DeepSpeedTransformerLayer(cfg, seed=i, device=dev) for i in range(layers)]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, T, 1024, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(B, T, 1024, generator=g, device=dev)
    keep = torch.tensor([max(1, round(T * KEEP_FRACTIONS[b % 4])) for b in range(B)], device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < keep[:, None]).long()
    if mask_form == "4d":
        mask = seq2seq_mask(torch.where(mask.bool(), 0.0, -1e9), T)
    gen = torch.Generator().manual_seed(seed)

    def step():
        for layer in stack:
            layer.zero_grad(set_to_none=True)
        h = xin = x.detach().clone().requires_grad_()
        for layer in stack:
            h = layer(h, attention_mask=mask, rng=draw_seeds(gen), training=True)
        (h.float() * w).sum().backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return xin.grad

    return step


def build(model: str, optimizer: str, T: int, mb: int, gas: int, seed: int, dropout: float = 0.0,
          attention_mode: Optional[str] = None, layers: Optional[int] = None):
    """``(engine, batch, cfg)`` of a bf16 training run: GPT-2 124M or
    BERT-large at width and depth, random weights from ``seed``, one
    fixed batch of ``gas * mb`` rows; ``dropout``: BERT's hidden and
    attention-probability dropout (GPT-2's ``dropout``).  With
    ``attention_mode`` (GPT-2 only): the long-context recipe, ``layers``
    layers, ``n_positions`` = T, cross-entropy chunks of 512 and Adam at
    lr 1e-4 (``LONG_ADAM``, whatever ``optimizer`` says)."""
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
        if attention_mode is not None:
            cfg = dataclasses.replace(cfg, attention_mode=attention_mode, n_positions=T,
                                      n_layer=layers or cfg.n_layer, xent_chunk_size=512)
        model_fn, init_fn, _ = gpt2.make_model(cfg)
        batch = {"input_ids": np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (mb * gas, T), dtype=np.int32)}
    opt = LONG_ADAM if attention_mode is not None else BERT_LAMB if optimizer == "lamb" else {
        "type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}}
    config = {"train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
              "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": opt}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=seed), config=config)
    return engine, batch, cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt2", choices=["gpt2", "bert-large", "transformer-layer"])
    ap.add_argument("--mask", default="2d", choices=["2d", "4d"],
                    help="transformer-layer: a (B, T) key-padding mask or a (B, 1, T, T) one")
    ap.add_argument("--optimizer", default=None, choices=["adamw", "lamb"],
                    help="default: adamw for gpt2, lamb for bert-large")
    ap.add_argument("--seq", type=int, default=None,
                    help="default: 1024 for gpt2, 512 for bert, 8192 with --attention-mode")
    ap.add_argument("--attention-mode", default=None, choices=["flash", "sparse"],
                    help="GPT-2's long-context recipe with this attention (B 1, Adam, xent chunks)")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of the long-context recipe (default 8) or of transformer-layer "
                         "(default 24)")
    ap.add_argument("--batch", type=int, default=None,
                    help="transformer-layer: rows a pass (default 8)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="hidden (and BERT's attention) dropout; BERT-large publishes 0.1")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="write a Chrome trace of the window here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_training measures the card; torch.cuda.is_available() is False")

    bert_run = args.model == "bert-large"
    layer_run = args.model == "transformer-layer"
    long_run = args.attention_mode is not None
    if long_run and (bert_run or layer_run or args.optimizer):
        raise ValueError("--attention-mode is GPT-2's long-context recipe, with its own Adam")
    if args.batch is not None and not layer_run:
        raise ValueError("--batch sets transformer-layer's rows; the training runs fix theirs")
    mb, gas = (1, 1) if long_run else (8, 2)
    if layer_run:
        T, mb, gas, optimizer = args.seq or 512, args.batch or 8, 1, None
        layers = args.layers or 24
        step = layer_step(args.mask, mb, T, args.seed, layers)
        meta = {"profile": "transformer_layer", "model": args.model, "mask": args.mask,
                "dropout": 0.1, "layers": layers}
    else:
        optimizer = "adam" if long_run else args.optimizer or ("lamb" if bert_run else "adamw")
        T = args.seq or (512 if bert_run else 8192 if long_run else 1024)
        engine, batch, engine_cfg = build(args.model, optimizer, T, mb, gas, args.seed,
                                          args.dropout, args.attention_mode,
                                          (args.layers or 8) if long_run else None)

        def step():
            return float(engine.train_batch(batch))

        meta = {"profile": "train_step", "model": args.model, "dropout": args.dropout,
                "attention_mode": args.attention_mode or "flash",
                "layers": getattr(engine_cfg, "n_layer", None) or engine_cfg.num_hidden_layers}
    for _ in range(2):  # warm-up: kernel build and load, allocator
        step()
    torch.cuda.synchronize()
    unprofiled_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        unprofiled_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.events()
    kern = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    window = [(e.time_range.start, e.time_range.end) for e in events]
    span_us = max(e for _, e in window) - min(s for s, _ in window)
    busy_us = union_us((e.time_range.start, e.time_range.end) for e in kern)
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
        **meta, "optimizer": optimizer, "dtype": "bf16", "micro_batch": mb, "gas": gas,
        "T": T, "steps": steps, "unprofiled_step_ms": unprofiled_ms,
        "wall_s": wall, "step_ms": wall / steps * 1e3,
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
