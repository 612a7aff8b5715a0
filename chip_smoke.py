#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: compile every CUDA kernel of the serving and training paths
   from ``deepspeed_tpu_torch/csrc`` with ``nvcc`` (one process per source,
   all started together).
2. ``kernel``: every kernel against its plain PyTorch version at the main
   paths' shapes (flash prefill at B=4, H=12, d=64, T=256/512/200 in bf16 and
   f32, and at the training shape B=8, T=1024 with its lse, and with
   BERT-large's key-padding bias at B=8, H=16, T=512 with its lse; flash decode
   over an 8-slot, 1024-position cache in f32, bf16 and int8, with and
   without a key-padding mask; flash backward at B=8, H=12, d=64, T=1024 in
   bf16 and f32, T=256 and a ragged T=1000, and with the key-padding bias
   at B=8, H=16, T=512 in bf16 and f32; fused Adam over GPT-2 124M's
   ``wte``, stacked ``qkv_w`` and ragged ``lnf_g`` leaves and over a whole
   step's 16 leaves; fused LAMB's two passes over BERT-large's
   ``tok_emb``, stacked ``qkv_w``, ragged ``mlm_bias`` and ``nsp_b`` and
   over a whole step's 26 leaves, with and without bias correction;
   paged flash decode at the paged pool's serving shape,
   8 slots x 8 pages of 128 over a permuted 129-page pool, in bf16, f32 and
   int8, also against flash decode over the gathered view, bit for bit;
   flash forward and backward with BERT-large's padding bias and attention
   dropout 0.1 (in-kernel Threefry bits against the host twin's) and with
   a (B, 1, T, T) mask read through its strides, at B=8, H=16, T=512 in
   bf16 and f32, and a trainable (1, 16, 512, 512) bias's cotangent under
   dropout; the two-pass backward at B=1, H=16, T=9216 in bf16 and f32,
   against its plain version and the single-pass kernel, its dq the same
   bits over two launches),
   with the tolerance stated, and the times of the kernel, the plain
   version and one PyTorch library call beside the least time the card
   could take (``bound_ms``).
3. ``serve_f32``: GPT-2 124M at full width and depth (random weights from
   a seed) behind ``init_serving``: 8 slots, 64-token prefill chunks, 16
   requests with 64..384-token prompts, drained; every request's greedy
   tokens must equal the port's solo ``generate()`` of the same prompt
   (the JAX package's serving contract) unless the first differing token
   sits on a near-tie of the top-2 logits.
4. ``serve_bf16``: the same flow in bf16 plus a ``generate()`` with B=4 and
   T=256, the serving main path.  Kernel launch counters are zeroed just
   before it and read just after: both serving kernels must have launched.
   Logits of the kernel path and of the plain path on the card must agree.
5. ``train_f32``: GPT-2 124M at full width and depth through
   ``deepspeed_tpu_torch.initialize`` in f32, B=2, T=1024, 3 ``train_batch``
   steps, TF32 off: the kernel path against the same steps with
   ``use_flash_attention=False`` (the plain attention); per-step losses
   must agree within the tolerance stated.
6. ``train_bf16``: the training main path, GPT-2 124M in bf16 with f32
   masters, micro-batch 8, gradient accumulation 2, T=1024, AdamW with
   ``WarmupDecayLR`` (lr 6e-5 rising to 6e-4 over 2 steps) and clipping
   1.0, 4 steps on one fixed batch.  The
   counters are zeroed just before and read just after: the flash forward,
   flash backward and fused Adam kernels must have launched; every loss
   finite and the last below the first.  Prints tokens/s, ms a step, peak
   memory and model-FLOPs utilization.
7. ``serve_paged_f32``: GPT-2 124M behind ``init_serving`` with the paged
   pool (8 slots x 1024 positions, 64-token chunks, 128-token pages) on
   ``paged_request_mix(seed=0)``: 16 requests sharing a 200-token prefix
   and a 3-turn session.  Served tokens must equal the slot engine's on the
   same prompts (the near-tie rule above); at least 6 prefix hits, a
   copy-on-write, 2 session rebinds, no leaked page; paged flash decode
   launched, slot flash decode not.
8. ``serve_paged_bf16``: the same mix in bf16, the paged serving main path
   (counters zeroed just before and read just after), against the slot
   engine on the same mix (decode tokens/s, TTFT, prefill chunks run);
   then the session is spilled to disk and a fourth turn restores it: the
   restored rows must equal the spilled ones bit for bit.
9. ``train_bert_f32``: BERT-large at full width and depth (random weights
   from a seed) through ``initialize`` in f32, B=2, T=512 with a
   key-padding mask, LAMB, 3 steps, TF32 off: the kernel path (biased
   flash forward and backward, fused LAMB) against
   ``use_flash_attention=False``; per-step losses must agree within the
   tolerance stated; the LAMB kernels must launch and fused Adam not.
10. ``train_bert_bf16``: the BERT pretraining main path, BERT-large in bf16
   over f32 masters, micro-batch 8, gradient accumulation 2, T=512 with
   the padded synthetic MLM + NSP batch, LAMB with bing_bert's phase-2
   settings (lr 2e-3, weight decay 0.01, no bias correction, trust ratio
   in [0.01, 0.3]), ``WarmupDecayLR``, clipping 1.0, 4 steps.  Counters
   zeroed just before and read just after: the biased flash forward and
   backward and both LAMB kernels must have launched; every loss finite
   and the last below the first.  Prints tokens/s, ms a step, peak memory
   and model-FLOPs utilization.
11. ``train_bert_drop_f32``: BERT-large with its published dropout (hidden
   and attention-probability 0.1) in f32, B=2, T=512, LAMB, 3 steps, TF32
   off: the kernel path against ``use_flash_attention=False`` on the same
   seeds (the same keep-bits, the same hidden masks); per-step losses
   within the tolerance stated.
12. ``train_bert_drop_bf16``: this slice's main path, BERT-large with its
   published dropout, otherwise ``train_bert_bf16``'s settings.  Counters
   zeroed just before and read just after: every flash forward and
   backward launch ran with the bias and dropout, both LAMB kernels
   launched, fused Adam and the two-pass backward not; every loss finite.
   Prints tokens/s, ms a step, peak memory and model-FLOPs utilization.
13. ``transformer_layer``: ``DeepSpeedTransformerLayer`` at BERT-large
   width (pre-LN, the op's default dropout 0.1 and 0.1): 24 layers in bf16
   at B=8, T=512, forward and backward, with a (B, T) mask (the key-row
   bias) and with a (B, 1, T, T) seq2seq mask (the full bias), each a main
   path (counters zeroed before, read after); the same stack in f32 at
   B=2 against plain attention on the same seeds; one layer at B=1,
   T=9216, whose backward must be the two-pass B6a/B6b and not B2.
14. ``kernels``: one entry per kernel with its launches on each main path
   (``launches_by_path``: serving, serving_paged, training,
   training_bert, training_bert_dropout, transformer_layer) and their sum.

Then the card's name and power limit (``nvidia-smi``) and, last, the
``{"ok": true, "device": ...}`` line.  Any failing phase raises, so the
script exits non-zero; without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and FLOP/s by
# operand type (bf16 on the tensor cores, f32 on the CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain version on the same inputs:
#  * f32: 2e-5, the JAX kernel tests' own bound; both sides sum in f32
#    in different orders (TF32 is off, see below)
#  * bf16 outputs: 2e-2; both sides round the output (and the prefill's p)
#    to bf16, whose spacing is 2**-8 relative, after f32 sums taken in
#    different orders
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# f32 serving vs solo generate(): a differing greedy token is accepted only
# where the top-2 logits at that step lie within this gap; the two paths'
# f32 logits differ by sums taken in other orders (~1e-5 at most)
F32_NEAR_TIE = 1e-3
# bf16 kernel path vs bf16 plain path, first-step logits (absolute): the
# two round attention (p, and its output) to bf16 at different points and
# carry that through 12 bf16 residual layers; the random-init logits span
# about +-3, and a wrong mask or offset moves them far more than this
BF16_LOGIT_TOL = 0.1

FLUSH_BYTES = 512 << 20  # > the 50 MB L2: every timed launch starts cold

# flash backward vs its plain version, entry by entry:
#   |got - ref| <= tol * (|ref| + BWD_RMS_SHARE * rms(ref))
# with tol the f32/bf16 bound above.  The relative term takes a bf16
# output that rounds the other way (one spacing, <= 2**-7 of the entry)
# and dq's f32 sum, taken with atomics in an order that changes between
# runs; the rms term takes entries near zero.  With random causal inputs
# the entries shrink like sqrt(e / position) (rms ~0.1 at T=1024), so a
# kernel that drops or misplaces one 64-row tile's share of a late row
# moves it by several times its bound
BWD_RMS_SHARE = 0.5
# fused Adam vs its plain version (f32 p), each of p, m and v relative to
# its own largest entry: the kernel rounds each product and sum as the
# plain version does, so at most an ulp may differ (the runs read 0)
ADAM_RTOL = 1e-6
# train_f32, flash kernels vs plain attention, per-step loss (relative):
# the same f32 math in other summation orders; the runs read 0, 0 and
# 9.1e-8, so this leaves two orders of margin
TRAIN_F32_LOSS_RTOL = 1e-5
# Adam's operations per element of the keep-folded body (multiplies, adds,
# two divides, a square root, a select), for the bound; bytes per f32
# element: p read+write, g read, m read+write, v read+write
ADAM_FLOPS_PER_ELEM = 24
ADAM_BYTES_PER_ELEM = 28
# fused LAMB vs its plain version (f32 p): m, v and p each within 1e-6 of
# its own largest entry (each product and sum rounded as the plain version
# rounds it, so at most an ulp may differ); the trust ratio within 1e-5
# relative, since its norms sum per block, in another order than
# torch.linalg.vector_norm
LAMB_RTOL = 1e-6
LAMB_TRUST_RTOL = 1e-5
# LAMB's bytes per f32 element: pass 1 reads p and g, reads and writes m
# and v, writes dir (28); pass 2 reads p and dir and writes p (12).  Its
# operations: pass 1's keep-folded body with the decay term and the two
# squares summed (~26), pass 2's multiply and subtract (2)
LAMB_DIR_BYTES, LAMB_APPLY_BYTES = 28, 12
LAMB_DIR_FLOPS, LAMB_APPLY_FLOPS = 26, 2
# the key-padding pattern of the biased attention checks: batch row b
# keeps BIAS_KEEP[b % 4] of its 512 keys (the rest carry a -1e9 bias)
BIAS_KEEP = (512, 448, 300, 129)
# attention dropout: BERT-Large's published rate, and the key words of the
# kernel checks (both above 2**31, so the uint32 arithmetic is exercised)
DROP_RATE = 0.1
DROP_KEY = (0x9E3779B9, 0xBB67AE85)
# the two-pass backward's check: one sequence past d 64's 8,192-row bound
# of the fused backward, keeping LONG_KEEP of its keys
LONG_T, LONG_KEEP = 9216, 8000
# its entry bound's rms share: BWD_RMS_SHARE was set for sums over at most
# 1,024 terms; here each gradient sums LONG_T terms that nearly cancel,
# and the f32 rounding of such a sum grows as the square root of its
# length.  Against the float64 function (`_bwd2_float64`, on an H100) the
# f32 dk and dv read 1.24x and 1.01x the unscaled bound, the kernel's and
# the plain version's alike (the same bits), and dq 0.46x (kernel) and
# 1.05x (plain, cuBLAS's order): the error is the f32 sum's own, and the
# kernel's dq is the closer of the two
LONG_RMS_SHARE = BWD_RMS_SHARE * (LONG_T / 1024) ** 0.5
# f32 autograd through the kernels vs the plain path (dq, dk, dv and a
# trainable bias's cotangent), each relative to its largest entry: the
# same f32 math in other summation orders (the card tests read ~1e-6)
AUTOGRAD_F32_RTOL = 1e-4
# train_bert_drop_f32, kernels vs plain attention with dropout on both
# (the same keep-bits, the same hidden masks), per-step loss (relative):
# as train_f32's bound (train_bert_f32, without dropout, reads ~1e-7 on
# an H100)
TRAIN_DROP_F32_LOSS_RTOL = 1e-5
# transformer_layer's f32 check, 24 layers at B 2 through the kernels vs
# plain attention on the same seeds: the output and the input's gradient
# within this share of their largest entries (f32 sums in other orders,
# carried through 24 pre-LN layers)
LAYER_F32_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Fail(RuntimeError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise Fail(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, flush, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each after
    an L2 flush, from CUDA events around the launch alone."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def grad_err(a, b, tol, rms_share=BWD_RMS_SHARE):
    """``(max |a - b|, max of |a - b| over its bound)`` for the backward's
    entry-by-entry bound ``tol * (|b| + rms_share * rms(b))``; the check
    passes where the second is at most 1."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    bound = tol * (b.abs() + rms_share * b.square().mean().sqrt())
    worst = (diff / bound.clamp_min(1e-30)).max()
    return float(diff.max()), float(worst)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash_fwd(torch, dev, flush):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, d = 4, 12, 64
    rows = []
    for T in (256, 512, 200):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(T)
            q, k, v = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype) for _ in range(3))
            scale = d ** -0.5
            out, _ = fa.flash_fwd_cuda(q, k, v, causal=True, sm_scale=scale)
            ref, _ = fa.flash_fwd_reference(q, k, v, True, scale)
            torch.cuda.synchronize()
            name = str(dtype).replace("torch.", "")
            err, tol = max_err(out, ref), TOL[name]
            check(torch.isfinite(out).all().item(), f"flash_fwd T={T} {name}: non-finite output")
            check(err <= tol, f"flash_fwd T={T} {name}: max_err {err} > tol {tol}")
            item = dtype.itemsize
            nbytes = 4 * B * H * T * d * item
            flops = 4 * B * H * d * T * (T + 1) / 2
            b_ms, b_by = bound_ms(nbytes, flops, name)
            row = {
                "phase": "kernel", "kernel": "flash_fwd", "B": B, "H": H, "T": T, "d": d,
                "dtype": name, "causal": True, "max_err": err, "tol": tol,
                "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale), flush),
                "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, True, scale), flush),
                "library_ms": device_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), flush),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            rows.append(row)
    return rows


def _decode_inputs(torch, dev, kv, masked, B=8, H=12, S=1024, d=64):
    from deepspeed_tpu_torch.ops.transformer.inference import _kv_quant

    g = torch.Generator(device=dev).manual_seed(1234)
    qdtype = torch.float32 if kv == "float32" else torch.bfloat16
    q = torch.randn(B, H, 1, d, generator=g, device=dev).to(qdtype)
    k32 = torch.randn(B, H, S, d, generator=g, device=dev)
    v32 = torch.randn(B, H, S, d, generator=g, device=dev)
    if kv == "int8":
        kc, vc = (dict(zip(("q", "s"), _kv_quant(t))) for t in (k32, v32))
    else:
        kc, vc = k32.to(qdtype), v32.to(qdtype)
    # per-slot positions: a fresh slot (0), a full cache (S-1), the rest between
    pos = torch.tensor([0, S - 1, 100, 511, 777, 1, 300, 1000][:B], dtype=torch.int32, device=dev)
    kpm = None
    if masked:
        kpm = torch.rand(B, S, generator=g, device=dev) > 0.3
        kpm[:, 0] = True
        kpm[5, :2] = False  # slot 5 (pos 1) has no attendable key: uniform over S
    return q, kc, vc, pos, kpm


def _decode_cost(kv, pos, kpm, B, H, S, d, q_item):
    """Bytes and flops this call's data needs: each attendable K and V row
    once (all S rows of a slot with no attendable key), q, out, pos, and
    the int8 scales and mask prefix where present."""
    kv_item = {"float32": 4, "bfloat16": 2, "int8": 1}[kv]
    rows = 0
    for b in range(B):
        n = min(int(pos[b]), S - 1) + 1
        if kpm is not None and not bool(kpm[b, :n].any()):
            n = S
        rows += n
    nbytes = rows * H * d * 2 * kv_item + 2 * B * H * d * q_item + 4 * B
    if kv == "int8":
        nbytes += rows * H * 2 * 4
    if kpm is not None:
        nbytes += rows
    return nbytes, 4 * rows * H * d


def check_flash_decode(torch, dev, flush):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.kernels import flash_decode as fd

    B, H, S, d = 8, 12, 1024, 64
    rows = []
    for kv in ("bfloat16", "int8", "float32"):
        for masked in (False, True):
            q, kc, vc, pos, kpm = _decode_inputs(torch, dev, kv, masked, B, H, S, d)
            out = fd.flash_decode_cuda(q, kc, vc, pos, key_padding_mask=kpm)
            ref = fd.flash_decode_reference(q, kc, vc, pos, key_padding_mask=kpm)
            torch.cuda.synchronize()
            qname = str(q.dtype).replace("torch.", "")
            err, tol = max_err(out, ref), TOL[qname]
            check(torch.isfinite(out).all().item(), f"flash_decode {kv} masked={masked}: non-finite")
            check(err <= tol, f"flash_decode {kv} masked={masked}: max_err {err} > tol {tol}")
            pos_h, kpm_h = pos.cpu(), (kpm.cpu() if kpm is not None else None)
            nbytes, flops = _decode_cost(kv, pos_h, kpm_h, B, H, S, d, q.element_size())
            b_ms, b_by = bound_ms(nbytes, flops, qname)
            library_ms = None
            if kv != "int8":
                allowed = torch.arange(S, device=dev)[None, :] <= pos[:, None].long()
                if kpm is not None:
                    allowed = allowed & kpm
                amask = allowed[:, None, None, :]
                library_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, kc, vc, attn_mask=amask), flush)
            row = {
                "phase": "kernel", "kernel": "flash_decode", "B": B, "H": H, "S": S, "d": d,
                "kv": kv, "q_dtype": qname, "masked": masked, "pos": pos_h.tolist(),
                "max_err": err, "tol": tol,
                "kernel_ms": device_ms(torch, lambda: fd.flash_decode_cuda(
                    q, kc, vc, pos, key_padding_mask=kpm), flush),
                "plain_ms": device_ms(torch, lambda: fd.flash_decode_reference(
                    q, kc, vc, pos, key_padding_mask=kpm), flush),
                "library_ms": library_ms,
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            rows.append(row)
    return rows


def check_flash_decode_paged(torch, dev, flush):
    """B5 at the paged pool's serving shape: 8 slots x 8 pages of 128 rows
    over a permuted 129-page pool (the default 1 + 2 x 64), ragged
    positions, in bf16, f32 and int8; against its plain version and, bit
    for bit, against B4 over the gathered contiguous view."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.kernels import flash_decode as fd
    from deepspeed_tpu_torch.ops.transformer.inference import _kv_quant

    B, H, P, page_len, d = 8, 12, 8, 128, 64
    S, NP = P * page_len, 1 + 2 * B * P
    rows = []
    for kv in ("bfloat16", "int8", "float32"):
        g = torch.Generator(device=dev).manual_seed(4321)
        qdtype = torch.float32 if kv == "float32" else torch.bfloat16
        q = torch.randn(B, H, 1, d, generator=g, device=dev).to(qdtype)
        k32 = torch.randn(NP, H, page_len, d, generator=g, device=dev)
        v32 = torch.randn(NP, H, page_len, d, generator=g, device=dev)
        if kv == "int8":
            kc, vc = (dict(zip(("q", "s"), _kv_quant(t))) for t in (k32, v32))
        else:
            kc, vc = k32.to(qdtype), v32.to(qdtype)
        del k32, v32
        perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(5)) + 1
        table = perm[:B * P].reshape(B, P).to(torch.int32).to(dev)
        pos = torch.tensor([0, S - 1, 100, 511, 777, 1, 300, 1000], dtype=torch.int32, device=dev)
        out = fd.flash_decode_paged_cuda(q, kc, vc, table, pos)
        ref = fd.flash_decode_paged_reference(q, kc, vc, table, pos)
        b4 = fd.flash_decode_cuda(q, fd.paged_gather(kc, table), fd.paged_gather(vc, table), pos)
        torch.cuda.synchronize()
        qname = str(qdtype).replace("torch.", "")
        err, tol = max_err(out, ref), TOL[qname]
        check(torch.isfinite(out).all().item(), f"flash_decode_paged {kv}: non-finite")
        check(err <= tol, f"flash_decode_paged {kv}: max_err {err} > tol {tol}")
        check(torch.equal(out, b4), f"flash_decode_paged {kv}: differs from flash_decode over the "
                                    f"gathered view by {max_err(out, b4)} (one body: must be equal)")
        pos_h = pos.cpu()
        nbytes, flops = _decode_cost(kv, pos_h, None, B, H, S, d, q.element_size())
        nbytes += B * P * 4  # the page table
        b_ms, b_by = bound_ms(nbytes, flops, qname)
        library_ms = None
        if kv != "int8":
            ids = table.reshape(-1).long()

            def gather_sdpa():
                gk, gv = (c.index_select(0, ids).view(B, P, H, page_len, d).transpose(1, 2)
                          .reshape(B, H, S, d) for c in (kc, vc))
                return F.scaled_dot_product_attention(q, gk, gv, attn_mask=amask)

            amask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
            library_ms = device_ms(torch, gather_sdpa, flush)
        row = {
            "phase": "kernel", "kernel": "flash_decode_paged", "B": B, "H": H, "P": P,
            "page_len": page_len, "num_pages": NP, "d": d, "kv": kv, "q_dtype": qname,
            "pos": pos_h.tolist(), "max_err": err, "tol": tol, "equal_to_flash_decode_gathered": True,
            "kernel_ms": device_ms(torch, lambda: fd.flash_decode_paged_cuda(q, kc, vc, table, pos),
                                   flush),
            "plain_ms": device_ms(torch, lambda: fd.flash_decode_paged_reference(
                q, kc, vc, table, pos), flush),
            # no single PyTorch call computes this function: two calls,
            # index_select of the pages then SDPA with a boolean mask
            "library_ms": library_ms, "library_calls": "index_select + scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        rows.append(row)
        del kc, vc
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------

def serve(srv, reqs):
    """Submit ``reqs`` (ten, two steps, then the rest, so slots churn
    mid-decode), drain, and return the finished requests in order with
    the drain's wall seconds."""
    import torch

    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs[:10]]
    srv.step()
    srv.step()
    rids += [srv.submit(p, max_new_tokens=n) for p, n in reqs[10:]]
    res = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = [res[r] for r in rids]
    for r, (p, n) in zip(out, reqs):
        check(r.finish_reason == "length" and len(r.generated) == n,
              f"request {r.request_id}: finish {r.finish_reason}, {len(r.generated)} of {n} tokens")
        check(all(0 <= t < 50257 for t in r.generated), f"request {r.request_id}: token out of vocab")
    return out, wall


def top2_gap(eng, tokens):
    """Top-1 minus top-2 logit of the next token after ``tokens``."""
    import torch

    k, v = eng.init_cache(1, len(tokens))
    logits, _, _ = eng.prefill(np.asarray(tokens)[None, :], k, v)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def near_tie_flips(eng, done, wants, label):
    """The first token where each served request's tokens differ from
    the expected ones, which must sit on a near-tie of the top-2 logits
    of ``eng`` (f32)."""
    flips = []
    for r, want in zip(done, wants):
        got = r.tokens()
        if np.array_equal(want, got):
            continue
        i = int(np.nonzero(want != got)[0][0])
        gap = top2_gap(eng, got[:i])
        flips.append({"request": r.request_id, "at": i - r.prompt_len, "top2_gap": gap})
        check(gap < F32_NEAR_TIE,
              f"{label} request {r.request_id}: served token {i - r.prompt_len} differs with "
              f"top-2 gap {gap} >= {F32_NEAR_TIE}")
    return flips


def phase_serve_f32(torch, params, reqs):
    import deepspeed_tpu_torch

    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", params=params, dtype=torch.float32,
        serving={"num_slots": 8, "prefill_chunk": 64})
    done, wall = serve(srv, reqs)
    eng = srv.engine
    solo = [eng.generate(r.prompt[None, :], max_new_tokens=len(r.generated))[0] for r in done]
    flips = near_tie_flips(eng, done, solo, "serve_f32 vs solo generate()")
    emit({"phase": "serve_f32", "requests": len(done),
          "tokens": int(sum(len(r.generated) for r in done)),
          "equal_to_solo_generate": len(done) - len(flips), "near_tie_flips": flips,
          "near_tie_tol": F32_NEAR_TIE, "wall_s": wall})
    del srv, eng


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def phase_serve_bf16(torch, params, reqs):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.transformer.inference import forward_with_cache, init_kv_cache

    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", params=params, dtype=torch.bfloat16,
        serving={"num_slots": 8, "prefill_chunk": 64})
    eng = srv.engine
    gen_ids = np.random.default_rng(7).integers(1, 50257, (4, 256), dtype=np.int32)

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    done, wall = serve(srv, reqs)
    t0 = time.perf_counter()
    gen = eng.generate(gen_ids, max_new_tokens=16)
    gen_wall = time.perf_counter() - t0
    launches = kernels.launches()
    # ----------------------------------------------------------------------

    check(gen.shape == (4, 272) and np.array_equal(gen[:, :256], gen_ids),
          f"generate() returned {gen.shape}")
    for name in ("flash_fwd", "flash_decode"):
        check(launches[name] > 0, f"kernel {name} was not launched on the serving main path")
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    n_tok = int(sum(len(r.generated) for r in done))
    stats = srv.stats()
    emit({"phase": "serve_bf16", "requests": len(done), "tokens": n_tok,
          "ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
          # TTFT counts the queue wait for a slot; decode tokens/s is the
          # decode steps' tokens over their host wall time
          "tokens_per_s": n_tok / wall, "wall_s": wall,
          "decode_tokens_per_s": (n_tok - len(done)) / stats["phase_seconds"]["decode"],
          "decode_steps": stats["decode_steps"], "prefill_chunks": stats["prefill_chunks"],
          "phase_seconds": stats["phase_seconds"],
          "generate": {"B": 4, "T": 256, "new": 16, "wall_s": gen_wall},
          "launches": launches})

    # -- kernel path vs plain path on the card, first-step logits ----------
    cfg = eng.model_config
    S = 256 + 16
    icfg = eng.inference_config(S)
    plain = dataclasses.replace(icfg, use_flash_attention=False)
    toks = torch.from_numpy(gen_ids.astype(np.int64)).to(eng.device)
    errs = {}
    with torch.inference_mode():
        outs = {}
        for name, c in (("kernel", icfg), ("plain", plain)):
            k, v = init_kv_cache(cfg.n_layer, 4, cfg.n_head, S, cfg.head_dim, torch.bfloat16,
                                 device=eng.device)
            pre, _, _ = forward_with_cache(eng.params, toks, k, v, 0, c)
            nxt = torch.argmax(pre[:, -1], dim=-1)[:, None]
            pos = torch.full((4,), 256, dtype=torch.int32, device=eng.device)
            dec, _, _ = forward_with_cache(eng.params, nxt, k, v, pos, c)
            outs[name] = (pre, nxt, dec)
        kp, kn, kd = outs["kernel"]
        pp, pn, pd = outs["plain"]
        errs["prefill"] = max_err(kp, pp)
        errs["decode"] = max_err(kd, pd) if torch.equal(kn, pn) else None
    check(all(torch.isfinite(t).all().item() for t in (kp, kd, pp, pd)), "non-finite logits")
    check(errs["prefill"] <= BF16_LOGIT_TOL, f"bf16 prefill logits differ by {errs['prefill']}")
    check(errs["decode"] is not None and errs["decode"] <= BF16_LOGIT_TOL,
          f"bf16 decode logits differ by {errs['decode']}")
    emit({"phase": "logits_bf16", "B": 4, "T": 256, "max_abs_err": errs, "tol": BF16_LOGIT_TOL,
          "logit_range": [float(pp.min()), float(pp.max())]})
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8: the paged serving path
# ---------------------------------------------------------------------------

PAGED = {"num_slots": 8, "prefill_chunk": 64, "kvcache": {"enabled": True, "page_len": 128}}


def accounted_pages(pool):
    """Pages the host bookkeeping holds: index entries, parked sessions
    and mapped slots (the leak check of the JAX package's tests)."""
    pages = set()
    for e in pool.index.entries():
        pages.update(e.pages)
    for s in pool.sessions.warm():
        pages.update(s.pages)
    for ps in pool._slot_pages.values():
        pages.update(ps)
    return pages


def slot_replay(srv, done):
    """Serve the prompts of ``done`` (with their budgets) on ``srv`` and
    return its tokens in order."""
    rids = [srv.submit(r.prompt, max_new_tokens=len(r.generated)) for r in done]
    res = srv.drain()
    return [res[r].tokens() for r in rids]


def phase_serve_paged_f32(torch, params, mix):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import drain_paged_mix

    srv = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=torch.float32,
                                           serving=PAGED)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    done, turns = drain_paged_mix(srv, mix)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches()
    check(launches["flash_decode_paged"] > 0 and launches["flash_decode"] == 0,
          f"serve_paged_f32: decode launches {launches}")
    kv = srv.stats()["kvcache"]
    check(kv["prefix_hits"] >= 6 and kv["cow_copies"] >= 1 and kv["session_rebinds"] == 2,
          f"serve_paged_f32: kvcache counters {kv}")
    check(srv.pool.live_slots == 0 and kv["pages_live"] == len(accounted_pages(srv.pool)),
          f"serve_paged_f32: {kv['pages_live']} live pages, "
          f"{len(accounted_pages(srv.pool))} accounted for")
    allreq = done + turns
    for r in allreq:
        check(r.finish_reason == "length" and all(0 <= t < 50257 for t in r.generated),
              f"serve_paged_f32 request {r.request_id}: {r.finish_reason}")
    eng = srv.engine
    del srv
    from deepspeed_tpu_torch.serving import ServingEngine

    want = slot_replay(ServingEngine(eng, num_slots=8, prefill_chunk=64), allreq)
    flips = near_tie_flips(eng, allreq, want, "serve_paged_f32 vs the slot engine")
    emit({"phase": "serve_paged_f32", "requests": len(allreq), "session_turns": len(turns),
          "tokens": int(sum(len(r.generated) for r in allreq)),
          "equal_to_slot_engine": len(allreq) - len(flips), "near_tie_flips": flips,
          "near_tie_tol": F32_NEAR_TIE, "kvcache": kv, "launches": launches, "wall_s": wall})
    del eng
    torch.cuda.empty_cache()


def _served_summary(srv, done, wall):
    st = srv.stats()
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in done]
    n_tok = int(sum(len(r.generated) for r in done))
    return {"ttft_ms_p50": _percentile(ttft, 50), "ttft_ms_p99": _percentile(ttft, 99),
            "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
            "decode_tokens_per_s": (n_tok - len(done)) / st["phase_seconds"]["decode"],
            "decode_ms_per_step": st["phase_seconds"]["decode"] / st["decode_steps"] * 1e3,
            "decode_steps": st["decode_steps"], "prefill_chunks": st["prefill_chunks"],
            "phase_seconds": st["phase_seconds"]}


def phase_serve_paged_bf16(torch, params, mix):
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import drain_paged_mix

    out = {}
    # the slot engine on the same mix first (session turns are plain
    # requests there), then the paged engine: the paged serving main path
    slot = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=torch.bfloat16,
                                            serving={"num_slots": 8, "prefill_chunk": 64})
    t0 = time.perf_counter()
    done, turns = drain_paged_mix(slot, mix)
    torch.cuda.synchronize()
    out["slot"] = _served_summary(slot, done + turns, time.perf_counter() - t0)
    del slot
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as spill:
        cfg = {**PAGED, "kvcache": {**PAGED["kvcache"], "spill_dir": spill}}
        srv = deepspeed_tpu_torch.init_serving(model="gpt2", params=params, dtype=torch.bfloat16,
                                               serving=cfg)
        # -- the main path: counters zeroed just before, read just after ---
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        done, turns = drain_paged_mix(srv, mix)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launches()
        # ------------------------------------------------------------------
        out["paged"] = _served_summary(srv, done + turns, wall)
        check(launches["flash_decode_paged"] > 0 and launches["flash_decode"] == 0,
              f"serve_paged_bf16: launches {launches}")
        kv = srv.stats()["kvcache"]
        check(kv["session_rebinds"] == 2 and kv["prefix_hits"] >= 6,
              f"serve_paged_bf16: kvcache counters {kv}")

        # -- a bf16 spill -> restore of the session -------------------------
        pool = srv.pool
        sess = pool.sessions.peek("chat-1")
        n_pages = len(sess.pages)
        before = pool._gather_host(sess.pages)
        check(pool.spill_sessions(time.monotonic()) == 1 and pool.sessions.is_spilled("chat-1"),
              "serve_paged_bf16: session not spilled")
        files = sorted(os.listdir(os.path.join(spill, os.listdir(spill)[0])))
        prompt = np.concatenate([turns[-1].tokens(), mix[1][1][0]])
        rid = srv.submit(prompt, max_new_tokens=8, session_id="chat-1")
        t4 = srv.drain()[rid]
        kv = srv.stats()["kvcache"]
        check(kv["session_restores"] == 1 and kv["session_rebinds"] == 3 and t4.prefix_hint > 0,
              f"serve_paged_bf16: restore {kv}, hit {t4.prefix_hint}")
        # the restored pages hold the spilled rows [0, hit) untouched: the
        # turn wrote positions >= hit only, and parked them again
        after = pool._gather_host(pool.sessions.peek("chat-1").pages[:n_pages])
        hit = t4.prefix_hint

        def head(leaf):  # (L, pages, H, page_len, x) -> (L, H, hit, x)
            L, n, Hh, pl, x = leaf.shape
            return leaf.permute(0, 2, 1, 3, 4).reshape(L, Hh, n * pl, x)[:, :, :hit]

        check(all(torch.equal(head(before[k]), head(after[k])) for k in before),
              "serve_paged_bf16: restored rows differ from the spilled ones")
        check(files == ["kv.npz", "manifest.json", "meta.json"], f"spill files {files}")
        emit({"phase": "serve_paged_bf16", "requests": len(done) + len(turns),
              "paged": out["paged"], "slot": out["slot"], "kvcache": kv,
              "tokens_saved": kv["tokens_saved"],
              "prefill_chunks_saved": out["slot"]["prefill_chunks"] - out["paged"]["prefill_chunks"],
              "spill_restore": {"files": files, "restored_rows": hit, "leaves": sorted(before),
                                "dtype": str(before["k"].dtype)},
              "launches": launches})
        del srv, pool
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 2 (training kernels): flash forward lse, flash backward, fused Adam
# ---------------------------------------------------------------------------

def check_flash_fwd_training(torch, dev, flush):
    """B1 at the training shape with its lse (the residual the backward
    consumes)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 12, 1024, 64
    g = torch.Generator(device=dev).manual_seed(1024)
    q, k, v = (torch.randn(B, H, T, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
    ref, ref_lse = fa.flash_fwd_reference(q, k, v, True, scale)
    torch.cuda.synchronize()
    err, lse_err = max_err(out, ref), max_err(lse, ref_lse)
    check(err <= TOL["bfloat16"], f"flash_fwd training shape: max_err {err}")
    check(lse_err <= 1e-4, f"flash_fwd training shape: lse max_err {lse_err} > 1e-4")
    b_ms, b_by = bound_ms(4 * B * H * T * d * 2 + B * H * T * 4, 4 * B * H * d * T * (T + 1) / 2,
                          "bfloat16")
    row = {
        "phase": "kernel", "kernel": "flash_fwd", "B": B, "H": H, "T": T, "d": d,
        "dtype": "bfloat16", "causal": True, "lse": True, "max_err": err, "lse_max_err": lse_err,
        "tol": TOL["bfloat16"], "lse_tol": 1e-4,
        "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True),
                               flush),
        "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, True, scale), flush,
                              iters=5),
        "library_ms": device_ms(
            torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), flush),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(row)
    return row


def check_flash_bwd(torch, dev, flush):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    rows = []
    for B, T, dtype in ((8, 1024, torch.bfloat16), (8, 1024, torch.float32),
                        (8, 256, torch.bfloat16), (8, 1000, torch.bfloat16)):
        H, d = 12, 64
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device=dev).manual_seed(T + 7)
        q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype) for _ in range(4))
        scale = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, True, scale, want_lse=True)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale)
        ref = fa.flash_bwd_reference(q, k, v, do, lse, delta, True, scale)
        torch.cuda.synchronize()
        errs, over = zip(*(grad_err(a, b, TOL[name]) for a, b in zip(got, ref)))
        rms = [float(b.float().square().mean().sqrt()) for b in ref]
        for grad, e, w in zip(("dq", "dk", "dv"), errs, over):
            check(w <= 1.0, f"flash_bwd B={B} T={T} {name}: {grad} max_err {e} is {w:.3g}x "
                            f"its entry bound {TOL[name]} * (|ref| + {BWD_RMS_SHARE} * rms(ref))")
        check(all(torch.isfinite(a).all().item() for a in got), f"flash_bwd T={T} {name}: non-finite")
        item = dtype.itemsize
        pairs = T * (T + 1) / 2  # causal (query, key) pairs
        nbytes = 7 * B * H * T * d * item + 2 * B * H * T * 4
        flops = 5 * 2 * d * pairs * B * H  # s, dp, dv, dk, dq products
        b_ms, b_by = bound_ms(nbytes, flops, name)
        # the library yardstick: SDPA's backward through autograd, timed only
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        row = {
            "phase": "kernel", "kernel": "flash_bwd", "B": B, "H": H, "T": T, "d": d,
            "dtype": name, "causal": True, "max_err": max(errs), "max_err_dq_dk_dv": list(errs),
            "err_over_bound_dq_dk_dv": list(over), "rms_dq_dk_dv": rms, "tol": TOL[name],
            "tol_rms_share": BWD_RMS_SHARE,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(q, k, v, do, lse, delta, True, scale),
                                   flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(q, k, v, do, lse, delta, True,
                                                                         scale), flush, iters=5),
            "library_ms": device_ms(torch, lambda: torch.autograd.grad(
                lout, (ql, kl, vl), do, retain_graph=True), flush, iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        del lout
        emit(row)
        rows.append(row)
    return rows


def check_fused_adam(torch, dev, flush):
    """B3 per leaf (wte, stacked qkv_w, ragged lnf_g) and over one step's
    16 leaves of GPT-2 124M, f32 masters and grads."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.kernels import fused_update as fu

    cfg = gpt2.PRESETS["gpt2"]
    d, L = cfg.n_embd, cfg.n_layer
    step_shapes = [(cfg.vocab_size, d), (cfg.n_positions, d), (d,), (d,),
                   (L, d), (L, d), (L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d),
                   (L, d), (L, d), (L, d, 4 * d), (L, 4 * d), (L, 4 * d, d), (L, d)]
    check(sum(int(np.prod(s)) for s in step_shapes) == cfg.num_params(), "GPT-2 leaf shapes")
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, adam_w_mode=True)
    g = torch.Generator(device=dev).manual_seed(3)

    def leaves(shapes):
        out = []
        for shp in shapes:
            p = torch.randn(shp, generator=g, device=dev) * 0.02
            out.append((p, torch.randn(shp, generator=g, device=dev) * 1e-3,
                        torch.randn(shp, generator=g, device=dev) * 1e-4,
                        torch.rand(shp, generator=g, device=dev) * 1e-7))
        return out

    scal = torch.tensor([6e-4, 1.0, 1.0 - 0.9 ** 3, 1.0 - 0.95 ** 3], device=dev)

    def run_kernel(ls):
        for p, gr, m, v in ls:
            fu.adam_leaf_cuda(p, gr, m, v, scal, **hyper)

    def run_plain(ls):
        for p, gr, m, v in ls:
            fu._adam_keep_body(p, gr, m, v, *scal.unbind(0), **hyper)

    def library(ls):
        params = [torch.nn.Parameter(p.clone()) for p, _, _, _ in ls]
        for prm, (_, gr, _, _) in zip(params, ls):
            prm.grad = gr
        opt = torch.optim.AdamW(params, lr=6e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                                fused=True)
        return opt.step

    rows = []
    for label, shapes in (("wte", [step_shapes[0]]), ("qkv_w", [step_shapes[6]]),
                          ("lnf_g", [step_shapes[2]]), ("step_16_leaves", step_shapes)):
        ls = leaves(shapes)
        ref = [fu._adam_keep_body(p, gr, m, v, *scal.unbind(0), **hyper) for p, gr, m, v in ls]
        work = [tuple(t.clone() for t in leaf) for leaf in ls]
        run_kernel(work)
        torch.cuda.synchronize()
        got = {"p": [w[0] for w in work], "m": [w[2] for w in work], "v": [w[3] for w in work]}
        errs, tols = {}, {}
        for i, part in enumerate(("p", "m", "v")):
            ref_i = [r[i] for r in ref]
            errs[part] = max(max_err(a, b) for a, b in zip(got[part], ref_i))
            tols[part] = ADAM_RTOL * max(float(b.abs().max()) for b in ref_i)
            check(errs[part] <= tols[part],
                  f"fused_adam {label}: {part} max_err {errs[part]} > tol {tols[part]} "
                  f"({ADAM_RTOL} of its largest entry)")
        err = max(errs.values())
        n = sum(int(np.prod(s)) for s in shapes)
        b_ms, b_by = bound_ms(ADAM_BYTES_PER_ELEM * n, ADAM_FLOPS_PER_ELEM * n, "float32")
        row = {
            "phase": "kernel", "kernel": "fused_adam", "leaves": label, "launches_per_call": len(shapes),
            "elements": n, "p_dtype": "float32", "max_err": err, "max_err_p_m_v": errs,
            "tol_p_m_v": tols,
            "kernel_ms": device_ms(torch, lambda: run_kernel(work), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: run_plain(work), flush, iters=5),
            "library_ms": device_ms(torch, library(work), flush, iters=10),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        rows.append(row)
        del ls, ref, work
    return rows


def bert_leaf_shapes(cfg):
    """The 26 leaf shapes of a BERT parameter tree (the layers stacked on
    a leading dim), checked against ``num_params``."""
    d, L, i, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size, cfg.vocab_size
    shapes = [(V, d), (cfg.max_position_embeddings, d), (cfg.type_vocab_size, d), (d,), (d,),
              (L, d), (L, d), (L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d),
              (L, d), (L, d), (L, d, i), (L, i), (L, i, d), (L, d),
              (d, d), (d,), (d, d), (d,), (d,), (d,), (V,), (d, 2), (2,)]
    check(len(shapes) == 26 and sum(int(np.prod(s)) for s in shapes) == cfg.num_params(),
          "BERT leaf shapes")
    return shapes


def check_fused_lamb(torch, dev, flush):
    """B7a and B7b per leaf (``tok_emb``, stacked ``qkv_w``, ragged
    ``mlm_bias`` and ``nsp_b``) and over one step's 26 leaves of
    BERT-large, f32 masters and grads, with and without bias correction.
    Leaves alternate between weight scale 0.02 and 1, and the 1-D
    ``mlm_bias`` is zero (its init), so the trust ratio takes its three
    branches: inside the clamp, at ``max_coeff`` 0.3, and 1."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops.kernels import fused_update as fu

    shapes = bert_leaf_shapes(bert.BERT_LARGE)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    clamp = dict(min_coeff=0.01, max_coeff=0.3)
    g = torch.Generator(device=dev).manual_seed(17)

    def leaves(idx):
        out = []
        for j in idx:
            shp = shapes[j]
            scale = 0.0 if j == 23 else (0.02 if j % 2 == 0 else 1.0)
            p = torch.randn(shp, generator=g, device=dev) * scale
            out.append((p, torch.randn(shp, generator=g, device=dev) * 1e-3,
                        torch.randn(shp, generator=g, device=dev) * 1e-4,
                        torch.rand(shp, generator=g, device=dev) * 1e-7))
        return out

    rows = []
    for bias_correction in (True, False):
        c1, c2 = (1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3) if bias_correction else (1.0, 1.0)
        scal = torch.tensor([2e-3, 1.0, c1, c2], device=dev)
        for label, idx in (("tok_emb", [0]), ("qkv_w", [7]), ("mlm_bias", [23]), ("nsp_b", [25]),
                           ("step_26_leaves", list(range(26)))):
            if label != "step_26_leaves" and not bias_correction:
                continue  # the single leaves once; the whole step in both modes
            ls = leaves(idx)
            ref = [fu._lamb_math(p, gr, m, v, *scal.unbind(0), **hyper, **clamp)
                   for p, gr, m, v in ls]
            work = [tuple(t.clone() for t in leaf) for leaf in ls]
            dir_buf = torch.empty(max(p.numel() for p, _, _, _ in ls), device=dev)
            trusts = [fu.lamb_leaf_cuda(*w, scal, dir_buf=dir_buf, **hyper, **clamp) for w in work]
            torch.cuda.synchronize()
            errs, tols = {}, {}
            # work leaves are (p, g, m, v); _lamb_math returns (p, m, v, trust)
            for part, wi, ri in (("p", 0, 0), ("m", 2, 1), ("v", 3, 2)):
                ref_i = [r[ri] for r in ref]
                errs[part] = max(max_err(w[wi], b) for w, b in zip(work, ref_i))
                tols[part] = LAMB_RTOL * max(float(b.abs().max()) for b in ref_i)
                check(errs[part] <= tols[part],
                      f"fused_lamb {label}: {part} max_err {errs[part]} > tol {tols[part]} "
                      f"({LAMB_RTOL} of its largest entry)")
            t_ref = torch.stack([r[3].reshape(()) for r in ref])
            t_got = torch.cat(trusts)
            t_rel = float(((t_got - t_ref).abs() / t_ref).max())
            check(t_rel <= LAMB_TRUST_RTOL, f"fused_lamb {label}: trust off by {t_rel} relative")
            branches = {"at_max": int((t_ref == 0.3).sum()), "one": int((t_ref == 1.0).sum()),
                        "inside": int(((t_ref > 0.01) & (t_ref < 0.3)).sum())}
            n = sum(p.numel() for p, _, _, _ in ls)
            # each pass timed alone: pass 1 over every leaf (m and v move on
            # each repeat), pass 2 over every leaf with the trusts found above
            dir_k = device_ms(torch, lambda: [fu.lamb_dir_cuda(*w, scal, dir_buf, **hyper)
                                              for w in work], flush, iters=10)
            apply_k = device_ms(torch, lambda: [fu.lamb_apply_cuda(w[0], dir_buf, scal, t)
                                                for w, t in zip(work, trusts)], flush, iters=10)

            def plain_dir():
                for p, gr, m, v in work:
                    d, _, _ = fu._lamb_dir_body(p, gr, m, v, *scal.unbind(0)[1:], **hyper)
                    torch.linalg.vector_norm(p), torch.linalg.vector_norm(d)

            def plain_apply():
                lr, keep = scal[0], scal[1]
                for (p, _, _, _), t in zip(work, trusts):
                    (p - keep * lr * t * dir_buf[:p.numel()].view_as(p)).to(p.dtype)

            both = device_ms(torch, lambda: [fu.lamb_leaf_cuda(*w, scal, dir_buf=dir_buf, **hyper,
                                                               **clamp) for w in work],
                             flush, iters=10)
            for kernel, k_ms, plain_fn, nbytes, flops in (
                ("fused_lamb_dir", dir_k, plain_dir, LAMB_DIR_BYTES, LAMB_DIR_FLOPS),
                ("fused_lamb_apply", apply_k, plain_apply, LAMB_APPLY_BYTES, LAMB_APPLY_FLOPS),
            ):
                b_ms, b_by = bound_ms(nbytes * n, flops * n, "float32")
                row = {
                    "phase": "kernel", "kernel": kernel, "leaves": label,
                    "bias_correction": bias_correction, "launches_per_call": len(ls),
                    "elements": n, "p_dtype": "float32", "max_err": max(errs.values()),
                    "max_err_p_m_v": errs, "tol_p_m_v": tols, "trust_max_rel_err": t_rel,
                    "trust_tol": LAMB_TRUST_RTOL, "trust_branches": branches,
                    "kernel_ms": k_ms, "both_passes_with_trust_ms": both,
                    "plain_ms": device_ms(torch, plain_fn, flush, iters=5),
                    # torch.optim has no LAMB: no one PyTorch call computes it
                    "library_ms": None, "library": "none (torch.optim has no LAMB)",
                    "bound_ms": b_ms, "bound_by": b_by,
                }
                emit(row)
                rows.append(row)
            del ls, ref, work, dir_buf
    return rows


def _bias_inputs(torch, dev, B, H, T, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype) for _ in range(4))
    keep = [BIAS_KEEP[b % len(BIAS_KEEP)] * T // 512 for b in range(B)]
    kb = torch.zeros(B, T, device=dev)
    for b, n in enumerate(keep):
        kb[b, n:] = -1e9
    return q, k, v, do, kb, keep


def check_flash_bias(torch, dev, flush):
    """B1 (with lse) and B2 with BERT-large's key-padding bias at B=8,
    H=16, T=512, d=64, non-causal, in bf16 and f32: rows keep 512, 448, 300
    and 129 keys.  A padded key's p must be exactly 0, so its dk and dv
    rows must be exactly 0."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 16, 512, 64
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v, do, kb, keep = _bias_inputs(torch, dev, B, H, T, d, dtype, seed=512)
        scale = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, kbias=kb)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, False, scale, kb)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, False, scale, kbias=kb)
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, False, scale, kb)
        torch.cuda.synchronize()
        err, lse_err, tol = max_err(out, ref), max_err(lse, ref_lse), TOL[name]
        check(torch.isfinite(out).all().item(), f"flash_fwd kbias {name}: non-finite output")
        check(err <= tol, f"flash_fwd kbias {name}: max_err {err} > tol {tol}")
        check(lse_err <= 1e-4, f"flash_fwd kbias {name}: lse max_err {lse_err} > 1e-4")
        errs, over = zip(*(grad_err(a, b, tol) for a, b in zip(got, refb)))
        for grad, e, w in zip(("dq", "dk", "dv"), errs, over):
            check(w <= 1.0, f"flash_bwd kbias {name}: {grad} max_err {e} is {w:.3g}x its entry "
                            f"bound {tol} * (|ref| + {BWD_RMS_SHARE} * rms(ref))")
        check(all(torch.isfinite(a).all().item() for a in got), f"flash_bwd kbias {name}: non-finite")
        padded = max(float(torch.cat([got[1][b, :, n:], got[2][b, :, n:]]).abs().max())
                     for b, n in enumerate(keep) if n < T)
        check(padded == 0.0, f"flash_bwd kbias {name}: a padded key's dk/dv is {padded}, not 0")
        item = dtype.itemsize
        mask = kb[:, None, None, :].to(dtype)  # SDPA's float mask, in q's type
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * item + B * H * T * 4 + B * T * 4,
                                4 * B * H * d * T * T, name)
        rows[("flash_fwd", name)] = {
            "phase": "kernel", "kernel": "flash_fwd", "bias": "kbias (B, 1, 1, T)", "B": B,
            "H": H, "T": T, "d": d, "dtype": name, "causal": False, "lse": True,
            "keys_kept": keep, "max_err": err, "lse_max_err": lse_err, "tol": tol, "lse_tol": 1e-4,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, False, scale, want_lse=True, kbias=kb), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(q, k, v, False, scale, kb),
                                  flush, iters=5),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * item + 2 * B * H * T * 4 + B * T * 4,
                                5 * 2 * d * T * T * B * H, name)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lout = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        rows[("flash_bwd", name)] = {
            "phase": "kernel", "kernel": "flash_bwd", "bias": "kbias (B, 1, 1, T)", "B": B,
            "H": H, "T": T, "d": d, "dtype": name, "causal": False, "keys_kept": keep,
            "max_err": max(errs), "max_err_dq_dk_dv": list(errs),
            "err_over_bound_dq_dk_dv": list(over), "padded_keys_dk_dv_max": padded, "tol": tol,
            "tol_rms_share": BWD_RMS_SHARE,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, False, scale, kbias=kb), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, False, scale, kb), flush, iters=5),
            "library_ms": device_ms(torch, lambda: torch.autograd.grad(
                lout, (ql, kl, vl), do, retain_graph=True), flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del lout
        emit(rows[("flash_fwd", name)])
        emit(rows[("flash_bwd", name)])
    return rows


def _sdpa_grad(torch, F, q, k, v, do, **kw):
    """SDPA's backward through autograd on fresh leaves, for timing: a
    callable that recomputes the gradients of one forward."""
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lout = F.scaled_dot_product_attention(ql, kl, vl, **kw)
    return lambda: torch.autograd.grad(lout, (ql, kl, vl), do, retain_graph=True)


def _check_bwd_rows(got, ref, tol, label, rms_share=BWD_RMS_SHARE):
    errs, over = zip(*(grad_err(a, b, tol, rms_share) for a, b in zip(got, ref)))
    for grad, e, w in zip(("dq", "dk", "dv"), errs, over):
        check(w <= 1.0, f"{label}: {grad} max_err {e} is {w:.3g}x its entry bound "
                        f"{tol} * (|ref| + {rms_share} * rms(ref))")
    check(all(a.isfinite().all().item() for a in got), f"{label}: non-finite gradient")
    return list(errs), list(over)


def _padded_zero(got, keep, T):
    """The largest |dk|, |dv| over padded keys (must be exactly 0)."""
    return max(float(max(got[1][b, :, n:].abs().max(), got[2][b, :, n:].abs().max()))
               for b, n in enumerate(keep) if n < T)


def check_flash_dropout(torch, dev, flush):
    """B1 (with lse) and B2 with BERT-large's key-padding bias and
    attention dropout 0.1 (in-kernel Threefry bits) at B=8, H=16, T=512,
    d=64, non-causal, in bf16 and f32, against the plain versions on the
    same key words (the host twin's bits).  A single wrong keep-bit moves
    an f32 output by ~|v| / (0.9 T) ~ 2e-3, a hundred times the bound.
    Library: SDPA with ``dropout_p`` 0.1 and the float mask (its own random
    stream: the time alone is compared)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 16, 512, 64
    drop = fa.make_dropout(DROP_RATE, DROP_KEY)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v, do, kb, keep = _bias_inputs(torch, dev, B, H, T, d, dtype, seed=513)
        scale = d ** -0.5
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, kbias=kb, drop=drop)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, False, scale, kb, None, drop)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, False, scale, kb, None, drop)
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, False, scale, kb, None, drop)
        torch.cuda.synchronize()
        err, lse_err, tol = max_err(out, ref), max_err(lse, ref_lse), TOL[name]
        check(torch.isfinite(out).all().item(), f"flash_fwd kbias+dropout {name}: non-finite")
        check(err <= tol, f"flash_fwd kbias+dropout {name}: max_err {err} > tol {tol}")
        check(lse_err <= 1e-4, f"flash_fwd kbias+dropout {name}: lse max_err {lse_err} > 1e-4")
        errs, over = _check_bwd_rows(got, refb, tol, f"flash_bwd kbias+dropout {name}")
        padded = _padded_zero(got, keep, T)
        check(padded == 0.0, f"flash_bwd kbias+dropout {name}: a padded key's dk/dv is {padded}")
        item = dtype.itemsize
        mask = kb[:, None, None, :].to(dtype)
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * item + B * H * T * 4 + B * T * 4,
                                4 * B * H * d * T * T, name)
        rows[("flash_fwd", name)] = {
            "phase": "kernel", "kernel": "flash_fwd", "bias": "kbias (B, 1, 1, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "lse": True, "keys_kept": keep, "max_err": err,
            "lse_max_err": lse_err, "tol": tol, "lse_tol": 1e-4,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, False, scale, want_lse=True, kbias=kb, drop=drop), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, False, scale, kb, None, drop), flush, iters=3),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=DROP_RATE), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
            "bound_note": "the dots' operations; Threefry's integer operations have no "
                          "peak in the table and are left out",
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * item + 2 * B * H * T * 4 + B * T * 4,
                                5 * 2 * d * T * T * B * H, name)
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=mask, dropout_p=DROP_RATE)
        rows[("flash_bwd", name)] = {
            "phase": "kernel", "kernel": "flash_bwd", "bias": "kbias (B, 1, 1, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "keys_kept": keep, "max_err": max(errs), "max_err_dq_dk_dv": errs,
            "err_over_bound_dq_dk_dv": over, "padded_keys_dk_dv_max": padded, "tol": tol,
            "tol_rms_share": BWD_RMS_SHARE,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, False, scale, kb, None, drop), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, False, scale, kb, None, drop), flush, iters=3),
            "library_ms": device_ms(torch, sdpa_bwd, flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del sdpa_bwd
        emit(rows[("flash_fwd", name)])
        emit(rows[("flash_bwd", name)])
    return rows


def check_flash_fbias(torch, dev, flush):
    """B1 and B2 with the full bias form, read through its broadcast
    strides, at B=8, H=16, T=512, d=64 with dropout 0.1: a (8, 1, 512, 512)
    mask (the key padding plus a seq2seq pattern: each row's second half
    attends causally within it) in bf16 and f32 against the plain
    versions, and, in f32, a trainable (1, 16, 512, 512) bias through
    ``flash_attention``'s autograd (its cotangent under dropout) against
    the plain path with the host twin's keep-mask."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d = 8, 16, 512, 64
    drop = fa.make_dropout(DROP_RATE, DROP_KEY)
    scale = d ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        q, k, v, do, kb, keep = _bias_inputs(torch, dev, B, H, T, d, dtype, seed=514)
        mask4 = seq2seq_mask(torch, kb, T)
        fb = mask4.expand(B, H, T, T)
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, fbias=fb, drop=drop)
        ref, ref_lse = fa.flash_fwd_reference(q, k, v, False, scale, None, fb, drop)
        delta = (do.float() * out.float()).sum(-1)
        got = fa.flash_bwd_cuda(q, k, v, do, lse, delta, False, scale, None, fb, drop)
        refb = fa.flash_bwd_reference(q, k, v, do, lse, delta, False, scale, None, fb, drop)
        torch.cuda.synchronize()
        err, lse_err, tol = max_err(out, ref), max_err(lse, ref_lse), TOL[name]
        check(torch.isfinite(out).all().item(), f"flash_fwd fbias {name}: non-finite")
        check(err <= tol, f"flash_fwd fbias {name}: max_err {err} > tol {tol}")
        check(lse_err <= 1e-4, f"flash_fwd fbias {name}: lse max_err {lse_err} > 1e-4")
        errs, over = _check_bwd_rows(got, refb, tol, f"flash_bwd fbias {name}")
        item = dtype.itemsize
        smask = mask4.to(dtype)
        bias_bytes = B * T * T * 4  # the (8, 1, 512, 512) f32 mask, read once
        fb_ms, fb_by = bound_ms(4 * B * H * T * d * item + B * H * T * 4 + bias_bytes,
                                4 * B * H * d * T * T, name)
        rows[("flash_fwd", name)] = {
            "phase": "kernel", "kernel": "flash_fwd", "bias": "fbias (B, 1, T, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "lse": True, "max_err": err, "lse_max_err": lse_err, "tol": tol,
            "kernel_ms": device_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, False, scale, want_lse=True, fbias=fb, drop=drop), flush),
            "plain_ms": device_ms(torch, lambda: fa.flash_fwd_reference(
                q, k, v, False, scale, None, fb, drop), flush, iters=3),
            "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=smask, dropout_p=DROP_RATE), flush),
            "bound_ms": fb_ms, "bound_by": fb_by,
        }
        bb_ms, bb_by = bound_ms(7 * B * H * T * d * item + 2 * B * H * T * 4 + bias_bytes,
                                5 * 2 * d * T * T * B * H, name)
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=smask, dropout_p=DROP_RATE)
        rows[("flash_bwd", name)] = {
            "phase": "kernel", "kernel": "flash_bwd", "bias": "fbias (B, 1, T, T)",
            "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
            "causal": False, "max_err": max(errs), "max_err_dq_dk_dv": errs,
            "err_over_bound_dq_dk_dv": over, "tol": tol, "tol_rms_share": BWD_RMS_SHARE,
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(
                q, k, v, do, lse, delta, False, scale, None, fb, drop), flush, iters=10),
            "plain_ms": device_ms(torch, lambda: fa.flash_bwd_reference(
                q, k, v, do, lse, delta, False, scale, None, fb, drop), flush, iters=3),
            "library_ms": device_ms(torch, sdpa_bwd, flush, iters=10),
            "bound_ms": bb_ms, "bound_by": bb_by,
        }
        del sdpa_bwd
        emit(rows[("flash_fwd", name)])
        emit(rows[("flash_bwd", name)])

    # a trainable per-head bias under dropout, through the autograd function
    g = torch.Generator(device=dev).manual_seed(515)
    q, k, v, w = (torch.randn(B, H, T, d, generator=g, device=dev) for _ in range(4))
    bias = torch.randn(1, H, T, T, generator=g, device=dev) * 0.5
    grads = {}
    for label in ("kernels", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        if label == "kernels":
            out = fa.flash_attention(*leaves[:3], bias=leaves[3], dropout_rate=DROP_RATE,
                                     dropout_rng=DROP_KEY)
        else:
            m4 = fa.dropout_keep_mask_host(DROP_KEY, B, H, T, T, 1 - DROP_RATE, dev)
            out = fa.mha_reference(*leaves[:3], bias=leaves[3], dropout_mask=m4.view(B, H, T, T),
                                   keep_prob=1 - DROP_RATE)
        (out * w).sum().backward()
        grads[label] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    rel = [max_err(a, b) / float(b.abs().max()) for a, b in zip(grads["kernels"], grads["plain"])]
    check(max(rel) <= AUTOGRAD_F32_RTOL,
          f"trainable fbias under dropout: dq/dk/dv/dbias differ by {rel} of their largest "
          f"entries > {AUTOGRAD_F32_RTOL}")
    rows["trainable_bias"] = {
        "phase": "kernel", "kernel": "flash_attention (B1, B2, the bias cotangent)",
        "bias": "trainable (1, H, T, T)", "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d,
        "dtype": "float32", "rel_err_dq_dk_dv_dbias": rel, "tol": AUTOGRAD_F32_RTOL}
    emit(rows["trainable_bias"])
    return rows


def seq2seq_mask(torch, kb, T):
    """A (B, 1, T, T) f32 mask: the key padding of ``kb`` (B, T), plus a
    seq2seq (UniLM) pattern, in which every query sees the first half of
    the row and a query in the second half sees the second half causally."""
    half = T // 2
    pos = torch.arange(T, device=kb.device)
    allowed = (pos[None, :] < half) | (pos[None, :] <= pos[:, None])  # (T, T)
    return torch.where(allowed[None, None], kb[:, None, None, :],
                       torch.full((), -1e9, device=kb.device)).float().contiguous()


def _bwd2_float64(torch, fa, args):
    """The two-pass backward's function in float64, head by head, on the
    same inputs (lse, delta, the f32 keep factor): the yardstick that
    tells the f32 kernel's summation error from the f32 plain version's.
    Returns ``(dq, dk, dv)`` in float64."""
    q, k, v, do, lse, delta, _, scale, kb, _, drop = args
    keep = fa.keep_mask(drop, q, k)
    grads = ([], [], [])
    for h in range(q.shape[1]):
        qh, kh, vh, doh = (t[0, h].double() for t in (q, k, v, do))
        p = torch.exp(qh @ kh.T * scale + kb[0].double()[None, :]
                      - lse[0, h].double()[:, None])
        f = (keep[0, h].float() / drop.keep_prob).double()
        ds = p * ((doh @ vh.T) * f - delta[0, h].double()[:, None]) * scale
        for out, g in zip(grads, (ds @ kh, ds.T @ qh, (p * f).T @ doh)):
            out.append(g)
        del p, f, ds
    del keep
    return tuple(torch.stack(g)[None] for g in grads)


def check_flash_bwd2(torch, dev, flush):
    """B6a (dq pass) and B6b (dk/dv pass) at one long sequence, B=1, H=16,
    T=9216, d=64 (past d 64's 8,192-row bound of the fused backward), in
    bf16 and f32, with a key-padding bias keeping 8,000 keys and dropout
    0.1: against the two-pass plain version, against B2 on the same
    inputs, in f32 against the float64 function (:func:`_bwd2_float64`;
    the plain version's own error beside the kernel's), and dq the same
    bits over two launches.  Bound by operations:
    the dq pass 6 T^2 d B H, the dk/dv pass 8 T^2 d B H (14 together).
    Library: SDPA's backward with the float mask (the whole backward, for
    both rows)."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    B, H, T, d, kept = 1, 16, LONG_T, 64, LONG_KEEP
    drop = fa.make_dropout(DROP_RATE, DROP_KEY)
    scale = d ** -0.5
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        g = torch.Generator(device=dev).manual_seed(9216)
        q, k, v, do = (torch.randn(B, H, T, d, generator=g, device=dev).to(dtype)
                       for _ in range(4))
        kb = torch.zeros(B, T, device=dev)
        kb[:, kept:] = -1e9
        out, lse = fa.flash_fwd_cuda(q, k, v, False, scale, want_lse=True, kbias=kb, drop=drop)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, False, scale, kb, None, drop)
        got = fa.flash_bwd2_cuda(*args)
        again = fa.flash_bwd_dq_cuda(*args)
        b2 = fa.flash_bwd_cuda(*args)
        torch.cuda.synchronize()
        tol = TOL[name]
        check(torch.equal(got[0], again), f"flash_bwd_dq {name}: dq differs between two launches")
        b2_errs, b2_over = _check_bwd_rows(got, b2, tol, f"flash_bwd2 vs flash_bwd {name}",
                                           LONG_RMS_SHARE)
        torch.cuda.empty_cache()
        ref = fa.flash_bwd2_reference(*args)
        torch.cuda.synchronize()
        errs, over = _check_bwd_rows(got, ref, tol, f"flash_bwd2 {name}", LONG_RMS_SHARE)
        f64 = {}
        if dtype == torch.float32:
            # both f32 results against float64, at the unscaled rms share
            torch.cuda.empty_cache()
            exact = _bwd2_float64(torch, fa, args)
            for label, res in (("kernel", got), ("plain", ref)):
                f64[label + "_vs_f64_over_bound_dq_dk_dv"] = [
                    grad_err(a, b, tol)[1] for a, b in zip(res, exact)]
            emit({"phase": "kernel", "kernel": "flash_bwd2 vs float64", "dtype": name, "T": T,
                  "tol": tol, "tol_rms_share": BWD_RMS_SHARE, **f64})
            _check_bwd_rows(got, exact, tol, f"flash_bwd2 {name} vs float64", LONG_RMS_SHARE)
            del exact
        del ref
        torch.cuda.empty_cache()
        padded = _padded_zero(got, [kept], T)
        check(padded == 0.0, f"flash_bwd2 {name}: a padded key's dk/dv is {padded}")
        item = dtype.itemsize
        small = 2 * B * H * T * 4 + B * T * 4  # lse, delta, the bias row
        sdpa_bwd = _sdpa_grad(torch, F, q, k, v, do, attn_mask=kb[:, None, None, :].to(dtype))
        library_ms = device_ms(torch, sdpa_bwd, flush, iters=3, warmup=1)
        del sdpa_bwd
        for kernel, fn, plain, nbytes, flops in (
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq_cuda(*args),
             lambda: fa.flash_bwd_dq_reference(*args), 5 * B * H * T * d * item + small,
             6 * T * T * d * B * H),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv_cuda(*args),
             lambda: fa.flash_bwd_dkv_reference(*args), 6 * B * H * T * d * item + small,
             8 * T * T * d * B * H),
        ):
            b_ms, b_by = bound_ms(nbytes, flops, name)
            rows[(kernel, name)] = {
                "phase": "kernel", "kernel": kernel, "bias": "kbias (B, 1, 1, T)",
                "dropout": DROP_RATE, "B": B, "H": H, "T": T, "d": d, "dtype": name,
                "causal": False, "keys_kept": kept, "max_err": max(errs),
                "max_err_dq_dk_dv": errs, "err_over_bound_dq_dk_dv": over,
                "vs_flash_bwd_max_err_dq_dk_dv": b2_errs, "vs_flash_bwd_over_bound": b2_over,
                "dq_bitwise_repeatable": True, "padded_keys_dk_dv_max": padded, "tol": tol,
                "tol_rms_share": LONG_RMS_SHARE, **f64,
                "kernel_ms": device_ms(torch, fn, flush, iters=3, warmup=1),
                "plain_ms": device_ms(torch, plain, flush, iters=1, warmup=0),
                "library_ms": library_ms, "library": "SDPA's whole backward (float mask)",
                "bound_ms": b_ms, "bound_by": b_by,
            }
            torch.cuda.empty_cache()
        rows[("flash_bwd", name)] = {
            "kernel_ms": device_ms(torch, lambda: fa.flash_bwd_cuda(*args), flush, iters=3,
                                   warmup=1)}
        emit(rows[("flash_bwd_dq", name)])
        emit(rows[("flash_bwd_dkv", name)])
        emit({"phase": "kernel", "kernel": "flash_bwd", "B": B, "H": H, "T": T, "d": d,
              "dtype": name, "bias": "kbias (B, 1, 1, T)", "dropout": DROP_RATE,
              "kernel_ms": rows[("flash_bwd", name)]["kernel_ms"],
              "note": "B2 on B6's inputs, for comparison"})
        del q, k, v, do, out, lse, delta, got, again, b2, args
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 5 and 6: the training path
# ---------------------------------------------------------------------------

def _train(torch, model_fn, params, config, batch, steps):
    import deepspeed_tpu_torch

    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=params,
                                                     config=config)
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        losses.append(float(loss))  # the host read ends the step
        walls.append(time.perf_counter() - t0)
    return engine, losses, walls


def phase_train_f32(torch, params):
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    cfg = gpt2.PRESETS["gpt2"]
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}}}
    batch = {"input_ids": np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 1024),
                                                             dtype=np.int32)}
    out = {}
    for name, c in (("kernels", cfg), ("plain_attention", dataclasses.replace(
            cfg, use_flash_attention=False))):
        kernels.reset_launches()
        engine, losses, walls = _train(torch, gpt2.make_model(c)[0], params, config, batch, 3)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": kernels.launches()}
        del engine
        torch.cuda.empty_cache()
    check(out["kernels"]["launches"]["flash_bwd"] > 0 and out["plain_attention"]["launches"]["flash_bwd"] == 0,
          f"train_f32: flash launches {out['kernels']['launches']} / {out['plain_attention']['launches']}")
    k, p = out["kernels"]["losses"], out["plain_attention"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_f32: non-finite loss {k} / {p}")
    check(max(rel) <= TRAIN_F32_LOSS_RTOL,
          f"train_f32: kernel vs plain losses differ by {max(rel)} > {TRAIN_F32_LOSS_RTOL}")
    emit({"phase": "train_f32", "B": 2, "T": 1024, "steps": 3, "allow_tf32": False,
          "losses": out, "max_rel_diff": max(rel), "tol": TRAIN_F32_LOSS_RTOL})


def phase_train_bf16(torch, params):
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels

    cfg = gpt2.PRESETS["gpt2"]
    mb, gas, T, steps = 8, 2, 1024, 4
    config = {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                  "weight_decay": 0.1}},
        # warmup_min_lr > 0: the log warmup's first step would otherwise run
        # at lr 0 and update nothing
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 6e-5,
            "warmup_max_lr": 6e-4}},
    }
    batch = {"input_ids": np.random.default_rng(12).integers(0, cfg.vocab_size, (mb * gas, T),
                                                             dtype=np.int32)}
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    engine, losses, walls = _train(torch, gpt2.make_model(cfg)[0], params, config, batch, steps)
    launches = kernels.launches()
    # ----------------------------------------------------------------------

    for name in ("flash_fwd", "flash_bwd", "fused_adam"):
        check(launches[name] > 0, f"kernel {name} was not launched on the training main path")
    check(all(np.isfinite(losses)), f"train_bf16: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_bf16: loss did not fall: {losses}")
    tokens = mb * gas * T
    # all the tokens over all the time of the steps after the first (which
    # includes the kernels' first load)
    step_s = float(sum(walls[1:])) / (steps - 1)
    # model FLOPs a step: 6 N per token for the weights (the tied head
    # included) and 6 L T d per token for causal attention, forward and
    # backward; remat's recompute is not counted
    flops = tokens * (6 * cfg.num_params() + 6 * cfg.n_layer * T * cfg.n_embd)
    emit({"phase": "train_bf16", "micro_batch": mb, "gas": gas, "T": T, "steps": steps,
          "losses": losses, "step_ms": [w * 1e3 for w in walls], "step_ms_mean_after_first": step_s * 1e3,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "global_steps": engine.global_steps})
    del engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 9 and 10: BERT-large pretraining with LAMB
# ---------------------------------------------------------------------------

def phase_train_bert_f32(torch, params):
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = bert.BERT_LARGE
    B, T, steps = 2, 512, 3
    config = {"train_micro_batch_size_per_gpu": B, "gradient_clipping": 1.0, "optimizer": BERT_LAMB}
    batch = synthetic_mlm_batch(cfg.vocab_size, B, T, seed=21)
    out = {}
    for name, c in (("kernels", cfg), ("plain_attention", dataclasses.replace(
            cfg, use_flash_attention=False))):
        kernels.reset_launches()
        engine, losses, walls = _train(torch, bert.make_model(c)[0], params, config, batch, steps)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": kernels.launches()}
        del engine
        torch.cuda.empty_cache()
    kl, pl = out["kernels"]["launches"], out["plain_attention"]["launches"]
    check(kl["flash_fwd"] > 0 and kl["flash_bwd"] > 0 and pl["flash_bwd"] == 0,
          f"train_bert_f32: flash launches {kl} / {pl}")
    check(kl["fused_lamb_dir"] > 0 and kl["fused_lamb_apply"] > 0 and kl["fused_adam"] == 0,
          f"train_bert_f32: optimizer launches {kl}")
    k, p = out["kernels"]["losses"], out["plain_attention"]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_bert_f32: non-finite loss {k} / {p}")
    check(max(rel) <= TRAIN_F32_LOSS_RTOL,
          f"train_bert_f32: kernel vs plain losses differ by {max(rel)} > {TRAIN_F32_LOSS_RTOL}")
    emit({"phase": "train_bert_f32", "model": "bert-large", "B": B, "T": T, "steps": steps,
          "keys_kept": batch["attention_mask"].sum(1).tolist(), "allow_tf32": False,
          "losses": out, "max_rel_diff": max(rel), "tol": TRAIN_F32_LOSS_RTOL})


def phase_train_bert_bf16(torch, params):
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = bert.BERT_LARGE
    mb, gas, T, steps = 8, 2, 512, 4
    config = {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": BERT_LAMB,
        # warmup_min_lr > 0: the log warmup's first step would otherwise run
        # at lr 0 and update nothing
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
            "warmup_max_lr": 2e-3}},
    }
    batch = synthetic_mlm_batch(cfg.vocab_size, mb * gas, T, seed=22)
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    engine, losses, walls = _train(torch, bert.make_model(cfg)[0], params, config, batch, steps)
    launches = kernels.launches()
    # ----------------------------------------------------------------------

    for name in ("flash_fwd", "flash_bwd", "fused_lamb_dir", "fused_lamb_apply"):
        check(launches[name] > 0, f"kernel {name} was not launched on the BERT training main path")
    check(launches["fused_adam"] == 0, f"train_bert_bf16: fused_adam launched {launches}")
    check(all(np.isfinite(losses)), f"train_bert_bf16: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train_bert_bf16: loss did not fall: {losses}")
    tokens = mb * gas * T
    step_s = float(sum(walls[1:])) / (steps - 1)
    # model FLOPs a step: 6 N per token for the weights (the tied decoder
    # included) and 12 L T d per token for non-causal attention, forward
    # and backward; remat's recompute is not counted.  Padded positions
    # are computed, so they count as tokens.
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    flops = tokens * (6 * cfg.num_params() + 12 * L * T * d)
    emit({"phase": "train_bert_bf16", "model": "bert-large", "optimizer": BERT_LAMB,
          "micro_batch": mb, "gas": gas, "T": T, "steps": steps,
          "real_tokens_per_step": int(batch["attention_mask"].sum()), "losses": losses,
          "step_ms": [w * 1e3 for w in walls], "step_ms_mean_after_first": step_s * 1e3,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "global_steps": engine.global_steps})
    del engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 11-13: BERT-large with its published dropout, the transformer layer
# ---------------------------------------------------------------------------

def _bert_drop_cfg(bert):
    """BERT-large as published: hidden and attention-probability dropout
    0.1 (google-research/bert's BERT-Large ``bert_config.json``)."""
    return dataclasses.replace(bert.BERT_LARGE, hidden_dropout_prob=0.1,
                               attention_probs_dropout_prob=0.1)


def phase_train_bert_drop_f32(torch, params):
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = _bert_drop_cfg(bert)
    B, T, steps = 2, 512, 3
    config = {"train_micro_batch_size_per_gpu": B, "gradient_clipping": 1.0, "optimizer": BERT_LAMB}
    batch = synthetic_mlm_batch(cfg.vocab_size, B, T, seed=23)
    out = {}
    for name, c in (("kernels", cfg), ("plain_attention", dataclasses.replace(
            cfg, use_flash_attention=False))):
        kernels.reset_launches()
        engine, losses, walls = _train(torch, bert.make_model(c)[0], params, config, batch, steps)
        out[name] = {"losses": losses, "step_ms": [w * 1e3 for w in walls],
                     "launches": kernels.launches(), "variants": kernels.launch_variants()}
        del engine
        torch.cuda.empty_cache()
    kl, pl = out["kernels"], out["plain_attention"]
    for name in ("flash_fwd", "flash_bwd"):
        check(kl["launches"][name] > 0 and kl["variants"][name] == {
            "kbias+dropout": kl["launches"][name]} and pl["launches"][name] == 0,
            f"train_bert_drop_f32: {name} launches {kl['variants'][name]} / {pl['launches'][name]}")
    k, p = kl["losses"], pl["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(k, p)]
    check(all(np.isfinite(k)) and all(np.isfinite(p)), f"train_bert_drop_f32: non-finite {k} / {p}")
    check(max(rel) <= TRAIN_DROP_F32_LOSS_RTOL,
          f"train_bert_drop_f32: kernel vs plain losses differ by {max(rel)} > "
          f"{TRAIN_DROP_F32_LOSS_RTOL}")
    emit({"phase": "train_bert_drop_f32", "model": "bert-large", "hidden_dropout": 0.1,
          "attention_dropout": 0.1, "B": B, "T": T, "steps": steps,
          "keys_kept": batch["attention_mask"].sum(1).tolist(), "allow_tf32": False,
          "losses": out, "max_rel_diff": max(rel), "tol": TRAIN_DROP_F32_LOSS_RTOL})


def phase_train_bert_drop_bf16(torch, params):
    """The main path of this slice: BERT-large with its published dropout,
    train_bert_bf16's phase-2 settings otherwise."""
    from deepspeed_tpu_torch.models import bert
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB, synthetic_mlm_batch

    cfg = _bert_drop_cfg(bert)
    mb, gas, T, steps = 8, 2, 512, 4
    config = {
        "train_micro_batch_size_per_gpu": mb, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0, "optimizer": BERT_LAMB,
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
            "warmup_max_lr": 2e-3}},
    }
    batch = synthetic_mlm_batch(cfg.vocab_size, mb * gas, T, seed=22)
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counters zeroed just before, read just after -------
    torch.cuda.synchronize()
    kernels.reset_launches()
    engine, losses, walls = _train(torch, bert.make_model(cfg)[0], params, config, batch, steps)
    launches = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------

    for name in ("flash_fwd", "flash_bwd", "fused_lamb_dir", "fused_lamb_apply"):
        check(launches[name] > 0, f"kernel {name} was not launched on the BERT dropout main path")
    for name in ("flash_fwd", "flash_bwd"):
        check(variants[name] == {"kbias+dropout": launches[name]},
              f"train_bert_drop_bf16: {name} ran {variants[name]}, not all with bias and dropout")
    for name in ("fused_adam", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 0, f"train_bert_drop_bf16: {name} launched {launches}")
    check(all(np.isfinite(losses)), f"train_bert_drop_bf16: non-finite loss {losses}")
    tokens = mb * gas * T
    step_s = float(sum(walls[1:])) / (steps - 1)
    L, d = cfg.num_hidden_layers, cfg.hidden_size
    flops = tokens * (6 * cfg.num_params() + 12 * L * T * d)
    emit({"phase": "train_bert_drop_bf16", "model": "bert-large", "hidden_dropout": 0.1,
          "attention_dropout": 0.1, "optimizer": BERT_LAMB, "micro_batch": mb, "gas": gas,
          "T": T, "steps": steps, "real_tokens_per_step": int(batch["attention_mask"].sum()),
          "losses": losses, "step_ms": [w * 1e3 for w in walls],
          "step_ms_mean_after_first": step_s * 1e3, "tokens_per_step": tokens,
          "tokens_per_s": tokens / step_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "model_flops_per_step": flops, "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "launches": launches, "variants": variants, "global_steps": engine.global_steps})
    del engine
    torch.cuda.empty_cache()
    return launches


def _layer_stack(torch, cfg, n, dev):
    from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerLayer

    return [DeepSpeedTransformerLayer(cfg, seed=i, device=dev) for i in range(n)]


def _run_stack(torch, layers, x, mask, seed, w):
    """Forward through ``layers`` with per-layer seeds drawn from a CPU
    generator seeded ``seed``, then the backward of ``sum(out * w)``.
    Returns the output and the input's gradient."""
    from deepspeed_tpu_torch.ops.transformer.transformer import draw_seeds

    gen = torch.Generator().manual_seed(seed)
    x = x.detach().clone().requires_grad_()
    h = x
    for layer in layers:
        h = layer(h, attention_mask=mask, rng=draw_seeds(gen), training=True)
    (h.float() * w).sum().backward()
    return h.detach(), x.grad


def phase_transformer_layer(torch, dev):
    """DeepSpeedTransformerLayer at BERT-large width (d 1024, 16 heads of
    64, FFN 4096, pre-LN, dropout 0.1 and 0.1, the op's defaults): 24
    layers in bf16 at B 8, T 512, forward and backward, with a (B, T) mask
    (B1/B2 with the key-row bias) and with a (B, 1, T, T) seq2seq mask (the
    full bias); the same in f32 at B 2 against plain attention on the same
    seeds; and one layer at B 1, T 9216 with a (B, T) mask, whose backward
    is the two-pass B6a/B6b."""
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.transformer.transformer import DeepSpeedTransformerConfig

    cfg = DeepSpeedTransformerConfig(
        batch_size=8, hidden_size=1024, intermediate_size=4096, heads=16, attn_dropout_ratio=0.1,
        hidden_dropout_ratio=0.1, num_hidden_layers=24, pre_layer_norm=True,
        dtype=torch.bfloat16)
    L, B, T, D = 24, 8, 512, 1024
    layers = _layer_stack(torch, cfg, L, dev)
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(B, T, D, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(B, T, D, generator=g, device=dev)
    keep = torch.tensor([BIAS_KEEP[b % 4] for b in range(B)], device=dev)
    mask2 = (torch.arange(T, device=dev)[None, :] < keep[:, None]).long()
    kb = torch.where(mask2.bool(), 0.0, -1e9)
    mask4 = seq2seq_mask(torch, kb, T)
    runs, launches = {}, {}
    total = {name: 0 for name in kernels.launches()}
    want = {"2d": "kbias+dropout", "4d": "fbias+dropout"}
    # one untimed pass of each form first (cuBLAS plans, the allocator):
    # the first timed pass read 413 ms against the second form's 139 ms
    for mask in (mask2, mask4):
        _run_stack(torch, layers, x, mask, 4, w)
    for form, mask in (("2d", mask2), ("4d", mask4)):
        for layer in layers:
            layer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        # -- the main path: counters zeroed just before, read just after ---
        kernels.reset_launches()
        t0 = time.perf_counter()
        out, dx = _run_stack(torch, layers, x, mask, 5, w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[form] = kernels.launches()
        variants = kernels.launch_variants()
        # ------------------------------------------------------------------
        for name in ("flash_fwd", "flash_bwd"):
            check(variants[name] == {want[form]: L},
                  f"transformer_layer {form}: {name} ran {variants[name]}, want {L} {want[form]}")
        check(launches[form]["flash_bwd_dq"] == 0 and launches[form]["flash_bwd_dkv"] == 0,
              f"transformer_layer {form}: two-pass backward launched {launches[form]}")
        check(out.isfinite().all().item() and dx.isfinite().all().item(),
              f"transformer_layer {form}: non-finite output or gradient")
        for name, n in launches[form].items():
            total[name] += n
        runs[form] = {"wall_ms": wall * 1e3, "launches": launches[form], "variants": variants,
                      "out_rms": float(out.float().square().mean().sqrt())}
    del layers, x, w, out, dx
    torch.cuda.empty_cache()

    # -- f32 at B 2: the kernels against plain attention, the same seeds -----
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    layers = _layer_stack(torch, f32, L, dev)
    x = torch.randn(2, T, D, generator=g, device=dev)
    w = torch.randn(2, T, D, generator=g, device=dev)
    f32_err = {}
    for form, mask in (("2d", mask2[:2]), ("4d", mask4[:2])):
        res = {}
        for label, use_flash in (("kernels", True), ("plain", False)):
            for layer in layers:
                layer.config = dataclasses.replace(f32, use_flash_attention=use_flash)
                layer.zero_grad(set_to_none=True)
            res[label] = _run_stack(torch, layers, x, mask, 6, w)
        errs = [max_err(a, b) / float(b.abs().max()) for a, b in zip(res["kernels"], res["plain"])]
        check(max(errs) <= LAYER_F32_RTOL,
              f"transformer_layer f32 {form}: kernels vs plain attention differ by {errs} of the "
              f"largest entries > {LAYER_F32_RTOL}")
        f32_err[form] = {"out": errs[0], "dx": errs[1]}
    del layers, x, w, res
    torch.cuda.empty_cache()

    # -- one layer at T 9216: the two-pass backward ----------------------------
    (layer,) = _layer_stack(torch, dataclasses.replace(cfg, num_hidden_layers=1), 1, dev)
    x = torch.randn(1, LONG_T, D, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(1, LONG_T, D, generator=g, device=dev)
    mask = (torch.arange(LONG_T, device=dev) < LONG_KEEP).long()[None]
    torch.cuda.synchronize()
    # -- the main path: counters zeroed just before, read just after -------
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, dx = _run_stack(torch, [layer], x, mask, 7, w)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["long"] = kernels.launches()
    variants = kernels.launch_variants()
    # ----------------------------------------------------------------------
    check(launches["long"]["flash_bwd_dq"] == 1 and launches["long"]["flash_bwd_dkv"] == 1
          and launches["long"]["flash_bwd"] == 0 and launches["long"]["flash_fwd"] == 1,
          f"transformer_layer T={LONG_T}: launches {launches['long']}")
    check(variants["flash_bwd_dq"] == {"kbias+dropout": 1},
          f"transformer_layer T={LONG_T}: B6a ran {variants['flash_bwd_dq']}")
    check(out.isfinite().all().item() and dx.isfinite().all().item(),
          f"transformer_layer T={LONG_T}: non-finite output or gradient")
    for name, n in launches["long"].items():
        total[name] += n
    runs["long"] = {"B": 1, "T": LONG_T, "keys_kept": LONG_KEEP, "wall_ms": wall * 1e3,
                    "launches": launches["long"], "variants": variants}
    emit({"phase": "transformer_layer", "layers": L, "d": D, "heads": 16, "ffn": 4096,
          "pre_ln": True, "attn_dropout": 0.1, "hidden_dropout": 0.1, "B": B, "T": T,
          "dtype": "bfloat16", "runs": runs, "f32_B2_rel_err": f32_err, "f32_tol": LAYER_F32_RTOL})
    del layer, x, w, out, dx
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs the port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.models import bert, gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import paged_request_mix, request_mix

    # a reference states its float32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    seconds = kernels.build(force=True)
    ptxas = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for n, log in kernels.library().build_log.items()}
    emit({"phase": "build", "nvcc_s": seconds, "wall_s": time.perf_counter() - t0,
          "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": False, "ptxas": ptxas})

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    check_flash_fwd(torch, dev, flush)
    fwd_train = check_flash_fwd_training(torch, dev, flush)
    dec_rows = check_flash_decode(torch, dev, flush)
    paged_rows = check_flash_decode_paged(torch, dev, flush)
    bwd_rows = check_flash_bwd(torch, dev, flush)
    adam_rows = check_fused_adam(torch, dev, flush)
    bias_rows = check_flash_bias(torch, dev, flush)
    lamb_rows = check_fused_lamb(torch, dev, flush)
    drop_rows = check_flash_dropout(torch, dev, flush)
    fbias_rows = check_flash_fbias(torch, dev, flush)
    torch.cuda.empty_cache()
    long_rows = check_flash_bwd2(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()

    cfg = gpt2.PRESETS["gpt2"]
    params = gpt2.init_params(cfg, seed=0)
    reqs = request_mix(seed=0)
    phase_serve_f32(torch, params, reqs)
    serve_launches = phase_serve_bf16(torch, params, reqs)
    mix = paged_request_mix(seed=0)
    phase_serve_paged_f32(torch, params, mix)
    paged_launches = phase_serve_paged_bf16(torch, params, mix)
    phase_train_f32(torch, params)
    train_launches = phase_train_bf16(torch, params)
    del params
    bert_params = bert.init_params(bert.BERT_LARGE, seed=0)
    phase_train_bert_f32(torch, bert_params)
    bert_launches = phase_train_bert_bf16(torch, bert_params)
    phase_train_bert_drop_f32(torch, bert_params)
    drop_launches = phase_train_bert_drop_bf16(torch, bert_params)
    del bert_params
    torch.cuda.empty_cache()
    layer_launches = phase_transformer_layer(torch, dev)
    by_path = {name: {"serving": serve_launches[name], "serving_paged": paged_launches[name],
                      "training": train_launches[name], "training_bert": bert_launches[name],
                      "training_bert_dropout": drop_launches[name],
                      "transformer_layer": layer_launches[name]}
               for name in serve_launches}

    # the main-path shapes: the GPT-2 training step's bf16 attention (B=8,
    # H=12, T=1024, d=64: B1 with lse, B2), the bf16 pool's decode (8 slots
    # x 1024 positions), the bf16 paged pool's decode (8 slots x 8 pages of
    # 128), one step's fused Adam over GPT-2 124M's 16 leaves and one step's
    # fused LAMB over BERT-large's 26 leaves (no bias correction, as the
    # main path), B6a and B6b at one bf16 sequence of 9,216 (B=1, H=16, a
    # key-padding bias, dropout 0.1).  B1 and B2 also carry their rows at
    # the BERT main paths' shape (bf16, B=8, H=16, T=512): the key-padding
    # bias under "kbias", with dropout 0.1 under "kbias_dropout" (this
    # slice's main path), the (B, 1, T, T) mask with dropout under "fbias".
    bwd = next(r for r in bwd_rows if r["T"] == 1024 and r["dtype"] == "bfloat16")
    dec = next(r for r in dec_rows if r["kv"] == "bfloat16" and not r["masked"])
    paged = next(r for r in paged_rows if r["kv"] == "bfloat16")
    adam = next(r for r in adam_rows if r["leaves"] == "step_16_leaves")
    lamb = {r["kernel"]: r for r in lamb_rows
            if r["leaves"] == "step_26_leaves" and not r["bias_correction"]}
    report = kernels.kernels_report()
    entries = []
    for name, row, replaces in (
        ("flash_fwd", fwd_train, "deepspeed_tpu/ops/attention/flash_attention.py:237"),
        ("flash_decode", dec, "deepspeed_tpu/ops/kernels/flash_decode.py:88"),
        ("flash_decode_paged", paged, "deepspeed_tpu/ops/kernels/flash_decode.py:277"),
        ("flash_bwd", bwd, "deepspeed_tpu/ops/attention/flash_attention.py:607"),
        ("fused_adam", adam, "deepspeed_tpu/ops/kernels/fused_update.py:125"),
        ("fused_lamb_dir", lamb["fused_lamb_dir"], "deepspeed_tpu/ops/kernels/fused_update.py:214"),
        ("fused_lamb_apply", lamb["fused_lamb_apply"],
         "deepspeed_tpu/ops/kernels/fused_update.py:231"),
        ("flash_bwd_dq", long_rows[("flash_bwd_dq", "bfloat16")],
         "deepspeed_tpu/ops/attention/flash_attention.py:480"),
        ("flash_bwd_dkv", long_rows[("flash_bwd_dkv", "bfloat16")],
         "deepspeed_tpu/ops/attention/flash_attention.py:538"),
    ):
        entry = {
            "name": name, "route": "cuda", "source": report[name]["source"],
            "replaces": replaces, "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name], "max_abs_err": row["max_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        }
        for label, rows_of in (("kbias", bias_rows), ("kbias_dropout", drop_rows),
                               ("fbias", fbias_rows)):
            row = rows_of.get((name, "bfloat16"))
            if row is not None:
                entry[label] = {key: row[key] for key in (
                    "B", "H", "T", "max_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
        entries.append(entry)
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
