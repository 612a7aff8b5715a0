#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: compile every CUDA kernel of the serving and training paths
   from ``deepspeed_tpu_torch/csrc`` with ``nvcc`` (one process per source,
   all started together).
2. ``kernel``: every kernel against its plain PyTorch version at the main
   paths' shapes (flash prefill at B=4, H=12, d=64, T=256/512/200 in bf16 and
   f32, and at the training shape B=8, T=1024 with its lse; flash decode
   over an 8-slot, 1024-position cache in f32, bf16 and int8, with and
   without a key-padding mask; flash backward at B=8, H=12, d=64, T=1024 in
   bf16 and f32, T=256 and a ragged T=1000; fused Adam over GPT-2 124M's
   ``wte``, stacked ``qkv_w`` and ragged ``lnf_g`` leaves and over a whole
   step's 16 leaves), with the tolerance stated, and the times of the
   kernel, the plain version and one PyTorch library call beside the least
   time the card could take (``bound_ms``).
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
7. ``kernels``: one entry per kernel with its launches on each main path
   (``launches_by_path``: serving, training) and their sum.

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


def grad_err(a, b, tol):
    """``(max |a - b|, max of |a - b| over its bound)`` for the backward's
    entry-by-entry bound ``tol * (|b| + BWD_RMS_SHARE * rms(b))``; the
    check passes where the second is at most 1."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    bound = tol * (b.abs() + BWD_RMS_SHARE * b.square().mean().sqrt())
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


def phase_serve_f32(torch, params, reqs):
    import deepspeed_tpu_torch

    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", params=params, dtype=torch.float32,
        serving={"num_slots": 8, "prefill_chunk": 64})
    done, wall = serve(srv, reqs)
    eng = srv.engine
    flips = []
    for r in done:
        solo = eng.generate(r.prompt[None, :], max_new_tokens=len(r.generated))[0]
        got = r.tokens()
        if np.array_equal(solo, got):
            continue
        i = int(np.nonzero(solo != got)[0][0])
        gap = top2_gap(eng, got[:i])
        flips.append({"request": r.request_id, "at": i - r.prompt_len, "top2_gap": gap})
        check(gap < F32_NEAR_TIE,
              f"f32 request {r.request_id}: served token {i - r.prompt_len} differs from solo "
              f"generate() with top-2 gap {gap} >= {F32_NEAR_TIE}")
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


# ---------------------------------------------------------------------------
# phases 5 and 6: the training path
# ---------------------------------------------------------------------------

def _train(torch, cfg, params, config, batch, steps):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    model_fn, _, _ = gpt2.make_model(cfg)
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
        engine, losses, walls = _train(torch, c, params, config, batch, 3)
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
    engine, losses, walls = _train(torch, cfg, params, config, batch, steps)
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

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this script runs the port on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.tools.profile_serving import request_mix

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
    bwd_rows = check_flash_bwd(torch, dev, flush)
    adam_rows = check_fused_adam(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()

    cfg = gpt2.PRESETS["gpt2"]
    params = gpt2.init_params(cfg, seed=0)
    reqs = request_mix(seed=0)
    phase_serve_f32(torch, params, reqs)
    serve_launches = phase_serve_bf16(torch, params, reqs)
    phase_train_f32(torch, params)
    train_launches = phase_train_bf16(torch, params)
    by_path = {name: {"serving": serve_launches[name], "training": train_launches[name]}
               for name in serve_launches}

    # the main-path shapes: the training step's bf16 attention (B=8, H=12,
    # T=1024, d=64: B1 with lse, B2), the bf16 pool's decode (8 slots x
    # 1024 positions) and one step's fused Adam over GPT-2 124M's 16 leaves
    bwd = next(r for r in bwd_rows if r["T"] == 1024 and r["dtype"] == "bfloat16")
    dec = next(r for r in dec_rows if r["kv"] == "bfloat16" and not r["masked"])
    adam = next(r for r in adam_rows if r["leaves"] == "step_16_leaves")
    report = kernels.kernels_report()
    entries = []
    for name, row, replaces in (
        ("flash_fwd", fwd_train, "deepspeed_tpu/ops/attention/flash_attention.py:237"),
        ("flash_decode", dec, "deepspeed_tpu/ops/kernels/flash_decode.py:88"),
        ("flash_bwd", bwd, "deepspeed_tpu/ops/attention/flash_attention.py:607"),
        ("fused_adam", adam, "deepspeed_tpu/ops/kernels/fused_update.py:125"),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": report[name]["source"],
            "replaces": replaces, "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name], "max_abs_err": row["max_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
