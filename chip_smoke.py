#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: compile every CUDA kernel of the serving path from
   ``deepspeed_tpu_torch/csrc`` with ``nvcc`` (one process per source, all
   started together).
2. ``kernel``: every kernel against its plain PyTorch version at the main
   path's shapes (flash prefill at B=4, H=12, d=64, T=256/512/200 in bf16 and
   f32; flash decode over an 8-slot, 1024-position cache in f32, bf16 and
   int8, with and without a key-padding mask), with the tolerance stated,
   and the times of the kernel, the plain version and one PyTorch library
   call beside the least time the card could take (``bound_ms``).
3. ``serve_f32``: GPT-2 124M at full width and depth (random weights from
   a seed) behind ``init_serving``: 8 slots, 64-token prefill chunks, 16
   requests with 64..384-token prompts, drained; every request's greedy
   tokens must equal the port's solo ``generate()`` of the same prompt
   (the JAX package's serving contract) unless the first differing token
   sits on a near-tie of the top-2 logits.
4. ``serve_bf16``: the same flow in bf16 plus a ``generate()`` with B=4 and
   T=256, the main path.  Kernel launch counters are zeroed just before it
   and read just after: every kernel must have launched.  Logits of the
   kernel path and of the plain path on the card must agree.
5. ``kernels``: one entry per kernel with its launches on the main path.

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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
    fwd_rows = check_flash_fwd(torch, dev, flush)
    dec_rows = check_flash_decode(torch, dev, flush)
    del flush
    torch.cuda.empty_cache()

    cfg = gpt2.PRESETS["gpt2"]
    params = gpt2.init_params(cfg, seed=0)
    reqs = request_mix(seed=0)
    phase_serve_f32(torch, params, reqs)
    launches = phase_serve_bf16(torch, params, reqs)

    # the main-path shapes: generate()'s bf16 prefill (B=4, T=256) and the
    # bf16 pool's decode (8 slots x 1024 positions)
    fwd = next(r for r in fwd_rows if r["T"] == 256 and r["dtype"] == "bfloat16")
    dec = next(r for r in dec_rows if r["kv"] == "bfloat16" and not r["masked"])
    report = kernels.kernels_report()
    entries = []
    for name, row, replaces in (
        ("flash_fwd", fwd, "deepspeed_tpu/ops/attention/flash_attention.py:237"),
        ("flash_decode", dec, "deepspeed_tpu/ops/kernels/flash_decode.py:88"),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": report[name]["source"],
            "replaces": replaces, "launches": launches[name], "max_abs_err": row["max_err"],
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
