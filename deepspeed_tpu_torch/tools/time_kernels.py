"""Device time of the attention forwards and the decode kernels on the card.

    python -m deepspeed_tpu_torch.tools.time_kernels [--iters 20] [--rows b1 b4]

Times, at ``chip_smoke.py``'s shapes and on inputs made on the card from
``--seed``, each launch after a 512 MB write that evicts the 50 MB L2
(CUDA events around the launch alone, the mean over ``--iters``):

* B1 ``flash_fwd_cuda`` in bf16: GPT-2's training shape (8, 12, 1024, 64),
  causal, with its lse; BERT-large's (8, 16, 512, 64) with a key-padding
  bias, with the bias and dropout 0.1, and with a (B, 1, T, T) mask and
  dropout;
* B8 ``splash_fwd_cuda`` in bf16 at (1, 12, T, 64), T 8192 and 16384,
  GPT-2's default BigBird layout (block 256, causal), with its lse;
* B4 ``flash_decode_cuda`` over an 8-slot, 1024-position cache (12 heads
  of 64) in bf16, int8 and f32, with and without a key-padding mask, and
  B5 ``flash_decode_paged_cuda`` over 8 slots x 8 pages of 128 in bf16.

``--rows`` keeps the rows whose names start with one of its prefixes
(``b1``, ``b8``, ``b4``, ``b5``; a kernel builds at its first launch).

It calls only entry points every slice of the port since the block-sparse
one has, so it can time an older checkout of the package: put that
checkout first on PYTHONPATH and run this file by its path.  Two checkouts
are compared on one card by running them in turns (parent, change, change,
parent).  Prints one JSON line: ms by row, the card's name and power
limit.  Needs a CUDA card; it raises without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

FLUSH_BYTES = 512 << 20


def _device_ms(fn, flush, iters: int, warmup: int = 3) -> float:
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


def _flash_rows(dev, seed: int):
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)

    def qkv(B, H, T):
        return [torch.randn(B, H, T, 64, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    rows = {}
    q, k, v = qkv(8, 12, 1024)
    rows["b1_gpt2"] = lambda: fa.flash_fwd_cuda(q, k, v, True, 0.125, want_lse=True)
    bq, bk, bv = qkv(8, 16, 512)
    kbias = torch.zeros(8, 512, device=dev)
    for b, keep in enumerate((512, 448, 300, 129)):
        kbias[b::4, keep:] = -1e9
    fbias = kbias[:, None, None, :].expand(8, 16, 512, 512)
    drop = fa.make_dropout(0.1, (0x9E3779B9, 0xBB67AE85))
    rows["b1_bert_kbias"] = lambda: fa.flash_fwd_cuda(bq, bk, bv, False, 0.125, want_lse=True,
                                                      kbias=kbias)
    rows["b1_bert_kbias_dropout"] = lambda: fa.flash_fwd_cuda(
        bq, bk, bv, False, 0.125, want_lse=True, kbias=kbias, drop=drop)
    rows["b1_bert_fbias_dropout"] = lambda: fa.flash_fwd_cuda(
        bq, bk, bv, False, 0.125, want_lse=True, fbias=fbias, drop=drop)
    return rows


def _splash_rows(dev, seed: int):
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops.attention import sparse as sp

    rows = {}
    for T in (8192, 16384):
        cfg = dataclasses.replace(gpt2.PRESETS["gpt2"], n_positions=T, attention_mode="sparse")
        layout, block = gpt2.sparse_layout(cfg, T)
        g = torch.Generator(device=dev).manual_seed(seed + T)
        q, k, v = (torch.randn(1, 12, T, 64, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        rows[f"b8_t{T}"] = (lambda q=q, k=k, v=v, layout=layout, block=block:
                            sp.splash_fwd_cuda(q, k, v, layout, block, True, 0.125,
                                               want_lse=True))
    return rows


def _decode_rows(dev, seed: int):
    from deepspeed_tpu_torch.ops.kernels import flash_decode as fd
    from deepspeed_tpu_torch.ops.transformer.inference import _kv_quant

    B, H, S, d = 8, 12, 1024, 64
    pos = torch.tensor([0, S - 1, 100, 511, 777, 1, 300, 1000], dtype=torch.int32, device=dev)
    rows = {}
    for kv in ("bfloat16", "int8", "float32"):
        g = torch.Generator(device=dev).manual_seed(seed)
        qd = torch.float32 if kv == "float32" else torch.bfloat16
        q = torch.randn(B, H, 1, d, generator=g, device=dev).to(qd)
        k, v = (torch.randn(B, H, S, d, generator=g, device=dev) for _ in range(2))
        kc, vc = ((dict(zip(("q", "s"), _kv_quant(t))) for t in (k, v)) if kv == "int8"
                  else (k.to(qd), v.to(qd)))
        kpm = torch.rand(B, S, generator=g, device=dev) > 0.3
        kpm[:, 0] = True
        kpm[5, :2] = False
        for masked in (False, True):
            mask = kpm if masked else None
            rows[f"b4_{kv}{'_masked' if masked else ''}"] = (
                lambda q=q, kc=kc, vc=vc, mask=mask:
                fd.flash_decode_cuda(q, kc, vc, pos, key_padding_mask=mask))
    P, page_len = 8, 128
    NP = 1 + 2 * B * P
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, 1, d, generator=g, device=dev).to(torch.bfloat16)
    kp, vp = (torch.randn(NP, H, page_len, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    perm = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(5)) + 1
    table = perm[:B * P].reshape(B, P).to(torch.int32).to(dev)
    rows["b5_bfloat16"] = lambda: fd.flash_decode_paged_cuda(q, kp, vp, table, pos)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", nargs="*", default=None,
                    help="time only the rows whose names start with one of these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_kernels needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = {**_flash_rows(dev, args.seed), **_splash_rows(dev, args.seed),
            **_decode_rows(dev, args.seed)}
    if args.rows:
        rows = {name: fn for name, fn in rows.items() if name.startswith(tuple(args.rows))}
    out = {"tool": "time_kernels", "iters": args.iters,
           "ms": {name: _device_ms(fn, flush, args.iters) for name, fn in rows.items()},
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, check=True, timeout=60).stdout.strip()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
