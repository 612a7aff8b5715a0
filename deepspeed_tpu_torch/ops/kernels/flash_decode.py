"""Single-query flash decode over the slot-pool KV layout (counterpart of
``deepspeed_tpu/ops/kernels/flash_decode.py``).

Contract (the same as the JAX kernel's):

* ``q``: (B, H, 1, d) — one query per slot (decode step).
* caches: (B, H, S, d) tensors in ``q``'s type, or the int8 pair
  ``{"q": int8 codes, "s": (B, H, S, 1) f32 scales}`` from
  ``init_kv_cache``.
* ``pos``: scalar or per-slot (B,) write offsets; key ``j`` is
  attendable iff ``j <= pos[b]`` (serving writes the token's K/V before
  it attends).
* ``key_padding_mask``: optional (B, S), True = attendable.

:func:`flash_decode` launches the CUDA kernel (``csrc/flash_decode.cu``)
for CUDA tensors and runs :func:`flash_decode_reference`, the plain
PyTorch version of the same function, for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import kernels as _kernels

# Same mask constant as the JAX version: fully-masked rows degrade to a
# uniform softmax instead of NaN (the garbage rows of idle slots).
NEG_INF = -1e30

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_D = 128


def decode_supported(B: int, H: int, S: int, d: int) -> bool:
    """Shapes the CUDA kernel serves: any cache length, head_dim up to
    128.  (The TPU grid needed ``S % 128 == 0``; the Hopper kernel walks
    keys one row at a time and masks past ``pos`` itself.)"""
    return B >= 1 and H >= 1 and S >= 1 and 1 <= d <= _MAX_D


def _per_slot(pos) -> bool:
    """True when ``pos`` is a per-example (B,) write-offset vector (the
    slot-pool form) rather than a Python int or a 0-dim tensor."""
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def flash_decode_reference(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                           key_padding_mask=None) -> torch.Tensor:
    """Plain PyTorch attention of queries (B, H, T, d) against a static
    cache (B, H, S, d): the body of ``cache_attention`` in the JAX package
    (any T).  Query ``i`` attends keys ``j <= pos + i``.  q, k and v are
    widened to f32; int8 scales apply outside the dots."""
    quant = isinstance(k_cache, dict)
    if quant:
        k_scale = k_cache["s"][..., 0][:, :, None, :]  # (B, H, 1, S)
        v_scale = v_cache["s"][..., 0][:, :, None, :]
        k_op, v_op = k_cache["q"], v_cache["q"]
    else:
        k_op, v_op = k_cache, v_cache
    B, H, T, d = q.shape
    S = k_op.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k_op.float()) * sm_scale
    if quant:
        s = s * k_scale
    key_idx = torch.arange(S, device=q.device)[None, None, None, :]
    if _per_slot(pos):
        pos_off = pos.to(q.device, torch.int64)[:, None, None, None]
    else:
        pos_off = pos  # Python int or 0-dim tensor broadcast
    q_idx = pos_off + torch.arange(T, device=q.device)[None, None, :, None]
    allowed = key_idx <= q_idx
    if key_padding_mask is not None:
        allowed = allowed & key_padding_mask[:, None, None, :].to(q.device, torch.bool)
    s = torch.where(allowed, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * v_scale
    out = torch.einsum("bhts,bhsd->bhtd", p, v_op.float())
    return out.to(q.dtype)


def _check_cuda(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"flash_decode_cuda: {name} lies on {t.device}, not on a CUDA device")
    if t.device != device:
        raise ValueError(f"flash_decode_cuda: {name} is on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"flash_decode_cuda: {name} must be contiguous")


def flash_decode_cuda(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                      key_padding_mask=None) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/flash_decode.cu``) on the current
    stream.  Raises for tensors that are not on one CUDA device, not
    contiguous, or of a type or shape the kernel does not take."""
    quant = isinstance(k_cache, dict)
    k_op = k_cache["q"] if quant else k_cache
    v_op = v_cache["q"] if quant else v_cache
    if q.ndim != 4:
        raise ValueError(f"flash_decode_cuda: q must be (B, H, 1, d), got {tuple(q.shape)}")
    B, H, T, d = q.shape
    if T != 1:
        raise ValueError(f"flash_decode serves exactly one query per slot, got T={T}")
    S = k_op.shape[2]
    if k_op.shape != (B, H, S, d) or v_op.shape != (B, H, S, d):
        raise ValueError(
            f"flash_decode_cuda: caches must be (B, H, S, d) = ({B}, {H}, S, {d}), "
            f"got {tuple(k_op.shape)} / {tuple(v_op.shape)}"
        )
    if not decode_supported(B, H, S, d):
        raise ValueError(f"flash_decode_cuda cannot serve (B={B}, H={H}, S={S}, d={d})")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"flash_decode_cuda: q dtype {q.dtype} not in {list(_Q_CODES)}")
    if quant:
        if k_op.dtype != torch.int8 or v_op.dtype != torch.int8:
            raise ValueError("flash_decode_cuda: int8 caches need int8 codes")
        for nm, sc in (("k scales", k_cache["s"]), ("v scales", v_cache["s"])):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (B, H, S, 1):
                raise ValueError(f"flash_decode_cuda: {nm} must be f32 (B, H, S, 1)")
    elif k_op.dtype != q.dtype or v_op.dtype != q.dtype:
        raise ValueError(
            f"flash_decode_cuda: cache dtype {k_op.dtype}/{v_op.dtype} must equal q's {q.dtype}"
        )
    dev = q.device
    for nm, t in (("q", q), ("k_cache", k_op), ("v_cache", v_op)):
        _check_cuda(nm, t, dev)
    ks = vs = None
    if quant:
        ks, vs = k_cache["s"], v_cache["s"]
        _check_cuda("k scales", ks, dev)
        _check_cuda("v scales", vs, dev)
    if isinstance(pos, torch.Tensor):
        pos_vec = pos.to(device=dev, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    else:
        pos_vec = torch.full((B,), int(pos), dtype=torch.int32, device=dev)
    kpm = None
    if key_padding_mask is not None:
        if tuple(key_padding_mask.shape) != (B, S):
            raise ValueError(
                f"flash_decode_cuda: key_padding_mask must be (B, S) = ({B}, {S}), "
                f"got {tuple(key_padding_mask.shape)}"
            )
        kpm = (key_padding_mask.to(dev) != 0).to(torch.uint8).contiguous()
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty((B, H, 1, d), dtype=q.dtype, device=dev)
    lib = _kernels.library()
    fn = lib.fn("flash_decode")
    err = fn(
        q.data_ptr(), k_op.data_ptr(), v_op.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        pos_vec.data_ptr(), kpm.data_ptr() if kpm is not None else None,
        out.data_ptr(), B, H, S, d, _Q_CODES[q.dtype], _KV_CODES[k_op.dtype],
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_decode", err)
    _kernels.count_launch("flash_decode")
    return out


def flash_decode(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                 key_padding_mask=None) -> torch.Tensor:
    """Single-query attention against a slot cache; see module docs.
    Returns (B, H, 1, d) in ``q.dtype``.  CUDA tensors take the kernel,
    CPU tensors the plain version."""
    if q.shape[2] != 1:
        raise ValueError(f"flash_decode serves exactly one query per slot, got T={q.shape[2]}")
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, pos, sm_scale, key_padding_mask)
    return flash_decode_cuda(q, k_cache, v_cache, pos, sm_scale, key_padding_mask)
