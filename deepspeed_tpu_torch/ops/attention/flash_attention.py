"""Flash attention, forward and backward (counterpart of
``deepspeed_tpu/ops/attention/flash_attention.py``).

Layout convention: ``(batch, heads, seq, head_dim)``.

:func:`flash_fwd` launches the forward CUDA kernel (``csrc/flash_fwd.cu``)
and :func:`flash_bwd` the backward one (``csrc/flash_bwd.cu``) for CUDA
tensors; CPU tensors take :func:`flash_fwd_reference` and
:func:`flash_bwd_reference`, the plain PyTorch versions of the same
arithmetic.  :class:`_FlashAttention` ties the two together as the
autograd function (the JAX package's ``custom_vjp``).
:func:`flash_attention` keeps the JAX package's dispatch: dense below
128x128 scores, the plain reference below 8 rows, the kernels otherwise;
the dense and reference branches differentiate through autograd.

An additive score bias is added in f32 after ``sm_scale``, before the
causal mask, as in the JAX package.  The dense and reference branches take
any bias broadcastable to (B, H, Tq, Tk); the kernels take the key-row
form (B, 1, 1, Tk) (a key-padding mask, BERT's), handed to them as an f32
(B, Tk) ``kbias``.  The full form past the dense threshold and attention
dropout are not ported (ROADMAP A9) and raise.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops import kernels as _kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def _causal_allowed(qlen: int, klen: int, device) -> torch.Tensor:
    """(qlen, klen) bool, end-aligned: query i sits at key position
    (klen - qlen) + i."""
    qp = torch.arange(qlen, device=device)[:, None] + (klen - qlen)
    return qp >= torch.arange(klen, device=device)[None, :]


def _scores(q, k, causal: bool, sm_scale: Optional[float], bias=None) -> torch.Tensor:
    """f32 scaled scores (B, H, Tq, Tk) plus ``bias`` (broadcastable to
    them) in f32, end-aligned causal mask applied with
    ``DEFAULT_MASK_VALUE``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        mask = _causal_allowed(s.shape[-2], s.shape[-1], s.device)
        s = torch.where(mask, s, torch.full((), DEFAULT_MASK_VALUE, device=s.device))
    return s


def mha_reference(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                  bias=None) -> torch.Tensor:
    """Plain attention in f32; the numerics ground truth."""
    p = torch.softmax(_scores(q, k, causal, sm_scale, bias), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# Below 128x128 scores the materializing path is the JAX package's
# choice (measured there on the TPU); the port keeps the same dispatch so
# that parity covers the same branches.
SMALL_SEQ_DENSE_SCORES = 128 * 128


def mha_dense(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
              bias=None) -> torch.Tensor:
    """Materializing attention with input-dtype dot operands, f32
    accumulation and f32 softmax; p is rounded to the input type before
    the value dot (f32 inputs stay f32 end to end)."""
    p = torch.softmax(_scores(q, k, causal, sm_scale, bias), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float()).to(q.dtype)


def _kbias4(kbias):
    """The kernels' (B, Tk) key-row bias as a (B, 1, 1, Tk) score bias."""
    return None if kbias is None else kbias[:, None, None, :]


def flash_fwd_reference(q, k, v, causal: bool, sm_scale: float,
                        kbias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's arithmetic: f32 scores from
    the operands' values plus the f32 key-row bias ``kbias`` (B, Tk) if
    given, f32 (m, l), unnormalized p rounded to v's type before the
    value dot, a row with l = 0 divided by 1.  Returns ``(out, lse)``
    with lse (B, H, Tq) f32."""
    s = _scores(q, k, causal, sm_scale, _kbias4(kbias))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("inf")), m + torch.log(l.clamp_min(1e-37)))
    return out, lse[..., 0]


def _check_kbias(who: str, kbias, b: int, sk: int, dev) -> None:
    if kbias is None:
        return
    if kbias.shape != (b, sk) or kbias.dtype != torch.float32:
        raise ValueError(f"{who}: kbias must be float32 (B, Tk) = ({b}, {sk}), got "
                         f"{kbias.dtype} {tuple(kbias.shape)}")
    if not kbias.is_cuda or kbias.device != dev:
        raise ValueError(f"{who}: kbias lies on {kbias.device}, need the CUDA device {dev}")
    if not kbias.is_contiguous():
        raise ValueError(f"{who}: kbias must be contiguous")


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, want_lse: bool = False,
                   kbias=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel (``csrc/flash_fwd.cu``) on the current
    stream; ``kbias``: an optional f32 (B, Tk) key-row bias.  Raises for
    tensors that are not on one CUDA device, not contiguous, or of a type
    or shape the kernel does not take."""
    if q.ndim != 4:
        raise ValueError(f"flash_fwd_cuda: q must be (B, H, T, d), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(
            f"flash_fwd_cuda: k/v must be (B, H, Tk, d) = ({b}, {h}, Tk, {d}), "
            f"got {tuple(k.shape)} / {tuple(v.shape)}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd_cuda: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd_cuda: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} must be one of "
            f"{list(_DTYPE_CODES)} and equal"
        )
    if causal and sq > sk:
        raise ValueError(f"flash_fwd_cuda: causal attention needs Tq <= Tk, got {sq} > {sk}")
    if b * h > 65535:
        raise ValueError(f"flash_fwd_cuda: B*H = {b * h} exceeds the grid's 65535")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"flash_fwd_cuda: {name} lies on {t.device}, need the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd_cuda: {name} must be contiguous")
    _check_kbias("flash_fwd_cuda", kbias, b, sk, dev)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if want_lse else None
    lib = _kernels.library()
    fn = lib.fn("flash_fwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        kbias.data_ptr() if kbias is not None else None,
        b * h, h, sq, sk, d, _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_fwd", err)
    _kernels.count_launch("flash_fwd")
    return out, lse


def flash_fwd(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
              want_lse: bool = False, kbias=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The attention forward kernel's function: ``(out, lse or None)``;
    ``kbias``: an optional f32 (B, Tk) key-row bias.  CUDA tensors take
    the kernel, CPU tensors the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out, lse = flash_fwd_reference(q, k, v, causal, sm_scale, kbias)
        return out, (lse if want_lse else None)
    return flash_fwd_cuda(q, k, v, causal, sm_scale, want_lse=want_lse, kbias=kbias)


def flash_bwd_reference(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                        kbias=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel's arithmetic (the
    Pallas ``_flash_bwd_fused_kernel``'s): f32 scores from the operands'
    values plus the f32 key-row bias ``kbias`` (B, Tk) if given,
    ``p = exp(s - lse)`` with masked scores at ``DEFAULT_MASK_VALUE``,
    ``p`` rounded to dO's type before the dV product,
    ``ds = p (dp - delta) scale`` (no bias term: the bias enters after the
    scale) rounded to q's type before the dK and dQ products, f32 sums.
    ``lse`` and ``delta`` are (B, H, Tq) f32.  Returns ``(dq, dk, dv)`` in
    the inputs' types."""
    p = torch.exp(_scores(q, k, causal, sm_scale, _kbias4(kbias)) - lse[..., None])
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do32)
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                   kbias=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward CUDA kernel (``csrc/flash_bwd.cu``) on the
    current stream; ``kbias``: the forward's optional f32 (B, Tk) key-row
    bias.  dq is summed in an f32 buffer (zeroed here, cast to
    q's type after the kernel, as the Pallas kernel's ``dq32``).  Raises
    for tensors that are not on one CUDA device, not contiguous, or of a
    type or shape the kernel does not take."""
    if q.ndim != 4:
        raise ValueError(f"flash_bwd_cuda: q must be (B, H, T, d), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d) or do.shape != q.shape:
        raise ValueError(
            f"flash_bwd_cuda: k/v must be (B, H, Tk, d) and dO like q ({tuple(q.shape)}), got "
            f"{tuple(k.shape)} / {tuple(v.shape)} / {tuple(do.shape)}"
        )
    if lse.shape != (b, h, sq) or delta.shape != (b, h, sq):
        raise ValueError(
            f"flash_bwd_cuda: lse/delta must be (B, H, Tq) = ({b}, {h}, {sq}), got "
            f"{tuple(lse.shape)} / {tuple(delta.shape)}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_bwd_cuda: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError(
            f"flash_bwd_cuda: q/k/v/dO dtypes {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype} must be "
            f"one of {list(_DTYPE_CODES)} and equal"
        )
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"flash_bwd_cuda: lse/delta must be float32, got {lse.dtype}/{delta.dtype}")
    if causal and sq > sk:
        raise ValueError(f"flash_bwd_cuda: causal attention needs Tq <= Tk, got {sq} > {sk}")
    if b * h > 65535:
        raise ValueError(f"flash_bwd_cuda: B*H = {b * h} exceeds the grid's 65535")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do), ("lse", lse), ("delta", delta)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"flash_bwd_cuda: {name} lies on {t.device}, need the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_bwd_cuda: {name} must be contiguous")
    _check_kbias("flash_bwd_cuda", kbias, b, sk, dev)
    dq32 = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.library()
    fn = lib.fn("flash_bwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), kbias.data_ptr() if kbias is not None else None, dq32.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b * h, h, sq, sk, d, _DTYPE_CODES[q.dtype],
        int(bool(causal)), float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_bwd", err)
    _kernels.count_launch("flash_bwd")
    return dq32.to(q.dtype), dk, dv


def flash_bwd(q, k, v, do, lse, delta, causal: bool, sm_scale: float,
              kbias=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward kernel's function: ``(dq, dk, dv)``.  CUDA
    tensors take the kernel, CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal, sm_scale, kbias)
    return flash_bwd_cuda(q, k, v, do, lse, delta, causal, sm_scale, kbias)


def _bias_mode(bias, b: int, sk: int):
    """Classify an additive bias: (B or 1, 1, 1, Tk) is ``("kbias", f32
    (B, Tk))``, the kernels' form; anything else broadcastable to (B, H,
    Tq, Tk) is ``("fbias", bias)``."""
    if bias is None:
        return None, None
    if bias.ndim != 4:
        raise ValueError(f"bias must be 4-D broadcastable to (B,H,Tq,Tk), got {tuple(bias.shape)}")
    if bias.shape[1] == 1 and bias.shape[2] == 1 and bias.shape[3] == sk:
        return "kbias", bias.detach().expand(b, 1, 1, sk).reshape(b, sk).float().contiguous()
    return "fbias", bias


def _bias_cotangent(q, k, v, out, lse, do, bias, causal: bool, sm_scale: float) -> torch.Tensor:
    """Exact dL/dbias: dS of the pre-scale scores (no ``sm_scale``, the
    bias enters after it), summed over the dims the bias broadcasts along.
    Computed only for a bias that requires a gradient (a learned relative
    position); a constant padding mask never pays this O(Tq*Tk) pass."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = _scores(q, k, causal, sm_scale, torch.broadcast_to(bias.detach(), (b, h, sq, sk)))
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    delta = (do32 * out.float()).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    dims = tuple(i for i in range(4) if bias.shape[i] == 1)
    db = ds.sum(dim=dims, keepdim=True) if dims else ds
    return db.to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """Kernel attention with its kernel backward (the JAX package's
    ``_flash_attention`` custom_vjp): the forward keeps the kernel's
    ``lse``; the backward forms ``delta = rowsum(dO * O)`` in f32 as plain
    torch (the XLA prologue of the Pallas backward) and runs
    :func:`flash_bwd`.  ``bias`` is the caller's key-row bias (B or 1, 1,
    1, Tk) or None; the kernels take it as the f32 (B, Tk) ``kbias``.  Its
    cotangent is :func:`_bias_cotangent`, computed only when the bias
    requires a gradient: a constant mask gets None, the port's form of
    XLA's dead-code elimination of that pass."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, sm_scale: float):
        kbias = _bias_mode(bias, q.shape[0], k.shape[2])[1]
        out, lse = flash_fwd(q, k, v, causal, sm_scale, want_lse=True, kbias=kbias)
        ctx.save_for_backward(q, k, v, out, lse, kbias, bias)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kbias, bias = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale, kbias)
        dbias = None
        if ctx.needs_input_grad[3]:
            dbias = _bias_cotangent(q, k, v, out, lse, do, bias, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, dbias, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                    bias=None, dropout_rate: float = 0.0) -> torch.Tensor:
    """Attention over ``(batch, heads, seq, head_dim)`` inputs,
    differentiable.

    Dispatch as in the JAX package: ``sq*sk <= 128*128`` takes
    :func:`mha_dense`, fewer than 8 rows :func:`mha_reference`, the rest
    the kernels (:class:`_FlashAttention` when a gradient is wanted, the
    forward kernel alone without ``lse`` otherwise, as the JAX package's
    non-differentiated primal).  The JAX version also routed shapes outside its TPU
    envelope (no block divisor of T, K/V beyond the VMEM budget) to a
    blockwise XLA path or to the splash kernel; the Hopper kernel masks a
    ragged last tile and streams K/V through shared memory, so it serves
    every length up to ``n_positions`` and those routes do not exist
    here.

    ``bias``: an additive score bias broadcastable to (B, H, Tq, Tk),
    differentiable.  Past the dense threshold the kernels take the
    key-row form (B, 1, 1, Tk); the full form raises there (ROADMAP A9),
    as does ``dropout_rate > 0`` everywhere."""
    if dropout_rate > 0.0:
        raise NotImplementedError("flash_attention dropout is not ported yet (ROADMAP A9)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
    if sq * sk <= SMALL_SEQ_DENSE_SCORES:
        return mha_dense(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias)
    if sq < 8 or sk < 8 or (causal and sq > sk):
        # causal sq > sk leaves rows with no key at all; the reference's
        # uniform softmax is the defined answer there
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias)
    mode, kbias = _bias_mode(bias, b, sk)
    if mode == "fbias":
        raise NotImplementedError(
            f"flash_attention: a full score bias {tuple(bias.shape)} past the dense threshold is "
            "not ported yet (ROADMAP A9); the kernels take a key-row bias (B, 1, 1, Tk)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    wants_grad = any(t is not None and t.requires_grad for t in (q, k, v, bias))
    if torch.is_grad_enabled() and wants_grad:
        return _FlashAttention.apply(q, k, v, bias, causal, float(sm_scale))
    return flash_fwd(q, k, v, causal, sm_scale, kbias=kbias)[0]
