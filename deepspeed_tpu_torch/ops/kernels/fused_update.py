"""Fused optimizer update: one memory pass per leaf for Adam, two for
LAMB (counterpart of ``deepspeed_tpu/ops/kernels/fused_update.py``).

:func:`adam_leaf` updates one parameter leaf and its moments in place:
for CUDA tensors it launches the kernel (``csrc/fused_adam.cu``), which
reads (p, g, m, v) once and writes (p, m, v) once; for CPU tensors it runs
:func:`_adam_keep_body`, the plain PyTorch version of the same
arithmetic.  Every leaf takes the kernel, whatever its size: the JAX
package's ``size % 256`` / 8-row rule was the TPU's tiling envelope.

Overflow ("skip") folds into the same pass: ``keep = 1 - overflow``
writes back the old state and the old parameter.  The scalars
``[lr, keep, c1, c2]`` travel as a 4-float tensor on the leaves' device,
built with torch ops, so neither the overflow flag nor the step count is
ever read on the host.

LAMB needs the whole leaf's trust ratio ``||p|| / ||dir||`` before any
parameter byte can be written, so :func:`lamb_leaf` is two passes.  For
CUDA tensors the first kernel (``csrc/fused_lamb.cu``, B7a) reads (p, g,
m, v) once, writes m and v in place, the direction ``dir`` (f32, into a
scratch buffer) and one ``(sum p^2, sum dir^2)`` partial per block; the
trust ratio resolves on the device from the partials with torch ops
(:func:`_lamb_trust`, no host read), and the second kernel (B7b) reads
(p, dir) and writes ``p - lr * trust * dir`` in p's type.  For CPU
tensors :func:`_lamb_math` runs the same arithmetic.  The scalars ride in
the same ``[lr, keep, c1, c2]`` tensor as Adam's.
"""
from __future__ import annotations

import functools
from typing import Any, List, Optional

import torch

from deepspeed_tpu_torch.ops import kernels as _kernels
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState, FusedAdam, _adam_keep_body
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb, LambState

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def adam_update_reference(p32, g32, m, v, lr, b1, b2, eps, weight_decay,
                          adam_w_mode, c1, c2):
    """Adam/AdamW on f32 tensors: returns ``(p_new, m_new, v_new)``.
    ``c1``/``c2`` are the bias corrections (pass 1.0 to disable).  The
    keep-folded body with keep = 1."""
    keep = torch.ones((), dtype=torch.float32, device=p32.device)
    return _adam_keep_body(p32, g32, m, v, lr, keep, c1, c2, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, adam_w_mode=adam_w_mode)


def _check_leaf(p, g, m, v, scal, who: str = "adam_leaf") -> None:
    if p.shape != g.shape or p.shape != m.shape or p.shape != v.shape:
        raise ValueError(
            f"{who}: p/g/m/v shapes differ: {tuple(p.shape)} / {tuple(g.shape)} / "
            f"{tuple(m.shape)} / {tuple(v.shape)}"
        )
    if p.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"{who}: p/g dtypes {p.dtype}/{g.dtype} must be one of {list(_DTYPE_CODES)}")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or scal.dtype != torch.float32:
        raise ValueError(f"{who}: m/v/scal must be float32, got {m.dtype}/{v.dtype}/{scal.dtype}")
    if scal.shape != (4,):
        raise ValueError(f"{who}: scal must be [lr, keep, c1, c2], got shape {tuple(scal.shape)}")


def _check_on_device(who: str, dev, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{who}: {name} lies on {t.device}, need the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def adam_leaf_cuda(p, g, m, v, scal, *, b1, b2, eps, weight_decay, adam_w_mode) -> None:
    """Launch the fused Adam kernel (``csrc/fused_adam.cu``) on the
    current stream; p, m and v are updated in place (the Pallas kernel's
    ``input_output_aliases``).  Raises for tensors that are not on one
    CUDA device, not contiguous, or of a type the kernel does not take."""
    _check_leaf(p, g, m, v, scal)
    dev = p.device
    _check_on_device("adam_leaf_cuda", dev, p=p, g=g, m=m, v=v, scal=scal)
    lib = _kernels.library()
    fn = lib.fn("fused_adam")
    err = fn(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), scal.data_ptr(), p.numel(),
        _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype],
        b1 - 1.0, 1.0 - b1, b2 - 1.0, 1.0 - b2, float(eps), float(weight_decay),
        int(bool(adam_w_mode)), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("fused_adam", err)
    # 24 FLOPs an element; p and g read, p written, m and v read and written
    _kernels.count_launch("fused_adam", cost=lambda: (
        24 * p.numel(), p.numel() * (2 * p.element_size() + g.element_size() + 16)))


def adam_leaf(p, g, m, v, scal, *, b1, b2, eps, weight_decay, adam_w_mode) -> None:
    """One Adam/AdamW step of one leaf, in place: ``scal`` is the f32
    tensor ``[lr, keep, c1, c2]`` on the leaf's device.  CUDA tensors take
    the kernel, CPU tensors the plain version."""
    if p.device.type != "cpu":
        adam_leaf_cuda(p, g, m, v, scal, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, adam_w_mode=adam_w_mode)
        return
    _check_leaf(p, g, m, v, scal)
    lr, keep, c1, c2 = scal.unbind(0)
    p_new, m_new, v_new = _adam_keep_body(
        p.float(), g.float(), m, v, lr, keep, c1, c2, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay, adam_w_mode=adam_w_mode,
    )
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


# ---------------------------------------------------------------------------
# LAMB: two passes per leaf (B7a direction + norm partials, B7b apply)
# ---------------------------------------------------------------------------

_LAMB_THREADS = 256
_LAMB_MAX_BLOCKS = 132 * 8  # 8 blocks of 256 threads per SM of an H100


def _lamb_dir_body(p32, g32, m, v, keep, c1, c2, *, b1, b2, eps, weight_decay):
    """The keep-folded LAMB direction on f32 values: ``(dir, m_new,
    v_new)``, the decay term included.  The CUDA kernel's pass 1 rounds
    each product and sum on its own as this does."""
    g32 = torch.where(keep > 0, g32, torch.zeros((), dtype=g32.dtype, device=g32.device))
    m_new = m + keep * ((b1 - 1.0) * m + (1.0 - b1) * g32)
    v_new = v + keep * ((b2 - 1.0) * v + (1.0 - b2) * g32 * g32)
    d = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
    if weight_decay > 0.0:
        d = d + weight_decay * p32
    return d, m_new, v_new


def _lamb_trust(w_norm, u_norm, min_coeff, max_coeff):
    """``||p|| / ||dir||`` clamped to ``[min_coeff, max_coeff]``, and 1
    where either norm is 0."""
    return torch.where(
        (w_norm > 0) & (u_norm > 0),
        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
        torch.ones((), dtype=torch.float32, device=w_norm.device),
    )


def _lamb_math(p, g, m, v, lr, keep, c1, c2, *, b1, b2, eps, weight_decay, min_coeff,
               max_coeff):
    """The plain LAMB leaf: the direction body, the trust ratio from the
    whole leaf's norms, and ``p - keep * lr * trust * dir`` in p's type.
    Returns ``(p_new, m_new, v_new, trust)``."""
    p32 = p.float()
    d, m_new, v_new = _lamb_dir_body(p32, g.float(), m, v, keep, c1, c2, b1=b1, b2=b2, eps=eps,
                                     weight_decay=weight_decay)
    trust = _lamb_trust(torch.linalg.vector_norm(p32), torch.linalg.vector_norm(d),
                        min_coeff, max_coeff)
    return (p32 - keep * lr * trust * d).to(p.dtype), m_new, v_new, trust


def _lamb_blocks(n: int) -> int:
    """Pass 1's grid: one block per 1,024 elements, at most 8 per SM; the
    count of norm partials."""
    return max(1, min(-(-n // (4 * _LAMB_THREADS)), _LAMB_MAX_BLOCKS))


def lamb_dir_cuda(p, g, m, v, scal, dir_buf, *, b1, b2, eps, weight_decay) -> torch.Tensor:
    """Launch LAMB's pass 1 (B7a, ``csrc/fused_lamb.cu``) on the current
    stream: m and v updated in place, the direction written into the
    first ``p.numel()`` elements of the f32 scratch ``dir_buf``.  Returns
    the norm partials, an f32 ``(blocks, 2)`` tensor of ``(sum p^2, sum
    dir^2)`` per block."""
    _check_leaf(p, g, m, v, scal, "lamb_leaf")
    dev = p.device
    _check_on_device("lamb_dir_cuda", dev, p=p, g=g, m=m, v=v, scal=scal, dir_buf=dir_buf)
    n = p.numel()
    if dir_buf.dtype != torch.float32 or dir_buf.numel() < n:
        raise ValueError(f"lamb_dir_cuda: dir_buf must be float32 with >= {n} elements, got "
                         f"{dir_buf.dtype} with {dir_buf.numel()}")
    blocks = _lamb_blocks(n)
    partials = torch.empty((blocks, 2), dtype=torch.float32, device=dev)
    lib = _kernels.library()
    err = lib.fn("fused_lamb_dir")(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), dir_buf.data_ptr(),
        partials.data_ptr(), scal.data_ptr(), n, blocks, _DTYPE_CODES[p.dtype],
        _DTYPE_CODES[g.dtype], b1 - 1.0, 1.0 - b1, b2 - 1.0, 1.0 - b2, float(eps),
        float(weight_decay), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("fused_lamb_dir", err)
    # 26 FLOPs an element; p, g read, m, v read and written, the f32 direction written
    _kernels.count_launch("fused_lamb_dir", cost=lambda: (
        26 * n, n * (p.element_size() + g.element_size() + 20)))
    return partials


def lamb_apply_cuda(p, dir_buf, scal, trust) -> None:
    """Launch LAMB's pass 2 (B7b, ``csrc/fused_lamb.cu``) on the current
    stream: ``p - ((keep * lr) * trust) * dir`` written over p in p's
    type.  ``trust``: a 1-element f32 tensor on the device."""
    dev = p.device
    _check_on_device("lamb_apply_cuda", dev, p=p, dir_buf=dir_buf, scal=scal, trust=trust)
    if p.dtype not in _DTYPE_CODES or dir_buf.dtype != torch.float32 or dir_buf.numel() < p.numel():
        raise ValueError(f"lamb_apply_cuda: p {p.dtype} must be one of {list(_DTYPE_CODES)} and "
                         f"dir_buf float32 with >= {p.numel()} elements")
    if trust.dtype != torch.float32 or trust.numel() != 1 or scal.shape != (4,):
        raise ValueError("lamb_apply_cuda: trust must be one float32 value and scal "
                         "[lr, keep, c1, c2]")
    lib = _kernels.library()
    err = lib.fn("fused_lamb_apply")(
        p.data_ptr(), dir_buf.data_ptr(), scal.data_ptr(), trust.data_ptr(), p.numel(),
        _DTYPE_CODES[p.dtype], torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("fused_lamb_apply", err)
    # 2 FLOPs an element; the f32 direction and p read, p written
    _kernels.count_launch("fused_lamb_apply", cost=lambda: (
        2 * p.numel(), p.numel() * (4 + 2 * p.element_size())))


def lamb_trust_from_partials(partials, min_coeff, max_coeff) -> torch.Tensor:
    """The trust ratio from pass 1's norm partials, on the device (torch
    ops, no host read): a 1-element f32 tensor."""
    norms = partials.sum(dim=0).sqrt()
    return _lamb_trust(norms[0], norms[1], min_coeff, max_coeff).reshape(1)


def lamb_trust_from_sums(sums, min_coeff, max_coeff) -> torch.Tensor:
    """The trust ratio from the summed ``(sum p^2, sum dir^2)`` of a whole
    leaf (a ZeRO shard's partials summed over the ranks that hold the
    rest): a 1-element f32 tensor."""
    norms = sums.sqrt()
    return _lamb_trust(norms[0], norms[1], min_coeff, max_coeff).reshape(1)


def lamb_leaf_cuda(p, g, m, v, scal, *, b1, b2, eps, weight_decay, min_coeff, max_coeff,
                   dir_buf: Optional[torch.Tensor] = None, reduce_sq=None) -> torch.Tensor:
    """Both LAMB passes over one leaf on the current stream, with the trust
    ratio resolved on the device between them; p, m and v are updated in
    place.  ``dir_buf``: an f32 scratch of at least ``p.numel()`` elements
    for the direction (one buffer may serve every leaf of a step, in
    stream order); allocated here if None.  ``reduce_sq``: where p is a
    ZeRO shard, a function that sums the shard's ``(sum p^2, sum dir^2)``
    over the ranks holding the rest of the leaf (zero padding adds
    nothing).  Returns the trust ratio.  Raises for tensors that are not
    on one CUDA device, not contiguous, or of a type the kernels do not
    take."""
    if dir_buf is None:
        dir_buf = torch.empty(p.numel(), dtype=torch.float32, device=p.device)
    partials = lamb_dir_cuda(p, g, m, v, scal, dir_buf, b1=b1, b2=b2, eps=eps,
                             weight_decay=weight_decay)
    if reduce_sq is None:
        trust = lamb_trust_from_partials(partials, min_coeff, max_coeff)
    else:
        trust = lamb_trust_from_sums(reduce_sq(partials.sum(dim=0)), min_coeff, max_coeff)
    lamb_apply_cuda(p, dir_buf, scal, trust)
    return trust


def lamb_leaf(p, g, m, v, scal, *, b1, b2, eps, weight_decay, min_coeff, max_coeff,
              dir_buf: Optional[torch.Tensor] = None, reduce_sq=None) -> torch.Tensor:
    """One LAMB step of one leaf, in place: ``scal`` is the f32 tensor
    ``[lr, keep, c1, c2]`` on the leaf's device.  CUDA tensors take the
    kernels, CPU tensors the plain version.  ``reduce_sq``: see
    :func:`lamb_leaf_cuda`.  Returns the trust ratio."""
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, min_coeff=min_coeff,
                 max_coeff=max_coeff)
    if p.device.type != "cpu":
        return lamb_leaf_cuda(p, g, m, v, scal, dir_buf=dir_buf, reduce_sq=reduce_sq, **hyper)
    _check_leaf(p, g, m, v, scal, "lamb_leaf")
    if reduce_sq is not None:
        lr, keep, c1, c2 = scal.unbind(0)
        p32 = p.float()
        d, m_new, v_new = _lamb_dir_body(p32, g.float(), m, v, keep, c1, c2, b1=b1, b2=b2,
                                         eps=eps, weight_decay=weight_decay)
        sums = reduce_sq(torch.stack([torch.sum(p32 * p32), torch.sum(d * d)]))
        trust = lamb_trust_from_sums(sums, min_coeff, max_coeff)
        p.copy_((p32 - keep * lr * trust[0] * d).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
        return trust
    p_new, m_new, v_new, trust = _lamb_math(p, g, m, v, *scal.unbind(0), **hyper)
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)
    return trust.reshape(1)


def adam_scalars(optimizer, step: torch.Tensor, lr, overflow: Optional[torch.Tensor]) -> torch.Tensor:
    """``[lr, keep, c1, c2]`` as an f32 tensor on ``step``'s device, from
    torch ops only (no host read), for Adam and LAMB alike.  The bias
    corrections count ``step + 1`` unconditionally, as
    ``FusedAdam.update``: on a skipped
    step the values do not matter (the update is zeroed) but must stay
    finite."""
    dev = step.device
    keep = (torch.ones((), dtype=torch.float32, device=dev) if overflow is None
            else 1.0 - overflow.to(torch.float32))
    if optimizer.bias_correction:
        bstep = (step + 1).to(torch.float32)
        c1 = 1.0 - torch.pow(optimizer.b1, bstep)
        c2 = 1.0 - torch.pow(optimizer.b2, bstep)
    else:
        c1 = c2 = torch.ones((), dtype=torch.float32, device=dev)
    if isinstance(lr, torch.Tensor) and lr.device == dev:
        lr_t = lr.to(torch.float32)
    else:  # a host value: a fill on the device, no host-to-device copy
        lr_t = torch.full((), float(lr), dtype=torch.float32, device=dev)
    return torch.stack([lr_t, keep, c1, c2])


def engine_update(optimizer, grads: List[torch.Tensor], opt_state, params: List[torch.Tensor],
                  lr, overflow: Optional[torch.Tensor], reduce_norms=None) -> Any:
    """The engine's update seam: one :func:`adam_leaf` or :func:`lamb_leaf`
    per leaf, in place over ``params`` and the state's moments; the
    state's step advances unless ``overflow``.  ``reduce_norms(i, sums)``:
    for ZeRO shards, LAMB's per-leaf squared norms summed across ranks.
    Returns the state, or None when the optimizer or state is neither the
    Adam family with f32 state nor LAMB (the caller then takes
    ``optimizer.update``): the reduced Adam state (``AdamState8``) returns
    None as in the JAX package, whose reduced-state update runs outside
    any Pallas kernel."""
    is_adam = isinstance(optimizer, FusedAdam) and isinstance(opt_state, AdamState)
    is_lamb = isinstance(optimizer, FusedLamb) and isinstance(opt_state, LambState)
    if not (is_adam or is_lamb):
        return None
    scal = adam_scalars(optimizer, opt_state.step, lr, overflow)
    hyper = dict(b1=optimizer.b1, b2=optimizer.b2, eps=optimizer.eps,
                 weight_decay=optimizer.weight_decay)
    leaves = zip(params, grads, opt_state.exp_avg, opt_state.exp_avg_sq)
    if is_adam:
        for p, g, m, v in leaves:
            adam_leaf(p, g, m, v, scal, adam_w_mode=optimizer.adam_w_mode, **hyper)
    else:
        # one direction scratch for the whole step, reused leaf by leaf in
        # stream order
        dir_buf = None
        if params and params[0].is_cuda:
            dir_buf = torch.empty(max(p.numel() for p in params), dtype=torch.float32,
                                  device=params[0].device)
        for i, (p, g, m, v) in enumerate(leaves):
            red = None if reduce_norms is None else functools.partial(reduce_norms, i)
            lamb_leaf(p, g, m, v, scal, min_coeff=optimizer.min_coeff,
                      max_coeff=optimizer.max_coeff, dir_buf=dir_buf, reduce_sq=red, **hyper)
    if overflow is None:
        opt_state.step += 1
    else:
        opt_state.step += (~overflow).to(opt_state.step.dtype)
    return opt_state
