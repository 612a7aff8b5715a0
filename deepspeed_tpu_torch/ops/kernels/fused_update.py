"""Fused optimizer update: one memory pass per leaf (counterpart of
``deepspeed_tpu/ops/kernels/fused_update.py``, Adam branch).

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

LAMB (ROADMAP B7) is not ported: :func:`engine_update` raises for it.
"""
from __future__ import annotations

from typing import Any, List, Optional

import torch

from deepspeed_tpu_torch.ops import kernels as _kernels
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState, FusedAdam, _adam_keep_body

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def adam_update_reference(p32, g32, m, v, lr, b1, b2, eps, weight_decay,
                          adam_w_mode, c1, c2):
    """Adam/AdamW on f32 tensors: returns ``(p_new, m_new, v_new)``.
    ``c1``/``c2`` are the bias corrections (pass 1.0 to disable).  The
    keep-folded body with keep = 1."""
    keep = torch.ones((), dtype=torch.float32, device=p32.device)
    return _adam_keep_body(p32, g32, m, v, lr, keep, c1, c2, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, adam_w_mode=adam_w_mode)


def _check_leaf(p, g, m, v, scal) -> None:
    if p.shape != g.shape or p.shape != m.shape or p.shape != v.shape:
        raise ValueError(
            f"adam_leaf: p/g/m/v shapes differ: {tuple(p.shape)} / {tuple(g.shape)} / "
            f"{tuple(m.shape)} / {tuple(v.shape)}"
        )
    if p.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"adam_leaf: p/g dtypes {p.dtype}/{g.dtype} must be one of {list(_DTYPE_CODES)}")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or scal.dtype != torch.float32:
        raise ValueError(f"adam_leaf: m/v/scal must be float32, got {m.dtype}/{v.dtype}/{scal.dtype}")
    if scal.shape != (4,):
        raise ValueError(f"adam_leaf: scal must be [lr, keep, c1, c2], got shape {tuple(scal.shape)}")


def adam_leaf_cuda(p, g, m, v, scal, *, b1, b2, eps, weight_decay, adam_w_mode) -> None:
    """Launch the fused Adam kernel (``csrc/fused_adam.cu``) on the
    current stream; p, m and v are updated in place (the Pallas kernel's
    ``input_output_aliases``).  Raises for tensors that are not on one
    CUDA device, not contiguous, or of a type the kernel does not take."""
    _check_leaf(p, g, m, v, scal)
    dev = p.device
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v), ("scal", scal)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"adam_leaf_cuda: {name} lies on {t.device}, need the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"adam_leaf_cuda: {name} must be contiguous")
    lib = _kernels.library()
    fn = lib.fn("fused_adam")
    err = fn(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), scal.data_ptr(), p.numel(),
        _DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype],
        b1 - 1.0, 1.0 - b1, b2 - 1.0, 1.0 - b2, float(eps), float(weight_decay),
        int(bool(adam_w_mode)), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("fused_adam", err)
    _kernels.count_launch("fused_adam")


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


def adam_scalars(optimizer, step: torch.Tensor, lr, overflow: Optional[torch.Tensor]) -> torch.Tensor:
    """``[lr, keep, c1, c2]`` as an f32 tensor on ``step``'s device, from
    torch ops only (no host read).  The bias corrections count
    ``step + 1`` unconditionally, as ``FusedAdam.update``: on a skipped
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
                  lr, overflow: Optional[torch.Tensor]) -> Any:
    """The engine's update seam: one :func:`adam_leaf` per leaf, in place
    over ``params`` and the state's moments; the state's step advances
    unless ``overflow``.  Returns the state, or None when the optimizer
    or state is not the Adam family with f32 state (the caller then takes
    ``optimizer.update``).  LAMB raises (ROADMAP B7)."""
    if getattr(optimizer, "name", None) in ("lamb", "onebitlamb"):
        raise NotImplementedError("the fused LAMB update is not ported yet (ROADMAP B7)")
    if not (isinstance(optimizer, FusedAdam) and isinstance(opt_state, AdamState)):
        return None
    scal = adam_scalars(optimizer, opt_state.step, lr, overflow)
    hyper = dict(b1=optimizer.b1, b2=optimizer.b2, eps=optimizer.eps,
                 weight_decay=optimizer.weight_decay, adam_w_mode=optimizer.adam_w_mode)
    for p, g, m, v in zip(params, grads, opt_state.exp_avg, opt_state.exp_avg_sq):
        adam_leaf(p, g, m, v, scal, **hyper)
    if overflow is None:
        opt_state.step += 1
    else:
        opt_state.step += (~overflow).to(opt_state.step.dtype)
    return opt_state
