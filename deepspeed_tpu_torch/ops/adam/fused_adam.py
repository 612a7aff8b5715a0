"""Adam / AdamW / SGD (counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``).

The optimizers work on lists of parameter tensors (the engine's
flattened leaves, in one fixed order).  ``init(params)`` builds the state;
``update(grads, state, params, lr=..., skip=...)`` is the plain,
functional step: it returns ``(updates, new_state)`` and the caller
applies ``p + u``.  The engine's Adam path does not call ``update``: it
runs the fused kernel in place through
:func:`deepspeed_tpu_torch.ops.kernels.fused_update.engine_update`.

Only f32 Adam state is ported; ``state_precision`` "8bit" and "bf16"
raise (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # 0-dim int32, on the parameters' device
    exp_avg: List[torch.Tensor]  # m, one f32 tensor per parameter
    exp_avg_sq: List[torch.Tensor]  # v, one f32 tensor per parameter


def _device_of(params: List[torch.Tensor]) -> torch.device:
    return params[0].device if params else torch.device("cpu")


def _adam_keep_body(p32, g32, m, v, lr, keep, c1, c2, *, b1, b2, eps,
                    weight_decay, adam_w_mode):
    """The keep-folded Adam body on f32 values: ``(p32_new, m_new,
    v_new)``.  ``keep`` is an f32 scalar tensor, 1 - overflow: 0 selects
    the old state and a zero update.  ``lr``, ``c1``, ``c2`` are f32 scalar
    tensors or floats.  This is the one copy of the Adam arithmetic: the
    CUDA kernel (``csrc/fused_adam.cu``) rounds each product and sum on its
    own as this does."""
    g32 = torch.where(keep > 0, g32, torch.zeros((), dtype=g32.dtype, device=g32.device))
    if not adam_w_mode and weight_decay > 0.0:
        g32 = g32 + weight_decay * p32
    m_new = m + keep * ((b1 - 1.0) * m + (1.0 - b1) * g32)
    v_new = v + keep * ((b2 - 1.0) * v + (1.0 - b2) * g32 * g32)
    denom = torch.sqrt(v_new / c2) + eps
    upd = -(lr * (m_new / c1) / denom)
    if adam_w_mode and weight_decay > 0.0:
        upd = upd - (lr * weight_decay) * p32
    return p32 + keep * upd, m_new, v_new


class FusedAdam:
    """Adam with decoupled (AdamW) or L2 (classic) weight decay.
    ``adam_w_mode=True`` decays the parameters, not the gradients."""

    name = "adam"

    def __init__(
        self,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        adam_w_mode: bool = True,
        bias_correction: bool = True,
        amsgrad: bool = False,
        state_precision: str = "fp32",
        state_block: int = 256,
    ):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad (matches reference)")
        if state_precision not in ("fp32", "bf16", "8bit"):
            raise ValueError(
                f"state_precision must be 'fp32', 'bf16' or '8bit', got {state_precision!r}"
            )
        if state_precision != "fp32":
            raise NotImplementedError(
                f"state_precision={state_precision!r} (reduced-precision Adam state) is not "
                "ported yet (ROADMAP A13)"
            )
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.state_precision = state_precision
        self.state_block = state_block

    def init(self, params: List[torch.Tensor]) -> AdamState:
        zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            exp_avg=zeros(), exp_avg_sq=zeros(),
        )

    def update(self, grads: List[torch.Tensor], state: AdamState, params: List[torch.Tensor],
               lr=None, skip: Optional[torch.Tensor] = None):
        """Returns ``(updates, new_state)``; apply with ``p + u``.
        ``skip``: optional 0-dim bool tensor (overflow); when set the state
        keeps its old values and the updates are zero."""
        lr = self.lr if lr is None else lr
        dev = state.step.device
        keep = (torch.ones((), dtype=torch.float32, device=dev) if skip is None
                else 1.0 - skip.to(torch.float32))
        step = state.step + (1 if skip is None else (~skip).to(state.step.dtype))
        if self.bias_correction:
            # bias corrections use the unconditional count: on a skipped
            # step the stored count stays put and c2 = 1 - b2^0 = 0 would
            # divide by zero (the update is zeroed there anyway)
            bstep = (state.step + 1).to(torch.float32)
            c1 = 1.0 - torch.pow(self.b1, bstep)
            c2 = 1.0 - torch.pow(self.b2, bstep)
        else:
            c1 = c2 = 1.0
        updates, ms, vs = [], [], []
        for g, m, v, p in zip(grads, state.exp_avg, state.exp_avg_sq, params):
            p32 = p.float()
            p_new, m_new, v_new = _adam_keep_body(
                p32, g.float(), m, v, lr, keep, c1, c2, b1=self.b1, b2=self.b2, eps=self.eps,
                weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode)
            # exact while |u| <= |p| / 2 (Sterbenz), so p + u gives back p_new
            updates.append(p_new - p32)
            ms.append(m_new)
            vs.append(v_new)
        return updates, AdamState(step=step, exp_avg=ms, exp_avg_sq=vs)


class FusedAdamW(FusedAdam):
    name = "adamw"

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, **kw):
        super().__init__(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         adam_w_mode=True, **kw)


class SGD:
    name = "sgd"

    def __init__(self, lr: float = 1e-3, momentum: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params: List[torch.Tensor]):
        state = {"step": torch.zeros((), dtype=torch.int32, device=_device_of(params))}
        if self.momentum != 0.0:
            state["momentum_buffer"] = [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params
            ]
        return state

    def update(self, grads: List[torch.Tensor], state, params: List[torch.Tensor], lr=None):
        lr = self.lr if lr is None else lr
        new_state = {"step": state["step"] + 1}
        updates, bufs = [], []
        for i, (g, p) in enumerate(zip(grads, params)):
            g = g.float()
            if self.weight_decay > 0.0:
                g = g + self.weight_decay * p.float()
            if self.momentum == 0.0:
                updates.append(-lr * g)
                continue
            buf_new = self.momentum * state["momentum_buffer"][i] + g
            d = g + self.momentum * buf_new if self.nesterov else buf_new
            updates.append(-lr * d)
            bufs.append(buf_new)
        if self.momentum != 0.0:
            new_state["momentum_buffer"] = bufs
        return updates, new_state
