"""LAMB (counterpart of ``deepspeed_tpu/ops/lamb/fused_lamb.py``).

``FusedLamb`` works on lists of parameter tensors (the engine's flattened
leaves, in one fixed order), as :class:`~deepspeed_tpu_torch.ops.adam.
fused_adam.FusedAdam` does.  ``init(params)`` builds the state;
``update(grads, state, params, lr=...)`` is the plain, functional step:
it returns ``(updates, new_state)`` and the caller applies ``p + u``.  The
trust ratio ``||p|| / ||dir||`` is taken per leaf, so a leaf that stacks
the layers on a leading dim gets one ratio for all of them, as in the JAX
package.  The engine does not call ``update``: it runs the two LAMB
kernels in place through
:func:`deepspeed_tpu_torch.ops.kernels.fused_update.engine_update`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import _device_of


@dataclasses.dataclass
class LambState:
    step: torch.Tensor  # 0-dim int32, on the parameters' device
    exp_avg: List[torch.Tensor]  # m, one f32 tensor per parameter
    exp_avg_sq: List[torch.Tensor]  # v, one f32 tensor per parameter


class FusedLamb:
    name = "lamb"

    def __init__(
        self,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        bias_correction: bool = True,
        max_coeff: float = 10.0,
        min_coeff: float = 0.01,
    ):
        """``max_coeff``/``min_coeff`` clamp the trust ratio (the
        reference's defaults)."""
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, params: List[torch.Tensor]) -> LambState:
        zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
        return LambState(
            step=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            exp_avg=zeros(), exp_avg_sq=zeros(),
        )

    def update(self, grads: List[torch.Tensor], state: LambState, params: List[torch.Tensor],
               lr=None):
        """Returns ``(updates, new_state)``; apply with ``p + u``."""
        lr = self.lr if lr is None else lr
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        if self.bias_correction:
            c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
            c2 = 1.0 - torch.pow(b2, step.to(torch.float32))
        else:
            c1 = c2 = 1.0
        updates, ms, vs = [], [], []
        for g, m, v, p in zip(grads, state.exp_avg, state.exp_avg_sq, params):
            g = g.float()
            p32 = p.float()
            m_new = b1 * m + (1.0 - b1) * g
            v_new = b2 * v + (1.0 - b2) * g * g
            update_dir = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps)
            if self.weight_decay > 0.0:
                update_dir = update_dir + self.weight_decay * p32
            w_norm = torch.linalg.vector_norm(p32)
            u_norm = torch.linalg.vector_norm(update_dir)
            trust = torch.where(
                (w_norm > 0) & (u_norm > 0),
                torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                torch.ones((), dtype=torch.float32, device=p.device),
            )
            updates.append(-lr * trust * update_dir)
            ms.append(m_new)
            vs.append(v_new)
        return updates, LambState(step=step, exp_avg=ms, exp_avg_sq=vs)
