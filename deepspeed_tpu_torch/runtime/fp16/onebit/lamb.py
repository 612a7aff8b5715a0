"""1-bit LAMB (counterpart of ``deepspeed_tpu/runtime/fp16/onebit/lamb.py``;
the reference's ``OnebitLamb``, arXiv:2104.06069).

LAMB with a warmup, then frozen variance and the 1-bit momentum exchange
of ``onebit/adam.py``.  The warmup keeps an EMA of every leaf's trust
ratio (``scaling_coeff``); the compressed phase scales each coordinate's
update by its leaf's frozen ratio (``coeff_flat``), so it sends no norms.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from deepspeed_tpu_torch.comm import compressed
from deepspeed_tpu_torch.runtime.fp16.onebit.adam import OnebitAdam, _exchange, _zeros


@dataclasses.dataclass
class OnebitLambState:
    step: torch.Tensor
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]
    worker_error: List[torch.Tensor]
    scaling_coeff: List[torch.Tensor]  # a 0-dim f32 trust ratio per leaf


@dataclasses.dataclass
class FrozenOnebitLambState:
    """:class:`~deepspeed_tpu_torch.runtime.fp16.onebit.adam.FrozenOnebitAdamState`
    and ``coeff_flat``: the frozen trust ratios, one a coordinate (1 on the
    padding, which ``v_flat > 0`` masks)."""

    step: torch.Tensor
    m_signs: torch.Tensor
    m_scales: torch.Tensor
    v_flat: torch.Tensor
    coeff_flat: torch.Tensor
    worker_error: torch.Tensor
    server_error: torch.Tensor


class OnebitLamb(OnebitAdam):
    name = "onebitlamb"

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100000, max_coeff: float = 10.0,
                 min_coeff: float = 0.01, coeff_beta: float = 0.9, **_compat):
        super().__init__(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                         freeze_step=freeze_step)
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.coeff_beta = coeff_beta

    def init(self, params: List[torch.Tensor]) -> OnebitLambState:
        dev = params[0].device if params else torch.device("cpu")
        return OnebitLambState(
            step=torch.zeros((), dtype=torch.int32, device=dev), exp_avg=_zeros(params),
            exp_avg_sq=_zeros(params), worker_error=_zeros(params),
            scaling_coeff=[torch.ones((), dtype=torch.float32, device=p.device) for p in params])

    def update(self, grads, state: OnebitLambState, params, lr=None, reduce_norms=None):
        """The warm step (:meth:`OnebitAdam.update`'s rule) with each leaf's
        trust ratio.  ``reduce_norms(i, sums)``: where ZeRO or a ``model``
        axis cuts leaf ``i``, its ``(sum p^2, sum dir^2)`` summed across
        the ranks holding its other slices (the norms of the whole leaf)."""
        lr = self.lr if lr is None else lr
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        frozen = step > self.freeze_step
        t_eff = torch.clamp(step, max=self.freeze_step).to(torch.float32)
        c2 = 1.0 - b2 ** t_eff
        out = ([], [], [], [], [])
        for i, (g, m, v, werr, coeff, p) in enumerate(zip(
                grads, state.exp_avg, state.exp_avg_sq, state.worker_error, state.scaling_coeff,
                params)):
            g = g.float()
            p32 = p.float()
            m_new = b1 * m + (1.0 - b1) * g
            v_new = torch.where(frozen, v, b2 * v + (1.0 - b2) * g * g)
            corrected = m_new + werr
            scale = torch.mean(torch.abs(corrected))
            m_comp = torch.where(corrected >= 0, scale, -scale)
            m_eff = torch.where(frozen, m_comp, m_new)
            werr_out = torch.where(frozen, corrected - m_comp, werr)
            update_dir = m_eff / (torch.sqrt(v_new / c2) + self.eps)
            if self.weight_decay > 0.0:
                update_dir = update_dir + self.weight_decay * p32
            if reduce_norms is None:
                w_norm = torch.linalg.vector_norm(p32.reshape(-1))
                u_norm = torch.linalg.vector_norm(update_dir.reshape(-1))
            else:
                sums = reduce_norms(i, torch.stack([torch.sum(p32 * p32),
                                                    torch.sum(update_dir * update_dir)]))
                w_norm, u_norm = torch.sqrt(sums[0]), torch.sqrt(sums[1])
            fresh = torch.where((w_norm > 0) & (u_norm > 0),
                                torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                                torch.ones((), dtype=torch.float32, device=p32.device))
            coeff_new = torch.where(frozen, coeff,
                                    self.coeff_beta * coeff + (1 - self.coeff_beta) * fresh)
            trust = torch.where(frozen, coeff, fresh)
            for lst, val in zip(out, (-lr * trust * update_dir, m_new, v_new, werr_out,
                                      coeff_new)):
                lst.append(val)
        updates, ms, vs, werrs, coeffs = out
        return updates, OnebitLambState(step=step, exp_avg=ms, exp_avg_sq=vs, worker_error=werrs,
                                        scaling_coeff=coeffs)

    def make_frozen_state(self, state: OnebitLambState, n_ranks: int,
                          rows: bool = False) -> FrozenOnebitLambState:
        m_signs, m_scales, v_flat, werr, serr = self._frozen_parts(state, n_ranks, rows)
        parts = [c.float().reshape(1).expand(max(1, m.numel()))
                 for c, m in zip(state.scaling_coeff, state.exp_avg)]
        coeff_flat = torch.cat(parts)
        coeff_flat = torch.nn.functional.pad(coeff_flat, (0, v_flat.shape[0] - coeff_flat.shape[0]),
                                             value=1.0)
        return FrozenOnebitLambState(step=state.step.clone(), m_signs=m_signs, m_scales=m_scales,
                                     v_flat=v_flat, coeff_flat=coeff_flat, worker_error=werr,
                                     server_error=serr)

    def frozen_apply(self, g, fstate: FrozenOnebitLambState, p_flat, lr, group=None):
        m_flat = compressed.decompress_chunks(fstate.m_signs, fstate.m_scales)
        m_rows = self.b1 * (m_flat[None] if group is None else m_flat) + (1.0 - self.b1) * g
        m_signs, m_scales, werr, serr = _exchange(m_rows, fstate.worker_error,
                                                  fstate.server_error, group)
        m_synced = compressed.decompress_chunks(m_signs, m_scales)
        denom = torch.sqrt(fstate.v_flat / self._c2()) + self.eps
        update_dir = (m_synced * (fstate.v_flat > 0)) / denom
        if self.weight_decay > 0.0:
            update_dir = update_dir + self.weight_decay * p_flat
        upd = -lr * fstate.coeff_flat * update_dir
        return upd, FrozenOnebitLambState(
            step=fstate.step + 1, m_signs=m_signs, m_scales=m_scales, v_flat=fstate.v_flat,
            coeff_flat=fstate.coeff_flat, worker_error=werr, server_error=serr)

    # the variance-sharded frozen layout is 1-bit Adam's alone, as in the
    # JAX package
    frozen_apply_vsharded = None
