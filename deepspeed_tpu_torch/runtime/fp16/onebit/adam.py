"""1-bit Adam (counterpart of ``deepspeed_tpu/runtime/fp16/onebit/adam.py``;
the reference's ``OnebitAdam``, arXiv:2102.02888).

Adam with a warmup of exact updates (:meth:`OnebitAdam.update`, the
engine's dense gradient exchange); after ``freeze_step`` the variance is
frozen and only the momentum crosses the wire, 1-bit compressed with error
feedback (:meth:`OnebitAdam.frozen_apply` over ``comm/compressed.py``).

The frozen state keeps the synced momentum in its exchange form, int8
signs and per-chunk scales; the warm momentum's representation error,
scaled by ``b1``, is folded into the worker residual at the switch
(:meth:`OnebitAdam.make_frozen_state`), so the first frozen exchange sees
the reference's value.  Each rank keeps its own ``worker_error`` row and
``server_error`` chunk.  ``frozen_apply`` and ``frozen_apply_vsharded``
take this rank's gradient row and a process group, or, with ``group=None``,
every rank's rows stacked ``(n, Mp)`` in one process (the plain version).

The flat packing (:func:`pack_flat`, :func:`pack_rows`,
:func:`unpack_flat`) concatenates leaves in the engine's order, ravelled,
zero-padded to a multiple: the offload engine's master slices use it too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from deepspeed_tpu_torch.comm import compressed


def pack_flat(leaves: Sequence[torch.Tensor], multiple: int) -> torch.Tensor:
    """The leaves ravelled as f32 and concatenated, zero-padded to a
    length that is a multiple of ``multiple``."""
    flat = torch.cat([torch.as_tensor(x).reshape(-1).to(torch.float32) for x in leaves])
    pad = (-flat.shape[0]) % multiple
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def pack_rows(leaves: Sequence[torch.Tensor], n: int, multiple: int) -> torch.Tensor:
    """Leaves shaped ``(n, *shape)`` as one ``(n, Mp)`` f32 matrix (padded)."""
    flat = torch.cat([torch.as_tensor(x).reshape(n, -1).to(torch.float32) for x in leaves], dim=1)
    pad = (-flat.shape[1]) % multiple
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def unpack_flat(flat: torch.Tensor, templates: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The inverse of :func:`pack_flat`: a slice of ``flat`` for each
    template, in its shape and dtype."""
    out, off = [], 0
    for t in templates:
        n = t.numel()
        out.append(flat[off:off + n].reshape(t.shape).to(t.dtype))
        off += n
    return out


def _zeros(params):
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def _exchange(m_rows, werr, serr, group):
    if group is None:
        return compressed.compressed_allreduce_rows_compressed_out(m_rows, werr, serr)
    return compressed.compressed_allreduce_compressed_out(m_rows, werr, serr, group,
                                                          kind="grad-exchange")


@dataclasses.dataclass
class OnebitAdamState:
    step: torch.Tensor  # 0-dim int32
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]  # frozen after freeze_step
    worker_error: List[torch.Tensor]


@dataclasses.dataclass
class FrozenOnebitAdamState:
    """The compressed phase's state: the synced momentum as int8 signs and
    per-chunk scales, the frozen variance flat (padded to a multiple of
    the exchange's ranks), this rank's residuals (``(Mp,)`` and ``(Mp //
    n,)``; ``(n, Mp)`` and ``(n, Mp // n)`` for stacked rows)."""

    step: torch.Tensor
    m_signs: torch.Tensor
    m_scales: torch.Tensor
    v_flat: torch.Tensor
    worker_error: torch.Tensor
    server_error: torch.Tensor


class OnebitAdam:
    name = "onebitadam"

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_step: int = 100000, cuda_aware: bool = False,
                 comm_backend_name: str = "nccl", fsdp_size: int = 1, **_compat):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.freeze_step = int(freeze_step)

    def init(self, params: List[torch.Tensor]) -> OnebitAdamState:
        dev = params[0].device if params else torch.device("cpu")
        return OnebitAdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                               exp_avg=_zeros(params), exp_avg_sq=_zeros(params),
                               worker_error=_zeros(params))

    def update(self, grads, state: OnebitAdamState, params, lr=None):
        """The warm (and single-program) step: returns ``(updates,
        state)``.  Past ``freeze_step`` the momentum is quantized locally to
        ``sign * mean|.|`` with its residual carried (the engine's frozen
        path replaces this with the exchange)."""
        lr = self.lr if lr is None else lr
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        frozen = step > self.freeze_step
        t_eff = torch.clamp(step, max=self.freeze_step).to(torch.float32)
        c2 = 1.0 - b2 ** t_eff
        updates, ms, vs, werrs = [], [], [], []
        for g, m, v, werr, p in zip(grads, state.exp_avg, state.exp_avg_sq, state.worker_error,
                                    params):
            g = g.float()
            m_new = b1 * m + (1.0 - b1) * g
            v_new = torch.where(frozen, v, b2 * v + (1.0 - b2) * g * g)
            corrected = m_new + werr
            scale = torch.mean(torch.abs(corrected))
            m_comp = torch.where(corrected >= 0, scale, -scale)
            werr_new = corrected - m_comp
            # a coordinate that never saw a gradient has no variance: its
            # +-scale must not become a scale/eps step
            m_eff = torch.where(frozen, m_comp * (v_new > 0), m_new)
            werr_out = torch.where(frozen, werr_new, werr)
            denom = torch.sqrt(v_new / c2) + self.eps
            upd = -lr * m_eff / denom
            if self.weight_decay > 0.0:
                upd = upd - lr * self.weight_decay * p.float()
            updates.append(upd)
            ms.append(m_new)
            vs.append(v_new)
            werrs.append(werr_out)
        return updates, OnebitAdamState(step=step, exp_avg=ms, exp_avg_sq=vs, worker_error=werrs)

    def _frozen_parts(self, state, n_ranks: int, rows: bool):
        m_flat = pack_flat(state.exp_avg, n_ranks)
        v_flat = pack_flat(state.exp_avg_sq, n_ranks)
        m_signs, m_scales = compressed.compress_chunks(m_flat, n_ranks)
        delta = self.b1 * (m_flat - compressed.decompress_chunks(m_signs, m_scales))
        mp = m_flat.shape[0]
        werr = delta[None].expand(n_ranks, mp).clone() if rows else delta
        serr = torch.zeros((n_ranks, mp // n_ranks) if rows else (mp // n_ranks,),
                           dtype=torch.float32, device=m_flat.device)
        return m_signs, m_scales, v_flat, werr, serr

    def make_frozen_state(self, state: OnebitAdamState, n_ranks: int,
                          rows: bool = False) -> FrozenOnebitAdamState:
        """The warm state (whole leaves) in the compressed phase's layout,
        for ``n_ranks`` exchange ranks; this rank's residuals (every rank's
        start the same), or with ``rows`` every rank's stacked."""
        m_signs, m_scales, v_flat, werr, serr = self._frozen_parts(state, n_ranks, rows)
        return FrozenOnebitAdamState(step=state.step.clone(), m_signs=m_signs, m_scales=m_scales,
                                     v_flat=v_flat, worker_error=werr, server_error=serr)

    def _c2(self):
        return 1.0 - self.b2 ** float(self.freeze_step)

    def frozen_apply(self, g, fstate: FrozenOnebitAdamState, p_flat: torch.Tensor, lr,
                     group=None):
        """One compressed-momentum step: the local gradient ``g`` (this
        rank's ``(Mp,)`` row, or every rank's ``(n, Mp)`` with ``group``
        None) folds into the synced momentum, the momenta are exchanged 1-bit
        with error feedback, and the update uses the frozen variance.
        Returns ``(update (Mp,), new state)``."""
        m_flat = compressed.decompress_chunks(fstate.m_signs, fstate.m_scales)
        m_rows = self.b1 * (m_flat[None] if group is None else m_flat) + (1.0 - self.b1) * g
        m_signs, m_scales, werr, serr = _exchange(m_rows, fstate.worker_error,
                                                  fstate.server_error, group)
        m_synced = compressed.decompress_chunks(m_signs, m_scales)
        denom = torch.sqrt(fstate.v_flat / self._c2()) + self.eps
        upd = -lr * (m_synced * (fstate.v_flat > 0)) / denom
        if self.weight_decay > 0.0:
            upd = upd - lr * self.weight_decay * p_flat
        return upd, FrozenOnebitAdamState(step=fstate.step + 1, m_signs=m_signs,
                                          m_scales=m_scales, v_flat=fstate.v_flat,
                                          worker_error=werr, server_error=serr)

    def frozen_apply_vsharded(self, g, m_signs, m_scales, v_chunk, p_chunk, werr, serr, lr,
                              group=None):
        """The other frozen layout: the variance and the masters cut 1/n
        over the exchange's ranks (``v_chunk``, ``p_chunk``: this rank's
        ``(Mp // n,)``, or ``(n, Mp // n)`` with ``group`` None), each rank
        updating its chunk, then the updated masters all-gathered for the
        next forward.  The next momentum fold needs the whole synced
        momentum on every rank, so the exchange's last all-gather stays:
        this layout adds a 4 B a parameter f32 all-gather to the ~2 B of the
        1-bit exchange (three times the wire) to save 8 B a parameter of
        memory a rank; the engine keeps the replicated layout.  Returns
        ``(p_full (Mp,), p_chunk, m_signs, m_scales, werr, serr)``."""
        from deepspeed_tpu_torch.comm import collectives

        m_flat = compressed.decompress_chunks(m_signs, m_scales)
        m_rows = self.b1 * (m_flat[None] if group is None else m_flat) + (1.0 - self.b1) * g
        new_signs, new_scales, werr, serr = _exchange(m_rows, werr, serr, group)
        n = m_scales.shape[0]
        m_chunks = new_signs.reshape(n, -1).float() * new_scales[:, None]
        if group is not None:
            m_chunks = m_chunks[collectives.dist.get_rank(group)]
        denom = torch.sqrt(v_chunk / self._c2()) + self.eps
        upd = -lr * (m_chunks * (v_chunk > 0)) / denom
        if self.weight_decay > 0.0:
            upd = upd - lr * self.weight_decay * p_chunk
        p_chunk = p_chunk + upd
        p_full = (p_chunk.reshape(-1) if group is None
                  else collectives.all_gather(p_chunk, group, kind="vsharded-param-all-gather"))
        return p_full, p_chunk, new_signs, new_scales, werr, serr
