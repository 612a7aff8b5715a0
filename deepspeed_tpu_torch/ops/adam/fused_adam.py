"""Adam / AdamW / SGD (counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``).

The optimizers work on lists of parameter tensors (the engine's
flattened leaves, in one fixed order).  ``init(params)`` builds the state;
``update(grads, state, params, lr=..., skip=...)`` is the plain,
functional step: it returns ``(updates, new_state)`` and the caller
applies ``p + u``.  The engine's Adam path with f32 state does not call
``update``: it runs the fused kernel in place through
:func:`deepspeed_tpu_torch.ops.kernels.fused_update.engine_update`.

``state_precision`` "bf16" and "8bit" keep the reduced state of the JAX
package (:class:`AdamState8`): m in bf16, v in bf16 (stochastically
rounded) or as uint8 codes of sqrt(v) over per-block absmax scales, about
3 B a parameter against 8.  Its update is plain torch ops on each leaf,
as the JAX package's is XLA ops outside any Pallas kernel (the fused
kernel serves f32 state only).  The stochastic rounding draws its bits
from a ``torch.Generator`` (``update(..., generator=)``), where the JAX
package uses its ``rng_bit_generator`` (ROADMAP C4): the two agree in
distribution, not bit for bit; without a generator both round to
nearest.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # 0-dim int32, on the parameters' device
    exp_avg: List[torch.Tensor]  # m, one f32 tensor per parameter
    exp_avg_sq: List[torch.Tensor]  # v, one f32 tensor per parameter


@dataclasses.dataclass
class AdamState8:
    """Reduced-precision Adam state (``state_precision`` "8bit" or "bf16",
    the JAX package's ``AdamState8``).  8bit: m in bf16, v as uint8 codes
    of sqrt(v) (param-shaped) with one f32 scale a block, or f32
    passthrough for leaves under 16,384 elements (scale: ``zeros(1)``).
    bf16: m and v in bf16, each scale ``zeros(1)``."""

    step: torch.Tensor
    exp_avg: List[torch.Tensor]  # m, bf16
    vq: List[torch.Tensor]  # v codes: uint8, or the f32 / bf16 passthrough
    vs: List[torch.Tensor]  # per-leaf block scales, f32 (n_blocks,) or (1,)


# the reduced state's in-place step works a leaf in chunks of about this
# many elements: 64 MiB a f32 temporary
REDUCED_CHUNK = 1 << 24


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """f32 sqrt rounded to nearest, as XLA's and CUDA's ``sqrtf``: torch's
    vectorized CPU sqrt may be one ulp off, so the CPU takes it in f64."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _bias_corrections(opt, step: torch.Tensor):
    """``(c1, c2)`` from the unconditional count ``step + 1`` (see
    :meth:`FusedAdam.update`)."""
    if not opt.bias_correction:
        return 1.0, 1.0
    bstep = (step + 1).to(torch.float32)
    return 1.0 - torch.pow(opt.b1, bstep), 1.0 - torch.pow(opt.b2, bstep)


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


@dataclasses.dataclass
class CutBlocks:
    """A rank's slice of a leaf cut across ranks, for the 8-bit state:
    ``index`` (:meth:`ZeroLayout.natural_index`) one int64 vector a
    dimension of the slice, summed to each element's flat index in the
    natural leaf of ``n`` elements; ``block`` the leaf's block;
    ``reduce_max(t)`` the elementwise max of a ``(n // block,)`` tensor
    over the ranks holding the leaf's other slices."""

    index: List[torch.Tensor]
    n: int
    block: int
    reduce_max: Callable[[torch.Tensor], torch.Tensor]

    @property
    def n_blocks(self) -> int:
        return self.n // self.block

    def rows(self, shape) -> int:
        """Rows of the slice's first dimension in a chunk of about
        :data:`REDUCED_CHUNK` elements (at least one)."""
        row = 1
        for s in shape[1:]:
            row *= s
        return max(1, REDUCED_CHUNK // max(row, 1))

    def ids(self, lo: int, hi: int) -> torch.Tensor:
        """The whole-leaf blocks of the slice's rows ``lo:hi``, in the
        slice's shape (a flat leaf's padding in block 0, where its zeros
        raise no absmax)."""
        flat = self.index[0][lo:hi]
        for t in self.index[1:]:
            flat = flat[..., None] + t
        return torch.where(flat < self.n, flat, 0) // self.block

    def scales(self, part: torch.Tensor) -> torch.Tensor:
        """The whole leaf's block scales from this slice's partial absmax
        of sqrt(v) (its blocks' max over every rank)."""
        return torch.clamp(self.reduce_max(part), min=1e-30) / 255.0


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
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.state_precision = state_precision
        self.state_block = state_block

    # -- reduced-precision state ------------------------------------------
    def _v_blocks(self, n: int) -> int:
        """A leaf's quantization block: the largest divisor of ``n`` that is
        at most ``state_block``; 0 (f32 passthrough) for leaves under
        16,384 elements or with no divisor of at least 16."""
        if n < 16384:
            return 0
        for b in range(min(self.state_block, n), 15, -1):
            if n % b == 0:
                return b
        return 0

    @staticmethod
    def _sr_bf16(x32: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """f32 -> bf16 with stochastic rounding: uniform bits below the bf16
        mantissa cut are added, then truncated (nearest rounding without a
        generator).  Non-finite values pass through."""
        if generator is None:
            return x32.to(torch.bfloat16)
        r = torch.randint(0, 1 << 16, x32.shape, generator=generator, dtype=torch.int32,
                          device=x32.device)
        sr = ((x32.view(torch.int32) + r) & -65536).view(torch.float32)
        return torch.where(torch.isfinite(x32), sr, x32).to(torch.bfloat16)

    def _v_encode(self, v32: torch.Tensor, generator: Optional[torch.Generator], skip=None,
                  block: Optional[int] = None, ids: Optional[torch.Tensor] = None,
                  scales: Optional[torch.Tensor] = None):
        """v (f32, >= 0) -> ``(codes, scales)``: uint8 codes of sqrt(v) over
        per-block absmax scales, stochastically rounded with a generator
        (nearest without one, and on a skipped step, so a burst of skips
        does not random-walk the codes); bf16 state: v stochastically
        rounded to bf16.  ``block``: the leaf's block (0: f32 passthrough)
        where ``v32`` is a block-aligned chunk of it; ``ids`` and
        ``scales``: where ``v32`` is a chunk of a rank's slice of a leaf cut
        across ranks, its elements' whole-leaf blocks and the whole leaf's
        new scales (:meth:`CutBlocks.scales`), returned as they are."""
        one = torch.zeros((1,), dtype=torch.float32, device=v32.device)
        if self.state_precision == "bf16":
            # idempotent on exact-bf16 inputs: the added bits mask away
            return self._sr_bf16(v32, generator), one
        if ids is not None:
            u = _sqrt_rn(v32)
            s = scales[ids]
        else:
            b = self._v_blocks(v32.numel()) if block is None else block
            if b == 0:
                return v32, one
            u = _sqrt_rn(v32).reshape(-1, b)
            s = torch.clamp(u.amax(dim=1, keepdim=True), min=1e-30) / 255.0
        q = u / s
        if generator is not None:
            noise = torch.rand(q.shape, generator=generator, dtype=torch.float32, device=q.device)
            if skip is not None:
                noise = torch.where(skip, torch.full((), 0.5, device=q.device), noise)
            q = torch.floor(q + noise)
        else:
            q = torch.round(q)
        codes = torch.clamp(q, 0, 255).to(torch.uint8).reshape(v32.shape)
        return codes, (scales if ids is not None else s[:, 0])

    @staticmethod
    def _block_absmax(v32: torch.Tensor, ids: torch.Tensor, part: torch.Tensor) -> None:
        """``part`` (a leaf's blocks) raised to the absmax of sqrt(v) over
        the elements of ``v32`` (a chunk of a rank's slice of the leaf) in
        each block ``ids`` names."""
        part.scatter_reduce_(0, ids.reshape(-1), _sqrt_rn(v32).reshape(-1), "amax")

    def _v_decode(self, vq: torch.Tensor, vs: torch.Tensor,
                  block: Optional[int] = None, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The inverse of :meth:`_v_encode`.  Codes are floored at half a
        step: a small nonzero v decoded as 0 would hand Adam an eps
        denominator; the floor bounds the update by ``lr * m / (absmax /
        510)`` and leaves codes >= 1 unbiased."""
        if vq.dtype != torch.uint8:  # f32 / bf16 passthrough
            return vq.float()
        codes = torch.clamp(vq.float(), min=0.5)
        if ids is not None:
            return torch.square(codes * vs[ids])
        b = self._v_blocks(vq.numel()) if block is None else block
        return torch.square(codes.reshape(-1, b) * vs[:, None]).reshape(vq.shape)

    def init(self, params: List[torch.Tensor], whole: Optional[List[int]] = None):
        """The state of ``params``; ``whole``: each leaf's element count
        where ``params`` holds a rank's slice of it (the 8-bit blocks are
        the whole leaf's: its block scales, whole, on every rank)."""
        step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
        if self.state_precision == "bf16":
            zb = lambda: [torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)  # noqa: E731
                          for p in params]
            return AdamState8(step=step, exp_avg=zb(), vq=zb(),
                              vs=[torch.zeros((1,), dtype=torch.float32, device=p.device)
                                  for p in params])
        if self.state_precision == "8bit":
            sizes = whole or [p.numel() for p in params]
            blocks = [self._v_blocks(n) for n in sizes]
            return AdamState8(
                step=step,
                exp_avg=[torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                         for p in params],
                vq=[torch.zeros(p.shape, dtype=torch.uint8 if b else torch.float32,
                                device=p.device) for p, b in zip(params, blocks)],
                vs=[torch.zeros((n // b,) if b else (1,), dtype=torch.float32,
                                device=p.device) for p, n, b in zip(params, sizes, blocks)])
        zeros = lambda: [torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                         for p in params]
        return AdamState(step=step, exp_avg=zeros(), exp_avg_sq=zeros())

    def state_bytes(self, state) -> int:
        """The optimizer state's bytes on its devices (the step counter
        aside)."""
        if isinstance(state, AdamState8):
            leaves = state.exp_avg + state.vq + state.vs
        else:
            leaves = state.exp_avg + state.exp_avg_sq
        return sum(t.numel() * t.element_size() for t in leaves)

    def update(self, grads: List[torch.Tensor], state, params: List[torch.Tensor],
               lr=None, skip: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Returns ``(updates, new_state)``; apply with ``p + u``.
        ``skip``: optional 0-dim bool tensor (overflow); when set the state
        keeps its old values and the updates are zero.  ``generator``: the
        reduced state's stochastic-rounding bits (on the parameters'
        device); None rounds to nearest."""
        if isinstance(state, AdamState8):
            return self._update_8bit(grads, state, params, lr, generator, skip)
        lr = self.lr if lr is None else lr
        dev = state.step.device
        keep = (torch.ones((), dtype=torch.float32, device=dev) if skip is None
                else 1.0 - skip.to(torch.float32))
        step = state.step + (1 if skip is None else (~skip).to(state.step.dtype))
        # bias corrections use the unconditional count: on a skipped step
        # the stored count stays put and c2 = 1 - b2^0 = 0 would divide by
        # zero (the update is zeroed there anyway)
        c1, c2 = _bias_corrections(self, state.step)
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

    def _reduced_scalars(self, state: AdamState8, lr, skip):
        lr = self.lr if lr is None else lr
        keep = None if skip is None else 1.0 - skip.to(torch.float32)
        c1, c2 = _bias_corrections(self, state.step)
        return lr, keep, c1, c2

    def _reduced_moments(self, g, m, vq, vs, p, keep, skip, block=None, ids=None):
        """One leaf's (or chunk's) Adam moments over the reduced state:
        ``(p f32, m_new, v_new)`` in f32.  ``skip`` folds the overflow skip
        in: m and v keep their decoded values."""
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        g32 = g.float()
        if keep is not None:
            g32 = torch.where(skip, torch.zeros((), dtype=torch.float32, device=g32.device),
                              g32)  # 0 * inf would poison the fold
        p32 = p.float()
        if not self.adam_w_mode and wd > 0.0:
            g32 = g32 + wd * p32
        m32 = m.float()
        v32 = self._v_decode(vq, vs, block, ids)
        if keep is None:
            m_new = b1 * m32 + (1.0 - b1) * g32
            v_new = b2 * v32 + (1.0 - b2) * g32 * g32
        else:
            m_new = m32 + keep * ((b1 - 1.0) * m32 + (1.0 - b1) * g32)
            v_new = v32 + keep * ((b2 - 1.0) * v32 + (1.0 - b2) * g32 * g32)
        return p32, m_new, v_new

    def _reduced_leaf(self, g, m, vq, vs, p, lr, keep, skip, c1, c2, generator, block=None,
                      ids=None, scales=None):
        """One leaf's (or one chunk's) step over the reduced state: f32
        Adam on the decoded values, ``(update, m bf16, v codes, v
        scales)``.  On a skipped step the update is zero, m keeps its bits
        and v re-encodes its decoded self at nearest rounding.  ``ids`` and
        ``scales``: a chunk of a cut leaf's slice (:meth:`_v_encode`)."""
        wd = self.weight_decay
        p32, m_new, v_new = self._reduced_moments(g, m, vq, vs, p, keep, skip, block, ids)
        upd = -(lr * (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps))
        if self.adam_w_mode and wd > 0.0:
            upd = upd - lr * wd * p32
        if keep is not None:
            upd = keep * upd
        nvq, nvs = self._v_encode(v_new, generator, skip, block, ids, scales)
        return upd, m_new.to(torch.bfloat16), nvq, nvs

    def _update_8bit(self, grads, state: AdamState8, params, lr, generator, skip=None):
        """The functional step over the reduced state (the JAX package's
        ``_update_8bit``); each leaf draws its rounding bits from
        ``generator`` in turn."""
        lr, keep, c1, c2 = self._reduced_scalars(state, lr, skip)
        step = state.step + (1 if skip is None else (~skip).to(state.step.dtype))
        upds, ms, vqs, vss = [], [], [], []
        for g, m, vq, vs, p in zip(grads, state.exp_avg, state.vq, state.vs, params):
            upd, m_new, nvq, nvs = self._reduced_leaf(g, m, vq, vs, p, lr, keep, skip, c1, c2,
                                                      generator)
            upds.append(upd)
            ms.append(m_new)
            vqs.append(nvq)
            vss.append(nvs)
        return upds, AdamState8(step=step, exp_avg=ms, vq=vqs, vs=vss)

    @torch.no_grad()
    def step_reduced_(self, grads, state: AdamState8, params, lr=None,
                      skip: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      cuts: Optional[List[Optional["CutBlocks"]]] = None) -> None:
        """The engine's step over the reduced state, in place: ``p + u``
        written into each parameter and the new state into the state's
        tensors, leaf by leaf in block-aligned chunks of about
        :data:`REDUCED_CHUNK` elements, so the f32 temporaries stay a
        chunk's size (a stacked GPT-2 774M leaf holds 236M elements).  The
        values are :meth:`update`'s (with a generator the rounding bits are
        drawn chunk by chunk).  ``cuts[i]``: where leaf ``i`` is a rank's
        slice of a leaf cut across ranks with 8-bit blocks, its
        :class:`CutBlocks`: the slice steps in chunks of its first
        dimension's rows twice, first for its blocks' absmax (reduced over
        the ranks into the whole leaf's scales), then for the update."""
        chunk = REDUCED_CHUNK
        lr, keep, c1, c2 = self._reduced_scalars(state, lr, skip)
        for i, (g, m, vq, vs, p) in enumerate(zip(grads, state.exp_avg, state.vq, state.vs,
                                                  params)):
            cut = None if cuts is None else cuts[i]
            if cut is not None:
                self._step_cut_(cut, g, m, vq, vs, p, lr, keep, skip, c1, c2, generator)
                continue
            n = p.numel()
            b = self._v_blocks(n) if vq.dtype == torch.uint8 else 0
            step = max(b, chunk // b * b) if b else chunk
            pf, gf, mf, qf = p.view(-1), g.reshape(-1), m.view(-1), vq.view(-1)
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                vs_c = vs[lo // b:hi // b] if b else vs
                upd, m_new, nvq, nvs = self._reduced_leaf(
                    gf[lo:hi], mf[lo:hi], qf[lo:hi], vs_c, pf[lo:hi], lr, keep, skip, c1, c2,
                    generator, block=b)
                pf[lo:hi].copy_((pf[lo:hi].float() + upd).to(p.dtype))
                mf[lo:hi].copy_(m_new)
                qf[lo:hi].copy_(nvq)
                if b:
                    vs_c.copy_(nvs)
        state.step += 1 if skip is None else (~skip).to(state.step.dtype)

    def _step_cut_(self, cut: CutBlocks, g, m, vq, vs, p, lr, keep, skip, c1, c2,
                   generator) -> None:
        """:meth:`step_reduced_` on a rank's slice of a cut leaf: the new
        v's absmax a block over the slice's chunks, the whole leaf's scales
        from every rank's, then each chunk's update and codes.  The old
        scales decode both passes; they are replaced at the end."""
        rows, step = p.shape[0], cut.rows(p.shape)
        part = torch.zeros(cut.n_blocks, dtype=torch.float32, device=p.device)
        for lo in range(0, rows, step):
            hi = min(rows, lo + step)
            ids = cut.ids(lo, hi).to(p.device)
            _, _, v_new = self._reduced_moments(g[lo:hi], m[lo:hi], vq[lo:hi], vs, p[lo:hi],
                                                keep, skip, ids=ids)
            self._block_absmax(v_new, ids, part)
        scales = cut.scales(part)
        for lo in range(0, rows, step):
            hi = min(rows, lo + step)
            upd, m_new, nvq, _ = self._reduced_leaf(
                g[lo:hi], m[lo:hi], vq[lo:hi], vs, p[lo:hi], lr, keep, skip, c1, c2, generator,
                ids=cut.ids(lo, hi).to(p.device), scales=scales)
            p[lo:hi].copy_((p[lo:hi].float() + upd).to(p.dtype))
            m[lo:hi].copy_(m_new)
            vq[lo:hi].copy_(nvq)
        vs.copy_(scales)


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
