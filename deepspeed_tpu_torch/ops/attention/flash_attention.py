"""Flash attention, forward and backward (counterpart of
``deepspeed_tpu/ops/attention/flash_attention.py``).

Layout convention: ``(batch, heads, seq, head_dim)``.

:func:`flash_fwd` launches the forward CUDA kernel (``csrc/flash_fwd.cu``,
B1), :func:`flash_bwd` the single-pass backward (``csrc/flash_bwd.cu``, B2)
and :func:`flash_bwd2` the two-pass backward (``csrc/flash_bwd_2pass.cu``,
B6a then B6b) for CUDA tensors; CPU tensors take
:func:`flash_fwd_reference`, :func:`flash_bwd_reference` and
:func:`flash_bwd2_reference`, the plain PyTorch versions of the same
arithmetic.  :class:`_FlashAttention` ties them together as the autograd
function (the JAX package's ``custom_vjp``).  :func:`flash_attention`
keeps the JAX package's dispatch: dense below 128x128 scores, the plain
reference below 8 rows, the kernels otherwise; the dense and reference
branches differentiate through autograd.  The backward takes B6 where a
bias meets a sequence whose f32 dq passes ``_FUSED_BWD_MAX_SQ_BYTES`` a
batch*head, as the JAX package's does, and B2 otherwise.

An additive score bias is added in f32 after ``sm_scale``, before the
causal mask, as in the JAX package.  The kernels take it in two forms: the
key-row form (B, 1, 1, Tk) (a key-padding mask, BERT's) as an f32 (B, Tk)
``kbias``, and any other bias broadcastable to (B, H, Tq, Tk) as the full
form ``fbias``, read in place through its broadcast strides (the JAX
package materializes it as (B*H, Tq, Tk); the numbers are the same).

Attention-probability dropout (softmax, then dropout on the value path) is
keyed by a pair of uint32 words: the kernels regenerate the keep-bits from
a counter-based Threefry-2x32 of each score's absolute position, and
:func:`dropout_keep_mask_host` gives the same bits on the host side, bit
for bit the JAX package's, for the dense and reference branches and for
the plain versions.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Attention dropout: counter-based Threefry-2x32 keep-bits
#
# 20-round Threefry-2x32 (the Random123 / jax.random schedule) on the
# counter (row * Tk + col, b * H + h) under a key of two uint32 words: a
# pure function of the score's absolute position, so every kernel and
# every tiling regenerates the same bits and no keep-mask is stored.  The
# host twin computes in int64 holding uint32 values, masked after every
# add and shift: torch's uint32 has no add kernel on the CPU.
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
# int64 elements a host-mask chunk computes at once (128 MiB a temporary)
_HOST_MASK_CHUNK = 1 << 24


def _rotl32(x, r: int):
    return ((x << r) & _MASK32) | (x >> (32 - r))


def _threefry2x32_bits(k0: int, k1: int, x0, x1):
    """First output word of 20-round Threefry-2x32 on counter (x0, x1)
    under key (k0, k1): int64 tensors (or ints) holding uint32 values,
    broadcast against each other."""
    ks = (k0, k1, 0x1BD11BDA ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i, rots in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for r in rots:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0


def _drop_threshold(keep_prob: float) -> int:
    """keep iff bits < threshold (uint32 compare): P(keep) = keep_prob."""
    return min(int(keep_prob * 4294967296.0), 4294967295)


def _check_dropout_counter_bound(sq: int, sk: int) -> None:
    """The counter packs ``row * sk + col`` into one uint32 word; past
    2**32 score positions the stream would repeat, so refuse."""
    if sq * sk >= 2**32:
        raise ValueError(
            f"attention dropout PRNG counter would wrap: sq*sk = {sq}*{sk} "
            ">= 2**32; use sparse or ring attention for scores this large"
        )


def _seed_pair(rng) -> Tuple[int, int]:
    """``(k0, k1)``, two uint32 key words, from a ``torch.Generator`` (two
    words drawn on the generator's device: the engine's is a CPU one, so
    no device sync) or from an explicit pair: two ints, a tensor or an
    array whose first two words are the key (the JAX package's raw uint32
    key data)."""
    if isinstance(rng, torch.Generator):
        words = torch.randint(0, 2**32, (2,), generator=rng, dtype=torch.int64,
                              device=rng.device).tolist()
    elif isinstance(rng, torch.Tensor):
        words = rng.reshape(-1)[:2].tolist()
    else:
        words = [int(w) for w in np.asarray(rng).reshape(-1)[:2]]
    if len(words) != 2:
        raise ValueError(f"a dropout key is two uint32 words, got {rng!r}")
    return int(words[0]) & _MASK32, int(words[1]) & _MASK32


class Dropout(NamedTuple):
    """Attention dropout as the kernels take it: the key words and the
    keep probability."""
    k0: int
    k1: int
    keep_prob: float

    @property
    def threshold(self) -> int:
        return _drop_threshold(self.keep_prob)

    @property
    def inv_keep(self) -> float:
        """1 / keep_prob in f32, the factor of a kept score."""
        return float(np.float32(1.0) / np.float32(self.keep_prob))


def make_dropout(rate: float, rng) -> Optional[Dropout]:
    """The kernels' dropout for ``rate`` keyed by ``rng`` (see
    :func:`_seed_pair`); None at rate 0."""
    if rate <= 0.0:
        return None
    if rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    if rate >= 1.0:
        raise ValueError(f"dropout_rate must be below 1, got {rate}")
    return Dropout(*_seed_pair(rng), 1.0 - float(rate))


def dropout_keep_mask_host(seed_pair, b: int, h: int, sq: int, sk: int, keep_prob: float,
                           device=None) -> torch.Tensor:
    """The full (b*h, sq, sk) uint8 keep-mask the kernels generate, on
    ``device``: bit for bit the JAX package's ``dropout_keep_mask_host``.
    ``seed_pair``: anything :func:`_seed_pair` takes.  Computed in chunks
    of at most ``_HOST_MASK_CHUNK`` scores."""
    _check_dropout_counter_bound(sq, sk)
    k0, k1 = _seed_pair(seed_pair)
    thr = _drop_threshold(keep_prob)
    rows = torch.arange(sq, dtype=torch.int64, device=device)[:, None]
    x0 = rows * sk + torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    out = torch.empty((b * h, sq, sk), dtype=torch.uint8, device=device)
    per_bh = sq * sk
    if per_bh <= _HOST_MASK_CHUNK:
        nb = _HOST_MASK_CHUNK // per_bh
        for b0 in range(0, b * h, nb):
            bhs = torch.arange(b0, min(b0 + nb, b * h), dtype=torch.int64, device=device)
            out[b0:b0 + nb] = _threefry2x32_bits(k0, k1, x0[None], bhs[:, None, None]) < thr
    else:
        step = max(1, _HOST_MASK_CHUNK // sk)
        for bh in range(b * h):
            x1 = torch.full((1, 1), bh, dtype=torch.int64, device=device)
            for r0 in range(0, sq, step):
                out[bh, r0:r0 + step] = _threefry2x32_bits(k0, k1, x0[r0:r0 + step], x1) < thr
    return out


def keep_mask(drop: Optional[Dropout], q, k) -> Optional[torch.Tensor]:
    """The (B, H, Tq, Tk) uint8 keep-mask of ``drop`` for attention over
    ``q``, ``k`` (the bits the kernels generate); None without dropout."""
    if drop is None:
        return None
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    mask = dropout_keep_mask_host((drop.k0, drop.k1), b, h, sq, sk, drop.keep_prob, q.device)
    return mask.reshape(b, h, sq, sk)


def _keep_factor(drop: Optional[Dropout], q, k) -> Optional[torch.Tensor]:
    """f32 (B, H, Tq, Tk): 1 / keep_prob on a kept score, 0 on a dropped one
    (``keep / keep_prob`` in f32, as the kernels compute it); None without
    dropout."""
    mask = keep_mask(drop, q, k)
    return None if mask is None else mask.float() / drop.keep_prob


def mha_reference(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                  bias=None, dropout_mask=None, keep_prob: float = 1.0) -> torch.Tensor:
    """Plain attention in f32; the numerics ground truth.  ``dropout_mask``:
    a (B, H, Tq, Tk) {0, 1} keep-mask applied to the softmax output
    (softmax, then dropout)."""
    p = torch.softmax(_scores(q, k, causal, sm_scale, bias), dim=-1)
    if dropout_mask is not None:
        p = p * (dropout_mask.float() / keep_prob)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# Below 128x128 scores the materializing path is the JAX package's
# choice (measured there on the TPU); the port keeps the same dispatch so
# that parity covers the same branches.
SMALL_SEQ_DENSE_SCORES = 128 * 128

# The JAX package's bound on the fused backward's resident f32 dq (sq * d
# * 4 bytes a batch*head): past it, a biased attention takes the two-pass
# backward there, and here too (B6; read at call time)
_FUSED_BWD_MAX_SQ_BYTES = 1 << 21


def mha_dense(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
              bias=None, dropout_mask=None, keep_prob: float = 1.0) -> torch.Tensor:
    """Materializing attention with input-dtype dot operands, f32
    accumulation and f32 softmax; p (after dropout) is rounded to the input
    type before the value dot (f32 inputs stay f32 end to end)."""
    p = torch.softmax(_scores(q, k, causal, sm_scale, bias), dim=-1)
    if dropout_mask is not None:
        p = p * (dropout_mask.float() / keep_prob)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float()).to(q.dtype)


def _kbias4(kbias):
    """The kernels' (B, Tk) key-row bias as a (B, 1, 1, Tk) score bias."""
    return None if kbias is None else kbias[:, None, None, :]


def _score_bias(kbias, fbias):
    """The kernels' bias as a score bias broadcastable to (B, H, Tq, Tk):
    the key-row form through :func:`_kbias4`, the full form as it is."""
    return _kbias4(kbias) if kbias is not None else fbias


def flash_fwd_reference(q, k, v, causal: bool, sm_scale: float, kbias=None, fbias=None,
                        drop: Optional[Dropout] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel's arithmetic: f32
    scores from the operands' values plus the f32 bias (key-row ``kbias``
    (B, Tk) or full ``fbias``) if given, f32 (m, l) over the full p,
    unnormalized p times the dropout factor (``drop``) rounded to v's type
    before the value dot, a row with l = 0 divided by 1.  Returns ``(out,
    lse)`` with lse (B, H, Tq) f32."""
    s = _scores(q, k, causal, sm_scale, _score_bias(kbias, fbias))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep_factor(drop, q, k)
    pv = p if keep is None else p * keep
    acc = torch.einsum("bhqk,bhkd->bhqd", pv.to(v.dtype).float(), v.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("inf")), m + torch.log(l.clamp_min(1e-37)))
    return out, lse[..., 0]


def _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop):
    """The backward kernels' score tile, whole: ``(pd, ds)``, f32, with
    ``pd = p * keep`` rounded to dO's type (dV's probability) and ``ds = p
    (dp * keep - delta) scale`` rounded to q's type (no bias term: the bias
    enters after the scale)."""
    p = torch.exp(_scores(q, k, causal, sm_scale, _score_bias(kbias, fbias)) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    keep = _keep_factor(drop, q, k)
    pd = p
    if keep is not None:
        pd = p * keep
        dp = dp * keep
        del keep
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype).float()
    return pd.to(do.dtype).float(), ds


def flash_bwd_reference(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                        fbias=None, drop: Optional[Dropout] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the single-pass backward kernel's
    arithmetic (the Pallas ``_flash_bwd_fused_kernel``'s): ``p = exp(s -
    lse)`` from f32 scores with the forward's bias (masked scores at
    ``DEFAULT_MASK_VALUE``), dV's p and dp times the dropout factor, p
    rounded to dO's type before the dV product, ``ds = p (dp - delta)
    scale`` rounded to q's type before the dK and dQ products, f32 sums.
    ``lse`` and ``delta`` are (B, H, Tq) f32.  Returns ``(dq, dk, dv)`` in
    the inputs' types."""
    pd, ds = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, do.float())
    del pd
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                           fbias=None, drop: Optional[Dropout] = None) -> torch.Tensor:
    """Plain version of the dq pass (B6a, the Pallas
    ``_flash_bwd_dq_kernel``): the score tile of :func:`flash_bwd_reference`
    and ``dq = ds k`` summed in f32, in q's type."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                            fbias=None, drop: Optional[Dropout] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv pass (B6b, the Pallas
    ``_flash_bwd_dkv_kernel``): ``(dk, dv)`` from the same score tile."""
    pd, ds = _bwd_probs(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, do.float())
    del pd
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd2_reference(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                         fbias=None, drop: Optional[Dropout] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two-pass backward: the dq pass, then the dk/dv
    pass (each recomputes the score tile).  Returns ``(dq, dk, dv)``."""
    args = (q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    dq = flash_bwd_dq_reference(*args)
    return (dq, *flash_bwd_dkv_reference(*args))


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


def _check_fbias(who: str, fbias, shape, dev) -> None:
    if fbias is None:
        return
    if tuple(fbias.shape) != tuple(shape) or fbias.dtype != torch.float32:
        raise ValueError(f"{who}: fbias must be a float32 view of shape (B, H, Tq, Tk) = "
                         f"{tuple(shape)}, got {fbias.dtype} {tuple(fbias.shape)}")
    if not fbias.is_cuda or fbias.device != dev:
        raise ValueError(f"{who}: fbias lies on {fbias.device}, need the CUDA device {dev}")


def _variant(kbias, fbias, drop) -> str:
    form = "kbias" if kbias is not None else "fbias" if fbias is not None else "none"
    return form + ("+dropout" if drop is not None else "")


def _ext_args(kbias, fbias, drop: Optional[Dropout]):
    """The kernels' extended arguments: kbias, fbias, fbias's strides,
    dropout, k0, k1, threshold, inv_keep."""
    strides = tuple(fbias.stride()) if fbias is not None else (0, 0, 0, 0)
    return (kbias.data_ptr() if kbias is not None else None,
            fbias.data_ptr() if fbias is not None else None, *strides,
            int(drop is not None), drop.k0 if drop else 0, drop.k1 if drop else 0,
            drop.threshold if drop else 0, drop.inv_keep if drop else 1.0)


def _check_options(who, q, k, kbias, fbias, drop) -> None:
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    if kbias is not None and fbias is not None:
        raise ValueError(f"{who}: give kbias or fbias, not both")
    _check_kbias(who, kbias, b, sk, q.device)
    _check_fbias(who, fbias, (b, h, sq, sk), q.device)
    if drop is not None:
        _check_dropout_counter_bound(sq, sk)


def flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, want_lse: bool = False,
                   kbias=None, fbias=None, drop: Optional[Dropout] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the CUDA kernel (``csrc/flash_fwd.cu``) on the current
    stream; ``kbias``: an optional f32 (B, Tk) key-row bias, ``fbias`` an
    optional f32 (B, H, Tq, Tk) bias (an expanded view is read in place),
    ``drop`` optional dropout.  Raises for tensors that are not on one CUDA
    device, not contiguous, or of a type or shape the kernel does not
    take."""
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
    _check_options("flash_fwd_cuda", q, k, kbias, fbias, drop)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if want_lse else None
    lib = _kernels.library()
    fn = lib.fn("flash_fwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, *_ext_args(kbias, fbias, drop),
        b * h, h, sq, sk, d, _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_fwd", err)
    _kernels.count_launch("flash_fwd", _variant(kbias, fbias, drop))
    return out, lse


def flash_fwd(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
              want_lse: bool = False, kbias=None, fbias=None, drop: Optional[Dropout] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The attention forward kernel's function: ``(out, lse or None)``;
    ``kbias``/``fbias``: an optional f32 bias, ``drop`` optional dropout.
    CUDA tensors take the kernel, CPU tensors the plain version."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out, lse = flash_fwd_reference(q, k, v, causal, sm_scale, kbias, fbias, drop)
        return out, (lse if want_lse else None)
    return flash_fwd_cuda(q, k, v, causal, sm_scale, want_lse=want_lse, kbias=kbias, fbias=fbias,
                          drop=drop)


def _check_bwd(who: str, q, k, v, do, lse, delta) -> None:
    if q.ndim != 4:
        raise ValueError(f"{who}: q must be (B, H, T, d), got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d) or do.shape != q.shape:
        raise ValueError(
            f"{who}: k/v must be (B, H, Tk, d) and dO like q ({tuple(q.shape)}), got "
            f"{tuple(k.shape)} / {tuple(v.shape)} / {tuple(do.shape)}"
        )
    if lse.shape != (b, h, sq) or delta.shape != (b, h, sq):
        raise ValueError(
            f"{who}: lse/delta must be (B, H, Tq) = ({b}, {h}, {sq}), got "
            f"{tuple(lse.shape)} / {tuple(delta.shape)}"
        )
    if d not in _HEAD_DIMS:
        raise ValueError(f"{who}: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, do)):
        raise ValueError(
            f"{who}: q/k/v/dO dtypes {q.dtype}/{k.dtype}/{v.dtype}/{do.dtype} must be "
            f"one of {list(_DTYPE_CODES)} and equal"
        )
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{who}: lse/delta must be float32, got {lse.dtype}/{delta.dtype}")
    if b * h > 65535:
        raise ValueError(f"{who}: B*H = {b * h} exceeds the grid's 65535")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do), ("lse", lse), ("delta", delta)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{who}: {name} lies on {t.device}, need the CUDA device {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def flash_bwd_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                   fbias=None, drop: Optional[Dropout] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the single-pass backward CUDA kernel (``csrc/flash_bwd.cu``)
    on the current stream, with the forward's bias and dropout.  dq is
    summed in an f32 buffer (zeroed here, cast to q's type after the
    kernel, as the Pallas kernel's ``dq32``).  Raises for tensors that are
    not on one CUDA device, not contiguous, or of a type or shape the
    kernel does not take."""
    _check_bwd("flash_bwd_cuda", q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and sq > sk:
        raise ValueError(f"flash_bwd_cuda: causal attention needs Tq <= Tk, got {sq} > {sk}")
    _check_options("flash_bwd_cuda", q, k, kbias, fbias, drop)
    dev = q.device
    dq32 = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernels.library()
    fn = lib.fn("flash_bwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq32.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_ext_args(kbias, fbias, drop), b * h, h, sq, sk, d, _DTYPE_CODES[q.dtype],
        int(bool(causal)), float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_bwd", err)
    _kernels.count_launch("flash_bwd", _variant(kbias, fbias, drop))
    return dq32.to(q.dtype), dk, dv


def flash_bwd(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None, fbias=None,
              drop: Optional[Dropout] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The single-pass backward kernel's function: ``(dq, dk, dv)``.  CUDA
    tensors take the kernel, CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    return flash_bwd_cuda(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)


def _launch_bwd2(name: str, outs, q, k, v, do, lse, delta, causal: bool, sm_scale: float,
                 kbias, fbias, drop: Optional[Dropout]) -> None:
    """Check the arguments and launch one pass of the two-pass backward
    (``csrc/flash_bwd_2pass.cu``) writing ``outs``."""
    _check_bwd(name + "_cuda", q, k, v, do, lse, delta)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if causal and sq > sk:
        raise ValueError(f"{name}_cuda: causal attention needs Tq <= Tk, got {sq} > {sk}")
    _check_options(name + "_cuda", q, k, kbias, fbias, drop)
    lib = _kernels.library()
    err = lib.fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs), *_ext_args(kbias, fbias, drop),
        b * h, h, sq, sk, d, _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    lib.check(name, err)
    _kernels.count_launch(name, _variant(kbias, fbias, drop))


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                      fbias=None, drop: Optional[Dropout] = None) -> torch.Tensor:
    """Launch the dq pass (B6a) on the current stream: dq summed in
    registers and written once in q's type (no atomics, so the same bits
    every launch).  Same arguments and refusals as :func:`flash_bwd_cuda`."""
    dq = torch.empty_like(q)
    _launch_bwd2("flash_bwd_dq", (dq,), q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias,
                 drop)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                       fbias=None, drop: Optional[Dropout] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv pass (B6b) on the current stream: ``(dk, dv)``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd2("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, delta, causal, sm_scale, kbias,
                 fbias, drop)
    return dk, dv


def flash_bwd2_cuda(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None,
                    fbias=None, drop: Optional[Dropout] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass backward on the card: the dq kernel (B6a), then the
    dk/dv kernel (B6b).  Returns ``(dq, dk, dv)``."""
    args = (q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    return (flash_bwd_dq_cuda(*args), *flash_bwd_dkv_cuda(*args))


def flash_bwd2(q, k, v, do, lse, delta, causal: bool, sm_scale: float, kbias=None, fbias=None,
               drop: Optional[Dropout] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two-pass backward's function: ``(dq, dk, dv)``.  CUDA tensors
    take the kernels, CPU tensors the plain version."""
    if q.device.type == "cpu":
        return flash_bwd2_reference(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)
    return flash_bwd2_cuda(q, k, v, do, lse, delta, causal, sm_scale, kbias, fbias, drop)


def _bias_mode(bias, b: int, h: int, sq: int, sk: int):
    """Classify an additive bias: (B or 1, 1, 1, Tk) is ``("kbias", f32
    (B, Tk))``; anything else broadcastable to (B, H, Tq, Tk) is
    ``("fbias", an f32 (B, H, Tq, Tk) view)`` (converted to f32 before the
    expansion, so a broadcast dim keeps stride 0)."""
    if bias is None:
        return None, None
    if bias.ndim != 4:
        raise ValueError(f"bias must be 4-D broadcastable to (B,H,Tq,Tk), got {tuple(bias.shape)}")
    if bias.shape[1] == 1 and bias.shape[2] == 1 and bias.shape[3] == sk:
        return "kbias", bias.detach().expand(b, 1, 1, sk).reshape(b, sk).float().contiguous()
    return "fbias", bias.detach().float().expand(b, h, sq, sk)


def _bias_cotangent(q, k, v, out, lse, do, bias, causal: bool, sm_scale: float,
                    drop: Optional[Dropout] = None) -> torch.Tensor:
    """Exact dL/dbias: dS of the pre-scale scores (no ``sm_scale``, the
    bias enters after it), with dp times the dropout factor, summed over
    the dims the bias broadcasts along.  Computed only for a bias that
    requires a gradient (a learned relative position); a constant padding
    mask never pays this O(Tq*Tk) pass."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = _scores(q, k, causal, sm_scale, torch.broadcast_to(bias.detach(), (b, h, sq, sk)))
    p = torch.exp(s - lse[..., None])
    do32 = do.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    keep = _keep_factor(drop, q, k)
    if keep is not None:
        dp = dp * keep
    delta = (do32 * out.float()).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    dims = tuple(i for i in range(4) if bias.shape[i] == 1)
    db = ds.sum(dim=dims, keepdim=True) if dims else ds
    return db.to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """Kernel attention with its kernel backward (the JAX package's
    ``_flash_attention`` custom_vjp): the forward keeps the kernel's
    ``lse``; the backward forms ``delta = rowsum(dO * O)`` in f32 as plain
    torch (the XLA prologue of the Pallas backward; O is the output after
    dropout) and runs :func:`flash_bwd` (B2), or :func:`flash_bwd2` (B6)
    where a bias meets ``sq * d * 4 > _FUSED_BWD_MAX_SQ_BYTES``.  ``bias``
    is the caller's bias or None; the kernels take it as ``kbias`` or
    ``fbias`` (:func:`_bias_mode`).  ``drop`` is the dropout or None; the
    backward regenerates the same keep-bits.  The bias's cotangent is
    :func:`_bias_cotangent`, computed only when the bias requires a
    gradient: a constant mask gets None, the port's form of XLA's
    dead-code elimination of that pass."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal: bool, sm_scale: float, drop):
        b, h, sq, _ = q.shape
        mode, b2 = _bias_mode(bias, b, h, sq, k.shape[2])
        kbias = b2 if mode == "kbias" else None
        out, lse = flash_fwd(q, k, v, causal, sm_scale, want_lse=True, kbias=kbias,
                             fbias=b2 if mode == "fbias" else None, drop=drop)
        ctx.save_for_backward(q, k, v, out, lse, kbias, bias)
        ctx.causal = causal
        ctx.sm_scale = sm_scale
        ctx.drop = drop
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, kbias, bias = ctx.saved_tensors
        b, h, sq, d = q.shape
        fbias = None
        if bias is not None and kbias is None:
            fbias = _bias_mode(bias, b, h, sq, k.shape[2])[1]
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        two_pass = bias is not None and sq * d * 4 > _FUSED_BWD_MAX_SQ_BYTES
        bwd = flash_bwd2 if two_pass else flash_bwd
        dq, dk, dv = bwd(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale, kbias, fbias, ctx.drop)
        dbias = None
        if ctx.needs_input_grad[3]:
            dbias = _bias_cotangent(q, k, v, out, lse, do, bias, ctx.causal, ctx.sm_scale, ctx.drop)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                    bias=None, dropout_rate: float = 0.0, dropout_rng=None) -> torch.Tensor:
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
    differentiable; the kernels take the key-row form (B, 1, 1, Tk) and
    the full form.  ``dropout_rate``: attention-probability dropout
    (softmax, then dropout), keyed by ``dropout_rng`` (a
    ``torch.Generator`` or an explicit pair of uint32 words, see
    :func:`_seed_pair`); the kernels generate the keep-bits in-kernel, the
    dense and reference branches take the same bits from
    :func:`dropout_keep_mask_host`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    drop = make_dropout(dropout_rate, dropout_rng)
    b, h, sq, sk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    keep_prob = 1.0 if drop is None else drop.keep_prob
    if sq * sk <= SMALL_SEQ_DENSE_SCORES:
        return mha_dense(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                         dropout_mask=keep_mask(drop, q, k), keep_prob=keep_prob)
    if sq < 8 or sk < 8 or (causal and sq > sk):
        # causal sq > sk leaves rows with no key at all; the reference's
        # uniform softmax is the defined answer there
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale, bias=bias,
                             dropout_mask=keep_mask(drop, q, k), keep_prob=keep_prob)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    wants_grad = any(t is not None and t.requires_grad for t in (q, k, v, bias))
    if torch.is_grad_enabled() and wants_grad:
        return _FlashAttention.apply(q, k, v, bias, causal, float(sm_scale), drop)
    mode, b2 = _bias_mode(bias, b, h, sq, sk)
    return flash_fwd(q, k, v, causal, sm_scale, kbias=b2 if mode == "kbias" else None,
                     fbias=b2 if mode == "fbias" else None, drop=drop)[0]
