"""Sequence parallelism over the ``seq`` axis: ring attention and Ulysses
all-to-all attention (counterpart of ``deepspeed_tpu/parallel/sequence.py``).

The JAX package runs both inside ``shard_map`` over global arrays; here
each rank holds its shard of the sequence, ``(B, H, T/P, d)``, positions
``[r*T/P, (r+1)*T/P)`` on the ``seq`` rank ``r``, and the exchanges are
explicit.

* **Ring attention** (:func:`ring_attention`) is one
  ``torch.autograd.Function``: autograd cannot see through the
  ``batch_isend_irecv`` that rotates K/V.  The forward walks the ring: at
  step ``i`` the rank holds the K/V of rank ``src = (r - i) mod P`` and
  runs the attention forward kernel (B1, :func:`flash_fwd` with its lse)
  on that block: causal on the diagonal block, full for ``src < r``,
  skipped for ``src > r`` (the JAX body masks those scores to
  ``DEFAULT_MASK_VALUE``, so they add exactly 0).  The ``(out, lse)``
  pairs merge in f32, step by step in that fixed order.  The backward
  forms ``delta = rowsum(dO * O)`` and walks the ring again: each block
  goes to the backward kernel (B2, :func:`flash_bwd`) with the merged
  lse, dq sums locally in step order, and the f32 dK/dV accumulators
  travel with their K/V, reaching their owner after a full turn — the
  same bits every run.  CPU tensors take the kernels' plain versions in
  the same schedule (the JAX body's online softmax, blockwise); that is
  also the kernels' oracle on the card (``plain=True``).
* **Ulysses** (:func:`ulysses_attention`): an all-to-all from sequence to
  heads, :func:`flash_attention` over the whole sequence for H/P heads,
  and an all-to-all back; each exchange's backward is the inverse one.

The schedule is apart from the exchange: a :class:`SeqRing` over the
``seq`` group of a mesh runs one rank per process, a :class:`VirtualRing`
runs P ranks in one process (the sequence cut into P shards, the
exchange a rotation of a list), which is how the ring is held against
dense attention on one card.

At ``seq`` size 1 both fall back to :func:`flash_attention` (or the plain
reference for Ulysses' ``use_flash=False``), as the JAX package does.

The ambient mesh (:func:`ambient_mesh`, :func:`scoped_to`,
:func:`set_global_mesh`, :func:`get_global_mesh`) is the JAX package's:
models are built before an engine's mesh exists, so they resolve it when
they run; the engine scopes its mesh around every forward.  Resolution
order: an explicit ``mesh`` argument, then the running engine's, then
the process default.
"""
from __future__ import annotations

import contextlib
import functools
import math
from contextvars import ContextVar
from typing import List, Optional, Sequence

import torch

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.ops.attention.flash_attention import (
    flash_attention,
    flash_bwd,
    flash_bwd_float64,
    flash_bwd_reference,
    flash_fwd,
    flash_fwd_reference,
    mha_reference,
)
from deepspeed_tpu_torch.sharding.layout import DEFAULT_LAYOUT

SEQ_AXIS = "seq"


def _axis_size(mesh, axis_name: str) -> int:
    return int(mesh.sizes.get(axis_name, 1))


def check_seq_len(T: int, P: int) -> None:
    """The JAX package's refusal of a sequence the ``seq`` axis does not
    divide."""
    if T % P:
        raise ValueError(f"seq len {T} not divisible by seq axis size {P}")


def check_ulysses_heads(H: int, P: int) -> None:
    """The JAX package's refusal of Ulysses over heads ``P`` does not
    divide (``H``: the heads the rank holds)."""
    if H % P:
        raise ValueError(f"ulysses needs heads ({H}) divisible by seq axis ({P})")


def local_positions(mesh, T: int) -> slice:
    """This rank's positions of a length-``T`` sequence: the token
    dimension's block under the batch layout with the sequence cut over
    ``seq`` (``sharding/layout.py`` ``batch(seq_sharded=True)``)."""
    return mesh.region((T,), DEFAULT_LAYOUT.batch(2, seq_sharded=True)[1:])[0]


# ---------------------------------------------------------------------------
# rings: the exchange apart from the schedule
# ---------------------------------------------------------------------------

class SeqRing:
    """One rank of the ring over a mesh's ``seq`` group: ``lanes`` holds
    this rank's tensors alone, and the exchange sends to the next ``seq``
    rank and receives from the previous one (``comm/collectives.py``
    ``RingExchange``, counted as ``seq-p2p``)."""

    def __init__(self, mesh, axis_name: str = SEQ_AXIS):
        self.size = _axis_size(mesh, axis_name)
        self.mys = [mesh.coords[axis_name]]
        self._xchg = collectives.RingExchange(
            mesh.group((axis_name,)), mesh.members((axis_name,)), mesh.coords[axis_name],
            kind="seq-p2p")

    def lanes(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [x.contiguous()]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return xs[0]

    def start(self, lanes):
        pending = self._xchg.start(lanes[0])
        return _Done(None, pending)


class VirtualRing:
    """``size`` ranks of a ring in one process: a tensor's sequence
    dimension (2) is cut into ``size`` shards, one lane each, and the
    exchange hands lane ``j`` what lane ``j - 1`` sent (no bytes move
    between processes, none are counted)."""

    def __init__(self, size: int):
        self.size = int(size)
        self.mys = list(range(self.size))

    def lanes(self, x: torch.Tensor) -> List[torch.Tensor]:
        check_seq_len(x.shape[2], self.size)
        return [c.contiguous() for c in x.chunk(self.size, dim=2)]

    def join(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=2)

    def start(self, lanes):
        n = len(lanes)
        return _Done([lanes[(j - 1) % n] for j in range(n)], None)


class _Done:
    __slots__ = ("lanes", "pending")

    def __init__(self, lanes, pending):
        self.lanes, self.pending = lanes, pending

    def wait(self):
        return self.lanes if self.pending is None else [self.pending.wait()]


# ---------------------------------------------------------------------------
# the ring's schedule
# ---------------------------------------------------------------------------

def _merge(acc, lse, o, l):
    """Merge a block's ``(out, lse)`` into the running pair, in f32."""
    o = o.float()
    if acc is None:
        return o, l
    m = torch.maximum(lse, l)
    a, b = torch.exp(lse - m), torch.exp(l - m)
    s = a + b
    acc = (acc * a[..., None] + o * b[..., None]) / s[..., None]
    return acc, m + torch.log(s)


def _blocks(plain: bool):
    """The block forward and backward: the kernels (B1 with its lse, B2)
    on CUDA tensors, their plain versions on CPU tensors or with
    ``plain``."""
    if plain:
        return flash_fwd_reference, flash_bwd_reference

    def fwd(q, k, v, causal, scale):
        return flash_fwd(q, k, v, causal, scale, want_lse=True)

    return fwd, flash_bwd


def ring_forward(qs, ks, vs, ring, causal: bool, scale: float, plain: bool = False):
    """The forward walk over ``ring``'s lanes: ``(outs, lses)``, each lane's
    output in q's type and its merged lse (f32)."""
    fwd, _ = _blocks(plain)
    n, P = len(qs), ring.size
    acc, lse = [None] * n, [None] * n
    cur = [[ks[j], vs[j]] for j in range(n)]
    for i in range(P):
        # post the rotation before the block's work, as the JAX body
        # starts its ppermute before the einsums
        nxt = ring.start(cur) if i < P - 1 else None
        for j in range(n):
            my = ring.mys[j]
            src = (my - i) % P
            if causal and src > my:
                continue
            o, l = fwd(qs[j], cur[j][0], cur[j][1], causal and src == my, scale)
            acc[j], lse[j] = _merge(acc[j], lse[j], o, l)
        if nxt is not None:
            cur = nxt.wait()
    return [a.to(q.dtype) for a, q in zip(acc, qs)], lse


def ring_backward(qs, ks, vs, outs, lses, dos, ring, causal: bool, scale: float,
                  plain: bool = False):
    """The backward walk: ``(dqs, dks, dvs)`` in the inputs' types.  dq
    sums in f32 in step order; the f32 dK/dV of a K/V block ride the ring
    with it and are this rank's after P sends."""
    _, bwd = _blocks(plain)
    n, P = len(qs), ring.size
    deltas = [(do.float() * o.float()).sum(dim=-1) for do, o in zip(dos, outs)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dkv = [[torch.zeros(k.shape, dtype=torch.float32, device=k.device),
            torch.zeros(v.shape, dtype=torch.float32, device=v.device)] for k, v in zip(ks, vs)]
    cur = [[ks[j], vs[j]] for j in range(n)]
    for i in range(P):
        nxt = ring.start(cur) if i < P - 1 else None
        for j in range(n):
            my = ring.mys[j]
            src = (my - i) % P
            if causal and src > my:
                continue
            gq, gk, gv = bwd(qs[j], cur[j][0], cur[j][1], dos[j], lses[j], deltas[j],
                             causal and src == my, scale)
            dq[j] += gq.float()
            dkv[j][0] += gk.float()
            dkv[j][1] += gv.float()
        dkv = ring.start(dkv).wait()
        if nxt is not None:
            cur = nxt.wait()
    return ([g.to(q.dtype) for g, q in zip(dq, qs)],
            [g[0].to(k.dtype) for g, k in zip(dkv, ks)],
            [g[1].to(v.dtype) for g, v in zip(dkv, vs)])


def ring_bwd_float64(q, k, v, do, lse, delta, P: int, causal: bool, sm_scale: float):
    """The ring backward's function in float64 and the bound of its bf16
    or f32 contract, over the whole ``(B, H, T, d)`` tensors cut into
    ``P`` shards as the ring cuts them: ``((dq, dk, dv), (bound_dq,
    bound_dk, bound_dv))``, float64, as
    ``flash_attention.flash_bwd_float64`` gives them (read with
    ``float64_over_bound``).  Each block the schedule runs is
    ``flash_bwd_float64`` on that block with the merged ``lse`` and
    ``delta``: its result rounded to the input type is a block's
    contract.  The ring sums the P blocks of a row or column in f32 and
    rounds once more, so the bound is the blocks' bounds summed, plus the
    f32 sum's error over the blocks' magnitudes, plus the last rounding.
    The exact part is the whole sequence's gradient."""
    T = q.shape[2]
    check_seq_len(T, P)
    n = T // P
    u = torch.finfo(q.dtype).eps / 2
    e = torch.finfo(torch.float32).eps / 2
    exact = [torch.zeros(t.shape, dtype=torch.float64, device=q.device) for t in (q, k, v)]
    bound = [torch.zeros_like(x) for x in exact]
    mag = [torch.zeros_like(x) for x in exact]  # sum of the blocks' |result| bounds

    def cut(t, j):
        return t[:, :, j * n:(j + 1) * n]

    for my in range(P):
        for src in range(P):
            if causal and src > my:
                continue
            (gq, gk, gv), (bq, bk, bv) = flash_bwd_float64(
                cut(q, my), cut(k, src), cut(v, src), cut(do, my), cut(lse, my),
                cut(delta, my), causal and src == my, sm_scale)
            for i, (j, g, b) in enumerate(((my, gq, bq), (src, gk, bk), (src, gv, bv))):
                sl = (slice(None), slice(None), slice(j * n, (j + 1) * n))
                exact[i][sl] += g
                bound[i][sl] += b
                mag[i][sl] += g.abs() + b
    out_bounds = []
    for x, b, m in zip(exact, bound, mag):
        pre = b + (P - 1) * e * m
        out_bounds.append(pre + u * (x.abs() + pre))
    return tuple(exact), tuple(out_bounds)


class _RingAttention(torch.autograd.Function):
    """The ring, forward and backward, as one autograd function over
    ``ring``'s lanes (the rank's shard, or the whole sequence of a
    :class:`VirtualRing`)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal: bool, scale: float, plain: bool):
        qs, ks, vs = ring.lanes(q), ring.lanes(k), ring.lanes(v)
        outs, lses = ring_forward(qs, ks, vs, ring, causal, scale, plain)
        out, lse = ring.join(outs), ring.join(lses)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale, ctx.plain = ring, causal, scale, plain
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ring = ctx.ring
        lanes = [ring.lanes(t) for t in (q, k, v, out, lse, do)]
        dq, dk, dv = ring_backward(*lanes, ring, ctx.causal, ctx.scale, ctx.plain)
        return ring.join(dq), ring.join(dk), ring.join(dv), None, None, None, None


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``collectives.all_to_all`` from ``split`` to ``concat`` over a
    group; the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, split: int, concat: int):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return collectives.all_to_all(x, group, split, concat, kind="seq-all-to-all")

    @staticmethod
    def backward(ctx, g):
        return (collectives.all_to_all(g.contiguous(), ctx.group, ctx.concat, ctx.split,
                                       kind="seq-all-to-all"), None, None, None)


class _ReduceFromSeq(torch.autograd.Function):
    """Sum over the ``seq`` group forward (``seq-loss``), identity
    backward: each rank's loss is the global one, and its gradient flows
    through this rank's positions alone (the engine then sums the
    gradients over ``seq``)."""

    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.clone(), group, kind="seq-loss")

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_seq(x: torch.Tensor, mesh, axis_name: str = SEQ_AXIS) -> torch.Tensor:
    """``x`` summed over the ``seq`` ranks of ``mesh``; its gradient as it
    is."""
    return _ReduceFromSeq.apply(x, mesh.group((axis_name,)))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def ring_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None, mesh=None,
                   axis_name: str = SEQ_AXIS, ring=None, plain: bool = False) -> torch.Tensor:
    """Exact attention with K/V rotating around the ``seq`` ring.  ``q, k,
    v``: this rank's shards ``(B, H, T/P, d)`` (positions ``[r*T/P,
    (r+1)*T/P)``); the result is this rank's shard of the output.  At
    ``seq`` size 1: :func:`flash_attention`.  ``ring``: a
    :class:`VirtualRing` over whole tensors instead of the mesh's ring;
    ``plain``: the kernels' plain versions on any device."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if ring is None:
        mesh = _resolve_mesh(mesh)
        if _axis_size(mesh, axis_name) == 1:
            return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        ring = SeqRing(mesh, axis_name)
    return _RingAttention.apply(q, k, v, ring, bool(causal), float(sm_scale), bool(plain))


def ulysses_attention(q, k, v, causal: bool = False, sm_scale: Optional[float] = None,
                      mesh=None, axis_name: str = SEQ_AXIS, use_flash: bool = True) -> torch.Tensor:
    """All-to-all (Ulysses) attention over ``seq``: this rank's shards
    ``(B, H, T/P, d)`` in, its shard of the output out.  Needs ``H % P ==
    0``.  At ``seq`` size 1: :func:`flash_attention` (``use_flash``) or the
    plain reference."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    mesh = _resolve_mesh(mesh)
    P = _axis_size(mesh, axis_name)
    if P == 1:
        if use_flash:
            return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        return mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    check_ulysses_heads(q.shape[1], P)
    group = mesh.group((axis_name,))
    # (B, H, T/P, d) -> (B, H/P, T, d): heads out, sequence in
    q, k, v = (_AllToAll.apply(t, group, 1, 2) for t in (q, k, v))
    if use_flash:
        o = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    else:
        o = mha_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return _AllToAll.apply(o, group, 2, 1)


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT_MESH: ContextVar = ContextVar("ds_torch_ambient_mesh", default=None)
_DEFAULT_MESH = None


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make ``mesh`` the one lazily resolved ops see, for the block (an
    engine scopes its own around every forward)."""
    token = _AMBIENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT_MESH.reset(token)


def scoped_to(mesh, fn):
    """``fn`` run under :func:`ambient_mesh` of ``mesh``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with ambient_mesh(mesh):
            return fn(*args, **kwargs)

    return wrapped


def set_global_mesh(mesh) -> None:
    """Set the process default (code outside any engine)."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_global_mesh():
    """The running engine's ambient mesh, else the process default."""
    amb = _AMBIENT_MESH.get()
    return amb if amb is not None else _DEFAULT_MESH


def _resolve_mesh(mesh):
    if mesh is not None:
        return mesh
    resolved = get_global_mesh()
    if resolved is None:
        raise ValueError(
            "sequence-parallel attention needs a mesh: pass mesh=..., run "
            "under an engine (it scopes its mesh around every forward), or "
            "set_global_mesh(...) for standalone use"
        )
    return resolved
