"""Collectives on explicit process groups (counterpart of
``deepspeed_tpu/comm/collectives.py:99-131``, whose ``lax`` collectives
run inside a compiled SPMD program over named mesh axes).

Here each is a thin wrapper over ``torch.distributed`` on a group of the
port's mesh (``comm/mesh.py``), and each counts its bytes, by kind, under
the convention of ``runtime/zero/stages.py::zero_step_comm_model``: an
all-reduce twice its payload, an all-gather its whole result once, a
reduce-scatter its shard once, an all-to-all its input once, a ring
exchange the bytes it sends.  ``kind`` names the count (the model's
``all-gather``, ``reduce-scatter``, ``all-reduce``, ``grad-exchange``, or
a kind of the port's own such as ``update-all-gather``, ``tp-all-reduce``,
``seq-all-to-all``, ``seq-p2p``, ``expert-all-reduce``, ``pipe-p2p``);
:func:`reset_counts` and :func:`counts` read them.  The counts are host
integers from tensor shapes: counting never waits on the device.

The engine calls these only on axes longer than one rank (a one-rank
axis moves nothing, and the model counts nothing for it); called on a
one-rank group they still run the collective.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_COUNTS: Dict[str, int] = defaultdict(int)


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> Dict[str, int]:
    """Bytes counted by kind since the last :func:`reset_counts`."""
    return dict(_COUNTS)


def _count(kind: str, nbytes: int) -> None:
    _COUNTS[kind] += int(nbytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group) -> int:
    return dist.get_world_size(group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce(x: torch.Tensor, group, kind: str = "all-reduce", op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"`` / ``"min"``: the largest / smallest entry) over
    ``group``, in place on a contiguous ``x`` (a copy otherwise); returns
    the result."""
    y = x if x.is_contiguous() else x.contiguous()
    dist.all_reduce(y, op=_OPS[op], group=group)
    _count(kind, 2 * _nbytes(y))
    return y


def all_reduce_mean(x: torch.Tensor, group, kind: str = "all-reduce") -> torch.Tensor:
    return all_reduce(x, group, kind=kind) / group_size(group)


def all_gather(x: torch.Tensor, group, dim: int = 0, kind: str = "all-gather",
               order: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in group-rank order,
    or chunk ``c`` from group rank ``order[c]``.  A gather along a
    dimension other than the first costs one copy after the collective."""
    n = group_size(group)
    x = x.contiguous()
    staged = _host_staged(x.device, group)
    src = _to_host(x) if staged else x
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]) if x.dim() else (n,),
                      dtype=x.dtype, device=src.device, pin_memory=staged and src.is_pinned())
    dist.all_gather_into_tensor(out, src, group=group)
    _count(kind, _nbytes(out))
    if staged:
        out = out.to(x.device, non_blocking=True)
    if x.dim() == 0:
        return out
    stacked = out.view((n,) + tuple(x.shape))
    if order is not None and list(order) != list(range(n)):
        stacked = stacked[torch.as_tensor(list(order), device=x.device)]
    if dim == 0:
        return stacked.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    shape = list(x.shape)
    shape[dim] *= n
    return stacked.movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0,
                   kind: str = "reduce-scatter") -> torch.Tensor:
    """Sum over ``group`` and keep this rank's chunk of ``dim`` (group
    rank ``r`` keeps chunk ``r``).  A dimension other than the first costs
    one copy before the collective."""
    n = group_size(group)
    shape = list(x.shape)
    if shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(shape)} is not a multiple of {n}")
    shape[dim] //= n
    if dim == 0:
        inp = x.contiguous()
    else:
        split = list(x.shape[:dim]) + [n, shape[dim]] + list(x.shape[dim + 1:])
        inp = x.reshape(split).movedim(dim, 0).contiguous()  # (n, *shape)
    inp = inp.reshape((n * shape[0],) + tuple(shape[1:]))
    if _host_staged(x.device, group):
        # gloo has no reduce-scatter of CUDA tensors: the sum over the
        # group on the host, this rank's chunk back to the device
        host = _to_host(inp)
        dist.all_reduce(host, group=group)
        r = dist.get_rank(group)
        out = host[r * shape[0]:(r + 1) * shape[0]].to(x.device, non_blocking=True)
    else:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, inp, group=group)
    _count(kind, _nbytes(out))
    return out


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int,
               kind: str = "all-to-all") -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: cut ``split_dim`` into one
    chunk per group rank, send chunk ``j`` to group rank ``j``, and
    concatenate the chunks received along ``concat_dim`` in group-rank
    order.  One ``all_to_all_single``, with a copy on each side; a CUDA
    tensor on a gloo group goes through pinned host memory
    (:func:`_host_staged`)."""
    n = group_size(group)
    shape = list(x.shape)
    if shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(shape)} is not a multiple of {n}")
    parts = shape[:split_dim] + [n, shape[split_dim] // n] + shape[split_dim + 1:]
    inp = x.reshape(parts).movedim(split_dim, 0).contiguous()
    staged = _host_staged(inp.device, group)
    src = _to_host(inp) if staged else inp
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _count(kind, _nbytes(inp))
    if staged:
        out = out.to(inp.device, non_blocking=True)
    # out[j] is group rank j's chunk: put the rank index just before
    # concat_dim and merge the two
    out = out.movedim(0, concat_dim)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return out.reshape(shape)


class RingExchange:
    """Send to the next rank of a ring and receive from the previous one
    (``batch_isend_irecv``): :meth:`start` posts the transfers of a list
    of tensors and returns a handle whose ``wait()`` gives the tensors
    received, shaped and typed as those sent.  ``ranks`` are the ring's
    global ranks in ring order, ``me`` this rank's place in it; each
    exchange counts the bytes it sends under ``kind``."""

    def __init__(self, group, ranks: Sequence[int], me: int, kind: str = "p2p"):
        self.group, self.ranks, self.me, self.kind = group, list(ranks), int(me), kind
        self.size = len(self.ranks)

    def start(self, tensors: Sequence[torch.Tensor]) -> "_Pending":
        nxt = self.ranks[(self.me + 1) % self.size]
        prv = self.ranks[(self.me - 1) % self.size]
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, nxt, group=self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, prv, group=self.group) for t in recvs]
        reqs = dist.batch_isend_irecv(ops)
        _count(self.kind, sum(_nbytes(t) for t in sends))
        return _Pending(reqs, recvs, sends)


class _Pending:
    """Transfers in flight; the sent tensors stay referenced until they end."""

    __slots__ = ("reqs", "recvs", "sends")

    def __init__(self, reqs, recvs, sends):
        self.reqs, self.recvs, self.sends = reqs, recvs, sends

    def wait(self) -> List[torch.Tensor]:
        for r in self.reqs:
            r.wait()
        self.sends = None
        return self.recvs


def _host_staged(device, group) -> bool:
    """Whether a transfer from or to ``device`` goes through host memory: a
    CUDA tensor on a gloo group (gloo's send, receive, all-to-all,
    all-gather and reduce-scatter take host tensors only; ranks that share
    one card meet over gloo)."""
    return torch.device(device).type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, pinned where there is a card."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def p2p_send(x: torch.Tensor, dst: int, group, kind: str = "p2p") -> "_Pending":
    """Post a send of ``x`` to global rank ``dst`` of ``group`` (its bytes,
    any dtype, as ``uint8``); ``wait()`` on the handle ends it.  A CUDA
    tensor on a gloo group is copied to pinned host memory first (stage
    processes sharing one card)."""
    raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    if _host_staged(raw.device, group):
        host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(raw)
        raw = host
    req = dist.isend(raw, dst, group=group)
    _count(kind, raw.numel())
    return _Pending([req], [], [raw])


def p2p_recv(shape, dtype: torch.dtype, device, src: int, group) -> torch.Tensor:
    """Receive from global rank ``src`` of ``group`` what :func:`p2p_send`
    sent, as a tensor of ``shape`` and ``dtype`` on ``device`` (blocks
    until it has arrived)."""
    n = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
    staged = _host_staged(device, group)
    buf = torch.empty((n,), dtype=torch.uint8, device="cpu" if staged else device,
                      pin_memory=staged)
    dist.recv(buf, src, group=group)
    if staged:
        buf = buf.to(device, non_blocking=True)
    return buf.view(dtype).reshape(shape)


def broadcast_object(obj: Any, src: int = 0, group=None) -> Any:
    """``obj`` from rank ``src`` on every rank (the checkpoint tag)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def host_allgather(obj: Any, group=None) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (a host-side gather:
    blocking on every rank)."""
    out: List[Any] = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group=None) -> None:
    dist.barrier(group=group)


_HOST_GROUPS: Dict[Tuple[Tuple[int, ...], ...], Any] = {}


def host_group(rank_sets: Optional[Sequence[Sequence[int]]] = None):
    """A gloo group for host tensors: over every rank by default (the
    default group when it is gloo, else one made at the first call), or,
    given ``rank_sets`` (every group's ranks, the same lists in the same
    order on every rank), this rank's group among them.  Collective: every
    rank calls it at the same point."""
    me = dist.get_rank()
    if rank_sets is None:
        rank_sets = [list(range(dist.get_world_size()))]
    key = tuple(tuple(r) for r in rank_sets)
    if key not in _HOST_GROUPS:
        mine = None
        for ranks in key:
            if len(ranks) == dist.get_world_size() and dist.get_backend() == "gloo":
                pg = dist.group.WORLD
            else:
                pg = dist.new_group(list(ranks), backend="gloo")
            if me in ranks:
                mine = pg
        _HOST_GROUPS[key] = mine
    return _HOST_GROUPS[key]


def host_all_gather(x: torch.Tensor, group, out: Optional[torch.Tensor] = None,
                    kind: str = "offload-masters-allgather") -> torch.Tensor:
    """Every rank's contiguous host tensor ``x`` (same shape on each),
    concatenated flat in group-rank order, into ``out`` when given (a
    pinned buffer kept across calls): one ``all_gather_into_tensor`` on a
    gloo group, no pickling."""
    n = group_size(group)
    flat = x.reshape(-1)
    if out is None:
        out = torch.empty(n * flat.numel(), dtype=x.dtype, pin_memory=x.is_pinned())
    dist.all_gather_into_tensor(out, flat, group=group)
    _count(kind, _nbytes(out))
    return out


# ---------------------------------------------------------------------------
# EQuARX-style int8 quantized all-reduce (``deepspeed_tpu/comm/collectives.py``
# ``_quantize_chunks_int8``, ``_int8_body``, ``quantized_allreduce_replicated``,
# ``dense_allreduce_replicated``).  Each takes this rank's row of the
# exchange on a process group; the ``*_rows`` functions take every rank's
# row stacked ``(n, M)`` in one process (the plain versions the tests and
# the card's check hold the group versions to).
# ---------------------------------------------------------------------------

def quantize_chunks_int8(xc: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Symmetric int8 codes with one f32 scale per row of ``xc`` (``(k,
    chunk)``): ``scale = max|x| / 127`` (1 for an all-zero row).  With a
    ``generator``, unbiased stochastic rounding ``floor(y + u)``, ``u ~
    U[0, 1)`` drawn from it (on ``xc``'s device); else round half to even,
    as ``jnp.rint``."""
    amax = xc.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    y = xc / scale[:, None]
    if generator is not None:
        q = torch.floor(y + torch.rand(y.shape, generator=generator, device=y.device,
                                       dtype=torch.float32))
    else:
        q = torch.round(y)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def quantized_allreduce(x: torch.Tensor, group, generator: Optional[torch.Generator] = None,
                        kind: str = "grad-exchange") -> torch.Tensor:
    """The mean over ``group`` of every rank's ``x`` (``(M,)``, M a multiple
    of the group size), quantized twice: each destination chunk to int8
    with its own scale, exchanged by an all-to-all (with the scales), the
    served chunk averaged, re-quantized and all-gathered.  Bytes: 2 M of
    codes and 8 n of scales a rank.  ``generator``: stochastic rounding
    (this rank's own draws); None rounds to nearest."""
    n = group_size(group)
    xf = x.float().reshape(n, -1)
    q, scale = quantize_chunks_int8(xf, generator)
    served = all_to_all(q, group, split_dim=0, concat_dim=0, kind=kind)
    served_scales = all_to_all(scale.reshape(n, 1), group, split_dim=0, concat_dim=0, kind=kind)
    partial = torch.mean(served.float() * served_scales, dim=0)
    q2, scale2 = quantize_chunks_int8(partial[None, :], generator)
    all_q = all_gather(q2[0], group, kind=kind)
    all_s = all_gather(scale2, group, kind=kind)
    return (all_q.reshape(n, -1).float() * all_s[:, None]).reshape(-1)


def quantized_allreduce_rows(rows: torch.Tensor) -> torch.Tensor:
    """:func:`quantized_allreduce` with nearest rounding over every rank's
    row ``(n, M)`` in one process: the ``(M,)`` mean every rank gets."""
    n, m = rows.shape
    if m % n:
        raise ValueError(f"tensor length {m} not divisible by axis size {n}")
    xf = rows.float().reshape(n, n, m // n)  # [source, destination chunk, :]
    qs, ss = zip(*(quantize_chunks_int8(xf[i]) for i in range(n)))
    q, s = torch.stack(qs), torch.stack(ss)  # (n, n, chunk), (n, n)
    partial = torch.mean(q.float() * s[:, :, None], dim=0)  # (n destinations, chunk)
    q2, s2 = quantize_chunks_int8(partial)
    return (q2.float() * s2[:, None]).reshape(-1)


def dense_allreduce(x: torch.Tensor, group, kind: str = "grad-exchange") -> torch.Tensor:
    """The full-precision mean of every rank's ``x`` (the dense rung of the
    same interface)."""
    return all_reduce(x.float().contiguous().clone(), group, kind=kind) / group_size(group)


def dense_allreduce_rows(rows: torch.Tensor) -> torch.Tensor:
    return rows.float().mean(dim=0)
