"""Tensor parallelism over the ``model`` axis: the Megatron operators.

The JAX package gives its tensor-parallel leaves specs
(``sharding/rules.py``: ``qkv_w``/``fc_w`` and their biases cut by output
column, ``proj_w``/``fc_proj_w`` by input row, the token embedding by
vocabulary row) and GSPMD inserts every collective.  The port's models
take the rank's blocks of those leaves and call these operators where
the collectives go, each a ``torch.autograd.Function`` over the ``model``
group whose collectives count as ``tp-all-reduce``:

* :func:`copy_to_model` — identity forward, all-reduce backward: before
  a column-parallel matmul (and before the vocab-parallel head);
* :func:`reduce_from_model` — all-reduce forward, identity backward:
  after a row-parallel matmul, before its replicated bias;
* :func:`vocab_parallel_embedding` — the masked lookup of the rank's
  vocabulary rows, then an all-reduce;
* :func:`vocab_parallel_nll` — the token NLL from the rank's vocabulary
  columns of the logits: the max, the sum of exponentials and the target
  logit all-reduced, so the whole ``(B, T, V)`` logits never exist on
  one rank; its backward needs no collective.

:func:`tp_group` reads the ``model`` group of the ambient mesh
(``parallel/sequence.py``); with one rank on the axis there is none, and
the models keep their one-device arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepspeed_tpu_torch.comm import collectives

TP_AXIS = "model"
TP_ALL_REDUCE = "tp-all-reduce"


class TPGroup:
    """The ``model`` group of one rank: the process group, its size and
    this rank's place (its vocabulary block, its heads)."""

    __slots__ = ("group", "size", "rank")

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)


def tp_group(mesh=None) -> Optional[TPGroup]:
    """The ambient (or given) mesh's ``model`` group; None where the axis
    has one rank or no mesh is set."""
    if mesh is None:
        from deepspeed_tpu_torch.parallel.sequence import get_global_mesh

        mesh = get_global_mesh()
    if mesh is None or mesh.sizes.get(TP_AXIS, 1) <= 1:
        return None
    return TPGroup(mesh.group((TP_AXIS,)), mesh.sizes[TP_AXIS], mesh.coords[TP_AXIS])


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce(g.clone(), ctx.group, kind=TP_ALL_REDUCE), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collectives.all_reduce(x.clone(), group, kind=TP_ALL_REDUCE)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the ``model`` group."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``x`` summed over the ``model`` group; its gradient as it is."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def vocab_parallel_rows(table: torch.Tensor, tokens: torch.Tensor,
                        tp: Optional[TPGroup]) -> torch.Tensor:
    """This rank's share of an embedding lookup cut by vocabulary over
    ``model``: ``table`` is this rank's ``(V/m, D)`` block (rows
    ``[r*V/m, (r+1)*V/m)``); the rows of the tokens it holds, zeros
    elsewhere, so the sum over ``model`` is every row.  Without a group:
    ``table[tokens]``."""
    if tp is None:
        return table[tokens]
    n = table.shape[0]
    ids = tokens - tp.rank * n
    inside = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))


def vocab_parallel_embedding(table: torch.Tensor, tokens: torch.Tensor,
                             tp: Optional[TPGroup]) -> torch.Tensor:
    """Rows of an embedding table cut by vocabulary over ``model``
    (:func:`vocab_parallel_rows` summed by :func:`reduce_from_model`)."""
    return reduce_from_model(vocab_parallel_rows(table, tokens, tp), tp)


class _VocabParallelNLL(torch.autograd.Function):
    """Forward: ``log(sum exp(x - m)) + m - x[label]`` over the whole
    vocabulary from this rank's columns, in f32: the max (an all-reduce of
    the largest), then the sum of exponentials beside the target logit
    (one all-reduce; the target is 0 on ranks that do not hold it).
    Backward: ``softmax - onehot`` on this rank's columns, times the
    cotangent."""

    @staticmethod
    def forward(ctx, logits, labels, group, start: int):
        x = logits.float()
        n = x.shape[-1]
        m = collectives.all_reduce(x.amax(dim=-1), group, kind=TP_ALL_REDUCE, op="max")
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        ids = labels.long() - start
        inside = (ids >= 0) & (ids < n)
        ids = ids.clamp(0, n - 1)
        tgt = torch.gather(x, -1, ids[..., None])[..., 0]
        tgt = torch.where(inside, tgt, torch.zeros((), dtype=tgt.dtype, device=tgt.device))
        st = collectives.all_reduce(torch.stack([s, tgt]), group, kind=TP_ALL_REDUCE)
        ctx.save_for_backward(logits, m, st[0], ids, inside)
        return torch.log(st[0]) + m - st[1]

    @staticmethod
    def backward(ctx, g):
        logits, m, s, ids, inside = ctx.saved_tensors
        g = g.float()
        p = torch.exp(logits.float() - m[..., None]) / s[..., None]
        grad = p * g[..., None]
        hit = torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))
        grad.scatter_add_(-1, ids[..., None], -hit[..., None])
        return grad.to(logits.dtype), None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       tp: Optional[TPGroup]) -> torch.Tensor:
    """Per-position NLL (f32) from logits whose last dimension is this
    rank's vocabulary block (columns ``[r*V/m, (r+1)*V/m)``).  Without a
    group: ``ops/normalize.py`` ``token_nll``."""
    if tp is None:
        from deepspeed_tpu_torch.ops.normalize import token_nll

        return token_nll(logits, labels)
    return _VocabParallelNLL.apply(logits, labels, tp.group, tp.rank * logits.shape[-1])


def rank_dropout_key(key, tp: Optional[TPGroup]):
    """Attention dropout's key words for this rank's heads: the kernels
    count a keep-bit by the head's place among the heads they see, so each
    ``model`` rank folds its place into the second word and its heads
    draw their own masks."""
    if key is None or tp is None:
        return key
    k0, k1 = key
    return (k0, (int(k1) + 0x9E3779B9 * tp.rank) & 0xFFFFFFFF)
