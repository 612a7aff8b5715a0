"""Leaf layouts of a ZeRO engine, and stage 3's gather-on-use.

A :class:`ZeroLayout` holds, for every parameter leaf, the specs of
``runtime/zero/stages.py`` (parameter, gradient, optimizer state) and
moves tensors between them on the port's mesh: :meth:`ZeroLayout.gather`
(an all-gather per dimension whose spec loses axes), :meth:`ZeroLayout.narrow`
(a local sub-block where it gains some), :meth:`ZeroLayout.natural` and
:meth:`ZeroLayout.from_natural` (the whole leaf in its own shape, as
checkpoints and ``engine.params`` hold it).  Leaves of
``ZeroShardingRules.plan_flat`` live as zero-padded 1-D vectors, as in
the JAX engine's state.

**Tensor parallelism.**  A leaf with a ``model`` entry in its specs (the
tensor-parallel base spec, ``LeafLayout.tp_spec``) is held by each
``model`` rank as its block of that spec: the block the model computes
with, never gathered in the step (stage 3 gathers over ``fsdp`` only, up
to the block).  The fused ``q|k|v`` leaves (``sharding/rules.py``
``fused_tp_parts``) are stored head-grouped: their last dimension is
permuted so that a contiguous cut gives rank ``r`` ``[q_r | k_r | v_r]``,
the columns of its own heads.  ``natural``/``from_natural`` undo and
apply the permutation, so checkpoints and ``engine.params`` keep the
natural layout and a tag loads at any ``model`` size (ROADMAP C4: a
rank's block of ``qkv`` is not the block JAX's ``NamedSharding`` gives).

Stage 3 hands the model a :class:`ShardedLeaf` for each sharded leaf
instead of a tensor.  The model calls :func:`materialize` where it uses
one: the leaf is all-gathered in the compute type (once per forward: the
tied embedding serves the embedding and the head), and the gather's
backward reduces the gradient to this rank's shard (the data-axis
all-reduce, then the fsdp reduce-scatter).  A stacked block leaf
``(layers, ...)`` gives per-layer handles (:func:`unstack`), gathered
inside the block's checkpoint region: the recompute gathers them again
and they are freed after the block.  Outside checkpoint regions the
gathered weights are not kept for the backward: saved-tensor hooks store
a token in their place, and the first token the backward unpacks gathers
its group (all the leaves gathered outside blocks, or one block's)
again.  So every sharded leaf is gathered once in the forward and once
in the backward of each micro-step — ``zero_step_comm_model``'s
``2 * n_params * param_bytes`` — and the whole tree is never gathered at
once.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.sharding.spec import entry_axes, spec_tuple


@dataclasses.dataclass
class LeafLayout:
    """One leaf: its path, its natural shape, the flat plan entry ``(n,
    padded)`` or None, the shape it is stored in (natural, or
    ``(padded,)``), and its specs over that shape.  ``acc_spec`` is the
    gradient accumulator's: the gradient spec, or the parameter spec where
    stage 3 shards a parameter whose gradient spec is replicated
    (``reduce_scatter: false``)."""

    path: str
    shape: Tuple[int, ...]
    flat: Optional[Tuple[int, int]]
    state_shape: Tuple[int, ...]
    param_spec: tuple
    grad_spec: tuple
    opt_spec: tuple
    acc_spec: tuple
    # the tensor-parallel base spec (the param spec's model entries) and,
    # for a fused leaf cut over model, its number of packed parts
    tp_spec: tuple = ()
    parts: int = 1

    @property
    def numel(self) -> int:
        n = 1
        for s in self.state_shape:
            n *= s
        return n


# axes whose ranks each hold their own block of a leaf, never gathered in
# the step: ``model`` (tensor parallelism), ``expert`` (a MoE layer's
# experts) and ``pipe`` (a pipeline stage's layers)
HELD_AXES = ("pipe", "model", "expert")


def _sharded(mesh, spec, skip: Sequence[str] = ()) -> bool:
    return any(mesh.size([a for a in entry_axes(e) if a not in skip]) > 1 for e in spec)


def _held_only(spec) -> tuple:
    """A spec's entries over the held axes alone (the block a rank keeps)."""
    out = []
    for e in spec:
        axes = tuple(a for a in entry_axes(e) if a in HELD_AXES)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def _group_parts(t: torch.Tensor, parts: int, ranks: int, inverse: bool = False) -> torch.Tensor:
    """The last dimension ``[part][rank][c]`` reordered ``[rank][part][c]``
    (``inverse``: back)."""
    n = t.shape[-1]
    c = n // (parts * ranks)
    a, b = (ranks, parts) if inverse else (parts, ranks)
    return t.reshape(*t.shape[:-1], a, b, c).transpose(-3, -2).reshape(t.shape)


class ZeroLayout:
    """The specs of every leaf on one mesh, and the moves between them."""

    def __init__(self, mesh, rules, shapes: Sequence[Tuple[int, ...]], paths: Sequence[str]):
        from deepspeed_tpu_torch.sharding.rules import fused_tp_parts

        self.mesh = mesh
        self.rules = rules
        plan = rules.plan_flat(_shape_tree(paths, shapes))
        self.leaves: List[LeafLayout] = []
        for path, shape in zip(paths, shapes):
            shape = tuple(int(s) for s in shape)
            flat = None
            state_shape = shape
            if path in plan:
                _, n, padded = plan[path]
                flat, state_shape = (n, padded), (padded,)
            nd = len(state_shape)
            ps = spec_tuple(rules.param_spec(path, state_shape), nd)
            gs = spec_tuple(rules.grad_spec(path, state_shape), nd)
            os_ = spec_tuple(rules.opt_spec(path, state_shape), nd)
            # model cuts the three specs alike; the stage's own axes decide
            acc = ps if (_sharded(mesh, ps, skip=HELD_AXES)
                         and not _sharded(mesh, gs, skip=HELD_AXES)) else gs
            tp = _held_only(ps)
            parts = 1
            if nd and tp[-1] == "model" and mesh.sizes["model"] > 1:
                parts = fused_tp_parts(path)
            self.leaves.append(LeafLayout(path, shape, flat, state_shape, ps, gs, os_, acc,
                                          tp, parts))

    # -- predicates ---------------------------------------------------------
    def sharded(self, spec) -> bool:
        return _sharded(self.mesh, spec)

    def param_sharded(self, i: int) -> bool:
        """Whether stage 3 shards the parameter (over axes other than
        ``model``): the model gathers it on use."""
        return _sharded(self.mesh, self.leaves[i].param_spec, skip=HELD_AXES)

    def tp_sharded(self, i: int) -> bool:
        """Whether each ``model`` (``expert``, ``pipe``) rank holds its own
        block of the leaf."""
        return self.sharded(self.leaves[i].tp_spec)

    def local_numel(self, i: int) -> int:
        """Elements of leaf ``i``'s held block (its stored size where no
        held axis cuts it)."""
        leaf = self.leaves[i]
        cut = 1
        for e in leaf.tp_spec:
            cut *= self.mesh.size(entry_axes(e))
        return leaf.numel // cut

    def update_sharded(self, i: int) -> bool:
        """Whether the optimizer state is cut finer than the parameter."""
        leaf = self.leaves[i]
        return tuple(map(entry_axes, leaf.opt_spec)) != tuple(map(entry_axes, leaf.param_spec))

    def update_owner(self, i: int) -> bool:
        """Whether this rank counts leaf ``i``'s update slice in the global
        gradient norm: each element once, on the rank at coordinate 0 of
        every data-parallel axis that does not cut it."""
        cut = {a for e in self.leaves[i].opt_spec for a in entry_axes(e)}
        return all(self.mesh.coords[a] == 0
                   for a in ("pipe", "data", "fsdp", "seq", "model", "expert") if a not in cut)

    def update_axes(self, i: int) -> Tuple[str, ...]:
        """The axes that cut leaf ``i``'s optimizer state (LAMB's norms sum
        over them)."""
        cut = []
        for e in self.leaves[i].opt_spec:
            cut.extend(a for a in entry_axes(e) if self.mesh.sizes[a] > 1)
        return tuple(a for a in ("pipe", "data", "fsdp", "model", "expert") if a in cut)

    # -- moves ----------------------------------------------------------------
    def _slices(self, shape: Sequence[int], from_spec, to_spec) -> List[slice]:
        """Each dimension's slice of :meth:`narrow`."""
        idx = []
        for n, fe, te in zip(shape, spec_tuple(from_spec, len(shape)),
                             spec_tuple(to_spec, len(shape))):
            fa, ta = entry_axes(fe), entry_axes(te)
            kf, kt = self.mesh.size(fa), self.mesh.size(ta)
            off = self.mesh.chunk_index(ta) * (n // kt) - self.mesh.chunk_index(fa) * (n // kf)
            idx.append(slice(off, off + n // kt))
        return idx

    def narrow(self, t: torch.Tensor, shape: Sequence[int], from_spec, to_spec) -> torch.Tensor:
        """This rank's block of ``to_spec`` out of its block ``t`` of
        ``from_spec`` (``to_spec`` cuts each dimension by ``from_spec``'s
        axes and then more); a view."""
        return t[tuple(self._slices(shape, from_spec, to_spec))]

    def gather(self, t: torch.Tensor, from_spec, to_spec, kind: str) -> torch.Tensor:
        """This rank's block of ``to_spec`` from its block ``t`` of
        ``from_spec`` (``from_spec`` cuts each dimension by ``to_spec``'s
        axes and then more): one all-gather per dimension that loses
        axes, counted under ``kind``."""
        nd = t.dim()
        for d, (fe, te) in enumerate(zip(spec_tuple(from_spec, nd), spec_tuple(to_spec, nd))):
            fa, ta = entry_axes(fe), entry_axes(te)
            extra = tuple(a for a in fa[len(ta):] if self.mesh.sizes[a] > 1)
            if extra:
                t = collectives.all_gather(t, self.mesh.group(extra), dim=d, kind=kind,
                                           order=self.mesh.chunk_order(extra))
        return t

    def to_state(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """A natural-shape tensor in the leaf's stored shape (flattened and
        zero-padded for a flat leaf)."""
        leaf = self.leaves[i]
        if leaf.flat is None:
            return full
        n, padded = leaf.flat
        flat = full.reshape(-1)
        return torch.cat([flat, flat.new_zeros(padded - n)]) if padded > n else flat

    def from_state(self, i: int, t: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves[i]
        if leaf.flat is None:
            return t
        n, _ = leaf.flat
        return t[:n].reshape(leaf.shape)

    def natural(self, i: int, t: torch.Tensor, spec, kind: str = "checkpoint") -> torch.Tensor:
        """The whole leaf in its natural shape from this rank's block ``t``
        of ``spec`` (a collective where ``spec`` cuts the leaf: call on
        every rank)."""
        whole = self.gather(t, spec, (), kind)
        parts = self.leaves[i].parts
        if parts > 1:
            whole = _group_parts(whole, parts, self.mesh.sizes["model"], inverse=True)
        return self.from_state(i, whole)

    def from_natural(self, i: int, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``spec`` from the whole natural leaf."""
        state = self.to_state(i, full)
        parts = self.leaves[i].parts
        if parts > 1:
            state = _group_parts(state, parts, self.mesh.sizes["model"])
        return self.narrow(state, self.leaves[i].state_shape, (), spec)

    def natural_index(self, i: int, spec) -> List[torch.Tensor]:
        """Where this rank's block of ``spec`` sits in the natural leaf,
        without building it: one int64 vector a dimension of the block,
        whose sum over the dimensions (broadcast) is each element's flat
        index in the natural leaf -- :meth:`from_natural` of
        ``arange(numel)`` -- and, in a flat leaf's padding, an index of at
        least the leaf's size."""
        leaf = self.leaves[i]
        shape = leaf.state_shape
        out, stride = [], 1
        for d in range(len(shape) - 1, -1, -1):
            idx = torch.arange(shape[d], dtype=torch.int64)
            if d == len(shape) - 1 and leaf.parts > 1:
                idx = _group_parts(idx, leaf.parts, self.mesh.sizes["model"])
            out.append(idx * stride)
            stride *= shape[d]
        out.reverse()
        return [t[s] for t, s in zip(out, self._slices(shape, (), spec))]

    # -- gradients ------------------------------------------------------------
    def reduce_grad(self, i: int, g: torch.Tensor) -> torch.Tensor:
        """One micro-step's gradient of leaf ``i`` (its tensor-parallel
        block in the stored shape, f32), summed over the data-parallel grid
        into the accumulator's spec: the all-reduce over ``seq``
        (``seq-grad-exchange``), the all-reduce over ``data``
        (``grad-exchange``), then the reduce-scatter over ``fsdp`` where the
        spec cuts the leaf, else the all-reduce over ``fsdp``."""
        return self.reduce_leaf(self.leaves[i], g)

    def reduce_leaf(self, leaf: LeafLayout, g: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if mesh.sizes["seq"] > 1:
            # each seq rank saw other positions: sum their gradients first
            g = collectives.all_reduce(g, mesh.group(("seq",)), kind="seq-grad-exchange")
        if mesh.sizes["data"] > 1:
            g = collectives.all_reduce(g, mesh.group(("data",)), kind="grad-exchange")
        if mesh.sizes["fsdp"] > 1:
            dims = [d for d, e in enumerate(leaf.acc_spec) if "fsdp" in entry_axes(e)]
            if dims and _sharded(mesh, leaf.grad_spec, skip=HELD_AXES):
                g = collectives.reduce_scatter(g, mesh.group(("fsdp",)), dim=dims[0])
            else:
                g = collectives.all_reduce(g, mesh.group(("fsdp",)))
                if dims:  # stage 3 without reduce_scatter: keep the shard
                    g = self.narrow(g, leaf.state_shape, (), leaf.acc_spec).contiguous()
        return g


def _shape_tree(paths: Sequence[str], shapes: Sequence[Tuple[int, ...]]) -> Dict[str, Any]:
    """A flat {path: shape-carrier} tree for ``plan_flat`` (it reads paths
    and shapes only)."""
    return {p: _Shape(s) for p, s in zip(paths, shapes)}


class _Shape:
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)


# ---------------------------------------------------------------------------
# stage 3: gather on use
# ---------------------------------------------------------------------------

class _GatherFn(torch.autograd.Function):
    """All-gather a shard into the whole leaf (compute type) in the
    forward; reduce the whole gradient to the shard (f32) in the
    backward."""

    @staticmethod
    def forward(ctx, shard, gather, reduce):
        ctx.reduce = reduce
        return gather(shard.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g), None, None


class _Token:
    __slots__ = ("group", "member", "size", "stride", "offset")

    def __init__(self, group, member, t):
        self.group, self.member = group, member
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class Stage3Context:
    """One micro-step's gathers for a stage-3 engine: the handles the
    model receives, the once-per-forward cache, and the saved-tensor
    hooks that gather again in the backward."""

    def __init__(self, layout: ZeroLayout, masters: Sequence[torch.Tensor], dtype: torch.dtype,
                 local=None):
        """``local(i, layer, g)``: where each rank keeps its own gradients
        (the engine's explicit exchanges), the gather's backward hands it
        leaf ``i``'s whole f32 gradient (of one layer of a stacked leaf,
        ``layer`` set) unreduced instead of reducing it to the shard."""
        self.layout, self.masters, self.dtype = layout, masters, dtype
        self.local = local
        self._full: Dict[int, torch.Tensor] = {}
        # storage address -> (weakref to the gathered tensor, group, member)
        self._live: Dict[int, Tuple[Any, Any, Any]] = {}
        self._groups: Dict[Any, List[Any]] = {}
        self._layer_shards: Dict[Tuple[int, int], torch.Tensor] = {}
        self._regathered: Dict[Any, Dict[Any, torch.Tensor]] = {}

    # -- the model's handles ----------------------------------------------------
    def leaf(self, i: int) -> "ShardedLeaf":
        return ShardedLeaf(self, i)

    def _gather_fn(self, i: int, dim_offset: int = 0):
        leaf = self.layout.leaves[i]
        spec, to = leaf.param_spec[dim_offset:], leaf.tp_spec[dim_offset:]

        def gather(shard):
            # over fsdp only: up to the rank's tensor-parallel block
            full = self.layout.gather(shard.to(self.dtype), spec, to, "all-gather")
            return self.layout.from_state(i, full) if dim_offset == 0 else full

        return gather

    def _reduce_fn(self, i: int, dim_offset: int = 0, layer: Optional[int] = None):
        layout, leaf = self.layout, self.layout.leaves[i]

        def reduce(g):
            g = g.float()
            if self.local is not None:
                self.local(i, layer, layout.to_state(i, g.contiguous()) if dim_offset == 0 else g)
                return None
            if dim_offset == 0:
                g = layout.to_state(i, g.contiguous())
                return layout.reduce_grad(i, g)
            # one layer of a stacked leaf: the same reduction on its slice
            sub = LeafLayout(leaf.path, leaf.shape[1:], None, leaf.state_shape[1:],
                             leaf.param_spec[1:], leaf.grad_spec[1:], leaf.opt_spec[1:],
                             leaf.acc_spec[1:], leaf.tp_spec[1:])
            return layout.reduce_leaf(sub, g.contiguous())

        return reduce

    def full(self, i: int) -> torch.Tensor:
        """Leaf ``i`` whole, in the compute type: gathered once per forward."""
        if i not in self._full:
            t = _GatherFn.apply(self.masters[i], self._gather_fn(i), self._reduce_fn(i))
            self._register(t, "outer", ("full", i))
            self._full[i] = t
        return self._full[i]

    def layer(self, i: int, shard_l: torch.Tensor, l: int) -> torch.Tensor:
        """Layer ``l`` of stacked leaf ``i`` whole, from its shard slice."""
        t = _GatherFn.apply(shard_l, self._gather_fn(i, 1), self._reduce_fn(i, 1, l))
        if (i, l) not in self._layer_shards:  # a recompute gathers again, once
            self._layer_shards[(i, l)] = shard_l
            self._register(t, ("layer", l), ("layer", i, l))
        return t

    def end_forward(self) -> None:
        """Drop the forward's gathered leaves: the backward gathers them
        again where it needs them."""
        self._full.clear()

    # -- the backward's second gather --------------------------------------------
    def _register(self, t: torch.Tensor, group, member) -> None:
        self._live[t.untyped_storage().data_ptr()] = (weakref.ref(t), group, member)
        self._groups.setdefault(group, []).append(member)

    def pack(self, t: torch.Tensor):
        ent = self._live.get(t.untyped_storage().data_ptr()) if t.layout == torch.strided else None
        if ent is None or ent[0]() is None or t.dtype != self.dtype:
            return t
        return _Token(ent[1], ent[2], t)

    def unpack(self, x):
        if not isinstance(x, _Token):
            return x
        cache = self._regathered.get(x.group)
        if cache is None:
            cache = {}
            with torch.no_grad():
                for member in self._groups[x.group]:
                    if member[0] == "full":
                        i = member[1]
                        cache[member] = self._gather_fn(i)(self.masters[i].detach())
                    else:
                        _, i, l = member
                        cache[member] = self._gather_fn(i, 1)(self._layer_shards[(i, l)].detach())
            self._regathered[x.group] = cache
        return cache[x.member].as_strided(x.size, x.stride, x.offset)

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)


class ShardedLeaf:
    """What a stage-3 model receives for a sharded leaf: :func:`materialize`
    gathers it, :func:`unstack` cuts a stacked block leaf into per-layer
    handles."""

    __slots__ = ("ctx", "i")

    def __init__(self, ctx: Stage3Context, i: int):
        self.ctx, self.i = ctx, i

    @property
    def dtype(self) -> torch.dtype:
        return self.ctx.dtype

    @property
    def shape(self) -> torch.Size:
        """The shape :func:`materialize` gives: the leaf's tensor-parallel
        block."""
        layout, leaf = self.ctx.layout, self.ctx.layout.leaves[self.i]
        return torch.Size(n // layout.mesh.size(entry_axes(e))
                          for n, e in zip(leaf.shape, leaf.tp_spec))

    def layers(self) -> List[Any]:
        leaf = self.ctx.layout.leaves[self.i]
        if leaf.flat is not None or entry_axes(leaf.param_spec[0]):
            # no per-layer cut (flat, or the layer dim itself is sharded):
            # the whole leaf, gathered once per forward
            return list(self.ctx.full(self.i).unbind(0))
        shards = self.ctx.masters[self.i].unbind(0)
        return [LayerShard(self.ctx, self.i, s, l) for l, s in enumerate(shards)]


class LayerShard:
    """One layer of a stacked sharded leaf, gathered by :func:`materialize`
    (inside the block, so a recompute gathers it again)."""

    __slots__ = ("ctx", "i", "shard", "l")

    def __init__(self, ctx, i, shard, l):
        self.ctx, self.i, self.shard, self.l = ctx, i, shard, l


def materialize(x: Any) -> Any:
    """A tensor as it is; a stage-3 handle gathered whole."""
    if isinstance(x, ShardedLeaf):
        return x.ctx.full(x.i)
    if isinstance(x, LayerShard):
        return x.ctx.layer(x.i, x.shard, x.l)
    return x


def unstack(x: Any) -> List[Any]:
    """The per-layer entries of a stacked block leaf: ``x.unbind(0)`` for a
    tensor, per-layer handles for a stage-3 leaf."""
    if isinstance(x, ShardedLeaf):
        return x.layers()
    return list(x.unbind(0))
