"""The port's mesh: named axes over the ranks of a ``torch.distributed``
process group (counterpart of ``deepspeed_tpu/comm/mesh.py``, where one
``jax.sharding.Mesh`` replaces every process group).

Axes, outermost first (``sharding/mesh.py`` ``MESH_AXES``): ``pipe``,
``data``, ``fsdp``, ``seq``, ``model``, ``expert``.  Rank ``r`` sits at
the coordinates of a :class:`~deepspeed_tpu_torch.comm.topology.ProcessTopology`
over those axes (ranks increase fastest along the last axis).  The ranks
that differ only along a set of axes form one process group;
:meth:`Mesh.group` hands out this rank's, built once with
``torch.distributed.new_group`` for every set the engine uses (``data``,
``fsdp``, and both: the data-parallel grid ZeRO partitions over;
``model``, the tensor-parallel group of the Megatron operators
(``parallel/tensor.py``); ``seq``, the ring and the all-to-all of
``parallel/sequence.py``, and the gradients' all-reduce over it;
``expert``, the MoE layer's sum over its experts (``moe/layer.py``);
``pipe``, the pipeline's stage-to-stage transfers and its replicated
leaves' gradient sum (``runtime/pipe/engine.py``)).
:meth:`Mesh.ensure_groups` adds others (LAMB's norms over the axes that
cut a leaf); the step's scalars travel over every rank
(:meth:`Mesh.world_group`).

A spec entry that names several axes (``("fsdp", "data")``) cuts a
dimension fsdp-major; a group's ranks are in global-rank order, which is
data-major, so :meth:`Mesh.chunk_order` gives the reordering a gather
needs.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm.topology import ProcessTopology
from deepspeed_tpu_torch.sharding.mesh import MESH_AXES, resolve_mesh_shape
from deepspeed_tpu_torch.sharding.spec import entry_axes, spec_tuple

# the axis sets whose groups the engine asks for
GROUP_AXES: Tuple[Tuple[str, ...], ...] = (
    ("data",), ("fsdp",), ("data", "fsdp"), ("model",), ("seq",), ("expert",), ("pipe",))


class Mesh:
    """Axis sizes, this rank's coordinates, and its process group for each
    axis set of :data:`GROUP_AXES` that spans more than one rank."""

    def __init__(self, sizes: Dict[str, int], rank: int = 0):
        self.sizes = {ax: int(sizes.get(ax, 1)) for ax in MESH_AXES}
        self.axis_names = MESH_AXES
        self.topology = ProcessTopology(list(MESH_AXES), [self.sizes[a] for a in MESH_AXES])
        self.world_size = self.topology.world_size
        self.rank = int(rank)
        coord = self.topology.get_coord(self.rank)
        self.coords = {ax: int(getattr(coord, ax)) for ax in MESH_AXES}
        self._groups: Dict[frozenset, object] = {}
        self._members: Dict[frozenset, List[int]] = {}

    # -- groups -----------------------------------------------------------
    def _build_groups(self) -> None:
        """Every rank calls ``new_group`` for every group, in one order
        (``torch.distributed``'s rule); each keeps its own."""
        self.ensure_groups(GROUP_AXES)

    def ensure_groups(self, axis_sets: Sequence[Sequence[str]]) -> None:
        """Build this rank's group over each axis set not built yet (its
        axes longer than one rank).  Collective: every rank calls it with
        the same sets in the same order."""
        import torch.distributed as dist

        if self.world_size <= 1:
            return
        for axes in axis_sets:
            axes = tuple(a for a in MESH_AXES if a in axes and self.sizes[a] > 1)
            key = frozenset(axes)
            if not axes or key in self._groups:
                continue
            for ranks in self.group_ranks(axes):
                if len(ranks) == self.world_size:
                    pg = dist.group.WORLD
                else:
                    pg = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[key] = pg
                    self._members[key] = ranks

    def group_ranks(self, axes: Sequence[str]) -> List[List[int]]:
        """The rank lists (each sorted) of every group over ``axes``."""
        others = [a for a in MESH_AXES if a not in axes]
        out = []
        for oc in itertools.product(*[range(self.sizes[a]) for a in others]):
            fixed = dict(zip(others, oc))
            ranks = sorted(self.topology.filter_match(**fixed))
            out.append(ranks)
        return out

    def members(self, axes: Sequence[str]) -> List[int]:
        """The global ranks of this rank's group over ``axes``, in group
        order (a one-rank axis set: this rank alone)."""
        axes = tuple(a for a in axes if self.sizes[a] > 1)
        if not axes:
            return [self.rank]
        return self._members[frozenset(axes)]

    def world_group(self):
        """The group of every rank (None for one rank)."""
        import torch.distributed as dist

        return dist.group.WORLD if self.world_size > 1 else None

    def size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.sizes[a] for a in axes])) if axes else 1

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes`` (None for one rank)."""
        axes = tuple(a for a in axes if self.sizes[a] > 1)
        if not axes:
            return None
        key = frozenset(axes)
        if key not in self._groups:
            raise KeyError(f"no process group over {sorted(axes)} (mesh {self.sizes})")
        return self._groups[key]

    # -- chunk placement ----------------------------------------------------
    def chunk_index(self, axes: Sequence[str]) -> int:
        """This rank's chunk of a dimension cut by ``axes`` (major first)."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def chunk_order(self, axes: Sequence[str]) -> Optional[List[int]]:
        """For a gather over ``axes`` (major first): ``order[c]`` is the
        group rank holding chunk ``c``; None when group order is chunk
        order already."""
        live = tuple(a for a in axes if self.sizes[a] > 1)
        if len(live) <= 1:
            return None
        members = self._members[frozenset(live)]
        pos = {}
        for j, r in enumerate(members):
            c = self.topology.get_coord(r)
            idx = 0
            for a in live:
                idx = idx * self.sizes[a] + int(getattr(c, a))
            pos[idx] = j
        order = [pos[c] for c in range(len(members))]
        return None if order == list(range(len(members))) else order

    def region(self, shape: Sequence[int], spec) -> Tuple[slice, ...]:
        """This rank's block of a leaf of ``shape`` cut by ``spec``."""
        out = []
        for n, entry in zip(shape, spec_tuple(spec, len(shape))):
            axes = entry_axes(entry)
            k = self.size(axes)
            if n % k:
                raise ValueError(f"dim of {n} does not divide over {axes} ({k} ranks)")
            c = self.chunk_index(axes)
            out.append(slice(c * (n // k), (c + 1) * (n // k)))
        return tuple(out)

    def local_block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole tensor ``t``, contiguous."""
        return t[self.region(tuple(t.shape), spec)].contiguous()

    def __repr__(self) -> str:
        shown = {a: s for a, s in self.sizes.items() if s > 1 or a == "data"}
        return f"Mesh({shown}, rank={self.rank})"


def make_mesh(cfg=None, world_size: Optional[int] = None) -> Mesh:
    """The mesh of a ``mesh`` config block (a ``MeshConfig`` or a dict)
    over the started process group (one process when none is started).
    Builds this rank's process groups."""
    from deepspeed_tpu_torch.comm import distributed
    from deepspeed_tpu_torch.config.config import MeshConfig

    if cfg is None:
        cfg = MeshConfig()
    elif isinstance(cfg, dict):
        cfg = MeshConfig.from_dict(cfg)
    world = distributed.get_world_size() if world_size is None else int(world_size)
    sizes = resolve_mesh_shape(cfg, world)
    mesh = Mesh(sizes, rank=distributed.get_rank())
    if world > 1:
        mesh._build_groups()
    return mesh


def inference_mesh(mp_size: int) -> Optional[Mesh]:
    """The serving mesh of ``init_inference(mp_size=M)`` (the JAX engine's
    ``inference/engine.py:205-211``): ``{model: M, data: world // M}`` over
    the started process group, each data replica computing the same
    result.  None without a group, where ``M`` must be 1 (one process, as
    the port served before tensor parallelism)."""
    from deepspeed_tpu_torch.comm import distributed

    m = int(mp_size)
    if m < 1:
        raise ValueError(f"mp_size must be >= 1, got {m}")
    if not distributed.is_initialized():
        if m > 1:
            raise ValueError(
                f"mp_size={m} needs a process group of a multiple of {m} ranks: start one "
                "process per rank under a launcher (RANK, WORLD_SIZE, LOCAL_RANK, "
                "MASTER_ADDR, MASTER_PORT)")
        return None
    world = distributed.get_world_size()
    if world % m:
        raise ValueError(f"mp_size={m} does not divide {world} ranks")
    return make_mesh({"model": m, "data": world // m})


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Axis-size accessors (the reference's grid API,
    ``PipelineParallelGrid.get_*_parallel_world_size``)."""

    sizes: Dict[str, int]

    @classmethod
    def from_mesh(cls, mesh) -> "MeshInfo":
        return cls(sizes=dict(mesh.sizes))

    @property
    def dp_world_size(self) -> int:
        # everything ZeRO partitions over = data × fsdp
        return self.sizes.get("data", 1) * self.sizes.get("fsdp", 1)

    @property
    def fsdp_world_size(self) -> int:
        return self.sizes.get("fsdp", 1)

    @property
    def model_parallel_world_size(self) -> int:
        return self.sizes.get("model", 1)

    @property
    def pipe_parallel_world_size(self) -> int:
        return self.sizes.get("pipe", 1)

    @property
    def seq_parallel_world_size(self) -> int:
        return self.sizes.get("seq", 1)

    @property
    def expert_parallel_world_size(self) -> int:
        return self.sizes.get("expert", 1)

    @property
    def world_size(self) -> int:
        return int(np.prod(list(self.sizes.values())))
