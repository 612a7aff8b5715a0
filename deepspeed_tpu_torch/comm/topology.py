"""Named-axis cartesian rank grid (counterpart of
``deepspeed_tpu/comm/topology.py``, itself the reference's
``runtime/pipe/topology.py``: ``ProcessTopology`` :12,
``PipeDataParallelTopology`` :235, ``PipeModelDataParallelTopology`` :246).

Pure Python, kept as the JAX package has it.  Here it also maps each
``torch.distributed`` rank to its mesh coordinates and lists the ranks of
every per-axis process group (:func:`deepspeed_tpu_torch.comm.mesh.make_mesh`).
"""
from __future__ import annotations

import itertools
from collections import namedtuple
from typing import Dict, List, Sequence, Tuple


class ProcessTopology:
    """Maps an N-dim cartesian coordinate (named axes) <-> flat rank.

    Axes are ordered outermost-first: ranks increment fastest along the
    *last* axis (same convention as the reference, topology.py:12-46).
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must align")
        self.axes = list(axes)
        self.dims = list(int(d) for d in dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping: Dict[Tuple[int, ...], int] = {}
        for rank, coord in enumerate(itertools.product(*[range(d) for d in self.dims])):
            self.mapping[coord] = rank

    def get_rank(self, **coord_kwargs) -> int:
        if sorted(coord_kwargs.keys()) != sorted(self.axes):
            raise ValueError(f"get_rank() requires all axes {self.axes}")
        key = tuple(coord_kwargs[a] for a in self.axes)
        if key not in self.mapping:
            raise ValueError(f"coord {coord_kwargs} out of range for dims {self.dims}")
        return self.mapping[key]

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_rank_repr(self, rank: int, omit_axes: Sequence[str] = ("data", "pipe"), inner_sep: str = "_", outer_sep: str = "-") -> str:
        omit = set(omit_axes)
        coord = self.get_coord(rank)
        parts = []
        for axis in self.axes:
            if axis in omit:
                continue
            parts.append(f"{axis}{inner_sep}{getattr(coord, axis):02d}")
        return outer_sep.join(parts)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        for coord, r in self.mapping.items():
            if r == rank:
                return self.ProcessCoord(*coord)
        raise ValueError(f"rank {rank} not in topology")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """All rank-lists that vary only along ``axis`` (the reference's
        per-axis process groups, topology.py:131)."""
        if axis not in self.axes:
            return []
        idx = self.axes.index(axis)
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        for other_coords in itertools.product(*[range(self.get_dim(a)) for a in other_axes]):
            ranks = []
            for axis_val in range(self.dims[idx]):
                coord = dict(zip(other_axes, other_coords))
                coord[axis] = axis_val
                ranks.append(self.get_rank(**coord))
            lists.append(ranks)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        def matches(coord):
            return all(getattr(coord, k) == v for k, v in filter_kwargs.items())

        return [rank for coord_t, rank in self.mapping.items() if matches(self.ProcessCoord(*coord_t))]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return self.filter_match(**{axis: idx})

    @property
    def world_size(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """[pipe, data] grid (reference topology.py:235-245): loading batches is
    cheaper than inter-stage comm, so data is the inner (fast) axis."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """[pipe, data, model] grid for 3D parallelism (reference :246-249)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])
