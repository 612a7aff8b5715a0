"""Mesh shapes and their link topology (counterpart of
``deepspeed_tpu/sharding/mesh.py``).

:func:`resolve_mesh_shape` fills in the ``-1`` axis of a ``mesh`` config
block from the world size and checks the product, as in the JAX package.
:func:`build_mesh` builds the port's mesh over the started
``torch.distributed`` process group (:mod:`deepspeed_tpu_torch.comm.mesh`)
and returns its :class:`MeshTopology`.  The ICI/DCN split of the JAX
package names a TPU's fast in-slice links and its slow links between
slices; the port runs on one host, so every mesh is
:meth:`MeshTopology.single_slice` (its queries stay, for the comm
layer's policy table).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

# Canonical axis order: outermost (slowest-varying, most DCN-tolerant)
# first.  pipe and data tolerate slower links; model/seq need the
# fastest ICI, so they are innermost (adjacent device ids share a
# physical link on TPU slices).
MESH_AXES: Tuple[str, ...] = ("pipe", "data", "fsdp", "seq", "model", "expert")

LINK_ICI = "ici"
LINK_DCN = "dcn"
LINK_MIXED = "ici+dcn"


def resolve_mesh_shape(cfg, n_devices: int) -> Dict[str, int]:
    """Fill in the -1 ("remaining") axis and validate the product."""
    sizes = {ax: int(getattr(cfg, ax)) for ax in MESH_AXES}
    free = [ax for ax, s in sizes.items() if s == -1]
    if len(free) > 1:
        raise ValueError(f"At most one mesh axis may be -1, got {free}")
    fixed = 1
    for ax, s in sizes.items():
        if s != -1:
            if s < 1:
                raise ValueError(f"mesh axis {ax} must be >=1 or -1, got {s}")
            fixed *= s
    if free:
        rem, mod = divmod(n_devices, fixed)
        if mod:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
        sizes[free[0]] = rem
    total = int(np.prod(list(sizes.values())))
    if total != n_devices:
        raise ValueError(f"Mesh {sizes} covers {total} devices but {n_devices} are available")
    return sizes


def split_dcn_ici(sizes: Dict[str, int], n_granules: int) -> Optional[Tuple[Dict[str, int], Dict[str, int]]]:
    """Factor each axis into (DCN, ICI) parts: the granule count is
    absorbed by the outermost (most DCN-tolerant) axes first — ``pipe``
    and ``data`` ride the slow inter-granule links, while
    ``model``/``seq`` stay inside a granule's ICI domain.  Returns
    ``(dcn_sizes, ici_sizes)`` or None when the granule count cannot be
    factored into the axis sizes."""
    dcn = {ax: 1 for ax in sizes}
    ici = dict(sizes)
    left = n_granules
    # outermost first; tolerate meshes missing some canonical axes
    order = [ax for ax in MESH_AXES if ax in ici] + [ax for ax in ici if ax not in MESH_AXES]
    for ax in order:
        if left == 1:
            break
        f = math.gcd(left, ici[ax])
        # absorb the largest factor of `left` that divides this axis
        while f > 1 and left % f == 0 and ici[ax] % f == 0:
            dcn[ax] *= f
            ici[ax] //= f
            left //= f
            f = math.gcd(left, ici[ax])
    return None if left != 1 else (dcn, ici)


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Per-axis ICI/DCN factoring of a device mesh — the topology
    descriptor layout and comm decisions key on."""

    sizes: Dict[str, int]
    dcn: Dict[str, int]
    ici: Dict[str, int]

    @classmethod
    def single_slice(cls, sizes: Dict[str, int]) -> "MeshTopology":
        return cls(sizes=dict(sizes), dcn={ax: 1 for ax in sizes}, ici=dict(sizes))

    @property
    def num_slices(self) -> int:
        return int(np.prod(list(self.dcn.values())))

    @property
    def slice_devices(self) -> int:
        return int(np.prod(list(self.ici.values())))

    def link(self, axis: str) -> str:
        """The link kind an exchange over ``axis`` rides: ``ici`` (all
        inside one slice), ``dcn`` (every hop crosses slices), or
        ``ici+dcn`` (a 2-level hierarchy)."""
        d, i = self.dcn.get(axis, 1), self.ici.get(axis, 1)
        if d > 1 and i > 1:
            return LINK_MIXED
        if d > 1:
            return LINK_DCN
        return LINK_ICI

    def crosses_dcn(self, axes) -> bool:
        names = axes if isinstance(axes, (tuple, list)) else (axes,)
        return any(self.dcn.get(a, 1) > 1 for a in names)

    def dcn_ranks(self, axes) -> int:
        names = axes if isinstance(axes, (tuple, list)) else (axes,)
        return int(np.prod([self.dcn.get(a, 1) for a in names]))

    def ici_ranks(self, axes) -> int:
        names = axes if isinstance(axes, (tuple, list)) else (axes,)
        return int(np.prod([self.ici.get(a, 1) for a in names]))

    def describe(self) -> str:
        if self.num_slices <= 1:
            return "single slice (all-ICI)"
        dcn = "×".join(str(self.dcn[ax]) for ax in MESH_AXES if ax in self.dcn)
        ici = "×".join(str(self.ici[ax]) for ax in MESH_AXES if ax in self.ici)
        return f"{self.num_slices} slices: dcn={dcn} ici={ici}"


def build_mesh(cfg=None, world_size: Optional[int] = None):
    """The port's mesh over the started process group (or one process
    when none is started), and its single-slice topology: ``(mesh,
    topology)``."""
    from deepspeed_tpu_torch.comm.mesh import make_mesh

    mesh = make_mesh(cfg, world_size=world_size)
    return mesh, MeshTopology.single_slice(mesh.sizes)
