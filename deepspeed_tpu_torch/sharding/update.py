"""Cross-replica weight-update sharding (arXiv:2004.13336) plus the
axis-placement primitives the ZeRO rule layer builds specs from
(counterpart of ``deepspeed_tpu/sharding/update.py``; the spec algebra
is the JAX package's, on the port's own :class:`PartitionSpec`).

The paper's observation: in data-parallel training the gradients are
all-reduced dense, but the *weight update* (optimizer math over the
full parameter/moment set) is embarrassingly shardable — annotate the
optimizer state sharded across replicas and each replica computes its
1/dp slice of the update, then all-gathers the updated parameters once
(the port's engine does both explicitly, ``runtime/engine.py``).  Per-replica update FLOPs and optimizer-state bytes
drop ~dp× for one params-sized all-gather per step; the loss trajectory
is unchanged (the math is elementwise).  Here it is the DEFAULT at
``zero_optimization.stage >= 1``: the ``fsdp`` axis shards state as
before, and the pure ``data`` axis — replicated in classic ZeRO —
joins the update sharding (``zero_optimization.cross_replica_weight_update``,
on by default; zero/stages.py consumes these primitives).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.sharding.spec import PartitionSpec, spec_tuple
from deepspeed_tpu_torch.sharding.spec import entry_axes as _entry_axes

__all__ = ["spec_tuple", "add_mesh_axis", "add_update_axis", "weight_update_model",
           "ADAM_FLOPS_PER_PARAM"]


def add_mesh_axis(
    shape: Sequence[int],
    base_spec: Optional[PartitionSpec],
    axis: str,
    size: int,
    min_size: int = 0,
) -> PartitionSpec:
    """Add one mesh axis to a leaf's PartitionSpec: the largest dim that
    (a) is not already sharded and (b) is divisible by ``size``.  Leaves
    smaller than ``min_size`` elements (the ZeRO-3 persistence
    threshold) or with no divisible dim stay as-is (replicated over the
    axis)."""
    ndim = len(shape)
    base = spec_tuple(base_spec, ndim)
    if size <= 1:
        return PartitionSpec(*base)
    if int(np.prod(shape)) < max(min_size, 1) and min_size > 0:
        return PartitionSpec(*base)
    candidates = [
        (shape[i], i)
        for i in range(ndim)
        if base[i] is None and shape[i] % size == 0 and shape[i] >= size
    ]
    if not candidates:
        return PartitionSpec(*base)
    _, dim = max(candidates)
    new = list(base)
    new[dim] = axis
    return PartitionSpec(*new)


def add_update_axis(
    shape: Sequence[int],
    spec: PartitionSpec,
    data_axis: str,
    data_size: int,
    fsdp_axis: str = "fsdp",
    fsdp_size: int = 1,
) -> PartitionSpec:
    """Extend an (already fsdp-placed) optimizer-state spec across the
    pure data axis — the cross-replica weight-update placement.

    Preference order: extend the fsdp-carrying dim to
    ``(fsdp, data)`` (fsdp-major, so each data-rank's slice is a
    sub-block of the grad reduce-scatter shard it already holds —
    no resharding comm); else place ``data`` alone on the largest
    still-free dim divisible by ``data_size``; else leave the spec
    as-is (the leaf's update stays replicated over data)."""
    ndim = len(shape)
    base = spec_tuple(spec, ndim)
    if data_size <= 1:
        return PartitionSpec(*base)
    for i in range(ndim):
        axes = _entry_axes(base[i])
        if fsdp_axis in axes and data_axis not in axes:
            if shape[i] % (fsdp_size * data_size) == 0:
                new = list(base)
                new[i] = tuple(axes) + (data_axis,)
                return PartitionSpec(*new)
    return add_mesh_axis(shape, PartitionSpec(*base), data_axis, data_size)


# ---------------------------------------------------------------------------
# update-phase byte/FLOP model
# ---------------------------------------------------------------------------

# First-order FLOPs of one Adam(W) update per parameter (ema m, ema v,
# sqrt, divide, weight decay, axpy) — the constant cancels in ratios;
# it exists so absolute numbers in reports are honest about units.
ADAM_FLOPS_PER_PARAM = 12


def weight_update_model(
    n_params: int,
    dp: int,
    sharded: bool = True,
    state_slots: int = 2,
    state_bytes: int = 4,
    master_bytes: int = 4,
) -> Dict[str, Any]:
    """Per-replica cost of the optimizer-update phase under replicated
    vs cross-replica-sharded weight updates (arXiv:2004.13336 §3).

    ``state_slots``: params-shaped optimizer-state mirrors (Adam: m+v).
    Returns per-replica update FLOPs, optimizer-state bytes, and the
    update all-gather wire bytes (sharded pays one params-sized gather
    of the updated values; replicated pays none)."""
    shard = max(1, dp) if sharded else 1
    return {
        "dp": dp,
        "sharded": bool(sharded),
        "update_flops_per_replica": ADAM_FLOPS_PER_PARAM * n_params // shard,
        "opt_state_bytes_per_replica": state_slots * state_bytes * n_params // shard,
        "update_allgather_bytes": master_bytes * n_params if (sharded and dp > 1) else 0,
    }
