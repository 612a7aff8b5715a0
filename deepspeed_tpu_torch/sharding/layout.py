"""SpecLayout: canonical axis names and the spec constructors every
engine consumes (counterpart of ``deepspeed_tpu/sharding/layout.py``).

The mesh axes are fixed framework-wide (``sharding/mesh.py`` ``MESH_AXES``):
``pipe``/``data``/``fsdp``/``seq``/``model``/``expert``.  A
:class:`SpecLayout` names them once so engines ask for *meanings*
("the batch spec", "per-rank exchange rows") instead of spelling axis
tuples — the seam the ``hand-built-partition-spec`` lint rule enforces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

from deepspeed_tpu_torch.sharding.spec import PartitionSpec

Axis = str
Axes = Union[Axis, Tuple[Axis, ...]]


@dataclass(frozen=True)
class SpecLayout:
    """Canonical PartitionSpecs over the framework mesh axes."""

    data_axis: Axis = "data"
    fsdp_axis: Axis = "fsdp"
    tp_axis: Axis = "model"
    pipe_axis: Axis = "pipe"
    seq_axis: Axis = "seq"
    expert_axis: Axis = "expert"

    # -- the DP grid ----------------------------------------------------
    @property
    def dp_axes(self) -> Tuple[Axis, Axis]:
        """The full data-parallel grid ZeRO partitions over: the pure
        ``data`` axis composed with the ``fsdp`` axis."""
        return (self.data_axis, self.fsdp_axis)

    # -- activations / batches -----------------------------------------
    def batch(self, ndim: int = 2, seq_dim: Optional[int] = 1, seq_sharded: bool = False) -> PartitionSpec:
        """Batch input: dim 0 over the dp grid, optionally the sequence
        dim over ``seq`` (context parallelism)."""
        spec: list = [None] * ndim
        spec[0] = self.dp_axes
        if seq_sharded and seq_dim is not None and ndim > seq_dim:
            spec[seq_dim] = self.seq_axis
        return PartitionSpec(*spec)

    def stacked_batch(self, ndim: int, seq_sharded: bool = False) -> PartitionSpec:
        """A (gas, micro, ...) stacked batch: replicated gas dim, then
        the normal batch spec."""
        return PartitionSpec(None, *tuple(self.batch(ndim - 1, seq_sharded=seq_sharded)))

    def micro_batch_stack(self, ndim: int = 2) -> PartitionSpec:
        """(M, mb, ...) micro-batch stack inside a pipelined step: the
        micro dim whole, the batch dim over the dp grid."""
        return PartitionSpec(None, self.dp_axes, *([None] * (ndim - 2)))

    # -- per-rank exchange rows ----------------------------------------
    def rows(self, axes: Optional[Axes] = None) -> PartitionSpec:
        """(n, M) per-rank rows sharded one row per rank of ``axes``
        (default: the dp grid) — the explicit-exchange layout."""
        return PartitionSpec(self.dp_axes if axes is None else axes)

    # -- parameters -----------------------------------------------------
    def replicated(self) -> PartitionSpec:
        return PartitionSpec()

    def vocab_embedding(self) -> PartitionSpec:
        """Vocab-parallel embedding table (V, D): vocab over tp."""
        return PartitionSpec(self.tp_axis, None)

    def column_parallel(self, ndim: int = 2) -> PartitionSpec:
        """Megatron column-parallel weight: output dim over tp."""
        return PartitionSpec(*([None] * (ndim - 1) + [self.tp_axis]))

    def row_parallel(self, ndim: int = 2) -> PartitionSpec:
        """Megatron row-parallel weight: input (contracted) dim over tp."""
        return PartitionSpec(*([None] * (ndim - 2) + [self.tp_axis, None]))

    def stacked(self, spec: Optional[PartitionSpec]) -> PartitionSpec:
        """Prepend the pipeline-stacked layer dim to a per-block spec."""
        return PartitionSpec(self.pipe_axis, *(tuple(spec) if spec is not None else ()))

    def fsdp_trailing(self, shape: Sequence[int], fsdp_size: int) -> PartitionSpec:
        """Stacked-block leaf ``(layers, ...)``: shard the largest
        trailing dim divisible by ``fsdp_size`` (the leading stacked dim
        stays whole); replicate when nothing divides — the
        ZeRO-Infinity group-upload layout (the JAX package's
        ``runtime/zero/param_offload.py``)."""
        dims = list(shape)
        if fsdp_size <= 1 or len(dims) < 2:
            return PartitionSpec()
        best = None
        for i in range(len(dims) - 1, 0, -1):
            if dims[i] % fsdp_size == 0 and (best is None or dims[i] > dims[best]):
                best = i
        if best is None:
            return PartitionSpec()
        spec = [None] * len(dims)
        spec[best] = self.fsdp_axis
        return PartitionSpec(*spec)


DEFAULT_LAYOUT = SpecLayout()


# ---------------------------------------------------------------------------
# module-level helpers (the spellings engines import)
# ---------------------------------------------------------------------------

def batch_pspec(ndim: int = 2, seq_dim: Optional[int] = 1, seq_sharded: bool = False) -> PartitionSpec:
    """PartitionSpec for a batch input (see :meth:`SpecLayout.batch`)."""
    return DEFAULT_LAYOUT.batch(ndim, seq_dim=seq_dim, seq_sharded=seq_sharded)


def stacked_batch_pspec(ndim: int, seq_sharded: bool = False) -> PartitionSpec:
    return DEFAULT_LAYOUT.stacked_batch(ndim, seq_sharded=seq_sharded)


def stacked_micro_batch_pspec(ndim: int = 2) -> PartitionSpec:
    return DEFAULT_LAYOUT.micro_batch_stack(ndim)


def dp_rows_spec(axes: Optional[Axes] = None) -> PartitionSpec:
    return DEFAULT_LAYOUT.rows(axes)


def replicated_pspec() -> PartitionSpec:
    return PartitionSpec()


def fsdp_trailing_spec(shape: Sequence[int], fsdp_size: int) -> PartitionSpec:
    return DEFAULT_LAYOUT.fsdp_trailing(shape, fsdp_size)

