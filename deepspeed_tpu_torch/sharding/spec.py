"""The port's ``PartitionSpec``: one entry per dimension of a leaf, each
None (the dimension is whole on every rank), an axis name (``"fsdp"``) or
a tuple of axis names, major first (``("fsdp", "data")``: the dimension is
cut into ``fsdp * data`` chunks, chunk ``f * data + d`` on the rank at
``fsdp = f, data = d``).

It stands for ``jax.sharding.PartitionSpec``: a tuple of those entries,
built as ``PartitionSpec(None, "fsdp")``, equal to a plain tuple of the
same entries.  Trailing entries may be left out, as in JAX."""
from __future__ import annotations

from typing import Any, Optional, Tuple


class PartitionSpec(tuple):
    """A tuple of per-dimension entries (None, an axis name, or a tuple
    of axis names)."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def entry_axes(entry: Any) -> Tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_tuple(spec: Optional[tuple], ndim: int) -> Tuple[Any, ...]:
    """Normalize a PartitionSpec to a full-length tuple."""
    if spec is None:
        return (None,) * ndim
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))
