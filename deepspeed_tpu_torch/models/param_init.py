"""A model family's parameter tree, declared once as :class:`LeafSpec`
leaves and drawn either on the host (numpy, the JAX package's stream and
values) or on a device (a seeded ``torch.Generator``, an independent
stream)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf: ``kind`` ``"n"`` a normal(0, ``scale``) draw, ``"z"``
    zeros, ``"o"`` ones; float32 on the host."""

    kind: str
    shape: Tuple[int, ...]
    scale: float = 0.0


def _map(tree: Dict[str, Any], fn: Callable[[str, LeafSpec], Any], prefix: str = ""):
    """``fn(path, spec)`` over every leaf, in the tree's order; paths
    joined by ``/``."""
    return {k: (_map(v, fn, f"{prefix}{k}/") if isinstance(v, dict) else fn(f"{prefix}{k}", v))
            for k, v in tree.items()}


def draw_host(tree: Dict[str, Any], seed: int, first: Sequence[str] = (),
              rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """The tree as float32 numpy arrays from ``np.random.default_rng(seed)``
    (or from ``rng``, part drawn already): the leaves at the paths
    ``first`` are drawn first, then the rest, each in the tree's order (the
    JAX package's ``init_params`` order)."""
    rng = np.random.default_rng(seed) if rng is None else rng

    def make(spec: LeafSpec) -> np.ndarray:
        if spec.kind == "n":
            return (rng.standard_normal(spec.shape) * spec.scale).astype(np.float32)
        return (np.zeros if spec.kind == "z" else np.ones)(spec.shape, np.float32)

    early: Dict[str, np.ndarray] = {}
    _map(tree, lambda path, spec: early.update({path: make(spec)}) if path in first else None)
    return _map(tree, lambda path, spec: early[path] if path in early else make(spec))


def draw_device(tree: Dict[str, Any], seed: int, dtype: torch.dtype, device: Any,
                keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                ) -> Dict[str, Any]:
    """The tree drawn on ``device``, one leaf at a time in the tree's order
    from one seeded generator (a normal draw in f32, then cast to
    ``dtype``).  ``keep(path, leaf)`` (a tensor-parallel rank's cut) sees
    each whole leaf and returns what to keep, so every rank draws the same
    stream and the transient memory is one leaf."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def make(path: str, spec: LeafSpec) -> torch.Tensor:
        if spec.kind == "n":
            t = (torch.randn(spec.shape, generator=g, device=device, dtype=torch.float32)
                 * spec.scale).to(dtype)
        else:
            t = (torch.zeros if spec.kind == "z" else torch.ones)(spec.shape, dtype=dtype,
                                                                  device=device)
        return t if keep is None else keep(path, t)

    return _map(tree, make)
