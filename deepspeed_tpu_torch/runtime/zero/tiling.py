"""TiledLinear (counterpart of ``deepspeed_tpu/runtime/zero/tiling.py``).

A linear split into ``in_splits x out_splits`` tiles, each a parameter of
its own (``tile_{i}_{j}_w`` of shape ``(in_i, out_j)`` and ``bias_{j}``),
so ZeRO's rules cut and gather each tile apart.  ``x @ W + b`` is
contracted tile by tile; the tiles hold the same values as the JAX
package's from the same seed.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn


def split_dim(total: int, splits: int) -> List[int]:
    """Near-even split sizes, the larger ones first."""
    base, rem = divmod(total, splits)
    return [base + (1 if i < rem else 0) for i in range(splits)]


def init_tiled_linear(in_features: int, out_features: int, in_splits: int = 1,
                      out_splits: int = 1, bias: bool = True, seed: int = 0,
                      std: float = 0.02) -> Dict[str, np.ndarray]:
    """The tiles as numpy arrays, drawn as the JAX package draws them:
    ``tile_{i}_{j}_w`` normal(std), ``bias_{j}`` zeros."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for i, ni in enumerate(split_dim(in_features, in_splits)):
        for j, nj in enumerate(split_dim(out_features, out_splits)):
            params[f"tile_{i}_{j}_w"] = (rng.standard_normal((ni, nj)) * std).astype(np.float32)
    if bias:
        for j, nj in enumerate(split_dim(out_features, out_splits)):
            params[f"bias_{j}"] = np.zeros(nj, np.float32)
    return params


def tiled_linear(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` tile by tile (the tiling read from the keys and
    shapes): for each output tile the input tiles' products summed in
    order, plus its bias."""
    tiles = [k.split("_") for k in params if k.startswith("tile_")]
    in_splits = 1 + max(int(t[1]) for t in tiles)
    out_splits = 1 + max(int(t[2]) for t in tiles)
    offsets = np.cumsum([0] + [params[f"tile_{i}_0_w"].shape[0] for i in range(in_splits)])
    outs = []
    for j in range(out_splits):
        acc = None
        for i in range(in_splits):
            part = x[..., offsets[i]:offsets[i + 1]] @ params[f"tile_{i}_{j}_w"].to(x.dtype)
            acc = part if acc is None else acc + part
        if f"bias_{j}" in params:
            acc = acc + params[f"bias_{j}"].to(acc.dtype)
        outs.append(acc)
    return torch.cat(outs, dim=-1)


class TiledLinear(nn.Module):
    """A linear layer kept as tiles (one ``nn.Parameter`` a tile)."""

    def __init__(self, in_features: int, out_features: int, in_splits: int = 1,
                 out_splits: int = 1, bias: bool = True, seed: int = 0,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if in_splits < 1 or out_splits < 1:
            raise ValueError("in_splits/out_splits must be >= 1")
        self.in_features, self.out_features = in_features, out_features
        self.in_splits, self.out_splits = in_splits, out_splits
        init = init_tiled_linear(in_features, out_features, in_splits, out_splits, bias=bias,
                                 seed=seed)
        self.tiles = nn.ParameterDict({
            k: nn.Parameter(torch.tensor(v, dtype=dtype, device=device)) for k, v in init.items()})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tiled_linear(dict(self.tiles), x)

    @torch.no_grad()
    def copy_params_from(self, weight, bias: Optional[torch.Tensor] = None) -> None:
        """Load the tiles from a dense ``(in, out)`` weight (and bias)."""
        weight = torch.as_tensor(weight)
        if tuple(weight.shape) != (self.in_features, self.out_features):
            raise ValueError(f"weight must be ({self.in_features}, {self.out_features}), "
                             f"got {tuple(weight.shape)}")
        io = np.cumsum([0] + split_dim(self.in_features, self.in_splits))
        oo = np.cumsum([0] + split_dim(self.out_features, self.out_splits))
        for i in range(self.in_splits):
            for j in range(self.out_splits):
                self.tiles[f"tile_{i}_{j}_w"].copy_(weight[io[i]:io[i + 1], oo[j]:oo[j + 1]])
        if bias is not None:
            bias = torch.as_tensor(bias)
            for j in range(self.out_splits):
                self.tiles[f"bias_{j}"].copy_(bias[oo[j]:oo[j + 1]])
