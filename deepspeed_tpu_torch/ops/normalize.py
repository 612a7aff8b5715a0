"""Shared normalization helper (counterpart of
``deepspeed_tpu/ops/normalize.py::layer_norm``)."""
from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics, output in the
    input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)
