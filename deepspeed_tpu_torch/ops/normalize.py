"""Shared normalization and elementwise helpers (counterpart of
``deepspeed_tpu/ops/normalize.py``)."""
from __future__ import annotations

from typing import Optional

import torch


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim with fp32 statistics, output in the
    input dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def dropout_generator(seed: Optional[int], device) -> Optional[torch.Generator]:
    """A dropout generator on ``device`` seeded ``seed`` (None: no
    dropout)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout drawn from ``generator`` (a ``torch.Generator`` on
    ``x``'s device); a no-op when deterministic, at rate 0 or without a
    generator.  The mask is not the JAX package's (another generator)."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood in f32."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    return logz - gold
