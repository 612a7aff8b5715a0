"""Grouped quantization ops (counterpart of
``deepspeed_tpu/ops/quantizer/quantizer.py``).

Symmetric and asymmetric grouped fake-quantization with optional
stochastic rounding, the real int8 codes of inference weights, and the
per-output-channel int8 pair the serving path keeps at rest.  The JAX
package computes all of it in plain XLA, outside any Pallas kernel; here
it is plain torch on the tensors' own device.  Stochastic rounding draws
its noise from an explicit ``torch.Generator`` where the JAX package
takes a PRNG key, so its draws differ from JAX's (ROADMAP C4); rounding
to nearest is bit for bit the JAX package's (``torch.round`` rounds half
to even, as ``jnp.round`` does).

The JAX package registers ``ds_quantizer`` as the ``quantizer`` op of its
op registry; that registry comes with ROADMAP A14 (``ops/registry.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as IEEE division, on any device: a CUDA tensor
    divided by a Python number is multiplied by the number's reciprocal,
    one rounding off, which moves a code that sits on a rounding edge."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    n = x.numel()
    if n % groups != 0:
        raise ValueError(f"tensor size {n} not divisible by groups={groups}")
    return x.reshape(groups, n // groups)


def quantize(
    x: torch.Tensor,
    groups: int = 1,
    bits: int = 8,
    symmetric: bool = True,
    stochastic: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Fake-quantize ``x`` to ``bits`` per group; returns its shape and
    dtype.  ``stochastic`` rounds down after adding uniform [0, 1) noise
    drawn from ``generator`` (required)."""
    g = _grouped(x.float(), groups)
    levels = 2.0 ** (bits - 1)
    if symmetric:
        absmax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, _div(absmax, levels - 1), torch.ones_like(absmax))
        q = g / scale
        lo, hi = -(levels - 1), levels - 1
    else:
        gmin = g.amin(dim=1, keepdim=True)
        gmax = g.amax(dim=1, keepdim=True)
        rng = torch.where(gmax > gmin, gmax - gmin, torch.ones_like(gmax))
        scale = _div(rng, 2.0 * levels - 1)
        q = (g - gmin) / scale
        lo, hi = 0.0, 2.0 * levels - 1
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        noise = torch.rand(q.shape, generator=generator, device=q.device, dtype=q.dtype)
        q = torch.floor(q + noise)
    else:
        q = torch.round(q)
    out = torch.clamp(q, lo, hi) * scale
    if not symmetric:
        out = out + gmin
    return out.reshape(x.shape).to(x.dtype)


def quantize_int8(x: torch.Tensor, groups: int = 1, symmetric: bool = True):
    """Real int8 codes for weight storage: ``(q int8, scale (groups,))``
    symmetric, ``(q uint8, scale, zero)`` asymmetric."""
    g = _grouped(x.float(), groups)
    if symmetric:
        absmax = g.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, _div(absmax, 127.0), torch.ones_like(absmax))
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        return q.reshape(x.shape), scale.squeeze(1)
    gmin = g.amin(dim=1, keepdim=True)
    gmax = g.amax(dim=1, keepdim=True)
    scale = torch.where(gmax > gmin, _div(gmax - gmin, 255.0), torch.ones_like(gmax))
    q = torch.clamp(torch.round((g - gmin) / scale), 0, 255).to(torch.uint8)
    return q.reshape(x.shape), scale.squeeze(1), gmin.squeeze(1)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, zero: Optional[torch.Tensor] = None,
                    groups: int = 1) -> torch.Tensor:
    out = _grouped(q.float(), groups) * scale[:, None]
    if zero is not None:
        out = out + zero[:, None]
    return out.reshape(q.shape)


def ds_quantizer(input: torch.Tensor, groups: int = 1, bit_num: int = 8, sr: bool = False,
                 asym: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The DeepSpeed entry point's signature (``ops/quantizer/quantizer.py:17``)."""
    return quantize(input, groups=groups, bits=bit_num, symmetric=not asym, stochastic=sr,
                    generator=generator)


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: ``w (..., in, out)`` ->
    ``(q int8 of w's shape, s (..., out) f32)`` with ``w ≈ q * s``, the
    absmax taken over the whole input dimension.  Runs on ``w``'s
    device."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, _div(absmax, 127.0), torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-2)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x @ (q * s)`` computed as ``(x @ q) * s``: the weight stays int8 at
    rest, and the product reads a transient copy of ``q`` in ``x``'s
    dtype."""
    return (x @ q.to(x.dtype)) * s.to(x.dtype)
