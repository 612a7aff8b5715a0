"""MoQ, progressive quantize-training (counterpart of
``deepspeed_tpu/runtime/quantize.py``).

The matmul weights are fake-quantized right after the optimizer update at
the accumulation boundary, with a bit width that anneals from
``quantize_bits_start`` to ``quantize_bits_target`` one bit a period past
``quantize_schedule_offset`` steps; the period may be lengthened by the
Hessian's top eigenvalue (``runtime/eigenvalue.py``,
:meth:`Quantizer.scale_period_by_eigenvalue`).  The quantize-dequantize
pass is ``ops/quantizer/quantizer.py`` ``quantize`` over each weight's
groups (a stacked ``(L, in, out)`` weight per layer); the schedule is host
arithmetic on the host's step count.
"""
from __future__ import annotations

import zlib
from typing import Any, Optional

import torch

from deepspeed_tpu_torch.ops.quantizer.quantizer import quantize as grouped_qdq
from deepspeed_tpu_torch.utils.logging import log_dist, logger

_SEED_MASK = (1 << 63) - 1


def is_quantized(name: str, ndim: int) -> bool:
    """The leaves MoQ quantizes: matmul weights (``*_w``, at least 2-D),
    not the embeddings."""
    return ndim >= 2 and name.endswith("_w") and "emb" not in name


class Quantizer:
    """``Quantizer(config)`` over a ``QuantizeTrainingConfig``."""

    def __init__(self, config):
        self.cfg = config
        self.q_period = max(1, int(config.quantize_schedule_offset))
        self._log_bits = None

    def current_bits(self, global_step: int) -> int:
        """``start`` bits until the offset, then one bit fewer a period
        down to ``target``."""
        start, target = self.cfg.quantize_bits_start, self.cfg.quantize_bits_target
        periods = max(0, (int(global_step) - self.q_period) // self.q_period + 1)
        return max(target, start - periods)

    def scale_period_by_eigenvalue(self, eigenvalue: float, max_eigenvalue: float) -> None:
        """The eigenvalue gate: a sharp layer (large curvature) lengthens the
        period between precision drops.  Call it before training, after an
        :meth:`Eigenvalue.compute_eigenvalue` probe."""
        ratio = max(1e-6, float(eigenvalue)) / max(1e-6, float(max_eigenvalue))
        self.q_period = max(1, int(self.q_period * (1.0 + ratio)))

    def _qdq_leaf(self, w: torch.Tensor, bits: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        """One weight quantize-dequantized; a stacked ``(L, ...)`` weight in
        ``L * quantize_groups`` groups, so no group straddles two layers."""
        g = self.cfg.quantize_groups
        if w.dim() >= 3:
            L = w.shape[0]
            if (w.numel() // L) % g != 0:
                logger.warning(
                    f"MoQ: per-layer size {w.numel() // L} not divisible by quantize_groups="
                    f"{g}; using one scale group per layer for this tensor")
                g = 1
            groups = L * g
        else:
            if w.numel() % g != 0:
                logger.warning(
                    f"MoQ: tensor of {w.numel()} elements not divisible by quantize_groups="
                    f"{g}; falling back to one scale group for this tensor")
                g = 1
            groups = g
        return grouped_qdq(w, groups=groups, bits=bits,
                           symmetric=self.cfg.quantize_type != "asymmetric",
                           stochastic=self.cfg.quantize_rounding == "stochastic",
                           generator=generator)

    def quantize_params(self, params: Any, global_step: int, seed: int = 0) -> Any:
        """The parameter tree with every matmul weight fake-quantized at
        :meth:`current_bits`; norms, biases and embeddings unchanged.
        Stochastic rounding draws each weight's bits from a generator on
        its device seeded by ``seed`` and the crc32 of its name (the JAX
        package folds the same crc32 into its key; ROADMAP C4)."""
        def visit(tree):
            if isinstance(tree, dict):
                return {k: (visit(v) if isinstance(v, dict) else leaf(k, v))
                        for k, v in tree.items()}
            return tree

        def leaf(name, w):
            if not isinstance(w, torch.Tensor) or not is_quantized(name, w.dim()):
                return w
            return self.quantize_leaf(name, w, global_step, seed)

        return visit(params)

    def quantize_leaf(self, name: str, w: torch.Tensor, global_step: int,
                      seed: int = 0) -> torch.Tensor:
        """One matmul weight (named by its key) fake-quantized at
        :meth:`current_bits`, as :meth:`quantize_params` does it."""
        gen = None
        if self.cfg.quantize_rounding == "stochastic":
            crc = zlib.crc32(name.encode()) & 0x7FFFFFFF
            gen = torch.Generator(device=w.device).manual_seed(
                (int(seed) * 1_000_003 + crc) & _SEED_MASK)
        return self._qdq_leaf(w, self.current_bits(global_step), gen)

    def maybe_log(self, global_step: int) -> None:
        if not self.cfg.quantize_verbose:
            return
        bits = self.current_bits(global_step)
        if bits != self._log_bits:
            self._log_bits = bits
            log_dist(f"MoQ: weights now quantized to {bits} bits (period={self.q_period})")
