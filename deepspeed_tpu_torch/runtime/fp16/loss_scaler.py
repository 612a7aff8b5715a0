"""Loss scaling (counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``).

The scaler's state is a few 0-dim tensors on the engine's device, and
the overflow check and scale update are tensor ops (``torch.where``), so
a step reads nothing back to the host; the engine reads the overflow flag
only when the scaler is dynamic.  bf16 and f32 training use the static
scaler with scale 1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from deepspeed_tpu_torch.config.config import Fp16Config


@dataclasses.dataclass
class LossScaleState:
    scale: torch.Tensor  # f32
    good_steps: torch.Tensor  # i32: consecutive overflow-free steps
    hysteresis_left: torch.Tensor  # i32
    overflow: torch.Tensor  # bool: the last step overflowed


class LossScaler:
    """Static or dynamic; ``dynamic=False, init_scale=1`` is the no-op
    scaler."""

    def __init__(
        self,
        dynamic: bool = False,
        init_scale: float = 2.0**32,
        scale_factor: float = 2.0,
        scale_window: int = 1000,
        min_scale: float = 1.0,
        hysteresis: int = 2,
    ):
        self.dynamic = dynamic
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.hysteresis = int(hysteresis)

    @classmethod
    def from_config(cls, cfg: Fp16Config) -> "LossScaler":
        if not cfg.enabled:
            return cls(dynamic=False, init_scale=1.0)
        if cfg.dynamic_loss_scale:
            return cls(
                dynamic=True,
                init_scale=2.0**cfg.initial_scale_power,
                scale_window=cfg.loss_scale_window,
                min_scale=cfg.min_loss_scale,
                hysteresis=cfg.hysteresis,
            )
        return cls(dynamic=False, init_scale=cfg.loss_scale)

    def init(self, device="cpu") -> LossScaleState:
        return LossScaleState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32, device=device),
            good_steps=torch.zeros((), dtype=torch.int32, device=device),
            hysteresis_left=torch.tensor(self.hysteresis, dtype=torch.int32, device=device),
            overflow=torch.zeros((), dtype=torch.bool, device=device),
        )

    def scale_loss(self, loss: torch.Tensor, state: LossScaleState) -> torch.Tensor:
        return loss * state.scale.to(loss.dtype)

    def unscale_and_check(self, grads: List[torch.Tensor],
                          state: LossScaleState) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Unscaled grads and the overflow flag (a 0-dim bool tensor; any
        non-finite gradient value when the scaler is dynamic)."""
        inv = 1.0 / state.scale
        grads = [(g.float() * inv).to(g.dtype) for g in grads]
        if not self.dynamic:
            return grads, torch.zeros((), dtype=torch.bool, device=state.scale.device)
        finite = torch.ones((), dtype=torch.bool, device=state.scale.device)
        for g in grads:
            finite = finite & torch.isfinite(g).all()
        return grads, ~finite

    def update(self, state: LossScaleState, overflow: torch.Tensor) -> LossScaleState:
        """Dynamic scale update: an overflow cuts the scale (after the
        hysteresis runs out) and resets the window; ``scale_window`` clean
        steps double it."""
        if not self.dynamic:
            return dataclasses.replace(state, overflow=overflow)
        hysteresis_left = torch.where(
            overflow, torch.clamp(state.hysteresis_left - 1, min=0), state.hysteresis_left)
        should_cut = overflow & (hysteresis_left <= 0)
        new_scale = torch.where(
            should_cut, torch.clamp(state.scale / self.scale_factor, min=self.min_scale), state.scale)
        hysteresis_left = torch.where(
            should_cut, torch.full_like(hysteresis_left, self.hysteresis), hysteresis_left)
        good = torch.where(overflow, torch.zeros_like(state.good_steps), state.good_steps + 1)
        grow = ~overflow & (good >= self.scale_window)
        new_scale = torch.where(grow, new_scale * self.scale_factor, new_scale)
        good = torch.where(grow, torch.zeros_like(good), good)
        return LossScaleState(scale=new_scale, good_steps=good, hysteresis_left=hysteresis_left,
                              overflow=overflow)
