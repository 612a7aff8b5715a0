"""Progressive Layer Drop (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``).

The theta schedule of "Accelerating Training of Transformer-Based
Language Models with Progressive Layer Dropping" (Zhang & He, 2020):
``theta(t) = (1 - theta_bar) * exp(-gamma * t) + theta_bar``, so early
steps keep almost every layer and the keep probability anneals to
``theta_bar``.  The engine puts ``theta(global_step)`` into every
micro-batch under :data:`PLD_THETA_KEY` (an f32 0-dim tensor on the host);
a model that supports PLD (``models/gpt2.py``) pops it and keeps layer l of
L with probability ``1 - (l+1)/L * (1 - theta)``.  The keep decisions are
made on the host from the micro-step's generator, so a dropped layer
launches nothing.
"""
from __future__ import annotations

import math

import torch

PLD_THETA_KEY = "__pld_theta__"


class ProgressiveLayerDrop:
    """``ProgressiveLayerDrop(theta, gamma)``, as the JAX package's."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)
        self.current_theta = 1.0

    def theta_at(self, global_step: int) -> float:
        """The schedule at ``global_step``, the host formula in f64."""
        return (1.0 - self.theta) * math.exp(-self.gamma * int(global_step)) + self.theta

    def get_theta(self, global_step) -> torch.Tensor:
        """The schedule at ``global_step`` as an f32 0-dim tensor on the
        host: the host formula rounded once to f32 (the JAX package
        evaluates it in f32 in its step, where XLA's ``exp`` may land one
        ulp away; ROADMAP C4)."""
        return torch.tensor(self.theta_at(int(global_step)), dtype=torch.float32)

    def update_state(self, global_step: int) -> None:
        """The host's copy of the schedule (reported by ``get_state``)."""
        self.current_theta = self.theta_at(global_step)

    def get_state(self) -> dict:
        return {"progressive_layer_drop": True, "pld_theta": self.current_theta}


def layer_keep_probs(theta, n_layers: int) -> torch.Tensor:
    """Each layer's keep probability, f32: ``p_l = 1 - (l+1)/L * (1 - theta)``."""
    depth_frac = (torch.arange(n_layers, dtype=torch.float32) + 1.0) / n_layers
    return 1.0 - depth_frac * (1.0 - torch.as_tensor(theta, dtype=torch.float32))
