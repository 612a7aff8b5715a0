"""Learning-rate schedules (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``).

``LRRangeTest``, ``OneCycle``, ``WarmupLR`` and ``WarmupDecayLR`` as pure
functions of the step count, evaluated in float32 as the JAX package
evaluates them: each returns a 0-dim float32 CPU tensor.  The engine
knows the step count on the host, so a schedule never reads the device.
:class:`LRScheduler` keeps the reference's ``step()/get_lr()/
state_dict()`` object API.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

LR_SCHEDULE_REGISTRY: Dict[str, Callable[..., Callable]] = {}

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _register(name: str):
    def deco(fn):
        LR_SCHEDULE_REGISTRY[name.lower()] = fn
        return fn

    return deco


@_register(LR_RANGE_TEST)
def lr_range_test(
    lr_range_test_min_lr: float = 1e-3,
    lr_range_test_step_size: int = 2000,
    lr_range_test_step_rate: float = 1.0,
    lr_range_test_staircase: bool = False,
    **_ignored,
) -> Callable:
    """LR range sweep: lr = min_lr * (1 + rate * interval)."""

    def schedule(step):
        interval = _f32(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return schedule


@_register(ONE_CYCLE)
def one_cycle(
    cycle_min_lr: float,
    cycle_max_lr: float,
    decay_lr_rate: float = 0.0,
    cycle_first_step_size: int = 2000,
    cycle_second_step_size: Optional[int] = None,
    cycle_first_stair_count: int = 0,
    cycle_second_stair_count: Optional[int] = None,
    decay_step_size: int = 0,
    cycle_momentum: bool = True,
    cycle_min_mom: float = 0.8,
    cycle_max_mom: float = 0.9,
    decay_mom_rate: float = 0.0,
    **_ignored,
) -> Callable:
    """1cycle policy: linear ramp min→max over the first leg, max→min over
    the second, then post-cycle decay of the min lr."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = _f32(step)
        first = _f32(cycle_first_step_size)
        up = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (step / first)
        down_frac = torch.clamp((step - first) / _f32(second), 0.0, 1.0)
        down = cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down_frac
        post = step - total_cycle
        decay_intervals = torch.floor(post / decay_step_size) if decay_step_size > 0 else post
        decayed = cycle_min_lr / (1.0 + decay_lr_rate * torch.clamp(decay_intervals, min=0.0))
        return torch.where(step < first, up, torch.where(step < total_cycle, down, decayed))

    return schedule


def one_cycle_momentum(
    cycle_min_mom: float = 0.8,
    cycle_max_mom: float = 0.9,
    decay_mom_rate: float = 0.0,
    cycle_first_step_size: int = 2000,
    cycle_second_step_size: Optional[int] = None,
    decay_step_size: int = 0,
    **_ignored,
) -> Callable:
    """Momentum leg of 1cycle: moves inversely to lr (max→min→max)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def schedule(step):
        step = _f32(step)
        first = _f32(cycle_first_step_size)
        down = cycle_max_mom - (cycle_max_mom - cycle_min_mom) * (step / first)
        up_frac = torch.clamp((step - first) / _f32(second), 0.0, 1.0)
        up = cycle_min_mom + (cycle_max_mom - cycle_min_mom) * up_frac
        post = torch.clamp(step - total_cycle, min=0.0)
        decay_intervals = torch.floor(post / decay_step_size) if decay_step_size > 0 else post
        decayed = cycle_max_mom * (1.0 + decay_mom_rate * decay_intervals)
        return torch.where(step < first, down, torch.where(step < total_cycle, up, decayed))

    return schedule


@_register(WARMUP_LR)
def warmup_lr(
    warmup_min_lr: float = 0.0,
    warmup_max_lr: float = 0.001,
    warmup_num_steps: int = 1000,
    warmup_type: str = "log",
    **_ignored,
) -> Callable:
    """Warmup then hold; ``log`` (the reference's default) or ``linear``
    ramp."""

    def schedule(step):
        step = _f32(step)
        n = _f32(max(warmup_num_steps, 1))
        if warmup_type == "log":
            frac = torch.log1p(torch.minimum(step, n)) / torch.log1p(n)
        else:
            frac = torch.minimum(step, n) / n
        lr = warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac
        return torch.where(step >= n, _f32(warmup_max_lr), lr)

    return schedule


@_register(WARMUP_DECAY_LR)
def warmup_decay_lr(
    total_num_steps: int,
    warmup_min_lr: float = 0.0,
    warmup_max_lr: float = 0.001,
    warmup_num_steps: int = 1000,
    warmup_type: str = "log",
    **_ignored,
) -> Callable:
    """Warmup then linear decay to zero over ``total_num_steps``."""
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def schedule(step):
        step = _f32(step)
        n = _f32(max(warmup_num_steps, 1))
        total = _f32(max(total_num_steps, 1))
        decay = torch.clamp((total - step) / torch.clamp(total - n, min=1.0), 0.0, 1.0)
        return torch.where(step < n, base(step), warmup_max_lr * decay)

    return schedule


def get_lr_schedule(name: str, params: Dict[str, Any]) -> Callable:
    """Resolve a scheduler config block to a schedule function."""
    key = name.lower()
    if key not in LR_SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown lr schedule '{name}'; valid: {VALID_LR_SCHEDULES}")
    return LR_SCHEDULE_REGISTRY[key](**params)


class LRScheduler:
    """Stateful wrapper preserving the reference object API
    (``step()``, ``get_lr()``, ``state_dict()``/``load_state_dict()``)."""

    def __init__(self, schedule_fn: Callable, last_batch_iteration: int = -1):
        self.schedule_fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [float(self.schedule_fn(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]
