"""Training engine on one device (counterpart of
``deepspeed_tpu/runtime/engine.py::DeepSpeedEngine``).

The engine owns f32 master weights on its device (leaves of the caller's
parameter tree, flattened in sorted-key order as a JAX pytree flattens).
Each micro-step casts the masters to the compute type (bf16, fp16 or
f32), runs the model callable ``(params, batch, generator) -> loss``,
scales the loss and runs autograd's backward, which casts the gradients
back to f32 and sums them into the masters' ``.grad`` (the gradient
accumulator).  At the accumulation boundary the step averages, unscales,
checks overflow (dynamic scaler only), clips by the global norm and
updates: Adam and AdamW with f32 state always take
:func:`~deepspeed_tpu_torch.ops.kernels.fused_update.engine_update` (the
fused Adam kernel on the card), SGD its own ``update``.

PyTorch runs eagerly: there is no compiled step; ``train_batch`` loops
over the micro-batches.  Nothing reads the device on the host except the
overflow flag when the loss scaler is dynamic (as the JAX engine).

The generator handed to the model is a CPU ``torch.Generator`` seeded
from the config's ``seed`` and the micro-step count (None in eval), so
drawing dropout seeds from it never waits on the card.

Not ported (each raises, naming its ROADMAP item, or is absent): ZeRO
sharding across devices and TP (A6), offload (A12), pipeline (A11), 1-bit
optimizers and LAMB (A13, B7), the comm layer, supervision, telemetry,
sanitizer, timeline and flops profiler (A14/A15), MoQ and PLD (A13),
checkpoints (A4).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.inference.engine import resolve_device
from deepspeed_tpu_torch.ops.adam.fused_adam import SGD, FusedAdam, FusedAdamW
from deepspeed_tpu_torch.ops.kernels.fused_update import engine_update
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScaler
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.utils.logging import log_dist

_SEED_MASK = (1 << 63) - 1


def tree_flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """Leaves of a tree of dicts, lists and tuples (dict keys in sorted
    order, as a JAX pytree), and a function that rebuilds the tree from a
    list of new leaves."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (list, tuple)):
            subs = [walk(x) for x in t]
            typ = type(t)
            return lambda it: typ([s(it) for s in subs])
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    return torch.sqrt(torch.stack(sq).sum())


def _clip_by_global_norm(grads: List[torch.Tensor],
                         max_norm: float) -> Tuple[List[torch.Tensor], torch.Tensor]:
    norm = _global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [(g.float() * factor).to(g.dtype) for g in grads], norm


class DeepSpeedEngine:
    def __init__(
        self,
        model: Callable,
        params: Any,
        config: DeepSpeedConfig,
        optimizer: Any = None,
        lr_scheduler: Any = None,
        loss_fn: Optional[Callable] = None,
        device: Any = "cuda",
    ):
        """``model``: callable ``(params, batch, generator) -> loss`` (or
        outputs if ``loss_fn`` is given, then ``loss_fn(outputs, batch) ->
        loss``).  ``params``: the initial parameter tree (numpy arrays or
        tensors); the engine keeps its own f32 copy on ``device``."""
        self.device = resolve_device(device)
        self.config = config
        self._model_fn = model
        self._loss_fn = loss_fn

        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.loss_scaler = LossScaler.from_config(config.fp16)

        # -- f32 masters: the leaves of the caller's tree, on the device --
        leaves, self._unflatten = tree_flatten(params)
        self._params: List[torch.Tensor] = [
            torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)
            if not isinstance(x, torch.Tensor)
            else x.detach().to(device=self.device, dtype=torch.float32, copy=True)
            for x in leaves
        ]
        for p in self._params:
            p.requires_grad_(True)

        # -- optimizer and schedule ---------------------------------------
        self.optimizer = optimizer if optimizer is not None else self._configure_basic_optimizer()
        self.lr_schedule = self._configure_lr_schedule(lr_scheduler)
        self.client_lr_scheduler = lr_scheduler
        with torch.no_grad():
            self.opt_state = self.optimizer.init(self._params)
        self.loss_scale_state = self.loss_scaler.init(self.device)

        self.skipped_steps = 0
        self._host_global_step = 0
        self._host_micro_step = 0
        self._cached_loss = None
        self._last_info: Dict[str, Any] = {}
        log_dist(
            f"engine: device={self.device} dtype={self.compute_dtype} "
            f"micro_bs={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} zero_stage={self.zero_stage} (one device)"
        )

    # ------------------------------------------------------------------
    # configuration helpers
    # ------------------------------------------------------------------
    def _configure_basic_optimizer(self):
        """Reference ``_configure_basic_optimizer``."""
        name = self.config.optimizer.name or C.ADAM_OPTIMIZER
        params = dict(self.config.optimizer.params)
        params.pop("torch_adam", None)
        lr = params.pop("lr", 1e-3)
        if name == C.ADAM_OPTIMIZER:
            adam_w_mode = params.pop("adam_w_mode", True)
            return FusedAdam(lr=lr, adam_w_mode=adam_w_mode, **params)
        if name == C.ADAMW_OPTIMIZER:
            return FusedAdamW(lr=lr, **params)
        if name == C.LAMB_OPTIMIZER:
            raise NotImplementedError("the LAMB optimizer is not ported yet (ROADMAP B7 + A13)")
        if name in (C.ONEBIT_ADAM_OPTIMIZER, C.ONEBIT_LAMB_OPTIMIZER):
            raise NotImplementedError(f"the {name} optimizer is not ported yet (ROADMAP A13)")
        if name == C.SGD_OPTIMIZER:
            return SGD(lr=lr, **params)
        raise ValueError(f"Unknown optimizer '{name}'")

    def _configure_lr_schedule(self, client_scheduler):
        if callable(client_scheduler):
            return client_scheduler
        if self.config.scheduler.type:
            return get_lr_schedule(self.config.scheduler.type, self.config.scheduler.params)
        base_lr = getattr(self.optimizer, "lr", 1e-3)
        return lambda step: torch.tensor(base_lr, dtype=torch.float32)

    # ------------------------------------------------------------------
    # properties (the reference engine exposes config as methods)
    # ------------------------------------------------------------------
    @property
    def zero_stage(self) -> int:
        return self.config.zero_config.stage

    zero_optimization_stage = zero_stage

    @property
    def train_batch_size(self) -> int:
        return self.config.train_batch_size

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    @property
    def global_steps(self) -> int:
        return self._host_global_step

    @property
    def micro_steps(self) -> int:
        return self._host_micro_step

    @property
    def loss_scale(self) -> float:
        return float(self.loss_scale_state.scale)

    @property
    def module(self):
        return self._model_fn

    @property
    def params(self) -> Any:
        """The f32 master weights, as the caller's tree (detached)."""
        return self._unflatten([p.detach() for p in self._params])

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self._host_global_step))]

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._host_micro_step % self.gradient_accumulation_steps == 0

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _to_device(self, x: Any) -> Any:
        """A batch leaf on the engine's device; host arrays go through
        pinned memory so the copy does not wait for the queued step."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _prepare_batch(self, batch: Any) -> Any:
        leaves, rebuild = tree_flatten(batch)
        return rebuild([self._to_device(x) for x in leaves])

    def _materialize_params(self) -> Any:
        """The masters cast to the compute type, as the caller's tree; the
        cast's backward hands f32 gradients to the masters."""
        return self._unflatten([p.to(self.compute_dtype) for p in self._params])

    def _generator(self) -> torch.Generator:
        seed = (self.config.seed * 1_000_003 + self._host_micro_step) & _SEED_MASK
        return torch.Generator().manual_seed(seed)

    def _compute_loss(self, batch: Any, generator: Optional[torch.Generator]) -> torch.Tensor:
        out = self._model_fn(self._materialize_params(), batch, generator)
        loss = self._loss_fn(out, batch) if self._loss_fn is not None else out
        loss = torch.as_tensor(loss)
        return loss.mean() if loss.ndim != 0 else loss

    def _micro_step(self, batch: Any) -> torch.Tensor:
        """Forward and backward of one micro-batch on the device; the
        gradients add into the masters' ``.grad``."""
        loss = self._compute_loss(batch, self._generator())
        self.loss_scaler.scale_loss(loss.float(), self.loss_scale_state).backward()
        self._host_micro_step += 1
        return loss.detach()

    @torch.no_grad()
    def _apply_step(self) -> Dict[str, Any]:
        """Optimizer step at the accumulation boundary (the JAX engine's
        ``_apply_step_impl`` + ``_apply_update``)."""
        gas = self.gradient_accumulation_steps
        grads = [p.grad / gas if p.grad is not None else torch.zeros_like(p) for p in self._params]
        for p in self._params:
            p.grad = None
        grads, overflow = self.loss_scaler.unscale_and_check(grads, self.loss_scale_state)
        grad_norm = torch.zeros((), dtype=torch.float32, device=self.device)
        if self.config.gradient_clipping > 0.0:
            grads, grad_norm = _clip_by_global_norm(grads, self.config.gradient_clipping)
        lr = float(self.lr_schedule(self._host_global_step))
        params = [p.detach() for p in self._params]
        state = engine_update(self.optimizer, grads, self.opt_state, params, lr, overflow)
        if state is None:
            self.opt_state = self._plain_update(grads, params, lr, overflow)
        self.loss_scale_state = self.loss_scaler.update(self.loss_scale_state, overflow)
        return {"lr": lr, "grad_norm": grad_norm, "overflow": overflow}

    def _plain_update(self, grads, params, lr, overflow):
        """``optimizer.update`` then ``p + u`` for optimizers the fused
        kernel does not serve (SGD); on overflow the old parameters and
        state stay."""
        lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
        updates, new_state = self.optimizer.update(grads, self.opt_state, params, lr=lr_t)
        for p, u in zip(params, updates):
            p.copy_(torch.where(overflow, p, (p.float() + u).to(p.dtype)))
        old, _ = tree_flatten(self.opt_state)
        new, rebuild = tree_flatten(new_state)
        return rebuild([torch.where(overflow, o, n) for o, n in zip(old, new)])

    def _end_step(self, info: Dict[str, Any]) -> None:
        """Host bookkeeping at the boundary: the overflow flag is read on
        the host only when the scaler is dynamic."""
        self._last_info = info
        if self.loss_scaler.dynamic and bool(info["overflow"]):
            self.skipped_steps += 1
            log_dist(f"step skipped on overflow; loss scale -> {self.loss_scale}")
            return
        self._host_global_step += 1

    # ------------------------------------------------------------------
    # user API
    # ------------------------------------------------------------------
    def forward(self, batch: Any) -> torch.Tensor:
        """Forward and backward of one micro-batch; returns the loss.
        As in the JAX engine, the gradients are produced here and summed
        into the accumulator; ``backward()`` checks the call order."""
        loss = self._micro_step(self._prepare_batch(batch))
        self._cached_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss: Any = None, allreduce_gradients: bool = True) -> Any:
        """Gradient accumulation already happened in ``forward``; this is
        the ordering checkpoint."""
        if self._cached_loss is None:
            raise RuntimeError("backward() called before forward()")
        loss = self._cached_loss
        self._cached_loss = None
        return loss

    def step(self) -> None:
        """Apply the optimizer step at the gradient-accumulation boundary."""
        if self.is_gradient_accumulation_boundary():
            self._end_step(self._apply_step())

    def train_batch(self, batch: Any) -> torch.Tensor:
        """One global batch: every leaf's leading dim is ``gas *
        micro_batch``; the micro-batches are its consecutive slices.
        Returns the mean micro-batch loss (a 0-dim tensor on the
        device)."""
        gas = self.gradient_accumulation_steps
        leaves, rebuild = tree_flatten(batch)
        leaves = [self._to_device(x) for x in leaves]
        mb = leaves[0].shape[0] // gas if leaves else 0
        losses = []
        for i in range(gas):
            micro = rebuild([x[i * mb:(i + 1) * mb] for x in leaves])
            losses.append(self._micro_step(micro))
        self._end_step(self._apply_step())
        return torch.stack(losses).mean()

    @torch.no_grad()
    def eval_batch(self, batch: Any) -> torch.Tensor:
        """The loss of one batch without dropout and without gradients."""
        return self._compute_loss(self._prepare_batch(batch), None)

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "save_checkpoint is not ported yet (ROADMAP A4 runtime/checkpointing.py)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "load_checkpoint is not ported yet (ROADMAP A4 runtime/checkpointing.py)")
