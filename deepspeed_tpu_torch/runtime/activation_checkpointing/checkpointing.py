"""Activation checkpointing (counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``).

Everything runs over ``torch.utils.checkpoint`` with
``use_reentrant=False``: a checkpointed function keeps its inputs, drops
its intermediates and recomputes them in the backward.  What it keeps
besides is a *save policy*, the counterpart of a ``jax.checkpoint``
policy, carried out in the pair of contexts handed to the checkpoint as
its ``context_fn`` (:func:`policy_contexts`), one around the forward, one
around the recompute.  The policies:

* ``nothing_saveable``: keep nothing (the default);
* ``dots_saveable`` / ``dots_with_no_batch_dims_saveable``: keep every
  matmul's output (``mm``, ``addmm``, ``bmm``, ``baddbmm``), or only those
  without batch dimensions (``mm``, ``addmm``: the weight matmuls).  A
  dispatch mode sees every op: :class:`_KeepMode` stores the named ops'
  outputs in the forward, :class:`_ReplayMode` hands them back in the
  recompute instead of running the op (each op pays a Python dispatch);
* names (``save_only_these_names``): keep the values a model tags with
  :func:`saved_matmul` (GPT-2's ``qkv`` and ``ffn_pre``: the projection
  before its bias add, which the recompute redoes) or :func:`saved_value`
  (``attn_ctx``), with no dispatch mode: the recompute's stand-in packs
  what the matmul's node packs and skips the matmul.  ``attn_o`` and
  ``attn_lse`` together keep the attention kernel's output and
  log-sum-exp (``ops/attention/flash_attention.py`` ``kernel_residuals``):
  the recompute hands them to the kernel's autograd node instead of
  launching the forward kernel again, and the backward kernel runs from
  them.  Contexts rather than explicit segments, because a segment
  boundary would keep the tensors that cross it and recompute its last op
  anyway.

``cpu_checkpointing`` (the ``activation_checkpointing`` block, set by
:func:`configure`) keeps what the JAX policy
``offload_dot_with_no_batch_dims`` saves, the weight matmuls' outputs, on
pinned host memory, and the checkpointed function's activation inputs
too (the reference's checkpoint-in-CPU); everything else is recomputed.
The engine calls ``configure(deepspeed_config=config)`` at construction,
as the JAX engine does; a GPT-2 block under ``nothing_saveable`` follows
the configured ``cpu_checkpointing`` (``models/gpt2.py``).

Randomness: ``torch.utils.checkpoint`` restores the global CPU and CUDA
RNG states for the recompute; a function drawing from an explicit
``torch.Generator`` must be handed a fresh one (or a seed) per call, as
:func:`checkpoint_sequential` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any, Callable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from deepspeed_tpu_torch.config.config import ActivationCheckpointingConfig
from deepspeed_tpu_torch.ops.attention.flash_attention import kernel_residuals
from deepspeed_tpu_torch.utils.logging import log_dist

_CONFIG = ActivationCheckpointingConfig()

# the names a GPT-2 block tags (models/gpt2.py) and the attention kernels'
# residuals (ops/attention/flash_attention.py, sparse.py)
KNOWN_NAMES = ("qkv", "attn_ctx", "ffn_pre", "attn_o", "attn_lse")
POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable")

_aten = torch.ops.aten
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)
_DOTS = _DOTS_NO_BATCH + (_aten.bmm.default, _aten.baddbmm.default)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None) -> None:
    """Set the module's checkpointing behaviour from a config's
    ``activation_checkpointing`` block, then from the explicit arguments."""
    global _CONFIG
    if deepspeed_config is not None:
        cfg = getattr(deepspeed_config, "activation_checkpointing", None)
        if cfg is not None:
            _CONFIG = cfg
    updates = {}
    if partition_activations is not None:
        updates["partition_activations"] = partition_activations
    if contiguous_checkpointing is not None:
        updates["contiguous_memory_optimization"] = contiguous_checkpointing
    if checkpoint_in_cpu is not None:
        updates["cpu_checkpointing"] = checkpoint_in_cpu
    if synchronize is not None:
        updates["synchronize_checkpoint_boundary"] = synchronize
    if profile is not None:
        updates["profile"] = profile
    if num_checkpoints is not None:
        updates["number_checkpoints"] = num_checkpoints
    if updates:
        _CONFIG = dataclasses.replace(_CONFIG, **updates)
    log_dist(f"activation checkpointing configured: partition={_CONFIG.partition_activations} "
             f"cpu={_CONFIG.cpu_checkpointing}")


def is_configured() -> bool:
    return _CONFIG is not None


def get_config() -> ActivationCheckpointingConfig:
    return _CONFIG


# ---------------------------------------------------------------------------
# save policies
# ---------------------------------------------------------------------------

class SavePolicy:
    """Which values a checkpointed function keeps: ``kind`` one of
    :data:`POLICIES`, or ``names`` (a tuple of :data:`KNOWN_NAMES`);
    ``offload``: keep them on pinned host memory."""

    def __init__(self, kind: str = "nothing_saveable", names: Sequence[str] = (),
                 offload: bool = False):
        if names:
            unknown = sorted(set(names) - set(KNOWN_NAMES))
            if unknown:
                raise ValueError(f"unknown remat names {unknown}; known: {list(KNOWN_NAMES)}")
        elif kind not in POLICIES:
            raise NotImplementedError(
                f"remat policy {kind!r} is not ported to deepspeed_tpu_torch (ported: "
                f"{', '.join(POLICIES)} and save-by-name; ROADMAP A13)")
        self.kind, self.names, self.offload = kind, frozenset(names), offload
        # both kernel residuals saved: the recompute takes them back
        self.kernel_residuals = {"attn_o", "attn_lse"} <= self.names

    @property
    def saves_nothing(self) -> bool:
        return not self.names and self.kind == "nothing_saveable"

    @property
    def by_op(self) -> bool:
        """Whether the policy names ops (carried out by dispatch modes)."""
        return not self.names and self.kind in ("dots_saveable",
                                                 "dots_with_no_batch_dims_saveable")

    def keeps(self, func) -> bool:
        if self.kind == "dots_saveable":
            return func in _DOTS
        return func in _DOTS_NO_BATCH


class _Store:
    """What one checkpoint call keeps, each in the order the forward made
    it: named values, op outputs (dispatch modes) and the attention
    kernels' ``(out, lse)`` pairs (``kernel_residuals``)."""

    def __init__(self, policy: SavePolicy):
        self.policy = policy
        self.named: List[Any] = []
        self.named_grad: List[bool] = []  # saved_value's: whether each required a gradient
        self.ops: List[Any] = []
        self.pairs: List[Any] = []
        self.replaying = False

    def _hold(self, t: torch.Tensor):
        t = t.detach()
        if not self.policy.offload:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=True)
        return host, t.device

    @staticmethod
    def _back(held):
        if isinstance(held, tuple):
            host, device = held
            return host.to(device, non_blocking=True)
        return held

    def keep_named(self, t: torch.Tensor) -> None:
        self.named.append(self._hold(t))

    def take_named(self) -> torch.Tensor:
        return self._back(self.named.pop(0))

    def keep_op(self, out):
        self.ops.append(self._hold(out) if isinstance(out, torch.Tensor)
                        else [self._hold(t) for t in out])

    def take_op(self):
        held = self.ops.pop(0)
        return self._back(held) if not isinstance(held, list) else [self._back(h) for h in held]

    # the attention kernels' residuals (ops/attention: kernel_residuals)
    def keep(self, out: torch.Tensor, lse: torch.Tensor) -> None:
        self.pairs.append((self._hold(out), self._hold(lse)))

    def take(self):
        out, lse = self.pairs.pop(0)
        return self._back(out), self._back(lse)


# ---------------------------------------------------------------------------
# names: the values a model tags
# ---------------------------------------------------------------------------

class _Active(threading.local):
    store: Optional[_Store] = None  # the running checkpoint's, if its policy names values


_ACTIVE = _Active()


def _named_store(name: str) -> Optional[_Store]:
    store = _ACTIVE.store
    return store if store is not None and name in store.policy.names else None


@functools.lru_cache(maxsize=None)
def _matmul_packs_weight_first() -> bool:
    """Whether ``x @ w``'s autograd node packs ``w`` before ``x``'s rows
    (read once from a tiny product: the order is torch's, not ours)."""
    shapes = []
    x = torch.zeros(2, 2, 3, requires_grad=True)
    w = torch.zeros(3, 5, requires_grad=True)
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        x @ w
    return shapes[0] == (3, 5)


class _ReplayMatmul(torch.autograd.Function):
    """The recompute's stand-in for ``x @ w`` whose output the checkpoint's
    forward kept: it packs what the matmul's node packs (``x`` as rows and
    ``w``, in the node's order), so the forward's node gets its saved
    tensors, and hands the kept output back without the matmul.  The
    recompute's graph is dropped, so its backward never runs."""

    @staticmethod
    def forward(ctx, x, w, kept):
        rows = x.reshape(-1, x.shape[-1])
        ctx.save_for_backward(*((w, rows) if _matmul_packs_weight_first() else (rows, w)))
        return kept

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("a checkpoint's recompute graph is not differentiated")


def saved_matmul(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` tagged ``name`` (the JAX ``checkpoint_name`` on a
    projection): inside a checkpoint whose policy saves ``name`` its output
    is kept in the forward and handed back in the recompute without the
    matmul; elsewhere a plain ``x @ w``."""
    store = _named_store(name)
    if store is None:
        return x @ w
    if store.replaying:
        return _ReplayMatmul.apply(x, w, store.take_named())
    y = x @ w
    store.keep_named(y)
    return y


def saved_value(name: str, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``fn()`` tagged ``name``, for values whose ops save no tensor for
    the backward (a transpose and a reshape): kept in the forward and
    handed back in the recompute without running ``fn``."""
    store = _named_store(name)
    if store is None:
        return fn()
    if store.replaying:
        # its consumers pack what they packed in the forward only if it
        # requires a gradient as it did there
        return store.take_named().requires_grad_(store.named_grad.pop(0))
    y = fn()
    store.keep_named(y)
    store.named_grad.append(y.requires_grad)
    return y


@contextlib.contextmanager
def _active(store: Optional[_Store]):
    prev, _ACTIVE.store = _ACTIVE.store, store
    try:
        yield
    finally:
        _ACTIVE.store = prev


class _KeepMode(TorchDispatchMode):
    """The forward of an op policy: every op runs; the policy's ops'
    outputs are kept."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.store.policy.keeps(func):
            self.store.keep_op(out)
        return out


class _ReplayMode(TorchDispatchMode):
    """The recompute of an op policy: the policy's ops hand back their kept
    outputs."""

    def __init__(self, store: _Store):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.store.policy.keeps(func):
            return self.store.take_op()
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _policy_ctx(store: _Store, extra, replaying: bool):
    """The forward's (``replaying`` False) or the recompute's context of one
    checkpoint call: the named values, the kernels' residuals and, for an
    op policy, the dispatch mode."""
    store.replaying = replaying
    policy = store.policy
    with contextlib.ExitStack() as stack:
        if extra is not None:
            stack.enter_context(extra)
        if policy.names:
            stack.enter_context(_active(store))
        if policy.kernel_residuals:
            stack.enter_context(kernel_residuals(store))
        if policy.by_op:
            stack.enter_context((_ReplayMode if replaying else _KeepMode)(store))
        yield


def policy_contexts(policy: SavePolicy, extra: Optional[Callable] = None) -> Callable:
    """A ``context_fn`` for ``torch.utils.checkpoint`` that carries out
    ``policy``; ``extra``: another ``context_fn`` whose pair is entered
    too (the MoE layer's, ``moe/layer.py`` ``recompute_contexts``)."""

    def context_fn():
        store = _Store(policy)
        fwd, rec = extra() if extra is not None else (None, None)
        return _policy_ctx(store, fwd, False), _policy_ctx(store, rec, True)

    return context_fn


# ---------------------------------------------------------------------------
# inputs on the host (cpu_checkpointing)
# ---------------------------------------------------------------------------

class _ToHost(torch.autograd.Function):
    """A pinned host copy of an activation (its gradient goes back to the
    device)."""

    @staticmethod
    def forward(ctx, x):
        ctx.device = x.device
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        host.copy_(x, non_blocking=True)
        return host

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.device, non_blocking=True)


class _ToDevice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, device):
        return x.to(device, non_blocking=True)

    @staticmethod
    def backward(ctx, g):
        host = torch.empty(g.shape, dtype=g.dtype, pin_memory=g.is_cuda)
        host.copy_(g, non_blocking=True)
        return host, None


def _offloaded(function: Callable, which: Sequence[int], device) -> Callable:
    """``function`` taking the arguments at ``which`` from the host."""

    def run(*args, **kwargs):
        args = [(_ToDevice.apply(a, device) if i in which else a) for i, a in enumerate(args)]
        return function(*args, **kwargs)

    return run


def _activation_args(args) -> List[int]:
    """The arguments offloaded under ``cpu_checkpointing``: floating tensors
    on a CUDA device."""
    return [i for i, a in enumerate(args)
            if isinstance(a, torch.Tensor) and a.is_cuda and a.is_floating_point()]


def remat(function: Callable, *args, policy: Optional[SavePolicy] = None,
          offload_args: Optional[Sequence[int]] = None, context_fn: Optional[Callable] = None,
          **kwargs):
    """``function(*args, **kwargs)`` under ``torch.utils.checkpoint``
    (``use_reentrant=False``) with ``policy`` (default: the configured
    one, :func:`config_policy`).  With an offloading policy the arguments
    at ``offload_args`` (default: every floating CUDA tensor) wait on the
    host.  ``context_fn``: an extra ``context_fn`` entered beside the
    policy's."""
    policy = config_policy() if policy is None else policy
    if policy.offload and args:
        which = _activation_args(args) if offload_args is None else [
            i for i in offload_args if isinstance(args[i], torch.Tensor) and args[i].is_cuda]
        if which:
            device = args[which[0]].device
            args = tuple(_ToHost.apply(a) if i in which else a for i, a in enumerate(args))
            function = _offloaded(function, which, device)
    if policy.saves_nothing and not policy.offload:
        kw = {} if context_fn is None else {"context_fn": context_fn}
        return _torch_checkpoint(function, *args, use_reentrant=False, **kw, **kwargs)
    return _torch_checkpoint(function, *args, use_reentrant=False,
                             context_fn=policy_contexts(policy, context_fn), **kwargs)


def config_policy(config: Optional[ActivationCheckpointingConfig] = None) -> SavePolicy:
    """The configured block's policy: save nothing, or under
    ``cpu_checkpointing`` keep the weight matmuls' outputs on the host
    (the JAX package's ``offload_dot_with_no_batch_dims``)."""
    cfg = _CONFIG if config is None else config
    if cfg.cpu_checkpointing:
        return SavePolicy("dots_with_no_batch_dims_saveable", offload=True)
    return SavePolicy()


def checkpoint(function: Callable, *args, **kwargs):
    """Run ``function(*args)`` now and recompute it in the backward, under
    the configured policy (``checkpoint(fn, *args)``, the reference's
    signature)."""
    return remat(function, *args, **kwargs)


def checkpoint_wrapper(function: Callable,
                       config: Optional[ActivationCheckpointingConfig] = None) -> Callable:
    """Decorator form: a checkpointed version of ``function`` under
    ``config``'s policy (default: the configured one at each call)."""

    def wrapped(*args, **kwargs):
        policy = config_policy(config) if config is not None else None
        return remat(function, *args, policy=policy, **kwargs)

    return wrapped


def checkpoint_sequential(apply_block: Callable, params_stacked: Any, x: torch.Tensor,
                          generator_for: Optional[Callable[[int], Any]] = None,
                          every: int = 1) -> torch.Tensor:
    """``apply_block(p, h, generator)`` over the layers of the stacked
    leaves of ``params_stacked`` (a dict, list or tensor whose leaves lead
    with the layer dim), each run of ``every`` layers checkpointed as one
    (``every <= 1``: each layer).  ``generator_for(j)`` gives layer ``j``'s
    generator (a fresh one per call, so the recompute draws what the
    forward drew; the JAX version folds its key per layer); None passes
    None."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    flat, spec = tree_flatten(params_stacked)
    if not flat:
        return x
    # one unbind a leaf, so the backward stacks each leaf's gradient once
    per_leaf = [t.unbind(0) for t in flat]
    n = len(per_leaf[0])
    layers = [tree_unflatten([u[j] for u in per_leaf], spec) for j in range(n)]
    gen = generator_for if generator_for is not None else (lambda j: None)
    every = max(1, int(every))

    def run(h, j0, j1, *ps):
        for j, p in zip(range(j0, j1), ps):
            h = apply_block(p, h, gen(j))
        return h

    for j0 in range(0, n, every):
        j1 = min(n, j0 + every)
        x = remat(run, x, j0, j1, *layers[j0:j1], offload_args=(0,))
    return x


# ---------------------------------------------------------------------------
# model-parallel RNG streams (the reference's tracker API)
# ---------------------------------------------------------------------------

class CudaRNGStatesTracker:
    """Named RNG streams, each a ``torch.Generator``'s state:
    ``fork(name)`` draws a seed from the stream (advancing it) and runs its
    block with the global RNGs (CPU and CUDA) seeded by it, restoring them
    after."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        return dict(self.states_)

    def set_states(self, states):
        self.states_ = dict(states)

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(int(seed)).get_state()

    @contextlib.contextmanager
    def fork(self, name: str = "model-parallel-rng"):
        stream = torch.Generator()
        stream.set_state(self.states_[name])
        seed = int(torch.randint(0, 2**62, (1,), generator=stream))
        self.states_[name] = stream.get_state()
        with torch.random.fork_rng():
            torch.manual_seed(seed)
            yield


_CUDA_RNG_TRACKER = CudaRNGStatesTracker()


def get_cuda_rng_tracker() -> CudaRNGStatesTracker:
    return _CUDA_RNG_TRACKER


def model_parallel_cuda_manual_seed(seed: int) -> None:
    """Seed the model-parallel stream (``seed + 2718``)."""
    _CUDA_RNG_TRACKER.reset()
    _CUDA_RNG_TRACKER.add("model-parallel-rng", seed + 2718)
