"""Training engine (counterpart of
``deepspeed_tpu/runtime/engine.py::DeepSpeedEngine``), on one device or on
every rank of a ``torch.distributed`` process group.

The engine owns f32 master weights on its device (leaves of the caller's
parameter tree, flattened in sorted-key order as a JAX pytree flattens).
Each micro-step casts the masters to the compute type (bf16, fp16 or
f32), runs the model callable ``(params, batch, generator) -> loss``,
scales the loss and runs autograd's backward, which casts the gradients
back to f32; they are reduced over the data-parallel grid and summed into
the gradient accumulator.  At the accumulation boundary the step
averages, unscales, checks overflow (dynamic scaler only), clips by the
global norm and updates: Adam and AdamW with f32 state and LAMB always
take :func:`~deepspeed_tpu_torch.ops.kernels.fused_update.engine_update`
(the fused Adam kernel, or LAMB's two kernels, on the card), SGD and the
reduced Adam state (``state_precision`` "8bit" / "bf16") the optimizer's
own ``update`` (plain torch ops; the overflow skip folds into the reduced
state's producer, and its stochastic rounding draws from a generator on
the device seeded by the seed and the global step).

**Training extras** (``runtime/activation_checkpointing``,
``progressive_layer_drop.py``, ``quantize.py``): the engine configures the
``activation_checkpointing`` block at construction; with
``progressive_layer_drop`` every micro-batch dict carries theta under
``PLD_THETA_KEY``; with ``quantize_training`` (MoQ) the matmul weights are
fake-quantized after the update at the boundary, an overflow step keeping
them unquantized.  Both keep the JAX engine's whole-leaf groups where
ranks cut a leaf: the 8-bit state's block scales are the whole leaf's
(each element's block through the same cut as its slice, the partial
absmax all-reduced by MAX; :class:`~deepspeed_tpu_torch.ops.adam.fused_adam.CutBlocks`),
and MoQ quantizes each cut matmul weight gathered whole.  MoQ under
offload raises (the JAX engine's rule).

**ZeRO across ranks.**  The engine's mesh (``mesh`` config block or
argument; ``comm/mesh.py``) is read from the started process group
(``comm.distributed.init_distributed``); the data-parallel grid is
``data x fsdp``, and each rank's batch is its own rows.  The JAX
package's rules (``runtime/zero/stages.py``) give every leaf a parameter,
gradient and optimizer-state spec, and ``runtime/zero/partition.py``
carries them out:

* each micro-step's gradient is all-reduced over ``data``, then
  reduce-scattered over ``fsdp`` where the gradient spec cuts the leaf
  (stage >= 2), else all-reduced over ``fsdp``;
* the update runs on this rank's slice of the optimizer state (stage >= 1:
  fsdp, and data too by cross-replica update sharding), as contiguous
  tensors the fused kernels take; the updated masters are all-gathered
  back to the parameter spec;
* stage 3 keeps only this rank's shard of each sharded master, and the
  model gathers on use (``runtime/zero/partition.py``);
* the global gradient norm sums each element once (on the rank at
  coordinate 0 of the axes that do not cut it), and one all-reduce per
  step carries it with the overflow count and the loss sum, so every
  rank clips, skips and reports alike; ``train_batch`` returns the mean
  loss over the global batch.

**Tensor and sequence parallelism.**  A ``model`` axis cuts the leaves
the model's ``tp_spec_fn`` (or ``partition_rules``) names: each ``model``
rank keeps its block of them (ZeRO's specs compose on top: stage 3
gathers over ``fsdp`` only) and the model runs the Megatron operators of
``parallel/tensor.py`` on them.  A ``seq`` axis cuts the positions: each
``seq`` rank runs its positions of its rows (``parallel/sequence.py``).
The engine scopes its mesh around every forward
(``parallel.sequence.ambient_mesh``), so the model finds its groups
(it keeps them for the backward's recompute);
every micro-step's gradient is all-reduced over ``seq`` before the
data-parallel reduction; the global norm counts each element once (a
tensor-parallel block once per block, a replicated leaf once); the step's
scalars travel over every rank.  ``dp_world_size`` counts ``data x
fsdp`` only.  ``initialize`` refuses, as the JAX package does, a
tensor-parallel dimension the ``model`` axis does not divide (GPT-2's
vocabulary of 50257 at ``model`` 2), and the model's own refusals
(``initialize``'s ``mesh_check``, a model's ``check_mesh``: heads, ``T %
seq``, Ulysses' heads).

Every collective counts its bytes by kind (``comm/collectives.py``); at
world size 1 the engine issues none, and its arithmetic is the
one-device engine's, bit for bit.

PyTorch runs eagerly: there is no compiled step; ``train_batch`` loops
over the micro-batches.  Nothing reads the device on the host except the
overflow flag when the loss scaler is dynamic (as the JAX engine).

The generator handed to the model is a CPU ``torch.Generator`` seeded
from the config's ``seed`` and the micro-step count (None in eval), so
drawing dropout seeds from it never waits on the card.  The JAX engine's
``rng`` state leaf has no counterpart: a checkpoint restores the
micro-step count, and the generator (hidden-dropout masks, attention
dropout's Threefry keys) follows from it.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``,
``runtime/checkpointing.py``) carry the masters, the optimizer state, the
loss scaler's state and the host counters (global and micro step,
skipped steps, samples), which stay the engine's source of truth.  A
registered loader (``register_dataloader``, ``prefetch_loader``) has its
cursor saved and restored with them.  At every step boundary the engine
checks the ``step.boundary`` fault site, a pending preemption (the
``resilience.watchdog``: emergency save, exit 43) and the divergence
guard (``resilience.divergence``, on by default as in the JAX engine).

**Expert parallelism.**  An ``expert`` axis cuts the MoE leaves by
expert (the family table's specs, ``tp_spec_fn``): each ``expert`` rank
holds its experts, sees the same rows as its peers, and the model sums
the experts' outputs over the group (``moe/layer.py``); the replicated
leaves get their whole gradient on every ``expert`` rank, so nothing is
reduced over ``expert``, and the global norm and the loss count each
once.  A ``pipe`` axis belongs to ``runtime/pipe/engine.py``'s
``PipelineEngine``; under this engine it replicates, as under the JAX
engine.

**ZeRO-Offload** (``zero_optimization.offload_optimizer.device`` ``cpu``
or ``nvme``): the f32 masters and Adam moments live in pinned
host memory (the moments on disk under ``nvme``) in a
``runtime/zero/offload.py::HostOffloadOptimizer``; the device holds the
compute-type parameters and the f32 gradient accumulator only.  Under a
``model`` or ``expert`` axis each rank's host optimizer holds its block of
every cut leaf (``qkv`` head-grouped) and the replicated leaves whole;
checkpoints gather the natural layout.  At the
accumulation boundary the accumulator is averaged, unscaled, checked,
norm-reduced and clipped on the device (the code of the device step),
copied into pinned host buffers on a side stream behind an event, stepped
by the native host Adam (``ops/adam/cpu_adam.py``), cast to bf16 by the
host kernel into a pinned buffer and copied back to the device parameters
without blocking; the next cast into that buffer waits for the copy's
event.  Across the ranks that hold the same blocks (the ``data x fsdp x
seq`` grid; or ``DS_OFFLOAD_SHARDS`` in one process) the masters are
packed flat and each rank keeps, steps and checkpoints its 1/P slice, the
updated slices all-gathered as pinned f32 tensors on a gloo group over
that grid; the device keeps whole parameters (blocks) and reduces whole
gradients whatever the stage.  A ``pipe`` axis is refused, as the JAX
pipeline engine refuses offload.  ``offload_param`` routes to
``runtime/zero/param_offload.py`` in ``initialize``.

**1-bit Adam / LAMB and compressed exchanges** (``OneBitAdam``,
``OneBitLamb``; ``comm.strategy`` ``int8`` / ``onebit``): on a
data-parallel grid of more than one rank, at any ZeRO stage, the 1-bit
optimizers' warm steps take the dense exchange (their state on ZeRO's
update slices; LAMB's trust-ratio norms summed over a cut leaf's ranks);
from ``freeze_step`` each rank keeps its own gradients and one 1-bit
momentum exchange a step crosses the wire over ``data x fsdp``
(``runtime/fp16/onebit/``, :meth:`_explicit_step`), the frozen state
replicated over that grid.  The compressed strategies exchange each
rank's gradient row once a step (``comm/strategy.py`` ``exchange_rows``)
and then take the dense update.  Under stage 3 each rank keeps its
gathered leaves' gradients unreduced for its row; ``seq`` ranks sum their
rows first; under a ``model`` axis each ``model`` rank's row is its blocks
(the replicated leaves on ``model`` rank 0's row alone, its results
taken by the others: ROADMAP C4).

**Telemetry** (``telemetry`` block; ``telemetry/``): the engine arms the
process's plane before the comm layer (whose strategy decisions land in
the registry), attaches its step timeline (phase histograms, the step
wall, MFU), counts its first step into the per-bucket cost table
(``telemetry/attribution.py``: the MFU numerator and the flops
profiler's cost) and, with a sink or the trace armed on the card, times
its second under ``torch.profiler``.  With tracing armed each step's
work on the card is one span between two CUDA events, placed at export
or report time.  At ``steps_per_print`` the loss, lr and loss scale go
to the registry and the TensorBoard monitor; the loss is read off the
card (``.item()``) only when a monitor, an exporter or
``wall_clock_breakdown`` asks for it, so registry-only telemetry adds no
sync.  ``wall_clock_breakdown`` fences the timeline's ``compute`` phase
and logs the timeline and the CUDA-event timers at that cadence.

Not ported (each raises, naming its ROADMAP item, or is absent): 1-bit
optimizers and explicit exchanges under an ``expert`` or ``pipe`` axis,
and the 1-bit local-quantization fallback on leaves cut across ranks
(A13, the compositions); supervision and telemetry's cross-rank
aggregation (A14) and the sanitizer (A15).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.ops.adam.fused_adam import SGD, AdamState8, FusedAdam, FusedAdamW
from deepspeed_tpu_torch.ops.kernels.fused_update import engine_update
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.parallel.sequence import ambient_mesh
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScaler
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.zero.partition import HELD_AXES
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (
    BACKWARD_TIMER,
    FORWARD_TIMER,
    STEP_TIMER,
    TRAIN_BATCH_TIMER,
)

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


def tree_paths(tree: Any) -> List[str]:
    """The ``/``-joined path of every leaf, in :func:`tree_flatten`'s
    order (the JAX package's path strings: ``blocks/qkv_w``)."""
    out: List[str] = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, path + (str(i),))
        else:
            out.append("/".join(path))

    walk(tree, ())
    return out


def tree_items(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in :func:`tree_flatten`'s order."""
    return list(zip(tree_paths(tree), tree_flatten(tree)[0]))


def tree_from_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of dicts whose leaves ``flat`` names by path:
    ``{"blocks/qkv_w": t, "wte": t}`` -> ``{"blocks": {"qkv_w": t}, "wte": t}``."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for key in heads:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


class _PlacedBatch:
    """A batch already on the engine's device, placed ahead of the step by
    ``prefetch_loader``: ``train_batch`` takes it without placing it
    again.  On the card its leaves were copied from pinned host memory on
    the engine's copy stream; :meth:`take` makes the current stream wait
    for the copies' event and marks each leaf as used by the current
    stream, so the caching allocator does not hand its memory to a later
    batch (allocated on the copy stream) while the step still reads it.
    ``sources`` keeps the pinned host tensors alive until the batch is
    taken."""

    __slots__ = ("leaves", "rebuild", "event", "sources")

    def __init__(self, leaves, rebuild, event=None, sources=None):
        self.leaves, self.rebuild, self.event, self.sources = leaves, rebuild, event, sources

    def take(self) -> Tuple[List[torch.Tensor], Callable]:
        if self.event is not None:
            stream = torch.cuda.current_stream(self.leaves[0].device)
            stream.wait_event(self.event)
            for t in self.leaves:
                t.record_stream(stream)
        self.sources = None
        return self.leaves, self.rebuild


def _pinned(x: Any) -> torch.Tensor:
    """A host batch leaf in pinned memory (a CUDA tensor stays as it is)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x if x.is_cuda else x.pin_memory()


def _sum_squares(grads: List[torch.Tensor], device) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    return torch.stack(sq).sum() if sq else torch.zeros((), dtype=torch.float32, device=device)


def _keep_on_overflow(overflow, old, new):
    """``new`` where no rank overflowed, else ``old`` (trees of tensors)."""
    olds, _ = tree_flatten(old)
    news, rebuild = tree_flatten(new)
    return rebuild([torch.where(overflow, o, n) for o, n in zip(olds, news)])


def _clip_by_norm(grads: List[torch.Tensor], norm: torch.Tensor,
                  max_norm: float) -> List[torch.Tensor]:
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [(g.float() * factor).to(g.dtype) for g in grads]


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
        mesh=None,
        tp_spec_fn=None,
        partition_rules=None,
        mesh_check=None,
        comm_model=None,
    ):
        """``model``: callable ``(params, batch, generator) -> loss`` (or
        outputs if ``loss_fn`` is given, then ``loss_fn(outputs, batch) ->
        loss``).  ``params``: the initial parameter tree (numpy arrays or
        tensors), whole on every rank; the engine keeps its own f32 copy of
        this rank's part on ``device``.  ``mesh``: the port's mesh, a
        ``mesh`` config dict or a ``MeshConfig`` (default: the config's
        ``mesh`` block over the started process group).
        ``partition_rules`` / ``tp_spec_fn``: the layout inputs of the JAX
        engine (a family name, a rule table or a ``(path, shape) -> spec``
        callable); they keep tensor-parallel leaves out of the flat plan.
        ``mesh_check(sizes)``: the model's refusals of a mesh, raised here
        (``gpt2.check_mesh`` / ``bert.check_mesh`` bound to the config).
        ``comm_model(sizes, rows, T, act_bytes, gas=, labels_given=)``: the
        model's activation collectives (``gpt2.parallel_comm_model`` /
        ``bert.parallel_comm_model`` bound to the config), which
        :meth:`comm_summary` evaluates at a micro-batch's shape."""
        from deepspeed_tpu_torch.comm.mesh import Mesh, MeshInfo
        from deepspeed_tpu_torch.runtime.zero.partition import ZeroLayout
        from deepspeed_tpu_torch.runtime.zero.stages import ZeroShardingRules
        from deepspeed_tpu_torch.sharding.mesh import MeshTopology, build_mesh
        from deepspeed_tpu_torch.sharding.rules import PartitionRules

        self.device = resolve_device(device)
        self.config = config
        self._model_fn = model
        self._loss_fn = loss_fn
        self._comm_model = comm_model

        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.loss_scaler = LossScaler.from_config(config.fp16)

        # -- mesh and ZeRO rules ------------------------------------------
        if isinstance(mesh, Mesh):
            self.mesh, self.topology = mesh, MeshTopology.single_slice(mesh.sizes)
        else:
            self.mesh, self.topology = build_mesh(config.mesh if mesh is None else mesh)
        self.mesh_info = MeshInfo.from_mesh(self.mesh)
        self.global_rank = self.mesh.rank
        self.world_size = self.mesh.world_size
        self.dp_world_size = self.mesh_info.dp_world_size
        self.partition_rules = PartitionRules.coerce(partition_rules, tp_spec_fn)
        zc = config.zero_config
        if zc.offload_optimizer.enabled:
            # the host optimizer owns the update over its own flat slices:
            # the device keeps whole compute-type parameters and reduces
            # whole gradients, whatever the stage
            zc = dataclasses.replace(zc, stage=0)
        self.zero_rules = ZeroShardingRules(
            zc,
            fsdp_size=self.mesh_info.fsdp_world_size,
            tp_spec_fn=self.partition_rules.tp_spec_fn(),
            data_size=self.mesh_info.sizes.get("data", 1),
        )

        # -- f32 masters: this rank's part of each leaf, on the device ------
        leaves, self._unflatten = tree_flatten(params)
        self._paths = tree_paths(params)
        shapes = [tuple(np.shape(x)) for x in leaves]
        self._check_parallel(mesh_check, shapes)
        self.layout = ZeroLayout(self.mesh, self.zero_rules, shapes, self._paths)
        # LAMB's norms reduce over the axes that cut each leaf's state
        self.mesh.ensure_groups(sorted({self.layout.update_axes(i) for i in range(len(leaves))}))
        self._host_opt = None
        if self._check_offload(model, optimizer):
            self._init_host_offload(leaves)
            leaves = []
        self._params: List[torch.Tensor] = self._params if self._host_opt is not None else []
        for i, x in enumerate(leaves):
            full = (torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)
                    if not isinstance(x, torch.Tensor)
                    else x.detach().to(device=self.device, dtype=torch.float32, copy=True))
            leaf = self.layout.leaves[i]
            if leaf.flat is not None or self.layout.sharded(leaf.param_spec):
                full = self.layout.from_natural(i, full, leaf.param_spec).contiguous()
            self._params.append(full)
        for p in self._params:
            p.requires_grad_(True)
        self._grad_acc: List[Optional[torch.Tensor]] = [None] * len(self._params)
        self._stage3 = any(self.layout.param_sharded(i) for i in range(len(self._params)))

        # -- optimizer and schedule (state on this rank's update slices) ----
        self.optimizer = optimizer if optimizer is not None else self._configure_basic_optimizer()
        self.lr_schedule = self._configure_lr_schedule(lr_scheduler)
        self.client_lr_scheduler = lr_scheduler
        self.opt_state = None  # offload: the host optimizer holds it
        self._state_cuts = None
        if self._host_opt is None:
            with torch.no_grad():
                params = [self._update_param(i) for i in range(len(self._params))]
                if getattr(self.optimizer, "state_precision", "fp32") == "8bit":
                    self.opt_state = self.optimizer.init(
                        params, whole=[int(np.prod(leaf.shape)) for leaf in self.layout.leaves])
                    self._init_state_cuts()
                else:
                    self.opt_state = self.optimizer.init(params)
        self.loss_scale_state = self.loss_scaler.init(self.device)
        # a static scaler's scale on the host (load_checkpoint refreshes it)
        self._static_scale = self.loss_scaler.init_scale
        self._init_training_extras(config)

        self.skipped_steps = 0
        self._host_global_step = 0
        self._host_micro_step = 0
        self.global_samples = 0
        self._cached_loss = None
        self._last_loss = None  # the boundary's divergence check_loss reads it
        self._last_info: Dict[str, Any] = {}
        self._peer_preempt = False  # a preemption seen by any rank (the step scalars)
        self._init_onebit()
        self._init_telemetry(config)
        self._init_comm_layer(config)
        self._init_resilience_and_overlap(config)
        log_dist(
            f"engine: device={self.device} dtype={self.compute_dtype} "
            f"micro_bs={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} zero_stage={self.zero_stage} "
            f"mesh={self.mesh} ({sum(self.layout.update_sharded(i) for i in range(len(self._params)))}"
            f" of {len(self._params)} leaves update-sharded, "
            f"{sum(self.layout.param_sharded(i) for i in range(len(self._params)))} param-sharded)"
        )

    def _check_offload(self, model, optimizer) -> bool:
        """The JAX engine's offload checks (``engine.py:149-191``): a model
        without a ``stream_spec`` under ``offload_param`` keeps its
        parameters on the device, with the JAX warning; ``offload_optimizer``
        refuses a client optimizer and any optimizer but Adam/AdamW.
        Returns whether the optimizer is offloaded."""
        from deepspeed_tpu_torch.runtime.zero.offload import host_optimizer_refusal

        zc = self.config.zero_config
        if zc.offload_param.enabled and getattr(model, "stream_spec", None) is None:
            logger.warning(
                "offload_param: model exposes no stream_spec, so params stay "
                "device-resident; models.gpt2.make_model provides the layer-streaming path")
        if not zc.offload_optimizer.enabled:
            return False
        reason = host_optimizer_refusal(self.config, optimizer)
        if reason is not None:
            raise ValueError(f"offload_optimizer: {reason}")
        if self.mesh.sizes["pipe"] > 1:
            raise NotImplementedError(
                "offload_optimizer with a pipe axis: the pipeline engine owns its layout and "
                "refuses offload, as the JAX package's does")
        return True

    def _init_training_extras(self, config) -> None:
        """The activation checkpointing block published to
        ``runtime/activation_checkpointing`` (the JAX engine's
        ``configure`` call), MoQ's quantizer and PLD's schedule, and
        MoQ under offload's refusal (the JAX engine's rule).  The 8-bit
        state's blocks and MoQ's quantization groups are the whole leaf's
        wherever ranks cut it (:meth:`_init_state_cuts`,
        :meth:`_quantize_masters`)."""
        from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as act_ckpt

        act_ckpt.configure(deepspeed_config=config)
        self.quantizer = None
        if config.quantize_training.enabled:
            if self._host_opt is not None:
                raise NotImplementedError(
                    "quantize_training (MoQ) is not supported with offload_optimizer")
            from deepspeed_tpu_torch.runtime.quantize import Quantizer

            self.quantizer = Quantizer(config.quantize_training)
        self.progressive_layer_drop = None
        if config.progressive_layer_drop.enabled:
            from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop

            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=config.progressive_layer_drop.theta,
                gamma=config.progressive_layer_drop.gamma)

    def _init_state_cuts(self) -> None:
        """The 8-bit state's blocks on leaves cut across ranks (ZeRO's update
        slices, stage 3's shards, ``model`` blocks): for each such leaf with
        blocks, where its slice sits in the natural leaf (one index vector
        a dimension of the slice, so each chunk's blocks are worked out as
        it steps) and the max over the ranks holding its other slices, so
        every block scale is the one-rank value (the JAX engine's blocks
        span the whole leaf, ``engine.py:841-857``)."""
        from deepspeed_tpu_torch.comm import collectives
        from deepspeed_tpu_torch.ops.adam.fused_adam import CutBlocks

        layout, cuts = self.layout, []
        for i, leaf in enumerate(layout.leaves):
            n = int(np.prod(leaf.shape))
            b = self.optimizer._v_blocks(n)
            if not b or not (layout.sharded(leaf.opt_spec) or leaf.flat is not None):
                cuts.append(None)
                continue
            index = [t.to(self.device) for t in layout.natural_index(i, leaf.opt_spec)]
            reduce_max = functools.partial(collectives.all_reduce,
                                           group=self.mesh.group(layout.update_axes(i)),
                                           kind="state-scales", op="max")
            cuts.append(CutBlocks(index=index, n=n, block=b, reduce_max=reduce_max))
        self._state_cuts = cuts if any(c is not None for c in cuts) else None

    def _rounding_generator(self) -> torch.Generator:
        """The reduced Adam state's stochastic-rounding bits for this step,
        on the device: fresh each step, from the seed and the global step
        (the JAX engine folds ``global_step + 997_001`` into its key;
        ROADMAP C4)."""
        seed = (self.config.seed * 1_000_003 + 997_001 + self._host_global_step) ^ (1 << 61)
        return torch.Generator(device=self.device).manual_seed(seed & _SEED_MASK)

    # the axes whose ranks hold the same parameter blocks under offload:
    # the host masters are cut into flat slices over them
    _OFFLOAD_SLICE_AXES = ("data", "fsdp", "seq")

    def _offload_shard_count(self) -> int:
        """How many flat slices the f32 masters and moments (this rank's
        blocks of them under a ``model`` or ``expert`` axis) are cut into
        (the JAX engine's ``_offload_shards``, ``engine.py:166-183``):
        across ranks one a rank of the ``data x fsdp x seq`` grid that
        holds the same blocks; in one process ``DS_OFFLOAD_SHARDS`` (the
        JAX package's simulated hosts: this process steps every slice)."""
        env = int(os.environ.get("DS_OFFLOAD_SHARDS", "1"))
        if self.world_size > 1:
            P = self.mesh.size(self._OFFLOAD_SLICE_AXES)
            if env > 1 and env != P:
                logger.warning(f"DS_OFFLOAD_SHARDS={env} ignored: with {P} processes holding "
                               "the same blocks each owns exactly one slice")
            return P
        return max(1, env)

    def _host_block(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of leaf ``i`` (its natural whole ``full``, on
        the host) as the host optimizer holds it: the stored shape cut by
        the held axes (``model``, ``expert``), contiguous."""
        leaf = self.layout.leaves[i]
        return self.layout.from_natural(i, full.float(), leaf.param_spec).contiguous()

    def _host_natural(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole and natural, on the host, from this rank's
        block ``t`` of it (gathered over the held axes on the engine's
        device: collective where a held axis cuts the leaf)."""
        if not self.layout.tp_sharded(i):
            return self.layout.from_state(i, t)
        whole = self.layout.natural(i, t.to(self.device), self.layout.leaves[i].param_spec)
        return whole.to("cpu")

    def _init_host_offload(self, leaves: List[Any]) -> None:
        """The host optimizer (the JAX engine's
        ``_configure_host_offload_optimizer``, ``engine.py:586-623``) and the
        pinned buffers of the boundary's copies, allocated once; the device
        keeps the parameters in the compute type.  With P > 1 slices the
        masters are packed flat (``pack_flat``, padded to a multiple of P)
        and this rank keeps slice ``[r L, (r+1) L)`` with its moments (every
        slice in one process), under ``nvme`` in ``shard<i>/``; after each
        step the updated slices are all-gathered into one pinned f32
        buffer, whose views are the whole masters."""
        from deepspeed_tpu_torch.runtime.fp16.onebit.adam import pack_flat, unpack_flat
        from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

        oc = self.config.zero_config.offload_optimizer
        nvme_dir = None
        if oc.device == "nvme":
            if not oc.nvme_path:
                raise ValueError("offload_optimizer.device=nvme requires nvme_path")
            nvme_dir = os.path.join(oc.nvme_path, "zero_infinity_swap")
        pin = self.device.type == "cuda"
        # this rank's block of every leaf (the leaf itself where no held
        # axis cuts it), as the device computes with it
        leaves = [self._host_block(i, x.detach().cpu() if isinstance(x, torch.Tensor)
                                   else torch.from_numpy(np.ascontiguousarray(np.asarray(x))))
                  for i, x in enumerate(leaves)]
        held = tuple(a for a in HELD_AXES if self.mesh.sizes[a] > 1)
        self._offload_blocks = self.mesh.size(held)
        block = self.mesh.chunk_index(held)
        P = self._offload_shards = self._offload_shard_count()
        self._host_pg = None
        if nvme_dir is not None and self._offload_blocks > 1:
            nvme_dir = os.path.join(nvme_dir, f"block{block}")
        if P <= 1:
            if nvme_dir is not None:
                os.makedirs(nvme_dir, exist_ok=True)
            self._host_opts = [HostOffloadOptimizer.from_config(
                self.config, list(zip(self._paths, leaves)), nvme_swap_dir=nvme_dir,
                pin_memory=pin)]
            self._host_shard_ids = [block]
            self._masters_full = self._host_opts[0].masters
            self._host_grads = [torch.empty(m.shape, dtype=torch.float32, pin_memory=pin)
                                for m in self._masters_full]
        else:
            flat = pack_flat(leaves, P)
            L = self._offload_slice_len = flat.numel() // P
            if self.world_size > 1:
                from deepspeed_tpu_torch.comm import collectives

                axes = tuple(a for a in self._OFFLOAD_SLICE_AXES if self.mesh.sizes[a] > 1)
                sets = self.mesh.group_ranks(axes)
                mine = next(r for r in sets if self.global_rank in r)
                slices = [mine.index(self.global_rank)]
                # gloo over the ranks holding the same blocks (group order
                # is slice order: each set is sorted)
                self._host_pg = collectives.host_group(sets)
            else:
                slices = list(range(P))
            # a slice's name counts every block's slices: block b's slice s
            self._host_shard_ids = [block * P + j for j in slices]

            def shard(j):
                nv = None if nvme_dir is None else os.path.join(nvme_dir, f"shard{j}")
                if nv is not None:
                    os.makedirs(nv, exist_ok=True)
                return HostOffloadOptimizer.from_config(
                    self.config, [("flat", flat[j * L:(j + 1) * L])], nvme_swap_dir=nv,
                    pin_memory=pin)

            self._host_opts = [shard(j) for j in slices]
            self._gathered = torch.empty(P * L, dtype=torch.float32, pin_memory=pin)
            self._gathered.copy_(flat)
            del flat
            self._masters_full = [v.view(t.shape) for v, t in zip(
                unpack_flat(self._gathered, [t.reshape(-1) for t in leaves]), leaves)]
            self._host_grads = [torch.empty(L, dtype=torch.float32, pin_memory=pin)
                                for _ in slices]
            log_dist(f"ZeRO-Offload: masters sharded 1/{P} per host "
                     f"({L * 4 / 1e9:.2f} GB master slice/host)")
        self._host_opt = self._host_opts[0]
        masters = self._masters_full
        self._host_cast = ([torch.empty(m.shape, dtype=self.compute_dtype, pin_memory=pin)
                            for m in masters] if self.compute_dtype != torch.float32 else None)
        self._d2h_stream = torch.cuda.Stream(self.device) if pin else None
        self._h2d_done = None  # the event of the last copy out of the pinned buffers
        self._offload_events: Dict[str, Any] = {}
        self.offload_timing: Dict[str, float] = {}
        with torch.no_grad():
            # a copy, never the master itself (the CPU in f32 would alias it)
            self._params = [m.to(self.device, non_blocking=True).to(self.compute_dtype, copy=True)
                            for m in masters]
        log_dist(f"ZeRO-Offload: {sum(m.numel() for m in masters)} parameters, "
                 f"{self.compute_dtype} on {self.device}, f32 masters+moments on the host "
                 f"({oc.device})")

    def host_master_bytes(self) -> int:
        """The bytes of the f32 masters this rank's host optimizer(s) own."""
        return sum(m.numel() * 4 for opt in self._host_opts for m in opt.masters)

    def _check_parallel(self, mesh_check, shapes) -> None:
        """The refusals of a ``model`` or ``seq`` axis, before any leaf is
        cut: the model's own (``mesh_check``), a ``model`` axis with
        no tensor-parallel leaf, and every tensor-parallel dimension the
        ``model`` axis does not divide (the JAX package's words, in
        ``sharding/rules.py`` ``check_model_cut``)."""
        from deepspeed_tpu_torch.sharding.rules import check_model_cut

        sizes = self.mesh.sizes
        if mesh_check is not None:
            mesh_check(dict(sizes))
        m = sizes["model"]
        if m <= 1:
            return
        if not check_model_cut(zip(self._paths, shapes), self.partition_rules.tp_spec_fn(), m):
            raise ValueError(
                f"mesh.model = {m} needs the model's tensor-parallel specs: pass "
                "tp_spec_fn (make_model's third value) or partition_rules")

    def _dp_group(self):
        """The data-parallel grid's group (``data x fsdp``), None at one rank."""
        return self.mesh.group(("data", "fsdp"))

    def _explicit_refusal(self) -> Optional[str]:
        """Why the port cannot run an explicit (1-bit or compressed)
        exchange on this engine's layout, or None.  Each ``model`` rank
        exchanges the rows of its own blocks over its data-parallel grid
        (``seq`` ranks sum their rows first, stage 3 keeps each rank's
        gradients unreduced); an ``expert`` or ``pipe`` axis is not ported
        (the JAX package composes them under GSPMD)."""
        other = [a for a in ("expert", "pipe") if self.mesh.sizes[a] > 1]
        if other:
            return f"a {'/'.join(other)} axis"
        return None

    def _init_onebit(self) -> None:
        """The 1-bit optimizers' compressed phase (the JAX engine's
        ``engine.py:309-365``): after ``freeze_step`` every rank keeps its
        own gradients and one 1-bit momentum exchange a step crosses the
        wire.  Its blockers: a data-parallel grid of one rank, offload;
        otherwise the optimizer falls back to its local quantization under
        the dense exchange, with the JAX package's warning.  The warm
        state lives on ZeRO's update slices; the compressed phase's is
        replicated over the data-parallel grid (per ``model`` rank, its
        blocks), with the JAX package's warning of its bytes."""
        from deepspeed_tpu_torch.runtime.fp16.onebit.adam import OnebitAdam

        self._onebit_frozen = False
        self._onebit_exchange_ok = False
        if not isinstance(self.optimizer, OnebitAdam):
            return
        reason = self._explicit_refusal()
        if reason is not None:
            raise NotImplementedError(
                f"1-bit {type(self.optimizer).__name__} under {reason} is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A13, the compositions)")
        blockers = {"data-parallel grid must be > 1": self.dp_world_size > 1,
                    "offload_optimizer unsupported": self._host_opt is None,
                    "quantize_training (MoQ) unsupported": self.quantizer is None,
                    "progressive_layer_drop unsupported": self.progressive_layer_drop is None}
        self._onebit_exchange_ok = all(blockers.values())
        if not self._onebit_exchange_ok:
            failed = [k for k, ok in blockers.items() if not ok]
            cut = [i for i in range(len(self._params)) if self.layout.update_axes(i)]
            if cut:
                raise NotImplementedError(
                    f"1-bit {type(self.optimizer).__name__}'s local quantization fallback "
                    f"({'; '.join(failed)}) on leaves cut across ranks is not ported to "
                    "deepspeed_tpu_torch yet (ROADMAP A13, the compositions): its scale is a "
                    "whole leaf's mean")
            logger.warning(
                f"1-bit {type(self.optimizer).__name__}: compressed gradient exchange DISABLED "
                "— the optimizer will fall back to local momentum quantization with "
                f"full-precision allreduce ({'; '.join(failed)})")
        elif any(self.layout.update_sharded(i) for i in range(len(self._params))):
            n_p = sum(self.layout.local_numel(i) for i in range(len(self._params)))
            logger.warning(
                "1-bit optimizer + ZeRO: the compressed phase replicates the momentum signs "
                "(int8) + flat fp32 variance/params and keeps a per-rank fp32 worker-error row "
                f"(~{13 * n_p / 2**30:.1f}GiB static per rank, plus fp32 momentum/grad "
                "transients during the step) — ZeRO's state sharding does not apply after "
                "freeze_step")

    def _init_telemetry(self, config) -> None:
        """The telemetry plane (the JAX engine's ``engine.py:433-453``),
        armed BEFORE the comm layer so its strategy decisions land in the
        registry; the TensorBoard monitor (a sink: the loss/lr/loss-scale
        events go through the manager), the flops profiler, the
        CUDA-event timers, and the throughput timer where the breakdown or
        the monitor reads it (its report waits for the card)."""
        from deepspeed_tpu_torch import telemetry as _telemetry
        from deepspeed_tpu_torch.config.config import (
            FlopsProfilerConfig,
            TelemetryConfig,
            TensorboardConfig,
        )
        from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler, device_name
        from deepspeed_tpu_torch.utils.monitor import TensorBoardMonitor
        from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer, ThroughputTimer

        tb = getattr(config, "tensorboard", None) or TensorboardConfig()
        self.monitor = TensorBoardMonitor(output_path=tb.output_path, job_name=tb.job_name,
                                          enabled=tb.enabled, rank=self.global_rank)
        self.telemetry = _telemetry.configure(
            getattr(config, "telemetry", None) or TelemetryConfig(), rank=self.global_rank,
            label="train", monitor=self.monitor, device_name=device_name(self.device))
        self.flops_profiler = FlopsProfiler(
            getattr(config, "flops_profiler", None) or FlopsProfilerConfig(), engine=self)
        self.timers = SynchronizedWallClockTimer(self.device)
        self.wall_clock_breakdown = bool(getattr(config, "wall_clock_breakdown", False))
        self.tput_timer = (ThroughputTimer(batch_size=config.train_batch_size,
                                           steps_per_output=config.steps_per_print,
                                           device=self.device)
                           if self.wall_clock_breakdown or self.monitor.enabled else None)
        self._step_cost: Dict[str, float] = {}
        # the first step is counted, the second (when a sink reads it) timed
        self._attr_stage = ("count" if self.telemetry.attribution_armed
                            or self.flops_profiler.enabled else None)

    def _init_comm_layer(self, config) -> None:
        """The comm layer (the JAX engine's ``_init_comm_layer``): resolve
        the gradient exchange's strategy once; ``int8`` / ``onebit`` switch
        ``train_batch`` to the explicit step (each rank's gradient row,
        one compressed exchange a step, :meth:`_explicit_step`), unless a
        blocker forces dense (the JAX package's warning).  The onebit
        strategy's error-feedback residuals ride checkpoints as
        ``comm/``.  Records the forced-dense fallback of
        ``reduce_scatter: false``."""
        from deepspeed_tpu_torch.comm.strategy import STRATEGY_DENSE, STRATEGY_ONEBIT, CommLayer
        from deepspeed_tpu_torch.config.config import CommConfig

        self.comm = CommLayer(self.mesh, self.mesh_info, getattr(config, "comm", None) or CommConfig(),
                              zero_config=config.zero_config, topology=self.topology)
        if (config.zero_config.stage >= 2 and self.mesh_info.fsdp_world_size > 1
                and not config.zero_config.reduce_scatter):
            self.comm.note("zero-grad-reduce", STRATEGY_DENSE,
                           "zero_optimization.reduce_scatter=false forces the dense all-reduce path")
            logger.warning(
                "zero_optimization.reduce_scatter=false: gradient reduction stays a full "
                "all-reduce (grads replicated over fsdp) — ~2x the wire bytes and a "
                "params-sized grad buffer per rank")
        if getattr(self, "_host_pg", None) is not None:
            self.comm.note("offload-masters-allgather", STRATEGY_DENSE,
                           "host all-gather of the f32 master slices (pinned tensors on a gloo "
                           "group)")
        # one model rank's elements: the blocks its collectives move
        self._comm_n_params = sum(self.layout.local_numel(i)
                                  for i in range(len(self.layout.leaves)))
        n = max(1, self.dp_world_size)
        self._comm_flat_len = self._row_len()
        want = self.comm.select(4 * self._comm_n_params, torch.float32, ("data", "fsdp"),
                                site="grad-exchange")
        explicit = want != STRATEGY_DENSE
        if explicit:
            blockers = {
                "data-parallel grid must be > 1": self.dp_world_size > 1,
                "offload_optimizer unsupported": self._host_opt is None,
                "1-bit optimizer owns its own exchange": not self._onebit_exchange_ok,
            }
            failed = [k for k, ok in blockers.items() if not ok]
            if failed:
                logger.warning(
                    f"comm: '{want}' gradient exchange requested but DISABLED "
                    f"({'; '.join(failed)}); falling back to dense")
                self.comm.note("grad-exchange", STRATEGY_DENSE,
                               f"forced dense: {'; '.join(failed)}")
                want, explicit = STRATEGY_DENSE, False
        if explicit and self._explicit_refusal() is not None:
            raise NotImplementedError(
                f"comm.strategy '{want}' under {self._explicit_refusal()} is not ported to "
                "deepspeed_tpu_torch yet (ROADMAP A13, the compositions)")
        self._comm_grad_strategy = want
        self._comm_explicit = explicit
        self._comm_residuals = None
        if explicit and want == STRATEGY_ONEBIT and self.comm.config.error_feedback:
            mp = self._comm_flat_len
            self._comm_residuals = (torch.zeros(mp, device=self.device),
                                    torch.zeros(mp // n, device=self.device))
        if explicit:
            log_dist(f"comm: '{want}' gradient exchange over ('data', 'fsdp') (n={n} ranks, "
                     f"{self._comm_flat_len} padded coords, "
                     f"{'EF residuals in state' if self._comm_residuals else 'stateless'})")
        if self.telemetry.collect:
            self.telemetry.set_comm(self.comm_summary())

    def comm_summary(self, rows: Optional[int] = None, seq_len: Optional[int] = None,
                     labels_given: bool = False) -> Dict[str, Any]:
        """The strategy table and the per-step byte model: the JAX package's
        ``step_comm_bytes`` (``param_bytes`` is the compute type's size)
        and the port's own ``update-all-gather`` and ``seq-grad-exchange``
        (``runtime/zero/stages.py::port_step_comm_extras``), over one
        ``model`` rank's elements; with the engine's ``comm_model`` and a
        micro-batch's shape (``rows`` of ``seq_len`` tokens, this rank's
        rows, every position), ``parallel``: the activations' collectives
        of the model under tensor and sequence parallelism."""
        from deepspeed_tpu_torch.comm.strategy import step_comm_bytes
        from deepspeed_tpu_torch.runtime.zero.stages import port_step_comm_extras

        model = step_comm_bytes(
            self._comm_n_params, self.mesh_info.sizes, stage=self.zero_stage,
            gas=self.gradient_accumulation_steps, strategy=self._comm_grad_strategy,
            param_bytes=torch.finfo(self.compute_dtype).bits // 8,
            reduce_scatter=self.config.zero_config.reduce_scatter, topology=self.topology)
        extras = port_step_comm_extras(
            self._comm_n_params, self.mesh_info.sizes, stage=self.zero_stage,
            cross_replica=self.config.zero_config.cross_replica_weight_update,
            gas=self.gradient_accumulation_steps)
        out = {"strategy": self._comm_grad_strategy,
               "grad_exchange_bytes": model["grad-exchange"], "model": model,
               "extras": extras, "table": self.comm.table()}
        if self._comm_model is not None and rows is not None:
            out["parallel"] = self._comm_model(
                dict(self.mesh.sizes), rows, seq_len, torch.finfo(self.compute_dtype).bits // 8,
                gas=self.gradient_accumulation_steps, labels_given=labels_given)
        return out

    def _init_resilience_and_overlap(self, config) -> None:
        """The ``resilience`` block (divergence guard, preemption watchdog,
        fault plan from ``DS_FAULT_PLAN``) and the ``overlap`` block (step
        timeline, async checkpoint writer); engines built without them
        take the defaults."""
        from deepspeed_tpu_torch.config.config import OverlapConfig, ResilienceConfig
        from deepspeed_tpu_torch.resilience import DivergenceGuard, PreemptionWatchdog, faults
        from deepspeed_tpu_torch.runtime.overlap import AsyncCheckpointWriter, StepTimeline

        self.resilience = getattr(config, "resilience", None) or ResilienceConfig()
        div = self.resilience.divergence
        self._divergence_guard = (DivergenceGuard(threshold=div.threshold, action=div.action)
                                  if div.enabled else None)
        # the directory emergency saves / auto-rollback target: explicit
        # watchdog.save_dir, else wherever the run last saved/loaded
        self._resilience_ckpt_dir: Optional[str] = self.resilience.watchdog.save_dir
        self._watchdog = None
        if self.resilience.watchdog.enabled:
            self._watchdog = PreemptionWatchdog(
                grace_seconds=self.resilience.watchdog.grace_seconds,
                exit_code=self.resilience.watchdog.exit_code,
            ).install()
        faults.install_from_env()
        self._train_loader = None  # registered resumable dataloader

        self.overlap = getattr(config, "overlap", None) or OverlapConfig()
        self.timeline = StepTimeline(enabled=self.overlap.timeline.enabled,
                                     window=self.overlap.timeline.window)
        if self.telemetry.collect or self.telemetry.tracer.enabled:
            self.timeline.attach_telemetry(self.telemetry, prefix="train")
        # the fence (a synchronize per step) follows wall_clock_breakdown
        # when unset, whose timers already read the card at report time
        fence = self.overlap.timeline.fence
        self._timeline_fence = self.wall_clock_breakdown if fence is None else bool(fence)
        self._async_writer = (
            AsyncCheckpointWriter(
                drain_timeout_seconds=self.overlap.async_checkpoint.drain_timeout_seconds)
            if self.overlap.async_checkpoint.enabled else None
        )
        self._copy_stream = None  # prefetch_loader's host-to-device stream

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
            return FusedLamb(lr=lr, **params)
        if name == C.ONEBIT_ADAM_OPTIMIZER:
            from deepspeed_tpu_torch.runtime.fp16.onebit.adam import OnebitAdam

            return OnebitAdam(lr=lr, fsdp_size=self.mesh_info.fsdp_world_size, **params)
        if name == C.ONEBIT_LAMB_OPTIMIZER:
            from deepspeed_tpu_torch.runtime.fp16.onebit.lamb import OnebitLamb

            return OnebitLamb(lr=lr, **params)
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
        """The f32 master weights, whole, as the caller's tree (detached).
        Where ZeRO shards them this gathers: read it on every rank.  Under
        offload: the host masters."""
        if self._host_opt is not None:
            return self._unflatten([self._host_natural(i, m)
                                    for i, m in enumerate(self._masters_full)])
        return self._unflatten([self.layout.natural(i, p.detach(), self.layout.leaves[i].param_spec)
                                for i, p in enumerate(self._params)])

    def _update_param(self, i: int) -> torch.Tensor:
        """The masters of leaf ``i``'s optimizer-state slice: the master
        itself where the state is cut as the parameter, else a contiguous
        copy of this rank's slice (the fused kernels refuse views)."""
        leaf = self.layout.leaves[i]
        p = self._params[i].detach()
        if not self.layout.update_sharded(i):
            return p
        return self.layout.narrow(p, leaf.state_shape, leaf.param_spec, leaf.opt_spec).contiguous()

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

    def _materialize_params(self, ctx=None) -> Any:
        """The masters cast to the compute type, as the caller's tree; the
        cast's backward hands f32 gradients to the masters.  With a stage-3
        context ``ctx`` a sharded leaf is a handle the model gathers on use
        (``runtime/zero/partition.py``)."""
        out = []
        for i, p in enumerate(self._params):
            if ctx is not None and self.layout.param_sharded(i):
                out.append(ctx.leaf(i))
            else:
                out.append(self.layout.from_state(i, p).to(self.compute_dtype))
        return self._unflatten(out)

    def _generator(self) -> torch.Generator:
        seed = (self.config.seed * 1_000_003 + self._host_micro_step) & _SEED_MASK
        return torch.Generator().manual_seed(seed)

    def _compute_loss(self, batch: Any, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self._stage3:
            return self._loss_of(self._materialize_params(), batch, generator)
        from deepspeed_tpu_torch.runtime.zero.partition import Stage3Context

        ctx = Stage3Context(self.layout, self._params, self.compute_dtype,
                            local=self._local_sink if self._local_grads() else None)
        with ctx.hooks():
            loss = self._loss_of(self._materialize_params(ctx), batch, generator)
        ctx.end_forward()
        return loss

    def _loss_of(self, params: Any, batch: Any, generator) -> torch.Tensor:
        with ambient_mesh(self.mesh):
            out = self._model_fn(params, batch, generator)
        loss = self._loss_fn(out, batch) if self._loss_fn is not None else out
        loss = torch.as_tensor(loss)
        return loss.mean() if loss.ndim != 0 else loss

    def _micro_step(self, batch: Any) -> torch.Tensor:
        """Forward and backward of one micro-batch on the device; the
        gradients, reduced over the data-parallel grid, add into the
        accumulator."""
        if self.progressive_layer_drop is not None and isinstance(batch, dict):
            from deepspeed_tpu_torch.runtime.progressive_layer_drop import PLD_THETA_KEY

            batch = {**batch, PLD_THETA_KEY: self.progressive_layer_drop.get_theta(
                self._host_global_step)}
        loss = self._compute_loss(batch, self._generator())
        self.loss_scaler.scale_loss(loss.float(), self.loss_scale_state).backward()
        self._accumulate()
        self._host_micro_step += 1
        self.global_samples += self.train_micro_batch_size_per_gpu * self.dp_world_size
        return loss.detach()

    @torch.no_grad()
    def _accumulate(self) -> None:
        """Move each master's ``.grad`` into the accumulator, reduced as the
        stage says (stage 3's sharded leaves were reduced in the backward).
        A leaf the loss did not reach contributes zeros, so every rank
        issues the same collectives."""
        local = self._local_grads()
        reduces = not local and self.dp_world_size * self.mesh.sizes["seq"] > 1
        for i, p in enumerate(self._params):
            g, p.grad = p.grad, None
            if g is None:
                if not reduces:
                    continue
                g = torch.zeros_like(p)
            if not self.layout.param_sharded(i) and not local:
                g = self.layout.reduce_grad(i, g)
            if g.dtype != torch.float32:  # offload: the compute-type leaves' gradients
                g = g.float()
            acc = self._grad_acc[i]
            self._grad_acc[i] = g if acc is None else acc.add_(g)

    @torch.no_grad()
    def _apply_step(self, loss: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Optimizer step at the accumulation boundary (the JAX engine's
        ``_apply_step_impl`` + ``_apply_update``) on this rank's update
        slices; ``loss`` (this rank's mean loss) comes back as the global
        batch's mean under ``info["loss"]``."""
        if self._local_grads():
            return self._explicit_step(loss)
        grads, overflow, grad_norm, loss = self._boundary_grads(loss)
        if self._host_opt is not None:
            return self._host_apply_step(grads, overflow, grad_norm, loss)
        return self._update(grads, overflow, grad_norm, loss)

    def _update(self, grads, overflow, grad_norm, loss) -> Dict[str, Any]:
        """The update of this rank's slices from the boundary's gradients
        (on the optimizer-state slices), then the updated masters gathered
        back to the parameter spec."""
        layout, n = self.layout, len(self._params)
        lr = float(self.lr_schedule(self._host_global_step))
        params = [self._update_param(i) for i in range(n)]
        state = engine_update(self.optimizer, grads, self.opt_state, params, lr, overflow,
                              reduce_norms=self._lamb_norm_reducer())
        if state is None:
            self.opt_state = self._plain_update(grads, params, lr, overflow)
        for i in range(n):
            if layout.update_sharded(i):
                leaf = layout.leaves[i]
                self._params[i].copy_(layout.gather(params[i], leaf.opt_spec, leaf.param_spec,
                                                    "update-all-gather"))
        if self.quantizer is not None:
            self._quantize_masters(overflow)
        self.loss_scale_state = self.loss_scaler.update(self.loss_scale_state, overflow)
        return {"lr": lr, "grad_norm": grad_norm, "overflow": overflow, "loss": loss}

    def _boundary_grads(self, loss: Optional[torch.Tensor]):
        """The boundary's gradients on the device: the accumulator
        averaged, unscaled and checked, the global norm reduced (with the
        step's scalars across ranks) and clipped.  Returns ``(grads,
        overflow, grad_norm, loss)``."""
        layout, n = self.layout, len(self._params)
        div = self.gradient_accumulation_steps * self.dp_world_size
        grads = []
        for i, p in enumerate(self._params):
            leaf, acc = layout.leaves[i], self._grad_acc[i]
            if acc is None:
                acc = torch.zeros(layout.narrow(p, leaf.state_shape, leaf.param_spec,
                                                leaf.acc_spec).shape, device=self.device)
            grads.append(layout.narrow(acc, leaf.state_shape, leaf.acc_spec, leaf.opt_spec) / div)
        self._grad_acc = [None] * n
        grads, overflow = self.loss_scaler.unscale_and_check(grads, self.loss_scale_state)
        clip = self.config.gradient_clipping > 0.0
        grad_norm = torch.zeros((), dtype=torch.float32, device=self.device)
        sq = None
        if clip:
            sq = _sum_squares([g for i, g in enumerate(grads) if layout.update_owner(i)],
                              self.device)
        if self.world_size > 1:
            # one all-reduce over every rank for the step's scalars: every
            # rank clips, skips, reports and meets a preemption alike; the
            # loss, equal on a row's model and seq ranks, counts once
            from deepspeed_tpu_torch.comm import collectives

            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            wd = self._watchdog
            preempt = torch.full((), float(wd is not None and wd.preemption_requested),
                                 dtype=torch.float32, device=self.device)
            counts_loss = self._counts_loss()
            vec = torch.stack([zero if sq is None else sq, overflow.float(),
                               zero if loss is None or not counts_loss else loss.float(),
                               preempt])
            vec = collectives.all_reduce(vec, self.mesh.world_group(), kind="step-scalars")
            sq, overflow = (vec[0] if clip else None), vec[1] > 0
            if loss is not None:
                loss = vec[2] / self.dp_world_size
            self._peer_preempt = bool(vec[3] > 0)
        if clip:
            grad_norm = torch.sqrt(sq)
            grads = _clip_by_norm(grads, grad_norm, self.config.gradient_clipping)
        return grads, overflow, grad_norm, loss

    # ------------------------------------------------------------------
    # the explicit exchanges: the 1-bit optimizers' compressed phase and
    # comm.strategy int8 / onebit
    # ------------------------------------------------------------------
    def _local_grads(self) -> bool:
        """Whether each rank keeps its own gradients until the step's one
        explicit exchange (no reduction a micro-step)."""
        return self._onebit_frozen or self._comm_explicit

    def _sync_onebit_phase(self, global_step: int) -> None:
        """Align the compressed phase with a tag's step count before a
        restore (``runtime/checkpointing.py``): a tag at ``freeze_step`` is
        still warm (the phase flips at the start of the next
        ``train_batch``); a warm tag rolls a frozen engine back."""
        if not self._onebit_exchange_ok:
            return
        if not self._onebit_frozen and global_step > self.optimizer.freeze_step:
            self._enter_onebit_frozen()
        elif self._onebit_frozen and global_step <= self.optimizer.freeze_step:
            self._exit_onebit_frozen()

    def _row_leaf(self, i: int, block: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s part of an explicit exchange's row, from this
        rank's whole block of it (the stored shape cut by the held axes):
        the natural leaf where no ``model`` axis cuts it (unpadded), else
        the block as stored (head-grouped ``qkv``)."""
        return block if self.layout.tp_sharded(i) else self.layout.from_state(i, block)

    def _from_row_leaf(self, i: int, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's part of ``spec`` from leaf ``i``'s row part ``t``
        (a view)."""
        leaf = self.layout.leaves[i]
        block = t if self.layout.tp_sharded(i) else self.layout.to_state(i, t)
        return self.layout.narrow(block, leaf.state_shape, leaf.tp_spec, spec)

    def _row_members(self, lead: Optional[bool] = None) -> List[int]:
        """The leaves in this rank's exchange row (``lead``: in ``model``
        rank 0's): every leaf, or under a ``model`` axis the blocks it cuts
        and, on ``model`` rank 0 alone, the replicated leaves (each element
        is exchanged once; the other ``model`` ranks take those from it,
        :meth:`_from_lead`)."""
        lead = self.mesh.coords["model"] == 0 if lead is None else lead
        return [i for i in range(len(self._params)) if lead or self.layout.tp_sharded(i)]

    def _row_numel(self, lead: Optional[bool] = None) -> int:
        return sum(int(np.prod(self.layout.leaves[i].shape)) if not self.layout.tp_sharded(i)
                   else int(np.prod(self._block_shape(i))) for i in self._row_members(lead))

    def _row_len(self) -> int:
        """Every rank's exchange row's length: ``model`` rank 0's elements
        (the longest row) padded to the data-parallel grid."""
        dp = max(1, self.dp_world_size)
        return -(-self._row_numel(lead=True) // dp) * dp

    def _row_parts(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's row parts and, on a ``model`` rank other than 0,
        zeros up to ``model`` rank 0's elements: every ``model`` rank's row
        (and its residuals and frozen state) is of one length."""
        pad = self._row_numel(lead=True) - self._row_numel()
        return parts + [torch.zeros(pad, device=self.device)] if pad else parts

    def _row_leaves(self, tensors: List[torch.Tensor], spec: str,
                    idx: List[int]) -> List[torch.Tensor]:
        """Leaves ``idx`` of tensors in each leaf's ``spec``
        (``"param_spec"``, ``"opt_spec"``) as row parts: gathered over the
        stage's axes up to the held block (a collective where ZeRO cuts a
        leaf), then :meth:`_row_leaf`."""
        out = []
        for i in idx:
            leaf = self.layout.leaves[i]
            t = self.layout.gather(tensors[i].detach(), getattr(leaf, spec), leaf.tp_spec,
                                   "row-gather")
            out.append(self._row_leaf(i, t))
        return out

    def _model_sum(self, sq: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's row, summed over the ``model`` axis (the
        whole row of a data rank)."""
        if self.mesh.sizes["model"] <= 1:
            return sq
        from deepspeed_tpu_torch.comm import collectives

        return collectives.all_reduce(sq, self.mesh.group(("model",)), kind="step-scalars")

    def _from_lead(self, parts: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """The replicated leaves' row parts of ``model`` rank 0 on every
        ``model`` rank (one all-reduce over ``model`` to which the other
        ranks add zeros: the lead's bits); nothing without a ``model``
        axis."""
        from deepspeed_tpu_torch.runtime.fp16.onebit.adam import pack_flat, unpack_flat

        rep = [i for i in range(len(self._params)) if not self.layout.tp_sharded(i)]
        if self.mesh.sizes["model"] <= 1 or not rep:
            return {}
        from deepspeed_tpu_torch.comm import collectives

        shapes = [self.layout.leaves[i].shape for i in rep]
        if self.mesh.coords["model"] == 0:
            flat = pack_flat([parts[i] for i in rep], 1)
        else:
            flat = torch.zeros(sum(int(np.prod(sh)) for sh in shapes), device=self.device)
        flat = collectives.all_reduce(flat, self.mesh.group(("model",)), kind="model-replicated")
        return dict(zip(rep, unpack_flat(flat, [torch.empty(sh, device="meta") for sh in shapes])))

    def _held_stack(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's exchange row (a frozen 1-bit state's
        field, an exchange's residuals), stacked over the ``model`` axis
        for a tag (collective), or itself without one."""
        if self.mesh.sizes["model"] <= 1:
            return t
        from deepspeed_tpu_torch.comm import collectives

        return collectives.all_gather(t[None].contiguous(), self.mesh.group(("model",)),
                                      kind="checkpoint")

    def _held_row(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's entry of :meth:`_held_stack`'s stack."""
        return t[self.mesh.coords["model"]] if self.mesh.sizes["model"] > 1 else t

    @torch.no_grad()
    def _enter_onebit_frozen(self) -> None:
        """The warm state in the compressed phase's layout (the JAX engine's
        ``_enter_onebit_frozen``): the momentum as signs and chunk scales,
        the variance flat, this rank's residuals."""
        st, idx = self.opt_state, self._row_members()
        rows = {f: self._row_parts(self._row_leaves(getattr(st, f), "opt_spec", idx))
                for f in ("exp_avg", "exp_avg_sq", "worker_error")}
        rows.update({f.name: [getattr(st, f.name)[i] for i in idx]
                     for f in dataclasses.fields(st)
                     if f.name not in rows and isinstance(getattr(st, f.name), list)})
        self.opt_state = self.optimizer.make_frozen_state(
            dataclasses.replace(st, **rows), self.dp_world_size)
        self._onebit_frozen = True
        self.comm.note("momentum-exchange", "onebit",
                       f"1-bit {type(self.optimizer).__name__} compressed-exchange phase")
        log_dist(f"1-bit {type(self.optimizer).__name__}: entering compressed-exchange phase at "
                 f"step {self._host_global_step} (freeze_step={self.optimizer.freeze_step}, "
                 f"dp_ranks={self.dp_world_size})")

    @torch.no_grad()
    def _exit_onebit_frozen(self) -> None:
        """Back to the warm layout (a pre-freeze tag's restore overwrites
        the values next)."""
        self.opt_state = self.optimizer.init([self._update_param(i)
                                              for i in range(len(self._params))])
        self._onebit_frozen = False
        log_dist(f"1-bit {type(self.optimizer).__name__}: rolled back to warmup (pre-freeze) "
                 "state layout")

    def _step_scalars(self, sq, overflow, loss):
        """One all-reduce over every rank of ``[sq, overflow, loss,
        preemption]``: ``(sq summed, overflow anywhere, the global batch's
        mean loss)``."""
        from deepspeed_tpu_torch.comm import collectives

        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        wd = self._watchdog
        preempt = torch.full((), float(wd is not None and wd.preemption_requested),
                             dtype=torch.float32, device=self.device)
        vec = torch.stack([sq, overflow.float(),
                           zero if loss is None or not self._counts_loss() else loss.float(),
                           preempt])
        vec = collectives.all_reduce(vec, self.mesh.world_group(), kind="step-scalars")
        self._peer_preempt = bool(vec[3] > 0)
        return vec[0], vec[1] > 0, (None if loss is None else vec[2] / self.dp_world_size)

    @torch.no_grad()
    def _explicit_step(self, loss: Optional[torch.Tensor]) -> Dict[str, Any]:
        """The boundary of the explicit paths (the JAX engine's
        ``_frozen_full_step`` and ``_comm_full_step``): this rank's
        accumulated gradients packed flat into its row and unscaled; an
        overflow on any rank skips the step and keeps the residuals.

        * 1-bit frozen phase: the row clipped by its own norm (the
          reference's per-rank clipping; the reported norm is the root of
          the rows' mean square), folded into the synced momentum and
          exchanged 1-bit (``frozen_apply``); the masters move by the
          update.
        * ``comm.strategy`` int8 / onebit: non-finite entries zeroed, one
          compressed exchange of the row, then the dense path's update
          (clipping by the exchanged mean's global norm)."""
        from deepspeed_tpu_torch.runtime.fp16.onebit.adam import pack_flat, unpack_flat

        n, group, layout = self.dp_world_size, self._dp_group(), self.layout
        gas = self.gradient_accumulation_steps
        # this rank's whole blocks (a stage-3 leaf's came from its gather's
        # backward unreduced), as the row's leaves
        idx = self._row_members()
        nat = [self._row_leaf(i, self._grad_acc[i] if self._grad_acc[i] is not None
                              else torch.zeros(self._block_shape(i), device=self.device))
               for i in idx]
        self._grad_acc = [None] * len(self._params)
        scale = self.loss_scale_state.scale.float()
        g_row = pack_flat(self._row_parts(nat), n)
        if self.mesh.sizes["seq"] > 1:
            # each seq rank saw other positions: their sum, once a step
            from deepspeed_tpu_torch.comm import collectives

            g_row = collectives.all_reduce(g_row, self.mesh.group(("seq",)),
                                           kind="seq-grad-exchange")
        g_row = g_row / (gas * scale)
        local_overflow = ~torch.isfinite(torch.sum(g_row))
        clip = self.config.gradient_clipping
        lr = float(self.lr_schedule(self._host_global_step))
        if self._onebit_frozen:
            # the row's norm across the model axis: this data rank's whole
            # gradient; a seq rank's row equals its peers'
            sq_local = self._model_sum(torch.sum(g_row * g_row))
            lead = self.mesh.coords["model"] == 0 and self.mesh.coords["seq"] == 0
            sq, overflow, loss = self._step_scalars(
                sq_local if lead else torch.zeros_like(sq_local), local_overflow, loss)
            grad_norm = torch.sqrt(sq / n)
            if clip > 0.0:
                g_row = g_row * torch.clamp(clip / (torch.sqrt(sq_local) + 1e-6), max=1.0)
            p_nat = self._row_leaves(self._params, "param_spec", idx)
            p_flat = pack_flat(self._row_parts(p_nat), n)
            upd, new_state = self.optimizer.frozen_apply(
                g_row, self.opt_state, p_flat, torch.tensor(lr, device=self.device), group=group)
            new_flat = torch.where(overflow, p_flat, p_flat + upd)
            new = dict(zip(idx, unpack_flat(new_flat, p_nat)))
            new.update(self._from_lead(new))
            for i, t in new.items():
                self._params[i].copy_(self._from_row_leaf(i, t, layout.leaves[i].param_spec))
            self.opt_state = type(new_state)(**{
                f: torch.where(overflow, getattr(self.opt_state, f), getattr(new_state, f))
                for f in new_state.__dataclass_fields__})
            self.loss_scale_state = self.loss_scaler.update(self.loss_scale_state, overflow)
            return {"lr": lr, "grad_norm": grad_norm, "overflow": overflow, "loss": loss}
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        _, overflow, loss = self._step_scalars(zero, local_overflow, loss)
        g_row = torch.where(torch.isfinite(g_row), g_row, torch.zeros((), device=self.device))
        gen = None
        if self._comm_grad_strategy == "int8":
            # fresh bits a step and a rank (the JAX engine folds the step
            # into its key; the draws differ, ROADMAP C4)
            gen = torch.Generator(device=self.device).manual_seed(
                (self.config.seed * 1_000_003 + 777_001 + self._host_global_step * 4099
                 + self.global_rank) & _SEED_MASK)
        g_mean, new_res = self.comm.exchange_rows(g_row, self._comm_grad_strategy, group=group,
                                                  generator=gen,
                                                  residuals=self._comm_residuals)
        if new_res is not None:
            self._comm_residuals = tuple(torch.where(overflow, old, new) for old, new in
                                         zip(self._comm_residuals, new_res))
        mine = unpack_flat(g_mean, nat)
        parts = {**dict(zip(idx, mine)), **self._from_lead(dict(zip(idx, mine)))}
        grads = [self._from_row_leaf(i, parts[i], layout.leaves[i].opt_spec)
                 for i in range(len(self._params))]
        grad_norm = torch.zeros((), dtype=torch.float32, device=self.device)
        if clip > 0.0:
            grad_norm = torch.sqrt(self._model_sum(_sum_squares(mine, self.device)))
            grads = _clip_by_norm(grads, grad_norm, clip)
        return self._update(grads, overflow, grad_norm, loss)

    def _block_shape(self, i: int) -> Tuple[int, ...]:
        """Leaf ``i``'s held block in its stored shape (the stored shape
        where no held axis cuts it)."""
        from deepspeed_tpu_torch.sharding.spec import entry_axes

        leaf = self.layout.leaves[i]
        return tuple(n // self.mesh.size(entry_axes(e))
                     for n, e in zip(leaf.state_shape, leaf.tp_spec))

    def _local_sink(self, i: int, layer: Optional[int], g: torch.Tensor) -> None:
        """A stage-3 gather's gradient kept unreduced where each rank keeps
        its own gradients (the explicit exchanges): added into leaf ``i``'s
        whole block (``layer``: one layer of a stacked leaf)."""
        acc = self._grad_acc[i]
        if acc is None:
            acc = self._grad_acc[i] = torch.zeros(self._block_shape(i), device=self.device)
        (acc if layer is None else acc[layer]).add_(g)

    def _portable_opt_fields(self) -> Dict[str, Any]:
        """The optimizer state by field, as a tag holds it: in the 1-bit
        compressed phase the residuals of every rank gathered to
        ``(n, Mp)`` and ``(n, Mp // n)`` (collective: every rank calls)."""
        from deepspeed_tpu_torch.comm import collectives

        opt = self.opt_state
        out = ({f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)}
               if dataclasses.is_dataclass(opt) else dict(opt))
        if self._onebit_frozen:
            for k in ("worker_error", "server_error"):
                out[k] = collectives.all_gather(out[k][None], self._dp_group(),
                                                kind="checkpoint")
            # each model rank's state is of its own blocks
            out = {k: (t if k == "step" else self._held_stack(t)) for k, t in out.items()}
        return out

    def _comm_state(self) -> Dict[str, torch.Tensor]:
        """The onebit strategy's residuals of every rank, ``comm/`` in a
        tag (collective)."""
        if self._comm_residuals is None:
            return {}
        from deepspeed_tpu_torch.comm import collectives

        werr, serr = (self._held_stack(collectives.all_gather(t[None], self._dp_group(),
                                                             kind="checkpoint"))
                      for t in self._comm_residuals)
        return {"comm/worker_error": werr, "comm/server_error": serr}

    def _dp_row(self) -> int:
        """This rank's row of the data-parallel grid's stacked residuals."""
        import torch.distributed as dist

        group = self._dp_group()
        return 0 if group is None else dist.get_rank(group)

    def _host_apply_step(self, grads, overflow, grad_norm, loss) -> Dict[str, Any]:
        """The offload step after :meth:`_boundary_grads` (the JAX engine's
        ``_host_apply_step``): gradients into the pinned host buffers on
        the side stream, the host Adam over the masters in place, the cast
        into the pinned compute-type buffers and the copies back to the
        device parameters.  A dynamic scaler's overflow skips the update."""
        lr = float(self.lr_schedule(self._host_global_step))
        if not (self.loss_scaler.dynamic and bool(overflow)):
            timing, ev = self.offload_timing, self._offload_events
            timing.clear()
            ev.clear()
            t0 = time.perf_counter()
            if self._offload_shards > 1:
                # this rank's slices of the packed gradient only
                from deepspeed_tpu_torch.runtime.fp16.onebit.adam import pack_flat

                P, L = self._offload_shards, self._offload_slice_len
                flat = pack_flat(grads, P)
                grads = [flat[i % P * L:(i % P + 1) * L] for i in self._host_shard_ids]
            if self._d2h_stream is not None:
                ev["d2h_start"], ev["d2h_end"] = (torch.cuda.Event(enable_timing=True)
                                                  for _ in range(2))
                self._d2h_stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self._d2h_stream):
                    ev["d2h_start"].record()
                    for h, g in zip(self._host_grads, grads):
                        h.copy_(g, non_blocking=True)
                    ev["d2h_end"].record()
                ev["d2h_end"].synchronize()  # the host reads the buffers next
            else:
                for h, g in zip(self._host_grads, grads):
                    h.copy_(g)
            del grads
            t1 = time.perf_counter()
            if self._offload_shards <= 1:
                self._host_opt.step(self._host_grads, lr, self._host_global_step + 1)
            else:
                for opt, g in zip(self._host_opts, self._host_grads):
                    opt.step([g], lr, self._host_global_step + 1)
            t2 = time.perf_counter()
            self._gather_masters()
            t3 = time.perf_counter()
            self._push_params(self._masters_full)
            timing.update(d2h_wait_ms=(t1 - t0) * 1e3, adam_ms=(t2 - t1) * 1e3,
                          gather_ms=(t3 - t2) * 1e3)
        self.loss_scale_state = self.loss_scaler.update(self.loss_scale_state, overflow)
        return {"lr": lr, "grad_norm": grad_norm, "overflow": overflow, "loss": loss}

    def _gather_masters(self) -> None:
        """With P > 1 slices: every slice's updated masters into the whole
        pinned buffer (``_sharded_host_step``'s reassembly): across ranks
        one all-gather of the f32 slices as pinned tensors on a gloo group
        (``offload-masters-allgather``), in one process a copy of each.  The
        buffer is written only after the last copy out of it ended."""
        if self._offload_shards <= 1:
            return
        if self._h2d_done is not None:
            self._h2d_done.synchronize()
        if self._host_pg is not None:
            from deepspeed_tpu_torch.comm import collectives

            collectives.host_all_gather(self._host_opt.masters[0], self._host_pg,
                                        out=self._gathered)
            return
        L = self._offload_slice_len
        for i, opt in zip(self._host_shard_ids, self._host_opts):
            self._gathered[i * L:(i + 1) * L].copy_(opt.masters[0])

    def _push_params(self, masters: List[torch.Tensor]) -> None:
        """The masters, cast to the compute type (the host kernel's
        round-to-nearest-even for bf16), into the device parameters.  The
        cast waits for the last copy out of the same pinned buffers."""
        from deepspeed_tpu_torch.ops.adam.cpu_adam import fp32_to_bf16

        t0 = time.perf_counter()
        if self._h2d_done is not None:
            self._h2d_done.synchronize()
        src = masters
        if self._host_cast is not None:
            for m, c in zip(masters, self._host_cast):
                if c.dtype == torch.bfloat16:
                    fp32_to_bf16(m.reshape(-1), c.reshape(-1))
                else:
                    c.copy_(m)
            src = self._host_cast
        t1 = time.perf_counter()
        cuda = self.device.type == "cuda"
        ev = self._offload_events
        if cuda:
            ev["h2d_start"], ev["h2d_end"] = (torch.cuda.Event(enable_timing=True)
                                              for _ in range(2))
            ev["h2d_start"].record()
        with torch.no_grad():
            for p, h in zip(self._params, src):
                p.copy_(h, non_blocking=cuda)
        if cuda:
            ev["h2d_end"].record()
            self._h2d_done = ev["h2d_end"]
        self.offload_timing["cast_ms"] = (t1 - t0) * 1e3

    def _host_buffers_idle(self) -> None:
        """Wait for the last copy out of the pinned host buffers (before a
        checkpoint load overwrites the masters)."""
        if self._h2d_done is not None:
            self._h2d_done.synchronize()

    def _after_host_load(self) -> None:
        """A checkpoint load replaced the host masters: the whole masters
        (gathered from the slices) and the device parameters follow."""
        self._gather_masters()
        self._push_params(self._masters_full)

    def offload_breakdown(self) -> Dict[str, float]:
        """The last offload step's milliseconds: ``d2h_ms`` and ``h2d_ms``
        (CUDA events on the copies' streams; None off the card),
        ``d2h_wait_ms`` (host clock from issuing the gradient copies to
        their event: the device compute still queued plus the copies),
        ``adam_ms`` (the host Adam, disk waits under ``nvme`` included) and
        ``cast_ms`` (the host clock of the cast)."""
        out = dict(self.offload_timing)
        ev = self._offload_events
        for key in ("d2h", "h2d"):
            if f"{key}_end" in ev:
                ev[f"{key}_end"].synchronize()
                out[f"{key}_ms"] = ev[f"{key}_start"].elapsed_time(ev[f"{key}_end"])
            else:
                out[f"{key}_ms"] = None
        return out

    def _counts_loss(self) -> bool:
        """Whether this rank's loss enters the step's sum: one rank of
        every data-parallel row (the ``model``, ``seq`` and ``expert``
        ranks of a row compute the same loss; of a ``pipe`` axis, the last
        stage, which holds it)."""
        c, sizes = self.mesh.coords, self.mesh.sizes
        return (c["model"] == 0 and c["seq"] == 0 and c["expert"] == 0
                and c["pipe"] == sizes["pipe"] - 1)

    def _lamb_norm_reducer(self):
        """LAMB's per-leaf ``(sum p^2, sum dir^2)`` summed over the ranks
        that hold the leaf's other slices (None where no leaf is cut)."""
        axes = [self.layout.update_axes(i) for i in range(len(self._params))]
        if not any(axes):
            return None
        from deepspeed_tpu_torch.comm import collectives

        def reduce(i: int, sq: torch.Tensor) -> torch.Tensor:
            if not axes[i]:
                return sq
            return collectives.all_reduce(sq, self.mesh.group(axes[i]), kind="lamb-norms")

        return reduce

    def _quantize_masters(self, overflow) -> None:
        """MoQ after the update: the matmul weights fake-quantized in place
        at this step's bits, the unquantized masters kept on overflow.  A
        leaf cut across ranks (stage 3's shards, ``model`` blocks) is
        quantized whole, as one rank does (gathered, the same groups and
        bits on every rank), and each rank keeps its part."""
        from deepspeed_tpu_torch.runtime.quantize import is_quantized

        seed = (self.config.seed * 1_000_003 + 1_000_003 + self._host_global_step) & _SEED_MASK
        layout = self.layout
        for i, p in enumerate(self._params):
            leaf = layout.leaves[i]
            name = leaf.path.split("/")[-1]
            if not is_quantized(name, len(leaf.shape)):
                continue
            whole = layout.natural(i, p.detach(), leaf.param_spec, kind="moq-gather")
            q = self.quantizer.quantize_leaf(name, whole, self._host_global_step, seed=seed)
            q = layout.from_natural(i, q, leaf.param_spec)
            p.detach().copy_(torch.where(overflow, p.detach(), q))

    def _plain_update(self, grads, params, lr, overflow):
        """``optimizer.update`` then ``p + u`` for what the fused kernels do
        not serve: SGD (on overflow the old parameters and state stay) and
        the reduced Adam state, stepped in place chunk by chunk
        (``step_reduced_``), the overflow skip folded into its producer as
        the JAX optimizer's is."""
        lr_t = torch.full((), lr, dtype=torch.float32, device=self.device)
        if isinstance(self.opt_state, AdamState8):
            self.optimizer.step_reduced_(grads, self.opt_state, params, lr=lr_t, skip=overflow,
                                         generator=self._rounding_generator(),
                                         cuts=self._state_cuts)
            return self.opt_state
        from deepspeed_tpu_torch.runtime.fp16.onebit.lamb import OnebitLamb

        kw = {}
        if isinstance(self.optimizer, OnebitLamb) and self._lamb_norm_reducer() is not None:
            kw["reduce_norms"] = self._lamb_norm_reducer()
        updates, new_state = self.optimizer.update(grads, self.opt_state, params, lr=lr_t, **kw)
        for p, u in zip(params, updates):
            p.copy_(torch.where(overflow, p, (p.float() + u).to(p.dtype)))
        if dataclasses.is_dataclass(new_state):
            return type(new_state)(**{
                f.name: _keep_on_overflow(overflow, getattr(self.opt_state, f.name),
                                          getattr(new_state, f.name))
                for f in dataclasses.fields(new_state)})
        return _keep_on_overflow(overflow, self.opt_state, new_state)

    def _end_step(self, info: Dict[str, Any], loss: Optional[torch.Tensor]) -> None:
        """Host bookkeeping at the boundary: the overflow flag is read on
        the host only when the scaler is dynamic; then the boundary hook
        and the timeline's step record."""
        self._last_info = info
        overflowed = self.loss_scaler.dynamic and bool(info["overflow"])
        if overflowed:
            self.skipped_steps += 1
            log_dist(f"step skipped on overflow; loss scale -> {self.loss_scale}")
        else:
            self._host_global_step += 1
        if self.quantizer is not None:
            self.quantizer.maybe_log(self._host_global_step)
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self._host_global_step)
        self._maybe_report_progress()
        self._on_step_boundary(overflowed, loss=loss)
        self.timeline.end_step()

    def _maybe_report_progress(self) -> None:
        """At ``steps_per_print``: the progress line, the
        ``wall_clock_breakdown`` summary (the timeline and the CUDA-event
        timers, read here), and the loss/lr/loss-scale events through the
        telemetry manager (the JAX engine's ``engine.py:1995-2030``).  The
        loss is read off the card only when a consumer is armed (monitor,
        sinks or ``wall_clock_breakdown``); the registry-only default
        skips the loss gauge and reads nothing."""
        step = self._host_global_step
        if step <= 0 or step % self.config.steps_per_print:
            return
        tm = self.telemetry
        read = tm.monitor_enabled or tm.exports_armed or self.wall_clock_breakdown
        # the scale off the card only where the card is read anyway: for a
        # consumer, or a dynamic scaler (its overflow flag, every step)
        scale = (self.loss_scale if read or self.loss_scaler.dynamic
                 else self._static_scale)
        log_dist(f"step={step} lr={self.get_lr()[0]:.3e} loss_scale={scale:.1f}")
        if self.wall_clock_breakdown:
            if self.timeline.enabled:
                log_dist(self.timeline.format_summary(self.config.steps_per_print))
            self.timers.log([TRAIN_BATCH_TIMER, FORWARD_TIMER, BACKWARD_TIMER, STEP_TIMER],
                            normalizer=self.config.steps_per_print)
        if tm.tracer.enabled:
            tm.tracer.resolve()  # the card's spans, at report cadence
        if tm.collect or tm.monitor_enabled:
            last = self._last_loss
            loss = float(last) if read and last is not None else None
            tm.publish_train_progress(step=step, samples=self.global_samples, loss=loss,
                                      lr=float(self.get_lr()[0]), loss_scale=scale)

    def train_step_attribution(self):
        """The counted step's per-bucket cost table
        (:class:`~deepspeed_tpu_torch.telemetry.attribution.Attribution`,
        with the timed step's device ms once timed), or None before the
        first step or when attribution is off."""
        return self.telemetry.attribution()

    def _attribution_window(self):
        """The context the coming step runs in: the counting mode on the
        first step, a ``torch.profiler`` window on the second when a sink
        or the trace reads it on the card; else a no-op: ``(stage, context)``."""
        from contextlib import nullcontext

        stage = self._attr_stage
        if stage == "count":
            from deepspeed_tpu_torch.telemetry.attribution import counting

            return stage, counting("train_step", self.telemetry.device_name)
        if stage == "time":
            from deepspeed_tpu_torch.telemetry.attribution import timing

            return stage, timing()
        return None, nullcontext()

    def _close_attribution(self, stage, handle) -> None:
        tm = self.telemetry
        if stage == "count":
            attr = handle.attribution(tm.device_name)
            self._step_cost = {"flops": attr.total_flops(), "bytes accessed": attr.total_bytes()}
            tm.set_step_cost(self._step_cost)
            armed = tm.attribution_armed
            if armed:
                tm.set_attribution(attr)
            timed = armed and self.device.type == "cuda" and (tm.exports_armed or tm.tracer.enabled)
            self._attr_stage = "time" if timed else None
        elif stage == "time":
            self._attr_stage = None
            if handle.timing is not None and tm.attribution() is not None:
                tm.attribution().set_timing(handle.timing)
                tm.set_attribution(tm.attribution())

    def _fence_compute(self, t_compute: float) -> None:
        """With ``overlap.timeline.fence``, wait for the card and note the
        step's launches as ``compute``."""
        if self.timeline.enabled and self._timeline_fence:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timeline.note("compute", time.perf_counter() - t_compute)

    # ------------------------------------------------------------------
    # user API
    # ------------------------------------------------------------------
    def forward(self, batch: Any) -> torch.Tensor:
        """Forward and backward of one micro-batch; returns the loss.
        As in the JAX engine, the gradients are produced here and summed
        into the accumulator; ``backward()`` checks the call order."""
        if self._onebit_frozen or self._comm_explicit:
            raise RuntimeError(
                "the 1-bit compressed phase and comm.strategy int8/onebit run whole batches "
                "(each rank's gradient row is exchanged once a step); use train_batch()")
        if self.wall_clock_breakdown:
            self.timers(FORWARD_TIMER).start()
        loss = self._micro_step(self._prepare_batch(batch))
        if self.wall_clock_breakdown:
            self.timers(FORWARD_TIMER).stop()
        self._cached_loss = self._last_loss = loss
        return loss

    __call__ = forward

    def backward(self, loss: Any = None, allreduce_gradients: bool = True) -> Any:
        """Gradient accumulation already happened in ``forward``; this is
        the ordering checkpoint."""
        if self._cached_loss is None:
            raise RuntimeError("backward() called before forward()")
        if self.wall_clock_breakdown:
            # the gradients were produced in forward(): an empty region,
            # as the JAX engine's
            self.timers(BACKWARD_TIMER).start()
            self.timers(BACKWARD_TIMER).stop()
        loss = self._cached_loss
        self._cached_loss = None
        return loss

    def step(self) -> None:
        """Apply the optimizer step at the gradient-accumulation boundary."""
        if self.is_gradient_accumulation_boundary():
            if self.wall_clock_breakdown:
                self.timers(STEP_TIMER).start()
            info = self._apply_step()
            if self.wall_clock_breakdown:
                self.timers(STEP_TIMER).stop()
                self.timers.log([FORWARD_TIMER, BACKWARD_TIMER, STEP_TIMER])
            self._end_step(info, loss=self._last_loss)

    def train_batch(self, batch: Any) -> torch.Tensor:
        """One step: every leaf's leading dim is ``gas * micro_batch``,
        this rank's rows (the micro-batches are its consecutive slices).
        Returns the mean loss over the global batch, every rank's
        micro-batches (a 0-dim tensor on the device).  Batches from ``prefetch_loader`` are already on the
        device and pass straight through."""
        gas = self.gradient_accumulation_steps
        if self.tput_timer is not None:
            self.tput_timer.start()
        if (self._onebit_exchange_ok and not self._onebit_frozen
                and self._host_global_step >= self.optimizer.freeze_step):
            self._enter_onebit_frozen()
        if isinstance(batch, _PlacedBatch):
            # the prefetcher noted its own wait as data_wait
            leaves, rebuild = batch.take()
        else:
            with self.timeline.phase("data_wait"):
                leaves, rebuild = tree_flatten(batch)
                leaves = [self._to_device(x) for x in leaves]
        profile_step = self._host_global_step + 1
        self.flops_profiler.start_step(profile_step)
        if self.wall_clock_breakdown:
            self.timers(TRAIN_BATCH_TIMER).start()
        span = self._step_span_start()
        t_compute = time.perf_counter()
        stage, window = self._attribution_window()
        with window as handle:
            mb = leaves[0].shape[0] // gas if leaves else 0
            losses = []
            for i in range(gas):
                micro = rebuild([x[i * mb:(i + 1) * mb] for x in leaves])
                losses.append(self._micro_step(micro))
            info = self._apply_step(torch.stack(losses).mean())
            if stage == "time":
                torch.cuda.synchronize(self.device)  # the window holds the step's kernels
        if stage is not None:
            self._close_attribution(stage, handle)
        loss = info["loss"]
        self._last_loss = loss
        self._step_span_end(span, profile_step)
        if self.wall_clock_breakdown:
            self.timers(TRAIN_BATCH_TIMER).stop()
        self._fence_compute(t_compute)
        self.flops_profiler.end_step(profile_step, cost=self._step_cost)
        if self.tput_timer is not None:
            self.tput_timer.stop()
        self._end_step(info, loss=loss)
        return loss

    def _step_span_start(self):
        """With tracing armed: the step's start on the card (a CUDA event
        on the current stream) or on the host clock off the card."""
        tracer = self.telemetry.tracer
        if not tracer.enabled:
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return tracer.now()

    def _step_span_end(self, start, step: int) -> None:
        """The step's ``train/compute`` span: between two CUDA events on the
        card (placed when the trace is exported or at report time, never
        the time it took to queue the launches), the host clock off it."""
        if start is None:
            return
        from deepspeed_tpu_torch.telemetry import PID_ENGINE

        tracer = self.telemetry.tracer
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            tracer.add_device_span("train/compute", "train", start, end, pid=PID_ENGINE, tid=1,
                                   args={"step": step}, tid_name="card")
        else:
            tracer.add_span("train/compute", "train", start, tracer.now(), pid=PID_ENGINE,
                            tid=1, args={"step": step}, tid_name="card")

    @torch.no_grad()
    def eval_batch(self, batch: Any) -> torch.Tensor:
        """The loss of one batch without dropout and without gradients."""
        return self._compute_loss(self._prepare_batch(batch), None)

    # ------------------------------------------------------------------
    # input pipeline
    # ------------------------------------------------------------------
    def _place_ahead(self, batch: Any) -> _PlacedBatch:
        """The prefetcher's place stage (its own thread): every leaf on the
        engine's device.  On the card each leaf is pinned and copied on
        the engine's copy stream, whose event the step's stream waits on
        (:meth:`_PlacedBatch.take`)."""
        leaves, rebuild = tree_flatten(batch)
        if self.device.type != "cuda":
            return _PlacedBatch([self._to_device(x) for x in leaves], rebuild)
        torch.cuda.set_device(self._copy_stream.device)  # this thread's current device
        host = [_pinned(x) for x in leaves]
        with torch.cuda.stream(self._copy_stream):
            placed = [h.to(self.device, non_blocking=True) for h in host]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _PlacedBatch(placed, rebuild, event, host)

    def prefetch_loader(self, loader, prefetch_depth: Optional[int] = None):
        """Wrap a host batch iterator so loader pulls and the copies to the
        card run ahead of the step as a two-stage pipeline
        (``runtime/overlap`` ``DevicePrefetcher``); feed the result to
        ``train_batch``.  ``prefetch_depth`` defaults to the
        ``overlap.prefetch.depth`` config (2 = double buffering); with
        ``overlap.prefetch.enabled = false`` the wrap is a synchronous
        pass-through (A/B knob for measuring the overlap) — unless the
        caller passes ``prefetch_depth`` explicitly, which is a direct API
        request for background prefetch and wins over the config default.
        The wrapper is registered (:meth:`register_dataloader`), so
        checkpoints carry its cursor."""
        from deepspeed_tpu_torch.runtime.overlap import DevicePrefetcher, InlineLoader

        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        if not self.overlap.prefetch.enabled and prefetch_depth is None:
            return self.register_dataloader(
                InlineLoader(loader, self._place_ahead, timeline=self.timeline))
        depth = self.overlap.prefetch.depth if prefetch_depth is None else int(prefetch_depth)
        return self.register_dataloader(DevicePrefetcher(
            loader, depth=depth, place_fn=self._place_ahead, timeline=self.timeline))

    def register_dataloader(self, loader):
        """Register the training loader for resume-cursor round-trips:
        checkpoint saves record its ``state_dict()`` in the client state,
        loads restore it — a restarted job neither replays nor skips
        batches.  ``prefetch_loader`` calls this automatically."""
        self._train_loader = loader
        return loader

    # ------------------------------------------------------------------
    # resilience: preemption + divergence
    # ------------------------------------------------------------------
    def _note_checkpoint_dir(self, directory: str) -> None:
        """Remember where this run checkpoints (emergency saves and
        divergence rollback target it)."""
        self._resilience_ckpt_dir = os.path.abspath(directory)

    def _on_step_boundary(self, overflowed: bool, loss=None) -> None:
        """Host-side hook after every optimizer-step boundary: the fault
        site first (an injected kill at a boundary must win over progress
        reporting), then a pending preemption request, then the
        divergence guard.  Nothing here reads the card unless
        ``divergence.check_loss`` asks for it."""
        from deepspeed_tpu_torch.resilience import faults

        faults.check("step.boundary")
        wd = self._watchdog
        # across ranks the save is collective: a preemption any rank saw
        # (the step scalars' all-reduce) is every rank's
        preempt = wd is not None and (
            self._peer_preempt if self.world_size > 1 else wd.preemption_requested)
        if preempt:
            self._handle_preemption()
        guard = self._divergence_guard
        if guard is None:
            return
        diverged = bool(overflowed) or faults.check_flag("engine.force_overflow")
        if not diverged and self.resilience.divergence.check_loss and loss is not None:
            # opt-in host sync: the only NaN signal without dynamic loss
            # scaling (bf16 has no overflow flag)
            diverged = not bool(np.isfinite(float(loss)))
        action = guard.record(diverged)
        if action is not None:
            self._apply_divergence_action(action)

    def _handle_preemption(self) -> None:
        """Emergency checkpoint + exit.  Exit-code contract: the
        configured code (default 43) means "preempted AND saved" — a
        scheduler can requeue and resume blindly; exit 1 means the save
        did not happen (deadline passed or save failed) — treat as a
        crash and resume from the previous tag."""
        wd = self._watchdog
        from deepspeed_tpu_torch.telemetry import get_registry

        get_registry().counter("resilience/preemptions").inc()
        log_dist(
            f"preemption signal ({wd.signal_name}) received; attempting emergency "
            f"checkpoint ({wd.remaining():.0f}s of grace left)"
        )
        if self.world_size > 1 and not self._every_rank_can_save():
            logger.error("preempted, but a rank cannot save (no checkpoint dir or no grace "
                         "left); exiting WITHOUT saving")
            raise SystemExit(1)
        if self._resilience_ckpt_dir is None:
            logger.error(
                "preempted but no checkpoint dir is known (no prior save/load and no "
                "'resilience.watchdog.save_dir'); exiting WITHOUT saving"
            )
            raise SystemExit(1)
        if wd.remaining() <= 0:
            logger.error(
                f"preemption grace deadline ({wd.grace_seconds}s) already passed; "
                "exiting WITHOUT saving"
            )
            raise SystemExit(1)
        writer = self._async_writer
        if writer is not None and writer.in_flight:
            # drain-before-exit: an in-flight background commit must land
            # (or provably fail) before the emergency save touches the
            # tree; the budget is capped by the remaining grace window
            log_dist("draining in-flight async checkpoint before the emergency save")
            try:
                writer.drain(timeout=max(1.0, min(writer.drain_timeout_seconds, wd.remaining())))
            except BaseException as e:  # hung drain => cannot certify "saved"
                logger.error(f"drain of in-flight async save failed: {e!r}")
                raise SystemExit(1) from e
        try:
            # synchronous: exit code 43 must certify a COMMITTED tag
            path = self.save_checkpoint(self._resilience_ckpt_dir, async_save=False)
        except BaseException as e:  # a failed save must NOT exit as "saved"
            logger.error(f"emergency checkpoint failed: {e!r}")
            raise SystemExit(1) from e
        log_dist(f"emergency checkpoint saved to {path}; exiting with code {wd.exit_code}")
        raise SystemExit(wd.exit_code)

    def _every_rank_can_save(self) -> bool:
        """Whether every rank knows a checkpoint directory and has grace
        left (one all-reduce): an emergency save is collective, so the
        ranks save together or exit together."""
        from deepspeed_tpu_torch.comm import collectives

        ok = self._resilience_ckpt_dir is not None and self._watchdog.remaining() > 0
        flag = torch.full((), 0.0 if ok else 1.0, dtype=torch.float32, device=self.device)
        return float(collectives.all_reduce(flag, self.mesh.world_group(),
                                            kind="boundary-flags")) == 0.0

    def _apply_divergence_action(self, action: str) -> None:
        from deepspeed_tpu_torch.telemetry import get_registry

        get_registry().counter("resilience/divergence_actions", action=action).inc()
        n = self.resilience.divergence.threshold
        if action == C.DIVERGENCE_ACTION_FLOOR:
            # the floor is read by the scaler's next update: nothing to
            # recompile in eager PyTorch
            old = self.loss_scaler.min_scale
            self.loss_scaler.min_scale = max(old / 2.0, 2.0**-24)
            logger.warning(
                f"divergence guard: {n} consecutive skipped steps — lowering loss-scale "
                f"floor {old} -> {self.loss_scaler.min_scale}"
            )
        elif action == C.DIVERGENCE_ACTION_ROLLBACK:
            if self._resilience_ckpt_dir is None:
                logger.error(
                    f"divergence guard: {n} consecutive skipped steps and action=rollback, "
                    "but no checkpoint dir is known (no prior save/load); cannot roll back"
                )
                return
            logger.warning(
                f"divergence guard: {n} consecutive skipped steps — rolling back to the "
                f"last verified checkpoint under {self._resilience_ckpt_dir}"
            )
            # strict=False even under fail_on_missing: a failed rollback
            # must degrade to the error log below, not crash the step
            path, _ = self.load_checkpoint(self._resilience_ckpt_dir, strict=False)
            if path is None:
                logger.error("divergence rollback found no loadable checkpoint")
        else:
            logger.warning(
                f"divergence guard: {n} consecutive NaN/overflow-skipped steps "
                f"(loss scale {self.loss_scale}) — the run is likely diverging"
            )

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, save_latest: bool = True,
                        async_save: Optional[bool] = None):
        """``async_save``: None defers to the ``overlap.async_checkpoint``
        config; True/False forces the background/synchronous path for this
        save."""
        from deepspeed_tpu_torch.runtime.checkpointing import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state,
                     save_latest=save_latest, async_save=async_save)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None, **kw):
        """``(path, client_state)``, or ``(None, {})`` when nothing
        loadable is found; keywords: ``load_optimizer_states``,
        ``load_lr_scheduler_states``, ``load_module_only``, ``strict``."""
        from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint as _load

        out = _load(self, load_dir, tag=tag, **kw)
        if not self.loss_scaler.dynamic:
            self._static_scale = self.loss_scale  # a tag may carry another scale
        return out
