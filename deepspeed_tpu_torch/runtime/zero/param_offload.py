"""ZeRO-Infinity parameter offload: train a model whose parameters exceed
the card by streaming one layer group at a time through it (counterpart of
``deepspeed_tpu/runtime/zero/param_offload.py``; the reference's
``partitioned_param_swapper.py:36``).

The model advertises its streaming structure as ``model_fn.stream_spec``
(``models/gpt2.py``): the stacked ``blocks`` and three stages, ``embed``,
``group`` and ``head_loss``.  A step is, for each micro-batch::

    embed -> [group fwd] x G -> head (+ its gradients) -> [group bwd] x G -> embed bwd

* The forward sweep runs under ``torch.no_grad()`` and keeps only the G+1
  group boundary activations.
* Group g+1's compute-type parameters go host -> device on a side stream
  while group g computes, into the second of two device group buffers
  (an event keeps a buffer's next copy behind its last use).
* Each group's backward re-runs the group from its detached boundary
  under ``torch.enable_grad()`` (with the same dropout seeds), then
  ``torch.autograd.grad`` to the group's parameters and its input.
* The group gradients drain device -> host into pinned buffers on a side
  stream, one group behind the compute, and add into the host f32
  accumulators; the device holds at most two groups' gradients.
* The resident leaves (embeddings, final LayerNorm) stay on the device;
  the tied ``wte``'s two gradients (embedding and head) are summed in f32
  on the host, as the JAX engine sums them.

At the boundary the host f32 gradients are averaged, checked and clipped
(the norm summed in f64), the native host Adam steps the pinned f32
masters (``runtime/zero/offload.py``), and each group's compute-type copy
is refreshed the moment its rows are updated: in pinned host memory
(``offload_param.device: cpu``) or, under ``nvme``, written to the group's
file through the aio engine (``runtime/swap/async_swapper.py``), from
which every upload then reads it.

The device holds the resident leaves, two group buffers, the boundary
activations and one group's activations and gradients — never the model.
``live_group_param_bytes`` counts the bytes of the two device group buffers,
``live_group_grad_bytes`` those of the group gradients the backward made
that are not yet freed (each tensor counted until it is garbage; their
maxima in ``stats``).

Across ranks (a ``mesh`` of ``data`` x ``fsdp``, the JAX package's
``_setup_host_partition``, ``param_offload.py:196-207, 323-458``), each rank
keeps its ``fsdp`` part of every block leaf's masters, moments and group
files: the leaf's largest trailing dimension that ``fsdp`` divides
(``sharding/layout.py`` ``fsdp_trailing_spec``; a leaf nothing divides
stays whole on every rank), and the resident leaves whole.  A group's
upload is this rank's part, all-gathered over ``fsdp`` on the device; its
gradient is all-reduced over ``data`` and reduce-scattered over ``fsdp``
back to the part (the resident leaves' all-reduced over both), averaged
over the data-parallel ranks, each rank training on its own rows.  The
global norm counts each part once (on the ``data`` rank 0 of its ``fsdp``
rank; the whole leaves on rank 0) in one all-reduce of ``[sq,
overflow]``.  A checkpoint writes each rank's masters and moments to its
own file (``host_optimizer_rank<r>.pt``), ``masters_sharded`` in the meta;
a tag restores at any ``fsdp`` size, reassembled from every saved rank's
file (or from a one-rank tag's ``state.pt``) and cut to this rank's parts.
A ``seq``, ``expert`` or ``pipe`` axis replicates the stream, as under the
JAX streaming engine (which checks none of them): its ranks take the same
rows and parts as their ``data x fsdp`` peers and count nothing twice.
``progressive_layer_drop`` and ``quantize_training`` are left unread, with
a warning, as the JAX streaming engine leaves them (ROADMAP C4).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.zero.offload import (
    HostOffloadOptimizer,
    host_optimizer_refusal,
    host_unscale_clip_and_check,
    sum_squares_f64,
)
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclasses.dataclass
class StreamSpec:
    """The layer-streaming structure a model exposes for parameter offload.

    ``blocks_key``: the subtree whose leaves stack the layers on a leading
    dim.  ``embed(resident, tokens) -> x``; ``group(gblocks, x, seeds,
    deterministic, remat) -> x``; ``head_loss(resident, x, batch) ->
    loss``; ``layer_seeds(generator) -> [seeds per layer]``."""

    n_layer: int
    blocks_key: str
    embed: Callable
    group: Callable
    head_loss: Callable
    layer_seeds: Callable = lambda generator: None
    deterministic: bool = True
    remat: bool = True
    supported: bool = True


def _untrack(engine_ref, kind: str, n: int) -> None:
    engine = engine_ref()
    if engine is not None:
        engine._live(kind, -n)


# the axes whose ranks replicate the stream
REPLICA_AXES = ("seq", "expert", "pipe")


class ZeroInfinityEngine:
    """Streaming train executor for ``offload_param`` models.  Its API is
    the engine's where it matters: ``train_batch``, ``eval_batch``,
    ``save_checkpoint`` / ``load_checkpoint``, ``global_steps``."""

    @staticmethod
    def streamable(model, config, optimizer=None) -> Optional[str]:
        """None if this model and config can stream, else the reason
        (``initialize`` then falls back to the in-memory engine, with a
        warning)."""
        spec = getattr(model, "stream_spec", None)
        if spec is None:
            return "model exposes no stream_spec"
        if not spec.supported:
            return "model config is not streamable (MoE blocks)"
        if config.fp16.enabled:
            return "requires bf16 (no dynamic loss scale on the host path)"
        if config.mesh.model > 1:
            return "model (TP) sharding of streamed params is not implemented"
        # a seq, expert or pipe axis replicates the stream (the JAX
        # streaming engine checks none of them: its step sees them whole)
        return host_optimizer_refusal(config, optimizer)

    @staticmethod
    def check_fallback_fits(params, config, reason: str, device) -> None:
        """``offload_param`` was asked for but cannot stream (``reason``):
        refuse unless the in-memory engine's resident bytes fit the card
        (the card's total memory, ``torch.cuda.mem_get_info``; override with
        ``DS_TPU_HBM_BYTES``; no budget off the card)."""
        from deepspeed_tpu_torch.runtime.engine import tree_flatten

        hbm = os.environ.get("DS_TPU_HBM_BYTES")
        dev = torch.device(device)
        if hbm is None and dev.type == "cuda" and torch.cuda.is_available():
            hbm = torch.cuda.mem_get_info(dev)[1]
        if hbm is None:
            return
        leaves, _ = tree_flatten(params)
        n = sum(int(np.prod(np.shape(x))) for x in leaves)
        dt = 2 if (config.bf16.enabled or config.fp16.enabled) else 4
        opt_dev = 0 if config.zero_config.offload_optimizer.enabled else 12  # f32 master + m + v
        per_dev = n * (dt + 4 + opt_dev)  # f32 gradients stay on the device
        if per_dev > 0.9 * float(hbm):
            raise RuntimeError(
                f"offload_param requested but this combination cannot stream ({reason}); "
                f"the in-memory fallback would keep ~{per_dev / 1e9:.1f} GB resident of "
                f"{float(hbm) / 1e9:.1f} GB on the device and run out of memory at step time. "
                "Fix the streaming blocker instead.")

    def __init__(self, model, params, config, lr_scheduler=None, device: Any = "cuda"):
        from deepspeed_tpu_torch.runtime.engine import tree_flatten, tree_paths
        from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScaler
        from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
        from deepspeed_tpu_torch.utils.device import resolve_device

        reason = self.streamable(model, config)
        if reason is not None:
            raise NotImplementedError(f"offload_param cannot stream: {reason}")
        extras = [k for k in ("quantize_training", "progressive_layer_drop")
                  if getattr(config, k).enabled]
        if extras:
            # the JAX streaming engine never reads either block
            logger.warning(f"offload_param: the streaming engine does not apply "
                           f"{' and '.join(extras)}; the block is left unread, as in the JAX "
                           "package's ZeroInfinityEngine")
        spec: StreamSpec = model.stream_spec
        self.device = resolve_device(device)
        self.config, self.spec = config, spec
        self._setup_mesh(config)
        self.compute_dtype = torch.bfloat16 if config.bf16.enabled else torch.float32
        zc = config.zero_config
        # layers per group: offload_param.buffer_count, or its largest
        # divisor of n_layer below it
        want = max(1, int(zc.offload_param.buffer_count or 1))
        gl = max(d for d in range(1, min(want, spec.n_layer) + 1) if spec.n_layer % d == 0)
        self.group_layers, self.n_groups = gl, spec.n_layer // gl
        self.cuda = self.device.type == "cuda"

        # -- host state ----------------------------------------------------
        leaves, self._unflatten = tree_flatten(params)
        self._paths = tree_paths(params)
        prefix = f"{spec.blocks_key}/"
        self._block_idx = [i for i, p in enumerate(self._paths) if p.startswith(prefix)]
        self._res_idx = [i for i, p in enumerate(self._paths) if not p.startswith(prefix)]
        self._block_keys = [self._paths[i][len(prefix):] for i in self._block_idx]
        self._res_keys = [self._paths[i] for i in self._res_idx]
        # each block leaf's fsdp-cut dimension (None: whole on every rank)
        shapes = [tuple(np.shape(x)) for x in leaves]
        self._full_shapes = shapes
        self._cut = {i: self._cut_dim(shapes[i], self._fsdp) for i in self._block_idx}
        leaves = [self._leaf_to_local(i, x) for i, x in enumerate(leaves)]
        nvme_dir = None
        if zc.offload_optimizer.device == "nvme" or zc.offload_param.device == "nvme":
            nvme_dir = zc.offload_param.nvme_path or zc.offload_optimizer.nvme_path
            if not nvme_dir:
                raise ValueError("offload device nvme requires nvme_path")
            if self.world_size > 1:
                # co-located ranks must not share files
                nvme_dir = os.path.join(nvme_dir, f"rank{self.global_rank}")
        self._host_opt = HostOffloadOptimizer.from_config(
            config, list(zip(self._paths, leaves)), streaming=True,
            nvme_swap_dir=(os.path.join(nvme_dir, "moments")
                           if zc.offload_optimizer.device == "nvme" else None),
            pin_memory=self.cuda)
        masters = self._host_opt.masters
        self._host_grads = [torch.zeros(m.shape, dtype=torch.float32, pin_memory=self.cuda)
                            for m in masters]
        # one group's slice of each block leaf: its shape and its offset in
        # the group's flat compute-type buffer, this rank's part
        # (``_gshapes``) and whole (``_gshapes_full``)
        self._gshapes = [(gl,) + tuple(masters[i].shape[1:]) for i in self._block_idx]
        sizes = [torch.Size(s).numel() for s in self._gshapes]
        self._goffs = [sum(sizes[:j]) for j in range(len(sizes))]
        self._gnumel = sum(sizes)
        self._gshapes_full = [(gl,) + shapes[i][1:] for i in self._block_idx]
        full = [torch.Size(s).numel() for s in self._gshapes_full]
        self._goffs_full = [sum(full[:j]) for j in range(len(full))]
        self._gnumel_full = sum(full)
        self._esize = torch.empty((), dtype=self.compute_dtype).element_size()
        self.group_bytes = self._gnumel_full * self._esize

        def pinned(n, dtype=None):
            return torch.empty(n, dtype=dtype or self.compute_dtype, pin_memory=self.cuda)

        self.live_group_param_bytes = 0
        self.live_group_grad_bytes = 0
        self.stats: Dict[str, int] = {}
        self.reset_stats()
        self._param_swapper = None
        self._host_groups: List[torch.Tensor] = []
        if zc.offload_param.device == "nvme":
            from deepspeed_tpu_torch.runtime.swap.async_swapper import AsyncTensorSwapper

            self._param_swapper = AsyncTensorSwapper(os.path.join(nvme_dir, "params"),
                                                     aio_config=config.aio)
            self._read_bufs = [pinned(self._gnumel) for _ in range(2)]
            self._read_free: List[Optional[Any]] = [None, None]  # the H2D out of each
        else:
            self._host_groups = [pinned(self._gnumel) for _ in range(self.n_groups)]
        for g in range(self.n_groups):
            self._refresh_group(g)
        if self._param_swapper is not None:
            self._param_swapper.synchronize_writes()
        # the resident leaves on the device (leaf tensors the head and the
        # embedding differentiate) and their pinned staging
        self._res_cast = [pinned(masters[i].shape) for i in self._res_idx]
        self._res_dev = [torch.empty(masters[i].shape, dtype=self.compute_dtype, device=self.device)
                         for i in self._res_idx]
        self._res_done = None
        self._push_resident()
        # the two device group buffers and the gradient drain's pinned
        # staging.  The buffers are written on the copy stream: allocated
        # here, before any step, and its first copies wait for the work
        # queued so far (memory the allocator hands out may still be read
        # by kernels queued on the current stream)
        self._slots = [torch.empty(self._gnumel_full, dtype=self.compute_dtype,
                                   device=self.device) for _ in range(2)]
        # across fsdp the copies land in this rank's part, gathered whole
        # into the slot on use
        self._part_slots = ([torch.empty(self._gnumel, dtype=self.compute_dtype,
                                         device=self.device) for _ in range(2)]
                            if self._masters_sharded else self._slots)
        self._live("param", 2 * self.group_bytes)  # they live as long as the engine
        self._slot_free: List[Optional[Any]] = [None, None]
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._slot_free = [ev, ev]
        self._grad_stage = [pinned(self._gnumel) for _ in range(2)]
        self._res_grad_stage = [[pinned(masters[i].shape) for i in self._res_idx] for _ in range(2)]
        self._res_grad_f32 = ([pinned(masters[i].shape, torch.float32) for i in self._res_idx]
                              if self.dp_world_size > 1 else None)
        self._h2d = torch.cuda.Stream(self.device) if self.cuda else None
        self._d2h = torch.cuda.Stream(self.device) if self.cuda else None
        self.reset_stats()

        # -- schedule and bookkeeping ---------------------------------------
        if callable(lr_scheduler):
            self.lr_schedule = lr_scheduler
        elif config.scheduler.type:
            self.lr_schedule = get_lr_schedule(config.scheduler.type, config.scheduler.params)
        else:
            base_lr = (config.optimizer.params or {}).get("lr", 1e-3)
            self.lr_schedule = lambda step: base_lr
        self.client_lr_scheduler = lr_scheduler
        self.optimizer = self._host_opt
        self.loss_scaler = LossScaler.from_config(config.fp16)
        self.loss_scale_state = self.loss_scaler.init(self.device)
        self._grad_acc: List[Optional[torch.Tensor]] = [None] * len(masters)
        self._host_global_step = 0
        self._host_micro_step = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self._last_info: Dict[str, Any] = {}
        self._async_writer = None
        self._train_loader = None
        from deepspeed_tpu_torch import telemetry as _telemetry

        # the process's telemetry plane, armed from the config as the
        # engine arms it (this engine publishes zinf/* straight into it)
        _telemetry.configure(getattr(config, "telemetry", None), rank=self.global_rank,
                             label="offload")
        log_dist(
            f"ZeRO-Infinity engine: {spec.n_layer} layers in {self.n_groups} groups of {gl}, "
            f"mesh {self.mesh} (masters sharded over fsdp: {self._masters_sharded}), "
            f"params {zc.offload_param.device}, moments "
            f"{'nvme' if zc.offload_optimizer.device == 'nvme' else 'cpu'}, "
            f"{self.group_bytes / 2**20:.1f} MiB a group, micro_bs="
            f"{config.train_micro_batch_size_per_gpu} gas={config.gradient_accumulation_steps}")

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def global_steps(self) -> int:
        return self._host_global_step

    @property
    def micro_steps(self) -> int:
        return self._host_micro_step

    @property
    def zero_stage(self) -> int:
        return self.config.zero_config.stage

    @property
    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self._host_global_step))]

    @property
    def params(self) -> Any:
        """The host f32 masters as the caller's tree, whole (across fsdp each
        block leaf is gathered from every rank's part: call on every
        rank)."""
        masters = list(self._host_opt.masters)
        if self._masters_sharded:
            masters = [self._gather_leaf(i, m) if i in self._cut else m
                       for i, m in enumerate(masters)]
        return self._unflatten(masters)

    # ------------------------------------------------------------------
    # the mesh: this rank's part of the fsdp axis
    # ------------------------------------------------------------------
    def _setup_mesh(self, config) -> None:
        """The engine's ``data`` x ``fsdp`` mesh over the started process
        group and this rank's ``fsdp`` part (the JAX engine's
        ``_setup_host_partition``: a process holds one part here)."""
        from deepspeed_tpu_torch.comm.mesh import MeshInfo
        from deepspeed_tpu_torch.sharding.mesh import build_mesh

        self.mesh, _ = build_mesh(config.mesh)
        self.mesh_info = MeshInfo.from_mesh(self.mesh)
        self.world_size, self.global_rank = self.mesh.world_size, self.mesh.rank
        self.dp_world_size = self.mesh_info.dp_world_size
        self._fsdp = self.mesh.sizes["fsdp"]
        self._part = self.mesh.coords["fsdp"]
        # a seq, expert or pipe axis holds replicas of the data x fsdp grid
        # (the same rows, parts and steps): each part is counted on the
        # replicas' first
        self._replica0 = all(self.mesh.coords[a] == 0 for a in REPLICA_AXES)
        self._masters_sharded = self._fsdp > 1
        if self.world_size > 1:
            from deepspeed_tpu_torch.comm import collectives

            self._host_pg = collectives.host_group()

    @staticmethod
    def _cut_dim(shape, fsdp: int) -> Optional[int]:
        """The dimension ``fsdp`` ranks cut a stacked block leaf along (its
        group's ``fsdp_trailing_spec``: the leading layer dimension never),
        or None."""
        from deepspeed_tpu_torch.sharding.layout import fsdp_trailing_spec

        for d, e in enumerate(fsdp_trailing_spec(tuple(shape), fsdp)):
            if e == "fsdp":
                return d
        return None

    def _leaf_to_local(self, i: int, x):
        """This rank's part of leaf ``i`` (the JAX engine's
        ``_leaf_to_local``): a block leaf cut over fsdp, else whole."""
        d = self._cut.get(i)
        if d is None or not self._masters_sharded:
            return x
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        per = t.shape[d] // self._fsdp
        return t.narrow(d, self._part * per, per).contiguous()

    def _gather_leaf(self, i: int, part: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` whole from every fsdp part (host tensors; collective
        over every rank: the parts of the ``data`` rank 0 row)."""
        from deepspeed_tpu_torch.comm import collectives

        flat = collectives.host_all_gather(part.contiguous(), self._host_pg, kind="checkpoint")
        parts = flat.view(self.world_size, *part.shape)
        ranks = [r for r in range(self.world_size)
                 if self.mesh.topology.get_coord(r).data == 0
                 and all(getattr(self.mesh.topology.get_coord(r), a) == 0 for a in REPLICA_AXES)]
        ranks.sort(key=lambda r: self.mesh.topology.get_coord(r).fsdp)
        return torch.cat([parts[r] for r in ranks], dim=self._cut[i])

    def reset_stats(self) -> None:
        """Restart the counters: group uploads, bytes read from and written
        to the group files, and the most group parameter / gradient bytes
        held on the device at once (from what is held now)."""
        self.stats = {"group_uploads": 0, "group_read_bytes": 0, "group_write_bytes": 0,
                      "max_live_group_param_bytes": self.live_group_param_bytes,
                      "max_live_group_grad_bytes": self.live_group_grad_bytes}

    def _live(self, kind: str, delta: int) -> None:
        attr = f"live_group_{kind}_bytes"
        setattr(self, attr, getattr(self, attr) + delta)
        key = f"max_live_group_{kind}_bytes"
        self.stats[key] = max(self.stats[key], getattr(self, attr))

    def _track(self, kind: str, t: torch.Tensor) -> None:
        """Count ``t``'s bytes as live group ``kind`` bytes until the tensor
        is freed (the finalizer holds the engine weakly: it must not keep
        a dropped engine alive)."""
        n = t.numel() * t.element_size()
        self._live(kind, n)
        weakref.finalize(t, _untrack, weakref.ref(self), kind, n)

    # ------------------------------------------------------------------
    # host <-> device staging
    # ------------------------------------------------------------------
    def _group_rows(self, g: int):
        lo = g * self.group_layers
        return lo, lo + self.group_layers

    def _cast_group(self, g: int, out: torch.Tensor) -> torch.Tensor:
        """Group ``g``'s compute-type parameters from the masters' rows
        into the flat ``out``."""
        from deepspeed_tpu_torch.ops.adam.cpu_adam import fp32_to_bf16

        lo, hi = self._group_rows(g)
        masters = self._host_opt.masters
        for j, i in enumerate(self._block_idx):
            rows = masters[i][lo:hi].reshape(-1)
            dst = out[self._goffs[j]:self._goffs[j] + rows.numel()]
            if dst.dtype == torch.bfloat16:
                fp32_to_bf16(rows, dst)
            else:
                dst.copy_(rows)
        return out

    def _refresh_group(self, g: int) -> None:
        """After the masters' rows of group ``g`` changed: its host copy
        (``cpu``), or an async write of its file (``nvme``; a later read
        of the group waits for it)."""
        if self._param_swapper is None:
            self._cast_group(g, self._host_groups[g])
            return
        flat = self._cast_group(g, torch.empty(self._gnumel, dtype=self.compute_dtype))
        self._param_swapper.swap_out(f"group{g:04d}", flat, async_op=True)
        self.stats["group_write_bytes"] += self.group_bytes

    def _push_resident(self) -> None:
        """The resident masters, cast, into the device's resident leaves
        (the next cast into the staging waits for the last copy)."""
        from deepspeed_tpu_torch.ops.adam.cpu_adam import fp32_to_bf16

        if self._res_done is not None:
            self._res_done.synchronize()
        for k, i in enumerate(self._res_idx):
            m, c = self._host_opt.masters[i], self._res_cast[k]
            if c.dtype == torch.bfloat16:
                fp32_to_bf16(m.reshape(-1), c.reshape(-1))
            else:
                c.copy_(m)
        with torch.no_grad():
            for d, c in zip(self._res_dev, self._res_cast):
                d.copy_(c, non_blocking=self.cuda)
        if self.cuda:
            self._res_done = torch.cuda.Event()
            self._res_done.record()

    def _issue_upload(self, g: int):
        """Start group ``g``'s upload into device slot ``g % 2`` (from its
        file under ``nvme``: the read is waited for here, then the copy
        rides the side stream).  Returns the handle :meth:`_take_group`
        finishes."""
        s = g % 2
        if self._param_swapper is not None:
            if self._read_free[s] is not None:
                self._read_free[s].synchronize()  # the last copy out of this read buffer
            src = self._param_swapper.swap_in(f"group{g:04d}", out=self._read_bufs[s],
                                              async_op=True)
            self._param_swapper.synchronize_reads()
            self.stats["group_read_bytes"] += self.group_bytes
        else:
            src = self._host_groups[g]
        self.stats["group_uploads"] += 1
        if not self.cuda:
            self._part_slots[s].copy_(src)
            return g, None
        with torch.cuda.stream(self._h2d):
            if self._slot_free[s] is not None:
                self._h2d.wait_event(self._slot_free[s])  # the slot's last group is done
            self._part_slots[s].copy_(src, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d)
        if self._param_swapper is not None:
            self._read_free[s] = ready
        return g, ready

    def _take_group(self, handle, requires_grad: bool) -> Dict[str, torch.Tensor]:
        """The uploaded group's leaves (views into its slot), the current
        stream ordered after the copy."""
        g, ready = handle
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        flat = self._slots[g % 2]
        if self._masters_sharded:
            self._assemble(self._part_slots[g % 2], flat)
        out = {}
        for j, key in enumerate(self._block_keys):
            n = torch.Size(self._gshapes_full[j]).numel()
            v = flat[self._goffs_full[j]:self._goffs_full[j] + n].view(self._gshapes_full[j])
            out[key] = v.detach().requires_grad_(True) if requires_grad else v
        return out

    @torch.no_grad()
    def _assemble(self, part: torch.Tensor, whole: torch.Tensor) -> None:
        """A group whole from every fsdp rank's part: one all-gather over
        ``fsdp`` of this rank's flat part (``group-all-gather``), each leaf
        concatenated along its cut dimension into ``whole``."""
        from deepspeed_tpu_torch.comm import collectives

        parts = collectives.all_gather(part, self.mesh.group(("fsdp",)),
                                       kind="group-all-gather").view(self._fsdp, -1)
        for j, i in enumerate(self._block_idx):
            lo, n = self._goffs[j], torch.Size(self._gshapes[j]).numel()
            dst = whole[self._goffs_full[j]:self._goffs_full[j]
                        + torch.Size(self._gshapes_full[j]).numel()].view(self._gshapes_full[j])
            d = self._cut[i]
            if d is None:
                dst.copy_(parts[0, lo:lo + n].view(self._gshapes[j]))
                continue
            torch.cat([parts[f, lo:lo + n].view(self._gshapes[j]) for f in range(self._fsdp)],
                      dim=d, out=dst)

    def _release_group(self, g: int) -> None:
        """Group ``g``'s compute is queued: its slot is free for the next
        upload once the current stream gets past here."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._slot_free[g % 2] = ev

    def _resident(self, requires_grad: bool) -> Dict[str, torch.Tensor]:
        return {k: (d.detach().requires_grad_(True) if requires_grad else d)
                for k, d in zip(self._res_keys, self._res_dev)}

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _generator(self) -> torch.Generator:
        """The micro-step's generator, seeded as the in-memory engine's, so
        the streamed and the in-memory model draw the same dropout seeds."""
        from deepspeed_tpu_torch.runtime.engine import _SEED_MASK

        seed = (self.config.seed * 1_000_003 + self._host_micro_step) & _SEED_MASK
        return torch.Generator().manual_seed(seed)

    def _group_seeds(self, seeds, g: int):
        lo, hi = self._group_rows(g)
        return seeds[lo:hi] if seeds is not None else [None] * self.group_layers

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        t = torch.as_tensor(x)
        return t.pin_memory().to(self.device, non_blocking=True) if self.cuda else t.clone()

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def train_batch(self, batch: Any, timing: Optional[dict] = None) -> torch.Tensor:
        """One step over ``batch`` (every leaf's leading dim ``gas *
        micro_batch``).  ``timing``: pass a dict to run the step serialized
        (a device synchronize after every phase) and receive its seconds
        by phase: ``upload_s`` (host -> device, file reads included),
        ``fwd_s`` / ``bwd_s`` (compute), ``drain_s`` (device -> host
        gradients and their host accumulation), ``opt_s`` (the host step
        and the groups' refresh).  The serialized step is slower than a
        normal one; use normal steps for throughput."""
        gas = self.gradient_accumulation_steps
        rows = next(iter(batch.values())).shape[0]
        mb = rows // gas
        if rows != mb * gas or mb != self.train_micro_batch_size_per_gpu:
            raise ValueError(f"batch rows {rows} != micro_bs*gas "
                             f"{self.train_micro_batch_size_per_gpu * gas}")
        if timing is not None:
            timing.update({k: 0.0 for k in ("upload_s", "fwd_s", "bwd_s", "drain_s", "opt_s")})

        def phase(key, fn, *a):
            if timing is None:
                return fn(*a)
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a)
            self._sync()
            timing[key] += time.perf_counter() - t0
            return out

        losses = []
        for micro in range(gas):
            mbatch = {k: self._to_device(v[micro * mb:(micro + 1) * mb]) for k, v in batch.items()}
            losses.append(self._micro_step(mbatch, micro == 0, phase))
        loss = torch.stack(losses).mean()
        if self.dp_world_size > 1:
            # the global batch's mean: every rank its own rows
            from deepspeed_tpu_torch.comm import collectives

            loss = collectives.all_reduce(loss.float().clone(), self.mesh.group(("data", "fsdp")),
                                          kind="step-scalars") / self.dp_world_size
        phase("opt_s", self._host_step)
        self._publish_step(timing)
        return loss

    def _publish_step(self, timing: Optional[dict]) -> None:
        """The streaming engine has no step timeline: its step counters and
        gauges go to the telemetry registry directly (the JAX engine's
        ``zinf/*``; host values only)."""
        from deepspeed_tpu_torch.telemetry import get_registry

        reg = get_registry()
        if not reg.enabled:
            return
        info = self._last_info
        reg.counter("zinf/steps", engine="offload").inc()
        reg.gauge("zinf/lr", engine="offload").set(info["lr"])
        if info["overflow"]:
            reg.counter("zinf/overflow_skips", engine="offload").inc()
        for key, v in (timing or {}).items():
            reg.gauge(f"zinf/{key}", engine="offload").set(v)

    def _micro_step(self, batch, first: bool, phase) -> torch.Tensor:
        spec, G = self.spec, self.n_groups
        seeds = spec.layer_seeds(self._generator()) if not spec.deterministic else None
        tokens = batch["input_ids"]
        with torch.no_grad():
            res = self._resident(False)
            xs = [phase("fwd_s", spec.embed, res, tokens)]
            inflight = phase("upload_s", self._issue_upload, 0)
            for g in range(G):
                gp = self._take_group(inflight, False)
                xs.append(phase("fwd_s", spec.group, gp, xs[-1], self._group_seeds(seeds, g),
                                spec.deterministic, spec.remat and self.group_layers > 1))
                self._release_group(g)
                if g + 1 < G:  # its copy (and file read) ride under group g's compute
                    inflight = phase("upload_s", self._issue_upload, g + 1)
        # the head and its gradients: to its input and the resident leaves
        res = self._resident(True)
        res_list = list(res.values())

        def head():
            with torch.enable_grad():
                x = xs[-1].detach().requires_grad_(True)
                loss = spec.head_loss(res, x, batch)
                return loss.detach(), torch.autograd.grad(loss, [x] + res_list,
                                                          allow_unused=True)

        loss, (dx, *d_head) = phase("fwd_s", head)
        pend = None
        inflight = phase("upload_s", self._issue_upload, G - 1)
        for g in range(G - 1, -1, -1):
            gp = self._take_group(inflight, True)
            keys = list(gp)

            def group_bwd(gp=gp, g=g, dx=dx):
                with torch.enable_grad():
                    x = xs[g].detach().requires_grad_(True)
                    y = spec.group(gp, x, self._group_seeds(seeds, g), spec.deterministic,
                                   spec.remat and self.group_layers > 1)
                    return torch.autograd.grad(y, [x] + [gp[k] for k in keys], grad_outputs=dx)

            dx, *dgp = phase("bwd_s", group_bwd)
            self._release_group(g)
            if g > 0:
                inflight = phase("upload_s", self._issue_upload, g - 1)
            xs[g + 1] = None
            for t in dgp:
                self._track("grad", t)
            started = phase("drain_s", self._start_drain, g, dgp)
            if pend is not None:
                phase("drain_s", self._finish_drain, pend, first)
            pend = started

        def embed_bwd():
            with torch.enable_grad():
                x0 = spec.embed(res, tokens)
                return torch.autograd.grad(x0, res_list, grad_outputs=dx, allow_unused=True)

        d_embed = phase("bwd_s", embed_bwd)
        phase("drain_s", self._finish_drain, pend, first)
        phase("drain_s", self._drain_resident, d_head, d_embed, first)
        self._host_micro_step += 1
        self.global_samples += self.train_micro_batch_size_per_gpu * self.dp_world_size
        return loss

    def _reduce_group_grads(self, dgp: List[torch.Tensor]) -> List[torch.Tensor]:
        """A group's gradients over the data-parallel ranks (the JAX
        engine's ``group_bwd`` out-shardings): all-reduced over ``data``,
        reduce-scattered over ``fsdp`` to this rank's part (all-reduced
        where nothing is cut), averaged."""
        from deepspeed_tpu_torch.comm import collectives

        data = self.mesh.group(("data",))
        fsdp = self.mesh.group(("fsdp",))
        out = []
        for j, t in enumerate(dgp):
            t = t.contiguous()
            if data is not None:
                t = collectives.all_reduce(t, data, kind="group-grad-reduce")
            if fsdp is not None:
                d = self._cut[self._block_idx[j]]
                t = (collectives.all_reduce(t, fsdp, kind="group-grad-reduce") if d is None else
                     collectives.reduce_scatter(t, fsdp, dim=d, kind="group-grad-reduce"))
            out.append(t / self.dp_world_size)
        return out

    def _start_drain(self, g: int, dgp: List[torch.Tensor]):
        """Copy group ``g``'s gradients (this rank's part, reduced over the
        data-parallel ranks) into pinned staging ``g % 2`` on the drain
        stream (the host adds them one group later)."""
        if self.dp_world_size > 1:
            dgp = self._reduce_group_grads(dgp)
        stage = self._grad_stage[g % 2]
        if not self.cuda:
            for j, t in enumerate(dgp):
                stage[self._goffs[j]:self._goffs[j] + t.numel()].copy_(t.reshape(-1))
            return g, None, dgp
        self._d2h.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._d2h):
            for j, t in enumerate(dgp):
                stage[self._goffs[j]:self._goffs[j] + t.numel()].copy_(t.reshape(-1),
                                                                       non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._d2h)
        return g, done, dgp

    def _finish_drain(self, pend, first: bool) -> None:
        """Wait for a group's gradient copy and add it into the host f32
        accumulators' rows (copy on the first micro-step); the device
        gradients go with the caller's last reference to ``pend``."""
        g, done, _ = pend
        if done is not None:
            done.synchronize()
        stage = self._grad_stage[g % 2]
        lo, hi = self._group_rows(g)
        for j, i in enumerate(self._block_idx):
            n = torch.Size(self._gshapes[j]).numel()
            src = stage[self._goffs[j]:self._goffs[j] + n].view(self._gshapes[j])
            dst = self._host_grads[i][lo:hi]
            if first:
                dst.copy_(src)
            else:
                dst.add_(src)  # promoted to f32 element by element, no copy

    def _drain_resident(self, d_head, d_embed, first: bool) -> None:
        """The resident leaves' gradients to the host; the two of the tied
        ``wte`` (head and embedding) summed in f32 there (across ranks on
        the device, then all-reduced over the data-parallel ranks and
        averaged)."""
        if self.dp_world_size > 1:
            self._drain_resident_ranks(d_head, d_embed, first)
            return
        stages = self._res_grad_stage
        with torch.no_grad():
            for s, grads in enumerate((d_head, d_embed)):
                for k, t in enumerate(grads):
                    if t is not None:
                        stages[s][k].copy_(t, non_blocking=self.cuda)
        self._sync()
        for k, i in enumerate(self._res_idx):
            parts = [stages[s][k].float() for s, grads in enumerate((d_head, d_embed))
                     if grads[k] is not None]
            total = parts[0] if len(parts) == 1 else parts[0] + parts[1]
            if first:
                self._host_grads[i].copy_(total)
            else:
                self._host_grads[i].add_(total)

    @torch.no_grad()
    def _drain_resident_ranks(self, d_head, d_embed, first: bool) -> None:
        from deepspeed_tpu_torch.comm import collectives

        dp = self.mesh.group(("data", "fsdp"))
        for k, i in enumerate(self._res_idx):
            parts = [t[k].float() for t in (d_head, d_embed) if t[k] is not None]
            total = parts[0] if len(parts) == 1 else parts[0] + parts[1]
            total = collectives.all_reduce(total.contiguous(), dp, kind="group-grad-reduce")
            self._res_grad_f32[k].copy_(total / self.dp_world_size)
            if first:
                self._host_grads[i].copy_(self._res_grad_f32[k])
            else:
                self._host_grads[i].add_(self._res_grad_f32[k])

    def _clip_and_check_ranks(self) -> Tuple[float, bool]:
        """The global norm and overflow over the ranks' parts (the JAX
        engine's ``_clip_and_check_global``): each fsdp part's squares
        summed once, by the ``data`` rank 0 of its fsdp rank, the whole
        leaves' by rank 0, in f64; one all-reduce of ``[sq, overflow]``;
        then every rank clips by the global norm."""
        from deepspeed_tpu_torch.comm import collectives

        data0 = self.mesh.coords["data"] == 0
        sq, overflow = 0.0, False
        for i, g in enumerate(self._host_grads):
            if not bool(torch.isfinite(g).all()):
                overflow = True
            mine = (data0 and self._replica0) if (
                self._masters_sharded and self._cut.get(i) is not None) else self.global_rank == 0
            if mine:
                sq += sum_squares_f64(g)
        vec = torch.tensor([sq, 1.0 if overflow else 0.0], dtype=torch.float64)
        vec = collectives.all_reduce(vec, self._host_pg, kind="offload-host-sync")
        norm, overflow = math.sqrt(float(vec[0])), bool(vec[1] > 0)
        clip = self.config.gradient_clipping
        if clip > 0.0 and math.isfinite(norm) and norm > clip:
            factor = clip / (norm + 1e-6)
            for g in self._host_grads:
                g.mul_(factor)
        return norm, overflow

    def _host_step(self) -> None:
        """The boundary on the host: average, check and clip, the host Adam
        (the groups refreshed as their rows land), the resident leaves
        pushed to the device."""
        gas = self.gradient_accumulation_steps
        if self.cuda:
            self._h2d.synchronize()  # no upload still reads a host group buffer
        for g in self._host_grads:
            g.div_(gas)
        if self.world_size > 1:
            grad_norm, overflow = self._clip_and_check_ranks()
        else:
            _, grad_norm, overflow = host_unscale_clip_and_check(
                self._host_grads, 1.0, self.config.gradient_clipping)
        lr = float(self.lr_schedule(self._host_global_step))
        G, gl = self.n_groups, self.group_layers
        if not overflow:
            self._host_opt.step(self._host_grads, lr, self._host_global_step + 1,
                                row_groups=[(g * gl, (g + 1) * gl) for g in range(G)],
                                row_group_prefix=f"{self.spec.blocks_key}/",
                                on_group=self._refresh_group)
            self._push_resident()
            self._host_global_step += 1
        else:
            self.skipped_steps += 1
            logger.warning("offload_param step skipped on non-finite grads")
        self._last_info = {"lr": lr, "grad_norm": grad_norm, "overflow": overflow}

    @torch.no_grad()
    def eval_batch(self, batch: Any) -> torch.Tensor:
        """The loss of one batch, without dropout and without gradients."""
        spec = self.spec
        batch = {k: self._to_device(v) for k, v in batch.items()}
        res = self._resident(False)
        x = spec.embed(res, batch["input_ids"])
        inflight = self._issue_upload(0)
        for g in range(self.n_groups):
            x = spec.group(self._take_group(inflight, False), x, [None] * self.group_layers,
                           True, False)
            self._release_group(g)
            if g + 1 < self.n_groups:
                inflight = self._issue_upload(g + 1)
        return spec.head_loss(res, x, batch)

    # ------------------------------------------------------------------
    # checkpointing (the host masters are the source of truth)
    # ------------------------------------------------------------------
    def _host_buffers_idle(self) -> None:
        self._sync()
        if self._param_swapper is not None:
            self._param_swapper.synchronize()

    def _after_host_load(self) -> None:
        """A load replaced the masters: every group's copy and the resident
        leaves follow."""
        for g in range(self.n_groups):
            self._refresh_group(g)
        if self._param_swapper is not None:
            self._param_swapper.synchronize_writes()
        self._push_resident()

    def _rank_files(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Across fsdp, this rank's masters and moments (its parts of the
        block leaves, the resident leaves whole), ``master/ m/ v/`` by path,
        in its own file beside ``state.pt`` (host copies)."""
        if not self._masters_sharded:
            return {}
        return {f"host_optimizer_rank{self.global_rank}.pt":
                {k: t.detach().clone() for k, t in self._host_opt.state_dict().items()}}

    def _meta_extras(self) -> Dict[str, Any]:
        return {"engine": "zero_infinity_param_offload", "masters_sharded": self._masters_sharded,
                "process_count": self.world_size, "fsdp": self._fsdp,
                "fsdp_part_of_rank": [self.mesh.topology.get_coord(r).fsdp
                                      for r in range(self.world_size)]}

    def _whole_host_state(self, path: str, meta: Dict[str, Any],
                          restored: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The tag's masters and moments whole, ``master/ m/ v/`` by path
        (the JAX engine's ``_reassemble_host_state``): a one-rank tag's from
        its ``state.pt``; a tag sharded over fsdp from every saved part's
        file (the first rank of each part), each block leaf concatenated
        along the saving mesh's cut dimension."""
        if not meta.get("masters_sharded", False):
            out = {}
            for k in self._paths:
                out[f"master/{k}"] = restored[f"params/{k}"]
                for x in ("m", "v"):
                    name = f"host_optimizer/{x}/{k}"
                    if name in restored:
                        out[f"{x}/{k}"] = restored[name]
            return out
        F, parts = int(meta["fsdp"]), list(meta["fsdp_part_of_rank"])
        files = []
        for f in range(F):
            name = os.path.join(path, "state", f"host_optimizer_rank{parts.index(f)}.pt")
            if not os.path.exists(name):
                raise ValueError(
                    f"ZeRO-Infinity checkpoint {path} was saved with its masters sharded over "
                    f"fsdp {F}; part {f}'s file {os.path.basename(name)} is missing, so the "
                    "fsdp axis cannot be resharded")
            files.append(torch.load(name, map_location="cpu", weights_only=True, mmap=True))
        out = {}
        prefix = f"{self.spec.blocks_key}/"
        for name in files[0]:
            k = name.split("/", 1)[1]
            d = (self._cut_dim(self._full_shapes[self._paths.index(k)], F)
                 if k.startswith(prefix) else None)
            out[name] = (files[0][name] if d is None
                         else torch.cat([fl[name] for fl in files], dim=d))
        return out

    def _restore_host(self, path: str, meta: Dict[str, Any], restored: Dict[str, torch.Tensor],
                      moments: bool) -> None:
        """Restore the masters (and, with ``moments``, the moments) from a
        tag of any fsdp size: reassembled whole, then cut to this rank's
        parts; moments the tag does not hold are reset, with a warning."""
        whole = self._whole_host_state(path, meta, restored)
        local = {n: self._leaf_to_local(self._paths.index(n.split("/", 1)[1]), t).contiguous()
                 for n, t in whole.items()}
        if moments and all(f"m/{k}" in local for k in self._paths):
            self._host_opt.load_state_dict(local)
            return
        if moments:
            logger.warning(f"host optimizer state not found in {path}: the f32 masters are "
                           "rebuilt from its parameters and the Adam moments are being RESET")
        self._host_opt.load_masters([local[f"master/{k}"] for k in self._paths])
        if moments:
            self._host_opt.reset_moments()

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, save_latest: bool = True,
                        async_save: Optional[bool] = None):
        """One tag under the port's commit protocol
        (``runtime/checkpointing.py``): on one rank the host masters as
        ``params/`` and the moments under ``host_optimizer/`` in
        ``state.pt``; across fsdp each rank's in its own file
        (:meth:`_rank_files`).  Collective across ranks."""
        from deepspeed_tpu_torch.runtime.checkpointing import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state,
                     save_latest=save_latest, async_save=async_save)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None, **kw):
        from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint as _load

        return _load(self, load_dir, tag=tag, **kw)

