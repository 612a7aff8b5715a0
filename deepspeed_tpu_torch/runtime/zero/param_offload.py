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

One rank only: offload across ranks raises (ROADMAP A12), as the JAX
package's fsdp streaming (``_setup_host_partition``) is not ported.
"""
from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.zero.offload import (
    HostOffloadOptimizer,
    host_optimizer_refusal,
    host_unscale_clip_and_check,
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
        spec: StreamSpec = model.stream_spec
        self.device = resolve_device(device)
        self.config, self.spec = config, spec
        self.world_size, self.dp_world_size, self.global_rank = 1, 1, 0
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
        nvme_dir = None
        if zc.offload_optimizer.device == "nvme" or zc.offload_param.device == "nvme":
            nvme_dir = zc.offload_param.nvme_path or zc.offload_optimizer.nvme_path
            if not nvme_dir:
                raise ValueError("offload device nvme requires nvme_path")
        self._host_opt = HostOffloadOptimizer.from_config(
            config, list(zip(self._paths, leaves)), streaming=True,
            nvme_swap_dir=(os.path.join(nvme_dir, "moments")
                           if zc.offload_optimizer.device == "nvme" else None),
            pin_memory=self.cuda)
        masters = self._host_opt.masters
        self._host_grads = [torch.zeros(m.shape, dtype=torch.float32, pin_memory=self.cuda)
                            for m in masters]
        # one group's slice of each block leaf: its shape and its offset in
        # the group's flat compute-type buffer
        self._gshapes = [(gl,) + tuple(masters[i].shape[1:]) for i in self._block_idx]
        sizes = [torch.Size(s).numel() for s in self._gshapes]
        self._goffs = [sum(sizes[:j]) for j in range(len(sizes))]
        self._gnumel = sum(sizes)
        self._esize = torch.empty((), dtype=self.compute_dtype).element_size()
        self.group_bytes = self._gnumel * self._esize

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
        self._slots = [torch.empty(self._gnumel, dtype=self.compute_dtype, device=self.device)
                       for _ in range(2)]
        self._live("param", 2 * self.group_bytes)  # they live as long as the engine
        self._slot_free: List[Optional[Any]] = [None, None]
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._slot_free = [ev, ev]
        self._grad_stage = [pinned(self._gnumel) for _ in range(2)]
        self._res_grad_stage = [[pinned(masters[i].shape) for i in self._res_idx] for _ in range(2)]
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
        log_dist(
            f"ZeRO-Infinity engine: {spec.n_layer} layers in {self.n_groups} groups of {gl}, "
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

    @property
    def params(self) -> Any:
        """The host f32 masters as the caller's tree."""
        return self._unflatten(list(self._host_opt.masters))

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self._host_global_step))]

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
            self._slots[s].copy_(src)
            return g, None
        with torch.cuda.stream(self._h2d):
            if self._slot_free[s] is not None:
                self._h2d.wait_event(self._slot_free[s])  # the slot's last group is done
            self._slots[s].copy_(src, non_blocking=True)
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
        out = {}
        for j, key in enumerate(self._block_keys):
            n = torch.Size(self._gshapes[j]).numel()
            v = flat[self._goffs[j]:self._goffs[j] + n].view(self._gshapes[j])
            out[key] = v.detach().requires_grad_(True) if requires_grad else v
        return out

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
        phase("opt_s", self._host_step)
        return loss

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
        self.global_samples += self.train_micro_batch_size_per_gpu
        return loss

    def _start_drain(self, g: int, dgp: List[torch.Tensor]):
        """Copy group ``g``'s gradients into pinned staging ``g % 2`` on the
        drain stream (the host adds them one group later)."""
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
        ``wte`` (head and embedding) summed in f32 there."""
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

    def _host_step(self) -> None:
        """The boundary on the host: average, check and clip, the host Adam
        (the groups refreshed as their rows land), the resident leaves
        pushed to the device."""
        gas = self.gradient_accumulation_steps
        if self.cuda:
            self._h2d.synchronize()  # no upload still reads a host group buffer
        for g in self._host_grads:
            g.div_(gas)
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

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None, save_latest: bool = True,
                        async_save: Optional[bool] = None):
        """One tag under the port's commit protocol
        (``runtime/checkpointing.py``): the host masters as ``params/``,
        the moments under ``host_optimizer/``."""
        from deepspeed_tpu_torch.runtime.checkpointing import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state,
                     save_latest=save_latest, async_save=async_save)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None, **kw):
        from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint as _load

        return _load(self, load_dir, tag=tag, **kw)

