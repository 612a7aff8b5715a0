"""ZeRO-Offload / ZeRO-Infinity — the host-resident optimizer (counterpart
of ``deepspeed_tpu/runtime/zero/offload.py``).

The f32 masters and the Adam moments live in host memory, allocated once
at construction (pinned when the engine runs on the card, so the
gradient copies land in them and the parameter copies leave from them
without a staging copy); with ``device: nvme`` the moments live on disk
instead and stream around each leaf's update through the pipelined
swapper (``runtime/swap/optimizer_swapper.py``).  The update is the
native host Adam (``ops/adam/cpu_adam.py``), in place.

Leaves are keyed by their ``/``-joined paths in the JAX package's order
(``runtime/engine.py::tree_items``); :meth:`HostOffloadOptimizer.state_dict`
keeps the JAX layout (``master/<path>``, ``m/<path>``, ``v/<path>``).
Across ranks the engines give each rank's optimizer its own part: the
in-memory engine one flat slice (``flat``) of the packed masters, the
streaming engine its ``fsdp`` part of every block leaf.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.utils.logging import log_dist


def host_optimizer_refusal(config, optimizer=None) -> Optional[str]:
    """Why the host Adam cannot own this config's update, or None: a client
    optimizer object, or an optimizer other than Adam/AdamW (the JAX
    package's checks, ``engine.py:149-191`` and ``param_offload.py:76``)."""
    if optimizer is not None:
        return ("a client optimizer cannot be combined with offload (the host step owns the "
                "update); drop optimizer= or the offload block")
    name = config.optimizer.name or "adam"
    if name.lower() not in ("adam", "adamw"):
        return f"the host step supports Adam/AdamW, got '{name}'"
    return None


def host_f32(x, pin: bool) -> torch.Tensor:
    """A contiguous f32 host copy of ``x`` (a tensor or array), pinned when
    ``pin``."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    out = torch.empty(tuple(t.shape), dtype=torch.float32, pin_memory=pin)
    out.copy_(t.to(torch.float32))
    return out


class HostOffloadOptimizer:
    """Owns the f32 masters and the moments on the host; steps them with the
    native host Adam; optionally swaps the moments to disk.

    ``items``: ``(path, leaf)`` of every parameter, in the engine's order."""

    def __init__(self, items: Sequence[Tuple[str, object]], lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, adamw_mode: bool = True,
                 nvme_swap_dir: Optional[str] = None, aio_config=None, pipeline: bool = True,
                 pin_memory: bool = False, num_threads: Optional[int] = None):
        self.keys = [k for k, _ in items]
        self.pin_memory = pin_memory
        self.masters: List[torch.Tensor] = [host_f32(v, pin_memory) for _, v in items]
        self.opt = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                    adamw_mode=adamw_mode, num_threads=num_threads)
        self.swapper = None
        if nvme_swap_dir is not None:
            from deepspeed_tpu_torch.runtime.swap.optimizer_swapper import PipelinedOptimizerSwapper

            self.swapper = PipelinedOptimizerSwapper(
                nvme_swap_dir, [tuple(m.shape) for m in self.masters], aio_config=aio_config,
                pipeline=pipeline)
            log_dist(f"ZeRO-Infinity: {len(self.masters)} moment groups on NVMe at {nvme_swap_dir}")
        else:
            self._m = [torch.zeros(m.shape, dtype=torch.float32, pin_memory=pin_memory)
                       for m in self.masters]
            self._v = [torch.zeros(m.shape, dtype=torch.float32, pin_memory=pin_memory)
                       for m in self.masters]
            host_gb = sum(m.numel() for m in self.masters) * 12 / 1e9
            log_dist(f"ZeRO-Offload: f32 masters+moments on host ({host_gb:.2f} GB)")

    @classmethod
    def from_config(cls, config, items: Sequence[Tuple[str, object]], streaming: bool = False,
                    nvme_swap_dir: Optional[str] = None,
                    pin_memory: bool = False) -> "HostOffloadOptimizer":
        """The host optimizer of ``config.optimizer``'s Adam/AdamW.  Decoupled
        weight decay: the in-memory engine takes it for ``AdamW`` and for
        ``Adam`` (or no optimizer named) unless ``adam_w_mode`` is false, the
        streaming engine (``streaming``) for ``AdamW`` or no optimizer named,
        never for ``Adam``, as the JAX package's two engines decide it
        (``engine.py:582``, ``param_offload.py:244``; ROADMAP C4)."""
        name = (config.optimizer.name or "").lower()
        p = dict(config.optimizer.params or {})
        if streaming:
            adamw = name in ("", "adamw")
        else:
            adamw = name == "adamw" or bool(p.get("adam_w_mode", True))
        oc = config.zero_config.offload_optimizer
        return cls(items, lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
                   eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0),
                   adamw_mode=adamw, nvme_swap_dir=nvme_swap_dir, aio_config=config.aio,
                   pipeline=oc.pipeline_read or oc.pipeline_write, pin_memory=pin_memory)

    def _moments(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.swapper is None:
            return self._m[i], self._v[i]
        bufs = self.swapper.get(i)
        return bufs["m"], bufs["v"]

    def step(self, grads: Sequence[torch.Tensor], lr: float, step_count: int,
             row_groups: Optional[List[Tuple[int, int]]] = None, row_group_prefix: str = "",
             on_group: Optional[Callable[[int], None]] = None) -> List[torch.Tensor]:
        """``grads``: one contiguous f32 host tensor per master, in order.
        Updates the masters in place and returns them.

        ``row_groups``: ``(lo, hi)`` leading-dim row ranges over the leaves
        whose path starts with ``row_group_prefix`` (the streaming
        engine's stacked blocks): those leaves step group-major, and
        ``on_group(g)`` fires once range ``g``'s rows are updated across
        all of them, so the caller overlaps each group's write-back with
        the rest of the step.  With the moments on disk the leaves step in
        order (group-major would re-read every leaf's moments once a
        group) and ``on_group`` fires for every group at the end."""
        n = len(self.masters)
        if len(grads) != n:
            raise ValueError(f"host step: {len(grads)} gradients for {n} masters")
        grouped = row_groups is not None and self.swapper is None
        sel = [i for i in range(n) if self.keys[i].startswith(row_group_prefix)] if grouped else []
        for i in (i for i in range(n) if i not in set(sel)):
            if self.swapper is not None and i + 1 < n:
                self.swapper.prefetch(i + 1)  # the next leaf's read rides under this update
            m, v = self._moments(i)
            self.opt.step(self.masters[i], grads[i], m, v, step_count, lr=lr)
            if self.swapper is not None:
                self.swapper.put(i)  # write-back rides under the next update
        if grouped:
            for g, (lo, hi) in enumerate(row_groups):
                for i in sel:
                    # leading-dim slices of contiguous tensors stay contiguous
                    self.opt.step(self.masters[i][lo:hi], grads[i][lo:hi], self._m[i][lo:hi],
                                  self._v[i][lo:hi], step_count, lr=lr)
                if on_group is not None:
                    on_group(g)
        if self.swapper is not None:
            self.swapper.flush()
        if row_groups is not None and on_group is not None and not grouped:
            for g in range(len(row_groups)):
                on_group(g)
        return self.masters

    def load_masters(self, leaves: Sequence[torch.Tensor]) -> None:
        """Overwrite the masters (in place: their pinned buffers stay)."""
        if len(leaves) != len(self.masters):
            raise ValueError(f"load_masters: {len(leaves)} leaves for {len(self.masters)} masters")
        for m, x in zip(self.masters, leaves):
            m.copy_(torch.as_tensor(x).to(torch.float32).reshape(m.shape))

    def reset_moments(self) -> None:
        for i, m in enumerate(self.masters):
            if self.swapper is None:
                self._m[i].zero_()
                self._v[i].zero_()
            else:
                zeros = torch.zeros(m.shape, dtype=torch.float32)
                self.swapper.load_group(i, zeros, zeros)

    # -- checkpoint support ------------------------------------------------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """``master/<path>``, ``m/<path>``, ``v/<path>``: live tensors (under
        ``nvme`` the moments are read back from disk first)."""
        out = {}
        for i, k in enumerate(self.keys):
            out[f"master/{k}"] = self.masters[i]
            out[f"m/{k}"], out[f"v/{k}"] = self._moments(i)
        return out

    def load_state_dict(self, data: Dict[str, torch.Tensor]) -> None:
        """Install ``master/ m/ v/``-keyed tensors (the :meth:`state_dict`
        layout), in place."""
        for i, k in enumerate(self.keys):
            want, got = tuple(self.masters[i].shape), tuple(data[f"master/{k}"].shape)
            if got != want:
                raise ValueError(f"host optimizer leaf '{k}': checkpoint shape {got} != "
                                 f"engine shape {want}")
        for i, k in enumerate(self.keys):
            self.masters[i].copy_(data[f"master/{k}"].to(torch.float32))
            m, v = data[f"m/{k}"], data[f"v/{k}"]
            if self.swapper is not None:
                self.swapper.load_group(i, m, v)
            else:
                self._m[i].copy_(m.to(torch.float32))
                self._v[i].copy_(v.to(torch.float32))


_NORM_CHUNK = 1 << 20


def sum_squares_f64(g: torch.Tensor) -> float:
    """The sum of ``g``'s squares in f64, ``_NORM_CHUNK`` elements at a time
    (no f64 copy of the whole tensor)."""
    sq = 0.0
    for c in g.view(-1).split(_NORM_CHUNK):
        c = c.to(torch.float64)
        sq += float(torch.dot(c, c))
    return sq


def host_unscale_clip_and_check(grads_flat: List[torch.Tensor], scale: float,
                                clip: float) -> Tuple[List[torch.Tensor], float, bool]:
    """Host-side unscale, global-norm clip and overflow check, in place on
    contiguous f32 host tensors, as the JAX package's executor on the host
    does it: the squares summed in f64 (a chunk of ``_NORM_CHUNK`` at a
    time, so no f64 copy of a whole leaf is made).  A non-finite value
    makes the f64 sum non-finite (a finite f32 square cannot overflow
    f64), so the sum is the overflow check."""
    inv = 1.0 / scale
    sq = 0.0
    for g in grads_flat:
        if inv != 1.0:
            g.mul_(inv)
        sq += sum_squares_f64(g)
    overflow = not math.isfinite(sq)
    norm = math.sqrt(sq)
    if clip > 0.0 and not overflow and norm > clip:
        factor = clip / (norm + 1e-6)
        for g in grads_flat:
            g.mul_(factor)
    return grads_flat, norm, overflow
