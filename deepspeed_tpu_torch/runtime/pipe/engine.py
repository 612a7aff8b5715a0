"""Pipeline-parallel engine (counterpart of
``deepspeed_tpu/runtime/pipe/engine.py``; reference ``PipelineEngine``
:46, ``train_batch`` :250, the instruction executors :540-1005,
``_exec_schedule`` :1209).

The JAX engine compiles a whole batch into one ``shard_map`` program over
the ``pipe`` axis and lets XLA overlap the ``ppermute`` transfers.  Here
each ``pipe`` rank runs its own stage, as the reference does: it
interprets its stage's instruction stream (``runtime/pipe/schedule.py``:
``TrainSchedule`` for ``"1f1b"``; for ``"gpipe"`` every forward, then
every backward) and moves activations forward and their gradients back
with ``isend``/``irecv`` on the ``pipe`` group (``comm/collectives.py``
``p2p_send`` / ``p2p_recv``, counted as ``pipe-p2p``; a CUDA tensor on a
gloo group goes through pinned host memory, for stage processes sharing
one card).  Shapes are static (every stage runs the first stage's layers
on the batch once, without gradients, to learn them), so no shape
handshake travels.

* Stage 0 runs the layers before the body, the last stage the layers
  after it and ``loss_fn``; stage ``s`` runs body blocks ``[s*K,
  (s+1)*K)``, the block of the stacked ``blocks`` leaves the ``pipe``
  axis gives it (the module's partition rules ``stacked`` over ``pipe``,
  as the JAX engine's), each block's leaves also cut over ``model`` by
  the rules, as in the data-parallel engine.
* The ``pre``, ``post`` and ``tied`` leaves live on every stage; their
  gradients are summed over ``pipe`` before the step (``pipe-grad-reduce``:
  the reference's ``ReduceTiedGrads`` for the embedding ⇄ head pair, the
  JAX engine's psum of its pre/post gradients), so every stage updates
  them alike.  Then the data-parallel reduction and the optimizer step
  are the base engine's.
* 1F1B holds at most ``S`` micro-batches' stage inputs and outputs live,
  whatever ``M`` is; GPipe holds ``M``.  :attr:`max_live` reads it.

The JAX engine's contract holds: ZeRO stage > 1 raises; ``forward``,
``backward`` and ``step`` raise; ``train_batch(data_iter=, batch=)`` and
``eval_batch`` return the batch's loss on every rank; the gradients are
a sequential run's.  A ``pipe`` rank's generator seed is the step's and
the micro-batch's, and each layer draws from it by its place in the
model (``module.layer_generator``), so a layer's randomness does not
depend on the stage that runs it.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.parallel.sequence import ambient_mesh
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine, tree_flatten
from deepspeed_tpu_torch.runtime.pipe import schedule as sched
from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule
from deepspeed_tpu_torch.sharding.spec import entry_axes
from deepspeed_tpu_torch.utils.logging import log_dist

PIPE_P2P = "pipe-p2p"
PIPE_GRAD_REDUCE = "pipe-grad-reduce"


def gpipe_steps(micro_batches: int, stages: int, stage_id: int):
    """GPipe's stream in the schedules' instructions: every forward (with
    its receive and send), then every backward, then the reductions and
    the step.  Each micro-batch has a buffer of its own."""
    first, last = stage_id == 0, stage_id == stages - 1
    for m in range(micro_batches):
        cmds = []
        if first or last:
            cmds.append(sched.LoadMicroBatch(m))
        if not first:
            cmds.append(sched.RecvActivation(m))
        cmds.append(sched.ForwardPass(m))
        if not last:
            cmds.append(sched.SendActivation(m))
        yield cmds
    for m in range(micro_batches):
        cmds = []
        if not last:
            cmds.append(sched.RecvGrad(m))
        cmds.append(sched.BackwardPass(m))
        if not first:
            cmds.append(sched.SendGrad(m))
        if m == micro_batches - 1:
            cmds += [sched.ReduceTiedGrads(), sched.ReduceGrads(), sched.OptimizerStep()]
        yield cmds


def pipe_comm_model(act_shape, act_bytes: int, micro_batches: int, stages: int, stage_id: int,
                    replicated_numel: int) -> Dict[str, int]:
    """Bytes one stage counts a training step: ``pipe-p2p``, one
    activation sent forward a micro-batch (all stages but the last) and
    one gradient back (all but the first); ``pipe-grad-reduce``, the f32
    gradients of the leaves every stage holds (``replicated_numel``
    elements) all-reduced over ``pipe`` (twice the payload)."""
    if stages <= 1:
        return {PIPE_P2P: 0, PIPE_GRAD_REDUCE: 0}
    a = int(np.prod(act_shape)) * act_bytes
    sends = int(stage_id < stages - 1) + int(stage_id > 0)
    return {PIPE_P2P: micro_batches * sends * a, PIPE_GRAD_REDUCE: 2 * 4 * replicated_numel}


class _BusyClock:
    """A stage's compute spans in a step: CUDA events around each forward
    and backward on the card (device time), host time on the CPU.
    :meth:`idle_share` is the rest of the step's wall (waits for the
    neighbours, transfers, the bubble) over the wall: the card's idle
    share where the stage has a card of its own.  Where stage processes
    share a card, a span also takes in the other stages' kernels that
    ran inside it, so the share is not the card's idle time."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.spans: List = []
        self.busy = 0.0
        self.t_start = time.perf_counter()

    def __enter__(self):
        if self.cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e0.record()
        else:
            self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            self.spans.append((self._e0, e1))
        else:
            self.busy += time.perf_counter() - self._t0

    def idle_share(self) -> Optional[float]:
        if self.cuda:
            torch.cuda.synchronize()
            self.busy = sum(a.elapsed_time(b) for a, b in self.spans) / 1e3
        wall = time.perf_counter() - self.t_start
        return None if wall <= 0 else max(0.0, 1.0 - self.busy / wall)


class PipelineEngine(DeepSpeedEngine):
    """Training engine for :class:`PipelineModule` models."""

    def __init__(self, module: PipelineModule, config: DeepSpeedConfig, mesh=None,
                 params: Any = None, tp_spec_fn=None, partition_rules=None, device: Any = "cuda",
                 **kw):
        from deepspeed_tpu_torch.comm.mesh import Mesh
        from deepspeed_tpu_torch.sharding.mesh import build_mesh
        from deepspeed_tpu_torch.sharding.rules import PartitionRules

        if config.zero_config.stage > 1:
            # the reference's constraint (pipe/engine.py:56), for its
            # reason: partitioned gradients conflict with the pipeline's
            # accumulation over micro-batches
            raise AssertionError("ZeRO stages > 1 are incompatible with pipeline parallelism")
        if config.zero_config.offload_optimizer.enabled:  # as the JAX engine
            raise NotImplementedError("offload_optimizer is not supported with the pipeline engine yet")
        if config.progressive_layer_drop.enabled:  # as the JAX engine
            raise NotImplementedError(
                "progressive_layer_drop is not wired into the pipeline engine yet "
                "(theta injection lives in the micro-step path)")
        if not isinstance(mesh, Mesh):
            mesh, _ = build_mesh(config.mesh if mesh is None else mesh)
        self.num_stages = mesh.sizes["pipe"]
        self.stage_id = mesh.coords["pipe"]
        self.pipe_module = module
        module.configure_stages(self.num_stages)
        if params is None:
            params = module.build_params(config.seed)
        self._micro_batches = config.gradient_accumulation_steps
        self._schedule = config.pipeline.schedule
        base_rules = PartitionRules.coerce(partition_rules, tp_spec_fn)
        super().__init__(model=self.forward, params=params, config=config, mesh=mesh,
                         partition_rules=base_rules.stacked(prefix="blocks"), device=device,
                         **kw)
        self._pipe_ranks = mesh.members(("pipe",))
        self._pipe_group = mesh.group(("pipe",))
        self._act: Dict[Tuple, Tuple[torch.Size, torch.dtype]] = {}
        self.max_live = 0
        self.idle_share: Optional[float] = None
        M, S = self._micro_batches, self.num_stages
        log_dist(f"pipeline engine: stages={S} micro_batches={M} body_layers={module.body_len} "
                 f"schedule={self._schedule} bubble={(S - 1) / (M + S - 1):.1%}")

    # the reference disables the unfused API on pipeline engines
    # (pipe/engine.py:1100-1130), and so does the JAX package
    def forward(self, *a, **kw):
        raise RuntimeError("PipelineEngine only supports train_batch() / eval_batch()")

    __call__ = forward

    def backward(self, *a, **kw):
        raise RuntimeError("PipelineEngine only supports train_batch() / eval_batch()")

    def step(self, *a, **kw):
        raise RuntimeError("PipelineEngine only supports train_batch() / eval_batch()")

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    @staticmethod
    def _split_batch(batch: Any) -> Tuple[Any, Any]:
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            return batch[0], batch[1]
        if isinstance(batch, dict):
            labels = batch.get("labels", batch.get("label"))
            if labels is None:
                raise TypeError("pipeline batch dict must contain a 'labels' entry")
            inputs = {k: v for k, v in batch.items() if k not in ("labels", "label")}
            if len(inputs) == 1:
                inputs = next(iter(inputs.values()))
            return inputs, labels
        raise TypeError("pipeline batch must be (inputs, labels) or a dict with 'labels'")

    def _full_batch_from(self, data_iter_or_batch: Any) -> Any:
        if hasattr(data_iter_or_batch, "__next__"):
            micro = [next(data_iter_or_batch) for _ in range(self._micro_batches)]
            leaves = [tree_flatten(m)[0] for m in micro]
            _, rebuild = tree_flatten(micro[0])
            cat = [torch.cat([torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor)
                              else x for x in xs]) for xs in zip(*leaves)]
            return rebuild(cat)
        return data_iter_or_batch

    def _micro_split(self, batch: Any) -> Tuple[List[Any], List[Any]]:
        inputs, labels = self._split_batch(self._prepare_batch(self._full_batch_from(batch)))
        M = self._micro_batches

        def cut(tree):
            leaves, rebuild = tree_flatten(tree)
            B = leaves[0].shape[0]
            if B % M:
                raise ValueError(f"batch {B} not divisible by {M} micro-batches")
            mb = B // M
            return [rebuild([x[m * mb:(m + 1) * mb] for x in leaves]) for m in range(M)]

        return cut(inputs), cut(labels)

    def _seed(self, m: int) -> int:
        return (self.config.seed * 1_000_003 + self._host_micro_step + m) & ((1 << 63) - 1)

    # ------------------------------------------------------------------
    # one stage
    # ------------------------------------------------------------------
    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.num_stages - 1

    def _stage_forward(self, params, x, inp, lab, seed: Optional[int]):
        """This stage's layers on micro-batch input ``inp`` (stage 0) or on
        the received activation ``x``; the last stage returns the loss."""
        module = self.pipe_module
        if self.is_first_stage:
            x = module.apply_pre(params, inp, seed)
        K = module.body_len // self.num_stages
        x = module.apply_blocks(params["blocks"], x, self.stage_id * K, seed)
        if not self.is_last_stage:
            return x
        out = module.apply_post(params, x, seed)
        loss = module.loss_fn(out, lab) if module.loss_fn is not None else out
        loss = torch.as_tensor(loss)
        return loss.mean() if loss.ndim else loss

    def _act_meta(self, params, inp) -> Tuple[torch.Size, torch.dtype]:
        """The activation's shape and type between stages: the first
        stage's layers run on the micro-batch once, without gradients
        (every stage holds them and the batch, so no handshake)."""
        leaves = tree_flatten(inp)[0]
        key = tuple((tuple(x.shape), x.dtype) for x in leaves)
        if key not in self._act:
            with torch.no_grad(), ambient_mesh(self.mesh):
                h = self.pipe_module.apply_pre(params, inp, None)
            self._act[key] = (h.shape, h.dtype)
        return self._act[key]

    def _send(self, t: torch.Tensor, stage: int, pending: List) -> None:
        pending.append(collectives.p2p_send(t, self._pipe_ranks[stage], self._pipe_group,
                                            kind=PIPE_P2P))

    def _recv(self, meta, stage: int) -> torch.Tensor:
        shape, dtype = meta
        return collectives.p2p_recv(shape, dtype, self.device, self._pipe_ranks[stage],
                                    self._pipe_group)

    def _run_train(self, params, inputs: List[Any], labels: List[Any]) -> List[torch.Tensor]:
        """Interpret this stage's stream over the step's micro-batches:
        forwards and backwards in micro-batch order, gradients summed
        into the masters' ``.grad``.  Returns the last stage's losses."""
        M, S, s = self._micro_batches, self.num_stages, self.stage_id
        steps = (gpipe_steps(M, S, s) if self._schedule == "gpipe"
                 else sched.TrainSchedule(M, S, s).steps())
        meta = self._act_meta(params, inputs[0]) if S > 1 else None
        fwd_next = bwd_next = 0
        buf_fwd: Dict[int, int] = {}
        buf_bwd: Dict[int, int] = {}
        recv_act: Dict[int, torch.Tensor] = {}
        recv_grad: Dict[int, torch.Tensor] = {}
        live: Dict[int, Tuple[Optional[torch.Tensor], torch.Tensor]] = {}
        in_grad: Dict[int, torch.Tensor] = {}
        losses: List[torch.Tensor] = []
        pending: List = []
        clock = _BusyClock(self.device)
        for cmds in steps:
            for c in cmds:
                if isinstance(c, sched.RecvActivation):
                    recv_act[c.buffer_id] = self._recv(meta, s - 1)
                elif isinstance(c, sched.ForwardPass):
                    m, fwd_next = fwd_next, fwd_next + 1
                    buf_fwd[c.buffer_id] = m
                    x = None
                    if not self.is_first_stage:
                        x = recv_act.pop(c.buffer_id).requires_grad_(True)
                    with clock:
                        y = self._stage_forward(params, x, inputs[m], labels[m], self._seed(m))
                    live[m] = (x, y)
                    self.max_live = max(self.max_live, len(live))
                    if self.is_last_stage:
                        losses.append(y.detach().float())
                elif isinstance(c, sched.SendActivation):
                    self._send(live[buf_fwd[c.buffer_id]][1], s + 1, pending)
                elif isinstance(c, sched.RecvGrad):
                    recv_grad[c.buffer_id] = self._recv(meta, s + 1)
                elif isinstance(c, sched.BackwardPass):
                    m, bwd_next = bwd_next, bwd_next + 1
                    buf_bwd[c.buffer_id] = m
                    x, y = live.pop(m)
                    with clock:
                        if self.is_last_stage:
                            self.loss_scaler.scale_loss(y.float(), self.loss_scale_state).backward()
                        else:
                            torch.autograd.backward(y, recv_grad.pop(c.buffer_id))
                    if x is not None:
                        in_grad[m] = x.grad
                elif isinstance(c, sched.SendGrad):
                    self._send(in_grad.pop(buf_bwd[c.buffer_id]), s - 1, pending)
                # LoadMicroBatch: the micro-batches are on the device
                # already; ReduceTiedGrads / ReduceGrads / OptimizerStep:
                # train_batch's, after the stream
        for p in pending:
            p.wait()
        self.idle_share = clock.idle_share()
        return losses

    def _reduce_pipe_grads(self) -> None:
        """Sum over ``pipe`` the gradients of every leaf the stages all hold
        (``pre``, ``post``, ``tied``): each is nonzero only where a stage
        ran the layer (a tied key on the first and the last)."""
        if self.num_stages <= 1:
            return
        for i, p in enumerate(self._params):
            if any("pipe" in entry_axes(e) for e in self.layout.leaves[i].param_spec):
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = collectives.all_reduce(g, self._pipe_group, kind=PIPE_GRAD_REDUCE)

    def replicated_numel(self) -> int:
        """Elements of the leaves every stage holds (``pipe-grad-reduce``'s
        payload; one ``model`` rank's block)."""
        return sum(self.layout.local_numel(i) for i in range(len(self._params))
                   if not any("pipe" in entry_axes(e)
                              for e in self.layout.leaves[i].param_spec))

    # ------------------------------------------------------------------
    # public API (reference train_batch, pipe/engine.py:250)
    # ------------------------------------------------------------------
    def train_batch(self, data_iter: Any = None, batch: Any = None) -> torch.Tensor:
        """One global step: every micro-batch through the pipeline, the
        reductions and the optimizer step.  Takes a data iterator (the
        reference's signature: ``gradient_accumulation_steps`` micro-batches
        drawn from it) or a whole batch (leaves ``[gas * micro, ...]``, this
        rank's rows).  Returns the batch's mean loss on every rank."""
        src = data_iter if data_iter is not None else batch
        if src is None:
            raise ValueError("train_batch() needs data_iter or batch")
        inputs, labels = self._micro_split(src)
        t_compute = time.perf_counter()
        params = self._materialize_params()
        with ambient_mesh(self.mesh):
            losses = self._run_train(params, inputs, labels)
        self._reduce_pipe_grads()
        self._accumulate()
        M = self._micro_batches
        self._host_micro_step += M
        self.global_samples += self.train_micro_batch_size_per_gpu * M * self.dp_world_size
        loss = (torch.stack(losses).mean() if losses
                else torch.zeros((), dtype=torch.float32, device=self.device))
        info = self._apply_step(loss)
        loss = info["loss"]
        self._last_loss = loss
        self._fence_compute(t_compute)
        self._end_step(info, loss=loss)
        return loss

    @torch.no_grad()
    def eval_batch(self, data_iter: Any = None, batch: Any = None) -> torch.Tensor:
        """The batch's mean loss without gradients, on every rank."""
        src = data_iter if data_iter is not None else batch
        inputs, labels = self._micro_split(src)
        params = self._materialize_params()
        S, s = self.num_stages, self.stage_id
        losses, pending = [], []
        with ambient_mesh(self.mesh):
            meta = self._act_meta(params, inputs[0]) if S > 1 else None
            for m in range(self._micro_batches):
                x = None if self.is_first_stage else self._recv(meta, s - 1)
                y = self._stage_forward(params, x, inputs[m], labels[m], None)
                if self.is_last_stage:
                    losses.append(y.float())
                else:
                    self._send(y, s + 1, pending)
        for p in pending:
            p.wait()
        loss = (torch.stack(losses).mean() if losses
                else torch.zeros((), dtype=torch.float32, device=self.device))
        if self.world_size > 1:
            mine = loss if self._counts_loss() else torch.zeros_like(loss)
            loss = collectives.all_reduce(mine.clone(), self.mesh.world_group(),
                                          kind="step-scalars") / self.dp_world_size
        return loss
