"""ServingEngine: continuous batching over a slot-pool or a paged KV cache
(counterpart of ``deepspeed_tpu/serving/engine.py``).

Sits on top of an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
(whose params, device and dtype it reuses) and replaces the closed
``generate()`` loop with a request stream:

* ``submit()`` — admission-controlled (queue bound, per-request
  queue-wait deadlines, capacity validation with the derived numbers);
* ``step()`` — one scheduler tick: expire/admit, up to
  ``prefill_chunks_per_step`` prompt chunks, then ONE decode step over
  the whole slot pool;
* ``drain()`` — run until every request finishes, return the results.

Every step has the same shapes: a prefill chunk is ``(1,
prefill_chunk)`` tokens at a slot and position, a decode step is
``(num_slots, 1)`` tokens with a per-slot position vector.  Both write
the pool's cache tensors in place.

``serving.kvcache.enabled`` swaps the slot pool for the paged pool
(:class:`~deepspeed_tpu_torch.serving.kvcache.PagedKVPool`): requests
that share a prompt prefix reuse its pages and prefill restarts at the
first uncached chunk, a partly filled shared tail page is copied before
the slot's first chunk writes, a finished turn under a ``session_id``
parks its pages for the next turn, and every decode step attends
through the page tables (the paged flash-decode kernel on the card).

Decoding is greedy by default (bit parity with solo ``generate()`` in
the JAX package, token parity up to near-ties here); per-request
sampling draws from generators keyed on (seed, position), so a
request's tokens do not depend on its slot.

**Across ranks** (an engine with ``mp_size=M`` under a process group,
``inference/engine.py``): each rank's pools hold its ``n_head / M``
heads (the JAX engine replicates its pools: ROADMAP C4), the host
allocator, prefix index and copy-on-write are the same on every rank,
and a session spill lands in a subdirectory of the rank's own.  Every
rank runs the same scheduler, so every rank must see the same
submissions and the same clock.  ``submit`` and ``cancel`` are
collectives: every rank calls them in the same order, rank 0 decides
(admission reads its measured step time) and broadcasts the outcome,
and every rank applies it or raises rank 0's refusal, so ids and queues
agree at every call.  Once a step (and at the start of a drain) rank 0
broadcasts its ``time.monotonic()``, and every rank plans the step on
it.  Within a step every decision reads the broadcast clock; rank 0
stamps its requests' first-token and finish times with its own clock
after them, for the metrics.  ``stats()`` then skips the idle sweeps
(they would read a rank's own clock).

Not ported yet (ROADMAP A8): the request journal, the SIGTERM watchdog
and its session spill at drain, telemetry spans, the ds_san/ds_shard
hooks, tenants, the fleet and KV tiering.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.config.config import ServingConfig
from deepspeed_tpu_torch.inference.engine import sample_logits_pooled
from deepspeed_tpu_torch.ops.transformer.inference import forward_with_cache
from deepspeed_tpu_torch.serving.kvcache import GARBAGE_PAGE, PagedKVPool
from deepspeed_tpu_torch.serving.pool import SlotKVPool, _leaves
from deepspeed_tpu_torch.serving.scheduler import (
    PRIORITY_NORMAL,
    ContinuousScheduler,
    PrefillJob,
    Request,
    ServingDraining,
    ServingOverloaded,
    ServingQueueFull,
)
from deepspeed_tpu_torch.utils.logging import log_dist

# the decode kernel's row tile on the TPU; the pool capacity keeps the
# JAX engine's alignment so that both engines build the same pool shapes
_TPU_DECODE_ALIGN = 128
# the collectives' kind for the ranks' agreement on a session restore
AGREE_KIND = "session-agree"


def rank_spill_dir(spill_dir: Optional[str], mesh) -> Optional[str]:
    """A rank's own session-spill directory: ``spill_dir`` on one rank,
    ``spill_dir/model<r>`` (``-data<j>`` past one data replica) on a mesh
    of several, each with its own manifests."""
    if not spill_dir or mesh is None or mesh.world_size == 1:
        return spill_dir or None
    name = f"model{mesh.coords['model']}"
    if mesh.sizes["data"] > 1:
        name += f"-data{mesh.coords['data']}"
    return os.path.join(spill_dir, name)


class ServingEngine:
    def __init__(self, engine, config: Any = None, **overrides):
        """``engine``: a built InferenceEngine.  ``config``: a
        :class:`ServingConfig`, a raw ``serving`` config dict, or None;
        ``overrides`` replace individual fields (``num_slots=2, ...``)."""
        if config is None:
            config = ServingConfig()
        elif isinstance(config, dict):
            config = ServingConfig.from_dict(config)
        if overrides:
            config = ServingConfig.from_dict({**dataclasses.asdict(config), **overrides})
        else:
            config = ServingConfig.from_dict(dataclasses.asdict(config))
        self.engine = engine
        self.config = config
        mcfg = engine.model_config

        capacity = engine.generation_capacity
        if config.max_len:
            if config.max_len > capacity:
                raise ValueError(
                    f"serving.max_len={config.max_len} exceeds the engine's "
                    f"generation capacity min(max_out_tokens={engine.max_out_tokens}, "
                    f"n_positions={mcfg.n_positions}) = {capacity}"
                )
            max_len = config.max_len
        else:
            # derive: the engine capacity floored to a (chunk, 128) common
            # multiple — the JAX engine's rule with its decode kernel armed
            # — or to a chunk multiple when that is too small for a chunk
            # (chunk-multiple capacity keeps the last chunk's write from
            # clamping)
            max_len = (capacity // config.prefill_chunk) * config.prefill_chunk
            if max_len < 1:
                raise ValueError(
                    f"serving.prefill_chunk={config.prefill_chunk} exceeds the "
                    f"engine's generation capacity {capacity}; lower the chunk "
                    f"or raise max_out_tokens"
                )
            step = math.lcm(config.prefill_chunk, _TPU_DECODE_ALIGN)
            aligned = (capacity // step) * step
            if aligned >= config.prefill_chunk:
                max_len = aligned
        kv_dtype = "int8" if config.kv_cache_dtype == "int8" else engine._kv_dtype
        self.device = engine.device
        # across ranks: rank 0's admissions, cancellations and clock
        mesh = engine.mesh
        self._group = mesh.world_group() if mesh is not None and mesh.world_size > 1 else None
        self._rank0 = self._group is None or mesh.rank == 0
        self._now = 0.0  # the step's clock (rank 0's under a group)
        heads = engine.local_heads
        kvc = config.kvcache
        self._paged = bool(kvc.enabled)
        if self._paged:
            if config.max_len:
                if max_len % kvc.page_len:
                    raise ValueError(
                        f"serving.max_len={max_len} must be a multiple of "
                        f"serving.kvcache.page_len={kvc.page_len} — the paged "
                        "pool maps slots as whole pages"
                    )
            else:
                # re-floor the derived capacity to a (chunk, page_len)
                # common multiple: chunk-multiple keeps the last prefill
                # write from clamping, page-multiple keeps slots whole
                step = math.lcm(config.prefill_chunk, kvc.page_len)
                aligned = (capacity // step) * step
                if aligned < config.prefill_chunk:
                    raise ValueError(
                        f"serving.kvcache.page_len={kvc.page_len} cannot align "
                        f"to the engine capacity {capacity} within "
                        f"lcm(prefill_chunk={config.prefill_chunk}, page_len)="
                        f"{step}; lower page_len or raise max_out_tokens"
                    )
                max_len = aligned
            self.pool = PagedKVPool(
                mcfg.n_layer, config.num_slots, heads, max_len,
                mcfg.head_dim, kv_dtype, page_len=kvc.page_len,
                num_pages=(kvc.num_pages or None), device=self.device,
                prefill_chunk=config.prefill_chunk,
                pinned_prefixes=kvc.pinned_prefixes,
                session_ttl_seconds=kvc.session_ttl_seconds,
                spill_dir=rank_spill_dir(kvc.spill_dir, mesh),
                agree=self._agree if self._group is not None else None,
            )
        else:
            self.pool = SlotKVPool(
                mcfg.n_layer, config.num_slots, heads, max_len, mcfg.head_dim,
                kv_dtype, device=self.device,
            )
        self.scheduler = ContinuousScheduler(
            self.pool,
            prefill_chunk=config.prefill_chunk,
            prefill_chunks_per_step=config.prefill_chunks_per_step,
            max_queue=config.max_queue,
            deadline_seconds=config.deadline_seconds,
            capacity=min(max_len, capacity),
            slo_ttft_ms=config.slo_ttft_ms,
            degrade_queue_watermark=config.degrade_queue_watermark,
            degrade_engage_steps=config.degrade_engage_steps,
            degrade_disengage_steps=config.degrade_disengage_steps,
            degrade_max_new_tokens=config.degrade_max_new_tokens,
        )
        # the admission controller's measured-service-rate feed
        self.scheduler.step_seconds_fn = self._measured_step_seconds
        self._step_wall_ewma: Optional[float] = None
        self._icfg = engine.inference_config(max_len)
        self._step_count = 0
        self._phase_seconds = {"sched": 0.0, "prefill": 0.0, "decode": 0.0}
        self.prefill_chunks = 0
        self.decode_steps = 0
        log_dist(
            f"serving engine: {config.num_slots} slots x {max_len} positions "
            f"(kv={kv_dtype}, chunk={config.prefill_chunk}, "
            f"{'paged, ' if self._paged else ''}"
            f"pool {self.pool.cache_bytes() / 1e6:.1f} MB"
            f"{f' a rank ({heads} of {mcfg.n_head} heads)' if engine.mp_world_size > 1 else ''}"
            f", device={self.device})"
        )

    # ------------------------------------------------------------------
    def _measured_step_seconds(self) -> Optional[float]:
        """Recent mean serving-step wall in seconds (EWMA over non-empty
        steps); None on a cold engine, which admits."""
        return self._step_wall_ewma

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: Optional[int] = None,
        eos_token_id: Optional[int] = None,
        deadline_seconds: Optional[float] = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        seed: int = 0,
        priority: Optional[int] = None,
        session_id: Optional[str] = None,
    ) -> int:
        """Enqueue one request; returns its id.  Raises
        :class:`ServingQueueFull` when the queue is at its bound,
        :class:`ServingOverloaded` (with ``retry_after``) when the
        estimated TTFT exceeds ``serving.slo_ttft_ms`` or the
        degradation ladder sheds the tier, and ``ValueError`` when the
        request cannot ever fit the pool.  ``priority``: 0 high / 1
        normal (default) / 2 low.

        ``session_id`` (paged pool only): a finished turn's KV pages park
        under this id, and the next turn whose prompt extends the parked
        history rebinds them — prefill restarts at the first uncached
        chunk.  Ignored on the slot pool.

        Across ranks a collective: rank 0's call decides, and every rank
        returns its id or raises its refusal (module docstring)."""
        kw = dict(
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self.config.max_new_tokens),
            eos_token_id=eos_token_id,
            deadline_seconds=deadline_seconds,
            do_sample=do_sample,
            temperature=temperature,
            top_k=top_k,
            seed=seed,
            priority=PRIORITY_NORMAL if priority is None else priority,
            session_id=session_id,
        )
        s = self.scheduler
        if self._group is None:
            return self._admit(prompt, kw, time.monotonic()).request_id
        box = None
        if self._rank0:
            try:
                req = self._admit(prompt, kw, time.monotonic())
                box = (req.prompt, kw, req.request_id, req.submit_time)
            except Exception as e:  # a refusal: every rank raises it
                box = e
            box = (box, s.rejected, s.admission.shed)
        out, s.rejected, s.admission.shed = collectives.broadcast_object(
            box, src=0, group=self._group)
        if isinstance(out, Exception):
            raise out
        prompt, kw, rid, at = out
        if not self._rank0:
            s.submit(prompt, now=at, step=self._step_count, request_id=rid,
                     bypass_admission=True, **kw)
        return rid

    def _admit(self, prompt, kw, now: float) -> Request:
        """One process's admission of a request (rank 0's across ranks)."""
        if kw["do_sample"] and kw["top_k"] > self.config.max_top_k:
            raise ValueError(
                f"top_k={kw['top_k']} exceeds serving.max_top_k={self.config.max_top_k}; "
                "raise serving.max_top_k or lower the request's top_k"
            )
        return self.scheduler.submit(prompt, now=now, step=self._step_count, **kw)

    def step(self) -> bool:
        """One serving step: tick the scheduler, land this step's prefill
        chunks, then one decode step over the pool.  Returns whether any
        work remains."""
        self._step_count += 1
        t0 = time.monotonic()
        now = self._sync(t0)
        if self._paged:
            # TTL sweep BEFORE admission: pages a cold session releases
            # this tick are available to the requests admitted in it
            self.pool.sweep(now)
        plan = self.scheduler.tick(now, self._step_count, admit=True)
        t1 = time.monotonic()
        for job in plan.prefill_jobs:
            self._run_prefill(job)
        t2 = time.monotonic()
        toks, pos, decoding = self.scheduler.decode_inputs()
        if decoding:
            self._run_decode(toks, pos, decoding)
        t3 = time.monotonic()
        self._phase_seconds["sched"] += t1 - t0
        self._phase_seconds["prefill"] += t2 - t1
        self._phase_seconds["decode"] += t3 - t2
        if plan.prefill_jobs or decoding:
            wall = t3 - t0
            self._step_wall_ewma = (
                wall if self._step_wall_ewma is None
                else 0.2 * wall + 0.8 * self._step_wall_ewma
            )
        return self.scheduler.has_work()

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Request]:
        """Step until every submitted request finishes (or ``max_steps``
        elapses); returns and clears the finished-request map."""
        self.scheduler.sweep_expired(self._sync(time.monotonic()), self._step_count)
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.scheduler.pop_finished()

    def cancel(self, request_id: int) -> bool:
        """Retire a queued or in-flight request without finishing it;
        False when the id is unknown or already retired.  Across ranks a
        collective: every rank cancels rank 0's id at rank 0's clock (the
        ranks' schedulers agree, and so do their answers)."""
        now = time.monotonic()
        if self._group is not None:
            box = (int(request_id), now) if self._rank0 else None
            request_id, now = collectives.broadcast_object(box, src=0, group=self._group)
        return self.scheduler.cancel(request_id, now=now, step=self._step_count)

    def result(self, request_id: int) -> Optional[Request]:
        return self.scheduler.request(request_id)

    def pop_results(self) -> Dict[int, Request]:
        return self.scheduler.pop_finished()

    # ------------------------------------------------------------------
    # across ranks
    # ------------------------------------------------------------------
    def _sync(self, now: float) -> float:
        """The step's clock: ``now`` on one rank, rank 0's across ranks
        (one broadcast)."""
        if self._group is not None:
            now = collectives.broadcast_object(now if self._rank0 else None, src=0,
                                               group=self._group)
        self._now = now
        return now

    def _agree(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (one all-reduce of the flag)."""
        flag = torch.tensor([int(bool(ok))], dtype=torch.int32, device=self.device)
        return bool(collectives.all_reduce(flag, self._group, kind=AGREE_KIND, op="min").item())

    def _note_time(self) -> float:
        """The ``now`` a step's decisions read: the broadcast clock across
        ranks, else the wall clock."""
        return self._now if self._group is not None else time.monotonic()

    def _stamp(self, reqs, now: float) -> None:
        """Rank 0's first-token and finish times from its own clock (the
        metrics), where the step's notes set the broadcast one."""
        if self._group is None or not self._rank0:
            return
        wall = time.monotonic()
        for r in reqs:
            if r.first_token_time == now:
                r.first_token_time = wall
            if r.finish_time == now:
                r.finish_time = wall

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _run_prefill(self, job: PrefillJob) -> None:
        r = job.req
        chunk = self.config.prefill_chunk
        dev = self.device
        n_pos = self.engine.model_config.n_positions
        toks = torch.from_numpy(job.tokens[None, :].astype(np.int64)).to(dev)
        # explicit clipped position ids: the zero-padded chunk tail must
        # not shift the wpe rows of the real tokens
        position_ids = torch.clamp(
            job.start + torch.arange(chunk, device=dev), 0, n_pos - 1)[None, :]
        take = slice(job.take_idx, job.take_idx + 1)  # the one row sampled
        if self._paged:
            # the slot's pending copy-on-write lands BEFORE this chunk's
            # writes, on every layer and leaf of K and V ((0, 0) — the
            # garbage page onto itself — is the identity)
            src, dst = self.pool.consume_cow(r.slot)
            if (src, dst) != (GARBAGE_PAGE, GARBAGE_PAGE):
                for buf in _leaves(self.pool.k) + _leaves(self.pool.v):
                    buf[:, dst] = buf[:, src]
            table = torch.from_numpy(self.pool.table(r.slot)).to(dev)[None, :]
            # the per-slot (1,) offset: the chunk writes and attends
            # through the slot's page table
            logits, _, _ = forward_with_cache(
                self.engine.params, toks, self.pool.k, self.pool.v,
                torch.tensor([job.start], dtype=torch.int32, device=dev), self._icfg,
                position_ids=position_ids, page_table=table, tp=self.engine.tp, logits_rows=take,
            )
        else:
            ks, vs = self.pool.slot_view(r.slot)
            # a 0-dim tensor offset (never the initial-prefill fast path):
            # the chunk attends the slot's whole cache under the position mask
            logits, _, _ = forward_with_cache(
                self.engine.params, toks, ks, vs, torch.tensor(job.start), self._icfg,
                position_ids=position_ids, tp=self.engine.tp, logits_rows=take,
            )
        first = sample_logits_pooled(
            logits[0, 0][None, :],
            [r.do_sample], [r.temperature], [r.top_k], [r.seed],
            [job.start + job.take_idx], self.config.max_top_k,
        )[0]
        self.prefill_chunks += 1
        now = self._note_time()
        if self._paged and job.final:
            # the whole prompt's KV is paged in: learn it as a shared
            # prefix (before note_prefill — a 1-token budget can retire
            # the request, releasing the slot, inside that call)
            self.pool.learn_prefix(r, now=now)
        self.scheduler.note_prefill(job, int(first), now=now, step=self._step_count)
        self._stamp([r], now)

    @torch.inference_mode()
    def _run_decode(self, toks: np.ndarray, pos: np.ndarray, decoding) -> None:
        flags, temps, topks, seeds = self.scheduler.sampling_inputs()
        dev = self.device
        tok_t = torch.from_numpy(toks.astype(np.int64)).to(dev)[:, None]
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(dev)
        paged = {}
        if self._paged:
            # every slot's page table; non-decoding slots write to the
            # garbage page, their reads were already behind the position mask
            wmask = np.zeros((self.pool.num_slots,), np.bool_)
            for r in decoding:
                wmask[r.slot] = True
            paged = {"page_table": torch.from_numpy(self.pool.tables()).to(dev),
                     "write_mask": torch.from_numpy(wmask).to(dev)}
        logits, _, _ = forward_with_cache(
            self.engine.params, tok_t, self.pool.k, self.pool.v, pos_t, self._icfg,
            tp=self.engine.tp, **paged,
        )
        out = sample_logits_pooled(
            logits[:, -1], flags, temps, topks, seeds, pos, self.config.max_top_k,
        )
        self.decode_steps += 1
        now = self._note_time()
        self.scheduler.note_decode(
            {r.slot: int(out[r.slot]) for r in decoding}, now, self._step_count
        )
        self._stamp(decoding, now)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Counters and per-phase host wall time (seconds) for logs."""
        s = self.scheduler
        if self._group is None:  # across ranks the sweeps run in steps only
            s.sweep_expired(time.monotonic(), self._step_count)
        if self._paged and self._group is None:
            # the same idle sweep for parked-session TTLs: the per-step
            # sweep never runs on an engine that receives no traffic
            self.pool.sweep(time.monotonic())
        out = {
            "submitted": s.submitted,
            "finished": s.finished_count,
            "rejected": s.rejected,
            "expired": s.expired,
            "shed": s.shed_count + s.admission.shed,
            "cancelled": s.cancelled_count,
            "degrade_level": s.ladder.level,
            "queue_depth_now": s.queue_depth,
            "live_slots_now": self.pool.live_slots,
            "serving_steps": self._step_count,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "pool_bytes": self.pool.cache_bytes(),
            "kv_dtype": "int8" if isinstance(self.pool.k, dict) else str(self.pool.k.dtype),
            "phase_seconds": dict(self._phase_seconds),
        }
        if self._paged:
            out["kvcache"] = self.pool.stats()
        return out


__all__ = [
    "ServingEngine", "ServingQueueFull", "ServingOverloaded", "ServingDraining", "Request",
]
