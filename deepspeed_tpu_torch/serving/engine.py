"""ServingEngine: continuous batching over a slot-pool KV cache
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
the pool's cache tensors in place.  Decoding is greedy by default (bit
parity with solo ``generate()`` in the JAX package, token parity up to
near-ties here); per-request sampling draws from generators keyed on
(seed, position), so a request's tokens do not depend on its slot.

Not ported yet (ROADMAP A8): the request journal, the SIGTERM watchdog,
telemetry spans, the ds_san/ds_shard hooks, tenants, the fleet and the
paged pool.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import ServingConfig
from deepspeed_tpu_torch.inference.engine import sample_logits_pooled
from deepspeed_tpu_torch.ops.transformer.inference import forward_with_cache
from deepspeed_tpu_torch.serving.pool import SlotKVPool
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
        self.pool = SlotKVPool(
            mcfg.n_layer, config.num_slots, mcfg.n_head, max_len, mcfg.head_dim,
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
            f"pool {self.pool.cache_bytes() / 1e6:.1f} MB, device={self.device})"
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
    ) -> int:
        """Enqueue one request; returns its id.  Raises
        :class:`ServingQueueFull` when the queue is at its bound,
        :class:`ServingOverloaded` (with ``retry_after``) when the
        estimated TTFT exceeds ``serving.slo_ttft_ms`` or the
        degradation ladder sheds the tier, and ``ValueError`` when the
        request cannot ever fit the pool.  ``priority``: 0 high / 1
        normal (default) / 2 low."""
        if do_sample and top_k > self.config.max_top_k:
            raise ValueError(
                f"top_k={top_k} exceeds serving.max_top_k={self.config.max_top_k}; "
                "raise serving.max_top_k or lower the request's top_k"
            )
        req = self.scheduler.submit(
            prompt,
            max_new_tokens=(max_new_tokens if max_new_tokens is not None
                            else self.config.max_new_tokens),
            eos_token_id=eos_token_id,
            deadline_seconds=deadline_seconds,
            do_sample=do_sample,
            temperature=temperature,
            top_k=top_k,
            seed=seed,
            priority=PRIORITY_NORMAL if priority is None else priority,
            now=time.monotonic(),
            step=self._step_count,
        )
        return req.request_id

    def step(self) -> bool:
        """One serving step: tick the scheduler, land this step's prefill
        chunks, then one decode step over the pool.  Returns whether any
        work remains."""
        self._step_count += 1
        t0 = time.monotonic()
        plan = self.scheduler.tick(t0, self._step_count, admit=True)
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
        self.scheduler.sweep_expired(time.monotonic(), self._step_count)
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.scheduler.pop_finished()

    def cancel(self, request_id: int) -> bool:
        """Retire a queued or in-flight request without finishing it;
        False when the id is unknown or already retired."""
        return self.scheduler.cancel(request_id, now=time.monotonic(), step=self._step_count)

    def result(self, request_id: int) -> Optional[Request]:
        return self.scheduler.request(request_id)

    def pop_results(self) -> Dict[int, Request]:
        return self.scheduler.pop_finished()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _run_prefill(self, job: PrefillJob) -> None:
        r = job.req
        chunk = self.config.prefill_chunk
        dev = self.device
        n_pos = self.engine.model_config.n_positions
        ks, vs = self.pool.slot_view(r.slot)
        toks = torch.from_numpy(job.tokens[None, :].astype(np.int64)).to(dev)
        # explicit clipped position ids: the zero-padded chunk tail must
        # not shift the wpe rows of the real tokens
        position_ids = torch.clamp(
            job.start + torch.arange(chunk, device=dev), 0, n_pos - 1)[None, :]
        # a tensor offset (never the initial-prefill fast path): the chunk
        # attends the slot's whole cache under the position mask
        logits, _, _ = forward_with_cache(
            self.engine.params, toks, ks, vs, torch.tensor(job.start), self._icfg,
            position_ids=position_ids,
        )
        first = sample_logits_pooled(
            logits[0, job.take_idx][None, :],
            [r.do_sample], [r.temperature], [r.top_k], [r.seed],
            [job.start + job.take_idx], self.config.max_top_k,
        )[0]
        self.prefill_chunks += 1
        self.scheduler.note_prefill(job, int(first), now=time.monotonic(), step=self._step_count)

    @torch.inference_mode()
    def _run_decode(self, toks: np.ndarray, pos: np.ndarray, decoding) -> None:
        flags, temps, topks, seeds = self.scheduler.sampling_inputs()
        dev = self.device
        tok_t = torch.from_numpy(toks.astype(np.int64)).to(dev)[:, None]
        pos_t = torch.from_numpy(pos.astype(np.int32)).to(dev)
        logits, _, _ = forward_with_cache(
            self.engine.params, tok_t, self.pool.k, self.pool.v, pos_t, self._icfg,
        )
        out = sample_logits_pooled(
            logits[:, -1], flags, temps, topks, seeds, pos, self.config.max_top_k,
        )
        self.decode_steps += 1
        self.scheduler.note_decode(
            {r.slot: int(out[r.slot]) for r in decoding}, time.monotonic(), self._step_count
        )

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Counters and per-phase host wall time (seconds) for logs."""
        s = self.scheduler
        s.sweep_expired(time.monotonic(), self._step_count)
        return {
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


__all__ = [
    "ServingEngine", "ServingQueueFull", "ServingOverloaded", "ServingDraining", "Request",
]
