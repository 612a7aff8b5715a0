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
* ``drain()`` — run until every request finishes, return the results;
* ``recover()`` — after a crash, replay the write-ahead journal's
  incomplete requests under their original ids (``serving.journal_dir``);
* ``install_watchdog()`` — SIGTERM/SIGINT stop admission, drain the
  in-flight requests within ``serving.drain_deadline_seconds``, flush
  warm sessions, and exit 43 only after the journal commits (1 else).

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

``serving.kvcache.tiers.enabled`` attaches a
:class:`~deepspeed_tpu_torch.serving.kvcache.tiers.PageTierManager`:
cold pages move device → pinned host → disk at step boundaries (the
tick before admission, its demotions gathered in one ``index_select``
per leaf) and come back by ``index_copy_`` before the slot that needs
them binds; the page tables keep their shape, so every prefill and
decode call keeps its one signature.  ``serving.tenants.enabled``
attaches a
:class:`~deepspeed_tpu_torch.serving.frontdoor.tenants.TenantRegistry`:
``submit(tenant=...)`` is charged against the tenant's token bucket,
queued under weighted-fair queueing, tiered by its SLO class, held to
its page quota, and billed at retire in step with the journal.

Decoding is greedy by default (bit parity with solo ``generate()`` in
the JAX package, token parity up to near-ties here); per-request
sampling draws from generators keyed on (seed, position), so a
request's tokens do not depend on its slot — and a journal replay
reproduces them.

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
(they would read a rank's own clock).  Only rank 0 writes the journal;
``recover()`` is a collective (rank 0 reads the incomplete set and
broadcasts it, every rank replays the same records under the same ids in
the same order).  Rank 0's watchdog decides a drain: the step's clock
broadcast carries its flag, rank 0 decides each drain step and the exit
code, so every rank drains the same steps and exits alike.  Tiers under
a group: each rank tiers its own pool's pages and writes its disk tier
under ``disk_dir/model<r>`` (``rank_spill_dir``); rank 0's broadcast clock
drives every tick, and a disk write or read counts as done only once
every rank's has (``kvcache/tiers.py`` ``_settle``: a MIN all-reduce of
each entry's flags, ``session-agree`` bytes), so every rank demotes,
promotes and misses alike, and the drain's ``flush()`` runs the same
rounds on every rank.

Around the engine: ``serving/fleet/`` routes over several engines
(each wrapped in a ``LocalReplica``, in this process or in a child behind
``serving/frontdoor/transport.py``) through ``cancel``,
``client_request_id``, ``pop_results`` and ``recover``, and
``serving/frontdoor/http.py`` serves one engine over HTTP.

Telemetry: the engine attaches to whatever plane the process armed
(``telemetry.configure``, called before ``init_serving``) when it is
built.  Its step timeline (``sched`` / ``prefill`` / ``decode``) publishes
``serving/*`` histograms and gauges; the scheduler's lifecycle events
become spans on the request's own trace lane (queue, prefill chunks,
prefill, decode, retire) and the ``serving/ttft_ms``, ``tpot_ms`` and
``queue_wait_ms`` histograms; admission counts ``serving/submitted``,
``rejected``, ``shed`` and ``retry_after_s``; the paged pool's counters
become ``kvcache/*`` gauges at each step.  A prefill chunk's and a decode
step's host times follow the sampled token's read back to the host, so
their spans and TTFT are the card's work.  Not ported yet: the
ds_san/ds_shard hooks (A15).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import telemetry as _telemetry
from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.config.config import ServingConfig
from deepspeed_tpu_torch.inference.engine import sample_logits_pooled
from deepspeed_tpu_torch.ops.transformer.inference import forward_with_cache
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving.frontdoor.tenants import TenantRegistry
from deepspeed_tpu_torch.serving.journal import JournalError, RequestJournal
from deepspeed_tpu_torch.serving.kvcache import GARBAGE_PAGE, PagedKVPool
from deepspeed_tpu_torch.serving.kvcache.tiers import PageTierManager
from deepspeed_tpu_torch.serving.pool import SlotKVPool, _leaves
from deepspeed_tpu_torch.serving.scheduler import (
    PRIORITY_NORMAL,
    ContinuousScheduler,
    PrefillJob,
    Request,
    ServingDraining,
    ServingOverloaded,
    ServingQueueFull,
    advance_request_ids,
)
from deepspeed_tpu_torch.serving.watchdog import ServingWatchdog
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# the decode kernel's row tile on the TPU; the pool capacity keeps the
# JAX engine's alignment so that both engines build the same pool shapes
_TPU_DECODE_ALIGN = 128
# the collectives' kind for the ranks' agreements: a session restore, and
# a KV tier entry's disk write or read done on every rank
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
        self._drain_flag = False  # the step's drain decision (rank 0's)
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

        # client_key -> request id (the at-most-once admission map;
        # seeded from the journal when one is armed; rank 0's)
        self._client_keys: Dict[str, int] = {}
        # write-ahead request journal: "" = off; rank 0 writes it across
        # ranks.  A construction failure disables journaling rather than
        # the engine — availability over durability, loudly.
        self._journal: Optional[RequestJournal] = None
        self._journal_quarantined: Optional[str] = None
        if config.journal_dir and self._rank0:
            try:
                self._journal = RequestJournal(
                    config.journal_dir,
                    segment_records=config.journal_segment_records,
                    keep_segments=config.journal_keep_segments,
                )
                # id-reuse guard: a restarted process submitting BEFORE
                # recover() must not hand out a journaled incomplete id
                # (its retire record would drop the old acknowledged
                # request from the replay set)
                advance_request_ids(self._journal.last_request_id)
                # at-most-once admission: journaled client keys survive
                # a restart, so a duplicate resubmit dedups here too
                self._client_keys.update(self._journal.client_keys)
            except OSError as e:
                logger.error(
                    f"serving: request journal at {config.journal_dir!r} failed "
                    f"to open ({e!r}); journaling DISABLED — a crash loses "
                    "in-flight and queued requests"
                )
        self._watchdog: Optional[ServingWatchdog] = None
        from deepspeed_tpu_torch.profiling.flops_profiler import device_name
        from deepspeed_tpu_torch.runtime.overlap.timeline import StepTimeline

        self.timeline = StepTimeline(enabled=True, phases=("sched", "prefill", "decode"))
        # telemetry: attach to whatever plane the process armed (a
        # no-config process gets no-op publishes).  Arm the plane BEFORE
        # building engines: the timeline attachment and the manager's SLO
        # config are captured here.
        self.telemetry = _telemetry.manager_for("serving", device_name=device_name(self.device))
        self._tel_ttft = self.telemetry.histogram("serving/ttft_ms")
        self._tel_tpot = self.telemetry.histogram("serving/tpot_ms")
        self._tel_queue_wait = self.telemetry.histogram("serving/queue_wait_ms")
        if self.telemetry.collect or self.telemetry.tracer.enabled:
            self.timeline.attach_telemetry(self.telemetry, prefix="serving")
        # kvcache event watermarks: deltas become trace instants
        self._kv_evt_seen = {"evictions": 0, "session_spills": 0}
        # the scheduler's lifecycle events become journal records, tenant
        # billing, spans and histograms
        self.scheduler.on_event = self._on_request_event
        # hierarchical KV tiering: the tier manager's migration worker
        # moves T1<->T2 in the background; the engine thread drives
        # T0<->T1 through tick() at step boundaries (and from
        # stats()/drain(), so an idle engine still drains pending
        # demotions)
        self._tiers: Optional[PageTierManager] = None
        if self._paged and kvc.tiers.enabled:
            # under a process group (a group of one too) the tiers agree
            # across ranks, each rank on a disk directory of its own
            ranked = mesh is not None
            self._tiers = PageTierManager(
                self.pool,
                host_pages=kvc.tiers.host_pages,
                disk_dir=rank_spill_dir(kvc.tiers.disk_dir, mesh),
                residency_window=kvc.tiers.residency_window,
                demote_watermark=kvc.tiers.demote_watermark,
                prefetch_ahead=kvc.tiers.prefetch_ahead,
                demote_batch=kvc.tiers.demote_batch,
                agree=self._agree_flags if ranked else None,
                decide=self._decide if ranked else None,
            )
            self._tiers.telemetry = self.telemetry
            self.pool.attach_tiers(self._tiers)
        # the multi-tenant dimension: rate limits + weighted-fair
        # queueing + SLO classes + KV quotas + billing-grade accounting,
        # all keyed by submit(tenant=...)
        self.tenants: Optional[TenantRegistry] = None
        if config.tenants.enabled:
            self.tenants = TenantRegistry(config.tenants)
            self.scheduler.tenants = self.tenants
            if self._paged:
                self.pool.attach_tenants(self.tenants)
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
        client_key: Optional[str] = None,
        session_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> int:
        """Enqueue one request; returns its id.  Raises
        :class:`ServingQueueFull` when the queue is at its bound,
        :class:`ServingOverloaded` (with ``retry_after``) when the
        estimated TTFT exceeds ``serving.slo_ttft_ms`` or the
        degradation ladder sheds the tier, :class:`ServingDraining`
        after SIGTERM, and ``ValueError`` when the request cannot ever
        fit the pool.  With a journal armed, the id is returned only
        after the submit record committed — an acknowledged request
        survives a crash.  ``priority``: 0 high / 1 normal (default) /
        2 low.

        ``client_key`` is an idempotency key: a resubmit carrying a key
        this engine has already acknowledged — in memory or in the
        journal, i.e. across a crash/restart — returns the ORIGINAL id
        without a second admission, while that request is tracked.

        ``session_id`` (paged pool only): a finished turn's KV pages park
        under this id, and the next turn whose prompt extends the parked
        history rebinds them — prefill restarts at the first uncached
        chunk.  Ignored (beyond journaling) on the slot pool.

        ``tenant``: with ``serving.tenants`` armed, the submit is charged
        against the tenant's token bucket (raises :class:`TenantThrottled`
        with ``retry_after`` past the limit), queued under weighted-fair
        queueing ahead of the priority tiers, and — when ``priority`` is
        not given — tiered by the tenant's SLO class.  The label journals,
        so per-tenant accounting reconciles exactly across a crash.

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
            priority=priority,
            client_key=client_key,
            session_id=session_id,
            tenant=tenant,
        )
        s = self.scheduler
        if self._group is None:
            out = self._admit(prompt, kw, time.monotonic())
            return out if isinstance(out, int) else out.request_id
        box = None
        if self._rank0:
            try:
                req = self._admit(prompt, kw, time.monotonic())
                box = ((None, None, req, None) if isinstance(req, int)
                       else (req.prompt, kw, req.request_id, req.submit_time))
            except Exception as e:  # a refusal: every rank raises it
                box = e
            box = (box, s.rejected, s.admission.shed)
        out, s.rejected, s.admission.shed = collectives.broadcast_object(
            box, src=0, group=self._group)
        if isinstance(out, Exception):
            raise out
        prompt, kw, rid, at = out
        if not self._rank0 and kw is not None:
            s.submit(prompt, now=at, step=self._step_count, request_id=rid,
                     bypass_admission=True, **kw)
        return rid

    def _admit(self, prompt, kw, now: float):
        """One process's admission of a request (rank 0's across ranks):
        the admitted :class:`Request`, or the id a known ``client_key``
        already holds.  Resolves ``kw["priority"]`` (the tenant's SLO
        class when the caller gave none), and journals and commits the
        submit before it returns."""
        client_key, tenant = kw["client_key"], kw["tenant"]
        if client_key is not None:
            known = self._client_keys.get(client_key)
            if known is not None:
                if self.scheduler.request(known) is not None:
                    return known
                # the original admission was delivered and popped — the
                # dedup window is the request's tracked lifetime, so a
                # retry after discharge is a NEW request (returning the
                # dead id would strand the caller waiting forever)
                del self._client_keys[client_key]
        if kw["do_sample"] and kw["top_k"] > self.config.max_top_k:
            raise ValueError(
                f"top_k={kw['top_k']} exceeds serving.max_top_k={self.config.max_top_k}; "
                "raise serving.max_top_k or lower the request's top_k"
            )
        wd = self._watchdog
        tm = self.telemetry
        if wd is not None and wd.draining:
            if tm.collect:
                tm.counter("serving/rejected").inc()
            raise ServingDraining(
                f"serving engine is draining ({wd.signal_name} received, "
                f"{max(wd.remaining(), 0.0):.1f}s of drain budget left); retry "
                "against the restarted engine",
                retry_after=max(wd.remaining(), 0.0),
            )
        faults.check("serving.submit")
        if self.tenants is not None:
            # SLO class → priority tier (an explicit priority wins),
            # then the token-bucket charge: reserved capacity
            # (prompt + budget), realized usage billed at retire.
            # Raises TenantThrottled (429 semantics) with retry_after.
            kw["priority"] = self.tenants.priority_for(tenant, kw["priority"])
            cost = float(np.asarray(prompt).reshape(-1).shape[0] + int(kw["max_new_tokens"]))
            try:
                self.tenants.admit(tenant, cost, now=now)
            except ServingQueueFull:
                if tm.collect:
                    tm.counter("serving/rejected").inc()
                    self._tenant_counter(tenant, "throttled").inc()
                raise
        elif kw["priority"] is None:
            kw["priority"] = PRIORITY_NORMAL
        try:
            req = self.scheduler.submit(prompt, now=now, step=self._step_count, **kw)
        except ServingOverloaded as e:
            if tm.collect:
                tm.counter("serving/rejected").inc()
                tm.counter("serving/shed").inc()
                tm.histogram("serving/retry_after_s").observe(e.retry_after or 0.0)
            if self.tenants is not None:
                self.tenants.note("rejected", tenant)
            raise
        except ServingQueueFull:
            if tm.collect:
                tm.counter("serving/rejected").inc()
            if self.tenants is not None:
                self.tenants.note("rejected", tenant)
            raise
        # WAL contract: the submit record is durable BEFORE the id is
        # acknowledged (a commit failure quarantines; the request still
        # serves — availability over durability, loudly)
        self._journal_record("record_submit", req)
        self._journal_commit()
        if client_key is not None:
            self._client_keys[client_key] = req.request_id
        if self.tenants is not None:
            self.tenants.note("admitted", tenant)
            if tm.collect:
                self._tenant_counter(tenant, "admitted").inc()
        if tm.collect:
            tm.counter("serving/submitted").inc()
        return req

    def _tenant_counter(self, tenant: Optional[str], kind: str):
        from deepspeed_tpu_torch.serving.frontdoor.tenants import DEFAULT_TENANT

        return self.telemetry.counter(f"serving/tenant/{tenant or DEFAULT_TENANT}/{kind}")

    def client_request_id(self, client_key: str) -> Optional[int]:
        """The id this engine acknowledged for ``client_key`` (in memory
        or journaled), or None — the at-most-once dedup probe (rank 0's
        across ranks)."""
        return self._client_keys.get(client_key)

    def recover(self) -> list:
        """Replay the journal's incomplete requests into this engine
        under their **original ids** (idempotent: a second ``recover()``
        re-reads the on-disk set, whose requests are live here now and
        are skipped by id).  Greedy and seeded-sampling replays bit-match
        the uninterrupted run.  Returns the replayed ids, oldest first.

        Across ranks a collective: rank 0 reads the incomplete set and
        broadcasts it, and every rank replays the same records under the
        same ids in the same order."""
        if self._paged:
            # re-register manifest-verified session spills (and committed
            # tier entries) FIRST, so a replayed turn-N+1 rebinds its
            # session exactly like the uninterrupted run would have
            try:
                sids = self.pool.recover()
                if sids:
                    log_dist(f"serving: kvcache re-registered {len(sids)} "
                             "spilled or tiered session(s)")
            except OSError as e:
                logger.warning(f"serving: kvcache session recovery failed: {e!r}")
        entries = []
        if self._journal is not None:
            try:
                entries = self._journal.incomplete()
            except JournalError as e:
                self._quarantine_journal(e)
                entries = []
        if self._group is not None:
            entries = collectives.broadcast_object(
                entries if self._rank0 else None, src=0, group=self._group)
        now = self._sync(time.monotonic())
        replayed = []
        for e in entries:
            rid = int(e["id"])
            if self.scheduler.request(rid) is not None:
                continue  # already live here (double recover)
            req = self.scheduler.submit(
                np.asarray(e["prompt"], np.int32),
                max_new_tokens=int(e["max_new"]),
                eos_token_id=e.get("eos"),
                # 0 = NO deadline (None falls back to the scheduler
                # default): the queue wait already happened once, an
                # acknowledged replay must not expire a second time
                deadline_seconds=0.0,
                do_sample=bool(e.get("do_sample", False)),
                temperature=float(e.get("temperature", 1.0)),
                top_k=int(e.get("top_k", 0)),
                seed=int(e.get("seed", 0)),
                priority=int(e.get("priority", PRIORITY_NORMAL)),
                request_id=rid,
                bypass_admission=True,  # accepted before the crash
                client_key=e.get("ck"),
                session_id=e.get("sid"),
                # the journaled tenant label rides the replay — the
                # bucket is NOT re-charged (admission happened before
                # the crash; a replay must never double-bill)
                tenant=e.get("tn"),
                now=now,
                step=self._step_count,
            )
            if e.get("ck") and self._rank0:
                self._client_keys[str(e["ck"])] = rid
            if self.tenants is not None:
                self.tenants.note("replayed", e.get("tn"))
            advance_request_ids(rid)
            # re-journal into the live segment: recovery is self-contained
            # even after the old segments compact away
            self._journal_record("record_submit", req)
            replayed.append(rid)
        self._journal_commit()
        if replayed:
            log_dist(
                f"serving: replayed {len(replayed)} incomplete request(s) "
                f"from the journal (ids {replayed[0]}..{replayed[-1]})"
            )
            if self.telemetry.collect:
                self.telemetry.counter("serving/replayed").inc(len(replayed))
        return replayed

    # ------------------------------------------------------------------
    # journal plumbing (quarantine-on-failure)
    # ------------------------------------------------------------------
    def _journal_record(self, method: str, *args) -> None:
        """Append one record; a failed append quarantines (the journal
        can no longer certify anything) and serving continues."""
        j = self._journal
        if j is None:
            return
        try:
            getattr(j, method)(*args)
        except JournalError as e:
            self._quarantine_journal(e)

    def _journal_commit(self) -> bool:
        """Commit appended records; False (after quarantine) when the
        journal could not certify durability."""
        j = self._journal
        if j is None or not j.dirty:
            return j is not None
        try:
            j.commit()
            return True
        except JournalError as e:
            self._quarantine_journal(e)
            return False

    def _quarantine_journal(self, err: Exception) -> None:
        j, self._journal = self._journal, None
        logger.error(
            f"serving: journal commit failed ({err}); quarantining — serving "
            "continues WITHOUT crash recovery for new work"
        )
        j.quarantine()
        self._journal_quarantined = j.quarantined
        if self.telemetry.collect:
            self.telemetry.counter("serving/journal_quarantined").inc()

    def _on_request_event(self, kind: str, r, now: float, step: int) -> None:
        """Scheduler lifecycle hook → journal records (committed at the
        step boundary; a reject at once), tenant billing, and spans on the
        request's own trace lane (tid = request id): queue → prefill →
        decode → retire, plus the TTFT / per-output-token histograms."""
        tm = self.telemetry
        if kind == "admitted":
            self._journal_record("record_admit", r)
        elif kind == "first_token":
            self._journal_record("record_first_token", r)
        elif kind in ("finished", "cancelled"):
            self._journal_record("record_retire", r)
            if self.tenants is not None:
                # realized-usage billing, mirrored by the retire
                # record's ``n`` — the two ledgers reconcile exactly
                # after a crash + recover() (at most one retire per id)
                if kind == "finished":
                    self.tenants.bill(r.tenant, len(r.generated))
                    if tm.collect:
                        self._tenant_counter(r.tenant, "billed_tokens").inc(len(r.generated))
                else:
                    self.tenants.note("cancelled", r.tenant)
        elif kind in ("expired", "shed"):
            # reject record, committed NOW rather than at the step
            # boundary: a crash in between must not resurrect a request
            # the client was already told to retry elsewhere
            self._journal_record("record_reject", r)
            self._journal_commit()
            if self.tenants is not None:
                self.tenants.note(kind, r.tenant)
        if tm.collect or tm.tracer.enabled:
            self._publish_request_event(kind, r, now)

    def _publish_request_event(self, kind: str, r, now: float) -> None:
        """The JAX engine's request spans and histograms
        (``serving/engine.py:1070-1139``); host dict ops, spans only when
        tracing is armed."""
        tm = self.telemetry
        tracer = tm.tracer if tm.tracer.enabled else None
        rid = r.request_id
        lane = dict(pid=_telemetry.PID_REQUESTS, tid=rid)
        if kind == "admitted":
            self._tel_queue_wait.observe((now - r.submit_time) * 1e3)
            if tracer is not None:
                tracer.add_span("queue", "serving.request", r.submit_time, now, **lane,
                                args={"request": rid, "slot": r.slot, "prompt_len": r.prompt_len},
                                tid_name=f"request {rid}")
        elif kind == "first_token":
            ttft_ms = (now - r.submit_time) * 1e3
            self._tel_ttft.observe(ttft_ms)
            if tracer is not None:
                tracer.add_span(
                    "prefill", "serving.request",
                    r.admit_time if r.admit_time is not None else r.submit_time, now, **lane,
                    args={"request": rid, "ttft_ms": round(ttft_ms, 3),
                          "chunks": -(-r.prompt_len // self.config.prefill_chunk)})
            tm.check_slo(ttft_ms)
        elif kind == "finished":
            if tm.collect:
                tm.counter("serving/finished", reason=r.finish_reason or "?").inc()
                if len(r.generated) > 1 and r.first_token_time is not None:
                    self._tel_tpot.observe(
                        (now - r.first_token_time) * 1e3 / (len(r.generated) - 1))
            if tracer is not None:
                if r.first_token_time is not None:
                    tracer.add_span("decode", "serving.request", r.first_token_time, now, **lane,
                                    args={"request": rid, "tokens": len(r.generated)})
                tracer.add_instant("retire", "serving.request", ts=now, **lane,
                                   args={"request": rid, "finish_reason": r.finish_reason,
                                         "tokens": len(r.generated)})
        elif kind == "cancelled":
            if tm.collect:
                tm.counter("serving/cancelled").inc()
            if tracer is not None:
                tracer.add_instant("cancelled", "serving.request", ts=now, **lane,
                                   args={"request": rid, "tokens": len(r.generated)})
        elif kind == "expired":
            if tm.collect:
                tm.counter("serving/expired").inc()
            if tracer is not None:
                tracer.add_instant("expired", "serving.request", ts=now, **lane,
                                   args={"request": rid,
                                         "queue_wait_ms": round((now - r.submit_time) * 1e3, 3)})
        elif kind == "shed":
            if tm.collect:
                tm.counter("serving/shed").inc()
                if r.retry_after is not None:
                    tm.histogram("serving/retry_after_s").observe(r.retry_after)
            if tracer is not None:
                tracer.add_instant("shed", "serving.request", ts=now, **lane,
                                   args={"request": rid, "priority": r.priority,
                                         "ladder_rung": self.scheduler.ladder.level,
                                         "retry_after_s": r.retry_after})

    def _publish_kvcache(self) -> None:
        """Paged-pool counters → ``kvcache/*`` registry gauges, plus trace
        instants for eviction/spill deltas since the last publish
        (step-boundary granularity; host dict reads only)."""
        tm = self.telemetry
        if not self._paged or not (tm.collect or tm.tracer.enabled):
            return
        st = self.pool.stats()
        if tm.collect:
            for key in ("pages_live", "pages_free", "hit_rate", "tokens_saved",
                        "cow_copies", "evictions", "session_rebinds",
                        "session_spills", "session_restores", "prefix_entries",
                        "sessions_warm", "sessions_spilled"):
                tm.gauge(f"kvcache/{key}").set(float(st[key]))
            for key, val in (st.get("tiers") or {}).items():
                if isinstance(val, (int, float)):
                    tm.gauge(f"kvcache/tier/{key}").set(float(val))
        tracer = tm.tracer if tm.tracer.enabled else None
        for key, name in (("evictions", "kvcache_evict"), ("session_spills", "kvcache_spill")):
            delta = int(st[key]) - self._kv_evt_seen[key]
            if delta > 0 and tracer is not None:
                tracer.add_instant(name, "serving.kvcache",
                                   args={"count": delta, "pages_free": st["pages_free"],
                                         "pages_live": st["pages_live"]})
            self._kv_evt_seen[key] = int(st[key])

    def step(self) -> bool:
        """One serving step: tick the scheduler, land this step's prefill
        chunks, then one decode step over the pool.  Returns whether any
        work remains.  If a drain signal is pending (SIGTERM through the
        installed :class:`ServingWatchdog`; rank 0's across ranks), runs
        the graceful drain and exits with the watchdog's contract
        instead."""
        t0 = time.monotonic()
        now = self._sync(t0)
        if self._drain_flag:
            self._drain_and_exit()
        return self._step_once(True, t0, now)

    def _step_once(self, admit: bool, t0: Optional[float] = None,
                   now: Optional[float] = None) -> bool:
        self._step_count += 1
        if t0 is None:
            t0 = time.monotonic()
            now = self._sync(t0)
        if self._paged:
            # TTL sweep BEFORE admission: pages a cold session releases
            # this tick are available to the requests admitted in it
            self.pool.sweep(now)
        if self._tiers is not None:
            # migration tick BEFORE admission: hinted prefetch pages
            # upcoming admits/rebinds back to T0 so their prefill chunk
            # runs against warm pages; watermark demotion batches the
            # device-to-host traffic at the step boundary
            self._tiers.tick(now, hints=self.scheduler.upcoming_hints(
                self._tiers.prefetch_ahead))
        tl = self.timeline
        with tl.phase("sched"):
            plan = self.scheduler.tick(now, self._step_count, admit=admit)
        t1 = time.monotonic()
        with tl.phase("prefill"):
            for job in plan.prefill_jobs:
                self._run_prefill(job)
        t2 = time.monotonic()
        with tl.phase("decode"):
            toks, pos, decoding = self.scheduler.decode_inputs()
            if decoding:
                self._run_decode(toks, pos, decoding)
        t3 = time.monotonic()
        tl.set_gauge("queue_depth", self.scheduler.queue_depth)
        tl.set_gauge("live_slots", self.pool.live_slots)
        tl.end_step()
        self._phase_seconds["sched"] += t1 - t0
        self._phase_seconds["prefill"] += t2 - t1
        self._phase_seconds["decode"] += t3 - t2
        if plan.prefill_jobs or decoding:
            wall = t3 - t0
            self._step_wall_ewma = (
                wall if self._step_wall_ewma is None
                else 0.2 * wall + 0.8 * self._step_wall_ewma
            )
        # retirements this step become durable at the boundary
        self._journal_commit()
        if self._tiers is not None:
            # the step's wall window feeds the swap-hide overlap ratio
            self._tiers.note_step(t0, time.monotonic())
        self._publish_kvcache()
        return self.scheduler.has_work()

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Request]:
        """Step until every submitted request finishes (or ``max_steps``
        elapses); returns and clears the finished-request map.  Also
        sweeps queued-deadline expiry first, so an idle engine's
        over-deadline waiters expire even when no step runs."""
        now = self._sync(time.monotonic())
        self.scheduler.sweep_expired(now, self._step_count)
        if self._tiers is not None:
            # idle-engine demotion: a drain() with no work must still
            # turn the migration queue (mirror of the idle TTL sweep)
            self._tiers.tick(now)
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._journal_commit()
        return self.scheduler.pop_finished()

    def cancel(self, request_id: int) -> bool:
        """Retire a queued or in-flight request without finishing it;
        False when the id is unknown or already retired.  The retire
        record journals and commits at once — a cancelled request must
        not replay after a crash.  Across ranks a collective: every rank
        cancels rank 0's id at rank 0's clock (the ranks' schedulers
        agree, and so do their answers)."""
        now = time.monotonic()
        if self._group is not None:
            box = (int(request_id), now) if self._rank0 else None
            request_id, now = collectives.broadcast_object(box, src=0, group=self._group)
        ok = self.scheduler.cancel(request_id, now=now, step=self._step_count)
        if ok:
            self._journal_commit()
        return ok

    # ------------------------------------------------------------------
    # graceful drain
    # ------------------------------------------------------------------
    def install_watchdog(
        self,
        drain_deadline_seconds: Optional[float] = None,
        exit_code: Optional[int] = None,
    ) -> ServingWatchdog:
        """Arm SIGTERM/SIGINT graceful drain: admission stops, in-flight
        requests drain within the deadline, undone work persists in the
        journal, warm sessions flush (to the tiers or the spill dir), and
        the process exits 43 only after the journal commits (1
        otherwise).  Across ranks every rank installs its own; rank 0's
        decides."""
        if self._watchdog is None:
            kw = {}
            if exit_code is not None:
                kw["exit_code"] = exit_code
            self._watchdog = ServingWatchdog(
                drain_deadline_seconds=(
                    drain_deadline_seconds
                    if drain_deadline_seconds is not None
                    else self.config.drain_deadline_seconds
                ),
                **kw,
            ).install()
        return self._watchdog

    def _decide(self, value):
        """Rank 0's ``value`` on every rank (itself on one)."""
        if self._group is None:
            return value
        return collectives.broadcast_object(value if self._rank0 else None, src=0,
                                            group=self._group)

    def _drain_and_exit(self) -> None:
        """The SIGTERM sequence.  Exit 43 certifies durable undone work
        (journal committed) — or a complete drain when no journal is
        armed; anything less is exit 1, the crash contract.  Across
        ranks rank 0 decides each drain step and the exit code."""
        wd = self._watchdog
        if self._rank0:
            log_dist(
                f"serving: drain signal ({wd.signal_name}) received; admission "
                f"stopped, draining {self.pool.live_slots} in-flight request(s) "
                f"within {max(wd.remaining(), 0.0):.1f}s "
                f"({self.scheduler.queue_depth} queued will replay from the journal)"
            )
        if self.telemetry.collect:
            self.telemetry.counter("serving/drains").inc()
        drained_all = True
        try:
            while self._decide(bool(self.scheduler.live) and wd.remaining() > 0
                               if self._rank0 else None):
                self._step_once(admit=False)
        except BaseException as e:  # a dying drain must still certify honestly
            logger.error(f"serving: drain loop failed: {e!r}")
            drained_all = False
        if self.scheduler.live:
            drained_all = False
            logger.warning(
                f"serving: drain deadline ({(wd or self.config).drain_deadline_seconds:g}s) cut "
                f"off {self.scheduler.live} in-flight request(s) "
                f"{sorted(self.pool.owners().values())}; they replay from the journal"
            )
        if self._paged:
            # persist every warm session before the process dies: the
            # restarted engine's recover() re-registers the spills and
            # turn N+1 rebinds across the restart (no-op w/o a spill_dir
            # or a disk tier)
            try:
                if self._tiers is not None:
                    # tiering path: demote every warm session and push
                    # T1 to disk, so tiered state survives the process
                    n_spilled = self._tiers.flush(self._note_time())
                else:
                    n_spilled = self.pool.spill_sessions(time.monotonic())
                if n_spilled:
                    log_dist(f"serving: kvcache spilled {n_spilled} warm session(s) at drain")
            except OSError as e:
                logger.error(f"serving: kvcache session spill at drain failed: {e!r}")
        undone = self.scheduler.pending_ids()
        code = None
        if self._rank0:
            code = 1
            if self._journal is not None:
                self._journal_record("record_drain", undone)
                if self._journal_commit():
                    log_dist(
                        f"serving: journal committed ({len(undone)} undone request(s) "
                        f"durable); exiting with code {wd.exit_code}"
                    )
                    code = wd.exit_code
                else:
                    logger.error("serving: journal could not commit at drain; exiting 1")
            elif drained_all and not undone:
                log_dist(
                    "serving: drained completely (no journal armed, nothing undone); "
                    f"exiting with code {wd.exit_code}"
                )
                code = wd.exit_code
            else:
                logger.error(
                    f"serving: {len(undone)} undone request(s) with no journal to "
                    "persist them; exiting 1 (crash contract)"
                )
        raise SystemExit(self._decide(code))

    def result(self, request_id: int) -> Optional[Request]:
        return self.scheduler.request(request_id)

    def pop_results(self) -> Dict[int, Request]:
        return self.scheduler.pop_finished()

    # ------------------------------------------------------------------
    # across ranks
    # ------------------------------------------------------------------
    def _sync(self, now: float) -> float:
        """The step's clock: ``now`` on one rank, rank 0's across ranks
        (one broadcast, which also carries rank 0's drain decision into
        ``_drain_flag``)."""
        wd = self._watchdog
        flag = wd is not None and wd.draining
        if self._group is not None:
            now, flag = collectives.broadcast_object(
                (now, flag) if self._rank0 else None, src=0, group=self._group)
        self._now, self._drain_flag = now, flag
        return now

    def _agree(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank (one all-reduce of the flag)."""
        return bool(self._agree_flags([int(bool(ok))])[0])

    def _agree_flags(self, flags) -> list:
        """Each flag's MIN over the ranks (one all-reduce of them all; over
        the process group's world, which a group of one is too)."""
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32, device=self.device)
        return collectives.all_reduce(t, self._group, kind=AGREE_KIND, op="min").tolist()

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
        faults.check("serving.prefill")
        faults.check_latency("serving.prefill")
        tracer = self.telemetry.tracer if self.telemetry.tracer.enabled else None
        t_span = tracer.now() if tracer is not None else 0.0
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
        if tracer is not None:
            # chunk-level detail on the request's own lane, between its
            # queue and prefill spans (the sampled token was read back to
            # the host: the span holds the chunk's work on the card)
            tracer.add_span(
                "prefill_chunk", "serving.request", t_span, tracer.now(),
                pid=_telemetry.PID_REQUESTS, tid=r.request_id,
                args={"request": r.request_id, "start": job.start, "len": job.length,
                      "final": job.final},
                tid_name=f"request {r.request_id}")
        self.scheduler.note_prefill(job, int(first), now=now, step=self._step_count)
        self._stamp([r], now)

    @torch.inference_mode()
    def _run_decode(self, toks: np.ndarray, pos: np.ndarray, decoding) -> None:
        faults.check("serving.decode")
        faults.check_latency("serving.decode")
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
            if s.sweep_expired(time.monotonic(), self._step_count):
                self._journal_commit()
            if self._paged:
                # the same idle sweep for parked-session TTLs: the
                # per-step sweep never runs on an engine that receives no
                # traffic
                self.pool.sweep(time.monotonic())
        if self._tiers is not None and self.engine.mesh is None:
            # idle-engine demotion: a quiescent engine must still drain
            # pending demotions instead of holding T0 pages forever (under
            # a group the tick is a collective: it runs in steps only)
            self._tiers.tick(time.monotonic())
        if self.telemetry.collect:
            self.telemetry.gauge("serving/queue_depth_now").set(s.queue_depth)
            self.telemetry.gauge("serving/live_slots_now").set(self.pool.live_slots)
        j = self._journal
        out = {
            "submitted": s.submitted,
            "finished": s.finished_count,
            "rejected": s.rejected,
            "expired": s.expired,
            "shed": s.shed_count + s.admission.shed,
            "cancelled": s.cancelled_count,
            "degrade_level": s.ladder.level,
            "degrade_rung": s.ladder.rung,
            "degrade_engagements": s.ladder.engagements,
            "draining": bool(self._watchdog is not None and self._watchdog.draining),
            "journal": ("off" if j is None and not self._journal_quarantined
                        else ("quarantined" if j is None else "on")),
            "journal_records": 0 if j is None else j.records,
            "journal_commits": 0 if j is None else j.commits,
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
        if self.tenants is not None:
            out["tenants"] = self.tenants.snapshot()
        return out


__all__ = [
    "ServingEngine", "ServingQueueFull", "ServingOverloaded", "ServingDraining", "Request",
]
