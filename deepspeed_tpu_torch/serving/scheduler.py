"""Continuous-batching scheduler: admission, chunked prefill, and
token-granularity retirement — pure host bookkeeping (a copy of
``deepspeed_tpu/serving/scheduler.py``; the logic is unchanged).

Requests flow ``QUEUED -> PREFILL -> DECODE -> DONE`` (or ``EXPIRED``
when the queue-wait deadline passes before a slot frees; ``submit``
itself rejects with :class:`ServingQueueFull` past the queue bound).
Every :meth:`tick` produces a :class:`StepPlan` the serving engine
executes against its two fixed-shape executables:

* up to ``prefill_chunks_per_step`` prompt chunks (FIFO across the
  slots mid-prefill) — long prompts are *split*, so an in-flight decode
  is never stalled behind a 384-token prefill;
* one decode step over the whole slot pool whenever any slot is
  decoding.

The scheduler also owns the **safe-position invariant** the fixed-shape
decode step relies on: :meth:`decode_inputs` gives every non-decoding
slot a write position whose contents are overwritten before they are
ever attendable (a mid-prefill slot's next chunk start; position 0 for
free slots, which the next occupant's first chunk overwrites).

Overload management (docs/serving.md §Resilience): ``submit`` carries a
**priority tier** (0 high / 1 normal / 2 low); admission into free
slots is priority-then-FIFO.  An :class:`AdmissionController` sheds
normal/low submits whose *estimated TTFT* — queue backlog over the
measured step rate the engine feeds in — exceeds ``slo_ttft_ms``,
raising :class:`ServingOverloaded` with a ``retry_after`` hint.  A
:class:`DegradationLadder` engages on sustained queue pressure with
hysteresis: clamp new admits' ``max_new_tokens`` → shrink the prefill
chunk budget to 1 → shed queued low-priority requests.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.config import constants as C
from deepspeed_tpu_torch.serving.pool import SlotKVPool
from deepspeed_tpu_torch.utils.logging import logger

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"
EXPIRED = "expired"
SHED = "shed"
CANCELLED = "cancelled"

PRIORITY_HIGH = C.SERVING_PRIORITY_HIGH
PRIORITY_NORMAL = C.SERVING_PRIORITY_NORMAL
PRIORITY_LOW = C.SERVING_PRIORITY_LOW


class ServingQueueFull(RuntimeError):
    """Graceful admission rejection: the waiting queue is at its bound.
    Callers back off / shed load; nothing in flight is affected.
    ``retry_after`` (seconds, may be None) is the backoff hint derived
    from the estimated backlog drain time."""

    def __init__(self, msg: str, retry_after: Optional[float] = None):
        super().__init__(msg)
        self.retry_after = retry_after


class ServingOverloaded(ServingQueueFull):
    """Load-shed rejection: the request's *estimated TTFT* (backlog over
    the measured step rate) exceeds the configured SLO.  Subclasses
    :class:`ServingQueueFull` so existing back-off handlers keep
    working; ``retry_after`` estimates when the backlog will have
    drained below the SLO."""


class ServingDraining(ServingQueueFull):
    """Admission stopped: the engine received SIGTERM and is draining
    (docs/serving.md §Resilience).  Retry against the restarted engine
    — journaled undone work replays there."""


class _IdSource:
    """Process-global request ids: several engines in one process (bench
    sweeps build one per (kv, load) point) must not reuse ids — the
    telemetry trace keys per-request span lanes on them.  Journal
    replay preserves original ids, so :meth:`advance_past` bumps the
    counter beyond any replayed id before fresh submits resume."""

    def __init__(self):
        self._n = -1
        self._lock = threading.Lock()

    def __next__(self) -> int:
        with self._lock:
            self._n += 1
            return self._n

    def advance_past(self, request_id: int) -> None:
        with self._lock:
            self._n = max(self._n, int(request_id))


_REQUEST_IDS = _IdSource()


def advance_request_ids(request_id: int) -> None:
    """Module-level hook for journal replay (see :class:`_IdSource`)."""
    _REQUEST_IDS.advance_past(request_id)


@dataclasses.dataclass
class Request:
    """One sequence through the pool.  ``prompt`` is a 1-D int32 array;
    timings are host wall-clock stamps the SLO bench aggregates."""

    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    deadline_seconds: Optional[float] = None  # queue-wait bound; None = scheduler default
    # per-request sampling params (ride the fixed decode signature as
    # per-slot vectors; greedy when do_sample is False)
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0
    # overload management (docs/serving.md §Resilience)
    priority: int = PRIORITY_NORMAL  # 0 high / 1 normal / 2 low
    retry_after: Optional[float] = None  # backoff hint on shed/expired results
    degraded: bool = False  # admitted under an engaged degradation ladder
    # caller-chosen idempotency key (the fleet router's at-most-once
    # admission contract; journaled in the submit record)
    client_key: Optional[str] = None
    # durable session KV (serving/kvcache): requests sharing a
    # session_id rebind the previous turn's parked pages instead of
    # re-prefilling; journaled so replay reuses the same session
    session_id: Optional[str] = None
    # multi-tenant dimension (serving/frontdoor/tenants.py): journaled
    # (``tn``) so per-tenant accounting reconciles across a crash;
    # ``wfq_tag`` is the start-time-fair-queueing virtual start time —
    # the pop order when a TenantRegistry is attached to the scheduler
    tenant: Optional[str] = None
    wfq_tag: float = 0.0
    # tokens already cached at admission (prefix/session hit) — prefill
    # starts here; 0 on the slot pool and on kvcache misses
    prefix_hint: int = 0

    status: str = QUEUED
    slot: Optional[int] = None
    prefill_pos: int = 0  # prompt tokens written to the cache so far
    generated: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None  # eos | length | expired
    submit_time: float = 0.0
    admit_time: Optional[float] = None  # queue -> slot (prefill starts)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    submit_step: int = 0
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finish_step: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def tokens(self) -> np.ndarray:
        """prompt + generated (the solo-``generate()``-comparable view)."""
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])


@dataclasses.dataclass
class PrefillJob:
    """One prompt chunk: write ``tokens`` (padded to the chunk size) at
    cache position ``start`` of the request's slot.  ``take_idx`` is the
    within-chunk index of the last real token — where the first
    generated token is sampled when ``final``."""

    req: Request
    start: int
    tokens: np.ndarray  # (prefill_chunk,) int32, zero-padded past `length`
    length: int
    final: bool
    take_idx: int


@dataclasses.dataclass
class StepPlan:
    """This tick's prefill chunks.  The decode set is NOT planned here:
    the engine derives it from :meth:`ContinuousScheduler.decode_inputs`
    *after* the chunks land, so a request whose final chunk completed
    this very step decodes this step too."""

    prefill_jobs: List[PrefillJob]


class DegradationLadder:
    """Graduated load response with hysteresis (docs/serving.md
    §Resilience).  ``update`` is called once per scheduler tick with the
    queue depth; ``engage_steps`` consecutive pressured ticks climb one
    rung, ``disengage_steps`` consecutive calm ticks step one down —
    engaging fast and disengaging slow so the ladder does not flap at
    the watermark.

    Rungs: 0 normal · 1 clamp new admits' ``max_new_tokens`` · 2 shrink
    the prefill chunk budget to one chunk/step · 3 shed queued
    low-priority requests.
    """

    RUNGS = ("normal", "clamp_new_tokens", "shrink_prefill", "shed_low_priority")
    MAX_LEVEL = 3

    def __init__(self, max_queue: int, watermark: float = 0.75,
                 engage_steps: int = 8, disengage_steps: int = 16):
        self.max_queue = int(max_queue)
        self.watermark = float(watermark)
        self.engage_steps = max(1, int(engage_steps))
        self.disengage_steps = max(1, int(disengage_steps))
        self.level = 0
        self.engagements = 0  # rung climbs over the scheduler's life
        self._pressured_ticks = 0
        self._calm_ticks = 0

    @property
    def rung(self) -> str:
        return self.RUNGS[self.level]

    def pressured(self, queue_depth: int) -> bool:
        return self.max_queue > 0 and queue_depth >= self.watermark * self.max_queue

    def update(self, queue_depth: int) -> int:
        """One tick; returns the (possibly changed) level."""
        if self.pressured(queue_depth):
            self._calm_ticks = 0
            self._pressured_ticks += 1
            if self._pressured_ticks >= self.engage_steps and self.level < self.MAX_LEVEL:
                self.level += 1
                self.engagements += 1
                self._pressured_ticks = 0
                logger.warning(
                    f"serving: degradation ladder engaged rung {self.level} "
                    f"({self.rung}) at queue depth {queue_depth}/{self.max_queue}"
                )
        else:
            self._pressured_ticks = 0
            self._calm_ticks += 1
            if self._calm_ticks >= self.disengage_steps and self.level > 0:
                self.level -= 1
                self._calm_ticks = 0
                logger.info(
                    f"serving: degradation ladder stepped down to rung "
                    f"{self.level} ({self.rung})"
                )
        return self.level


class AdmissionController:
    """Estimated-TTFT load shedding.  The estimate is a queueing model
    over *measured* time — ``step_seconds_fn`` returns the engine's
    recent mean serving-step wall (the telemetry registry's window when
    the plane is armed, a local EWMA otherwise); the backlog is counted
    in steps:

    * prefill work ahead: every queued prompt's chunks (plus the
      candidate's own) over the effective chunks-per-step budget;
    * slot wait: with no free slot, the mean remaining decode budget of
      the live set, times how many queue "generations" precede the
      candidate (``ceil(queue_position / num_slots)``).

    It is an *estimate* feeding an SLO threshold, not a guarantee — the
    point is that shed decisions track the actually-measured service
    rate, so a slow chip sheds sooner at the same queue depth.  High
    priority bypasses the test (only the hard ``max_queue`` bound
    applies); without a measurement yet (cold engine) everything
    admits."""

    def __init__(self, scheduler: "ContinuousScheduler", slo_ttft_ms: float,
                 retry_after_min: float = C.SERVING_RETRY_AFTER_MIN_SECONDS_DEFAULT):
        self.scheduler = scheduler
        self.slo_ttft_ms = float(slo_ttft_ms)
        self.retry_after_min = float(retry_after_min)
        self.shed = 0  # TTFT-shed submit rejections

    def estimate_ttft_seconds(self, prompt_len: int,
                              in_queue: bool = False,
                              prompt=None,
                              session_id: Optional[str] = None) -> Optional[float]:
        """``in_queue=True`` when the candidate already sits in the
        queue (the rung-3 shed path pricing a waiter's retry_after):
        its chunks are then inside the queue sum and its queue slot
        inside ``len(_queue)`` — adding them again would double-count.

        With a paged kvcache pool, prefill work is priced at the
        **post-hit budget**: the pool's side-effect-free
        ``prefix_hint_tokens`` probe subtracts the expected prefix /
        session hit from every queued prompt (and from the candidate,
        when its tokens are given), so shed decisions track the work
        the engine will actually do."""
        s = self.scheduler
        step_s = s.step_seconds_fn() if s.step_seconds_fn is not None else None
        if not step_s or step_s <= 0:
            return None
        chunk = s.prefill_chunk
        hint_fn = getattr(s.pool, "prefix_hint_tokens", None)

        def _remaining(r: "Request") -> int:
            left = max(r.prompt_len - r.prefill_pos, 0)
            if hint_fn is not None and r.prefill_pos == 0 and left > 0:
                left = max(left - hint_fn(r.prompt, r.session_id), 1)
            return left

        chunks = sum(math.ceil(_remaining(r) / chunk) for r in s._queue)
        if not in_queue:
            cand = int(prompt_len)
            if hint_fn is not None and prompt is not None and cand > 0:
                cand = max(cand - hint_fn(prompt, session_id), 1)
            chunks += math.ceil(cand / chunk)
        steps = math.ceil(chunks / s.effective_chunks_per_step())
        if not s.pool.free_slots:
            live = [r for r in s._active.values()]
            if live:
                remaining = [
                    max(r.max_new_tokens - len(r.generated), 1) for r in live
                ]
                mean_rem = sum(remaining) / len(remaining)
                waiters = len(s._queue) + (0 if in_queue else 1)
                generations = math.ceil(waiters / s.pool.num_slots)
                steps += int(mean_rem * generations)
        return steps * step_s

    def retry_after_seconds(self, est_s: Optional[float]) -> float:
        """How long until the backlog should have drained below the SLO
        (floored — a sub-50ms hint tells a client nothing)."""
        if est_s is None:
            return max(self.retry_after_min, 1.0)
        return max(self.retry_after_min, est_s - self.slo_ttft_ms / 1e3)

    def check(self, prompt_len: int, priority: int, prompt=None,
              session_id: Optional[str] = None) -> None:
        """Raise :class:`ServingOverloaded` when the candidate's
        estimated TTFT exceeds the SLO (normal/low priority only)."""
        if self.slo_ttft_ms <= 0 or priority <= PRIORITY_HIGH:
            return
        est = self.estimate_ttft_seconds(
            prompt_len, prompt=prompt, session_id=session_id
        )
        if est is not None and est * 1e3 > self.slo_ttft_ms:
            self.shed += 1
            retry = self.retry_after_seconds(est)
            raise ServingOverloaded(
                f"serving overloaded: estimated TTFT {est * 1e3:.0f}ms exceeds "
                f"slo_ttft_ms={self.slo_ttft_ms:g} "
                f"(queue {self.scheduler.queue_depth}, priority {priority}); "
                f"retry after {retry:.2f}s",
                retry_after=retry,
            )


class ContinuousScheduler:
    def __init__(
        self,
        pool: SlotKVPool,
        prefill_chunk: int,
        prefill_chunks_per_step: int = 1,
        max_queue: int = 64,
        deadline_seconds: float = 0.0,
        capacity: Optional[int] = None,
        slo_ttft_ms: float = 0.0,
        degrade_queue_watermark: float = C.SERVING_DEGRADE_QUEUE_WATERMARK_DEFAULT,
        degrade_engage_steps: int = C.SERVING_DEGRADE_ENGAGE_STEPS_DEFAULT,
        degrade_disengage_steps: int = C.SERVING_DEGRADE_DISENGAGE_STEPS_DEFAULT,
        degrade_max_new_tokens: int = C.SERVING_DEGRADE_MAX_NEW_TOKENS_DEFAULT,
    ):
        self.pool = pool
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_chunks_per_step = max(1, int(prefill_chunks_per_step))
        self.max_queue = int(max_queue)
        self.deadline_seconds = float(deadline_seconds)
        # admission bound on prompt+generated length (pool capacity
        # clamped by the engine's generation capacity)
        self.capacity = int(capacity) if capacity is not None else pool.max_len
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, Request] = {}  # slot -> request
        self._finished: Dict[int, Request] = {}  # request_id -> request
        self._ids = _REQUEST_IDS
        self.submitted = 0
        self.rejected = 0
        self.expired = 0
        self.shed_count = 0  # queued requests shed by the ladder
        self.cancelled_count = 0  # explicit cancel() retirements
        self.finished_count = 0
        self.degrade_max_new_tokens = max(0, int(degrade_max_new_tokens))
        self.ladder = DegradationLadder(
            max_queue=self.max_queue,
            watermark=degrade_queue_watermark,
            engage_steps=degrade_engage_steps,
            disengage_steps=degrade_disengage_steps,
        )
        self.admission = AdmissionController(self, slo_ttft_ms=slo_ttft_ms)
        # measured serving-step wall feed (seconds; engine-owned so the
        # scheduler stays jax- and telemetry-free)
        self.step_seconds_fn: Optional[Callable[[], Optional[float]]] = None
        # lifecycle observer (the serving engine's telemetry hook):
        # called as on_event(kind, request, now, step) at "admitted",
        # "first_token", "finished", "expired" transitions.  Pure host
        # callback — the scheduler itself stays jax- and telemetry-free.
        self.on_event: Optional[Any] = None
        # TenantRegistry (serving/frontdoor/tenants.py) when the tenant
        # dimension is armed: submits get WFQ tags and _pop_next picks
        # the tenant with the lowest outstanding tag first.  The
        # scheduler stays tenant-policy-free — the registry owns it.
        self.tenants: Optional[Any] = None

    def _emit(self, kind: str, r: Request, now: float, step: int) -> None:
        if self.on_event is not None:
            self.on_event(kind, r, now, step)

    # -- introspection ----------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live(self) -> int:
        return len(self._active)

    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    def pending_ids(self) -> List[int]:
        """Ids of every request not yet finished (queued + in-flight) —
        the graceful drain's undone set."""
        return sorted(
            [r.request_id for r in self._queue]
            + [r.request_id for r in self._active.values()]
        )

    def upcoming_hints(self, limit: int = 4) -> List[Tuple[Any, Optional[str]]]:
        """(prompt, session_id) of the next admits in priority-FIFO
        order — the KV tier manager's prefetch contract (docs/serving.md
        §KV tiering): pages these requests need promote back to T0
        *before* their prefill chunk runs.  Read-only on the queue."""
        if limit <= 0 or not self._queue:
            return []
        # priority-then-FIFO, matching _pop_next (0 = high; stable sort
        # preserves FIFO within a tier)
        ordered = sorted(
            self._queue, key=lambda r: getattr(r, "priority", 1)
        )
        return [
            (r.prompt, getattr(r, "session_id", None))
            for r in ordered[:limit]
        ]

    def request(self, request_id: int) -> Optional[Request]:
        if request_id in self._finished:
            return self._finished[request_id]
        for r in self._active.values():
            if r.request_id == request_id:
                return r
        for r in self._queue:
            if r.request_id == request_id:
                return r
        return None

    def pop_finished(self) -> Dict[int, Request]:
        out, self._finished = self._finished, {}
        return out

    def effective_chunks_per_step(self) -> int:
        """The prefill chunk budget after the degradation ladder: rung 2
        ("shrink_prefill") caps it at one chunk/step so decode latency
        for the live set is protected at the cost of new-request TTFT."""
        return 1 if self.ladder.level >= 2 else self.prefill_chunks_per_step

    # -- admission --------------------------------------------------------
    def submit(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        eos_token_id: Optional[int] = None,
        deadline_seconds: Optional[float] = None,
        now: float = 0.0,
        step: int = 0,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        seed: int = 0,
        priority: int = PRIORITY_NORMAL,
        request_id: Optional[int] = None,
        bypass_admission: bool = False,
        client_key: Optional[str] = None,
        session_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Request:
        """``priority``: 0 high (never TTFT-shed) / 1 normal / 2 low
        (first shed when the ladder tops out).  ``request_id`` +
        ``bypass_admission`` are the journal-replay surface: replayed
        requests were *already accepted* before the crash, so they keep
        their ids and skip every overload test."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if do_sample and temperature <= 0.0:
            raise ValueError(f"temperature must be > 0 when sampling, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if priority not in (PRIORITY_HIGH, PRIORITY_NORMAL, PRIORITY_LOW):
            raise ValueError(
                f"priority must be {PRIORITY_HIGH} (high), {PRIORITY_NORMAL} "
                f"(normal) or {PRIORITY_LOW} (low), got {priority}"
            )
        total = prompt.shape[0] + int(max_new_tokens)
        if total > self.capacity:
            raise ValueError(
                f"prompt_len + max_new_tokens = {prompt.shape[0]}+{max_new_tokens} "
                f"= {total} exceeds the serving capacity {self.capacity} "
                f"(pool max_len={self.pool.max_len})"
            )
        if not bypass_admission:
            if len(self._queue) >= self.max_queue:
                self.rejected += 1
                retry = self.admission.retry_after_seconds(
                    self.admission.estimate_ttft_seconds(prompt.shape[0])
                )
                raise ServingQueueFull(
                    f"serving queue is full ({len(self._queue)} waiting >= "
                    f"max_queue={self.max_queue}); retry after ~{retry:.2f}s "
                    f"or raise serving.max_queue",
                    retry_after=retry,
                )
            if self.ladder.level >= 3 and priority >= PRIORITY_LOW:
                # rung 3: low priority is shed at the door, not queued
                # then expired — the queue is for work that can be served
                self.rejected += 1
                self.admission.shed += 1
                retry = self.admission.retry_after_seconds(
                    self.admission.estimate_ttft_seconds(prompt.shape[0])
                )
                raise ServingOverloaded(
                    f"serving overloaded: degradation ladder at rung "
                    f"{self.ladder.level} ({self.ladder.rung}) sheds low-priority "
                    f"submits; retry after {retry:.2f}s",
                    retry_after=retry,
                )
            # estimated-TTFT admission test (high priority bypasses)
            try:
                self.admission.check(
                    prompt.shape[0], priority, prompt=prompt,
                    session_id=session_id,
                )
            except ServingOverloaded:
                self.rejected += 1
                raise
        req = Request(
            request_id=next(self._ids) if request_id is None else int(request_id),
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            eos_token_id=eos_token_id,
            deadline_seconds=deadline_seconds,
            do_sample=bool(do_sample),
            temperature=float(temperature),
            top_k=int(top_k),
            seed=int(seed),
            priority=int(priority),
            client_key=client_key,
            session_id=session_id,
            tenant=tenant,
            submit_time=now,
            submit_step=step,
        )
        if self.tenants is not None:
            # weighted-fair queueing ahead of the priority tiers: the
            # tag fixes this request's place in the tenant-fair pop
            # order (replays are tagged too — fairness applies to the
            # recovered queue exactly as it did to the original)
            req.wfq_tag = self.tenants.tag(tenant, cost=float(total))
        if request_id is not None:
            self._ids.advance_past(request_id)
        self._queue.append(req)
        self.submitted += 1
        return req

    # -- per-step policy --------------------------------------------------
    def sweep_expired(self, now: float, step: int) -> int:
        """Expire queued requests past their queue-wait deadline.  Runs
        inside every :meth:`tick`, AND host-side from the engine's
        ``stats()``/``drain()`` — an idle engine (submitted work but no
        ``step()`` being driven) must still expire waiters rather than
        hold them past their deadline forever."""
        if not self._queue:
            return 0
        n = 0
        kept: Deque[Request] = deque()
        for r in self._queue:
            deadline = (
                r.deadline_seconds
                if r.deadline_seconds is not None
                else self.deadline_seconds
            )
            if deadline and (now - r.submit_time) > deadline:
                r.status = EXPIRED
                r.finish_reason = "expired"
                r.finish_time = now
                r.finish_step = step
                # same backoff contract as shed: every involuntary
                # retirement carries a retry_after hint
                r.retry_after = self.admission.retry_after_seconds(
                    self.admission.estimate_ttft_seconds(r.prompt_len, in_queue=True)
                )
                self._finished[r.request_id] = r
                self.expired += 1
                n += 1
                logger.warning(
                    f"serving: request {r.request_id} expired after "
                    f"{now - r.submit_time:.3f}s in queue (deadline {deadline:g}s)"
                )
                self._emit("expired", r, now, step)
            else:
                kept.append(r)
        self._queue = kept
        return n

    def shed_queued_low_priority(self, now: float, step: int) -> int:
        """Ladder rung 3: retire queued low-priority requests with a
        ``retry_after`` hint — explicit shed beats silent deadline death
        under sustained overload."""
        if not any(r.priority >= PRIORITY_LOW for r in self._queue):
            return 0
        n = 0
        kept: Deque[Request] = deque()
        for r in self._queue:
            if r.priority >= PRIORITY_LOW:
                r.status = SHED
                r.finish_reason = "shed"
                r.finish_time = now
                r.finish_step = step
                r.retry_after = self.admission.retry_after_seconds(
                    self.admission.estimate_ttft_seconds(r.prompt_len, in_queue=True)
                )
                self._finished[r.request_id] = r
                self.shed_count += 1
                n += 1
                self._emit("shed", r, now, step)
            else:
                kept.append(r)
        self._queue = kept
        if n:
            logger.warning(
                f"serving: shed {n} queued low-priority request(s) at ladder "
                f"rung {self.ladder.level}"
            )
        return n

    def cancel(self, request_id: int, now: float, step: int) -> bool:
        """Retire a queued or in-flight request without finishing it —
        the hedge loser's retirement path (docs/serving.md §Fleet).  An
        in-flight cancel frees the slot immediately (the freed slot's
        stale cache is unreachable by the overwrite-before-attend
        invariant); the result surfaces with status CANCELLED so the
        engine journals a retire record.  False when the id is unknown
        or already retired."""
        for i, r in enumerate(self._queue):
            if r.request_id == request_id:
                del self._queue[i]
                self._retire_cancelled(r, now, step)
                return True
        for slot, r in list(self._active.items()):
            if r.request_id == request_id:
                del self._active[slot]
                self._release_slot(slot, r, now)
                self._retire_cancelled(r, now, step)
                return True
        return False

    def _release_slot(self, slot: int, r: Request, now: float) -> None:
        """Return a slot to the pool: the paged pool's ``retire`` hook
        sees the request (so a finished turn can park under its
        session); the slot pool just frees."""
        retire = getattr(self.pool, "retire", None)
        if retire is not None:
            retire(slot, r, now=now)
        else:
            self.pool.free(slot)

    def _retire_cancelled(self, r: Request, now: float, step: int) -> None:
        r.status = CANCELLED
        r.finish_reason = "cancelled"
        r.finish_time = now
        r.finish_step = step
        self._finished[r.request_id] = r
        self.cancelled_count += 1
        self._emit("cancelled", r, now, step)

    def _pop_next(self) -> Request:
        """Highest-priority (lowest tier number) queued request, FIFO
        within a tier — an O(queue) scan, fine at max_queue scale.
        With a TenantRegistry attached, weighted-fair queueing picks the
        tenant FIRST (lowest outstanding virtual tag) and the
        priority-then-FIFO scan runs within that tenant only."""
        if self.tenants is not None:
            i = self.tenants.pick(self._queue)
            r = self._queue[i]
            del self._queue[i]
            return r
        best_i, best = 0, None
        for i, r in enumerate(self._queue):
            if best is None or r.priority < best.priority:
                best_i, best = i, r
                if r.priority == PRIORITY_HIGH:
                    break
        del self._queue[best_i]
        return best

    def tick(self, now: float, step: int, admit: bool = True) -> StepPlan:
        """Expire over-deadline waiters, update the degradation ladder,
        admit queued requests into free slots (priority-then-FIFO), and
        pick this step's prefill chunks.  ``admit=False`` is drain mode:
        in-flight requests keep decoding, the queue stays parked (its
        journaled work replays on the restarted engine)."""
        # 1) queue-wait deadlines
        self.sweep_expired(now, step)
        # 2) degradation ladder (hysteresis inside)
        self.ladder.update(len(self._queue))
        if admit and self.ladder.level >= 3:
            self.shed_queued_low_priority(now, step)
        # 3) admission: queued -> free slots (priority, then FIFO)
        while admit and self._queue and self.pool.free_slots:
            r = self._pop_next()
            if self.ladder.level >= 1 and self.degrade_max_new_tokens:
                # rung 1: clamp the generation budget of NEW admits only
                # — in-flight budgets are a contract already accepted
                if r.max_new_tokens > self.degrade_max_new_tokens:
                    r.max_new_tokens = self.degrade_max_new_tokens
                    r.degraded = True
            alloc_request = getattr(self.pool, "alloc_request", None)
            if alloc_request is not None:
                # hit-aware paged allocation: the pool resolves the
                # longest cached prefix / session rebind and sets
                # r.prefill_pos past it (serving/kvcache)
                r.prefill_pos = 0
                slot = alloc_request(r, now=now)
            else:
                r.prefill_pos = 0
                slot = self.pool.alloc(r.request_id)
            if slot is None:
                # out of pages (paged pool under sharing pressure):
                # park the request back at the queue head — retiring
                # slots free pages and the next tick retries
                self._queue.appendleft(r)
                break
            r.slot = slot
            r.status = PREFILL
            r.admit_time = now
            r.admit_step = step
            self._active[r.slot] = r
            self._emit("admitted", r, now, step)
        # 4) prefill chunk budget, FIFO over mid-prefill slots
        jobs: List[PrefillJob] = []
        budget = self.effective_chunks_per_step()
        prefilling = sorted(
            (r for r in self._active.values() if r.status == PREFILL),
            key=lambda r: r.request_id,
        )
        for r in prefilling:
            pos = r.prefill_pos
            while budget > 0 and pos < r.prompt_len:
                length = min(self.prefill_chunk, r.prompt_len - pos)
                chunk = np.zeros((self.prefill_chunk,), np.int32)
                chunk[:length] = r.prompt[pos : pos + length]
                jobs.append(
                    PrefillJob(
                        req=r,
                        start=pos,
                        tokens=chunk,
                        length=length,
                        final=pos + length >= r.prompt_len,
                        take_idx=length - 1,
                    )
                )
                pos += length
                budget -= 1
            if budget == 0:
                break
        return StepPlan(prefill_jobs=jobs)

    def note_prefill(self, job: PrefillJob, first_token: int, now: float, step: int) -> None:
        """A chunk landed; on the final chunk the sampled first token
        arrives (the TTFT moment) and the request joins the decode set —
        or retires immediately when its budget is a single token / the
        first token is EOS."""
        r = job.req
        r.prefill_pos = job.start + job.length
        if not job.final:
            return
        r.status = DECODE
        r.generated = [int(first_token)]
        r.first_token_time = now
        r.first_token_step = step
        self._emit("first_token", r, now, step)
        if len(r.generated) >= r.max_new_tokens or (
            r.eos_token_id is not None and first_token == r.eos_token_id
        ):
            self._finish(r, now, step)

    def decode_inputs(self) -> Tuple[np.ndarray, np.ndarray, List[Request]]:
        """Fixed-shape decode-step inputs over the whole pool.

        Decoding slots feed their latest token at its true position;
        every other slot gets a *safe* garbage position — one whose
        write is overwritten before it can ever be attended (the next
        chunk start for mid-prefill slots, 0 for free slots)."""
        toks = np.zeros((self.pool.num_slots,), np.int32)
        pos = np.zeros((self.pool.num_slots,), np.int32)
        decoding: List[Request] = []
        for slot, r in self._active.items():
            if r.status == DECODE:
                toks[slot] = r.generated[-1]
                pos[slot] = r.prompt_len + len(r.generated) - 1
                decoding.append(r)
            else:  # mid-prefill: next chunk overwrites this position
                pos[slot] = r.prefill_pos
        return toks, pos, decoding

    def sampling_inputs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Fixed-shape per-slot sampling vectors (ride the same decode
        signature every step): do_sample flags, temperatures, top-k
        bounds, and seeds.  Non-active / non-sampling slots keep the
        greedy defaults — their computed token is either discarded
        (non-decoding) or the bare argmax (the solo-``generate()``
        bit-match path)."""
        S = self.pool.num_slots
        flags = np.zeros((S,), bool)
        temps = np.ones((S,), np.float32)
        topks = np.zeros((S,), np.int32)
        seeds = np.zeros((S,), np.uint32)
        for slot, r in self._active.items():
            flags[slot] = r.do_sample
            temps[slot] = np.float32(r.temperature)
            topks[slot] = np.int32(r.top_k)
            seeds[slot] = np.uint32(r.seed & 0xFFFFFFFF)
        return flags, temps, topks, seeds

    def note_decode(self, tokens_by_slot: Dict[int, int], now: float, step: int) -> None:
        """Append this step's token per decoding slot; retire at EOS or
        budget — the slot frees *this* token, not at batch end."""
        for slot, tok in tokens_by_slot.items():
            r = self._active[slot]
            r.generated.append(int(tok))
            if (r.eos_token_id is not None and tok == r.eos_token_id) or len(
                r.generated
            ) >= r.max_new_tokens:
                self._finish(r, now, step)

    def _finish(self, r: Request, now: float, step: int) -> None:
        r.status = DONE
        r.finish_reason = (
            "eos"
            if (r.eos_token_id is not None and r.generated and r.generated[-1] == r.eos_token_id)
            else "length"
        )
        r.finish_time = now
        r.finish_step = step
        del self._active[r.slot]
        self._release_slot(r.slot, r, now)
        self._finished[r.request_id] = r
        self.finished_count += 1
        self._emit("finished", r, now, step)
