"""Multi-tenant fairness, rate limiting, and billing-grade accounting (a
copy of ``deepspeed_tpu/serving/frontdoor/tenants.py``).

The north star is many tenants sharing one fleet where the quiet
tenant never pays for the noisy one.  Four mechanisms, all keyed by the
request's ``tenant`` label:

* **token-bucket rate limits** — each tenant refills at
  ``refill_tokens_per_second`` up to ``burst_tokens``; a submit costs
  ``prompt_len + max_new_tokens`` (the reserved capacity, not the
  realized one — realized usage is billed at retire).  An empty bucket
  raises :class:`TenantThrottled` (a ``ServingQueueFull`` subclass, so
  the ``retry_after`` hint rides the refusal).  Fault site ``tenant.refill`` perturbs the refill path.
* **weighted-fair queueing** — ahead of the priority tiers: start-time
  fair queueing tags every submit with a per-tenant virtual start time
  advanced by ``cost / weight``; the scheduler pops the tenant with the
  lowest outstanding tag, then priority-then-FIFO *within* that tenant.
  A tenant flooding the queue advances its own virtual clock far past
  the quiet tenant's, so the quiet tenant's next request still pops
  first.
* **SLO classes** — ``gold``/``silver``/``bronze`` map onto the
  existing priority tiers (0/1/2) and therefore onto the scheduler's
  degradation ladder: bronze is shed first at rung 3, gold bypasses the
  estimated-TTFT admission test.
* **quotas + accounting** — per-tenant caps on paged-KV pages and
  pinned prefixes (enforced in ``kvcache/``), and per-tenant counters
  (admitted / rejected / throttled / billed tokens) whose journal twin
  (:func:`journal_tenant_totals`) reconciles exactly across a
  crash + ``recover()``: admission is journaled with a
  ``tn`` key before the ack, realized tokens are journaled in the
  retire record, and replays bypass the bucket (no double-charge).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving import journal as _journal
from deepspeed_tpu_torch.serving.scheduler import ServingQueueFull

DEFAULT_TENANT = "default"

#: SLO class → priority tier (0 high / 1 normal / 2 low).  The tier is
#: what the scheduler's admission test + degradation ladder act on, so
#: the class mapping IS the ladder mapping.
SLO_CLASSES: Dict[str, int] = {"gold": 0, "silver": 1, "bronze": 2}


class TenantThrottled(ServingQueueFull):
    """Per-tenant rate limit exceeded.  Carries ``retry_after`` — the
    seconds until the bucket holds the request's cost again — and
    is a ``ServingQueueFull`` to callers that catch that."""


class TokenBucket:
    """Classic token bucket with exact accounting: ``refilled`` and
    ``consumed`` are monotone totals the race harness checks against
    ``tokens`` (``burst + refilled - consumed == tokens`` always, no
    lost updates).  NOT internally locked — the registry serializes
    access (one lock)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.refilled = 0.0
        self.consumed = 0.0
        self._updated: Optional[float] = None

    def refill(self, now: float) -> None:
        """Fault site ``tenant.refill``: an injected failure aborts the
        whole operation BEFORE any state moves, so accounting never
        tears."""
        faults.check("tenant.refill")
        faults.check_race("race.tenant.refill")
        if self._updated is None:
            self._updated = now
            return
        dt = max(now - self._updated, 0.0)
        self._updated = now
        if dt <= 0.0 or self.rate <= 0.0:
            return
        add = min(dt * self.rate, self.burst - self.tokens)
        if add > 0.0:
            self.tokens += add
            self.refilled += add

    def take(self, cost: float, now: float) -> Optional[float]:
        """Consume ``cost`` tokens; returns None on success or the
        seconds until the bucket could cover the cost (the throttle's
        ``retry_after``)."""
        self.refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            self.consumed += cost
            return None
        if self.rate <= 0.0:
            return 60.0  # bucket can never refill; arbitrary long hint
        return max((cost - self.tokens) / self.rate, 1e-3)


class TenantState:
    """One tenant's live state: spec knobs, bucket, WFQ virtual clock
    and the accounting counters ``stats()`` / the bench read."""

    def __init__(self, name: str, spec: Dict[str, Any]):
        self.name = name
        self.weight = max(float(spec.get("weight", 1.0)), 1e-6)
        self.slo_class = str(spec.get("slo_class", "silver"))
        self.kv_pages_max = int(spec.get("kv_pages_max", 0))
        self.pinned_prefixes_max = int(spec.get("pinned_prefixes_max", 0))
        self.bucket = TokenBucket(
            rate=float(spec.get("refill_tokens_per_second", 0.0)),
            burst=float(spec.get("burst_tokens", 0.0)),
        )
        self.last_tag = 0.0  # WFQ virtual start time of the latest submit
        self.counters: Dict[str, float] = {
            "submitted": 0, "admitted": 0, "throttled": 0, "rejected": 0,
            "shed": 0, "expired": 0, "cancelled": 0, "finished": 0,
            "replayed": 0, "billed_tokens": 0, "quota_defers": 0,
        }

    @property
    def priority(self) -> int:
        return SLO_CLASSES.get(self.slo_class, 1)


class TenantRegistry:
    """The tenant table the engine, scheduler and paged pool share.

    One lock covers the buckets and the WFQ clocks — deliberately
    coarse (host-side dict math, nanoseconds)."""

    def __init__(self, config=None):
        self._lock = threading.Lock()
        self._states: Dict[str, TenantState] = {}
        self._vtime = 0.0  # global WFQ virtual time (advances on pop)
        self._defaults: Dict[str, Any] = {}
        self._overrides: Dict[str, Dict[str, Any]] = {}
        self.rate_limit_enabled = True
        if config is not None:
            self._defaults = {
                "refill_tokens_per_second": config.refill_tokens_per_second,
                "burst_tokens": config.burst_tokens,
                "weight": config.weight,
                "slo_class": config.slo_class,
                "kv_pages_max": config.kv_pages_max,
                "pinned_prefixes_max": config.pinned_prefixes_max,
            }
            self._overrides = {
                name: dict(spec) for name, spec in config.overrides.items()
            }

    # -- state table -------------------------------------------------------
    def state(self, tenant: Optional[str]) -> TenantState:
        name = tenant or DEFAULT_TENANT
        st = self._states.get(name)
        if st is None:
            spec = dict(self._defaults)
            spec.update(self._overrides.get(name, {}))
            st = TenantState(name, spec)
            self._states[name] = st
        return st

    def names(self):
        return sorted(self._states)

    # -- admission ---------------------------------------------------------
    def admit(self, tenant: Optional[str], cost: float, now: float) -> None:
        """Charge the tenant's bucket for a submit; raises
        :class:`TenantThrottled` (with the refill-time ``retry_after``)
        when the bucket cannot cover it.  A zero-rate zero-burst spec
        means 'unlimited' (rate limiting off for that tenant)."""
        with self._lock:
            st = self.state(tenant)
            st.counters["submitted"] += 1
            if not self.rate_limit_enabled or (
                st.bucket.rate <= 0.0 and st.bucket.burst <= 0.0
            ):
                return
            retry = st.bucket.take(float(cost), now)
            if retry is None:
                return
            st.counters["throttled"] += 1
        raise TenantThrottled(
            f"tenant {st.name!r} rate limit: cost {cost:g} exceeds bucket "
            f"({st.bucket.tokens:.1f} of {st.bucket.burst:g} tokens, refill "
            f"{st.bucket.rate:g}/s); retry after ~{retry:.2f}s",
            retry_after=retry,
        )

    def priority_for(self, tenant: Optional[str], explicit: Optional[int]) -> int:
        """The request's priority tier: an explicit caller choice wins,
        otherwise the tenant's SLO class decides."""
        if explicit is not None:
            return int(explicit)
        with self._lock:
            return self.state(tenant).priority

    # -- weighted-fair queueing -------------------------------------------
    def tag(self, tenant: Optional[str], cost: float) -> float:
        """Start-time fair queueing: the submit's virtual start time is
        ``max(global vtime, tenant's last tag)``; the tenant's clock
        then advances by ``cost / weight``."""
        with self._lock:
            st = self.state(tenant)
            start = max(self._vtime, st.last_tag)
            st.last_tag = start + float(cost) / st.weight
            return start

    def pick(self, queue) -> int:
        """The scheduler's pop policy with tenants armed: choose the
        tenant with the LOWEST outstanding virtual tag (fairness ahead
        of the tiers), then priority-then-FIFO within that tenant.
        Returns the queue index to pop."""
        with self._lock:
            tags: Dict[str, float] = {}
            for r in queue:
                t = r.tenant or DEFAULT_TENANT
                tag = r.wfq_tag
                if t not in tags or tag < tags[t]:
                    tags[t] = tag
            winner = min(tags, key=lambda t: (tags[t], t))
            best_i, best = 0, None
            for i, r in enumerate(queue):
                if (r.tenant or DEFAULT_TENANT) != winner:
                    continue
                if best is None or r.priority < best.priority:
                    best_i, best = i, r
                    if r.priority == 0:
                        break
            self._vtime = max(self._vtime, best.wfq_tag)
            return best_i

    # -- accounting --------------------------------------------------------
    def note(self, kind: str, tenant: Optional[str], n: float = 1) -> None:
        with self._lock:
            st = self.state(tenant)
            if kind in st.counters:
                st.counters[kind] += n

    def bill(self, tenant: Optional[str], tokens: int) -> None:
        """Realized usage at retire — the journal's ``n`` twin, so the
        in-memory ledger and :func:`journal_tenant_totals` agree."""
        with self._lock:
            st = self.state(tenant)
            st.counters["finished"] += 1
            st.counters["billed_tokens"] += int(tokens)

    # -- kv quotas ---------------------------------------------------------
    def kv_pages_max(self, tenant: Optional[str]) -> int:
        with self._lock:
            return self.state(tenant).kv_pages_max

    def pinned_prefixes_max(self, tenant: Optional[str]) -> int:
        with self._lock:
            return self.state(tenant).pinned_prefixes_max

    def note_quota_defer(self, tenant: Optional[str]) -> None:
        self.note("quota_defers", tenant)

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for name, st in self._states.items():
                out[name] = dict(st.counters)
                out[name].update({
                    "weight": st.weight,
                    "slo_class": st.slo_class,
                    "priority": st.priority,
                    "bucket_tokens": st.bucket.tokens,
                    "bucket_burst": st.bucket.burst,
                    "bucket_rate": st.bucket.rate,
                })
            return out


# ---------------------------------------------------------------------------
# journal reconciliation
# ---------------------------------------------------------------------------

def journal_tenant_totals(journal_dir: str) -> Dict[str, Dict[str, int]]:
    """Replay the request journal into per-tenant totals — the durable
    twin of :meth:`TenantRegistry.snapshot`, and the reconciliation
    oracle for the crash tests: ``admitted`` counts distinct journaled
    submits (latest-wins by id, so a recover()'s re-journal does not
    double-count) and ``billed_tokens`` sums the retire records'
    realized token counts (at most one retire per id — no double-bill
    across a crash)."""
    submits: Dict[int, Optional[str]] = {}
    billed: Dict[int, int] = {}
    rejected: Dict[int, Optional[str]] = {}
    for rec in _journal.read_records(journal_dir):
        t = rec.get("t")
        rid = int(rec.get("id", -1))
        if t == "submit":
            submits[rid] = rec.get("tn")
        elif t == "retire":
            if rec.get("reason") != "cancelled":
                billed[rid] = int(rec.get("n", 0))
        elif t == "reject":
            rejected[rid] = submits.get(rid)
    out: Dict[str, Dict[str, int]] = {}

    def row(tenant: Optional[str]) -> Dict[str, int]:
        name = tenant or DEFAULT_TENANT
        return out.setdefault(
            name, {"admitted": 0, "billed_tokens": 0, "retired": 0,
                   "rejected": 0})

    for rid, tenant in submits.items():
        row(tenant)["admitted"] += 1
    for rid, n in billed.items():
        r = row(submits.get(rid))
        r["billed_tokens"] += n
        r["retired"] += 1
    for rid, tenant in rejected.items():
        row(tenant)["rejected"] += 1
    return out


__all__ = [
    "DEFAULT_TENANT", "SLO_CLASSES", "TenantThrottled", "TokenBucket",
    "TenantState", "TenantRegistry", "journal_tenant_totals",
]
