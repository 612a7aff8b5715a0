"""Fleet health plane: per-replica state machine + circuit breaker
(counterpart of ``deepspeed_tpu/serving/fleet/health.py``).

Every replica behind the :class:`~deepspeed_tpu_torch.serving.fleet.router.
FleetRouter` carries a :class:`ReplicaHealth` — a four-state machine

    healthy -> degraded -> healthy      (ladder pressure, reversible)
    any     -> draining                 (SIGTERM observed; no new routes)
    any     -> dead                     (heartbeat EOF / process loss)
    dead    -> healthy                  (supervised restart + replay)

— fed by the replica's own telemetry (degradation-ladder rung, shed
rate) and by death signals (a heartbeat channel's ``PeerEvent`` for
process replicas, the handle's liveness flag in process).

The :class:`CircuitBreaker` is the route-failure half of the plane:
``breaker_failures`` CONSECUTIVE failures trip it OPEN, after which the
replica is skipped for a backoff drawn from the
:class:`~deepspeed_tpu_torch.resilience.policy.RetryPolicy` schedule —
exponential across consecutive trips, capped, seeded jitter, the same
deterministic curve checkpoint I/O retries use.  When the backoff
elapses the breaker admits ``halfopen_probes`` HALF_OPEN probe
requests: one success re-closes (and resets the backoff exponent), one
failure re-opens with the next, longer backoff.  The jitter draws from
``random.Random(seed)`` as the JAX package's breaker does, so one seed
gives both packages the same backoff sequence.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from deepspeed_tpu_torch.resilience.policy import RetryPolicy
from deepspeed_tpu_torch.utils.logging import logger

# replica states
HEALTHY = "healthy"
DEGRADED = "degraded"
DRAINING = "draining"
DEAD = "dead"

# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Consecutive-failure breaker with seeded-jitter exponential
    backoff.  ``clock`` is injectable so tests run at full speed."""

    def __init__(
        self,
        failure_threshold: int = 3,
        policy: Optional[RetryPolicy] = None,
        halfopen_probes: int = 1,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.policy = policy if policy is not None else RetryPolicy()
        self.halfopen_probes = max(1, int(halfopen_probes))
        self._rng = random.Random(seed)
        self._clock = clock
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0  # lifetime CLOSED->OPEN transitions
        self.retry_at: Optional[float] = None  # OPEN until (monotonic)
        self._backoff_attempt = 0  # resets on a half-open success
        self._probes_left = 0

    def allow(self, now: Optional[float] = None) -> bool:
        """May a request route to this replica right now?  An OPEN
        breaker whose backoff has elapsed transitions to HALF_OPEN here
        and hands out its probe tokens."""
        if self.state == CLOSED:
            return True
        now = self._clock() if now is None else now
        if self.state == OPEN:
            if self.retry_at is not None and now < self.retry_at:
                return False
            self.state = HALF_OPEN
            self._probes_left = self.halfopen_probes
        if self._probes_left > 0:
            self._probes_left -= 1
            return True
        return False

    def record_success(self) -> None:
        """A routed request was acknowledged: a half-open probe success
        closes the breaker and resets the backoff exponent."""
        self.consecutive_failures = 0
        if self.state != CLOSED:
            self.state = CLOSED
            self.retry_at = None
            self._backoff_attempt = 0

    def record_failure(self, now: Optional[float] = None) -> bool:
        """A routed request failed; returns True when this failure trips
        (or re-trips) the breaker OPEN."""
        now = self._clock() if now is None else now
        if self.state == HALF_OPEN:
            self._open(now)
            return True
        self.consecutive_failures += 1
        if self.state == CLOSED and self.consecutive_failures >= self.failure_threshold:
            self._open(now)
            return True
        return False

    def _open(self, now: float) -> None:
        self.state = OPEN
        self.trips += 1
        self._backoff_attempt += 1
        self.consecutive_failures = 0
        self._probes_left = 0
        pause = self.policy.delay(self._backoff_attempt, self._rng)
        self.retry_at = now + pause
        logger.warning(
            f"fleet: circuit breaker OPEN (trip {self.trips}); half-open "
            f"probe in {pause:.2f}s"
        )

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "trips": self.trips,
            "consecutive_failures": self.consecutive_failures,
            "retry_at": self.retry_at,
        }


class ReplicaHealth:
    """One replica's state machine + breaker, as the router sees it."""

    def __init__(self, name: str, breaker: CircuitBreaker):
        self.name = name
        self.breaker = breaker
        self.state = HEALTHY
        self.reason: Optional[str] = None
        self.died_at: Optional[float] = None
        self.deaths = 0
        self.restarts = 0

    # -- transitions ------------------------------------------------------
    def mark_degraded(self, reason: str = "ladder engaged") -> None:
        if self.state == HEALTHY:
            self.state = DEGRADED
            self.reason = reason

    def mark_healthy(self) -> None:
        if self.state == DEGRADED:
            self.state = HEALTHY
            self.reason = None

    def mark_draining(self, reason: str = "drain signal") -> None:
        if self.state != DEAD:
            self.state = DRAINING
            self.reason = reason

    def mark_undrained(self) -> None:
        """Drain abandoned (e.g. an elastic scale-down aborted at its
        migration deadline): back into rotation.  Not a restart — the
        process never went away, so no counter moves."""
        if self.state == DRAINING:
            self.state = HEALTHY
            self.reason = None

    def mark_dead(self, reason: str, now: Optional[float] = None) -> None:
        if self.state != DEAD:
            self.state = DEAD
            self.reason = reason
            self.died_at = now if now is not None else time.monotonic()
            self.deaths += 1
            logger.warning(f"fleet: replica {self.name} marked dead ({reason})")

    def revive(self) -> None:
        """A supervised restart replayed the journal: back to healthy
        with a fresh breaker streak (the restarted process has not
        failed anything yet)."""
        self.state = HEALTHY
        self.reason = None
        self.restarts += 1
        self.breaker.record_success()

    # -- feeds ------------------------------------------------------------
    def observe(self, degrade_level: int, draining: bool = False) -> None:
        """Per-step telemetry feed: the replica's degradation-ladder
        rung (and drain flag) maps onto the reversible health states.
        Dead replicas only leave DEAD through :meth:`revive`."""
        if self.state == DEAD:
            return
        if draining:
            self.mark_draining()
            return
        if self.state == DRAINING:
            return
        if degrade_level >= 1:
            self.mark_degraded(f"ladder rung {degrade_level}")
        else:
            self.mark_healthy()

    def on_peer_event(self, kind: str, reason: str = "") -> None:
        """Heartbeat-channel feed: a ``dead`` event (socket EOF —
        what a kill -9 looks like from outside) kills the replica; a
        ``bye`` marks it draining (it announced a graceful exit)."""
        if kind == "dead":
            self.mark_dead(reason or "heartbeat EOF")
        elif kind == "bye":
            self.mark_draining(reason or "peer said bye")

    def routable(self, now: Optional[float] = None) -> bool:
        return self.state not in (DEAD, DRAINING) and self.breaker.allow(now)

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "reason": self.reason,
            "deaths": self.deaths,
            "restarts": self.restarts,
            "breaker": self.breaker.snapshot(),
        }


__all__ = [
    "CircuitBreaker", "ReplicaHealth",
    "HEALTHY", "DEGRADED", "DRAINING", "DEAD",
    "CLOSED", "OPEN", "HALF_OPEN",
]
