"""ReplicaSupervisor: restart dead replicas, losslessly (counterpart of
``deepspeed_tpu/serving/fleet/supervisor.py``).

The serving fleet answers a dead REPLICA with a local restart + journal
replay — the other replicas keep serving throughout.

Policy: at most ``max_restarts`` restarts per replica (a crash-looping
replica eventually stays dead rather than flapping forever), with the
:class:`~deepspeed_tpu_torch.resilience.policy.RetryPolicy` backoff schedule
between attempts — exponential, capped, seeded jitter, the same curve
the circuit breaker and checkpoint I/O use.  ``sleep`` is injectable so
tests run at full speed.

Two execution modes:

* **sync** (default) — ``handle_death`` blocks through backoff +
  restart + replay and returns the replayed ids (the router re-binds
  in-flight handles to them) or None when the replica must stay dead
  (budget exhausted, or the restart itself failed — a factory raise
  counts as a consumed attempt).
* **background** (``background=True``) — ``handle_death`` returns the
  :data:`RESTART_PENDING` sentinel immediately and runs the restart on
  a daemon thread; the surviving replicas keep serving while the
  replacement rebuilds and warms (a replica in a child process builds in
  that process, so the routing loop genuinely overlaps it).  The router polls
  :meth:`drain_completed` each step and revives/re-binds on completion
  — this is what keeps admitted-TTFT near steady-state during a
  failover instead of charging every in-flight request the rebuild.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.resilience.policy import RetryPolicy
from deepspeed_tpu_torch.utils.logging import logger

# handle_death's "restart underway" answer in background mode — distinct
# from None ("stays dead") and from a (possibly empty) replayed-id list
RESTART_PENDING = object()


class ReplicaSupervisor:
    def __init__(
        self,
        max_restarts: int = 3,
        policy: Optional[RetryPolicy] = None,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        background: bool = False,
        restart_budget_reset_seconds: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_restarts = max(0, int(max_restarts))
        self.policy = policy if policy is not None else RetryPolicy(
            backoff_seconds=0.2, backoff_max_seconds=5.0
        )
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.background = bool(background)
        # leaky-bucket budget: every restart_budget_reset_seconds of
        # clean service since the last consumed attempt forgives one
        # attempt, so a long-lived elastic fleet isn't permanently
        # condemned by one bad hour.  0 = legacy never-decays behaviour.
        self.restart_budget_reset_seconds = max(
            0.0, float(restart_budget_reset_seconds)
        )
        self._clock = clock
        self._attempts: Dict[str, int] = {}  # name -> restarts consumed
        self._last_attempt_at: Dict[str, float] = {}
        self.restarts = 0  # successful restarts, fleet-wide
        self._lock = threading.Lock()
        self._threads: Dict[str, threading.Thread] = {}
        self._completed: List[Tuple[Any, Optional[List[int]]]] = []

    def attempts(self, name: str) -> int:
        self._decay_budget(name)
        return self._attempts.get(name, 0)

    def _decay_budget(self, name: str) -> None:
        """Forgive one consumed attempt per full reset interval of
        service since the last consumed attempt (leaky bucket)."""
        reset = self.restart_budget_reset_seconds
        if reset <= 0:
            return
        n = self._attempts.get(name, 0)
        if n <= 0:
            return
        last = self._last_attempt_at.get(name)
        if last is None:
            return
        forgiven = int((self._clock() - last) // reset)
        if forgiven <= 0:
            return
        remaining = max(0, n - forgiven)
        self._attempts[name] = remaining
        # the un-forgiven remainder keeps accruing from the same epoch
        self._last_attempt_at[name] = last + forgiven * reset
        logger.info(
            f"fleet: replica {name} earned back {n - remaining} restart "
            f"attempt(s) after clean service ({remaining} consumed remain)"
        )

    def handle_death(self, replica, reason: str):
        """Restart ``replica`` (anything with ``restart() -> replayed
        ids``) under the budget.  Returns the replayed ids, None when it
        must stay dead, or :data:`RESTART_PENDING` in background mode."""
        name = replica.name
        self._decay_budget(name)
        n = self._attempts.get(name, 0)
        if n >= self.max_restarts:
            logger.error(
                f"fleet: replica {name} dead ({reason}) and its restart "
                f"budget ({self.max_restarts}) is exhausted; it stays dead"
            )
            return None
        self._attempts[name] = n + 1
        self._last_attempt_at[name] = self._clock()
        pause = self.policy.delay(n + 1, self._rng)
        logger.warning(
            f"fleet: restarting replica {name} ({reason}); attempt "
            f"{n + 1}/{self.max_restarts} after {pause:.2f}s backoff"
            + (" [background]" if self.background else "")
        )
        if not self.background:
            self._sleep(pause)
            return self._restart(replica)
        t = threading.Thread(
            target=self._bg_restart, args=(replica, pause),
            name=f"fleet-restart-{name}", daemon=True,
        )
        with self._lock:
            self._threads[name] = t
        t.start()
        return RESTART_PENDING

    def _restart(self, replica) -> Optional[List[int]]:
        try:
            replayed = replica.restart()
        except Exception as e:
            logger.error(f"fleet: replica {replica.name} restart failed: {e!r}")
            return None
        with self._lock:
            # both the router's sync path and N background restart
            # threads land here — an unlocked += drops restarts
            self.restarts += 1
        logger.warning(
            f"fleet: replica {replica.name} restarted; journal replayed "
            f"{len(replayed)} request(s) under original ids"
        )
        return replayed

    def _bg_restart(self, replica, pause: float) -> None:
        self._sleep(pause)
        replayed = self._restart(replica)
        with self._lock:
            self._completed.append((replica, replayed))
            self._threads.pop(replica.name, None)

    def pending(self) -> bool:
        """Any background restart still underway?"""
        with self._lock:
            return bool(self._threads)

    def drain_completed(self) -> List[Tuple[Any, Optional[List[int]]]]:
        """Pop finished background restarts: (replica, replayed ids or
        None).  The router calls this each step and revives/re-binds."""
        with self._lock:
            out, self._completed = self._completed, []
        return out


__all__ = ["ReplicaSupervisor", "RESTART_PENDING"]
