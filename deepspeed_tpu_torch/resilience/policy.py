"""Failure policies: bounded retry with backoff, and the divergence guard
(a copy of ``deepspeed_tpu/resilience/policy.py``).

:func:`retry_call` is the one retry implementation in the codebase —
checkpoint I/O and distributed init both route through it, so backoff
behaviour (exponential, capped, deterministic seeded jitter, optional
overall deadline) is uniform and testable.  ``sleep``/``clock`` are
injectable so tests run at full speed.

:class:`DivergenceGuard` watches the step stream for runs of
NaN/overflow-skipped steps (the signature of a diverged run or a
loss-scale floor set too high) and trips a configured action after N
consecutive skips; the engine maps the action string to behaviour
(warn / lower the loss-scale floor / roll back to the last verified
checkpoint).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple


class RetryError(RuntimeError):
    """Raised when a retry policy is exhausted (or its deadline passes)."""


@dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff + jitter.

    ``retry_on`` is the exception allow-list; anything else (including
    :class:`~deepspeed_tpu_torch.resilience.faults.InjectedKill`) propagates
    immediately — a process death must never be "retried".
    """

    max_attempts: int = 3
    backoff_seconds: float = 0.5
    backoff_max_seconds: float = 30.0
    jitter: float = 0.25  # extra delay fraction, uniform in [0, jitter)
    timeout_seconds: Optional[float] = None  # overall deadline across attempts
    retry_on: Tuple[type, ...] = (OSError,)

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        base = min(self.backoff_seconds * (2.0 ** (attempt - 1)), self.backoff_max_seconds)
        return base * (1.0 + self.jitter * rng.random())


def retry_call(
    policy: RetryPolicy,
    fn: Callable,
    *args,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    seed: int = 0,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)`` under ``policy``.  Returns the first
    successful result; raises :class:`RetryError` (chained to the last
    failure) on exhaustion or deadline."""
    rng = random.Random(seed)
    start = clock()
    last: Optional[BaseException] = None
    for attempt in range(1, max(1, policy.max_attempts) + 1):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            last = e
            if attempt >= policy.max_attempts:
                break
            pause = policy.delay(attempt, rng)
            if (
                policy.timeout_seconds is not None
                and (clock() - start) + pause > policy.timeout_seconds
            ):
                raise RetryError(
                    f"{getattr(fn, '__name__', 'call')} gave up after {attempt} attempt(s): "
                    f"deadline of {policy.timeout_seconds}s would be exceeded"
                ) from e
            if on_retry is not None:
                on_retry(attempt, e, pause)
            from deepspeed_tpu_torch.telemetry import get_registry

            get_registry().counter(
                "resilience/retries", fn=getattr(fn, "__name__", "call")
            ).inc()
            sleep(pause)
    raise RetryError(
        f"{getattr(fn, '__name__', 'call')} failed after {policy.max_attempts} attempt(s): {last!r}"
    ) from last


def retry(policy: RetryPolicy, **retry_kwargs):
    """Decorator form of :func:`retry_call`."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            return retry_call(policy, fn, *args, **retry_kwargs, **kwargs)

        wrapper.__name__ = getattr(fn, "__name__", "wrapped")
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


@dataclass
class DivergenceGuard:
    """Trip ``action`` after ``threshold`` CONSECUTIVE skipped steps.

    One clean step resets the streak — occasional overflow skips are
    normal dynamic-loss-scale behaviour; a long run of them is not.
    """

    threshold: int = 20
    action: str = "warn"
    streak: int = field(default=0, init=False)
    trips: int = field(default=0, init=False)

    def record(self, diverged: bool) -> Optional[str]:
        """Feed one step's verdict; returns the action string when the
        guard trips (and resets the streak so the action is not
        re-triggered every subsequent step)."""
        if not diverged:
            self.streak = 0
            return None
        self.streak += 1
        if self.streak >= max(1, self.threshold):
            self.streak = 0
            self.trips += 1
            return self.action
        return None
