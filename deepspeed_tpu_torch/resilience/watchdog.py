"""Preemption watchdog: turn SIGTERM into a clean checkpoint-and-exit (a
copy of ``deepspeed_tpu/resilience/watchdog.py``).

Cluster schedulers deliver SIGTERM with a grace
window before the hard kill.  The watchdog's signal handler only sets a
flag and a monotonic deadline — everything non-async-signal-safe
(logging, the emergency save, ``SystemExit``) happens at the next step
boundary, where the engine calls into :meth:`PreemptionWatchdog`.

Exit-code contract (see ``docs/resilience.md``):

* ``EXIT_PREEMPTED_SAVED`` (default 43) — preempted AND the emergency
  checkpoint committed; a scheduler can requeue-and-resume blindly.
* exit 1 — preempted but the save failed or the grace deadline had
  already passed; treat like a crash (resume from the previous tag).
"""
from __future__ import annotations

import os
import signal
import time
from typing import Callable, Dict, Optional, Tuple

EXIT_PREEMPTED_SAVED = 43

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionWatchdog:
    def __init__(
        self,
        grace_seconds: float = 60.0,
        exit_code: int = EXIT_PREEMPTED_SAVED,
        signals: Tuple[signal.Signals, ...] = _DEFAULT_SIGNALS,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.grace_seconds = float(grace_seconds)
        self.exit_code = int(exit_code)
        self.signals = tuple(signals)
        self._clock = clock
        self._old_handlers: Dict[int, object] = {}
        self._requested_at: Optional[float] = None
        self._signum: Optional[int] = None
        self.repeat_count = 0
        self._installed = False

    # -- signal plumbing --------------------------------------------------
    def _handle(self, signum, frame) -> None:
        # async-signal-safe: flags only; the engine acts at the next
        # step boundary
        if self._requested_at is None:
            self._requested_at = self._clock()
            self._signum = signum
            return
        # ESCALATION: a repeated signal means the step-boundary handler
        # is not coming (hung compile, deadlocked collective) or the
        # operator really wants out — restore the original disposition
        # and re-deliver, so a second Ctrl-C/SIGTERM behaves like the
        # watchdog was never installed
        self.repeat_count += 1
        old = self._old_handlers.get(signum, signal.SIG_DFL)
        signal.signal(signum, old)
        if callable(old):
            old(signum, frame)
        else:
            os.kill(os.getpid(), signum)

    def install(self) -> "PreemptionWatchdog":
        if not self._installed:
            for sig in self.signals:
                self._old_handlers[sig] = signal.signal(sig, self._handle)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            for sig, old in self._old_handlers.items():
                signal.signal(sig, old)
            self._old_handlers.clear()
            self._installed = False

    __enter__ = install

    def __exit__(self, *exc_info) -> None:
        self.uninstall()

    # -- state ------------------------------------------------------------
    @property
    def preemption_requested(self) -> bool:
        return self._requested_at is not None

    @property
    def requested_at(self) -> Optional[float]:
        """Monotonic stamp of the (first) preemption signal — the anchor
        the serving drain budget counts down from (serving/watchdog.py)."""
        return self._requested_at

    @property
    def signal_name(self) -> str:
        if self._signum is None:
            return "none"
        try:
            return signal.Signals(self._signum).name
        except ValueError:
            return str(self._signum)

    def remaining(self) -> float:
        """Seconds left in the grace window (<= 0 once the deadline has
        passed; +inf when no preemption is pending)."""
        if self._requested_at is None:
            return float("inf")
        return (self._requested_at + self.grace_seconds) - self._clock()

    def reset(self) -> None:
        """Clear a pending request (after it has been handled)."""
        self._requested_at = None
        self._signum = None
        self.repeat_count = 0
