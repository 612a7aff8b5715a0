"""ServingWatchdog: SIGTERM → stop admission → drain → exit 43 (a copy of
``deepspeed_tpu/serving/watchdog.py``).

:class:`~deepspeed_tpu_torch.resilience.watchdog.PreemptionWatchdog`'s
contract, wired into the serving plane.
The training engine answers preemption with an emergency checkpoint;
the serving engine's equivalent durable state is the request journal —
so the drain sequence is:

1. the signal handler only flags (async-signal-safe; a *repeated*
   signal escalates through the inner watchdog's restore-and-redeliver
   escape hatch, exactly like training);
2. ``submit()`` starts rejecting with :class:`ServingDraining` the
   moment the flag is up — admission stops before the next step;
3. the next ``step()`` enters the drain loop: in-flight requests keep
   decoding (no new admissions) until the live set empties or
   ``drain_deadline_seconds`` runs out;
4. undone work — still-queued requests plus in-flight requests the
   deadline cut off — is already durable in the journal (submit records
   commit at acknowledgement); a final ``drain`` record is appended and
   the journal commits;
5. **exit 43 certifies the commit**: with a journal, 43 is raised only
   after ``commit()`` returns (a failed commit quarantines and exits
   1); without a journal, 43 requires a complete drain (undone work
   with nowhere durable to live is exit 1, the crash contract — resume
   has nothing to replay from).

The engine drives :meth:`ServingEngine.install_watchdog`; tests drive
the same path by delivering a real ``SIGTERM`` to the process.
"""
from __future__ import annotations

import signal
from typing import Optional, Tuple

from deepspeed_tpu_torch.resilience.watchdog import EXIT_PREEMPTED_SAVED, PreemptionWatchdog

_DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class ServingWatchdog:
    """Thin composition over :class:`PreemptionWatchdog`: same signal
    plumbing, flag-only handler, grace window and escalation — the
    serving engine polls :attr:`draining` and runs the drain itself at
    its step boundary (``engine._drain_and_exit``)."""

    def __init__(
        self,
        drain_deadline_seconds: float = 30.0,
        exit_code: int = EXIT_PREEMPTED_SAVED,
        signals: Tuple[signal.Signals, ...] = _DEFAULT_SIGNALS,
    ):
        self._inner = PreemptionWatchdog(
            grace_seconds=drain_deadline_seconds,
            exit_code=exit_code,
            signals=signals,
        )

    # -- lifecycle --------------------------------------------------------
    def install(self) -> "ServingWatchdog":
        self._inner.install()
        return self

    def uninstall(self) -> None:
        self._inner.uninstall()

    __enter__ = install

    def __exit__(self, *exc_info) -> None:
        self.uninstall()

    # -- state ------------------------------------------------------------
    @property
    def draining(self) -> bool:
        """A drain signal has been received (admission must reject)."""
        return self._inner.preemption_requested

    @property
    def exit_code(self) -> int:
        return self._inner.exit_code

    @property
    def drain_deadline_seconds(self) -> float:
        return self._inner.grace_seconds

    @property
    def signal_name(self) -> str:
        return self._inner.signal_name

    @property
    def requested_at(self) -> Optional[float]:
        return self._inner.requested_at

    def remaining(self) -> float:
        """Seconds of drain budget left (+inf when no drain pending)."""
        return self._inner.remaining()

    def reset(self) -> None:
        self._inner.reset()


__all__ = ["ServingWatchdog"]
