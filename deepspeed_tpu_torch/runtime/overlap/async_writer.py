"""Background checkpoint commits: training resumes while bytes hit disk (a
copy of ``deepspeed_tpu/runtime/overlap/async_writer.py``).

A synchronous atomic save (the stage -> manifest -> rename protocol)
stalls training for the full serialize+hash+fsync — seconds to minutes
at scale.  The async path splits the save at the only point that needs
the device state to hold still:

1. **snapshot** (caller thread, the only stall): device state is copied
   into pinned host tensors on a side CUDA stream at the step boundary,
   and the copies' event is synchronized before the save returns — after
   this, training may overwrite the device tensors in place freely;
2. **commit** (background thread): the snapshot runs the *unchanged*
   stage -> meta -> manifest -> rename protocol against the checkpoint
   tree, so every durability property the fault-injection tests prove
   holds for async saves too — a kill mid-commit leaves the
   previous tree plus a ``.tmp`` staging dir, never a loadable-but-
   corrupt tag.

One save is in flight at a time: a second save request **drains** the
in-flight one first (so tags commit in submission order and the staging
registry in ``resilience.manager`` never sees two owners of one dir).
The preemption watchdog drains synchronously before its emergency save,
keeping the exit-43 => committed-checkpoint contract intact.

A failed background commit is logged and surfaced on the next
:meth:`drain` (``PendingSave.error``); it never takes down the training
thread — the durability model is "the previous tag survives", same as a
crash at that instruction would have left.
"""
from __future__ import annotations

import atexit
import threading
import time
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger


class PendingSave:
    """Handle for one in-flight (or finished) background save."""

    def __init__(self, tag: str, final_path: str):
        self.tag = tag
        self.final_path = final_path
        self.started_at = time.monotonic()
        self.finished_at: Optional[float] = None
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def ok(self) -> bool:
        return self.done and self.error is None

    @property
    def done(self) -> bool:
        return self._thread is not None and not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join the background commit; True if it finished (ok or not)
        within ``timeout``."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()


class AsyncCheckpointWriter:
    """Serializes background saves: at most one in flight, drained in
    submission order."""

    def __init__(self, drain_timeout_seconds: float = 300.0):
        self.drain_timeout_seconds = float(drain_timeout_seconds)
        self._lock = threading.Lock()
        self._pending: Optional[PendingSave] = None
        self._atexit_registered = False
        self.last_error: Optional[BaseException] = None
        self.completed = 0
        self.failed = 0

    def _register_exit_drain(self) -> None:
        """A script whose last act is a save must not lose it: the
        commit thread is a daemon, which the interpreter would abandon
        mid-write.  The drain runs from threading's own exit hook (as the
        JAX package's, whose orbax commit needs executors that
        ``concurrent.futures`` disables from the same hook; callbacks run
        in reverse registration order, so registering here, long after
        ``concurrent.futures`` imported, runs the drain first), before
        the interpreter tears modules down."""
        register = getattr(threading, "_register_atexit", None)
        if register is not None:
            register(self._exit_drain)
        else:  # pragma: no cover - future-python fallback, best effort
            atexit.register(self._exit_drain)

    def _exit_drain(self) -> None:
        try:
            if self.in_flight:
                logger.warning("draining in-flight async checkpoint at interpreter exit")
            self.drain()  # also surfaces a finished-but-failed commit
        except BaseException as e:  # noqa: BLE001 — exit path must not throw
            logger.error(f"async checkpoint drain at exit failed: {e!r}")

    @property
    def in_flight(self) -> bool:
        with self._lock:
            p = self._pending
        return p is not None and not p.done

    def _settle_locked(self, pending: "PendingSave") -> None:
        """Account one finished save.  Caller holds ``self._lock`` and
        owns the ``_pending -> None`` (or replace) transition, so each
        save hits completed/failed exactly once."""
        if pending.error is not None:
            self.failed += 1
            self.last_error = pending.error
        else:
            self.completed += 1

    def submit(self, tag: str, final_path: str, commit_fn: Callable[[], None]) -> PendingSave:
        """Start ``commit_fn`` on a background thread.  The caller must
        :meth:`drain` first — two concurrent saves would race the
        checkpoint tree's staging/latest/GC state."""
        settled: Optional[PendingSave] = None
        with self._lock:
            if self._pending is not None and not self._pending.done:
                raise RuntimeError(
                    f"async save of '{self._pending.tag}' still in flight; drain() first"
                )
            if self._pending is not None:
                # finished but nobody drained it (a concurrent drain read
                # the handle, then lost the transition to us) — settle it
                # here or the save is never counted
                settled = self._pending
                self._settle_locked(settled)
                self._pending = None
            pending = PendingSave(tag, final_path)

            def run():
                # the background commit is a trace span (the checkpoint
                # writer's lane) and an async-saves count; no-ops when the
                # plane is off
                from deepspeed_tpu_torch.telemetry import PID_CHECKPOINT, get_registry, get_tracer

                tracer = get_tracer()
                t0 = tracer.now()
                try:
                    commit_fn()
                except BaseException as e:  # noqa: BLE001 — surfaced via drain()
                    pending.error = e
                finally:
                    pending.finished_at = time.monotonic()
                    tracer.add_span(
                        "ckpt_commit", "checkpoint", t0, tracer.now(), pid=PID_CHECKPOINT,
                        args={"tag": tag, "ok": pending.error is None},
                    )
                    reg = get_registry()
                    if reg.enabled:
                        reg.counter(
                            "ckpt/async_saves",
                            outcome="ok" if pending.error is None else "failed",
                        ).inc()

            if not self._atexit_registered:
                self._register_exit_drain()
                self._atexit_registered = True
            t = threading.Thread(target=run, daemon=True, name=f"ds-async-ckpt-{tag}")
            pending._thread = t
            self._pending = pending
            t.start()
        if settled is not None and settled.error is not None:
            logger.error(
                f"async checkpoint save of '{settled.tag}' failed: {settled.error!r} "
                "(the previously committed tag is still the durable state)"
            )
        return pending

    def drain(self, timeout: Optional[float] = None) -> Optional[PendingSave]:  # ds-race: entry
        """Wait for the in-flight save (if any) to finish and return its
        handle.  Raises ``TimeoutError`` if it does not finish within
        ``timeout`` (default: ``drain_timeout_seconds``) — callers on an
        exit path treat that as "not saved".  A failed commit is logged
        and recorded (``last_error``) but NOT re-raised: the previous
        tag is still the durable state, and the caller's next save
        proceeds fresh."""
        with self._lock:
            pending = self._pending
        if pending is None:
            return None
        timeout = self.drain_timeout_seconds if timeout is None else float(timeout)
        if not pending.wait(timeout):
            raise TimeoutError(
                f"async save of '{pending.tag}' did not finish within {timeout:.0f}s"
            )
        # The trainer and the preemption watchdog can drain the same
        # handle concurrently; whichever thread wins the None-out
        # transition owns the accounting, so completed/failed count each
        # save exactly once.
        accounted = False
        with self._lock:
            if self._pending is pending:
                self._pending = None
                accounted = True
                self._settle_locked(pending)
        if accounted and pending.error is not None:
            logger.error(
                f"async checkpoint save of '{pending.tag}' failed: {pending.error!r} "
                "(the previously committed tag is still the durable state)"
            )
        return pending
