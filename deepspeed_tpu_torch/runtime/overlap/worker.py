"""Shared bounded-queue background worker (a copy of
``deepspeed_tpu/runtime/overlap/worker.py``).

A single daemon thread draining a bounded FIFO of host-side jobs.  The
checkpoint writer and device prefetcher each grew their own ad-hoc
thread + queue; the KV tier manager needs the same shape (slow disk IO
hidden under engine compute), so the pattern lives here once.

Contract:

- ``submit`` enqueues a callable; it never blocks the caller beyond the
  bounded-queue backpressure (``block=False`` returns ``False`` when the
  queue is full so callers can retry on their next tick).
- Jobs run strictly in submission order on one thread — callers rely on
  this for write-after-write ordering onto disk.
- Job exceptions never kill the thread: they are counted, remembered
  (``last_error``) and re-surfaced to the owner via ``errors()`` which
  drains the pending-error list.  A job raising is an abnormal event for
  tier migration (the entry simply stays in its current tier), not a
  crash.
- ``drain`` blocks until every job submitted so far has finished — used
  by tests and by engine shutdown to make background state durable.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

__all__ = ["BoundedWorker"]

_POLL_S = 0.05


class BoundedWorker:
    """One daemon thread executing submitted thunks in FIFO order."""

    def __init__(self, name: str = "ds-worker", depth: int = 32) -> None:
        if depth < 1:
            raise ValueError(f"worker depth must be >= 1, got {depth}")
        self.name = name
        self._q: "queue.Queue[Optional[Tuple[str, Callable[[], Any]]]]" = (
            queue.Queue(maxsize=depth))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._errors: List[Tuple[str, BaseException]] = []
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.last_error: Optional[BaseException] = None

    # -- lifecycle ---------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, name=self.name, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            if item is None:
                self._q.task_done()
                break
            label, fn = item
            try:
                fn()
                with self._lock:
                    self.completed += 1
            except BaseException as exc:  # noqa: BLE001 - surfaced to owner
                with self._lock:
                    self.failed += 1
                    self.last_error = exc
                    self._errors.append((label, exc))
            finally:
                self._q.task_done()

    # -- API ---------------------------------------------------------

    def submit(self, fn: Callable[[], Any], label: str = "",
               block: bool = False) -> bool:
        """Enqueue ``fn``; returns False when full (``block=False``) or
        after ``close``."""
        if self._stop.is_set():
            return False
        self._ensure_thread()
        try:
            if block:
                while not self._stop.is_set():
                    try:
                        self._q.put((label, fn), timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return False
            else:
                self._q.put_nowait((label, fn))
        except queue.Full:
            return False
        with self._lock:
            self.submitted += 1
        return True

    def pending(self) -> int:
        """Jobs submitted and not finished, the running one included: the
        queue's count of puts not yet marked done, so a job the thread
        has taken off the queue but not begun still counts (a queue size
        plus a busy flag set after the take let :meth:`drain` return
        between the two)."""
        with self._q.mutex:
            return self._q.unfinished_tasks

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until everything submitted so far has run.

        Returns False on timeout (work may still be in flight)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.pending() > 0:
            if self._thread is None or not self._thread.is_alive():
                return self.pending() == 0
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.001)
        return True

    def errors(self) -> List[Tuple[str, BaseException]]:
        """Drain and return (label, exception) pairs from failed jobs."""
        with self._lock:
            out, self._errors = self._errors, []
        return out

    def close(self, timeout: float = 2.0) -> None:
        """Stop accepting work and join the thread (idempotent)."""
        if self._stop.is_set():
            return
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout)

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "pending": self.pending(),
            }
