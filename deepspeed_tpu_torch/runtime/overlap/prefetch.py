"""Double-buffered input prefetch (counterpart of
``deepspeed_tpu/runtime/overlap/prefetch.py``).

The engine's launches run asynchronously on the card; what serializes a
training loop is the host work per batch — pulling the next batch out of
the loader (tokenization, disk reads) and copying it to the card.
:class:`DevicePrefetcher` runs both ahead of the consumer as a two-stage
pipeline:

    loader thread:  ``next(loader)``      -> bounded queue (depth N)
    place  thread:  ``place_fn(batch)``   -> bounded queue (depth N)
    consumer:       pops device-resident batches; the step never waits
                    on the host-to-device copy while the pipeline keeps up

The engine's place function (``engine.prefetch_loader``) pins the host
batch and copies it on a CUDA stream of its own, recording an event the
step's stream waits on; see ``runtime/engine.py``.

Each stage is backpressured by its queue (``depth`` batches in flight
per stage), so host memory is bounded at ``~2*depth`` batches.  The
consumer-side queue wait — the time the accelerator would have idled on
input — is reported to the engine's ``StepTimeline`` as ``data_wait``.

Exceptions raised by the loader or the placement function are re-raised
in the consumer at the position they occurred; iteration order is
preserved exactly.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import torch

from deepspeed_tpu_torch.runtime.dataloader import ResumableWrapperMixin
from deepspeed_tpu_torch.runtime.engine import tree_flatten


class _End:
    """Sentinel: the upstream stage is exhausted."""


class _Raised:
    """Sentinel wrapper: the upstream stage raised."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_ABORT = object()  # returned by _get when the pipeline is being closed


def _put(q: "queue.Queue", item: Any, stop: threading.Event) -> bool:
    """Blocking put that aborts when ``stop`` is set, so a worker blocked
    on a full queue can never outlive :meth:`DevicePrefetcher.close`."""
    while True:
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            if stop.is_set():
                return False


def _get(q: "queue.Queue", stop: threading.Event) -> Any:
    """Blocking get with the same abort contract as :func:`_put`."""
    while True:
        try:
            return q.get(timeout=0.05)
        except queue.Empty:
            if stop.is_set():
                return _ABORT


def _load_worker(it, out_q: "queue.Queue", stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            item = next(it)
        except StopIteration:
            item = _End()
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            item = _Raised(e)
        if not _put(out_q, item, stop):
            return
        if isinstance(item, (_End, _Raised)):
            return


def _place_worker(place: Callable[[Any], Any], in_q: "queue.Queue", out_q: "queue.Queue", stop: threading.Event) -> None:
    while not stop.is_set():
        item = _get(in_q, stop)
        if item is _ABORT:
            return
        if not isinstance(item, (_End, _Raised)):
            try:
                item = place(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                item = _Raised(e)
        if not _put(out_q, item, stop):
            return
        if isinstance(item, (_End, _Raised)):
            return


def _not_ported_sanitizer(sanitizer: Any) -> None:
    if sanitizer is not None:
        raise NotImplementedError(
            "the sanitizer's transfer guard on the place stage is not ported yet (ROADMAP A15)")


def _to_device(batch: Any, device: Any) -> Any:
    leaves, rebuild = tree_flatten(batch)
    return rebuild([torch.as_tensor(x).to(device) for x in leaves])


class DevicePrefetcher(ResumableWrapperMixin):
    """Wraps a host batch iterator with pipelined load + device placement.

    ``place_fn``: host batch -> device-resident batch (the engine passes
    its pinned copy on a side stream); when omitted, every leaf moves to
    ``device`` (None: stays where it is, as a tensor).

    ``depth``: batches in flight per stage (2 = double buffering).

    ``timeline``: optional ``StepTimeline``; consumer-side queue waits
    are noted as ``data_wait``.

    ``sanitizer``: the JAX package's transfer guard on the place stage;
    the keyword stays and raises when given (ROADMAP A15).

    The place stage does not fall back to anything when it fails: the
    error re-raises in the consumer at the batch where it happened.
    """

    def __init__(
        self,
        loader: Iterable,
        depth: int = 2,
        place_fn: Optional[Callable[[Any], Any]] = None,
        device: Any = None,
        timeline: Any = None,
        sanitizer: Any = None,
    ):
        _not_ported_sanitizer(sanitizer)
        self.loader = loader
        self.depth = max(1, int(depth))
        self.device = device
        self.place_fn = place_fn
        self.timeline = timeline
        self._stop: Optional[threading.Event] = None
        self._threads: List[threading.Thread] = []

    def _place(self, batch: Any) -> Any:
        if self.place_fn is not None:
            return self.place_fn(batch)
        return _to_device(batch, self.device)

    def __iter__(self):
        self.close()  # a fresh iteration owns fresh threads/queues
        it = iter(self.loader)
        self._capture_base()
        stop = threading.Event()
        self._stop = stop
        loaded: "queue.Queue" = queue.Queue(maxsize=self.depth)
        placed: "queue.Queue" = queue.Queue(maxsize=self.depth)
        threads = [
            threading.Thread(
                target=_load_worker, args=(it, loaded, stop),
                daemon=True, name="ds-prefetch-load",
            ),
            threading.Thread(
                target=_place_worker, args=(self._place, loaded, placed, stop),
                daemon=True, name="ds-prefetch-place",
            ),
        ]
        self._threads = threads
        for t in threads:
            t.start()
        return self._consume(placed)

    def _consume(self, placed: "queue.Queue"):
        try:
            while True:
                t0 = time.perf_counter()
                item = placed.get()
                if self.timeline is not None:
                    self.timeline.note("data_wait", time.perf_counter() - t0)
                if isinstance(item, _End):
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                self._served += 1
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the pipeline threads (idempotent; runs automatically when
        iteration ends or the consumer breaks out)."""
        if self._stop is not None:
            self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        self._stop = None

    def __len__(self):
        try:
            return len(self.loader)
        except TypeError:
            raise TypeError("wrapped loader is a generator with no len()") from None


class InlineLoader:
    """The unoverlapped fallback (``overlap.prefetch.enabled = false``):
    same interface as :class:`DevicePrefetcher` — re-iterable, with
    ``__len__`` — but synchronous load + place on the consumer thread,
    so swapping the knob never changes iteration semantics."""

    def __init__(
        self,
        loader: Iterable,
        place_fn: Callable[[Any], Any],
        timeline: Any = None,
        sanitizer: Any = None,
    ):
        _not_ported_sanitizer(sanitizer)
        self.loader = loader
        self.place_fn = place_fn
        self.timeline = timeline

    def state_dict(self) -> Optional[dict]:
        # synchronous wrap: the inner cursor tracks consumption exactly
        fn = getattr(self.loader, "state_dict", None)
        return dict(fn()) if fn is not None else None

    def load_state_dict(self, sd: dict) -> None:
        fn = getattr(self.loader, "load_state_dict", None)
        if fn is not None:
            fn(sd)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            out = self.place_fn(batch)
            if self.timeline is not None:
                self.timeline.note("data_wait", time.perf_counter() - t0)
            yield out

    def __len__(self):
        try:
            return len(self.loader)
        except TypeError:
            raise TypeError("wrapped loader is a generator with no len()") from None


def inline_loader(loader: Iterable, place_fn: Callable[[Any], Any], timeline: Any = None):
    """Back-compat alias for :class:`InlineLoader`."""
    return InlineLoader(loader, place_fn, timeline=timeline)
