"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

Host-side batching of an indexable dataset with a resumable cursor: the
checkpoint's client state records ``(epoch, cursor, seed)``, so a
restarted job neither replays nor skips batches.  The shuffle is
``np.random.default_rng(seed + epoch)``, so the permutations are the JAX
package's.  ``process_index`` and ``process_count`` default to this
rank's place in the data-parallel grid (``data x fsdp``) of the started
process group, 0 and 1 without one: each rank takes its own contiguous
slice of every epoch's permutation, as the JAX loader slices per
process.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.engine import tree_flatten


class RepeatingLoader:
    """Wrap an iterator to auto-restart at StopIteration."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def __len__(self):
        return len(self.loader)


class DeepSpeedDataLoader:
    """Batches an indexable dataset of trees/arrays.

    ``dataset`` may be: a dict/tuple of equal-length numpy arrays, or a
    sequence of per-example trees (collated by stacking).  Yields host
    numpy batches of size ``batch_size``; the engine places them on the
    card (``engine.prefetch_loader`` does so ahead of the step).
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        collate_fn: Optional[Callable] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        from deepspeed_tpu_torch.comm import distributed

        if process_index is None:
            process_index = distributed.get_rank()
        if process_count is None:
            process_count = distributed.get_world_size()
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        # resumable-cursor state: the cursor counts batches YIELDED in the
        # current iteration; load_state_dict arms a skip for the next
        # __iter__.
        self._cursor = 0
        self._start = 0

        # Columnar = dict (or tuple) of equal-length arrays, one row per
        # example.  A *list* is always treated as a sequence of per-example
        # trees — a list of equal-shape arrays is ambiguous, and rows win.
        columns = tree_flatten(dataset)[0] if isinstance(dataset, (dict, tuple)) else []
        self._columnar = bool(columns) and all(isinstance(x, np.ndarray) for x in columns)
        if self._columnar:
            lengths = {len(x) for x in columns}
            if len(lengths) != 1:
                raise ValueError(f"columnar dataset has unequal column lengths: {sorted(lengths)}")
            self._n = lengths.pop()
        else:
            self._n = len(dataset)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def state_dict(self) -> dict:
        """Resume cursor: epoch + batches yielded this iteration + the
        shuffle seed (the epoch's generator is seeded ``seed + epoch``, so
        (seed, epoch) IS the shuffle's random state)."""
        return {"epoch": int(self.epoch), "cursor": int(self._cursor), "seed": int(self.seed)}

    def load_state_dict(self, sd: dict) -> None:
        """Restore a cursor saved by :meth:`state_dict`: the next
        ``__iter__`` recreates the same permutation and skips the
        already-consumed batches — no replays, no skips."""
        self.epoch = int(sd.get("epoch", 0))
        self.seed = int(sd.get("seed", self.seed))
        self._start = int(sd.get("cursor", 0))
        self._cursor = self._start

    def __len__(self) -> int:
        per_proc = self._n // self.process_count
        if self.drop_last:
            return per_proc // self.batch_size
        return math.ceil(per_proc / self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        # eager prologue (the cursor reset must happen at iter() time,
        # not first next(): wrappers read the cursor between the two)
        start, self._start = self._start, 0
        self._cursor = start
        idx = np.arange(self._n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        # contiguous per-process shard (DistributedSampler semantics)
        per_proc = self._n // self.process_count
        idx = idx[self.process_index * per_proc: (self.process_index + 1) * per_proc]
        return self._generate(idx, start)

    def _generate(self, idx: np.ndarray, start: int) -> Iterator[Any]:
        for b in range(start, len(self)):
            sel = idx[b * self.batch_size: (b + 1) * self.batch_size]
            if len(sel) == 0:
                return
            if self._columnar:
                leaves, rebuild = tree_flatten(self.dataset)
                batch = rebuild([col[sel] for col in leaves])
            else:
                examples = [self.dataset[int(i)] for i in sel]
                if self.collate_fn is not None:
                    batch = self.collate_fn(examples)
                else:
                    columns = zip(*(tree_flatten(e)[0] for e in examples))
                    batch = tree_flatten(examples[0])[1]([np.stack(xs) for xs in columns])
            # cursor advances at hand-off: a checkpoint taken after this
            # batch's step must resume at b + 1
            self._cursor = b + 1
            yield batch


class ResumableWrapperMixin:
    """Consumed-cursor bookkeeping shared by loader wrappers that pull
    AHEAD of training (``DevicePrefetchLoader`` here, the overlap
    ``DevicePrefetcher``): the checkpointable cursor is the inner
    loader's cursor at iteration start plus the batches actually handed
    to training — never the inner loader's own cursor, which runs ahead
    by up to the prefetch depth.  Wrappers call :meth:`_capture_base`
    right after ``iter(self.loader)`` (the inner loader's eager prologue
    has applied any resume skip by then) and bump ``_served`` at each
    yield."""

    _served = 0
    _base_state: Optional[dict] = None

    def _capture_base(self) -> None:
        fn = getattr(self.loader, "state_dict", None)
        self._base_state = dict(fn()) if fn is not None else None
        self._served = 0

    def state_dict(self) -> Optional[dict]:
        """None when the wrapped loader has no state protocol (the
        checkpoint then simply carries no resume cursor)."""
        if self._base_state is not None:
            base = dict(self._base_state)
            base["cursor"] = int(base.get("cursor", 0)) + self._served
            return base
        fn = getattr(self.loader, "state_dict", None)
        return dict(fn()) if fn is not None else None

    def load_state_dict(self, sd: dict) -> None:
        fn = getattr(self.loader, "load_state_dict", None)
        if fn is None:
            return
        fn(sd)
        self._served = 0
        self._base_state = None


class DevicePrefetchLoader(ResumableWrapperMixin):
    """Wraps any batch iterator with ahead-of-time placement on a device
    (``prefetch_depth`` batches in flight on one worker thread).

    ``engine.prefetch_loader`` routes through the two-stage pipelined
    ``runtime.overlap.DevicePrefetcher``, which also copies on a side CUDA
    stream; this single-worker wrapper stays for direct users of a plain
    placement.  ``transform`` (host batch -> placed batch) overrides the
    default, which moves every array leaf to ``device``.
    """

    def __init__(self, loader: Iterable, prefetch_depth: int = 2, device: Any = None,
                 transform: Optional[Callable[[Any], Any]] = None):
        self.loader = loader
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.device = device
        self.transform = transform

    def __iter__(self):
        it = iter(self.loader)
        self._capture_base()
        return self._pipeline(it)

    def _put(self, batch: Any) -> Any:
        if self.transform is not None:
            return self.transform(batch)
        leaves, rebuild = tree_flatten(batch)
        return rebuild([torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
                        .to(self.device) for x in leaves])

    def _pipeline(self, it):
        import collections
        from concurrent.futures import ThreadPoolExecutor

        queue = collections.deque()
        with ThreadPoolExecutor(max_workers=1) as pool:
            try:
                for _ in range(self.prefetch_depth):
                    queue.append(pool.submit(self._put, next(it)))
            except StopIteration:
                pass
            while queue:
                out = queue.popleft()
                try:
                    queue.append(pool.submit(self._put, next(it)))
                except StopIteration:
                    pass
                result = out.result()
                self._served += 1
                yield result

    def __len__(self):
        try:
            return len(self.loader)
        except TypeError:
            raise TypeError("wrapped loader is a generator with no len()") from None
