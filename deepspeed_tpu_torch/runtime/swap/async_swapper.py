"""Async tensor swapping (counterpart of
``deepspeed_tpu/runtime/swap/async_swapper.py``): the ZeRO-Infinity
building block that moves host tensors to and from files through the aio
engine (``ops/aio/aio.py``), overlapping the I/O with compute.

Each logical tensor maps to one file in the swap folder.  Reads ride one
aio handle; writes ride a small fixed pool of handles (keys hash to
slots), so a ``swap_in`` of a key whose write is still in flight waits for
that key's slot only, and other keys' writes stay in flight (the
reference's double-buffered pattern, ``pipelined_optimizer_swapper.py:60``).
An injected ``aio_handle`` serves every request, at the cost of waiting on
everything at once.

Tensors are contiguous CPU tensors; ``swap_in`` allocates its buffer
unless ``out`` is given.  An async write owns its tensor until the write
completes: the engine reads it from its own threads.
"""
from __future__ import annotations

import os
import zlib
from typing import Dict, Optional

import torch

from deepspeed_tpu_torch.ops.aio.aio import AioHandle


class AsyncTensorSwapper:
    _WRITE_POOL = 4

    def __init__(self, swap_dir: str, aio_handle: Optional[AioHandle] = None, aio_config=None):
        os.makedirs(swap_dir, exist_ok=True)
        self.swap_dir = swap_dir
        kw = {}
        if aio_config is not None:
            kw = dict(block_size=aio_config.block_size, queue_depth=aio_config.queue_depth,
                      single_submit=aio_config.single_submit,
                      overlap_events=aio_config.overlap_events,
                      thread_count=max(1, aio_config.thread_count))
        self._handle_kw = kw
        self._injected = aio_handle is not None
        self.aio = aio_handle if aio_handle is not None else AioHandle(**kw)
        # per-slot wait granularity: with more writers than slots a swap_in
        # may wait on an unrelated key's write that hashed to its slot
        self._write_handles: Dict[int, AioHandle] = {}
        self._index: Dict[str, tuple] = {}  # key -> (path, shape, dtype)
        self._pending_reads = 0
        self._inflight_writes: Dict[str, torch.Tensor] = {}

    def _path(self, key: str) -> str:
        return os.path.join(self.swap_dir, f"{key.replace('/', '__')}.swp")

    def _slot(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self._WRITE_POOL

    def _write_handle(self, key: str) -> AioHandle:
        if self._injected:
            return self.aio
        s = self._slot(key)
        h = self._write_handles.get(s)
        if h is None:
            h = self._write_handles[s] = AioHandle(**self._handle_kw)
        return h

    @property
    def used_kernel_aio(self) -> bool:
        return any(h.used_kernel_aio for h in (self.aio, *self._write_handles.values()))

    def swap_out(self, key: str, tensor: torch.Tensor, async_op: bool = True) -> None:
        """Write ``tensor`` to ``key``'s file.  With ``async_op`` the
        swapper owns ``tensor`` until the write lands."""
        if key in self._inflight_writes:
            self.synchronize_writes(key)  # never two writes in flight on one file
        t = tensor.contiguous()
        path = self._path(key)
        self._index[key] = (path, tuple(t.shape), t.dtype)
        self._inflight_writes[key] = t
        self._write_handle(key).async_pwrite(t, path)
        if not async_op:
            self.synchronize_writes(key)

    def swap_in(self, key: str, out: Optional[torch.Tensor] = None,
                async_op: bool = True) -> torch.Tensor:
        """Read ``key`` into ``out`` (allocated if None).  With ``async_op``
        the bytes are valid only after :meth:`synchronize_reads`."""
        if key not in self._index:
            raise KeyError(f"tensor '{key}' was never swapped out")
        if key in self._inflight_writes:
            # read after write: this key's bytes are still in flight
            self.synchronize_writes(key)
        path, shape, dtype = self._index[key]
        if out is None:
            out = torch.empty(shape, dtype=dtype)
        want = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        if out.numel() * out.element_size() != want:
            raise ValueError(f"swap_in '{key}': buffer of {out.numel() * out.element_size()} "
                             f"bytes for {want}")
        self.aio.async_pread(out, path)
        self._pending_reads += 1
        if not async_op:
            self.synchronize()
        return out

    def synchronize_writes(self, key: Optional[str] = None) -> int:
        """Complete the write in flight for ``key`` (every write when
        None).  Waiting on a key's slot completes every write of that
        slot."""
        if key is None:
            return sum(self.synchronize_writes(k) for k in list(self._inflight_writes))
        if key not in self._inflight_writes:
            return 0
        n = self._write_handle(key).wait()
        if self._injected:
            self._inflight_writes.clear()
            self._pending_reads = 0
        else:
            s = self._slot(key)
            for k in [k for k in self._inflight_writes if self._slot(k) == s]:
                self._inflight_writes.pop(k, None)
        return n

    def synchronize_reads(self) -> int:
        """Complete every read in flight (writes stay in flight, unless a
        shared injected handle carries them too)."""
        if not self._pending_reads:
            return 0
        n = self.aio.wait()
        self._pending_reads = 0
        if self._injected:
            self._inflight_writes.clear()
        return n

    def synchronize(self) -> int:
        return self.synchronize_reads() + self.synchronize_writes()

    def release(self, key: str) -> None:
        if key in self._inflight_writes:
            self.synchronize_writes(key)
        info = self._index.pop(key, None)
        if info and os.path.exists(info[0]):
            os.unlink(info[0])

