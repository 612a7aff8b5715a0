"""NVMe optimizer-state swapping (counterpart of
``deepspeed_tpu/runtime/swap/optimizer_swapper.py``): the Adam moments of
N parameter groups live on disk and stream in and out around each group's
update, so host memory holds a small working set (the reference's
``pipelined_optimizer_swapper.py:60``).

While group ``i`` steps, group ``i+1``'s moments are being read
(``prefetch``) and group ``i-1``'s written back (``put``).  The buffers a
write-back owned return to a spare list at :meth:`flush` (every request
complete), and later reads of the same shape reuse them: after the first
step no buffer is allocated.
"""
from __future__ import annotations

import os
from typing import Dict, List

import torch

from deepspeed_tpu_torch.runtime.swap.async_swapper import AsyncTensorSwapper


class PipelinedOptimizerSwapper:
    """``get(i)`` returns group i's ``{"m", "v"}`` host tensors
    (prefetched if the pipeline was primed), ``put(i)`` schedules their
    write-back, ``prefetch(i)`` starts an async read, ``flush()`` completes
    all I/O."""

    def __init__(self, swap_dir: str, shapes: List[tuple], aio_config=None, pipeline: bool = True):
        self.swapper = AsyncTensorSwapper(os.path.join(swap_dir, "optimizer"), aio_config=aio_config)
        self.shapes = [tuple(s) for s in shapes]
        self.pipeline = pipeline
        self._resident: Dict[int, Dict[str, torch.Tensor]] = {}
        self._prefetching: Dict[int, Dict[str, torch.Tensor]] = {}
        self._initialized = set()
        self._written: List[torch.Tensor] = []
        self._spare: Dict[tuple, List[torch.Tensor]] = {}

    def _keys(self, i: int):
        return (f"group{i}_m", f"group{i}_v")

    def _buffer(self, i: int) -> torch.Tensor:
        spare = self._spare.get(self.shapes[i])
        return spare.pop() if spare else torch.empty(self.shapes[i], dtype=torch.float32)

    def _read(self, i: int) -> Dict[str, torch.Tensor]:
        km, kv = self._keys(i)
        return {"m": self.swapper.swap_in(km, out=self._buffer(i), async_op=True),
                "v": self.swapper.swap_in(kv, out=self._buffer(i), async_op=True)}

    def initialize_group(self, i: int) -> None:
        """First touch: the moments start as zeros (written at the first put)."""
        self._resident[i] = {"m": self._buffer(i).zero_(), "v": self._buffer(i).zero_()}
        self._initialized.add(i)

    def prefetch(self, i: int) -> None:
        if i in self._resident or i in self._prefetching:
            return
        if i not in self._initialized:
            self.initialize_group(i)
            return
        self._prefetching[i] = self._read(i)

    def get(self, i: int) -> Dict[str, torch.Tensor]:
        if i in self._resident:
            return self._resident[i]
        if i in self._prefetching:
            self.swapper.synchronize_reads()
            self._resident[i] = self._prefetching.pop(i)
            return self._resident[i]
        if i not in self._initialized:
            self.initialize_group(i)
            return self._resident[i]
        bufs = self._read(i)
        self.swapper.synchronize_reads()
        self._resident[i] = bufs
        return bufs

    def put(self, i: int) -> None:
        """Schedule the write-back of group i's moments; they leave the
        working set."""
        bufs = self._resident.pop(i, None)
        if bufs is None:
            return
        km, kv = self._keys(i)
        self.swapper.swap_out(km, bufs["m"], async_op=self.pipeline)
        self.swapper.swap_out(kv, bufs["v"], async_op=self.pipeline)
        self._written += [bufs["m"], bufs["v"]]

    def flush(self) -> None:
        self.swapper.synchronize()
        for t in self._written:
            self._spare.setdefault(tuple(t.shape), []).append(t)
        self._written = []

    # -- checkpoint support ---------------------------------------------
    def load_group(self, i: int, m: torch.Tensor, v: torch.Tensor) -> None:
        if self._prefetching.pop(i, None) is not None:
            self.swapper.synchronize_reads()  # no read may land in a dropped buffer
        self._resident[i] = {"m": m.to(torch.float32).contiguous().clone(),
                             "v": v.to(torch.float32).contiguous().clone()}
        self._initialized.add(i)
