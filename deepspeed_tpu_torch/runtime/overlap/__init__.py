"""Overlap subsystem (counterpart of ``deepspeed_tpu/runtime/overlap``):
keep the card busy while the host moves bytes.

* :mod:`~deepspeed_tpu_torch.runtime.overlap.prefetch` —
  :class:`DevicePrefetcher`, a two-stage (load / place) pipelined input
  prefetcher (``engine.prefetch_loader`` routes here; the engine's place
  stage copies from pinned memory on a CUDA stream of its own);
* :mod:`~deepspeed_tpu_torch.runtime.overlap.async_writer` —
  :class:`AsyncCheckpointWriter`, background stage->manifest->rename
  checkpoint commits with drain semantics (``overlap.async_checkpoint``
  config block; the durability contract is unchanged);
* :mod:`~deepspeed_tpu_torch.runtime.overlap.timeline` —
  :class:`StepTimeline`, honest (fenced) per-step attribution of wall
  time to ``data_wait`` / ``compute`` / ``ckpt_stall`` / ``compile`` /
  ``other``;
* :mod:`~deepspeed_tpu_torch.runtime.overlap.worker` —
  :class:`BoundedWorker`, the shared bounded-queue background thread.
"""
from deepspeed_tpu_torch.runtime.overlap.async_writer import (  # noqa: F401
    AsyncCheckpointWriter,
    PendingSave,
)
from deepspeed_tpu_torch.runtime.overlap.prefetch import (  # noqa: F401
    DevicePrefetcher,
    InlineLoader,
    inline_loader,
)
from deepspeed_tpu_torch.runtime.overlap.timeline import PHASES, StepTimeline  # noqa: F401
from deepspeed_tpu_torch.runtime.overlap.worker import BoundedWorker  # noqa: F401
