"""Training metrics monitor (TensorBoard; counterpart of
``deepspeed_tpu/utils/monitor.py``).

Reference: the engine's tensorboardX summary-writer integration
(``engine.py:285-320`` config, ``:1178-1188`` loss events, ``:1356-1382``
lr/scale events; writer only on global rank 0) emitting
``Train/Samples/{train_loss,lr,loss_scale,elapsed_time_ms_*}``.

Uses ``torch.utils.tensorboard`` when it imports (it needs the
``tensorboard`` package, which a machine may lack); otherwise falls back
to a JSONL event log (``events.jsonl``) with the same tags so metrics are
never silently dropped.

Lifecycle: every constructed monitor registers an atexit flush+close —
the JSONL fallback handle (and a buffering SummaryWriter) must not be
dropped unflushed when the process dies between report cadences.
``close()`` is idempotent and unregisters the hook.

In the telemetry plane this class is a *sink*: the engine publishes
through the metrics registry and the manager forwards the reference
``Train/Samples/*`` tags here.
"""
from __future__ import annotations

import atexit
import json
import os
import time
from typing import Optional

from deepspeed_tpu_torch.utils.logging import logger


class TensorBoardMonitor:
    def __init__(self, output_path: str = "", job_name: str = "DeepSpeedJobName", enabled: bool = True, rank: int = 0):
        self.enabled = enabled and rank == 0
        self._writer = None
        self._jsonl = None
        self._closed = False
        if not self.enabled:
            return
        out_dir = os.path.join(output_path or "runs", job_name)
        os.makedirs(out_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=out_dir)
        except Exception as e:
            self._jsonl = open(os.path.join(out_dir, "events.jsonl"), "a")
            logger.warning(f"monitor: tensorboard unavailable ({e}); writing JSONL events to {out_dir}")
        atexit.register(self.close)

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        if not self.enabled:
            return
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(global_step))
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(global_step), "ts": time.time()}) + "\n")
            self._jsonl.flush()

    def write_events(self, events, global_step: int) -> None:
        """``events``: [(tag, value), ...] — reference summary_events shape."""
        for tag, value in events:
            self.add_scalar(tag, value, global_step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()
        elif self._jsonl is not None and not self._jsonl.closed:
            self._jsonl.flush()

    def close(self) -> None:
        """Flush + close both backends; idempotent (called by the
        engine, the telemetry shutdown, AND atexit — whichever first)."""
        if self._closed:
            return
        self._closed = True
        try:
            atexit.unregister(self.close)
        except Exception:  # pragma: no cover - interpreter teardown
            pass
        if self._writer is not None:
            self._writer.close()
        if self._jsonl is not None and not self._jsonl.closed:
            self._jsonl.close()
