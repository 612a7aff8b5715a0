"""Wall clock timers and throughput accounting (counterpart of
``deepspeed_tpu/utils/timer.py``).

``SynchronizedWallClockTimer`` (the reference's ``deepspeed/utils/timer.py``
:19) names timers around regions of a step.  CUDA launches are
asynchronous, so on the card a timer records a ``torch.cuda.Event`` on the
current stream at ``start`` and at ``stop`` and reads their elapsed time
only when it is asked (``elapsed``, ``log``, ``get_mean``: the report
cadence).  Nothing here calls ``torch.cuda.synchronize()`` on ``start`` or
``stop``; reading a pair waits for its end event, once per report.  Off
the card the timers read the host clock.

``ThroughputTimer`` mirrors the reference's samples/sec logger (:100): it
waits for the card only on the steps it reports (one event wait a report
window), as the JAX timer blocks only there.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_TIMER = "forward"
BACKWARD_TIMER = "backward"
STEP_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _on_card(device) -> bool:
    return device is not None and getattr(device, "type", str(device)) == "cuda"


def _event():
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Timer:
    """One named timer: CUDA event pairs on the card (read at report
    time), host-clock intervals otherwise."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.started = False
        self._cuda = _on_card(device)
        self._start = None
        self._pairs: List[tuple] = []
        self._elapsed = 0.0

    def start(self) -> None:
        assert not self.started, f"timer {self.name} already started"
        self._start = _event() if self._cuda else time.perf_counter()
        self.started = True

    def stop(self, record: bool = True) -> None:
        assert self.started, f"timer {self.name} not started"
        if record:
            if self._cuda:
                self._pairs.append((self._start, _event()))
            else:
                self._elapsed += time.perf_counter() - self._start
        self.started = False

    def reset(self) -> None:
        self.started = False
        self._pairs = []
        self._elapsed = 0.0

    def elapsed(self, reset: bool = True) -> float:
        """Seconds recorded so far (an interval in flight is not counted);
        on the card this waits for the last recorded event."""
        value = self._elapsed
        if self._pairs:
            self._pairs[-1][1].synchronize()
            value += sum(s.elapsed_time(e) for s, e in self._pairs) / 1e3
        if reset:
            self._pairs = []
            self._elapsed = 0.0
        return value


class SynchronizedWallClockTimer:
    """Named timers on ``device`` (CUDA events on the card)."""

    def __init__(self, device=None):
        self.device = device
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.device)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True, ranks=None) -> None:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                ms = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {ms:.2f}ms")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks)

    def get_mean(self, names: List[str], normalizer: float = 1.0, reset: bool = True) -> Dict[str, float]:
        out = {}
        for name in names:
            if name in self.timers:
                out[name] = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
        return out


class ThroughputTimer:
    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 monitor_memory: bool = False, logging_fn=None, device=None):
        self.start_time = 0.0
        self.end_time = 0.0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg))
        self._cuda = _on_card(device)
        self._window_start = 0.0
        self._window_step0 = 0

    def update_epoch_count(self) -> None:
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self) -> None:
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.time()

    def stop(self, report_speed: bool = True) -> None:
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        self.global_step_count += 1
        if self.start_time > 0:
            # wait for the card only on reporting steps: the telescoped sum
            # over a report window stays right without per-step waits
            will_report = report_speed and self.global_step_count % self.steps_per_output == 0
            if will_report and self._cuda:
                _event().synchronize()
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            if will_report:
                # "current" speed over the whole report window — per-step
                # durations are meaningless without per-step waits
                window = self.end_time - self._window_start if self._window_start else duration
                window_steps = self.global_step_count - self._window_step0
                self.logging(
                    f"epoch={self.epoch_count}/micro_step={self.micro_step_count}/"
                    f"global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.3f}, "
                    f"CurrSamplesPerSec={self.batch_size * window_steps / max(window, 1e-9):.3f}"
                )
                self._window_start = self.end_time
                self._window_step0 = self.global_step_count

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            samples = self.batch_size * (self.global_step_count - self.start_step)
            return samples / self.total_elapsed_time
        return float("nan")
