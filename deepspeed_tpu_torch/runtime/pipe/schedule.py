"""Pipeline schedules as pure instruction streams (counterpart of
``deepspeed_tpu/runtime/pipe/schedule.py``, copied as it is: pure Python).

Reference ``runtime/pipe/schedule.py``: PipeSchedule :6, TrainSchedule
:182 (the 1F1B interleave), InferenceSchedule :129, DataParallelSchedule
:292, and the instructions :336-476.

Where the JAX package compiles a whole pipelined batch into one program
and keeps these streams as the semantics that program must meet, the
port's ``runtime/pipe/engine.py`` interprets them: each ``pipe`` rank runs
its own stage's stream, with point-to-point transfers between stages.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

from deepspeed_tpu_torch.runtime.utils import call_to_str


def _is_even(x: int) -> bool:
    return x % 2 == 0


def _is_odd(x: int) -> bool:
    return x % 2 != 0


class PipeInstruction:
    """Atomic action a pipeline stage executes in one schedule step.

    Keyword args are stored as attributes (reference schedule.py:336)."""

    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        return call_to_str(self.name, **self.kwargs)

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Optimizer update + zero grads (after Reduce*Grads)."""


class ReduceGrads(PipeInstruction):
    """Data-parallel gradient reduction within the stage."""


class ReduceTiedGrads(PipeInstruction):
    """All-reduce grads of tied modules across the stages that own them."""


class BufferOpInstruction(PipeInstruction):
    """Instruction operating on one of the stage's pipeline buffers."""

    def __init__(self, buffer_id: int, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """Load a micro-batch into ``buffer_id`` (first/last stages)."""


class ForwardPass(BufferOpInstruction):
    """Compute a forward pass on the activation in ``buffer_id``."""


class BackwardPass(BufferOpInstruction):
    """Compute a backward pass for the activation in ``buffer_id``."""


class SendActivation(BufferOpInstruction):
    """Send activations in ``buffer_id`` to the next stage."""


class RecvActivation(BufferOpInstruction):
    """Receive activations from the previous stage into ``buffer_id``."""


class SendGrad(BufferOpInstruction):
    """Send input-activation grads in ``buffer_id`` to the previous stage."""


class RecvGrad(BufferOpInstruction):
    """Receive output-activation grads into ``buffer_id``."""


class PipeSchedule(ABC):
    """Generates, per schedule step, the instruction list one stage runs.

    Steps are atomic: a barrier may be placed between successive yielded
    lists without deadlock (reference schedule.py:6-42)."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @abstractmethod
    def steps(self):
        """Yield a list of :class:`PipeInstruction` per step."""

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id: int) -> bool:
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id: int) -> bool:
        return 0 <= stage_id < self.stages

    @property
    def stage(self) -> int:
        return self.stage_id

    @property
    def num_stages(self) -> int:
        return self.stages

    @property
    def num_micro_batches(self) -> int:
        return self.micro_batches

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id: int) -> int:
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        return iter(self.steps())

    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule — (S-1)/(M+S-1) for 1F1B/GPipe."""
        m, s = self.micro_batches, self.stages
        return (s - 1) / (m + s - 1) if m + s > 1 else 0.0


class InferenceSchedule(PipeSchedule):
    """Forward-only pipelining with two alternating buffers
    (reference schedule.py:129-180)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id

            if _is_even(self.stage_id):
                recv_buf = step_id % 2
                send_buf = (step_id + 1) % 2
            else:
                recv_buf = (step_id + 1) % 2
                send_buf = step_id % 2

            if (self.is_first_stage or self.is_last_stage) and self._valid_micro_batch(micro_batch_id):
                cmds.append(LoadMicroBatch(recv_buf))

            # Even stages send first, odd stages receive first: pairs up
            # sends/recvs without deadlock under synchronous transports.
            if _is_even(self.stage_id):
                if self._valid_stage(self.next_stage) and self._valid_micro_batch(micro_batch_id - 1):
                    cmds.append(SendActivation(send_buf))
                if self._valid_stage(self.prev_stage) and self._valid_micro_batch(micro_batch_id):
                    cmds.append(RecvActivation(recv_buf))
            else:
                if self._valid_stage(self.prev_stage) and self._valid_micro_batch(micro_batch_id):
                    cmds.append(RecvActivation(recv_buf))
                if self._valid_stage(self.next_stage) and self._valid_micro_batch(micro_batch_id - 1):
                    cmds.append(SendActivation(send_buf))

            if self._valid_micro_batch(micro_batch_id):
                cmds.append(ForwardPass(recv_buf))

            yield cmds

    def num_pipe_buffers(self) -> int:
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B interleave (reference schedule.py:182-290): each stage
    alternates forward and backward steps, with earlier stages running
    more warm-up forwards; steady state holds ≤ ``num_pipe_buffers``
    in-flight micro-batches."""

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)

            cmds = []
            curr_buffer = prev_buffer = None
            if self._valid_micro_batch(prev_micro_batch_id):
                prev_buffer = self._buffer_idx(prev_micro_batch_id)
            if self._valid_micro_batch(micro_batch_id):
                curr_buffer = self._buffer_idx(micro_batch_id)

            # Activation / gradient exchange.  On forward steps a stage
            # receives the activation it is about to consume and returns
            # the grad it produced on the previous (backward) step; on
            # backward steps it ships the previous forward's activation
            # downstream and receives the grad it is about to consume.
            if is_forward:
                if curr_buffer is not None and self._valid_stage(self.prev_stage):
                    cmds.append(RecvActivation(curr_buffer))
                if prev_buffer is not None and self._valid_stage(self.prev_stage):
                    cmds.append(SendGrad(prev_buffer))
            else:
                if prev_buffer is not None and self._valid_stage(self.next_stage):
                    cmds.append(SendActivation(prev_buffer))
                if curr_buffer is not None and self._valid_stage(self.next_stage):
                    cmds.append(RecvGrad(curr_buffer))

            if (self.is_first_stage or self.is_last_stage) and is_forward and curr_buffer is not None:
                cmds.append(LoadMicroBatch(curr_buffer))

            if curr_buffer is not None:
                cmds.append(ForwardPass(curr_buffer) if is_forward else BackwardPass(curr_buffer))

            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def num_pipe_buffers(self) -> int:
        buffers = min(self.stages - self.stage_id + 1, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id: int):
        """Map a schedule step to (micro_batch_id, is_forward).  Even
        steps are forwards on even stages / backwards on odd stages and
        vice versa — the parity trick that staggers neighbors so their
        sends/recvs pair up (reference schedule.py:249-290)."""
        if _is_even(step_id) and _is_even(self.stage_id):
            return self._even_step_forward_id(step_id), True
        if _is_odd(step_id) and _is_odd(self.stage_id):
            return self._odd_step_forward_id(step_id), True
        if _is_even(step_id) and _is_odd(self.stage_id):
            return self._even_step_backward_id(step_id), False
        if _is_odd(step_id) and _is_even(self.stage_id):
            return self._odd_step_backward_id(step_id), False
        raise AssertionError("unreachable")

    def _even_step_forward_id(self, step_id: int) -> int:
        return step_id // 2 - self.stage_id // 2

    def _odd_step_forward_id(self, step_id: int) -> int:
        return (step_id - 1) // 2 - self.stage_id // 2

    def _even_step_backward_id(self, step_id: int) -> int:
        return step_id // 2 - self.stages + (self.stage_id + 1) // 2

    def _odd_step_backward_id(self, step_id: int) -> int:
        return (step_id - 1) // 2 - self.stages + 1 + self.stage_id // 2


class DataParallelSchedule(PipeSchedule):
    """Plain gradient-accumulation data parallelism expressed as a
    pipeline schedule (reference schedule.py:292-320)."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [
                LoadMicroBatch(buffer_id=0),
                ForwardPass(buffer_id=0),
                BackwardPass(buffer_id=0),
            ]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self) -> int:
        return 1
