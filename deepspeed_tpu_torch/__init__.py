"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for an
NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths
and names.  The kernels the JAX package wrote in Pallas for the TPU are
CUDA C++ kernels here (``csrc/``), built with ``nvcc`` at first use.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel takes its plain PyTorch version.
"""
from __future__ import annotations

from deepspeed_tpu_torch.version import __version__


def init_inference(model=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (``device`` defaults to ``"cuda"``; it raises when there is no card)."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model=model, **kwargs)


def init_serving(model=None, serving=None, **kwargs):
    """A continuous-batching ServingEngine over an :func:`init_inference`
    engine.  ``serving`` is the ``serving`` config block (dict or
    ServingConfig); remaining kwargs go to ``init_inference``."""
    from deepspeed_tpu_torch.serving import ServingEngine

    return ServingEngine(init_inference(model=model, **kwargs), config=serving)


__all__ = ["__version__", "init_inference", "init_serving"]
