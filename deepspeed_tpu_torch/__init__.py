"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for an
NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths
and names.  ``initialize`` trains (one device), ``init_inference`` and
``init_serving`` serve.  The kernels the JAX package wrote in Pallas for the TPU are
CUDA C++ kernels here (``csrc/``), built with ``nvcc`` at first use.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from deepspeed_tpu_torch.version import __version__


def initialize(
    args=None,
    model: Optional[Callable] = None,
    model_parameters: Any = None,
    optimizer: Any = None,
    training_data: Any = None,
    lr_scheduler: Any = None,
    mesh=None,
    tp_spec_fn=None,
    partition_rules=None,
    loss_fn: Optional[Callable] = None,
    dist_init_required: Optional[bool] = None,
    collate_fn: Optional[Callable] = None,
    config: Any = None,
    config_params: Any = None,
    device: Any = "cuda",
):
    """Build a ready-to-train engine on one device.

    * ``model``: callable ``(params, batch, generator) -> loss`` (or
      outputs if ``loss_fn`` is given); ``generator`` is a
      ``torch.Generator`` in training and None in eval.
    * ``model_parameters``: the initial parameter tree (numpy arrays or
      tensors).
    * ``config``: dict or path to a DeepSpeed-style JSON config.
    * ``device``: ``"cuda"`` (the default; raises when there is no card)
      or ``"cpu"``, where every kernel takes its plain PyTorch version.

    Returns ``(engine, optimizer, None, lr_schedule)``.  A mesh, tensor
    parallelism and partition rules (ROADMAP A6), a data loader from
    ``training_data`` (A5) and pipeline modules (A11) are not ported."""
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig, DeepSpeedConfigError
    from deepspeed_tpu_torch.inference.engine import resolve_device
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    device = resolve_device(device)
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if config is None:
        raise DeepSpeedConfigError("initialize() needs `config` (dict or json path)")
    if model is None:
        raise ValueError("initialize() needs `model` (callable (params, batch, generator) -> loss/outputs)")
    if model_parameters is None:
        raise ValueError("initialize() needs `model_parameters` (initial parameter tree)")
    if mesh is not None or tp_spec_fn is not None or partition_rules is not None:
        raise NotImplementedError(
            "meshes, tensor parallelism and partition rules are not ported yet (ROADMAP A6); "
            "the port trains on one device")
    if training_data is not None:
        raise NotImplementedError("initialize(training_data=...) is not ported yet (ROADMAP A5 "
                                  "runtime/dataloader.py)")
    engine = DeepSpeedEngine(
        model=model, params=model_parameters, config=DeepSpeedConfig(config),
        optimizer=optimizer, lr_scheduler=lr_scheduler, loss_fn=loss_fn, device=device,
    )
    return engine, engine.optimizer, None, engine.lr_schedule


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


__all__ = ["__version__", "initialize", "init_inference", "init_serving"]
