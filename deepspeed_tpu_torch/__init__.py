"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for an
NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths
and names.  ``initialize`` trains (one device, or ZeRO 0-3, tensor,
sequence and expert parallelism and pipeline stages across the ranks of a
``torch.distributed`` group),
``init_inference`` and ``init_serving`` serve (one device, or tensor
parallel over ``mp_size`` ranks of a group).  The kernels the JAX
package wrote in Pallas for the TPU are CUDA C++ kernels here
(``csrc/``), built with ``nvcc`` at first use.
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
    mesh_check: Optional[Callable] = None,
    comm_model: Optional[Callable] = None,
    loss_fn: Optional[Callable] = None,
    dist_init_required: Optional[bool] = None,
    collate_fn: Optional[Callable] = None,
    config: Any = None,
    config_params: Any = None,
    device: Any = "cuda",
):
    """Build a ready-to-train engine, on one device or on every rank of a
    process group.

    Under a launcher (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment) this starts
    ``torch.distributed`` first (``comm.distributed.init_distributed``:
    NCCL for ``device="cuda"``, gloo for the CPU), unless
    ``dist_init_required`` is False; every rank then calls
    ``initialize`` with the same arguments and trains on its own rows.

    * ``model``: callable ``(params, batch, generator) -> loss`` (or
      outputs if ``loss_fn`` is given); ``generator`` is a
      ``torch.Generator`` in training and None in eval.
    * ``model_parameters``: the initial parameter tree (numpy arrays or
      tensors).
    * ``config``: dict or path to a DeepSpeed-style JSON config.
    * ``device``: ``"cuda"`` (the default; raises when there is no card)
      or ``"cpu"``, where every kernel takes its plain PyTorch version.

    * ``training_data``: a dataset for a
      :class:`~deepspeed_tpu_torch.runtime.dataloader.DeepSpeedDataLoader`
      (a dict/tuple of equal-length numpy arrays, or a sequence of
      examples batched by ``collate_fn``), shuffled from the config's
      ``seed``, in batches of ``train_micro_batch_size_per_gpu``, dropping
      the last partial batch per ``dataloader_drop_last``.

    * ``mesh``: the port's mesh, a ``mesh`` config dict or a
      ``MeshConfig`` (default: the config's ``mesh`` block over the
      group: ``data x fsdp x seq x model``); ``tp_spec_fn`` /
      ``partition_rules``: the JAX engine's layout inputs, which a
      ``model`` axis above 1 needs (``make_model``'s third value);
      ``mesh_check`` / ``comm_model``: the model's refusals of a mesh and
      its activation collectives' byte model (``gpt2.check_mesh`` /
      ``gpt2.parallel_comm_model`` and BERT's, bound to the config with
      ``functools.partial``).

    * A :class:`~deepspeed_tpu_torch.runtime.pipe.PipelineModule` as
      ``model`` builds a
      :class:`~deepspeed_tpu_torch.runtime.pipe.engine.PipelineEngine`
      (``model_parameters`` optional: the module builds them from the
      config's ``seed``); a ``loss_fn`` here becomes the module's.

    * ``zero_optimization.offload_optimizer.device`` ``cpu`` / ``nvme``
      keeps the f32 masters and Adam moments on the host (ZeRO-Offload,
      ``runtime/zero/offload.py``); ``offload_param.device`` ``cpu`` /
      ``nvme`` builds a
      :class:`~deepspeed_tpu_torch.runtime.zero.param_offload.ZeroInfinityEngine`
      that streams one layer group at a time through the card, for a
      model with a ``stream_spec`` (``gpt2.make_model``'s); a model or
      config that cannot stream falls back to the in-memory engine with a
      warning, unless it would not fit the card.  Across ranks each rank
      keeps its own part of the masters and moments: a flat 1/P slice in
      the in-memory engine, its ``fsdp`` part of every block leaf in the
      streaming one.

    Returns ``(engine, optimizer, loader, lr_schedule)``, the loader None
    without ``training_data``; it hands each data-parallel rank its own
    slice of every epoch."""
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig, DeepSpeedConfigError
    from deepspeed_tpu_torch.utils.device import resolve_device
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    device = resolve_device(device)
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if config is None:
        raise DeepSpeedConfigError("initialize() needs `config` (dict or json path)")
    if model is None:
        raise ValueError("initialize() needs `model` (callable (params, batch, generator) -> loss/outputs)")
    is_pipe = isinstance(model, PipelineModule)
    if model_parameters is None and not is_pipe:
        raise ValueError("initialize() needs `model_parameters` (initial parameter tree)")
    from deepspeed_tpu_torch.comm.distributed import init_distributed
    from deepspeed_tpu_torch.comm.mesh import Mesh, make_mesh

    if dist_init_required is not False:
        init_distributed(device=device)
    if mesh is not None and not isinstance(mesh, Mesh):
        mesh = make_mesh(mesh)
    ds_config = DeepSpeedConfig(
        config, world_size=None if mesh is None else mesh.sizes["data"] * mesh.sizes["fsdp"])
    stream_reason = "pipeline module" if is_pipe else None
    if not is_pipe and ds_config.zero_config.offload_param.enabled:
        from deepspeed_tpu_torch.runtime.zero.param_offload import ZeroInfinityEngine
        from deepspeed_tpu_torch.utils.logging import logger

        stream_reason = ZeroInfinityEngine.streamable(model, ds_config, optimizer)
        if stream_reason is not None:
            # refuse (not warn-then-run-out-of-memory) a model asked to
            # stream that would not fit the in-memory engine
            ZeroInfinityEngine.check_fallback_fits(model_parameters, ds_config, stream_reason,
                                                   device)
            logger.warning(f"offload_param: falling back to the in-memory engine — {stream_reason}")
    if not is_pipe and ds_config.zero_config.offload_param.enabled and stream_reason is None:
        # ZeRO-Infinity: the parameters exceed the card, so layer groups
        # stream through it (the reference's partitioned_param_swapper.py:36)
        engine = ZeroInfinityEngine(model=model, params=model_parameters, config=ds_config,
                                    lr_scheduler=lr_scheduler, device=device)
    elif is_pipe:
        # the reference's rule (deepspeed/__init__.py:125-149): a
        # PipelineModule trains on a PipelineEngine
        from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

        if loss_fn is not None:
            if model.loss_fn is not None and model.loss_fn is not loss_fn:
                raise ValueError("loss_fn given both to PipelineModule and initialize()")
            model.loss_fn = loss_fn
        engine = PipelineEngine(
            module=model, config=ds_config, mesh=mesh, params=model_parameters,
            optimizer=optimizer, lr_scheduler=lr_scheduler, device=device,
            tp_spec_fn=tp_spec_fn, partition_rules=partition_rules,
            mesh_check=mesh_check, comm_model=comm_model,
        )
    else:
        engine = DeepSpeedEngine(
            model=model, params=model_parameters, config=ds_config,
            optimizer=optimizer, lr_scheduler=lr_scheduler, loss_fn=loss_fn, device=device,
            mesh=mesh, tp_spec_fn=tp_spec_fn, partition_rules=partition_rules,
            mesh_check=mesh_check, comm_model=comm_model,
        )
    loader = None
    if training_data is not None:
        from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

        loader = DeepSpeedDataLoader(
            training_data,
            batch_size=ds_config.train_micro_batch_size_per_gpu,
            shuffle=True,
            seed=ds_config.seed,
            drop_last=ds_config.dataloader_drop_last,
            collate_fn=collate_fn,
            process_index=engine.mesh.chunk_index(("data", "fsdp")) if hasattr(engine, "mesh") else 0,
            process_count=engine.dp_world_size,
        )
    return engine, engine.optimizer, loader, engine.lr_schedule


def init_inference(model=None, **kwargs):
    """Build an :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`
    (``device`` defaults to ``"cuda"``; it raises when there is no card).

    ``mp_size=M`` serves tensor parallel on every rank of a process group
    (started from the launcher environment, as :func:`initialize` starts
    it; call on every rank with the same arguments): a ``model`` rank holds
    its block of every leaf and ``n_head / M`` heads of every KV cache.
    ``checkpoint`` / ``checkpoint_tag`` read the parameters of a tag the
    port's training wrote at any mesh; ``init_on_device`` draws the random
    init on the device."""
    from deepspeed_tpu_torch.inference.engine import InferenceEngine

    return InferenceEngine(model=model, **kwargs)


def init_serving(model=None, serving=None, **kwargs):
    """A continuous-batching ServingEngine over an :func:`init_inference`
    engine.  ``serving`` is the ``serving`` config block (dict or
    ServingConfig); remaining kwargs go to ``init_inference`` (``mp_size``,
    ``checkpoint``, ...).  Across ranks every rank submits, steps and
    drains alike (``submit`` and ``cancel`` are collectives decided on
    rank 0), and every rank plans on rank 0's clock."""
    from deepspeed_tpu_torch.serving import ServingEngine

    return ServingEngine(init_inference(model=model, **kwargs), config=serving)


__all__ = ["__version__", "initialize", "init_inference", "init_serving"]
