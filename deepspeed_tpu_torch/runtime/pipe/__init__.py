"""Pipeline parallelism (counterpart of ``deepspeed_tpu/runtime/pipe/``;
reference ``deepspeed/runtime/pipe/``)."""
from deepspeed_tpu_torch.runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec
from deepspeed_tpu_torch.runtime.pipe import schedule

__all__ = ["PipelineModule", "LayerSpec", "TiedLayerSpec", "schedule"]
