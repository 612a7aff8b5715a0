"""FLOPs profiler (counterpart of ``deepspeed_tpu/profiling``)."""
from deepspeed_tpu_torch.profiling.flops_profiler import (
    FlopsProfiler,
    get_model_profile,
    see_memory_usage,
)

__all__ = ["FlopsProfiler", "get_model_profile", "see_memory_usage"]
