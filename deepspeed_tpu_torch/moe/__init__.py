"""Mixture-of-experts with expert parallelism over the ``expert`` mesh
axis (counterpart of ``deepspeed_tpu/moe/``)."""
from deepspeed_tpu_torch.moe.layer import (
    MoEConfig,
    init_moe_params,
    moe_ffn,
    moe_param_specs,
    top_k_gating,
)

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn", "moe_param_specs", "top_k_gating"]
