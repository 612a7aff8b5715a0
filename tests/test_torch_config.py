"""Parity of the port's DeepSpeed config (deepspeed_tpu_torch) with the JAX
package's ``DeepSpeedConfig`` on one device (data-parallel world size 1):
the same JSON dicts give the same batch triad, the same training fields
and the same rejections; blocks the port cannot honour yet raise
``NotImplementedError`` naming their ROADMAP item unless they are at their
"off" default."""
import json

import pytest

from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config.config import DeepSpeedConfigError as JError
from deepspeed_tpu_torch.config.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError as TError

VALID = [
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8},
    {"train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 2},
    {"train_batch_size": 16},
    {"train_micro_batch_size_per_gpu": 3},
    {
        "train_batch_size": 16, "train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 2,
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95], "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"total_num_steps": 100, "warmup_num_steps": 10, "warmup_max_lr": 6e-4}},
        "bf16": {"enabled": True}, "gradient_clipping": 1.0, "steps_per_print": 5, "seed": 7,
        "zero_optimization": {"stage": 2},
    },
    {"train_micro_batch_size_per_gpu": 2,
     "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 16, "hysteresis": 3},
     "optimizer": {"type": "SGD", "params": {"lr": 0.1, "momentum": 0.9}},
     "mesh": {"data": 1}, "telemetry": {}, "wall_clock_breakdown": False,
     "kernels": {"enabled": "auto"}},
]

INVALID = [
    {},  # no batch size at all
    {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 3},
    {"train_batch_size": 10, "gradient_accumulation_steps": 3},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3},
    {"train_batch_size": 8, "trian_micro_batch_size": 2},  # unknown top-level key
    {"train_batch_size": 8, "optimizer": {"type": "Adam", "parms": {}}},
    {"train_batch_size": 8, "fp16": {"enabled": True, "loss_scal": 0}},
    {"train_batch_size": 8, "bf16": {"enabled": True}, "fp16": {"enabled": True}},
    {"train_batch_size": 8, "zero_optimization": {"stage": 4}},
    {"train_batch_size": 8, "zero_optimization": {"stage": 1, "bucket": 5}},
    {"train_batch_size": 8, "optimizer": {"type": 3}},
    {"train_batch_size": 8, "mesh": {"dat": 1}},
]


def _fields(c):
    return {
        "triad": (c.train_batch_size, c.train_micro_batch_size_per_gpu, c.gradient_accumulation_steps),
        "optimizer": (c.optimizer.name, json.dumps(c.optimizer.params, sort_keys=True),
                      c.optimizer.legacy_fusion),
        "scheduler": (c.scheduler.type, json.dumps(c.scheduler.params, sort_keys=True)),
        "fp16": (c.fp16.enabled, c.fp16.loss_scale, c.fp16.initial_scale_power,
                 c.fp16.loss_scale_window, c.fp16.hysteresis, c.fp16.min_loss_scale,
                 c.fp16.dynamic_loss_scale),
        "bf16": c.bf16.enabled,
        "zero": (c.zero_config.stage, c.zero_enabled, c.zero_optimization_stage),
        "scalars": (c.gradient_clipping, c.steps_per_print, c.seed, c.compute_dtype),
    }


@pytest.mark.parametrize("d", VALID, ids=range(len(VALID)))
def test_same_dict_gives_same_fields(d):
    assert _fields(TConfig(d)) == _fields(JConfig(d, world_size=1))


@pytest.mark.parametrize("d", INVALID, ids=range(len(INVALID)))
def test_same_dict_gives_same_rejection(d):
    with pytest.raises(JError):
        JConfig(d, world_size=1)
    with pytest.raises(TError):
        TConfig(d)


@pytest.mark.parametrize("d,item", [
    ({"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}}, "A12"),
    ({"zero_optimization": {"stage": 3, "offload_param": {"device": "nvme"}}}, "A12"),
    ({"zero_optimization": {"stage": 1, "reduce_bucket_size": 1000}}, "A6"),
    ({"mesh": {"data": 2}}, "A6"),
    ({"mesh": {"fsdp": 4}}, "A6"),
    ({"pipeline": {"stages": 2}}, "A11"),
    ({"resilience": {"watchdog": {"enabled": True}}}, "A14"),
    ({"telemetry": {"enabled": True, "ring": 16}}, "A14"),
    ({"activation_checkpointing": {"partition_activations": True}}, "A13"),
    ({"wall_clock_breakdown": True}, "A14"),
    ({"dataloader_drop_last": True}, "A5"),
    ({"sparse_attention": {"mode": "fixed"}}, "A10"),
])
def test_not_ported_blocks_raise_naming_their_item(d, item):
    d = {"train_batch_size": 8, **d}
    JConfig(d, world_size=1)  # the JAX package takes it
    with pytest.raises(NotImplementedError, match=item):
        TConfig(d)


def test_serving_block_still_parses():
    c = TConfig({"train_batch_size": 8, "serving": {"num_slots": 4, "prefill_chunk": 32}})
    assert c.serving.num_slots == 4 and c.serving.prefill_chunk == 32
