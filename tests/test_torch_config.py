"""Parity of the port's DeepSpeed config (deepspeed_tpu_torch) with the JAX
package's ``DeepSpeedConfig`` on one device (data-parallel world size 1):
the same JSON dicts give the same batch triad, the same training fields
and the same rejections; blocks the port cannot honour yet raise
``NotImplementedError`` naming their ROADMAP item unless they are at their
"off" default; the keys the JAX package parses and never reads again are
carried under its attribute names; the ``serving.fleet`` (with its
``elastic`` block) and ``serving.frontdoor`` blocks parse and refuse as
the JAX package's do."""
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
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 8, "bf16": {"enabled": True},
     "optimizer": {"type": "Lamb", "params": {
         "lr": 2e-3, "betas": [0.9, 0.999], "eps": 1e-6, "weight_decay": 0.01,
         "bias_correction": False, "max_coeff": 0.3, "min_coeff": 0.01}}},
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
    {"train_batch_size": 8, "checkpoint_tag_validation": "Strict"},
    {"train_batch_size": 8, "resilience": {"checkpoint": {"checksum": "md5"}}},
    {"train_batch_size": 8, "resilience": {"retry": {"max_attempts": 0}}},
    {"train_batch_size": 8, "resilience": {"divergence": {"action": "panic"}}},
    {"train_batch_size": 8, "resilience": {"watchdog": {"exit_code": 300}}},
    {"train_batch_size": 8, "resilience": {"watchdog": {"grace": 5}}},
    {"train_batch_size": 8, "overlap": {"prefetch": {"depth": 0}}},
    {"train_batch_size": 8, "overlap": {"async_checkpoint": {"drain_timeout_seconds": 0}}},
    {"train_batch_size": 8, "overlap": {"timeline": {"window": 0}}},
    {"train_batch_size": 8, "overlap": {"prefetcher": {}}},
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
    # prescale_gradients, fp32_allreduce and disable_allgather parse now
    # (test_keys_the_jax_package_never_reads_parse_as_its_attributes)
    ({"pipeline": {"stages": 2}}, "A11"),
    ({"resilience": {"supervision": {"enabled": True}}}, "A14"),
    ({"telemetry": {"enabled": True, "ring": 16}}, "A14"),
    ({"activation_checkpointing": {"partition_activations": True}}, "A13"),
    ({"wall_clock_breakdown": True}, "A14"),
    ({"sanitizer": {"enabled": True}}, "A15"),
    ({"progressive_layer_drop": {"enabled": True}}, "A13"),
])
def test_not_ported_blocks_raise_naming_their_item(d, item):
    d = {"train_batch_size": 8, **d}
    JConfig(d, world_size=1)  # the JAX package takes it
    with pytest.raises(NotImplementedError, match=item):
        TConfig(d)


@pytest.mark.parametrize("block", [
    None,
    {"mode": "fixed"},
    {"mode": "bigbird", "block": 64, "num_random_blocks": 2, "different_layout_per_head": True},
    {"block": 16, "attention": "unidirectional"},
], ids=["absent", "fixed", "bigbird-params", "no-mode"])
def test_sparse_attention_block_parses_as_the_jax_package_does(block):
    d = {"train_batch_size": 8}
    if block is not None:
        d["sparse_attention"] = block
    want = JConfig(d, world_size=1).sparse_attention
    got = TConfig(d).sparse_attention
    assert (got.mode, got.params) == (want.mode, want.params)


RESILIENCE_OVERLAP = [
    {},
    {"resilience": {"checkpoint": {"keep_last_n": 3, "keep_every": 100, "checksum": "CRC32",
                                   "fail_on_missing": True, "verify_on_load": False},
                    "watchdog": {"enabled": True, "grace_seconds": 30, "exit_code": 50,
                                 "save_dir": "/ckpt"},
                    "retry": {"max_attempts": 5, "backoff_seconds": 0.0, "jitter": 0.0,
                              "timeout_seconds": 9.5},
                    "divergence": {"threshold": 4, "action": "Rollback", "check_loss": True},
                    "supervision": {"enabled": False}},
     "overlap": {"prefetch": {"enabled": False, "depth": 4},
                 "async_checkpoint": {"enabled": True, "drain_timeout_seconds": 60},
                 "timeline": {"enabled": False, "window": 16, "fence": True}},
     "checkpoint_tag_validation": "Fail", "dataloader_drop_last": True},
]


@pytest.mark.parametrize("extra", RESILIENCE_OVERLAP, ids=["defaults", "every-key"])
def test_resilience_and_overlap_blocks_parse_as_the_jax_package_does(extra):
    """The ``resilience`` (but ``supervision``) and ``overlap`` blocks,
    ``checkpoint_tag_validation`` and ``dataloader_drop_last`` parse to the
    JAX dataclasses' fields, and ``retry.policy()`` builds the same
    policy."""
    import dataclasses

    d = {"train_batch_size": 8, **extra}
    want, got = JConfig(d, world_size=1), TConfig(d)
    for block in ("checkpoint", "watchdog", "retry", "divergence"):
        assert dataclasses.asdict(getattr(got.resilience, block)) == \
            dataclasses.asdict(getattr(want.resilience, block)), block
    assert dataclasses.asdict(got.overlap) == dataclasses.asdict(want.overlap)
    assert got.checkpoint_tag_validation_mode == want.checkpoint_tag_validation_mode
    assert got.dataloader_drop_last == want.dataloader_drop_last
    assert dataclasses.asdict(got.resilience.retry.policy()) == \
        dataclasses.asdict(want.resilience.retry.policy())


def test_serving_block_still_parses():
    c = TConfig({"train_batch_size": 8, "serving": {"num_slots": 4, "prefill_chunk": 32}})
    assert c.serving.num_slots == 4 and c.serving.prefill_chunk == 32


SERVING_RESILIENCE = [
    {"journal_dir": "/tmp/j"},
    {"drain_deadline_seconds": 5.0},
    {"journal_dir": "/ckpt/wal", "journal_segment_records": 64, "journal_keep_segments": 2,
     "drain_deadline_seconds": 0.0},
    {"tenants": {"enabled": True}},
    {"tenants": {"enabled": True, "refill_tokens_per_second": 50.0, "burst_tokens": 400,
                 "weight": 2, "slo_class": "Gold", "kv_pages_max": 12, "pinned_prefixes_max": 2,
                 "overrides": {"acme": {"kv_pages_max": 3, "slo_class": "bronze"},
                               "globex": {"weight": 0.5}}}},
    {"kvcache": {"tiers": {"enabled": True}}},
    {"kvcache": {"enabled": True, "tiers": {"enabled": True}}},
    {"kvcache": {"enabled": True, "page_len": 128, "num_pages": 160,
                 "tiers": {"enabled": True, "host_pages": 24, "disk_dir": "/nvme/kv",
                           "residency_window": 256, "demote_watermark": 0.3,
                           "prefetch_ahead": 2, "demote_batch": 8}}},
]


@pytest.mark.parametrize("block", SERVING_RESILIENCE, ids=[
    "journal", "drain", "journal-every-key", "tenants", "tenants-every-key", "tiers",
    "tiers-paged", "tiers-every-key"])
def test_journal_drain_tenants_and_tiers_parse_as_the_jax_package_does(block):
    """The request journal's keys, the drain deadline, the ``tenants``
    block and ``kvcache.tiers`` are ported: the same dict gives the JAX
    package's fields, and the full config takes them."""
    import dataclasses

    from deepspeed_tpu.config.config import ServingConfig as JServing
    from deepspeed_tpu_torch.config.config import ServingConfig as TServing

    want, got = dataclasses.asdict(JServing.from_dict(block)), dataclasses.asdict(
        TServing.from_dict(block))
    assert got == want  # the fleet and frontdoor blocks too, at their defaults
    TConfig({"train_batch_size": 8, "serving": block})


@pytest.mark.parametrize("block", [
    {"drain_deadline_seconds": -1},
    {"journal_segment_records": 0},
    {"journal_keep_segments": 0},
    {"tenants": {"weight": 0.0}},
    {"tenants": {"overrides": {"acme": {"refill_rate": 1}}}},
    {"tenants": {"slo_class": "platinum"}},
    {"tenants": {"bogus": 1}},
    {"kvcache": {"tiers": {"enabled": True, "demote_watermark": 0.0}}},
    {"kvcache": {"tiers": {"enabled": True, "host_pages": -1}}},
])
def test_journal_drain_tenants_and_tiers_reject_as_the_jax_package_does(block):
    from deepspeed_tpu.config.config import ServingConfig as JServing
    from deepspeed_tpu_torch.config.config import ServingConfig as TServing

    with pytest.raises(JError):
        JServing.from_dict(block)
    with pytest.raises(TError):
        TServing.from_dict(block)


@pytest.mark.parametrize("block", [{"fleet": {"replicas": 2}}, {"frontdoor": {"enabled": True}}])
def test_fleet_and_frontdoor_still_refuse_naming_a8(block):
    """The fleet and the front door are ported, so the blocks that raised
    ``NotImplementedError`` naming A8 now parse to the JAX package's
    fields, in the full config too."""
    import dataclasses

    from deepspeed_tpu.config.config import ServingConfig as JServing
    from deepspeed_tpu_torch.config.config import ServingConfig as TServing

    want = dataclasses.asdict(JServing.from_dict(block))
    assert dataclasses.asdict(TServing.from_dict(block)) == want
    got = TConfig({"train_batch_size": 8, "serving": block}).serving
    assert dataclasses.asdict(got) == want


LAMB_PARAMS = {"lr": 2e-3, "betas": [0.9, 0.98], "eps": 1e-6, "weight_decay": 0.01,
               "bias_correction": False, "max_coeff": 0.3, "min_coeff": 0.02}


@pytest.mark.parametrize("params", [LAMB_PARAMS, {}], ids=["bing_bert", "defaults"])
def test_lamb_block_builds_the_jax_packages_optimizer(params):
    """The engine turns a ``Lamb`` block into ``FusedLamb`` with the same
    hyper-parameters as the JAX package's ``FusedLamb(lr=lr, **params)``
    (``_configure_basic_optimizer``); the reference defaults fill what
    the block leaves out."""
    import numpy as np

    from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JLamb
    from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    d = {"train_batch_size": 8, "optimizer": {"type": "Lamb", "params": dict(params)}}
    jopt = JLamb(**{"lr": 1e-3, **JConfig(d, world_size=1).optimizer.params})
    eng = DeepSpeedEngine(model=lambda p, b, g: p["w"].sum(), params={"w": np.ones(3, np.float32)},
                          config=TConfig(d), device="cpu")
    topt = eng.optimizer
    assert isinstance(topt, FusedLamb)
    names = ("lr", "b1", "b2", "eps", "weight_decay", "bias_correction", "max_coeff", "min_coeff")
    assert {n: getattr(topt, n) for n in names} == {n: getattr(jopt, n) for n in names}


def test_onebit_lamb_still_raises_naming_a13():
    import numpy as np

    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

    d = {"train_batch_size": 8, "optimizer": {"type": "OneBitLamb", "params": {"lr": 1e-3}}}
    JConfig(d, world_size=1)  # the JAX package takes it
    with pytest.raises(NotImplementedError, match="A13"):
        DeepSpeedEngine(model=lambda p, b, g: p["w"].sum(), params={"w": np.ones(3, np.float32)},
                        config=TConfig(d), device="cpu")


# the top-level keys the JAX package parses and never reads again: the
# port carries them unread under the JAX DeepSpeedConfig's attribute names
C7_KEYS = {
    "prescale_gradients": (True, "prescale_gradients"),
    "gradient_predivide_factor": (4.0, "gradient_predivide_factor"),
    "sparse_gradients": (True, "sparse_gradients_enabled"),
    "fp32_allreduce": (True, "allreduce_always_fp32"),
    "memory_breakdown": (True, "memory_breakdown"),
    "dump_state": (True, "dump_state"),
    "disable_allgather": (True, "disable_allgather"),
    "zero_allow_untested_optimizer": (True, "zero_allow_untested_optimizer"),
}


@pytest.mark.parametrize("key", sorted(C7_KEYS))
def test_keys_the_jax_package_never_reads_parse_as_its_attributes(key):
    """Each key at a value off its default is accepted, and its attribute
    equals the JAX package's (also at the default, key absent)."""
    value, attr = C7_KEYS[key]
    d = {"train_batch_size": 8, key: value}
    assert getattr(TConfig(d), attr) == getattr(JConfig(d, world_size=1), attr)
    assert getattr(TConfig(d), attr) != getattr(TConfig({"train_batch_size": 8}), attr)
    base = {"train_batch_size": 8}
    assert getattr(TConfig(base), attr) == getattr(JConfig(base, world_size=1), attr)


def test_every_key_still_refused_names_an_open_item():
    """What ``_TOP_NOT_PORTED`` still refuses names a ROADMAP item, and
    none of the keys above is in it."""
    from deepspeed_tpu_torch.config import config as tc

    assert not set(C7_KEYS) & set(tc._TOP_NOT_PORTED)
    for key, (_, item) in tc._TOP_NOT_PORTED.items():
        assert item.split()[0][0] in "AB", (key, item)
    assert not hasattr(tc, "_NOT_PORTED_BLOCKS")


FLEET_BLOCKS = [
    {"fleet": {}},
    {"fleet": {"replicas": 3, "route_retries": 1, "breaker_failures": 5,
               "breaker_backoff_seconds": 0.25, "breaker_backoff_max_seconds": 8.0,
               "breaker_halfopen_probes": 2, "hedge": True, "hedge_factor": 2.0,
               "hedge_min_observations": 8, "max_restarts": 2,
               "restart_backoff_seconds": 0.1, "restart_budget_reset_seconds": 60.0}},
    {"fleet": {"elastic": {"enabled": True}}},
    {"fleet": {"elastic": {"enabled": True, "min_replicas": 1, "max_replicas": 3,
                           "scale_up_queue_depth": 4, "scale_up_ttft_seconds": 2.0,
                           "scale_down_queue_depth": 1, "engage_ticks": 2,
                           "disengage_ticks": 6, "scale_up_cooldown_seconds": 1.0,
                           "scale_down_cooldown_seconds": 10.0, "warm_pool_size": 1,
                           "migration_deadline_seconds": 15.0, "migration_retries": 1}}},
    {"frontdoor": {"enabled": True}},
    {"frontdoor": {"enabled": True, "host": "0.0.0.0", "port": 8080,
                   "stream_poll_seconds": 0.005, "max_body_bytes": 4096}},
    {"fleet": {"replicas": 2}, "frontdoor": {"enabled": True}, "journal_dir": "/j",
     "tenants": {"enabled": True}},
]


@pytest.mark.parametrize("block", FLEET_BLOCKS, ids=[
    "fleet-defaults", "fleet-every-key", "elastic", "elastic-every-key", "frontdoor",
    "frontdoor-every-key", "all"])
def test_fleet_elastic_and_frontdoor_parse_as_the_jax_package_does(block):
    import dataclasses

    from deepspeed_tpu.config.config import ServingConfig as JServing
    from deepspeed_tpu_torch.config.config import ServingConfig as TServing

    want = dataclasses.asdict(JServing.from_dict(block))
    assert dataclasses.asdict(TServing.from_dict(block)) == want
    got = TConfig({"train_batch_size": 8, "serving": block}).serving
    assert dataclasses.asdict(got) == want


FLEET_REJECTS = [
    {"fleet": {"replica": 3}},
    {"fleet": {"replicas": 0}},
    {"fleet": {"route_retries": -1}},
    {"fleet": {"breaker_failures": 0}},
    {"fleet": {"breaker_backoff_seconds": -0.5}},
    {"fleet": {"breaker_backoff_seconds": 4.0, "breaker_backoff_max_seconds": 2.0}},
    {"fleet": {"breaker_halfopen_probes": 0}},
    {"fleet": {"hedge_factor": 0}},
    {"fleet": {"hedge_min_observations": 0}},
    {"fleet": {"max_restarts": -1}},
    {"fleet": {"restart_backoff_seconds": -1}},
    {"fleet": {"restart_budget_reset_seconds": -1.0}},
    {"fleet": {"elastic": {"warm_replicas": 2}}},
    {"fleet": {"elastic": {"min_replicas": 0}}},
    {"fleet": {"elastic": {"min_replicas": 3, "max_replicas": 2}}},
    {"fleet": {"elastic": {"scale_up_queue_depth": 0}}},
    {"fleet": {"elastic": {"scale_up_ttft_seconds": 0}}},
    {"fleet": {"elastic": {"scale_down_queue_depth": -1}}},
    {"fleet": {"elastic": {"scale_up_queue_depth": 2, "scale_down_queue_depth": 2}}},
    {"fleet": {"elastic": {"engage_ticks": 0}}},
    {"fleet": {"elastic": {"disengage_ticks": 0}}},
    {"fleet": {"elastic": {"scale_up_cooldown_seconds": -1}}},
    {"fleet": {"elastic": {"scale_down_cooldown_seconds": -1}}},
    {"fleet": {"elastic": {"warm_pool_size": -1}}},
    {"fleet": {"elastic": {"migration_deadline_seconds": 0}}},
    {"fleet": {"elastic": {"migration_retries": -1}}},
    {"frontdoor": {"port": 70000}},
    {"frontdoor": {"stream_poll_seconds": 0}},
    {"frontdoor": {"max_body_bytes": 0}},
    {"frontdoor": {"hots": "x"}},
]


@pytest.mark.parametrize("block", FLEET_REJECTS, ids=range(len(FLEET_REJECTS)))
def test_fleet_elastic_and_frontdoor_reject_as_the_jax_package_does(block):
    """The same dict is refused by both, with the same message."""
    from deepspeed_tpu.config.config import ServingConfig as JServing
    from deepspeed_tpu_torch.config.config import ServingConfig as TServing

    with pytest.raises(JError) as want:
        JServing.from_dict(block)
    with pytest.raises(TError) as got:
        TServing.from_dict(block)
    assert str(got.value) == str(want.value)
