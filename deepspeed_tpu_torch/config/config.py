"""Typed DeepSpeed JSON config (counterpart of
``deepspeed_tpu/config/config.py``).

Ported: :class:`DeepSpeedConfig` with its batch triad on one device, the
``fp16``, ``bf16``, ``optimizer``, ``scheduler`` blocks, the ZeRO
``stage``, ``gradient_clipping``, ``steps_per_print``, ``seed``, and the
``serving`` block's slot-pool fields (:class:`ServingConfig`).  Unknown
keys raise :class:`DeepSpeedConfigError` as in the JAX package.  Keys and
blocks the JAX package knows but the port cannot honour yet are accepted
only at their "off" default; otherwise they raise ``NotImplementedError``
naming their ROADMAP item, never accepted and ignored."""
from __future__ import annotations

import dataclasses
import difflib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

from deepspeed_tpu_torch.config import constants as C


class DeepSpeedConfigError(Exception):
    pass


def _describe_unknown(keys: Iterable[str], block: str, valid: Iterable[str]) -> str:
    """'serving.num_slot' (did you mean 'num_slots'?), ... — full paths
    plus nearest-key hints."""
    valid = sorted(str(v) for v in valid)
    parts = []
    for key in sorted(str(k) for k in keys):
        path = f"{block}.{key}" if block else key
        close = difflib.get_close_matches(key, valid, n=1, cutoff=0.6)
        hint = f" (did you mean '{close[0]}'?)" if close else ""
        parts.append(f"'{path}'{hint}")
    return ", ".join(parts)


def _check_empty(d: Dict[str, Any], block: str, valid: Iterable[str] = ()) -> None:
    if d:
        raise DeepSpeedConfigError(
            f"Unknown config key(s): {_describe_unknown(d.keys(), block, valid)}"
        )


def _known_keys(cls, *extra: str) -> Iterable[str]:
    return tuple(f.name for f in dataclasses.fields(cls)) + extra


# serving keys of the JAX package whose machinery is not ported yet:
# key -> (default that means "off", ROADMAP item)
_NOT_PORTED_KEYS = {
    "journal_dir": (C.SERVING_JOURNAL_DIR_DEFAULT, "A8 serving/journal.py"),
    "journal_segment_records": (C.SERVING_JOURNAL_SEGMENT_RECORDS_DEFAULT, "A8 serving/journal.py"),
    "journal_keep_segments": (C.SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT, "A8 serving/journal.py"),
    "drain_deadline_seconds": (C.SERVING_DRAIN_DEADLINE_SECONDS_DEFAULT, "A8 serving/watchdog.py"),
}
_NOT_PORTED_BLOCKS = {
    C.SERVING_FLEET: "A8 serving/fleet/",
    C.SERVING_FRONTDOOR: "A8 serving/frontdoor/",
    C.SERVING_TENANTS: "A8 serving/frontdoor/tenants.py",
}


def _refuse_not_ported(d: Dict[str, Any]) -> None:
    """Raise for any part of ``d`` that asks for serving machinery the
    port does not have yet (paged KV, tiers, journal, watchdog, fleet,
    front-door, tenants)."""
    for key, (off, item) in _NOT_PORTED_KEYS.items():
        if key in d and d[key] not in (off, None):
            raise NotImplementedError(
                f"'{C.SERVING}.{key}' is not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP {item})"
            )
        d.pop(key, None)
    for block, item in _NOT_PORTED_BLOCKS.items():
        if d.pop(block, None):
            raise NotImplementedError(
                f"'{C.SERVING}.{block}' is not ported to deepspeed_tpu_torch yet "
                f"(ROADMAP {item})"
            )
    kvc = d.pop(C.SERVING_KVCACHE, None) or {}
    if kvc.get("enabled"):
        raise NotImplementedError(
            f"'{C.SERVING}.{C.SERVING_KVCACHE}.enabled' (the paged KV pool) is not "
            "ported to deepspeed_tpu_torch yet (ROADMAP B5 + A8 serving/kvcache/)"
        )
    if (kvc.get(C.SERVING_KVCACHE_TIERS) or {}).get("enabled"):
        raise NotImplementedError(
            f"'{C.SERVING}.{C.SERVING_KVCACHE}.{C.SERVING_KVCACHE_TIERS}' is not "
            "ported to deepspeed_tpu_torch yet (ROADMAP A8 serving/kvcache/tiers.py)"
        )


@dataclass
class ServingConfig:
    """``serving`` block: the continuous-batching slot-pool engine.
    ``num_slots`` concurrent sequences share one fixed-shape KV pool;
    prompts prefill in ``prefill_chunk``-token chunks interleaved with
    decode steps; ``max_queue`` bounds admission and
    ``deadline_seconds`` expires requests that wait too long for a
    slot."""

    num_slots: int = C.SERVING_NUM_SLOTS_DEFAULT
    max_len: int = C.SERVING_MAX_LEN_DEFAULT  # 0 = derive from the engine
    kv_cache_dtype: str = C.SERVING_KV_CACHE_DTYPE_DEFAULT
    prefill_chunk: int = C.SERVING_PREFILL_CHUNK_DEFAULT
    prefill_chunks_per_step: int = C.SERVING_PREFILL_CHUNKS_PER_STEP_DEFAULT
    max_queue: int = C.SERVING_MAX_QUEUE_DEFAULT
    max_new_tokens: int = C.SERVING_MAX_NEW_TOKENS_DEFAULT
    deadline_seconds: float = C.SERVING_DEADLINE_SECONDS_DEFAULT
    max_top_k: int = C.SERVING_MAX_TOP_K_DEFAULT
    slo_ttft_ms: float = C.SERVING_SLO_TTFT_MS_DEFAULT
    degrade_queue_watermark: float = C.SERVING_DEGRADE_QUEUE_WATERMARK_DEFAULT
    degrade_engage_steps: int = C.SERVING_DEGRADE_ENGAGE_STEPS_DEFAULT
    degrade_disengage_steps: int = C.SERVING_DEGRADE_DISENGAGE_STEPS_DEFAULT
    degrade_max_new_tokens: int = C.SERVING_DEGRADE_MAX_NEW_TOKENS_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        if d is None:
            return cls()
        d = dict(d)
        _refuse_not_ported(d)
        out = cls(
            num_slots=int(d.pop("num_slots", C.SERVING_NUM_SLOTS_DEFAULT)),
            max_len=int(d.pop("max_len", C.SERVING_MAX_LEN_DEFAULT)),
            kv_cache_dtype=str(
                d.pop("kv_cache_dtype", C.SERVING_KV_CACHE_DTYPE_DEFAULT)
            ).lower(),
            prefill_chunk=int(d.pop("prefill_chunk", C.SERVING_PREFILL_CHUNK_DEFAULT)),
            prefill_chunks_per_step=int(
                d.pop("prefill_chunks_per_step", C.SERVING_PREFILL_CHUNKS_PER_STEP_DEFAULT)
            ),
            max_queue=int(d.pop("max_queue", C.SERVING_MAX_QUEUE_DEFAULT)),
            max_new_tokens=int(d.pop("max_new_tokens", C.SERVING_MAX_NEW_TOKENS_DEFAULT)),
            deadline_seconds=float(
                d.pop("deadline_seconds", C.SERVING_DEADLINE_SECONDS_DEFAULT)
            ),
            max_top_k=int(d.pop("max_top_k", C.SERVING_MAX_TOP_K_DEFAULT)),
            slo_ttft_ms=float(d.pop("slo_ttft_ms", C.SERVING_SLO_TTFT_MS_DEFAULT)),
            degrade_queue_watermark=float(
                d.pop("degrade_queue_watermark", C.SERVING_DEGRADE_QUEUE_WATERMARK_DEFAULT)
            ),
            degrade_engage_steps=int(
                d.pop("degrade_engage_steps", C.SERVING_DEGRADE_ENGAGE_STEPS_DEFAULT)
            ),
            degrade_disengage_steps=int(
                d.pop("degrade_disengage_steps", C.SERVING_DEGRADE_DISENGAGE_STEPS_DEFAULT)
            ),
            degrade_max_new_tokens=int(
                d.pop("degrade_max_new_tokens", C.SERVING_DEGRADE_MAX_NEW_TOKENS_DEFAULT)
            ),
        )
        _check_empty(d, C.SERVING, _known_keys(cls))
        if out.max_top_k < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.max_top_k' must be >= 1, got {out.max_top_k}"
            )
        if out.num_slots < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.num_slots' must be >= 1, got {out.num_slots}"
            )
        if out.kv_cache_dtype not in C.SERVING_KV_CACHE_DTYPES:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.kv_cache_dtype' must be one of "
                f"{C.SERVING_KV_CACHE_DTYPES}, got '{out.kv_cache_dtype}'"
            )
        if out.prefill_chunk < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.prefill_chunk' must be >= 1, got {out.prefill_chunk}"
            )
        if out.prefill_chunks_per_step < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.prefill_chunks_per_step' must be >= 1, "
                f"got {out.prefill_chunks_per_step}"
            )
        if out.max_len < 0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.max_len' must be >= 0 (0 derives it from the "
                f"engine's capacity), got {out.max_len}"
            )
        if out.max_len and out.max_len % out.prefill_chunk:
            # a chunk-multiple capacity is what guarantees the last
            # prefill chunk's write never clamps at the cache end
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.max_len' ({out.max_len}) must be a multiple of "
                f"prefill_chunk ({out.prefill_chunk})"
            )
        if out.max_queue < 0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.max_queue' must be >= 0, got {out.max_queue}"
            )
        if out.max_new_tokens < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.max_new_tokens' must be >= 1, got {out.max_new_tokens}"
            )
        if out.deadline_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.deadline_seconds' must be >= 0, got {out.deadline_seconds}"
            )
        if out.slo_ttft_ms < 0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.slo_ttft_ms' must be >= 0 (0 disables the "
                f"admission test), got {out.slo_ttft_ms}"
            )
        if not 0.0 < out.degrade_queue_watermark <= 1.0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.degrade_queue_watermark' must be in (0, 1] "
                f"(a fraction of max_queue), got {out.degrade_queue_watermark}"
            )
        if out.degrade_engage_steps < 1 or out.degrade_disengage_steps < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.degrade_engage_steps'/'degrade_disengage_steps' must "
                f"be >= 1, got {out.degrade_engage_steps}/{out.degrade_disengage_steps}"
            )
        if out.degrade_max_new_tokens < 0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.degrade_max_new_tokens' must be >= 0 (0 disables "
                f"the clamp rung), got {out.degrade_max_new_tokens}"
            )
        return out


# ---------------------------------------------------------------------------
# training blocks
# ---------------------------------------------------------------------------

def _not_ported(path: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"'{path}' is not ported to deepspeed_tpu_torch yet (ROADMAP {item})")


@dataclass
class Fp16Config:
    enabled: bool = C.FP16_ENABLED_DEFAULT
    loss_scale: float = C.FP16_LOSS_SCALE_DEFAULT  # 0 => dynamic
    initial_scale_power: int = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.FP16_HYSTERESIS_DEFAULT
    min_loss_scale: float = C.FP16_MIN_LOSS_SCALE_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Fp16Config":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(d.pop(C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)),
            loss_scale=float(d.pop(C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT)),
            initial_scale_power=int(d.pop(C.FP16_INITIAL_SCALE_POWER, C.FP16_INITIAL_SCALE_POWER_DEFAULT)),
            loss_scale_window=int(d.pop(C.FP16_LOSS_SCALE_WINDOW, C.FP16_LOSS_SCALE_WINDOW_DEFAULT)),
            hysteresis=int(d.pop(C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT)),
            min_loss_scale=float(d.pop(C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT)),
        )
        _check_empty(d, C.FP16, _known_keys(cls))
        return out

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@dataclass
class Bf16Config:
    enabled: bool = C.BF16_ENABLED_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "Bf16Config":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(enabled=bool(d.pop(C.BF16_ENABLED, C.BF16_ENABLED_DEFAULT)))
        _check_empty(d, C.BF16, _known_keys(cls))
        return out


@dataclass
class OptimizerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "OptimizerConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            type=d.pop(C.TYPE, None),
            params=dict(d.pop(C.OPTIMIZER_PARAMS, {}) or {}),
            legacy_fusion=bool(d.pop(C.LEGACY_FUSION, C.LEGACY_FUSION_DEFAULT)),
        )
        _check_empty(d, C.OPTIMIZER, _known_keys(cls))
        if out.type is not None and not isinstance(out.type, str):
            raise DeepSpeedConfigError("optimizer.type must be a string")
        return out

    @property
    def name(self) -> Optional[str]:
        return self.type.lower() if self.type else None


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SchedulerConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(type=d.pop(C.TYPE, None), params=dict(d.pop(C.SCHEDULER_PARAMS, {}) or {}))
        _check_empty(d, C.SCHEDULER, _known_keys(cls))
        return out


# zero_optimization keys of the JAX package other than ``stage``: their
# default there, and the ROADMAP item that ports them.  On one device
# every stage is the same math, so the stage itself is honoured.
_ZERO_NOT_PORTED = {
    "contiguous_gradients": (True, "A6"),
    "reduce_scatter": (True, "A6"),
    "reduce_bucket_size": (500_000_000, "A6"),
    "allgather_partitions": (True, "A6"),
    "allgather_bucket_size": (500_000_000, "A6"),
    "overlap_comm": (True, "A6"),
    "load_from_fp32_weights": (True, "A4 checkpoints"),
    "elastic_checkpoint": (True, "A4 checkpoints"),
    "sub_group_size": (1_000_000_000, "A6"),
    "stage3_prefetch_bucket_size": (50_000_000, "A6"),
    "prefetch_bucket_size": (50_000_000, "A6"),
    "stage3_param_persistence_threshold": (100_000, "A6"),
    "param_persistence_threshold": (100_000, "A6"),
    "stage3_max_live_parameters": (1_000_000_000, "A6"),
    "max_live_parameters": (1_000_000_000, "A6"),
    "stage3_max_reuse_distance": (1_000_000_000, "A6"),
    "max_reuse_distance": (1_000_000_000, "A6"),
    "stage3_gather_fp16_weights_on_model_save": (False, "A4 checkpoints"),
    "gather_fp16_weights_on_model_save": (False, "A4 checkpoints"),
    "round_robin_gradients": (False, "A6"),
    "ignore_unused_parameters": (True, "A6"),
    "legacy_stage1": (False, "A6"),
    "cross_replica_weight_update": (True, "A6"),
    "cpu_offload": (False, "A12"),
}
_OFFLOAD_KEYS = ("device", "nvme_path", "buffer_count", "buffer_size", "pin_memory",
                 "pipeline_read", "pipeline_write", "fast_init", "max_in_cpu", "ratio")


@dataclass
class ZeroConfig:
    """``zero_optimization``: only ``stage`` is ported (one device: every
    stage is the same math).  Offload raises (ROADMAP A12); the other
    knobs are accepted at their JAX default only (ROADMAP A6)."""

    stage: int = C.ZERO_STAGE_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(stage=int(d.pop(C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT)))
        for block in ("offload_param", "offload_optimizer"):
            sub = d.pop(block, None)
            if sub is None:
                continue
            sub = dict(sub)
            unknown = set(sub) - set(_OFFLOAD_KEYS)
            if unknown:
                _check_empty({k: sub[k] for k in unknown}, f"{C.ZERO_OPTIMIZATION}.{block}", _OFFLOAD_KEYS)
            if sub.get("device", "none") not in ("none", "cpu", "nvme"):
                raise DeepSpeedConfigError(
                    f"{C.ZERO_OPTIMIZATION}.{block}.device must be none|cpu|nvme, got {sub['device']}"
                )
            if sub.get("device", "none") != "none":
                raise _not_ported(f"{C.ZERO_OPTIMIZATION}.{block}", "A12")
        for key, (default, item) in _ZERO_NOT_PORTED.items():
            if key in d and d.pop(key) != default:
                raise _not_ported(f"{C.ZERO_OPTIMIZATION}.{key}", item)
        _check_empty(d, C.ZERO_OPTIMIZATION,
                     ("stage", "offload_param", "offload_optimizer", *_ZERO_NOT_PORTED))
        if not (0 <= out.stage <= C.MAX_STAGE_ZERO_OPTIMIZATION):
            raise DeepSpeedConfigError(f"zero_optimization.stage must be in [0,3], got {out.stage}")
        return out


def _check_mesh(d: Optional[Dict[str, Any]]) -> None:
    """The ``mesh`` block on one device: ``data`` may be -1 (whatever is
    left) or 1, every other axis 1.  More devices raise (ROADMAP A6)."""
    if d is None:
        return
    d = dict(d)
    sizes = {axis: int(d.pop(axis, -1 if axis == "data" else 1)) for axis in C.MESH_AXES}
    _check_empty(d, C.MESH, C.MESH_AXES)
    if sizes["data"] not in (-1, 1) or any(sizes[a] != 1 for a in C.MESH_AXES if a != "data"):
        raise _not_ported(f"{C.MESH} {sizes} (more than one device)", "A6")


def _off_block(v: Any) -> bool:
    """A block at its "off" default: absent, empty, or only
    ``enabled: false``."""
    return v is None or v == {} or v == {"enabled": False}


# top-level keys of the JAX package that the port does not honour yet:
# key -> (predicate "at its off default", ROADMAP item)
_TOP_NOT_PORTED = {
    "amp": (_off_block, "A13"),
    "prescale_gradients": (lambda v: v is False, "A6"),
    "gradient_predivide_factor": (lambda v: v == 1.0, "A6"),
    "sparse_gradients": (lambda v: v is False, "A13 csr_tensor.py"),
    "fp32_allreduce": (lambda v: v is False, "A6"),
    "wall_clock_breakdown": (lambda v: v is False, "A14"),
    "memory_breakdown": (lambda v: v is False, "A14"),
    "dump_state": (lambda v: v is False, "A14"),
    "disable_allgather": (lambda v: v is False, "A6"),
    "tensorboard": (_off_block, "A14"),
    "pipeline": (_off_block, "A11 runtime/pipe/"),
    "checkpoint_tag_validation": (lambda v: v == "Warn", "A4 checkpoints"),
    "resilience": (_off_block, "A14 resilience/"),
    "overlap": (_off_block, "A5 runtime/overlap/"),
    "sanitizer": (_off_block, "A15"),
    "comm": (_off_block, "A6 comm/"),
    "telemetry": (_off_block, "A14 telemetry/"),
    "kernels": (lambda v: v is None or v == {} or v == {"enabled": "auto"},
                "B (the port has no kernel switch: CUDA tensors always take the kernels)"),
    "activation_checkpointing": (_off_block, "A13 activation_checkpointing/"),
    "flops_profiler": (_off_block, "A14 profiling/flops_profiler.py"),
    "aio": (_off_block, "A12 ops/aio/"),
    "elasticity": (_off_block, "A14 elasticity/"),
    "quantize_training": (_off_block, "A13 runtime/quantize.py"),
    "progressive_layer_drop": (_off_block, "A13 progressive_layer_drop.py"),
    "sparse_attention": (_off_block, "A10"),
    "zero_allow_untested_optimizer": (lambda v: v is False, "A6"),
    "dataloader_drop_last": (lambda v: v is False, "A5 runtime/dataloader.py"),
}

_PORTED_TOP_LEVEL = {
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.GRADIENT_ACCUMULATION_STEPS,
    C.OPTIMIZER, C.SCHEDULER, C.FP16, C.BF16, C.ZERO_OPTIMIZATION, C.GRADIENT_CLIPPING,
    C.STEPS_PER_PRINT, C.SEED, C.MESH, C.SERVING,
}
# the JAX package's ``_KNOWN_TOP_LEVEL``
_KNOWN_TOP_LEVEL = _PORTED_TOP_LEVEL | set(_TOP_NOT_PORTED)


class DeepSpeedConfig:
    """Parse a config dict / JSON path and resolve the batch-size triad.
    The port runs on one device: the data-parallel world size is 1."""

    world_size = 1

    def __init__(self, config: Any):
        if isinstance(config, str):
            with open(config, "r") as f:
                d = json.load(f)
        elif isinstance(config, dict):
            d = json.loads(json.dumps(config))  # deep copy + json-type check
        else:
            raise DeepSpeedConfigError(f"config must be a dict or a path to a JSON file, got {type(config)}")

        unknown = set(d.keys()) - _KNOWN_TOP_LEVEL
        if unknown:
            raise DeepSpeedConfigError(
                "Unknown top-level config key(s): " + _describe_unknown(unknown, "", _KNOWN_TOP_LEVEL)
            )

        self.train_batch_size = d.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = d.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = d.get(C.GRADIENT_ACCUMULATION_STEPS)

        self.optimizer = OptimizerConfig.from_dict(d.get(C.OPTIMIZER))
        self.scheduler = SchedulerConfig.from_dict(d.get(C.SCHEDULER))
        self.fp16 = Fp16Config.from_dict(d.get(C.FP16))
        self.bf16 = Bf16Config.from_dict(d.get(C.BF16))
        self.zero_config = ZeroConfig.from_dict(d.get(C.ZERO_OPTIMIZATION))
        _check_mesh(d.get(C.MESH))
        self.serving = ServingConfig.from_dict(d.get(C.SERVING))
        self.gradient_clipping = float(d.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT))
        self.steps_per_print = int(d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT))
        self.seed = int(d.get(C.SEED, C.SEED_DEFAULT))
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        for key, (is_off, item) in _TOP_NOT_PORTED.items():
            if key in d and not is_off(d[key]):
                raise _not_ported(key, item)
        self._resolve_batch_triad()

    # --- batch triad (reference runtime/config.py:736-898) ---
    def _resolve_batch_triad(self) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        ws = self.world_size

        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas, rem = divmod(train, micro * ws)
            if rem:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({train}) not divisible by micro_batch*world_size ({micro}*{ws})"
                )
        elif train is not None and gas is not None:
            micro, rem = divmod(train, gas * ws)
            if rem:
                raise DeepSpeedConfigError(
                    f"train_batch_size ({train}) not divisible by grad_accum*world_size ({gas}*{ws})"
                )
        elif micro is not None and gas is not None:
            train = micro * gas * ws
        elif train is not None:
            gas = 1
            micro, rem = divmod(train, ws)
            if rem:
                raise DeepSpeedConfigError(f"train_batch_size ({train}) not divisible by world_size ({ws})")
        elif micro is not None:
            gas = 1
            train = micro * ws
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size / train_micro_batch_size_per_gpu must be set"
            )

        self.train_batch_size = int(train)
        self.train_micro_batch_size_per_gpu = int(micro)
        self.gradient_accumulation_steps = int(gas)
        if self.train_batch_size != self.train_micro_batch_size_per_gpu * self.gradient_accumulation_steps * ws:
            raise DeepSpeedConfigError(
                f"Batch triad check failed: {self.train_batch_size} != "
                f"{self.train_micro_batch_size_per_gpu} * {self.gradient_accumulation_steps} * {ws}"
            )

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage

    @property
    def compute_dtype(self) -> str:
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"
