"""The ``serving`` config block (counterpart of
``deepspeed_tpu/config/config.py::ServingConfig``).

Only the fields the slot-pool engine reads are ported.  Unknown keys
raise :class:`DeepSpeedConfigError` as in the JAX package; blocks of the
JAX serving stack that the port does not have yet raise
``NotImplementedError`` naming their ROADMAP item instead of being
accepted and ignored."""
from __future__ import annotations

import dataclasses
import difflib
from dataclasses import dataclass
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
