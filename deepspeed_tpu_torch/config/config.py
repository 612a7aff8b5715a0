"""Typed DeepSpeed JSON config (counterpart of
``deepspeed_tpu/config/config.py``).

Ported: :class:`DeepSpeedConfig` with its batch triad on one device, the
``fp16``, ``bf16``, ``optimizer``, ``scheduler`` blocks, the ZeRO
``stage``, ``gradient_clipping``, ``steps_per_print``, ``seed``, the
``serving`` block (the slot and paged pools, the request journal, the
SIGTERM drain, KV tiering, tenants, the fleet with its elastic autoscaler
and the HTTP front door; :class:`ServingConfig`, :class:`KVCacheConfig`,
:class:`KVTiersConfig`, :class:`TenantsConfig`, :class:`FleetConfig`,
:class:`ElasticConfig`, :class:`FrontdoorConfig`), the ``resilience``
block but its ``supervision`` (:class:`ResilienceConfig`), the ``overlap``
block (:class:`OverlapConfig`), ``checkpoint_tag_validation`` and
``dataloader_drop_last``, and the top-level keys the JAX package parses
and never reads again (``prescale_gradients``, ``sparse_gradients``,
``memory_breakdown``, ...), carried unread under its attribute names.  Unknown
keys raise :class:`DeepSpeedConfigError` as in the JAX package.  Keys and
blocks the JAX package knows but the port cannot honour yet are accepted
only at their "off" default; otherwise they raise ``NotImplementedError``
naming their ROADMAP item, never accepted and ignored."""
from __future__ import annotations

import dataclasses
import difflib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

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


@dataclass
class KVTiersConfig:
    """``serving.kvcache.tiers`` block: hierarchical page residency device
    memory (T0) → host memory (T1) → disk (T2), parsed and validated as in
    the JAX package (``serving/kvcache/tiers.py``)."""

    enabled: bool = C.SERVING_KVCACHE_TIERS_ENABLED_DEFAULT
    host_pages: int = C.SERVING_KVCACHE_TIERS_HOST_PAGES_DEFAULT  # 0 = unbounded
    disk_dir: str = C.SERVING_KVCACHE_TIERS_DISK_DIR_DEFAULT  # "" = no T2
    residency_window: int = C.SERVING_KVCACHE_TIERS_RESIDENCY_WINDOW_DEFAULT
    demote_watermark: float = C.SERVING_KVCACHE_TIERS_DEMOTE_WATERMARK_DEFAULT
    prefetch_ahead: int = C.SERVING_KVCACHE_TIERS_PREFETCH_AHEAD_DEFAULT
    demote_batch: int = C.SERVING_KVCACHE_TIERS_DEMOTE_BATCH_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "KVTiersConfig":
        if d is None:
            return cls()
        if isinstance(d, KVTiersConfig):
            d = dataclasses.asdict(d)
        d = dict(d)
        block = f"{C.SERVING}.{C.SERVING_KVCACHE}.{C.SERVING_KVCACHE_TIERS}"
        out = cls(
            enabled=bool(d.pop("enabled", C.SERVING_KVCACHE_TIERS_ENABLED_DEFAULT)),
            host_pages=int(d.pop("host_pages", C.SERVING_KVCACHE_TIERS_HOST_PAGES_DEFAULT)),
            disk_dir=str(d.pop("disk_dir", C.SERVING_KVCACHE_TIERS_DISK_DIR_DEFAULT) or ""),
            residency_window=int(d.pop(
                "residency_window", C.SERVING_KVCACHE_TIERS_RESIDENCY_WINDOW_DEFAULT)),
            demote_watermark=float(d.pop(
                "demote_watermark", C.SERVING_KVCACHE_TIERS_DEMOTE_WATERMARK_DEFAULT)),
            prefetch_ahead=int(d.pop(
                "prefetch_ahead", C.SERVING_KVCACHE_TIERS_PREFETCH_AHEAD_DEFAULT)),
            demote_batch=int(d.pop("demote_batch", C.SERVING_KVCACHE_TIERS_DEMOTE_BATCH_DEFAULT)),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.host_pages < 0:
            raise DeepSpeedConfigError(
                f"'{block}.host_pages' must be >= 0 (0 = unbounded), got {out.host_pages}"
            )
        if out.residency_window < 0:
            raise DeepSpeedConfigError(
                f"'{block}.residency_window' must be >= 0 (0 keeps whole "
                f"sessions resident), got {out.residency_window}"
            )
        if not (0.0 < out.demote_watermark <= 1.0):
            raise DeepSpeedConfigError(
                f"'{block}.demote_watermark' must be in (0, 1], got {out.demote_watermark}"
            )
        if out.prefetch_ahead < 0:
            raise DeepSpeedConfigError(
                f"'{block}.prefetch_ahead' must be >= 0, got {out.prefetch_ahead}"
            )
        if out.demote_batch < 1:
            raise DeepSpeedConfigError(
                f"'{block}.demote_batch' must be >= 1, got {out.demote_batch}"
            )
        return out


@dataclass
class KVCacheConfig:
    """``serving.kvcache`` block: the paged KV pool — fixed-shape page
    buffers with a host page allocator, shared-prefix dedup via a radix
    index, copy-on-write for partially filled shared pages, and durable
    per-``session_id`` KV reuse (warm in-pool, spilled to ``spill_dir``
    when cold)."""

    enabled: bool = C.SERVING_KVCACHE_ENABLED_DEFAULT
    page_len: int = C.SERVING_KVCACHE_PAGE_LEN_DEFAULT
    num_pages: int = C.SERVING_KVCACHE_NUM_PAGES_DEFAULT  # 0 = derive
    # prompt prefixes (token-id lists) pre-registered in the radix index
    # at engine start; pinned entries are never evicted under pressure
    pinned_prefixes: Tuple[Tuple[int, ...], ...] = ()
    session_ttl_seconds: float = C.SERVING_KVCACHE_SESSION_TTL_SECONDS_DEFAULT
    spill_dir: str = C.SERVING_KVCACHE_SPILL_DIR_DEFAULT
    tiers: KVTiersConfig = field(default_factory=KVTiersConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "KVCacheConfig":
        if d is None:
            return cls()
        if isinstance(d, KVCacheConfig):
            d = dataclasses.asdict(d)
        d = dict(d)
        block = f"{C.SERVING}.{C.SERVING_KVCACHE}"
        tiers = KVTiersConfig.from_dict(d.pop(C.SERVING_KVCACHE_TIERS, None))
        raw_pins = d.pop("pinned_prefixes", ())
        if raw_pins is None:
            raw_pins = ()
        if not isinstance(raw_pins, (list, tuple)):
            raise DeepSpeedConfigError(
                f"'{block}.pinned_prefixes' must be a list of token-id "
                f"lists, got {type(raw_pins).__name__}"
            )
        pins: List[Tuple[int, ...]] = []
        for i, spec in enumerate(raw_pins):
            if not isinstance(spec, (list, tuple)) or not spec:
                raise DeepSpeedConfigError(
                    f"'{block}.pinned_prefixes[{i}]' must be a non-empty "
                    f"list of token ids"
                )
            pins.append(tuple(int(t) for t in spec))
        out = cls(
            tiers=tiers,
            enabled=bool(d.pop("enabled", C.SERVING_KVCACHE_ENABLED_DEFAULT)),
            page_len=int(d.pop("page_len", C.SERVING_KVCACHE_PAGE_LEN_DEFAULT)),
            num_pages=int(d.pop("num_pages", C.SERVING_KVCACHE_NUM_PAGES_DEFAULT)),
            pinned_prefixes=tuple(pins),
            session_ttl_seconds=float(
                d.pop("session_ttl_seconds", C.SERVING_KVCACHE_SESSION_TTL_SECONDS_DEFAULT)
            ),
            spill_dir=str(d.pop("spill_dir", C.SERVING_KVCACHE_SPILL_DIR_DEFAULT) or ""),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.page_len < 1:
            raise DeepSpeedConfigError(f"'{block}.page_len' must be >= 1, got {out.page_len}")
        if out.num_pages < 0:
            raise DeepSpeedConfigError(
                f"'{block}.num_pages' must be >= 0 (0 derives it from the "
                f"slot capacity), got {out.num_pages}"
            )
        if out.session_ttl_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{block}.session_ttl_seconds' must be >= 0, got {out.session_ttl_seconds}"
            )
        return out


# per-tenant override spec keys accepted under serving.tenants.overrides
_TENANT_SPEC_KEYS = (
    "refill_tokens_per_second",
    "burst_tokens",
    "weight",
    "slo_class",
    "kv_pages_max",
    "pinned_prefixes_max",
)


@dataclass
class TenantsConfig:
    """``serving.tenants`` block: the multi-tenant dimension — per-tenant token-bucket admission rates,
    weighted-fair queueing ahead of priority tiers, SLO classes mapped
    onto the degradation ladder's priorities, and per-tenant paged-KV
    page / pinned-prefix quotas.  Field values are the defaults for any
    tenant; ``overrides`` refines them per tenant name."""

    enabled: bool = C.SERVING_TENANTS_ENABLED_DEFAULT
    refill_tokens_per_second: float = (
        C.SERVING_TENANTS_REFILL_TOKENS_PER_SECOND_DEFAULT)
    burst_tokens: float = C.SERVING_TENANTS_BURST_TOKENS_DEFAULT
    weight: float = C.SERVING_TENANTS_WEIGHT_DEFAULT
    slo_class: str = C.SERVING_TENANTS_SLO_CLASS_DEFAULT
    kv_pages_max: int = C.SERVING_TENANTS_KV_PAGES_MAX_DEFAULT
    pinned_prefixes_max: int = C.SERVING_TENANTS_PINNED_PREFIXES_MAX_DEFAULT
    overrides: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "TenantsConfig":
        if d is None:
            return cls()
        if isinstance(d, TenantsConfig):
            d = dataclasses.asdict(d)
        d = dict(d)
        block = f"{C.SERVING}.{C.SERVING_TENANTS}"
        raw_over = d.pop("overrides", None) or {}
        if not isinstance(raw_over, dict):
            raise DeepSpeedConfigError(
                f"'{block}.overrides' must be a dict of per-tenant spec "
                f"dicts, got {type(raw_over).__name__}"
            )
        overrides: Dict[str, Dict[str, Any]] = {}
        for name, spec in raw_over.items():
            if not isinstance(spec, dict):
                raise DeepSpeedConfigError(
                    f"'{block}.overrides[{name!r}]' must be a dict, "
                    f"got {type(spec).__name__}"
                )
            unknown = sorted(set(spec) - set(_TENANT_SPEC_KEYS))
            if unknown:
                raise DeepSpeedConfigError(
                    f"'{block}.overrides[{name!r}]' has unknown keys "
                    f"{unknown}; known: {sorted(_TENANT_SPEC_KEYS)}"
                )
            slo = spec.get("slo_class")
            if slo is not None and slo not in C.SERVING_TENANTS_SLO_CLASSES:
                raise DeepSpeedConfigError(
                    f"'{block}.overrides[{name!r}].slo_class' must be one "
                    f"of {C.SERVING_TENANTS_SLO_CLASSES}, got '{slo}'"
                )
            overrides[str(name)] = dict(spec)
        out = cls(
            enabled=bool(d.pop("enabled", C.SERVING_TENANTS_ENABLED_DEFAULT)),
            refill_tokens_per_second=float(
                d.pop("refill_tokens_per_second",
                     C.SERVING_TENANTS_REFILL_TOKENS_PER_SECOND_DEFAULT)
            ),
            burst_tokens=float(
                d.pop("burst_tokens", C.SERVING_TENANTS_BURST_TOKENS_DEFAULT)
            ),
            weight=float(d.pop("weight", C.SERVING_TENANTS_WEIGHT_DEFAULT)),
            slo_class=str(
                d.pop("slo_class", C.SERVING_TENANTS_SLO_CLASS_DEFAULT)
            ).lower(),
            kv_pages_max=int(
                d.pop("kv_pages_max", C.SERVING_TENANTS_KV_PAGES_MAX_DEFAULT)
            ),
            pinned_prefixes_max=int(
                d.pop("pinned_prefixes_max",
                     C.SERVING_TENANTS_PINNED_PREFIXES_MAX_DEFAULT)
            ),
            overrides=overrides,
        )
        _check_empty(d, block, _known_keys(cls))
        if out.refill_tokens_per_second < 0:
            raise DeepSpeedConfigError(
                f"'{block}.refill_tokens_per_second' must be >= 0 "
                f"(0 with burst_tokens 0 = unlimited), "
                f"got {out.refill_tokens_per_second}"
            )
        if out.burst_tokens < 0:
            raise DeepSpeedConfigError(
                f"'{block}.burst_tokens' must be >= 0, got {out.burst_tokens}"
            )
        if out.weight <= 0:
            raise DeepSpeedConfigError(
                f"'{block}.weight' must be > 0, got {out.weight}"
            )
        if out.slo_class not in C.SERVING_TENANTS_SLO_CLASSES:
            raise DeepSpeedConfigError(
                f"'{block}.slo_class' must be one of "
                f"{C.SERVING_TENANTS_SLO_CLASSES}, got '{out.slo_class}'"
            )
        if out.kv_pages_max < 0 or out.pinned_prefixes_max < 0:
            raise DeepSpeedConfigError(
                f"'{block}.kv_pages_max'/'pinned_prefixes_max' must be >= 0 "
                f"(0 = uncapped), got "
                f"{out.kv_pages_max}/{out.pinned_prefixes_max}"
            )
        return out


@dataclass
class ElasticConfig:
    """``serving.fleet.elastic`` block (``serving/fleet/elastic.py``):
    load-driven autoscaling — hot/cold tick hysteresis over the
    router's own signals (queue depth, admitted-TTFT estimate, shed),
    warm-pool scale-up, and drain-based scale-down with live KV session
    migration to the survivors over the spill-manifest wire format."""

    enabled: bool = C.SERVING_FLEET_ELASTIC_ENABLED_DEFAULT
    min_replicas: int = C.SERVING_FLEET_ELASTIC_MIN_REPLICAS_DEFAULT
    max_replicas: int = C.SERVING_FLEET_ELASTIC_MAX_REPLICAS_DEFAULT
    scale_up_queue_depth: int = C.SERVING_FLEET_ELASTIC_SCALE_UP_QUEUE_DEPTH_DEFAULT
    scale_up_ttft_seconds: float = C.SERVING_FLEET_ELASTIC_SCALE_UP_TTFT_SECONDS_DEFAULT
    scale_down_queue_depth: int = (
        C.SERVING_FLEET_ELASTIC_SCALE_DOWN_QUEUE_DEPTH_DEFAULT
    )
    engage_ticks: int = C.SERVING_FLEET_ELASTIC_ENGAGE_TICKS_DEFAULT
    disengage_ticks: int = C.SERVING_FLEET_ELASTIC_DISENGAGE_TICKS_DEFAULT
    scale_up_cooldown_seconds: float = (
        C.SERVING_FLEET_ELASTIC_SCALE_UP_COOLDOWN_SECONDS_DEFAULT
    )
    scale_down_cooldown_seconds: float = (
        C.SERVING_FLEET_ELASTIC_SCALE_DOWN_COOLDOWN_SECONDS_DEFAULT
    )
    warm_pool_size: int = C.SERVING_FLEET_ELASTIC_WARM_POOL_SIZE_DEFAULT
    migration_deadline_seconds: float = (
        C.SERVING_FLEET_ELASTIC_MIGRATION_DEADLINE_SECONDS_DEFAULT
    )
    migration_retries: int = C.SERVING_FLEET_ELASTIC_MIGRATION_RETRIES_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ElasticConfig":
        if d is None:
            return cls()
        if isinstance(d, ElasticConfig):
            d = dataclasses.asdict(d)
        d = dict(d)
        block = f"{C.SERVING}.{C.SERVING_FLEET}.{C.SERVING_FLEET_ELASTIC}"
        out = cls(
            enabled=bool(d.pop("enabled", C.SERVING_FLEET_ELASTIC_ENABLED_DEFAULT)),
            min_replicas=int(
                d.pop("min_replicas", C.SERVING_FLEET_ELASTIC_MIN_REPLICAS_DEFAULT)
            ),
            max_replicas=int(
                d.pop("max_replicas", C.SERVING_FLEET_ELASTIC_MAX_REPLICAS_DEFAULT)
            ),
            scale_up_queue_depth=int(
                d.pop("scale_up_queue_depth",
                     C.SERVING_FLEET_ELASTIC_SCALE_UP_QUEUE_DEPTH_DEFAULT)
            ),
            scale_up_ttft_seconds=float(
                d.pop("scale_up_ttft_seconds",
                     C.SERVING_FLEET_ELASTIC_SCALE_UP_TTFT_SECONDS_DEFAULT)
            ),
            scale_down_queue_depth=int(
                d.pop("scale_down_queue_depth",
                     C.SERVING_FLEET_ELASTIC_SCALE_DOWN_QUEUE_DEPTH_DEFAULT)
            ),
            engage_ticks=int(
                d.pop("engage_ticks", C.SERVING_FLEET_ELASTIC_ENGAGE_TICKS_DEFAULT)
            ),
            disengage_ticks=int(
                d.pop("disengage_ticks",
                     C.SERVING_FLEET_ELASTIC_DISENGAGE_TICKS_DEFAULT)
            ),
            scale_up_cooldown_seconds=float(
                d.pop("scale_up_cooldown_seconds",
                     C.SERVING_FLEET_ELASTIC_SCALE_UP_COOLDOWN_SECONDS_DEFAULT)
            ),
            scale_down_cooldown_seconds=float(
                d.pop("scale_down_cooldown_seconds",
                     C.SERVING_FLEET_ELASTIC_SCALE_DOWN_COOLDOWN_SECONDS_DEFAULT)
            ),
            warm_pool_size=int(
                d.pop("warm_pool_size",
                     C.SERVING_FLEET_ELASTIC_WARM_POOL_SIZE_DEFAULT)
            ),
            migration_deadline_seconds=float(
                d.pop("migration_deadline_seconds",
                     C.SERVING_FLEET_ELASTIC_MIGRATION_DEADLINE_SECONDS_DEFAULT)
            ),
            migration_retries=int(
                d.pop("migration_retries",
                     C.SERVING_FLEET_ELASTIC_MIGRATION_RETRIES_DEFAULT)
            ),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.min_replicas < 1:
            raise DeepSpeedConfigError(
                f"'{block}.min_replicas' must be >= 1, got {out.min_replicas}"
            )
        if out.max_replicas < out.min_replicas:
            raise DeepSpeedConfigError(
                f"'{block}.max_replicas' ({out.max_replicas}) must be >= "
                f"min_replicas ({out.min_replicas})"
            )
        if out.scale_up_queue_depth < 1:
            raise DeepSpeedConfigError(
                f"'{block}.scale_up_queue_depth' must be >= 1, "
                f"got {out.scale_up_queue_depth}"
            )
        if out.scale_up_ttft_seconds <= 0:
            raise DeepSpeedConfigError(
                f"'{block}.scale_up_ttft_seconds' must be > 0, "
                f"got {out.scale_up_ttft_seconds}"
            )
        if out.scale_down_queue_depth < 0:
            raise DeepSpeedConfigError(
                f"'{block}.scale_down_queue_depth' must be >= 0, "
                f"got {out.scale_down_queue_depth}"
            )
        if out.scale_down_queue_depth >= out.scale_up_queue_depth:
            raise DeepSpeedConfigError(
                f"'{block}.scale_down_queue_depth' "
                f"({out.scale_down_queue_depth}) must be < "
                f"scale_up_queue_depth ({out.scale_up_queue_depth}) — "
                f"overlapping thresholds would flap"
            )
        if out.engage_ticks < 1:
            raise DeepSpeedConfigError(
                f"'{block}.engage_ticks' must be >= 1, got {out.engage_ticks}"
            )
        if out.disengage_ticks < 1:
            raise DeepSpeedConfigError(
                f"'{block}.disengage_ticks' must be >= 1, "
                f"got {out.disengage_ticks}"
            )
        if out.scale_up_cooldown_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{block}.scale_up_cooldown_seconds' must be >= 0, "
                f"got {out.scale_up_cooldown_seconds}"
            )
        if out.scale_down_cooldown_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{block}.scale_down_cooldown_seconds' must be >= 0, "
                f"got {out.scale_down_cooldown_seconds}"
            )
        if out.warm_pool_size < 0:
            raise DeepSpeedConfigError(
                f"'{block}.warm_pool_size' must be >= 0, "
                f"got {out.warm_pool_size}"
            )
        if out.migration_deadline_seconds <= 0:
            raise DeepSpeedConfigError(
                f"'{block}.migration_deadline_seconds' must be > 0, "
                f"got {out.migration_deadline_seconds}"
            )
        if out.migration_retries < 0:
            raise DeepSpeedConfigError(
                f"'{block}.migration_retries' must be >= 0, "
                f"got {out.migration_retries}"
            )
        return out


@dataclass
class FleetConfig:
    """``serving.fleet`` block (``serving/fleet/router.py``): the
    router over N engine replicas — least-estimated-TTFT placement, a
    per-replica circuit breaker with seeded-jitter exponential backoff,
    optional tail-latency hedging, and supervised lossless replica
    restart (journal replay under original ids)."""

    replicas: int = C.SERVING_FLEET_REPLICAS_DEFAULT
    route_retries: int = C.SERVING_FLEET_ROUTE_RETRIES_DEFAULT
    breaker_failures: int = C.SERVING_FLEET_BREAKER_FAILURES_DEFAULT
    breaker_backoff_seconds: float = C.SERVING_FLEET_BREAKER_BACKOFF_SECONDS_DEFAULT
    breaker_backoff_max_seconds: float = (
        C.SERVING_FLEET_BREAKER_BACKOFF_MAX_SECONDS_DEFAULT
    )
    breaker_halfopen_probes: int = C.SERVING_FLEET_BREAKER_HALFOPEN_PROBES_DEFAULT
    hedge: bool = C.SERVING_FLEET_HEDGE_DEFAULT
    hedge_factor: float = C.SERVING_FLEET_HEDGE_FACTOR_DEFAULT
    hedge_min_observations: int = C.SERVING_FLEET_HEDGE_MIN_OBSERVATIONS_DEFAULT
    max_restarts: int = C.SERVING_FLEET_MAX_RESTARTS_DEFAULT
    restart_backoff_seconds: float = C.SERVING_FLEET_RESTART_BACKOFF_SECONDS_DEFAULT
    restart_budget_reset_seconds: float = (
        C.SERVING_FLEET_RESTART_BUDGET_RESET_SECONDS_DEFAULT
    )
    elastic: ElasticConfig = field(default_factory=ElasticConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "FleetConfig":
        if d is None:
            return cls()
        if isinstance(d, FleetConfig):
            d = dataclasses.asdict(d)
        d = dict(d)
        block = f"{C.SERVING}.{C.SERVING_FLEET}"
        elastic = ElasticConfig.from_dict(d.pop(C.SERVING_FLEET_ELASTIC, None))
        out = cls(
            replicas=int(d.pop("replicas", C.SERVING_FLEET_REPLICAS_DEFAULT)),
            route_retries=int(
                d.pop("route_retries", C.SERVING_FLEET_ROUTE_RETRIES_DEFAULT)
            ),
            breaker_failures=int(
                d.pop("breaker_failures", C.SERVING_FLEET_BREAKER_FAILURES_DEFAULT)
            ),
            breaker_backoff_seconds=float(
                d.pop("breaker_backoff_seconds",
                     C.SERVING_FLEET_BREAKER_BACKOFF_SECONDS_DEFAULT)
            ),
            breaker_backoff_max_seconds=float(
                d.pop("breaker_backoff_max_seconds",
                     C.SERVING_FLEET_BREAKER_BACKOFF_MAX_SECONDS_DEFAULT)
            ),
            breaker_halfopen_probes=int(
                d.pop("breaker_halfopen_probes",
                     C.SERVING_FLEET_BREAKER_HALFOPEN_PROBES_DEFAULT)
            ),
            hedge=bool(d.pop("hedge", C.SERVING_FLEET_HEDGE_DEFAULT)),
            hedge_factor=float(
                d.pop("hedge_factor", C.SERVING_FLEET_HEDGE_FACTOR_DEFAULT)
            ),
            hedge_min_observations=int(
                d.pop("hedge_min_observations",
                     C.SERVING_FLEET_HEDGE_MIN_OBSERVATIONS_DEFAULT)
            ),
            max_restarts=int(
                d.pop("max_restarts", C.SERVING_FLEET_MAX_RESTARTS_DEFAULT)
            ),
            restart_backoff_seconds=float(
                d.pop("restart_backoff_seconds",
                     C.SERVING_FLEET_RESTART_BACKOFF_SECONDS_DEFAULT)
            ),
            restart_budget_reset_seconds=float(
                d.pop("restart_budget_reset_seconds",
                     C.SERVING_FLEET_RESTART_BUDGET_RESET_SECONDS_DEFAULT)
            ),
            elastic=elastic,
        )
        _check_empty(d, block, _known_keys(cls))
        if out.replicas < 1:
            raise DeepSpeedConfigError(
                f"'{block}.replicas' must be >= 1, got {out.replicas}"
            )
        if out.route_retries < 0:
            raise DeepSpeedConfigError(
                f"'{block}.route_retries' must be >= 0, got {out.route_retries}"
            )
        if out.breaker_failures < 1:
            raise DeepSpeedConfigError(
                f"'{block}.breaker_failures' must be >= 1, got {out.breaker_failures}"
            )
        if out.breaker_backoff_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{block}.breaker_backoff_seconds' must be >= 0, "
                f"got {out.breaker_backoff_seconds}"
            )
        if out.breaker_backoff_max_seconds < out.breaker_backoff_seconds:
            raise DeepSpeedConfigError(
                f"'{block}.breaker_backoff_max_seconds' "
                f"({out.breaker_backoff_max_seconds}) must be >= "
                f"breaker_backoff_seconds ({out.breaker_backoff_seconds})"
            )
        if out.breaker_halfopen_probes < 1:
            raise DeepSpeedConfigError(
                f"'{block}.breaker_halfopen_probes' must be >= 1, "
                f"got {out.breaker_halfopen_probes}"
            )
        if out.hedge_factor <= 0:
            raise DeepSpeedConfigError(
                f"'{block}.hedge_factor' must be > 0, got {out.hedge_factor}"
            )
        if out.hedge_min_observations < 1:
            raise DeepSpeedConfigError(
                f"'{block}.hedge_min_observations' must be >= 1, "
                f"got {out.hedge_min_observations}"
            )
        if out.max_restarts < 0:
            raise DeepSpeedConfigError(
                f"'{block}.max_restarts' must be >= 0 (0 = never restart), "
                f"got {out.max_restarts}"
            )
        if out.restart_backoff_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{block}.restart_backoff_seconds' must be >= 0, "
                f"got {out.restart_backoff_seconds}"
            )
        if out.restart_budget_reset_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{block}.restart_budget_reset_seconds' must be >= 0 "
                f"(0 = budget never decays), "
                f"got {out.restart_budget_reset_seconds}"
            )
        return out


@dataclass
class FrontdoorConfig:
    """``serving.frontdoor`` block (``serving/frontdoor/http.py``): the
    stdlib HTTP front-door — chunked streaming token responses, request
    deadlines mapped onto scheduler deadlines, ``Retry-After``-bearing
    429/503 overload answers, and SIGTERM graceful drain composed with
    the serving watchdog."""

    enabled: bool = C.SERVING_FRONTDOOR_ENABLED_DEFAULT
    host: str = C.SERVING_FRONTDOOR_HOST_DEFAULT
    port: int = C.SERVING_FRONTDOOR_PORT_DEFAULT  # 0 = ephemeral
    stream_poll_seconds: float = C.SERVING_FRONTDOOR_STREAM_POLL_SECONDS_DEFAULT
    max_body_bytes: int = C.SERVING_FRONTDOOR_MAX_BODY_BYTES_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "FrontdoorConfig":
        if d is None:
            return cls()
        if isinstance(d, FrontdoorConfig):
            d = dataclasses.asdict(d)
        d = dict(d)
        block = f"{C.SERVING}.{C.SERVING_FRONTDOOR}"
        out = cls(
            enabled=bool(d.pop("enabled", C.SERVING_FRONTDOOR_ENABLED_DEFAULT)),
            host=str(d.pop("host", C.SERVING_FRONTDOOR_HOST_DEFAULT)),
            port=int(d.pop("port", C.SERVING_FRONTDOOR_PORT_DEFAULT)),
            stream_poll_seconds=float(
                d.pop("stream_poll_seconds",
                     C.SERVING_FRONTDOOR_STREAM_POLL_SECONDS_DEFAULT)
            ),
            max_body_bytes=int(
                d.pop("max_body_bytes",
                     C.SERVING_FRONTDOOR_MAX_BODY_BYTES_DEFAULT)
            ),
        )
        _check_empty(d, block, _known_keys(cls))
        if not 0 <= out.port <= 65535:
            raise DeepSpeedConfigError(
                f"'{block}.port' must be in [0, 65535] (0 = ephemeral), "
                f"got {out.port}"
            )
        if out.stream_poll_seconds <= 0:
            raise DeepSpeedConfigError(
                f"'{block}.stream_poll_seconds' must be > 0, "
                f"got {out.stream_poll_seconds}"
            )
        if out.max_body_bytes < 1:
            raise DeepSpeedConfigError(
                f"'{block}.max_body_bytes' must be >= 1, "
                f"got {out.max_body_bytes}"
            )
        return out


@dataclass
class ServingConfig:
    """``serving`` block: the continuous-batching slot-pool engine.
    ``num_slots`` concurrent sequences share one fixed-shape KV pool;
    prompts prefill in ``prefill_chunk``-token chunks interleaved with
    decode steps; ``max_queue`` bounds admission and
    ``deadline_seconds`` expires requests that wait too long for a
    slot.  ``kvcache.enabled`` swaps the slot pool for the paged pool.
    ``journal_dir`` arms the write-ahead request journal,
    ``drain_deadline_seconds`` bounds the SIGTERM drain, ``tenants``
    the multi-tenant dimension, ``fleet`` the router over replicas and
    ``frontdoor`` the HTTP server."""

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
    kvcache: KVCacheConfig = field(default_factory=KVCacheConfig)
    # graceful drain: SIGTERM stops admission and drains in-flight
    # requests for at most this long before the journal commit + exit 43
    drain_deadline_seconds: float = C.SERVING_DRAIN_DEADLINE_SECONDS_DEFAULT
    # write-ahead request journal ("" = off): submit/admit/first-token/
    # retire records under serving/journal.py's atomic segment protocol
    journal_dir: str = C.SERVING_JOURNAL_DIR_DEFAULT
    journal_segment_records: int = C.SERVING_JOURNAL_SEGMENT_RECORDS_DEFAULT
    journal_keep_segments: int = C.SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT
    # per-tenant rate limits, weighted-fair queueing, SLO classes and
    # paged-KV quotas, keyed by submit(tenant=...)
    tenants: TenantsConfig = field(default_factory=TenantsConfig)
    # the router over engine replicas: placement, breakers, hedging,
    # supervised restart, and the elastic autoscaler (serving/fleet/)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    # the stdlib HTTP front door (serving/frontdoor/http.py)
    frontdoor: FrontdoorConfig = field(default_factory=FrontdoorConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ServingConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            fleet=FleetConfig.from_dict(d.pop(C.SERVING_FLEET, None)),
            kvcache=KVCacheConfig.from_dict(d.pop(C.SERVING_KVCACHE, None)),
            frontdoor=FrontdoorConfig.from_dict(d.pop(C.SERVING_FRONTDOOR, None)),
            tenants=TenantsConfig.from_dict(d.pop(C.SERVING_TENANTS, None)),
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
            drain_deadline_seconds=float(
                d.pop("drain_deadline_seconds", C.SERVING_DRAIN_DEADLINE_SECONDS_DEFAULT)
            ),
            journal_dir=str(d.pop("journal_dir", C.SERVING_JOURNAL_DIR_DEFAULT) or ""),
            journal_segment_records=int(
                d.pop("journal_segment_records", C.SERVING_JOURNAL_SEGMENT_RECORDS_DEFAULT)
            ),
            journal_keep_segments=int(
                d.pop("journal_keep_segments", C.SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT)
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
        if out.drain_deadline_seconds < 0:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.drain_deadline_seconds' must be >= 0, "
                f"got {out.drain_deadline_seconds}"
            )
        if out.journal_segment_records < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.journal_segment_records' must be >= 1, "
                f"got {out.journal_segment_records}"
            )
        if out.journal_keep_segments < 1:
            raise DeepSpeedConfigError(
                f"'{C.SERVING}.journal_keep_segments' must be >= 1, "
                f"got {out.journal_keep_segments}"
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


_OFFLOAD_KEYS = ("device", "nvme_path", "buffer_count", "buffer_size", "pin_memory",
                 "pipeline_read", "pipeline_write", "fast_init", "max_in_cpu", "ratio")


def _pop_alias(d: Dict[str, Any], key: str, alias: str, default: Any, block: str) -> Any:
    """Pop a key that also has a reference-compat alias; both spellings
    at once raise (the JAX package's rule)."""
    if key in d and alias in d:
        raise DeepSpeedConfigError(
            f"'{block}.{key}' and its alias '{block}.{alias}' are both set; use one"
        )
    return d.pop(key, d.pop(alias, default))


@dataclass
class ZeroConfig:
    """``zero_optimization``, parsed as the JAX package parses it.  The
    engine reads what the JAX engine reads: ``stage``, ``reduce_scatter``,
    ``cross_replica_weight_update`` and ``param_persistence_threshold``
    (alias ``stage3_param_persistence_threshold``); the bucket, overlap,
    live-parameter and checkpoint knobs are carried, unread, as there.
    Offload (``offload_param``, ``offload_optimizer``, ``cpu_offload``)
    raises (ROADMAP A12)."""

    stage: int = C.ZERO_STAGE_DEFAULT
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = True
    sub_group_size: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_fp16_weights_on_model_save: bool = False
    round_robin_gradients: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    cross_replica_weight_update: bool = True

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        if d is None:
            return cls()
        d = dict(d)
        block = C.ZERO_OPTIMIZATION
        for sub_name in ("offload_param", "offload_optimizer"):
            sub = d.pop(sub_name, None)
            if sub is None:
                continue
            sub = dict(sub)
            unknown = set(sub) - set(_OFFLOAD_KEYS)
            if unknown:
                _check_empty({k: sub[k] for k in unknown}, f"{block}.{sub_name}", _OFFLOAD_KEYS)
            if sub.get("device", "none") not in ("none", "cpu", "nvme"):
                raise DeepSpeedConfigError(
                    f"{block}.{sub_name}.device must be none|cpu|nvme, got {sub['device']}"
                )
            if sub.get("device", "none") != "none":
                raise _not_ported(f"{block}.{sub_name}", "A12")
        if bool(d.pop("cpu_offload", False)):
            raise _not_ported(f"{block}.cpu_offload", "A12")
        out = cls(
            stage=int(d.pop(C.ZERO_STAGE, C.ZERO_STAGE_DEFAULT)),
            contiguous_gradients=bool(d.pop("contiguous_gradients", True)),
            reduce_scatter=bool(d.pop("reduce_scatter", True)),
            reduce_bucket_size=int(d.pop("reduce_bucket_size", 500_000_000)),
            allgather_partitions=bool(d.pop("allgather_partitions", True)),
            allgather_bucket_size=int(d.pop("allgather_bucket_size", 500_000_000)),
            overlap_comm=bool(d.pop("overlap_comm", True)),
            load_from_fp32_weights=bool(d.pop("load_from_fp32_weights", True)),
            elastic_checkpoint=bool(d.pop("elastic_checkpoint", True)),
            sub_group_size=int(d.pop("sub_group_size", 1_000_000_000)),
            prefetch_bucket_size=int(_pop_alias(d, "stage3_prefetch_bucket_size",
                                                "prefetch_bucket_size", 50_000_000, block)),
            param_persistence_threshold=int(_pop_alias(
                d, "stage3_param_persistence_threshold", "param_persistence_threshold",
                100_000, block)),
            max_live_parameters=int(_pop_alias(d, "stage3_max_live_parameters",
                                               "max_live_parameters", 1_000_000_000, block)),
            max_reuse_distance=int(_pop_alias(d, "stage3_max_reuse_distance",
                                              "max_reuse_distance", 1_000_000_000, block)),
            gather_fp16_weights_on_model_save=bool(_pop_alias(
                d, "stage3_gather_fp16_weights_on_model_save",
                "gather_fp16_weights_on_model_save", False, block)),
            round_robin_gradients=bool(d.pop("round_robin_gradients", False)),
            ignore_unused_parameters=bool(d.pop("ignore_unused_parameters", True)),
            legacy_stage1=bool(d.pop("legacy_stage1", False)),
            cross_replica_weight_update=bool(d.pop("cross_replica_weight_update", True)),
        )
        _check_empty(d, block, _known_keys(
            cls, "offload_param", "offload_optimizer", "cpu_offload",
            "stage3_prefetch_bucket_size", "stage3_param_persistence_threshold",
            "stage3_max_live_parameters", "stage3_max_reuse_distance",
            "stage3_gather_fp16_weights_on_model_save"))
        if not (0 <= out.stage <= C.MAX_STAGE_ZERO_OPTIMIZATION):
            raise DeepSpeedConfigError(f"zero_optimization.stage must be in [0,3], got {out.stage}")
        return out


# mesh axes the port does not shard over yet, and their ROADMAP items
_MESH_NOT_PORTED = {
    "pipe": "A11 (pipeline)",
    "expert": "A11 (MoE expert parallelism)",
}


@dataclass
class MeshConfig:
    """``mesh``: the named axis sizes, parsed as the JAX package parses
    them; ``data`` defaults to whatever the world size leaves (-1).  The
    port shards over ``data``, ``fsdp``, ``seq`` and ``model``; a ``pipe``
    or ``expert`` axis larger than 1 raises, naming its item."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    AXES = ("pipe", "data", "fsdp", "seq", "model", "expert")

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "MeshConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            data=int(d.pop("data", -1)),
            fsdp=int(d.pop("fsdp", 1)),
            model=int(d.pop("model", 1)),
            pipe=int(d.pop("pipe", 1)),
            seq=int(d.pop("seq", 1)),
            expert=int(d.pop("expert", 1)),
        )
        _check_empty(d, C.MESH, _known_keys(cls))
        for axis, item in _MESH_NOT_PORTED.items():
            if getattr(out, axis) not in (1, -1):
                raise _not_ported(f"{C.MESH}.{axis} = {getattr(out, axis)}", item)
        return out


@dataclass
class CommConfig:
    """``comm``: the gradient exchange's wire strategy, parsed as the JAX
    package parses it.  The port runs ``dense``; a strategy that resolves
    to ``int8`` or ``onebit`` raises where the engine selects it
    (``comm/strategy.py``, ROADMAP A13)."""

    strategy: str = C.COMM_STRATEGY_DEFAULT
    threshold_bytes: int = C.COMM_THRESHOLD_BYTES_DEFAULT
    dcn_threshold_bytes: int = C.COMM_DCN_THRESHOLD_BYTES_DEFAULT
    quantize_bits: int = C.COMM_QUANTIZE_BITS_DEFAULT
    error_feedback: bool = C.COMM_ERROR_FEEDBACK_DEFAULT
    stochastic_rounding: bool = C.COMM_STOCHASTIC_ROUNDING_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "CommConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            strategy=str(d.pop("strategy", C.COMM_STRATEGY_DEFAULT)).lower(),
            threshold_bytes=int(d.pop("threshold_bytes", C.COMM_THRESHOLD_BYTES_DEFAULT)),
            dcn_threshold_bytes=int(d.pop("dcn_threshold_bytes",
                                          C.COMM_DCN_THRESHOLD_BYTES_DEFAULT)),
            quantize_bits=int(d.pop("quantize_bits", C.COMM_QUANTIZE_BITS_DEFAULT)),
            error_feedback=bool(d.pop("error_feedback", C.COMM_ERROR_FEEDBACK_DEFAULT)),
            stochastic_rounding=bool(d.pop("stochastic_rounding",
                                           C.COMM_STOCHASTIC_ROUNDING_DEFAULT)),
        )
        _check_empty(d, C.COMM, _known_keys(cls))
        if out.strategy not in C.COMM_STRATEGIES:
            raise DeepSpeedConfigError(
                f"'{C.COMM}.strategy' must be one of {C.COMM_STRATEGIES}, got '{out.strategy}'")
        if out.threshold_bytes < 0 or out.dcn_threshold_bytes < 0:
            raise DeepSpeedConfigError(f"'{C.COMM}' thresholds must be >= 0")
        if out.quantize_bits != C.COMM_QUANTIZE_BITS_DEFAULT:
            raise DeepSpeedConfigError(
                f"'{C.COMM}.quantize_bits' supports only {C.COMM_QUANTIZE_BITS_DEFAULT}, "
                f"got {out.quantize_bits}")
        return out


@dataclass
class SparseAttentionConfig:
    """``sparse_attention``: ``mode`` (dense|fixed|variable|bigbird|
    bslongformer) and the remaining keys as the mode's ``params`` (block,
    different_layout_per_head, ...), parsed as the JAX package parses
    them; as there, nothing reads the block (a model takes its
    ``SparsityConfig`` directly: ``GPT2Config.sparsity_config``)."""

    mode: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SparseAttentionConfig":
        if d is None:
            return cls()
        d = dict(d)
        mode = d.pop("mode", None)
        return cls(mode=mode, params=d)


def _dp_world_size(mesh: "MeshConfig") -> int:
    """``data x fsdp`` of the mesh over the started process group (1 when
    none is started)."""
    from deepspeed_tpu_torch.comm import distributed
    from deepspeed_tpu_torch.sharding.mesh import resolve_mesh_shape

    try:
        sizes = resolve_mesh_shape(mesh, distributed.get_world_size())
    except ValueError:  # the engine's mesh build raises for it
        return 1
    return sizes["data"] * sizes["fsdp"]


def _off_block(v: Any) -> bool:
    """A block at its "off" default: absent, empty, or only
    ``enabled: false``."""
    return v is None or v == {} or v == {"enabled": False}


@dataclass
class ResilienceCheckpointConfig:
    """``resilience.checkpoint`` — durability of the checkpoint tree."""

    atomic: bool = C.CHECKPOINT_ATOMIC_DEFAULT
    verify_on_load: bool = C.CHECKPOINT_VERIFY_ON_LOAD_DEFAULT
    checksum: str = C.CHECKPOINT_CHECKSUM_DEFAULT
    keep_last_n: int = C.CHECKPOINT_KEEP_LAST_N_DEFAULT  # 0 = keep all
    keep_every: int = C.CHECKPOINT_KEEP_EVERY_DEFAULT  # pin step multiples
    fail_on_missing: bool = C.CHECKPOINT_FAIL_ON_MISSING_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "ResilienceCheckpointConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            atomic=bool(d.pop("atomic", C.CHECKPOINT_ATOMIC_DEFAULT)),
            verify_on_load=bool(d.pop("verify_on_load", C.CHECKPOINT_VERIFY_ON_LOAD_DEFAULT)),
            checksum=str(d.pop("checksum", C.CHECKPOINT_CHECKSUM_DEFAULT)).lower(),
            keep_last_n=int(d.pop("keep_last_n", C.CHECKPOINT_KEEP_LAST_N_DEFAULT)),
            keep_every=int(d.pop("keep_every", C.CHECKPOINT_KEEP_EVERY_DEFAULT)),
            fail_on_missing=bool(d.pop(C.CHECKPOINT_FAIL_ON_MISSING,
                                       C.CHECKPOINT_FAIL_ON_MISSING_DEFAULT)),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.checksum not in C.CHECKPOINT_CHECKSUM_ALGORITHMS:
            raise DeepSpeedConfigError(
                f"'{block}.checksum' must be one of {C.CHECKPOINT_CHECKSUM_ALGORITHMS}, "
                f"got '{out.checksum}'"
            )
        return out


@dataclass
class WatchdogConfig:
    """``resilience.watchdog`` — SIGTERM/SIGINT → emergency checkpoint at
    the next step boundary, then exit with a scheduler-readable code."""

    enabled: bool = C.WATCHDOG_ENABLED_DEFAULT
    grace_seconds: float = C.WATCHDOG_GRACE_SECONDS_DEFAULT
    exit_code: int = C.WATCHDOG_EXIT_CODE_DEFAULT
    save_dir: Optional[str] = None  # default: the engine's last ckpt dir

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "WatchdogConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(d.pop("enabled", C.WATCHDOG_ENABLED_DEFAULT)),
            grace_seconds=float(d.pop("grace_seconds", C.WATCHDOG_GRACE_SECONDS_DEFAULT)),
            exit_code=int(d.pop("exit_code", C.WATCHDOG_EXIT_CODE_DEFAULT)),
            save_dir=d.pop("save_dir", None),
        )
        _check_empty(d, block, _known_keys(cls))
        if not (0 <= out.exit_code <= 255):
            raise DeepSpeedConfigError(f"'{block}.exit_code' must be in [0, 255], got {out.exit_code}")
        if out.grace_seconds < 0:
            raise DeepSpeedConfigError(f"'{block}.grace_seconds' must be >= 0, got {out.grace_seconds}")
        return out


@dataclass
class RetryConfig:
    """``resilience.retry`` — the bounded-retry policy of checkpoint I/O."""

    max_attempts: int = C.RETRY_MAX_ATTEMPTS_DEFAULT
    backoff_seconds: float = C.RETRY_BACKOFF_SECONDS_DEFAULT
    backoff_max_seconds: float = C.RETRY_BACKOFF_MAX_SECONDS_DEFAULT
    jitter: float = C.RETRY_JITTER_DEFAULT
    timeout_seconds: Optional[float] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "RetryConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            max_attempts=int(d.pop("max_attempts", C.RETRY_MAX_ATTEMPTS_DEFAULT)),
            backoff_seconds=float(d.pop("backoff_seconds", C.RETRY_BACKOFF_SECONDS_DEFAULT)),
            backoff_max_seconds=float(d.pop("backoff_max_seconds",
                                            C.RETRY_BACKOFF_MAX_SECONDS_DEFAULT)),
            jitter=float(d.pop("jitter", C.RETRY_JITTER_DEFAULT)),
            timeout_seconds=d.pop("timeout_seconds", None),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.max_attempts < 1:
            raise DeepSpeedConfigError(f"'{block}.max_attempts' must be >= 1, got {out.max_attempts}")
        return out

    def policy(self):
        """The port's runtime :class:`RetryPolicy` (imported here so
        config parsing stays free of the resilience package)."""
        from deepspeed_tpu_torch.resilience.policy import RetryPolicy

        return RetryPolicy(
            max_attempts=self.max_attempts,
            backoff_seconds=self.backoff_seconds,
            backoff_max_seconds=self.backoff_max_seconds,
            jitter=self.jitter,
            timeout_seconds=self.timeout_seconds,
        )


@dataclass
class DivergenceConfig:
    """``resilience.divergence`` — N consecutive NaN/overflow-skipped
    steps trip a configurable action (warn / lower the loss-scale floor /
    roll back to the last verified checkpoint)."""

    enabled: bool = C.DIVERGENCE_ENABLED_DEFAULT
    threshold: int = C.DIVERGENCE_THRESHOLD_DEFAULT
    action: str = C.DIVERGENCE_ACTION_WARN
    # Opt-in host sync: without dynamic loss scaling (bf16 default) there
    # is no overflow flag, so NaN detection must read the loss each step.
    check_loss: bool = False

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "DivergenceConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(d.pop("enabled", C.DIVERGENCE_ENABLED_DEFAULT)),
            threshold=int(d.pop("threshold", C.DIVERGENCE_THRESHOLD_DEFAULT)),
            action=str(d.pop("action", C.DIVERGENCE_ACTION_WARN)).lower(),
            check_loss=bool(d.pop("check_loss", False)),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.action not in C.DIVERGENCE_ACTIONS:
            raise DeepSpeedConfigError(
                f"'{block}.action' must be one of {C.DIVERGENCE_ACTIONS}, got '{out.action}'"
            )
        if out.threshold < 1:
            raise DeepSpeedConfigError(f"'{block}.threshold' must be >= 1, got {out.threshold}")
        return out


@dataclass
class ResilienceConfig:
    """``resilience`` block.  Its ``supervision`` sub-block (heartbeats,
    the hung-collective watchdog, exit 44) is accepted only at its off
    default (ROADMAP A14)."""

    checkpoint: ResilienceCheckpointConfig = field(default_factory=ResilienceCheckpointConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    retry: RetryConfig = field(default_factory=RetryConfig)
    divergence: DivergenceConfig = field(default_factory=DivergenceConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ResilienceConfig":
        if d is None:
            return cls()
        d = dict(d)
        sub = lambda key: (d.pop(key, None), f"{C.RESILIENCE}.{key}")  # noqa: E731
        out = cls(
            checkpoint=ResilienceCheckpointConfig.from_dict(*sub(C.RESILIENCE_CHECKPOINT)),
            watchdog=WatchdogConfig.from_dict(*sub(C.RESILIENCE_WATCHDOG)),
            retry=RetryConfig.from_dict(*sub(C.RESILIENCE_RETRY)),
            divergence=DivergenceConfig.from_dict(*sub(C.RESILIENCE_DIVERGENCE)),
        )
        if not _off_block(d.pop(C.RESILIENCE_SUPERVISION, None)):
            raise _not_ported(f"{C.RESILIENCE}.{C.RESILIENCE_SUPERVISION}",
                              "A14 resilience/supervision/")
        _check_empty(d, C.RESILIENCE, (*_known_keys(cls), C.RESILIENCE_SUPERVISION))
        return out


@dataclass
class PrefetchOverlapConfig:
    """``overlap.prefetch`` — pipelined load + device placement of input
    batches ahead of the step (``engine.prefetch_loader``)."""

    enabled: bool = C.PREFETCH_ENABLED_DEFAULT
    depth: int = C.PREFETCH_DEPTH_DEFAULT  # batches in flight per stage

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "PrefetchOverlapConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(d.pop("enabled", C.PREFETCH_ENABLED_DEFAULT)),
            depth=int(d.pop("depth", C.PREFETCH_DEPTH_DEFAULT)),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.depth < 1:
            raise DeepSpeedConfigError(f"'{block}.depth' must be >= 1, got {out.depth}")
        return out


@dataclass
class AsyncCheckpointConfig:
    """``overlap.async_checkpoint`` — snapshot the state at the step
    boundary, run the stage->manifest->rename commit on a background
    thread (the durability contract is unchanged)."""

    enabled: bool = C.ASYNC_CHECKPOINT_ENABLED_DEFAULT
    drain_timeout_seconds: float = C.ASYNC_CHECKPOINT_DRAIN_TIMEOUT_DEFAULT

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "AsyncCheckpointConfig":
        if d is None:
            return cls()
        d = dict(d)
        out = cls(
            enabled=bool(d.pop("enabled", C.ASYNC_CHECKPOINT_ENABLED_DEFAULT)),
            drain_timeout_seconds=float(d.pop("drain_timeout_seconds",
                                              C.ASYNC_CHECKPOINT_DRAIN_TIMEOUT_DEFAULT)),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.drain_timeout_seconds <= 0:
            raise DeepSpeedConfigError(
                f"'{block}.drain_timeout_seconds' must be > 0, got {out.drain_timeout_seconds}"
            )
        return out


@dataclass
class TimelineConfig:
    """``overlap.timeline`` — per-step wall-time attribution (data_wait /
    compute / ckpt_stall / compile / other).

    ``fence``: synchronize the card after each step so ``compute`` is
    recorded.  ``null`` (default) follows ``wall_clock_breakdown``, which
    the port refuses (ROADMAP A14): so the fence is on only when asked for
    explicitly, and an unfenced timeline omits ``compute`` rather than
    record the time it took to queue the step."""

    enabled: bool = C.TIMELINE_ENABLED_DEFAULT
    window: int = C.TIMELINE_WINDOW_DEFAULT
    fence: Optional[bool] = None  # None = follow wall_clock_breakdown

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], block: str) -> "TimelineConfig":
        if d is None:
            return cls()
        d = dict(d)
        fence = d.pop("fence", None)
        out = cls(
            enabled=bool(d.pop("enabled", C.TIMELINE_ENABLED_DEFAULT)),
            window=int(d.pop("window", C.TIMELINE_WINDOW_DEFAULT)),
            fence=None if fence is None else bool(fence),
        )
        _check_empty(d, block, _known_keys(cls))
        if out.window < 1:
            raise DeepSpeedConfigError(f"'{block}.window' must be >= 1, got {out.window}")
        return out


@dataclass
class OverlapConfig:
    """``overlap`` block: input prefetch, async checkpoints, the step
    timeline."""

    prefetch: PrefetchOverlapConfig = field(default_factory=PrefetchOverlapConfig)
    async_checkpoint: AsyncCheckpointConfig = field(default_factory=AsyncCheckpointConfig)
    timeline: TimelineConfig = field(default_factory=TimelineConfig)

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "OverlapConfig":
        if d is None:
            return cls()
        d = dict(d)
        sub = lambda key: (d.pop(key, None), f"{C.OVERLAP}.{key}")  # noqa: E731
        out = cls(
            prefetch=PrefetchOverlapConfig.from_dict(*sub(C.OVERLAP_PREFETCH)),
            async_checkpoint=AsyncCheckpointConfig.from_dict(*sub(C.OVERLAP_ASYNC_CHECKPOINT)),
            timeline=TimelineConfig.from_dict(*sub(C.OVERLAP_TIMELINE)),
        )
        _check_empty(d, C.OVERLAP, _known_keys(cls))
        return out


# top-level keys of the JAX package that the port does not honour yet:
# key -> (predicate "at its off default", ROADMAP item)
_TOP_NOT_PORTED = {
    "amp": (_off_block, "A13"),
    "wall_clock_breakdown": (lambda v: v is False, "A14"),
    "tensorboard": (_off_block, "A14"),
    "pipeline": (_off_block, "A11 runtime/pipe/"),
    "sanitizer": (_off_block, "A15"),
    "telemetry": (_off_block, "A14 telemetry/"),
    "kernels": (lambda v: v is None or v == {} or v == {"enabled": "auto"},
                "B (the port has no kernel switch: CUDA tensors always take the kernels)"),
    "activation_checkpointing": (_off_block, "A13 activation_checkpointing/"),
    "flops_profiler": (_off_block, "A14 profiling/flops_profiler.py"),
    "aio": (_off_block, "A12 ops/aio/"),
    "elasticity": (_off_block, "A14 elasticity/"),
    "quantize_training": (_off_block, "A13 runtime/quantize.py"),
    "progressive_layer_drop": (_off_block, "A13 progressive_layer_drop.py"),
}

_PORTED_TOP_LEVEL = {
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, C.GRADIENT_ACCUMULATION_STEPS,
    C.OPTIMIZER, C.SCHEDULER, C.FP16, C.BF16, C.ZERO_OPTIMIZATION, C.GRADIENT_CLIPPING,
    C.STEPS_PER_PRINT, C.SEED, C.MESH, C.SERVING, C.SPARSE_ATTENTION, C.RESILIENCE, C.OVERLAP,
    C.CHECKPOINT_TAG_VALIDATION, C.DATALOADER_DROP_LAST, C.COMM,
    C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR, C.SPARSE_GRADIENTS,
    C.ALLREDUCE_ALWAYS_FP32, C.MEMORY_BREAKDOWN, C.DUMP_STATE, C.DISABLE_ALLGATHER,
    C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
}
# the JAX package's ``_KNOWN_TOP_LEVEL``
_KNOWN_TOP_LEVEL = _PORTED_TOP_LEVEL | set(_TOP_NOT_PORTED)


class DeepSpeedConfig:
    """Parse a config dict / JSON path and resolve the batch-size triad.
    ``world_size``: the data-parallel world size the triad counts (the
    JAX package's argument); default: the ``mesh`` block's ``data x
    fsdp`` over the started process group, 1 without one."""

    def __init__(self, config: Any, world_size: Optional[int] = None):
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
        self.mesh = MeshConfig.from_dict(d.get(C.MESH))
        self.comm = CommConfig.from_dict(d.get(C.COMM))
        if world_size is None:
            world_size = _dp_world_size(self.mesh)
        self.world_size = int(world_size)
        self.serving = ServingConfig.from_dict(d.get(C.SERVING))
        self.sparse_attention = SparseAttentionConfig.from_dict(d.get(C.SPARSE_ATTENTION))
        self.gradient_clipping = float(d.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT))
        self.steps_per_print = int(d.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT))
        self.seed = int(d.get(C.SEED, C.SEED_DEFAULT))
        self.resilience = ResilienceConfig.from_dict(d.get(C.RESILIENCE))
        self.overlap = OverlapConfig.from_dict(d.get(C.OVERLAP))
        # validated as in the JAX package, which never reads it either
        self.checkpoint_tag_validation_mode = d.get(C.CHECKPOINT_TAG_VALIDATION,
                                                    C.CHECKPOINT_TAG_VALIDATION_DEFAULT)
        self.dataloader_drop_last = bool(d.get(C.DATALOADER_DROP_LAST,
                                               C.DATALOADER_DROP_LAST_DEFAULT))
        # parsed as the JAX package parses them; it never reads them again
        self.prescale_gradients = bool(d.get(C.PRESCALE_GRADIENTS,
                                             C.PRESCALE_GRADIENTS_DEFAULT))
        self.gradient_predivide_factor = float(d.get(C.GRADIENT_PREDIVIDE_FACTOR,
                                                     C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT))
        self.sparse_gradients_enabled = bool(d.get(C.SPARSE_GRADIENTS,
                                                   C.SPARSE_GRADIENTS_DEFAULT))
        self.allreduce_always_fp32 = bool(d.get(C.ALLREDUCE_ALWAYS_FP32,
                                                C.ALLREDUCE_ALWAYS_FP32_DEFAULT))
        self.memory_breakdown = bool(d.get(C.MEMORY_BREAKDOWN, C.MEMORY_BREAKDOWN_DEFAULT))
        self.dump_state = bool(d.get(C.DUMP_STATE, C.DUMP_STATE_DEFAULT))
        self.disable_allgather = bool(d.get(C.DISABLE_ALLGATHER, C.DISABLE_ALLGATHER_DEFAULT))
        self.zero_allow_untested_optimizer = bool(d.get(C.ZERO_ALLOW_UNTESTED_OPTIMIZER, False))
        if self.checkpoint_tag_validation_mode not in C.CHECKPOINT_TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError(
                f"checkpoint_tag_validation must be one of {C.CHECKPOINT_TAG_VALIDATION_MODES}"
            )
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
