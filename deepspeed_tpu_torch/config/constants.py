"""Config keys and defaults (copy of the training and ``serving``
sections of ``deepspeed_tpu/config/constants.py``; the port keeps its own
copy)."""

#############################################
# Batch size triad
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False
SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

BF16 = "bf16"
BF16_ENABLED = "enabled"
BF16_ENABLED_DEFAULT = False

#############################################
# Engine knobs
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
# top-level keys the JAX package parses and never reads again: carried
# unread under the JAX DeepSpeedConfig's attribute names
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
ALLREDUCE_ALWAYS_FP32 = "fp32_allreduce"
ALLREDUCE_ALWAYS_FP32_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
DISABLE_ALLGATHER = "disable_allgather"
DISABLE_ALLGATHER_DEFAULT = False
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
SEED = "seed"
SEED_DEFAULT = 42

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0
MAX_STAGE_ZERO_OPTIMIZATION = 3

MESH = "mesh"
MESH_AXES = ("data", "fsdp", "model", "pipe", "seq", "expert")

# comm block (the JAX package's constants)
COMM = "comm"
COMM_STRATEGY_AUTO = "auto"
COMM_STRATEGY_DENSE = "dense"
COMM_STRATEGY_INT8 = "int8"
COMM_STRATEGY_ONEBIT = "onebit"
COMM_STRATEGIES = [COMM_STRATEGY_AUTO, COMM_STRATEGY_DENSE, COMM_STRATEGY_INT8, COMM_STRATEGY_ONEBIT]
COMM_STRATEGY_DEFAULT = COMM_STRATEGY_DENSE
COMM_THRESHOLD_BYTES_DEFAULT = 65536  # below this, dense always wins
COMM_DCN_THRESHOLD_BYTES_DEFAULT = 4096
COMM_QUANTIZE_BITS_DEFAULT = 8
COMM_ERROR_FEEDBACK_DEFAULT = True
COMM_STOCHASTIC_ROUNDING_DEFAULT = True

#############################################
# Serving (continuous-batching slot-pool engine)
#############################################
SERVING = "serving"
SPARSE_ATTENTION = "sparse_attention"
SERVING_NUM_SLOTS_DEFAULT = 8  # concurrent sequences in the slot pool
SERVING_MAX_LEN_DEFAULT = 0  # 0 = derive from min(max_out_tokens, n_positions)
SERVING_KV_CACHE_DTYPE_DEFAULT = "model"  # model | int8
SERVING_KV_CACHE_DTYPES = ["model", "int8"]
SERVING_PREFILL_CHUNK_DEFAULT = 64  # prompt tokens per prefill chunk
SERVING_PREFILL_CHUNKS_PER_STEP_DEFAULT = 1  # chunks interleaved per decode step
SERVING_MAX_QUEUE_DEFAULT = 64  # waiting requests before submit() rejects
SERVING_MAX_NEW_TOKENS_DEFAULT = 128  # per-request default generation budget
SERVING_DEADLINE_SECONDS_DEFAULT = 0.0  # 0 = no queue-wait deadline
# top-k head width for per-slot sampling — requests with
# top_k > max_top_k reject at submit
SERVING_MAX_TOP_K_DEFAULT = 64
# -- overload management ------------------------------------------------
# priority tiers: 0 = high (never TTFT-shed), 1 = normal, 2 = low
# (first to shed when the degradation ladder tops out)
SERVING_PRIORITY_HIGH = 0
SERVING_PRIORITY_NORMAL = 1
SERVING_PRIORITY_LOW = 2
SERVING_SLO_TTFT_MS_DEFAULT = 0.0  # 0 = no estimated-TTFT admission test
# overload shed floor: a retry_after below this tells clients nothing
SERVING_RETRY_AFTER_MIN_SECONDS_DEFAULT = 0.05
# degradation ladder: engage when queue_depth >= watermark * max_queue
# sustained engage_steps ticks; step back down after disengage_steps
# calm ticks (hysteresis — disengage slower than engage)
SERVING_DEGRADE_QUEUE_WATERMARK_DEFAULT = 0.75
SERVING_DEGRADE_ENGAGE_STEPS_DEFAULT = 8
SERVING_DEGRADE_DISENGAGE_STEPS_DEFAULT = 16
SERVING_DEGRADE_MAX_NEW_TOKENS_DEFAULT = 32  # rung-1 clamp; 0 disables the rung
# -- paged KV cache (serving.kvcache.*) ------------------------------------
SERVING_KVCACHE = "kvcache"
SERVING_KVCACHE_ENABLED_DEFAULT = False  # paged pool off = slot-contiguous pool
SERVING_KVCACHE_PAGE_LEN_DEFAULT = 128  # tokens per KV page
SERVING_KVCACHE_NUM_PAGES_DEFAULT = 0  # 0 = derive (garbage page + 2x slot capacity)
SERVING_KVCACHE_SESSION_TTL_SECONDS_DEFAULT = 0.0  # 0 = warm sessions never expire
SERVING_KVCACHE_SPILL_DIR_DEFAULT = ""  # "" = cold sessions drop instead of spill
# -- hierarchical KV tiering (serving.kvcache.tiers.*) ---------------------
SERVING_KVCACHE_TIERS = "tiers"
SERVING_KVCACHE_TIERS_ENABLED_DEFAULT = False
SERVING_KVCACHE_TIERS_HOST_PAGES_DEFAULT = 0  # T1 page cap; 0 = unbounded
SERVING_KVCACHE_TIERS_DISK_DIR_DEFAULT = ""  # "" = no T2 (host tier only)
SERVING_KVCACHE_TIERS_RESIDENCY_WINDOW_DEFAULT = 0  # tokens kept in T0 per parked session; 0 = all
SERVING_KVCACHE_TIERS_DEMOTE_WATERMARK_DEFAULT = 0.75  # demote when pages_live exceeds this fraction
SERVING_KVCACHE_TIERS_PREFETCH_AHEAD_DEFAULT = 4  # queued admits prefetched per tick
SERVING_KVCACHE_TIERS_DEMOTE_BATCH_DEFAULT = 4  # entries demoted per tick
# -- the request journal and the SIGTERM drain ----------------------------
SERVING_DRAIN_DEADLINE_SECONDS_DEFAULT = 30.0  # SIGTERM in-flight drain budget
SERVING_JOURNAL_DIR_DEFAULT = ""  # "" = request journaling off
SERVING_JOURNAL_SEGMENT_RECORDS_DEFAULT = 512  # records per WAL segment
SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT = 4  # sealed segments before compaction
# -- tenants (serving.tenants.*) -------------------------------------------
SERVING_TENANTS = "tenants"
SERVING_TENANTS_ENABLED_DEFAULT = False
# default (per-tenant) token-bucket admission rate: budget tokens
# (prompt + reserved max_new) per second, and the burst ceiling;
# rate 0 + burst 0 = unlimited tenant
SERVING_TENANTS_REFILL_TOKENS_PER_SECOND_DEFAULT = 0.0
SERVING_TENANTS_BURST_TOKENS_DEFAULT = 0.0
SERVING_TENANTS_WEIGHT_DEFAULT = 1.0  # WFQ share weight
SERVING_TENANTS_SLO_CLASS_DEFAULT = "silver"  # gold | silver | bronze
SERVING_TENANTS_SLO_CLASSES = ["gold", "silver", "bronze"]
SERVING_TENANTS_KV_PAGES_MAX_DEFAULT = 0  # 0 = no per-tenant page cap
SERVING_TENANTS_PINNED_PREFIXES_MAX_DEFAULT = 0  # 0 = no pin cap
# -- fleet router (serving.fleet.*; serving/fleet/router.py) -----------
SERVING_FLEET = "fleet"
SERVING_FLEET_REPLICAS_DEFAULT = 1  # engine replicas behind the router
SERVING_FLEET_ROUTE_RETRIES_DEFAULT = 2  # extra replicas tried per submit
# circuit breaker: consecutive failures that trip a replica OPEN, then
# seeded-jitter exponential backoff (resilience/policy.py RetryPolicy
# schedule) before a half-open probe is admitted
SERVING_FLEET_BREAKER_FAILURES_DEFAULT = 3
SERVING_FLEET_BREAKER_BACKOFF_SECONDS_DEFAULT = 0.5
SERVING_FLEET_BREAKER_BACKOFF_MAX_SECONDS_DEFAULT = 30.0
SERVING_FLEET_BREAKER_HALFOPEN_PROBES_DEFAULT = 1
# tail-latency hedging: duplicate a first-token-less request to a
# second replica after hedge_factor * observed p99 TTFT (armed only
# past hedge_min_observations samples); first token wins, the loser is
# cancelled via scheduler retirement
SERVING_FLEET_HEDGE_DEFAULT = False
SERVING_FLEET_HEDGE_FACTOR_DEFAULT = 1.5
SERVING_FLEET_HEDGE_MIN_OBSERVATIONS_DEFAULT = 16
# replica supervision: restarts per replica before it stays dead, with
# the same RetryPolicy backoff schedule between restart attempts
SERVING_FLEET_MAX_RESTARTS_DEFAULT = 3
SERVING_FLEET_RESTART_BACKOFF_SECONDS_DEFAULT = 0.2
# restart-budget decay (leaky bucket): every this-many seconds of clean
# service since the last restart attempt forgives one consumed attempt,
# so one bad hour does not permanently exhaust a long-lived replica's
# budget; 0 = never decay (the pre-elastic behavior)
SERVING_FLEET_RESTART_BUDGET_RESET_SECONDS_DEFAULT = 0.0
# -- elastic fleet (serving.fleet.elastic.*; serving/fleet/elastic.py):
# load-driven autoscaling with warm-pool scale-up and drain +
# live-KV-session-migration scale-down ----------------------------------
SERVING_FLEET_ELASTIC = "elastic"
SERVING_FLEET_ELASTIC_ENABLED_DEFAULT = False
SERVING_FLEET_ELASTIC_MIN_REPLICAS_DEFAULT = 1
SERVING_FLEET_ELASTIC_MAX_REPLICAS_DEFAULT = 4
# scale-up pressure: a tick is HOT when mean queued-per-routable-replica
# crosses the depth threshold, any replica's admitted-TTFT estimate
# crosses the ttft threshold, or the router absorbed shed/rejections
# since the last tick
SERVING_FLEET_ELASTIC_SCALE_UP_QUEUE_DEPTH_DEFAULT = 4
SERVING_FLEET_ELASTIC_SCALE_UP_TTFT_SECONDS_DEFAULT = 1.0
SERVING_FLEET_ELASTIC_SCALE_DOWN_QUEUE_DEPTH_DEFAULT = 1
# hysteresis: engage fast (consecutive hot ticks), disengage slow
# (consecutive cold ticks) — the degradation ladder's shape
SERVING_FLEET_ELASTIC_ENGAGE_TICKS_DEFAULT = 3
SERVING_FLEET_ELASTIC_DISENGAGE_TICKS_DEFAULT = 12
SERVING_FLEET_ELASTIC_SCALE_UP_COOLDOWN_SECONDS_DEFAULT = 5.0
SERVING_FLEET_ELASTIC_SCALE_DOWN_COOLDOWN_SECONDS_DEFAULT = 30.0
# pre-built (factory + warm hook, off the routing thread) replicas kept
# ready so a scale-up is an O(1) attach instead of a replica's build
SERVING_FLEET_ELASTIC_WARM_POOL_SIZE_DEFAULT = 1
# scale-down victim drain budget: while the victim still holds
# in-flight requests past this deadline the scale-down ABORTS (the
# victim revives) — it never proceeds over live work
SERVING_FLEET_ELASTIC_MIGRATION_DEADLINE_SECONDS_DEFAULT = 30.0
SERVING_FLEET_ELASTIC_MIGRATION_RETRIES_DEFAULT = 3
# -- the HTTP front door (serving.frontdoor.*; serving/frontdoor/http.py)
SERVING_FRONTDOOR = "frontdoor"
SERVING_FRONTDOOR_ENABLED_DEFAULT = False
SERVING_FRONTDOOR_HOST_DEFAULT = "127.0.0.1"
SERVING_FRONTDOOR_PORT_DEFAULT = 0  # 0 = ephemeral (OS-assigned) port
# chunked-streaming poll cadence: how often the handler thread samples
# a live request's partial tokens between engine steps
SERVING_FRONTDOOR_STREAM_POLL_SECONDS_DEFAULT = 0.01
# hard cap on a single request body (token-id JSON) — a front door
# should bound untrusted input before it reaches the scheduler
SERVING_FRONTDOOR_MAX_BODY_BYTES_DEFAULT = 1 << 20

#############################################
# Checkpoints and the data loader
#############################################
CHECKPOINT_TAG_VALIDATION = "checkpoint_tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

#############################################
# Resilience (checkpoint durability, preemption, retries, divergence)
#############################################
RESILIENCE = "resilience"

RESILIENCE_CHECKPOINT = "checkpoint"
CHECKPOINT_ATOMIC_DEFAULT = True
CHECKPOINT_VERIFY_ON_LOAD_DEFAULT = True
CHECKPOINT_CHECKSUM_DEFAULT = "sha256"
CHECKPOINT_CHECKSUM_ALGORITHMS = ["sha256", "crc32", "none"]
CHECKPOINT_KEEP_LAST_N_DEFAULT = 0  # 0 = keep everything
CHECKPOINT_KEEP_EVERY_DEFAULT = 0  # 0 = no step-multiple pinning
CHECKPOINT_FAIL_ON_MISSING = "fail_on_missing"
CHECKPOINT_FAIL_ON_MISSING_DEFAULT = False

RESILIENCE_WATCHDOG = "watchdog"
WATCHDOG_ENABLED_DEFAULT = False
WATCHDOG_GRACE_SECONDS_DEFAULT = 60.0
WATCHDOG_EXIT_CODE_DEFAULT = 43  # "preempted and saved"

RESILIENCE_RETRY = "retry"
RETRY_MAX_ATTEMPTS_DEFAULT = 3
RETRY_BACKOFF_SECONDS_DEFAULT = 0.5
RETRY_BACKOFF_MAX_SECONDS_DEFAULT = 30.0
RETRY_JITTER_DEFAULT = 0.25

RESILIENCE_DIVERGENCE = "divergence"
DIVERGENCE_ENABLED_DEFAULT = True
DIVERGENCE_THRESHOLD_DEFAULT = 20
DIVERGENCE_ACTION_WARN = "warn"
DIVERGENCE_ACTION_FLOOR = "floor_loss_scale"
DIVERGENCE_ACTION_ROLLBACK = "rollback"
DIVERGENCE_ACTIONS = [
    DIVERGENCE_ACTION_WARN,
    DIVERGENCE_ACTION_FLOOR,
    DIVERGENCE_ACTION_ROLLBACK,
]

RESILIENCE_SUPERVISION = "supervision"

#############################################
# Overlap (input prefetch, async checkpoints, step timeline)
#############################################
OVERLAP = "overlap"

OVERLAP_PREFETCH = "prefetch"
PREFETCH_ENABLED_DEFAULT = True
PREFETCH_DEPTH_DEFAULT = 2

OVERLAP_ASYNC_CHECKPOINT = "async_checkpoint"
ASYNC_CHECKPOINT_ENABLED_DEFAULT = False
ASYNC_CHECKPOINT_DRAIN_TIMEOUT_DEFAULT = 300.0  # seconds

OVERLAP_TIMELINE = "timeline"
TIMELINE_ENABLED_DEFAULT = True
TIMELINE_WINDOW_DEFAULT = 512  # steps retained for summaries
