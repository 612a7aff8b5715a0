"""Serving defaults (copy of the ``serving`` section of
``deepspeed_tpu/config/constants.py``; the port keeps its own copy)."""

#############################################
# Serving (continuous-batching slot-pool engine)
#############################################
SERVING = "serving"
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
# -- blocks of the JAX package's serving stack not ported yet ------------
SERVING_DRAIN_DEADLINE_SECONDS_DEFAULT = 30.0  # SIGTERM in-flight drain budget
SERVING_JOURNAL_DIR_DEFAULT = ""  # "" = request journaling off
SERVING_JOURNAL_SEGMENT_RECORDS_DEFAULT = 512  # records per WAL segment
SERVING_JOURNAL_KEEP_SEGMENTS_DEFAULT = 4  # sealed segments before compaction
SERVING_KVCACHE = "kvcache"
SERVING_KVCACHE_TIERS = "tiers"
SERVING_FLEET = "fleet"
SERVING_FRONTDOOR = "frontdoor"
SERVING_TENANTS = "tenants"
