"""serving/ — continuous-batching serving engine over a slot-pool KV
cache (counterpart of ``deepspeed_tpu/serving``; the journal, watchdog,
paged pool, fleet and front-door are not ported yet).

    srv = deepspeed_tpu_torch.init_serving(model="gpt2", dtype=torch.bfloat16,
                                           serving={"num_slots": 8})
    rid = srv.submit(prompt_tokens, max_new_tokens=64)
    results = srv.drain()
    print(results[rid].tokens())
"""
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.pool import SlotKVPool, SlotPoolError
from deepspeed_tpu_torch.serving.scheduler import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AdmissionController,
    ContinuousScheduler,
    DegradationLadder,
    PrefillJob,
    Request,
    ServingDraining,
    ServingOverloaded,
    ServingQueueFull,
)

__all__ = [
    "ServingEngine",
    "SlotKVPool",
    "SlotPoolError",
    "AdmissionController",
    "ContinuousScheduler",
    "DegradationLadder",
    "PrefillJob",
    "Request",
    "ServingQueueFull",
    "ServingOverloaded",
    "ServingDraining",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_LOW",
]
