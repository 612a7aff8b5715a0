"""serving/ — continuous-batching serving engine over a slot-pool or a
paged KV cache (counterpart of ``deepspeed_tpu/serving``): the pools,
the scheduler, a write-ahead request journal for crash recovery
(``journal.py``), a SIGTERM graceful-drain watchdog (``watchdog.py``),
device → host → disk KV tiering (``kvcache/tiers.py``), tenants
(``frontdoor/tenants.py``), the fleet router over replicas with failover,
supervised restart and elastic scaling (``fleet/``), and the framed RPC
transport and HTTP front door (``frontdoor/transport.py``,
``frontdoor/http.py``).

    srv = deepspeed_tpu_torch.init_serving(
        model="gpt2", dtype=torch.bfloat16,
        serving={"num_slots": 8, "journal_dir": "/ckpt/serving-journal",
                 "kvcache": {"enabled": True,
                             "tiers": {"enabled": True, "disk_dir": "/ckpt/kv"}}})
    srv.install_watchdog()          # SIGTERM -> drain -> exit 43
    srv.recover()                   # replay a crashed engine's journal
    rid = srv.submit(prompt_tokens, max_new_tokens=64, session_id="chat-1")
    results = srv.drain()
    print(results[rid].tokens())

    # a fleet of replica processes behind one router
    router = FleetRouter([TransportReplica(n, ProcessTransport(n, argv)) ...],
                         config={"route_retries": 2},
                         supervisor=ReplicaSupervisor(max_restarts=2))
    hid = router.submit(prompt_tokens, client_key="req-1")
    results = router.drain()

    FrontDoor(srv).serve_forever()  # POST /v1/generate, GET /healthz, /statsz
"""
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.fleet import (
    FleetOverloaded,
    FleetRouter,
    LocalReplica,
    ReplicaDeadError,
    ReplicaSupervisor,
)
from deepspeed_tpu_torch.serving.frontdoor import (
    FrontDoor,
    TenantRegistry,
    TenantThrottled,
    TransportFrameError,
    TransportReplica,
    journal_tenant_totals,
    wrap_replica,
)
from deepspeed_tpu_torch.serving.journal import JournalError, RequestJournal
from deepspeed_tpu_torch.serving.kvcache import PagedKVPool, PageTierManager
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
from deepspeed_tpu_torch.serving.watchdog import ServingWatchdog

__all__ = [
    "ServingEngine",
    "FleetRouter",
    "FleetOverloaded",
    "LocalReplica",
    "ReplicaDeadError",
    "ReplicaSupervisor",
    "FrontDoor",
    "TransportFrameError",
    "TransportReplica",
    "wrap_replica",
    "PagedKVPool",
    "PageTierManager",
    "SlotKVPool",
    "SlotPoolError",
    "AdmissionController",
    "ContinuousScheduler",
    "DegradationLadder",
    "PrefillJob",
    "Request",
    "RequestJournal",
    "JournalError",
    "ServingQueueFull",
    "ServingOverloaded",
    "ServingDraining",
    "ServingWatchdog",
    "TenantRegistry",
    "TenantThrottled",
    "journal_tenant_totals",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_LOW",
]
