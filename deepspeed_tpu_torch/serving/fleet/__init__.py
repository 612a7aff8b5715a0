"""serving/fleet/ — health-gated routing over N serving replicas with
failover, hedged retries, lossless supervised restart and elastic scaling
with live KV session migration (counterpart of
``deepspeed_tpu/serving/fleet``)."""
from deepspeed_tpu_torch.serving.fleet.health import (
    CLOSED,
    DEAD,
    DEGRADED,
    DRAINING,
    HALF_OPEN,
    HEALTHY,
    OPEN,
    CircuitBreaker,
    ReplicaHealth,
)
from deepspeed_tpu_torch.serving.fleet.elastic import FleetAutoscaler, WarmPool
from deepspeed_tpu_torch.serving.fleet.replica import LocalReplica, ReplicaDeadError
from deepspeed_tpu_torch.serving.fleet.router import (
    FleetHandle,
    FleetOverloaded,
    FleetRouter,
)
from deepspeed_tpu_torch.serving.fleet.supervisor import ReplicaSupervisor

__all__ = [
    "FleetAutoscaler",
    "WarmPool",
    "FleetRouter",
    "FleetHandle",
    "FleetOverloaded",
    "LocalReplica",
    "ReplicaDeadError",
    "ReplicaSupervisor",
    "CircuitBreaker",
    "ReplicaHealth",
    "HEALTHY",
    "DEGRADED",
    "DRAINING",
    "DEAD",
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
]
