"""serving/frontdoor/ — the multi-tenant front door ahead of the serving
engine (counterpart of ``deepspeed_tpu/serving/frontdoor``).

- ``transport.py`` — the transport-agnostic RPC replica boundary: one
  wire codec (op dispatch + exception registry + crc-framed binary
  frames, the JAX package's wire byte for byte) shared by an in-process
  transport and socket / child-process stream transports, so the fleet
  router, supervisor and autoscaler drive local and remote replicas
  through one duck surface.
- ``tenants.py`` — token-bucket admission rates, weighted-fair queueing
  ahead of the priority tiers, SLO classes mapped onto scheduler
  priorities, paged-KV page / pinned-prefix quotas, and
  tenant-attributed accounting that reconciles exactly against the
  request journal across a crash.
- ``http.py`` — the stdlib HTTP surface: chunked streaming token
  responses, request deadlines mapped to scheduler deadlines,
  ``Retry-After``-bearing 429/503 answers, and SIGTERM graceful drain
  composed with the serving watchdog (exit 43 after journal commit).
"""
from deepspeed_tpu_torch.serving.frontdoor.tenants import (
    DEFAULT_TENANT,
    SLO_CLASSES,
    TenantRegistry,
    TenantThrottled,
    journal_tenant_totals,
)
from deepspeed_tpu_torch.serving.frontdoor.transport import (
    InProcTransport,
    LoopbackTransport,
    ProcessTransport,
    SocketTransport,
    StreamTransport,
    TransportFrameError,
    TransportReplica,
    dispatch,
    raise_wire,
    read_frame,
    serve_socket,
    serve_stdio,
    serve_stream,
    wrap_replica,
    write_frame,
)
from deepspeed_tpu_torch.serving.frontdoor.http import FrontDoor

__all__ = [
    "DEFAULT_TENANT",
    "SLO_CLASSES",
    "TenantRegistry",
    "TenantThrottled",
    "journal_tenant_totals",
    "InProcTransport",
    "LoopbackTransport",
    "ProcessTransport",
    "SocketTransport",
    "StreamTransport",
    "TransportFrameError",
    "TransportReplica",
    "dispatch",
    "raise_wire",
    "read_frame",
    "serve_socket",
    "serve_stdio",
    "serve_stream",
    "wrap_replica",
    "write_frame",
    "FrontDoor",
]
