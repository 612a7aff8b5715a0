"""Resilience subsystem (counterpart of ``deepspeed_tpu/resilience``): the
machinery that lets a long run survive preemption, bad disks and
divergence, with a fault-injection harness proving each recovery path
(``tests/test_torch_resilience.py``).

* :mod:`~deepspeed_tpu_torch.resilience.atomic` — atomic metadata writes
  and per-tag size+checksum manifests (a tag exists fully or not at all);
* :mod:`~deepspeed_tpu_torch.resilience.manager` — stage/commit/
  quarantine/retention over a checkpoint tree;
* :mod:`~deepspeed_tpu_torch.resilience.policy` — the shared retry policy
  and the divergence guard;
* :mod:`~deepspeed_tpu_torch.resilience.watchdog` — SIGTERM → emergency
  checkpoint at the next step boundary → distinctive exit code;
* :mod:`~deepspeed_tpu_torch.resilience.faults` — the deterministic fault
  injector the tests drive everything with.

The supervision plane (heartbeats, the hung-collective watchdog, exit
44) is not ported (ROADMAP A14).
"""
from deepspeed_tpu_torch.resilience.atomic import (  # noqa: F401
    MANIFEST_FILE,
    atomic_write_text,
    file_digest,
    fsync_dir,
    verify_manifest,
    write_manifest,
)
from deepspeed_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    InjectedFault,
    InjectedKill,
)
from deepspeed_tpu_torch.resilience.policy import (  # noqa: F401
    DivergenceGuard,
    RetryError,
    RetryPolicy,
    retry,
    retry_call,
)
from deepspeed_tpu_torch.resilience.watchdog import (  # noqa: F401
    EXIT_PREEMPTED_SAVED,
    PreemptionWatchdog,
)
from deepspeed_tpu_torch.resilience import manager  # noqa: F401


class CheckpointNotFoundError(RuntimeError):
    """Strict-mode load found no loadable (verified) checkpoint."""
