"""Replica handles: the interface the FleetRouter routes against
(counterpart of ``deepspeed_tpu/serving/fleet/replica.py``).

A replica is anything that can ``submit/step/cancel/pop_results`` and
answer liveness + load questions — duck-typed, so the router serves

* :class:`LocalReplica` — an in-process :class:`~deepspeed_tpu_torch.serving.
  engine.ServingEngine` built by a factory over its own journal
  directory.  ``kill()`` models process loss faithfully: the engine
  object is DROPPED without drain, so only journal-committed state
  survives — exactly the durable set a ``kill -9`` leaves behind.
  ``restart()`` rebuilds through the factory and replays the journal
  under original ids (the lossless-restart contract).
* process replicas — ``serving/frontdoor/transport.py``'s
  :class:`TransportReplica` over a :class:`ProcessTransport` implements
  the same surface over a child process's framed stdio pipes, whose EOF
  is the death signal (what a ``kill -9`` looks like from outside).

The required surface (see :class:`LocalReplica` for semantics):
``name``, ``alive()``, ``submit(prompt, **kw) -> id``, ``cancel(id)``,
``step()``, ``has_work()``, ``pop_results()``, ``result(id)``,
``first_token_seen(id)``, ``estimate_ttft(prompt_len)``,
``queue_depth()``, ``degrade_level()``, ``draining()``,
``client_request_id(key)``, ``restart() -> replayed ids``, ``stats()``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.utils.logging import logger


class ReplicaDeadError(RuntimeError):
    """The replica's process is gone (or its in-process stand-in was
    killed): the route attempt never reached a journal ack, so the
    router may safely retry the request on another replica."""


class LocalReplica:
    """In-process replica over a factory-built ServingEngine.

    The factory MUST bind a stable per-replica ``journal_dir`` — the
    journal is the identity that survives ``kill()``; a journal-less
    factory still restarts, but replays nothing (lossy, logged).

    ``warm`` (optional) runs against every factory-built engine BEFORE
    it serves — restart included, before ``recover()`` replays — so a
    rebuilt replica pays its first-call costs (allocator growth, kernel
    loads) off the routing path instead of charging them to the replayed
    requests' TTFT.
    """

    def __init__(self, name: str, factory: Callable[[], Any],
                 warm: Optional[Callable[[Any], None]] = None):
        self.name = str(name)
        self._factory = factory
        self._warm = warm
        self.engine = factory()
        if warm is not None:
            warm(self.engine)
        self._dead = False
        self.kills = 0
        if self.engine._journal is None:
            logger.warning(
                f"fleet: replica {self.name} has no journal armed — a death "
                "loses its accepted work (restart replays nothing)"
            )

    # -- liveness ---------------------------------------------------------
    def alive(self) -> bool:
        return not self._dead

    def kill(self, reason: str = "killed") -> None:
        """Model a process loss: drop the engine mid-flight.  No drain,
        no final commit — the journal keeps only what was committed at
        the moment of death, which is the whole point."""
        self._dead = True
        self.engine = None
        self.kills += 1
        logger.warning(f"fleet: replica {self.name} killed ({reason})")

    def restart(self) -> List[int]:
        """Rebuild through the factory over the same journal directory
        and replay: incomplete acknowledged requests come back under
        their ORIGINAL ids (greedy and seeded-sampling replays
        bit-match the uninterrupted run — ``ServingEngine.recover``).
        The warm hook runs before the replay so the rebuilt engine's
        first-call cost never lands on the replayed requests."""
        self.engine = self._factory()
        if self._warm is not None:
            self._warm(self.engine)
        self._dead = False
        return self.engine.recover()

    def _require_alive(self):
        if self._dead or self.engine is None:
            raise ReplicaDeadError(f"replica {self.name} is dead")
        return self.engine

    # -- request surface --------------------------------------------------
    def submit(self, prompt, **kw) -> int:
        return self._require_alive().submit(prompt, **kw)

    def cancel(self, request_id: int) -> bool:
        if self._dead or self.engine is None:
            return False
        return self.engine.cancel(request_id)

    def step(self) -> bool:
        return self._require_alive().step()

    def has_work(self) -> bool:
        if self._dead or self.engine is None:
            return False
        return self.engine.scheduler.has_work()

    def pop_results(self) -> Dict[int, Any]:
        if self._dead or self.engine is None:
            return {}
        return self.engine.pop_results()

    def result(self, request_id: int) -> Optional[Any]:
        if self._dead or self.engine is None:
            return None
        return self.engine.result(request_id)

    def first_token_seen(self, request_id: int) -> bool:
        r = self.result(request_id)
        return r is not None and r.first_token_time is not None

    def client_request_id(self, client_key: str) -> Optional[int]:
        if self._dead or self.engine is None:
            return None
        return self.engine.client_request_id(client_key)

    # -- load / health feeds ----------------------------------------------
    def estimate_ttft(self, prompt_len: int) -> Optional[float]:
        """The replica's own admission estimate (queue backlog over its
        measured step rate) — the router's least-estimated-TTFT placement
        signal.  None on a cold replica (no measurement = no penalty)."""
        if self._dead or self.engine is None:
            return None
        return self.engine.scheduler.admission.estimate_ttft_seconds(prompt_len)

    def kv_affinity(self, prompt, session_id: Optional[str] = None) -> float:
        """Prompt tokens this replica could serve from its paged KV —
        a parked session for ``session_id`` or a cached prefix — the
        router's placement-affinity signal.  With KV tiering armed the
        count is priced by residency (device 1.0 > host 0.75 > disk 0.5):
        a replica that
        must promote from disk offers less than one already holding the
        pages warm.  Side-effect-free; 0 on the slot-contiguous pool, a
        dead replica, or a miss."""
        if self._dead or self.engine is None:
            return 0.0
        priced = getattr(self.engine.pool, "affinity_tokens", None)
        if priced is not None:
            return float(priced(prompt, session_id=session_id))
        hint = getattr(self.engine.pool, "prefix_hint_tokens", None)
        if hint is None:
            return 0.0
        return float(hint(prompt, session_id=session_id))

    def queue_depth(self) -> int:
        if self._dead or self.engine is None:
            return 0
        return self.engine.scheduler.queue_depth

    def degrade_level(self) -> int:
        if self._dead or self.engine is None:
            return 0
        return self.engine.scheduler.ladder.level

    def draining(self) -> bool:
        if self._dead or self.engine is None:
            return False
        wd = self.engine._watchdog
        return bool(wd is not None and wd.draining)

    def stats(self) -> Dict[str, Any]:
        if self._dead or self.engine is None:
            return {"dead": True}
        return self.engine.stats()

    # -- live migration (the elastic fleet's scale-down) -------------------
    def export_sessions(self, dest_dir: str) -> List[str]:
        """Scale-down: write this replica's parked sessions and pinned
        prefixes into ``dest_dir`` in the spill wire format (read-only
        on the pool — retryable).  Empty on a slot-contiguous pool.
        Fault site ``migrate.export`` (fail / latency / sigkill)."""
        engine = self._require_alive()
        faults.check("migrate.export")
        faults.check_latency("migrate.export")
        export = getattr(engine.pool, "export_sessions", None)
        if export is None:
            return []
        return export(dest_dir, now=time.monotonic())

    def import_sessions(self, src_dir: str) -> Dict[str, int]:
        """Survivor side: adopt every manifest-verified entry under
        ``src_dir``.  Fault site ``migrate.import``."""
        engine = self._require_alive()
        faults.check("migrate.import")
        faults.check_latency("migrate.import")
        imp = getattr(engine.pool, "import_sessions", None)
        if imp is None:
            return {}
        return imp(src_dir, now=time.monotonic())

    def sweep_sessions(self, now: float) -> int:
        """TTL-sweep parked sessions host-side.  The engine sweeps per
        step, so an idle (drained-but-alive) replica never steps and
        never expires — the autoscaler tick calls this instead."""
        if self._dead or self.engine is None:
            return 0
        sweep = getattr(self.engine.pool, "sweep", None)
        if sweep is None:
            return 0
        return int(sweep(now))


__all__ = ["LocalReplica", "ReplicaDeadError"]
