"""FleetAutoscaler: load-driven replica count with live KV migration
(counterpart of ``deepspeed_tpu/serving/fleet/elastic.py``).

The elastic half of the fleet story.  The reference DeepSpeed ships ``deepspeed/elasticity/`` and
``runner.py --restarts`` because production fleets must survive spiky
traffic and node churn; here the same need is served by ONE component
watching the router's own signals:

* **signals** — per-replica queue depth and admitted-TTFT estimate
  (both straight off the replica surface the router already routes by)
  plus the router's rejection counter (the shed-rate proxy: every
  ``FleetOverloaded`` the fleet absorbed since the last tick).
* **hysteresis** — a tick is *hot* when any routable replica's queue
  depth or TTFT estimate crosses its scale-up threshold (or the fleet
  shed since the last tick), *cold* when every routable replica sits at
  or under ``scale_down_queue_depth`` with no shed.  ``engage_ticks``
  consecutive hot ticks trigger a scale-up, ``disengage_ticks``
  consecutive cold ticks a scale-down, each then held off by its own
  cooldown — four independent knobs so spiky load cannot flap the
  fleet.
* **scale-up** — replicas come from a :class:`WarmPool`: a background
  filler thread builds replicas through the factory (a child process
  each, or an engine and its warm hook, OFF the routing thread) and
  parks them ready; ``tick()`` just
  adopts one, which is O(bookkeeping) on the routing thread.  Fault
  site ``fleet.scale_up`` (fail / latency).
* **scale-down** — the victim transitions to DRAINING (no new routes;
  in-flight work keeps stepping), and once idle its parked sessions and
  pinned prefixes are **live-migrated** to a survivor: the victim's
  ``export_sessions`` writes the paged pool's spill wire format (manifest-last
  per entry, read-only on the victim — retryable), the survivor's
  ``import_sessions`` adopts every manifest-verified entry, router
  affinity re-points because the survivor now answers ``kv_affinity``
  for those sessions, and the post-migration turn continues
  bit-identically.  Export/import failures retry up to
  ``migration_retries`` times; a victim that dies mid-migration is
  handed to the router's death path (journal replay — zero acknowledged
  loss); a victim still holding in-flight work past
  ``migration_deadline_seconds`` ABORTS the scale-down and returns to
  rotation (scale-down never proceeds over live requests).

``tick()`` runs on the routing thread (call it between ``step()``s, the
same discipline the router's own bookkeeping follows).  The warm-pool
filler is the only thread the autoscaler itself starts.
"""
from __future__ import annotations

import shutil
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from deepspeed_tpu_torch.config.config import ElasticConfig
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving.fleet.health import DRAINING
from deepspeed_tpu_torch.serving.fleet.replica import ReplicaDeadError
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class WarmPool:
    """Pre-built replicas, filled by a background daemon thread so
    scale-up never charges a replica's build to the routing thread.

    ``factory(name) -> replica`` builds one ready-to-serve replica (a
    :class:`LocalReplica` factory typically runs the warm hook inside).
    The filler keeps ``size`` replicas parked; :meth:`take` pops one in
    O(1).  ``size=0`` disables the pool (``take`` builds inline)."""

    def __init__(self, factory: Callable[[str], Any], size: int = 1,
                 name_prefix: str = "elastic"):
        self._factory = factory
        self.size = max(0, int(size))
        self._prefix = str(name_prefix)
        self._lock = threading.Lock()
        self._ready: Deque[Any] = deque()
        self._built = 0  # lifetime builds -> unique replica names
        self._failures = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.size > 0:
            self._thread = threading.Thread(
                target=self._fill_loop, name="fleet-warm-pool", daemon=True
            )
            self._thread.start()

    def _next_name(self) -> str:
        with self._lock:
            self._built += 1
            return f"{self._prefix}{self._built}"

    def _fill_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                deficit = self.size - len(self._ready)
            if deficit <= 0:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            name = self._next_name()
            try:
                rep = self._factory(name)
            except Exception as e:
                with self._lock:
                    self._failures += 1
                logger.warning(f"fleet: warm-pool build of {name} failed: {e!r}")
                self._wake.wait(timeout=0.2)  # don't spin on a broken factory
                self._wake.clear()
                continue
            with self._lock:
                self._ready.append(rep)

    def take(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Pop a warm replica.  With an empty pool: waits up to
        ``timeout`` for the filler (None = no wait), then falls back to
        an INLINE build — correct but slow, and logged as such."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            rep = None
            with self._lock:
                if self._ready:
                    rep = self._ready.popleft()
            if rep is not None:
                # the Event is self-synchronized: signal the refill
                # outside the lock so every _wake access is lock-free
                self._wake.set()
                return rep
            if self._thread is None or deadline is None:
                break
            if time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        name = self._next_name()
        logger.warning(
            f"fleet: warm pool empty; building replica {name} inline "
            "(scale-up pays the build)"
        )
        try:
            return self._factory(name)
        except Exception as e:
            with self._lock:
                self._failures += 1
            logger.error(f"fleet: inline replica build of {name} failed: {e!r}")
            return None

    def ready(self) -> int:
        with self._lock:
            return len(self._ready)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "size": self.size,
                "ready": len(self._ready),
                "built": self._built,
                "build_failures": self._failures,
            }


class FleetAutoscaler:
    """Drive the router's replica count from its own load signals.

    ``router`` — a :class:`FleetRouter`.  ``replica_factory(name)``
    builds one ready replica (feeds the warm pool).  ``config`` — an
    :class:`ElasticConfig` (or dict).  ``clock`` is injectable so tests
    run hysteresis and cooldowns at full speed."""

    # drain phases (one victim at a time; stats() surfaces the phase)
    _IDLE = "idle"
    _DRAIN_WAIT = "draining"
    _MIGRATING = "migrating"

    def __init__(
        self,
        router: Any,
        replica_factory: Callable[[str], Any],
        config: Any = None,
        clock: Callable[[], float] = time.monotonic,
        handoff_root: Optional[str] = None,
    ):
        if config is None:
            config = ElasticConfig()
        elif isinstance(config, dict):
            config = ElasticConfig.from_dict(config)
        self.config = config
        self.router = router
        self._clock = clock
        self._handoff_root = handoff_root
        self.pool = WarmPool(replica_factory, size=config.warm_pool_size)
        self._hot_ticks = 0
        self._cold_ticks = 0
        self._last_scale_up = -float("inf")
        self._last_scale_down = -float("inf")
        self._last_rejections = int(getattr(router, "rejections", 0))
        self._hot_since: Optional[float] = None  # reaction-time anchor
        self._cold_since: Optional[float] = None
        # drain state (at most one victim at a time)
        self._phase = self._IDLE
        self._victim: Optional[str] = None
        self._drain_started = 0.0
        # counters / event log (stats() reads these)
        self.ticks = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.scale_downs_aborted = 0
        self.migrations_completed = 0
        self.migrations_failed = 0
        self.sessions_migrated = 0
        self.last_scale_up_reaction_s: Optional[float] = None
        self.last_scale_down_reaction_s: Optional[float] = None
        self.events: Deque[Dict[str, Any]] = deque(maxlen=32)
        log_dist(
            f"fleet: autoscaler armed ({config.min_replicas}.."
            f"{config.max_replicas} replicas, up at queue>"
            f"{config.scale_up_queue_depth} or ttft>"
            f"{config.scale_up_ttft_seconds}s x{config.engage_ticks} ticks, "
            f"down at queue<={config.scale_down_queue_depth} "
            f"x{config.disengage_ticks} ticks, warm pool "
            f"{config.warm_pool_size})"
        )

    # -- signal plane -----------------------------------------------------
    def _routable(self) -> List[str]:
        out = []
        for name in list(self.router._order):
            rep = self.router._replicas.get(name)
            h = self.router._health.get(name)
            if rep is None or h is None:
                continue
            if rep.alive() and h.routable(self._clock()):
                out.append(name)
        return out

    def _read_signals(self) -> Dict[str, Any]:
        names = self._routable()
        depths, ests = [], []
        for name in names:
            rep = self.router._replicas.get(name)
            if rep is None:
                continue
            depths.append(int(rep.queue_depth()))
            est = rep.estimate_ttft(1)
            if est is not None:
                ests.append(float(est))
        rejections = int(getattr(self.router, "rejections", 0))
        shed = rejections - self._last_rejections
        self._last_rejections = rejections
        return {
            "routable": len(names),
            "max_queue_depth": max(depths) if depths else 0,
            "max_ttft_est": max(ests) if ests else 0.0,
            "shed": max(0, shed),
        }

    # -- the tick ---------------------------------------------------------
    def tick(self) -> None:
        """One autoscaler evaluation; call on the routing thread between
        router steps.  Cheap: signal reads + bookkeeping; the only heavy
        work (engine builds) happens on the warm-pool filler thread."""
        now = self._clock()
        self.ticks += 1
        self._sweep_idle_sessions(now)
        if self._phase != self._IDLE:
            self._continue_drain(now)
            return
        sig = self._read_signals()
        n = len(self.router._order)
        hot = (
            sig["max_queue_depth"] > self.config.scale_up_queue_depth
            or sig["max_ttft_est"] > self.config.scale_up_ttft_seconds
            or sig["shed"] > 0
        )
        cold = (
            not hot
            and sig["shed"] == 0
            and sig["max_queue_depth"] <= self.config.scale_down_queue_depth
        )
        if hot:
            self._hot_ticks += 1
            self._cold_ticks = 0
            self._cold_since = None
            if self._hot_since is None:
                self._hot_since = now
        elif cold:
            self._cold_ticks += 1
            self._hot_ticks = 0
            self._hot_since = None
            if self._cold_since is None:
                self._cold_since = now
        else:
            self._hot_ticks = self._cold_ticks = 0
            self._hot_since = self._cold_since = None
        if (
            self._hot_ticks >= self.config.engage_ticks
            and n < self.config.max_replicas
            and now - self._last_scale_up >= self.config.scale_up_cooldown_seconds
        ):
            self._scale_up(now)
        elif (
            self._cold_ticks >= self.config.disengage_ticks
            and n > self.config.min_replicas
            and now - self._last_scale_down
            >= self.config.scale_down_cooldown_seconds
        ):
            self.request_scale_down(now=now)

    # -- scale-up ---------------------------------------------------------
    def _scale_up(self, now: float) -> None:
        try:
            faults.check("fleet.scale_up")
            faults.check_latency("fleet.scale_up")
            rep = self.pool.take()
        except Exception as e:
            logger.warning(f"fleet: scale-up failed: {e!r}")
            self.events.append({"kind": "scale_up_failed", "at": now,
                                "reason": repr(e)})
            self._hot_ticks = 0  # re-earn the trigger rather than spin
            return
        if rep is None:
            self._hot_ticks = 0
            return
        self.router.add_replica(rep)
        self.scale_ups += 1
        self._last_scale_up = now
        reaction = (now - self._hot_since) if self._hot_since is not None else 0.0
        self.last_scale_up_reaction_s = reaction
        self._hot_ticks = 0
        self._hot_since = None
        self.events.append({
            "kind": "scale_up", "at": now, "replica": rep.name,
            "reaction_s": reaction,
        })
        log_dist(
            f"fleet: scaled UP to {len(self.router._order)} replicas "
            f"(+{rep.name}, reaction {reaction:.3f}s)"
        )

    # -- scale-down / migration -------------------------------------------
    def request_scale_down(self, name: Optional[str] = None,
                           now: Optional[float] = None) -> bool:
        """Begin draining a victim (default: the most recently added
        routable replica — LIFO keeps the original fleet stable).
        Returns False when no eligible victim exists or a drain is
        already underway."""
        if self._phase != self._IDLE:
            return False
        now = self._clock() if now is None else now
        if name is None:
            routable = self._routable()
            if len(self.router._order) <= self.config.min_replicas:
                return False
            if not routable:
                return False
            name = routable[-1]
        elif name not in self.router._replicas:
            return False
        self.router.begin_drain(name, "elastic scale-down")
        self._phase = self._DRAIN_WAIT
        self._victim = name
        self._drain_started = now
        self.events.append({"kind": "drain_start", "at": now, "replica": name})
        log_dist(f"fleet: draining replica {name} for scale-down")
        return True

    def _continue_drain(self, now: float) -> None:
        name = self._victim
        rep = self.router._replicas.get(name)
        h = self.router._health.get(name)
        if rep is None or h is None:
            self._finish_drain(now, removed=False)
            return
        if not rep.alive() or h.state not in (DRAINING,):
            # the victim died (or was revived by someone else) while
            # draining: the router's death path owns it now — journal
            # replay reproduces anything the migration would have moved
            self._abort_drain(now, reason="victim left draining state")
            return
        inflight = self.router.inflight_on(name)
        if inflight > 0:
            if now - self._drain_started > self.config.migration_deadline_seconds:
                # NEVER proceed over live requests: give up the
                # scale-down and put the victim back into rotation
                self._abort_drain(
                    now,
                    reason=f"{inflight} in-flight past the "
                    f"{self.config.migration_deadline_seconds}s deadline",
                )
            return
        self._phase = self._MIGRATING
        self._migrate(name, rep, now)

    def _pick_survivor(self, victim: str) -> Optional[Any]:
        for name in reversed(self._routable()):
            if name != victim:
                return self.router._replicas.get(name)
        return None

    def _migrate(self, victim_name: str, victim: Any, now: float) -> None:
        """Move the victim's parked sessions + pinned prefixes to a
        survivor.  Bounded retries; total failure only costs warmth
        (the next turn re-prefills), never acknowledged work."""
        survivor = self._pick_survivor(victim_name)
        exporter = getattr(victim, "export_sessions", None)
        importer = getattr(survivor, "import_sessions", None) if survivor else None
        if exporter is None or importer is None:
            self._finish_drain(now, removed=True)  # nothing to move
            return
        handoff = tempfile.mkdtemp(
            prefix=f"migrate_{victim_name}_", dir=self._handoff_root
        )
        attempts = self.config.migration_retries + 1
        moved = None
        for attempt in range(attempts):
            try:
                exported = exporter(handoff)
                counts = importer(handoff)
                moved = (exported, counts)
                break
            except ReplicaDeadError:
                # the victim's process died mid-migration: hand it to
                # the router's death path — the supervisor restart +
                # journal replay keeps acknowledged work lossless, and
                # this scale-down is abandoned
                self.migrations_failed += 1
                self.events.append({
                    "kind": "migration_died", "at": now, "replica": victim_name,
                })
                logger.warning(
                    f"fleet: replica {victim_name} died mid-migration; "
                    "falling back to journal replay"
                )
                shutil.rmtree(handoff, ignore_errors=True)
                self._phase = self._IDLE
                self._victim = None
                self.router.mark_dead(victim_name, "died mid-migration")
                return
            except Exception as e:
                logger.warning(
                    f"fleet: migration attempt {attempt + 1}/{attempts} "
                    f"from {victim_name} failed: {e!r}"
                )
        shutil.rmtree(handoff, ignore_errors=True)
        if moved is None:
            # migration never succeeded: proceed with removal anyway —
            # sessions the victim had spilled remain on ITS spill_dir
            # (journal/spill recovery territory); the fleet only loses
            # warmth, not acknowledged work
            self.migrations_failed += 1
            self.events.append({
                "kind": "migration_failed", "at": now, "replica": victim_name,
            })
        else:
            exported, counts = moved
            self.migrations_completed += 1
            self.sessions_migrated += int(counts.get("sessions", 0))
            self.events.append({
                "kind": "migration", "at": now, "replica": victim_name,
                "exported": len(exported), "imported": dict(counts),
            })
        self._finish_drain(now, removed=True)

    def _abort_drain(self, now: float, reason: str) -> None:
        name = self._victim
        self.scale_downs_aborted += 1
        self.events.append({
            "kind": "drain_aborted", "at": now, "replica": name,
            "reason": reason,
        })
        logger.warning(f"fleet: scale-down of {name} aborted ({reason})")
        h = self.router._health.get(name)
        if h is not None and h.state == DRAINING:
            self.router.abort_drain(name)
        self._phase = self._IDLE
        self._victim = None
        self._cold_ticks = 0
        self._cold_since = None
        self._last_scale_down = now  # cooldown before the next try

    def _finish_drain(self, now: float, removed: bool) -> None:
        name = self._victim
        if removed and name in self.router._replicas:
            try:
                self.router.remove_replica(name)
            except ValueError as e:  # late-bound handle appeared: abort
                self._abort_drain(now, reason=str(e))
                return
        self.scale_downs += 1
        self._last_scale_down = now
        reaction = now - self._drain_started
        self.last_scale_down_reaction_s = reaction
        self._phase = self._IDLE
        self._victim = None
        self._cold_ticks = 0
        self._cold_since = None
        self.events.append({
            "kind": "scale_down", "at": now, "replica": name,
            "reaction_s": reaction,
        })
        log_dist(
            f"fleet: scaled DOWN to {len(self.router._order)} replicas "
            f"(-{name}, drain+migrate {reaction:.3f}s)"
        )

    # -- idle-session TTL sweep -------------------------------------------
    def _sweep_idle_sessions(self, now: float) -> None:
        """An idle replica never steps, so its per-step pool sweep never
        runs and parked sessions never expire — sweep from the tick so a
        drained-but-alive replica still releases pages."""
        for name in list(self.router._order):
            rep = self.router._replicas.get(name)
            sweep = getattr(rep, "sweep_sessions", None) if rep else None
            if sweep is None:
                continue
            try:
                sweep(time.monotonic())
            except Exception:
                pass  # a dying replica's sweep must not kill the tick

    # -- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": len(self.router._order),
            "min_replicas": self.config.min_replicas,
            "max_replicas": self.config.max_replicas,
            "phase": self._phase,
            "victim": self._victim,
            "ticks": self.ticks,
            "hot_ticks": self._hot_ticks,
            "cold_ticks": self._cold_ticks,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_downs_aborted": self.scale_downs_aborted,
            "migrations_completed": self.migrations_completed,
            "migrations_failed": self.migrations_failed,
            "sessions_migrated": self.sessions_migrated,
            "last_scale_up_reaction_s": self.last_scale_up_reaction_s,
            "last_scale_down_reaction_s": self.last_scale_down_reaction_s,
            "warm_pool": self.pool.stats(),
            "last_events": list(self.events)[-8:],
        }

    def stop(self) -> None:
        self.pool.stop()


__all__ = ["FleetAutoscaler", "WarmPool"]
