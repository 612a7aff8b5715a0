"""FleetRouter: the front door over N serving-engine replicas (counterpart
of ``deepspeed_tpu/serving/fleet/router.py``).

One ``submit()`` surface for the whole fleet:

* **placement** — least-estimated-TTFT: each routable replica prices
  the candidate through its own admission controller (queue backlog
  over its measured step rate), degraded replicas are deprioritized,
  and ties rotate round-robin.  A replica that rejects with
  ``retry_after`` is held under router-level backpressure for exactly
  that long — the engine's hint IS the router's schedule.
* **failure handling** — a submit that fails before the journal ack is
  retried on another replica (bounded by ``route_retries``; safe
  because an un-acknowledged request is un-journaled by the WAL
  contract).  Per-replica circuit breakers (consecutive-failure trip,
  half-open probes, seeded-jitter exponential backoff) take chronically
  failing replicas out of rotation.  Optional tail-latency hedging
  duplicates a still-first-token-less request to a second replica after
  ``hedge_factor x`` the observed p99 TTFT; the first leg to produce a
  token wins and the loser is cancelled via scheduler retirement.
* **lossless restart** — on replica death (liveness EOF, an injected
  ``replica.death``, or a route failure surfacing
  :class:`~deepspeed_tpu_torch.serving.fleet.replica.ReplicaDeadError`) the
  router marks it dead and hands it to the
  :class:`~deepspeed_tpu_torch.serving.fleet.supervisor.ReplicaSupervisor`;
  the restarted engine replays its journal under ORIGINAL ids and the
  router re-binds in-flight handles to the replayed requests —
  acknowledged work completes bit-identically.  Requests whose results
  died with an unrestartable replica are re-fired on another replica:
  generation is a deterministic function of the journaled fields, so
  the re-run reproduces the same tokens.
* **at-most-once admission** — ``client_key`` dedups against the
  router's handle map AND every live replica's journal-backed key map,
  so a client retry after a crash adopts the original admission instead
  of double-serving.

Fault sites (chaos matrix): ``router.route`` (fail + recurring
latency), ``router.hedge``, ``replica.death``.

The router's counters are its own integers (``stats()``), mirrored into
the telemetry registry (``fleet/*`` counters and the ``fleet/ttft_ms``
histogram) when the process armed it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from deepspeed_tpu_torch.config.config import FleetConfig
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.policy import RetryPolicy
from deepspeed_tpu_torch.serving.fleet.health import (
    DEAD,
    HEALTHY,
    CircuitBreaker,
    ReplicaHealth,
)
from deepspeed_tpu_torch.serving.fleet.replica import ReplicaDeadError
from deepspeed_tpu_torch.serving.fleet.supervisor import RESTART_PENDING
from deepspeed_tpu_torch.serving.scheduler import ServingOverloaded, ServingQueueFull
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class FleetOverloaded(ServingOverloaded):
    """Every routable replica rejected (or none is routable).
    ``retry_after`` is the soonest any replica expects to admit — the
    minimum over the per-replica hints, the fleet-level backpressure
    contract."""


@dataclasses.dataclass
class FleetHandle:
    """One client request as the router tracks it: the primary binding,
    the optional hedge leg, and the original submit parameters (the
    hedge/re-fire path re-submits from these — deterministic outputs
    make that a bit-identical re-run, not a different answer)."""

    handle_id: int
    prompt: np.ndarray
    kwargs: Dict[str, Any]
    client_key: Optional[str]
    submit_time: float
    replica: str
    request_id: int
    hedge_wanted: bool = False
    hedge_replica: Optional[str] = None
    hedge_request_id: Optional[int] = None
    hedged_at: Optional[float] = None
    winner: Optional[str] = None
    refires: int = 0
    done: bool = False


class FleetRouter:
    def __init__(
        self,
        replicas: List[Any],
        config: Any = None,
        supervisor: Any = None,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not replicas:
            raise ValueError("FleetRouter requires at least one replica")
        if config is None:
            config = FleetConfig()
        elif isinstance(config, dict):
            config = FleetConfig.from_dict(config)
        self.config = config
        self._clock = clock
        self._supervisor = supervisor
        self._replicas: Dict[str, Any] = {}
        self._order: List[str] = []
        self._health: Dict[str, ReplicaHealth] = {}
        self._seed = int(seed)
        self._policy = RetryPolicy(
            backoff_seconds=config.breaker_backoff_seconds,
            backoff_max_seconds=config.breaker_backoff_max_seconds,
        )
        # guards fleet MEMBERSHIP (_replicas/_order/_health): the
        # autoscaler's warm-pool add and scale-down remove may race the
        # routing thread's iteration (a scale-down while a route walks).
        # Routing itself stays single-threaded; iteration takes
        # snapshots and tolerates names vanishing mid-walk.
        self._mlock = threading.RLock()
        self._added = 0  # lifetime adds (stable breaker seed offsets)
        for rep in replicas:
            self.add_replica(rep)
        self._rr = 0  # round-robin tie-break rotation
        self._next_handle = 0
        self._handles: Dict[int, FleetHandle] = {}
        self._by_rid: Dict[Tuple[str, int], int] = {}
        self._results: Dict[int, Any] = {}
        self._client_handles: Dict[str, int] = {}
        self._backpressure: Dict[str, float] = {}  # name -> held until
        self._refire_pending: List[int] = []
        self._restarting: Set[str] = set()  # background restarts underway
        self._ttft_ms: List[float] = []  # delivered-TTFT window (hedge p99)
        # counters (mirrored into the telemetry registry when armed)
        from deepspeed_tpu_torch import telemetry as _telemetry

        self.telemetry = _telemetry.manager_for("fleet")
        self.routed = 0
        self.rejections = 0  # per-replica retry_after rejections absorbed
        self.failovers = 0  # submits that succeeded on a non-first replica
        self.route_failures = 0
        self.deaths = 0
        self.hedges = 0
        self.hedge_wins = 0  # hedge leg beat the primary
        self.hedge_cancelled = 0  # loser legs retired
        self.refired = 0
        self.affinity_routes = 0  # placements won by KV affinity
        self.last_failover: Optional[Dict[str, Any]] = None
        log_dist(
            f"fleet: router over {len(self._order)} replica(s) "
            f"({', '.join(self._order)}); breaker trips at "
            f"{config.breaker_failures} consecutive failures, hedging "
            f"{'on' if config.hedge else 'off'}"
        )

    # ------------------------------------------------------------------
    # membership (the elastic fleet)
    # ------------------------------------------------------------------
    def add_replica(self, rep: Any) -> None:
        """Bring a replica into rotation (elastic scale-up; also the
        constructor's own registration path).  Safe against a concurrent
        routing walk — membership mutates under ``_mlock`` and the walks
        snapshot."""
        name = rep.name
        with self._mlock:
            if name in self._replicas:
                raise ValueError(f"duplicate replica name {name!r}")
            health = ReplicaHealth(
                name,
                CircuitBreaker(
                    failure_threshold=self.config.breaker_failures,
                    policy=self._policy,
                    halfopen_probes=self.config.breaker_halfopen_probes,
                    seed=self._seed + self._added,
                    clock=self._clock,
                ),
            )
            self._added += 1
            self._replicas[name] = rep
            self._order.append(name)
            self._health[name] = health

    def remove_replica(self, name: str) -> Any:
        """Take a replica out of the fleet entirely (elastic scale-down,
        after drain + migration).  Refuses while any unresolved handle
        is still bound to it — the autoscaler must drain first."""
        with self._mlock:
            if name not in self._replicas:
                raise ValueError(f"unknown replica {name!r}")
            bound = self.inflight_on(name)
            if bound:
                raise ValueError(
                    f"replica {name!r} still holds {bound} in-flight "
                    f"handle(s); drain before removing"
                )
            rep = self._replicas.pop(name)
            self._order.remove(name)
            self._health.pop(name, None)
            self._backpressure.pop(name, None)
            self._restarting.discard(name)
            return rep

    def begin_drain(self, name: str, reason: str = "scale-down") -> None:
        """Stop routing NEW work at a replica; in-flight work keeps
        stepping to completion (DRAINING is stepped but not routable)."""
        h = self._health.get(name)
        if h is None:
            raise ValueError(f"unknown replica {name!r}")
        h.mark_draining(reason)

    def abort_drain(self, name: str) -> None:
        """Put a draining replica back into rotation (scale-down aborted
        at its migration deadline)."""
        h = self._health.get(name)
        if h is not None:
            h.mark_undrained()

    def inflight_on(self, name: str) -> int:
        """Unresolved handles whose primary or hedge leg is bound to
        ``name`` — the scale-down gate."""
        return sum(
            1 for hd in self._handles.values()
            if not hd.done and (hd.replica == name or hd.hedge_replica == name)
        )

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _pick(self, prompt_len: int, exclude: Set[str], now: float,
              prompt: Optional[np.ndarray] = None,
              session_id: Optional[str] = None) -> Optional[str]:
        """Least-estimated-TTFT over routable, non-backpressured
        replicas; degraded states rank after healthy; ties rotate.
        When ``prompt`` is given, KV affinity dominates within a health
        tier: the replica holding the request's parked session or
        longest cached prefix wins placement.  Hedge legs pass no prompt — a hedge exists
        to ESCAPE the primary, so it must not be pulled back by the
        primary's warm cache."""
        scored = []
        order = list(self._order)  # snapshot: membership may mutate
        n = len(order)
        for i, name in enumerate(order):
            if name in exclude:
                continue
            rep = self._replicas.get(name)
            h = self._health.get(name)
            if rep is None or h is None:
                continue  # removed mid-walk
            if not rep.alive() or not h.routable(now):
                continue
            if self._backpressure.get(name, 0.0) > now:
                continue  # honoring the replica's own retry_after
            aff = 0.0
            if prompt is not None:
                probe = getattr(rep, "kv_affinity", None)
                if probe is not None:
                    try:
                        # float: tier-priced affinity (host 0.75 / disk
                        # 0.5 per token) must keep its fraction so warm
                        # residency outbids a disk-resident copy
                        aff = float(probe(prompt, session_id=session_id))
                    except Exception:  # a probe failure must not unroute
                        aff = 0.0
            est = rep.estimate_ttft(prompt_len)
            scored.append((
                0 if h.state == HEALTHY else 1,
                -aff,
                est if est is not None else 0.0,
                rep.queue_depth(),
                (i - self._rr) % n,
                name,
            ))
        if not scored:
            return None
        self._rr += 1
        best = min(scored)
        if best[1] < 0:
            self.affinity_routes += 1
            if self.telemetry.collect:
                self.telemetry.counter("fleet/affinity_routes").inc()
        return best[-1]

    def _route(
        self,
        prompt: np.ndarray,
        kwargs: Dict[str, Any],
        exclude: Set[str],
        now: float,
        client_key: Optional[str] = None,
    ) -> Tuple[str, int]:
        """One placement: try up to ``route_retries + 1`` replicas.  A
        retry is safe exactly because a failed submit never produced a
        journal ack (the WAL contract: the id is acknowledged only after
        the submit record commits)."""
        hints: List[float] = []
        tried: Set[str] = set(exclude)
        attempts = 0
        while attempts <= self.config.route_retries:
            name = self._pick(len(prompt), tried, now, prompt=prompt,
                              session_id=kwargs.get("session_id"))
            if name is None:
                break
            attempts += 1
            tried.add(name)
            rep = self._replicas.get(name)
            h = self._health.get(name)
            if rep is None or h is None:
                continue  # removed between pick and submit
            try:
                rid = rep.submit(prompt, client_key=client_key, **kwargs)
            except ServingQueueFull as e:
                # overload is not a breaker failure — the replica is
                # alive and telling us exactly when to come back
                self.rejections += 1
                if e.retry_after:
                    self._backpressure[name] = max(
                        self._backpressure.get(name, 0.0), now + e.retry_after
                    )
                    hints.append(e.retry_after)
                continue
            except ReplicaDeadError:
                self._handle_death(name, "died at submit", now)
                continue
            except Exception as e:
                self.route_failures += 1
                tripped = h.breaker.record_failure(now)
                if self.telemetry.collect:
                    self.telemetry.counter("fleet/route_failures").inc()
                    if tripped:
                        self.telemetry.counter("fleet/breaker_trips").inc()
                logger.warning(f"fleet: submit to {name} failed ({e!r}); "
                               f"{'breaker OPEN, ' if tripped else ''}trying next")
                continue
            h.breaker.record_success()
            if attempts > 1:
                self.failovers += 1
                if self.telemetry.collect:
                    self.telemetry.counter("fleet/failovers").inc()
            return name, rid
        retry = min(hints) if hints else self._soonest_retry(now)
        raise FleetOverloaded(
            f"fleet overloaded: no replica admitted the request "
            f"({attempts} tried, {len(self._order)} total); retry after "
            f"~{retry:.2f}s",
            retry_after=retry,
        )

    def _soonest_retry(self, now: float) -> float:
        """When nothing is routable and nobody handed us a hint: the
        soonest a breaker half-opens or a backpressure hold expires."""
        candidates = [u - now for u in list(self._backpressure.values()) if u > now]
        for h in list(self._health.values()):
            if h.state != DEAD and h.breaker.retry_at is not None:
                candidates.append(h.breaker.retry_at - now)
        return max(min(candidates), 0.05) if candidates else 1.0

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: Optional[int] = None,
        client_key: Optional[str] = None,
        hedge: Optional[bool] = None,
        **kw,
    ) -> int:
        """Route one request into the fleet; returns a fleet-level
        handle id (stable across failover, restart, and hedging).
        Raises :class:`FleetOverloaded` (with the min ``retry_after``
        over the replicas' hints) when no replica admits."""
        faults.check("router.route")
        faults.check_latency("router.route")
        now = self._clock()
        if client_key is not None:
            known = self._client_handles.get(client_key)
            if known is not None:
                return known
            adopted = self._adopt_by_client_key(client_key, prompt, kw, now)
            if adopted is not None:
                return adopted
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        kwargs = dict(kw)
        if max_new_tokens is not None:
            kwargs["max_new_tokens"] = max_new_tokens
        name, rid = self._route(prompt, kwargs, set(), now, client_key=client_key)
        hid = self._next_handle
        self._next_handle += 1
        hd = FleetHandle(
            handle_id=hid,
            prompt=prompt,
            kwargs=kwargs,
            client_key=client_key,
            submit_time=now,
            replica=name,
            request_id=rid,
            hedge_wanted=self.config.hedge if hedge is None else bool(hedge),
        )
        self._handles[hid] = hd
        self._by_rid[(name, rid)] = hid
        if client_key is not None:
            self._client_handles[client_key] = hid
        if name not in self._replicas:
            # the replica was removed (elastic scale-down) between
            # placement and binding: nobody will ever step or collect
            # it, so re-fire now.  remove_replica refuses while a BOUND
            # handle exists, so exactly one side of this race acts —
            # either the removal saw the handle and refused, or we see
            # the removal here and re-route.
            self._refire(hd, {name}, now)
        self.routed += 1
        if self.telemetry.collect:
            self.telemetry.counter("fleet/routed", replica=name).inc()
        return hid

    def _adopt_by_client_key(
        self, client_key: str, prompt, kw: Dict[str, Any], now: float
    ) -> Optional[int]:
        """Journal-checked dedup: if any live replica already
        acknowledged this key (possibly before a crash/restart), bind a
        handle to the EXISTING admission instead of submitting again."""
        for name in list(self._order):
            rep = self._replicas.get(name)
            if rep is None or not rep.alive():
                continue
            rid = rep.client_request_id(client_key)
            if rid is None:
                continue
            r = rep.result(rid)
            if r is None:
                # the admission was delivered and discharged — adopting
                # the dead id would strand the handle; treat the retry
                # as a new request instead
                continue
            hid = self._next_handle
            self._next_handle += 1
            hd = FleetHandle(
                handle_id=hid,
                prompt=np.asarray(prompt, np.int32).reshape(-1),
                kwargs=dict(kw),
                client_key=client_key,
                submit_time=now,
                replica=name,
                request_id=rid,
            )
            self._handles[hid] = hd
            self._by_rid[(name, rid)] = hid
            self._client_handles[client_key] = hid
            # the admission may have already retired: surface its result
            if r.finish_time is not None:
                hd.done = True
                hd.winner = name
                self._results[hid] = r
            log_dist(
                f"fleet: client_key {client_key!r} deduped to replica "
                f"{name} request {rid} (at-most-once admission)"
            )
            return hid
        return None

    def step(self) -> bool:
        """One fleet step: drive every live replica, detect deaths (and
        restart through the supervisor), collect results, resolve and
        launch hedges.  Returns whether any handle is still unresolved."""
        now = self._clock()
        self._poll_restarts(now)
        self._retry_refires(now)
        stepped = False
        for name in list(self._order):
            rep = self._replicas.get(name)
            h = self._health.get(name)
            if rep is None or h is None:
                continue  # removed mid-walk
            if h.state == DEAD:
                continue
            if rep.alive() and faults.check_flag("replica.death"):
                rep.kill("injected replica.death")
            if not rep.alive():
                self._handle_death(name, "replica process lost", now)
                continue
            try:
                if rep.has_work():
                    rep.step()
                    stepped = True
            except ReplicaDeadError:
                self._handle_death(name, "died mid-step", now)
                continue
            except Exception as e:
                tripped = h.breaker.record_failure(now)
                self.route_failures += 1
                logger.warning(
                    f"fleet: replica {name} step failed ({e!r})"
                    + ("; breaker OPEN" if tripped else "")
                )
                continue
            self._collect(name, rep, now)
            h.observe(rep.degrade_level(), rep.draining())
        self._resolve_hedges(now)
        self._maybe_hedge(now)
        if self._restarting and not stepped:
            # the fleet is idle waiting on a background rebuild: yield
            # the GIL so the restart thread makes progress instead of
            # busy-spinning (survivors with live work never pause here)
            time.sleep(0.002)
        return self.has_work()

    def has_work(self) -> bool:
        return any(not hd.done for hd in self._handles.values())

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Any]:
        """Step until every handle resolves (or ``max_steps``); returns
        and clears the {handle_id: result} map."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.pop_results()

    def result(self, handle_id: int) -> Optional[Any]:
        return self._results.get(handle_id)

    def handle(self, handle_id: int) -> Optional[FleetHandle]:
        return self._handles.get(handle_id)

    def pop_results(self) -> Dict[int, Any]:
        out = {}
        for hid in [h.handle_id for h in self._handles.values() if h.done]:
            r = self._results.pop(hid, None)
            if r is not None:
                out[hid] = r
            hd = self._handles.pop(hid)
            if hd.client_key is not None:
                self._client_handles.pop(hd.client_key, None)
        return out

    # ------------------------------------------------------------------
    # collection + hedging
    # ------------------------------------------------------------------
    def _collect(self, name: str, rep, now: float) -> None:
        for rid, r in rep.pop_results().items():
            hid = self._by_rid.pop((name, rid), None)
            if hid is None:
                continue  # an already-settled hedge loser
            hd = self._handles.get(hid)
            if hd is None or hd.done:
                continue
            if getattr(r, "finish_reason", None) == "cancelled":
                continue  # the loser's retirement record
            if hd.hedge_request_id is not None:
                # a finished leg wins outright; retire the other
                if name == hd.replica:
                    self._cancel_leg(hd.hedge_replica, hd.hedge_request_id)
                elif name == hd.hedge_replica:
                    self._cancel_leg(hd.replica, hd.request_id)
                    hd.replica, hd.request_id = name, rid
                    self.hedge_wins += 1
                hd.hedge_replica = hd.hedge_request_id = hd.hedged_at = None
            hd.done = True
            hd.winner = name
            self._results[hid] = r
            if r.first_token_time is not None:
                self._ttft_ms.append((r.first_token_time - r.submit_time) * 1e3)
                if len(self._ttft_ms) > 1024:
                    del self._ttft_ms[:512]
                if self.telemetry.collect:
                    self.telemetry.histogram("fleet/ttft_ms").observe(self._ttft_ms[-1])

    def _cancel_leg(self, name: Optional[str], rid: Optional[int]) -> None:
        """Loser retirement: scheduler-level cancel on whichever replica
        holds the losing leg (frees its slot mid-decode)."""
        if name is None or rid is None:
            return
        self._by_rid.pop((name, rid), None)
        rep = self._replicas.get(name)
        if rep is not None and rep.alive():
            try:
                if rep.cancel(rid):
                    self.hedge_cancelled += 1
                    if self.telemetry.collect:
                        self.telemetry.counter("fleet/hedge_cancelled").inc()
            except Exception as e:  # a failed cancel is cosmetic, not fatal
                logger.warning(f"fleet: cancel of {rid} on {name} failed: {e!r}")

    def hedge_delay_seconds(self) -> Optional[float]:
        """``hedge_factor x`` the observed p99 delivered-TTFT; None
        until ``hedge_min_observations`` samples exist (hedging with no
        tail evidence would just double-submit everything)."""
        if not self.config.hedge and not any(
            hd.hedge_wanted for hd in self._handles.values()
        ):
            return None
        if len(self._ttft_ms) < self.config.hedge_min_observations:
            return None
        p99_s = float(np.percentile(np.asarray(self._ttft_ms), 99)) / 1e3
        return max(p99_s * self.config.hedge_factor, 1e-4)

    def _maybe_hedge(self, now: float) -> None:
        delay = self.hedge_delay_seconds()
        if delay is None:
            return
        for hd in list(self._handles.values()):
            if (
                hd.done
                or not hd.hedge_wanted
                or hd.hedge_request_id is not None
                or now - hd.submit_time < delay
            ):
                continue
            prim = self._replicas.get(hd.replica)
            if prim is not None and prim.alive() and prim.first_token_seen(hd.request_id):
                continue  # the primary already produced a token
            faults.check("router.hedge")
            name2 = self._pick(len(hd.prompt), {hd.replica}, now)
            if name2 is None:
                continue
            rep2 = self._replicas.get(name2)
            if rep2 is None:
                continue
            try:
                # NB no client_key: the hedge is the router's own
                # duplicate, not a second client admission
                rid2 = rep2.submit(hd.prompt, **hd.kwargs)
            except ServingQueueFull:
                continue
            except Exception as e:
                self._health[name2].breaker.record_failure(now)
                logger.warning(f"fleet: hedge submit to {name2} failed: {e!r}")
                continue
            hd.hedge_replica, hd.hedge_request_id, hd.hedged_at = name2, rid2, now
            self._by_rid[(name2, rid2)] = hd.handle_id
            if name2 not in self._replicas:
                # same bind-vs-remove window as submit: drop the leg
                # (the primary is still running; re-hedging may re-arm)
                self._by_rid.pop((name2, rid2), None)
                hd.hedge_replica = hd.hedge_request_id = hd.hedged_at = None
                continue
            self.hedges += 1
            if self.telemetry.collect:
                self.telemetry.counter("fleet/hedges").inc()
            log_dist(
                f"fleet: hedged handle {hd.handle_id} to {name2} after "
                f"{now - hd.submit_time:.3f}s (delay {delay:.3f}s)"
            )

    def _resolve_hedges(self, now: float) -> None:
        """First-token-wins: the first leg to produce a token becomes
        the primary; the other is cancelled via scheduler retirement."""
        for hd in self._handles.values():
            if hd.done or hd.hedge_request_id is None:
                continue
            prim, sec = self._replicas.get(hd.replica), self._replicas.get(hd.hedge_replica)
            p_seen = prim is not None and prim.alive() and prim.first_token_seen(hd.request_id)
            s_seen = sec is not None and sec.alive() and sec.first_token_seen(hd.hedge_request_id)
            if p_seen:  # primary wins ties (it was first to be asked)
                self._cancel_leg(hd.hedge_replica, hd.hedge_request_id)
            elif s_seen:
                self._cancel_leg(hd.replica, hd.request_id)
                hd.replica, hd.request_id = hd.hedge_replica, hd.hedge_request_id
                self.hedge_wins += 1
            else:
                continue
            hd.hedge_replica = hd.hedge_request_id = hd.hedged_at = None

    # ------------------------------------------------------------------
    # death, restart, re-binding
    # ------------------------------------------------------------------
    def mark_dead(self, name: str, reason: str = "declared dead") -> None:
        """External death signal (heartbeat EOF observer, chaos tool)."""
        self._handle_death(name, reason, self._clock())

    def on_peer_event(self, name: str, kind: str, reason: str = "") -> None:
        """Heartbeat-channel feed: route a PeerEvent at the named
        replica (``dead`` -> death handling + restart, ``bye`` ->
        draining, no new routes)."""
        if kind == "dead":
            self._handle_death(name, reason or "heartbeat EOF", self._clock())
        else:
            h = self._health.get(name)
            if h is not None:
                h.on_peer_event(kind, reason)

    def _handle_death(self, name: str, reason: str, now: float) -> None:
        h = self._health.get(name)
        rep = self._replicas.get(name)
        if h is None or rep is None or h.state == DEAD:
            return
        h.mark_dead(reason, now)
        self.deaths += 1
        if self.telemetry.collect:
            self.telemetry.counter("fleet/deaths", replica=name).inc()
        self.last_failover = {"replica": name, "reason": reason, "at": now}
        replayed = None
        if self._supervisor is not None:
            replayed = self._supervisor.handle_death(rep, reason)
        if replayed is RESTART_PENDING:
            # background restart underway: the replica stays DEAD (and
            # out of placement) while its handles stay bound — they will
            # be re-bound or re-fired when the restart resolves, and the
            # surviving replicas keep serving in the meantime
            self._restarting.add(name)
            return
        if replayed is not None:
            h.revive()
            if self.telemetry.collect:
                self.telemetry.counter("fleet/restarts", replica=name).inc()
            self._rebind(name, set(int(r) for r in replayed), now)
        else:
            self._refire_all(name, now)

    def _poll_restarts(self, now: float) -> None:
        """Resolve background restarts (supervisor ``background=True``):
        revive + re-bind on success, re-fire the stranded handles when
        the replica stays dead."""
        if not self._restarting or self._supervisor is None:
            return
        for rep, replayed in self._supervisor.drain_completed():
            name = rep.name
            self._restarting.discard(name)
            if replayed is not None:
                self._health[name].revive()
                if self.telemetry.collect:
                    self.telemetry.counter("fleet/restarts", replica=name).inc()
                self._rebind(name, set(int(r) for r in replayed), now)
            else:
                self._refire_all(name, now)

    def _rebind(self, name: str, replayed: Set[int], now: float) -> None:
        """The restarted replica replayed its journal under original
        ids: handles whose request is in the replay set stay bound (the
        replay completes them bit-identically); handles whose request
        is NOT there (retired before the crash, result lost with the
        process) re-fire elsewhere."""
        rebound = refired = 0
        for hd in list(self._handles.values()):
            if hd.done:
                continue
            if hd.hedge_replica == name and hd.hedge_request_id is not None:
                if hd.hedge_request_id not in replayed:
                    # the hedge leg died unreplayed: drop it (the
                    # primary is still running; re-hedging may re-arm)
                    self._by_rid.pop((name, hd.hedge_request_id), None)
                    hd.hedge_replica = hd.hedge_request_id = hd.hedged_at = None
            if hd.replica != name:
                continue
            if hd.request_id in replayed:
                rebound += 1
            else:
                self._refire(hd, {name}, now)
                refired += 1
        log_dist(
            f"fleet: replica {name} re-bound {rebound} in-flight handle(s) "
            f"to replayed requests, re-fired {refired}"
        )

    def _refire_all(self, name: str, now: float) -> None:
        """The replica stays dead: every handle bound to it re-fires on
        the rest of the fleet (deterministic generation makes the re-run
        reproduce the lost outputs)."""
        for hd in list(self._handles.values()):
            if hd.done:
                continue
            if hd.hedge_replica == name and hd.hedge_request_id is not None:
                self._by_rid.pop((name, hd.hedge_request_id), None)
                hd.hedge_replica = hd.hedge_request_id = hd.hedged_at = None
            if hd.replica == name:
                self._refire(hd, {name}, now)

    def _refire(self, hd: FleetHandle, exclude: Set[str], now: float) -> None:
        self._by_rid.pop((hd.replica, hd.request_id), None)
        try:
            name2, rid2 = self._route(
                hd.prompt, hd.kwargs, exclude, now, client_key=hd.client_key
            )
        except ServingQueueFull:
            # the rest of the fleet is saturated right now: park the
            # handle and retry at the next step
            if hd.handle_id not in self._refire_pending:
                self._refire_pending.append(hd.handle_id)
            return
        hd.replica, hd.request_id = name2, rid2
        hd.refires += 1
        self.refired += 1
        self._by_rid[(name2, rid2)] = hd.handle_id
        if self.telemetry.collect:
            self.telemetry.counter("fleet/refired").inc()

    def _retry_refires(self, now: float) -> None:
        pending, self._refire_pending = self._refire_pending, []
        for hid in pending:
            hd = self._handles.get(hid)
            if hd is None or hd.done:
                continue
            dead = {n for n, h in list(self._health.items()) if h.state == DEAD}
            self._refire(hd, dead, now)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def replicas_by_state(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for h in list(self._health.values()):
            out[h.state] = out.get(h.state, 0) + 1
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "replicas": len(self._order),
            "replica_states": self.replicas_by_state(),
            "replica_health": {
                n: h.snapshot() for n, h in list(self._health.items())
            },
            "routed": self.routed,
            "rejections": self.rejections,
            "failovers": self.failovers,
            "route_failures": self.route_failures,
            "deaths": self.deaths,
            "restarts": sum(h.restarts for h in list(self._health.values())),
            "refired": self.refired,
            "affinity_routes": self.affinity_routes,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "hedge_cancelled": self.hedge_cancelled,
            "inflight": sum(1 for h in self._handles.values() if not h.done),
            "last_failover": self.last_failover,
        }


__all__ = ["FleetRouter", "FleetHandle", "FleetOverloaded"]
