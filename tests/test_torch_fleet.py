"""The port's fleet router (``deepspeed_tpu_torch.serving.fleet``) on the
CPU, a mirror of ``tests/test_fleet.py`` held against the JAX package.

* The JAX file's tests on the port: the breaker's trip, half-open probe
  and re-open; the health state machine; the supervisor's budget and
  backoff; least-estimated-TTFT placement; bounded failover and
  ``FleetOverloaded`` with the least ``retry_after``; backpressure from
  ``retry_after``; at-most-once admission by ``client_key`` (across a
  router restart and a replica crash); kill one of three in-process
  replicas mid-decode under seeded Poisson load — zero acknowledged loss,
  tokens bit for bit solo ``generate()``; rebinding, refiring and
  background restarts; hedging (first token wins, the loser cancelled);
  the fault sites ``router.route``, ``router.hedge`` and
  ``replica.death`` through ``DS_FAULT_PLAN``.
* Decision parity: the JAX ``FleetRouter`` and the port's drive identical
  scripted replicas (duck-typed, no model) under one ``ManualClock`` and
  one seed through a seeded trace of submits, route failures, overloads,
  deaths and restarts: the same placements, breaker states and
  ``stats()``.
* Token parity: the same load and the same kill over three JAX replicas
  and three port replicas (weights carried across) give the same tokens.

The model is GPT2_TINY with its position table scaled up, f32.
``DS_FLEET_TRANSPORT=inproc|socket`` reruns the file with every replica
behind the framed RPC boundary."""
import dataclasses
import os
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, FleetConfig, ServingConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.policy import RetryPolicy
from deepspeed_tpu_torch.serving import ServingEngine
from deepspeed_tpu_torch.serving.fleet import (
    CLOSED,
    DEAD,
    DEGRADED,
    DRAINING,
    HALF_OPEN,
    HEALTHY,
    OPEN,
    CircuitBreaker,
    FleetOverloaded,
    FleetRouter,
    LocalReplica,
    ReplicaHealth,
    ReplicaSupervisor,
)

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TINY = tgpt2.GPT2_TINY


def _params(seed=7):
    """Position-sensitive weights (wpe scaled): slot/position bugs change
    generations instead of hiding."""
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


@pytest.fixture(scope="module")
def eng():
    return deepspeed_tpu_torch.init_inference(
        model_config=TINY, params=_params(), dtype=torch.float32, device="cpu",
        max_out_tokens=TINY.n_positions)


class ManualClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _prompts(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(1, TINY.vocab_size, rng.integers(lo, hi + 1), dtype=np.int32)
        for _ in range(n)
    ]


def _factory(eng, base, name, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_len", 64)
    d = str(base / name / "journal")

    def build():
        return ServingEngine(eng, journal_dir=d, **kw)

    return build


def _wrap(rep):
    """``DS_FLEET_TRANSPORT=inproc|socket`` reruns the file with every
    replica behind the frontdoor RPC boundary — the router / supervisor
    contract must hold unchanged over both transports."""
    mode = os.environ.get("DS_FLEET_TRANSPORT", "")
    if not mode:
        return rep
    from deepspeed_tpu_torch.serving.frontdoor.transport import wrap_replica

    return wrap_replica(rep, mode)


def _fleet(eng, tmp_path, n=3, config=None, supervisor=None, clock=None, **kw):
    reps = [_wrap(LocalReplica(f"r{i}", _factory(eng, tmp_path, f"r{i}", **kw)))
            for i in range(n)]
    router = FleetRouter(
        reps,
        config=config,
        supervisor=supervisor,
        clock=clock if clock is not None else time.monotonic,
    )
    return router, reps


def _solo(eng, prompt, max_new):
    return np.asarray(eng.generate(prompt[None, :], max_new_tokens=max_new))[0]


# ---------------------------------------------------------------------------
# circuit breaker (no engine)
# ---------------------------------------------------------------------------

def test_breaker_trips_after_consecutive_failures():
    clk = ManualClock()
    br = CircuitBreaker(failure_threshold=3, clock=clk,
                        policy=RetryPolicy(backoff_seconds=1.0, jitter=0.0))
    assert br.state == CLOSED and br.allow()
    assert not br.record_failure()
    assert not br.record_failure()
    assert br.record_failure()  # third consecutive failure trips
    assert br.state == OPEN and br.trips == 1
    assert not br.allow()  # backoff has not elapsed
    assert br.retry_at == pytest.approx(1.0)


def test_breaker_halfopen_probe_success_closes():
    clk = ManualClock()
    br = CircuitBreaker(failure_threshold=1, halfopen_probes=1, clock=clk,
                        policy=RetryPolicy(backoff_seconds=1.0, jitter=0.0))
    br.record_failure()
    assert br.state == OPEN
    clk.advance(1.5)
    assert br.allow()  # the half-open probe token
    assert br.state == HALF_OPEN
    assert not br.allow()  # probes are rationed
    br.record_success()
    assert br.state == CLOSED and br.allow()
    # the backoff exponent reset: a re-trip starts from the base again
    br.record_failure()
    assert br.retry_at == pytest.approx(clk.t + 1.0)


def test_breaker_halfopen_failure_reopens_with_longer_backoff():
    clk = ManualClock()
    br = CircuitBreaker(failure_threshold=1, clock=clk,
                        policy=RetryPolicy(backoff_seconds=1.0, jitter=0.0))
    br.record_failure()
    first = br.retry_at - clk.t
    clk.advance(first + 0.1)
    assert br.allow()  # probe
    assert br.record_failure()  # probe failed: re-open
    second = br.retry_at - clk.t
    assert br.state == OPEN and br.trips == 2
    assert second > first  # exponential across consecutive trips


def test_breaker_success_resets_failure_streak():
    br = CircuitBreaker(failure_threshold=3, clock=ManualClock())
    br.record_failure()
    br.record_failure()
    br.record_success()
    assert not br.record_failure()
    assert not br.record_failure()  # streak restarted: still CLOSED
    assert br.state == CLOSED


# ---------------------------------------------------------------------------
# health state machine + supervisor (no engine)
# ---------------------------------------------------------------------------

def test_health_state_machine_transitions():
    h = ReplicaHealth("r0", CircuitBreaker(clock=ManualClock()))
    assert h.state == HEALTHY and h.routable(0.0)
    h.observe(degrade_level=2)
    assert h.state == DEGRADED and h.routable(0.0)  # deprioritized, not excluded
    h.observe(degrade_level=0)
    assert h.state == HEALTHY
    h.on_peer_event("bye")
    assert h.state == DRAINING and not h.routable(0.0)
    h.on_peer_event("dead", "heartbeat EOF")
    assert h.state == DEAD and not h.routable(0.0) and h.deaths == 1
    h.observe(degrade_level=0)  # telemetry cannot resurrect the dead
    assert h.state == DEAD
    h.revive()
    assert h.state == HEALTHY and h.restarts == 1 and h.routable(0.0)


class _FakeReplica:
    def __init__(self, name="f0", fail=False):
        self.name = name
        self.fail = fail
        self.restarted = 0

    def restart(self):
        self.restarted += 1
        if self.fail:
            raise RuntimeError("no comeback")
        return [1, 2]


def test_supervisor_budget_and_failed_restart():
    sup = ReplicaSupervisor(max_restarts=2, sleep=lambda s: None)
    rep = _FakeReplica()
    assert sup.handle_death(rep, "t") == [1, 2]
    assert sup.handle_death(rep, "t") == [1, 2]
    assert sup.handle_death(rep, "t") is None  # budget exhausted
    assert rep.restarted == 2 and sup.attempts(rep.name) == 2
    # a restart that raises counts as a consumed attempt and returns None
    bad = _FakeReplica("f1", fail=True)
    assert sup.handle_death(bad, "t") is None
    assert sup.attempts("f1") == 1


def test_supervisor_backoff_uses_retry_policy_schedule():
    pauses = []
    sup = ReplicaSupervisor(
        max_restarts=3, sleep=pauses.append,
        policy=RetryPolicy(backoff_seconds=0.2, backoff_max_seconds=5.0, jitter=0.0),
    )
    rep = _FakeReplica()
    sup.handle_death(rep, "t")
    sup.handle_death(rep, "t")
    assert pauses == [pytest.approx(0.2), pytest.approx(0.4)]  # exponential


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------

def test_fleet_config_parses_and_rejects_unknown_keys():
    cfg = ServingConfig.from_dict({
        "fleet": {"replicas": 3, "hedge": True, "breaker_failures": 5},
    })
    assert cfg.fleet.replicas == 3 and cfg.fleet.hedge
    assert cfg.fleet.breaker_failures == 5
    assert FleetConfig.from_dict(None).replicas == 1  # defaults
    with pytest.raises(DeepSpeedConfigError, match="serving.fleet"):
        ServingConfig.from_dict({"fleet": {"replica": 3}})  # did-you-mean path
    with pytest.raises(DeepSpeedConfigError, match="hedge_factor"):
        FleetConfig.from_dict({"hedge_factor": 0})  # must be > 0


def test_router_accepts_dict_config_and_rejects_empty_fleet():
    with pytest.raises(ValueError):
        FleetRouter([])


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_routing_spreads_load_least_ttft(eng, tmp_path):
    router, reps = _fleet(eng, tmp_path, n=3)
    for p in _prompts(6, 6, 12, seed=1):
        router.submit(p, max_new_tokens=4)
    # a cold fleet has no TTFT estimates: placement falls back to queue
    # depth + round-robin, which must spread rather than pile on r0
    depths = [r.queue_depth() + len(r.engine.scheduler._active) for r in reps]
    assert all(d >= 1 for d in depths), depths
    assert router.routed == 6
    res = router.drain(max_steps=400)
    assert len(res) == 6


def test_fleet_results_bit_match_solo_generate(eng, tmp_path):
    router, _ = _fleet(eng, tmp_path, n=2)
    prompts = _prompts(5, 4, 20, seed=2)
    solo = [_solo(eng, p, 6) for p in prompts]
    hids = [router.submit(p, max_new_tokens=6) for p in prompts]
    res = router.drain(max_steps=400)
    for hid, want in zip(hids, solo):
        np.testing.assert_array_equal(np.asarray(res[hid].tokens()), want)


def test_failover_retries_on_another_replica(eng, tmp_path):
    """A submit that dies before the journal ack fails over: the first
    replica's fault feeds its breaker, the request lands elsewhere."""
    router, _ = _fleet(eng, tmp_path, n=2)
    with faults.FaultInjector(seed=0).fail("serving.submit", times=1):
        hid = router.submit(_prompts(1, 8, 8)[0], max_new_tokens=4)
    assert router.failovers == 1 and router.route_failures == 1
    states = [h.breaker.consecutive_failures for h in router._health.values()]
    assert sorted(states) == [0, 1]
    res = router.drain(max_steps=300)
    assert hid in res and res[hid].finish_reason is not None


def test_fleet_overloaded_carries_min_retry_after(eng, tmp_path):
    """Saturate a tiny fleet: the router-level rejection must carry the
    minimum retry_after over the replicas' own hints."""
    router, _ = _fleet(eng, tmp_path, n=2, max_queue=1, num_slots=1)
    p = _prompts(1, 8, 8)[0]
    with pytest.raises(FleetOverloaded) as ei:
        for _ in range(24):
            router.submit(p, max_new_tokens=8)
    assert ei.value.retry_after is not None and ei.value.retry_after > 0
    assert router.rejections >= 1
    router.drain(max_steps=400)


def test_backpressure_holds_replica_until_retry_after(eng, tmp_path):
    clk = ManualClock()
    router, reps = _fleet(eng, tmp_path, n=2, clock=clk)
    router._backpressure["r0"] = clk.t + 10.0  # r0 said "come back in 10s"
    h1 = router.submit(_prompts(1, 6, 6)[0], max_new_tokens=2)
    assert router.handle(h1).replica == "r1"
    clk.advance(11.0)  # the hold expires: r0 is routable again
    assert router._pick(6, {"r1"}, clk.t) == "r0"
    router.drain(max_steps=300)


def test_breaker_open_excludes_replica_from_placement(eng, tmp_path):
    clk = ManualClock()
    router, _ = _fleet(eng, tmp_path, n=2, clock=clk)
    br = router._health["r0"].breaker
    for _ in range(br.failure_threshold):
        br.record_failure(clk.t)
    assert br.state == OPEN
    for _ in range(3):
        hid = router.submit(_prompts(1, 6, 6)[0], max_new_tokens=2)
        assert router.handle(hid).replica == "r1"
    clk.advance(1e6)  # past any backoff: half-open admits a probe
    assert router._pick(6, set(), clk.t) in ("r0", "r1")
    assert br.state in (HALF_OPEN, CLOSED)
    router.drain(max_steps=300)


# ---------------------------------------------------------------------------
# at-most-once admission (client_key)
# ---------------------------------------------------------------------------

def test_client_key_dedup_same_router(eng, tmp_path):
    router, _ = _fleet(eng, tmp_path, n=2)
    p = _prompts(1, 8, 8)[0]
    h1 = router.submit(p, max_new_tokens=4, client_key="order-1")
    h2 = router.submit(p, max_new_tokens=4, client_key="order-1")
    assert h1 == h2 and router.routed == 1
    router.drain(max_steps=300)


def test_client_key_dedup_survives_router_restart(eng, tmp_path):
    """A fresh router (crashed front door) over the same replicas must
    adopt the journaled admission instead of double-serving the key."""
    router, reps = _fleet(eng, tmp_path, n=2)
    p = _prompts(1, 10, 10, seed=5)[0]
    router.submit(p, max_new_tokens=4, client_key="order-7")
    for _ in range(2):
        router.step()
    sub_before = reps[0].engine.stats()["submitted"] + reps[1].engine.stats()["submitted"]
    router2 = FleetRouter(reps)  # fresh front door, empty handle map
    h2 = router2.submit(p, max_new_tokens=4, client_key="order-7")
    sub_after = reps[0].engine.stats()["submitted"] + reps[1].engine.stats()["submitted"]
    assert sub_after == sub_before  # adopted, not re-admitted
    res = router2.drain(max_steps=300)
    np.testing.assert_array_equal(np.asarray(res[h2].tokens()), _solo(eng, p, 4))


def test_client_key_dedup_survives_replica_crash(eng, tmp_path):
    """The key rides the journal: after kill -9 + replay, a client retry
    still maps to the ORIGINAL request id on the restarted replica."""
    router, reps = _fleet(eng, tmp_path, n=1,
                          supervisor=ReplicaSupervisor(sleep=lambda s: None))
    p = _prompts(1, 10, 10, seed=6)[0]
    h1 = router.submit(p, max_new_tokens=6, client_key="order-9")
    rid = router.handle(h1).request_id
    for _ in range(2):
        router.step()
    reps[0].kill("chaos")
    router.step()  # death -> supervised restart -> journal replay -> rebind
    assert reps[0].alive()
    assert reps[0].client_request_id("order-9") == rid
    assert router.submit(p, max_new_tokens=6, client_key="order-9") == h1
    res = router.drain(max_steps=300)
    np.testing.assert_array_equal(np.asarray(res[h1].tokens()), _solo(eng, p, 6))


# ---------------------------------------------------------------------------
# the headline: kill 1 of 3 mid-decode under load -> zero acknowledged loss
# ---------------------------------------------------------------------------

def test_kill_one_of_three_zero_acknowledged_loss_bit_identical(eng, tmp_path):
    router, reps = _fleet(eng, tmp_path, n=3,
                          supervisor=ReplicaSupervisor(max_restarts=3,
                                                       sleep=lambda s: None))
    rng = np.random.default_rng(3)
    prompts = _prompts(9, 4, 16, seed=3)
    solo = [_solo(eng, p, 8) for p in prompts]
    hids = []
    # seeded Poisson-ish trickle: interleave submits with steps so the
    # victim dies with queued AND active work
    for i, p in enumerate(prompts):
        hids.append(router.submit(p, max_new_tokens=8, client_key=f"ck{i}"))
        for _ in range(int(rng.poisson(1.0))):
            router.step()
    victim = max(reps, key=lambda r: r.queue_depth() + len(r.engine.scheduler._active))
    victim.kill("kill -9 mid-decode")
    res = router.drain(max_steps=800)
    # ZERO acknowledged loss: every admitted request resolves...
    assert sorted(res) == sorted(hids)
    # ...bit-identically to the uninterrupted solo run (journal replay +
    # deterministic generation)
    for hid, want in zip(hids, solo):
        np.testing.assert_array_equal(np.asarray(res[hid].tokens()), want)
    st = router.stats()
    assert st["deaths"] == 1 and st["restarts"] == 1
    assert victim.kills == 1 and victim.alive()


def test_rebind_preserves_original_request_ids(eng, tmp_path):
    router, reps = _fleet(eng, tmp_path, n=1,
                          supervisor=ReplicaSupervisor(sleep=lambda s: None))
    hids = [router.submit(p, max_new_tokens=6)
            for p in _prompts(3, 8, 12, seed=4)]
    before = {h: router.handle(h).request_id for h in hids}
    for _ in range(2):
        router.step()
    reps[0].kill("chaos")
    router.step()
    after = {h: router.handle(h).request_id for h in hids if router.handle(h)}
    for h, rid in after.items():
        assert rid == before[h]  # replayed under ORIGINAL ids, handles re-bound
    res = router.drain(max_steps=400)
    assert sorted(res) == sorted(hids)


def test_unrestartable_replica_refires_elsewhere(eng, tmp_path):
    """Restart budget 0: the dead replica stays dead and its in-flight
    requests re-fire on the survivor — deterministic generation makes
    the re-run reproduce the same tokens."""
    router, reps = _fleet(eng, tmp_path, n=2,
                          supervisor=ReplicaSupervisor(max_restarts=0,
                                                       sleep=lambda s: None))
    prompts = _prompts(4, 6, 12, seed=8)
    solo = [_solo(eng, p, 6) for p in prompts]
    hids = [router.submit(p, max_new_tokens=6) for p in prompts]
    victim = reps[0] if any(router.handle(h).replica == "r0" for h in hids) else reps[1]
    victim.kill("no budget")
    res = router.drain(max_steps=500)
    assert sorted(res) == sorted(hids)
    for hid, want in zip(hids, solo):
        np.testing.assert_array_equal(np.asarray(res[hid].tokens()), want)
    assert router.refired >= 1
    assert router.replicas_by_state()[DEAD] == 1


def test_background_restart_overlaps_serving(eng, tmp_path):
    """``ReplicaSupervisor(background=True)``: handle_death returns
    immediately (RESTART_PENDING), the victim stays DEAD and out of
    placement while its rebuild runs on a thread, survivors keep
    serving, and on completion the router revives + re-binds — same
    zero-loss bit-identical outcome as the synchronous path."""
    from deepspeed_tpu_torch.serving.fleet.supervisor import RESTART_PENDING  # noqa: F401

    sup = ReplicaSupervisor(
        max_restarts=2, background=True,
        policy=RetryPolicy(backoff_seconds=0.01, jitter=0.0),
    )
    router, reps = _fleet(eng, tmp_path, n=2, supervisor=sup)
    prompts = _prompts(4, 6, 12, seed=21)
    solo = [_solo(eng, p, 6) for p in prompts]
    hids = [router.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(2):
        router.step()
    victim = max(reps, key=lambda r: r.queue_depth() + len(r.engine.scheduler._active))
    victim.kill("kill -9, restart in background")
    router.step()  # death detected -> restart dispatched to the thread
    assert router.replicas_by_state().get(DEAD, 0) == 1  # pending, not revived
    deadline = time.monotonic() + 60.0
    res = {}
    while router.has_work() and time.monotonic() < deadline:
        router.step()
        res.update(router.pop_results())
    res.update(router.pop_results())
    assert sorted(res) == sorted(hids)
    for hid, want in zip(hids, solo):
        np.testing.assert_array_equal(np.asarray(res[hid].tokens()), want)
    st = router.stats()
    assert st["deaths"] == 1 and st["restarts"] == 1
    assert victim.alive() and not sup.pending()


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------

def _warm_ttft(router, n=3, seed=11):
    for p in _prompts(n, 6, 6, seed=seed):
        router.submit(p, max_new_tokens=2)
    router.drain(max_steps=300)


def test_hedge_fires_after_p99_delay_and_cancels_loser(eng, tmp_path):
    clk = ManualClock()
    router, _ = _fleet(
        eng, tmp_path, n=2, clock=clk,
        config={"hedge": True, "hedge_min_observations": 2, "hedge_factor": 1.0},
    )
    _warm_ttft(router)
    assert router.hedge_delay_seconds() is not None
    long = _prompts(1, 30, 30, seed=12)[0]  # multi-chunk prefill: no
    solo = _solo(eng, long, 4)              # first token on step one
    h = router.submit(long, max_new_tokens=4)
    primary = router.handle(h).replica
    clk.advance(1000.0)  # way past p99 * factor with no first token
    router.step()
    assert router.hedges == 1
    assert router.handle(h).hedge_replica not in (None, primary)
    res = router.drain(max_steps=400)
    np.testing.assert_array_equal(np.asarray(res[h].tokens()), solo)
    assert router.hedge_cancelled == 1  # the loser leg was retired
    # the loser's cancellation retired its slot: both replicas are empty
    assert not router.has_work()


def test_hedge_disarmed_below_min_observations(eng, tmp_path):
    clk = ManualClock()
    router, _ = _fleet(
        eng, tmp_path, n=2, clock=clk,
        config={"hedge": True, "hedge_min_observations": 100},
    )
    _warm_ttft(router)
    assert router.hedge_delay_seconds() is None  # tail evidence too thin
    h = router.submit(_prompts(1, 30, 30, seed=13)[0], max_new_tokens=2)
    clk.advance(1e6)
    router.step()
    assert router.hedges == 0
    router.drain(max_steps=300)


def test_hedge_skipped_once_first_token_seen(eng, tmp_path):
    clk = ManualClock()
    router, _ = _fleet(
        eng, tmp_path, n=2, clock=clk,
        config={"hedge": True, "hedge_min_observations": 2, "hedge_factor": 1.0},
    )
    _warm_ttft(router)
    h = router.submit(_prompts(1, 6, 6, seed=14)[0], max_new_tokens=8)
    router.step()  # short prompt: first token lands on the first step
    clk.advance(1000.0)
    router.step()
    assert router.hedges == 0  # a tokened request never hedges
    router.drain(max_steps=300)


# ---------------------------------------------------------------------------
# fault sites: router.route / router.hedge / replica.death (DS_FAULT_PLAN)
# ---------------------------------------------------------------------------

def test_fault_site_router_route_roundtrip(eng, tmp_path):
    router, _ = _fleet(eng, tmp_path, n=2)
    spec = faults.plan_json([{"site": "router.route", "action": "fail", "times": 1}])
    inj = faults.FaultInjector.from_plan(spec)
    with inj:
        with pytest.raises(faults.InjectedFault):
            router.submit(_prompts(1, 6, 6)[0], max_new_tokens=2)
        h = router.submit(_prompts(1, 6, 6)[0], max_new_tokens=2)  # one-shot
    assert ("router.route", "InjectedFault") in inj.log
    res = router.drain(max_steps=300)
    assert h in res


def test_fault_site_router_route_recurring_latency(eng, tmp_path):
    router, _ = _fleet(eng, tmp_path, n=2)
    spec = faults.plan_json([
        {"site": "router.route", "action": "latency", "seconds": 0.05, "times": 0},
    ])
    with faults.FaultInjector.from_plan(spec) as inj:
        t0 = time.monotonic()
        for p in _prompts(2, 6, 6, seed=15):
            router.submit(p, max_new_tokens=2)
        elapsed = time.monotonic() - t0
    assert elapsed >= 0.1  # recurring: BOTH submits paid the slow path
    assert inj.calls("router.route") >= 2
    router.drain(max_steps=300)


def test_fault_site_router_hedge_blocks_hedging(eng, tmp_path):
    clk = ManualClock()
    router, _ = _fleet(
        eng, tmp_path, n=2, clock=clk,
        config={"hedge": True, "hedge_min_observations": 2, "hedge_factor": 1.0},
    )
    _warm_ttft(router)
    h = router.submit(_prompts(1, 30, 30, seed=16)[0], max_new_tokens=4)
    clk.advance(1000.0)
    with faults.FaultInjector(seed=0).fail("router.hedge", times=1) as inj:
        with pytest.raises(faults.InjectedFault):
            router.step()  # the hedge launch is the injected instruction
    assert router.hedges == 0
    assert ("router.hedge", "InjectedFault") in inj.log
    res = router.drain(max_steps=400)  # the primary still completes
    assert h in res


def test_fault_site_replica_death_via_env_plan(eng, tmp_path, monkeypatch):
    """The full multi-process shape: the plan rides DS_FAULT_PLAN,
    installs at startup, and the router's per-step poll kills a live
    replica — which the supervisor then restarts losslessly."""
    router, reps = _fleet(eng, tmp_path, n=2,
                          supervisor=ReplicaSupervisor(sleep=lambda s: None))
    prompts = _prompts(3, 6, 12, seed=17)
    solo = [_solo(eng, p, 4) for p in prompts]
    hids = [router.submit(p, max_new_tokens=4) for p in prompts]
    monkeypatch.setenv(
        faults.DS_FAULT_PLAN_ENV,
        faults.plan_json([{"site": "replica.death", "action": "flag", "times": 1}]),
    )
    inj = faults.install_from_env(rank=0)
    assert inj is not None
    try:
        res = router.drain(max_steps=500)
    finally:
        faults._ACTIVE = None  # install_from_env is process-lifetime
    assert ("replica.death", "flag") in inj.log
    assert router.deaths == 1 and sum(r.kills for r in reps) == 1
    assert sorted(res) == sorted(hids)
    for hid, want in zip(hids, solo):
        np.testing.assert_array_equal(np.asarray(res[hid].tokens()), want)


# ---------------------------------------------------------------------------
# health plane wiring + introspection
# ---------------------------------------------------------------------------

def test_peer_event_bye_drains_and_dead_restarts(eng, tmp_path):
    router, reps = _fleet(eng, tmp_path, n=2,
                          supervisor=ReplicaSupervisor(sleep=lambda s: None))
    router.on_peer_event("r0", "bye")
    assert router._health["r0"].state == DRAINING
    h = router.submit(_prompts(1, 6, 6)[0], max_new_tokens=2)
    assert router.handle(h).replica == "r1"  # draining gets no new routes
    router.on_peer_event("r1", "dead", "heartbeat EOF")
    assert router.deaths == 1
    assert router._health["r1"].state == HEALTHY  # supervised restart
    res = router.drain(max_steps=300)
    assert h in res


def test_stats_expose_fleet_rows(eng, tmp_path):
    router, _ = _fleet(eng, tmp_path, n=2)
    router.submit(_prompts(1, 6, 6)[0], max_new_tokens=2)
    st = router.stats()
    for key in ("replicas", "replica_states", "replica_health", "routed",
                "deaths", "restarts", "hedges", "refired", "inflight",
                "last_failover"):
        assert key in st
    assert st["replicas"] == 2 and st["routed"] == 1 and st["inflight"] == 1
    assert st["replica_health"]["r0"]["breaker"]["state"] == CLOSED
    router.drain(max_steps=300)
    assert router.stats()["inflight"] == 0


def test_engine_cancel_retires_slot_and_journals(eng, tmp_path):
    """The hedging loser path at engine level: cancel mid-decode frees
    the slot, journals the retirement, and recover() never resurrects
    the cancelled request."""
    srv = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64,
                        journal_dir=str(tmp_path / "cx" / "journal"))
    rid = srv.submit(_prompts(1, 6, 6, seed=18)[0], max_new_tokens=32)
    for _ in range(3):
        srv.step()
    assert srv.cancel(rid)
    assert srv.result(rid).finish_reason == "cancelled"
    assert srv.pool.live_slots == 0  # the slot came back
    assert not srv.cancel(rid)  # idempotent-ish: already retired
    srv2 = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64,
                         journal_dir=str(tmp_path / "cx" / "journal"))
    assert srv2.recover() == []  # journaled retire: nothing to replay


# ---------------------------------------------------------------------------
# decision parity: the JAX router and the port's on one scripted trace
# ---------------------------------------------------------------------------

class _ScriptedResult:
    def __init__(self, rid, prompt, submit_time):
        self.request_id = rid
        self._tokens = list(prompt)
        self.submit_time = submit_time
        self.first_token_time = None
        self.finish_time = None
        self.finish_reason = None
        self.retry_after = None

    def tokens(self):
        return list(self._tokens)


class _ScriptedReplica:
    """A replica with no model: every answer is a function of the calls it
    received, so two routers that decide alike see the same answers.
    ``plan`` forces the next submits' outcomes (``fail`` a route failure,
    ``full`` an overload with ``retry_after``, ``dead`` a death)."""

    def __init__(self, name, clock, queue_full, dead_error):
        self.name = name
        self._clock = clock
        self._full, self._dead_error = queue_full, dead_error
        self.plan = []
        self._dead = False
        self.kills = 0
        self._next = 0
        self._live = {}  # rid -> [steps left, result]
        self._done = {}
        self._keys = {}

    def alive(self):
        return not self._dead

    def kill(self, reason="killed"):
        self._dead = True
        self.kills += 1

    def restart(self):
        self._dead = False
        return sorted(self._live)  # the "journal": every incomplete request

    def submit(self, prompt, client_key=None, **kw):
        if self._dead:
            raise self._dead_error(f"{self.name} is dead")
        outcome = self.plan.pop(0) if self.plan else "ok"
        if outcome == "fail":
            raise RuntimeError("scripted route failure")
        if outcome == "full":
            raise self._full("scripted overload", retry_after=0.25 + 0.125 * len(self._live))
        if outcome == "dead":
            self._dead = True
            raise self._dead_error("scripted death at submit")
        rid = self._next
        self._next += 1
        r = _ScriptedResult(rid, prompt, self._clock())
        self._live[rid] = [int(kw.get("max_new_tokens") or 2) + len(prompt) % 3, r]
        if client_key is not None:
            self._keys[client_key] = rid
        return rid

    def step(self):
        if self._dead:
            raise self._dead_error(f"{self.name} is dead")
        now = self._clock()
        for rid in sorted(self._live):
            left, r = self._live[rid]
            r._tokens.append((rid * 7 + len(r._tokens)) % 50)
            if r.first_token_time is None:
                r.first_token_time = now
            if left <= 1:
                r.finish_time, r.finish_reason = now, "length"
                self._done[rid] = r
                del self._live[rid]
            else:
                self._live[rid][0] = left - 1
        return bool(self._live)

    def has_work(self):
        return not self._dead and bool(self._live)

    def pop_results(self):
        out, self._done = self._done, {}
        return out

    def result(self, rid):
        if rid in self._live:
            return self._live[rid][1]
        return self._done.get(rid)

    def first_token_seen(self, rid):
        r = self.result(rid)
        return r is not None and r.first_token_time is not None

    def cancel(self, rid):
        if rid not in self._live:
            return False
        r = self._live.pop(rid)[1]
        r.finish_time, r.finish_reason = self._clock(), "cancelled"
        self._done[rid] = r
        return True

    def client_request_id(self, key):
        return self._keys.get(key)

    def estimate_ttft(self, prompt_len):
        return None if not self._live else 0.01 * len(self._live) + 1e-4 * prompt_len

    def queue_depth(self):
        return len(self._live)

    def degrade_level(self):
        return 1 if len(self._live) > 4 else 0

    def draining(self):
        return False

    def kv_affinity(self, prompt, session_id=None):
        return 0.75 * len(prompt) if session_id is not None and sum(
            map(ord, session_id)) % 3 == int(self.name[1:]) % 3 else 0.0

    def stats(self):
        return {"live": len(self._live)}


def _scripted_fleet(pkg, clock, seed):
    if pkg == "jax":
        from deepspeed_tpu.serving.fleet import FleetRouter as R
        from deepspeed_tpu.serving.fleet import ReplicaDeadError as D
        from deepspeed_tpu.serving.fleet import ReplicaSupervisor as S
        from deepspeed_tpu.serving.scheduler import ServingQueueFull as Q
    else:
        from deepspeed_tpu_torch.serving.fleet import FleetRouter as R
        from deepspeed_tpu_torch.serving.fleet import ReplicaDeadError as D
        from deepspeed_tpu_torch.serving.fleet import ReplicaSupervisor as S
        from deepspeed_tpu_torch.serving.scheduler import ServingQueueFull as Q
    reps = [_ScriptedReplica(f"r{i}", clock, Q, D) for i in range(4)]
    router = R(reps, seed=seed, clock=clock,
               config={"route_retries": 2, "breaker_failures": 2,
                       "breaker_backoff_seconds": 0.5, "hedge": True,
                       "hedge_min_observations": 4, "hedge_factor": 1.0},
               supervisor=S(max_restarts=2, seed=seed, sleep=lambda s: None))
    return router, reps


def _drive(pkg, seed, events=400):
    clock = ManualClock()
    router, reps = _scripted_fleet(pkg, clock, seed)
    rng = random.Random(seed)
    trace = []
    for e in range(events):
        op = rng.random()
        name = rng.randrange(len(reps))
        if op < 0.45:
            kw = {"max_new_tokens": rng.randrange(1, 5)}
            if rng.random() < 0.3:
                kw["session_id"] = f"s{rng.randrange(4)}"
            key = f"k{rng.randrange(60)}" if rng.random() < 0.5 else None
            prompt = np.arange(rng.randrange(2, 9), dtype=np.int32)
            try:
                hid = router.submit(prompt, client_key=key, **kw)
                hd = router.handle(hid)
                trace.append(("submit", hid, hd.replica, hd.request_id))
            except Exception as exc:  # the FleetOverloaded each package raises
                trace.append(("refused", type(exc).__name__, round(exc.retry_after, 9)))
        elif op < 0.75:
            router.step()
            trace.append(("step", sorted(router.pop_results())))
        elif op < 0.88:
            reps[name].plan += [rng.choice(["fail", "fail", "fail", "full", "dead"])] * 2
        elif op < 0.895:
            reps[name].kill("scripted kill")
        elif op < 0.90:
            router.mark_dead(f"r{name}", "scripted mark")
        clock.advance(rng.random() * 0.3)
        st = router.stats()
        trace.append(("health", [(n, h["state"], h["breaker"]["state"], h["breaker"]["trips"],
                                  h["breaker"]["retry_at"]) for n, h in
                                 sorted(st["replica_health"].items())]))
    router.drain(max_steps=2000)
    return trace, router.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_parity_with_the_jax_router(seed):
    """Identical scripted replicas, one clock, one seed: the port's router
    places, refuses, trips, restarts and counts exactly as the JAX one
    (the breakers' seeded jitter draws the same sequence)."""
    want, want_stats = _drive("jax", seed)
    got, got_stats = _drive("port", seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"event {i}: port {g} != jax {w}"
    assert got_stats == want_stats
    kinds = {t[0] for t in want}
    assert {"submit", "refused", "step"} <= kinds
    assert want_stats["deaths"] > 0 and want_stats["route_failures"] > 0
    assert any(h["breaker"]["trips"] for h in want_stats["replica_health"].values())


# ---------------------------------------------------------------------------
# token parity: three JAX replicas and three port replicas, the same kill
# ---------------------------------------------------------------------------

def _kill_run(router, reps, prompts, rng, victim):
    hids = []
    for i, p in enumerate(prompts):
        hids.append(router.submit(p, max_new_tokens=8, client_key=f"tp{i}"))
        for _ in range(int(rng.poisson(1.0))):
            router.step()
        if i == len(prompts) // 2:
            reps[victim].kill("kill -9 mid-decode")
    res = router.drain(max_steps=800)
    assert sorted(res) == sorted(hids)
    return [list(np.asarray(res[h].tokens())) for h in hids], router.stats()


def test_token_parity_with_jax_replicas(eng, tmp_path):
    """The same load and the same kill over three JAX replicas and three
    port replicas (the same weights): the same tokens, each request's
    equal to solo ``generate()``, and the same death/restart counts."""
    from deepspeed_tpu.serving import ServingEngine as JServingEngine
    from deepspeed_tpu.serving.fleet import FleetRouter as JFleetRouter
    from deepspeed_tpu.serving.fleet import LocalReplica as JLocalReplica
    from deepspeed_tpu.serving.fleet import ReplicaSupervisor as JReplicaSupervisor

    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=_params(),
                                        dtype=jnp.float32, max_out_tokens=JTINY.n_positions)
    prompts = _prompts(8, 4, 16, seed=31)

    def jfac(name):
        d = str(tmp_path / "jax" / name)
        return lambda: JServingEngine(jeng, num_slots=2, prefill_chunk=8, max_len=64,
                                      journal_dir=d)

    jreps = [JLocalReplica(f"r{i}", jfac(f"r{i}")) for i in range(3)]
    jrouter = JFleetRouter(jreps, supervisor=JReplicaSupervisor(sleep=lambda s: None))
    want, jst = _kill_run(jrouter, jreps, prompts, np.random.default_rng(5), 1)
    router, reps = _fleet(eng, tmp_path / "port", n=3,
                          supervisor=ReplicaSupervisor(sleep=lambda s: None))
    got, st = _kill_run(router, reps, prompts, np.random.default_rng(5), 1)
    assert got == want
    for toks, p in zip(got, prompts):
        np.testing.assert_array_equal(np.asarray(toks), _solo(eng, p, 8))
    for key in ("deaths", "restarts", "routed", "failovers", "refired"):
        assert st[key] == jst[key], key
    assert st["deaths"] == 1 and st["restarts"] == 1


# ---------------------------------------------------------------------------
# the chaos tool on the CPU: real replica processes
# ---------------------------------------------------------------------------

def test_fleet_chaos_tool_on_the_cpu(tmp_path):
    """``tools/fleet_chaos.py`` at GPT2_TINY: three replica child processes
    over ``ProcessTransport``, one killed by ``DS_FAULT_PLAN`` mid-decode
    (rc -9, zero loss, the journal's incomplete set replayed), then the
    elastic fleet (a scale-up, a victim killed in ``migrate.export``, a
    clean migration the survivor rebinds); every output solo
    ``generate()``'s."""
    from deepspeed_tpu_torch.tools import fleet_chaos

    out = fleet_chaos.run("cpu", root=str(tmp_path))
    assert out["ok"], out["failures"]
    a, b = out["failover"], out["elastic"]
    assert a["victim_rc"] == -9 and a["resolved"] == a["requests"]
    assert a["bit_identical"] == a["requests"]  # f32 on the CPU: no near-tie flips
    assert a["restarts"][0]["replayed"] == a["restarts"][0]["undone"]
    assert b["scale_ups"] >= 1 and b["victim_rc"] == -9
    assert b["migration"]["exported"] > 0 and b["survivor_rebinds"] >= 1
    assert b["bit_identical"] == b["requests"]
