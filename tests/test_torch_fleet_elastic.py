"""The port's elastic fleet (``deepspeed_tpu_torch.serving.fleet.elastic``)
on the CPU, a mirror of ``tests/test_fleet_elastic.py``: the elastic
config's defaults and validation, the supervisor's leaky restart budget,
the warm pool's take / refill / inline fallback, hot/cold hysteresis with
cooldowns and the replica cap, scale-down of an idle fleet to its
minimum, the drain deadline aborting over live requests, the paged pool's
export/import round trip, drain-based scale-down with live KV migration so
the next turn is bit for bit, the ``migrate.export`` fault retried and a
victim's death mid-migration falling back to journal replay, the idle
session sweep, and (``slow``, as in the JAX file) the open-loop Poisson
run at twice one replica's capacity.  Plus the same 3-turn migration
driven on the JAX package's fleet and the port's (weights carried
across): the same tokens turn by turn, and ``fleet_chaos.py`` on the CPU.

The model is GPT2_TINY with its position table scaled up, f32."""
import dataclasses
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.config.config import (
    DeepSpeedConfigError,
    ElasticConfig,
    FleetConfig,
    ServingConfig,
)
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving import ServingEngine
from deepspeed_tpu_torch.serving.fleet import (
    HEALTHY,
    FleetAutoscaler,
    FleetOverloaded,
    FleetRouter,
    LocalReplica,
    ReplicaSupervisor,
    WarmPool,
)
from deepspeed_tpu_torch.serving.fleet.replica import ReplicaDeadError

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TINY = tgpt2.GPT2_TINY

PAGED = {"kvcache": {"enabled": True, "page_len": 8}}


def _params(seed=7):
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


@pytest.fixture(scope="module")
def eng():
    """Position-sensitive engine (wpe scaled) shared by every replica —
    slot/position bugs change generations instead of hiding."""
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


def _auto_factory(eng, base, **kw):
    """factory(name) -> LocalReplica, the shape the WarmPool feeds on."""

    def make(name):
        return LocalReplica(name, _factory(eng, base, name, **kw))

    return make


def _solo(eng, prompt, max_new):
    return np.asarray(eng.generate(prompt[None, :], max_new_tokens=max_new))[0]


# ---------------------------------------------------------------------------
# config plumbing (no engine)
# ---------------------------------------------------------------------------

def test_elastic_config_defaults_and_validation():
    cfg = FleetConfig.from_dict(None)
    assert cfg.elastic.enabled is False and cfg.elastic.min_replicas == 1
    cfg = ServingConfig.from_dict({
        "fleet": {"elastic": {
            "enabled": True, "max_replicas": 5, "engage_ticks": 2,
        }},
    })
    assert cfg.fleet.elastic.enabled and cfg.fleet.elastic.max_replicas == 5
    with pytest.raises(DeepSpeedConfigError, match="elastic"):
        ElasticConfig.from_dict({"warm_replicas": 2})  # unknown key
    with pytest.raises(DeepSpeedConfigError, match="max_replicas"):
        ElasticConfig.from_dict({"min_replicas": 3, "max_replicas": 2})
    # anti-flap: overlapping thresholds are rejected outright
    with pytest.raises(DeepSpeedConfigError, match="flap"):
        ElasticConfig.from_dict({
            "scale_up_queue_depth": 2, "scale_down_queue_depth": 2,
        })
    with pytest.raises(DeepSpeedConfigError, match="migration_retries"):
        ElasticConfig.from_dict({"migration_retries": -1})


def test_fleet_config_restart_budget_reset_validation():
    cfg = FleetConfig.from_dict({"restart_budget_reset_seconds": 120.0})
    assert cfg.restart_budget_reset_seconds == 120.0
    assert FleetConfig.from_dict(None).restart_budget_reset_seconds == 0.0
    with pytest.raises(DeepSpeedConfigError, match="restart_budget_reset"):
        FleetConfig.from_dict({"restart_budget_reset_seconds": -1.0})


# ---------------------------------------------------------------------------
# supervisor restart-budget decay (no engine)
# ---------------------------------------------------------------------------

class _FakeReplica:
    def __init__(self, name="f0"):
        self.name = name
        self.restarted = 0

    def restart(self):
        self.restarted += 1
        return [1, 2]


def test_supervisor_restart_budget_decays_with_clean_service():
    clk = ManualClock()
    sup = ReplicaSupervisor(
        max_restarts=2, sleep=lambda s: None,
        restart_budget_reset_seconds=10.0, clock=clk,
    )
    rep = _FakeReplica()
    assert sup.handle_death(rep, "t") == [1, 2]
    assert sup.handle_death(rep, "t") == [1, 2]
    assert sup.handle_death(rep, "t") is None  # exhausted at t=0
    # 10s of clean service forgives one consumed attempt
    clk.advance(10.0)
    assert sup.attempts(rep.name) == 1
    assert sup.handle_death(rep, "t") == [1, 2]
    assert sup.attempts(rep.name) == 2
    # two full intervals forgive the rest (floor at zero)
    clk.advance(25.0)
    assert sup.attempts(rep.name) == 0


def test_supervisor_budget_never_decays_when_reset_disabled():
    clk = ManualClock()
    sup = ReplicaSupervisor(max_restarts=1, sleep=lambda s: None, clock=clk)
    rep = _FakeReplica("f1")
    assert sup.handle_death(rep, "t") == [1, 2]
    clk.advance(1e9)  # an eon of clean service changes nothing
    assert sup.attempts("f1") == 1
    assert sup.handle_death(rep, "t") is None


# ---------------------------------------------------------------------------
# warm pool (no engine)
# ---------------------------------------------------------------------------

class _Warmable:
    def __init__(self, name):
        self.name = name


def test_warm_pool_prebuilds_take_and_inline_fallback():
    built = []

    def fac(name):
        built.append(name)
        return _Warmable(name)

    pool = WarmPool(fac, size=1)
    try:
        deadline = time.monotonic() + 10.0
        while pool.ready() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pool.ready() == 1  # the filler pre-built off-thread
        rep = pool.take()
        assert rep is not None and rep.name == "elastic1"
    finally:
        pool.stop()
    # size=0 disables the filler: take() builds inline
    pool0 = WarmPool(fac, size=0)
    rep = pool0.take()
    assert rep is not None and rep.name.startswith("elastic")
    pool0.stop()

    def broken(name):
        raise RuntimeError("no replica for you")

    boom = WarmPool(broken, size=0)
    assert boom.take() is None
    assert boom.stats()["build_failures"] == 1
    boom.stop()


# ---------------------------------------------------------------------------
# autoscaler hysteresis, cooldowns, bounds
# ---------------------------------------------------------------------------

def test_autoscaler_scale_up_hysteresis_cooldown_and_max_cap(eng, tmp_path):
    r0 = LocalReplica("r0", _factory(eng, tmp_path, "r0"))
    router = FleetRouter([r0])
    clk = ManualClock()
    auto = FleetAutoscaler(
        router, _auto_factory(eng, tmp_path),
        config={
            "enabled": True, "min_replicas": 1, "max_replicas": 3,
            "scale_up_queue_depth": 2, "scale_down_queue_depth": 0,
            "engage_ticks": 3, "disengage_ticks": 10**6,
            "scale_up_cooldown_seconds": 100.0,
            "scale_down_cooldown_seconds": 0.0,
            "warm_pool_size": 0,
        },
        clock=clk,
    )
    for p in _prompts(6, 6, 10, seed=1):
        router.submit(p, max_new_tokens=4)
    # hysteresis: two hot ticks are not enough
    auto.tick()
    auto.tick()
    assert auto.scale_ups == 0 and len(router._order) == 1
    auto.tick()  # third consecutive hot tick engages
    assert auto.scale_ups == 1 and len(router._order) == 2
    assert auto.last_scale_up_reaction_s is not None
    # cooldown: still hot, but the second scale-up must wait 100s
    for _ in range(5):
        auto.tick()
    assert auto.scale_ups == 1
    clk.advance(101.0)
    auto.tick()
    assert auto.scale_ups == 2 and len(router._order) == 3
    # max_replicas is a hard ceiling
    clk.advance(101.0)
    for _ in range(5):
        auto.tick()
    assert auto.scale_ups == 2 and len(router._order) == 3
    res = router.drain(max_steps=600)
    assert len(res) == 6  # the surge work all resolves
    auto.stop()


def test_autoscaler_scales_down_idle_fleet_to_min(eng, tmp_path):
    reps = [LocalReplica(f"r{i}", _factory(eng, tmp_path, f"r{i}"))
            for i in range(2)]
    router = FleetRouter(reps)
    clk = ManualClock()
    auto = FleetAutoscaler(
        router, _auto_factory(eng, tmp_path),
        config={
            "enabled": True, "min_replicas": 1, "max_replicas": 3,
            "scale_up_queue_depth": 2, "scale_down_queue_depth": 0,
            "engage_ticks": 10**6, "disengage_ticks": 3,
            "scale_up_cooldown_seconds": 0.0,
            "scale_down_cooldown_seconds": 0.0,
            "warm_pool_size": 0,
        },
        clock=clk,
    )
    auto.tick()
    auto.tick()
    assert auto.stats()["phase"] == "idle" and len(router._order) == 2
    auto.tick()  # third cold tick begins the drain (LIFO victim: r1)
    assert auto.stats()["phase"] == "draining"
    assert auto.stats()["victim"] == "r1"
    auto.tick()  # idle victim -> migrate (nothing parked) -> removed
    assert auto.scale_downs == 1 and len(router._order) == 1
    assert "r1" not in router._replicas
    # min_replicas floors the fleet: no further scale-down ever fires
    for _ in range(10):
        auto.tick()
    assert auto.scale_downs == 1 and len(router._order) == 1
    auto.stop()


def test_autoscaler_drain_deadline_aborts_over_live_requests(eng, tmp_path):
    reps = [LocalReplica(f"r{i}", _factory(eng, tmp_path, f"r{i}"))
            for i in range(2)]
    router = FleetRouter(reps)
    clk = ManualClock()
    auto = FleetAutoscaler(
        router, _auto_factory(eng, tmp_path),
        config={
            "enabled": True, "min_replicas": 1, "max_replicas": 3,
            "engage_ticks": 10**6, "disengage_ticks": 10**6,
            "warm_pool_size": 0, "migration_deadline_seconds": 5.0,
        },
        clock=clk,
    )
    hids = [router.submit(p, max_new_tokens=6)
            for p in _prompts(4, 6, 10, seed=2)]
    victim = router.handle(hids[0]).replica
    assert auto.request_scale_down(victim)
    assert router.inflight_on(victim) >= 1
    auto.tick()  # inside the deadline: keep waiting for the drain
    assert auto.stats()["phase"] == "draining"
    clk.advance(6.0)
    auto.tick()  # past the deadline with live requests: ABORT
    assert auto.scale_downs_aborted == 1 and auto.stats()["phase"] == "idle"
    assert victim in router._order
    assert router._health[victim].state == HEALTHY  # back in rotation
    res = router.drain(max_steps=600)
    assert len(res) == 4  # nothing was lost to the aborted drain
    auto.stop()


# ---------------------------------------------------------------------------
# pool export/import wire format
# ---------------------------------------------------------------------------

def test_pool_export_import_roundtrip_counts(eng, tmp_path):
    a = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64,
                      journal_dir=str(tmp_path / "a" / "journal"), **PAGED)
    b = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64,
                      journal_dir=str(tmp_path / "b" / "journal"), **PAGED)
    p = _prompts(1, 10, 10, seed=3)[0]
    a.submit(p, max_new_tokens=4, session_id="sess-a")
    a.drain()
    assert a.pool.stats()["sessions_warm"] == 1
    handoff = str(tmp_path / "handoff")
    exported = a.pool.export_sessions(handoff, now=0.0)
    assert "sess-a" in exported
    # export is read-only: the source still holds its parked session
    assert a.pool.stats()["sessions_warm"] == 1
    counts = b.pool.import_sessions(handoff, now=0.0)
    assert counts["sessions"] == 1 and counts["skipped"] == 0
    assert b.pool.stats()["sessions_warm"] == 1
    # idempotent: a second import skips (the survivor's copy wins)
    counts2 = b.pool.import_sessions(handoff, now=0.0)
    assert counts2["sessions"] == 0 and counts2["skipped"] >= 1
    assert b.pool.stats()["sessions_warm"] == 1


# ---------------------------------------------------------------------------
# live migration: parity, fault retries, death fallback
# ---------------------------------------------------------------------------

def _migration_fleet(eng, tmp_path, migration_retries=2):
    r0 = LocalReplica("r0", _factory(eng, tmp_path, "r0", **PAGED))
    r1 = LocalReplica("r1", _factory(eng, tmp_path, "r1", **PAGED))
    sup = ReplicaSupervisor(max_restarts=2, sleep=lambda s: None)
    router = FleetRouter([r0, r1], supervisor=sup)
    auto = FleetAutoscaler(
        router, _auto_factory(eng, tmp_path, **PAGED),
        config={
            "enabled": True, "min_replicas": 1, "max_replicas": 3,
            "engage_ticks": 10**6, "disengage_ticks": 10**6,
            "warm_pool_size": 0, "migration_deadline_seconds": 60.0,
            "migration_retries": migration_retries,
        },
        handoff_root=str(tmp_path),
    )
    return router, auto, r0, r1


def _run_turn(router, prompt, session_id, max_new=6):
    hid = router.submit(prompt, max_new_tokens=max_new, session_id=session_id)
    res = router.drain(max_steps=600)
    return np.asarray(res[hid].tokens())


def _three_turns(eng, seed, turns=3, start_len=8, extra=4, max_new=6):
    """(prompt, expected) per turn: turn t's prompt is turn t-1's FULL
    solo output plus fresh tokens, expected is the solo generation over
    the whole context — the uninterrupted run every fleet turn must
    bit-match."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, TINY.vocab_size, start_len, dtype=np.int32)
    out = []
    for _ in range(turns):
        full = _solo(eng, ctx, max_new)
        out.append((ctx.copy(), full))
        ctx = np.concatenate(
            [full, rng.integers(1, TINY.vocab_size, extra, dtype=np.int32)]
        ).astype(np.int32)
    return out


def test_migration_parity_three_turn_session(eng, tmp_path):
    """The satellite headline: a 3-turn session whose replica is
    scale-downed after turn 2 — turn 3 runs on the survivor against the
    MIGRATED KV and bit-matches the uninterrupted solo run."""
    router, auto, r0, r1 = _migration_fleet(eng, tmp_path)
    turns = _three_turns(eng, seed=5)
    # turns 1-2 land on r1 (r0 drains so placement pins the session)
    router.begin_drain("r0", "pin the session to r1")
    for prompt, want in turns[:2]:
        np.testing.assert_array_equal(_run_turn(router, prompt, "s0"), want)
    router.abort_drain("r0")
    assert r1.engine.pool.stats()["sessions_warm"] == 1
    # scale r1 down: drain + live migration of its parked session to r0
    assert auto.request_scale_down("r1")
    for _ in range(50):
        auto.tick()
        if auto.stats()["phase"] == "idle":
            break
    assert auto.scale_downs == 1 and auto.migrations_completed == 1
    assert auto.sessions_migrated >= 1 and "r1" not in router._order
    # turn 3 continues on the survivor, bit-identical, and the KV it
    # extends is the MIGRATED copy (r0 never served turns 1-2)
    prompt, want = turns[2]
    np.testing.assert_array_equal(_run_turn(router, prompt, "s0"), want)
    kv = r0.engine.pool.stats()
    assert kv["session_rebinds"] + kv["session_restores"] >= 1
    auto.stop()


def test_migrate_export_fault_retries_then_succeeds(eng, tmp_path):
    router, auto, r0, r1 = _migration_fleet(eng, tmp_path)
    router.begin_drain("r0", "pin the session to r1")
    _run_turn(router, _prompts(1, 10, 10, seed=6)[0], "s1")
    router.abort_drain("r0")
    assert r1.engine.pool.stats()["sessions_warm"] == 1
    with faults.FaultInjector(seed=0).fail("migrate.export", times=1):
        assert auto.request_scale_down("r1")
        for _ in range(50):
            auto.tick()
            if auto.stats()["phase"] == "idle":
                break
    # the first export attempt failed; the retry completed the move
    assert auto.migrations_completed == 1 and auto.migrations_failed == 0
    assert auto.sessions_migrated >= 1 and "r1" not in router._order
    assert r0.engine.pool.stats()["sessions_warm"] >= 1
    auto.stop()


def test_victim_death_mid_migration_falls_back_to_journal_replay(eng, tmp_path):
    """A replica that dies mid-export (the multi-process kill -9 shape:
    ReplicaDeadError at the pipe) abandons the scale-down and lands on
    the router's death path — supervisor restart, zero acknowledged
    loss, and the next session turn simply re-prefills bit-identically."""
    router, auto, r0, r1 = _migration_fleet(eng, tmp_path)
    turns = _three_turns(eng, seed=7, turns=2)
    router.begin_drain("r0", "pin the session to r1")
    np.testing.assert_array_equal(
        _run_turn(router, turns[0][0], "s2"), turns[0][1]
    )
    router.abort_drain("r0")

    def dying_export(dest_dir):
        # what a kill -9 mid-export looks like from the parent: the
        # process is gone and the pipe EOFs before any manifest lands
        r1.kill("sigkill mid-export")
        raise ReplicaDeadError("pipe EOF mid-export")

    r1.export_sessions = dying_export
    assert auto.request_scale_down("r1")
    for _ in range(50):
        auto.tick()
        if auto.stats()["phase"] == "idle":
            break
    assert auto.migrations_failed == 1 and auto.scale_downs == 0
    # the death path restarted r1 from its journal: alive, routable,
    # still a fleet member — the scale-down was abandoned, not the replica
    assert r1.alive() and "r1" in router._order
    assert router._health["r1"].state == HEALTHY
    assert r1.kills == 1
    # the parked KV died with the process; turn 2 re-prefills and still
    # bit-matches the uninterrupted run (warmth lost, correctness kept)
    np.testing.assert_array_equal(
        _run_turn(router, turns[1][0], "s2"), turns[1][1]
    )
    auto.stop()


# ---------------------------------------------------------------------------
# idle-session TTL sweep (regression: an idle replica never steps)
# ---------------------------------------------------------------------------

def test_idle_session_ttl_sweeps_without_traffic(eng, tmp_path):
    ttl = {"kvcache": {"enabled": True, "page_len": 8,
                       "session_ttl_seconds": 0.2}}
    # engine half: stats() on an idle engine runs the pool sweep, so a
    # replica that never steps still expires its parked sessions
    srv = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64,
                        journal_dir=str(tmp_path / "idle" / "journal"),
                        **ttl)
    srv.submit(_prompts(1, 10, 10, seed=8)[0], max_new_tokens=4,
               session_id="sess-idle")
    srv.drain()
    assert srv.pool.stats()["sessions_warm"] == 1
    time.sleep(0.3)
    srv.stats()  # no step(), no traffic — the stats sweep must expire it
    assert srv.pool.stats()["sessions_warm"] == 0
    # autoscaler half: the tick sweeps every replica host-side
    rep = LocalReplica("rt", _factory(eng, tmp_path, "rt", **ttl))
    router = FleetRouter([rep])
    auto = FleetAutoscaler(
        router, _auto_factory(eng, tmp_path, **ttl),
        config={"enabled": True, "engage_ticks": 10**6,
                "disengage_ticks": 10**6, "warm_pool_size": 0},
    )
    rid = rep.submit(_prompts(1, 10, 10, seed=9)[0], max_new_tokens=4,
                     session_id="sess-tick")
    while rep.has_work():
        rep.step()
    rep.pop_results()
    assert rid >= 0 and rep.engine.pool.stats()["sessions_warm"] == 1
    time.sleep(0.3)
    auto.tick()
    assert rep.engine.pool.stats()["sessions_warm"] == 0
    auto.stop()


# ---------------------------------------------------------------------------
# the chaos proof: 2x offered load, forced scale-down, bounded tail
# ---------------------------------------------------------------------------

def _open_loop(router, auto, prompts, offered_rps, seed, max_new,
               down_at_frac=None):
    """Seeded open-loop Poisson driver.  Returns (finished, handles,
    shed, ttft_ms): every admitted handle MUST appear in finished —
    that is the zero-acknowledged-loss ledger the caller asserts on."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / offered_rps, size=len(prompts)))
    down_at = (
        float(arrivals[max(int(len(arrivals) * down_at_frac) - 1, 0)])
        if down_at_frac is not None else None
    )
    pending = list(zip(arrivals, prompts))
    handles, finished, shed = {}, {}, 0
    t0 = time.monotonic()
    while (pending or router.has_work()
           or (auto is not None and auto.stats()["phase"] != "idle")):
        now = time.monotonic() - t0
        # the forced scale-down waits until a victim exists (the fleet
        # above its minimum): the port's CPU steps may outrun the scale-up
        if down_at is not None and now >= down_at and auto.request_scale_down():
            down_at = None
        while pending and pending[0][0] <= now:
            _, (i, p) = pending.pop(0)
            try:
                handles[router.submit(p, max_new_tokens=max_new)] = i
            except FleetOverloaded:
                shed += 1
        if auto is not None:
            auto.tick()
        if router.has_work():
            router.step()
        elif pending:
            time.sleep(min(0.005, max(0.0, pending[0][0] - now)))
        finished.update(router.pop_results())
    finished.update(router.pop_results())
    ttft = [
        (r.first_token_time - r.submit_time) * 1e3
        for hid, r in finished.items()
        if hid in handles and r.first_token_time is not None
    ]
    return finished, handles, shed, ttft


@pytest.mark.slow
def test_elastic_poisson_2x_capacity_chaos_proof(eng, tmp_path):
    """Acceptance headline: seeded open-loop Poisson at 2x one
    replica's measured capacity over an autoscaled fleet with a FORCED
    mid-surge scale-down — zero acknowledged loss, every output (and a
    session continuation across the churn) bit-identical to solo, and
    admitted-p99 TTFT within 3x the steady-state tail (the SLO shedder
    keeps what the fleet admits honest while it scales)."""
    max_new = 4
    prompts = [(i, p) for i, p in enumerate(_prompts(32, 6, 12, seed=11))]
    expect = [_solo(eng, p, max_new) for _, p in prompts]

    # -- capacity anchor: closed loop on one warm replica
    cap_rep = LocalReplica("cap", _factory(eng, tmp_path, "cap", **PAGED))
    for p in _prompts(2, 8, 8, seed=12):  # warm the executables
        cap_rep.submit(p, max_new_tokens=max_new)
    while cap_rep.has_work():
        cap_rep.step()
    cap_rep.pop_results()
    t0 = time.monotonic()
    for _, p in prompts[:8]:
        cap_rep.submit(p, max_new_tokens=max_new)
    while cap_rep.has_work():
        cap_rep.step()
    cap_rep.pop_results()
    cap_rps = 8.0 / max(time.monotonic() - t0, 1e-9)

    # -- steady state: one replica at 0.5x capacity, no elasticity
    steady_router = FleetRouter(
        [LocalReplica("s0", _factory(eng, tmp_path, "s0", **PAGED))]
    )
    fin, hs, _, ttft = _open_loop(
        steady_router, None, prompts[:16], 0.5 * cap_rps, seed=13,
        max_new=max_new,
    )
    assert len(ttft) == len(hs) == 16  # nothing queues away its token
    steady_p99 = max(float(np.percentile(ttft, 99)), 25.0)

    # -- the surge: 2x capacity, SLO-armed replicas, warm pool ready
    slo_ms = max(2.0 * steady_p99, 50.0)
    armed = dict(PAGED, slo_ttft_ms=slo_ms)
    r0 = LocalReplica("r0", _factory(eng, tmp_path, "r0", **armed))
    router = FleetRouter([r0])
    auto = FleetAutoscaler(
        router, _auto_factory(eng, tmp_path, **armed),
        config={
            "enabled": True, "min_replicas": 1, "max_replicas": 2,
            "scale_up_queue_depth": 2, "scale_down_queue_depth": 1,
            "scale_up_ttft_seconds": slo_ms / 1e3,
            "engage_ticks": 2, "disengage_ticks": 10**6,
            "scale_up_cooldown_seconds": 0.0,
            "scale_down_cooldown_seconds": 0.0,
            "warm_pool_size": 1, "migration_deadline_seconds": 60.0,
            "migration_retries": 2,
        },
        handoff_root=str(tmp_path),
    )
    deadline = time.monotonic() + 120.0
    while auto.pool.ready() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert auto.pool.ready() >= 1  # scale-up must not pay the compile
    # a session parked before the surge must survive the churn
    sess_p = _prompts(1, 8, 8, seed=14)[0]
    sess_full = _solo(eng, sess_p, max_new)
    hid = router.submit(sess_p, max_new_tokens=max_new, session_id="chaos")
    res = router.drain(max_steps=600)
    np.testing.assert_array_equal(np.asarray(res[hid].tokens()), sess_full)

    fin, hs, shed, ttft = _open_loop(
        router, auto, prompts, 2.0 * cap_rps, seed=15, max_new=max_new,
        down_at_frac=0.6,
    )
    # the autoscaler reacted, and the forced scale-down went through
    # (drain + migrate) or aborted SAFELY over live requests — never both
    assert auto.scale_ups >= 1
    assert auto.scale_downs + auto.scale_downs_aborted >= 1
    # zero acknowledged loss: every admitted handle resolved, and every
    # resolved output bit-matches the uninterrupted solo run
    assert set(hs) <= set(fin)
    for h, i in hs.items():
        np.testing.assert_array_equal(np.asarray(fin[h].tokens()), expect[i])
    assert len(ttft) == len(hs)
    # the admitted tail stays within 3x steady state: shedding + the
    # warm scale-up keep the fleet's promises honest under 2x load
    elastic_p99 = float(np.percentile(ttft, 99)) if ttft else 0.0
    assert elastic_p99 <= 3.0 * steady_p99, (
        f"admitted p99 {elastic_p99:.1f}ms > 3x steady {steady_p99:.1f}ms "
        f"(shed {shed}/{len(prompts)})"
    )
    # the pre-surge session continues bit-identically after the churn
    ctx2 = np.concatenate(
        [sess_full, _prompts(1, 4, 4, seed=16)[0]]
    ).astype(np.int32)
    expect2 = _solo(eng, ctx2, max_new)
    hid2 = router.submit(ctx2, max_new_tokens=max_new, session_id="chaos")
    res = router.drain(max_steps=600)
    np.testing.assert_array_equal(np.asarray(res[hid2].tokens()), expect2)
    auto.stop()


# ---------------------------------------------------------------------------
# against the JAX package: the same migration, the same tokens
# ---------------------------------------------------------------------------

def _migrate_three_turns(router, auto, turns):
    out = []
    router.begin_drain("r0", "pin the session to r1")
    for prompt, _ in turns[:2]:
        out.append(_run_turn(router, prompt, "s0").tolist())
    router.abort_drain("r0")
    assert auto.request_scale_down("r1")
    for _ in range(50):
        auto.tick()
        if auto.stats()["phase"] == "idle":
            break
    out.append(_run_turn(router, turns[2][0], "s0").tolist())
    st = auto.stats()
    return out, (st["scale_downs"], st["migrations_completed"], st["sessions_migrated"])


def test_migration_matches_the_jax_fleet(eng, tmp_path):
    """The 3-turn session scaled down after turn 2 on the JAX package's
    fleet and on the port's (the same weights): every turn's tokens and
    the autoscaler's counts agree, and equal solo ``generate()``."""
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.serving import ServingEngine as JServingEngine
    from deepspeed_tpu.serving.fleet import FleetAutoscaler as JFleetAutoscaler
    from deepspeed_tpu.serving.fleet import FleetRouter as JFleetRouter
    from deepspeed_tpu.serving.fleet import LocalReplica as JLocalReplica
    from deepspeed_tpu.serving.fleet import ReplicaSupervisor as JReplicaSupervisor

    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=_params(),
                                        dtype=jnp.float32, max_out_tokens=JTINY.n_positions)

    def jfac(name):
        d = str(tmp_path / "jax" / name / "journal")
        return lambda: JServingEngine(jeng, num_slots=2, prefill_chunk=8, max_len=64,
                                      journal_dir=d, **PAGED)

    jrouter = JFleetRouter([JLocalReplica(n, jfac(n)) for n in ("r0", "r1")],
                           supervisor=JReplicaSupervisor(max_restarts=2, sleep=lambda s: None))
    jauto = JFleetAutoscaler(
        jrouter, lambda name: JLocalReplica(name, jfac(name)),
        config={"enabled": True, "min_replicas": 1, "max_replicas": 3,
                "engage_ticks": 10**6, "disengage_ticks": 10**6, "warm_pool_size": 0,
                "migration_deadline_seconds": 60.0, "migration_retries": 2},
        handoff_root=str(tmp_path / "jax"))
    turns = _three_turns(eng, seed=5)
    want, jcounts = _migrate_three_turns(jrouter, jauto, turns)
    jauto.stop()
    router, auto, r0, _ = _migration_fleet(eng, tmp_path / "port")
    got, counts = _migrate_three_turns(router, auto, turns)
    auto.stop()
    assert got == want
    assert counts == jcounts == (1, 1, 1)
    for toks, (_, full) in zip(got, turns):
        np.testing.assert_array_equal(np.asarray(toks), full)
    kv = r0.engine.pool.stats()
    assert kv["session_rebinds"] + kv["session_restores"] >= 1
