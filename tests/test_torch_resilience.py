"""The port's resilience subsystem (deepspeed_tpu_torch.resilience and the
engine's checkpoint, preemption and divergence paths): twins of
``tests/test_resilience.py``'s classes, on the port's engine on the CPU.

The properties proven here, as for the JAX package:

* a kill at any save site NEVER produces a loadable-but-corrupt tag (only
  the previous tree plus a ``.tmp`` staging dir survive);
* a corrupt newest tag is quarantined to ``<tag>.corrupt`` and the load
  falls back to the previous verified tag;
* SIGTERM during training produces a verified emergency checkpoint and
  exit code 43; an expired grace window exits 1 without a tag;
* the divergence guard rolls back, lowers the loss-scale floor or warns.

The fault injector, manifests and retry policy are the JAX package's
logic copied; the parity tests at the top feed both copies the same
plans and files.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.resilience import faults as jfaults
from deepspeed_tpu.resilience import manager as jmanager
from deepspeed_tpu.resilience import policy as jpolicy
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.resilience import (
    CheckpointNotFoundError,
    DivergenceGuard,
    FaultInjector,
    InjectedFault,
    InjectedKill,
    PreemptionWatchdog,
    RetryError,
    RetryPolicy,
    atomic_write_text,
    faults,
    manager,
    retry_call,
    verify_manifest,
    write_manifest,
)
from deepspeed_tpu_torch.runtime.checkpointing import load_checkpoint

TINY = dataclasses.replace(gpt2.GPT2_TINY, remat=False)


def make_engine(seed=7, fp16=False, resilience=None):
    model_fn, init_fn, _ = gpt2.make_model(TINY)
    config = {
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "steps_per_print": 1000,
        # backoff 0 so injected-failure retries don't sleep in tests
        "resilience": {"retry": {"backoff_seconds": 0.0}, **(resilience or {})},
    }
    if fp16:
        config["fp16"] = {"enabled": True, "initial_scale_power": 8}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=seed), config=config, device="cpu")
    return engine


def batch(seed=3, bs=4, seq=16):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, TINY.vocab_size, (bs, seq), dtype=np.int32)}


def manifest_files(tag_dir):
    with open(os.path.join(tag_dir, "manifest.json")) as f:
        return json.load(f)["files"]


def lnf_g(eng):
    return eng.params["lnf_g"].clone()


# ---------------------------------------------------------------------------
# the copies against the JAX package's modules
# ---------------------------------------------------------------------------


def test_fault_plans_fire_as_the_jax_injectors_do():
    """One DS_FAULT_PLAN through both injectors: the same calls fire,
    in the same order, with the same seeded probabilistic draws."""
    plan = jfaults.plan_json([
        {"site": "a", "action": "fail", "times": 2, "after": 1},
        {"site": "b", "action": "flag", "times": 3},
        {"site": "c", "action": "fail", "probability": 0.5, "times": 50},
        {"site": "d", "action": "stall", "seconds": 0.0, "times": 2},
        {"site": "e", "action": "latency", "seconds": 0.0, "times": 3},
        {"site": "f", "action": "fail", "rank": 1},
    ], seed=4)
    tape = []
    for mod in (jfaults, faults):
        inj = mod.FaultInjector.from_plan(plan, rank=0)
        out = []
        for _ in range(8):
            for site in ("a", "c", "f"):
                try:
                    inj.fire(site)
                    out.append(0)
                except OSError:
                    out.append(1)
            out += [inj.fire_flag("b"), inj.fire_stall("d"), inj.fire_latency("e")]
        tape.append((out, inj.log, json.loads(inj.to_plan())))
    assert tape[0] == tape[1]


def test_manager_orders_and_retains_as_the_jax_one(tmp_path):
    """Two equal trees (tags, a foreign dir, a staging dir): the same
    order, the same committed tags and the same retention deletions."""
    roots = []
    for side in ("port", "jax"):
        root = tmp_path / side
        for i in (1, 2, 3, 4, 6, 9):
            d = root / f"global_step{i}"
            d.mkdir(parents=True)
            (d / "meta.json").write_text(json.dumps({"global_step": i}))
        (root / "logs").mkdir()
        (root / "global_step7.tmp").mkdir()
        roots.append(str(root))
    port, jax_root = roots
    assert manager.newest_first(port) == jmanager.newest_first(jax_root)
    assert sorted(manager.committed_tags(port)) == sorted(jmanager.committed_tags(jax_root))
    assert manager.tag_step(port, "global_step6") == jmanager.tag_step(jax_root, "global_step6")
    deleted = manager.retention_gc(port, keep_last_n=2, keep_every=3)
    assert deleted == jmanager.retention_gc(jax_root, keep_last_n=2, keep_every=3)
    assert deleted == ["global_step4", "global_step2", "global_step1"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_root))


def test_retry_delays_equal_the_jax_policy():
    for attempt in range(1, 8):
        rng_a, rng_b = jpolicy.random.Random(attempt), jpolicy.random.Random(attempt)
        a = RetryPolicy(backoff_seconds=0.3, backoff_max_seconds=5.0, jitter=0.5)
        b = jpolicy.RetryPolicy(backoff_seconds=0.3, backoff_max_seconds=5.0, jitter=0.5)
        assert a.delay(attempt, rng_a) == b.delay(attempt, rng_b)


# ---------------------------------------------------------------------------
# atomic primitives + manifests
# ---------------------------------------------------------------------------


class TestAtomic:
    def test_atomic_write_replaces_and_survives_crash(self, tmp_path):
        target = str(tmp_path / "latest")
        atomic_write_text(target, "tag_a")
        assert open(target).read() == "tag_a"
        # crash at the replace instruction: the old content must survive
        inj = FaultInjector().kill("atomic.replace")
        with inj, pytest.raises(InjectedKill):
            atomic_write_text(target, "tag_b")
        assert open(target).read() == "tag_a"
        assert inj.log == [("atomic.replace", "InjectedKill")]
        atomic_write_text(target, "tag_b")
        assert open(target).read() == "tag_b"

    @pytest.mark.parametrize("algorithm", ["sha256", "crc32", "none"])
    def test_manifest_roundtrip(self, tmp_path, algorithm):
        from deepspeed_tpu.resilience import verify_manifest as jverify

        d = tmp_path / "tag"
        (d / "sub").mkdir(parents=True)
        (d / "a.bin").write_bytes(b"\x01" * 100)
        (d / "sub" / "b.bin").write_bytes(b"\x02" * 50)
        m = write_manifest(str(d), algorithm=algorithm)
        assert set(m["files"]) == {"a.bin", "sub/b.bin"}
        ok, errors = verify_manifest(str(d))
        assert ok and not errors
        assert jverify(str(d)) == (True, [])  # the JAX package reads the port's manifest

    def test_manifest_detects_truncation_corruption_and_missing(self, tmp_path):
        d = tmp_path / "tag"
        d.mkdir()
        (d / "a.bin").write_bytes(b"\x01" * 100)
        (d / "b.bin").write_bytes(b"\x02" * 100)
        (d / "c.bin").write_bytes(b"\x03" * 100)
        write_manifest(str(d))
        FaultInjector.truncate_file(str(d / "a.bin"), keep_bytes=10)
        FaultInjector(seed=1).corrupt_file(str(d / "b.bin"))  # same size, flipped byte
        os.remove(d / "c.bin")
        ok, errors = verify_manifest(str(d))
        assert not ok
        blob = "; ".join(errors)
        assert "size mismatch 'a.bin'" in blob
        assert "checksum mismatch 'b.bin'" in blob
        assert "missing file 'c.bin'" in blob

    def test_legacy_tag_without_manifest_is_tolerated(self, tmp_path):
        d = tmp_path / "tag"
        d.mkdir()
        (d / "a.bin").write_bytes(b"x")
        ok, notes = verify_manifest(str(d))
        assert ok and "legacy" in notes[0]


# ---------------------------------------------------------------------------
# retry policy + divergence guard units
# ---------------------------------------------------------------------------


class TestRetry:
    def test_succeeds_after_transient_failures(self):
        inj = FaultInjector().fail("flaky", times=2)
        sleeps = []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            inj.fire("flaky")
            return "ok"

        with inj:
            out = retry_call(
                RetryPolicy(max_attempts=4, backoff_seconds=0.1, jitter=0.5),
                flaky,
                sleep=sleeps.append,
            )
        assert out == "ok" and calls["n"] == 3
        # exponential backoff with deterministic seeded jitter in [1, 1.5)
        assert 0.1 <= sleeps[0] < 0.15 and 0.2 <= sleeps[1] < 0.3

    def test_exhaustion_raises_retry_error_chained(self):
        def always():
            raise OSError("disk on fire")

        with pytest.raises(RetryError) as e:
            retry_call(RetryPolicy(max_attempts=3, backoff_seconds=0.0), always, sleep=lambda s: None)
        assert isinstance(e.value.__cause__, OSError)

    def test_deadline_stops_early(self):
        clock = {"t": 0.0}

        def always():
            raise OSError("still down")

        with pytest.raises(RetryError, match="deadline"):
            retry_call(
                RetryPolicy(max_attempts=100, backoff_seconds=10.0, jitter=0.0, timeout_seconds=5.0),
                always,
                sleep=lambda s: clock.__setitem__("t", clock["t"] + s),
                clock=lambda: clock["t"],
            )

    def test_kill_is_never_retried(self):
        calls = {"n": 0}

        def dies():
            calls["n"] += 1
            raise InjectedKill("gone")

        with pytest.raises(InjectedKill):
            retry_call(RetryPolicy(max_attempts=5, backoff_seconds=0.0), dies, sleep=lambda s: None)
        assert calls["n"] == 1


class TestDivergenceGuard:
    def test_trips_on_consecutive_skips_only(self):
        g = DivergenceGuard(threshold=3, action="warn")
        assert g.record(True) is None
        assert g.record(True) is None
        assert g.record(False) is None  # clean step resets the streak
        assert g.record(True) is None
        assert g.record(True) is None
        assert g.record(True) == "warn"
        assert g.trips == 1
        assert g.record(True) is None  # streak restarts after a trip


# ---------------------------------------------------------------------------
# checkpoint durability under fault injection
# ---------------------------------------------------------------------------


class TestCheckpointFaults:
    def test_kill_mid_save_never_leaves_loadable_corrupt_tag(self, tmp_path):
        eng = make_engine()
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))  # global_step1, committed
        eng.train_batch(batch(4))
        for site in ("ckpt.save.state", "ckpt.save.meta", "ckpt.commit"):
            with FaultInjector().kill(site), pytest.raises(InjectedKill):
                eng.save_checkpoint(str(tmp_path))
            names = sorted(os.listdir(tmp_path))
            # at most the staging dir of the dead save — no half-written tag
            assert "global_step2" not in names, site
            assert manager.committed_tags(str(tmp_path)) == ["global_step1"], site
        assert "global_step2.tmp" in names
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step1") and eng2.global_steps == 1

    def test_kill_between_commit_and_latest_update(self, tmp_path):
        eng = make_engine()
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))
        eng.train_batch(batch(4))
        with FaultInjector().kill("ckpt.latest"), pytest.raises(InjectedKill):
            eng.save_checkpoint(str(tmp_path))
        # the tag committed; only the pointer update died
        assert sorted(manager.committed_tags(str(tmp_path))) == ["global_step1", "global_step2"]
        assert (tmp_path / "latest").read_text().strip() == "global_step1"
        # latest still resolves to a verified tag — restore is consistent
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step1")
        # with the stale pointer removed, the scan finds the newer tag
        os.remove(tmp_path / "latest")
        eng3 = make_engine(seed=98)
        path, _ = eng3.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step2") and eng3.global_steps == 2

    def test_corrupt_newest_tag_quarantined_and_fallback(self, tmp_path):
        eng = make_engine()
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))
        saved = lnf_g(eng)
        eng.train_batch(batch(4))
        p2 = eng.save_checkpoint(str(tmp_path))
        # truncate a manifest-listed payload file of the newest tag
        rel = sorted(f for f in manifest_files(p2) if f.startswith("state/"))[-1]
        FaultInjector.truncate_file(os.path.join(p2, rel), keep_bytes=1)
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step1") and eng2.global_steps == 1
        assert torch.equal(lnf_g(eng2), saved)
        names = os.listdir(tmp_path)
        assert "global_step2.corrupt" in names and "global_step2" not in names

    def test_missing_meta_json_detected_by_manifest(self, tmp_path):
        eng = make_engine()
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))
        eng.train_batch(batch(4))
        p2 = eng.save_checkpoint(str(tmp_path))
        os.remove(os.path.join(p2, "meta.json"))
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step1")
        assert "global_step2.corrupt" in os.listdir(tmp_path)

    def test_latest_pointing_at_missing_tag_scans_for_newest(self, tmp_path):
        eng = make_engine()
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))
        atomic_write_text(str(tmp_path / "latest"), "global_step999")
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path is not None and path.endswith("global_step1")

    def test_transient_io_error_is_retried(self, tmp_path):
        eng = make_engine()
        eng.train_batch(batch())
        inj = FaultInjector().fail("ckpt.save.state", times=2, exc=InjectedFault)
        with inj:
            path = eng.save_checkpoint(str(tmp_path))
        assert inj.calls("ckpt.save.state") == 3  # two failures + the success
        ok, errors = manager.verify_tag(str(tmp_path), os.path.basename(path))
        assert ok, errors

    def test_foreign_dirs_are_not_tags(self, tmp_path):
        # user dirs under the checkpoint root (logs/, tensorboard/) must
        # never be GC'd by retention nor picked up by the fallback scan
        eng = make_engine(resilience={"checkpoint": {"keep_last_n": 1}})
        logs = tmp_path / "tensorboard"
        logs.mkdir()
        (logs / "events.out").write_bytes(b"precious")
        for i in range(3):
            eng.train_batch(batch(i))
            eng.save_checkpoint(str(tmp_path))
        assert manager.committed_tags(str(tmp_path)) == ["global_step3"]
        assert (logs / "events.out").read_bytes() == b"precious"  # survived GC
        # a stale latest + only-foreign-dirs root returns (None, {}), not a crash
        empty_root = tmp_path / "only_logs"
        (empty_root / "logs").mkdir(parents=True)
        assert load_checkpoint(None, str(empty_root)) == (None, {})

    def test_retention_gc_never_counts_staging_dirs(self, tmp_path):
        for i in range(1, 5):
            d = tmp_path / f"global_step{i}"
            d.mkdir()
            (d / "meta.json").write_text(json.dumps({"global_step": i}))
        for i in (6, 7):
            d = tmp_path / f"global_step{i}.tmp"
            d.mkdir()
            (d / "meta.json").write_text(json.dumps({"global_step": i}))
        deleted = manager.retention_gc(str(tmp_path), keep_last_n=2)
        assert sorted(deleted) == ["global_step1", "global_step2"]
        names = sorted(os.listdir(tmp_path))
        # both staging dirs survived untouched; the two newest tags kept
        assert names == [
            "global_step3", "global_step4", "global_step6.tmp", "global_step7.tmp",
        ]

    def test_retention_gc_protects_tag_with_inflight_stage(self, tmp_path):
        for i in range(1, 4):
            d = tmp_path / f"global_step{i}"
            d.mkdir()
            (d / "meta.json").write_text(json.dumps({"global_step": i}))
        # an async writer owns global_step1's staging dir (re-save in flight)
        manager.begin_stage(str(tmp_path), "global_step1")
        try:
            deleted = manager.retention_gc(str(tmp_path), keep_last_n=1)
            assert deleted == ["global_step2"]  # step1 protected, step3 in window
            assert (tmp_path / "global_step1").is_dir()
        finally:
            manager.abort_stage(str(tmp_path), "global_step1")
        # ownership released: the next sweep may collect it
        assert manager.retention_gc(str(tmp_path), keep_last_n=1) == ["global_step1"]

    def test_begin_stage_refuses_dir_owned_by_inflight_save(self, tmp_path):
        manager.begin_stage(str(tmp_path), "t")
        try:
            with pytest.raises(manager.StageInFlightError):
                manager.begin_stage(str(tmp_path), "t")
        finally:
            manager.abort_stage(str(tmp_path), "t")
        # released (crash-leftover semantics): a fresh save reclaims it
        assert manager.begin_stage(str(tmp_path), "t").endswith("t.tmp")
        manager.abort_stage(str(tmp_path), "t")

    def test_retention_keep_last_n_and_keep_every(self, tmp_path):
        eng = make_engine(resilience={"checkpoint": {"keep_last_n": 2, "keep_every": 3}})
        for i in range(5):
            eng.train_batch(batch(i))
            eng.save_checkpoint(str(tmp_path))
        kept = sorted(manager.committed_tags(str(tmp_path)))
        # newest two (4, 5) plus the keep_every=3 multiple (3)
        assert kept == ["global_step3", "global_step4", "global_step5"]
        assert (tmp_path / "latest").read_text().strip() == "global_step5"
        # restore still works against the pruned tree
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step5") and eng2.global_steps == 5


# ---------------------------------------------------------------------------
# strict loads (engine-free: resolution fails before any state is touched)
# ---------------------------------------------------------------------------


class TestStrictLoad:
    def test_default_returns_none_tuple(self, tmp_path):
        assert load_checkpoint(None, str(tmp_path / "nothing")) == (None, {})

    def test_strict_true_raises_with_config_path_in_message(self, tmp_path):
        with pytest.raises(CheckpointNotFoundError, match="resilience.checkpoint.fail_on_missing"):
            load_checkpoint(None, str(tmp_path), strict=True)

    def test_fail_on_missing_config(self, tmp_path):
        eng = make_engine(resilience={"checkpoint": {"fail_on_missing": True}})
        with pytest.raises(CheckpointNotFoundError):
            eng.load_checkpoint(str(tmp_path / "nothing"))
        # explicit strict=False overrides the config
        assert eng.load_checkpoint(str(tmp_path / "nothing"), strict=False) == (None, {})

    def test_strict_explicit_missing_tag(self, tmp_path):
        with pytest.raises(CheckpointNotFoundError, match="global_step7"):
            load_checkpoint(None, str(tmp_path), tag="global_step7", strict=True)


# ---------------------------------------------------------------------------
# preemption watchdog (SIGTERM → emergency checkpoint → exit code)
# ---------------------------------------------------------------------------


class TestPreemption:
    def test_sigterm_saves_emergency_checkpoint_and_exits_43(self, tmp_path):
        eng = make_engine(
            resilience={"watchdog": {"enabled": True, "grace_seconds": 120, "save_dir": str(tmp_path)}}
        )
        try:
            eng.train_batch(batch())
            os.kill(os.getpid(), signal.SIGTERM)
            with pytest.raises(SystemExit) as e:
                eng.train_batch(batch(4))
            assert e.value.code == 43
            tags = manager.committed_tags(str(tmp_path))
            assert tags == ["global_step2"]
            ok, errors = manager.verify_tag(str(tmp_path), tags[0])
            assert ok, errors
            assert (tmp_path / "latest").read_text().strip() == "global_step2"
            saved = lnf_g(eng)
        finally:
            eng._watchdog.uninstall()
        # scheduler-side restart resumes from the emergency tag
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step2") and eng2.global_steps == 2
        assert torch.equal(lnf_g(eng2), saved)

    def test_expired_grace_deadline_exits_1_without_saving(self, tmp_path):
        eng = make_engine(
            resilience={"watchdog": {"enabled": True, "grace_seconds": 0, "save_dir": str(tmp_path)}}
        )
        try:
            eng.train_batch(batch())
            os.kill(os.getpid(), signal.SIGTERM)
            with pytest.raises(SystemExit) as e:
                eng.train_batch(batch(4))
            assert e.value.code == 1  # "crashed", NOT preempted-and-saved
            assert manager.committed_tags(str(tmp_path)) == []
        finally:
            eng._watchdog.uninstall()

    def test_watchdog_flags_then_escalates_on_repeat(self):
        # a prior handler stands in for the default disposition so the
        # escalation path (second signal → restore + re-deliver) is
        # observable without terminating the test process
        delivered = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: delivered.append(s))
        wd = PreemptionWatchdog(grace_seconds=5.0, signals=(signal.SIGUSR1,)).install()
        try:
            assert not wd.preemption_requested and wd.remaining() == float("inf")
            os.kill(os.getpid(), signal.SIGUSR1)
            assert wd.preemption_requested and wd.signal_name == "SIGUSR1"
            assert 0 < wd.remaining() <= 5.0
            assert delivered == []  # first signal only sets the flag
            os.kill(os.getpid(), signal.SIGUSR1)
            assert wd.repeat_count == 1
            assert delivered == [signal.SIGUSR1]
            assert signal.getsignal(signal.SIGUSR1) is not wd._handle
        finally:
            wd.uninstall()
            signal.signal(signal.SIGUSR1, prev)


# ---------------------------------------------------------------------------
# divergence guard in the engine
# ---------------------------------------------------------------------------


class TestDivergenceInEngine:
    def test_rollback_to_last_verified_checkpoint(self, tmp_path):
        eng = make_engine(
            resilience={"divergence": {"enabled": True, "threshold": 2, "action": "rollback"}}
        )
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))
        saved = lnf_g(eng)
        # two forced "overflow-skipped" steps trip the guard
        with FaultInjector().flag("engine.force_overflow", times=2):
            eng.train_batch(batch(4))
            eng.train_batch(batch(5))
        assert eng.global_steps == 1  # rolled back to the saved tag
        assert torch.equal(lnf_g(eng), saved)
        assert eng._divergence_guard.trips == 1

    def test_guard_fires_on_micro_step_api(self, tmp_path):
        # the reference-style forward/backward/step loop reaches the
        # boundary hook too (not just train_batch)
        eng = make_engine(
            resilience={"divergence": {"enabled": True, "threshold": 2, "action": "warn"}}
        )
        with FaultInjector().flag("engine.force_overflow", times=2):
            for i in range(2):
                loss = eng.forward(batch(i))
                eng.backward(loss)
                eng.step()
        assert eng._divergence_guard.trips == 1

    def test_check_loss_detects_nan_without_dynamic_scaling(self):
        # bf16/fp32 runs have no overflow flag; check_loss is the NaN path
        eng = make_engine(
            resilience={"divergence": {"enabled": True, "threshold": 2, "action": "warn",
                                       "check_loss": True}}
        )
        eng._on_step_boundary(False, loss=torch.tensor(float("nan")))
        eng._on_step_boundary(False, loss=torch.tensor(float("nan")))
        assert eng._divergence_guard.trips == 1
        eng._on_step_boundary(False, loss=torch.tensor(1.0))
        assert eng._divergence_guard.streak == 0

    def test_floor_loss_scale_action(self, tmp_path):
        eng = make_engine(
            fp16=True,
            resilience={"divergence": {"enabled": True, "threshold": 2,
                                       "action": "floor_loss_scale"}},
        )
        eng.train_batch(batch())
        floor_before = eng.loss_scaler.min_scale
        with FaultInjector().flag("engine.force_overflow", times=2):
            eng.train_batch(batch(4))
            eng.train_batch(batch(5))
        assert eng.loss_scaler.min_scale == floor_before / 2.0
        # training continues
        assert np.isfinite(float(eng.train_batch(batch(6))))


def test_step_boundary_site_and_fault_plan_from_the_environment(monkeypatch):
    """``DS_FAULT_PLAN`` arms the engine at construction (as a launcher's
    children are armed) and the ``step.boundary`` site fires after the
    step's bookkeeping."""
    monkeypatch.setenv(faults.DS_FAULT_PLAN_ENV, faults.plan_json(
        [{"site": "step.boundary", "action": "fail", "after": 1}]))
    try:
        eng = make_engine()
        eng.train_batch(batch())
        with pytest.raises(InjectedFault):
            eng.train_batch(batch(4))
        assert eng.global_steps == 2
    finally:
        faults._ACTIVE = None
