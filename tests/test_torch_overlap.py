"""The port's overlap subsystem (deepspeed_tpu_torch.runtime.overlap):
twins of ``tests/test_overlap.py``'s ``TestDevicePrefetcher``,
``TestStepTimeline``, ``TestAsyncCheckpoint``, ``TestAsyncWriterUnit`` and
``TestPreemptionDrain``, on the port's engine on the CPU.

No test here gates on the wall clock.  The JAX twins' "2x steps per s"
and "stall under 20 %" are timing gates that a loaded machine fails; the
same properties are held by counts (batches pulled ahead of the consumer
stay within the pipeline's depth, the consumer's wait is noted as
``data_wait``) and by a commit held open on a gate (the save returns
while its commit is still in flight).
"""
import dataclasses
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2
from deepspeed_tpu_torch.resilience import FaultInjector, InjectedKill, file_digest, manager
from deepspeed_tpu_torch.runtime.overlap import (
    AsyncCheckpointWriter,
    DevicePrefetcher,
    InlineLoader,
    StepTimeline,
)

TINY = dataclasses.replace(gpt2.GPT2_TINY, remat=False)
ASYNC_ON = {"async_checkpoint": {"enabled": True}}


def make_engine(seed=7, overlap=None, resilience=None):
    model_fn, init_fn, _ = gpt2.make_model(TINY)
    config = {
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "steps_per_print": 1000,
        "resilience": {"retry": {"backoff_seconds": 0.0}, **(resilience or {})},
    }
    if overlap is not None:
        config["overlap"] = overlap
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=seed), config=config, device="cpu")
    return engine


def batch(seed=3, bs=4, seq=16):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, TINY.vocab_size, (bs, seq), dtype=np.int32)}


# ---------------------------------------------------------------------------
# DevicePrefetcher (pure host: ordering, errors, bounded run-ahead)
# ---------------------------------------------------------------------------


class TestDevicePrefetcher:
    def test_order_preserved_and_place_applied(self):
        out = list(DevicePrefetcher(range(20), depth=3, place_fn=lambda x: x * 10))
        assert out == [x * 10 for x in range(20)]

    def test_default_place_moves_leaves_to_the_device(self):
        out = list(DevicePrefetcher([{"a": np.arange(3)}], device="cpu"))
        assert isinstance(out[0]["a"], torch.Tensor) and out[0]["a"].tolist() == [0, 1, 2]

    def test_loader_exception_reraised_at_position(self):
        def gen():
            yield 1
            yield 2
            raise RuntimeError("loader died")

        got = []
        with pytest.raises(RuntimeError, match="loader died"):
            for x in DevicePrefetcher(gen(), depth=2, place_fn=lambda x: x):
                got.append(x)
        assert got == [1, 2]

    def test_place_exception_reraised(self):
        def bad_place(x):
            if x == 2:
                raise ValueError("place died")
            return x

        got = []
        with pytest.raises(ValueError, match="place died"):
            for x in DevicePrefetcher(range(5), depth=2, place_fn=bad_place):
                got.append(x)
        assert got == [0, 1]

    def test_consumer_break_shuts_pipeline_down(self):
        pf = DevicePrefetcher(range(1000), depth=2, place_fn=lambda x: x)
        for x in pf:
            if x == 3:
                break
        assert pf._threads == []  # close() ran via the generator finally

    def test_len_passthrough(self):
        assert len(DevicePrefetcher([1, 2, 3])) == 3
        with pytest.raises(TypeError):
            len(DevicePrefetcher(iter([1, 2, 3])))

    def test_sanitizer_keyword_refused(self):
        with pytest.raises(NotImplementedError, match="A15"):
            DevicePrefetcher([1], sanitizer=object())
        with pytest.raises(NotImplementedError, match="A15"):
            InlineLoader([1], lambda x: x, sanitizer=object())

    def test_pipeline_runs_ahead_by_at_most_its_depth(self):
        """The overlap itself, by counts: while the consumer holds a batch,
        the loader and place stages run ahead of it — and never by more
        than the two stages' queues and their one item in hand each."""
        depth, n = 2, 12
        pulled, placed = [], []
        tick = threading.Event()  # never set: a sleep the loop can end early

        def loader():
            for i in range(n):
                pulled.append(i)
                yield i

        def place(x):
            placed.append(x)
            return x

        ahead = []
        for x in DevicePrefetcher(loader(), depth=depth, place_fn=place):
            # give the stages time to fill their queues while we "compute"
            deadline = time.monotonic() + 2.0
            want = min(n, x + 1 + 2 * depth)
            while len(pulled) < want and time.monotonic() < deadline:
                tick.wait(0.005)
            ahead.append(len(pulled) - (x + 1))
        assert max(ahead) >= depth  # the stages really ran ahead of the step
        assert max(ahead) <= 2 * depth + 2
        assert placed == list(range(n))

    def test_timeline_notes_the_consumers_wait_as_data_wait(self):
        """A consumer faster than its loader waits on the queue: the wait
        is noted as data_wait, once per batch, and the step records close
        against it."""
        tl = StepTimeline()
        gate = threading.Semaphore(0)

        def loader():
            for i in range(3):
                gate.acquire()
                yield i

        pf = DevicePrefetcher(loader(), depth=2, place_fn=lambda x: x, timeline=tl)
        it = iter(pf)
        threading.Timer(0.05, gate.release).start()
        assert next(it) == 0
        tl.end_step()
        gate.release()
        gate.release()
        assert list(it) == [1, 2]
        s = tl.summary()
        assert s["steps"] == 1 and s["data_wait_ms"] > 0.0
        assert tl._pending["data_wait"] >= 0.0  # the two later waits, still pending


# ---------------------------------------------------------------------------
# engine integration: prefetch path and the inline fallback
# ---------------------------------------------------------------------------


class TestEnginePrefetch:
    def test_prefetched_losses_match_unprefetched(self):
        batches = [batch(i) for i in range(3)]
        # the CPU embedding backward sums in thread order unless asked not
        # to (tests/test_torch_checkpointing.py); the card's kernel sorts
        torch.use_deterministic_algorithms(True)
        try:
            eng_a = make_engine(seed=11)
            ref = [float(eng_a.train_batch(b)) for b in batches]
            eng_b = make_engine(seed=11)
            out = [float(eng_b.train_batch(b)) for b in eng_b.prefetch_loader(batches)]
        finally:
            torch.use_deterministic_algorithms(False)
        assert out == ref  # the same bits: placement changes nothing
        assert eng_b._train_loader is not None

    def test_prefetch_disabled_config_uses_inline_path(self):
        eng = make_engine(seed=11, overlap={"prefetch": {"enabled": False}})
        loader = eng.prefetch_loader([batch(0), batch(1)])
        assert not isinstance(loader, DevicePrefetcher)
        assert len(loader) == 2  # same interface as the enabled path
        losses = [float(eng.train_batch(b)) for b in loader]
        assert len(losses) == 2 and all(np.isfinite(losses))
        # re-iterable (multi-epoch loops must behave identically A/B)
        assert len(list(loader)) == 2
        # an EXPLICIT depth is a direct API request and wins over the knob
        assert isinstance(eng.prefetch_loader([batch(0)], prefetch_depth=3), DevicePrefetcher)


# ---------------------------------------------------------------------------
# step timeline
# ---------------------------------------------------------------------------


class TestStepTimeline:
    def test_note_and_summary_math(self):
        tl = StepTimeline()
        tl.note("compute", 0.010)
        tl.note("data_wait", 0.004)
        tl.end_step()
        s = tl.summary()
        assert s["steps"] == 1
        assert s["compute_ms"] == pytest.approx(10.0, abs=0.01)
        assert s["data_wait_ms"] == pytest.approx(4.0, abs=0.01)
        assert s["steps_per_s"] > 0
        assert "compute" in tl.format_summary()

    def test_disabled_timeline_records_nothing(self):
        tl = StepTimeline(enabled=False)
        tl.note("compute", 1.0)
        tl.end_step()
        assert tl.summary()["steps"] == 0

    def test_end_step_count_spreads_multi_step_runs(self):
        tl = StepTimeline()
        tl.note("compute", 0.08)
        tl.end_step(count=4)
        s = tl.summary()
        assert s["steps"] == 4
        assert s["compute_ms"] == pytest.approx(20.0, abs=0.01)

    def test_matches_the_jax_timeline(self):
        from deepspeed_tpu.runtime.overlap import StepTimeline as JTimeline

        got, want = StepTimeline(window=3), JTimeline(window=3)
        for tl in (got, want):
            for i in range(5):
                tl.note("data_wait", 0.001 * i)
                tl.note("ckpt_stall", 0.002)
                tl.set_gauge("queue", i)
                tl._last_boundary = None  # wall = the noted phases, clock-free
                tl.end_step(count=1 + i % 2)
        assert got.summary() == want.summary()
        assert got.summary(last_n=2) == want.summary(last_n=2)

    def test_engine_attributes_compute_and_ckpt_stall(self, tmp_path):
        # fence=True opts into the per-step synchronize so the compute
        # phase is recorded
        eng = make_engine(overlap={"timeline": {"fence": True}})
        eng.train_batch(batch())
        s1 = eng.timeline.summary()
        assert s1["steps"] == 1 and s1["compute_ms"] > 0 and s1["data_wait_ms"] > 0
        assert s1["compile_ms"] == 0.0  # eager PyTorch builds no executable
        eng.save_checkpoint(str(tmp_path), async_save=False)
        eng.train_batch(batch(4))  # the save's stall lands on this step
        s2 = eng.timeline.summary(1)
        assert s2["ckpt_stall_ms"] > 0

    def test_unfenced_default_omits_compute_but_keeps_host_phases(self):
        eng = make_engine()
        assert eng._timeline_fence is False
        eng.train_batch(batch())
        s = eng.timeline.summary()
        # no unfenced lie: compute is omitted; host phases still recorded
        assert s["compute_ms"] == 0.0 and s["data_wait_ms"] > 0


# ---------------------------------------------------------------------------
# async checkpointing
# ---------------------------------------------------------------------------


class TestAsyncCheckpoint:
    def test_save_returns_while_the_commit_is_in_flight(self, tmp_path, monkeypatch):
        """The stall property without a clock: the commit is held on a
        gate, yet save_checkpoint returns, training takes a step, and the
        tag that lands is the snapshot's (the step after it changes
        nothing in it)."""
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        gate = threading.Event()
        real_commit = manager.commit_tag

        def held_commit(root, tag):
            assert gate.wait(10.0)
            return real_commit(root, tag)

        monkeypatch.setattr(manager, "commit_tag", held_commit)
        snap = eng.params["lnf_g"].clone()
        path = eng.save_checkpoint(str(tmp_path / "async"))
        assert eng._async_writer.in_flight
        eng.train_batch(batch(4))  # training overwrites the masters in place
        assert not torch.equal(eng.params["lnf_g"], snap)
        gate.set()
        pend = eng._async_writer.drain()
        assert pend.ok, pend.error
        tag = os.path.basename(path)
        ok, notes = manager.verify_tag(str(tmp_path / "async"), tag)
        assert ok, notes
        assert manager.read_latest(str(tmp_path / "async")) == tag
        eng2 = make_engine(seed=99)
        eng2.load_checkpoint(str(tmp_path / "async"))
        assert torch.equal(eng2.params["lnf_g"], snap) and eng2.global_steps == 1

    def test_async_tag_round_trips_into_fresh_engine(self, tmp_path):
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        eng.train_batch(batch(4))
        eng.save_checkpoint(str(tmp_path))
        eng._async_writer.drain()
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step2") and eng2.global_steps == 2

    def test_second_save_drains_first_and_tags_commit_in_order(self, tmp_path):
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))  # in flight
        eng.train_batch(batch(4))
        eng.save_checkpoint(str(tmp_path))  # drains the first, submits the second
        eng._async_writer.drain()
        assert sorted(manager.committed_tags(str(tmp_path))) == ["global_step1", "global_step2"]
        assert manager.read_latest(str(tmp_path)) == "global_step2"
        assert eng._async_writer.completed == 2

    def test_load_checkpoint_drains_inflight_save(self, tmp_path):
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))  # still in flight
        path, _ = eng.load_checkpoint(str(tmp_path))  # must see the committed tag
        assert path is not None and path.endswith("global_step1")

    def test_kill_mid_async_commit_never_publishes_corrupt_tag(self, tmp_path):
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path))
        eng._async_writer.drain()
        eng.train_batch(batch(4))
        inj = FaultInjector().kill("ckpt.commit")
        with inj:
            eng.save_checkpoint(str(tmp_path))
            pend = eng._async_writer.drain()  # surfaces, does not raise
        assert isinstance(pend.error, InjectedKill)
        assert eng._async_writer.last_error is pend.error
        names = sorted(os.listdir(tmp_path))
        # only the dead save's staging dir — no half-written tag
        assert "global_step2" not in names and "global_step2.tmp" in names
        assert manager.committed_tags(str(tmp_path)) == ["global_step1"]
        # `latest` still resolves to the previous verified tag
        eng2 = make_engine(seed=99)
        path, _ = eng2.load_checkpoint(str(tmp_path))
        assert path.endswith("global_step1") and eng2.global_steps == 1
        # recovery: the dead save's stage ownership was released, so a
        # fresh save of the same tag reclaims the leftover and commits
        eng.save_checkpoint(str(tmp_path))
        assert eng._async_writer.drain().ok
        assert sorted(manager.committed_tags(str(tmp_path))) == ["global_step1", "global_step2"]
        assert manager.read_latest(str(tmp_path)) == "global_step2"

    def test_transient_background_failure_absorbed_by_retry(self, tmp_path):
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        inj = FaultInjector().fail("ckpt.save.state", times=2)
        with inj:
            path = eng.save_checkpoint(str(tmp_path))
            pend = eng._async_writer.drain()
        assert pend.ok, pend.error
        assert inj.calls("ckpt.save.state") == 3  # two failures + the success
        ok, notes = manager.verify_tag(str(tmp_path), os.path.basename(path))
        assert ok, notes

    def test_emergency_save_forces_synchronous_path(self, tmp_path):
        # async_save=False must commit before returning (the watchdog's
        # exit-43 contract rides on this)
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        path = eng.save_checkpoint(str(tmp_path), async_save=False)
        assert not eng._async_writer.in_flight
        ok, notes = manager.verify_tag(str(tmp_path), os.path.basename(path))
        assert ok, notes

    def test_sync_and_async_tags_hold_the_same_bytes(self, tmp_path):
        eng = make_engine(overlap=ASYNC_ON)
        eng.train_batch(batch())
        eng.save_checkpoint(str(tmp_path / "sync"), async_save=False)
        eng.save_checkpoint(str(tmp_path / "async"), async_save=True)
        assert eng._async_writer.drain().ok
        digests = [file_digest(str(tmp_path / d / "global_step1" / "state" / "state.pt"))
                   for d in ("sync", "async")]
        assert digests[0] == digests[1]


class TestAsyncWriterUnit:
    def test_submit_while_in_flight_raises(self):
        w = AsyncCheckpointWriter()
        gate = threading.Event()
        w.submit("a", "/tmp/a", gate.wait)
        with pytest.raises(RuntimeError, match="in flight"):
            w.submit("b", "/tmp/b", lambda: None)
        gate.set()
        assert w.drain().ok

    def test_drain_timeout_raises_then_recovers(self):
        w = AsyncCheckpointWriter(drain_timeout_seconds=0.05)
        gate = threading.Event()
        w.submit("a", "/tmp/a", gate.wait)
        with pytest.raises(TimeoutError):
            w.drain()
        gate.set()
        pend = w.drain(timeout=5.0)
        assert pend.ok and pend.finished_at >= pend.started_at
        assert w.completed == 1 and w.failed == 0

    def test_drain_with_nothing_in_flight_is_noop(self):
        assert AsyncCheckpointWriter().drain() is None

    def test_failed_commit_is_counted_and_surfaced_not_raised(self):
        w = AsyncCheckpointWriter()

        def boom():
            raise OSError("disk full")

        w.submit("a", "/tmp/a", boom)
        pend = w.drain()
        assert isinstance(pend.error, OSError) and not pend.ok
        assert w.failed == 1 and w.completed == 0 and w.last_error is pend.error


# ---------------------------------------------------------------------------
# preemption watchdog + async writer: drain-before-exit
# ---------------------------------------------------------------------------


class TestPreemptionDrain:
    def test_sigterm_drains_inflight_save_before_emergency_exit_43(self, tmp_path):
        eng = make_engine(
            overlap=ASYNC_ON,
            resilience={"watchdog": {"enabled": True, "grace_seconds": 120,
                                     "save_dir": str(tmp_path)}},
        )
        try:
            eng.train_batch(batch())
            drained = threading.Event()
            gate = threading.Event()

            def slow_commit():
                gate.wait(10.0)
                drained.set()

            eng._async_writer.submit("fake", str(tmp_path / "fake"), slow_commit)
            os.kill(os.getpid(), signal.SIGTERM)
            threading.Timer(0.1, gate.set).start()
            with pytest.raises(SystemExit) as e:
                eng.train_batch(batch(4))
            assert e.value.code == 43
            # the in-flight save finished BEFORE the emergency save/exit
            assert drained.is_set()
            tags = manager.committed_tags(str(tmp_path))
            assert tags == ["global_step2"]
            ok, notes = manager.verify_tag(str(tmp_path), tags[0])
            assert ok, notes
        finally:
            eng._watchdog.uninstall()

    def test_hung_drain_exits_1_not_43(self, tmp_path):
        eng = make_engine(
            overlap={"async_checkpoint": {"enabled": True, "drain_timeout_seconds": 0.1}},
            resilience={"watchdog": {"enabled": True, "grace_seconds": 120,
                                     "save_dir": str(tmp_path)}},
        )
        gate = threading.Event()
        try:
            eng.train_batch(batch())
            eng._async_writer.submit("hung", str(tmp_path / "hung"), gate.wait)
            os.kill(os.getpid(), signal.SIGTERM)
            with pytest.raises(SystemExit) as e:
                eng.train_batch(batch(4))
            # a save that cannot be certified must NOT exit "preempted-and-saved"
            assert e.value.code == 1
            assert manager.committed_tags(str(tmp_path)) == []
        finally:
            gate.set()
            eng._watchdog.uninstall()


def test_place_stage_errors_are_not_swallowed():
    """No fallback hides the device: a place-stage failure re-raises in
    the consumer at its batch (the engine's place function included)."""
    eng = make_engine()
    pf = eng.prefetch_loader([batch(0), {"input_ids": object()}])
    got = []
    with pytest.raises(TypeError):
        for b in pf:
            got.append(float(eng.train_batch(b)))
    assert len(got) == 1
