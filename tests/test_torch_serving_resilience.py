"""The port's serving resilience (``deepspeed_tpu_torch.serving.journal``,
``watchdog`` and the engine's ``recover()`` / drain) on the CPU, a mirror
of ``tests/test_serving_resilience.py`` held against the JAX package.

* The journal's unit behavior: submit/retire/admit round trip, a torn
  tail dropped and a corrupt middle raising, rotation and compaction,
  compaction on open under a restart loop — and its format: a journal the
  port writes reads in the JAX package to the same incomplete set and
  client keys, and a journal the JAX ``ServingEngine`` writes, killed
  mid-decode, replays in the port engine (weights carried across) to the
  JAX uninterrupted run's greedy tokens.
* An in-process ``InjectedKill`` at the 3rd decode, then ``recover()`` on
  a fresh port engine: the replayed tokens (greedy and seeded sampling)
  equal the uninterrupted run's, and a second ``recover()`` returns [].
* No reuse of journaled ids before ``recover()``; a shed request never
  resurrects after a crash; an expiry by the idle sweep is durable; a
  commit failure quarantines while serving continues; a client key
  dedups across a restart.
* SIGTERM in a subprocess: mid-prefill it drains and exits 43 after the
  journal commits; a commit failure at the drain exits 1; without a
  journal a full drain exits 43 and undone work exits 1.
* ``tools/serving_chaos.py`` on the CPU: a real ``kill -9`` and a real
  SIGTERM on the tiered engine, each replayed bit for bit.

The model is GPT2_TINY with its position table scaled up, f32."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.resilience import faults as jfaults
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving import journal as jjournal
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving import (
    PRIORITY_LOW,
    RequestJournal,
    ServingEngine,
    ServingQueueFull,
)
from deepspeed_tpu_torch.serving import journal as journal_mod
from deepspeed_tpu_torch.serving import scheduler as sched_mod

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TTINY = tgpt2.GPT2_TINY
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(seed=7):
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


@pytest.fixture(scope="module")
def eng():
    return deepspeed_tpu_torch.init_inference(
        model_config=TTINY, params=_params(), dtype=torch.float32, device="cpu",
        max_out_tokens=TTINY.n_positions)


def _prompts(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TTINY.vocab_size, rng.integers(lo, hi + 1), dtype=np.int32)
            for _ in range(n)]


def _srv(eng, tmp_path=None, cls=ServingEngine, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_len", 64)
    if tmp_path is not None:
        kw.setdefault("journal_dir", str(tmp_path / "journal"))
    return cls(eng, **kw)


class _Req:
    """Duck-typed scheduler Request for the journal's unit tests."""

    def __init__(self, rid, prompt=(1, 2, 3), max_new=4, **kw):
        self.request_id = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = max_new
        self.eos_token_id = kw.get("eos")
        self.priority = kw.get("priority", 1)
        self.deadline_seconds = None
        self.do_sample = kw.get("do_sample", False)
        self.temperature = kw.get("temperature", 1.0)
        self.top_k = kw.get("top_k", 0)
        self.seed = kw.get("seed", 0)
        self.generated = kw.get("generated", [])
        self.finish_reason = kw.get("finish_reason")
        self.client_key = kw.get("client_key")
        self.session_id = kw.get("session_id")
        self.tenant = kw.get("tenant")
        self.retry_after = kw.get("retry_after")


# ---------------------------------------------------------------------------
# the journal (no engine)
# ---------------------------------------------------------------------------

def test_journal_submit_retire_incomplete(tmp_path):
    j = RequestJournal(str(tmp_path / "j"))
    for rid in range(4):
        j.record_submit(_Req(rid, prompt=[rid + 1], max_new=3 + rid))
    j.record_retire(_Req(1, finish_reason="length"))
    j.record_retire(_Req(3, finish_reason="eos"))
    j.commit()
    inc = j.incomplete()
    assert [e["id"] for e in inc] == [0, 2]
    assert inc[0]["prompt"] == [1] and inc[0]["max_new"] == 3
    j.record_admit(_Req(2, max_new=2))  # the admit's effective budget wins
    j.commit()
    assert [e["max_new"] for e in j.incomplete()] == [3, 2]
    j.close()


def test_journal_torn_tail_dropped_and_corrupt_middle_raises(tmp_path):
    path = str(tmp_path / "j")
    j = RequestJournal(path)
    j.record_submit(_Req(0))
    j.record_submit(_Req(1))
    j.close()
    seg = os.path.join(path, sorted(os.listdir(path))[0])
    with open(seg, "a") as f:
        f.write('{"t":"submit","id":2,')  # a crash mid-append
    assert [e["id"] for e in journal_mod.incomplete_requests(path)] == [0, 1]
    with open(seg) as f:
        lines = f.readlines()
    lines[0] = lines[0][:-12] + "00000000\n"  # the first record's crc broken
    with open(seg, "w") as f:
        f.writelines(lines)
    with pytest.raises(journal_mod.JournalError, match="not a torn tail"):
        journal_mod.incomplete_requests(path)


def test_journal_rotation_and_compaction_bounded(tmp_path):
    path = str(tmp_path / "j")
    j = RequestJournal(path, segment_records=4, keep_segments=2)
    for rid in range(40):
        j.record_submit(_Req(rid))
        if rid % 2 == 0:
            j.record_retire(_Req(rid, finish_reason="length"))
    j.commit()
    segs = [n for n in os.listdir(path) if n.startswith("wal_")]
    assert len(segs) <= 2 + 2, segs  # keep_segments + compact + active
    odd = [r for r in range(40) if r % 2 == 1]
    assert [e["id"] for e in j.incomplete()] == odd
    j.close()
    j2 = RequestJournal(path, segment_records=4, keep_segments=2)
    assert [e["id"] for e in j2.incomplete()] == odd
    j2.close()


def test_journal_compacts_on_open_under_restart_loop(tmp_path):
    path = str(tmp_path / "j")
    for i in range(12):
        j = RequestJournal(path, segment_records=512, keep_segments=3)
        j.record_submit(_Req(i))
        if i % 2:
            j.record_retire(_Req(i, finish_reason="length"))
        j.close()
    assert len([n for n in os.listdir(path) if n.startswith("wal_")]) <= 3 + 2
    j = RequestJournal(path, segment_records=512, keep_segments=3)
    assert [e["id"] for e in j.incomplete()] == [i for i in range(12) if not i % 2]
    assert j.last_request_id == 11
    j.close()


def test_port_journal_reads_in_the_jax_package(tmp_path):
    """One on-disk format: the port's segments (rotated and compacted,
    with client keys, sessions and tenants) give the JAX package's reader
    the same records, incomplete set and client keys — and the other way
    round."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for J, path in ((RequestJournal, port_dir), (jjournal.RequestJournal, jax_dir)):
        j = J(path, segment_records=3, keep_segments=2)
        for rid in range(10):
            j.record_submit(_Req(rid, prompt=[rid, rid + 1], client_key=f"ck{rid}",
                                 session_id="s" if rid % 3 else None,
                                 tenant="acme" if rid % 2 else None))
            j.record_admit(_Req(rid, max_new=2))
            if rid % 4 == 0:
                j.record_retire(_Req(rid, finish_reason="length", generated=[5, 6]))
            if rid == 5:
                j.record_reject(_Req(rid, finish_reason="shed", retry_after=0.5))
        j.record_drain([1, 2])
        j.close()
    for path in (port_dir, jax_dir):
        assert journal_mod.read_records(path) == jjournal.read_records(path)
        assert journal_mod.incomplete_requests(path) == jjournal.incomplete_requests(path)
        assert journal_mod.client_keys(path) == jjournal.client_keys(path)
    assert journal_mod.read_records(port_dir) == jjournal.read_records(jax_dir)


# ---------------------------------------------------------------------------
# kill mid-decode -> restart -> replay
# ---------------------------------------------------------------------------

def _submit_all(srv, prompts, budgets):
    rids = []
    for i, (p, n) in enumerate(zip(prompts, budgets)):
        # request 2 samples (seeded): replay must reproduce it too
        kw = dict(do_sample=True, temperature=0.9, top_k=8, seed=123) if i == 2 else {}
        rids.append(srv.submit(p, max_new_tokens=n, **kw))
    return rids


def test_kill_mid_decode_restart_replays_bit_identical(eng, tmp_path):
    prompts, budgets = _prompts(5, 4, 20, seed=1), [6, 3, 5, 2, 4]
    ref = _srv(eng)
    rids_ref = _submit_all(ref, prompts, budgets)
    res_ref = ref.drain(max_steps=500)
    expect = [res_ref[r].tokens() for r in rids_ref]

    srv1 = _srv(eng, tmp_path)
    rids1 = _submit_all(srv1, prompts, budgets)
    with pytest.raises(faults.InjectedKill):
        with faults.FaultInjector(seed=0).kill("serving.decode", after=2):
            srv1.drain(max_steps=500)
    finished_before = set(srv1.scheduler._finished)

    srv2 = _srv(eng, tmp_path)  # a fresh engine over the same journal
    replayed = srv2.recover()
    assert replayed and set(replayed) == set(rids1) - finished_before
    assert 2 in [rids1.index(r) for r in replayed]  # the sampled request replays
    res2 = srv2.drain(max_steps=500)
    for rid, exp in zip(rids1, expect):
        if rid in replayed:
            np.testing.assert_array_equal(res2[rid].tokens(), exp)
    assert srv2.recover() == []  # idempotent


def test_jax_journal_replays_in_the_port_to_the_jax_tokens(eng, tmp_path):
    """The JAX ``ServingEngine`` journals, dies mid-decode (its own fault
    injector), and the port engine over the same weights replays its
    journal: the greedy tokens equal the JAX uninterrupted run's."""
    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=_params(),
                                        dtype=jnp.float32, max_out_tokens=JTINY.n_positions)
    prompts, budgets = _prompts(5, 4, 20, seed=11), [6, 3, 5, 2, 4]
    jref = _srv(jeng, cls=JServingEngine)
    ref_ids = [jref.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    res_ref = jref.drain(max_steps=500)
    jsrv = _srv(jeng, tmp_path, cls=JServingEngine)
    ids = [jsrv.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    with pytest.raises(jfaults.InjectedKill):
        with jfaults.FaultInjector(seed=0).kill("serving.decode", after=2):
            jsrv.drain(max_steps=500)
    left = set(ids) - set(jsrv.scheduler._finished)
    srv = _srv(eng, tmp_path)
    replayed = srv.recover()
    assert replayed and set(replayed) == left
    res = srv.drain(max_steps=500)
    for rid, ref_id in zip(ids, ref_ids):
        if rid in replayed:
            np.testing.assert_array_equal(res[rid].tokens(), res_ref[ref_id].tokens())
    assert jjournal.incomplete_requests(str(tmp_path / "journal")) == []  # the port retired them


def test_recover_without_journal_or_empty_is_noop(eng, tmp_path):
    assert _srv(eng).recover() == []
    assert _srv(eng, tmp_path).recover() == []


def test_restart_submit_before_recover_never_reuses_journaled_ids(eng, tmp_path):
    srv = _srv(eng, tmp_path)
    old = srv.submit(_prompts(1, 6, 6, seed=21)[0], max_new_tokens=3)
    sched_mod._REQUEST_IDS._n = -1  # "restart": the id counter starts over...
    srv2 = _srv(eng, tmp_path)  # ...but opening the journal bumps it
    fresh = srv2.submit(_prompts(1, 6, 6, seed=22)[0], max_new_tokens=3)
    assert fresh > old
    srv2.drain(max_steps=300)
    assert old in [e["id"] for e in journal_mod.incomplete_requests(str(tmp_path / "journal"))]
    assert srv2.recover() == [old]
    assert srv2.drain(max_steps=300)[old].finish_reason == "length"


def test_client_key_dedups_across_a_restart(eng, tmp_path):
    srv = _srv(eng, tmp_path)
    p = _prompts(1, 6, 6, seed=24)[0]
    rid = srv.submit(p, max_new_tokens=3, client_key="k-1")
    assert srv.submit(p, max_new_tokens=3, client_key="k-1") == rid
    srv2 = _srv(eng, tmp_path)  # restart: the key is journaled
    assert srv2.client_request_id("k-1") == rid
    assert srv2.recover() == [rid]
    assert srv2.submit(p, max_new_tokens=3, client_key="k-1") == rid
    assert srv2.drain(max_steps=300)[rid].finish_reason == "length"


# ---------------------------------------------------------------------------
# durability of involuntary retirements, quarantine
# ---------------------------------------------------------------------------

def test_shed_then_crash_never_resurrects_shed_requests(eng, tmp_path):
    srv = _srv(eng, tmp_path, num_slots=1, max_queue=8, slo_ttft_ms=0.0,
               degrade_queue_watermark=0.5, degrade_engage_steps=2,
               degrade_disengage_steps=4, degrade_max_new_tokens=2)
    prompts = _prompts(40, 6, 8, seed=23)
    srv.submit(prompts[0], max_new_tokens=24)
    shed_ids = []
    for i, p in enumerate(prompts[1:]):
        try:
            srv.submit(p, max_new_tokens=24, priority=PRIORITY_LOW if i % 2 else 1)
        except ServingQueueFull:
            pass
        srv.step()
        shed_ids = [r.request_id for r in srv.scheduler._finished.values()
                    if r.finish_reason == "shed"]
        if shed_ids:
            break
    assert shed_ids, "the ladder must reach the shed rung"
    assert all(srv.result(r).retry_after > 0 for r in shed_ids)
    del srv  # a crash: no drain, no final commit
    srv2 = _srv(eng, tmp_path, num_slots=1)
    replayed = srv2.recover()
    assert not set(replayed) & set(shed_ids), (replayed, shed_ids)
    res = srv2.drain(max_steps=3000)
    assert all(res[r].finish_reason != "shed" for r in replayed)


def test_expired_via_sweep_is_durable_in_journal(eng, tmp_path):
    srv = _srv(eng, tmp_path, num_slots=1)
    p = _prompts(2, 4, 4, seed=19)
    srv.submit(p[0], max_new_tokens=4)
    srv.step()
    r2 = srv.submit(p[1], max_new_tokens=4, deadline_seconds=1e-9)
    time.sleep(0.002)
    assert srv.stats()["expired"] == 1  # sweep + commit
    assert r2 not in [e["id"] for e in journal_mod.incomplete_requests(str(tmp_path / "journal"))]
    srv.drain(max_steps=200)


def test_journal_commit_failure_quarantines_and_serving_continues(eng, tmp_path):
    srv = _srv(eng, tmp_path)
    p = _prompts(3, 5, 9, seed=17)
    r0 = srv.submit(p[0], max_new_tokens=3)
    with faults.FaultInjector(seed=0).fail("serving.journal.commit"):
        r1 = srv.submit(p[1], max_new_tokens=3)  # the commit fails -> quarantine
    assert srv.stats()["journal"] == "quarantined"
    assert [d for d in os.listdir(tmp_path) if d.startswith("journal.corrupt")]
    assert not os.path.exists(tmp_path / "journal")
    r2 = srv.submit(p[2], max_new_tokens=3)
    res = srv.drain(max_steps=300)
    assert all(res[r].finish_reason == "length" for r in (r0, r1, r2))


# ---------------------------------------------------------------------------
# SIGTERM -> drain -> exit code, in a subprocess
# ---------------------------------------------------------------------------

_SIGTERM_CHILD = textwrap.dedent('''
    import json, os, signal, sys
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.resilience import faults
    from deepspeed_tpu_torch.serving import ServingDraining, ServingEngine

    case, root = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(cfg, seed=7)
    params["wpe"] = params["wpe"] * 40.0
    eng = deepspeed_tpu_torch.init_inference(model_config=cfg, params=params,
                                             dtype=torch.float32, device="cpu",
                                             max_out_tokens=cfg.n_positions)
    journal = case in ("prefill43", "commit_fail1")
    srv = ServingEngine(eng, num_slots=1, prefill_chunk=8, max_len=64,
                        journal_dir=os.path.join(root, "journal") if journal else "")
    rng = __import__("numpy").random.default_rng(3)
    prompt = lambda n: rng.integers(1, cfg.vocab_size, n, dtype="int32")
    note = {}
    if case == "prefill43":
        note["flight"] = srv.submit(prompt(24), max_new_tokens=3)  # 3 chunks of 8
        note["queued"] = srv.submit(prompt(6), max_new_tokens=3)
    elif case == "nojournal1":
        srv.submit(prompt(6), max_new_tokens=2)
        note["queued"] = srv.submit(prompt(6), max_new_tokens=2)
    else:
        srv.submit(prompt(6), max_new_tokens=2)
    srv.install_watchdog(drain_deadline_seconds=0.0 if case == "nojournal1" else 60.0)
    if case != "nojournal1":
        srv.step()  # the first chunk lands: prefill is mid-flight
    os.kill(os.getpid(), signal.SIGTERM)
    try:
        srv.submit(prompt(4), max_new_tokens=2)
    except ServingDraining as e:
        note["draining_retry_after"] = e.retry_after
    with open(os.path.join(root, "note.json"), "w") as f:
        json.dump(note, f)
    if case == "commit_fail1":
        faults.FaultInjector(seed=0).fail("serving.journal.commit", times=99).__enter__()
    while True:
        srv.step()
''')


def _sigterm_child(case, root):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DS_FAULT_PLAN", None)
    proc = subprocess.run([sys.executable, "-c", _SIGTERM_CHILD, case, str(root)], env=env,
                          cwd=REPO, capture_output=True, text=True, timeout=180)
    with open(os.path.join(root, "note.json")) as f:
        return proc, json.load(f)


def test_sigterm_mid_prefill_drains_and_exits_43_after_the_commit(eng, tmp_path):
    """SIGTERM while a 3-chunk prompt is mid-prefill: admission stops
    (ServingDraining with retry_after), the in-flight request finishes,
    the queued one stays durable, and the exit code is 43 after the drain
    record committed; a restarted engine replays the queued request."""
    proc, note = _sigterm_child("prefill43", tmp_path)
    assert proc.returncode == 43, proc.stderr[-2000:]
    assert note["draining_retry_after"] is not None
    jdir = str(tmp_path / "journal")
    assert [e["id"] for e in journal_mod.incomplete_requests(jdir)] == [note["queued"]]
    drains = [r for r in journal_mod.read_records(jdir) if r["t"] == "drain"]
    assert drains and drains[-1]["undone"] == [note["queued"]]
    retired = {r["id"] for r in journal_mod.read_records(jdir) if r["t"] == "retire"}
    assert note["flight"] in retired
    srv = _srv(eng, tmp_path, num_slots=1)
    assert srv.recover() == [note["queued"]]
    assert srv.drain(max_steps=300)[note["queued"]].finish_reason == "length"


def test_sigterm_journal_commit_failure_exits_1(tmp_path):
    proc, _ = _sigterm_child("commit_fail1", tmp_path)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert [d for d in os.listdir(tmp_path) if d.startswith("journal.corrupt")]


@pytest.mark.parametrize("case,code", [("nojournal43", 43), ("nojournal1", 1)])
def test_sigterm_without_journal_full_drain_is_43_undone_is_1(tmp_path, case, code):
    proc, _ = _sigterm_child(case, tmp_path)
    assert proc.returncode == code, proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the chaos tool on the CPU
# ---------------------------------------------------------------------------

def test_serving_chaos_kill9_and_sigterm_on_the_cpu(tmp_path):
    """``tools/serving_chaos.py --device cpu``: a real SIGKILL mid-decode
    and a real SIGTERM mid-drain on the tiered engine, in child processes,
    each replayed bit for bit against an uninterrupted child."""
    from deepspeed_tpu_torch.tools import serving_chaos

    out = serving_chaos.run("cpu", ("kill9", "sigterm"), str(tmp_path))
    assert out["ok"], out["failures"]
    assert out["rcs"]["kill9_victim"] == -9 and out["rcs"]["sigterm_victim"] == 43
    assert out["kill9"]["sampled_replayed"] and out["kill9"]["bit_identical"] == len(
        out["kill9"]["replayed"])
    assert out["sigterm"]["replayed"] and out["sigterm"]["recovered_hits_t2"] >= 1
