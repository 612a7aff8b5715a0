"""The port's hierarchical KV tiering (``deepspeed_tpu_torch.serving.kvcache
.tiers``) on the CPU, against the port's all-device paged pool and the JAX
package's tiered engine (a mirror of ``tests/test_kvtiers.py``).

* A tiered 3-turn schedule of several sessions gives the all-device run's
  tokens bit for bit (the same pool shape, the full T0 → T1 → T2 → T0
  cascade exercised), and the JAX tiered engine's tokens.
* The residency window's tail demotes and comes back before the rebind;
  the host cap cascades to disk and a later turn promotes back; prefetch
  hints page disk sessions back in; an idle engine's ``stats()`` and
  ``drain()`` turn the migration queue.
* ``recover()`` trusts only manifest-committed stages (a torn stage is
  invisible, the newest generation wins); a ``tier.demote`` kill mid-flush
  leaves exactly one committed entry, and a 3-turn continuation stays bit
  for bit solo ``generate()``.
* The prefill and decode calls keep one signature each under tier churn,
  a tick's demotions gather in ONE ``index_select`` per leaf, and the
  affinity price discounts host and disk residency.

The model is GPT2_TINY with its position table scaled up, so that page,
slot and position bookkeeping bugs change the generations; greedy tokens
are compared exactly."""
import dataclasses
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving import ServingEngine
from deepspeed_tpu_torch.serving import engine as engine_mod
from deepspeed_tpu_torch.serving.kvcache import PageTierManager

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TTINY = tgpt2.GPT2_TINY


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


def _solo(eng, prompt, max_new):
    return np.asarray(eng.generate(prompt[None, :], max_new_tokens=max_new))[0]


def _kv(tmp_path, tiers=None, **kv):
    """The module's one pool shape; ``tiers=None`` is the all-device
    reference."""
    kv = {"enabled": True, "page_len": 16, "num_pages": 24, **kv}
    if tiers is not None:
        kv["tiers"] = {"enabled": True, "disk_dir": str(tmp_path / "t2"), **tiers}
    return kv


def _tsrv(eng, tmp_path, tiers=None, engine_cls=ServingEngine, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_len", 64)
    return engine_cls(eng, kvcache=_kv(tmp_path, tiers, **kw.pop("kvcache", {})), **kw)


def _turns(srv, n_turns=3, n_sess=3, seed=3, max_new=4):
    """Seeded multi-turn session schedule; returns generated arrays keyed
    by (turn, session)."""
    rng = np.random.default_rng(seed)
    out, hist = {}, {}
    for turn in range(n_turns):
        batch = []
        for s in range(n_sess):
            sid = f"sess-{s}"
            prev = hist.get(sid, np.array([], np.int32))
            prompt = np.concatenate(
                [prev, rng.integers(1, TTINY.vocab_size, 10, dtype=np.int32)]).astype(np.int32)
            rid = srv.submit(prompt, max_new_tokens=max_new, temperature=0.0, session_id=sid)
            batch.append((rid, sid, prompt))
        res = srv.drain(max_steps=2000)
        for rid, sid, prompt in batch:
            gen = np.asarray(res[rid].generated, np.int32)
            hist[sid] = np.concatenate([prompt, gen]).astype(np.int32)
            out[(turn, sid)] = gen
    return out


CASCADE = {"host_pages": 8, "residency_window": 16, "demote_watermark": 0.25,
           "demote_batch": 8}


def test_tiered_multiturn_bit_identical_vs_all_device_and_jax(eng, tmp_path):
    """A device pool a quarter of the working set, host and disk tiers
    absorbing the rest: the all-device run's tokens, and the JAX tiered
    engine's, with the whole demote / promote cascade exercised."""
    ref = _turns(_tsrv(eng, tmp_path / "ref"), n_sess=4)
    srv = _tsrv(eng, tmp_path / "port", tiers=CASCADE)
    got = _turns(srv, n_sess=4)
    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=_params(),
                                        dtype=jnp.float32, max_out_tokens=JTINY.n_positions)
    jsrv = _tsrv(jeng, tmp_path / "jax", tiers=CASCADE, engine_cls=JServingEngine)
    want = _turns(jsrv, n_sess=4)
    assert sorted(got) == sorted(ref) == sorted(want)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=str(key))
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    st = srv.stats()["kvcache"]["tiers"]
    assert st["demote_t0_t1"] > 0 and st["demote_t1_t2"] > 0, st
    assert st["promote_t1_t0"] + st["promote_t2_t0"] > 0, st
    assert st["hits_t1"] + st["hits_t2"] > 0, st
    assert st["gather_ms"] is None and st["gather_pages"] == 0  # no card: not measured
    srv._tiers.close()
    jsrv._tiers.close()


def test_call_shapes_fixed_under_tier_churn(eng, tmp_path, monkeypatch):
    """Tiering rewrites the page tables in place between steps: every
    prefill call and every decode call keeps one signature."""
    sigs = {"prefill": set(), "decode": set()}
    real = engine_mod.forward_with_cache

    def spy(params, toks, k, v, pos, icfg, **kw):
        table = kw.get("page_table")
        sig = (tuple(toks.shape), tuple(pos.shape), None if table is None else
               (tuple(table.shape), table.dtype))
        sigs["prefill" if toks.shape[0] == 1 and toks.shape[1] > 1 else "decode"].add(sig)
        return real(params, toks, k, v, pos, icfg, **kw)

    monkeypatch.setattr(engine_mod, "forward_with_cache", spy)
    srv = _tsrv(eng, tmp_path, tiers=CASCADE)
    _turns(srv, n_sess=4, seed=91)
    st = srv.stats()["kvcache"]["tiers"]
    assert st["demote_t0_t1"] > 0 and st["demote_t1_t2"] > 0, st
    assert len(sigs["prefill"]) == 1 and len(sigs["decode"]) == 1, sigs
    srv._tiers.close()


def test_a_ticks_demotions_gather_in_one_index_select_per_leaf(eng, tmp_path, monkeypatch):
    """Several sessions demoted in one tick: one ``_gather_pinned`` call
    over all their pages (one ``index_select`` per cache leaf), each entry
    a view of its own pages, bit for bit the pages it left."""
    srv = _tsrv(eng, tmp_path, tiers={"demote_batch": 8})
    _turns(srv, n_turns=1, n_sess=3, seed=5)
    warm = {s.session_id: srv.pool._gather_host(s.pages) for s in srv.pool.sessions.warm()}
    assert len(warm) == 3
    calls = []
    real = srv.pool._gather_pinned
    monkeypatch.setattr(srv.pool, "_gather_pinned", lambda pages: calls.append(list(pages))
                        or real(pages))
    srv._tiers.demote_watermark = 0.01
    srv._tiers.tick(time.monotonic())
    assert len(calls) == 1, calls
    for sid, leaves in warm.items():
        e = srv._tiers._entries[f"sess:{sid}"]
        for k in leaves:
            assert torch.equal(e.leaves[k], leaves[k]), (sid, k)
    srv._tiers.close()


def test_tail_residency_window_demote_and_rebind(eng, tmp_path):
    """A parked session keeps only its residency window on the device; the
    tier manager holds the tail and pages it back in ahead of the rebind
    — turn 2 still equals solo ``generate()``."""
    srv = _tsrv(eng, tmp_path, tiers={"residency_window": 16, "demote_batch": 4})
    p1 = _prompts(1, 30, 30, seed=11)[0]
    r1 = srv.submit(p1, max_new_tokens=4, temperature=0.0, session_id="s")
    t1 = np.asarray(srv.drain(max_steps=500)[r1].tokens())
    np.testing.assert_array_equal(t1, _solo(eng, p1, 4))
    for _ in range(6):  # idle ticks trim the parked tail
        srv.stats()
    assert srv.pool.stats()["tiers"]["tail_demotions"] >= 1
    assert srv._tiers.has_tail("s")
    p2 = np.concatenate([t1, _prompts(1, 4, 4, seed=12)[0]])
    r2 = srv.submit(p2, max_new_tokens=4, temperature=0.0, session_id="s")
    np.testing.assert_array_equal(srv.drain(max_steps=500)[r2].tokens(), _solo(eng, p2, 4))
    assert srv.pool.stats()["tiers"]["tail_promotions"] >= 1
    assert srv.stats()["kvcache"]["session_rebinds"] == 1
    srv._tiers.close()


def test_idle_engine_stats_and_drain_tick_migrations(eng, tmp_path):
    """A quiescent engine still drains pending demotions: only ``stats()``
    and an empty ``drain()`` move the pages, down to disk."""
    srv = _tsrv(eng, tmp_path, tiers={"host_pages": 2, "demote_batch": 2})
    _turns(srv, n_turns=1, n_sess=4, seed=21)
    before = srv.pool.stats()["tiers"]
    srv._tiers.demote_watermark = 0.1
    for _ in range(8):
        srv.stats()
    mid = srv.pool.stats()["tiers"]
    assert mid["demote_t0_t1"] > before["demote_t0_t1"], (before, mid)
    srv.drain()
    srv._tiers._worker.drain(10.0)
    srv.stats()
    assert srv.pool.stats()["tiers"]["demote_t1_t2"] > 0
    srv._tiers.close()


def test_host_cap_cascades_to_disk_and_promotes_back(eng, tmp_path):
    """T1 over ``host_pages`` pushes LRU entries to T2; a later turn of the
    disk-resident session pages it back (a T2 hit) bit for bit."""
    srv = _tsrv(eng, tmp_path, tiers={"host_pages": 1, "demote_batch": 8})
    p1 = _prompts(1, 12, 12, seed=31)[0]
    r1 = srv.submit(p1, max_new_tokens=4, temperature=0.0, session_id="cold")
    t1 = np.asarray(srv.drain(max_steps=500)[r1].tokens())
    srv._tiers.flush(time.monotonic())  # every warm session -> T1 -> T2
    assert srv.pool.stats()["tiers"]["disk_entries"] >= 1
    assert not srv.pool.sessions.warm()
    p2 = np.concatenate([t1, _prompts(1, 4, 4, seed=32)[0]])
    r2 = srv.submit(p2, max_new_tokens=4, temperature=0.0, session_id="cold")
    np.testing.assert_array_equal(srv.drain(max_steps=500)[r2].tokens(), _solo(eng, p2, 4))
    st = srv.pool.stats()["tiers"]
    assert st["hits_t2"] >= 1, st
    assert srv.stats()["kvcache"]["session_rebinds"] == 1
    srv._tiers.close()


def test_flush_writes_more_entries_than_the_worker_queue_holds(eng, tmp_path, monkeypatch):
    """The drain's flush leaves nothing in host memory even when its disk
    writes outnumber the migration worker's queue (one slot here, each
    write slowed): the rest go in rounds."""
    from deepspeed_tpu_torch.runtime.overlap.worker import BoundedWorker

    srv = _tsrv(eng, tmp_path, tiers={"host_pages": 64})
    _turns(srv, n_turns=1, n_sess=4, seed=45)
    tiers = srv._tiers
    tiers._worker.close()
    tiers._worker = BoundedWorker(name="one-slot", depth=1)
    real = tiers._write_t2
    monkeypatch.setattr(tiers, "_write_t2", lambda *a: time.sleep(0.02) or real(*a))
    assert tiers.flush(time.monotonic()) == 4
    st = tiers.stats()
    assert st["host_entries"] == 0 and st["disk_entries"] >= 4, st
    tiers.close()


def test_worker_drain_waits_for_a_job_it_has_taken():
    """``BoundedWorker.drain`` (the flush's wait) returns only after every
    job has run, even one the thread has taken off the queue and not yet
    begun (the window is widened here by a slow queue ``get``)."""
    import queue

    from deepspeed_tpu_torch.runtime.overlap.worker import BoundedWorker

    class SlowTake(queue.Queue):
        def get(self, *a, **kw):
            item = super().get(*a, **kw)
            time.sleep(0.2)  # taken, not yet begun
            return item

    w = BoundedWorker(name="slow-take", depth=4)
    w._q = SlowTake(maxsize=4)
    done = []
    assert w.submit(lambda: done.append(1))
    while w._q.qsize():
        time.sleep(0.001)
    assert w.drain(5.0) and done == [1]
    assert w.pending() == 0
    w.close()


def test_recover_ignores_torn_stage_keeps_committed(eng, tmp_path):
    srv = _tsrv(eng, tmp_path, tiers={"host_pages": 1})
    p1 = _prompts(1, 12, 12, seed=41)[0]
    srv.submit(p1, max_new_tokens=4, temperature=0.0, session_id="good")
    srv.drain(max_steps=500)
    srv._tiers.flush(time.monotonic())
    srv._tiers.close()
    t2 = tmp_path / "t2"
    assert [d for d in os.listdir(t2) if d.startswith("sess_")]
    # a hand-built torn stage: payload + meta, no manifest
    torn = t2 / "sess_deadbeefdeadbeef-g99"
    torn.mkdir()
    np.savez(torn / "kv.npz", x=np.zeros(2))
    (torn / "meta.json").write_text(
        '{"kind": "session", "session_id": "torn", "tokens": [1, 2, 3], "leaf_dtypes": {}}')
    srv2 = _tsrv(eng, tmp_path, tiers={"host_pages": 1})
    found = srv2.pool.recover()
    assert "sess:good" in found and all("torn" not in k for k in found), found
    assert srv2._tiers.has_session("good") and not srv2._tiers.has_session("torn")
    srv2._tiers.close()


def test_recover_newest_generation_wins(eng, tmp_path):
    pool = _tsrv(eng, tmp_path).pool
    mgr = PageTierManager(pool, disk_dir=str(tmp_path / "gens"))
    old = {"kind": "session", "session_id": "s", "tokens": [1, 2], "parked_at": 1.0}
    new = {"kind": "session", "session_id": "s", "tokens": [1, 2, 3, 4], "parked_at": 2.0}
    leaves = {"L0.k": torch.zeros((1, 16, 2, 4))}
    mgr._write_t2("sess_aaaaaaaaaaaaaaaa-g1", old, leaves)
    mgr._write_t2("sess_aaaaaaaaaaaaaaaa-g2", new, leaves)
    assert mgr.recover() == ["sess:s"]
    e = mgr._entries["sess:s"]
    assert e.dir_name.endswith("-g2") and e.tokens.shape[0] == 4
    assert sorted(os.listdir(tmp_path / "gens")) == ["sess_aaaaaaaaaaaaaaaa-g2"]
    assert mgr._dirgen >= 2  # fresh writes never collide with survivors
    mgr.close()


def test_tier_demote_kill_mid_flush_one_committed_continuation_bit_identical(eng, tmp_path):
    """The ``tier.demote`` site sits between the staged payload and the
    manifest: session A's demotion commits, the kill tears B's.  A fresh
    engine over the same dirs trusts only A; three more turns of both
    equal solo ``generate()`` (A rebinds off T2, B re-prefills)."""
    seeds = {"a": 51, "b": 52}
    hist = {name: _solo(eng, _prompts(1, 12, 12, seed=s)[0], 4) for name, s in seeds.items()}

    def build():
        return _tsrv(eng, tmp_path, tiers={"host_pages": 1, "demote_batch": 8})

    srv1 = build()
    for name, seed in seeds.items():
        r = srv1.submit(_prompts(1, 12, 12, seed=seed)[0], max_new_tokens=4,
                        temperature=0.0, session_id=name)
        np.testing.assert_array_equal(srv1.drain(max_steps=500)[r].tokens(), hist[name])
    with pytest.raises(faults.InjectedKill):
        with faults.FaultInjector(seed=0).kill("tier.demote", after=1):
            srv1._tiers.flush(time.monotonic())
    srv1._tiers.close()
    committed = [d for d in os.listdir(tmp_path / "t2")
                 if os.path.exists(tmp_path / "t2" / d / "manifest.json")]
    assert len(committed) == 1, committed

    srv2 = build()
    found = srv2.pool.recover()
    assert len([k for k in found if k.startswith("sess:")]) == 1, found
    for turn in range(3):
        for name, seed in seeds.items():
            p = np.concatenate([hist[name], _prompts(1, 4, 4, seed=seed + 10 * turn)[0]])
            r = srv2.submit(p, max_new_tokens=4, temperature=0.0, session_id=name)
            got = np.asarray(srv2.drain(max_steps=500)[r].tokens())
            np.testing.assert_array_equal(got, _solo(eng, p, 4))
            hist[name] = got
    st = srv2.pool.stats()["tiers"]
    assert st["hits_t1"] + st["hits_t2"] >= 1, st  # A's committed entry was used
    srv2._tiers.close()


def test_prefetch_hints_page_disk_sessions_back_in(eng, tmp_path):
    """Every session flushed to disk and more submissions than slots: the
    step-boundary tick sees the queued tail as hints and prefetches those
    sessions off T2 before their prefill runs; tokens are unchanged."""
    srv = _tsrv(eng, tmp_path, tiers={"host_pages": 1, "prefetch_ahead": 4})
    first = _turns(srv, n_turns=1, n_sess=4, seed=71)
    srv._tiers.flush(time.monotonic())
    assert srv.pool.stats()["tiers"]["disk_entries"] >= 3
    got = _turns(srv, n_turns=1, n_sess=4, seed=71)
    for key in first:
        np.testing.assert_array_equal(got[key], first[key], err_msg=str(key))
    st = srv.pool.stats()["tiers"]
    assert st["prefetch_jobs"] >= 1 and st["hits_t1"] + st["hits_t2"] >= 1, st
    srv._tiers.close()


def test_affinity_tokens_price_residency(eng, tmp_path):
    """The same cached session is worth 1.0x on the device, 0.75x in host
    memory, 0.5x on disk; the unpriced hint keeps the full hit."""
    srv = _tsrv(eng, tmp_path, tiers={"host_pages": 8})
    p1 = _prompts(1, 16, 16, seed=81)[0]
    r1 = srv.submit(p1, max_new_tokens=4, temperature=0.0, session_id="s")
    t1 = np.asarray(srv.drain(max_steps=500)[r1].tokens())
    probe = np.concatenate([t1, _prompts(1, 6, 6, seed=82)[0]])
    warm_aff = srv.pool.affinity_tokens(probe, session_id="s")
    assert warm_aff > 0 and warm_aff == srv.pool.prefix_hint_tokens(probe, session_id="s")
    sess = next(s for s in srv.pool.sessions.warm() if s.session_id == "s")
    with srv.pool._lock:
        assert srv._tiers.demote_session(sess, time.monotonic())
        for e in list(srv.pool.index.entries()):
            srv.pool.index.remove(e)
            srv.pool._page_decref(e.pages)
    assert srv.pool.affinity_tokens(probe, session_id="s") == pytest.approx(0.75 * warm_aff)
    srv._tiers.flush(time.monotonic())
    srv.stats()
    assert srv.pool.stats()["tiers"]["disk_entries"] >= 1
    assert srv.pool.affinity_tokens(probe, session_id="s") == pytest.approx(0.5 * warm_aff)
    assert srv.pool.prefix_hint_tokens(probe, session_id="s") == warm_aff
    srv._tiers.close()
