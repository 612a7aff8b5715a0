"""The port's tenants (``deepspeed_tpu_torch.serving.frontdoor.tenants``)
and session migration on the CPU, a mirror of ``tests/test_tenants.py``.

* Unit level: the token bucket's exact accounting (``burst + refilled -
  consumed == tokens``) and throttle ``retry_after``, weighted-fair
  queueing (a flooding tenant cannot starve a quiet one; a weight scales
  the share), SLO class → priority, and the ``tenants`` block's
  validation as the JAX package validates it.
* Pool level: a tenant's KV page quota defers its allocation, frees at
  retire and charges fresh pages only; its pinned-prefix quota degrades
  an over-quota pin to an evictable entry.
* Engine level: billing at retire equals ``journal_tenant_totals`` over
  the journal (and the JAX package's reading of the same journal); a
  replay does not charge the bucket again; ``export_sessions`` →
  ``import_sessions`` into a second engine keeps the next turn's tokens
  (solo ``generate()``'s)."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.config.config import TenantsConfig as JTenantsConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving.frontdoor import tenants as jtenants
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, TenantsConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.serving import ServingEngine
from deepspeed_tpu_torch.serving.frontdoor.tenants import (
    DEFAULT_TENANT,
    SLO_CLASSES,
    TenantRegistry,
    TenantThrottled,
    TokenBucket,
    journal_tenant_totals,
)
from deepspeed_tpu_torch.serving.kvcache.pages import PagedKVPool

TTINY = tgpt2.GPT2_TINY


@pytest.fixture(scope="module")
def eng():
    p = jgpt2.init_params(dataclasses.replace(jgpt2.GPT2_TINY, remat=False), seed=7)
    p["wpe"] = p["wpe"] * 40.0
    return deepspeed_tpu_torch.init_inference(
        model_config=TTINY, params=p, dtype=torch.float32, device="cpu",
        max_out_tokens=TTINY.n_positions)


def _registry(**overrides):
    reg = TenantRegistry()
    reg._overrides = overrides
    return reg


def _invariant(b):
    assert b.burst + b.refilled - b.consumed == pytest.approx(b.tokens)


# ---------------------------------------------------------------------------
# token bucket and registry
# ---------------------------------------------------------------------------

def test_token_bucket_refill_caps_at_burst_and_keeps_invariant():
    b = TokenBucket(rate=10.0, burst=20.0)
    b.refill(now=0.0)  # the first touch only stamps the clock
    assert b.tokens == 20.0 and b.refilled == 0.0
    assert b.take(15.0, now=0.0) is None
    _invariant(b)
    b.refill(now=1.0)
    assert b.tokens == pytest.approx(15.0)
    b.refill(now=100.0)  # caps at burst; refilled counts real adds only
    assert b.tokens == pytest.approx(20.0)
    _invariant(b)


def test_token_bucket_take_deficit_returns_refill_time():
    b = TokenBucket(rate=4.0, burst=8.0)
    b.refill(now=0.0)
    assert b.take(6.0, now=0.0) is None
    assert b.take(6.0, now=0.0) == pytest.approx(1.0)  # deficit 4 at 4/s
    assert b.consumed == 6.0  # a failed take consumes nothing
    _invariant(b)
    z = TokenBucket(rate=0.0, burst=4.0)
    z.refill(now=0.0)
    assert z.take(4.0, now=0.0) is None
    assert z.take(1.0, now=1e9) == 60.0  # can never cover: the long hint
    _invariant(z)


def test_registry_throttles_with_retry_after_and_counts():
    reg = _registry(acme={"refill_tokens_per_second": 2.0, "burst_tokens": 10.0})
    reg.admit("acme", cost=8.0, now=0.0)
    with pytest.raises(TenantThrottled) as ei:
        reg.admit("acme", cost=8.0, now=0.0)
    assert ei.value.retry_after == pytest.approx(3.0)  # deficit 6 at 2/s
    snap = reg.snapshot()["acme"]
    assert snap["submitted"] == 2 and snap["throttled"] == 1
    for _ in range(50):  # the default spec 0/0 is unlimited
        reg.admit("quiet", cost=100.0, now=0.0)
    assert reg.snapshot()["quiet"]["throttled"] == 0
    reg.rate_limit_enabled = False  # the kill switch
    for _ in range(10):
        reg.admit("acme", cost=100.0, now=0.0)


def test_priority_for_explicit_wins_then_slo_class():
    reg = _registry(gold={"slo_class": "gold"}, bronze={"slo_class": "bronze"})
    assert reg.priority_for("gold", None) == 0
    assert reg.priority_for("bronze", None) == 2
    assert reg.priority_for("unconfigured", None) == 1  # silver default
    assert reg.priority_for("bronze", 0) == 0
    assert SLO_CLASSES == jtenants.SLO_CLASSES == {"gold": 0, "silver": 1, "bronze": 2}


def _q(tenant, tag, priority=1):
    return SimpleNamespace(tenant=tenant, wfq_tag=tag, priority=priority)


def test_wfq_flooding_tenant_cannot_starve_quiet_one():
    reg = _registry()
    noisy = [_q("noisy", reg.tag("noisy", cost=10.0)) for _ in range(20)]
    quiet = _q("quiet", reg.tag("quiet", cost=10.0))
    queue = noisy + [quiet]  # quiet submitted LAST, behind 20 noisy
    first_two = [queue.pop(reg.pick(queue)) for _ in range(2)]
    assert quiet in first_two
    reg2 = _registry()  # within one tenant: priority first, then FIFO
    a = _q("t", reg2.tag("t", 1.0), priority=1)
    b = _q("t", reg2.tag("t", 1.0), priority=0)
    c = _q("t", reg2.tag("t", 1.0), priority=0)
    assert [a, b, c][reg2.pick([a, b, c])] is b


def test_wfq_weight_scales_fair_share_like_the_jax_registry():
    """weight=2 gets twice the picks over an interleaved backlog, the
    same picks as the JAX package's registry."""
    picks = {}
    for name, Reg in (("port", TenantRegistry), ("jax", jtenants.TenantRegistry)):
        reg = Reg()
        reg._overrides = {"heavy": {"weight": 2.0}}
        queue = []
        for _ in range(6):
            queue.append(_q("heavy", reg.tag("heavy", cost=10.0)))
            queue.append(_q("light", reg.tag("light", cost=10.0)))
        picks[name] = [queue.pop(reg.pick(queue)).tenant for _ in range(9)]
    assert picks["port"] == picks["jax"]
    assert picks["port"].count("heavy") == 6 and picks["port"].count("light") == 3


@pytest.mark.parametrize("bad,match", [
    ({"overrides": {"acme": {"refill_rate": 1.0}}}, "unknown keys"),
    ({"overrides": {"acme": {"slo_class": "platinum"}}}, "slo_class"),
    ({"weight": 0.0}, "weight"),
    ({"slo_class": "tin"}, "slo_class"),
    ({"kv_pages_max": -1}, "kv_pages_max"),
])
def test_tenants_config_rejects_as_the_jax_package(bad, match):
    from deepspeed_tpu.config.config import DeepSpeedConfigError as JError

    with pytest.raises(JError, match=match):
        JTenantsConfig.from_dict(bad)
    with pytest.raises(DeepSpeedConfigError, match=match):
        TenantsConfig.from_dict(bad)


# ---------------------------------------------------------------------------
# kv quotas (pool level)
# ---------------------------------------------------------------------------

class _KReq:
    def __init__(self, rid, prompt, max_new=2, tenant=None):
        self.request_id = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = max_new
        self.session_id = None
        self.tenant = tenant
        self.prefill_pos = 0
        self.prefix_hint = 0
        self.slot = None
        self.generated = []
        self.finish_reason = None


def _pool(**kw):
    kw.setdefault("page_len", 8)
    kw.setdefault("prefill_chunk", 4)
    return PagedKVPool(2, 2, 2, 32, 4, torch.float32, **kw)


def test_kv_page_quota_defers_and_frees_at_retire():
    pool = _pool()
    pool.attach_tenants(_registry(capped={"kv_pages_max": 1}))
    r0 = _KReq("r0", [1, 2, 3, 4, 5, 6], tenant="capped")  # 6 + 2 = one page
    r0.slot = pool.alloc_request(r0)
    assert r0.slot is not None and pool._tenant_pages["capped"] == 1
    r1 = _KReq("r1", [9, 10, 11, 12, 13, 14], tenant="capped")
    assert pool.alloc_request(r1) is None  # over the cap: defers
    assert pool.tenant_quota_defers == 1
    assert pool.tenants.snapshot()["capped"]["quota_defers"] == 1
    r2 = _KReq("r2", [20, 21, 22, 23, 24, 25], tenant="other")
    r2.slot = pool.alloc_request(r2)  # another tenant is unaffected
    assert r2.slot is not None
    pool.retire(r2.slot, r2)
    pool.retire(r0.slot, r0)  # the capped tenant's retire frees its budget
    assert "capped" not in pool._tenant_pages
    r1.slot = pool.alloc_request(r1)
    assert r1.slot is not None
    pool.retire(r1.slot, r1)
    assert pool.stats()["tenant_quota_defers"] == 1


def test_kv_page_quota_charges_only_fresh_pages():
    pool = _pool()
    pool.attach_tenants(_registry(reader={"kv_pages_max": 2}))
    r0 = _KReq("r0", [1, 2, 3, 4, 5, 6, 7, 8], max_new=2, tenant="writer")
    r0.slot = pool.alloc_request(r0)
    pool.learn_prefix(r0)
    pool.retire(r0.slot, r0)
    r1 = _KReq("r1", [1, 2, 3, 4, 5, 6, 7, 8] + [30] * 8, max_new=2, tenant="reader")
    r1.slot = pool.alloc_request(r1)  # the 8-token prefix's page is reused, free
    assert r1.slot is not None and r1.prefix_hint == 8
    assert pool._tenant_pages["reader"] <= 2
    pool.retire(r1.slot, r1)


def test_pinned_prefix_quota_degrades_to_unpinned():
    pool = _pool(pinned_prefixes=[[1, 2, 3, 4], [5, 6, 7, 8]])
    pool.attach_tenants(_registry(pinner={"pinned_prefixes_max": 1}))
    r0 = _KReq("r0", [1, 2, 3, 4, 9, 9], tenant="pinner")
    r0.slot = pool.alloc_request(r0)
    pool.learn_prefix(r0)
    pool.retire(r0.slot, r0)
    assert pool._tenant_pinned["pinner"] == 1
    assert pool.index.lookup(np.array([1, 2, 3, 4, 99])).pinned
    r1 = _KReq("r1", [5, 6, 7, 8, 9, 9], tenant="pinner")
    r1.slot = pool.alloc_request(r1)
    pool.learn_prefix(r1)
    pool.retire(r1.slot, r1)
    assert pool.tenant_pin_rejects == 1 and pool._tenant_pinned["pinner"] == 1
    assert not pool.index.lookup(np.array([5, 6, 7, 8, 99])).pinned


# ---------------------------------------------------------------------------
# engine: billing, the journal, replay, migration
# ---------------------------------------------------------------------------

def _prompt(seed, n=6):
    return np.random.default_rng(seed).integers(1, TTINY.vocab_size, n, dtype=np.int32)


def _srv(eng, **kw):
    return ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64, **kw)


def test_engine_bills_tenants_and_journal_reconciles(eng, tmp_path):
    jdir = str(tmp_path / "journal")
    srv = _srv(eng, journal_dir=jdir, tenants={"enabled": True})
    rids = {}
    for i, tenant in enumerate(["acme", "acme", "globex", None]):
        rid = srv.submit(_prompt(seed=i), max_new_tokens=4, tenant=tenant)
        rids.setdefault(tenant or DEFAULT_TENANT, []).append(rid)
    res = srv.drain(max_steps=3000)
    snap = srv.stats()["tenants"]
    totals = journal_tenant_totals(jdir)
    assert totals == jtenants.journal_tenant_totals(jdir)  # the JAX package's reading
    for tenant, ids in rids.items():
        gen = sum(len(res[r].generated) for r in ids)
        assert snap[tenant]["admitted"] == totals[tenant]["admitted"] == len(ids)
        assert snap[tenant]["billed_tokens"] == totals[tenant]["billed_tokens"] == gen > 0
        assert totals[tenant]["retired"] == len(ids)


def test_slo_class_sets_scheduler_priority(eng):
    srv = _srv(eng, tenants={"enabled": True,
                             "overrides": {"gold_t": {"slo_class": "gold"},
                                           "bronze_t": {"slo_class": "bronze"}}})
    r_gold = srv.submit(_prompt(seed=20), max_new_tokens=2, tenant="gold_t")
    r_bronze = srv.submit(_prompt(seed=21), max_new_tokens=2, tenant="bronze_t")
    r_explicit = srv.submit(_prompt(seed=22), max_new_tokens=2, tenant="bronze_t", priority=0)
    assert srv.scheduler.request(r_gold).priority == 0
    assert srv.scheduler.request(r_bronze).priority == 2
    assert srv.scheduler.request(r_explicit).priority == 0


def test_replay_bypasses_bucket_no_double_charge(eng, tmp_path):
    jdir = str(tmp_path / "journal")
    tenants = {"enabled": True, "overrides": {"acme": {"refill_tokens_per_second": 0.0,
                                                       "burst_tokens": 12.0}}}
    srv1 = _srv(eng, journal_dir=jdir, tenants=tenants)
    rid = srv1.submit(_prompt(seed=30), max_new_tokens=4, tenant="acme")
    with pytest.raises(TenantThrottled):  # 2 of 12 left
        srv1.submit(_prompt(seed=31), max_new_tokens=4, tenant="acme")
    srv1._journal.close()  # "crash": rid never ran
    srv2 = _srv(eng, journal_dir=jdir, tenants=tenants)
    assert srv2.recover() == [rid]
    snap = srv2.tenants.snapshot()["acme"]
    assert snap["replayed"] == 1 and snap["throttled"] == 0
    assert snap["bucket_tokens"] == pytest.approx(12.0)  # not charged again
    assert srv2.drain(max_steps=3000)[rid].finish_reason == "length"


def test_tenant_quota_defers_on_the_engine_and_tokens_equal_solo(eng, tmp_path):
    """A tenant whose cap holds one request at a time waits its turn; the
    other tenant is not deferred; every request's tokens equal solo
    ``generate()``."""
    srv = ServingEngine(eng, num_slots=4, prefill_chunk=8, max_len=64,
                        kvcache={"enabled": True, "page_len": 16, "num_pages": 24},
                        tenants={"enabled": True,
                                 "overrides": {"capped": {"kv_pages_max": 3}}})
    # 14 + 4 tokens: two pages a request, so the cap of 3 holds one at a time
    reqs = [(t, _prompt(seed=40 + i, n=14)) for i in range(3) for t in ("capped", "open")]
    rids = [srv.submit(p, max_new_tokens=4, tenant=t) for t, p in reqs]
    res = srv.drain(max_steps=3000)
    for (t, p), rid in zip(reqs, rids):
        np.testing.assert_array_equal(res[rid].tokens(), eng.generate(p[None], max_new_tokens=4)[0])
    snap = srv.stats()["tenants"]
    assert snap["capped"]["quota_defers"] > 0 and snap["open"]["quota_defers"] == 0


def test_export_import_sessions_next_turn_equal(eng, tmp_path):
    """Sessions (one spilled to disk, one warm) and a pinned prefix export
    from one engine and import into a second; the next turn of each
    session rebinds there and equals solo ``generate()``."""
    kv = {"enabled": True, "page_len": 16, "num_pages": 24, "pinned_prefixes": [[7, 8, 9, 10]],
          "spill_dir": str(tmp_path / "spill_a")}
    a = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64, kvcache=kv)
    hist = {}
    for i, sid in enumerate(("s0", "s1")):
        p = np.concatenate([[7, 8, 9, 10], _prompt(seed=50 + i, n=8)]).astype(np.int32)
        rid = a.submit(p, max_new_tokens=4, session_id=sid)
        hist[sid] = a.drain(max_steps=500)[rid].tokens()
    sess = a.pool.sessions.peek("s0")
    a.pool._spill_or_drop(sess)  # s0 spilled, s1 warm
    assert a.pool.sessions.is_spilled("s0") and a.pool.sessions.peek("s1") is not None
    exported = a.pool.export_sessions(str(tmp_path / "wire"))
    assert sorted(exported) == ["pin:4", "s0", "s1"]
    b = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64,
                      kvcache={**kv, "spill_dir": str(tmp_path / "spill_b")})
    counts = b.pool.import_sessions(str(tmp_path / "wire"))
    assert counts == {"sessions": 2, "pinned": 1, "respilled": 0, "skipped": 0}
    for i, sid in enumerate(("s0", "s1")):
        p = np.concatenate([hist[sid], _prompt(seed=60 + i, n=4)]).astype(np.int32)
        rid = b.submit(p, max_new_tokens=4, session_id=sid)
        got = b.drain(max_steps=500)[rid]
        assert got.prefix_hint > 0
        np.testing.assert_array_equal(got.tokens(), eng.generate(p[None], max_new_tokens=4)[0])
    assert b.stats()["kvcache"]["session_rebinds"] == 2
    assert b.pool.import_sessions(str(tmp_path / "wire"))["skipped"] == 3  # known: skipped
