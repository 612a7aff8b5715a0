"""The port's paged KV serving (deepspeed_tpu_torch.serving.kvcache and the
paged branches of the ops and the engine) against the JAX package's, on
the CPU.

* The page pools of both packages are driven side by side over one seeded
  sequence of ``alloc_request`` / ``consume_cow`` / ``learn_prefix`` /
  ``retire`` / ``sweep`` calls; slots, COW pairs, tables, refcounts and
  ``stats()`` must be equal after every call, and the port's pool must
  pass the leak check of ``tests/test_kvcache.py``.
* ``paged_cache_write``, ``paged_gather`` and ``paged_cache_attention``
  against JAX's, and the paged decode's plain version against JAX's
  ``flash_decode_paged`` kernel in interpret mode.  Tolerances: 2e-5 for
  f32 and int8 (codes are bit-equal on both sides, the arithmetic is f32
  in other summation orders); writes and gathers move values, so they
  are compared exactly.
* ``forward_with_cache(page_table=...)`` against the slot-pool form of the
  port (1e-6: the gathered view holds the same values at every
  attendable position, masked keys weigh exactly 0).
* End to end, greedy tokens of the port's paged ServingEngine equal the
  JAX paged engine's, the port's slot engine's and solo ``generate()``,
  with the JAX engine's kvcache counters, over shared-prefix traffic with
  copy-on-write, a pinned prefix, a 3-turn session and a spill → restore.

The model is GPT2_TINY with its position table scaled up, so that page,
slot and position bookkeeping bugs change the generations."""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.kernels import flash_decode as jfd
from deepspeed_tpu.ops.transformer import inference as jinf
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu.serving.kvcache import PagedKVPool as JPagedKVPool
from deepspeed_tpu.serving.kvcache import PrefixEntry as JPrefixEntry
from deepspeed_tpu.serving.kvcache import PrefixIndex as JPrefixIndex
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.kernels import flash_decode as tfd
from deepspeed_tpu_torch.ops.transformer import inference as tinf
from deepspeed_tpu_torch.serving import PagedKVPool, ServingEngine
from deepspeed_tpu_torch.serving.kvcache import GARBAGE_PAGE, PrefixEntry, PrefixIndex

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TTINY = tgpt2.GPT2_TINY
TOL = 2e-5


def _params(seed=7):
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


@pytest.fixture(scope="module")
def engines():
    """(JAX InferenceEngine, port InferenceEngine) over the same weights,
    shared by the module's engine-level tests."""
    params = _params()
    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=params, dtype=jnp.float32,
                                        max_out_tokens=JTINY.n_positions)
    teng = deepspeed_tpu_torch.init_inference(model_config=TTINY, params=params,
                                              dtype=torch.float32, device="cpu",
                                              max_out_tokens=TTINY.n_positions)
    return jeng, teng


def _prompts(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TTINY.vocab_size, rng.integers(lo, hi + 1), dtype=np.int32)
            for _ in range(n)]


class _KReq:
    """Duck-typed scheduler Request for pool-level tests."""

    def __init__(self, rid, prompt, max_new=4, sid=None):
        self.request_id = rid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = max_new
        self.session_id = sid
        self.prefill_pos = 0
        self.prefix_hint = 0
        self.slot = None
        self.generated = []
        self.finish_reason = None


def _accounted_pages(pool):
    pages = set()
    for e in pool.index.entries():
        pages.update(e.pages)
    for s in pool.sessions.warm():
        pages.update(s.pages)
    for ps in pool._slot_pages.values():
        pages.update(ps)
    return pages


def _assert_no_leaks(pool):
    """The leak check of tests/test_kvcache.py: every live page is held by
    an index entry, a parked session or a mapped slot, and only those."""
    acc = _accounted_pages(pool)
    assert pool.pages_live == len(acc), (
        f"pages_live={pool.pages_live} but only {len(acc)} pages are "
        "accounted for by entries/sessions/slots (leak or double-free)"
    )
    for p in range(1, pool.num_pages):
        assert (pool.refcount(p) > 0) == (p in acc), f"page {p} refcount drift"


# ---------------------------------------------------------------------------
# host bookkeeping: the pools and the radix index side by side
# ---------------------------------------------------------------------------

def _assert_pools_equal(jp, tp):
    np.testing.assert_array_equal(jp.tables(), tp.tables())
    np.testing.assert_array_equal(jp._ref, tp._ref)
    assert jp.stats() == tp.stats()
    assert sorted(jp._slot_pages.items()) == sorted(tp._slot_pages.items())
    _assert_no_leaks(tp)


@pytest.mark.parametrize("seed,spill", [(0, False), (1, True), (2, False), (3, True)])
def test_pool_bookkeeping_matches_jax_step_by_step(seed, spill, tmp_path):
    rng = np.random.default_rng(seed)
    kw = dict(page_len=8, prefill_chunk=4, num_pages=12, session_ttl_seconds=6.0,
              pinned_prefixes=[[5, 6, 7, 8, 9]])
    jp = JPagedKVPool(2, 3, 2, 32, 4, jnp.float32,
                      spill_dir=str(tmp_path / "j") if spill else None, **kw)
    tp = PagedKVPool(2, 3, 2, 32, 4, torch.float32,
                     spill_dir=str(tmp_path / "t") if spill else None, **kw)
    prefixes = [np.array([5, 6, 7, 8, 9, 10, 11], np.int32),
                np.arange(20, 31, dtype=np.int32), np.array([40, 41], np.int32)]
    history = {}  # session id -> the last turn's prompt + generated
    live = {}
    now = 0.0
    for i in range(70):
        now += 1.0
        op = rng.choice(["admit", "admit", "retire", "sweep"])
        if op == "admit":
            sid = rng.choice(["chat-a", "chat-b", None])
            if sid is not None and 0 < len(history.get(sid, ())) <= 18:
                base = history[sid]
            else:
                base = prefixes[rng.integers(len(prefixes))]
            prompt = np.concatenate([base, rng.integers(50, 90, int(rng.integers(1, 6)))])
            prompt = prompt.astype(np.int32)
            max_new = int(rng.integers(2, 7))
            reqs = [_KReq(f"r{i}", prompt, max_new, sid) for _ in range(2)]
            slots = [p.alloc_request(r, now=now) for p, r in zip((jp, tp), reqs)]
            assert slots[0] == slots[1]
            assert reqs[0].prefill_pos == reqs[1].prefill_pos
            if slots[0] is not None:
                for r in reqs:
                    r.slot = slots[0]
                assert jp.consume_cow(slots[0]) == tp.consume_cow(slots[0])
                assert tp.consume_cow(slots[0]) == (GARBAGE_PAGE, GARBAGE_PAGE)  # consumed
                jp.consume_cow(slots[0])
                jp.learn_prefix(reqs[0], now=now)
                tp.learn_prefix(reqs[1], now=now)
                live[f"r{i}"] = reqs
        elif op == "retire" and live:
            rid = sorted(live)[int(rng.integers(len(live)))]
            reqs = live.pop(rid)
            gen = [int(t) for t in rng.integers(50, 90, reqs[0].max_new_tokens)]
            reason = rng.choice(["length", "eos", "cancelled"])
            for p, r in zip((jp, tp), reqs):
                r.generated, r.finish_reason = list(gen), str(reason)
                p.retire(r.slot, r, now=now)
            if reqs[0].session_id is not None and reason != "cancelled":
                history[reqs[0].session_id] = np.concatenate([reqs[0].prompt, gen]).astype(np.int32)
        elif op == "sweep":
            assert jp.sweep(now) == tp.sweep(now)
        _assert_pools_equal(jp, tp)
    st = tp.stats()
    assert st["prefix_hits"] > 0 and st["cow_copies"] > 0 and st["session_rebinds"] > 0
    assert st["evictions"] + st["session_drops"] + st["session_spills"] > 0


def test_prefix_index_matches_jax():
    keys = [[1, 2, 3], [1, 2, 3, 4, 5], [1, 2, 9], [7, 7], [1, 2, 3, 4, 6, 6]]
    ji, ti = JPrefixIndex(), PrefixIndex()
    for n, key in enumerate(keys):
        a = ji.insert(JPrefixEntry(tokens=np.array(key), pages=[n], last_used=float(n % 3)))
        b = ti.insert(PrefixEntry(tokens=np.array(key), pages=[n], last_used=float(n % 3)))
        assert a.pages == b.pages
    for q in ([1, 2, 3, 4, 5, 9], [1, 2, 3, 4, 6], [1, 2, 9, 9], [7], [8], [1, 2, 3, 4, 6, 6, 1]):
        a, b = ji.lookup(np.array(q), now=5.0), ti.lookup(np.array(q), now=5.0)
        assert (a is None) == (b is None) and (a is None or a.pages == b.pages)
        assert ji.common_prefix_len(np.array(q)) == ti.common_prefix_len(np.array(q))
    assert ji.remove(ji.get(np.array([1, 2, 3]))) and ti.remove(ti.get(np.array([1, 2, 3])))
    assert [e.pages for e in ji.evict_candidates()] == [e.pages for e in ti.evict_candidates()]
    assert len(ji) == len(ti) == 4


# ---------------------------------------------------------------------------
# paged cache ops and the paged decode's plain version
# ---------------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pools(kv, k, v):
    """(jax k, jax v, torch k, torch v) page pools; int8 pools are
    quantized on each side by its own _kv_quant."""
    if kv == "int8":
        jk, jv = (dict(zip(("q", "s"), jinf._kv_quant(jnp.asarray(a)))) for a in (k, v))
        tk, tv = (dict(zip(("q", "s"), tinf._kv_quant(torch.from_numpy(a)))) for a in (k, v))
        return jk, jv, tk, tv
    return jnp.asarray(k), jnp.asarray(v), torch.from_numpy(k), torch.from_numpy(v)


def _as_np(c):
    if isinstance(c, dict):
        return {n: _as_np(a) for n, a in c.items()}
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _assert_same(j, t, tol=0.0):
    j, t = _as_np(j), _as_np(t)
    if isinstance(j, dict):
        for n in j:
            _assert_same(j[n], t[n], tol)
        return
    if tol:
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("masked", [False, True])
def test_paged_cache_write_matches_jax(kv, masked):
    NP, H, page_len, d, B, T = 9, 2, 8, 4, 3, 5
    table = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0]], np.int32)
    pos = np.array([3, 9, 0], np.int32)
    t = _rand((B, H, T, d), 1)
    jk, _, tk, _ = _pools(kv, _rand((NP, H, page_len, d), 2), _rand((NP, H, page_len, d), 3))
    mask = np.array([True, False, True]) if masked else None
    jt = jnp.asarray(t)
    ref = jinf.paged_cache_write(jk, jt, jnp.asarray(table), jnp.asarray(pos),
                                 None if mask is None else jnp.asarray(mask))
    got = tinf.paged_cache_write(tk, torch.from_numpy(t), torch.from_numpy(table),
                                 torch.from_numpy(pos),
                                 None if mask is None else torch.from_numpy(mask))
    assert got is tk  # in place
    if masked:  # the redirected rows' duplicate writes on page 0 are garbage
        ref = {n: a[1:] for n, a in ref.items()} if kv == "int8" else ref[1:]
        got = {n: a[1:] for n, a in got.items()} if kv == "int8" else got[1:]
    _assert_same(ref, got)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_gather_matches_jax(kv):
    jk, _, tk, _ = _pools(kv, _rand((7, 2, 8, 4), 4), _rand((7, 2, 8, 4), 5))
    table = np.random.default_rng(6).permutation(np.arange(1, 7, dtype=np.int32)).reshape(2, 3)
    _assert_same(jinf.paged_gather(jk, jnp.asarray(table)),
                 tinf.paged_gather(tk, torch.from_numpy(table)))


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_paged_cache_attention_matches_jax(kv, T):
    B, H, P, page_len, d = 2, 3, 3, 16, 8
    NP = 1 + B * P
    jk, jv, tk, tv = _pools(kv, _rand((NP, H, page_len, d), 7), _rand((NP, H, page_len, d), 8))
    q = _rand((B, H, T, d), 9)
    table = np.random.default_rng(10).permutation(np.arange(1, NP, dtype=np.int32)).reshape(B, P)
    table[1, 2] = 0  # an unmapped entry: the garbage page, behind the mask
    pos = np.array([20, 9], np.int32)
    ref = jinf.paged_cache_attention(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
                                     use_kernel=False)
    got = tinf.paged_cache_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(table),
                                     torch.from_numpy(pos))
    _assert_same(ref, got, TOL)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_flash_decode_paged_plain_matches_jax_kernel_interpreted(kv):
    """The shape of tests/test_kvcache.py's kernel parity test: page_len
    128, a permuted table, ragged positions."""
    B, H, P, page_len, d = 2, 2, 3, 128, 16
    NP = 1 + B * P
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, H, 1, d)).astype(np.float32)
    jk, jv, tk, tv = _pools(kv, rng.standard_normal((NP, H, page_len, d)).astype(np.float32),
                            rng.standard_normal((NP, H, page_len, d)).astype(np.float32))
    table = rng.permutation(np.arange(1, NP, dtype=np.int32)).reshape(B, P)
    pos = np.array([37, 2 * page_len + 5], np.int32)
    ref = jfd.flash_decode_paged(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
                                 interpret=True)
    got = tfd.flash_decode_paged(torch.from_numpy(q), tk, tv, torch.from_numpy(table),
                                 torch.from_numpy(pos))
    _assert_same(ref, got, TOL)
    assert tfd.decode_paged_supported(B, H, P, 16, d) and not tfd.decode_paged_supported(B, H, P, 16, 192)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_forward_with_cache_paged_equals_slot_form(kv):
    """One 8-token prefill chunk per slot (at offsets 0 and 8), then one
    decode step over both slots: the paged form through permuted tables
    gives the slot-pool form's logits."""
    params = tgpt2.params_from_jax(_params())
    cfg = TTINY
    icfg = tinf.DeepSpeedInferenceConfig(hidden_size=cfg.n_embd, heads=cfg.n_head,
                                         dtype=torch.float32, max_out_tokens=32)
    dtype = "int8" if kv == "int8" else torch.float32
    S, page_len, B = 32, 8, 2
    NP = 1 + B * S // page_len
    sk, sv = tinf.init_kv_cache(cfg.n_layer, B, cfg.n_head, S, cfg.head_dim, dtype)
    pk, pv = tinf.init_kv_cache(cfg.n_layer, NP, cfg.n_head, page_len, cfg.head_dim, dtype)
    table = torch.from_numpy(np.random.default_rng(1).permutation(
        np.arange(1, NP, dtype=np.int32)).reshape(B, S // page_len))
    toks = _prompts(1, 16, 16, seed=2)[0]
    slot_pos = [0, 8]
    for b, start in enumerate(slot_pos):
        chunk = torch.from_numpy(toks[start:start + 8].astype(np.int64))[None]
        pos = torch.tensor([start], dtype=torch.int32)
        sl = lambda c: ({n: a[:, b:b + 1] for n, a in c.items()} if isinstance(c, dict)  # noqa: E731
                        else c[:, b:b + 1])
        a, _, _ = tinf.forward_with_cache(params, chunk, sl(sk), sl(sv), pos, icfg)
        p, _, _ = tinf.forward_with_cache(params, chunk, pk, pv, pos, icfg,
                                          page_table=table[b:b + 1])
        np.testing.assert_allclose(p.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)
    nxt = torch.tensor([[3], [4]])
    pos = torch.tensor([8, 16], dtype=torch.int32)
    a, _, _ = tinf.forward_with_cache(params, nxt, sk, sv, pos, icfg)
    p, _, _ = tinf.forward_with_cache(params, nxt, pk, pv, pos, icfg, page_table=table,
                                      write_mask=torch.tensor([True, True]))
    np.testing.assert_allclose(p.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# end to end: the paged engines
# ---------------------------------------------------------------------------

def _both(engines, jkv=None, tkv=None, **kw):
    """The JAX and the port's paged engines, same settings; ``jkv``/``tkv``
    add to the kvcache block of one side only."""
    jeng, teng = engines
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("max_len", 64)
    kv = {"enabled": True, "page_len": 16, **kw.pop("kvcache", {})}
    return (JServingEngine(jeng, kvcache={**kv, **(jkv or {})}, **kw),
            ServingEngine(teng, kvcache={**kv, **(tkv or {})}, **kw))


def _run(srv, prompts, n):
    rids = [srv.submit(p, max_new_tokens=n) for p in prompts]
    res = srv.drain(max_steps=600)
    return [np.asarray(res[r].tokens()) for r in rids]


_COUNTERS = ("prefix_hits", "tokens_saved", "cow_copies", "session_rebinds", "prefix_entries",
             "pages_live", "session_parks", "session_spills", "session_restores")


def test_paged_engine_shared_prefix_and_pinned_prefix_match_jax(engines):
    """Shared-prefix traffic (a 24-token shared run: hits floor to 16 or
    24 tokens, the partly filled second page is copied on write) plus a
    pinned 20-token system prompt."""
    jeng, teng = engines
    shared = _prompts(1, 24, 24, seed=11)[0]
    pin = _prompts(1, 20, 20, seed=21)[0]
    prompts = ([np.concatenate([shared, t]) for t in _prompts(5, 4, 12, seed=12)]
               + [np.concatenate([pin, t]) for t in _prompts(3, 5, 9, seed=22)]
               + _prompts(2, 6, 14, seed=13))
    jsrv, tsrv = _both(engines, kvcache={"pinned_prefixes": [pin.tolist()]})
    ref, got = _run(jsrv, prompts, 4), _run(tsrv, prompts, 4)
    slot = _run(ServingEngine(teng, num_slots=2, prefill_chunk=8, max_len=64), prompts, 4)
    for p, a, b, c in zip(prompts, ref, got, slot):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
        np.testing.assert_array_equal(b, teng.generate(p[None, :], max_new_tokens=4)[0])
    jkv, tkv = jsrv.stats()["kvcache"], tsrv.stats()["kvcache"]
    assert {k: tkv[k] for k in _COUNTERS} == {k: jkv[k] for k in _COUNTERS}
    assert tkv["prefix_hits"] >= 3 and tkv["cow_copies"] >= 1
    entry = tsrv.pool.index.lookup(np.concatenate([pin, [1]]))
    assert entry is not None and entry.pinned
    assert tsrv.pool.live_slots == 0
    _assert_no_leaks(tsrv.pool)


def test_paged_engine_session_turns_and_spill_restore_match_jax(engines, tmp_path):
    """Three chat turns under one session_id (two rebinds), then the
    session is spilled to disk and a fourth turn restores it; every turn
    equals the JAX engine's tokens and a solo generate() of the whole
    transcript."""
    jeng, teng = engines
    srvs = _both(engines, jkv={"spill_dir": str(tmp_path / "j")},
                 tkv={"spill_dir": str(tmp_path / "t")}, prefill_chunk=4)
    history = _prompts(1, 8, 8, seed=31)[0]
    for turn in range(4):
        if turn == 3:
            for srv in srvs:
                assert srv.pool.spill_sessions(0.0) == 1 and srv.pool.sessions.is_spilled("chat")
        outs = []
        for srv in srvs:
            rid = srv.submit(history, max_new_tokens=4, session_id="chat")
            outs.append(np.asarray(srv.drain(max_steps=300)[rid].tokens()))
        np.testing.assert_array_equal(outs[1], outs[0])
        np.testing.assert_array_equal(outs[1], teng.generate(history[None, :], max_new_tokens=4)[0])
        history = np.concatenate([outs[1], _prompts(1, 3, 5, seed=40 + turn)[0]])
        if turn == 2:  # the 3-turn chat: two rebinds on each side
            assert [srv.stats()["kvcache"]["session_rebinds"] for srv in srvs] == [2, 2]
    jkv, tkv = (srv.stats()["kvcache"] for srv in srvs)
    assert {k: tkv[k] for k in _COUNTERS} == {k: jkv[k] for k in _COUNTERS}
    assert tkv["session_rebinds"] == 3 and tkv["session_restores"] == 1
    _assert_no_leaks(srvs[1].pool)


def test_session_spill_format_matches_jax(tmp_path):
    """A bf16 session spilled by the port holds the JAX pool's files, meta
    keys, leaf dtypes and bytes; a fresh port pool recovers and restores
    the page contents bit for bit."""
    fill = _rand((2, 9, 2, 8, 4), 3)
    jp = JPagedKVPool(2, 2, 2, 16, 4, jnp.bfloat16, page_len=8, prefill_chunk=4,
                      spill_dir=str(tmp_path / "j"))
    tp = PagedKVPool(2, 2, 2, 16, 4, torch.bfloat16, page_len=8, prefill_chunk=4,
                     spill_dir=str(tmp_path / "t"))
    jp.swap(jnp.asarray(fill, jnp.bfloat16), jnp.asarray(fill * 2, jnp.bfloat16))
    tp.swap(torch.from_numpy(fill).bfloat16(), torch.from_numpy(fill * 2).bfloat16())
    for p in (jp, tp):
        r = _KReq("r0", [1, 2, 3, 4, 5, 6, 7, 8, 9], max_new=3, sid="chat")
        r.slot = p.alloc_request(r)
        r.generated, r.finish_reason = [6, 7, 8], "eos"
        p.retire(r.slot, r)
        assert p.spill_sessions(now=0.0) == 1
    (jdir,), (tdir,) = os.listdir(tmp_path / "j"), os.listdir(tmp_path / "t")
    assert jdir == tdir
    jd, td = tmp_path / "j" / jdir, tmp_path / "t" / tdir
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td)) == ["kv.npz", "manifest.json", "meta.json"]
    jmeta, tmeta = (json.loads((d / "meta.json").read_text()) for d in (jd, td))
    assert jmeta == tmeta and tmeta["leaf_dtypes"] == {"k": "bfloat16", "v": "bfloat16"}
    with np.load(jd / "kv.npz") as jz, np.load(td / "kv.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for n in jz.files:
            assert jz[n].dtype == tz[n].dtype == np.uint16
            np.testing.assert_array_equal(jz[n], tz[n])
    assert not tp.tables().any() and tp.pages_live == 0
    fresh = PagedKVPool(2, 2, 2, 16, 4, torch.bfloat16, page_len=8, prefill_chunk=4,
                        spill_dir=str(tmp_path / "t"))
    assert fresh.recover() == ["chat"]
    r1 = _KReq("r1", [1, 2, 3, 4, 5, 6, 7, 8, 9, 6, 7, 30], max_new=2, sid="chat")
    r1.slot = fresh.alloc_request(r1)
    assert r1.prefix_hint == 8 and fresh.stats()["session_restores"] == 1
    pages = fresh._slot_pages[r1.slot][:1]  # the 8-token hit covers the first page
    want = torch.from_numpy(fill).bfloat16()[:, [1]]
    assert torch.equal(fresh.k[:, pages], want) and torch.equal(fresh.v[:, pages], want * 2)
    fresh.retire(r1.slot, r1)
    _assert_no_leaks(fresh)
