"""Tensor-parallel inference and serving over ``model`` across gloo ranks:
``init_inference(mp_size=M)`` and ``init_serving`` in real OS processes
(``deepspeed_tpu_torch/tools/serve_worker.py``, one spawn of 2 ranks and
one of 4, every case of that size inside it) against the port at
``mp_size`` 1 in this process and the JAX package at the same
``mp_size`` on a host mesh.

* GPT2_TINY (its position table scaled up, as ``tests/test_torch_serving.py``
  has it) and BERT_TINY in f32: ``forward`` logits and encoder states
  within 2e-4 of both references; ``generate`` tokens equal, greedy, with
  a left-padded ``attention_mask`` and with the int8 KV cache; served
  greedy tokens equal solo ``generate`` at ``mp_size`` 1 and the JAX
  ``init_serving(mp_size=2)``, on the slot pool and on the paged pool
  (a shared prefix: hits and a copy-on-write).
* Every rank gives the same bits (sampled tokens too), data replicas
  (``model 2 x data 2``) as well; a rank's caches and pools hold
  ``n_head / M`` heads.
* A tag the port's training saved at ``model 2 x data 2`` serves at
  ``mp_size`` 4 and 1 with the same logits; ``init_on_device`` at
  ``mp_size`` 2 is the model of ``mp_size`` 1.
* A session spilled at ``mp_size`` 2 restores at ``mp_size`` 2, and with
  one rank's manifest gone no rank restores it.
* A refused submit (a queue of one, a prompt over the capacity) raises
  on every rank, and ids and a cancel's answer stay rank 0's.
* Rank 1's clock 1000 s ahead changes nothing: the ranks plan on rank
  0's broadcast clock (deadlines and session TTLs armed).
* A journaled engine killed (an injected kill at the 3rd decode on
  every rank) recovers on both ranks: the same replayed ids, the greedy
  ones' tokens those of one process's uninterrupted run; a tiered pool
  under the group builds, each rank's disk tier in a directory of its
  own.
* int8 weights at rest at ``mp_size`` 2: each rank's ``qkv_w/q`` and
  ``qkv_w/s`` are the head-grouped blocks of the whole weight's codes and
  scales (packed whole, then cut), ``proj_w/s`` replicated; logits within
  2e-4 of the int8 engine at ``mp_size`` 1 and the JAX int8 engine at 2,
  greedy tokens equal, served tokens solo int8 ``generate``'s.
* KV tiers at 2 ranks (device → host → disk, a flush to disk before the
  last turn, one rank's disk copy of one session corrupted): the tokens of
  one process's tiered run and of the all-device pool, every tier counter
  alike on both ranks, and the dropped session a miss on both (one
  rebind fewer than one process's run).
  SIGTERM to rank 0 alone drains both ranks through the same steps to
  the same exit code, 43, after rank 0's journal commits.
* The bytes counted in every drive equal the inference byte model.
* On one process: the refusals (a vocabulary or heads the axis does not
  divide, ``mp_size`` not dividing the world, ``mp_size`` > 1 without a
  process group), and at ``mp_size`` 1 under a group of one rank the
  engine of no group, bit for bit.

The children run with one thread and deterministic algorithms; they meet
through a file store, not a port.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.transformer.inference import LOGITS_GATHER
from deepspeed_tpu_torch.serving import ServingEngine
from deepspeed_tpu_torch.serving.engine import AGREE_KIND

from tests.test_torch_zero import GAS, MB, REPO, T, _gpt2_config

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TTINY = tgpt2.GPT2_TINY
TOL = dict(rtol=2e-4, atol=2e-4)
CAP = TTINY.n_positions
SLOT = {"num_slots": 2, "prefill_chunk": 8, "max_len": 64, "max_new_tokens": 8}
PAGED = {**SLOT, "kvcache": {"enabled": True, "page_len": 16}}
# served with rank 1's clock 1000 s ahead: deadlines and TTLs it would trip
# a device pool a quarter of the tier schedule's working set (as
# tests/test_torch_kvtiers.py's CASCADE)
TIERED = {**SLOT, "kvcache": {"enabled": True, "page_len": 16, "num_pages": 24,
                              "tiers": {"host_pages": 8, "residency_window": 16,
                                        "demote_watermark": 0.25, "demote_batch": 8}}}
TIER_DRIVE = {"kind": "tiers", "serving": TIERED, "sessions": 4, "turns": 3, "seed": 3,
              "max_new_tokens": 4, "flush": True}
SKEWED = {**SLOT, "deadline_seconds": 120.0,
          "kvcache": {"enabled": True, "page_len": 16, "session_ttl_seconds": 60.0,
                      "spill_dir": "auto"}}
N_NEW = 6


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _gpt_params():
    p = jgpt2.init_params(JTINY, seed=7)
    p["wpe"] = p["wpe"] * 40.0
    return p


def _inputs(rng):
    ids24 = rng.integers(1, TTINY.vocab_size, (2, 24))
    ids8 = rng.integers(1, TTINY.vocab_size, (2, 8))
    mask8 = np.ones((2, 8), np.int64)
    mask8[0, :3] = 0
    bert = {"input_ids": rng.integers(1, tbert.BERT_TINY.vocab_size, (2, 16)),
            "token_type_ids": np.repeat((np.arange(16) >= 9)[None].astype(np.int64), 2, 0),
            "attention_mask": np.ones((2, 16), np.int64)}
    bert["attention_mask"][1, 12:] = 0
    greedy = [{"prompt": rng.integers(1, TTINY.vocab_size, int(n)).tolist(), "max_new_tokens": b}
              for n, b in zip(rng.integers(3, 21, 6), [6, 3, 5, 2, 4, 7])]
    sampled = [{"prompt": rng.integers(1, TTINY.vocab_size, 9).tolist(), "max_new_tokens": 6,
                "do_sample": True, "temperature": 0.9, "top_k": 20, "seed": 5}]
    shared = rng.integers(1, TTINY.vocab_size, 26)  # hits of 24: a partly shared page
    prefixed = [{"prompt": np.concatenate([shared, rng.integers(1, TTINY.vocab_size, int(n))])
                 .tolist(), "max_new_tokens": 4} for n in (3, 6, 9, 5)]
    session = {"first": rng.integers(1, TTINY.vocab_size, 10).tolist(),
               "tails": [rng.integers(1, TTINY.vocab_size, n).tolist() for n in (5, 4)],
               "max_new_tokens": 4, "session_id": "chat"}
    return {"ids24": ids24, "ids8": ids8, "mask8": mask8, "bert": bert, "greedy": greedy,
            "sampled": sampled, "prefixed": prefixed, "session": session}


def _gpt_drives(tmp, x, serve=True):
    drives = [{"kind": "forward", "inputs": str(tmp / "ids24.npz")},
              {"kind": "generate", "inputs": str(tmp / "ids8.npz"), "max_new_tokens": N_NEW},
              {"kind": "generate", "inputs": str(tmp / "ids8_masked.npz"),
               "max_new_tokens": N_NEW},
              {"kind": "generate", "inputs": str(tmp / "ids8.npz"), "max_new_tokens": N_NEW,
               "do_sample": True, "temperature": 0.8, "top_k": 30, "seed": 11},
              {"kind": "cache", "batch": 2, "max_len": 16}]
    if serve:
        drives.append({"kind": "serve", "serving": SLOT, "requests": x["greedy"] + x["sampled"],
                       "first": 3, "steps": 2})
    return drives


def _paged_drive(x):
    return {"kind": "serve", "serving": {**PAGED, "kvcache": {**PAGED["kvcache"],
                                                               "spill_dir": "auto"}},
            "requests": x["prefixed"], "first": 1, "steps": 4,
            "session": {**x["session"], "spill_after": [0, 1],
                        "drop_manifest": {"rank": 1, "after": 1}}}


def _refusing_drive(x):
    """A queue of one: a second waiter is refused, as is a prompt over the
    capacity; after a step admits the first, a waiter is cancelled and so
    is an id no submit gave."""
    g = x["greedy"]
    too_long = {"prompt": (g[0]["prompt"] * 60)[:60], "max_new_tokens": 8}  # 68 > max_len 64
    return {"kind": "serve", "serving": {**SLOT, "max_queue": 1},
            "requests": [g[0], g[1], too_long, g[2], g[3]], "first": 3, "steps": 1,
            "refusals": True, "cancel": [3, 99]}


def _engine_spec(mp, **kw):
    return {"preset": "tiny", "mp_size": mp, "dtype": "float32", "max_out_tokens": CAP, **kw}


def _spawn(world, spec, tmp, name):
    spec = {"device": "cpu", "init_method": f"file://{tmp}/store{name}", "out": str(tmp), **spec}
    path = tmp / f"spec{name}.json"
    path.write_text(json.dumps(spec))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.serve_worker", str(path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, world):
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{out[-3000:]}"


def _port(mp=1, **kw):
    kw.setdefault("max_out_tokens", CAP)
    return deepspeed_tpu_torch.init_inference(mp_size=mp, dtype=torch.float32, device="cpu", **kw)


def _serve_local(srv, drive):
    """The worker's request sequence (without spills) on an engine of this
    process: the port's or the JAX package's."""
    reqs = drive["requests"]
    first = drive.get("first") or len(reqs)
    sub = lambda rs: [srv.submit(np.asarray(r["prompt"], np.int32),  # noqa: E731
                                 **{k: v for k, v in r.items() if k != "prompt"}) for r in rs]
    rids = sub(reqs[:first])
    for _ in range(int(drive.get("steps", 0))):
        srv.step()
    rids += sub(reqs[first:])
    res = srv.drain()
    done = [np.asarray(res[r].tokens()) for r in rids]
    srv.kvcache_requests = srv.stats().get("kvcache")
    sess = drive.get("session")
    if sess is not None:
        prompt = np.asarray(sess["first"], np.int32)
        for tail in [None, *sess["tails"]]:
            if tail is not None:
                prompt = np.concatenate([done[-1], np.asarray(tail, np.int32)])
            rid = srv.submit(prompt, max_new_tokens=sess["max_new_tokens"],
                             session_id=sess["session_id"])
            done.append(np.asarray(srv.drain()[rid].tokens()))
    return done


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns run while this process computes the references."""
    tmp = tmp_path_factory.mktemp("tpinf")
    x = _inputs(np.random.default_rng(0))
    gparams, bparams = _gpt_params(), jbert.init_params(jbert.BERT_TINY, seed=5)
    np.savez(tmp / "gpt.npz", **_flat(gparams))
    np.savez(tmp / "bert.npz", **_flat(bparams))
    np.savez(tmp / "ids24.npz", input_ids=x["ids24"])
    np.savez(tmp / "ids8.npz", input_ids=x["ids8"])
    np.savez(tmp / "ids8_masked.npz", input_ids=x["ids8"], attention_mask=x["mask8"])
    np.savez(tmp / "bert_in.npz", **x["bert"])
    rng = np.random.default_rng(1)
    np.savez(tmp / "train.npz", input_ids=np.repeat(rng.integers(
        0, TTINY.vocab_size, (1, GAS * MB * 2, T), dtype=np.int32), 2, axis=0))
    ck = str(tmp / "ckpt")
    gpt = _engine_spec(2, params=str(tmp / "gpt.npz"))
    bert = {**_engine_spec(2, params=str(tmp / "bert.npz")), "family": "bert"}
    bert_fwd = [{"kind": "forward", "inputs": str(tmp / "bert_in.npz")}]
    w2 = [{"name": "g2", "engine": gpt, "drives": _gpt_drives(tmp, x) + [_paged_drive(x)]},
          {"name": "g2i8", "engine": {**gpt, "kv_cache_dtype": "int8"}, "drives": [
              {"kind": "generate", "inputs": str(tmp / "ids8.npz"), "max_new_tokens": N_NEW},
              {"kind": "generate", "inputs": str(tmp / "ids8_masked.npz"),
               "max_new_tokens": N_NEW},
              {"kind": "cache", "batch": 2, "max_len": 16}]},
          {"name": "b2", "engine": bert, "drives": bert_fwd},
          {"name": "g2dev", "engine": _engine_spec(2, init_on_device=True, seed=3),
           "drives": _gpt_drives(tmp, x, serve=False)[:2]},
          {"name": "g2refuse", "engine": gpt, "drives": [_refusing_drive(x)]},
          {"name": "g2rec", "engine": gpt, "drives": [
              {"kind": "recover", "serving": SLOT, "requests": x["greedy"] + x["sampled"],
               "kill_at_decode": 3, "tiers_built": True},
              {"kind": "sigterm", "serving": SLOT, "requests": x["greedy"][:4], "steps": 2}]},
          {"name": "g2q8", "engine": {**gpt, "quantize_bits": 8}, "drives": [
              {"kind": "params"}, {"kind": "forward", "inputs": str(tmp / "ids24.npz")},
              {"kind": "generate", "inputs": str(tmp / "ids8.npz"), "max_new_tokens": N_NEW},
              {"kind": "serve", "serving": SLOT, "requests": x["greedy"]},
              {"kind": "serve", "serving": PAGED, "requests": x["prefixed"]}]},
          {"name": "g2tier", "engine": gpt, "drives": [
              {**TIER_DRIVE, "corrupt": {"rank": 1, "session": "sess-0"}}]},
          {"name": "g2skew", "engine": gpt, "clock_skew": {"rank": 1, "seconds": 1000.0},
           "drives": [{"kind": "serve", "serving": SKEWED, "requests": x["greedy"][:5],
                       "session": {**x["session"], "spill_after": [0]}}]}]
    train = {"name": "train_m2d2", "preset": "tiny", "init_seed": 3,
             "config": _gpt2_config(0, {"data": 2, "model": 2}), "batches": str(tmp / "train.npz"),
             "steps": 2, "save": {"dir": ck, "tag": "tp", "after": 2}, "record": "none"}
    w4 = [{"name": "g4", "engine": {**gpt, "mp_size": 4}, "drives": _gpt_drives(tmp, x)},
          {"name": "b4", "engine": {**bert, "mp_size": 4}, "drives": bert_fwd},
          {"name": "g4ck", "engine": _engine_spec(4, checkpoint=ck),
           "drives": [{"kind": "forward", "inputs": str(tmp / "ids24.npz")}]},
          {"name": "g2d2", "engine": gpt, "drives": _gpt_drives(tmp, x)[1:2] + [
              {"kind": "serve", "serving": SLOT, "requests": x["greedy"] + x["sampled"]}]}]
    p2 = _spawn(2, {"cases": w2}, tmp, "2")
    p4 = _spawn(4, {"cases": w4, "train_cases": [train]}, tmp, "4")
    refs = {}
    try:
        refs["port"] = _port(model_config=TTINY, params=gparams)
        refs["bert_port"] = _port(model_config=tbert.BERT_TINY, params=bparams)
        refs["port_i8"] = _port(model_config=TTINY, params=gparams, kv_cache_dtype="int8")
        refs["port_q8"] = _port(model_config=TTINY, params=gparams, quantize_bits=8)
        refs["jax_q8"] = deepspeed_tpu.init_inference(
            model_config=JTINY, params=gparams, dtype=jnp.float32, mp_size=2, max_out_tokens=CAP,
            quantize_bits=8)
        solo = {k: v for k, v in TIER_DRIVE.items() if k != "kind"}
        refs["tiers_solo"] = _tiered_solo(refs["port"], solo, tmp / "solo_t2")
        refs["jax"] = {m: deepspeed_tpu.init_inference(
            model_config=JTINY, params=gparams, dtype=jnp.float32, mp_size=m,
            max_out_tokens=CAP) for m in (2, 4)}
        refs["jax_bert"] = {m: deepspeed_tpu.init_inference(
            model_config=jbert.BERT_TINY, params=bparams, dtype=jnp.float32, mp_size=m)
            for m in (2, 4)}
        refs["jax_i8"] = deepspeed_tpu.init_inference(
            model_config=JTINY, params=gparams, dtype=jnp.float32, mp_size=2, max_out_tokens=CAP,
            kv_cache_dtype="int8")
        jslot = deepspeed_tpu.init_serving(model_config=JTINY, params=gparams, dtype=jnp.float32,
                                           mp_size=2, max_out_tokens=CAP, serving=SLOT)
        refs["jax_slot"] = _serve_local(jslot, {"requests": x["greedy"], "first": 3, "steps": 2})
        jpaged = deepspeed_tpu.init_serving(model_config=JTINY, params=gparams,
                                            dtype=jnp.float32, mp_size=2, max_out_tokens=CAP,
                                            serving=PAGED)
        refs["jax_paged"] = _serve_local(jpaged, _paged_drive(x))
        refs["jax_paged_stats"] = jpaged.kvcache_requests
    finally:
        _wait(p2, 2)
        _wait(p4, 4)
    refs["ckpt"] = _port(model_config=TTINY, checkpoint=ck)
    refs["dev"] = _port(model_config=TTINY, init_on_device=True, seed=3)
    return {"tmp": tmp, "x": x, **refs}


def _read(runs, name, world):
    """Every rank's (json, arrays) of a case."""
    out = []
    for r in range(world):
        with open(runs["tmp"] / f"{name}.r{r}.json") as f:
            meta = json.load(f)
        with np.load(runs["tmp"] / f"{name}.r{r}.npz") as z:
            out.append((meta, {k: z[k] for k in z.files}))
    return out


def _tiered_solo(port, drive, disk_dir):
    """The tier drive's schedule on one process's tiered engine (a flush
    before the last turn): its tokens and session rebinds."""
    from deepspeed_tpu_torch.tools.serve_worker import tier_turns

    kvc = dict(drive["serving"]["kvcache"])
    kvc["tiers"] = {**kvc["tiers"], "enabled": True, "disk_dir": str(disk_dir)}
    srv = ServingEngine(port, config={**drive["serving"], "kvcache": kvc})
    kw = {k: drive[k] for k in ("sessions", "turns", "seed", "max_new_tokens")}
    tokens = tier_turns(srv, before_last=lambda s: s._tiers.flush(time.monotonic()), **kw)
    out = {"tokens": tokens, "rebinds": srv.stats()["kvcache"]["session_rebinds"]}
    srv._tiers.close()
    return out


CASES = {"g2": 2, "g2i8": 2, "b2": 2, "g2dev": 2, "g2refuse": 2, "g2skew": 2, "g2rec": 2,
         "g2q8": 2, "g2tier": 2,
         "g4": 4, "b4": 4, "g4ck": 4, "g2d2": 4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_rank_gives_the_same_bits(runs, case):
    """Forward outputs, generated and served tokens (sampled ones too),
    served stats: rank 0's on every rank, data replicas included."""
    ranks = _read(runs, case, CASES[case])
    meta0, arr0 = ranks[0]
    assert meta0["world_size"] == CASES[case] and meta0["backend"] == "gloo"
    assert meta0["mesh"]["model"] == meta0["mp_size"]
    assert meta0["mesh"]["data"] == CASES[case] // meta0["mp_size"]
    for meta, arr in ranks[1:]:
        assert set(arr) == set(arr0)
        for k in arr0:
            np.testing.assert_array_equal(arr[k], arr0[k], err_msg=f"{case} {k}")
        for d0, d in zip(meta0["drives"], meta["drives"]):
            for key in ("tokens", "finish", "prefix_hints", "session_restores_by_turn", "ids",
                        "refused", "cancelled", "replayed"):
                assert d.get(key) == d0.get(key), (case, key)
            if "stats" in d0:
                assert d["stats"].get("kvcache") == d0["stats"].get("kvcache")


@pytest.mark.parametrize("case,m", [("g2", 2), ("g4", 4)])
def test_gpt2_forward_and_generate_match_mp1_and_jax(runs, case, m):
    (meta, arr), x = _read(runs, case, m)[0], runs["x"]
    port, jeng = runs["port"], runs["jax"][m]
    ref = port.forward(x["ids24"]).numpy()
    np.testing.assert_allclose(arr["d0"], ref, **TOL)
    np.testing.assert_allclose(arr["d0"], np.asarray(jeng.forward(x["ids24"])), **TOL)
    want = port.generate(x["ids8"], max_new_tokens=N_NEW)
    np.testing.assert_array_equal(arr["d1"], want)
    np.testing.assert_array_equal(arr["d1"], np.asarray(jeng.generate(x["ids8"],
                                                                      max_new_tokens=N_NEW)))
    want = port.generate(x["ids8"], max_new_tokens=N_NEW, attention_mask=x["mask8"])
    np.testing.assert_array_equal(arr["d2"], want)
    np.testing.assert_array_equal(arr["d2"], np.asarray(jeng.generate(
        x["ids8"], max_new_tokens=N_NEW, attention_mask=x["mask8"])))
    # sampled: the same draws as mp_size 1 (the whole logits on every rank)
    np.testing.assert_array_equal(arr["d3"], port.generate(
        x["ids8"], max_new_tokens=N_NEW, do_sample=True, temperature=0.8, top_k=30, seed=11))


def test_int8_cache_generate_matches_mp1_and_jax(runs):
    (meta, arr), x = _read(runs, "g2i8", 2)[0], runs["x"]
    port, jeng = runs["port_i8"], runs["jax_i8"]
    for i, mask in ((0, None), (1, x["mask8"])):
        want = port.generate(x["ids8"], max_new_tokens=N_NEW, attention_mask=mask)
        np.testing.assert_array_equal(arr[f"d{i}"], want)
        np.testing.assert_array_equal(arr[f"d{i}"], np.asarray(jeng.generate(
            x["ids8"], max_new_tokens=N_NEW, attention_mask=mask)))
    L, H, hd = TTINY.n_layer, TTINY.n_head, TTINY.head_dim
    assert meta["drives"][2]["shape"] == [L, 2, H // 2, 16, hd]


@pytest.mark.parametrize("case,m", [("b2", 2), ("b4", 4)])
def test_bert_encoder_states_match_mp1_and_jax(runs, case, m):
    (meta, arr), b = _read(runs, case, m)[0], runs["x"]["bert"]
    kw = {k: v for k, v in b.items() if k != "input_ids"}
    np.testing.assert_allclose(arr["d0"], runs["bert_port"].forward(b["input_ids"], **kw).numpy(),
                               **TOL)
    np.testing.assert_allclose(arr["d0"], np.asarray(runs["jax_bert"][m].forward(
        b["input_ids"], **kw)), **TOL)
    assert meta["local_heads"] == tbert.BERT_TINY.num_attention_heads // m


@pytest.mark.parametrize("case,m", [("g2", 2), ("g4", 4), ("g2d2", 4)])
def test_served_tokens_match_solo_generate_and_jax(runs, case, m):
    """Greedy requests equal solo ``generate`` at mp_size 1 and the JAX
    engine at mp_size 2; the sampled request equals mp_size 1's serving."""
    meta, _ = _read(runs, case, m)[0]
    d = next(d for d in meta["drives"] if d["kind"] == "serve")
    x, port = runs["x"], runs["port"]
    for r, got in zip(x["greedy"], d["tokens"]):
        want = port.generate(np.asarray(r["prompt"])[None], max_new_tokens=r["max_new_tokens"])
        np.testing.assert_array_equal(got, want[0])
    if case == "g2":
        for got, want in zip(d["tokens"], runs["jax_slot"]):
            np.testing.assert_array_equal(got, want)
    srv = ServingEngine(port, config=SLOT)
    want = _serve_local(srv, {"requests": x["sampled"]})
    np.testing.assert_array_equal(d["tokens"][-1], want[0])
    assert d["finish"] == ["length"] * len(d["finish"])
    assert d["pool_heads"] == TTINY.n_head // meta["mp_size"]


def test_killed_run_recovers_on_every_rank_to_one_process_tokens(runs):
    """Every rank died at the same decode and replayed the same ids (rank
    0 read the journal and broadcast it); the replayed greedy requests'
    tokens equal one process's uninterrupted run; a tiered pool builds
    under the group, each rank's disk tier in a directory of its own."""
    ranks = _read(runs, "g2rec", 2)
    d = ranks[0][0]["drives"][0]
    assert d["killed"] and d["replayed"] and set(d["replayed"]) <= set(d["ids"])
    assert all(meta["drives"][0]["replayed"] == d["replayed"] for meta, _ in ranks)
    assert [meta["drives"][0]["tiers_disk_dir"] for meta, _ in ranks] == ["model0", "model1"]
    x = runs["x"]
    reqs = x["greedy"] + x["sampled"]
    want = _serve_local(ServingEngine(runs["port"], config=SLOT), {"requests": reqs})
    n_greedy = 0
    for rid, got in zip(d["replayed"], d["tokens"]):
        i = d["ids"].index(rid)
        if i < len(x["greedy"]):
            np.testing.assert_array_equal(got, want[i])
            n_greedy += 1
    assert n_greedy > 0
    assert d["finish"] == ["length"] * len(d["finish"])


def test_sigterm_on_rank_0_drains_every_rank_alike(runs):
    ranks = _read(runs, "g2rec", 2)
    d = [meta["drives"][1] for meta, _ in ranks]
    assert [x["exit_code"] for x in d] == [43, 43]
    assert d[0]["steps"] == d[1]["steps"] and d[0]["undone"] == d[1]["undone"]
    assert d[0]["undone"]  # 4 requests on 2 slots: the queued ones stay undone
    journal = runs["tmp"] / "journal_g2rec_1"
    from deepspeed_tpu_torch.serving.journal import incomplete_requests, read_records

    assert [e["id"] for e in incomplete_requests(str(journal))] == d[0]["undone"]
    assert [r for r in read_records(str(journal)) if r["t"] == "drain"][-1]["undone"] == \
        d[0]["undone"]


def test_paged_pool_prefix_cow_and_session_spill_at_mp2(runs):
    """Prefix hits and a copy-on-write, every rank alike; the session
    spilled after turn 0 restores at turn 1 on both ranks; with rank 1's
    manifest gone after turn 1 neither rank restores at turn 2, and the
    tokens stay solo ``generate``'s and the JAX engine's."""
    ranks = _read(runs, "g2", 2)
    d = ranks[0][0]["drives"][-1]
    kv = d["stats"]["kvcache"]
    assert kv["prefix_hits"] >= 3 and kv["session_rebinds"] >= 1
    for meta, _ in ranks:
        assert meta["drives"][-1]["session_restores_by_turn"] == [0, 1, 1]
    before = d["kvcache_requests"]  # the prefix traffic's counters, before the session
    for key in ("prefix_hits", "cow_copies", "tokens_saved"):
        assert before[key] == runs["jax_paged_stats"][key], key
    assert before["cow_copies"] >= 1
    port = runs["port"]
    for got, want in zip(d["tokens"], runs["jax_paged"]):
        np.testing.assert_array_equal(got, want)
    prompts = [r["prompt"] for r in runs["x"]["prefixed"]]
    for got, p in zip(d["tokens"], prompts):
        np.testing.assert_array_equal(
            got, port.generate(np.asarray(p)[None], max_new_tokens=len(got) - len(p))[0])
    for got in d["tokens"][len(prompts):]:  # each turn: its prompt's solo generation
        n = runs["x"]["session"]["max_new_tokens"]
        np.testing.assert_array_equal(
            got, port.generate(np.asarray(got[:-n])[None], max_new_tokens=n)[0])
    assert d["pool_heads"] == TTINY.n_head // 2


def test_skewed_clock_plans_on_rank_0s(runs):
    ranks = _read(runs, "g2skew", 2)
    d = ranks[0][0]["drives"][0]
    assert d["finish"] == ["length"] * len(d["finish"])
    assert d["stats"]["expired"] == 0 and d["stats"]["kvcache"]["session_spills"] == 1
    assert ranks[1][0]["drives"][0]["stats"]["expired"] == 0
    port = runs["port"]
    for got, r in zip(d["tokens"], runs["x"]["greedy"][:5]):
        want = port.generate(np.asarray(r["prompt"])[None], max_new_tokens=r["max_new_tokens"])
        np.testing.assert_array_equal(got, want[0])


def test_refused_submits_and_cancels_agree_on_every_rank(runs):
    """Rank 0's refusals raise on every rank, the ids after them stay rank
    0's, and a cancel answers alike on every rank."""
    ranks = _read(runs, "g2refuse", 2)
    d = ranks[0][0]["drives"][0]
    assert d["refused"] == [None, "ServingQueueFull", "ValueError", None, "ServingQueueFull"]
    assert d["cancelled"] == [True, False]
    ids = d["ids"]
    assert [i is None for i in ids] == [False, True, True, False, True]
    assert ids[3] == ids[0] + 1, ids  # a refusal uses up no id
    for meta, _ in ranks[1:]:
        assert meta["drives"][0]["ids"] == ids
    assert d["finish"] == ["length", "cancelled"]
    r = runs["x"]["greedy"][0]
    want = runs["port"].generate(np.asarray(r["prompt"])[None], max_new_tokens=r["max_new_tokens"])
    np.testing.assert_array_equal(d["tokens"][0], want[0])
    assert d["stats"]["rejected"] == 2 and d["stats"]["cancelled"] == 1  # the queue's two
    assert ranks[1][0]["drives"][0]["stats"] == d["stats"] | {"phase_seconds": ranks[1][0][
        "drives"][0]["stats"]["phase_seconds"]}


@pytest.mark.parametrize("case,m", [("g2", 2), ("g4", 4), ("g2i8", 2)])
def test_caches_hold_a_ranks_heads(runs, case, m):
    meta, _ = _read(runs, case, m)[0]
    shape = next(d["shape"] for d in meta["drives"] if d["kind"] == "cache")
    assert shape == [TTINY.n_layer, 2, TTINY.n_head // m, 16, TTINY.head_dim]
    assert meta["local_heads"] == TTINY.n_head // m


def test_tag_saved_at_model_2_serves_at_mp_4_and_1(runs):
    (meta, arr), x = _read(runs, "g4ck", 4)[0], runs["x"]
    ref = runs["ckpt"].forward(x["ids24"]).numpy()
    np.testing.assert_allclose(arr["d0"], ref, **TOL)
    # the trained tag is not the initial model
    init = _port(model_config=TTINY, params=tgpt2.init_params(TTINY, seed=3))
    assert np.abs(init.forward(x["ids24"]).numpy() - ref).max() > 1e-3


def test_init_on_device_is_the_model_of_mp1(runs):
    (meta, arr), x = _read(runs, "g2dev", 2)[0], runs["x"]
    dev = runs["dev"]
    np.testing.assert_allclose(arr["d0"], dev.forward(x["ids24"]).numpy(), **TOL)
    np.testing.assert_array_equal(arr["d1"], dev.generate(x["ids8"], max_new_tokens=N_NEW))
    host = _port(model_config=TTINY, seed=3)  # another stream than the host init's
    assert not torch.equal(host.params["wte"], dev.params["wte"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_counted_bytes_equal_the_inference_byte_model(runs, case):
    meta, _ = _read(runs, case, CASES[case])[0]
    for d in meta["drives"]:
        if "model_bytes" not in d:
            continue
        assert d["model_bytes"]["tp-all-reduce"] > 0
        for kind, n in d["model_bytes"].items():
            assert d["comm"].get(kind, 0) == n, (case, d["kind"], kind, d["comm"])
        assert set(d["comm"]) <= {"tp-all-reduce", LOGITS_GATHER, AGREE_KIND}, d["comm"]


def test_device_init_draws_the_whole_tree_on_the_device():
    for mod, cfg in ((tgpt2, TTINY), (tbert, tbert.BERT_TINY)):
        got = mod.init_params_device(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
        want = mod.init_params(cfg, seed=1)
        for k, v in want.items():
            sub = v if isinstance(v, dict) else {None: v}
            for n, a in sub.items():
                t = got[k][n] if n is not None else got[k]
                assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16, (k, n)
                if float(np.std(a)) > 0:  # a normal draw: its scale, within sampling error
                    assert abs(float(t.float().std()) / float(np.std(a)) - 1) < 0.1, (k, n)
                else:
                    assert torch.equal(t.float(), torch.from_numpy(a)), (k, n)
        again = mod.init_params_device(cfg, seed=1, dtype=torch.bfloat16, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            _flat_t(got), _flat_t(again)))


def _flat_t(tree):
    return [v for k in tree for v in (tree[k].values() if isinstance(tree[k], dict)
                                      else [tree[k]])]


def test_refusals_on_one_process(tmp_path):
    with pytest.raises(ValueError, match="should be divisible by 2, but it is equal to 513"):
        _port(2, model_config=dataclasses.replace(TTINY, vocab_size=513))
    with pytest.raises(ValueError, match="should be divisible by 2"):
        deepspeed_tpu.init_inference(model_config=dataclasses.replace(JTINY, vocab_size=513),
                                     dtype=jnp.float32, mp_size=2)
    with pytest.raises(ValueError, match=r"n_head 25 is not divisible by the model axis \(4\).*C4"):
        _port(4, model="gpt2-xl")
    with pytest.raises(ValueError, match=r"num_attention_heads 4 is not divisible.*C4"):
        _port(3, model_config=dataclasses.replace(tbert.BERT_TINY, hidden_size=48,
                                                  intermediate_size=96))
    with pytest.raises(ValueError, match="mp_size=2 needs a process group"):
        _port(2, model="tiny")
    # a group of one rank: mp_size 2 does not divide it, and mp_size 1 runs
    # the group's engine (a model group of one) bit for bit as no group
    solo = _port(model="tiny")
    ids = np.random.default_rng(3).integers(1, 512, (2, 12))
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="mp_size=2 does not divide 1 ranks"):
            _port(2, model="tiny")
        grouped = _port(model="tiny")
        assert grouped.mesh is not None and grouped.mesh.sizes["model"] == 1
        assert grouped.tp is None
        assert torch.equal(grouped.forward(ids), solo.forward(ids))
        np.testing.assert_array_equal(grouped.generate(ids, max_new_tokens=5),
                                      solo.generate(ids, max_new_tokens=5))
        srv = ServingEngine(grouped, config=SLOT)
        got = _serve_local(srv, {"requests": [{"prompt": ids[0].tolist(), "max_new_tokens": 4}]})
        np.testing.assert_array_equal(got[0], solo.generate(ids[:1], max_new_tokens=4)[0])
    finally:
        torch.distributed.destroy_process_group()


def test_int8_at_mp2_cuts_packed_weights_by_heads(runs):
    """Each rank holds the head-grouped block of the whole weight's int8
    codes and per-channel scales (quantized whole, then cut), and serves
    the logits and tokens of the int8 engine at mp_size 1 and of the JAX
    int8 engine at mp_size 2."""
    from deepspeed_tpu_torch.runtime.zero.partition import _group_parts

    ranks, x = _read(runs, "g2q8", 2), runs["x"]
    whole = runs["port_q8"].params["blocks"]
    for r, (meta, _) in enumerate(ranks):
        with np.load(meta["drives"][0]["file"]) as z:
            arr = {f"d0/{k}": z[k] for k in z.files}
        for leaf in ("q", "s"):
            t = whole["qkv_w"][leaf]
            want = _group_parts(t, 3, 2).chunk(2, dim=-1)[r]
            got = arr[f"d0/blocks/qkv_w/{leaf}"]
            assert got.dtype == (np.int8 if leaf == "q" else np.float32)
            np.testing.assert_array_equal(got, want.numpy())
            fc = whole["fc_w"][leaf].chunk(2, dim=-1)[r]
            np.testing.assert_array_equal(arr[f"d0/blocks/fc_w/{leaf}"], fc.numpy())
        np.testing.assert_array_equal(arr["d0/blocks/proj_w/q"],
                                      whole["proj_w"]["q"].chunk(2, dim=1)[r].numpy())
        np.testing.assert_array_equal(arr["d0/blocks/proj_w/s"], whole["proj_w"]["s"].numpy())
    meta, arr = ranks[0]
    port, jeng = runs["port_q8"], runs["jax_q8"]
    np.testing.assert_allclose(arr["d1"], port.forward(x["ids24"]).numpy(), **TOL)
    np.testing.assert_allclose(arr["d1"], np.asarray(jeng.forward(x["ids24"])), **TOL)
    want = port.generate(x["ids8"], max_new_tokens=N_NEW)
    np.testing.assert_array_equal(arr["d2"], want)
    np.testing.assert_array_equal(arr["d2"], np.asarray(jeng.generate(x["ids8"],
                                                                      max_new_tokens=N_NEW)))
    for d, reqs in ((meta["drives"][3], x["greedy"]), (meta["drives"][4], x["prefixed"])):
        for r, got in zip(reqs, d["tokens"]):
            np.testing.assert_array_equal(got, port.generate(
                np.asarray(r["prompt"])[None], max_new_tokens=r["max_new_tokens"])[0])


def test_tiers_at_two_ranks_match_one_process_and_the_all_device_pool(runs):
    ranks = _read(runs, "g2tier", 2)
    solo = runs["tiers_solo"]
    d0 = ranks[0][0]["drives"][0]
    for r, (meta, _) in enumerate(ranks):
        d = meta["drives"][0]
        assert d["tokens"] == d0["tokens"] == solo["tokens"] == d["reference"]
        assert d["tier_counts"] == d0["tier_counts"]
        assert d["session_rebinds"] == d0["session_rebinds"]
        assert d["disk_dir"].endswith(os.path.join("tiers_g2tier_0", f"model{r}"))
    counts = d0["tier_counts"]
    assert counts["demote_t0_t1"] > 0 and counts["demote_t1_t2"] > 0, counts
    assert counts["hits_t2"] + counts["promote_t2_t1"] > 0, counts
    # sess-0's disk copy failed to verify on rank 1 only: a miss on both
    assert d0["dropped"] == [] and ranks[1][0]["drives"][0]["dropped"]
    assert d0["session_rebinds"] == solo["rebinds"] - 1
