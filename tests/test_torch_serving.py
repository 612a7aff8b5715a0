"""The port's continuous-batching ServingEngine (deepspeed_tpu_torch) on
the CPU: greedy parity with the JAX ServingEngine and with the port's own
solo ``generate()`` under slot churn, EOS retirement, queue-full
rejection, capacity validation, the config blocks not ported yet (the
fleet, the front door), and
sampled tokens keyed on (seed, position) whatever slot a request lands
in.  The model is GPT2_TINY with its position table scaled up, so that
slot and position bookkeeping bugs change the generations."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import KVCacheConfig as JKVCacheConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, ServingConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.serving import ServingEngine, ServingQueueFull, SlotKVPool, SlotPoolError

JTINY = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
TTINY = tgpt2.GPT2_TINY


def _params(seed=7):
    p = jgpt2.init_params(JTINY, seed=seed)
    p["wpe"] = p["wpe"] * 40.0
    return p


def _port_engine(params=None, **kw):
    kw.setdefault("max_out_tokens", TTINY.n_positions)
    return deepspeed_tpu_torch.init_inference(
        model_config=TTINY, params=_params() if params is None else params,
        dtype=torch.float32, device="cpu", **kw)


def _prompts(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TTINY.vocab_size, rng.integers(lo, hi + 1), dtype=np.int32)
            for _ in range(n)]


def _churn(srv, prompts, budgets):
    """Three requests, two steps, then the late arrivals mid-decode."""
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts[:3], budgets[:3])]
    srv.step()
    srv.step()
    rids += [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts[3:], budgets[3:])]
    res = srv.drain(max_steps=400)
    return [np.asarray(res[r].tokens()) for r in rids]


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_served_greedy_tokens_match_jax_serving_engine(kv):
    params = _params()
    prompts = _prompts(6, 3, 20, seed=1)
    budgets = [6, 3, 5, 2, 4, 7]
    conf = dict(num_slots=2, prefill_chunk=8, max_len=64, max_new_tokens=8, kv_cache_dtype=kv)
    jeng = deepspeed_tpu.init_inference(model_config=JTINY, params=params, dtype=jnp.float32,
                                        max_out_tokens=JTINY.n_positions)
    ref = _churn(JServingEngine(jeng, **conf), prompts, budgets)
    srv = ServingEngine(_port_engine(params), **conf)
    got = _churn(srv, prompts, budgets)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert srv.stats()["finished"] == 6 and srv.pool.free_slots == 2


def test_served_greedy_tokens_match_solo_generate():
    eng = _port_engine()
    srv = ServingEngine(eng, num_slots=3, prefill_chunk=16, max_len=128)
    prompts = _prompts(7, 5, 40, seed=2)
    budgets = [5, 9, 3, 6, 4, 8, 2]
    got = _churn(srv, prompts, budgets)
    for p, n, g in zip(prompts, budgets, got):
        np.testing.assert_array_equal(g, eng.generate(p[None, :], max_new_tokens=n)[0])


def test_eos_retires_at_token_granularity():
    eng = _port_engine()
    srv = ServingEngine(eng, num_slots=2, prefill_chunk=8, max_len=64)
    prompt = _prompts(1, 6, 6, seed=3)[0]
    solo = eng.generate(prompt[None, :], max_new_tokens=6)[0]
    eos = int(solo[len(prompt) + 2])
    first = int(np.nonzero(solo[len(prompt):] == eos)[0][0])
    rid = srv.submit(prompt, max_new_tokens=6, eos_token_id=eos)
    res = srv.drain(max_steps=50)[rid]
    assert res.finish_reason == "eos"
    np.testing.assert_array_equal(res.tokens(), solo[: len(prompt) + first + 1])
    assert srv.pool.free_slots == 2


def test_queue_full_and_capacity_validation():
    eng = _port_engine()
    srv = ServingEngine(eng, num_slots=1, prefill_chunk=8, max_len=64, max_queue=2)
    srv.submit(np.arange(1, 5), max_new_tokens=2)
    srv.submit(np.arange(1, 5), max_new_tokens=2)
    with pytest.raises(ServingQueueFull):
        srv.submit(np.arange(1, 5), max_new_tokens=2)
    with pytest.raises(ValueError, match="exceeds the serving capacity"):
        ServingEngine(eng, num_slots=1, prefill_chunk=8, max_len=64).submit(
            np.arange(1, 60), max_new_tokens=10)
    with pytest.raises(ValueError, match="generation capacity"):
        ServingEngine(eng, prefill_chunk=8, max_len=256)
    with pytest.raises(DeepSpeedConfigError, match="multiple of prefill_chunk"):
        ServingEngine(eng, prefill_chunk=8, max_len=60)
    with pytest.raises(DeepSpeedConfigError, match="num_slot"):
        ServingConfig.from_dict({"num_slot": 2})


def test_pool_capacity_keeps_the_jax_engines_rule():
    """Derived max_len: the capacity floored to lcm(chunk, 128) (the JAX
    engine's rule with its decode kernel armed), else to a chunk
    multiple."""
    eng = _port_engine(max_out_tokens=128)
    assert ServingEngine(eng, prefill_chunk=48).pool.max_len == 96   # lcm 384 > 128
    assert ServingEngine(eng, prefill_chunk=64).pool.max_len == 128
    pool = SlotKVPool(2, 3, 4, 32, 16, torch.float32)
    slots = [pool.alloc(f"r{i}") for i in range(3)]
    assert sorted(slots) == [0, 1, 2] and pool.alloc("r3") is None
    pool.free(slots[1])
    assert pool.alloc("r4") == slots[1]
    with pytest.raises(SlotPoolError):
        pool.free(7)


@pytest.mark.parametrize("block", [
    {"fleet": {"replicas": 2}},
    {"frontdoor": {"enabled": True}},
])
def test_unported_config_blocks_raise(block):
    """The fleet and the front door, once refused naming ROADMAP A8, are
    ported: each block parses, and an engine takes the config
    (``tests/test_torch_config.py`` holds them against the JAX package)."""
    cfg = ServingConfig.from_dict(block)
    assert cfg.fleet.replicas == block.get("fleet", {}).get("replicas", 1)
    assert cfg.frontdoor.enabled == block.get("frontdoor", {}).get("enabled", False)
    eng = _port_engine(max_out_tokens=64)
    assert ServingEngine(eng, cfg).config.fleet == cfg.fleet


@pytest.mark.parametrize("block", [
    {"enabled": True},
    {"enabled": True, "page_len": 16, "num_pages": 40, "pinned_prefixes": [[1, 2, 3]],
     "session_ttl_seconds": 2.5, "spill_dir": "/s",
     "tiers": {"host_pages": 8, "demote_watermark": 0.5}},
])
def test_kvcache_block_parses_like_jax(block):
    """The paged pool's block is ported: it parses to the JAX package's
    KVCacheConfig, field for field, its tiers too."""
    got = ServingConfig.from_dict({"kvcache": block}).kvcache
    assert dataclasses.asdict(got) == dataclasses.asdict(JKVCacheConfig.from_dict(block))


def test_sampled_tokens_reproducible_across_slot_churn():
    """A sampled request's tokens depend on its (seed, position) draws
    only: the same request alone and amid churn on another slot gives the
    same tokens; another seed gives others."""
    eng = _port_engine()
    prompt = _prompts(1, 9, 9, seed=4)[0]
    kw = dict(max_new_tokens=8, do_sample=True, temperature=1.5, top_k=20)

    alone = ServingEngine(eng, num_slots=1, prefill_chunk=8, max_len=64)
    rid = alone.submit(prompt, seed=11, **kw)
    solo_tokens = alone.drain()[rid].tokens()

    busy = ServingEngine(eng, num_slots=3, prefill_chunk=8, max_len=64)
    others = [busy.submit(p, max_new_tokens=3) for p in _prompts(2, 4, 12, seed=5)]
    busy.step()
    rid2 = busy.submit(prompt, seed=11, **kw)
    rid3 = busy.submit(prompt, seed=12, **kw)
    res = busy.drain()
    assert res[rid2].slot != 0 or res[others[0]].slot != 0
    np.testing.assert_array_equal(res[rid2].tokens(), solo_tokens)
    assert not np.array_equal(res[rid3].tokens(), solo_tokens)
    with pytest.raises(ValueError, match="max_top_k"):
        busy.submit(prompt, do_sample=True, top_k=500)
