"""Parity of the port's KV-cache inference path (deepspeed_tpu_torch) with
the JAX package's, on the CPU, in float32.

One small GPT-2 (vocab 512, 512 positions, d 64, 2 layers, 4 heads) is
initialized once from a numpy seed (``init_params`` is the same code on
both sides) and handed to both.  The JAX initial prefill at T=256 runs
its Pallas flash kernel in interpret mode (its default off the TPU); the
port takes the plain versions of its kernels.

Tolerance: logits 1e-4 absolute — several f32 matmuls deep, with sums in
different orders on the two sides (the attention functions alone hold
2e-5; see test_torch_flash_attention.py).  Greedy tokens must be equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.transformer import inference as jinf
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.transformer import inference as tinf

LOGIT_TOL = 1e-4

JCFG = dataclasses.replace(jgpt2.GPT2Config(vocab_size=512, n_positions=512, n_embd=64,
                                            n_layer=2, n_head=4), remat=False)
TCFG = tgpt2.GPT2Config(vocab_size=512, n_positions=512, n_embd=64, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def params():
    p = jgpt2.init_params(JCFG, seed=5)
    p["wpe"] = p["wpe"] * 40.0  # position-sensitive: offset bugs change outputs
    return p


def _icfgs(S):
    j = jinf.DeepSpeedInferenceConfig(hidden_size=64, heads=4, dtype=jnp.float32, max_out_tokens=S)
    t = tinf.DeepSpeedInferenceConfig(hidden_size=64, heads=4, dtype=torch.float32, max_out_tokens=S)
    return j, t


def _jparams(p):
    return {k: ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict) else jnp.asarray(v))
            for k, v in p.items()}


def _tokens(B, T, seed):
    return np.random.default_rng(seed).integers(1, 512, (B, T), dtype=np.int32)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_forward_with_cache_prefill_continue_decode(params, kv):
    """Initial prefill T=256 (the JAX kernel path), a chunked
    continuation at a traced offset, then a per-slot decode step — logits
    and the caches agree after each."""
    B, S = 2, 320
    jcfg, tcfg = _icfgs(S)
    jp, tp = _jparams(params), tgpt2.params_from_jax(params)
    kd = "int8" if kv == "int8" else jnp.float32
    jk, jv = jinf.init_kv_cache(2, B, 4, S, 16, kd)
    tk, tv = tinf.init_kv_cache(2, B, 4, S, 16, "int8" if kv == "int8" else torch.float32)

    toks = _tokens(B, 256, 1)
    jl, jk, jv = jinf.forward_with_cache(jp, jnp.asarray(toks), jk, jv, 0, jcfg)
    tl, tk, tv = tinf.forward_with_cache(tp, torch.from_numpy(toks), tk, tv, 0, tcfg)
    assert _err(jl, tl) < LOGIT_TOL
    if kv == "f32":
        assert _err(jk, tk) < LOGIT_TOL

    more = _tokens(B, 16, 2)
    jl, jk, jv = jinf.forward_with_cache(jp, jnp.asarray(more), jk, jv, jnp.int32(256), jcfg)
    tl, tk, tv = tinf.forward_with_cache(tp, torch.from_numpy(more), tk, tv, torch.tensor(256), tcfg)
    assert _err(jl, tl) < LOGIT_TOL

    step = _tokens(B, 1, 3)
    pos = np.asarray([272, 100], np.int32)  # row 1 rewinds: any per-slot offset
    jl, jk, jv = jinf.forward_with_cache(jp, jnp.asarray(step), jk, jv, jnp.asarray(pos), jcfg)
    tl, tk, tv = tinf.forward_with_cache(tp, torch.from_numpy(step), tk, tv, torch.from_numpy(pos), tcfg)
    assert _err(jl, tl) < LOGIT_TOL
    if kv == "int8":
        # the K rows differ by f32 rounding, which may move a code across
        # a .5 boundary: codes agree within one step
        diff = np.abs(np.asarray(jk["q"], np.int32) - tk["q"].numpy().astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


def test_per_layer_cache_tuples_match_stacked(params):
    """The per-layer tuple cache form gives the stacked form's logits and
    writes into the same storage when the tuple holds views."""
    B, S = 3, 64
    _, tcfg = _icfgs(S)
    tp = tgpt2.params_from_jax(params)
    tk, tv = tinf.init_kv_cache(2, B, 4, S, 16, torch.float32)
    toks = torch.from_numpy(_tokens(B, 10, 4))
    tinf.forward_with_cache(tp, toks, tk, tv, 0, tcfg)
    k2, v2 = tk.clone(), tv.clone()
    step = torch.from_numpy(_tokens(B, 1, 5))
    a, _, _ = tinf.forward_with_cache(tp, step, tk, tv, 10, tcfg)
    b, _, _ = tinf.forward_with_cache(tp, step, tuple(k2), tuple(v2), 10, tcfg)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(tk, k2, rtol=0, atol=0)


def _engines(params, **kw):
    jeng = deepspeed_tpu.init_inference(model_config=JCFG, params=params, dtype=jnp.float32,
                                        max_out_tokens=512, **kw)
    teng = deepspeed_tpu_torch.init_inference(model_config=TCFG, params=params, dtype=torch.float32,
                                              max_out_tokens=512, device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("kv_cache_dtype", ["model", "int8"])
def test_greedy_generate_matches_jax(params, kv_cache_dtype):
    jeng, teng = _engines(params, kv_cache_dtype=kv_cache_dtype)
    ids = _tokens(2, 150, 6)  # T >= 128: the flash prefill path on both sides
    ref = np.asarray(jeng.generate(ids, max_new_tokens=6))
    got = teng.generate(ids, max_new_tokens=6)
    np.testing.assert_array_equal(ref, got)


def test_left_padded_generate_matches_jax(params):
    jeng, teng = _engines(params)
    ids = _tokens(2, 12, 7)
    mask = np.ones((2, 12), np.int32)
    mask[1, :5] = 0
    ids[1, :5] = 0
    ref = np.asarray(jeng.generate(ids, max_new_tokens=5, attention_mask=mask))
    got = teng.generate(ids, max_new_tokens=5, attention_mask=mask)
    np.testing.assert_array_equal(ref, got)


def test_prefill_decode_step_surface_matches_generate(params):
    _, teng = _engines(params)
    ids = _tokens(1, 20, 8)
    k, v = teng.init_cache(1, 24)
    logits, k, v = teng.prefill(ids, k, v)
    tok = int(torch.argmax(logits[0, -1]))
    logits2, k, v = teng.decode_step(np.asarray([[tok]]), k, v, 20)
    tok2 = int(torch.argmax(logits2[0, -1]))
    np.testing.assert_array_equal(teng.generate(ids, max_new_tokens=2)[0, 20:], [tok, tok2])
    with pytest.raises(ValueError, match="capacity"):
        teng.decode_step(np.asarray([[tok]]), k, v, 24)
    with pytest.raises(ValueError, match="generation capacity"):
        teng.init_cache(1, 513)


def test_engine_capacity_and_unported_options(params):
    _, teng = _engines(params)
    with pytest.raises(ValueError, match="generation capacity"):
        teng.generate(_tokens(1, 500, 9), max_new_tokens=13)
    with pytest.raises(ValueError, match="LEFT-padded"):
        teng.generate(_tokens(1, 4, 9), attention_mask=np.asarray([[1, 1, 0, 0]]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(model="tiny", quantize_bits=8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(model="tiny", mp_size=2, device="cpu")
