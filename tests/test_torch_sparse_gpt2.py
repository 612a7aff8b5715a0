"""GPT-2 with ``attention_mode="sparse"`` in the port against the JAX
package, on the CPU, in float32.

``GPT2_TINY`` with 256 positions at T 256 takes the default BigBird layout
(block 64: the first of 256/128/64/16 that divides T with at least three
blocks; one random block, a window of three, one global block,
unidirectional) on both sides, each through its gather path: off the card
the port's auto route is gather, as the JAX package's is off the TPU.

* ``apply`` logits within 1e-5 of JAX's ``gpt2.apply`` on the same weights
  (``params_from_jax``): f32 sums in other orders.
* Five ``train_batch`` steps (gradient accumulation 2, clipping, AdamW,
  ``WarmupDecayLR``) against the JAX engine on a one-device mesh: losses
  within 2e-5 relative, the bound of test_torch_training.py's f32
  trajectory.
* The same steps with the sparse op on ``backend="splash"``
  (``_SplashAttention``, under remat, with the kernels' plain versions
  off the card) against ``backend="gather"``: losses within 1e-5
  relative, the bound chip_smoke.py holds the kernels to on the card.
* ``"ring"`` and ``"ulysses"`` (refused until they were ported) build and
  train: with one ``seq`` rank both fall back to flash attention, as in
  the JAX package, so two steps give flash's losses and masters bit for
  bit; without a mesh they raise the JAX package's error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import sparse as ts

T = 256
STEPS = 5
LOGIT_TOL = 1e-5
LOSS_RTOL = 2e-5
SPLASH_LOSS_RTOL = 1e-5


def _cfgs():
    j = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=T, attention_mode="sparse")
    t = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T, attention_mode="sparse")
    return j, t


def _config():
    return {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 10, "warmup_num_steps": 2, "warmup_min_lr": 1e-4,
            "warmup_max_lr": 1e-3}},
        "steps_per_print": 1000,
    }


def _batch(vocab):
    return {"input_ids": np.random.default_rng(0).integers(0, vocab, (4, T), dtype=np.int32)}


def _torch_losses(cfg, steps):
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=3), config=_config(), device="cpu")
    batch = _batch(cfg.vocab_size)
    return [float(eng.train_batch(batch)) for _ in range(steps)]


def test_sparse_logits_match_jax():
    jcfg, tcfg = _cfgs()
    tree = jgpt2.init_params(jcfg, seed=1)
    ids = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, T), dtype=np.int32)
    want = np.asarray(jgpt2.apply(tree, jnp.asarray(ids), jcfg))
    got = tgpt2.apply(tgpt2.params_from_jax(tree), torch.tensor(ids), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    # the default layout is BigBird at block 64, cached by config values
    key = tgpt2._sparsity_cache_key(ts.BigBirdSparsityConfig(
        num_heads=4, block=64, num_random_blocks=1, num_sliding_window_blocks=3,
        num_global_blocks=1, attention="unidirectional"), T)
    assert key in tgpt2._SPARSE_LAYOUTS and tgpt2._SPARSE_LAYOUTS[key].shape == (4, 4, 4)


def test_sparse_train_batch_trajectory_matches_jax_engine():
    jcfg, tcfg = _cfgs()
    model_fn, init_fn, tp_fn = jgpt2.make_model(jcfg)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, _, _, _ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                            config=_config(), mesh=mesh, tp_spec_fn=tp_fn)
    batch = _batch(jcfg.vocab_size)
    want = [float(eng.train_batch(batch)) for _ in range(STEPS)]
    got = _torch_losses(tcfg, STEPS)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_sparse_steps_through_the_splash_function_equal_the_gather_path(monkeypatch):
    _, tcfg = _cfgs()
    gather = _torch_losses(tcfg, 2)
    calls = []

    def splash(q, k, v, layout, block, causal=False, **kw):
        calls.append(block)
        return ts.block_sparse_attention(q, k, v, layout, block, causal=causal, backend="splash")

    monkeypatch.setattr(tgpt2, "block_sparse_attention", splash)
    got = _torch_losses(tcfg, 2)
    # 2 layers x 2 micro-steps x 2 steps, each forward run again by remat
    assert calls and set(calls) == {64} and len(calls) == 2 * 2 * 2 * 2
    np.testing.assert_allclose(got, gather, rtol=SPLASH_LOSS_RTOL)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_sequence_parallel_modes_are_refused_naming_a6(mode):
    """The id is the refusal's, kept; the modes now run (multi-rank parity:
    tests/test_torch_sequence_parallel.py)."""
    ids = np.random.default_rng(5).integers(0, tgpt2.GPT2_TINY.vocab_size, (2, 4, T))
    runs = {}
    # the embedding's backward sums in thread order otherwise
    torch.use_deterministic_algorithms(True)
    try:
        for m in ("flash", mode):
            cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T, attention_mode=m)
            model_fn, init_fn, _ = tgpt2.make_model(cfg)
            eng, *_ = deepspeed_tpu_torch.initialize(
                model=model_fn, model_parameters=init_fn(seed=3), device="cpu",
                config={**_config(), "mesh": {"data": 1, "seq": 1, "model": 1}})
            losses = [float(eng.train_batch({"input_ids": ids[s]})) for s in range(2)]
            runs[m] = (losses, [p.detach().clone() for p in eng._params])
    finally:
        torch.use_deterministic_algorithms(False)
    assert runs[mode][0] == runs["flash"][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[mode][1], runs["flash"][1]))
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T, attention_mode=mode)
    with pytest.raises(ValueError, match="needs a mesh"):
        tgpt2.apply(tgpt2.params_from_jax(jgpt2.init_params(jgpt2.GPT2_TINY, seed=0)),
                    torch.zeros(1, 8, dtype=torch.long), cfg)


def test_unknown_attention_mode_raises_as_the_jax_package_does():
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, attention_mode="local")
    with pytest.raises(ValueError, match="unknown attention_mode"):
        tgpt2.apply(tgpt2.params_from_jax(jgpt2.init_params(jgpt2.GPT2_TINY, seed=0)),
                    torch.zeros(1, 8, dtype=torch.long), cfg)
