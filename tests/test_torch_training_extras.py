"""The port's training extras against the JAX package's, on the CPU:
progressive layer drop, MoQ, the eigenvalue probe, CSR tensors and
TiledLinear, and the engine's wiring of them.

Tolerances (f32):
* PLD: ``layer_keep_probs`` bit for bit given the same theta; the theta
  schedule is the host formula rounded once to f32, bit for bit, and
  within one f32 ulp of the JAX package's (XLA's f32 ``exp`` is not
  correctly rounded on the CPU: ROADMAP C4).  With the keep decisions
  pinned on both sides (JAX: ``jax.random.bernoulli`` monkeypatched in the
  test; the port: ``torch.rand``), the forward within 1e-5 of JAX's.
* MoQ: ``current_bits`` equal; ``quantize_params`` with nearest rounding
  within 1e-6 absolute (one rounding of a scale may move a value by a
  quantization step only at an exact tie, which these inputs avoid).
* The eigenvalue: the quadratic within 1 % of its top eigenvalue 5 (the
  JAX package's test); GPT2_TINY with plain attention from the same start
  vector within 1e-3 relative of JAX's (the same power iteration on HVPs
  that agree to f32 rounding).
* CSR: bit for bit; TiledLinear: forward and gradients within 5e-6
  (sums of up to 37 products of order one, in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime import csr_tensor as jcsr
from deepspeed_tpu.runtime import progressive_layer_drop as jpld
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JEigenvalue
from deepspeed_tpu.runtime.quantize import Quantizer as JQuantizer
from deepspeed_tpu.runtime.zero import tiling as jtiling
from deepspeed_tpu_torch.config.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa
from deepspeed_tpu_torch.runtime import csr_tensor as tcsr
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue
from deepspeed_tpu_torch.runtime.quantize import Quantizer
from deepspeed_tpu_torch.runtime.zero import tiling as ttiling

FWD_TOL = 1e-5
QDQ_TOL = 1e-6
EIG_RTOL = 1e-3
TILE_TOL = 5e-6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


# ---------------------------------------------------------------------------
# progressive layer drop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta,gamma", [(0.5, 0.001), (0.3, 0.01)])
def test_pld_schedule_and_keep_probs_match_jax(theta, gamma):
    j, t = jpld.ProgressiveLayerDrop(theta, gamma), tpld.ProgressiveLayerDrop(theta, gamma)
    for step in range(0, 6000, 13):
        got = t.get_theta(step).numpy()
        assert got == np.float32(t.theta_at(step))  # the host formula, rounded once
        want = np.float32(j.get_theta(step))
        assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1
        for n in (2, 12, 36):
            np.testing.assert_array_equal(tpld.layer_keep_probs(want, n).numpy(),
                                          np.asarray(jpld.layer_keep_probs(want, n)))
        j.update_state(step)
        t.update_state(step)
        assert t.get_state() == j.get_state()
    assert tpld.PLD_THETA_KEY == jpld.PLD_THETA_KEY


def test_pld_forward_with_pinned_decisions_matches_jax(monkeypatch):
    """Keep probs at theta 0.5 over 2 layers are 0.75 and 0.5; both sides
    keep a layer iff its probability exceeds 0.6: layer 0 runs, layer 1 is
    skipped whole (its attention never runs)."""
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256)
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=256)
    params = jgpt2.init_params(jcfg, 0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    theta = np.float32(0.5)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p: p > 0.6)
    want = np.asarray(jgpt2.apply(params, jnp.asarray(ids), jcfg, rng=jax.random.PRNGKey(0),
                                  deterministic=False, pld_theta=jnp.float32(theta)))
    monkeypatch.undo()
    calls = []
    ref = tfa.flash_fwd_reference
    monkeypatch.setattr(tfa, "flash_fwd_reference", lambda *a, **k: calls.append(1) or ref(*a, **k))
    monkeypatch.setattr(torch, "rand", lambda n, generator=None: torch.full((n,), 0.6))
    got = tgpt2.apply(tgpt2.params_from_jax(params), torch.from_numpy(ids), cfg,
                      generator=torch.Generator().manual_seed(0), deterministic=False,
                      pld_theta=torch.tensor(theta))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_TOL, rtol=0)
    assert len(calls) == 1  # the kept layer's attention only
    # no theta, or eval: every layer runs
    full = tgpt2.apply(tgpt2.params_from_jax(params), torch.from_numpy(ids), cfg,
                       generator=None, deterministic=True, pld_theta=torch.tensor(theta))
    assert len(calls) == 1 + cfg.n_layer and not torch.allclose(full, got)


# ---------------------------------------------------------------------------
# MoQ
# ---------------------------------------------------------------------------

def _qcfg(**kw):
    d = {"train_batch_size": 1, "quantize_training": {"enabled": True, **kw}}
    return TConfig(d).quantize_training, JConfig(d, world_size=1).quantize_training


@pytest.mark.parametrize("kw", [{}, {"quantize_schedule_offset": 1},
                                {"quantize_bits_start": 12, "quantize_bits_target": 4,
                                 "quantize_schedule_offset": 7}])
def test_moq_bits_schedule_matches_jax(kw):
    tc, jc = _qcfg(**kw)
    t, j = Quantizer(tc), JQuantizer(jc)
    for step in range(0, 5000, 3):
        assert t.current_bits(step) == int(j.current_bits(step)), step
    t.scale_period_by_eigenvalue(2.0, 5.0)
    j.scale_period_by_eigenvalue(2.0, 5.0)
    assert t.q_period == j.q_period


@pytest.mark.parametrize("kw", [{"quantize_groups": 2}, {"quantize_groups": 3},
                                {"quantize_type": "asymmetric", "quantize_groups": 4}],
                         ids=["sym-g2", "sym-g3-fallback", "asym-g4"])
def test_moq_quantize_params_nearest_matches_jax(kw):
    tc, jc = _qcfg(quantize_bits_start=8, quantize_bits_target=4, quantize_schedule_offset=2,
                   **kw)
    params = jgpt2.init_params(jgpt2.GPT2_TINY, 0)
    for step in (0, 3, 10):
        want = _flat(JQuantizer(jc).quantize_params(params, step))
        got = _flat(Quantizer(tc).quantize_params(
            tgpt2.params_from_jax(params), step))
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=QDQ_TOL, rtol=0, err_msg=k)
            if not (k.endswith("_w") and "wte" not in k):
                np.testing.assert_array_equal(got[k], np.asarray(_flat(params)[k]))


def _engine(extra, cfg=None, opt=None):
    cfg = cfg or dataclasses.replace(tgpt2.GPT2_TINY, n_positions=64)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    conf = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 1,
            "optimizer": opt or {"type": "AdamW", "params": {"lr": 1e-3}}, **extra}
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                             config=conf, device="cpu")
    return eng


def test_moq_engine_trains_onto_the_grid():
    eng = _engine({"quantize_training": {
        "enabled": True, "quantize_bits_start": 16, "quantize_bits_target": 8,
        "quantize_schedule_offset": 1, "quantize_groups": 2, "quantize_rounding": "stochastic"}})
    batch = {"input_ids": np.random.default_rng(1).integers(0, 512, (4, 64))}
    losses = [float(eng.train_batch(batch)) for _ in range(10)]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    assert eng.quantizer.current_bits(eng.global_steps - 1) == 8
    qkv = eng.params["blocks"]["qkv_w"]  # (L, d, 3d): 2 groups a layer
    for layer in qkv:
        for group in layer.reshape(2, -1):
            assert torch.unique(group).numel() <= 2**8
    wte = eng.params["wte"]
    assert torch.unique(wte).numel() > 2**12  # embeddings stay full precision


def test_moq_keeps_the_unquantized_masters_on_an_overflow_step():
    eng = _engine({"fp16": {"enabled": True, "initial_scale_power": 4},
                   "quantize_training": {"enabled": True, "quantize_bits_start": 4,
                                         "quantize_bits_target": 4,
                                         "quantize_schedule_offset": 1}})
    before = [p.detach().clone() for p in eng._params]
    eng._quantize_masters(torch.tensor(True))
    assert all(torch.equal(a, b) for a, b in zip(before, eng._params))
    eng._quantize_masters(torch.tensor(False))
    assert not all(torch.equal(a, b) for a, b in zip(before, eng._params))


def test_moq_and_pld_refusals():
    with pytest.raises(NotImplementedError, match="MoQ"):
        _engine({"zero_optimization": {"offload_optimizer": {"device": "cpu"}},
                 "quantize_training": {"enabled": True}})
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

    with pytest.raises(NotImplementedError, match="pipeline engine"):
        PipelineEngine(None, TConfig({"train_batch_size": 4,
                                      "progressive_layer_drop": {"enabled": True}}),
                       device="cpu")


def test_pld_engine_feeds_theta_and_advances_it():
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=64, dropout=0.1)
    eng = _engine({"progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.5}},
                  cfg=cfg)
    seen = []
    fn = eng._model_fn

    def spy(params, batch, generator):
        if generator is not None:  # training: the engine's theta
            seen.append(float(batch[tpld.PLD_THETA_KEY]))
        else:
            assert tpld.PLD_THETA_KEY not in batch
        return fn(params, batch, generator)

    eng._model_fn = spy
    batch = {"input_ids": np.random.default_rng(1).integers(0, 512, (4, 64))}
    for _ in range(4):
        assert np.isfinite(float(eng.train_batch(batch)))
    pld = tpld.ProgressiveLayerDrop(0.5, 0.5)
    assert seen == [float(pld.get_theta(s)) for s in range(4)]
    assert eng.progressive_layer_drop.get_state()["pld_theta"] == pld.theta_at(4)
    assert float(eng.eval_batch(batch)) > 0  # eval carries no theta


# ---------------------------------------------------------------------------
# eigenvalue
# ---------------------------------------------------------------------------

def test_eigenvalue_power_iteration_quadratic():
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((8, 8)))
    eigs = np.array([5.0, 3.0, 1.0, 0.5, 0.3, 0.2, 0.1, 0.05], np.float32)
    A = torch.from_numpy((((Q * eigs) @ Q.T + ((Q * eigs) @ Q.T).T) / 2).astype(np.float32))
    est = Eigenvalue(max_iter=200, tol=1e-4).compute_eigenvalue(
        lambda p: 0.5 * p["x"] @ A @ p["x"], {"x": torch.ones(8)})
    assert abs(est - 5.0) < 0.05, est


def test_eigenvalue_gpt2_probe_matches_jax_and_refuses_the_kernels():
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, use_flash_attention=False)
    tcfg = dataclasses.replace(tgpt2.GPT2_TINY, use_flash_attention=False, remat=False)
    params = jgpt2.init_params(jcfg, 0)
    ids = np.random.default_rng(2).integers(0, 512, (1, 32)).astype(np.int32)
    jloss = lambda p: jgpt2.loss_fn(p, {"input_ids": jnp.asarray(ids)}, cfg=jcfg,  # noqa: E731
                                    deterministic=True)
    jeig = JEigenvalue(max_iter=8, tol=1e-3)
    want = jeig.compute_eigenvalue(jloss, params)
    # the JAX start vector: normal draws from split(PRNGKey(0), n_leaves)
    leaves, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(0), len(leaves))
    start = jax.tree.unflatten(tdef, [np.asarray(jax.random.normal(k, l.shape, jnp.float32))
                                      for k, l in zip(keys, leaves)])
    tparams = tgpt2.params_from_jax(params)
    tloss = lambda p: tgpt2.loss_fn(p, {"input_ids": torch.from_numpy(ids)}, cfg=tcfg,  # noqa: E731
                                    deterministic=True)
    got = Eigenvalue(max_iter=8, tol=1e-3).compute_eigenvalue(
        tloss, tparams, start=tgpt2.params_from_jax(start))
    assert abs(got - want) <= EIG_RTOL * abs(want), (got, want)
    flash = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256, remat=False)
    fparams = tgpt2.params_from_jax(jgpt2.init_params(
        dataclasses.replace(jgpt2.GPT2_TINY, n_positions=256), 0))
    ids2 = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (1, 256)))
    with pytest.raises(RuntimeError, match="use_flash_attention=False"):
        Eigenvalue(max_iter=2).compute_eigenvalue(
            lambda p: tgpt2.loss_fn(p, {"input_ids": ids2}, cfg=flash, deterministic=True),
            fparams)


# ---------------------------------------------------------------------------
# CSR and TiledLinear
# ---------------------------------------------------------------------------

def test_csr_tensor_matches_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((20, 6)).astype(np.float32)
    a[rng.random(20) < 0.6] = 0.0
    b = rng.standard_normal((20, 6)).astype(np.float32)
    b[rng.random(20) < 0.7] = 0.0
    ja, jb = jcsr.CSRTensor.from_dense(a), jcsr.CSRTensor.from_dense(b)
    ta, tb = tcsr.CSRTensor.from_dense(torch.from_numpy(a)), tcsr.CSRTensor.from_dense(
        torch.from_numpy(b))
    np.testing.assert_array_equal(ta.indices.numpy(), ja.indices)
    np.testing.assert_array_equal(ta.values.numpy(), ja.values)
    assert ta.sparse_size() == ja.sparse_size() and ta.density == ja.density
    np.testing.assert_array_equal(ta.to_dense().numpy(), ja.to_dense())
    np.testing.assert_array_equal(ta.scale(0.5).to_dense().numpy(), ja.scale(0.5).to_dense())
    s, js = ta.add(tb), ja.add(jb)
    np.testing.assert_array_equal(s.indices.numpy(), js.indices)
    np.testing.assert_array_equal(s.values.numpy(), js.values)
    tc = tcsr.CSRTensor.from_dense(torch.from_numpy(a[::-1].copy()))
    jc = jcsr.CSRTensor.from_dense(a[::-1].copy())
    np.testing.assert_array_equal(tcsr.csr_allreduce_host(ta, [ta, tb, tc]).to_dense().numpy(),
                                  jcsr.csr_allreduce_host(ja, [ja, jb, jc]).to_dense())
    with pytest.raises(ValueError):
        tcsr.CSRTensor.from_dense(torch.zeros(2, 3, 4))


@pytest.mark.parametrize("splits", [(1, 1), (3, 2), (2, 5)])
def test_tiled_linear_matches_jax(splits):
    ins, outs = splits
    assert ttiling.split_dim(37, ins) == jtiling.split_dim(37, ins)
    jp = jtiling.init_tiled_linear(37, 29, ins, outs, seed=3)
    tp = ttiling.init_tiled_linear(37, 29, ins, outs, seed=3)
    assert jp.keys() == tp.keys() and all(np.array_equal(jp[k], tp[k]) for k in jp)
    jp = {k: v + 0.1 * (i + 1) for i, (k, v) in enumerate(jp.items())}  # nonzero biases
    x = np.random.default_rng(5).standard_normal((4, 37)).astype(np.float32)
    jy, (jgp, jgx) = jax.value_and_grad(
        lambda p, xx: jnp.sum(jnp.sin(jtiling.tiled_linear(p, xx))), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x))
    mod = ttiling.TiledLinear(37, 29, ins, outs, seed=3)
    w = np.concatenate([np.concatenate([jp[f"tile_{i}_{j}_w"] for j in range(outs)], axis=1)
                        for i in range(ins)], axis=0)
    bias = np.concatenate([jp[f"bias_{j}"] for j in range(outs)])
    mod.copy_params_from(torch.from_numpy(w), torch.from_numpy(bias))
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.sin(mod(tx)).sum()
    ty.backward()
    np.testing.assert_allclose(float(ty), float(jy), atol=TILE_TOL * 10, rtol=TILE_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=TILE_TOL, rtol=0)
    for k, p in mod.tiles.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[k]), atol=TILE_TOL, rtol=0)
    dense = torch.from_numpy(x) @ torch.from_numpy(w) + torch.from_numpy(bias)
    torch.testing.assert_close(mod(torch.from_numpy(x)), dense, atol=TILE_TOL, rtol=0)
