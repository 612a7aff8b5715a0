"""The port's mixture-of-experts (deepspeed_tpu_torch.moe, the MoE
branches of models/gpt2.py and ops/transformer/inference.py) against the
JAX package's, on the CPU, in float32.

Tolerances:
* routing: dispatch bit for bit (it is 0/1 from the same argmax, cumsum
  and capacity rules); combine and aux 1e-6 (f32 softmax and sums in
  another order);
* ``moe_ffn``'s output and gradients 1e-5 (f32 matmuls; the port adds
  each token's <= k gated rows where JAX contracts dense (T, E, C)
  tensors, the same nonzero terms);
* GPT-2-MoE's loss 1e-5 relative and gradients 2e-5 absolute (two
  blocks deep, gradients ~1e-3-1);
* decode logits 1e-4 (test_torch_inference.py's bound; greedy tokens equal).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.moe import layer as jmoe
from deepspeed_tpu.ops.transformer import inference as jinf
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.moe import layer as tmoe
from deepspeed_tpu_torch.ops.transformer import inference as tinf

GATE_TOL = 1e-6
FFN_TOL = 1e-5
LOSS_RTOL, GRAD_ATOL = 1e-5, 2e-5
LOGIT_TOL = 1e-4


def _logits(T, E, seed, ties=0):
    x = np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)
    if ties:  # equal scores: the first index wins, then the next
        x[:ties] = 0.25
    return x


def _mask(T, seed):
    return (np.random.default_rng(seed).random(T) < 0.6).astype(np.float32)


@pytest.mark.parametrize("top_k,capacity,ties,masked", [
    (1, 16, 0, False),   # top-1, no drops
    (2, 16, 0, False),   # top-2, capacity shared across rounds
    (2, 5, 0, False),    # capacity drops in both rounds
    (1, 3, 0, False),    # top-1 drops
    (2, 6, 4, False),    # ties
    (2, 6, 0, True),     # pads route nowhere, out of aux
    (3, 7, 3, True),     # top-3 with ties, pads and drops
])
def test_top_k_gating_matches_jax(top_k, capacity, ties, masked):
    T, E = 32, 4
    logits = _logits(T, E, seed=top_k * 10 + capacity, ties=ties)
    mask = _mask(T, seed=capacity) if masked else None
    jd, jc, ja = jmoe.top_k_gating(jnp.asarray(logits), top_k, capacity,
                                   token_mask=None if mask is None else jnp.asarray(mask))
    td, tc, ta = tmoe.top_k_gating(torch.from_numpy(logits), top_k, capacity,
                                   token_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=GATE_TOL, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_TOL, rtol=GATE_TOL)
    if capacity < T * top_k // E:
        assert td.sum() < (T if mask is None else mask.sum()) * top_k  # something dropped


def test_all_tokens_on_one_expert_keep_capacity():
    """tests/test_moe.py's skewed case: capacity 4 keeps 4 tokens, the
    rest are counted as dropped, and the aux penalizes the imbalance."""
    logits = np.zeros((32, 4), np.float32)
    logits[:, 0] = 10.0
    with tmoe.record_drops() as rec:
        rec.note(tmoe.route(torch.from_numpy(logits), 1, 4))
    d, _, aux = tmoe.top_k_gating(torch.from_numpy(logits), top_k=1, capacity=4)
    assert float(d[:, 0].sum()) == 4.0 and float(aux) > 2.0
    assert rec.counts() == {"assignments": 32, "dropped": 28}
    assert int(rec.tokens[0].sum()) == 28


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_ffn_value_and_grad_match_jax(training, masked):
    """Output, aux and the gradients of ``sum(y**2) + 0.01 * aux`` with
    respect to every parameter and the input, against
    ``jax.value_and_grad`` of the JAX layer."""
    mcfg_j = jmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32, top_k=2, capacity_factor=1.25)
    mcfg_t = tmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32, top_k=2, capacity_factor=1.25)
    params = jmoe.init_moe_params(mcfg_j, np.random.default_rng(0))
    tparams0 = tmoe.init_moe_params(mcfg_t, np.random.default_rng(0))
    for k in params:
        np.testing.assert_array_equal(params[k], tparams0[k])
    x = np.random.default_rng(1).standard_normal((2, 16, 16)).astype(np.float32)
    mask = (np.random.default_rng(2).random((2, 16)) < 0.7).astype(np.float32) if masked else None

    def jloss(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, mcfg_j, training=training,
                              token_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

    (jl, (jy, ja)), (jg, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    ty, ta = tmoe.moe_ffn(tp, tx, mcfg_t, generator=torch.Generator() if training else None,
                          training=training,
                          token_mask=None if mask is None else torch.from_numpy(mask))
    tl = (ty ** 2).sum() + 0.01 * ta
    tl.backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=FFN_TOL, rtol=0)
    np.testing.assert_allclose(float(ta.detach()), float(ja), atol=GATE_TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=FFN_TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]), atol=FFN_TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=FFN_TOL, rtol=0)
    assert float(np.abs(tp["gate_w"].grad.numpy()).sum()) > 0  # the router learns


TINY_MOE_J = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=64, n_experts=4, remat=False)
TINY_MOE_T = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=64, n_experts=4, remat=False)


def test_moe_params_and_num_params_match_jax():
    jp = jgpt2.init_params(TINY_MOE_J, seed=3)
    tp = tgpt2.init_params(TINY_MOE_T, seed=3)
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
    conv = tgpt2.params_from_jax(jp)
    assert set(conv["blocks"]) == set(tgpt2.MOE_BLOCK_KEYS)
    np.testing.assert_array_equal(conv["blocks"]["w1"].numpy(), jp["blocks"]["w1"])
    for cfg in (TINY_MOE_T, dataclasses.replace(tgpt2.GPT2_SMALL, n_experts=8)):
        jcfg = dataclasses.replace(jgpt2.GPT2Config(), **{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "n_experts")})
        assert cfg.num_params() == jcfg.num_params()
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tp))
    assert n == TINY_MOE_T.num_params()
    with pytest.raises(NotImplementedError, match="device init does not cover MoE"):
        tgpt2.init_params_device(TINY_MOE_T, device="cpu")


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_gpt2_moe_loss_and_grads_match_jax(training, masked):
    """``loss_fn`` with the aux term, and its gradients: training capacity
    (1.25) when a generator is threaded in, eval capacity (2.0) when not;
    ``attention_mask`` keeps pads out of the routing."""
    jp = jgpt2.init_params(TINY_MOE_J, seed=4)
    ids = np.random.default_rng(5).integers(0, 512, (2, 64), dtype=np.int32)
    batch = {"input_ids": ids}
    if masked:
        am = np.ones((2, 64), np.int32)
        am[1, 40:] = 0
        batch["attention_mask"] = am
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0) if training else None
    jl, jg = jax.value_and_grad(lambda p: jgpt2.loss_fn(p, jbatch, rng=rng, cfg=TINY_MOE_J,
                                                        deterministic=True))(
        jax.tree.map(jnp.asarray, jp))

    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a), requires_grad=True), jp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl = tgpt2.loss_fn(tp, tbatch, generator=torch.Generator() if training else None,
                       cfg=TINY_MOE_T, deterministic=True)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(tp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_gpt2_moe_capacity_follows_training_flag():
    """Training routes at capacity 1.25, eval at 2.0: on a batch that
    overflows the training capacity the two losses differ, as in JAX."""
    tp = jax.tree.map(torch.from_numpy, tgpt2.init_params(TINY_MOE_T, seed=4))
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 64), dtype=np.int64))
    with torch.no_grad():
        with tmoe.record_drops() as rec:
            tgpt2.loss_fn(tp, {"input_ids": ids}, generator=torch.Generator(), cfg=TINY_MOE_T)
        train_drops = rec.counts()
        with tmoe.record_drops() as rec:
            tgpt2.loss_fn(tp, {"input_ids": ids}, generator=None, cfg=TINY_MOE_T)
        eval_drops = rec.counts()
    assert train_drops["assignments"] == eval_drops["assignments"] == 2 * 2 * 128
    assert train_drops["dropped"] > eval_drops["dropped"]


def test_drops_counted_only_when_recorded_and_once_under_remat():
    """Outside ``record_drops`` nothing is noted; inside it a training
    step's checkpointed blocks count their routing once (the forward),
    not again in the backward's recompute."""
    cfg = dataclasses.replace(TINY_MOE_T, remat=True)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                      tgpt2.init_params(cfg, seed=4))
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 64), dtype=np.int64))
    tgpt2.loss_fn(tp, {"input_ids": ids}, generator=torch.Generator(), cfg=cfg).backward()
    assert tmoe._RECORD is None
    with tmoe.record_drops() as rec:
        tgpt2.loss_fn(tp, {"input_ids": ids}, generator=torch.Generator(), cfg=cfg).backward()
    assert len(rec.tokens) == cfg.n_layer
    assert rec.counts()["assignments"] == cfg.n_layer * 2 * 128


def _icfgs(S, cfg):
    j = jinf.DeepSpeedInferenceConfig(hidden_size=cfg.n_embd, heads=cfg.n_head, dtype=jnp.float32,
                                      max_out_tokens=S, moe_top_k=cfg.moe_top_k)
    t = tinf.DeepSpeedInferenceConfig(hidden_size=cfg.n_embd, heads=cfg.n_head,
                                      dtype=torch.float32, max_out_tokens=S,
                                      moe_top_k=cfg.moe_top_k)
    return j, t


@pytest.mark.parametrize("paged", [False, True])
def test_moe_decode_logits_match_jax(paged):
    """A prefill chunk per slot, then decode steps over both slots, on
    the slot pool or through permuted page tables: the port's MoE decode
    logits equal JAX's ``forward_with_cache`` (no token mask, as JAX's
    decode: both rows route and take capacity)."""
    jp = jgpt2.init_params(TINY_MOE_J, seed=6)
    jp["wpe"] = jp["wpe"] * 40.0
    tp = tgpt2.params_from_jax(jp)
    jpj = jax.tree.map(jnp.asarray, jp)
    cfg = TINY_MOE_T
    S, B, page_len = 32, 2, 8
    jcfg, tcfg = _icfgs(S, cfg)
    if paged:
        NP = 1 + B * S // page_len
        table = np.random.default_rng(1).permutation(np.arange(1, NP, dtype=np.int32))
        table = table.reshape(B, S // page_len)
        jk, jv = jinf.init_kv_cache(cfg.n_layer, NP, cfg.n_head, page_len, cfg.head_dim, jnp.float32)
        tk, tv = tinf.init_kv_cache(cfg.n_layer, NP, cfg.n_head, page_len, cfg.head_dim,
                                    torch.float32)
    else:
        jk, jv = jinf.init_kv_cache(cfg.n_layer, B, cfg.n_head, S, cfg.head_dim, jnp.float32)
        tk, tv = tinf.init_kv_cache(cfg.n_layer, B, cfg.n_head, S, cfg.head_dim, torch.float32)
    toks = np.random.default_rng(2).integers(1, 512, (B, 8), dtype=np.int32)
    # both slots prefill 8 tokens in one batched chunk at per-slot offset 0
    pos = np.zeros((B,), np.int32)
    kw_j = {"page_table": jnp.asarray(table), "write_mask": jnp.ones((B,), bool)} if paged else {}
    kw_t = ({"page_table": torch.from_numpy(table), "write_mask": torch.ones((B,), dtype=torch.bool)}
            if paged else {})
    jl, jk, jv = jinf.forward_with_cache(jpj, jnp.asarray(toks), jk, jv, jnp.asarray(pos), jcfg, **kw_j)
    tl, tk, tv = tinf.forward_with_cache(tp, torch.from_numpy(toks), tk, tv, torch.from_numpy(pos),
                                         tcfg, **kw_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos = pos + 8
    for _ in range(4):
        jl, jk, jv = jinf.forward_with_cache(jpj, jnp.asarray(nxt), jk, jv, jnp.asarray(pos), jcfg,
                                             **kw_j)
        tl, tk, tv = tinf.forward_with_cache(tp, torch.from_numpy(nxt), tk, tv,
                                             torch.from_numpy(pos), tcfg, **kw_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=0)
        nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
        assert (tl[:, -1].argmax(-1).numpy() == nxt[:, 0]).all()
        pos = pos + 1


def test_moe_generate_matches_forward():
    """tests/test_moe.py's ``test_moe_generate_matches_forward`` on the
    port: KV-cache decode through the expert layer reproduces the full
    forward's greedy continuation, and the JAX engine's tokens."""
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, remat=False, n_experts=4, moe_top_k=2,
                              moe_capacity_factor=2.0)
    eng = deepspeed_tpu_torch.init_inference(model_config=cfg, dtype=torch.float32, seed=2,
                                             device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6), dtype=np.int32)
    out = np.asarray(eng.generate(toks, max_new_tokens=4))
    assert out.shape == (2, 10)
    cur = toks.copy()
    for _ in range(4):
        logits = np.asarray(eng.forward(cur))
        cur = np.concatenate([cur, logits[:, -1].argmax(-1)[:, None].astype(np.int32)], axis=1)
    np.testing.assert_array_equal(out, cur)
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, remat=False, n_experts=4, moe_top_k=2,
                               moe_capacity_factor=2.0)
    jeng = deepspeed_tpu.init_inference(model_config=jcfg, dtype=jnp.float32, seed=2)
    np.testing.assert_array_equal(out, np.asarray(jeng.generate(toks, max_new_tokens=4)))


def test_moe_serving_matches_solo_generate():
    """``init_serving`` over a MoE model on the slot pool and the paged
    pool: a request served alone gives solo ``generate()``'s tokens."""
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, remat=False, n_experts=4)
    for serving in ({"num_slots": 1, "prefill_chunk": 8},
                    {"num_slots": 1, "prefill_chunk": 8,
                     "kvcache": {"enabled": True, "page_len": 16}}):
        srv = deepspeed_tpu_torch.init_serving(model_config=cfg, dtype=torch.float32,
                                               device="cpu", serving=serving)
        prompt = np.random.default_rng(3).integers(1, 512, (12,), dtype=np.int32)
        rid = srv.submit(prompt, max_new_tokens=5)
        got = np.asarray(srv.drain()[rid].tokens())
        solo = np.asarray(srv.engine.generate(prompt[None], max_new_tokens=5)[0])
        np.testing.assert_array_equal(got, solo)
