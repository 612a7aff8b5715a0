"""The port's BERT (deepspeed_tpu_torch.models.bert) against the JAX
package's, on the CPU: parameters carried across, the MLM + NSP loss and
its gradients, and five LAMB ``train_batch`` steps of the two engines.

Both sides take the same ``init_params`` seed and the same numpy batches:
synthetic masked-LM batches (15 % of positions labelled, the rest -100),
two segments, an NSP label, and a key-padding mask whose rows keep
different numbers of tokens.  At T 64 both packages take the dense
attention branch; ``BERT_TINY`` with 256 positions at T 256 takes the
flash kernels (the JAX Pallas kernels interpreted, the port the plain
versions of its CUDA kernels), with the mask as their key-row bias.

The block with attention dropout runs against JAX's ``_bert_block`` given
the same attention key words (JAX's ``r_attn``): the keep-bits are the
same Threefry bits on both sides.

Tolerances (f32 throughout):
* loss 2e-5 relative; gradients 2e-5 of each leaf's largest entry plus
  2e-5 relative: the same math in other summation orders (attention,
  matmuls, LayerNorm statistics).
* the LAMB trajectory: per-step losses 2e-5 relative, final parameters
  1e-5 absolute (parameters ~0.02-1): the JAX engine runs its Pallas LAMB
  kernels interpreted (``DS_KERNELS=1``), the port the plain version of
  its two LAMB kernels; the trust ratios' norms sum in other orders.
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
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.runtime.engine import tree_flatten

TOL = 2e-5
STEPS = 5
PARAM_ATOL = 1e-5


def _cfgs(T, pre_ln=True):
    kw = dict(max_position_embeddings=max(128, T), pre_layer_norm=pre_ln)
    return (dataclasses.replace(jbert.BERT_TINY, **kw),
            dataclasses.replace(tbert.BERT_TINY, **kw))


def synthetic_batch(vocab, B, T, seed=0, keep=None):
    """An MLM + NSP batch: ids, 15 % of the real positions labelled (the
    labelled ones replaced by id 103), two segments, an NSP label, and a
    padding mask whose row ``b`` keeps ``keep[b]`` tokens."""
    rng = np.random.default_rng(seed)
    keep = keep if keep is not None else [T - (37 * b) % (T // 2) for b in range(B)]
    mask = (np.arange(T)[None, :] < np.asarray(keep)[:, None]).astype(np.int32)
    ids = rng.integers(0, vocab, (B, T), dtype=np.int32)
    labels = np.where((rng.random((B, T)) < 0.15) & (mask > 0), ids, -100).astype(np.int32)
    return {
        "input_ids": np.where(labels != -100, 103 % vocab, ids).astype(np.int32),
        "token_type_ids": (np.arange(T)[None, :] >= (np.asarray(keep)[:, None] // 2)).astype(np.int32),
        "attention_mask": mask,
        "masked_lm_labels": labels,
        "next_sentence_label": rng.integers(0, 2, B).astype(np.int32),
    }


def _flat_np(tree):
    leaves, _ = tree_flatten(tree)
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.detach().numpy()
            for x in leaves]


def test_params_from_jax_round_trip_and_refusals():
    jcfg, tcfg = _cfgs(64)
    tree = jbert.init_params(jcfg, seed=3)
    got = tbert.params_from_jax(tree)
    assert set(got) == set(tree) and set(got["blocks"]) == set(tree["blocks"])
    mine = tbert.init_params(tcfg, seed=3)
    a, b, c = _flat_np(got), _flat_np(tree), _flat_np(mine)
    assert len(a) == len(b) == len(c) == 26
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert tuple(got["blocks"]["qkv_w"].shape) == (2, 64, 192)  # stacked, (in, out)
    assert tcfg.num_params() == sum(x.size for x in c)
    large = jax.eval_shape(lambda: jbert.init_params_device(jbert.BERT_LARGE))
    assert tbert.BERT_LARGE.num_params() == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(large)) == 336_226_108
    assert tbert.params_from_jax(tree, dtype=torch.bfloat16)["tok_emb"].dtype == torch.bfloat16
    extra = {**tree, "lm_head": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="lm_head"):
        tbert.params_from_jax(extra)
    missing = {**tree, "blocks": {k: v for k, v in tree["blocks"].items() if k != "fc_b"}}
    with pytest.raises(KeyError, match="fc_b"):
        tbert.params_from_jax(missing)
    # the published BERT-Large dropout builds (attention dropout is ported)
    published = dataclasses.replace(tbert.BERT_LARGE, hidden_dropout_prob=0.1,
                                    attention_probs_dropout_prob=0.1)
    assert published.attention_probs_dropout_prob == 0.1


def _jax_loss_and_grads(cfg, params, batch):
    def f(p):
        return jbert.mlm_nsp_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, rng=None,
                                  cfg=cfg, deterministic=True)

    loss, grads = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, params))
    return float(loss), grads


def _torch_loss_and_grads(cfg, params, batch):
    p = tbert.params_from_jax(params)
    leaves, _ = tree_flatten(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = tbert.mlm_nsp_loss(p, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                              cfg=cfg, deterministic=True)
    loss.backward()
    return float(loss.detach()), [t.grad for t in leaves]


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
@pytest.mark.parametrize("T", [64, 256], ids=["dense_T64", "kernel_T256"])
def test_mlm_nsp_loss_and_grads_match_jax(T, pre_ln):
    jcfg, tcfg = _cfgs(T, pre_ln)
    params = jbert.init_params(jcfg, seed=1)
    batch = synthetic_batch(jcfg.vocab_size, 2, T, seed=T, keep=[T, T // 2 + 3])
    want_loss, want = _jax_loss_and_grads(jcfg, params, batch)
    kernels.reset_launches()
    got_loss, got = _torch_loss_and_grads(tcfg, params, batch)
    assert got_loss == pytest.approx(want_loss, rel=TOL)
    want = _flat_np(want)
    assert len(got) == len(want) == 26
    for g, w in zip(got, want):
        bound = TOL * (np.abs(w) + np.abs(w).max())
        assert (np.abs(g.numpy() - w) <= bound).all(), float(np.abs(g.numpy() - w).max())
    assert all(n == 0 for n in kernels.launches().values())  # CPU: the plain versions


def _config():
    return {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0,
        "optimizer": {"type": "Lamb", "params": {
            "lr": 2e-3, "weight_decay": 0.01, "bias_correction": False,
            "max_coeff": 0.3, "min_coeff": 0.01}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 10, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
            "warmup_max_lr": 2e-3}},
        "steps_per_print": 1000,
    }


def test_lamb_train_batch_trajectory_matches_jax_engine(monkeypatch):
    """Five LAMB ``train_batch`` steps of BERT_TINY at T 256 (the flash
    kernels' branch) on one fixed padded batch, f32, against the JAX
    engine on a one-device mesh with its Pallas LAMB kernels."""
    T = 256
    jcfg, tcfg = _cfgs(T)
    batch = synthetic_batch(jcfg.vocab_size, 4, T, seed=5)
    monkeypatch.setenv("DS_KERNELS", "1")
    model_fn, init_fn, tp_fn = jbert.make_model(jcfg)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                        config=_config(), mesh=mesh, tp_spec_fn=tp_fn)
    want = [float(jeng.train_batch(batch)) for _ in range(STEPS)]

    model_fn, init_fn, _ = tbert.make_model(tcfg)
    teng, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=3), config=_config(), device="cpu")
    assert isinstance(opt, FusedLamb) and opt.max_coeff == 0.3 and not opt.bias_correction
    got = [float(teng.train_batch(batch)) for _ in range(STEPS)]
    assert teng.global_steps == STEPS and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=TOL)
    for a, b in zip(_flat_np(teng.params), _flat_np(jax.tree.map(np.asarray, jeng.state["params"]))):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("T", [64, 256], ids=["dense_T64", "kernel_T256"])
def test_block_with_attention_dropout_matches_jax(T):
    """One pre-LN block, attention dropout 0.1 (hidden off), a padding
    mask: output and gradients (x and every leaf of the layer) against
    JAX's ``_bert_block`` with ``deterministic=False``, the port given
    JAX's ``r_attn = split(rng, 3)[2]`` as its attention key."""
    jcfg, tcfg = (dataclasses.replace(c, attention_probs_dropout_prob=0.1) for c in _cfgs(T))
    params = jbert.init_params(jcfg, seed=4)
    lp = {k: v[0] for k, v in params["blocks"].items()}
    rng = np.random.default_rng(T)
    x, w = (rng.standard_normal((2, T, jcfg.hidden_size)).astype(np.float32) for _ in range(2))
    keep = np.array([T, T // 2 + 3])
    mask_bias = np.where(np.arange(T)[None, None, None, :] < keep[:, None, None, None], 0.0,
                         -1e9).astype(np.float32)
    key = jax.random.PRNGKey(17)

    def f(lp_, x_):
        out = jbert._bert_block(jcfg, x_, lp_, jnp.asarray(mask_bias), key, False)
        return jnp.sum(out * jnp.asarray(w)), out

    (want_lp, want_x), want = jax.grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x))
    r_attn = np.asarray(jax.random.split(key, 3)[2])

    tlp = {k: torch.from_numpy(np.asarray(v)).requires_grad_() for k, v in lp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got = tbert._bert_block(tcfg, tx, tlp, torch.from_numpy(mask_bias), (None, None, r_attn),
                            False)
    (got * torch.from_numpy(w)).sum().backward()

    def close(a, b, what):
        b = np.asarray(b)
        assert (np.abs(a - b) <= TOL * (np.abs(b) + np.abs(b).max())).all(), what

    close(got.detach().numpy(), want, "out")
    close(tx.grad.numpy(), want_x, "dx")
    for k in tlp:
        close(tlp[k].grad.numpy(), want_lp[k], k)
    # the plain-attention branch applies the same keep-bits
    plain = tbert._bert_block(dataclasses.replace(tcfg, use_flash_attention=False),
                              torch.from_numpy(x), tlp, torch.from_numpy(mask_bias),
                              (None, None, r_attn), False)
    close(plain.detach().numpy(), want, "plain attention")


def test_remat_with_dropout_gives_the_same_gradients():
    """Attention and hidden dropout 0.1, one generator seed: the loss and
    every gradient equal with and without remat (the recomputed blocks
    regenerate the same keep-bits and hidden masks; gradients within 1e-6
    of their largest entry, the order autograd sums a leaf's parts in may
    differ, a wrong mask moves them by far more); attention dropout
    alone turns the model's dropout on (``make_model``'s rule), and the
    flash path equals the plain-attention path."""
    _, tcfg = _cfgs(256)
    tcfg = dataclasses.replace(tcfg, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(tcfg.vocab_size, 2, 256, seed=6,
                                                                keep=[256, 150]).items()}
    params = tbert.init_params(tcfg, seed=2)

    def run(cfg):
        p = tbert.params_from_jax(params)
        leaves, _ = tree_flatten(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = tbert.make_model(cfg)[0](p, batch, torch.Generator().manual_seed(5))
        loss.backward()
        return float(loss.detach()), [t.grad for t in leaves]

    remat = run(tcfg)
    flat = run(dataclasses.replace(tcfg, remat=False))
    assert remat[0] == flat[0]
    for a, b in zip(remat[1], flat[1]):
        # the same values; autograd may sum a leaf's parts in another order
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    plain = run(dataclasses.replace(tcfg, use_flash_attention=False))
    assert plain[0] == pytest.approx(remat[0], rel=TOL)
    attn_only = dataclasses.replace(tcfg, hidden_dropout_prob=0.0)
    loss_fn = tbert.make_model(attn_only)[0]
    p = tbert.params_from_jax(params)
    with torch.no_grad():
        train = float(loss_fn(p, batch, torch.Generator().manual_seed(5)))
        evald = float(loss_fn(p, batch, None))
    # small weights make attention nearly uniform, so the move is small,
    # but 40 times the loss's f32 spacing
    assert abs(train - evald) > 1e-6
