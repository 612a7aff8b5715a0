"""The port's training transformer layer
(deepspeed_tpu_torch.ops.transformer.transformer) against the JAX
package's, on the CPU: the weights' init, the layer's forward and
gradients (pre- and post-LN, a (B, T) mask and a (B, 1, T, T) mask), the
reference's packed weights, attention dropout given the same key words,
and the checkpointed layer against the uncheckpointed one.

At T 256 both packages take the flash kernels (the JAX Pallas kernels
interpreted, the port the plain versions of its CUDA kernels), the 2-D
mask as the key-row bias and the 4-D mask as the full bias.  The loss is
``sum(out * w)`` with one numpy cotangent ``w``.

Tolerances (f32): outputs and gradients 2e-5 of each tensor's largest
entry plus 2e-5 relative (the same math in other summation orders through
attention, two matmuls of the MLP, LayerNorm statistics); the checkpointed
layer against the uncheckpointed one: equal, the same torch ops in the
same order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import transformer as jtr
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.transformer import transformer as ttr

TOL = 2e-5
D, HEADS, FFN = 64, 4, 128


def _cfgs(**kw):
    base = dict(hidden_size=D, intermediate_size=FFN, heads=HEADS, attn_dropout_ratio=0.0,
                hidden_dropout_ratio=0.0, num_hidden_layers=2, layer_norm_eps=1e-12,
                pre_layer_norm=True)
    base.update(kw)
    return (jtr.DeepSpeedTransformerConfig(**base, dtype=jnp.float32),
            ttr.DeepSpeedTransformerConfig(**base, dtype=torch.float32))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    bound = TOL * (np.abs(want) + np.abs(want).max())
    assert (np.abs(got - want) <= bound).all(), (what, float(np.abs(got - want).max()))


def _mask(kind, B, T, rng):
    if kind == "none":
        return None
    if kind == "2d":
        keep = np.array([T, T // 2 + 5][:B])
        return (np.arange(T)[None, :] < keep[:, None]).astype(np.int32)
    bias = np.where(rng.random((B, 1, T, T)) < 0.15, -1e9, 0.0).astype(np.float32)
    bias[..., 0] = 0.0  # every row keeps a key
    return bias


def _jax_fwd_grad(params, x, w, cfg, mask, key=None):
    jw = jnp.asarray(w)
    jmask = None if mask is None else jnp.asarray(mask)

    def f(p, xx):
        out = jtr.transformer_layer_fn(p, xx, cfg, attention_mask=jmask, rng=key,
                                       training=key is not None)
        return jnp.sum(out * jw), out

    (gp, gx), out = jax.grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _torch_fwd_grad(layer, x, w, mask, seeds=None):
    tx = torch.from_numpy(x).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    out = layer(tx, attention_mask=tmask, rng=seeds, training=seeds is not None)
    (out * torch.from_numpy(w)).sum().backward()
    return (out.detach().numpy(), {k: p.grad.numpy() for k, p in layer.params.items()},
            tx.grad.numpy())


def test_init_weights_equal_jax():
    jcfg, tcfg = _cfgs(num_hidden_layers=24)
    want = jtr.init_transformer_params(jcfg, seed=5)
    got = ttr.init_transformer_params(tcfg, seed=5)
    assert list(got) == list(want) == list(ttr.PARAM_KEYS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    layer = ttr.DeepSpeedTransformerLayer(tcfg, seed=5, device="cpu")
    assert isinstance(layer, torch.nn.Module) and len(list(layer.parameters())) == 12
    for k, p in layer.params.items():
        assert p.dtype == torch.float32 and p.requires_grad
        np.testing.assert_array_equal(p.detach().numpy(), want[k])
    # config seed as the default, as in the JAX package
    default = ttr.DeepSpeedTransformerLayer(tcfg, device="cpu")
    np.testing.assert_array_equal(default.qkv_w.detach().numpy(),
                                  jtr.DeepSpeedTransformerLayer(jcfg).params["qkv_w"])
    with pytest.raises(KeyError, match="fc_b"):
        ttr.params_from_jax({k: v for k, v in want.items() if k != "fc_b"})


@pytest.mark.parametrize("mask_kind", ["2d", "4d"])
@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
def test_layer_forward_and_grads_match_jax(pre_ln, mask_kind):
    jcfg, tcfg = _cfgs(pre_layer_norm=pre_ln)
    rng = np.random.default_rng(7 + pre_ln)
    B, T = 2, 256
    x, w = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(2))
    mask = _mask(mask_kind, B, T, rng)
    params = jtr.init_transformer_params(jcfg, seed=1)
    want = _jax_fwd_grad(params, x, w, jcfg, mask)
    layer = ttr.DeepSpeedTransformerLayer(tcfg, seed=1, device="cpu")
    kernels.reset_launches()
    got = _torch_fwd_grad(layer, x, w, mask)
    _close(got[0], want[0], "out")
    for k in ttr.PARAM_KEYS:
        _close(got[1][k], want[1][k], k)
    _close(got[2], want[2], "dx")
    assert all(n == 0 for n in kernels.launches().values())  # CPU: the plain versions


def test_packed_initial_weights_match_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    qw, kw, vw, pw = (rng.standard_normal((D, D)).astype(np.float32) for _ in range(4))
    fw = rng.standard_normal((FFN, D)).astype(np.float32)
    fpw = rng.standard_normal((D, FFN)).astype(np.float32)
    biases = [rng.standard_normal(n).astype(np.float32) for n in (D, D, D, D, FFN, D)]
    want = jtr.DeepSpeedTransformerLayer(jcfg, initial_weights=[qw, kw, vw, pw, fw, fpw],
                                         initial_biases=biases)
    got = ttr.DeepSpeedTransformerLayer(tcfg, initial_weights=[qw, kw, vw, pw, fw, fpw],
                                        initial_biases=biases, device="cpu")
    for k in ttr.PARAM_KEYS:
        np.testing.assert_array_equal(got.params[k].detach().numpy(), want.params[k])
    x = rng.standard_normal((2, 8, D)).astype(np.float32)
    out = got(torch.from_numpy(x), training=False)
    _close(out.detach().numpy(), np.asarray(want(x, training=False)), "packed layer out")


@pytest.mark.parametrize("mask_kind", ["2d", "4d"])
def test_attention_dropout_matches_jax_given_the_key(mask_kind):
    """Attention dropout 0.1 on, hidden dropout off: the JAX layer draws
    its attention key as ``split(rng, 3)[0]``; the port gets those key
    words and regenerates the same keep-bits."""
    jcfg, tcfg = _cfgs(attn_dropout_ratio=0.1)
    rng = np.random.default_rng(11)
    B, T = 2, 256
    x, w = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(2))
    mask = _mask(mask_kind, B, T, rng)
    params = jtr.init_transformer_params(jcfg, seed=2)
    key = jax.random.PRNGKey(42)
    want = _jax_fwd_grad(params, x, w, jcfg, mask, key=key)
    attn_key = np.asarray(jax.random.split(key, 3)[0])
    layer = ttr.DeepSpeedTransformerLayer(tcfg, seed=2, device="cpu")
    got = _torch_fwd_grad(layer, x, w, mask, seeds=(attn_key, None, None))
    _close(got[0], want[0], "out")
    for k in ttr.PARAM_KEYS:
        _close(got[1][k], want[1][k], k)
    _close(got[2], want[2], "dx")
    # and the dropout did something: the eval output differs
    plain = _jax_fwd_grad(params, x, w, jcfg, mask)[0]
    assert np.abs(plain - want[0]).max() > 1e-3
    # after eval() the module drops nothing, given the same seeds
    layer.eval()
    with torch.no_grad():
        evald = layer(torch.from_numpy(x), attention_mask=None if mask is None else
                      torch.from_numpy(mask), rng=(attn_key, None, None))
    _close(evald.numpy(), plain, "out after eval()")


@pytest.mark.parametrize("pre_ln", [True, False], ids=["pre_ln", "post_ln"])
def test_checkpointed_layer_redraws_the_same_masks(pre_ln):
    """With both dropouts on, ``attn_dropout_checkpoint`` recomputes the
    attention and MLP parts in the backward: the output and every gradient
    equal the uncheckpointed layer's (the recomputation regenerates the
    same keep-bits and hidden masks from the seeds), and the eval output
    differs (the dropout did something)."""
    _, tcfg = _cfgs(pre_layer_norm=pre_ln, attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 256, D)).astype(np.float32)
    w = rng.standard_normal((2, 256, D)).astype(np.float32)
    mask = torch.from_numpy(_mask("2d", 2, 256, rng))
    seeds = ttr.draw_seeds(torch.Generator().manual_seed(9))
    runs = []
    for cfg in (tcfg, dataclasses.replace(tcfg, attn_dropout_checkpoint=True)):
        layer = ttr.DeepSpeedTransformerLayer(cfg, seed=3, device="cpu")
        tx = torch.from_numpy(x).requires_grad_()
        out = layer(tx, attention_mask=mask, rng=seeds, training=True)
        (out * torch.from_numpy(w)).sum().backward()
        runs.append((out.detach(), tx.grad, {k: v.grad for k, v in layer.params.items()}))
    (out, gx, gp), (c_out, c_gx, c_gp) = runs
    assert torch.equal(c_out, out) and torch.equal(c_gx, gx)
    assert all(torch.equal(c_gp[k], gp[k]) for k in ttr.PARAM_KEYS)
    with torch.no_grad():
        evald = layer(torch.from_numpy(x), attention_mask=mask, rng=seeds, training=False)
    assert float((evald - out).abs().max()) > 1e-3
