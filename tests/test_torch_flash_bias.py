"""Parity of the port's flash attention with an additive score bias
(deepspeed_tpu_torch) with the JAX package's, on the CPU.

The bias is BERT's key-padding mask: (B, 1, 1, T) f32, 0 on a real key and
-1e9 on a padded one, with the rows of each batch keeping a different
number of keys.  The JAX side runs ``flash_attention(..., interpret=True)``
(its Pallas forward and fused backward kernels interpreted, the ``kbias``
form) and ``jax.grad``; the port runs ``flash_attention`` with its
autograd function, whose CPU tensors take the plain versions of the CUDA
kernels (``flash_fwd_reference`` / ``flash_bwd_reference`` with
``kbias``).  The loss is ``sum(out * w)`` with one numpy cotangent ``w``.

Tolerance 2e-5 (absolute and relative), the JAX kernel tests' own f32
bound: both sides sum in f32 in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash_attention as jfa
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa

TOL = 2e-5


def _inputs(B, H, T, d, seed, keys_kept):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(4))
    bias = np.zeros((B, 1, 1, T), np.float32)
    for b, n in enumerate(keys_kept):
        bias[b, ..., n:] = -1e9
    return q, k, v, w, bias


def _jax(q, k, v, w, bias, causal, grad_bias=False):
    jw = jnp.asarray(w)

    def f(a, b, c, bb):
        out = jfa.flash_attention(a, b, c, causal=causal, bias=bb, interpret=True)
        return jnp.sum(out * jw), out

    argnums = (0, 1, 2, 3) if grad_bias else (0, 1, 2)
    grads, out = jax.grad(f, argnums=argnums, has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(q, k, v, w, bias, causal, grad_bias=False):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_(grad_bias)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, bias=tb)
    (out * torch.from_numpy(w)).sum().backward()
    grads = [t.grad.numpy() for t in (tq, tk, tv)]
    if grad_bias:
        grads.append(tb.grad.numpy())
    else:
        assert tb.grad is None  # a constant mask gets no cotangent
    return out.detach().numpy(), grads


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_padded_kbias_forward_and_grads_match_jax(causal):
    args = _inputs(2, 2, 256, 32, seed=7 + causal, keys_kept=(256, 131))
    want_out, want = _jax(*args, causal)
    got_out, got = _torch(*args, causal)
    _close(got_out, want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)
    if not causal:
        # a padded key takes no probability: its dk and dv are exactly 0
        assert not got[1][1, :, 131:].any() and not got[2][1, :, 131:].any()


def test_trainable_kbias_cotangent_matches_jax():
    args = _inputs(2, 2, 256, 32, seed=11, keys_kept=(200, 256))
    q, k, v, w, bias = args
    bias = bias + np.random.default_rng(12).standard_normal(bias.shape).astype(np.float32)
    want_out, want = _jax(q, k, v, w, bias, False, grad_bias=True)
    got_out, got = _torch(q, k, v, w, bias, False, grad_bias=True)
    _close(got_out, want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, name)
    assert got[3].shape == bias.shape


@pytest.mark.parametrize("shape", [(2, 1, 1, 64), (2, 2, 64, 64), (1, 1, 64, 64)],
                         ids=["kbias", "fbias", "broadcast"])
def test_dense_branch_takes_any_bias(shape):
    """At T 64 (4,096 scores, under the dense threshold) both packages
    take the materializing path with any broadcastable bias, trainable
    here: outputs and all four gradients against JAX's default dispatch."""
    rng = np.random.default_rng(13)
    q, k, v, w = (rng.standard_normal((2, 2, 64, 16)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal(shape).astype(np.float32)
    jw = jnp.asarray(w)

    def f(a, b, c, bb):
        out = jfa.flash_attention(a, b, c, causal=False, bias=bb)
        return jnp.sum(out * jw), out

    grads, want_out = jax.grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v, bias)))
    got_out, got = _torch(q, k, v, w, bias, False, grad_bias=True)
    _close(got_out, np.asarray(want_out), "out")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, grads):
        _close(a, np.asarray(b), name)


def test_kernel_plain_versions_with_kbias_match_the_reference():
    """The plain versions of the two kernels with ``kbias``: the forward's
    output and lse against ``mha_reference`` with the 4-D bias, a masked
    key's p exactly 0, and the backward against autograd through
    ``mha_reference``."""
    q, k, v, w, bias = (torch.from_numpy(a) for a in _inputs(2, 3, 200, 16, 3, (200, 57)))
    kb = bias[:, 0, 0, :].contiguous()
    out, lse = tfa.flash_fwd(q, k, v, causal=False, want_lse=True, kbias=kb)
    assert lse.shape == (2, 3, 200) and torch.isfinite(lse).all()
    ref = tfa.mha_reference(q, k, v, causal=False, bias=bias)
    assert float((out - ref).abs().max()) <= TOL
    p = torch.exp(tfa._scores(q, k, False, 0.25, tfa._kbias4(kb)) - lse[..., None])
    assert not p[1, :, :, 57:].any()
    delta = (w * out).sum(-1)
    got = tfa.flash_bwd(q, k, v, w, lse, delta, False, 0.25, kbias=kb)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    (tfa.mha_reference(qa, ka, va, causal=False, bias=bias) * w).sum().backward()
    for a, t in zip(got, (qa, ka, va)):
        assert float((a - t.grad).abs().max()) <= TOL


def test_unported_forms_raise_naming_a9():
    """What A9 left open is closed: the full bias past the dense threshold
    and dropout run (tests/test_torch_flash_dropout.py holds them to JAX);
    what stays refused is a bias that is not 4-D and dropout without a
    key."""
    q = torch.zeros(1, 2, 256, 32)
    out = tfa.flash_attention(q, q, q, bias=torch.zeros(1, 2, 256, 256))
    assert out.shape == q.shape and not out.any()
    out = tfa.flash_attention(q, q, q, dropout_rate=0.1, dropout_rng=(1, 2))
    assert out.shape == q.shape
    with pytest.raises(ValueError, match="dropout_rng"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="4-D"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(256))
