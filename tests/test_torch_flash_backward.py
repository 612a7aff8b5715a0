"""Parity of the port's flash-attention backward (deepspeed_tpu_torch) with
the JAX package's, on the CPU.

``jax.grad`` runs the JAX ``flash_attention`` with its Pallas kernels in
interpret mode (the fused single-pass backward, ``_flash_bwd_fused_kernel``);
``torch.autograd`` runs the port's ``flash_attention``, whose autograd
function takes the forward's ``lse`` and, for CPU tensors, the plain
``flash_bwd_reference`` (the CUDA kernel's arithmetic).  The loss is
``sum(out * w)`` with one numpy cotangent ``w`` for both sides.

Tolerances: float32 2e-5 (absolute and relative), the JAX kernel tests'
own bound, since both sides sum in f32 in different orders; bfloat16
3e-2 relative to each gradient's largest entry, because both sides round
p and ds to bf16 before the products and dq, dk, dv to bf16 at the end,
whose spacing is 2**-8 relative, after f32 sums in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash_attention as jfa
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _inputs(B, H, T, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(4)]


def _jax_grads(q, k, v, w, causal, dtype):
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    jw = jnp.asarray(w)

    def f(a, b, c):
        out = jfa.flash_attention(a, b, c, causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jw)

    return [np.asarray(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)]


def _torch_grads(q, k, v, w, causal, dtype):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("T", [256, 200])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_backward_plain_matches_jax_grad_f32(T, d, causal):
    q, k, v, w = _inputs(1, 2, T, d, seed=T + d + causal)
    ref = _jax_grads(q, k, v, w, causal, jnp.float32)
    got = _torch_grads(q, k, v, w, causal, torch.float32)
    for name, a, b in zip("qkv", ref, got):
        np.testing.assert_allclose(b, a, atol=F32_TOL, rtol=F32_TOL, err_msg=f"d{name}")


def test_flash_backward_plain_matches_jax_grad_bf16():
    q, k, v, w = _inputs(1, 2, 256, 64, seed=5)
    ref = _jax_grads(q, k, v, w, True, jnp.bfloat16)
    got = _torch_grads(q, k, v, w, True, torch.bfloat16)
    for name, a, b in zip("qkv", ref, got):
        scale = float(np.abs(a).max())
        assert float(np.abs(a - b).max()) <= BF16_TOL * scale, f"d{name}"


def test_flash_bwd_reference_matches_jax_fused_kernel_with_lse_and_delta():
    """The plain backward on the JAX kernel's own lse and delta (rectangular,
    end-aligned causal) equals ``_flash_bwd_fused_pallas``."""
    rng = np.random.default_rng(11)
    q, do = (rng.standard_normal((1, 2, 128, 32)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 2, 256, 32)).astype(np.float32) for _ in range(2))
    sc = 1.0 / np.sqrt(32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, True, sc, 128, 128, True, want_lse=True)
    ref = jfa._flash_bwd_fused_pallas(jq, jk, jv, out, lse, jdo, True, sc, 128, 128, True)
    delta = np.sum(np.asarray(out) * do, axis=-1)
    got = tfa.flash_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)),
                        torch.from_numpy(np.array(lse)), torch.from_numpy(delta), True, sc)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32_TOL, rtol=F32_TOL)


def test_autograd_takes_lse_only_when_a_gradient_is_wanted(monkeypatch):
    calls = []
    real = tfa.flash_fwd

    def spy(*args, **kwargs):
        calls.append(kwargs.get("want_lse", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_fwd", spy)
    q = torch.randn(1, 2, 256, 16)
    tfa.flash_attention(q, q, q, causal=True)
    tfa.flash_attention(q.requires_grad_(), q, q, causal=True)
    with torch.no_grad():
        tfa.flash_attention(q, q, q, causal=True)
    assert calls == [False, True, False]
