"""Parity of the port's flash-attention forward (deepspeed_tpu_torch) with
the JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (``interpret=True``,
as tests/test_kernels.py runs it); the port's wrapper takes its plain
PyTorch version of the CUDA kernel's arithmetic for CPU tensors.  Inputs
come from one numpy seed and go through both.

Tolerances: float32 2e-5, the JAX kernel tests' own bound; bfloat16 2e-2,
because both sides round the output (and p before the value dot) to
bf16, whose spacing is 2**-8 relative, and the f32 sums before the
rounding run in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash_attention as jfa
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(B, H, Tq, Tk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    return q, k, v


def _jax(a, dtype):
    return jnp.asarray(a, dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


@pytest.mark.parametrize("T", [128, 200, 256])
@pytest.mark.parametrize("d", [16, 64])
def test_flash_fwd_plain_matches_jax_kernel_f32(T, d):
    q, k, v = _qkv(2, 2, T, T, d, seed=T + d)
    ref = jfa.flash_attention(_jax(q, jnp.float32), _jax(k, jnp.float32), _jax(v, jnp.float32),
                              causal=True, interpret=True)
    out, lse = tfa.flash_fwd(_torch(q, torch.float32), _torch(k, torch.float32),
                             _torch(v, torch.float32), causal=True)
    assert lse is None
    assert out.shape == (2, 2, T, d) and out.dtype == torch.float32
    assert _err(ref, out) < F32_TOL, (T, d)


@pytest.mark.parametrize("T", [200, 256])
def test_flash_fwd_plain_matches_jax_kernel_bf16(T):
    q, k, v = _qkv(1, 2, T, T, 64, seed=T)
    ref = jfa.flash_attention(_jax(q, jnp.bfloat16), _jax(k, jnp.bfloat16), _jax(v, jnp.bfloat16),
                              causal=True, interpret=True)
    out, _ = tfa.flash_fwd(_torch(q, torch.bfloat16), _torch(k, torch.bfloat16),
                           _torch(v, torch.bfloat16), causal=True)
    assert out.dtype == torch.bfloat16
    assert _err(ref, out) < BF16_TOL


def test_flash_fwd_lse_and_non_causal_match_jax():
    q, k, v = _qkv(1, 2, 128, 256, 32, seed=3)
    for causal in (True, False):
        ref_o, ref_lse = jfa._flash_fwd_pallas(
            _jax(q, jnp.float32), _jax(k, jnp.float32), _jax(v, jnp.float32),
            causal, 1.0 / np.sqrt(32), 128, 128, True, want_lse=True,
        )
        out, lse = tfa.flash_fwd(_torch(q, torch.float32), _torch(k, torch.float32),
                                 _torch(v, torch.float32), causal=causal, want_lse=True)
        assert _err(ref_o, out) < F32_TOL
        assert _err(ref_lse, lse) < F32_TOL


@pytest.mark.parametrize("Tq,Tk,causal", [
    (64, 64, True),     # sq*sk <= 128**2: the dense branch
    (128, 128, False),  # still dense (equal to the bound)
    (4, 4100, False),   # sq < 8 past the dense bound: the reference branch
    (300, 300, True),   # the kernel branch
])
def test_flash_attention_dispatch_matches_jax(Tq, Tk, causal):
    q, k, v = _qkv(1, 2, Tq, Tk, 16, seed=Tq)
    ref = jfa.flash_attention(_jax(q, jnp.float32), _jax(k, jnp.float32), _jax(v, jnp.float32),
                              causal=causal)
    out = tfa.flash_attention(_torch(q, torch.float32), _torch(k, torch.float32),
                              _torch(v, torch.float32), causal=causal)
    assert _err(ref, out) < F32_TOL


def test_dense_and_reference_match_jax_bf16():
    q, k, v = _qkv(2, 2, 64, 64, 16, seed=9)
    jq, jk, jv = (_jax(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    assert _err(jfa.mha_dense(jq, jk, jv, causal=True), tfa.mha_dense(tq, tk, tv, causal=True)) < BF16_TOL
    assert _err(jfa.mha_reference(jq, jk, jv, causal=True),
                tfa.mha_reference(tq, tk, tv, causal=True)) < BF16_TOL


def test_bias_and_dropout_not_ported_yet():
    """What of the bias and dropout stays unported: a full (B, H, Tq, Tk)
    bias past the dense threshold and attention dropout (the key-row bias
    is ported: tests/test_torch_flash_bias.py)."""
    q, k, v = (_torch(a, torch.float32) for a in _qkv(1, 1, 256, 256, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tfa.flash_attention(q, k, v, bias=torch.zeros(1, 1, 256, 256))
    q, k, v = (_torch(a, torch.float32) for a in _qkv(1, 1, 8, 8, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tfa.flash_attention(q, k, v, dropout_rate=0.1)
