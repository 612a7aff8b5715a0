"""Parity of the port's flash decode (deepspeed_tpu_torch) with the JAX
package's, on the CPU.

The JAX side is ``cache_attention(use_kernel=False)``, the numerics ground
truth its Pallas decode kernel is tested against (tests/test_kernels.py);
the port's ``flash_decode`` takes its plain PyTorch version for CPU
tensors.  Inputs come from one numpy seed and go through both.

Tolerances: float32 and int8 caches 2e-5, the JAX kernel tests' own
bound (int8 codes are bit-equal on both sides, the arithmetic is f32);
bfloat16 caches 2e-2, because the output is rounded to bf16 (spacing
2**-8 relative) after f32 sums taken in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import inference as jinf
from deepspeed_tpu_torch.ops.kernels import flash_decode as tfd
from deepspeed_tpu_torch.ops.transformer import inference as tinf

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _err(j, t):
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _caches(kv, k, v):
    """(jax k, jax v, torch k, torch v) for one cache kind; int8 caches are
    quantized on each side by its own _kv_quant."""
    if kv == "int8":
        jk, jv = (dict(zip(("q", "s"), jinf._kv_quant(jnp.asarray(a)))) for a in (k, v))
        tk, tv = (dict(zip(("q", "s"), tinf._kv_quant(torch.from_numpy(a)))) for a in (k, v))
        return jk, jv, tk, tv
    jd, td = (jnp.float32, torch.float32) if kv == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (jnp.asarray(k, jd), jnp.asarray(v, jd),
            torch.from_numpy(k).to(td), torch.from_numpy(v).to(td))


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S", [128, 256])
def test_flash_decode_matches_jax(kv, S):
    B, H, d = 4, 3, 64
    q = _rand((B, H, 1, d), 1)
    k = _rand((B, H, S, d), 2)
    v = _rand((B, H, S, d), 3)
    jk, jv, tk, tv = _caches(kv, k, v)
    qd = (jnp.bfloat16, torch.bfloat16) if kv == "bf16" else (jnp.float32, torch.float32)
    # per-slot positions incl. the edges (fresh slot at 0, full cache)
    pos = np.asarray([0, S // 3, S - 1, 7], np.int32)
    ref = jinf.cache_attention(jnp.asarray(q, qd[0]), jk, jv, jnp.asarray(pos), use_kernel=False)
    out = tfd.flash_decode(torch.from_numpy(q).to(qd[1]), tk, tv, torch.from_numpy(pos))
    assert tuple(out.shape) == ref.shape and out.dtype == qd[1]
    assert _err(ref, out) < (BF16_TOL if kv == "bf16" else F32_TOL), (kv, S)


def test_flash_decode_scalar_pos_and_padding_mask():
    B, H, S, d = 2, 4, 128, 16
    q, k, v = _rand((B, H, 1, d), 4), _rand((B, H, S, d), 5), _rand((B, H, S, d), 6)
    mask = np.random.default_rng(7).integers(0, 2, (B, S)).astype(bool)
    mask[:, 0] = True
    ref = jinf.cache_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64,
                               key_padding_mask=jnp.asarray(mask), use_kernel=False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = tfd.flash_decode(tq, tk, tv, 64, key_padding_mask=torch.from_numpy(mask))
    assert _err(ref, out) < F32_TOL
    # a 0-dim tensor offset is the same function
    out2 = tfd.flash_decode(tq, tk, tv, torch.tensor(64), key_padding_mask=torch.from_numpy(mask))
    assert _err(ref, out2) < F32_TOL


def test_fully_masked_row_is_uniform_and_finite():
    """A row with no attendable key attends uniformly over the whole
    cache (the -1e30 mask constant), as the JAX version does."""
    B, H, S, d = 1, 2, 128, 16
    q, k, v = _rand((B, H, 1, d), 8), _rand((B, H, S, d), 9), _rand((B, H, S, d), 10)
    mask = np.zeros((B, S), bool)
    mask[:, 100:] = True  # nothing at or before pos=20 is attendable
    ref = jinf.cache_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 20,
                               key_padding_mask=jnp.asarray(mask), use_kernel=False)
    out = tfd.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)), 20,
                           key_padding_mask=torch.from_numpy(mask))
    assert torch.isfinite(out).all()
    assert _err(ref, out) < F32_TOL
    np.testing.assert_allclose(out[0, :, 0].numpy(), v[0].mean(axis=1), atol=1e-5)


def test_multi_query_cache_attention_matches_jax():
    """T > 1 against the cache (the serving prefill chunk's form) is the
    plain body on both sides."""
    B, H, S, T, d = 2, 2, 96, 8, 16
    q, k, v = _rand((B, H, T, d), 11), _rand((B, H, S, d), 12), _rand((B, H, S, d), 13)
    pos = np.asarray([0, 40], np.int32)
    ref = jinf.cache_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                               use_kernel=False)
    out = tinf.cache_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(pos))
    assert _err(ref, out) < F32_TOL


def test_kv_quant_codes_bit_equal():
    """Codes and scales equal bit for bit, ties included (both round half
    to even)."""
    rng = np.random.default_rng(14)
    t = rng.standard_normal((3, 2, 40, 64)).astype(np.float32)
    # rows whose values land on exact .5 code boundaries
    t[0, 0, 0, :] = 0.0
    t[0, 0, 0, 0] = 127.0
    t[0, 0, 0, 1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    jq, js = jinf._kv_quant(jnp.asarray(t))
    tq, ts = tinf._kv_quant(torch.from_numpy(t))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tq[0, 0, 0, 1:6].tolist() == [0, 2, 2, 0, -2]


def test_decode_contract():
    q = torch.zeros(2, 2, 2, 16)
    k = torch.zeros(2, 2, 128, 16)
    with pytest.raises(ValueError, match="one query"):
        tfd.flash_decode(q, k, k, 0)
    # the Hopper kernel serves any cache length (the TPU grid wanted S % 128)
    assert tfd.decode_supported(2, 2, 96, 16)
    assert tfd.decode_supported(8, 12, 1024, 64)
    assert not tfd.decode_supported(2, 2, 128, 256)
