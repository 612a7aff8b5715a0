"""Parity of the port's attention dropout, full score bias and two-pass
backward (deepspeed_tpu_torch) with the JAX package's, on the CPU.

The dropout key is a pair of uint32 words (the JAX package's raw key data)
fed to both sides.  The JAX side runs ``flash_attention(...,
interpret=True)`` (its Pallas forward and backward kernels interpreted,
with the keep-bits generated in-kernel by Threefry-2x32) and ``jax.grad``;
the port runs ``flash_attention`` with its autograd function, whose CPU
tensors take the plain versions of the CUDA kernels, with the same bits
from ``dropout_keep_mask_host``.  The loss is ``sum(out * w)`` with one
numpy cotangent ``w``.

The keep-mask must be equal bit for bit.  Outputs and gradients: 2e-5
absolute and relative, the JAX kernel tests' own f32 bound (both sides sum
in f32 in different orders; a single wrong keep-bit moves an output by
about |v| / (0.9 T), far above it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash_attention as jfa
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa

TOL = 2e-5
RATE = 0.1


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("seed,b,h,sq,sk,keep_prob", [
    ((123, 456), 2, 3, 37, 53, 0.9),             # ragged T, several b*h
    ((2**31 + 5, 2**32 - 1), 1, 2, 64, 200, 0.8),  # key words >= 2**31
    ((0, 0), 3, 1, 8, 8, 0.5),
    ((7, 2**31), 2, 2, 129, 129, 0.9),
])
def test_keep_mask_equals_jax_bit_for_bit(seed, b, h, sq, sk, keep_prob):
    want = np.asarray(jfa.dropout_keep_mask_host(jnp.asarray(seed, jnp.uint32), b, h, sq, sk,
                                                 keep_prob))
    got = tfa.dropout_keep_mask_host(np.asarray(seed, np.uint32), b, h, sq, sk, keep_prob)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the keep rate within four binomial standard deviations
    assert abs(float(want.mean()) - keep_prob) < 4 * np.sqrt(keep_prob * (1 - keep_prob) / want.size)


def test_keep_mask_chunks_and_key_sources(monkeypatch):
    """The host mask is the same in chunks of any size, and a key given as
    ints, a tensor or an array is one key; a generator draws two words."""
    whole = tfa.dropout_keep_mask_host((5, 6), 2, 2, 30, 40, 0.9)
    monkeypatch.setattr(tfa, "_HOST_MASK_CHUNK", 100)  # rows of one b*h at a time
    assert torch.equal(tfa.dropout_keep_mask_host(torch.tensor([5, 6]), 2, 2, 30, 40, 0.9), whole)
    assert tfa._seed_pair(np.asarray(jax.random.PRNGKey(7))) == (0, 7)
    g = torch.Generator().manual_seed(3)
    k0, k1 = tfa._seed_pair(g)
    assert 0 <= k0 < 2**32 and 0 <= k1 < 2**32
    assert tfa._seed_pair(torch.Generator().manual_seed(3)) == (k0, k1)
    with pytest.raises(ValueError, match="2\\*\\*32"):
        tfa.dropout_keep_mask_host((1, 2), 1, 1, 2**16, 2**16, 0.9)
    with pytest.raises(ValueError, match="dropout_rng"):
        tfa.flash_attention(*(torch.zeros(1, 1, 16, 16),) * 3, dropout_rate=0.1)


def _inputs(B, H, T, d, seed, bias_kind):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(4))
    if bias_kind == "kbias":
        bias = np.zeros((B, 1, 1, T), np.float32)
        bias[-1, ..., T // 2 + 3:] = -1e9
    elif bias_kind == "fbias":
        # a (B, 1, Tq, Tk) mask with a learned-looking part: the full form
        bias = (rng.standard_normal((B, 1, T, T)) * 0.5).astype(np.float32)
        bias[0, 0, :, T - 40:] = -1e9
    else:
        bias = None
    return q, k, v, w, bias


def _jax(q, k, v, w, bias, causal, seed, grad_bias=False, **kw):
    jw = jnp.asarray(w)
    key = jnp.asarray(seed, jnp.uint32)

    def f(a, b, c, bb):
        out = jfa.flash_attention(a, b, c, causal=causal, bias=bb, dropout_rate=RATE,
                                  dropout_rng=key, **kw)
        return jnp.sum(out * jw), out

    args = [jnp.asarray(a) for a in (q, k, v)] + [None if bias is None else jnp.asarray(bias)]
    argnums = (0, 1, 2, 3) if grad_bias else (0, 1, 2)
    grads, out = jax.grad(f, argnums=argnums, has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch(q, k, v, w, bias, causal, seed, grad_bias=False):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(grad_bias)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, bias=tb, dropout_rate=RATE,
                              dropout_rng=np.asarray(seed, np.uint32))
    (out * torch.from_numpy(w)).sum().backward()
    grads = [t.grad.numpy() for t in (tq, tk, tv)]
    if grad_bias:
        grads.append(tb.grad.numpy())
    elif tb is not None:
        assert tb.grad is None  # a constant mask gets no cotangent
    return out.detach().numpy(), grads


@pytest.mark.parametrize("bias_kind", ["none", "kbias", "fbias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dropout_forward_and_grads_match_jax(causal, bias_kind):
    seed = (2**31 + 17, 99)
    args = _inputs(2, 2, 256, 32, seed=3 + causal, bias_kind=bias_kind)
    want_out, want = _jax(*args, causal, seed, interpret=True)
    got_out, got = _torch(*args, causal, seed)
    _close(got_out, want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)
    if bias_kind == "kbias" and not causal:
        # a padded key takes no probability with dropout on: dk, dv exactly 0
        assert not got[1][1, :, 131:].any() and not got[2][1, :, 131:].any()


@pytest.mark.parametrize("shape", [(1, 2, 256, 256), (2, 1, 1, 256)], ids=["fbias", "kbias"])
def test_trainable_bias_cotangent_under_dropout_matches_jax(shape):
    seed = (11, 12)
    rng = np.random.default_rng(13)
    q, k, v, w = (rng.standard_normal((2, 2, 256, 32)).astype(np.float32) for _ in range(4))
    bias = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    want_out, want = _jax(q, k, v, w, bias, False, seed, grad_bias=True, interpret=True)
    got_out, got = _torch(q, k, v, w, bias, False, seed, grad_bias=True)
    _close(got_out, want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        _close(a, b, name)
    assert got[3].shape == shape and np.abs(got[3]).max() > 1e-4


@pytest.mark.parametrize("bias_kind", ["none", "fbias"])
def test_dense_branch_dropout_matches_jax(bias_kind):
    """T 64 (under the dense threshold): both packages materialize the
    keep-mask from the same Threefry bits; JAX's default dispatch."""
    seed = (5, 2**32 - 3)
    args = _inputs(2, 2, 64, 16, seed=21, bias_kind=bias_kind)
    want_out, want = _jax(*args, False, seed)
    got_out, got = _torch(*args, False, seed)
    _close(got_out, want_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)


@pytest.mark.parametrize("bias_kind,causal", [("kbias", False), ("fbias", True)])
def test_two_pass_plain_backward_matches_jax_two_pass_kernels(bias_kind, causal):
    """The port's two-pass plain backward (B6a then B6b) against the JAX
    package's ``_flash_bwd_pallas`` (``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel`` interpreted) on the same forward residuals,
    with in-kernel dropout."""
    seed = (31, 2**31 + 1)
    q, k, v, w, bias = _inputs(2, 2, 256, 32, seed=41, bias_kind=bias_kind)
    scale = 32 ** -0.5
    key = jnp.asarray(seed, jnp.uint32)
    jq, jk, jv, jw, jb = (jnp.asarray(a) for a in (q, k, v, w, bias))
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, 128, 128, True, bias=jb,
                                     keep_prob=1 - RATE, drop_seed=key)
    want = jfa._flash_bwd_pallas(jq, jk, jv, out, lse, jw, causal, scale, 128, 128, True,
                                 bias=jb, keep_prob=1 - RATE, drop_seed=key)
    drop = tfa.make_dropout(RATE, np.asarray(seed, np.uint32))
    tq, tk, tv, tw = (torch.from_numpy(a) for a in (q, k, v, w))
    mode, b2 = tfa._bias_mode(torch.from_numpy(bias), 2, 2, 256, 256)
    assert mode == bias_kind
    kb, fb = (b2, None) if mode == "kbias" else (None, b2)
    tout, tlse = tfa.flash_fwd(tq, tk, tv, causal, scale, want_lse=True, kbias=kb, fbias=fb,
                               drop=drop)
    _close(tout.numpy(), np.asarray(out), "out")
    _close(tlse.numpy(), np.asarray(lse), "lse")
    delta = (tw * tout).sum(-1)
    got = tfa.flash_bwd2(tq, tk, tv, tw, tlse, delta, causal, scale, kb, fb, drop)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), np.asarray(b), name)
    fused = tfa.flash_bwd(tq, tk, tv, tw, tlse, delta, causal, scale, kb, fb, drop)
    for a, b in zip(got, fused):
        _close(a.numpy(), b.numpy(), "two-pass vs single-pass")


@pytest.mark.parametrize("bias_kind,causal", [("kbias", False), ("fbias", True)])
def test_bf16_two_pass_plain_and_jax_kernels_lie_within_the_float64_bound(bias_kind, causal):
    """bf16, with in-kernel dropout: the port's two-pass plain backward and
    the JAX package's interpreted two-pass kernels (``_flash_bwd_pallas``)
    on the same inputs and forward residuals, both within
    ``flash_bwd_float64``'s bound (what the card's bf16 B6a/B6b are held
    to: each rounds p and ds to bf16 after f32 sums in its own order); a dq
    that misses one 64-key tile lies far outside it."""
    seed = (31, 2**31 + 1)
    q, k, v, w, bias = _inputs(1, 2, 256, 32, seed=43, bias_kind=bias_kind)
    scale = 32 ** -0.5
    key = jnp.asarray(seed, jnp.uint32)
    jq, jk, jv, jw = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, w))
    jb = jnp.asarray(bias)
    out, lse = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, 128, 128, True, bias=jb,
                                     keep_prob=1 - RATE, drop_seed=key, want_lse=True)
    jax_grads = jfa._flash_bwd_pallas(jq, jk, jv, out, lse, jw, causal, scale, 128, 128, True,
                                      bias=jb, keep_prob=1 - RATE, drop_seed=key)
    drop = tfa.make_dropout(RATE, np.asarray(seed, np.uint32))
    tq, tk, tv, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, w))
    mode, b2 = tfa._bias_mode(torch.from_numpy(bias), 1, 2, 256, 256)
    kb, fb = (b2, None) if mode == "kbias" else (None, b2)
    tlse = torch.from_numpy(np.array(lse, np.float32))
    delta = (tw.float() * torch.from_numpy(np.array(out, np.float32))).sum(-1)
    args = (tq, tk, tv, tw, tlse, delta, causal, scale, kb, fb, drop)
    plain = tfa.flash_bwd2(*args)
    assert all(g.dtype == torch.bfloat16 for g in plain)
    witness = tfa.flash_bwd_float64(*args)
    from_jax = [torch.from_numpy(np.array(g, np.float32)) for g in jax_grads]
    assert max(tfa.float64_over_bound(from_jax, witness)) <= 1.0
    assert max(tfa.float64_over_bound(plain, witness)) <= 1.0
    _, ds = tfa._bwd_probs(*args)
    ds[..., 64:128] = 0
    missing = torch.einsum("bhqk,bhkd->bhqd", ds, tk.float()).to(torch.bfloat16)
    assert tfa.float64_over_bound((missing, *plain[1:]), witness)[0] > 10.0


def test_two_pass_route_taken_past_the_threshold(monkeypatch):
    """With a bias, sq * d * 4 past ``_FUSED_BWD_MAX_SQ_BYTES`` takes the
    two-pass backward (B6), as the JAX package's dispatch does; without a
    bias the single-pass one (B2) stays.  The threshold is patched down so
    a small case crosses it; the gradients equal the single-pass route's."""
    seed = (8, 9)
    q, k, v, w, bias = _inputs(1, 2, 256, 32, seed=51, bias_kind="kbias")
    calls = []
    for name in ("flash_bwd", "flash_bwd2"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))

    _, single = _torch(q, k, v, w, bias, False, seed)
    assert calls == ["flash_bwd"]
    monkeypatch.setattr(tfa, "_FUSED_BWD_MAX_SQ_BYTES", 128 * 32 * 4)
    _, two = _torch(q, k, v, w, bias, False, seed)
    assert calls == ["flash_bwd", "flash_bwd2"]
    for a, b in zip(two, single):
        _close(a, b, "B6 route vs B2 route")
    _torch(q, k, v, w, None, False, seed)
    assert calls[-1] == "flash_bwd"  # no bias: the single-pass backward at any length


def test_reference_with_the_host_mask_matches_jax_reference():
    """``mha_reference`` / ``mha_dense`` with a materialized keep-mask (the
    plain versions' ``dropout_mask`` operand) against the JAX package's."""
    rng = np.random.default_rng(61)
    q, k, v = (rng.standard_normal((1, 2, 48, 16)).astype(np.float32) for _ in range(3))
    m4 = (rng.random((1, 2, 48, 48)) < 0.8).astype(np.uint8)
    for fn in ("mha_reference", "mha_dense"):
        want = getattr(jfa, fn)(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                dropout_mask=jnp.asarray(m4), keep_prob=0.8)
        got = getattr(tfa, fn)(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                               dropout_mask=torch.from_numpy(m4), keep_prob=0.8)
        _close(got.numpy(), np.asarray(want), fn)
