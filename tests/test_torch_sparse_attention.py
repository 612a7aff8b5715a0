"""The port's block-sparse attention (deepspeed_tpu_torch/ops/attention/
sparse.py) against the JAX package's, on the CPU, in float32.

* The gather path (plain torch, autograd) against JAX's
  ``block_sparse_attention(backend="gather")`` at (2, 4, 64, 8), block 16,
  on tests/test_sparse_attention.py's layout cases, with and without a key
  padding mask: the forward within 1e-5, the gradients of ``sum(out**2)``
  within rtol 2e-4 / atol 2e-5 of ``jax.grad``.
* The plain versions of the three splash kernels (B8 ``splash_fwd_reference``,
  B9a ``splash_bwd_dq_reference``, B9b ``splash_bwd_dkv_reference``)
  against the Pallas kernels run in interpret mode (``_splash_fwd(...,
  interpret=True, want_lse=True)``, ``_splash_bwd(..., interpret=True)``) on
  the same inputs, the same lse and delta: out and lse within 2e-5 with
  ``+inf`` at the same rows, dq/dk/dv within rtol 2e-4 / atol 2e-5 (the JAX
  package's own splash-gradient bounds); both sum in f32, in other orders.
  Layouts: BigBird uni- and bidirectional (its global rows are the dense
  bucket), a per-head layout built by hand (a window + global layout
  saturates at small nb and would collapse to one head's), untouched key
  columns (their dk/dv exactly 0), a row with no active block (out 0, lse
  +inf), and the all-ones layout (exempt from the dense bucket).
* ``splash_attention`` / ``block_sparse_attention(backend="splash")`` end to
  end through ``_SplashAttention`` and the dense rows, forward and
  gradients, against JAX's interpreted splash.
* ``SparseSelfAttention`` and ``SparseAttentionUtils`` against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import sparse as js
from deepspeed_tpu_torch.ops.attention import sparse as ts

FWD_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
SPLASH_OUT_TOL = 2e-5

LAYOUT_CASES = [
    ("dense", "DenseSparsityConfig", dict(num_heads=4, block=16), False),
    ("fixed-bi", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=2, num_global_blocks=1), False),
    ("fixed-uni", "FixedSparsityConfig",
     dict(num_heads=4, block=16, num_local_blocks=2, attention="unidirectional"), True),
    ("bigbird", "BigBirdSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=1, num_sliding_window_blocks=3,
          num_global_blocks=1), False),
    ("longformer", "BSLongformerSparsityConfig",
     dict(num_heads=4, block=16, num_sliding_window_blocks=3, global_block_indices=[0, 2]),
     False),
    ("variable", "VariableSparsityConfig",
     dict(num_heads=4, block=16, num_random_blocks=1, local_window_blocks=[1, 2],
          global_block_indices=[0]), False),
]


def _inputs(shape, n, seed, scale=1.0):
    r = np.random.default_rng(seed)
    return [(r.standard_normal(shape) * scale).astype(np.float32) for _ in range(n)]


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the gather path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True], ids=["no-kpm", "kpm"])
@pytest.mark.parametrize("name,cls,kw,causal", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_gather_path_and_its_gradients_match_jax(name, cls, kw, causal, padded):
    B, H, T, hd, block = 2, 4, 64, 8, 16
    layout = getattr(js, cls)(**kw).make_layout(T)
    q, k, v = _inputs((B, H, T, hd), 3, seed=0)
    kp = None
    if padded:
        kp = np.ones((B, T), bool)
        kp[0, 40:] = False
        kp[1, 9:] = False  # rows whose every key of a block is padded

    def jloss(q, k, v):
        out = js.block_sparse_attention(q, k, v, layout, block, causal=causal,
                                        key_padding_mask=None if kp is None else jnp.asarray(kp),
                                        backend="gather")
        return jnp.sum(out ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = ts.block_sparse_attention(tq, tk, tv, layout, block, causal=causal,
                                    key_padding_mask=None if kp is None else torch.tensor(kp),
                                    backend="gather")
    _close(out, jout, 0, FWD_TOL)
    (out ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)


def test_backend_rules_follow_the_jax_package():
    q = torch.zeros(1, 2, 128, 16)
    layout = ts.FixedSparsityConfig(num_heads=2, block=16).make_layout(128)
    with pytest.raises(ValueError, match="block >= 64"):
        ts.block_sparse_attention(q, q, q, layout, 16, backend="splash")
    layout64 = ts.FixedSparsityConfig(num_heads=2, block=64, num_local_blocks=2).make_layout(128)
    with pytest.raises(ValueError, match="key_padding_mask"):
        ts.block_sparse_attention(q, q, q, layout64, 64, backend="splash",
                                  key_padding_mask=torch.ones(1, 128))
    with pytest.raises(ValueError, match="backend"):
        ts.block_sparse_attention(q, q, q, layout64, 64, backend="triton")
    with pytest.raises(ValueError, match="layout"):
        ts.block_sparse_attention(q, q, q, layout64[:, :1], 64)
    # auto on CPU tensors takes the gather path, never the kernels'
    # functions: the same bits as backend="gather"
    x = torch.randn(1, 2, 128, 16, generator=torch.Generator().manual_seed(0))
    auto = ts.block_sparse_attention(x, x, x, layout64, 64, causal=True)
    gather = ts.block_sparse_attention(x, x, x, layout64, 64, causal=True, backend="gather")
    assert torch.equal(auto, gather)


# ---------------------------------------------------------------------------
# the splash kernels' plain versions against the interpreted Pallas kernels
# ---------------------------------------------------------------------------


def _layout(kind, nb, block):
    if kind == "bigbird-uni":
        return js.BigBirdSparsityConfig(num_heads=2, block=block,
                                        attention="unidirectional").make_layout(nb * block)
    if kind == "bigbird-bi":
        return js.BigBirdSparsityConfig(num_heads=2, block=block).make_layout(nb * block)
    if kind == "all-ones":
        return js.DenseSparsityConfig(num_heads=2, block=block).make_layout(nb * block)
    layout = ts.check_layouts(nb)[kind]  # per-head, untouched-columns, zero-degree-row
    assert kind != "per-head" or not ts._head_uniform(layout)
    return layout


SPLASH_CASES = [
    # (layout kind, causal, T, hd, block)
    ("bigbird-uni", True, 256, 64, 64),
    ("bigbird-bi", False, 256, 64, 64),
    ("per-head", True, 256, 64, 64),
    ("untouched-columns", True, 256, 64, 64),
    ("zero-degree-row", False, 256, 64, 64),
    ("all-ones", True, 256, 64, 64),
    ("bigbird-bi", False, 64, 16, 16),
    ("untouched-columns", False, 64, 16, 16),
]


@pytest.mark.parametrize("kind,causal,T,hd,block", SPLASH_CASES,
                         ids=[f"{c[0]}-T{c[2]}" for c in SPLASH_CASES])
def test_splash_plain_versions_match_the_interpreted_pallas_kernels(kind, causal, T, hd, block):
    B, H = 1, 2
    nb = T // block
    layout = _layout(kind, nb, block)
    scale = hd ** -0.5
    q, k, v, g = _inputs((B, H, T, hd), 4, seed=3, scale=0.3)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    jout, jlse = js._splash_fwd(jq, jk, jv, layout, block, causal, scale, True, want_lse=True)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = ts.splash_fwd_reference(tq, tk, tv, layout, block, causal, scale)
    _close(out, jout, 0, SPLASH_OUT_TOL)
    jlse = np.asarray(jlse)
    inf = np.isinf(jlse)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), inf)
    np.testing.assert_allclose(np.where(inf, 0, lse.numpy()), np.where(inf, 0, jlse),
                               rtol=0, atol=SPLASH_OUT_TOL)
    if kind == "zero-degree-row":
        assert inf.reshape(B, H, nb, block)[0, 0, 1].all() and inf.reshape(
            B, H, nb, block)[0, 1, 2].all()
        assert (out.reshape(B, H, nb, block, hd)[0, 0, 1] == 0).all()

    # the backward from the same saved out / lse (JAX's)
    jdq, jdk, jdv = js._splash_bwd(jq, jk, jv, jout, jnp.asarray(jlse), jg, layout, block,
                                   causal, scale, True)
    lse_t, out_t = torch.tensor(jlse), torch.tensor(np.asarray(jout))
    delta = (tg * out_t).sum(-1)
    args = (tq, tk, tv, tg, lse_t, delta, layout, block, causal, scale)
    dq = ts.splash_bwd_dq_reference(*args)
    dk, dv = ts.splash_bwd_dkv_reference(*args)
    for got, want in zip((dq, dk, dv), (jdq, jdk, jdv)):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)
    if kind == "untouched-columns":
        for h, col in ts.UNTOUCHED_COLUMNS:
            for grad in (dk, dv):
                assert (grad.reshape(B, H, nb, block, hd)[:, h, col] == 0).all(), (h, col)


@pytest.mark.parametrize("kind,causal", [("bigbird-bi", False), ("per-head", True)])
def test_splash_attention_end_to_end_matches_jax(kind, causal):
    """_SplashAttention (B8 forward, B9a + B9b backward, here their plain
    versions) plus the dense rows outside it, against JAX's interpreted
    splash path, forward and gradients of sum(out**2)."""
    B, H, T, hd, block = 1, 2, 256, 64, 64
    layout = _layout(kind, T // block, block)
    q, k, v = _inputs((B, H, T, hd), 3, seed=4, scale=0.3)

    def jloss(q, k, v):
        out = js.block_sparse_attention(q, k, v, layout, block, causal=causal, backend="splash")
        return jnp.sum(out ** 2), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = ts.block_sparse_attention(tq, tk, tv, layout, block, causal=causal, backend="splash")
    _close(out, jout, 0, SPLASH_OUT_TOL)
    (out ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, GRAD_RTOL, GRAD_ATOL)
    # without a gradient the forward alone runs, to the same bits
    with torch.no_grad():
        again = ts.splash_attention(tq, tk, tv, layout, block, causal=causal)
    assert torch.equal(again, out.detach())


def test_splash_gradients_equal_the_gather_path_on_a_dense_row_layout():
    """The splash route and the gather route are the same function: on
    BigBird's bidirectional layout (dense global rows) at T 256 their
    gradients agree within the JAX package's splash-vs-gather bound."""
    B, H, T, hd, block = 1, 2, 256, 64, 64
    layout = _layout("bigbird-bi", T // block, block)
    q, k, v = _inputs((B, H, T, hd), 3, seed=5, scale=0.3)
    grads = []
    for backend in ("splash", "gather"):
        tq, tk, tv = _t(q, k, v, grad=True)
        out = ts.block_sparse_attention(tq, tk, tv, layout, block, backend=backend)
        (out ** 2).sum().backward()
        grads.append((tq.grad, tk.grad, tv.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# module wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True], ids=["no-kpm", "kpm"])
def test_sparse_self_attention_matches_jax(padded):
    q, k, v = _inputs((2, 4, 64, 8), 3, seed=6)
    kp = None
    if padded:
        kp = np.ones((2, 64), bool)
        kp[:, 48:] = False
    jatt = js.SparseSelfAttention(js.BSLongformerSparsityConfig(num_heads=4, block=16))
    tatt = ts.SparseSelfAttention(ts.BSLongformerSparsityConfig(num_heads=4, block=16))
    want = jatt(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                key_padding_mask=None if kp is None else jnp.asarray(kp))
    got = tatt(*_t(q, k, v), key_padding_mask=None if kp is None else torch.tensor(kp))
    _close(got, want, 0, FWD_TOL)
    np.testing.assert_array_equal(tatt.get_layout(64), jatt.get_layout(64))
    # the default config and the causal rule from the config's attention
    for cfg_j, cfg_t in ((None, None), (
            js.FixedSparsityConfig(num_heads=4, block=16, attention="unidirectional"),
            ts.FixedSparsityConfig(num_heads=4, block=16, attention="unidirectional"))):
        want = js.SparseSelfAttention(cfg_j)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        got = ts.SparseSelfAttention(cfg_t)(*_t(q, k, v))
        _close(got, want, 0, FWD_TOL)


def test_sparse_attention_utils_match_jax():
    toks = np.arange(2 * 30, dtype=np.int32).reshape(2, 30)
    for block in (16, 15):
        want = js.SparseAttentionUtils.pad_to_block_size(block, toks, pad_token_id=7)
        got = ts.SparseAttentionUtils.pad_to_block_size(block, toks, pad_token_id=7)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]
        np.testing.assert_array_equal(ts.SparseAttentionUtils.unpad_sequence_output(got[2], got[0]),
                                      js.SparseAttentionUtils.unpad_sequence_output(want[2], want[0]))
    pe = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(ts.SparseAttentionUtils.extend_position_embedding(pe, 10),
                                  js.SparseAttentionUtils.extend_position_embedding(pe, 10))
