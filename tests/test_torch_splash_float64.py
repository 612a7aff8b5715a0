"""The bf16 block-sparse backward, and the bf16 forwards, against their
float64 functions, on the CPU.

The card's bf16 B9a / B9b (``csrc/splash_attn_tc.cu``) sum S and dP on the
tensor cores, in another order than any plain version, so a bf16 P or dS
next to a rounding tie may round to the other neighbour; they are held to
``sparse.splash_bwd_float64`` (the float64 function of the same inputs and
the bound of the bf16 contract around it, ``flash_bwd_float64`` over the
layout's scores).  Here, at small shapes (T <= 512, blocks of 64 and 96,
d 32 and 64, causal BigBird, a per-head layout and untouched key columns):

* the port's bf16 plain backward (``splash_bwd_dq_reference``,
  ``splash_bwd_dkv_reference``) and the JAX package's interpreted Pallas
  kernels (``_splash_bwd(..., interpret=True)``) on the same bf16 inputs
  and forward residuals both lie within that bound, and a dq that misses
  one key tile of one edge lies more than 10x outside it, so the bound has
  teeth;
* B9b's work items (``_dkv_items``, through the kernels' index arrays)
  cover every column's valid edges exactly once and in edge order, at most
  ``deg`` a piece, and a column is cut into several items (the kernel's
  "split" columns, which go through f32 partials) exactly when it has more
  than ``deg`` valid edges;
* the bf16 forwards (the splash forward B8 and the dense flash forward B1,
  whose card kernels sum on the tensor cores) against
  ``sparse.splash_fwd_float64`` / ``flash_attention.flash_fwd_float64``:
  the port's plain version and the JAX package's interpreted Pallas kernel
  within the bf16 outputs' 2e-2 (the output rounded to bf16, spacing 2**-8
  relative, after p is rounded to bf16 before P.V), lse within 1e-4 (f32
  sums of up to T terms) with the +inf rows of a row with no block equal,
  and a forward whose layout misses one edge lies outside 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import flash_attention as jfa
from deepspeed_tpu.ops.attention import sparse as js
from deepspeed_tpu_torch.ops.attention import flash_attention as tfa
from deepspeed_tpu_torch.ops.attention import sparse as ts

CASES = [
    # (layout kind, T, hd, block), causal
    ("bigbird-uni", 512, 64, 64),
    ("bigbird-uni", 384, 32, 96),   # a block that is no multiple of 64
    ("per-head", 256, 64, 64),
    ("untouched-columns", 256, 32, 64),
]


def _layout(kind, nb, block):
    if kind == "bigbird-uni":
        return js.BigBirdSparsityConfig(num_heads=2, block=block,
                                        attention="unidirectional").make_layout(nb * block)
    return ts.check_layouts(nb)[kind]  # per-head, untouched-columns (H = 2)


def _missing_tile(dq, q, k, v, do, lse, delta, layout, block, scale):
    """``dq`` less the share of one 64-key tile of one edge: the last row
    block's first active key block off the diagonal, in float64."""
    nb = layout.shape[1]
    r = nb - 1
    h = 0
    c = int(np.nonzero(layout[h, r, :r])[0][0])
    rows = slice(r * block, (r + 1) * block)
    keys = slice(c * block, c * block + 64)
    qd, kd, vd, dod = (t[0, h].double() for t in (q, k, v, do))
    p = torch.exp(qd[rows] @ kd[keys].T * scale - lse[0, h, rows].double()[:, None])
    ds = p * (dod[rows] @ vd[keys].T - delta[0, h, rows].double()[:, None]) * scale
    out = dq.double().clone()
    out[0, h, rows] -= ds @ kd[keys]
    return out.to(dq.dtype)


@pytest.mark.parametrize("kind,T,hd,block", CASES, ids=[f"{c[0]}-T{c[1]}-b{c[3]}" for c in CASES])
def test_bf16_plain_and_jax_splash_backward_lie_within_the_float64_bound(kind, T, hd, block):
    nb = T // block
    layout = _layout(kind, nb, block)
    scale = hd ** -0.5
    r = np.random.default_rng(17)
    jq, jk, jv, jg = (jnp.asarray(r.standard_normal((1, 2, T, hd)), jnp.bfloat16)
                      for _ in range(4))
    jout, jlse = js._splash_fwd(jq, jk, jv, layout, block, True, scale, True, want_lse=True)
    jax_grads = js._splash_bwd(jq, jk, jv, jout, jlse, jg, layout, block, True, scale, True)
    tq, tk, tv, tg = (torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
                      for x in (jq, jk, jv, jg))
    lse = torch.from_numpy(np.array(jlse, np.float32))
    delta = (tg.float() * torch.from_numpy(np.array(jout, np.float32))).sum(-1)
    args = (tq, tk, tv, tg, lse, delta, layout, block, True, scale)
    plain = (ts.splash_bwd_dq_reference(*args), *ts.splash_bwd_dkv_reference(*args))
    assert all(g.dtype == torch.bfloat16 for g in plain)
    witness = ts.splash_bwd_float64(*args)
    from_jax = [torch.from_numpy(np.array(g, np.float32)) for g in jax_grads]
    assert max(tfa.float64_over_bound(from_jax, witness)) <= 1.0
    assert max(tfa.float64_over_bound(plain, witness)) <= 1.0
    missing = _missing_tile(plain[0], tq, tk, tv, tg, lse, delta, layout, block, scale)
    assert tfa.float64_over_bound((missing, *plain[1:]), witness)[0] > 10.0
    if kind == "untouched-columns":  # no score reaches these key blocks
        for h, col in ts.UNTOUCHED_COLUMNS:
            for grad in witness[0][1:]:
                assert not grad.reshape(1, 2, nb, block, hd)[:, h, col].any()


def _bigbird(nb, att="unidirectional", block=16):
    return ts.BigBirdSparsityConfig(num_heads=2, block=block, attention=att).make_layout(
        nb * block)


@pytest.mark.parametrize("kind", ["bigbird-uni-64", "bigbird-bi-16", "per-head",
                                  "untouched-columns", "zero-degree-row", "all-ones"])
def test_dkv_items_cover_every_column_once_in_order_and_flag_split_columns(kind):
    if kind == "bigbird-uni-64":
        layout = _bigbird(64)  # GPT-2's T 16384 layout's shape: the global column splits
    elif kind == "bigbird-bi-16":
        layout = _bigbird(16, "bidirectional")  # global rows: the dense bucket's
    elif kind == "all-ones":
        layout = np.ones((2, 6, 6), np.uint8)  # exempt from the dense bucket
    else:
        layout = ts.check_layouts(8)[kind]
    sl = ts._splash_layout(layout)
    nb = sl.shape[1]
    idx, valid, deg, (qidx, flags, item_col, item_off, col_items) = ts._kernel_arrays(layout,
                                                                                      "cpu")
    active = (sl != 0) & ~ts._dense_row_mask(sl, exempt_uniform_full=True)[:, :, None]
    W = item_col.shape[1]
    split_seen = False
    for h in range(sl.shape[0]):
        ci = col_items[h].tolist()
        assert ci[0] == 0 and ci == sorted(ci)
        for c in range(nb):
            items = range(ci[c], ci[c + 1])
            assert len(items) >= 1 and all(int(item_col[h, w]) == c for w in items)
            edges = []
            for w in items:
                e0, e1 = int(item_off[h, w]), int(item_off[h, w + 1])
                assert e0 <= e1
                real = [int(qidx[h, e]) for e in range(e0, e1) if int(flags[h, e]) & 1]
                assert len(real) <= deg
                edges += real
            # the column's valid edges: each active row once, ascending
            assert edges == list(np.nonzero(active[h, :, c])[0])
            split = len(items) > 1
            assert split == (len(edges) > deg)
            split_seen |= split
        assert (item_col[h, ci[nb]:] == -1).all() and ci[nb] <= W
    if kind == "bigbird-uni-64":
        assert split_seen  # the global column is cut into items


FWD_TOL = 2e-2  # bf16 outputs
LSE_TOL = 1e-4


def _bf16(r, shape):
    return jnp.asarray(r.standard_normal(shape), jnp.bfloat16)


def _to_torch(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close_to_float64(out, lse, exact):
    ref, ref_lse = exact
    assert float((out.double() - ref).abs().max()) <= FWD_TOL
    inf = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), inf)
    assert float((lse.double() - ref_lse)[~inf].abs().max()) <= LSE_TOL


@pytest.mark.parametrize("kind,T,hd,block", [*CASES, ("zero-degree-row", 256, 64, 64)],
                         ids=[f"{c[0]}-T{c[1]}-b{c[3]}" for c in CASES] + ["zero-degree-row"])
def test_bf16_plain_and_jax_splash_forward_lie_within_tolerance_of_float64(kind, T, hd, block):
    nb = T // block
    layout = _layout(kind, nb, block) if kind != "zero-degree-row" else ts.check_layouts(nb)[kind]
    scale = hd ** -0.5
    r = np.random.default_rng(23)
    jq, jk, jv = (_bf16(r, (1, 2, T, hd)) for _ in range(3))
    jout, jlse = js._splash_fwd(jq, jk, jv, layout, block, True, scale, True, want_lse=True)
    tq, tk, tv = (_to_torch(x).to(torch.bfloat16) for x in (jq, jk, jv))
    exact = ts.splash_fwd_float64(tq, tk, tv, layout, block, True, scale)
    out, lse = ts.splash_fwd_reference(tq, tk, tv, layout, block, True, scale)
    assert out.dtype == torch.bfloat16
    _close_to_float64(out, lse, exact)
    _close_to_float64(_to_torch(jout), _to_torch(jlse), exact)
    if kind == "zero-degree-row":
        assert bool(torch.isinf(exact[1][0, 0, block:2 * block]).all())
        assert not exact[0][0, 0, block:2 * block].any()
    # one edge fewer: the last row block's first active key block off the diagonal
    if kind != "zero-degree-row":
        fewer = ts._splash_layout(layout).copy()
        c = int(np.nonzero(fewer[0, nb - 1, : nb - 1])[0][0])
        fewer[0, nb - 1, c] = 0
        if fewer.shape[0] == 1:
            fewer = np.concatenate([fewer, ts._splash_layout(layout)], 0)
        missing = ts.splash_fwd_float64(tq, tk, tv, fewer, block, True, scale)[0]
        assert float((out.double() - missing).abs().max()) > FWD_TOL


@pytest.mark.parametrize("causal,bias", [(True, False), (False, True)],
                         ids=["causal", "kbias"])
def test_bf16_plain_and_jax_flash_forward_lie_within_tolerance_of_float64(causal, bias):
    """GPT-2's causal form and BERT's key-padding bias, at (2, 2, 256, 64)."""
    B, H, T, d = 2, 2, 256, 64
    scale = d ** -0.5
    r = np.random.default_rng(29)
    jq, jk, jv = (_bf16(r, (B, H, T, d)) for _ in range(3))
    kb = np.zeros((B, T), np.float32)
    kb[1, 200:] = -1e9  # row 1 keeps 200 of its keys
    jbias = jnp.asarray(kb)[:, None, None, :] if bias else None
    jout, jlse = jfa._flash_fwd_pallas(jq, jk, jv, causal, scale, 128, 128, True, bias=jbias)
    tq, tk, tv = (_to_torch(x).to(torch.bfloat16) for x in (jq, jk, jv))
    tkb = torch.from_numpy(kb) if bias else None
    exact = tfa.flash_fwd_float64(tq, tk, tv, causal, scale, kbias=tkb)
    out, lse = tfa.flash_fwd_reference(tq, tk, tv, causal, scale, kbias=tkb)
    _close_to_float64(out, lse, exact)
    _close_to_float64(_to_torch(jout), _to_torch(jlse), exact)
    # the f32 plain version of the same inputs sits far closer
    out32, _ = tfa.flash_fwd_reference(tq.float(), tk.float(), tv.float(), causal, scale,
                                       kbias=tkb)
    assert float((out32.double() - exact[0]).abs().max()) <= 1e-5
