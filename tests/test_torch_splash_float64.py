"""The bf16 block-sparse backward against its float64 function, on the CPU.

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
  than ``deg`` valid edges.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
