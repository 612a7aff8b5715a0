"""Parity of the port's fused Adam update (deepspeed_tpu_torch) with the
JAX package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode
(``_adam_pallas_leaf(..., interpret=True)``) for a lane-aligned leaf and
its XLA leaf path (``_adam_math``) for a ragged one, as ``engine_update``
routes them; the port runs the plain version of its CUDA kernel
(``adam_leaf`` on CPU tensors) for every leaf.  Inputs come from one
numpy seed.

Tolerances: parameters 1e-6 and moments 1e-7, absolute, at parameter
values ~1 and moments ~1e-2: both sides evaluate the same f32 expression
in the same order, so only the last bit of a division or square root may
differ (the bias corrections ``1 - b**t`` are f32 powers on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.ops.kernels import fused_update as jfu
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam, FusedAdamW
from deepspeed_tpu_torch.ops.kernels import fused_update as tfu

P_TOL = 1e-6
M_TOL = 1e-7
HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"aligned": rng.standard_normal((16, 256)).astype(np.float32),
            "ragged": rng.standard_normal((37, 5)).astype(np.float32)}


def _grads(step, like):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in like.items()}


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "adam_l2"])
def test_adam_leaf_plain_matches_pallas_leaf_and_xla_leaf(adam_w_mode):
    leaves = _leaves(1)
    rng = np.random.default_rng(2)
    scal = np.array([1e-2, 1.0, 0.19, 0.002], np.float32)
    for name, p in leaves.items():
        g = rng.standard_normal(p.shape).astype(np.float32)
        m = (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
        v = (0.01 * rng.random(p.shape)).astype(np.float32)
        if name == "aligned":
            ref = jfu._adam_pallas_leaf(
                jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), jnp.asarray(scal),
                adam_w_mode=adam_w_mode, block_rows=8, interpret=True, **HYPER)
        else:
            ref = jfu._adam_math(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                                 *(jnp.float32(s) for s in scal), adam_w_mode=adam_w_mode, **HYPER)
        tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
        tfu.adam_leaf(tp, torch.from_numpy(g), tm, tv, torch.from_numpy(scal),
                      adam_w_mode=adam_w_mode, **HYPER)
        np.testing.assert_allclose(tp.numpy(), np.asarray(ref[0]), atol=P_TOL, rtol=0)
        np.testing.assert_allclose(tm.numpy(), np.asarray(ref[1]), atol=M_TOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(ref[2]), atol=M_TOL, rtol=0)


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "adam_l2"])
def test_engine_update_three_steps_matches_jax(adam_w_mode):
    leaves = _leaves(3)
    jopt = JFusedAdam(lr=1e-2, betas=(0.9, 0.999), weight_decay=0.01, adam_w_mode=adam_w_mode)
    topt = FusedAdam(lr=1e-2, betas=(0.9, 0.999), weight_decay=0.01, adam_w_mode=adam_w_mode)
    jp = {k: jnp.asarray(v) for k, v in leaves.items()}
    jst = jopt.init(jp)
    names = sorted(leaves)
    tp = [torch.from_numpy(leaves[k].copy()) for k in names]
    tst = topt.init(tp)
    for step in range(3):
        g = _grads(step, leaves)
        jp, jst = jfu.engine_update(jopt, {k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                                    jnp.float32(1e-2), jnp.bool_(False), interpret=True)
        tst = tfu.engine_update(topt, [torch.from_numpy(g[k]) for k in names], tst, tp, 1e-2,
                                torch.tensor(False))
    for i, k in enumerate(names):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[k]), atol=P_TOL, rtol=0)
        np.testing.assert_allclose(tst.exp_avg[i].numpy(), np.asarray(jst.exp_avg[k]), atol=M_TOL, rtol=0)
        np.testing.assert_allclose(tst.exp_avg_sq[i].numpy(), np.asarray(jst.exp_avg_sq[k]),
                                   atol=M_TOL, rtol=0)
    assert int(tst.step) == int(jst.step) == 3


def test_overflow_skip_preserves_state_bit_equal():
    """As ``tests/test_kernels.py`` checks for JAX: a skipped step leaves
    p, m and v bit-equal and the step count at 0."""
    opt = FusedAdamW(lr=1e-2)
    leaves = _leaves(4)
    params = [torch.from_numpy(v.copy()) for v in leaves.values()]
    st = opt.init(params)
    st.exp_avg[0].fill_(0.5)
    before = [t.clone() for t in params + st.exp_avg + st.exp_avg_sq]
    grads = [torch.randn(p.shape) for p in params]
    for g in grads:
        g.view(-1)[0] = float("inf")
    st = tfu.engine_update(opt, grads, st, params, 1e-2, torch.tensor(True))
    for a, b in zip(params + st.exp_avg + st.exp_avg_sq, before):
        assert torch.equal(a, b)
    assert int(st.step) == 0


def test_plain_update_matches_jax_update_and_non_adam_returns_none():
    """``FusedAdam.update`` (the functional plain step) against the JAX
    one, with a skip flag; SGD is not kernel-eligible; LAMB raises."""
    from deepspeed_tpu_torch.ops.adam.fused_adam import SGD

    leaves = _leaves(5)
    jopt = JFusedAdam(lr=1e-2, weight_decay=0.01)
    topt = FusedAdam(lr=1e-2, weight_decay=0.01)
    g = _grads(0, leaves)
    names = sorted(leaves)
    jp = {k: jnp.asarray(v) for k, v in leaves.items()}
    ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jopt.init(jp), jp,
                          lr=jnp.float32(1e-2), skip=jnp.bool_(False))
    tp = [torch.from_numpy(leaves[k]) for k in names]
    tu, tst = topt.update([torch.from_numpy(g[k]) for k in names], topt.init(tp), tp,
                          lr=torch.tensor(1e-2), skip=torch.tensor(False))
    for i, k in enumerate(names):
        np.testing.assert_allclose(tu[i].numpy(), np.asarray(ju[k]), atol=P_TOL, rtol=0)
    assert int(tst.step) == int(jst.step) == 1
    sgd = SGD(lr=1e-2)
    assert tfu.engine_update(sgd, tp, sgd.init(tp), tp, 1e-2, None) is None

    class FusedLamb:
        name = "lamb"

    with pytest.raises(NotImplementedError, match="B7"):
        tfu.engine_update(FusedLamb(), tp, None, tp, 1e-2, None)
    with pytest.raises(NotImplementedError, match="A13"):
        FusedAdam(state_precision="8bit")


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "adam_l2"])
def test_adam_update_reference_matches_jax_and_the_keep_body(adam_w_mode):
    """The port's unfolded entry point (the keep-folded body at keep = 1)
    equals the JAX package's unfolded body and the keep-folded body."""
    rng = np.random.default_rng(6)
    p, g = (rng.standard_normal((32, 256)).astype(np.float32) for _ in range(2))
    m = (0.1 * rng.standard_normal((32, 256))).astype(np.float32)
    v = (0.01 * rng.random((32, 256))).astype(np.float32)
    args = (0.01, 0.9, 0.999, 1e-8, 0.01, adam_w_mode, 0.19, 0.002)
    ref = jfu.adam_update_reference(jnp, *(jnp.asarray(a) for a in (p, g, m, v)), *args)
    got = tfu.adam_update_reference(*(torch.from_numpy(a) for a in (p, g, m, v)), *args)
    keep = tfu._adam_keep_body(*(torch.from_numpy(a) for a in (p, g, m, v)),
                               *torch.tensor([0.01, 1.0, 0.19, 0.002]).unbind(0), b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, adam_w_mode=adam_w_mode)
    for a, b, c in zip(ref, got, keep):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=P_TOL, rtol=0)
        np.testing.assert_allclose(c.numpy(), b.numpy(), atol=P_TOL, rtol=0)
