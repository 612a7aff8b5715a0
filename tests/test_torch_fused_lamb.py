"""Parity of the port's LAMB (deepspeed_tpu_torch) with the JAX package's,
on the CPU.

``FusedLamb.update`` (the plain per-leaf step) is held to the JAX
``FusedLamb.update``; the engine's seam ``engine_update`` (two passes per
leaf; the plain version of the CUDA kernels on CPU tensors) to the JAX
``engine_update(..., interpret=True)``, which runs its Pallas kernels
interpreted for the 256-aligned leaves and ``_lamb_math`` for the ragged
one.  The leaves are chosen so that the trust ratio takes every branch:
a unit-scale leaf hits ``max_coeff`` 0.3, a 1e-4-scale leaf ``min_coeff``
0.01, an all-zero leaf takes 1, a ragged 0.1-scale leaf stays inside the
clamp.  Inputs come from numpy seeds.

Tolerance: 1e-6 absolute on p, m and v (entries ~1e-4 to ~3): both sides
evaluate the same f32 expressions in the same order; only the norms' sums
run in another order, which moves the trust ratio by an ulp or so.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.kernels import fused_update as jfu
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops.kernels import fused_update as tfu
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb, LambState

TOL = 1e-6
CLAMP = dict(max_coeff=0.3, min_coeff=0.01)


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"aligned": rng.standard_normal((16, 256)).astype(np.float32),
            "small": (1e-4 * rng.standard_normal((8, 256))).astype(np.float32),
            "zero": np.zeros((8, 256), np.float32),
            "ragged": (0.1 * rng.standard_normal((37, 5))).astype(np.float32)}


def _grads(step, like):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in like.items()}


def _opts(bias_correction):
    kw = dict(lr=1e-2, betas=(0.9, 0.999), weight_decay=0.01, bias_correction=bias_correction,
              **CLAMP)
    return JFusedLamb(**kw), FusedLamb(**kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("bias_correction", [True, False], ids=["bc", "no_bc"])
def test_plain_update_matches_jax_update(bias_correction):
    leaves = _leaves(1)
    names = sorted(leaves)
    jopt, topt = _opts(bias_correction)
    jp = {k: jnp.asarray(v) for k, v in leaves.items()}
    jst = jopt.init(jp)
    tp = [torch.from_numpy(leaves[k].copy()) for k in names]
    tst = topt.init(tp)
    assert isinstance(tst, LambState) and int(tst.step) == 0
    for step in range(3):
        g = _grads(step, leaves)
        ju, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                              lr=jnp.float32(1e-2))
        tu, tst = topt.update([torch.from_numpy(g[k]) for k in names], tst, tp,
                              lr=torch.tensor(1e-2))
        jp = {k: jp[k] + ju[k] for k in names}
        tp = [p + u for p, u in zip(tp, tu)]
    for i, k in enumerate(names):
        _close(tp[i], jp[k])
        _close(tst.exp_avg[i], jst.exp_avg[k])
        _close(tst.exp_avg_sq[i], jst.exp_avg_sq[k])
    assert int(tst.step) == int(jst.step) == 3


@pytest.mark.parametrize("bias_correction", [True, False], ids=["bc", "no_bc"])
def test_engine_update_three_steps_with_overflow_matches_jax(bias_correction):
    """Three steps, the middle one skipped on overflow (its gradients
    carry an inf): p, m, v and the step count against the JAX seam."""
    leaves = _leaves(3)
    names = sorted(leaves)
    jopt, topt = _opts(bias_correction)
    jp = {k: jnp.asarray(v) for k, v in leaves.items()}
    jst = jopt.init(jp)
    tp = [torch.from_numpy(leaves[k].copy()) for k in names]
    tst = topt.init(tp)
    kernels.reset_launches()
    for step, overflow in enumerate((False, True, False)):
        g = _grads(step, leaves)
        if overflow:
            g["aligned"][0, 0] = np.inf
        before = [t.clone() for t in tp + tst.exp_avg + tst.exp_avg_sq]
        jp, jst = jfu.engine_update(jopt, {k: jnp.asarray(v) for k, v in g.items()}, jst, jp,
                                    jnp.float32(1e-2), jnp.bool_(overflow), interpret=True)
        tst = tfu.engine_update(topt, [torch.from_numpy(g[k]) for k in names], tst, tp, 1e-2,
                                torch.tensor(overflow))
        if overflow:  # a skipped step writes back the old state bit for bit
            for a, b in zip(tp + tst.exp_avg + tst.exp_avg_sq, before):
                assert torch.equal(a, b)
    for i, k in enumerate(names):
        _close(tp[i], jp[k])
        _close(tst.exp_avg[i], jst.exp_avg[k])
        _close(tst.exp_avg_sq[i], jst.exp_avg_sq[k])
    assert int(tst.step) == int(jst.step) == 2
    assert all(n == 0 for n in kernels.launches().values())  # CPU tensors: the plain version


@pytest.mark.parametrize("keep", [1.0, 0.0], ids=["step", "skip"])
@pytest.mark.parametrize("leaf", ["aligned", "small", "zero", "ragged"])
def test_lamb_leaf_matches_jax_leaf_and_its_trust_branch(leaf, keep):
    """One leaf with random moments through the port's ``lamb_leaf`` and
    the JAX leaf path ``engine_update`` routes it to (the interpreted
    Pallas pair for an aligned leaf, ``_lamb_math`` for a ragged one); the
    trust ratio takes the branch its leaf was chosen for."""
    p = _leaves(5)[leaf]
    rng = np.random.default_rng(6)
    g = rng.standard_normal(p.shape).astype(np.float32)
    m = (0.1 * rng.standard_normal(p.shape)).astype(np.float32)
    v = (0.01 * rng.random(p.shape)).astype(np.float32)
    scal = np.array([1e-2, keep, 0.19, 0.002], np.float32)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, **CLAMP)
    args = [jnp.asarray(a) for a in (p, g, m, v)]
    if leaf == "ragged":
        ref = jfu._lamb_math(*args, *(jnp.float32(s) for s in scal), **hyper)
    else:
        ref = jfu._lamb_pallas_leaf(*args, jnp.asarray(scal), block_rows=8, interpret=True,
                                    **hyper)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    trust = tfu.lamb_leaf(tp, torch.from_numpy(g), tm, tv, torch.from_numpy(scal), **hyper)
    for got, want in zip((tp, tm, tv), ref):
        _close(got, want)
    want_trust = {"aligned": 0.3, "small": 0.01, "zero": 1.0}.get(leaf)
    if want_trust is not None:
        assert float(trust) == pytest.approx(want_trust, rel=1e-6)
    else:
        assert 0.01 < float(trust) < 0.3
    if keep == 0.0:
        assert np.array_equal(tp.numpy(), p) and np.array_equal(tm.numpy(), m)


def test_lamb_math_is_the_direction_body_trust_and_apply():
    """``_lamb_math`` splits into the kernels' two passes: the direction
    body (pass 1), the trust from the whole leaf's norms, and
    ``p - keep * lr * trust * dir`` (pass 2)."""
    rng = np.random.default_rng(9)
    p, g, m = (torch.from_numpy(rng.standard_normal((300,)).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(rng.random(300).astype(np.float32))
    lr, keep, c1, c2 = (torch.tensor(x) for x in (2e-3, 1.0, 0.1, 0.001))
    hyper = dict(b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01)
    p_new, m_new, v_new, trust = tfu._lamb_math(p, g, m, v, lr, keep, c1, c2, max_coeff=10.0,
                                                min_coeff=0.01, **hyper)
    d, m2, v2 = tfu._lamb_dir_body(p, g, m, v, keep, c1, c2, **hyper)
    assert torch.equal(m_new, m2) and torch.equal(v_new, v2)
    t2 = tfu._lamb_trust(p.norm(), d.norm(), 0.01, 10.0)
    assert float(trust) == pytest.approx(float(t2), rel=1e-6)
    assert torch.equal(p_new, p - keep * lr * trust * d)
    assert tfu._lamb_blocks(1) == 1 and tfu._lamb_blocks(4096) == 4
    assert tfu._lamb_blocks(30522 * 1024) == 132 * 8
