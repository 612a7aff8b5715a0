"""The port's reduced-precision Adam state (``state_precision`` "8bit" and
"bf16") against the JAX package's, on the CPU.

The same numpy inputs go through ``deepspeed_tpu``'s ``FusedAdam`` and
``deepspeed_tpu_torch``'s.  Without a generator (JAX: ``rng=None``) both
round to nearest, so the codes agree but for ties: the sqrt and the
division may differ in their last bit, moving a value that sits on .5 by
one code.  Stochastic rounding draws from a ``torch.Generator`` in the
port and from JAX's ``rng_bit_generator`` (ROADMAP C4): it is held
statistically, not bit for bit.

Tolerances: block scales 1e-7 relative (one f32 rounding of absmax /
255); one update 1e-6 absolute at lr 1e-2 (both sides evaluate the same
f32 expression; the decoded v may differ by one code where a tie moved).
The engine's 8-bit run tracks its f32 run within 2e-3 in loss over six
steps on GPT2_TINY (the decoded v is within half a code of the f32 v).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.adam import fused_adam as fused_adam_mod
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState8, FusedAdam
from deepspeed_tpu_torch.ops.kernels import fused_update as tfu

SCALE_RTOL = 1e-7
UPD_TOL = 1e-6
ENGINE_LOSS_TOL = 2e-3


def _v(n, seed=0):
    """A realistic v: non-negative, spanning six orders of magnitude."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) ** 2) * 10.0 ** rng.uniform(-8, -2, n)).astype(np.float32)


def test_v_blocks_equal_the_jax_packages():
    for block in (256, 64):
        t, j = FusedAdam(state_precision="8bit", state_block=block), JFusedAdam(
            state_precision="8bit", state_block=block)
        for n in (1, 100, 16383, 16384, 16385, 16387, 65536 + 7, 3 * 50257, 768 * 3072,
                  2**14 * 17, 65521 * 2):
            assert t._v_blocks(n) == j._v_blocks(n), (block, n)


@pytest.mark.parametrize("shape", [(64, 512), (50257,), (3, 8)], ids=["blocked", "odd", "tiny"])
def test_encode_decode_without_generator_match_jax(shape):
    t, j = FusedAdam(state_precision="8bit"), JFusedAdam(state_precision="8bit")
    v = _v(int(np.prod(shape)), 1).reshape(shape)
    tq, ts = t._v_encode(torch.from_numpy(v), None)
    jq, js = j._v_encode(jnp.asarray(v), None)
    assert tq.dtype == (torch.uint8 if t._v_blocks(v.size) else torch.float32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL, atol=0)
    diff = np.abs(tq.numpy().astype(np.float64) - np.asarray(jq).astype(np.float64))
    if tq.dtype == torch.uint8:
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
    else:
        assert diff.max() == 0
    # decode the same codes on both sides
    dec_t = t._v_decode(torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js)))
    dec_j = np.asarray(j._v_decode(jq, js))
    np.testing.assert_allclose(dec_t.numpy(), dec_j, rtol=1e-6, atol=0)
    # bf16 state: nearest rounding without a generator, the same bits
    tb, jb = FusedAdam(state_precision="bf16"), JFusedAdam(state_precision="bf16")
    np.testing.assert_array_equal(
        tb._v_encode(torch.from_numpy(v), None)[0].float().numpy(),
        np.asarray(jb._v_encode(jnp.asarray(v), None)[0]).astype(np.float32))


@pytest.mark.parametrize("precision", ["8bit", "bf16"])
@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "adam_l2"])
def test_one_update_without_generator_matches_jax(precision, adam_w_mode):
    rng = np.random.default_rng(2)
    shapes = {"big": (64, 512), "small": (40, 8)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, weight_decay=0.01, adam_w_mode=adam_w_mode, state_precision=precision)
    jopt, topt = JFusedAdam(**kw), FusedAdam(**kw)
    # a state with history: two JAX steps, then the same codes on both sides
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jst = jopt.init(jp)
    for s in range(2):
        jg = {k: jnp.asarray(np.random.default_rng(10 + s).standard_normal(v.shape),
                             jnp.float32) for k, v in p.items()}
        _, jst = jopt.update(jg, jst, jp, rng=None)
    names = sorted(shapes)
    t_state = AdamState8(
        step=torch.tensor(int(jst.step), dtype=torch.int32),
        exp_avg=[torch.from_numpy(np.asarray(jst.exp_avg[k]).astype(np.float32)).bfloat16()
                 for k in names],
        vq=[torch.from_numpy(np.array(np.asarray(jst.vq[k]).astype(np.float32)
                                      if precision == "bf16" else np.asarray(jst.vq[k])))
            for k in names],
        vs=[torch.from_numpy(np.array(jst.vs[k])) for k in names])
    if precision == "bf16":
        t_state.vq = [v.bfloat16() for v in t_state.vq]
    ju, jst2 = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp, rng=None)
    tu, tst2 = topt.update([torch.from_numpy(g[k]) for k in names], t_state,
                           [torch.from_numpy(p[k]) for k in names], lr=torch.tensor(1e-2))
    for i, k in enumerate(names):
        np.testing.assert_allclose(tu[i].numpy(), np.asarray(ju[k]), atol=UPD_TOL, rtol=0)
        np.testing.assert_array_equal(tst2.exp_avg[i].float().numpy(),
                                      np.asarray(jst2.exp_avg[k]).astype(np.float32))
        dq = np.abs(tst2.vq[i].float().numpy() - np.asarray(jst2.vq[k]).astype(np.float32))
        assert dq.max() <= (1 if tst2.vq[i].dtype == torch.uint8 else 0), dq.max()
    assert int(tst2.step) == int(jst2.step) == 3


@pytest.mark.parametrize("precision", ["8bit", "bf16"])
def test_in_place_chunked_step_equals_the_functional_update(precision, monkeypatch):
    """The engine's ``step_reduced_`` (in place, block-aligned chunks of
    1024 elements here) gives ``update``'s values bit for bit without a
    generator, an overflow step included."""
    monkeypatch.setattr(fused_adam_mod, "REDUCED_CHUNK", 1024)
    rng = np.random.default_rng(7)
    shapes = [(64, 512), (3, 5), (16384 + 256,)]
    opt = FusedAdam(lr=1e-2, weight_decay=0.01, state_precision=precision)
    p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    a_state, b_state = opt.init(p), opt.init(p)
    a_p, b_p = [t.clone() for t in p], [t.clone() for t in p]
    for step in range(3):
        g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        skip = torch.tensor(step == 1)
        upd, a_state = opt.update(g, a_state, a_p, skip=skip)
        a_p = [(x + u) for x, u in zip(a_p, upd)]
        opt.step_reduced_(g, b_state, b_p, skip=skip)
    assert all(torch.equal(x, y) for x, y in zip(a_p, b_p))
    for name in ("exp_avg", "vq", "vs"):
        assert all(torch.equal(x, y) for x, y in zip(getattr(a_state, name),
                                                      getattr(b_state, name))), name
    assert int(a_state.step) == int(b_state.step) == 2


def test_stochastic_rounding_is_unbiased():
    """Mean over 400 draws of the decoded sqrt(v) (8bit) and of the bf16
    value equals the input within 4 standard errors, where nearest
    rounding is biased by up to half a step."""
    opt = FusedAdam(state_precision="8bit")
    v = torch.from_numpy(_v(16384, 3))
    gen = torch.Generator().manual_seed(0)
    u = torch.sqrt(v).reshape(-1, 256)
    acc = torch.zeros_like(u, dtype=torch.float64)
    n = 400
    for _ in range(n):
        q, s = opt._v_encode(v, gen)
        acc += q.reshape(-1, 256).double() * s[:, None].double()
    mean = acc / n
    step = (u.amax(dim=1, keepdim=True) / 255.0).double()
    # floor(q + U) has variance <= 1/4 code^2: standard error step/(2 sqrt n)
    err = ((mean - u.double()) / step).abs()
    assert float(err.max()) < 4 * 0.5 / np.sqrt(n) * 2, float(err.max())
    near = (torch.round(u / (u.amax(dim=1, keepdim=True) / 255.0)) * (
        u.amax(dim=1, keepdim=True) / 255.0)).double()
    assert float(((near - u.double()) / step).abs().max()) > 0.45  # nearest is biased
    x = torch.full((4096,), 1.0 + 2.0**-10, dtype=torch.float32)  # 1/8 of a bf16 ulp above 1
    sr = torch.stack([FusedAdam._sr_bf16(x, gen).float() for _ in range(n)]).mean()
    assert abs(float(sr) - float(x[0])) < 4 * 2.0**-7 / np.sqrt(n * 4096) * 2
    assert float(x.bfloat16().float()[0]) == 1.0  # nearest drops the increment


def test_8bit_state_stable_across_skipped_steps():
    """A burst of overflow-skipped steps leaves m's bits, moves no
    parameter and lets v's codes drift by at most one (nearest re-encode),
    as the JAX package's test holds its optimizer."""
    rng = np.random.default_rng(4)
    p = [torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))]
    opt = FusedAdam(lr=1e-2, state_precision="8bit")
    state = opt.init(p)
    g_good = [torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))]
    for i in range(3):
        _, state = opt.update(g_good, state, p, skip=torch.tensor(False),
                              generator=torch.Generator().manual_seed(i))
    m0, vq0 = state.exp_avg[0].clone(), state.vq[0].clone()
    g_bad = [torch.full((64, 512), float("inf"))]
    for i in range(5):
        upd, state = opt.update(g_bad, state, p, skip=torch.tensor(True),
                                generator=torch.Generator().manual_seed(100 + i))
        assert float(upd[0].abs().max()) == 0.0
    assert torch.equal(state.exp_avg[0], m0)
    drift = (state.vq[0].int() - vq0.int()).abs()
    assert int(drift.max()) <= 1
    assert int(state.step) == 3


def test_reduced_state_takes_the_plain_update_and_its_bytes():
    opt8 = FusedAdam(state_precision="8bit")
    p = [torch.zeros(64, 512), torch.zeros(10)]
    st = opt8.init(p)
    assert tfu.engine_update(opt8, p, st, p, 1e-3, None) is None
    # m bf16 + v uint8 + a scale per 256: ~3 B a parameter; tiny leaves f32
    assert opt8.state_bytes(st) == 64 * 512 * 3 + (64 * 512 // 256) * 4 + 10 * 6 + 4
    assert FusedAdam().state_bytes(FusedAdam().init(p)) == (64 * 512 + 10) * 8


def _engine(precision=None, seed=0, **extra):
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=64)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    params = {"lr": 1e-3, "weight_decay": 0.01}
    if precision:
        params["state_precision"] = precision
    conf = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 1,
            "optimizer": {"type": "AdamW", "params": params}, "seed": seed, **extra}
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                             config=conf, device="cpu")
    return eng


def _batches(n):
    rng = np.random.default_rng(5)
    return [{"input_ids": rng.integers(0, 512, (4, 64))} for _ in range(n)]


def test_engine_8bit_tracks_the_f32_state_run():
    ref, q8 = _engine(), _engine("8bit")
    assert isinstance(q8.opt_state, AdamState8)
    lr_, lq = [], []
    for b in _batches(1) * 6:  # one batch: the loss falls
        lr_.append(float(ref.train_batch(b)))
        lq.append(float(q8.train_batch(b)))
    assert lr_[0] == lq[0] and lr_[1] == lq[1]  # step 1: m = v = 0, f32 Adam's update
    np.testing.assert_allclose(lq, lr_, atol=ENGINE_LOSS_TOL, rtol=0)
    assert lq[-1] < lq[0]


@pytest.mark.parametrize("precision", ["8bit", "bf16"])
def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path, precision):
    torch.use_deterministic_algorithms(True)
    try:
        bs = _batches(5)
        a = _engine(precision)
        for b in bs[:2]:
            a.train_batch(b)
        a.save_checkpoint(str(tmp_path), tag="t")
        cont = [float(a.train_batch(b)) for b in bs[2:]]
        fresh = _engine(precision, seed=0)
        fresh.load_checkpoint(str(tmp_path), tag="t")
        for name, x in (("exp_avg", fresh.opt_state.exp_avg), ("vq", fresh.opt_state.vq),
                        ("vs", fresh.opt_state.vs)):
            assert all(t.dtype == u.dtype for t, u in zip(x, getattr(a.opt_state, name))), name
        assert [float(fresh.train_batch(b)) for b in bs[2:]] == cont
        assert all(torch.equal(x, y) for x, y in zip(fresh._params, a._params))
        assert all(torch.equal(x, y) for x, y in zip(fresh.opt_state.vq, a.opt_state.vq))
    finally:
        torch.use_deterministic_algorithms(False)
