"""1-bit Adam / LAMB and the compressed gradient exchanges of the port
against the JAX package, on the CPU.

* Flat packing (``pack_flat``, ``pack_rows``, ``unpack_flat``): bit for bit.
* ``OnebitAdam`` / ``OnebitLamb``: warm steps (and the single-program steps
  past ``freeze_step``) against the JAX ``update`` within
  ``OPT_RTOL``/``OPT_ATOL`` (the same f32 arithmetic; XLA fuses, torch
  rounds each op, and the quantization scales are means summed in other
  orders); ``make_frozen_state`` and ``frozen_apply`` on stacked rows
  against the JAX functions on a ``data: 4`` mesh; 1-bit Adam's
  variance-sharded layout likewise.  Momentum signs: a flip is allowed only
  where the JAX value lies within 1e-7 of zero, and such flips are counted
  and printed.
* The engine over two gloo ranks (``tools/zero_worker.py``, one spawn for
  every case) against the JAX engine at ``mesh {data: 2}`` (GPT2_TINY, T
  64, f32, gas 2, clipping 1.0): ``OneBitAdam`` and ``OneBitLamb`` through
  ``freeze_step`` 2 and past it, ``comm.strategy`` int8 (nearest rounding)
  and onebit; losses within ``ENGINE_LOSS_RTOL`` and masters within
  ``ENGINE_PARAM_ATOL`` of JAX's.  The bytes the port counts under
  ``grad-exchange`` a compressed step equal ``step_comm_bytes``'s model.
* The group versions of the exchanges over the two ranks against the plain
  ``*_rows`` versions: within 1e-6.
* Checkpoints at the freeze boundary and in the compressed phase, and the
  rollback of a frozen engine to a warm tag (the pattern of
  ``tests/test_onebit.py``): bit for bit in the port.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.runtime.fp16.onebit import adam as jadam
from deepspeed_tpu.runtime.fp16.onebit import lamb as jlamb
from deepspeed_tpu_torch.comm import collectives, compressed
from deepspeed_tpu_torch.comm.strategy import step_comm_bytes
from deepspeed_tpu_torch.runtime.fp16.onebit import adam as tadam
from deepspeed_tpu_torch.runtime.fp16.onebit import lamb as tlamb

from tests.test_torch_zero import T, _gpt2_config, _launch

OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
# the engines after five steps (three compressed): the losses within the
# zero tests' f32 bound; the masters within ENGINE_PARAM_ATOL except where a
# 1-bit sign (or an int8 code) lands apart on a value the two frameworks
# round to either side of zero (or of a rounding boundary).  Such a flip
# moves a coordinate by up to 2 lr scale / sqrt(v): the elements outside
# the bound are counted and printed, and held to FLIP_SHARE of the
# elements whose first gradient is not within SIGN_EPS of zero.  GPT-2's
# key bias has a zero gradient by construction (softmax is blind to it):
# its 1-bit steps are the signs of rounding noise in both frameworks, so
# its coordinates are counted and printed only
ENGINE_LOSS_RTOL, ENGINE_PARAM_ATOL = 2e-5, 2e-5
FLIP_SHARE = 1e-4
SIGN_EPS = 1e-7
N = 4
STEPS, FREEZE = 5, 2


def _leaves(seed, shapes=((3, 5), (7,), (2, 2, 3))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_pack_and_unpack_match_jax():
    leaves = _leaves(0)
    for mult in (1, 4, 7):
        got = tadam.pack_flat([torch.from_numpy(x) for x in leaves], mult)
        want = np.asarray(jadam.pack_flat(leaves, mult))
        np.testing.assert_array_equal(got.numpy(), want)
        back = tadam.unpack_flat(got, [torch.from_numpy(x) for x in leaves])
        jback = jadam.unpack_flat(jnp.asarray(want), leaves)
        for a, b, c in zip(back, jback, leaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c)
    rows = [np.random.default_rng(1).standard_normal((N,) + x.shape).astype(np.float32)
            for x in leaves]
    np.testing.assert_array_equal(
        tadam.pack_rows([torch.from_numpy(r) for r in rows], N, N).numpy(),
        np.asarray(jadam.pack_rows(rows, N, N)))


def _run_update(topt, jopt, steps, seed=2):
    leaves = _leaves(seed)
    tp = [torch.from_numpy(x.copy()) for x in leaves]
    jp = [jnp.asarray(x) for x in leaves]
    tst, jst = topt.init(tp), jopt.init(jp)
    rng = np.random.default_rng(seed + 10)
    for _ in range(steps):
        g = [rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
        tu, tst = topt.update([torch.from_numpy(x) for x in g], tst, tp, lr=torch.tensor(1e-2))
        ju, jst = jopt.update([jnp.asarray(x) for x in g], jst, jp, lr=1e-2)
        tp = [p + u for p, u in zip(tp, tu)]
        jp = [p + u for p, u in zip(jp, ju)]
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_RTOL, atol=OPT_ATOL)
    return tst, jst, tp, jp


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_warm_and_local_steps_match_jax(kind):
    """Four steps at freeze_step 2: two warm, two with local quantization
    (the single-program fallback)."""
    mk = {"adam": (tadam.OnebitAdam, jadam.OnebitAdam),
          "lamb": (tlamb.OnebitLamb, jlamb.OnebitLamb)}[kind]
    kw = dict(lr=1e-2, freeze_step=2, weight_decay=0.01)
    tst, jst, _, _ = _run_update(mk[0](**kw), mk[1](**kw), 4)
    assert int(tst.step) == int(jst.step) == 4
    for field in ("exp_avg", "exp_avg_sq", "worker_error"):
        for a, b in zip(getattr(tst, field), getattr(jst, field)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_RTOL, atol=OPT_ATOL)
    if kind == "lamb":
        for a, b in zip(tst.scaling_coeff, jst.scaling_coeff):
            np.testing.assert_allclose(float(a), float(b), rtol=OPT_RTOL)


def _sign_flips(port_signs, jax_signs, jax_values):
    differ = np.asarray(port_signs) != np.asarray(jax_signs)
    near = np.abs(np.asarray(jax_values)) <= SIGN_EPS
    return int((differ & near).sum()), int((differ & ~near).sum())


@pytest.mark.parametrize("kind", ["adam", "lamb"])
def test_frozen_state_and_steps_match_jax(kind):
    mk = {"adam": (tadam.OnebitAdam, jadam.OnebitAdam),
          "lamb": (tlamb.OnebitLamb, jlamb.OnebitLamb)}[kind]
    kw = dict(lr=1e-2, freeze_step=2, weight_decay=0.01)
    topt, jopt = mk[0](**kw), mk[1](**kw)
    tst, jst, tp, jp = _run_update(topt, jopt, 2, seed=3)
    tfz = topt.make_frozen_state(tst, N, rows=True)
    jfz = jopt.make_frozen_state(jst, N)
    for field in tfz.__dataclass_fields__:
        a, b = getattr(tfz, field), np.asarray(getattr(jfz, field))
        if field == "m_signs":
            m = np.asarray(jadam.pack_flat(jst.exp_avg, N))
            near, far = _sign_flips(a.numpy(), b, m)
            assert far == 0, f"{far} momentum signs differ away from zero"
            print(f"{kind}: make_frozen_state sign flips within {SIGN_EPS} of zero: {near}")
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=OPT_RTOL, atol=OPT_ATOL, err_msg=field)
    mesh = make_mesh(MeshConfig(data=N), devices=jax.devices()[:N])
    p_flat = tadam.pack_flat(tp, N)
    jp_flat = jadam.pack_flat(jp, N)
    rng = np.random.default_rng(4)
    for _ in range(3):
        g = rng.standard_normal((N, p_flat.shape[0])).astype(np.float32)
        tu, tfz = topt.frozen_apply(torch.from_numpy(g), tfz, p_flat, torch.tensor(1e-2))
        ju, jfz = jopt.frozen_apply(jnp.asarray(g), jfz, jp_flat, 1e-2, mesh)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=OPT_RTOL, atol=OPT_ATOL)
        p_flat, jp_flat = p_flat + tu, jp_flat + ju
        for field in ("m_scales", "worker_error", "server_error"):
            np.testing.assert_allclose(getattr(tfz, field).numpy(),
                                       np.asarray(getattr(jfz, field)), rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=field)
        np.testing.assert_array_equal(tfz.m_signs.numpy(), np.asarray(jfz.m_signs))
    assert int(tfz.step) == int(jfz.step) == 5


def test_variance_sharded_layout_matches_jax():
    """1-bit Adam's other frozen layout on stacked rows: the chunk update,
    the whole masters and the exchange's outputs."""
    opt = dict(lr=1e-2, freeze_step=1, weight_decay=0.01)
    topt, jopt = tadam.OnebitAdam(**opt), jadam.OnebitAdam(**opt)
    rng = np.random.default_rng(5)
    mp = 64
    m = rng.standard_normal(mp).astype(np.float32) * 1e-2
    signs, scales = compressed.compress_chunks(torch.from_numpy(m), N)
    v = np.abs(rng.standard_normal((N, mp // N))).astype(np.float32) * 1e-3
    p = rng.standard_normal((N, mp // N)).astype(np.float32)
    g = rng.standard_normal((N, mp)).astype(np.float32)
    werr, serr = np.zeros((N, mp), np.float32), np.zeros((N, mp // N), np.float32)
    mesh = make_mesh(MeshConfig(data=N), devices=jax.devices()[:N])
    got = topt.frozen_apply_vsharded(torch.from_numpy(g), signs, scales, torch.from_numpy(v),
                                     torch.from_numpy(p), torch.from_numpy(werr),
                                     torch.from_numpy(serr), torch.tensor(1e-2))
    want = jopt.frozen_apply_vsharded(jnp.asarray(g), jnp.asarray(signs.numpy()),
                                      jnp.asarray(scales.numpy()), jnp.asarray(v), jnp.asarray(p),
                                      jnp.asarray(werr), jnp.asarray(serr), 1e-2, mesh)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=OPT_RTOL,
                                   atol=OPT_ATOL)


# ---------------------------------------------------------------------------
# the engine over two gloo ranks
# ---------------------------------------------------------------------------

def _opt(kind):
    if kind == "adam":
        return {"type": "OneBitAdam", "params": {"lr": 1e-3, "freeze_step": FREEZE,
                                                 "weight_decay": 0.01}}
    return {"type": "OneBitLamb", "params": {"lr": 1e-3, "freeze_step": FREEZE,
                                             "weight_decay": 0.01}}


def _config(kind):
    cfg = _gpt2_config(0, {"data": 2, "fsdp": 1})
    if kind in ("adam", "lamb"):
        cfg["optimizer"] = _opt(kind)
    else:
        cfg["comm"] = {"strategy": kind, "threshold_bytes": 0, "stochastic_rounding": False}
    return cfg


def _jax_engine(kind, batches, steps):
    cfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=T)
    model_fn, init_fn, tp_fn = jgpt2.make_model(cfg)
    mesh = make_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    eng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                       config=_config(kind), mesh=mesh, tp_spec_fn=tp_fn)
    losses = [float(eng.train_batch({"input_ids": batches[s]})) for s in range(steps)]
    params = eng._unflatten_state_leaves(jax.tree.map(np.asarray, eng.state["params"]))
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            flat["params/" + "/".join(path)] = np.asarray(t)

    walk(params, ())
    # the first step's gradient of the global batch's loss at the initial
    # parameters, by checkpoint name
    p0 = init_fn(seed=3)
    grads = jax.grad(lambda p: model_fn(p, {"input_ids": jnp.asarray(batches[0])}, None))(p0)
    g0 = {}

    def walk_g(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk_g(t[k], path + (k,))
        else:
            g0["params/" + "/".join(path)] = np.asarray(t)

    walk_g(grads, ())
    return losses, flat, bool(getattr(eng, "_onebit_frozen", False)), g0


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("onebit")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jgpt2.GPT2_TINY.vocab_size, (8, 2 * 2 * 2, T), dtype=np.int32)
    np.savez(tmp / "b.npz", input_ids=ids)
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    np.savez(tmp / "c.npz", x=x, werr=(0.1 * rng.standard_normal(x.shape)).astype(np.float32),
             serr=(0.1 * rng.standard_normal((2, 500))).astype(np.float32))
    ck = str(tmp / "ck")

    def case(name, kind, steps, **kw):
        return {"name": name, "preset": "tiny", "model_cfg": {"n_positions": T}, "init_seed": 3,
                "config": _config(kind), "batches": str(tmp / "b.npz"), "steps": steps, **kw}

    cases = [case("adam", "adam", STEPS), case("lamb", "lamb", STEPS),
             case("int8", "int8", 3), case("onebit", "onebit", 3),
             case("ck", "adam", 7, save={"dir": ck, "tag": "frozen", "after": 5}),
             case("roll", "adam", 4, save={"dir": ck, "tag": "warm", "after": 2},
                  reload={"dir": ck, "tag": "warm", "after": 3}, record="none"),
             case("fresh_warm", "adam", 1, load={"dir": ck, "tag": "warm"}, first_batch=3,
                  record="none"),
             case("fresh_frozen", "adam", 2, load={"dir": ck, "tag": "frozen"}, first_batch=5),
             case("ck_onebit", "onebit", 3, save={"dir": ck, "tag": "comm", "after": 2},
                  record="none"),
             case("fresh_onebit", "onebit", 1, load={"dir": ck, "tag": "comm"}, first_batch=2,
                  record="none")]
    _launch(2, cases, tmp, extra={"compressed_check": str(tmp / "c.npz")})
    return {"tmp": tmp, "ids": ids, "ck": ck}


def _read(spawn, name, state=True):
    with open(spawn["tmp"] / f"{name}.json") as f:
        meta = json.load(f)
    if not state:
        return meta, None
    with np.load(spawn["tmp"] / f"{name}.npz") as z:
        return meta, {k: z[k] for k in z.files}


@pytest.mark.parametrize("kind", ["adam", "lamb", "int8", "onebit"])
def test_engine_at_data_2_matches_the_jax_engine(spawn, kind):
    meta, state = _read(spawn, kind)
    steps = len(meta["losses"])
    losses, params, frozen, g0 = _jax_engine(kind, spawn["ids"], steps)
    print(f"{kind}: port {meta['losses']} jax {losses}")
    assert meta["backend"] == "gloo" and meta["world_size"] == 2
    np.testing.assert_allclose(meta["losses"], losses, rtol=ENGINE_LOSS_RTOL)
    outside, near_zero, counted = {}, 0, 0
    for n, p in params.items():
        assert np.all(np.isfinite(state[n])), n
        far = np.abs(state[n] - p) > ENGINE_PARAM_ATOL
        zero = np.abs(g0[n]) <= SIGN_EPS
        near_zero += int((far & zero).sum())
        counted += int((~zero).sum())
        if (far & ~zero).any():
            outside[n] = (int((far & ~zero).sum()), float(np.abs(state[n] - p)[far & ~zero].max()))
    print(f"{kind}: masters outside {ENGINE_PARAM_ATOL}: {outside}; on coordinates whose first "
          f"gradient is within {SIGN_EPS} of zero: {near_zero}")
    assert sum(c for c, _ in outside.values()) <= FLIP_SHARE * counted, outside
    assert meta["onebit_frozen"] == frozen == (kind in ("adam", "lamb"))
    assert meta["table"]["grad-exchange"][0] == ("dense" if kind in ("adam", "lamb") else kind)


@pytest.mark.parametrize("kind", ["adam", "int8", "onebit"])
def test_compressed_steps_count_the_models_bytes(spawn, kind):
    """A compressed step moves ``step_comm_bytes``' int8 / onebit
    grad-exchange bytes (2 B a parameter and the scales), at least 4x below
    the dense exchange (gas 2: 8x); the warm steps of 1-bit Adam are dense."""
    meta, _ = _read(spawn, kind, state=False)
    n = meta["n_params"]
    model = step_comm_bytes(n, {"data": 2, "fsdp": 1}, stage=0, gas=2, strategy="onebit")
    dense = step_comm_bytes(n, {"data": 2, "fsdp": 1}, stage=0, gas=2, strategy="dense")
    pad = 2 * ((-n) % 2)
    frozen = meta["comm"][FREEZE:] if kind == "adam" else meta["comm"]
    for c in frozen:
        assert c["grad-exchange"] == model["grad-exchange"] + pad, c
        assert 4 * c["grad-exchange"] <= dense["grad-exchange"]
    if kind == "adam":
        for c in meta["comm"][:FREEZE]:
            assert c["grad-exchange"] == dense["grad-exchange"]


def test_group_exchanges_match_the_plain_rows(spawn):
    with np.load(spawn["tmp"] / "c.npz") as z:
        x, werr, serr = (torch.from_numpy(z[k]) for k in ("x", "werr", "serr"))
    with np.load(spawn["tmp"] / "compressed.npz") as z:
        got = {k: z[k] for k in z.files}
    out, w, e = compressed.compressed_allreduce_rows(x, werr, serr)
    np.testing.assert_allclose(got["onebit"], out[0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["werr"], w.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["serr"], e.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["int8"], collectives.quantized_allreduce_rows(x).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["dense"], x.mean(0).numpy(), rtol=0, atol=1e-6)
    assert int(got["onebit_bytes"]) == int(got["int8_bytes"]) == 2 * 1000 + 8 * 2
    # the variance-sharded layout: the same 1-bit exchange plus a 4 B a
    # parameter f32 all-gather of the updated masters (three times the wire)
    exchange, gather = (int(b) for b in got["vsharded_bytes"])
    assert exchange == 2 * 1000 + 8 * 2 and gather == 4 * 1000
    assert got["vsharded_p_full"].shape == (1000,) and np.isfinite(got["vsharded_p_full"]).all()


def test_checkpoint_in_the_compressed_phase_round_trips(spawn):
    ck, _ = _read(spawn, "ck")
    fresh, _ = _read(spawn, "fresh_frozen")
    assert fresh["onebit_frozen"] and fresh["global_steps"] == 7
    assert fresh["losses"] == ck["losses"][5:7]
    a = np.load(spawn["tmp"] / "ck.npz")
    b = np.load(spawn["tmp"] / "fresh_frozen.npz")
    assert set(a.files) == set(b.files)
    assert {"opt_state/m_signs", "opt_state/worker_error"} <= set(a.files)
    assert a["opt_state/worker_error"].shape[0] == 2
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_at_the_freeze_boundary_and_rollback(spawn):
    roll, _ = _read(spawn, "roll", state=False)
    fresh, _ = _read(spawn, "fresh_warm", state=False)
    # after the rollback the engine was warm at step 2; its next step froze
    # again, as the fresh engine's did
    assert roll["reload_phase"] == {"onebit_frozen": False, "global_steps": FREEZE}
    assert roll["onebit_frozen"] and fresh["onebit_frozen"]
    assert roll["losses"][3] == fresh["losses"][0]
    comm, _ = _read(spawn, "ck_onebit", state=False)
    again, _ = _read(spawn, "fresh_onebit", state=False)
    assert again["losses"][0] == comm["losses"][2]
