"""The compositions of ZeRO, tensor and sequence parallelism with offload,
the reduced Adam state, MoQ, 1-bit optimizers and compressed exchanges, in
the port against the JAX engine, on the CPU.

Every rank case runs through ``tools/zero_worker.py``: one 2-rank spawn
and one 4-rank spawn for every case (gloo, f32, dropout off, GPT2_TINY at
T 64, gas 2, clipping 1.0), while the parent runs the JAX engine on the
CPU's virtual devices.

* ``offload_optimizer`` (``cpu``, one case ``nvme``) at ``{model: 2}``,
  ``{data: 2, model: 2}``, ``{seq: 2}`` and, on a 4-expert GPT2_TINY,
  ``{expert: 2}``: each ``model`` (``expert``) rank's host optimizer holds
  its block of every cut leaf.  The JAX engine trains ``{seq: 2}`` with
  offload but stops at a sharding mismatch under a ``model`` or ``expert``
  axis (ROADMAP C5), so those cases are held to the JAX offload engine on
  their data-parallel grid alone (the same global batch; tensor and expert
  parallelism move no value beyond f32 rounding).  A tag written at world
  1 restores at ``{model: 2}`` and trains on as the one-rank engine does.
* The 8-bit and bf16 Adam state and MoQ at ``{data: 2}`` stage 1 / 2 and
  ``{fsdp: 2}`` stage 3, rounding to nearest (the JAX engine's key dropped
  from its update): every block scale is the whole leaf's, gathered whole.
  With each rank on the one-rank run's rows and no clipping the 8-bit
  state is the one-rank engine's bit for bit; the cut step itself (two
  slices of a leaf stepped as two ranks, in chunks) is the whole leaf's bit
  for bit.
* ``OneBitAdam`` / ``OneBitLamb`` at ``{data: 2, fsdp: 2}`` stage 2 and
  ``{data: 2, model: 2}`` with ``freeze_step`` 2 of 5 steps.
* ``comm.strategy`` ``int8`` / ``onebit`` at ``{fsdp: 2}`` stage 3 and
  ``{data: 2, model: 2}``, ``int8`` at ``{data: 2, seq: 2}`` (the ``seq``
  ranks' rows summed first), the exchange's bytes against
  ``step_comm_bytes``' model of one ``model`` rank's elements.
* ``offload_param`` at ``{seq: 2}``, ``{expert: 2}``, ``{pipe: 2}`` and
  ``{fsdp: 2, seq: 2}``: the stream replicated over ``seq``, ``expert`` and
  ``pipe`` in both packages (a 4-layer GPT-2 of 256 tokens); PLD and MoQ
  under the stream left unread, as the JAX streaming engine leaves them.

Bounds: losses within ``LOSS_RTOL`` and masters within ``PARAM_ATOL``
(``tests/test_torch_offload_ranks.py``'s f32 bounds; a rounding tie of an
8-bit code or a MoQ step moves an element by one step, counted as a
flipped sign is); the 1-bit and
compressed cases with ``tests/test_torch_onebit.py``'s engine bounds
(``ENGINE_LOSS_RTOL``, ``ENGINE_PARAM_ATOL`` and the share of flipped
signs, ``FLIP_SHARE``); the reduced state's block scales within
``SCALE_RTOL`` of JAX's (``tests/test_torch_adam8bit.py``'s one rounding
of absmax / 255, times the f32 gradient sums' reordering across ranks,
``SCALE_REORDER``).  Under a ``model`` axis each ``model`` rank exchanges
the rows of its own blocks (ROADMAP C4): its sign and int8 chunk scales
are its block's, where JAX's are the whole row's, so past the first
compressed step those cases are held to ``BLOCK_ROW_RTOL`` in loss (the
warm steps and the first compressed step to ``ENGINE_LOSS_RTOL``).
A tag taken at each mesh restores at world 1 with the masters equal bit
for bit.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.ops.adam import fused_adam as jfused_adam
from deepspeed_tpu_torch.comm.strategy import step_comm_bytes
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.engine import tree_items

from tests.test_torch_zero import _launch

T = 64
LOSS_RTOL, PARAM_ATOL = 2e-5, 1e-5
ENGINE_LOSS_RTOL, ENGINE_PARAM_ATOL, FLIP_SHARE, SIGN_EPS = 2e-5, 2e-5, 1e-4, 1e-7
SCALE_RTOL, SCALE_REORDER = 1e-7, 100
BLOCK_ROW_RTOL = 1e-4
STEPS, FREEZE = 3, 2
ONEBIT_STEPS = 5


def _config(mesh, zero=None, optimizer=None, comm=None, extra=None):
    c = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
         "gradient_clipping": 1.0,
         "optimizer": optimizer or {"type": "AdamW", "params": {"lr": 1e-3,
                                                                "weight_decay": 0.01}},
         "scheduler": {"type": "WarmupDecayLR", "params": {
             "total_num_steps": 10, "warmup_num_steps": 2, "warmup_min_lr": 1e-4,
             "warmup_max_lr": 1e-3}},
         "zero_optimization": {"stage": 0, "stage3_param_persistence_threshold": 0,
                               **(zero or {})},
         "steps_per_print": 1000, **(extra or {})}
    if mesh is not None:
        c["mesh"] = mesh
    if comm is not None:
        c["comm"] = {"threshold_bytes": 0, "stochastic_rounding": False, **comm}
    return c


def _off(device="cpu", path=None):
    return {"offload_optimizer": {"device": device, **({"nvme_path": path} if path else {})}}


def _stream():
    return {"stage": 3, "offload_param": {"device": "cpu", "buffer_count": 1}}


def _adamw(precision):
    return {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                        "state_precision": precision}}


def _onebit(kind):
    return {"type": {"adam": "OneBitAdam", "lamb": "OneBitLamb"}[kind],
            "params": {"lr": 1e-3, "freeze_step": FREEZE, "weight_decay": 0.01}}


MOQ = {"quantize_training": {"enabled": True, "quantize_bits_start": 12,
                             "quantize_bits_target": 8, "quantize_schedule_offset": 1,
                             "quantize_groups": 4}}

# name -> (world, mesh, config kwargs, steps, the JAX engine's mesh)
CASES = {
    "off_m2": (2, {"model": 2}, dict(zero=_off()), STEPS, {"data": 1}),
    "off_m2_nvme": (2, {"model": 2}, dict(zero=_off("nvme", "@nvme")), STEPS, {"data": 1}),
    "off_s2": (2, {"seq": 2}, dict(zero=_off()), STEPS, {"seq": 2}),
    "off_d2m2": (4, {"data": 2, "model": 2}, dict(zero=_off()), STEPS, {"data": 2}),
    "q8_d2_s1": (2, {"data": 2}, dict(zero={"stage": 1}, optimizer=_adamw("8bit")), STEPS,
                 {"data": 2}),
    "q8_d2_s2": (2, {"data": 2}, dict(zero={"stage": 2}, optimizer=_adamw("8bit")), STEPS,
                 {"data": 2}),
    "q8_f2_s3": (2, {"fsdp": 2}, dict(zero={"stage": 3}, optimizer=_adamw("8bit")), STEPS,
                 {"fsdp": 2}),
    "bf16_d2_s2": (2, {"data": 2}, dict(zero={"stage": 2}, optimizer=_adamw("bf16")), STEPS,
                   {"data": 2}),
    "bf16_f2_s3": (2, {"fsdp": 2}, dict(zero={"stage": 3}, optimizer=_adamw("bf16")), STEPS,
                   {"fsdp": 2}),
    "moq_d2_s2": (2, {"data": 2}, dict(zero={"stage": 2}, extra=MOQ), STEPS, {"data": 2}),
    "moq_f2_s3": (2, {"fsdp": 2}, dict(zero={"stage": 3}, extra=MOQ), STEPS, {"fsdp": 2}),
    "int8_f2_s3": (2, {"fsdp": 2}, dict(zero={"stage": 3}, comm={"strategy": "int8"}), STEPS,
                   {"fsdp": 2}),
    "onebit_f2_s3": (2, {"fsdp": 2}, dict(zero={"stage": 3}, comm={"strategy": "onebit"}),
                     STEPS, {"fsdp": 2}),
    "ob_d2f2_s2": (4, {"data": 2, "fsdp": 2}, dict(zero={"stage": 2}, optimizer=_onebit("adam")),
                   ONEBIT_STEPS, {"data": 2, "fsdp": 2}),
    "obl_d2f2_s2": (4, {"data": 2, "fsdp": 2},
                    dict(zero={"stage": 2}, optimizer=_onebit("lamb")), ONEBIT_STEPS,
                    {"data": 2, "fsdp": 2}),
    "ob_d2m2": (4, {"data": 2, "model": 2}, dict(optimizer=_onebit("adam")), ONEBIT_STEPS,
                {"data": 2, "model": 2}),
    "obl_d2m2": (4, {"data": 2, "model": 2}, dict(optimizer=_onebit("lamb")), ONEBIT_STEPS,
                 {"data": 2, "model": 2}),
    "int8_d2m2": (4, {"data": 2, "model": 2}, dict(comm={"strategy": "int8"}), STEPS,
                  {"data": 2, "model": 2}),
    "onebit_d2m2": (4, {"data": 2, "model": 2}, dict(comm={"strategy": "onebit"}), STEPS,
                    {"data": 2, "model": 2}),
    "int8_d2s2": (4, {"data": 2, "seq": 2}, dict(comm={"strategy": "int8"}), STEPS,
                  {"data": 2, "seq": 2}),
    "off_e2": (2, {"expert": 2}, dict(zero=_off()), STEPS, {"data": 1}),
    "inf_s2": (2, {"seq": 2}, dict(zero=_stream()), STEPS, {"seq": 2}),
    "inf_e2": (2, {"expert": 2}, dict(zero=_stream()), STEPS, {"expert": 2}),
    "inf_p2": (2, {"pipe": 2}, dict(zero=_stream()), STEPS, {"pipe": 2}),
    "inf_f2s2": (4, {"fsdp": 2, "seq": 2}, dict(zero=_stream()), STEPS, {"fsdp": 2, "seq": 2}),
}
# a seq axis needs the ring (or Ulysses) attention in the port's in-memory
# engine; the stream replicates over it (both packages), on a 4-layer GPT-2
# of 256 tokens (tests/test_torch_offload_ranks.py's)
STREAM_CFG = {"n_layer": 4, "vocab_size": 256}
STREAMED = "inf_"
MOE_CFG = {"n_experts": 4}
MODEL_CFG = {"off_s2": {"attention_mode": "ring"}, "int8_d2s2": {"attention_mode": "ring"},
             "off_e2": MOE_CFG, **{n: STREAM_CFG for n in CASES if n.startswith(STREAMED)}}
JAX_CFG = {"off_e2": MOE_CFG, **{n: STREAM_CFG for n in CASES if n.startswith(STREAMED)}}
REDUCED = ("q8_", "bf16_")
# a rounding tie (an 8-bit code, a MoQ step) moves an element by one step:
# held as flipped signs are
QUANTIZED = ("moq_", "q8_", "bf16_")
# the 1-bit tag under a model axis is written mid-run: a fresh engine
# resumes from it, and its own tag at the end is the one restored at world 1
SAVE_AFTER = {"ob_d2m2": 4}
TAG_OF = {"ob_d2m2": "ob_d2m2_resume"}
EXPLICIT = ("ob_", "obl_", "int8_", "onebit_")
BLOCK_ROWS = ("ob_d2m2", "obl_d2m2", "int8_d2m2", "onebit_d2m2")


def _case_config(name, tmp):
    _, mesh, kw, _, _ = CASES[name]
    kw = dict(kw)
    zero = kw.get("zero")
    if zero and "offload_optimizer" in zero and zero["offload_optimizer"].get("nvme_path"):
        kw["zero"] = _off("nvme", str(tmp / f"nvme_{name}"))
    return _config(mesh, **kw)


def _batches(steps, rows, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, jgpt2.GPT2_TINY.vocab_size, (steps, rows, T), dtype=np.int32)


@pytest.fixture(scope="module")
def spawn(tmp_path_factory):
    """Both spawns, and a world-1 offload tag the 2-rank spawn restores at
    ``{model: 2}`` (written before it starts)."""
    tmp = tmp_path_factory.mktemp("compose")
    ids = _batches(ONEBIT_STEPS, 16)
    np.savez(tmp / "b.npz", input_ids=ids)
    np.savez(tmp / "bs.npz", input_ids=ids % STREAM_CFG["vocab_size"])
    np.savez(tmp / "same.npz", input_ids=_same_rows(ids[:STEPS, :4]))
    ck = tmp / "ck"
    w1 = _port(_config(None, zero=_off()))
    w1_losses = [float(w1.train_batch({"input_ids": ids[s][:4]})) for s in range(2)]
    w1.save_checkpoint(str(ck), tag="w1")
    w1_losses.append(float(w1.train_batch({"input_ids": ids[2][:4]})))
    w1_params = {k: t.detach().clone() for k, t in tree_items(w1.params)}

    def case(name, **kw):
        steps = CASES[name][3]
        return {"name": name, "preset": "tiny",
                "model_cfg": {"n_positions": T, **MODEL_CFG.get(name, {})}, "init_seed": 3,
                "config": _case_config(name, tmp),
                "batches": str(tmp / ("bs.npz" if name.startswith(STREAMED) else "b.npz")),
                "steps": steps,
                "save": {"dir": str(ck), "tag": name, "after": SAVE_AFTER.get(name, steps)},
                "nearest_rounding": name.startswith(REDUCED), **kw}

    two = [case(n) for n, c in CASES.items() if c[0] == 2]
    two.append({"name": "q8_same_rows", "preset": "tiny", "model_cfg": {"n_positions": T},
                "init_seed": 3, "config": _q8_same_rows_config({"data": 2}),
                "batches": str(tmp / "same.npz"), "steps": STEPS, "nearest_rounding": True})
    two.append({"name": "off_m2_from_w1", "preset": "tiny", "model_cfg": {"n_positions": T},
                "init_seed": 3, "config": _config({"model": 2}, zero=_off()),
                "batches": str(tmp / "b.npz"), "steps": 1, "first_batch": 2,
                "load": {"dir": str(ck), "tag": "w1"}})
    four = [case(n) for n, c in CASES.items() if c[0] == 4]
    resume = case("ob_d2m2", load={"dir": str(ck), "tag": "ob_d2m2"}, first_batch=4, steps=1)
    four.append({**resume, "name": "ob_d2m2_resume",
                 "save": {"dir": str(ck), "tag": "ob_d2m2_resume", "after": 1}})
    _launch(2, two, tmp, name="2")
    _launch(4, four, tmp, name="4")
    return {"tmp": tmp, "ids": ids, "ck": ck, "w1_losses": w1_losses, "w1_params": w1_params}


def _same_rows(ids, mb=2, gas=2, dp=2):
    """Global batches whose every data-parallel rank's rows are ``ids``'
    (one rank's ``gas`` micro-batches of ``mb``, in the worker's row
    order)."""
    out = np.empty((ids.shape[0], gas * mb * dp, ids.shape[-1]), ids.dtype)
    for i in range(gas):
        for r in range(dp):
            out[:, (i * dp + r) * mb:(i * dp + r + 1) * mb] = ids[:, i * mb:(i + 1) * mb]
    return out


def _q8_same_rows_config(mesh):
    return _config(mesh, zero={"stage": 2}, optimizer=_adamw("8bit"),
                   extra={"gradient_clipping": 0.0})


def _read(spawn, name):
    with open(spawn["tmp"] / f"{name}.json") as f:
        meta = json.load(f)
    with np.load(spawn["tmp"] / f"{name}.npz") as z:
        return meta, {k: z[k] for k in z.files}


def _port(config, name=None):
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T, **MODEL_CFG.get(name, {}))
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                             config=config, device="cpu")
    return eng


def _flat(tree, prefix):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out[prefix + "/".join(path)] = np.asarray(t, np.float32)

    walk(tree, ())
    return out


def _jax_run(name, ids, monkeypatch):
    """The JAX engine at the case's reference mesh on the same global
    batches: losses, masters by checkpoint name, the 8-bit block scales
    by leaf, and the first step's gradient by checkpoint name."""
    from deepspeed_tpu.runtime.fp16.onebit.adam import unpack_flat

    _, mesh_port, _, steps, mesh = CASES[name]
    if name.startswith(REDUCED):
        # round to nearest: the update without its stochastic-rounding key
        orig = jfused_adam.FusedAdam._update_8bit
        monkeypatch.setattr(jfused_adam.FusedAdam, "_update_8bit",
                            lambda self, g, st, p, lr, rng, skip=None: orig(
                                self, g, st, p, lr, None, skip))
    # the JAX engine's flash attention under GSPMD is the ring's math
    cfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=T, **JAX_CFG.get(name, {}))
    if name.startswith(STREAMED):
        ids = ids % STREAM_CFG["vocab_size"]
    model_fn, init_fn, tp_fn = jgpt2.make_model(cfg)
    world = int(np.prod(list(mesh.values())))
    jmesh = make_mesh(MeshConfig(**mesh), devices=jax.devices()[:world])
    config = _config(mesh, **{k: v for k, v in CASES[name][2].items()})
    if "offload_optimizer" in config["zero_optimization"]:
        config["zero_optimization"] = {**config["zero_optimization"], **_off()}
    eng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                       config=config, mesh=jmesh, tp_spec_fn=tp_fn)
    rows = 4 * mesh.get("data", 1) * mesh.get("fsdp", 1)
    losses = [float(eng.train_batch({"input_ids": ids[s][:rows]})) for s in range(steps)]
    if getattr(eng, "_host_opt", None) is not None:
        params = eng._host_opt.masters_tree() if hasattr(eng._host_opt, "masters_tree") else None
        if params is None:
            flat = np.concatenate([o.masters[0] for o in eng._host_opts])
            params = unpack_flat(flat, jax.tree.map(np.asarray, eng.state["params"]))
    else:
        params = eng._unflatten_state_leaves(jax.tree.map(np.asarray, eng.state["params"]))
    out = {"losses": losses, "params": _flat(params, "params/"),
           "frozen": bool(getattr(eng, "_onebit_frozen", False))}
    state = getattr(eng, "state", None)
    opt = state.get("opt_state") if isinstance(state, dict) else None
    if opt is not None and hasattr(opt, "vs"):
        out["vs"] = _flat(eng._unflatten_state_leaves(jax.tree.map(np.asarray, opt.vs)),
                          "opt_state/vs/")
    p0 = init_fn(seed=3)
    out["g0"] = _flat(jax.grad(lambda p: model_fn(p, {"input_ids": ids[0][:rows]}, None))(p0),
                      "params/")
    return out


def _held_to(meta, state, ref, loss_rtol, atol, flips):
    np.testing.assert_allclose(meta["losses"], ref["losses"], rtol=loss_rtol)
    outside, counted = {}, 0
    for n, p in ref["params"].items():
        assert np.all(np.isfinite(state[n])), n
        far = np.abs(state[n] - p) > atol
        zero = np.abs(ref["g0"][n]) <= SIGN_EPS
        counted += int((~zero).sum())
        if (far & ~zero).any():
            outside[n] = (int((far & ~zero).sum()), float(np.abs(state[n] - p)[far].max()))
    allowed = FLIP_SHARE * counted if flips else 0
    assert sum(c for c, _ in outside.values()) <= allowed, outside


@pytest.mark.parametrize("name", [n for n in CASES if not n.startswith(BLOCK_ROWS)])
def test_composition_matches_the_jax_engine(spawn, name, monkeypatch):
    meta, state = _read(spawn, name)
    ref = _jax_run(name, spawn["ids"], monkeypatch)
    print(f"{name}: port {meta['losses']} jax {ref['losses']}")
    assert meta["world_size"] == CASES[name][0] and meta["backend"] == "gloo"
    explicit = name.startswith(EXPLICIT)
    _held_to(meta, state, ref, ENGINE_LOSS_RTOL if explicit else LOSS_RTOL,
             ENGINE_PARAM_ATOL if explicit else PARAM_ATOL,
             flips=explicit or name.startswith(QUANTIZED))
    assert meta["onebit_frozen"] == ref["frozen"]
    if "vs" in ref:
        # every block scale is the whole leaf's (whole on every rank)
        for n, want in ref["vs"].items():
            got = state[n]
            assert got.shape == want.shape, n
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL * SCALE_REORDER, atol=0,
                                       err_msg=n)
    # every rank holding the same block of a leaf holds the same bits
    assert all(meta["replicas_equal"].values()), meta["replicas_equal"]


@pytest.mark.parametrize("name", BLOCK_ROWS)
def test_block_rows_under_a_model_axis(spawn, name, monkeypatch):
    """Each ``model`` rank's exchange runs on the rows of its own blocks:
    the steps before the first compressed update equal JAX's within the
    engine bound, the rest within ``BLOCK_ROW_RTOL`` (the chunk scales are
    the block's); the exchange moves one model rank's elements."""
    meta, state = _read(spawn, name)
    ref = _jax_run(name, spawn["ids"], monkeypatch)
    print(f"{name}: port {meta['losses']} jax {ref['losses']}")
    exact = FREEZE + 1 if name.startswith(("ob_", "obl_")) else 1
    np.testing.assert_allclose(meta["losses"][:exact], ref["losses"][:exact],
                               rtol=ENGINE_LOSS_RTOL)
    np.testing.assert_allclose(meta["losses"], ref["losses"], rtol=BLOCK_ROW_RTOL)
    assert meta["onebit_frozen"] == ref["frozen"]
    assert all(np.isfinite(v).all() for v in state.values())
    # the replicated leaves take model rank 0's exchange: equal bits
    assert all(meta["replicas_equal"].values()), meta["replicas_equal"]


def test_frozen_tag_under_a_model_axis_resumes_bit_for_bit(spawn):
    """The compressed phase's state under ``{data: 2, model: 2}`` (each
    model rank's rows, all of one length) saved after step 4 and restored
    by a fresh engine: step 5 and the state after it equal the
    uninterrupted run's bit for bit."""
    meta, state = _read(spawn, "ob_d2m2")
    again, state2 = _read(spawn, "ob_d2m2_resume")
    assert again["onebit_frozen"] and again["global_steps"] == 5
    assert again["losses"] == meta["losses"][4:]
    assert set(state) == set(state2)
    assert state["opt_state/m_signs"].shape[0] == 2  # one row set a model rank
    for k in state:
        np.testing.assert_array_equal(state[k], state2[k], err_msg=k)


@pytest.mark.parametrize("name", ["int8_f2_s3", "onebit_f2_s3", "int8_d2m2", "onebit_d2m2",
                                  "int8_d2s2", "ob_d2f2_s2", "ob_d2m2"])
def test_compressed_exchange_bytes_equal_the_model(spawn, name):
    """A compressed step's ``grad-exchange`` bytes equal
    ``step_comm_bytes``' onebit / int8 model over one ``model`` rank's
    elements (padded to the grid), fewer than the dense exchange's;
    stage 3 gathers as the model counts and reduces no gradient."""
    meta, _ = _read(spawn, name)
    n, sizes = meta["n_params"], meta["mesh"]
    dp = sizes["data"] * sizes["fsdp"]
    stage = CASES[name][2].get("zero", {}).get("stage", 0)
    grid = {"data": sizes["data"], "fsdp": sizes["fsdp"]}
    model = step_comm_bytes(n, grid, stage=stage, gas=2, strategy="onebit")
    dense = step_comm_bytes(n, grid, stage=stage, gas=2, strategy="dense")
    dense_grad = sum(dense[k] for k in ("grad-exchange", "reduce-scatter", "all-reduce"))
    pad = 2 * ((-n) % dp)
    steps = meta["comm"][FREEZE:] if name.startswith("ob_") else meta["comm"]
    for c in steps:
        assert c["grad-exchange"] == model["grad-exchange"] + pad, (c, model)
        assert c["grad-exchange"] < dense_grad
        assert "reduce-scatter" not in c
        if stage == 3:
            assert c["all-gather"] == meta["model"]["all-gather"], (c, meta["model"])


@pytest.mark.parametrize("name", list(CASES))
def test_tag_restores_at_world_1_bit_for_bit(spawn, name):
    """The tag written at the case's mesh is in the natural layout: the
    one-rank engine of the same configuration restores its masters bit
    for bit (a 1-bit frozen or onebit-residual tag without its optimizer
    state: its layout is the exchange grid's)."""
    _, state = _read(spawn, TAG_OF.get(name, name))
    cfg = _case_config(name, spawn["tmp"])
    cfg.pop("mesh")
    eng = _port(cfg, name)
    eng.load_checkpoint(str(spawn["ck"]), tag=TAG_OF.get(name, name),
                        load_optimizer_states=not name.startswith(EXPLICIT))
    for k, t in tree_items(eng.params):
        np.testing.assert_array_equal(t.detach().float().numpy(), state[f"params/{k}"],
                                      err_msg=k)


def test_world_1_offload_tag_trains_on_at_model_2(spawn):
    """A one-rank offload tag restored at ``{model: 2}`` (each rank cutting
    its blocks of the masters and moments) takes the next step as the
    one-rank engine does."""
    meta, state = _read(spawn, "off_m2_from_w1")
    np.testing.assert_allclose(meta["losses"], spawn["w1_losses"][2:], rtol=LOSS_RTOL)
    for k, t in spawn["w1_params"].items():
        np.testing.assert_allclose(state[f"params/{k}"], t.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_offload_under_model_holds_a_block_a_rank(spawn):
    """Under ``{model: 2}`` each rank's host optimizer holds its block of
    every cut leaf and the replicated leaves whole (fewer master bytes
    than one rank's, the same on both); under ``{data: 2, model: 2}`` the
    same blocks cut in two flat slices."""
    whole = 4 * sum(int(t.numel()) for t in spawn["w1_params"].values())
    m2, _ = _read(spawn, "off_m2")
    d2m2, _ = _read(spawn, "off_d2m2")
    per = [h["masters"] for h in m2["host_bytes_by_rank"]]
    assert len(set(per)) == 1 and whole // 2 < per[0] < whole, (per, whole)
    block = per[0] // 4
    assert [h["masters"] for h in d2m2["host_bytes_by_rank"]] == [4 * (-(-block // 2))] * 4


def _two_ranks(fn):
    """``fn(r, reduce_max)`` on two threads standing for two ranks, each
    ``reduce_max`` the elementwise max of both ranks' tensors (their
    all-reduce)."""
    import threading

    barrier, box, errors = threading.Barrier(2), [None, None], []

    def reduce_max(r):
        def f(t):
            box[r] = t
            barrier.wait()
            out = torch.maximum(box[0], box[1])
            barrier.wait()
            return out
        return f

    def run(r):
        try:
            fn(r, reduce_max(r))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


@pytest.mark.parametrize("cut", ["rows", "columns", "head_grouped", "flat"])
def test_cut_8bit_blocks_equal_the_whole_leafs(cut, monkeypatch):
    """The 8-bit state on a leaf cut in two, each slice stepped as its rank
    steps it (``step_reduced_`` with a :class:`CutBlocks`, in chunks of a
    few rows, the partial absmax maxed over the two as the ranks'
    all-reduce does): over three steps the parameters, m, the codes and
    the block scales equal the whole leaf's bit for bit.  Slices hold
    under 16,384 elements, where a slice alone would take the f32
    passthrough; ``flat``: a zero-padded flat leaf of 16,401 elements
    (blocks of 231) cut mid-block."""
    from deepspeed_tpu_torch.ops.adam import fused_adam as fa
    from deepspeed_tpu_torch.runtime.zero.partition import _group_parts

    monkeypatch.setattr(fa, "REDUCED_CHUNK", 2048)
    opt = fa.FusedAdam(lr=1e-2, weight_decay=0.01, state_precision="8bit")
    shape = (16401,) if cut == "flat" else (32, 768)
    n = int(np.prod(shape))
    b = opt._v_blocks(n)
    assert b == (231 if cut == "flat" else 256) and n // 2 < 16384
    rng = np.random.default_rng(7)
    p0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    grads = [torch.from_numpy((rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, -1, shape))
                              .astype(np.float32)) for _ in range(3)]
    whole = p0.clone()
    state = opt.init([whole])
    for g in grads:
        opt.step_reduced_([g], state, [whole])
    if cut == "flat":  # padded to two slices of 8,201, the last element padding
        pad = lambda t: torch.cat([t, t.new_zeros(1)])  # noqa: E731
        cols, half = torch.arange(n + 1), (n + 1) // 2
        parts = [cols[:half], cols[half:]]
        take = lambda t, r: pad(t)[parts[r]]  # noqa: E731
        index = [[i] for i in parts]
    else:
        rows, cols = torch.arange(32) * 768, torch.arange(768)
        if cut == "head_grouped":  # the model axis' [q_r | k_r | v_r] blocks
            cols = _group_parts(cols, 3, 2)
        if cut == "rows":
            index = [[rows[:16], cols], [rows[16:], cols]]
            take = lambda t, r: t[16 * r:16 * (r + 1)]  # noqa: E731
        else:
            index = [[rows, cols[:384]], [rows, cols[384:]]]
            take = lambda t, r: t[:, cols[384 * r:384 * (r + 1)]]  # noqa: E731
    got = [None, None]

    def rank(r, reduce_max):
        p = take(p0, r).contiguous()
        st = opt.init([p], whole=[n])
        cuts = [fa.CutBlocks(index=index[r], n=n, block=b, reduce_max=reduce_max)]
        for g in grads:
            opt.step_reduced_([take(g, r).contiguous()], st, [p], cuts=cuts)
        got[r] = (p, st)

    _two_ranks(rank)
    for r in range(2):
        p, st = got[r]
        assert torch.equal(p, take(whole, r))
        assert torch.equal(st.exp_avg[0], take(state.exp_avg[0], r))
        assert torch.equal(st.vq[0], take(state.vq[0], r))
        assert torch.equal(st.vs[0], state.vs[0])


@pytest.mark.parametrize("mesh,stage", [({"data": 2}, 2), ({"fsdp": 2}, 3),
                                        ({"data": 2, "model": 2}, 1)])
def test_natural_index_places_every_slice(mesh, stage):
    """``ZeroLayout.natural_index`` gives, on every rank, each element's
    flat index in the natural leaf as ``from_natural`` of ``arange`` does
    (flat leaves' padding at the leaf's size or past it, the fused
    ``qkv`` head-grouped under ``model``), for every leaf of GPT2_TINY."""
    from deepspeed_tpu_torch.comm.mesh import Mesh
    from deepspeed_tpu_torch.config.config import ZeroConfig
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroLayout
    from deepspeed_tpu_torch.runtime.zero.stages import ZeroShardingRules

    items = tree_items(tgpt2.init_params(dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T),
                                         seed=0))
    shapes, paths = [tuple(t.shape) for _, t in items], [k for k, _ in items]
    world = int(np.prod(list(mesh.values())))
    seen = 0
    for r in range(world):
        m = Mesh(mesh, rank=r)
        zc = ZeroConfig.from_dict({"stage": stage, "stage3_param_persistence_threshold": 0})
        rules = ZeroShardingRules(zc, fsdp_size=m.sizes["fsdp"], data_size=m.sizes["data"],
                                  tp_spec_fn=tgpt2.tp_spec_fn if "model" in mesh else None)
        layout = ZeroLayout(m, rules, shapes, paths)
        for i, leaf in enumerate(layout.leaves):
            n = int(np.prod(leaf.shape))
            want = layout.from_natural(i, torch.arange(n).reshape(leaf.shape), leaf.opt_spec)
            index = layout.natural_index(i, leaf.opt_spec)
            got = index[0]
            for t in index[1:]:
                got = got[..., None] + t
            if leaf.flat is not None:  # to_state pads with zeros
                got = torch.where(got < n, got, 0)
            assert torch.equal(got, want), (r, leaf.path)
            seen += layout.sharded(leaf.opt_spec) or leaf.flat is not None
    assert seen


def test_cut_8bit_state_is_one_ranks_bits_on_the_same_rows(spawn):
    """``{data: 2}`` stage 2 with the 8-bit state, each rank on the one-rank
    run's rows, no clipping, rounding to nearest: the losses and the whole
    state (masters, m, codes, block scales) after three steps are the
    one-rank engine's bits (both on one thread: the same sums in the same
    order).  The cut blocks' scales are the whole leaf's; a scale taken
    over one rank's slice of a block would change its codes."""
    from deepspeed_tpu_torch.runtime.checkpointing import _state_tensors

    meta, state = _read(spawn, "q8_same_rows")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = _port(_q8_same_rows_config(None))
        eng._rounding_generator = lambda: None
        losses = [float(eng.train_batch({"input_ids": spawn["ids"][s][:4]}))
                  for s in range(STEPS)]
        want = {n: t.detach().float().numpy() for n, t in _state_tensors(eng).items()
                if n.startswith(("params/", "opt_state/"))}
    finally:
        torch.set_num_threads(threads)
    assert meta["losses"] == losses
    assert any(n.startswith("opt_state/vs/") and v.size > 1 for n, v in want.items())
    for n, v in want.items():
        np.testing.assert_array_equal(state[n], v, err_msg=n)


def test_stream_leaves_pld_and_moq_unread(monkeypatch):
    """``progressive_layer_drop`` and ``quantize_training`` under
    ``offload_param``: the JAX streaming engine never reads either block,
    so the port's streams as without them (bit for bit), with a warning
    naming them."""
    from deepspeed_tpu_torch.runtime.zero import param_offload
    from tests.test_torch_param_offload import _batches as stream_batches
    from tests.test_torch_param_offload import _config as stream_config
    from tests.test_torch_param_offload import _port as stream_port
    from tests.test_torch_param_offload import _stream

    plain = stream_port(stream_config(_stream()))
    seen = []
    monkeypatch.setattr(param_offload.logger, "warning", lambda msg, *a, **k: seen.append(msg))
    extras = {**stream_config(_stream()), **MOQ,
              "progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.5}}
    eng = stream_port(extras)
    assert isinstance(eng, param_offload.ZeroInfinityEngine)
    assert any("quantize_training and progressive_layer_drop" in m and "unread" in m
               for m in seen), seen
    for b in stream_batches(3):
        assert float(plain.train_batch(b)) == float(eng.train_batch(b))
    for (k, a), (_, c) in zip(tree_items(plain.params), tree_items(eng.params)):
        assert torch.equal(a, c), k
