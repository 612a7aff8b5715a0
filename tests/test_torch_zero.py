"""ZeRO 0-3 across gloo ranks: the port's engine in real OS processes
(``deepspeed_tpu_torch/tools/zero_worker.py``, one spawn of every rank per
world size, every case of that size inside it) against the port at world
size 1 and the JAX engine on a host mesh of the same shape.

* GPT2_TINY (T 64) in f32 with AdamW, gas 2, clipping 1.0, 3 steps, at
  world 2 (``data 2``) and world 4 (``data 2 x fsdp 2`` and ``fsdp 4``),
  stages 0-3 (``stage3_param_persistence_threshold: 0``, so stage 3
  shards every leaf): losses within ``F32_LOSS_RTOL`` and masters within
  ``F32_PARAM_ATOL`` (``tests/test_torch_training.py``) of the port at
  world 1 on the same global batches, and of the JAX engine at one stage
  per mesh (stage 3 where fsdp > 1, stage 1 on ``data 2``; the stages
  share their math).
* The bytes the port's collectives count in each step equal, kind by
  kind, ``step_comm_bytes`` and the port's own ``update-all-gather``
  model, also with ``reduce_scatter: false`` and with cross-replica
  update sharding off.
* Two runs of a case give the same bits.
* A tiny BERT with LAMB at ``data 2 x fsdp 2``, stage 2, against the port
  at world 1 and the JAX engine, each rank's micro-batch a micro-step.
* Checkpoints: a world-4 tag resumes bit for bit at world 4, loads at
  world 2 with the saver's masters and moments, and a one-process tag
  loads at world 2 and a world-2 tag in one process.
* A SIGTERM on one rank: every rank saves and exits 43.

The children run with one thread and deterministic algorithms; they meet
through a file store, not a port.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.checkpointing import _state_tensors
from deepspeed_tpu_torch.runtime.zero.stages import port_step_comm_extras

from tests.test_torch_bert import _config as _lamb_config
from tests.test_torch_bert import synthetic_batch
from tests.test_torch_training import F32_LOSS_RTOL, F32_PARAM_ATOL
from tests.test_torch_training import _config as _adamw_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, BERT_T, STEPS, GAS, MB = 64, 64, 3, 2, 2
MESHES = {"d2": {"data": 2, "fsdp": 1}, "d2f2": {"data": 2, "fsdp": 2},
          "f4": {"data": 1, "fsdp": 4}}
JAX_STAGE = {"d2": 1, "d2f2": 3, "f4": 3}
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "grad-exchange")


# the zero_optimization knobs the engine reads, off their defaults
KNOBS = {"": {}, "nors": {"reduce_scatter": False},
         "nocross": {"cross_replica_weight_update": False}}


def _gpt2_config(stage, mesh, mb=MB, knob=""):
    """The one-device parity run's config (``tests/test_torch_training.py``:
    AdamW, gas 2, clipping 1.0, WarmupDecayLR) on a mesh."""
    return {**_adamw_config(False), "train_micro_batch_size_per_gpu": mb, "mesh": mesh,
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0,
                                  **KNOBS[knob]}}


def _bert_config(mesh, gas=GAS, stage=2):
    return {**_lamb_config(), "train_micro_batch_size_per_gpu": MB,
            "gradient_accumulation_steps": gas, "mesh": mesh,
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}


def _launch(world, cases, tmp, name=None, rc=0, extra=None):
    name = name or str(world)
    spec = {"device": "cpu", "init_method": f"file://{tmp}/store{name}", "out": str(tmp),
            "cases": cases, **(extra or {})}
    path = tmp / f"spec{name}.json"
    path.write_text(json.dumps(spec))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.zero_worker", str(path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == rc, f"rank {r} of {world} exited {p.returncode}:\n{out[-3000:]}"


def _gpt2_cases(name, mesh, bfile, knob="", stages=range(4)):
    suffix = f"_{knob}" if knob else ""
    return [{"name": f"{name}_s{s}{suffix}", "preset": "tiny", "model_cfg": {"n_positions": T},
             "init_seed": 3, "config": _gpt2_config(s, mesh, knob=knob), "batches": str(bfile),
             "steps": STEPS} for s in stages]


def _one_process(cfg_dict, model, batches, steps, load=None, save=None):
    """The port at world 1 on the global batches: the state after
    ``steps`` steps, by checkpoint name, and the losses."""
    torch.use_deterministic_algorithms(True)
    if model == "bert":
        cfg = dataclasses.replace(tbert.BERT_TINY)
        model_fn, init_fn, _ = tbert.make_model(cfg)
    else:
        cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=T)
        model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                             config=cfg_dict, device="cpu")
    if load is not None:
        eng.load_checkpoint(*load)
    losses = [float(eng.train_batch({k: v[s] for k, v in batches.items()})) for s in range(steps)]
    if save is not None:
        eng.save_checkpoint(*save)
    return losses, {n: t.detach().clone() for n, t in _state_tensors(eng).items()}


def _jax(model, mesh, stage, batches, gas=GAS, mode="flash"):
    """The JAX engine on a host mesh of ``mesh``'s shape (any of ``data``,
    ``fsdp``, ``seq``, ``model``) with the family's tensor-parallel specs:
    the losses and the final masters by checkpoint name."""
    sizes = {a: mesh.get(a, 1) for a in ("data", "fsdp", "seq", "model")}
    if model == "bert":
        cfg = jbert.BERT_TINY
        model_fn, init_fn, tp_fn = jbert.make_model(cfg)
        config = _bert_config(sizes, gas=gas)
    else:
        cfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=T, attention_mode=mode)
        model_fn, init_fn, tp_fn = jgpt2.make_model(cfg)
        config = _gpt2_config(stage, sizes)
    world = int(np.prod(list(sizes.values())))
    jmesh = make_mesh(MeshConfig(**sizes), devices=jax.devices()[:world])
    eng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                       config=config, mesh=jmesh, tp_spec_fn=tp_fn)
    losses = [float(eng.train_batch({k: v[s] for k, v in batches.items()}))
              for s in range(STEPS)]
    params = eng._unflatten_state_leaves(jax.tree.map(np.asarray, eng.state["params"]))
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            flat["params/" + "/".join(path)] = np.asarray(t)

    walk(params, ())
    return losses, flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1 in-process, then one spawn of 4 ranks and one of 2."""
    tmp = tmp_path_factory.mktemp("zero")
    # one fixed global batch fed every step, as tests/test_torch_training.py
    # feeds the one-device parity run, so the loss must fall
    rng = np.random.default_rng(0)
    ids = np.repeat(rng.integers(0, tgpt2.GPT2_TINY.vocab_size, (1, GAS * MB * 4, T),
                                 dtype=np.int32), STEPS, axis=0)
    np.savez(tmp / "g4.npz", input_ids=ids)
    np.savez(tmp / "g2.npz", input_ids=ids[:, :GAS * MB * 2])
    bert = [synthetic_batch(tbert.BERT_TINY.vocab_size, GAS * MB * 4, BERT_T, seed=11 + s)
            for s in range(STEPS)]
    bert = {k: np.stack([b[k] for b in bert]) for k in bert[0]}
    np.savez(tmp / "b4.npz", **bert)
    ck = str(tmp / "ckpt")
    # a one-process tag (stage 0, 2 steps) for world 2 to load
    one = _one_process(_gpt2_config(0, {"data": 1}, mb=MB * 2),
                       "gpt2", {"input_ids": ids[:, :GAS * MB * 2]}, 2, save=(ck, "w1"))
    w4 = (_gpt2_cases("d2f2", MESHES["d2f2"], tmp / "g4.npz")
          + _gpt2_cases("f4", MESHES["f4"], tmp / "g4.npz")
          + _gpt2_cases("d2f2", MESHES["d2f2"], tmp / "g4.npz", "nors", (2, 3))
          + _gpt2_cases("d2f2", MESHES["d2f2"], tmp / "g4.npz", "nocross", (1, 3))
          + [dict(_gpt2_cases("d2f2", MESHES["d2f2"], tmp / "g4.npz")[3], name="d2f2_s3_again"),
             {"name": "bert_d2f2_s2", "model": "bert", "preset": "tiny", "init_seed": 3,
              "config": _bert_config(MESHES["d2f2"]), "batches": str(tmp / "b4.npz"),
              "steps": STEPS},
             {"name": "bert_f4_s3", "model": "bert", "preset": "tiny", "init_seed": 3,
              "config": _bert_config(MESHES["f4"], stage=3), "batches": str(tmp / "b4.npz"),
              "steps": STEPS},
             dict(_gpt2_cases("ck", MESHES["d2f2"], tmp / "g4.npz")[2], name="ck_full",
                  save={"dir": ck, "tag": "w4", "after": 2}),
             dict(_gpt2_cases("ck", MESHES["d2f2"], tmp / "g4.npz")[2], name="ck_resume",
                  load={"dir": ck, "tag": "w4"}, first_batch=2, steps=1)])
    _launch(4, w4, tmp)
    w2 = _gpt2_cases("d2", MESHES["d2"], tmp / "g2.npz") + [
        dict(_gpt2_cases("x", MESHES["d2"], tmp / "g2.npz")[2], name="ck_load_w4",
             load={"dir": ck, "tag": "w4"}, steps=0),
        dict(_gpt2_cases("x", MESHES["d2"], tmp / "g2.npz")[0], name="ck_load_w1",
             load={"dir": ck, "tag": "w1"}, first_batch=2, steps=1,
             save={"dir": ck, "tag": "w2", "after": 1}),
    ]
    _launch(2, w2, tmp)
    # and back: the world-2 tag in one process
    back = _one_process(_gpt2_config(0, {"data": 1}, mb=MB * 2), "gpt2",
                        {"input_ids": ids[:, :GAS * MB * 2]}, 0, load=(ck, "w2"))
    return {"tmp": tmp, "ids": ids, "bert": bert, "ck": ck, "one": one, "back": back}


def _read(runs, name):
    tmp = runs["tmp"]
    with open(tmp / f"{name}.json") as f:
        meta = json.load(f)
    with np.load(tmp / f"{name}.npz") as z:
        state = {k: z[k] for k in z.files}
    return meta, state


_REFS = {}


def _reference(runs, dp, model="gpt2"):
    key = (dp, model)
    if key not in _REFS:
        if model == "bert":
            # each rank's micro-batch is a micro-step of its own (the
            # rows are in that order), so the loss is normalized per
            # (rank, micro-batch) as across ranks
            _REFS[key] = _one_process(_bert_config({"data": 1}, gas=GAS * dp), "bert",
                                      runs["bert"], STEPS)
        else:
            _REFS[key] = _one_process(_gpt2_config(0, {"data": 1}, mb=MB * dp), "gpt2",
                                      {"input_ids": runs["ids"][:, :GAS * MB * dp]}, STEPS)
    return _REFS[key]


def _assert_close(meta, state, losses, ref_state, prefix="params/"):
    np.testing.assert_allclose(meta["losses"], losses, rtol=F32_LOSS_RTOL)
    names = [n for n in ref_state if n.startswith(prefix)]
    assert names and all(n in state for n in names)
    for n in names:
        ref = ref_state[n]
        ref = ref.numpy() if isinstance(ref, torch.Tensor) else ref
        np.testing.assert_allclose(state[n], ref, atol=F32_PARAM_ATOL, rtol=0, err_msg=n)


CASES = [f"{m}_s{s}" for m in MESHES for s in range(4)] + [
    "d2f2_s2_nors", "d2f2_s3_nors", "d2f2_s1_nocross", "d2f2_s3_nocross"]


@pytest.mark.parametrize("case", CASES)
def test_stage_matches_the_port_at_world_1(runs, case):
    meta, state = _read(runs, case)
    dp = meta["mesh"]["data"] * meta["mesh"]["fsdp"]
    assert meta["world_size"] == dp and meta["backend"] == "gloo"
    losses, ref = _reference(runs, dp)
    _assert_close(meta, state, losses, ref)
    assert meta["losses"][-1] < meta["losses"][0]


@pytest.mark.parametrize("case", CASES)
def test_counted_bytes_equal_the_model(runs, case):
    """Every step's counted bytes, kind by kind: the JAX model's kinds
    (``step_comm_bytes``), the port's ``update-all-gather``, and 32 bytes
    of step scalars; nothing else."""
    meta, _ = _read(runs, case)
    stage = int(case.split("_")[1][1])
    extras = port_step_comm_extras(meta["n_params"], meta["mesh"], stage,
                                   cross_replica=not case.endswith("nocross"))
    fsdp_kind = "all-reduce" if case.endswith("nors") or stage < 2 else "reduce-scatter"
    assert meta["model"][fsdp_kind if meta["mesh"]["fsdp"] > 1 else "grad-exchange"] > 0
    for counted in meta["comm"]:
        for kind in KINDS:
            assert counted.get(kind, 0) == meta["model"][kind], (kind, counted, meta["model"])
        assert counted.get("update-all-gather", 0) == extras["update-all-gather"]
        assert counted.get("step-scalars") == 32
        assert set(counted) <= set(KINDS) | {"update-all-gather", "step-scalars"}
    assert meta["model"]["total"] == sum(meta["model"][k] for k in KINDS)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_matches_the_jax_engine_on_a_host_mesh(runs, mesh):
    stage = JAX_STAGE[mesh]
    dp = MESHES[mesh]["data"] * MESHES[mesh]["fsdp"]
    batches = {"input_ids": runs["ids"][:, :GAS * MB * dp]}
    losses, params = _jax("gpt2", MESHES[mesh], stage, batches)
    meta, state = _read(runs, f"{mesh}_s{stage}")
    _assert_close(meta, state, losses, params)


def test_two_runs_give_the_same_bits(runs):
    a_meta, a = _read(runs, "d2f2_s3")
    b_meta, b = _read(runs, "d2f2_s3_again")
    assert a_meta["losses"] == b_meta["losses"]
    assert set(a) == set(b) and all(np.array_equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("case", ["bert_d2f2_s2", "bert_f4_s3"])
def test_bert_lamb_across_ranks(runs, case):
    """BERT_TINY with LAMB at ``data 2 x fsdp 2``, stage 2 (and at ``fsdp
    4``, stage 3: the tied embedding gathered once a forward), against the
    port at world 1 and the JAX engine on one device, both taking each
    rank's micro-batch as a micro-step (gas 8).  Each rank normalizes its
    MLM loss by its own labelled positions, as a torch data-parallel rank
    does; the JAX engine on a 4-device mesh normalizes by the global
    batch's (ROADMAP C4).  LAMB's per-leaf norms sum over the ranks of
    each shard (``lamb-norms``)."""
    meta, state = _read(runs, case)
    losses, ref = _reference(runs, 4, "bert")
    _assert_close(meta, state, losses, ref)
    assert all(c.get("lamb-norms", 0) > 0 for c in meta["comm"])
    if "jax_bert" not in _REFS:
        _REFS["jax_bert"] = _jax("bert", {"data": 1, "fsdp": 1}, 2, runs["bert"], gas=GAS * 4)
    jlosses, jparams = _REFS["jax_bert"]
    _assert_close(meta, state, jlosses, jparams)


def test_world_4_tag_resumes_bit_for_bit(runs):
    full_meta, full = _read(runs, "ck_full")
    res_meta, res = _read(runs, "ck_resume")
    assert res_meta["losses"] == full_meta["losses"][2:]
    assert set(full) == set(res) and all(np.array_equal(full[n], res[n]) for n in full)


def _tag_state(runs, tag):
    return torch.load(os.path.join(runs["ck"], tag, "state", "state.pt"), weights_only=True)


@pytest.mark.parametrize("tag,case", [("w4", "ck_load_w4"), ("w1", None)],
                         ids=["world4_tag_at_world2", "one_process_tag_at_world2"])
def test_tag_loads_at_another_world_size(runs, tag, case):
    """Masters and moments bit for bit those of the tag, at world 2; a
    one-process tag's also after world 2 trained on from it (the saver's
    state at the load is the tag's)."""
    disk = _tag_state(runs, tag)
    if case is None:
        _, one_state = runs["one"]
        assert all(torch.equal(one_state[n], disk[n]) for n in one_state)
        meta, _ = _read(runs, "ck_load_w1")
        assert meta["world_size"] == 2 and len(meta["losses"]) == 1
        return
    _, state = _read(runs, case)
    names = [n for n in disk if n.startswith(("params/", "opt_state/"))]
    assert any(n.startswith("opt_state/exp_avg_sq/") for n in names)
    for n in names:
        assert np.array_equal(state[n], disk[n].numpy()), n


def test_world_2_tag_loads_in_one_process(runs):
    disk = _tag_state(runs, "w2")
    _, back = runs["back"]
    names = [n for n in disk if n.startswith(("params/", "opt_state/"))]
    assert all(torch.equal(back[n], disk[n]) for n in names)
    _, w2 = _read(runs, "ck_load_w1")
    for n in names:
        assert np.array_equal(w2[n], disk[n].numpy()), n


def test_a_preemption_on_one_rank_saves_and_exits_43_on_every_rank(tmp_path):
    """SIGTERM to rank 0 alone after step 1: the step scalars carry its
    flag, so both ranks take the emergency save at step 2's boundary and
    exit 43; the tag is committed and holds step 2."""
    ids = np.random.default_rng(1).integers(0, tgpt2.GPT2_TINY.vocab_size,
                                            (3, GAS * MB * 2, T), dtype=np.int32)
    np.savez(tmp_path / "g.npz", input_ids=ids)
    save_dir = tmp_path / "emergency"
    case = dict(_gpt2_cases("pre", MESHES["d2"], tmp_path / "g.npz")[1], name="pre",
                sigterm={"rank": 0, "after": 1})
    case["config"] = dict(case["config"], resilience={
        "watchdog": {"enabled": True, "save_dir": str(save_dir)}})
    _launch(2, [case], tmp_path, name="pre", rc=43)
    tags = [d for d in os.listdir(save_dir) if not d.startswith(("latest", "."))]
    assert tags == ["global_step2"], tags
    with open(save_dir / "global_step2" / "meta.json") as f:
        meta = json.load(f)
    assert meta["global_step"] == 2 and meta["world_size"] == 2
