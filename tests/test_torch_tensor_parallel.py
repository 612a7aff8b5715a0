"""Tensor parallelism over ``model`` across gloo ranks: the port's engine in
real OS processes (``deepspeed_tpu_torch/tools/zero_worker.py``, one spawn
of every rank per world size, every case of that size inside it) against
the port at world size 1 and the JAX engine on a host mesh of the same
shape.

* GPT2_TINY (T 64) in f32 with AdamW, gas 2, clipping 1.0, 3 steps
  (``tests/test_torch_zero.py``'s parity run): ``model 2`` at ZeRO 0-3,
  ``model 4`` at stage 0, ``model 2 x data 2`` at stages 1 and 2,
  ``model 2 x fsdp 2`` at stage 3.  Losses within ``F32_LOSS_RTOL`` and
  masters within ``F32_PARAM_ATOL`` (``tests/test_torch_training.py``) of
  the port at world 1 on the same global batches, and of the JAX engine
  on a host mesh with the ``gpt2`` tensor-parallel specs.
* BERT_TINY with LAMB at ``model 2`` (stage 2) against the same two
  references: ``mlm_bias``, replicated but added a vocabulary block per
  rank, stays equal on both ranks; with dropout 0.1 / 0.1 its bytes and
  replicas hold too.
* On every rank holding the same block of a leaf the master is the same
  bits after the steps: every replicated leaf on every ``model`` rank.
* The bytes counted in each step equal, kind by kind, ``step_comm_bytes``,
  ``port_step_comm_extras`` and ``port_parallel_comm_model``
  (``tp-all-reduce``), with 32 bytes of step scalars.
* The head-grouped ``qkv`` layout: a rank's block is ``[q_r | k_r |
  v_r]``, and ``natural`` undoes the permutation.
* Checkpoints: a tag saved at ``model 2 x seq 2`` loads at ``model 4`` and
  at world 1 with the saver's masters and moments, and a world-1 tag at
  ``model 2 x seq 2``.
* The refusals, with the JAX package's wording: GPT-2's vocabulary of
  50257 at ``model 2``; and the port's own: heads ``model`` does not
  divide, a ``model`` axis without tensor-parallel specs.

The children run with one thread and deterministic algorithms; they meet
through a file store, not a port.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu_torch.comm.mesh import Mesh
from deepspeed_tpu_torch.config.config import DeepSpeedConfig
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.zero.partition import ZeroLayout
from deepspeed_tpu_torch.runtime.zero.stages import ZeroShardingRules, port_step_comm_extras

from tests.test_torch_bert import synthetic_batch
from tests.test_torch_zero import (
    BERT_T,
    GAS,
    KINDS,
    MB,
    STEPS,
    T,
    _assert_close,
    _bert_config,
    _gpt2_config,
    _jax,
    _launch,
    _one_process,
    _read,
)

# the counted kinds beside ZeRO's: the port's extras and the activations'
EXTRAS = ("update-all-gather", "seq-grad-exchange")
PARALLEL = ("tp-all-reduce", "seq-p2p", "seq-all-to-all", "seq-loss")

GPT2_MESHES = {
    "m2": {"data": 1, "model": 2},
    "m4": {"data": 1, "model": 4},
    "m2d2": {"data": 2, "model": 2},
    "m2f2": {"data": 1, "fsdp": 2, "model": 2},
}
GPT2_CASES = ["m2_s0", "m2_s1", "m2_s2", "m2_s3", "m4_s0", "m2d2_s1", "m2d2_s2", "m2f2_s3"]
# the JAX engine, once per mesh, at the stage whose sharding is the mesh's
JAX_CASES = {"m2": "m2_s0", "m4": "m4_s0", "m2d2": "m2d2_s2", "m2f2": "m2f2_s3"}
CK_MESH = {"data": 1, "seq": 2, "model": 2}


def gpt2_case(name, mesh, stage, bfile, mode="flash", model_cfg=None, **kw):
    return {"name": name, "preset": "tiny", "init_seed": 3,
            "model_cfg": {"n_positions": T, "attention_mode": mode, **(model_cfg or {})},
            "config": _gpt2_config(stage, mesh), "batches": str(bfile), "steps": STEPS, **kw}


def dp_of(mesh):
    return mesh.get("data", 1) * mesh.get("fsdp", 1)


def assert_bytes_equal_the_models(meta):
    """Every step's counted bytes, kind by kind, equal the models: the JAX
    package's kinds, the port's extras, the activations' collectives, and
    32 bytes of step scalars; nothing else."""
    for counted in meta["comm"]:
        for kind in KINDS:
            assert counted.get(kind, 0) == meta["model"][kind], (kind, counted, meta["model"])
        for kind in EXTRAS:
            assert counted.get(kind, 0) == meta["extras"][kind], (kind, counted, meta["extras"])
        for kind in PARALLEL:
            assert counted.get(kind, 0) == meta["parallel"][kind], (kind, counted,
                                                                    meta["parallel"])
        assert counted.get("step-scalars") == 32
        known = set(KINDS) | set(EXTRAS) | set(PARALLEL) | {"step-scalars", "lamb-norms"}
        assert set(counted) <= known, counted


def _tag_state(ck, tag):
    return torch.load(os.path.join(ck, tag, "state", "state.pt"), weights_only=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """World 1 in-process (a tag to load), then one spawn of 4 ranks and
    one of 2."""
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    ids = np.repeat(rng.integers(0, tgpt2.GPT2_TINY.vocab_size, (1, GAS * MB * 2, T),
                                 dtype=np.int32), STEPS, axis=0)
    np.savez(tmp / "g2.npz", input_ids=ids)
    np.savez(tmp / "g1.npz", input_ids=ids[:, :GAS * MB])
    bert = [synthetic_batch(tbert.BERT_TINY.vocab_size, GAS * MB, BERT_T, seed=11 + s)
            for s in range(STEPS)]
    bert = {k: np.stack([b[k] for b in bert]) for k in bert[0]}
    np.savez(tmp / "b1.npz", **bert)
    ck = str(tmp / "ckpt")
    _one_process(_gpt2_config(0, {"data": 1}), "gpt2", {"input_ids": ids[:, :GAS * MB]}, 1,
                 save=(ck, "w1"))
    w4 = [gpt2_case(c, GPT2_MESHES[c.split("_")[0]], int(c[-1]),
                    tmp / ("g2.npz" if dp_of(GPT2_MESHES[c.split("_")[0]]) == 2 else "g1.npz"))
          for c in GPT2_CASES if c.split("_")[0] != "m2"]
    w4 += [gpt2_case("ck_save", CK_MESH, 1, tmp / "g1.npz", "ring",
                     save={"dir": ck, "tag": "tp", "after": 2}, steps=2),
           gpt2_case("ck_m4_load_tp", GPT2_MESHES["m4"], 0, tmp / "g1.npz",
                     load={"dir": ck, "tag": "tp"}, steps=0),
           gpt2_case("ck_load_w1", CK_MESH, 1, tmp / "g1.npz", "ring",
                     load={"dir": ck, "tag": "w1"}, steps=0)]
    _launch(4, w4, tmp)
    w2 = [gpt2_case(c, GPT2_MESHES["m2"], int(c[-1]), tmp / "g1.npz")
          for c in GPT2_CASES if c.startswith("m2_")]
    w2.append({"name": "bert_m2", "model": "bert", "preset": "tiny", "init_seed": 3,
               "config": _bert_config(GPT2_MESHES["m2"]), "batches": str(tmp / "b1.npz"),
               "steps": STEPS})
    w2.append(dict(w2[-1], name="bert_m2_dropout", steps=2, model_cfg={
        "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}))
    _launch(2, w2, tmp)
    back = _one_process(_gpt2_config(0, {"data": 1}), "gpt2", {"input_ids": ids[:, :GAS * MB]},
                        0, load=(ck, "tp"))
    return {"tmp": tmp, "ids": ids, "bert": bert, "ck": ck, "back": back}


_REFS = {}


def _reference(runs, dp, model="gpt2"):
    key = (dp, model)
    if key not in _REFS:
        if model == "bert":
            _REFS[key] = _one_process(_bert_config({"data": 1}), "bert", runs["bert"], STEPS)
        else:
            _REFS[key] = _one_process(_gpt2_config(0, {"data": 1}, mb=MB * dp), "gpt2",
                                      {"input_ids": runs["ids"][:, :GAS * MB * dp]}, STEPS)
    return _REFS[key]


@pytest.mark.parametrize("case", GPT2_CASES)
def test_gpt2_matches_the_port_at_world_1(runs, case):
    meta, state = _read(runs, case)
    mesh = GPT2_MESHES[case.split("_")[0]]
    assert meta["world_size"] == dp_of(mesh) * mesh["model"] and meta["backend"] == "gloo"
    losses, ref = _reference(runs, dp_of(mesh))
    _assert_close(meta, state, losses, ref)
    assert meta["losses"][-1] < meta["losses"][0]


@pytest.mark.parametrize("case", GPT2_CASES + ["bert_m2", "bert_m2_dropout"])
def test_counted_bytes_equal_the_models(runs, case):
    """Also with BERT's dropout: the blocks' recompute then runs the MLP's
    all-reduce again (its dropout mask is kept after it)."""
    meta, _ = _read(runs, case)
    assert meta["parallel"]["tp-all-reduce"] > 0
    stage = 2 if case.startswith("bert") else int(case[-1])
    assert meta["extras"] == port_step_comm_extras(meta["n_params"], meta["mesh"], stage,
                                                   gas=GAS)
    assert_bytes_equal_the_models(meta)


@pytest.mark.parametrize("case", GPT2_CASES + ["bert_m2", "bert_m2_dropout", "ck_save"])
def test_replicated_leaves_are_equal_on_every_tp_rank(runs, case):
    """Under dropout too: the hidden masks of a replicated activation are
    the same on every ``model`` rank (each rank's heads draw their own
    attention masks)."""
    meta, _ = _read(runs, case)
    assert meta["replicas_equal"] and all(meta["replicas_equal"].values()), meta["replicas_equal"]
    assert all(np.isfinite(meta["losses"]))


@pytest.mark.parametrize("mesh", list(JAX_CASES))
def test_gpt2_matches_the_jax_engine_on_a_host_mesh(runs, mesh):
    case = JAX_CASES[mesh]
    dp = dp_of(GPT2_MESHES[mesh])
    losses, params = _jax("gpt2", GPT2_MESHES[mesh], int(case[-1]),
                             {"input_ids": runs["ids"][:, :GAS * MB * dp]})
    meta, state = _read(runs, case)
    _assert_close(meta, state, losses, params)


def test_bert_lamb_at_model_2(runs):
    """BERT_TINY with LAMB at ``model 2`` against the port at world 1 and
    the JAX engine on a ``model 2`` host mesh; LAMB's per-leaf norms of a
    tensor-parallel leaf sum over ``model`` (``lamb-norms``)."""
    meta, state = _read(runs, "bert_m2")
    losses, ref = _reference(runs, 1, "bert")
    _assert_close(meta, state, losses, ref)
    assert all(c.get("lamb-norms", 0) > 0 for c in meta["comm"])
    assert meta["replicas_equal"]["mlm_bias"]
    jlosses, jparams = _jax("bert", GPT2_MESHES["m2"], 2, runs["bert"])
    _assert_close(meta, state, jlosses, jparams)


def test_tag_saved_at_model_2_seq_2_loads_at_model_4_and_world_1(runs):
    disk = _tag_state(runs["ck"], "tp")
    names = [n for n in disk if n.startswith(("params/", "opt_state/"))]
    assert any(n.startswith("opt_state/exp_avg_sq/blocks/qkv_w") for n in names)
    saver, saver_state = _read(runs, "ck_save")
    _, m4 = _read(runs, "ck_m4_load_tp")
    _, one = runs["back"]
    for n in names:
        assert np.array_equal(saver_state[n], disk[n].numpy()), n
        assert np.array_equal(m4[n], disk[n].numpy()), n
        assert torch.equal(one[n], disk[n]), n
    assert saver["mesh"]["model"] == 2 and saver["mesh"]["seq"] == 2


def test_world_1_tag_loads_at_model_2_seq_2(runs):
    disk = _tag_state(runs["ck"], "w1")
    _, state = _read(runs, "ck_load_w1")
    names = [n for n in disk if n.startswith(("params/", "opt_state/"))]
    assert names
    for n in names:
        assert np.array_equal(state[n], disk[n].numpy()), n


def _layout(mesh_sizes, rank, stage=0):
    cfg = DeepSpeedConfig({"train_batch_size": 1, "zero_optimization": {"stage": stage}})
    mesh = Mesh(mesh_sizes, rank=rank)
    rules = ZeroShardingRules(cfg.zero_config, fsdp_size=mesh.sizes["fsdp"],
                              tp_spec_fn=tgpt2.tp_spec_fn)
    params = tgpt2.init_params(tgpt2.GPT2_TINY, seed=0)
    from deepspeed_tpu_torch.runtime.engine import tree_flatten, tree_paths

    leaves, _ = tree_flatten(params)
    paths = tree_paths(params)
    return ZeroLayout(mesh, rules, [x.shape for x in leaves], paths), leaves, paths


@pytest.mark.parametrize("m", [2, 4])
def test_qkv_block_is_the_ranks_heads(m):
    """A ``model`` rank's block of the fused ``qkv_w``/``qkv_b`` is ``[q_r
    | k_r | v_r]``, the columns of its own heads of each part (JAX's
    ``NamedSharding`` would cut the packed columns contiguously: ROADMAP
    C4), and ``natural`` gives the leaf back in its own order."""
    D = tgpt2.GPT2_TINY.n_embd
    n = D // m
    for r in range(m):
        layout, leaves, paths = _layout({"model": m}, r)
        for name in ("blocks/qkv_w", "blocks/qkv_b"):
            i = paths.index(name)
            full = torch.from_numpy(leaves[i])
            block = layout.from_natural(i, full, layout.leaves[i].param_spec)
            want = torch.cat([full[..., p * D + r * n:p * D + (r + 1) * n] for p in range(3)], -1)
            assert layout.leaves[i].parts == 3
            assert torch.equal(block, want), (name, r)
    # every rank's blocks, gathered as natural does, are the leaf again
    from deepspeed_tpu_torch.runtime.zero.partition import _group_parts

    i = paths.index("blocks/qkv_w")
    full = torch.from_numpy(leaves[i])
    blocks = [_layout({"model": m}, r)[0].from_natural(i, full, layout.leaves[i].param_spec)
              for r in range(m)]
    assert torch.equal(_group_parts(torch.cat(blocks, -1), 3, m, inverse=True), full)


def _engine(cfg, mesh_sizes, tp=True, family=tgpt2):
    model_fn, init_fn, tp_fn = family.make_model(cfg)
    config = DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1}, world_size=1)
    return DeepSpeedEngine(model_fn, init_fn(seed=0), config, device="cpu",
                           mesh=Mesh(mesh_sizes, rank=0), tp_spec_fn=tp_fn if tp else None,
                           mesh_check=functools.partial(family.check_mesh, cfg))


def test_vocab_50257_at_model_2_is_refused_as_the_jax_package_refuses_it():
    wording = r"should be divisible by 2, but it is equal to 50257"
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, vocab_size=50257)
    with pytest.raises(ValueError, match=wording) as got:
        _engine(cfg, {"model": 2})
    assert "wte" in str(got.value) and "(50257, 64)" in str(got.value)
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, vocab_size=50257)
    model_fn, init_fn, tp_fn = jgpt2.make_model(jcfg)
    jmesh = make_mesh(MeshConfig(data=1, model=2), devices=jax.devices()[:2])
    with pytest.raises(ValueError, match=wording):
        deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                 config={"train_micro_batch_size_per_gpu": 1}, mesh=jmesh,
                                 tp_spec_fn=tp_fn)


def test_port_refusals_of_a_model_axis():
    """Heads the ``model`` axis does not divide (a rank runs whole heads;
    GSPMD would reshard), for GPT-2 and BERT; a ``model`` axis without
    the model's tensor-parallel specs."""
    with pytest.raises(ValueError, match=r"n_head 2 is not divisible by the model axis \(4\)"):
        _engine(dataclasses.replace(tgpt2.GPT2_TINY, n_head=2), {"model": 4})
    with pytest.raises(ValueError, match=r"num_attention_heads 4 is not divisible"):
        _engine(dataclasses.replace(tbert.BERT_TINY, hidden_size=48, intermediate_size=96),
                {"model": 3}, family=tbert)
    with pytest.raises(ValueError, match="needs the model's tensor-parallel specs"):
        _engine(tgpt2.GPT2_TINY, {"model": 2}, tp=False)
    with pytest.raises(ValueError, match="BERT has no sequence-parallel mode"):
        _engine(tbert.BERT_TINY, {"seq": 2}, family=tbert)
    # the inference engine's refusals of the same (tests/test_torch_tp_inference.py
    # serves at mp_size 2 and 4 across ranks)
    with pytest.raises(ValueError, match=r"n_head 3 is not divisible by the model axis \(2\)"):
        deepspeed_tpu_torch.init_inference(
            model_config=dataclasses.replace(tgpt2.GPT2_TINY, n_head=3, n_embd=48), mp_size=2,
            device="cpu")
