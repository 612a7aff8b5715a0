"""Expert parallelism across gloo ranks: a MoE GPT-2 trained by the
port's engine in real OS processes (``deepspeed_tpu_torch/tools/zero_worker.py``)
against the port at world size 1 on the same global batches.

* GPT2_TINY with 4 experts, top-2 (T 64, f32, AdamW, gas 2, clipping 1.0,
  3 steps): ``{expert: 2}`` at world 2 and ``{fsdp: 2, expert: 2}`` at
  world 4, ZeRO stage 2, and the experts cut over ``model`` too
  (``{model: 2}``, world 2).  Losses within ``F32_LOSS_RTOL`` and masters
  within ``F32_PARAM_ATOL`` (``tests/test_torch_training.py``) of one
  process: every rank routes the data-parallel grid's global batch, so
  the capacity and the drops are one process's.
* The bytes counted a step equal, kind by kind, ``step_comm_bytes``, the
  port's ``update-all-gather`` model and ``gpt2.moe_comm_model``
  (``expert-all-reduce``, ``moe-routing``).
* Ranks holding the same block of a leaf hold the same bits (the
  replicated leaves' gradients are whole on every ``expert`` rank, summed
  once).
* A tag saved at ``{fsdp: 2, expert: 2}`` loads in one process with the
  saver's masters (the natural layout).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.checkpointing import _state_tensors

from tests.test_torch_training import F32_LOSS_RTOL, F32_PARAM_ATOL
from tests.test_torch_training import _config as _adamw_config
from tests.test_torch_zero import _launch

T, STEPS, GAS, MB, E = 64, 3, 2, 2, 4
MOE = {"n_positions": T, "n_experts": E}
MESHES = {"e2": {"data": 1, "expert": 2}, "f2e2": {"data": 1, "fsdp": 2, "expert": 2},
          "m2": {"data": 1, "model": 2}}
WORLD = {"e2": 2, "f2e2": 4, "m2": 2}


def _config(mesh, mb=MB, stage=2):
    return {**_adamw_config(False), "train_micro_batch_size_per_gpu": mb, "mesh": mesh,
            "zero_optimization": {"stage": stage}}


def _case(name, mesh, bfile, **kw):
    return {"name": name, "preset": "tiny", "model_cfg": MOE, "init_seed": 3,
            "config": _config(MESHES[mesh]), "batches": str(bfile), "steps": STEPS, **kw}


def _one_process(ids, dp, load=None, steps=STEPS):
    torch.use_deterministic_algorithms(True)
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, **MOE)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                             config=_config({"data": 1}, mb=MB * dp, stage=0),
                                             device="cpu")
    if load is not None:
        eng.load_checkpoint(*load)
    rows = GAS * MB * dp  # the global batch of a grid of dp ranks
    losses = [float(eng.train_batch({"input_ids": ids[s, :rows]})) for s in range(steps)]
    return losses, {n: t.detach().clone() for n, t in _state_tensors(eng).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    rng = np.random.default_rng(0)
    ids = np.repeat(rng.integers(0, tgpt2.GPT2_TINY.vocab_size, (1, GAS * MB * 2, T),
                                 dtype=np.int32), STEPS, axis=0)
    np.savez(tmp / "g.npz", input_ids=ids)
    ck = str(tmp / "ckpt")
    _launch(4, [_case("f2e2", "f2e2", tmp / "g.npz",
                      save={"dir": ck, "tag": "f2e2", "after": STEPS})], tmp, name="moe4")
    _launch(2, [_case("e2", "e2", tmp / "g.npz"), _case("m2", "m2", tmp / "g.npz")],
            tmp, name="moe2")
    return {"tmp": tmp, "ids": ids, "ck": ck}


_REFS = {}


def _reference(runs, dp):
    if dp not in _REFS:
        _REFS[dp] = _one_process(runs["ids"], dp)
    return _REFS[dp]


def _read(runs, name):
    with open(runs["tmp"] / f"{name}.json") as f:
        meta = json.load(f)
    with np.load(runs["tmp"] / f"{name}.npz") as z:
        return meta, {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", ["e2", "f2e2", "m2"])
def test_expert_parallel_matches_one_process(runs, case):
    meta, state = _read(runs, case)
    dp = meta["mesh"]["data"] * meta["mesh"]["fsdp"]
    losses, ref = _reference(runs, dp)
    np.testing.assert_allclose(meta["losses"], losses, rtol=F32_LOSS_RTOL)
    assert losses[-1] < losses[0]
    for name, t in ref.items():
        if name.startswith("params/"):
            np.testing.assert_allclose(state[name], t.numpy(), atol=F32_PARAM_ATOL, rtol=0,
                                       err_msg=name)
    assert all(meta["replicas_equal"].values()), meta["replicas_equal"]


@pytest.mark.parametrize("case", ["e2", "f2e2", "m2"])
def test_counted_bytes_equal_the_model(runs, case):
    meta, _ = _read(runs, case)
    want = {**meta["model"], **meta["extras"], **meta["parallel"]}
    for step in meta["comm"]:
        for kind, n in step.items():
            if kind != "step-scalars":  # the step's 4 scalars, no model kind
                assert n == want.get(kind), (case, kind, n, want.get(kind))
    if case != "m2":
        assert meta["comm"][0]["expert-all-reduce"] > 0
    if case == "f2e2":
        assert meta["comm"][0]["moe-routing"] > 0


def test_expert_parallel_tag_loads_in_one_process(runs):
    """The natural layout: a tag saved at ``{fsdp: 2, expert: 2}`` after
    its last step holds that run's masters; one process loads it and
    carries on as the world-4 run would."""
    _, state = _read(runs, "f2e2")
    _, loaded = _one_process(runs["ids"], 2, load=(runs["ck"], "f2e2"), steps=0)
    for name, t in loaded.items():
        if name.startswith("params/"):
            np.testing.assert_array_equal(t.numpy(), state[name], err_msg=name)
