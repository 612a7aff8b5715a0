"""The port's checkpoints (deepspeed_tpu_torch.runtime.checkpointing) on the
CPU: the applicable cases of ``tests/test_checkpointing.py``, a resumed run
against the port's own uninterrupted run (bit for bit) and against the JAX
engine's, and the points where the port's tags meet the JAX package's
(``meta.json``'s keys, ``consolidate_fp32_state_dict``).

Tolerances against the JAX engine are ``tests/test_torch_training.py``'s:
f32 losses 2e-5 relative and parameters 1e-5 absolute; bf16 losses 1e-3
relative, parameters 1e-4 absolute on average and at most twice the sum of
the steps' learning rates for any one element.  A resumed run against the
port's own uninterrupted run is held to equality: the same ops on the same
values in the same order, with every counter and generator restored.  On
the CPU that holds only under ``torch.use_deterministic_algorithms``: the
embedding lookup's backward (``index_put_`` with accumulation) sums in
whatever order its threads finish, so two identical runs differ in the
last bits without it (the card's kernel sorts its indices).
"""
import dataclasses
import json
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
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.runtime.checkpointing import STATE_DIR, STATE_FILE, consolidate_fp32_state_dict
from deepspeed_tpu_torch.runtime.engine import tree_flatten

TINY = dataclasses.replace(tgpt2.GPT2_TINY, remat=False)
F32_LOSS_RTOL, F32_PARAM_ATOL = 2e-5, 1e-5
BF16_LOSS_RTOL, BF16_PARAM_MEAN = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def make_engine(opt="Adam", fp16=False, seed=7, scheduler=None, cfg=TINY, **extra):
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    config = {
        "train_micro_batch_size_per_gpu": 2,
        "optimizer": {"type": opt, "params": {"lr": 1e-3, **({"momentum": 0.9} if opt == "SGD"
                                                            else {})}},
        "steps_per_print": 1000,
        **extra,
    }
    if fp16:
        config["fp16"] = {"enabled": True, "initial_scale_power": 8}
    if scheduler:
        config["scheduler"] = scheduler
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=seed), config=config, device="cpu")
    return engine


def batches(n, bs=4, seq=16, seed=3, vocab=TINY.vocab_size):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, (bs, seq), dtype=np.int32)} for _ in range(n)]


def flat(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
            for x in tree_flatten(tree)[0]]


def assert_same_state(a, b):
    """Masters, optimizer moments and counters equal, bit for bit."""
    assert all(torch.equal(x, y) for x, y in zip(a._params, b._params))
    sa, sb = tree_flatten(vars(a.opt_state) if dataclasses.is_dataclass(a.opt_state)
                          else a.opt_state)[0], \
        tree_flatten(vars(b.opt_state) if dataclasses.is_dataclass(b.opt_state)
                     else b.opt_state)[0]
    assert len(sa) == len(sb) and all(torch.equal(x, y) for x, y in zip(sa, sb))
    assert (a.global_steps, a.micro_steps, a.global_samples, a.skipped_steps) == \
        (b.global_steps, b.micro_steps, b.global_samples, b.skipped_steps)


# ---------------------------------------------------------------------------
# the cases of tests/test_checkpointing.py that apply on one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt", ["Adam", "AdamW", "Lamb", "SGD"])
def test_roundtrip_across_optimizer_wrappers(tmp_path, opt):
    eng = make_engine(opt=opt)
    bs = batches(3)
    eng.train_batch(bs[0])
    eng.train_batch(bs[1])
    eng.save_checkpoint(str(tmp_path), tag="ck")
    eng2 = make_engine(opt=opt, seed=99)  # different init
    path, _ = eng2.load_checkpoint(str(tmp_path), tag="ck")
    assert path is not None and eng2.global_steps == 2
    assert_same_state(eng, eng2)
    assert float(eng.train_batch(bs[2])) == float(eng2.train_batch(bs[2]))
    assert_same_state(eng, eng2)


def test_latest_tag_and_client_state(tmp_path):
    eng = make_engine()
    eng.train_batch(batches(1)[0])
    eng.save_checkpoint(str(tmp_path), client_state={"epoch": 3, "note": "hi"})
    eng.train_batch(batches(1)[0])
    eng.save_checkpoint(str(tmp_path), client_state={"epoch": 4})
    # latest file points at the newest tag
    assert (tmp_path / "latest").read_text().strip() == "global_step2"
    eng2 = make_engine(seed=1)
    path, client = eng2.load_checkpoint(str(tmp_path))
    assert path.endswith("global_step2") and client["epoch"] == 4
    # explicit older tag still loads
    eng3 = make_engine(seed=2)
    _, client1 = eng3.load_checkpoint(str(tmp_path), tag="global_step1")
    assert client1 == {"epoch": 3, "note": "hi"} and eng3.global_steps == 1


def test_missing_checkpoint_returns_none(tmp_path):
    eng = make_engine()
    path, client = eng.load_checkpoint(str(tmp_path / "nothing"))
    assert path is None and client == {}


def test_load_module_only(tmp_path):
    eng = make_engine()
    eng.train_batch(batches(1)[0])
    eng.save_checkpoint(str(tmp_path), tag="ck")
    eng2 = make_engine(seed=50)
    fresh_m = [m.clone() for m in eng2.opt_state.exp_avg]
    eng2.load_checkpoint(str(tmp_path), tag="ck", load_module_only=True)
    # params match but optimizer state/counters stay fresh
    assert all(torch.equal(x, y) for x, y in zip(eng._params, eng2._params))
    assert all(torch.equal(x, y) for x, y in zip(eng2.opt_state.exp_avg, fresh_m))
    assert eng2.global_steps == 0 and int(eng2.opt_state.step) == 0


def test_load_without_optimizer_states(tmp_path):
    eng = make_engine(fp16=True)
    eng.train_batch(batches(1)[0])
    eng.save_checkpoint(str(tmp_path), tag="ck")
    eng2 = make_engine(fp16=True, seed=50)
    eng2.load_checkpoint(str(tmp_path), tag="ck", load_optimizer_states=False)
    assert all(torch.equal(x, y) for x, y in zip(eng._params, eng2._params))
    assert int(eng2.opt_state.step) == 0  # fresh moments and step
    assert eng2.global_steps == 1 and eng2.loss_scale == eng.loss_scale


def test_fp16_loss_scale_state_roundtrip(tmp_path):
    eng = make_engine(fp16=True)
    eng.train_batch(batches(1)[0])
    scale_before = eng.loss_scale
    eng.save_checkpoint(str(tmp_path), tag="ck")
    eng2 = make_engine(fp16=True, seed=9)
    eng2.load_checkpoint(str(tmp_path), tag="ck")
    assert eng2.loss_scale == scale_before
    assert int(eng2.loss_scale_state.good_steps) == int(eng.loss_scale_state.good_steps) == 1


def test_lr_scheduler_position_restored(tmp_path):
    sched = {"type": "WarmupLR", "params": {"warmup_max_lr": 0.1, "warmup_num_steps": 10}}
    eng = make_engine(scheduler=sched)
    for b in batches(3):
        eng.train_batch(b)
    lr_before = eng.get_lr()[0]
    eng.save_checkpoint(str(tmp_path), tag="ck")
    eng2 = make_engine(scheduler=sched, seed=3)
    eng2.load_checkpoint(str(tmp_path), tag="ck")
    assert eng2.get_lr()[0] == lr_before  # schedule is a pure fn of step


def test_save_between_micro_steps_keeps_the_pending_gradients(tmp_path):
    """gas 2, saved after one micro-step: the tag holds the pending
    gradients, and the resumed boundary step equals the uninterrupted one;
    a params-only load drops them."""
    bs = batches(2, bs=2)
    a, b = (make_engine(gradient_accumulation_steps=2) for _ in range(2))
    for eng in (a, b):
        eng.forward(bs[0])
        eng.backward()
        eng.step()
    b.save_checkpoint(str(tmp_path), tag="mid")
    with open(tmp_path / "mid" / "meta.json") as f:
        assert json.load(f)["has_grad_acc"] is True
    c = make_engine(gradient_accumulation_steps=2, seed=99)
    c.load_checkpoint(str(tmp_path), tag="mid")
    for eng in (a, c):
        eng.forward(bs[1])
        eng.backward()
        eng.step()
    assert a.global_steps == c.global_steps == 1
    assert_same_state(a, c)
    d = make_engine(gradient_accumulation_steps=2, seed=98)
    d.train_batch({"input_ids": np.concatenate([bs[0]["input_ids"], bs[1]["input_ids"]])})
    d.forward(bs[0])
    d.load_checkpoint(str(tmp_path), tag="mid", load_module_only=True)
    assert all(p.grad is None for p in d._params)


def test_a_tag_of_another_model_is_refused(tmp_path):
    eng = make_engine()
    eng.save_checkpoint(str(tmp_path), tag="ck")
    other = make_engine(cfg=dataclasses.replace(TINY, n_layer=3))
    with pytest.raises(ValueError, match="does not match"):
        other.load_checkpoint(str(tmp_path), tag="ck")


def test_on_disk_format(tmp_path):
    """One torch.save file of CPU tensors under the JAX portable state's
    names, readable with weights_only=True; masters and moments in f32."""
    eng = make_engine(cfg=dataclasses.replace(TINY, n_positions=64), bf16={"enabled": True})
    eng.train_batch(batches(1)[0])
    path = eng.save_checkpoint(str(tmp_path))
    assert sorted(os.listdir(path)) == ["manifest.json", "meta.json", "state"]
    sd = torch.load(os.path.join(path, STATE_DIR, STATE_FILE), weights_only=True)
    assert {n.split("/")[0] for n in sd} == {"params", "opt_state", "loss_scale", "micro_step",
                                             "global_step", "global_samples"}
    assert sd["params/blocks/qkv_w"].dtype == torch.float32
    assert sd["opt_state/exp_avg_sq/wte"].dtype == torch.float32
    assert int(sd["opt_state/step"]) == 1 and int(sd["micro_step"]) == 1
    assert all(t.device.type == "cpu" for t in sd.values())


# ---------------------------------------------------------------------------
# resumed == uninterrupted (bit for bit), and against the JAX engine
# ---------------------------------------------------------------------------

RESUME_CFG = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256)
STEPS = 4


def _train_config(bf16: bool):
    return {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0,
        "bf16": {"enabled": bf16},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 10, "warmup_num_steps": 2, "warmup_min_lr": 1e-4,
            "warmup_max_lr": 1e-3}},
        "steps_per_print": 1000,
    }


def _resume_batches():
    ids = np.random.default_rng(0).integers(0, RESUME_CFG.vocab_size, (4, 256), dtype=np.int32)
    return [{"input_ids": ids}] * STEPS


def _port_engine(bf16, cfg=RESUME_CFG):
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    return deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                          config=_train_config(bf16), device="cpu")


def _port_resumed(tmp_path, bf16, cfg=RESUME_CFG, bs=None):
    """(uninterrupted losses and engine, resumed losses and engine)."""
    bs = bs or _resume_batches()
    whole, _, _, sched = _port_engine(bf16, cfg)
    ref = [float(whole.train_batch(b)) for b in bs]
    first = _port_engine(bf16, cfg)[0]
    got = [float(first.train_batch(b)) for b in bs[:STEPS // 2]]
    first.save_checkpoint(str(tmp_path))
    del first
    second = _port_engine(bf16, cfg)[0]
    second.load_checkpoint(str(tmp_path))
    got += [float(second.train_batch(b)) for b in bs[STEPS // 2:]]
    return ref, whole, got, second, sum(float(sched(i)) for i in range(STEPS))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_resumed_run_equals_uninterrupted_and_stays_near_the_jax_engine(tmp_path, precision,
                                                                       monkeypatch):
    bf16 = precision == "bf16"
    if not bf16:
        monkeypatch.setenv("DS_KERNELS", "1")  # the JAX side's Pallas Adam, interpreted
    ref, whole, got, resumed, lr_sum = _port_resumed(tmp_path, bf16)
    assert got == ref
    assert_same_state(whole, resumed)

    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=256)
    model_fn, init_fn, tp_fn = jgpt2.make_model(jcfg)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                    config=_train_config(bf16), mesh=mesh, tp_spec_fn=tp_fn)[0]
    want = [float(jeng.train_batch(b)) for b in _resume_batches()]
    pairs = list(zip(flat(resumed.params), flat(jax.tree.map(np.asarray, jeng.state["params"]))))
    if not bf16:
        np.testing.assert_allclose(got, want, rtol=F32_LOSS_RTOL)
        for a, b in pairs:
            np.testing.assert_allclose(a, b, atol=F32_PARAM_ATOL, rtol=0)
        return
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    errs = np.concatenate([np.abs(a - b).ravel() for a, b in pairs])
    assert errs.mean() <= BF16_PARAM_MEAN
    assert errs.max() <= 2 * lr_sum


def test_resumed_dropout_run_replays_the_same_masks(tmp_path):
    """With dropout the model's generator is seeded from the micro-step
    count: the restored count gives the resumed steps the masks the
    uninterrupted run drew (different batches per step, so a replayed or
    skipped batch would show)."""
    cfg = dataclasses.replace(RESUME_CFG, n_positions=64, dropout=0.1)
    rng = np.random.default_rng(1)
    bs = [{"input_ids": rng.integers(0, cfg.vocab_size, (4, 64), dtype=np.int32)}
          for _ in range(STEPS)]
    ref, whole, got, resumed, _ = _port_resumed(tmp_path, False, cfg=cfg, bs=bs)
    assert got == ref
    assert_same_state(whole, resumed)


# ---------------------------------------------------------------------------
# where the port's tags meet the JAX package's
# ---------------------------------------------------------------------------

# SGD: Adam's first step moves an element whose gradient is near eps by up
# to lr either way, so its masters would say more about the two
# frameworks' gradients than about the consolidation
MEET_CONFIG = {"train_micro_batch_size_per_gpu": 2,
               "optimizer": {"type": "SGD", "params": {"lr": 1e-3, "momentum": 0.9}},
               "steps_per_print": 1000}


@pytest.fixture(scope="module")
def jax_tag(tmp_path_factory):
    """One step of the JAX engine on one device, saved with orbax."""
    model_fn, init_fn, tp_fn = jgpt2.make_model(dataclasses.replace(jgpt2.GPT2_TINY, remat=False))
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=7),
                                   config=MEET_CONFIG, mesh=mesh, tp_spec_fn=tp_fn)[0]
    eng.train_batch(batches(1)[0])
    root = tmp_path_factory.mktemp("jax_ckpt")
    path = eng.save_checkpoint(str(root))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    from deepspeed_tpu.runtime.checkpointing import consolidate_fp32_state_dict as jconsolidate

    return {"meta": meta, "entries": sorted(os.listdir(path)), "fp32": jconsolidate(eng)}


def _port_one_step(tmp_path):
    eng = make_engine(opt="SGD", seed=7)  # MEET_CONFIG
    eng.train_batch(batches(1)[0])
    return eng, eng.save_checkpoint(str(tmp_path))


def test_meta_json_has_the_jax_engines_keys(tmp_path, jax_tag):
    eng, path = _port_one_step(tmp_path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == set(jax_tag["meta"])
    assert sorted(os.listdir(path)) == jax_tag["entries"]  # state/, meta.json, manifest.json
    for key in ("tag", "global_step", "micro_step", "global_samples", "skipped_steps",
                "world_size", "dp_world_size", "mp_world_size", "zero_stage", "client_state"):
        assert meta[key] == jax_tag["meta"][key], key
    assert meta["comm_state"] is None


def test_consolidated_fp32_state_dict_equals_the_jax_packages(tmp_path, jax_tag):
    eng, _ = _port_one_step(tmp_path)
    got, want = consolidate_fp32_state_dict(eng), jax_tag["fp32"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32 and got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0, err_msg=name)
