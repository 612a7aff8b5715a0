"""The port's training step (deepspeed_tpu_torch.initialize → train_batch)
against the JAX engine's (deepspeed_tpu.initialize → train_batch), on the
CPU.

Both sides take the same ``init_params`` seed and the same numpy batches:
``GPT2_TINY`` with 256 positions at T 256 (so both take the flash-attention
branch, the JAX one its Pallas kernels in interpret mode, the port the
plain versions of its CUDA kernels), gradient accumulation 2, global-norm
clipping 1.0, AdamW and ``WarmupDecayLR``.  The JAX engine runs on a
one-device mesh (the test harness gives JAX 8 CPU devices), and in f32
with ``DS_KERNELS=1``, so its update is the Pallas Adam kernel in
interpret mode.

Tolerances:
* f32: per-step losses 2e-5 relative and final parameters 1e-5 absolute
  (parameters ~0.02-1, moved ~5e-3 in five steps): the same f32 math in
  another summation order (attention, matmuls, the global norm).
* bf16: per-step losses 1e-3 relative; final f32 masters 1e-4 absolute
  on average over all elements, and at most twice the sum of the five
  steps' learning rates for any one element.  Activations round to bf16
  (spacing 2**-8 relative) at different points in the two frameworks (XLA
  fuses the elementwise chain, PyTorch rounds after each op), and Adam's
  normalized update turns a gradient near zero whose sign differs into a
  step of up to one lr the other way, so a few elements may differ by that
  much (measured: mean 1.4e-5, max 4.3e-3 of the 6.8e-3 bound).
* The micro-step API against ``train_batch``: parameters 1e-8 absolute
  (CPU GEMM kernels may block a sum differently by operand alignment).
"""
import dataclasses

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

STEPS = 5
F32_LOSS_RTOL, F32_PARAM_ATOL = 2e-5, 1e-5
BF16_LOSS_RTOL, BF16_PARAM_MEAN = 1e-3, 1e-4


def _config(bf16: bool):
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


def _batches(vocab):
    """One fixed batch, fed every step, so the loss must fall."""
    ids = np.random.default_rng(0).integers(0, vocab, (4, 256), dtype=np.int32)
    return [{"input_ids": ids}] * STEPS


def _run_jax(bf16: bool):
    cfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=256)
    model_fn, init_fn, tp_fn = jgpt2.make_model(cfg)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    eng, _, _, _ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                            config=_config(bf16), mesh=mesh, tp_spec_fn=tp_fn)
    losses = [float(eng.train_batch(b)) for b in _batches(cfg.vocab_size)]
    return losses, jax.tree.map(np.asarray, eng.state["params"])


def _run_torch(bf16: bool):
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, opt, _, sched = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=init_fn(seed=3), config=_config(bf16), device="cpu")
    losses = [float(eng.train_batch(b)) for b in _batches(cfg.vocab_size)]
    assert eng.global_steps == STEPS and eng.micro_steps == 2 * STEPS
    assert opt is eng.optimizer and callable(sched)
    lr_sum = sum(float(sched(i)) for i in range(STEPS))
    return losses, eng.params, lr_sum


def _flat(tree):
    leaves, _ = deepspeed_tpu_torch.runtime.engine.tree_flatten(tree)
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.numpy() for x in leaves]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_train_batch_trajectory_matches_jax_engine(precision, monkeypatch):
    if precision == "f32":
        monkeypatch.setenv("DS_KERNELS", "1")  # the JAX side's Pallas Adam, interpreted
    ref_losses, ref_params = _run_jax(precision == "bf16")
    got_losses, got_params, lr_sum = _run_torch(precision == "bf16")
    assert got_losses[-1] < got_losses[0]
    pairs = list(zip(_flat(got_params), _flat(ref_params)))
    if precision == "f32":
        np.testing.assert_allclose(got_losses, ref_losses, rtol=F32_LOSS_RTOL)
        for a, b in pairs:
            np.testing.assert_allclose(a, b, atol=F32_PARAM_ATOL, rtol=0)
        return
    np.testing.assert_allclose(got_losses, ref_losses, rtol=BF16_LOSS_RTOL)
    errs = np.concatenate([np.abs(a - b).ravel() for a, b in pairs])
    assert errs.mean() <= BF16_PARAM_MEAN
    assert errs.max() <= 2 * lr_sum


def test_params_from_jax_equals_the_ports_own_init():
    cfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=256)
    tcfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256)
    from_jax = _flat(tgpt2.params_from_jax(jgpt2.init_params(cfg, seed=3)))
    own = _flat(tgpt2.init_params(tcfg, seed=3))
    assert len(from_jax) == len(own)
    for a, b in zip(from_jax, own):
        np.testing.assert_array_equal(a, b)


def test_micro_api_and_eval_match_train_batch():
    """forward/backward/step over the micro-batches is train_batch;
    eval_batch is the loss without a gradient; checkpoints raise."""
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    batch = _batches(cfg.vocab_size)[0]
    engines = [deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                              config=_config(False), device="cpu")[0]
               for _ in range(2)]
    e1, e2 = engines
    before = float(e1.eval_batch({"input_ids": batch["input_ids"][:2]}))
    loss = float(e1.train_batch(batch))
    micro = []
    for i in range(2):
        micro.append(float(e2(({"input_ids": batch["input_ids"][2 * i:2 * i + 2]}))))
        e2.backward()
        e2.step()
    assert e2.global_steps == e1.global_steps == 1
    assert before == pytest.approx(micro[0], rel=1e-6)
    assert loss == pytest.approx(np.mean(micro), rel=1e-6)
    for a, b in zip(_flat(e1.params), _flat(e2.params)):
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)
    with pytest.raises(NotImplementedError, match="A4"):
        e1.save_checkpoint("/nonexistent")
    with pytest.raises(NotImplementedError, match="A5"):
        deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                       config=_config(False), training_data=[1], device="cpu")


SCHEDULES = [
    ("WarmupDecayLR", {"total_num_steps": 50, "warmup_num_steps": 10, "warmup_min_lr": 1e-5,
                       "warmup_max_lr": 1e-3}),
    ("WarmupDecayLR", {"total_num_steps": 50, "warmup_num_steps": 10, "warmup_type": "linear"}),
    ("WarmupLR", {"warmup_num_steps": 7, "warmup_max_lr": 3e-4}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 10,
                  "decay_lr_rate": 0.1, "decay_step_size": 5}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 8,
                  "cycle_second_step_size": 4, "decay_lr_rate": 0.5}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 6,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_lr_schedules_match_jax(name, params):
    """The port's schedules evaluate in f32 as the JAX ones: equal to 1e-7
    relative (a log1p may differ in its last bit)."""
    from deepspeed_tpu.runtime import lr_schedules as jlr
    from deepspeed_tpu_torch.runtime import lr_schedules as tlr

    jf, tf = jlr.get_lr_schedule(name, params), tlr.get_lr_schedule(name, params)
    for step in (0, 1, 3, 7, 8, 10, 11, 12, 25, 49, 50, 80):
        assert float(tf(step)) == pytest.approx(float(jf(step)), rel=1e-7, abs=1e-12), step
    jm, tm = jlr.one_cycle_momentum(cycle_first_step_size=10), tlr.one_cycle_momentum(cycle_first_step_size=10)
    for step in (0, 5, 10, 15, 20, 30):
        assert float(tm(step)) == pytest.approx(float(jm(step)), rel=1e-7)
    sched = tlr.LRScheduler(tf)
    sched.step()
    sched.step()
    assert sched.get_lr() == [float(tf(1))] and sched.state_dict() == {"last_batch_iteration": 1}


def test_dynamic_loss_scaler_matches_jax():
    """The same overflow sequence through both dynamic scalers gives the
    same scale, window and hysteresis after every step."""
    import jax.numpy as jnp

    from deepspeed_tpu.config.config import Fp16Config as JFp16
    from deepspeed_tpu.runtime.fp16.loss_scaler import LossScaler as JScaler
    from deepspeed_tpu_torch.config.config import Fp16Config as TFp16
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import LossScaler as TScaler

    block = {"enabled": True, "loss_scale": 0, "initial_scale_power": 8, "loss_scale_window": 3,
             "hysteresis": 2, "min_loss_scale": 4}
    js, ts = JScaler.from_config(JFp16.from_dict(block)), TScaler.from_config(TFp16.from_dict(block))
    jst, tst = js.init(), ts.init()
    for ovf in (False, True, True, True, False, False, False, False, True, True, True, True, True, True):
        jst = js.update(jst, jnp.bool_(ovf))
        tst = ts.update(tst, torch.tensor(ovf))
        assert float(tst.scale) == float(jst.scale)
        assert int(tst.good_steps) == int(jst.good_steps)
        assert int(tst.hysteresis_left) == int(jst.hysteresis_left)
    grads = [torch.tensor([1.0, float("inf")]), torch.ones(3)]
    _, ovf = ts.unscale_and_check(grads, tst)
    assert bool(ovf)
    _, ovf = TScaler().unscale_and_check(grads, TScaler().init())  # static: never overflows
    assert not bool(ovf)


def test_fp16_dynamic_scaler_skips_an_overflowing_step():
    """An inf gradient under the dynamic fp16 scaler skips the step: the
    parameters stay, the step count stays, the scale is cut after the
    hysteresis runs out (the JAX engine's contract)."""
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=256, remat=False)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    config = {"train_micro_batch_size_per_gpu": 2, "fp16": {"enabled": True, "initial_scale_power": 4,
                                                            "hysteresis": 1},
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}
    batch = {"input_ids": np.zeros((2, 256), np.int32)}

    def poisoned(params, b, generator):
        return model_fn(params, b, generator) * float("inf")

    eng = deepspeed_tpu_torch.initialize(model=poisoned, model_parameters=init_fn(seed=3),
                                         config=config, device="cpu")[0]
    before = [t.clone() for t in _flat_tensors(eng.params)]
    eng.train_batch(batch)
    assert eng.global_steps == 0 and eng.skipped_steps == 1 and eng.loss_scale == 8.0
    for a, b in zip(_flat_tensors(eng.params), before):
        assert torch.equal(a, b)
    assert int(eng.opt_state.step) == 0


def _flat_tensors(tree):
    leaves, _ = deepspeed_tpu_torch.runtime.engine.tree_flatten(tree)
    return leaves
