"""ZeRO-Infinity parameter offload in the port (``offload_param`` ``cpu`` /
``nvme``: ``runtime/zero/param_offload.py``'s ``ZeroInfinityEngine``)
against the JAX package's streaming engine and the port's in-memory
engines, on the CPU.

A 4-layer GPT2_TINY (vocabulary 256, 64 positions, T 48), the plain
attention (below the flash branch's T 128, on both sides), f32 unless a
test says bf16.

Tolerances:
* Against the JAX ``ZeroInfinityEngine`` (f32, one-device mesh, the same
  host Adam): losses 2e-5 relative, final masters 1e-5 absolute
  (``test_torch_training.py``'s f32 bounds).
* Against the port's offload engine (the same host Adam over the same
  f32 masters; the stream sums the tied ``wte``'s two gradients in f32
  on the host and the norm in f64, the in-memory engine in f32 on the
  device): f32 losses 1e-6 relative, masters 1e-5 absolute (the key
  bias's gradient is rounding noise around zero, which Adam's normalized
  step turns into moves of up to ~lr either way); bf16: the
  first loss bit for bit (the same bf16 weights and the same ops), later
  losses 1e-3 relative and masters ``test_torch_training.py``'s bf16
  bounds (mean 1e-4, max twice the steps' learning rates).
* ``nvme`` against ``cpu`` staging, and resume against the uninterrupted
  run: bit for bit.
"""
import dataclasses
import gc
import weakref

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
from deepspeed_tpu_torch.ops.aio import aio
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine, tree_flatten
from deepspeed_tpu_torch.runtime.zero.param_offload import ZeroInfinityEngine

TCFG = dataclasses.replace(tgpt2.GPT2_TINY, n_layer=4, vocab_size=256, n_positions=64)
JCFG = dataclasses.replace(jgpt2.GPT2_TINY, n_layer=4, vocab_size=256, n_positions=64,
                           use_flash_attention=False)
LR = 1e-3


def _config(zero, bf16=False, gas=1, optimizer="Adam", fp16=False):
    c = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas,
         "bf16": {"enabled": bf16}, "gradient_clipping": 1.0, "zero_optimization": zero,
         "optimizer": {"type": optimizer, "params": {"lr": LR}}, "steps_per_print": 10_000}
    if fp16:
        c["fp16"] = {"enabled": True}
    return c


def _stream(device="cpu", buffer_count=1, nvme_path=None):
    return {"stage": 3, "offload_param": {"device": device, "buffer_count": buffer_count,
                                          **({"nvme_path": nvme_path} if nvme_path else {})}}


def _batches(n, gas=1, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2 * gas, 48), dtype=np.int32)} for _ in range(n)]


def _port(config, cfg=TCFG, seed=0):
    torch.use_deterministic_algorithms(True)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=seed),
                                             config=config, device="cpu")
    return eng


def _flat(tree):
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)
            for x in tree_flatten(tree)[0]]


def test_infinity_engine_selected_trains_and_evaluates():
    e = _port(_config(_stream()))
    assert isinstance(e, ZeroInfinityEngine)
    assert e.n_groups == TCFG.n_layer and e.group_layers == 1
    assert all(m.device.type == "cpu" and m.dtype == torch.float32 for m in e._host_opt.masters)
    fixed = _batches(1)[0]
    l0 = float(e.eval_batch(fixed))
    losses = [float(e.train_batch(fixed)) for _ in range(4)]
    assert np.isfinite(losses).all() and e.global_steps == 4
    assert float(e.eval_batch(fixed)) < l0
    assert e.stats["group_uploads"] == 2 * 4 * TCFG.n_layer + 2 * TCFG.n_layer  # train + eval


def test_infinity_losses_match_jax_infinity_engine():
    model_fn, init_fn, tp_fn = jgpt2.make_model(JCFG)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    config = _config(_stream(buffer_count=2))
    jeng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                        config=config, mesh=mesh, tp_spec_fn=tp_fn)
    assert type(jeng).__name__ == "ZeroInfinityEngine"
    teng = _port(config)
    batches = _batches(4, seed=3)
    jl = [float(jeng.train_batch(b)) for b in batches]
    tl = [float(teng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    for a, b in zip([m.numpy() for m in teng._host_opt.masters], jeng._host_opt.masters):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_infinity_matches_the_ports_offload_engine(bf16):
    batches = _batches(4, gas=2, seed=4)
    inf = _port(_config(_stream(buffer_count=2), bf16=bf16, gas=2))
    off = _port(_config({"offload_optimizer": {"device": "cpu"}}, bf16=bf16, gas=2))
    assert isinstance(off, DeepSpeedEngine)
    il = [float(inf.train_batch(b)) for b in batches]
    ol = [float(off.train_batch(b)) for b in batches]
    pairs = list(zip(_flat(inf.params), _flat(off.params)))
    if not bf16:
        np.testing.assert_allclose(il, ol, rtol=1e-6)
        for a, b in pairs:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        return
    assert il[0] == ol[0]
    np.testing.assert_allclose(il, ol, rtol=1e-3)
    errs = np.concatenate([np.abs(a - b).ravel() for a, b in pairs])
    assert errs.mean() <= 1e-4 and errs.max() <= 2 * LR * len(batches)


def test_infinity_with_dropout_recomputes_the_forwards_masks():
    """Dropout on: the group recompute draws the forward's masks (the
    layer seeds of the micro-step's generator), so the stream equals the
    in-memory offload engine, whose checkpointed blocks recompute alike."""
    cfg = dataclasses.replace(TCFG, dropout=0.1)
    batches = _batches(3, seed=6)
    inf = _port(_config(_stream(buffer_count=2)), cfg=cfg)
    off = _port(_config({"offload_optimizer": {"device": "cpu"}}), cfg=cfg)
    il = [float(inf.train_batch(b)) for b in batches]
    ol = [float(off.train_batch(b)) for b in batches]
    np.testing.assert_allclose(il, ol, rtol=1e-6)
    assert float(inf.eval_batch(batches[0])) == pytest.approx(float(off.eval_batch(batches[0])),
                                                               rel=1e-6)


@pytest.mark.parametrize("buffer_count", [1, 2, 3])
def test_infinity_live_group_bytes_within_two_groups(buffer_count):
    e = _port(_config(_stream(buffer_count=buffer_count)))
    e.train_batch(_batches(1)[0])
    gl = {1: 1, 2: 2, 3: 2}[buffer_count]  # the largest divisor of 4 up to buffer_count
    assert e.group_layers == gl
    one = e.group_bytes
    assert one == 4 * sum(m.numel() // TCFG.n_layer * gl for p, m in
                          zip(e._paths, e._host_opt.masters) if p.startswith("blocks/"))
    # the two device group buffers, and the group gradients each counted
    # from the backward that makes them until they are freed: two groups'
    # at most (the drain runs one group behind), none after the step
    assert e.stats["max_live_group_param_bytes"] == 2 * one
    assert one < e.stats["max_live_group_grad_bytes"] <= 2 * one
    assert e.live_group_grad_bytes == 0
    engine = weakref.ref(e)  # the counting keeps no dropped engine alive
    del e
    gc.collect()
    assert engine() is None


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_infinity_nvme_staging_reads_every_group_from_disk(bf16, tmp_path):
    steps, gas = 2, 2
    batches = _batches(steps, gas=gas, seed=8)
    nv = _port(_config(_stream("nvme", 2, str(tmp_path)), bf16=bf16, gas=gas))
    cpu = _port(_config(_stream("cpu", 2), bf16=bf16, gas=gas))
    assert nv._param_swapper is not None and cpu._param_swapper is None
    aio.reset_counts()
    nl = [float(nv.train_batch(b)) for b in batches]
    reads = aio.counts()
    cl = [float(cpu.train_batch(b)) for b in batches]
    assert nl == cl
    assert all(torch.equal(a, b) for a, b in zip(nv._host_opt.masters, cpu._host_opt.masters))
    blocks = sum(m.numel() for p, m in zip(nv._paths, nv._host_opt.masters)
                 if p.startswith("blocks/")) * (2 if bf16 else 4)
    # every upload read its group's file: gas x 2 sweeps x the blocks' bytes
    assert nv.stats["group_read_bytes"] == steps * gas * 2 * blocks
    assert reads["read_bytes"] == steps * gas * 2 * blocks  # what the aio engine was asked
    assert reads["reads"] == steps * gas * 2 * nv.n_groups
    assert nv.stats["group_write_bytes"] == steps * blocks  # one refresh a group a step
    assert len(list((tmp_path / "params").iterdir())) == nv.n_groups


def test_infinity_gas2_checkpoint_resume_is_bit_for_bit(tmp_path):
    batches = _batches(4, gas=2, seed=9)
    a = _port(_config(_stream("nvme", 2, str(tmp_path / "a")), bf16=True, gas=2))
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ck"), tag="t")
    ref = [float(a.train_batch(b)) for b in batches[2:]]
    b_eng = _port(_config(_stream("nvme", 2, str(tmp_path / "b")), bf16=True, gas=2), seed=5)
    path, _ = b_eng.load_checkpoint(str(tmp_path / "ck"), tag="t")
    assert path is not None and b_eng.global_steps == 2
    assert [float(b_eng.train_batch(b)) for b in batches[2:]] == ref
    sa, sb = a._host_opt.state_dict(), b_eng._host_opt.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("optimizer,params,in_memory,streaming", [
    ("Adam", {}, True, False), ("Adam", {"adam_w_mode": False}, False, False),
    ("AdamW", {}, True, True), (None, {}, True, True)],
    ids=["adam", "adam_l2", "adamw", "unnamed"])
def test_decoupled_weight_decay_follows_the_jax_engines(optimizer, params, in_memory, streaming):
    """A kept difference (ROADMAP C4): under ``Adam`` with weight decay the
    in-memory offload engine decays the weights apart from the gradient
    (``adam_w_mode``, default true) while the streaming engine adds the
    decay to the gradient, as the JAX package's two engines do."""
    config = _config({"offload_optimizer": {"device": "cpu"}})
    config.pop("optimizer")
    if optimizer is not None:
        config["optimizer"] = {"type": optimizer, "params": {"lr": LR, "weight_decay": 0.1, **params}}
    stream = {**config, "zero_optimization": _stream()}
    model_fn, init_fn, tp_fn = jgpt2.make_model(JCFG)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    got = []
    for c in (config, stream):
        jeng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=0),
                                            config=c, mesh=mesh, tp_spec_fn=tp_fn)
        got.append((_port(c)._host_opt.opt.adamw_mode, jeng._host_opt.opt.adamw_mode))
    assert got == [(in_memory, in_memory), (streaming, streaming)]


def _unstreamable():
    return [("fp16", _config(_stream(), fp16=True)),
            ("tp", {**_config(_stream()), "mesh": {"model": 2}}),
            ("non_adam", _config(_stream(), optimizer="Lamb"))]


@pytest.mark.parametrize("name,config", _unstreamable(), ids=[n for n, _ in _unstreamable()])
def test_unstreamable_offload_param_refuses_when_it_would_not_fit(name, config, monkeypatch):
    monkeypatch.setenv("DS_TPU_HBM_BYTES", "1000")  # nothing fits
    with pytest.raises(RuntimeError, match="cannot stream"):
        _port(config)


def test_unstreamable_offload_param_falls_back_when_it_fits(monkeypatch):
    monkeypatch.setenv("DS_TPU_HBM_BYTES", str(10**12))
    e = _port(_config(_stream(), fp16=True))
    assert isinstance(e, DeepSpeedEngine)
    moe = dataclasses.replace(TCFG, n_experts=4)
    assert not tgpt2.make_model(moe)[0].stream_spec.supported
    assert isinstance(_port(_config(_stream()), cfg=moe), DeepSpeedEngine)


def test_offload_param_across_ranks_raises(monkeypatch):
    """Across ranks the stream is ported (its parts follow the fsdp axis;
    ``DS_OFFLOAD_SHARDS`` in one process streams as one rank, as in the JAX
    package); what still raises is a ``model`` axis (the engine itself,
    whatever ``initialize`` would fall back to), and MoE blocks and fp16."""
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig

    monkeypatch.setenv("DS_OFFLOAD_SHARDS", "2")
    e = _port(_config(_stream()))
    assert isinstance(e, ZeroInfinityEngine) and not e._masters_sharded
    model_fn, init_fn, _ = tgpt2.make_model(TCFG)
    with pytest.raises(NotImplementedError, match="model \\(TP\\)"):
        ZeroInfinityEngine(model=model_fn, params=init_fn(), device="cpu",
                           config=DeepSpeedConfig({**_config(_stream()), "mesh": {"model": 2}}))
    with pytest.raises(NotImplementedError, match="requires bf16"):
        ZeroInfinityEngine(model=model_fn, params=init_fn(), device="cpu",
                           config=DeepSpeedConfig(_config(_stream(), fp16=True)))
