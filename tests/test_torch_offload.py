"""ZeRO-Offload in the port (``offload_optimizer`` ``cpu`` / ``nvme``)
against the JAX package, on the CPU: the host kernels (built with ``g++``
here as on the card's host), the aio engine, the swappers, the host
optimizer and the offload engine.

Tolerances:
* The host Adam and its cast are the JAX package's C++ at the same flags:
  bit for bit (``assert_array_equal``), whatever the thread count.  Against
  ``adam_update_reference`` (another order of the same f32 arithmetic):
  ``tests/test_offload.py``'s rtol 1e-5, atol 1e-6.
* ``HostOffloadOptimizer`` on the same leaves and gradients: bit for bit.
* The offload engine against the JAX engine with offload (f32, three
  steps of GPT2_TINY at T 64): losses 2e-5 relative, ``grad_norm`` 1e-6
  relative (the port reduces the norm in f32 on the device, the JAX
  engine in f64 on the host, over gradients of two frameworks; read
  8.4e-8), final masters 1e-5 absolute (``test_torch_training.py``'s f32
  bounds).
* Resume and ``nvme`` against ``cpu``: bit for bit.
"""
import dataclasses
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
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JCPUAdam
from deepspeed_tpu.runtime.zero.offload import HostOffloadOptimizer as JHostOpt
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.ops.adam import cpu_adam
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, fp32_to_bf16
from deepspeed_tpu_torch.ops.aio.aio import AioHandle
from deepspeed_tpu_torch.ops.kernels.fused_update import adam_update_reference
from deepspeed_tpu_torch.runtime.engine import tree_flatten, tree_items
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 2e-5, 1e-6, 1e-5
T = 64


# ---------------------------------------------------------------------------
# host kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adamw", [False, True], ids=["adam", "adamw"])
def test_host_adam_is_the_jax_kernel_bit_for_bit(adamw):
    rng = np.random.default_rng(0)
    n = 10_001  # odd: the vector loops' tails
    p = rng.standard_normal(n).astype(np.float32)
    state = {"jax": [p.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)]}
    for threads in (1, 3):
        state[threads] = [torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)]
    ref = [torch.from_numpy(p.copy()), torch.zeros(n), torch.zeros(n)]
    jopt = JCPUAdam(lr=1e-2, weight_decay=0.01, adamw_mode=adamw)
    assert jopt.uses_native
    opts = {t: DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01, adamw_mode=adamw, num_threads=t)
            for t in (1, 3)}
    for step in range(1, 4):
        g = rng.standard_normal(n).astype(np.float32)
        jopt.step(*state["jax"][:1], g, *state["jax"][1:], step)
        for t, opt in opts.items():
            opt.step(state[t][0], torch.from_numpy(g), state[t][1], state[t][2], step)
        c1, c2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        ref = adam_update_reference(ref[0], torch.from_numpy(g), ref[1], ref[2], 1e-2, 0.9, 0.999,
                                    1e-8, 0.01, adamw, c1, c2)
    for t in (1, 3):
        for got, want in zip(state[t], state["jax"]):
            np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(state[1], ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_host_cast_to_bf16_is_torchs_rounding():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(70_001).astype(np.float32) * 100)
    x[:4] = torch.tensor([float("inf"), float("-inf"), 3.0e38, -1e-40])
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    before = cpu_adam.counts()["ds_fp32_to_bf16"]
    fp32_to_bf16(x, out, num_threads=2)
    assert cpu_adam.counts()["ds_fp32_to_bf16"] == before + 1
    assert torch.equal(out.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))


# ---------------------------------------------------------------------------
# aio
# ---------------------------------------------------------------------------

def test_aio_round_trip_async_and_many_in_flight(tmp_path):
    h = AioHandle(block_size=4096, thread_count=4)
    data = torch.from_numpy(np.random.default_rng(0).standard_normal(100_000).astype(np.float32))
    h.async_pwrite(data, str(tmp_path / "x.bin"))
    assert h.wait() >= 1
    out = torch.empty_like(data)
    h.async_pread(out, str(tmp_path / "x.bin"))
    h.wait()
    assert torch.equal(out, data)
    arrays = [torch.full((5000,), float(i)) for i in range(16)]
    for i, a in enumerate(arrays):
        h.async_pwrite(a, str(tmp_path / f"f{i}.bin"))
    assert h.wait() == 16
    outs = [torch.empty_like(a) for a in arrays]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    h.wait()
    assert all(torch.equal(o, a) for o, a in zip(outs, arrays))


def test_aio_file_offset(tmp_path):
    h = AioHandle(thread_count=2)
    path = str(tmp_path / "off.bin")
    base = torch.arange(1000, dtype=torch.float32)
    h.sync_pwrite(base, path)
    h.sync_pwrite(torch.full((100,), -1.0), path, file_offset=400)
    out = torch.empty_like(base)
    h.sync_pread(out, path)
    assert torch.equal(out[:100], base[:100])
    assert torch.equal(out[100:200], torch.full((100,), -1.0))  # bytes 400-799
    assert torch.equal(out[200:], base[200:])


def test_aio_odirect_odd_sizes_and_offset(tmp_path):
    """Aligned, ragged and tiny requests and a nonzero offset through the
    O_DIRECT engine (a filesystem that refuses O_DIRECT runs them on the
    engine's thread pool: the bytes must be the same either way)."""
    h = AioHandle(block_size=1 << 18, queue_depth=16, thread_count=2)
    rng = np.random.default_rng(0)
    for n in (1 << 20, (1 << 20) + 13, 511):
        data = np.frombuffer(rng.bytes(n), np.uint8).copy()
        path = str(tmp_path / f"blob_{n}.bin")
        h.sync_pwrite(data, path)
        assert os.path.getsize(path) == n
        back = np.zeros_like(data)
        h.sync_pread(back, path)
        np.testing.assert_array_equal(back, data)
    data = np.frombuffer(rng.bytes(4096 + 7), np.uint8).copy()
    path = str(tmp_path / "off.bin")
    h.sync_pwrite(data, path, file_offset=512)
    back = np.zeros_like(data)
    h.sync_pread(back, path, file_offset=512)
    np.testing.assert_array_equal(back, data)
    assert isinstance(h.used_kernel_aio, bool)


# ---------------------------------------------------------------------------
# swappers
# ---------------------------------------------------------------------------

def test_async_swapper_read_after_write(tmp_path):
    from deepspeed_tpu_torch.runtime.swap.async_swapper import AsyncTensorSwapper

    sw = AsyncTensorSwapper(str(tmp_path))
    rng = np.random.default_rng(1)
    v1, v2 = (torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
              for _ in range(2))
    sw.swap_out("g0", v1, async_op=True)
    sw.swap_out("g0", v2, async_op=True)  # over a write that may be in flight
    out = sw.swap_in("g0", async_op=True)  # must read v2, not v1 or torn bytes
    sw.synchronize()
    assert torch.equal(out, v2)
    sw.swap_out("g1", v1, async_op=True)
    sw.swap_out("g0", v1, async_op=True)
    out1 = sw.swap_in("g1", async_op=True)
    sw.synchronize()
    assert torch.equal(out1, v1)
    assert torch.equal(sw.swap_in("g0", async_op=False), v1)
    sw.release("g0")
    with pytest.raises(KeyError):
        sw.swap_in("g0")


def test_pipelined_optimizer_swapper(tmp_path):
    from deepspeed_tpu_torch.runtime.swap.optimizer_swapper import PipelinedOptimizerSwapper

    shapes = [(100,), (50, 2), (7,)]
    sw = PipelinedOptimizerSwapper(str(tmp_path), shapes, pipeline=True)
    for step in range(3):
        for i in range(3):
            if i + 1 < 3:
                sw.prefetch(i + 1)
            bufs = sw.get(i)
            bufs["m"] += i + 1 + step
            bufs["v"] += 10 * (i + 1) + step
            sw.put(i)
        sw.flush()
        if step == 0:  # the first step's buffers, back for reuse
            first = {t.data_ptr() for v in sw._spare.values() for t in v}
    got = [sw.get(i) for i in range(3)]
    for i, bufs in enumerate(got):
        assert torch.equal(bufs["m"], torch.full(shapes[i], float(3 * (i + 1) + 3)))
        assert torch.equal(bufs["v"], torch.full(shapes[i], float(30 * (i + 1) + 3)))
    assert len(first) == 6 and {t.data_ptr() for b in got for t in b.values()} <= first


# ---------------------------------------------------------------------------
# the host optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_host_offload_optimizer_matches_jax(device, tmp_path):
    tree = jgpt2.init_params(jgpt2.GPT2_TINY, seed=1)
    items = tree_items(tgpt2.params_from_jax(tree))
    kw = dict(lr=1e-3, betas=(0.9, 0.95), weight_decay=0.1, adamw_mode=True)
    jopt = JHostOpt(tree, nvme_swap_dir=str(tmp_path / "j") if device == "nvme" else None, **kw)
    topt = HostOffloadOptimizer(items, nvme_swap_dir=str(tmp_path / "t") if device == "nvme"
                                else None, num_threads=2, **kw)
    assert topt.keys == jopt.keys
    rng = np.random.default_rng(2)
    for step in range(1, 4):
        grads = [rng.standard_normal(m.shape).astype(np.float32) for m in topt.masters]
        jopt.step(jax.tree.unflatten(jax.tree.structure(tree), grads), 1e-3, step)
        topt.step([torch.from_numpy(g) for g in grads], 1e-3, step)
    want, got = jopt.state_dict(), topt.state_dict()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the offload engine
# ---------------------------------------------------------------------------

def _config(offload=None, bf16=False, fp16=None, optimizer="AdamW"):
    c = {
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "bf16": {"enabled": bf16},
        "optimizer": {"type": optimizer, "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 10, "warmup_num_steps": 2, "warmup_min_lr": 1e-4,
            "warmup_max_lr": 1e-3}},
        "steps_per_print": 1000,
    }
    if offload is not None:
        c["zero_optimization"] = {"offload_optimizer": offload}
    if fp16 is not None:
        c["fp16"] = fp16
    return c


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 512, (4, T), dtype=np.int32)} for _ in range(n)]


def _port(config, seed=3):
    torch.use_deterministic_algorithms(True)
    model_fn, init_fn, _ = tgpt2.make_model(dataclasses.replace(tgpt2.GPT2_TINY))
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=seed),
                                             config=config, device="cpu")
    return eng


def _flat(tree):
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)
            for x in tree_flatten(tree)[0]]


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_engine_matches_jax_offload_engine(device, tmp_path):
    def off(side):  # each engine its own swap folder
        return {"device": device, **({"nvme_path": str(tmp_path / side)} if device == "nvme" else {})}

    model_fn, init_fn, tp_fn = jgpt2.make_model(jgpt2.GPT2_TINY)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                        config=_config(off("jax")), mesh=mesh, tp_spec_fn=tp_fn)
    teng = _port(_config(off("port")))
    assert teng._host_opt is not None and teng.opt_state is None
    jl, tl, jn, tn = [], [], [], []
    for b in _batches(3):
        jl.append(float(jeng.train_batch(b)))
        jn.append(float(jeng._last_info["grad_norm"]) if hasattr(jeng, "_last_info")
                  else None)
        tl.append(float(teng.train_batch(b)))
        tn.append(float(teng._last_info["grad_norm"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    if jn[0] is not None:
        np.testing.assert_allclose(tn, jn, rtol=NORM_RTOL)
    jm = jeng._host_opt.masters
    for a, b in zip([m.numpy() for m in teng._host_opt.masters], jm):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)
    assert teng.global_steps == jeng.global_steps == 3
    if device == "nvme":
        assert os.listdir(os.path.join(str(tmp_path / "port"), "zero_infinity_swap", "optimizer"))


def test_offload_engine_holds_compute_params_and_follows_the_device_engine():
    """bf16: the device keeps bf16 parameters (no masters, no moments);
    the first loss is the in-memory engine's bit for bit, and the run
    stays within test_torch_training.py's bf16 bounds of it."""
    dev, off = _port(_config(bf16=True)), _port(_config({"device": "cpu"}, bf16=True))
    assert all(p.dtype == torch.bfloat16 for p in off._params)
    assert all(m.dtype == torch.float32 and m.device.type == "cpu" for m in off._host_opt.masters)
    dl, ol = zip(*[(float(dev.train_batch(b)), float(off.train_batch(b))) for b in _batches(4)])
    assert dl[0] == ol[0]
    np.testing.assert_allclose(ol, dl, rtol=1e-3)
    errs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(_flat(off.params), _flat(dev.params))])
    assert errs.mean() <= 1e-4 and errs.max() <= 2 * 4e-3


def test_offload_fp16_overflow_skips_the_step():
    """fp16 with a loss scale of 2**40: the scaled gradients overflow, the
    host step is skipped (masters untouched), the scale is cut, as the
    in-memory engine does."""
    fp16 = {"enabled": True, "initial_scale_power": 40, "hysteresis": 1}
    off = _port(_config({"device": "cpu"}, fp16=fp16))
    dev = _port(_config(fp16=fp16))
    before = [m.clone() for m in off._host_opt.masters]
    b = _batches(1)[0]
    off.train_batch(b)
    dev.train_batch(b)
    assert bool(off._last_info["overflow"]) and bool(dev._last_info["overflow"])
    assert off.skipped_steps == dev.skipped_steps == 1 and off.global_steps == 0
    assert off.loss_scale == dev.loss_scale < 2.0 ** 40
    assert all(torch.equal(a, m) for a, m in zip(before, off._host_opt.masters))


@pytest.mark.parametrize("device", ["cpu", "nvme"])
def test_offload_checkpoint_resume_is_bit_for_bit(device, tmp_path):
    off = {"device": device, **({"nvme_path": str(tmp_path / "swap")} if device == "nvme" else {})}
    batches = _batches(4, seed=5)
    a = _port(_config(off, bf16=True))
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path / "ck"), tag="t")
    ref = [float(a.train_batch(b)) for b in batches[2:]]
    b_eng = _port(_config(off, bf16=True), seed=9)
    path, _ = b_eng.load_checkpoint(str(tmp_path / "ck"), tag="t")
    assert path is not None and b_eng.global_steps == 2
    got = [float(b_eng.train_batch(b)) for b in batches[2:]]
    assert got == ref
    sa, sb = a._host_opt.state_dict(), b_eng._host_opt.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert all(torch.equal(x, y) for x, y in zip(a._params, b_eng._params))


def test_non_offload_tag_loads_into_offload_engine(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.runtime import checkpointing

    dev = _port(_config())
    dev.train_batch(_batches(1)[0])
    dev.save_checkpoint(str(tmp_path / "ck"), tag="t")
    off = _port(_config({"device": "cpu"}), seed=9)
    seen = []
    monkeypatch.setattr(checkpointing.logger, "warning", lambda msg, *a, **k: seen.append(msg))
    path, _ = off.load_checkpoint(str(tmp_path / "ck"), tag="t")
    assert path is not None and off.global_steps == 1
    assert any("moments are being RESET" in m for m in seen)
    for a, b in zip(_flat(off.params), _flat(dev.params)):
        np.testing.assert_array_equal(a, b)
    assert all(float(t.abs().max()) == 0.0 for k, t in off._host_opt.state_dict().items()
               if not k.startswith("master/"))
    off.train_batch(_batches(1)[0])
    assert off.global_steps == 2
    off.save_checkpoint(str(tmp_path / "ck2"), tag="o")
    with pytest.raises(ValueError, match="does not match"):  # no opt_state in an offload tag
        _port(_config()).load_checkpoint(str(tmp_path / "ck2"), tag="o")


def test_offload_refusals(monkeypatch):
    from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam

    model_fn, init_fn, _ = tgpt2.make_model(tgpt2.GPT2_TINY)
    with pytest.raises(ValueError, match="client optimizer"):
        deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(),
                                       config=_config({"device": "cpu"}),
                                       optimizer=FusedAdam(lr=1e-3), device="cpu")
    with pytest.raises(ValueError, match="Adam/AdamW"):
        _port(_config({"device": "cpu"}, optimizer="Lamb"))
    # DS_OFFLOAD_SHARDS (the JAX package's simulated hosts) is accepted:
    # two flat slices, each half of the padded masters
    monkeypatch.setenv("DS_OFFLOAD_SHARDS", "2")
    two = _port(_config({"device": "cpu"}))
    assert two._offload_shards == 2 and len(two._host_opts) == 2
    n = sum(m.numel() for m in two._masters_full)
    assert two.host_master_bytes() == 4 * (n + n % 2)
    monkeypatch.delenv("DS_OFFLOAD_SHARDS")
    with pytest.raises(ValueError, match="nvme_path"):
        _port(_config({"device": "nvme"}))


def test_pipeline_engine_refuses_offload_optimizer():
    from deepspeed_tpu_torch.config.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

    cfg = DeepSpeedConfig({"train_batch_size": 4, "zero_optimization":
                           {"offload_optimizer": {"device": "cpu"}}})
    with pytest.raises(NotImplementedError, match="pipeline engine"):
        PipelineEngine(module=None, config=cfg, device="cpu")
