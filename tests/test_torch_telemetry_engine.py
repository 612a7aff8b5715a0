"""The port's engines publishing into its telemetry plane against the JAX
engines publishing into theirs, on the CPU.

* Training: ``GPT2_TINY`` at T 128 (the flash branch: the JAX side's
  Pallas kernels interpreted, the port's plain versions), 3 ``train_batch``
  steps with the registry, a JSONL sink, the trace and the flops profiler
  armed, through ``deepspeed_tpu.initialize`` on a one-device mesh and
  ``deepspeed_tpu_torch.initialize``.  The metric names, every counter's
  value and every histogram's count must be equal, and the loss gauge
  within 1e-5 relative (the same f32 math in another summation order:
  the training trajectories agree to 2e-5, ``test_torch_training.py``).
* Serving: the same 4 requests through both paged ServingEngines with the
  registry and the trace armed: the same names, counters and histogram
  counts; the port's trace validates, holds one lane per request, and
  TTFT rebuilt from each lane's spans equals its ``serving/ttft_ms``
  sample within 1e-3 ms.
* The port alone: the counted step's ``matmul`` bucket is the analytic
  ``6 N`` count over the matmul weights exactly (activation
  checkpointing's recompute kept apart), the default registry-only plane
  reads no loss off the device, ``wall_clock_breakdown`` fences the
  timeline's compute phase, the sinks write their files.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu_torch
import deepspeed_tpu_torch.telemetry as ttel
from deepspeed_tpu.comm.mesh import make_mesh
from deepspeed_tpu.config.config import MeshConfig
from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.serving import ServingEngine as JServingEngine
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.telemetry.attribution import analytic_matmul_flops

LOSS_RTOL = 1e-5
TTFT_ATOL_MS = 1e-3
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_planes():
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


def _config(out, **extra):
    return {
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "steps_per_print": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "telemetry": {"enabled": True, "trace": True, "exporters": ["jsonl"],
                      "attribution": True, "output_path": str(out),
                      "export_interval_seconds": 60.0},
        "flops_profiler": {"enabled": True, "profile_step": 2},
        **extra,
    }


def _batch(vocab, T=128):
    return {"input_ids": np.random.default_rng(0).integers(0, vocab, (4, T), dtype=np.int32)}


def _tables(snapshot):
    names, counters, hists, gauges = set(), {}, {}, {}
    for m in snapshot["metrics"]:
        key = (m["name"], tuple(sorted(m["labels"].items())))
        names.add(m["name"])
        if m["kind"] == "counter":
            counters[key] = m["value"]
        elif m["kind"] == "histogram":
            hists[key] = m["count"]
        else:
            gauges[key] = m["value"]
    return names, counters, hists, gauges


def test_training_metrics_match_the_jax_engine(tmp_path):
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, n_positions=128)
    model_fn, init_fn, tp_fn = jgpt2.make_model(jcfg)
    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                        config=_config(tmp_path / "j"), mesh=mesh,
                                        tp_spec_fn=tp_fn)
    for _ in range(STEPS):
        jeng.train_batch(_batch(jcfg.vocab_size))
    want = _tables(jtel.get_registry().snapshot())

    tcfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=128)
    model_fn, init_fn, _ = tgpt2.make_model(tcfg)
    teng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                              config=_config(tmp_path / "t"), device="cpu")
    for _ in range(STEPS):
        teng.train_batch(_batch(tcfg.vocab_size))
    got = _tables(ttel.get_registry().snapshot())

    assert got[0] == want[0]  # names
    assert got[1] == want[1]  # every counter's value
    assert got[2] == want[2]  # every histogram's count
    loss = (("train/loss", (("engine", "train"),)))
    assert got[3][loss] == pytest.approx(want[3][loss], rel=LOSS_RTOL)
    assert got[3][("train/samples", (("engine", "train"),))] == 12

    # the sinks and the trace
    ttel.flush()
    files = set(os.listdir(tmp_path / "t"))
    assert "metrics_rank0.jsonl" in files
    rec = json.loads(open(tmp_path / "t" / "metrics_rank0.jsonl").readline())
    assert rec["rank"] == 0 and rec["metrics"]
    path = ttel.export_trace()
    doc = json.load(open(path))
    assert path == str(tmp_path / "t" / "trace.json")
    assert ttel.validate_chrome_trace(doc) == []
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sum(e["name"] == "train/compute" for e in spans) == STEPS
    assert sum(e["name"] == "train/data_wait" for e in spans) == STEPS
    # the flops profiler read the counted step's cost at its step
    res = teng.flops_profiler.results
    assert res["step"] == 2 and res["flops_per_step"] == teng.train_step_attribution().total_flops()


def _requests():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 512, int(n), dtype=np.int32) for n in (5, 19, 11, 27)]


def _serve(srv):
    rids = [srv.submit(p, max_new_tokens=6) for p in _requests()]
    srv.step()
    res = srv.drain(max_steps=400)
    return [np.asarray(res[r].tokens()) for r in rids], rids


def test_serving_metrics_and_request_spans_match_the_jax_engine():
    block = {"enabled": True, "trace": True}
    kv = {"enabled": True, "page_len": 16}
    conf = dict(num_slots=2, prefill_chunk=8, max_len=64, kvcache=kv)
    jcfg = dataclasses.replace(jgpt2.GPT2_TINY, remat=False)
    params = jgpt2.init_params(jcfg, seed=7)

    jtel.configure(block, label="serving")
    jeng = deepspeed_tpu.init_inference(model_config=jcfg, params=params,
                                        dtype=jax.numpy.float32,
                                        max_out_tokens=jcfg.n_positions)
    want_tokens, _ = _serve(JServingEngine(jeng, **conf))
    want = _tables(jtel.get_registry().snapshot())

    ttel.configure(block, label="serving")
    srv = deepspeed_tpu_torch.init_serving(
        model_config=tgpt2.GPT2_TINY, params=params, dtype=torch.float32, device="cpu",
        max_out_tokens=tgpt2.GPT2_TINY.n_positions, serving=conf)
    got_tokens, rids = _serve(srv)
    got = _tables(ttel.get_registry().snapshot())
    for a, b in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(a, b)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert got[1][("serving/submitted", (("engine", "serving"),))] == 4

    events = ttel.get_tracer().events()
    assert ttel.validate_chrome_trace({"traceEvents": events}) == []
    lanes = {}
    for e in events:
        if e["pid"] == ttel.PID_REQUESTS and e["ph"] == "X":
            lanes.setdefault(e["tid"], {})[e["name"]] = e
    assert sorted(lanes) == sorted(rids)
    rebuilt = sorted((lane["prefill"]["ts"] + lane["prefill"]["dur"] - lane["queue"]["ts"]) / 1e3
                     for lane in lanes.values())
    ttft = ttel.get_registry().histogram("serving/ttft_ms", engine="serving")
    np.testing.assert_allclose(rebuilt, sorted(ttft._ring), atol=TTFT_ATOL_MS, rtol=0)
    assert all({"queue", "prefill", "decode", "prefill_chunk"} <= set(lane) for lane in lanes.values())


def _tiny_engine(config, n_positions=128):
    cfg = dataclasses.replace(tgpt2.GPT2_TINY, n_positions=n_positions)
    model_fn, init_fn, _ = tgpt2.make_model(cfg)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=3),
                                             config=config, device="cpu")
    return cfg, eng


def test_counted_step_matmul_bucket_is_the_analytic_count():
    cfg, eng = _tiny_engine({"train_micro_batch_size_per_gpu": 2,
                             "gradient_accumulation_steps": 2,
                             "telemetry": {"attribution": True},
                             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    eng.train_batch(_batch(cfg.vocab_size))
    attr = eng.train_step_attribution()
    d = cfg.n_embd
    # the matmul weights: the tied head and each block's four matrices
    n_matmul = cfg.vocab_size * d + cfg.n_layer * (3 * d * d + d * d + 2 * 4 * d * d)
    tokens = 4 * 128
    assert attr.buckets["matmul"].flops == analytic_matmul_flops(n_matmul, tokens)
    # the blocks' forward again in the backward, kept apart: qkv, proj and
    # fc (torch's checkpoint stops recomputing once the saved tensors the
    # backward needs are back, before the output projection)
    recomputed = cfg.n_layer * (3 * d * d + d * d + 4 * d * d)
    assert attr.meta["recompute"]["matmul"]["flops"] == 2 * recomputed * tokens
    assert attr.buckets["attention"].flops > 0 and attr.buckets["optimizer-update"].bytes > 0
    assert attr.total_flops() == attr.module_flops
    tm = eng.telemetry
    assert tm.step_cost()["flops"] == attr.total_flops()
    assert ttel.get_registry().gauge("flops_per_step", engine="train").value == attr.total_flops()
    assert "matmul" in attr.format_table() and attr.to_record()["label"] == "train_step"


def test_registry_only_default_reads_no_loss_and_breakdown_fences(tmp_path, monkeypatch):
    """The default plane (registry only) publishes progress without the
    loss: at every step, each a ``steps_per_print`` step, no tensor is read
    on the host (not the loss, not the loss scale), and no throughput
    timer waits for the device; ``wall_clock_breakdown`` reads the loss
    and fences the timeline's compute phase."""
    reads = []
    for host_read in ("__float__", "__bool__", "item"):
        real = getattr(torch.Tensor, host_read)
        monkeypatch.setattr(torch.Tensor, host_read,
                            lambda t, *a, _real=real: reads.append(t) or _real(t, *a))
    batch = {"input_ids": _batch(512)["input_ids"][:2]}

    def run(extra):
        cfg, eng = _tiny_engine({"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1,
                                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **extra})
        reads.clear()
        losses = [eng.train_batch(batch) for _ in range(2)]
        scale_reads = sum(r is eng.loss_scale_state.scale for r in reads)
        return eng, sum(any(r is x for x in losses) for r in reads), scale_reads

    eng, loss_reads, scale_reads = run({})
    names = {m.name for m in ttel.get_registry().metrics()}
    assert {"train/lr", "train/samples", "train/step_wall_ms", "train/steps",
            "train/loss_scale"} <= names
    assert "train/loss" not in names and loss_reads == 0
    assert scale_reads == 0 and eng.tput_timer is None
    assert ttel.get_registry().gauge("train/loss_scale", engine="train").value == 1.0
    assert eng.timeline.summary()["compute_ms"] == 0.0  # unfenced: omitted

    eng, loss_reads, scale_reads = run({"wall_clock_breakdown": True,
                                        "tensorboard": {"enabled": True,
                                                        "output_path": str(tmp_path)}})
    assert loss_reads == 2 and scale_reads == 2 and eng.tput_timer is not None
    assert eng.timeline.summary()["compute_ms"] > 0.0
    assert ttel.get_registry().gauge("train/loss", engine="train").value is not None
    eng.monitor.close()
    assert os.listdir(tmp_path / "DeepSpeedJobName")


def test_initialize_refuses_aggregate_naming_supervision():
    with pytest.raises(NotImplementedError, match="A14 resilience/supervision/"):
        _tiny_engine({"train_micro_batch_size_per_gpu": 2,
                      "telemetry": {"enabled": True, "aggregate": True}})


def test_timed_window_buckets_the_ops_the_counted_step_buckets():
    """One membership for both halves of the attribution: a tiny GPT-2
    step counted, the next one timed; each bucket's profiler ranges in the
    timed window hold the same aten ops, as many times, as the counted
    step put in that bucket (forward, backward, recompute and the
    optimizer), so a bucket's device ms and its counted bytes cover the
    same work."""
    from deepspeed_tpu_torch.telemetry import attribution

    cfg, eng = _tiny_engine({"train_micro_batch_size_per_gpu": 2,
                             "gradient_accumulation_steps": 2,
                             "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    batch = _batch(cfg.vocab_size)
    with attribution.counting("train_step") as count:
        eng.train_batch(batch)
    with attribution.timing() as win:
        eng.train_batch(batch)
    assert not win.refused
    timed = win.timing["ops_by_bucket"]
    for bucket in attribution.BUCKETS:
        assert dict(timed[bucket]) == dict(count.ops_by_bucket[bucket]), bucket
    # the attention module's plain ops (its matmuls included) are attention's
    assert timed["attention"]["bmm"] > 0 or timed["attention"]["matmul"] > 0
    assert timed["matmul"] and timed["optimizer-update"]
