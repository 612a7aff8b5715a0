"""The port's telemetry modules (deepspeed_tpu_torch.telemetry, utils.monitor,
utils.timer, profiling.flops_profiler) against the JAX package's, on the
CPU.

The same seeded sequence of observations, spans and exports goes through
both: the registry snapshots (timestamps aside) and compact snapshots,
the Prometheus text (its header line, which carries the time, aside),
the JSONL records, the trace's events (timestamps aside, both buffers'
own clocks), the schema check's verdicts, ``bench_diff``'s verdicts,
the anomaly checks and the cross-rank aggregation must be equal, exactly.
The monitor's two branches (TensorBoard's writer, and JSONL events when
``torch.utils.tensorboard`` does not import) write the same tags as the
JAX monitor's.  The config blocks parse and refuse as the JAX package's
(``telemetry.aggregate: true`` refused, naming ROADMAP A14 supervision).
The counted step's buckets are checked against shapes worked out by hand
(exact), and a device span's placement against fake CUDA events.
"""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu_torch.telemetry as ttel
from deepspeed_tpu.config.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.config.config import DeepSpeedConfigError as JError
from deepspeed_tpu.telemetry import aggregate as jagg
from deepspeed_tpu.telemetry import exporters as jexp
from deepspeed_tpu.telemetry import regression as jreg
from deepspeed_tpu.telemetry import spans as jspans
from deepspeed_tpu.utils.monitor import TensorBoardMonitor as JMonitor
from deepspeed_tpu_torch.config.config import DeepSpeedConfig as TConfig
from deepspeed_tpu_torch.config.config import DeepSpeedConfigError as TError
from deepspeed_tpu_torch.ops import kernels as tkernels
from deepspeed_tpu_torch.telemetry import aggregate as tagg
from deepspeed_tpu_torch.telemetry import attribution as tattr
from deepspeed_tpu_torch.telemetry import exporters as texp
from deepspeed_tpu_torch.telemetry import regression as treg
from deepspeed_tpu_torch.telemetry import spans as tspans
from deepspeed_tpu_torch.utils.monitor import TensorBoardMonitor as TMonitor
from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer, ThroughputTimer


@pytest.fixture(autouse=True)
def _fresh_planes():
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()


def _drive(reg, seed=0):
    """One seeded sequence of updates: counters, gauges, histograms (with
    multiplicity), labels, a ring resize, a disabled stretch."""
    rng = np.random.default_rng(seed)
    reg.configure(enabled=True, ring=32, rank=3)
    c = reg.counter("serving/finished", reason="eos")
    g = reg.gauge("train/loss", engine="train")
    h = reg.histogram("serving/ttft_ms", engine="serving")
    for i in range(200):
        v = float(np.round(rng.random() * 100, 6))
        c.inc()
        g.set(v)
        h.observe(v, n=int(rng.integers(1, 3)))
        if i % 7 == 0:
            reg.counter("comm/decisions", site="grad-exchange", strategy="dense").inc(2)
        if i == 100:
            reg.configure(ring=16)
        if i == 150:
            reg.configure(enabled=False)
        if i == 160:
            reg.configure(enabled=True)
    reg.set_step(42)
    reg.gauge("mfu", engine="train")  # created, never set
    return reg


def _snap(reg):
    s = reg.snapshot()
    s.pop("ts")
    return s


def test_registry_snapshots_and_compact_match_jax():
    j = _drive(jtel.MetricsRegistry())
    t = _drive(ttel.MetricsRegistry())
    assert _snap(t) == _snap(j)
    assert t.snapshot_compact() == j.snapshot_compact()
    jh, th = (r.histogram("serving/ttft_ms", engine="serving") for r in (j, t))
    for q in (0, 50, 90, 99, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert th.window_mean() == jh.window_mean() and th.mean() == jh.mean()
    assert t.size() == j.size()


def test_registry_updates_are_thread_safe():
    """The registry's locking: eight threads updating one counter and one
    histogram lose no update (the async writer's and the router's
    threads publish concurrently)."""
    reg = ttel.MetricsRegistry(enabled=True)

    def work():
        for _ in range(2000):
            reg.counter("x").inc()
            reg.histogram("h").observe(1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert reg.counter("x").value == 16000 and reg.histogram("h").count == 16000


def test_prometheus_and_jsonl_exports_match_jax(tmp_path):
    j = _drive(jtel.MetricsRegistry())
    t = _drive(ttel.MetricsRegistry())
    outs = {}
    for side, reg, mod in (("j", j, jexp), ("t", t, texp)):
        d = tmp_path / side
        loop = mod.ExportLoop(reg, [mod.JsonlExporter(str(d / "m.jsonl")),
                                    mod.PrometheusTextfileExporter(str(d / "m.prom"))],
                              interval_seconds=60.0)
        loop.flush()
        loop.flush()
        loop.stop()
        assert loop.exports == 3  # two flushes and the stop's
        prom = (d / "m.prom").read_text().splitlines()
        lines = [json.loads(x) for x in (d / "m.jsonl").read_text().splitlines()]
        for rec in lines:
            rec.pop("ts")
        outs[side] = (prom[1:], lines)
        assert prom[0].startswith("# deepspeed_tpu telemetry, ts=")
    assert outs["t"] == outs["j"]


def _trace(buf, t0):
    """Spans, instants and counters at fixed offsets from ``t0``."""
    buf.configure(enabled=True, max_events=1000)
    buf.add_span("queue", "serving.request", t0, t0 + 0.002, pid=1, tid=7,
                 args={"request": 7}, tid_name="request 7")
    buf.add_span("prefill", "serving.request", t0 + 0.002, t0 + 0.010, pid=1, tid=7)
    buf.add_instant("retire", "serving.request", ts=t0 + 0.02, pid=1, tid=7,
                    args={"request": 7, "finish_reason": "length"})
    buf.add_counter("attribution/train_step/time_share_pct", {"matmul": 80.0, "attention": 20.0},
                    ts=t0 + 0.001)
    with buf.span("train/compile", "train"):
        pass
    buf.add_span("ckpt_commit", "checkpoint", t0, t0 + 1.0, pid=2, args={"tag": "s1", "ok": True})
    for i in range(1200):  # ring eviction: the name rows survive it
        buf.add_instant("comm_decision", "comm", ts=t0 + i * 1e-6, args={"i": i})
    return buf


def _untimed(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_trace_events_and_schema_match_jax(tmp_path):
    jb, tb = jspans.TraceBuffer(), tspans.TraceBuffer()
    j = _trace(jb, jb.epoch + 1.0)
    t = _trace(tb, tb.epoch + 1.0)
    assert _untimed(t.events()) == _untimed(j.events())
    assert t.dropped == j.dropped == 206
    doc = json.loads(open(t.export(str(tmp_path / "trace.json"), metadata={"run": 1})).read())
    assert tspans.validate_chrome_trace(doc) == [] == jspans.validate_chrome_trace(doc)
    assert doc["otherData"]["run"] == 1 and doc["displayTimeUnit"] == "ms"
    bad = [
        [],
        {"traceEvents": 3},
        {"traceEvents": [{"ph": "Q", "name": "x", "pid": 0, "tid": 0}]},
        {"traceEvents": [{"ph": "X", "name": "", "pid": "0", "tid": 0, "ts": -1, "dur": -2}]},
        {"traceEvents": [{"ph": "i", "name": "x", "pid": 0, "tid": 0, "ts": 0, "cat": "c",
                          "s": "z"}]},
        {"traceEvents": [{"ph": "C", "name": "x", "pid": 0, "tid": 0, "ts": 0, "args": {}}]},
    ]
    for b in bad:
        assert tspans.validate_chrome_trace(b) == jspans.validate_chrome_trace(b) != []


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on a machine without a card:
    its "device time" is a number the test sets."""

    clock = [0.0]

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_device_span_takes_its_times_from_events(monkeypatch):
    """A span of work on the card gets its start and length from its CUDA
    events, placed on the buffer's clock at resolve time: not the host
    clock of the moment the launches were queued."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    buf = tspans.TraceBuffer(enabled=True)
    buf.epoch = 0.0
    start, end = _FakeEvent(), _FakeEvent()
    _FakeEvent.clock[0] = 5.0
    start.record()
    _FakeEvent.clock[0] = 5.25
    end.record()
    buf.add_device_span("train/compute", "train", start, end, tid=1, tid_name="card")
    assert [e for e in buf._events] == []  # nothing read before resolve
    _FakeEvent.clock[0] = 6.0  # the card reaches the resolve's mark 0.75 s after the span
    monkeypatch.setattr(buf, "now", lambda: 100.0)
    assert buf.resolve() == 1
    (ev,) = [e for e in buf.events() if e["ph"] == "X"]
    assert ev["dur"] == pytest.approx(250_000.0)
    assert ev["ts"] == pytest.approx((100.0 - 0.75 - 0.25) * 1e6)
    assert tspans.validate_chrome_trace({"traceEvents": buf.events()}) == []


def _history(seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for run in range(12):
        for metric, base in (("decode_tokens_per_s", 1000.0), ("step_ms", 50.0)):
            v = base * (1 + 0.02 * rng.standard_normal())
            if run == 11 and metric == "step_ms":
                v *= 1.3
            recs.append({"schema": 1, "kind": "bench", "ts": float(run), "run_id": f"r{run}",
                         "git_sha": "x", "rung": "r", "metric": metric, "value": float(v),
                         "unit": "ms" if metric == "step_ms" else "tok/s",
                         "backend": "cpu", "fingerprint": "f"})
    recs.append({"kind": "bless", "ts": 5.5, "metric": "decode_tokens_per_s"})
    return recs


def test_bench_diff_and_anomaly_checks_match_jax(tmp_path):
    h = _history()
    assert treg.bench_diff(h) == jreg.bench_diff(h)
    assert treg.bench_diff(h, window=4, band_cap=0.1) == jreg.bench_diff(h, window=4, band_cap=0.1)
    ok, bad = treg.gate(treg.bench_diff(h))
    assert (ok, bad) == jreg.gate(jreg.bench_diff(h)) and not ok
    assert treg.format_verdicts(treg.bench_diff(h)) == jreg.format_verdicts(jreg.bench_diff(h))
    for args in ((300.0, 100.0, 8), (200.0, 100.0, 8), (300.0, 100.0, 3), (1.0, None, 9)):
        assert treg.check_step_spike(*args) == jreg.check_step_spike(*args)
    latest = {0: {"train/step_wall_ms{engine=train}": 10.0},
              1: {"train/step_wall_ms{engine=train}": 30.0},
              2: {"train/step_wall_ms{engine=train}": 11.0}}
    assert treg.find_stragglers(latest, [0, 1, 2]) == jreg.find_stragglers(latest, [0, 1, 2])
    # the history file round trip, and a tool's record names the torch device
    path = str(tmp_path / "bench_history.jsonl")
    n = treg.history_append([{"metric": "m", "value": 1.0, "unit": "ms"}], rung="r", path=path,
                            sha="abc")
    assert n == 1 and treg.history_load(path)[0]["metric"] == "m"
    monkeypatch_env = os.environ.pop("DS_BENCH_CHILD", None)
    try:
        assert treg.tool_history_emit({"metric": "m2", "value": 2.0}, "r", base_dir=str(tmp_path))
    finally:
        if monkeypatch_env is not None:
            os.environ["DS_BENCH_CHILD"] = monkeypatch_env
    assert treg.history_load(path)[-1]["backend"] == "cpu"


def test_aggregation_encoding_matches_jax(tmp_path):
    compact = _drive(ttel.MetricsRegistry()).snapshot_compact()
    enc = tagg.encode_metrics(compact)
    assert enc == jagg.encode_metrics(compact) and " " not in enc
    assert tagg.decode_metrics(enc) == jagg.decode_metrics(enc) == compact
    assert tagg.decode_metrics("{bad") is None
    outs = []
    for mod, reg in ((jagg, jtel.MetricsRegistry(enabled=True)),
                     (tagg, ttel.MetricsRegistry(enabled=True))):
        agg = mod.CrossRankAggregator(3, jsonl_path=str(tmp_path / f"{mod.__name__}.jsonl"),
                                      registry=reg)
        agg.update(0, 1, {"train/step_wall_ms": 10.0})
        agg.update(1, 1, {"train/step_wall_ms": 30.0})
        agg.update(2, 1, {"train/step_wall_ms": 11.0})
        agg.mark_dead(2, "beat timeout")
        rec = agg.export_line()
        rec.pop("ts")
        outs.append((rec, reg.snapshot_compact()))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("branch", ["tensorboard", "jsonl"])
def test_monitor_branches_write_the_jax_tags(branch, tmp_path, monkeypatch):
    if branch == "jsonl":
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    written = {}
    for side, cls in (("j", JMonitor), ("t", TMonitor)):
        mon = cls(output_path=str(tmp_path / side), job_name="job", enabled=True)
        mon.write_events([("Train/Samples/lr", 1e-3), ("Train/Samples/train_loss", 2.5)], 16)
        mon.flush()
        mon.close()
        mon.close()  # idempotent
        files = os.listdir(tmp_path / side / "job")
        written[side] = files
        if branch == "jsonl":
            rows = [json.loads(x) for x in open(tmp_path / side / "job" / "events.jsonl")]
            written[side] = [(r["tag"], r["value"], r["step"]) for r in rows]
        else:
            assert mon._writer is not None and any(f.startswith("events.out.tfevents") for f in files)
            written[side] = len(files)
    assert written["t"] == written["j"]
    assert not TMonitor(output_path=str(tmp_path / "off"), enabled=True, rank=1).enabled


def test_timers_on_the_host_clock(caplog):
    timers = SynchronizedWallClockTimer(torch.device("cpu"))
    t = timers("train_batch")
    t.start()
    sum(range(10000))
    t.stop()
    assert t.elapsed(reset=False) > 0
    assert timers.get_mean(["train_batch", "absent"]).keys() == {"train_batch"}
    assert t.elapsed() == 0.0  # reset by the read above
    logged = []
    tput = ThroughputTimer(batch_size=4, start_step=0, steps_per_output=2, logging_fn=logged.append)
    for _ in range(4):
        tput.start()
        tput.stop()
    assert len(logged) == 2 and "RunningAvgSamplesPerSec" in logged[0]


TELEMETRY_BLOCKS = [
    None,
    {},
    {"enabled": False},
    {"enabled": True, "ring": 16, "exporters": "JSONL", "trace": True,
     "output_path": "/x", "trace_path": "/x/t.json", "trace_buffer_events": 1000,
     "profiler_dir": "/p", "profiler_capture_ms": 10, "slo_ttft_breach_ms": 5.0,
     "attribution": False, "attribution_max_hlo_mb": 1.0, "spike_factor": 3.0,
     "spike_min_window": 2, "straggler_factor": 2.0, "export_interval_seconds": 0.5},
]


@pytest.mark.parametrize("block", TELEMETRY_BLOCKS, ids=range(len(TELEMETRY_BLOCKS)))
def test_telemetry_and_monitor_blocks_parse_as_the_jax_package_does(block):
    d = {"train_batch_size": 8, "wall_clock_breakdown": block is not None,
         "tensorboard": {"enabled": True, "output_path": "tb", "job_name": "j"},
         "flops_profiler": {"enabled": True, "profile_step": 3, "detailed": False}}
    if block is not None:
        d["telemetry"] = {**block, "aggregate": False} if block else block
    j, t = JConfig(d, world_size=1), TConfig(d)
    jt, tt = dataclasses.asdict(j.telemetry), dataclasses.asdict(t.telemetry)
    given = d.get("telemetry") or {}
    for key in ("aggregate", "attribution"):
        if key not in given:
            # the JAX defaults: snapshots on the supervision heartbeat the
            # port lacks, and a compile-time walk the port runs as a counted
            # step, asked for
            assert jt.pop(key) is True and tt.pop(key) is False
    assert tt == jt
    assert dataclasses.asdict(t.tensorboard) == dataclasses.asdict(j.tensorboard)
    assert dataclasses.asdict(t.flops_profiler) == dataclasses.asdict(j.flops_profiler)
    assert t.wall_clock_breakdown == j.wall_clock_breakdown


@pytest.mark.parametrize("block", [
    {"telemetry": {"exporters": ["statsd"]}},
    {"telemetry": {"ring": 8}},
    {"telemetry": {"export_interval_seconds": 0}},
    {"telemetry": {"trace_buffer_events": 10}},
    {"telemetry": {"spike_factor": 1.0}},
    {"telemetry": {"rings": 16}},
    {"tensorboard": {"enable": True}},
    {"flops_profiler": {"profile": 1}},
], ids=range(8))
def test_telemetry_refusals_match_the_jax_package(block):
    d = {"train_batch_size": 8, **block}
    with pytest.raises(JError):
        JConfig(d, world_size=1)
    with pytest.raises(TError):
        TConfig(d)


def test_aggregate_refused_naming_supervision():
    d = {"train_batch_size": 8, "telemetry": {"enabled": True, "aggregate": True}}
    JConfig(d, world_size=1)
    with pytest.raises(NotImplementedError, match="A14 resilience/supervision/"):
        TConfig(d)


def test_counting_buckets_ops_by_shape_and_module():
    """The counted region: a matmul ``2 m k n``, a pointwise op one FLOP
    an element, views free; the ops of an attention module in its bucket;
    a hand kernel's reported cost in its kernel's bucket."""
    from deepspeed_tpu_torch.ops.attention import flash_attention as fa

    a, b = torch.randn(8, 16), torch.randn(16, 4)
    q = torch.randn(1, 2, 128, 16)
    with tattr.counting("t") as count:
        y = (a @ b).relu()
        y.t()
        fa.flash_fwd(q, q, q, causal=True)
        tkernels.count_launch("flash_fwd", "none/tc",
                              cost=lambda: fa.attention_cost("flash_fwd", q, q, True))
        tkernels.count_launch("fused_adam", cost=lambda: (24 * 10, 28 * 10))
    tkernels.reset_launches()
    attr = count.attribution("cpu")
    assert attr.buckets["matmul"].flops == 2 * 8 * 16 * 4
    # under inference_mode the mode sees the composite calls (serving)
    with torch.inference_mode(), tattr.counting("t") as inf:
        a @ b
        torch.einsum("ik,kj->ij", a, b)
        torch.nn.functional.linear(a, b.t())
        a.to(torch.float32).reshape(16, 8)  # handed back / a view: no traffic
    inf = inf.attribution("cpu")
    assert inf.buckets["matmul"].flops == 3 * 2 * 8 * 16 * 4
    assert inf.buckets["layernorm/other"].bytes == 0
    assert attr.buckets["matmul"].bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert attr.buckets["layernorm/other"].flops == 8 * 4  # relu; the view is free
    pairs = 128 * 129 / 2
    att = attr.buckets["attention"]
    assert att.launches == {"flash_fwd": 1}
    assert att.flops > 4 * 16 * pairs * 2  # the plain ops plus the reported launch
    assert attr.buckets["optimizer-update"].flops == 240
    assert fa.attention_cost("flash_fwd", q, q, True, lse=False) == (
        4 * 16 * pairs * 2, 4 * 2 * 128 * 16 * 4)
    assert attr.total_flops() == attr.module_flops and attr.unattributed_flops == 0
    rows = attr.roofline()
    assert {r["bucket"] for r in rows} == {"matmul", "attention", "optimizer-update",
                                           "layernorm/other"}
    assert abs(sum(r["min_time_share_pct"] for r in rows) - 100.0) < 0.1
    assert attr.roofline("NVIDIA A100-SXM4-80GB") == []  # no peaks: no roofline


def test_kernel_classes_and_busy_union():
    assert tattr.kernel_bucket("void flash_fwd_tc_kernel<64>(...)") == "attention"
    assert tattr.kernel_bucket("flash_decode_paged_kernel") == "attention"
    assert tattr.kernel_class("flash_decode_paged_kernel") == "flash_decode_paged"
    assert tattr.kernel_bucket("nvjet_tst_128x64_64x4") == "matmul"
    assert tattr.kernel_bucket("fused_adam_kernel") == "optimizer-update"
    assert tattr.kernel_bucket("ncclDevKernel_AllReduce") == "comm-collective"
    assert tattr.kernel_bucket("vectorized_elementwise_kernel") == "layernorm/other"
    assert tattr.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_profiler_window_refused_while_another_records(tmp_path):
    """One profiler at a time: the manager's window is refused (counted)
    while a torch.profiler records, and opens, then writes its trace,
    once it stopped."""
    tm = ttel.configure({"enabled": True, "profiler_dir": str(tmp_path), "profiler_capture_ms": 1},
                        label="train")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tattr.profiler_active()
        assert not tm.capture_profile("test")
    assert tm.counter("profiler_refusals").value == 1
    assert tm.capture_profile("test")
    torch.ones(4).sum()
    path = tm.poll_profile(force=True)
    assert path is not None and os.path.exists(path)
    assert not tm.capture_profile("again")  # one shot
    assert ttel.status()["enabled"]


def test_bucket_times_takes_each_kernel_by_its_launching_ops_range():
    """The timed half's membership on stand-in profiler events: a kernel
    under an op recorded inside its range, or around the dispatch
    mode's handler (its own range opened inside it), takes that range's
    bucket; a hand kernel takes its name's; a kernel no op holds falls
    back to its name and counts as unranged; the buckets sum to the
    kernels' time."""
    from types import SimpleNamespace as NS

    from deepspeed_tpu_torch.telemetry import attribution as at

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev=cpu, start=0.0, end=1.0, kernels=(), parent=None):
        e = NS(name=name, device_type=dev, cpu_parent=parent, cpu_children=[],
               kernels=list(kernels), is_async=False,
               time_range=NS(start=start, end=end, elapsed_us=lambda: end - start))
        if parent is not None:
            parent.cpu_children.append(e)
        return e

    def k(name, us):
        return NS(name=name, device=0, duration=us)

    rng = ev(at.RANGE + "attention")
    inner = ev("aten::bmm", parent=rng, kernels=[k("nvjet_tst_gemm", 4.0)])
    outer = ev("aten::add_", kernels=[k("vectorized_elementwise_kernel", 2.0)])
    mode = ev("PythonDispatchMode", parent=outer)
    own = ev(at.RANGE + "optimizer-update", parent=mode)
    # the profiler's own event nested in the op repeats the op's kernels
    loading = ev("Lazy Function Loading", parent=inner, kernels=[k("nvjet_tst_gemm", 4.0)])
    node = ev("FlashBackward", kernels=[k("flash_bwd_tc_kernel", 8.0)])
    kernels = [ev("nvjet_tst_gemm", cuda, 0, 4), ev("vectorized_elementwise_kernel", cuda, 4, 6),
               ev("flash_bwd_tc_kernel", cuda, 6, 14), ev("nvjet_tst_gemm", cuda, 14, 15)]
    # the range shows on the card too, as an annotation over its kernels
    note = ev(at.RANGE + "attention", cuda, 0, 4)
    note.is_user_annotation = True
    t = at.bucket_times([rng, inner, loading, outer, mode, own, node, *kernels, note])
    ms = t["device_ms"]
    assert ms["attention"] == pytest.approx(12.0 / 1e3)  # the GEMM in its range, B2
    assert ms["optimizer-update"] == pytest.approx(2.0 / 1e3)
    assert ms["matmul"] == pytest.approx(1.0 / 1e3)  # the GEMM no op holds
    assert sum(ms.values()) == pytest.approx(t["kernels_ms"]) and t["kernels_ms"] == 0.015
    assert t["unranged_kernels"] == 1
    assert t["kernel_events"]["attention"] == 2 and t["launches_by_class"]["gemm"] == 2
    assert dict(t["ops_by_bucket"]["attention"]) == {"bmm": 1}
