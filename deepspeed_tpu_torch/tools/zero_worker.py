"""One rank of a ZeRO, tensor- or sequence-parallel training run: trains
the cases of a JSON spec and writes what each produced.

Run it once per rank under a launcher environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; or the
spec's ``init_method``, such as ``file:///tmp/store`` for ranks on one
host)::

    RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29511 \\
        python -m deepspeed_tpu_torch.tools.zero_worker spec.json

It imports torch and the port only.  The spec::

    {"device": "cpu" | "cuda", "backend": null | "gloo" | "nccl",
     "init_method": null, "deterministic": true,
     "threads": 1, "out": "<dir>", "collectives_check": false,
     "tp_ops_check": false, "seq_attention_check": null | "<npz: q, k, v, do>",
     "compressed_check": null | "<npz: x, werr, serr, each (n, M)>",
     "cases": [{"name": "s2", "model": "gpt2" | "bert", "preset": "tiny",
                "model_cfg": {...}, "init_seed": 3, "config": {...},
                "batches": "<npz: key -> (steps, global batch, ...)>"
                  | "synthetic": {"seed": 0, "T": 1024},
                "steps": 3, "first_batch": 0, "load": {"dir": ..., "tag": ...},
                "save": {"dir": ..., "tag": ..., "after": 2 (0: before any step)},
                "sigterm": {"rank": 0, "after": 1},
                "reload": {"dir": ..., "tag": ..., "after": 3},
                "record_step": null | 1, "profile_step": null | 2,
                "nearest_rounding": false,
                "record": "full" | "digest" | "none"}]}

Each rank trains on its own rows of every global batch (micro-batch
``i``'s rows ``i*mb*dp + r*mb ...`` on data-parallel rank ``r``, the JAX
engine's batch layout); the ``model`` and ``seq`` ranks of a row take the
same rows, whole (the model cuts a ``seq`` rank's positions), as do the
``expert`` ranks.  A mesh with a ``model`` or ``expert`` axis gets the
model's ``tp_spec_fn``.  Rank 0 writes
``<out>/<name>.json`` (losses, the collective bytes of every step by
kind, the comm models, ms a step, peak device memory, kernel launches,
the backend, and ``replicas_equal``: whether every rank holding the same
block of a leaf holds the same bits of its master) and, for ``record: full``,
``<out>/<name>.npz`` with every tensor of the state, whole, by checkpoint
name; ``record: digest`` writes a sha256 of each instead, ``none``
nothing (``state_finite`` in the JSON: whether every float tensor recorded
is finite).  A case with
``load`` restores the tag before training (``steps: 0`` records the
loaded state as it is); ``sigterm`` sends SIGTERM to one rank after a
step (with ``resilience.watchdog`` on, every rank saves and exits 43);
``reload`` restores a tag into the same engine after a step (a
rollback); ``nearest_rounding`` steps the reduced Adam state without
stochastic rounding (the JAX package's rule without a key, for holding
the two to the same values); ``record_step`` records the state after that step instead of
at the end; ``profile_step`` runs that step under ``torch.profiler`` on
the card (each rank's kernels' busy time and idle share of the step's
window).  The JSON also notes ``onebit_frozen`` (a 1-bit optimizer's
compressed phase) and ``global_steps`` at the end, and by rank: the
kernels launched, the offload engines' host master bytes, the optimizer
state's bytes on the device and the process's peak resident host bytes.  ``backend`` ``gloo`` with ``device``
``cuda`` runs ranks that share one card (CUDA tensors staged through
pinned host memory where gloo needs it).
``collectives_check`` first runs
:func:`check_collectives` and writes ``<out>/collectives.json``;
``compressed_check`` runs :func:`check_compressed` and writes
``<out>/compressed.npz``; ``tp_ops_check`` runs :func:`check_tp_ops` and writes
``<out>/tp_ops.json``; ``seq_attention_check`` runs
:func:`check_seq_attention` and writes ``<out>/seq_attention.npz``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import signal
import sys
import time

import numpy as np
import torch


def _model(case):
    if case.get("model", "gpt2") == "bert":
        from deepspeed_tpu_torch.models import bert as mod
    else:
        from deepspeed_tpu_torch.models import gpt2 as mod
    cfg = dataclasses.replace(mod.PRESETS[case.get("preset", "tiny")], **case.get("model_cfg", {}))
    model_fn, init_fn, tp_fn = mod.make_model(cfg)
    hooks = {"mesh_check": functools.partial(mod.check_mesh, cfg),
             "comm_model": functools.partial(mod.parallel_comm_model, cfg)}
    return cfg, model_fn, init_fn, tp_fn, hooks


_PARAMS: dict = {}


def _init_params(case, init_fn):
    """The case's initial parameters, drawn once for every case of the
    spec with the same model and seed (the engines copy them; none writes
    to them)."""
    key = json.dumps([case.get("model", "gpt2"), case.get("preset", "tiny"),
                      case.get("model_cfg", {}), int(case.get("init_seed", 0))], sort_keys=True)
    if key not in _PARAMS:
        _PARAMS.clear()  # one model's parameters held at a time
        _PARAMS[key] = init_fn(seed=int(case.get("init_seed", 0)))
    return _PARAMS[key]


def _batches(case, cfg, global_rows: int):
    steps, first = int(case.get("steps", 1)), int(case.get("first_batch", 0))
    if "batches" in case:
        with np.load(case["batches"]) as z:
            data = {k: z[k] for k in z.files}
        return [{k: v[first + s] for k, v in data.items()} for s in range(steps)]
    syn = case["synthetic"]
    rng = np.random.default_rng(syn.get("seed", 0))
    vocab = getattr(cfg, "vocab_size")
    return [{"input_ids": rng.integers(0, vocab, (global_rows, syn["T"]), dtype=np.int32)}
            for _ in range(steps)]


def _rank_rows(batch, engine):
    """This data-parallel rank's rows of a global batch."""
    gas, mb, dp = (engine.gradient_accumulation_steps, engine.train_micro_batch_size_per_gpu,
                   engine.dp_world_size)
    r = engine.mesh.chunk_index(("data", "fsdp"))
    rows = np.concatenate([np.arange(i * mb * dp + r * mb, i * mb * dp + (r + 1) * mb)
                           for i in range(gas)])
    return {k: v[rows] for k, v in batch.items()}


def _resident_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


class HostPeak:
    """This process's peak resident host memory while the context runs
    (``VmRSS`` sampled every ``interval`` seconds on a thread:
    ``peak_bytes``).  Not ``getrusage``'s ``ru_maxrss``, which carries the
    forking parent's peak across the ``exec``, nor ``VmHWM``, which some
    kernels do not report."""

    def __init__(self, interval: float = 0.05):
        import threading

        self.interval = interval
        self.peak_bytes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while True:
            self.peak_bytes = max(self.peak_bytes, _resident_bytes())
            if self._stop.wait(self.interval):
                return

    def __enter__(self) -> "HostPeak":
        self.peak_bytes = _resident_bytes()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()
        self.peak_bytes = max(self.peak_bytes, _resident_bytes())


def _record(engine):
    """Every tensor of the engine's state by checkpoint name, whole (the
    streaming engine: its masters, gathered whole; collective)."""
    from deepspeed_tpu_torch.runtime.checkpointing import _state_tensors
    from deepspeed_tpu_torch.runtime.engine import tree_items

    # copies: an offload engine's host tensors are live (a later step
    # updates them in place)
    if hasattr(engine, "_restore_host"):
        return {f"params/{k}": t.detach().to("cpu", copy=True)
                for k, t in tree_items(engine.params)}
    return {n: t.detach().to("cpu", copy=True) for n, t in _state_tensors(engine).items()}


def _host_bytes(engine):
    """The f32 master bytes this rank's host optimizer(s) own (offload
    engines), by kind: all, and the streaming engine's block leaves."""
    opts = getattr(engine, "_host_opts", None) or ([engine._host_opt]
                                                   if getattr(engine, "_host_opt", None) else [])
    if not opts:
        return None
    out = {"masters": sum(m.numel() * 4 for o in opts for m in o.masters)}
    blocks = getattr(engine, "_block_idx", None)
    if blocks is not None:
        out["block_masters"] = sum(opts[0].masters[i].numel() * 4 for i in blocks)
    return out


def _digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().reshape(-1).contiguous()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()


def _replicas(engine):
    """Every leaf's master as this rank holds it, hashed, and the
    coordinates of the axes that cut it: ranks at the same coordinates
    hold the same block and must hold the same bits (a replicated leaf on
    every ``model`` rank among them)."""
    from deepspeed_tpu_torch.sharding.spec import entry_axes

    out = {}
    if not hasattr(engine, "layout"):  # the streaming engine keeps no device masters
        return out
    for i, p in enumerate(engine._params):
        leaf = engine.layout.leaves[i]
        cut = sorted({a for e in leaf.param_spec for a in entry_axes(e)
                      if engine.mesh.sizes[a] > 1})
        out[leaf.path] = (_digest(p), tuple(engine.mesh.coords[a] for a in cut))
    return out


def _replicas_equal(per_rank):
    """``{leaf: bool}`` from every rank's :func:`_replicas`."""
    equal = {}
    for path in per_rank[0]:
        seen = {}
        ok = True
        for rep in per_rank:
            digest, coords = rep[path]
            ok &= seen.setdefault(coords, digest) == digest
        equal[path] = bool(ok)
    return equal


def run_case(case, device, out_dir, rank):
    with HostPeak() as host_peak:
        _run_case(case, device, out_dir, rank, host_peak)


def _run_case(case, device, out_dir, rank, host_peak):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import collectives
    from deepspeed_tpu_torch.ops import kernels

    cfg, model_fn, init_fn, tp_fn, hooks = _model(case)
    mesh = case["config"].get("mesh", {})
    tp = int(mesh.get("model", 1)) > 1 or int(mesh.get("expert", 1)) > 1
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model_fn, model_parameters=_init_params(case, init_fn),
        config=case["config"], device=device, tp_spec_fn=tp_fn if tp else None, **hooks)
    if case.get("nearest_rounding"):
        engine._rounding_generator = lambda: None
    if "load" in case:
        engine.load_checkpoint(case["load"]["dir"], tag=case["load"].get("tag"))
    global_rows = (engine.gradient_accumulation_steps * engine.train_micro_batch_size_per_gpu
                   * engine.dp_world_size)
    batches = _batches(case, cfg, global_rows)
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    losses, comm, ms = [], [], []
    reload_phase = None
    kernels.reset_launches()
    save = case.get("save")
    if save is not None and int(save.get("after", -1)) == 0:  # the initial state
        engine.save_checkpoint(save["dir"], tag=save.get("tag"))
    record_step = case.get("record_step")
    profile_step = case.get("profile_step")
    stepped, profile = None, None
    for s, batch in enumerate(batches):
        local = _rank_rows(batch, engine)
        collectives.reset_counts()
        if cuda:
            torch.cuda.synchronize(engine.device)
        prof = None
        if profile_step is not None and s + 1 == int(profile_step) and cuda:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        loss = engine.train_batch(local)
        if cuda:
            torch.cuda.synchronize(engine.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            prof.__exit__(None, None, None)
            from deepspeed_tpu_torch.tools.profile_serving import profile_summary

            summ = profile_summary(prof)
            profile = {k: summ[k] for k in ("window_ms", "device_busy_ms", "device_idle_share",
                                            "kernel_events")}
        if record_step is not None and s + 1 == int(record_step):
            stepped = _record(engine)
        comm.append(collectives.counts())
        losses.append(float(loss))
        if save is not None and s + 1 == int(save.get("after", len(batches))):
            engine.save_checkpoint(save["dir"], tag=save.get("tag"))
        reload = case.get("reload")
        if reload is not None and s + 1 == int(reload["after"]):
            # a restore into this engine mid-run (a rollback)
            engine.load_checkpoint(reload["dir"], tag=reload.get("tag"))
            reload_phase = {"onebit_frozen": bool(getattr(engine, "_onebit_frozen", False)),
                            "global_steps": int(engine.global_steps)}
        term = case.get("sigterm")
        if term is not None and rank == int(term["rank"]) and s + 1 == int(term["after"]):
            # a preemption on one rank: the next step boundary is every
            # rank's (an emergency save, then exit 43 everywhere)
            os.kill(os.getpid(), signal.SIGTERM)
    launches, variants = kernels.launches(), kernels.launch_variants()
    record = case.get("record", "full")
    state = stepped if stepped is not None else (_record(engine) if record != "none" else {})
    peak = int(torch.cuda.max_memory_allocated(engine.device)) if cuda else None
    dist_on = torch.distributed.is_initialized()
    peaks = collectives.host_allgather(peak) if dist_on else [peak]
    opt_state, opt = getattr(engine, "opt_state", None), getattr(engine, "optimizer", None)
    mine = {"host_bytes": _host_bytes(engine), "launches": launches, "profile": profile,
            "host_peak_bytes": host_peak.peak_bytes,
            "state_bytes": (opt.state_bytes(opt_state) if opt_state is not None
                            and hasattr(opt, "state_bytes") else None)}
    by_rank = collectives.host_allgather(mine) if dist_on else [mine]
    host = [r["host_bytes"] for r in by_rank]
    timing = (engine.offload_breakdown if getattr(engine, "_host_opt", None) is not None
              and hasattr(engine, "offload_breakdown") else None)
    replicas = collectives.host_allgather(_replicas(engine)) if dist_on else [_replicas(engine)]
    phase = {"onebit_frozen": bool(getattr(engine, "_onebit_frozen", False)),
             "global_steps": int(engine.global_steps), "reload_phase": reload_phase}
    if rank != 0:
        return
    # the activations' bytes at the micro-batch's shape (none without a step)
    shape = ({} if not batches else
             {"rows": engine.train_micro_batch_size_per_gpu,
              "seq_len": int(batches[-1]["input_ids"].shape[-1]),
              "labels_given": "labels" in batches[-1]})
    summary = engine.comm_summary(**shape) if hasattr(engine, "comm_summary") else {}
    result = {
        "name": case["name"], "losses": losses, "comm": comm, "ms": ms,
        "world_size": engine.world_size, "mesh": engine.mesh.sizes,
        "model": summary.get("model"), "extras": summary.get("extras"),
        "table": summary.get("table"),
        "parallel": summary.get("parallel"), "replicas_equal": _replicas_equal(replicas),
        "n_params": getattr(engine, "_comm_n_params", None), "launches": launches,
        "variants": variants, "host_bytes_by_rank": host,
        "launches_by_rank": [r["launches"] for r in by_rank],
        "profile_by_rank": [r["profile"] for r in by_rank],
        "host_peak_bytes_by_rank": [r["host_peak_bytes"] for r in by_rank],
        "state_bytes_by_rank": [r["state_bytes"] for r in by_rank],
        "offload_breakdown": timing() if timing is not None else None,
        "backend": (torch.distributed.get_backend() if torch.distributed.is_initialized()
                    else None),
        "peak_bytes": peak, "peak_bytes_by_rank": peaks, **phase,
    }
    if state:
        result["state_finite"] = all(bool(torch.isfinite(t).all()) for t in state.values()
                                     if t.is_floating_point())
    if record == "digest":
        result["digests"] = {n: _digest(t) for n, t in state.items()}
    elif record == "full":
        np.savez(os.path.join(out_dir, case["name"] + ".npz"),
                 **{n: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
                    for n, t in state.items()})
    with open(os.path.join(out_dir, case["name"] + ".json"), "w") as f:
        json.dump(result, f)


def check_collectives(device, out_dir, rank) -> None:
    """The collectives of ``comm/collectives.py`` on the started group, in
    f32 and bf16 at odd sizes, each against its plain expectation from
    every rank's input (all ranks draw the same inputs from one seed and
    take row ``rank``): all-reduce, reduce-scatter and all-gather along the
    first and a trailing dimension, and the stage-3 autograd gather
    (all-gather forward, reduce-scatter of the gradient backward).  Sums
    over ranks compare within a bound that grows with the world size (0 at
    one rank); the rest bit for bit.  Rank 0 writes
    ``<out>/collectives.json``."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import collectives
    from deepspeed_tpu_torch.runtime.zero.partition import _GatherFn

    pg, world = dist.group.WORLD, dist.get_world_size()
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    rows = []

    def record(op, dtype, shape, got, want, summed):
        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        eps = torch.finfo(dtype).eps
        tol = 0.0 if (world == 1 or not summed) else 2 * (world - 1) * eps * float(
            want.double().abs().max() + 1)
        rows.append({"op": op, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
                     "max_err": err, "tol": tol, "ok": bool(err <= tol)})

    g = torch.Generator().manual_seed(1234)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 7, 1023, 4097):
            x = torch.randn(world, n, generator=g).to(dtype)
            want = x.double().sum(0).to(dtype)
            got = collectives.all_reduce(x[rank].to(dev).clone(), pg, kind="check")
            record("all_reduce", dtype, (n,), got.cpu(), want, True)
            y = torch.randn(world, world * n, 3, generator=g).to(dtype)
            want = y.double().sum(0).to(dtype)[rank * n:(rank + 1) * n]
            got = collectives.reduce_scatter(y[rank].to(dev), pg, dim=0, kind="check")
            record("reduce_scatter_dim0", dtype, (world * n, 3), got.cpu(), want, True)
            want = y.double().sum(0).to(dtype).transpose(0, 1)[:, rank * n:(rank + 1) * n]
            got = collectives.reduce_scatter(y[rank].transpose(0, 1).contiguous().to(dev), pg,
                                             dim=1, kind="check")
            record("reduce_scatter_dim1", dtype, (3, world * n), got.cpu(), want, True)
            z = torch.randn(world, 5, n, generator=g).to(dtype)
            got = collectives.all_gather(z[rank].to(dev), pg, dim=0, kind="check")
            record("all_gather_dim0", dtype, (5, n), got.cpu(), torch.cat(list(z), 0), False)
            got = collectives.all_gather(z[rank].to(dev), pg, dim=1, kind="check")
            record("all_gather_dim1", dtype, (5, n), got.cpu(), torch.cat(list(z), 1), False)
            # the stage-3 gather: a bf16/f32 whole from f32 shards, the f32
            # shard gradient from every rank's whole gradient
            shard = z[rank].float().to(dev).requires_grad_(True)
            full = _GatherFn.apply(
                shard, lambda s: collectives.all_gather(s.to(dtype), pg, dim=1, kind="check"),
                lambda gr: collectives.reduce_scatter(gr.float(), pg, dim=1, kind="check"))
            record("autograd_gather_fwd", dtype, (5, n), full.detach().cpu(),
                   torch.cat(list(z), 1), False)
            up = torch.randn(world, 5, world * n, generator=g)
            full.backward(up[rank].to(dev).to(dtype))
            want = up.to(dtype).double().sum(0).float()[:, rank * n:(rank + 1) * n]
            record("autograd_gather_bwd", torch.float32, (5, world * n), shard.grad.cpu(),
                   want, True)
    if rank == 0:
        with open(os.path.join(out_dir, "collectives.json"), "w") as f:
            json.dump({"backend": dist.get_backend(), "world_size": world, "rows": rows,
                       "ok": all(r["ok"] for r in rows)}, f)


def check_compressed(inputs, device, out_dir, rank) -> None:
    """The compressed exchanges of ``comm/compressed.py`` and
    ``comm/collectives.py`` on the started group, on every rank's row of
    the ``(n, M)`` rows of ``inputs`` (an npz: ``x``, ``werr``, ``serr``):
    the 1-bit exchange (average and new residuals), the int8 all-reduce
    with nearest rounding, and the dense mean, each gathered whole, with
    the bytes each rank counted.  Rank 0 writes
    ``<out>/compressed.npz`` (the caller holds them to the ``*_rows``
    plain versions)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import collectives, compressed

    pg = dist.group.WORLD
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    with np.load(inputs) as z:
        x, werr, serr = (torch.from_numpy(z[k][rank]).to(dev) for k in ("x", "werr", "serr"))
    out = {}
    collectives.reset_counts()
    avg, w, e = compressed.compressed_allreduce(x, werr, serr, pg)
    out["onebit_bytes"] = np.asarray(collectives.counts().get("grad-exchange", 0))
    collectives.reset_counts()
    q = collectives.quantized_allreduce(x, pg)
    out["int8_bytes"] = np.asarray(collectives.counts().get("grad-exchange", 0))
    d = collectives.dense_allreduce(x, pg)
    for key, t in (("onebit", avg), ("int8", q), ("dense", d)):
        out[key] = t.float().cpu().numpy()
    for key, t in (("werr", w), ("serr", e)):
        out[key] = collectives.all_gather(t[None].contiguous(), pg, kind="check").cpu().numpy()
    # 1-bit Adam's variance-sharded frozen layout: its wire bytes by kind
    from deepspeed_tpu_torch.runtime.fp16.onebit.adam import OnebitAdam

    n = dist.get_world_size()
    signs, scales = compressed.compress_chunks(x * 1e-2, n)
    chunk = x.numel() // n
    collectives.reset_counts()
    p_full, *_ = OnebitAdam(lr=1e-2, freeze_step=1).frozen_apply_vsharded(
        x, signs, scales, x[rank * chunk:(rank + 1) * chunk].abs(),
        x[rank * chunk:(rank + 1) * chunk].clone(), werr, serr, 1e-2, group=pg)
    out["vsharded_bytes"] = np.asarray([collectives.counts().get("grad-exchange", 0),
                                        collectives.counts().get("vsharded-param-all-gather", 0)])
    out["vsharded_p_full"] = p_full.float().cpu().numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "compressed.npz"), **out)


def check_tp_ops(device, out_dir, rank) -> None:
    """The vocab-parallel embedding and NLL of ``parallel/tensor.py`` over
    the whole started group as the ``model`` group, at GPT-2 124M's widths
    (vocab 50304, d 768) on 8 rows of 1024 tokens, in f32 and bf16: every
    rank holds its vocabulary block of one table drawn from a seed, and
    the results and the gradients of its block are held against the plain
    embedding and ``token_nll`` on the whole table.  The embedding is a
    sum of one nonzero row and zeros (0 error); the NLL's sums run in
    another order: within ``TP_NLL_RTOL`` of its largest entry, its
    gradients within ``TP_NLL_RTOL`` of theirs.  Rank 0 writes
    ``<out>/tp_ops.json``."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.ops.normalize import token_nll
    from deepspeed_tpu_torch.parallel.tensor import (
        TPGroup,
        vocab_parallel_embedding,
        vocab_parallel_nll,
    )

    world = dist.get_world_size()
    tp = TPGroup(dist.group.WORLD, world, rank)
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    V, D, B, T = 50304, 768, 8, 1024
    n = V // world
    rows = []
    g = torch.Generator().manual_seed(4321)
    for dtype in (torch.float32, torch.bfloat16):
        table = (torch.randn(V, D, generator=g) * 0.02).to(dtype).to(dev)
        tokens = torch.randint(0, V, (B, T), generator=g).to(dev)
        mine = table[rank * n:(rank + 1) * n].clone().requires_grad_(True)
        whole = table.clone().requires_grad_(True)
        got = vocab_parallel_embedding(mine, tokens, tp)
        want = whole[tokens]
        up = (torch.randn(B, T, D, generator=g)).to(dtype).to(dev)
        got.backward(up)
        want.backward(up)
        emb_err = float((got.double() - want.double()).abs().max())
        emb_grad_err = float((mine.grad.double() - whole.grad[rank * n:(rank + 1) * n].double())
                             .abs().max())
        logits = torch.randn(B, T, V, generator=g).to(dtype).to(dev)
        labels = torch.randint(0, V, (B, T), generator=g).to(dev)
        lm = logits[..., rank * n:(rank + 1) * n].clone().requires_grad_(True)
        lw = logits.clone().requires_grad_(True)
        nll = vocab_parallel_nll(lm, labels, tp)
        ref = token_nll(lw, labels)
        cot = torch.rand(B, T, generator=g).to(dev)
        nll.backward(cot)
        ref.backward(cot)
        nll_err = float((nll.double() - ref.double()).abs().max() / ref.double().abs().max())
        gw = lw.grad[..., rank * n:(rank + 1) * n].double()
        nll_grad_err = float((lm.grad.double() - gw).abs().max() / gw.abs().max())
        rows.append({"dtype": str(dtype).replace("torch.", ""), "V": V, "D": D, "B": B, "T": T,
                     "embedding_max_err": emb_err, "embedding_grad_max_err": emb_grad_err,
                     "nll_rel_err": nll_err, "nll_grad_rel_err": nll_grad_err,
                     "tol": TP_NLL_RTOL, "grad_tol": TP_NLL_GRAD_RTOL[dtype],
                     "ok": bool(emb_err == 0.0 and emb_grad_err == 0.0
                                and nll_err <= TP_NLL_RTOL
                                and nll_grad_err <= TP_NLL_GRAD_RTOL[dtype])})
    if rank == 0:
        with open(os.path.join(out_dir, "tp_ops.json"), "w") as f:
            json.dump({"backend": dist.get_backend(), "world_size": world, "rows": rows,
                       "ok": all(r["ok"] for r in rows)}, f)


def check_seq_attention(inputs, device, out_dir, rank) -> None:
    """``ring_attention`` and ``ulysses_attention`` with every started rank
    on the ``seq`` axis, causal and full, forward and backward: the
    whole ``(B, H, T, d)`` q, k, v and output cotangent ``do`` of
    ``inputs`` (an npz), each rank its positions; the outputs and the
    gradients gathered whole.  Rank 0 writes them to
    ``<out>/seq_attention.npz`` as ``<ring|ulysses>_<causal|full>_<out|dq|dk|dv>``
    (the caller holds them to a reference)."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import collectives
    from deepspeed_tpu_torch.comm.mesh import make_mesh
    from deepspeed_tpu_torch.parallel.sequence import ring_attention, ulysses_attention

    world = dist.get_world_size()
    mesh = make_mesh({"data": 1, "seq": world})
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    with np.load(inputs) as z:
        whole = {k: torch.from_numpy(z[k]).to(dev) for k in ("q", "k", "v", "do")}
    T = whole["q"].shape[2]
    pos = slice(rank * T // world, (rank + 1) * T // world)
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (True, False):
            q, k, v = (whole[n][:, :, pos].clone().requires_grad_(True) for n in ("q", "k", "v"))
            o = fn(q, k, v, causal=causal, mesh=mesh)
            o.backward(whole["do"][:, :, pos])
            tag = f"{name}_{'causal' if causal else 'full'}"
            for key, t in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                t = collectives.all_gather(t.detach().contiguous(), mesh.world_group(), dim=2,
                                           kind="check")
                out[f"{tag}_{key}"] = t.float().cpu().numpy()
    if rank == 0:
        np.savez(os.path.join(out_dir, "seq_attention.npz"), **out)


# vocab_parallel_nll against token_nll on the same logits, relative to the
# largest entry: the log-sum-exp over 50,304 columns summed in f32 in
# another order (per rank, then across ranks) — a few f32 roundings of a
# sum of ~5e4 terms (bf16 logits are upcast on both sides).  The
# gradient's softmax divides by that sum; in bf16 each side rounds its
# f32 gradient to bf16, so an entry may land one bf16 spacing (2**-8
# relative) apart
TP_NLL_RTOL = 1e-5
TP_NLL_GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 1)))
    if spec.get("deterministic", True):
        torch.use_deterministic_algorithms(True)
    # a reference states its float32 matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.comm import distributed

    device = spec.get("device", "cpu")
    if not distributed.init_distributed(dist_backend=spec.get("backend"),
                                        init_method=spec.get("init_method"), device=device):
        raise SystemExit("zero_worker: no launcher environment (RANK, WORLD_SIZE)")
    os.makedirs(spec["out"], exist_ok=True)
    try:
        if spec.get("collectives_check"):
            check_collectives(device, spec["out"], distributed.get_rank())
        if spec.get("compressed_check"):
            check_compressed(spec["compressed_check"], device, spec["out"], distributed.get_rank())
        if spec.get("tp_ops_check"):
            check_tp_ops(device, spec["out"], distributed.get_rank())
        if spec.get("seq_attention_check"):
            check_seq_attention(spec["seq_attention_check"], device, spec["out"],
                                distributed.get_rank())
        for case in spec.get("cases", []):
            run_case(case, device, spec["out"], distributed.get_rank())
    finally:
        distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
