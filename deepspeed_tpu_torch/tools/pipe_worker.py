"""One rank of a pipelined training run: trains the cases of a JSON spec
with ``PipelineEngine`` and writes what each produced.

Run it once per rank under a launcher environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; or the
spec's ``init_method``, such as ``file:///tmp/store`` for ranks on one
host)::

    RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29511 \\
        python -m deepspeed_tpu_torch.tools.pipe_worker spec.json

It imports torch and the port only.  The spec::

    {"device": "cpu" | "cuda", "backend": null | "gloo" | "nccl",
     "init_method": null, "threads": 1, "out": "<dir>",
     "cases": [{"name": "p2", "module": {"kind": "linear", "dim": 16, "nblocks": 4}
                  | {"kind": "mlp", "dim": 16, "nblocks": 4}
                  | {"kind": "tied", "vocab": 32, "dim": 16, "nblocks": 4}
                  | {"factory": "<file.py>:<function>", "kwargs": {...}},
                "config": {...}, "batches": "<npz: x, y of (steps, batch, ...)>",
                "steps": 3, "eval": false, "load": {"dir": ..., "tag": ...},
                "save": {"dir": ..., "tag": ...}, "record": "full" | "none",
                "record_step": <steps>, "grad_norms": false}]}

``backend`` ``gloo`` with ``device`` ``cuda`` runs stage processes that
share one card (activations through pinned host memory).  ``tied`` puts
the embedding on the first stage and, as the head, on the last (their
gradients summed over ``pipe``).  A ``factory``
returns ``(PipelineModule, tp_spec_fn or None)`` from its ``kwargs``.
Every rank takes the whole batch of each step (the data-parallel rows of
``mesh.data`` > 1 are cut by ``chunk_index``).  Rank 0 writes
``<out>/<name>.json`` (losses, ``eval`` losses, the bytes of every step by
kind beside ``pipe_comm_model``, ms a step, the largest number of
micro-batches live, each stage's idle share, peak device memory and
kernel launches by stage, and with ``grad_norms`` each step's gradient
norms by leaf and block, :func:`record_grad_norms`) and, for ``record:
full``, ``<out>/<name>.npz`` with the parameters, whole, by path, as they
stand after step ``record_step`` (the last by default).
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch


# ---------------------------------------------------------------------------
# layers of the CPU tests (the JAX package's tests/test_pipe.py fixtures)
# ---------------------------------------------------------------------------

class Linear:
    """``gelu(x @ w + b)`` (tanh GELU, ``jax.nn.gelu``'s default), or
    without the activation."""

    def __init__(self, dim, act=True, seed_scale=1.0):
        self.dim, self.act, self.seed_scale = dim, act, seed_scale

    def init(self, rng):
        w = rng.standard_normal((self.dim, self.dim)) * (self.seed_scale / np.sqrt(self.dim))
        return {"w": w.astype(np.float32), "b": np.zeros((self.dim,), np.float32)}

    def apply(self, params, x, generator=None):
        h = x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)
        return torch.nn.functional.gelu(h, approximate="tanh") if self.act else h


class MLP:
    """A residual column → row parallel MLP block (Megatron layout): under
    a ``model`` axis ``w1``/``b1`` are the rank's output columns and
    ``w2`` its input rows (:func:`mlp_tp_spec`)."""

    def __init__(self, dim, mult=4):
        self.dim, self.mult = dim, mult

    def init(self, rng):
        h = self.dim * self.mult
        return {"w1": (rng.standard_normal((self.dim, h)) / np.sqrt(self.dim)).astype(np.float32),
                "b1": np.zeros((h,), np.float32),
                "w2": (rng.standard_normal((h, self.dim)) / np.sqrt(h)).astype(np.float32),
                "b2": np.zeros((self.dim,), np.float32)}

    def apply(self, params, x, generator=None):
        from deepspeed_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model, tp_group

        tp = tp_group()
        h = copy_to_model(x, tp) @ params["w1"] + params["b1"]
        h = torch.nn.functional.gelu(h, approximate="tanh")
        return x + reduce_from_model(h @ params["w2"], tp) + params["b2"]


def mlp_tp_spec(path, shape):
    """:class:`MLP`'s tensor-parallel specs over the per-block paths (the
    engine stacks them over ``pipe``)."""
    from deepspeed_tpu_torch.sharding.spec import PartitionSpec as P

    if path.endswith("w1"):
        return P(None, "model")
    if path.endswith("b1"):
        return P("model")
    if path.endswith("w2"):
        return P("model", None)
    return None


def mse_loss(outputs, labels):
    return ((outputs.float() - labels.float()) ** 2).mean()


class Embed:
    """A token embedding ``e[tokens]`` (the JAX package's tests/test_pipe.py
    ``Embed``), tied with :func:`tied_head` under one key."""

    def __init__(self, vocab, dim, std=1.0):
        self.vocab, self.dim, self.std = vocab, dim, std

    def init(self, rng):
        return {"e": (rng.standard_normal((self.vocab, self.dim)) * self.std).astype(np.float32)}

    def apply(self, params, tokens, generator=None):
        return params["e"][tokens.long()]


def tied_head(params, x):
    """The tied embedding as the output head: ``x @ e.T``."""
    return x @ params["e"].t().to(x.dtype)


def token_nll(logits, labels):
    """Mean cross entropy of ``logits (B, T, V)`` against ``labels (B, T)``."""
    lg = logits.float()
    return torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                             labels.reshape(-1).long())


def build_module(spec: dict, pipeline_cfg: dict):
    """``(PipelineModule, tp_spec_fn)`` of a case's ``module`` block."""
    from deepspeed_tpu_torch.runtime.pipe import LayerSpec, PipelineModule, TiedLayerSpec

    kw = {"activation_checkpoint_interval": int(pipeline_cfg.get("activation_checkpoint_interval", 0))}
    if "factory" in spec:
        path, fn = spec["factory"].rsplit(":", 1)
        mod_spec = importlib.util.spec_from_file_location("_pipe_factory", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return getattr(mod, fn)(**spec.get("kwargs", {}))
    dim, n = int(spec.get("dim", 16)), int(spec.get("nblocks", 4))
    if spec["kind"] == "tied":
        vocab = int(spec.get("vocab", 32))
        layers = ([TiedLayerSpec("embed", Embed, vocab, dim)]
                  + [LayerSpec(Linear, dim, act=True) for _ in range(n)]
                  + [TiedLayerSpec("embed", Embed, vocab, dim, forward_fn=tied_head)])
        return PipelineModule(layers, loss_fn=token_nll, **kw), None
    if spec["kind"] == "mlp":
        return PipelineModule([LayerSpec(MLP, dim) for _ in range(n)], loss_fn=mse_loss,
                              **kw), mlp_tp_spec
    layers = [LayerSpec(Linear, dim, act=True) for _ in range(n)]
    layers.append(LayerSpec(Linear, dim, act=False))
    return PipelineModule(layers, loss_fn=mse_loss, **kw), None


def _rows(x, engine):
    """This data-parallel rank's rows of a global batch, micro-batch by
    micro-batch (the JAX engine's layout: micro ``m``'s rows, then the
    rank's share of them)."""
    dp = engine.dp_world_size
    if dp == 1:
        return x
    M, r = engine.gradient_accumulation_steps, engine.mesh.chunk_index(("data", "fsdp"))
    mb = x.shape[0] // (M * dp)
    idx = np.concatenate([np.arange(m * mb * dp + r * mb, m * mb * dp + (r + 1) * mb)
                          for m in range(M)])
    return x[idx]


def record_grad_norms(engine) -> list:
    """Have ``engine`` note, at each optimizer step before it runs, every
    leaf's gradient norm: the micro-batches' sum after the ``pipe`` and
    data-parallel reductions.  A leaf stacked over ``pipe`` gives one norm
    a block, under ``<path>#<block>`` with the block's index in the whole
    model.  Returns the list each step appends its ``{name: norm}`` to."""
    from deepspeed_tpu_torch.sharding.spec import entry_axes

    steps, step = [], engine._apply_step

    def noted(*a, **kw):
        norms = {}
        for leaf, acc in zip(engine.layout.leaves, engine._grad_acc):
            g = torch.zeros((1,)) if acc is None else acc.float()
            if any("pipe" in entry_axes(e) for e in leaf.param_spec):
                k = g.shape[0]
                for j, v in enumerate(g.reshape(k, -1).norm(dim=1).tolist()):
                    norms[f"{leaf.path}#{engine.stage_id * k + j}"] = v
            else:
                norms[leaf.path] = float(g.norm())
        steps.append(norms)
        return step(*a, **kw)

    engine._apply_step = noted
    return steps


def run_case(case, device, out_dir, rank):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import collectives
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.runtime.engine import tree_items
    from deepspeed_tpu_torch.runtime.pipe.engine import pipe_comm_model

    module, tp_fn = build_module(case["module"], case["config"].get("pipeline", {}))
    engine, *_ = deepspeed_tpu_torch.initialize(model=module, config=case["config"],
                                                device=device, tp_spec_fn=tp_fn,
                                                dist_init_required=False)
    if "load" in case:
        engine.load_checkpoint(case["load"]["dir"], tag=case["load"].get("tag"))
    with np.load(case["batches"]) as z:
        data = {k: z[k] for k in z.files}
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(engine.device)
    losses, evals, comm, ms, idle = [], [], [], [], []
    norms = record_grad_norms(engine) if case.get("grad_norms") else None
    kernels.reset_launches()
    steps = int(case.get("steps", 1))
    record_step, params = int(case.get("record_step", steps)), None
    for s in range(steps):
        batch = (_rows(data["x"][s], engine), _rows(data["y"][s], engine))
        collectives.reset_counts()
        if cuda:
            torch.cuda.synchronize(engine.device)
        t0 = time.perf_counter()
        loss = engine.train_batch(batch=batch)
        if cuda:
            torch.cuda.synchronize(engine.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        comm.append(collectives.counts())
        losses.append(float(loss))
        idle.append(engine.idle_share)
        if case.get("eval"):
            evals.append(float(engine.eval_batch(batch=batch)))
        if s + 1 == record_step:
            params = {p: t.detach().cpu().numpy() for p, t in tree_items(engine.params)}
    if "save" in case:
        engine.save_checkpoint(case["save"]["dir"], tag=case["save"].get("tag"))
    if params is None:
        params = {p: t.detach().cpu().numpy() for p, t in tree_items(engine.params)}
    x0 = torch.as_tensor(_rows(data["x"][0], engine))
    mb = x0.shape[0] // engine.gradient_accumulation_steps
    act = engine._act_meta(engine._materialize_params(), engine._prepare_batch(x0[:mb]))
    model = pipe_comm_model(act[0], torch.empty((), dtype=act[1]).element_size(),
                            engine.gradient_accumulation_steps, engine.num_stages,
                            engine.stage_id, engine.replicated_numel())
    mine = {"stage": engine.stage_id, "comm": comm, "model": model, "max_live": engine.max_live,
            "idle": idle, "launches": kernels.launches(), "grad_norms": norms,
            "peak": int(torch.cuda.max_memory_allocated(engine.device)) if cuda else None}
    every = (collectives.host_allgather(mine) if torch.distributed.is_initialized()
             else [mine])
    if rank != 0:
        return
    result = {"name": case["name"], "losses": losses, "evals": evals, "ms": ms,
              "mesh": engine.mesh.sizes, "ranks": every}
    with open(os.path.join(out_dir, f"{case['name']}.json"), "w") as f:
        json.dump(result, f)
    if case.get("record", "full") == "full":
        np.savez(os.path.join(out_dir, f"{case['name']}.npz"), **params)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 1)))
    if spec.get("deterministic", True):
        torch.use_deterministic_algorithms(True)
    device = spec.get("device", "cpu")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = spec.get("backend") or ("nccl" if device == "cuda" else "gloo")
    init = spec.get("init_method") or "env://"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    torch.distributed.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    try:
        os.makedirs(spec["out"], exist_ok=True)
        for case in spec["cases"]:
            run_case(case, device, spec["out"], rank)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
