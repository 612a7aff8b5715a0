"""Pipelined training across ranks on one host: a ``PipelineModule`` on
each mesh, beside the same global batches at one stage.

    python -m deepspeed_tpu_torch.tools.profile_pipe --world 4 [--meshes p4,p2d2]
        [--factory chip_smoke.py:gpt2_pipe_module] [--schedule 1f1b|gpipe]
        [--steps 3] [--micro 8 --gas 4 --seq 1024] [--layers 12] [--device cuda]
        [--backend nccl|gloo] [--out DIR]

Meshes by name: ``p``, ``d`` and ``m`` each followed by their size
(``pipe``, ``data``, ``model``), such as ``p4``, ``p2d2``, ``p2m2``.  The
module comes from ``--factory`` (``<file>:<function>`` returning
``(PipelineModule, tp_spec_fn)``; by default GPT-2 124M as
``chip_smoke.py`` assembles it); the config is ``chip_smoke.py``'s
``train_bf16`` one (bf16 over f32 masters, AdamW, WarmupDecayLR, clipping
1.0) with ``gradient_accumulation_steps`` the micro-batch count.

Starts ``--world`` rank processes of ``tools/pipe_worker.py`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; they meet through a file store in the
output directory; each rank the card ``LOCAL_RANK``, so ``--world``
cards are needed; ``--backend gloo`` lets them share one card), once per
mesh, and one rank for the reference at one stage, its micro-batch
``--micro`` times the mesh's ``data`` (the same rows a micro-step).
Prints one JSON line per mesh: the losses and their largest relative
distance from one stage's, ms a step (rank 0's clock around a
synchronized step; the mean after the first), each rank's stage and idle
share (its device time outside its forwards and backwards over the
step's wall), peak device memory by rank, and each step's ``pipe-p2p`` /
``pipe-grad-reduce`` bytes beside ``pipe_comm_model``.  Then the card's
name and power limit (``nvidia-smi``), where there is one.  Exits non-zero
when a rank fails or a count differs from the model.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
AXIS_LETTERS = {"p": "pipe", "d": "data", "m": "model"}


def mesh_of(name: str) -> dict:
    mesh = {"data": 1}
    for letter, size in re.findall(r"([pdm])(\d+)", name):
        mesh[AXIS_LETTERS[letter]] = int(size)
    return mesh


def _config(mesh, micro, gas, schedule):
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
            "bf16": {"enabled": True}, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                      "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupDecayLR", "params": {
                "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 6e-5,
                "warmup_max_lr": 6e-4}},
            "mesh": mesh, "pipeline": {"schedule": schedule}}


def _spawn(world, spec, root, tag, device):
    spec = {**spec, "init_method": f"file://{root}/store_{tag}"}  # ranks meet through a file
    path = os.path.join(root, f"spec_{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.pipe_worker", path], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=1800)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(f"rank {r} of {world} ({tag}) exited {p.returncode}:\n{out[-4000:]}\n")
            raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--meshes", default="p4,p2d2")
    ap.add_argument("--factory", default=os.path.join(REPO, "chip_smoke.py") + ":gpt2_pipe_module")
    ap.add_argument("--schedule", default="1f1b", choices=("1f1b", "gpipe"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--gas", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=50257)
    ap.add_argument("--layers", type=int, default=None, help="the factory's n_layer")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    root = args.out or tempfile.mkdtemp()
    os.makedirs(root, exist_ok=True)
    meshes = [m for m in args.meshes.split(",") if m]
    dp_max = max(mesh_of(m)["data"] for m in meshes)
    rng = np.random.default_rng(0)
    rows = args.gas * args.micro * dp_max
    ids = rng.integers(0, args.vocab, (args.steps, rows, args.seq), dtype=np.int32)

    def case(name, mesh, dp):
        # the global batch of a grid of dp ranks: micro-batch m's rows, then
        # each rank's share of them (the worker cuts them)
        n = args.gas * args.micro * dp
        bfile = os.path.join(root, f"b{dp}.npz")
        if not os.path.exists(bfile):
            np.savez(bfile, x=ids[:, :n], y=ids[:, :n])
        kwargs = {} if args.layers is None else {"n_layer": args.layers}
        return {"name": name, "module": {"factory": args.factory, "kwargs": kwargs},
                "config": _config(mesh, args.micro, args.gas, args.schedule),
                "batches": bfile, "steps": args.steps, "record": "none"}

    spec = lambda cases: {"device": args.device, "backend": args.backend,  # noqa: E731
                          "deterministic": False, "threads": 4, "out": root, "cases": cases}
    refs = {}
    for dp in sorted({mesh_of(m)["data"] for m in meshes}):
        ref = case(f"ref_d{dp}", {"pipe": 1}, dp)
        ref["config"]["train_micro_batch_size_per_gpu"] = args.micro * dp
        _spawn(1, spec([ref]), root, f"ref{dp}", args.device)
        with open(os.path.join(root, f"ref_d{dp}.json")) as f:
            refs[dp] = json.load(f)
    ok = True
    for m in meshes:
        mesh = mesh_of(m)
        _spawn(args.world, spec([case(m, mesh, mesh["data"])]), root, m, args.device)
        with open(os.path.join(root, f"{m}.json")) as f:
            meta = json.load(f)
        ref = refs[mesh["data"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(meta["losses"], ref["losses"]))
        equal = all(step.get(k, 0) == v for r in meta["ranks"] for step in r["comm"]
                    for k, v in r["model"].items())
        ok &= equal
        print(json.dumps({
            "mesh": mesh, "schedule": args.schedule, "micro_batches": args.gas,
            "micro_batch": args.micro, "T": args.seq, "losses": meta["losses"],
            "one_stage_losses": ref["losses"], "max_rel_diff": rel,
            "step_ms": meta["ms"], "step_ms_mean_after_first": float(np.mean(meta["ms"][1:])),
            "one_stage_step_ms_mean_after_first": float(np.mean(ref["ms"][1:])),
            "stage_by_rank": [r["stage"] for r in meta["ranks"]],
            "idle_share_by_rank": [r["idle"] for r in meta["ranks"]],
            "peak_gib_by_rank": [(r["peak"] or 0) / 2**30 for r in meta["ranks"]],
            "bytes_by_rank": [r["comm"][-1] for r in meta["ranks"]],
            "model_by_rank": [r["model"] for r in meta["ranks"]],
            "bytes_equal_model": equal}), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        if smi:
            print(smi[0], flush=True)
    except (OSError, subprocess.SubprocessError):
        pass
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
