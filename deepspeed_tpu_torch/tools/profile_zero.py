"""ZeRO across ranks on one host: GPT-2 at each stage on each mesh, beside
the same global batches at world size 1.

    python -m deepspeed_tpu_torch.tools.profile_zero --world 4 [--meshes d2f2,f4]
        [--stages 0,1,2,3] [--steps 5] [--preset gpt2] [--micro 8 --gas 2 --seq 1024]
        [--device cuda] [--out DIR]

Starts ``--world`` rank processes of ``tools/zero_worker.py`` under the
launcher environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, a free ``MASTER_PORT``; on the card each rank takes the
card ``LOCAL_RANK``, so ``--world`` cards are needed), once per mesh, and
one rank for the reference: the same global batches at world 1, its
micro-batch ``--micro * world`` (the same rows per micro-step).  The
config is ``chip_smoke.py``'s ``train_bf16`` one (bf16 over f32 masters,
AdamW, WarmupDecayLR, clipping 1.0, remat), with
``stage3_param_persistence_threshold: 0`` so stage 3 shards every leaf;
each mesh's spawn checks the collectives first.

Prints one JSON line per (mesh, stage): the losses and their largest
relative distance from world 1's, ms a step (rank 0's host clock around a
synchronized step; the median after the first), peak device memory by
rank, and each step's collective bytes by kind beside the comm model
(``bytes_equal_model``).  Then a line with the card's name and power
limit (``nvidia-smi``), where there is one.  Exits non-zero when a rank
fails, the collectives check fails or a count differs from the model.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MESHES = {"d2": {"data": 2, "fsdp": 1}, "d4": {"data": 4, "fsdp": 1},
          "d2f2": {"data": 2, "fsdp": 2}, "f2": {"data": 1, "fsdp": 2},
          "f4": {"data": 1, "fsdp": 4}, "d1": {"data": 1, "fsdp": 1}}
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "grad-exchange")


def _config(micro, gas, stage, mesh):
    return {
        "train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                  "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 6e-5,
            "warmup_max_lr": 6e-4}},
        "mesh": mesh,
        "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0},
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world, spec, root, tag, device):
    path = os.path.join(root, f"spec_{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.tools.zero_worker", path], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=1800)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode, out[-3000:]) for r, (p, out) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise SystemExit(f"profile_zero: {tag}: rank {bad[0][0]} exited {bad[0][1]}:\n{bad[0][2]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--meshes", default="d2f2,f4")
    ap.add_argument("--stages", default="0,1,2,3")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--preset", default="gpt2")
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--gas", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    stages = [int(s) for s in args.stages.split(",")]
    meshes = args.meshes.split(",")
    for name in meshes:
        m = MESHES[name]
        if m["data"] * m["fsdp"] != args.world:
            raise SystemExit(f"profile_zero: mesh {name} {m} is not {args.world} ranks")
    root = args.out or tempfile.mkdtemp()
    os.makedirs(root, exist_ok=True)
    W, steps = args.world, args.steps
    vocab = 50257 if args.preset != "tiny" else 512
    ids = np.random.default_rng(0).integers(
        0, vocab, (steps, args.gas * args.micro * W, args.seq), dtype=np.int32)
    batches = os.path.join(root, "batches.npz")
    np.savez(batches, input_ids=ids)
    base = {"device": args.device, "deterministic": args.device != "cuda", "threads": 4,
            "out": root}

    def cases(tag, micro, mesh):
        return [{"name": f"{tag}_s{s}", "preset": args.preset, "init_seed": 0,
                 "model_cfg": {} if args.preset != "tiny" else {"n_positions": args.seq},
                 "config": _config(micro, args.gas, s, mesh), "batches": batches,
                 "steps": steps, "record": "none"} for s in stages]

    _spawn(1, dict(base, cases=cases("w1", args.micro * W, MESHES["d1"])[:1]), root, "w1",
           args.device)
    with open(os.path.join(root, "w1_s%d.json" % stages[0])) as f:
        ref = json.load(f)["losses"]
    ok = True
    for name in meshes:
        _spawn(W, dict(base, collectives_check=True, cases=cases(name, args.micro, MESHES[name])),
               root, name, args.device)
        with open(os.path.join(root, "collectives.json")) as f:
            coll = json.load(f)
        ok &= bool(coll["ok"])
        print(json.dumps({"mesh": name, "collectives_ok": coll["ok"],
                          "backend": coll["backend"], "world_size": coll["world_size"],
                          "collectives_max_err": max(r["max_err"] for r in coll["rows"])}),
              flush=True)
        for s in stages:
            with open(os.path.join(root, f"{name}_s{s}.json")) as f:
                r = json.load(f)
            model, extras = r["model"], r["extras"]
            equal = all(all(c.get(k, 0) == model[k] for k in KINDS)
                        and c.get("update-all-gather", 0) == extras["update-all-gather"]
                        for c in r["comm"])
            ok &= equal and all(np.isfinite(r["losses"]))
            print(json.dumps({
                "mesh": name, "sizes": MESHES[name], "stage": s, "world_size": r["world_size"],
                "backend": r["backend"], "losses": r["losses"], "losses_world1": ref,
                "max_rel_loss_diff_vs_world1": float(np.max(
                    np.abs(np.array(r["losses"]) - ref) / np.abs(ref))),
                "step_ms": r["ms"], "step_ms_median_after_first": float(np.median(r["ms"][1:])),
                "peak_gib_by_rank": [None if b is None else b / 2**30
                                     for b in r["peak_bytes_by_rank"]],
                "bytes_a_step": r["comm"][-1], "model": model, "extras": extras,
                "bytes_equal_model": equal, "n_params": r["n_params"],
                "launches": {k: v for k, v in r["launches"].items() if v}}), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        print(json.dumps({"cards": smi}), flush=True)
    except (OSError, subprocess.SubprocessError):
        pass
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
