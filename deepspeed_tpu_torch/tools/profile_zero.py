"""ZeRO, tensor and sequence parallelism across ranks on one host: GPT-2
(or BERT with LAMB) at each stage on each mesh, beside the same global
batches at world size 1.

    python -m deepspeed_tpu_torch.tools.profile_zero --world 4 [--meshes d2f2,f4]
        [--stages 0,1,2,3] [--steps 5] [--preset gpt2] [--micro 8 --gas 2 --seq 1024]
        [--model gpt2|bert] [--vocab 50304] [--attention-mode flash|ring|ulysses]
        [--xent-chunk 512] [--device cuda] [--out DIR]

Meshes by name: ``d``, ``f``, ``s`` and ``m`` each followed by their size
(``data``, ``fsdp``, ``seq``, ``model``), such as ``d2f2``, ``m4``,
``m2d2``, ``s4``, ``s2m2`` (axes not named are 1); ``name@2`` runs that
mesh at stage 2 alone instead of ``--stages``.  GPT-2 at T 8192 is
``--seq 8192`` (``n_positions`` follows ``--seq``); a ``seq`` axis needs
``--attention-mode ring`` or ``ulysses``; a ``model`` axis a vocabulary it
divides (``--vocab 50304`` for GPT-2).

Starts ``--world`` rank processes of ``tools/zero_worker.py`` under the
launcher environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, a free ``MASTER_PORT``; on the card each rank takes the
card ``LOCAL_RANK``, so ``--world`` cards are needed), once per mesh, and
one rank for the reference: the same global batches at world 1, its
micro-batch ``--micro`` times the mesh's ``data x fsdp`` (the same rows
per micro-step).  The config is ``chip_smoke.py``'s ``train_bf16`` one
(bf16 over f32 masters, AdamW, WarmupDecayLR, clipping 1.0, remat), or
for ``--model bert`` BERT-large with bing_bert's phase-2 LAMB on padded
synthetic MLM + NSP batches, with ``stage3_param_persistence_threshold:
0`` so stage 3 shards every leaf; each mesh's spawn checks the
collectives first.

Prints one JSON line per (mesh, stage): the losses and their largest
relative distance from world 1's, ms a step (rank 0's host clock around a
synchronized step; the median after the first), peak device memory by
rank, and each step's collective bytes by kind beside the comm models
(``bytes_equal_model``: ``step_comm_bytes``, ``port_step_comm_extras`` and
``port_parallel_comm_model``).  Then a line with the card's name and power
limit (``nvidia-smi``), where there is one.  Exits non-zero when a rank
fails, the collectives check fails or a count differs from the model.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
AXIS_LETTERS = {"d": "data", "f": "fsdp", "s": "seq", "m": "model"}
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "grad-exchange")
EXTRAS = ("update-all-gather", "seq-grad-exchange")
PARALLEL = ("tp-all-reduce", "seq-p2p", "seq-all-to-all", "seq-loss")


def mesh_of(name: str) -> dict:
    """``"s2m2"`` -> ``{"data": 1, "fsdp": 1, "seq": 2, "model": 2}``."""
    parts = re.findall(r"([dfsm])(\d+)", name)
    if "".join(letter + size for letter, size in parts) != name:
        raise SystemExit(f"profile_zero: mesh name {name!r} is not axis letters and sizes")
    mesh = {"data": 1, "fsdp": 1, "seq": 1, "model": 1}
    mesh.update({AXIS_LETTERS[letter]: int(size) for letter, size in parts})
    return mesh


def _config(micro, gas, stage, mesh, model="gpt2"):
    if model == "bert":
        from deepspeed_tpu_torch.tools.profile_training import BERT_LAMB

        opt = BERT_LAMB
        sched = {"total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 2e-4,
                 "warmup_max_lr": 2e-3}
    else:
        opt = {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                           "weight_decay": 0.1}}
        sched = {"total_num_steps": 100, "warmup_num_steps": 2, "warmup_min_lr": 6e-5,
                 "warmup_max_lr": 6e-4}
    return {
        "train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": opt,
        "scheduler": {"type": "WarmupDecayLR", "params": sched},
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
    ap.add_argument("--model", default="gpt2", choices=("gpt2", "bert"))
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--attention-mode", default="flash", choices=("flash", "ring", "ulysses"))
    ap.add_argument("--xent-chunk", type=int, default=0)
    args = ap.parse_args(argv)
    stages = [int(s) for s in args.stages.split(",")]
    names = [m.split("@") for m in args.meshes.split(",")]
    meshes = {n[0]: mesh_of(n[0]) for n in names}
    mesh_stages = {n[0]: [int(n[1])] if len(n) > 1 else stages for n in names}
    for name, m in meshes.items():
        if int(np.prod(list(m.values()))) != args.world:
            raise SystemExit(f"profile_zero: mesh {name} {m} is not {args.world} ranks")
    root = args.out or tempfile.mkdtemp()
    os.makedirs(root, exist_ok=True)
    W, steps = args.world, args.steps
    preset = args.preset if args.model == "gpt2" else ("bert-large" if args.preset == "gpt2"
                                                      else args.preset)
    model_cfg = {}
    if args.model == "gpt2":
        model_cfg = {"n_positions": args.seq, "attention_mode": args.attention_mode,
                     "xent_chunk_size": args.xent_chunk}
    if args.vocab is not None:
        model_cfg["vocab_size"] = args.vocab
    vocab = args.vocab or (512 if args.preset == "tiny" else 30522 if args.model == "bert"
                           else 50257)
    # the most rows a step takes: the widest data x fsdp of the meshes
    rows = args.gas * args.micro * max(m["data"] * m["fsdp"] for m in meshes.values())
    batches = os.path.join(root, "batches.npz")
    if args.model == "bert":
        from deepspeed_tpu_torch.tools.profile_training import synthetic_mlm_batch

        per = [synthetic_mlm_batch(vocab, rows, args.seq, seed=s) for s in range(steps)]
        np.savez(batches, **{k: np.stack([b[k] for b in per]) for k in per[0]})
    else:
        np.savez(batches, input_ids=np.random.default_rng(0).integers(
            0, vocab, (steps, rows, args.seq), dtype=np.int32))
    base = {"device": args.device, "deterministic": args.device != "cuda", "threads": 4,
            "out": root}

    def cases(tag, micro, mesh, ss):
        return [{"name": f"{tag}_s{s}", "model": args.model, "preset": preset, "init_seed": 0,
                 "model_cfg": model_cfg, "config": _config(micro, args.gas, s, mesh, args.model),
                 "batches": batches, "steps": steps, "record": "none"} for s in ss]

    refs = {}
    for dp in sorted({m["data"] * m["fsdp"] for m in meshes.values()}):
        # world 1 on the mesh's global rows: flash attention (what ring and
        # Ulysses compute), no model or seq axis
        one = dict(cases(f"w1dp{dp}", args.micro * dp, mesh_of("d1"), [0])[0],
                   model_cfg={**model_cfg, "attention_mode": "flash"} if args.model == "gpt2"
                   else model_cfg)
        _spawn(1, dict(base, cases=[one]), root, f"w1dp{dp}", args.device)
        with open(os.path.join(root, f"w1dp{dp}_s0.json")) as f:
            refs[dp] = json.load(f)
    ok = True
    for name, mesh in meshes.items():
        _spawn(W, dict(base, collectives_check=True,
                       cases=cases(name, args.micro, mesh, mesh_stages[name])),
               root, name, args.device)
        with open(os.path.join(root, "collectives.json")) as f:
            coll = json.load(f)
        ok &= bool(coll["ok"])
        print(json.dumps({"mesh": name, "collectives_ok": coll["ok"],
                          "backend": coll["backend"], "world_size": coll["world_size"],
                          "collectives_max_err": max(r["max_err"] for r in coll["rows"])}),
              flush=True)
        ref = refs[mesh["data"] * mesh["fsdp"]]
        for s in mesh_stages[name]:
            with open(os.path.join(root, f"{name}_s{s}.json")) as f:
                r = json.load(f)
            model, extras, par = r["model"], r["extras"], r["parallel"] or {}
            equal = all(all(c.get(k, 0) == model[k] for k in KINDS)
                        and all(c.get(k, 0) == extras[k] for k in EXTRAS)
                        and all(c.get(k, 0) == par.get(k, 0) for k in PARALLEL)
                        for c in r["comm"])
            replicas = all(r["replicas_equal"].values())
            ok &= equal and replicas and all(np.isfinite(r["losses"]))
            print(json.dumps({
                "mesh": name, "sizes": mesh, "stage": s, "model": args.model,
                "attention_mode": args.attention_mode, "T": args.seq,
                "world_size": r["world_size"],
                "backend": r["backend"], "losses": r["losses"], "losses_world1": ref["losses"],
                "max_rel_loss_diff_vs_world1": float(np.max(
                    np.abs(np.array(r["losses"]) - ref["losses"]) / np.abs(ref["losses"]))),
                "step_ms": r["ms"], "step_ms_median_after_first": float(np.median(r["ms"][1:])),
                "world1_step_ms_median_after_first": float(np.median(ref["ms"][1:])),
                "peak_gib_by_rank": [None if b is None else b / 2**30
                                     for b in r["peak_bytes_by_rank"]],
                "world1_peak_gib": None if ref["peak_bytes"] is None else ref["peak_bytes"] / 2**30,
                "bytes_a_step": r["comm"][-1], "comm_model": model, "extras": extras,
                "parallel": par, "bytes_equal_model": equal, "replicas_equal": replicas,
                "n_params": r["n_params"],
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
