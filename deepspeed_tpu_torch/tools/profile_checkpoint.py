"""Where a checkpoint save and a load spend their time on the card.

    python -m deepspeed_tpu_torch.tools.profile_checkpoint [--dir DIR] [--seed 0]

Builds ``chip_smoke.py``'s ``train_bf16`` engine (GPT-2 124M in bf16 over
f32 masters, AdamW; random weights from ``--seed``), takes one step, then
times on the host clock, function by function (the snapshot to pinned
host memory, ``torch.save``, the manifest's hashing and fsyncs, the commit
rename, ``latest``, retention):

* a synchronous save;
* an async save: the caller's stall, the background commit's stages, and
  the longest the caller's thread waited for the interpreter lock while
  the commit ran (a probe thread that sleeps 1 ms at a time and records
  how late it wakes);
* a load: the manifest check, ``torch.load`` and the copy into the
  engine.

The tags go to ``--dir`` (default: a temporary directory, removed
after).  Prints one JSON line.  Needs a CUDA card; it raises without one.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from deepspeed_tpu_torch.resilience import atomic, manager
from deepspeed_tpu_torch.runtime import checkpointing

# (module, attribute) of every stage timed
STAGES = (
    (checkpointing, "_snapshot_state_to_host"),
    (checkpointing, "_write_state"),
    (atomic, "write_manifest"),
    (manager, "commit_tag"),
    (manager, "write_latest"),
    (manager, "retention_gc"),
    (manager, "verify_tag"),
    (torch, "load"),
    (checkpointing, "_finish_restore"),
)


class StageClock:
    """Wraps each stage; ``spans`` holds (thread, stage, start, end)."""

    def __init__(self):
        self.spans: List[tuple] = []
        self._real = {}

    def __enter__(self):
        for mod, name in STAGES:
            real = getattr(mod, name)
            self._real[(mod, name)] = real

            def timed(*a, _real=real, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **kw)
                finally:
                    self.spans.append((threading.current_thread().name, _name, t0,
                                       time.perf_counter()))

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for (mod, name), real in self._real.items():
            setattr(mod, name, real)

    def take(self) -> Dict[str, float]:
        """ms by stage (the calling and the commit thread's apart) since
        the last take."""
        out: Dict[str, float] = {}
        for thread, name, t0, t1 in self.spans:
            key = name if thread == "MainThread" else f"{name} (commit thread)"
            out[key] = out.get(key, 0.0) + (t1 - t0) * 1e3
        self.spans = []
        return out


class LockProbe:
    """A thread that sleeps 1 ms at a time: how late it wakes is how long
    another thread kept the interpreter lock (or the host's cores)."""

    def __init__(self):
        self.worst_ms = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="lock-probe")

    def _run(self):
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            self.worst_ms = max(self.worst_ms, (time.perf_counter() - t0) * 1e3 - 1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(5.0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None, help="where the tags go (default: a temporary dir)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_checkpoint measures the card: torch.cuda.is_available() is False")

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    cfg = gpt2.PRESETS["gpt2"]
    config = {
        "train_micro_batch_size_per_gpu": 8, "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "betas": [0.9, 0.95],
                                                  "weight_decay": 0.1}},
        "overlap": {"async_checkpoint": {"enabled": True}},
    }
    model_fn, init_fn, _ = gpt2.make_model(cfg)
    engine = deepspeed_tpu_torch.initialize(model=model_fn, model_parameters=init_fn(seed=args.seed),
                                            config=config)[0]
    ids = np.random.default_rng(args.seed).integers(0, cfg.vocab_size, (16, 1024), dtype=np.int32)
    float(engine.train_batch({"input_ids": ids}))
    root = args.dir or tempfile.mkdtemp()
    out = {"card": torch.cuda.get_device_name(0)}
    try:
        with StageClock() as clock:
            t0 = time.perf_counter()
            path = engine.save_checkpoint(os.path.join(root, "sync"), async_save=False)
            out["sync_save_ms"] = (time.perf_counter() - t0) * 1e3
            out["sync_stages_ms"] = clock.take()
            out["tag_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                   for d, _, fs in os.walk(path) for f in fs)

            with LockProbe() as probe:
                t0 = time.perf_counter()
                engine.save_checkpoint(os.path.join(root, "async"), async_save=True)
                out["async_stall_ms"] = (time.perf_counter() - t0) * 1e3
                pend = engine._async_writer.drain()
            out["async_commit_ms"] = (pend.finished_at - pend.started_at) * 1e3
            out["async_ok"] = pend.ok
            out["async_stages_ms"] = clock.take()
            out["async_worst_lock_wait_ms"] = probe.worst_ms

            fresh = deepspeed_tpu_torch.initialize(model=model_fn,
                                                   model_parameters=init_fn(seed=args.seed + 1),
                                                   config=config)[0]
            t0 = time.perf_counter()
            fresh.load_checkpoint(os.path.join(root, "sync"))
            out["load_ms"] = (time.perf_counter() - t0) * 1e3
            out["load_stages_ms"] = clock.take()
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
