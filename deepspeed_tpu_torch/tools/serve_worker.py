"""One rank of a tensor-parallel inference or serving run: builds the
engines of a JSON spec's cases and drives them as every rank of the run
does, writing what each rank produced.

Run it once per rank under a launcher environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; or the
spec's ``init_method``, such as ``file:///tmp/store`` for ranks on one
host)::

    RANK=0 WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=29511 \\
        python -m deepspeed_tpu_torch.tools.serve_worker spec.json

It imports torch and the port only.  The spec::

    {"device": "cpu" | "cuda", "init_method": null, "threads": 1,
     "deterministic": true, "out": "<dir>",
     "train_cases": [<tools/zero_worker.py cases, run first: a tag to serve>],
     "cases": [{"name": "g2",
                "engine": {"model": "tiny" | null, "family": "gpt2" | "bert",
                           "preset": "tiny", "model_cfg": {...}, "mp_size": 2,
                           "dtype": "float32" | "bfloat16", "params": "<npz>",
                           "checkpoint": "<dir>", "checkpoint_tag": null,
                           "init_on_device": false, "seed": 0, "quantize_bits": 0,
                           "kv_cache_dtype": "model" | "int8", "max_out_tokens": 128},
                "clock_skew": {"rank": 1, "seconds": 1000.0},
                "drives": [...]}]}

``params`` is an npz of the whole tree by ``/``-joined leaf path (the
JAX package's names).  The drives, in order, each recorded under its
index ``i``:

* ``{"kind": "forward", "inputs": "<npz: input_ids[, token_type_ids,
  attention_mask]>"}``: ``engine.forward``; array ``d<i>``.
* ``{"kind": "generate", "inputs": "<npz: input_ids[, attention_mask]>",
  "max_new_tokens": 8, "do_sample": false, "temperature": 1.0, "top_k":
  0, "seed": 0}``: array ``d<i>``.
* ``{"kind": "cache", "batch": 2, "max_len": 16}``: the shape of a leaf
  of ``init_cache`` (``init_kv_cache``'s ``q`` for int8).
* ``{"kind": "shapes"}``: every parameter block's shape on this rank.
* ``{"kind": "params"}``: every parameter block of this rank, by leaf
  path (a packed int8 weight's ``.../q`` and ``.../s``), in
  ``<out>/<name>.r<rank>.d<i>.npz`` (``file``).
* ``{"kind": "serve", "serving": {...}, "requests": [{"prompt": [...],
  "max_new_tokens": 6, ...submit kwargs}], "first": 3, "steps": 2}``:
  ``init_serving`` over the case's engine; the first ``first`` requests,
  ``steps`` steps, the rest, a drain (``first`` null: all, then a
  drain).  ``"refusals": true`` records each submit's refusal (its
  exception's type name, null when admitted) in ``refused`` instead of
  raising; ``"cancel": [i, ...]`` then cancels the ``i``-th request (an
  ``i`` past the list: an id no submit gave), recording each answer in
  ``cancelled``.  ``"mix": "request" | "paged"`` with ``"mix_seed"`` serves
  ``tools/profile_serving.py``'s ``request_mix`` or
  ``paged_request_mix`` instead; ``"warmup": n`` first drains ``n``
  requests of the mix at 4 new tokens (before the counts start).
  ``"session": {"first": [...], "tails": [[...], ...],
  "max_new_tokens": 4, "session_id": "chat", "spill_after": [0, ...],
  "drop_manifest": {"rank": 1, "after": 1}}`` then serves a session's
  turns (each prompt the previous turn's tokens plus a tail); after each
  turn listed in ``spill_after`` every rank spills its warm sessions,
  and ``drop_manifest`` deletes one rank's spill manifests after a turn,
  so the next restore must fail on every rank.  ``kvcache_requests``
  holds the paged pool's counters before the session.  ``"profile":
  true`` traces the drive under ``torch.profiler`` (``profile``: its
  ``tools/profile_serving.py`` ``profile_summary``).
* ``{"kind": "recover", "serving": {...}, "requests": [...],
  "kill_at_decode": 3, "tiers_built": true}``: a journaled engine
  (``<out>/journal_<name>_<i>``, written by rank 0) serves the requests
  until every rank dies of an ``InjectedKill`` at its
  ``kill_at_decode``-th decode; a fresh engine over the same journal
  runs ``recover()`` (a collective) and a drain: ``ids`` the killed
  run's ids, ``replayed`` the replayed ids, ``tokens`` their tokens in
  that order.  ``tiers_built`` first builds a tiered paged engine under
  the group and records its disk tier's directory below the one it was
  given (``tiers_disk_dir``: the rank's own).
* ``{"kind": "tiers", "serving": {... "kvcache": {..., "tiers": {...}}},
  "sessions": 4, "turns": 3, "seed": 3, "max_new_tokens": 4, "new_tokens": 10,
  "flush": true,
  "corrupt": {"rank": 1, "session": "sess-0"}}``: :func:`tier_turns`'s
  session schedule on the paged pool without tiers (``reference``), then
  on the tiered pool (``tokens``; the disk tier under
  ``<out>/tiers_<name>_<i>``, a directory a rank): before the last turn
  ``flush`` pushes every warm session to disk, and ``corrupt`` overwrites
  one rank's disk copies of one session (``dropped``), whose restore must
  then fail verification there and miss on every rank.  ``tier_counts``:
  the tier manager's counters.
* ``{"kind": "sigterm", "serving": {...}, "requests": [...], "steps": 2}``:
  a journaled engine with the watchdog on every rank serves the requests;
  after ``steps`` steps rank 0 alone sends itself SIGTERM, and every rank
  steps until the drain exits: ``exit_code``, ``steps`` (the engine's
  step count at the exit), ``undone`` and the drained ``tokens``.

Each drive records the bytes counted by kind (``comm/collectives.py``)
and what the inference byte model gives for the same forwards
(``InferenceEngine.comm_model``), the kernel launches, its wall seconds
and, for ``serve``, the served tokens, TTFTs and ``stats()``.  Every rank
writes ``<out>/<name>.r<rank>.npz`` (arrays) and ``<name>.r<rank>.json``;
``clock_skew`` adds ``seconds`` to one rank's ``time.monotonic`` for the
case (the serving engine must plan on rank 0's clock).
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _family(engine_spec):
    if engine_spec.get("family", "gpt2") == "bert":
        from deepspeed_tpu_torch.models import bert as mod
    else:
        from deepspeed_tpu_torch.models import gpt2 as mod
    return mod


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def build_engine(spec, device):
    """``init_inference`` from a case's ``engine`` block."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.engine import tree_from_paths

    kw = dict(spec)
    mod = _family(kw)
    for key in ("family", "preset"):
        kw.pop(key, None)
    overrides = kw.pop("model_cfg", None)
    if kw.get("model") is None:
        kw.pop("model", None)
        kw["model_config"] = dataclasses.replace(mod.PRESETS[spec.get("preset", "tiny")],
                                                 **(overrides or {}))
    if "params" in kw:
        kw["params"] = tree_from_paths(_npz(kw["params"]))
    kw["dtype"] = _DTYPES[kw.get("dtype", "float32")]
    return deepspeed_tpu_torch.init_inference(device=device, **kw)


def _serving_model_bytes(srv):
    """The inference byte model summed over the forwards a serving engine
    ran: a prefill chunk is one row of ``prefill_chunk`` positions whose
    one sampled row's logits are gathered, a decode step every slot's one
    position."""
    eng, out = srv.engine, {}
    chunk = eng.comm_model(1, srv.config.prefill_chunk, logits_rows=1)
    step = eng.comm_model(srv.pool.num_slots, 1)
    for kind in set(chunk) | set(step):
        out[kind] = (srv.prefill_chunks * chunk.get(kind, 0)
                     + srv.decode_steps * step.get(kind, 0))
    return out


def _submit_all(srv, reqs, refused=None):
    """Each request's id.  With a ``refused`` list, a refused submit gives
    None and appends its exception's type name (an admitted one None)."""
    from deepspeed_tpu_torch.serving import ServingQueueFull

    ids = []
    for r in reqs:
        try:
            ids.append(srv.submit(np.asarray(r["prompt"], np.int32),
                                  **{k: v for k, v in r.items() if k != "prompt"}))
        except (ValueError, ServingQueueFull) as e:
            if refused is None:
                raise
            ids.append(None)
            refused.append(type(e).__name__)
            continue
        if refused is not None:
            refused.append(None)
    return ids


def _serve(engine, drive, rec, spill_root):
    from deepspeed_tpu_torch.comm import collectives
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.tools import profile_serving as ps

    serving = dict(drive.get("serving", {}))
    kvc = dict(serving.get("kvcache", {}))
    if kvc.get("spill_dir") == "auto":
        kvc["spill_dir"] = spill_root
        serving["kvcache"] = kvc
    srv = ServingEngine(engine, config=serving)
    mix = drive.get("mix")
    if drive.get("warmup"):
        for p, _ in ps.request_mix(int(drive.get("mix_seed", 0)) + 1)[:int(drive["warmup"])]:
            srv.submit(p, max_new_tokens=4)
        srv.drain()
        srv.prefill_chunks = srv.decode_steps = 0
        srv._phase_seconds = {k: 0.0 for k in srv._phase_seconds}
        _sync(engine)
        collectives.reset_counts()
        kernels.reset_launches()
        if engine.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(engine.device)
    _sync(engine)
    prof = None
    if drive.get("profile"):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    if mix == "request":
        done = ps.drain_request_mix(srv, ps.request_mix(int(drive.get("mix_seed", 0))))
    elif mix == "paged":
        done, turns = ps.drain_paged_mix(srv, ps.paged_request_mix(int(drive.get("mix_seed", 0))))
        done = done + turns
    else:
        reqs = drive["requests"]
        first = drive.get("first") or len(reqs)
        refused = [] if drive.get("refusals") else None
        rids = _submit_all(srv, reqs[:first], refused)
        for _ in range(int(drive.get("steps", 0))):
            srv.step()
        rids += _submit_all(srv, reqs[first:], refused)
        # a listed request's id, or past the list one no submit gave
        rec["cancelled"] = [srv.cancel(rids[i] if i < len(rids) else 10 ** 9)
                            for i in drive.get("cancel", [])]
        res = srv.drain()
        done = [res[r] for r in rids if r is not None]
        rec["ids"], rec["refused"] = rids, refused
    sess = drive.get("session")
    restores = []
    rec["kvcache_requests"] = srv.pool.stats() if hasattr(srv.pool, "stats") else None
    if sess is not None:
        prompt, turn = np.asarray(sess["first"], np.int32), None
        for i, tail in enumerate([None, *sess["tails"]]):
            if tail is not None:
                prompt = np.concatenate([turn.tokens(), np.asarray(tail, np.int32)])
            rid = srv.submit(prompt, max_new_tokens=int(sess["max_new_tokens"]),
                             session_id=sess.get("session_id", "chat"))
            turn = srv.drain()[rid]
            done.append(turn)
            restores.append(srv.pool.stats()["session_restores"])
            if i in sess.get("spill_after", []):
                srv.pool.spill_sessions(srv._now)
            drop = sess.get("drop_manifest")
            if (drop is not None and int(drop["after"]) == i
                    and engine.mesh.rank == int(drop["rank"])):
                root = srv.pool.sessions.spill_dir
                for name in os.listdir(root):
                    os.remove(os.path.join(root, name, "manifest.json"))
    _sync(engine)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        rec["profile"] = ps.profile_summary(prof)
    st = srv.stats()
    served = [r for r in done if r.first_token_time is not None]  # not a cancelled waiter
    ttft = [(r.first_token_time - r.submit_time) * 1e3 for r in served]
    n_tok = int(sum(len(r.generated) for r in served))
    rec.update({
        "tokens": [r.tokens().tolist() for r in done],
        "finish": [r.finish_reason for r in done],
        "prefix_hints": [int(getattr(r, "prefix_hint", 0) or 0) for r in done],
        "ttft_ms": ttft, "wall_s": wall, "tokens_generated": n_tok,
        "decode_tokens_per_s": ((n_tok - len(served)) / st["phase_seconds"]["decode"]
                                if st["phase_seconds"]["decode"] else None),
        "stats": st, "session_restores_by_turn": restores,
        "pool_heads": srv.pool.heads, "pool_bytes": srv.pool.cache_bytes(),
        "model_bytes": _serving_model_bytes(srv),
    })


# the tier manager's counters that every rank must agree on (its timings
# and the worker's queue depth are a rank's own)
TIER_COUNTS = ("demote_t0_t1", "demote_t1_t2", "promote_t1_t0", "promote_t2_t1",
               "promote_t2_t0", "tail_demotions", "tail_promotions", "hits_t1", "hits_t2",
               "tier_misses", "tier_drops", "prefetch_jobs", "host_entries", "host_pages",
               "disk_entries", "disk_pages")


def tier_turns(srv, sessions=4, turns=3, seed=3, max_new_tokens=4, new_tokens=10,
               before_last=None):
    """A seeded multi-turn schedule of ``sessions`` sessions (each turn a
    session's history plus ``new_tokens`` new tokens, greedy): the
    generated tokens by turn, then session.  ``before_last(srv)`` runs
    before the last turn."""
    rng = np.random.default_rng(int(seed))
    hist, out = {}, []
    for turn in range(int(turns)):
        if turn == int(turns) - 1 and before_last is not None:
            before_last(srv)
        batch = []
        for s in range(int(sessions)):
            sid = f"sess-{s}"
            prompt = np.concatenate([hist.get(sid, np.array([], np.int32)),
                                     rng.integers(1, srv.engine.model_config.vocab_size,
                                                  int(new_tokens), dtype=np.int32)]
                                    ).astype(np.int32)
            batch.append((srv.submit(prompt, max_new_tokens=int(max_new_tokens),
                                     session_id=sid), sid, prompt))
        res = srv.drain(max_steps=5000)
        row = []
        for rid, sid, prompt in batch:
            gen = np.asarray(res[rid].generated, np.int32)
            hist[sid] = np.concatenate([prompt, gen]).astype(np.int32)
            row.append(gen.tolist())
        out.append(row)
    return out


def _tiers(engine, drive, rec, disk_root):
    from deepspeed_tpu_torch.serving import ServingEngine

    serving = dict(drive["serving"])
    kvc = dict(serving["kvcache"])
    tiers = dict(kvc.pop("tiers", {}), enabled=True, disk_dir=disk_root)
    kw = {k: drive[k] for k in ("sessions", "turns", "seed", "max_new_tokens", "new_tokens")
          if k in drive}
    rec["reference"] = tier_turns(ServingEngine(engine, config={**serving, "kvcache": kvc}), **kw)
    srv = ServingEngine(engine, config={**serving, "kvcache": {**kvc, "tiers": tiers}})
    drop = drive.get("corrupt")
    rec["dropped"] = []

    def before_last(srv):
        if drive.get("flush"):
            srv._tiers.flush(srv._note_time())
        if drop is not None and engine.mesh is not None and engine.mesh.rank == int(drop["rank"]):
            from deepspeed_tpu_torch.serving.kvcache.sessions import DATA_FILE, session_dir_name

            base = session_dir_name(drop["session"]) + "-g"
            root = srv._tiers.disk_dir
            for name in sorted(os.listdir(root)):
                if name.startswith(base):  # its manifest's digest no longer matches
                    with open(os.path.join(root, name, DATA_FILE), "r+b") as f:
                        f.write(b"\0" * 64)
                    rec["dropped"].append(name)

    t0 = time.perf_counter()
    rec["tokens"] = tier_turns(srv, before_last=before_last, **kw)
    rec["wall_s"] = time.perf_counter() - t0
    st = srv.stats()["kvcache"]["tiers"]
    rec["tier_counts"] = {k: st[k] for k in TIER_COUNTS}
    rec["tier_moves"] = {k: st[k] for k in ("gather_ms_per_page", "scatter_ms_per_page",
                                            "gather_pages", "scatter_pages",
                                            "swap_hidden_ratio")}
    rec["disk_dir"] = srv._tiers.disk_dir
    rec["decode_steps"] = srv.decode_steps
    rec["session_rebinds"] = srv.stats()["kvcache"]["session_rebinds"]
    srv._tiers.close()


def _recover(engine, drive, rec, journal_dir):
    from deepspeed_tpu_torch.resilience import faults
    from deepspeed_tpu_torch.serving import ServingEngine

    if drive.get("tiers_built"):
        # a tiered paged engine under the group: built on every rank, its
        # disk tier in a directory of the rank's own
        tiered = ServingEngine(engine, config={"kvcache": {
            "enabled": True, "page_len": 16,
            "tiers": {"enabled": True, "disk_dir": journal_dir + "_t2"}}})
        rec["tiers_disk_dir"] = os.path.relpath(tiered._tiers.disk_dir, journal_dir + "_t2")
        tiered._tiers.close()
    serving = {**drive.get("serving", {}), "journal_dir": journal_dir}
    srv = ServingEngine(engine, config=serving)
    rec["ids"] = _submit_all(srv, drive["requests"])
    killed = False
    try:
        with faults.FaultInjector(seed=0).kill("serving.decode",
                                               after=int(drive["kill_at_decode"]) - 1):
            srv.drain()
    except faults.InjectedKill:
        killed = True
    rec["killed"] = killed
    fresh = ServingEngine(engine, config=serving)
    rec["replayed"] = fresh.recover()
    res = fresh.drain()
    rec["tokens"] = [res[r].tokens().tolist() for r in rec["replayed"]]
    rec["finish"] = [res[r].finish_reason for r in rec["replayed"]]


def _sigterm(engine, drive, rec, journal_dir):
    import signal

    from deepspeed_tpu_torch.serving import ServingEngine

    srv = ServingEngine(engine, config={**drive.get("serving", {}), "journal_dir": journal_dir})
    rec["ids"] = _submit_all(srv, drive["requests"])
    wd = srv.install_watchdog(drain_deadline_seconds=600.0)
    try:
        for _ in range(int(drive.get("steps", 0))):
            srv.step()
        if engine.mesh.rank == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        try:
            while True:
                srv.step()
        except SystemExit as e:
            rec["exit_code"] = e.code
    finally:
        wd.uninstall()
    rec["steps"] = srv._step_count
    rec["undone"] = srv.scheduler.pending_ids()
    done = srv.scheduler.pop_finished()
    rec["tokens"] = [done[r].tokens().tolist() for r in sorted(done)]


def _sync(engine):
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def run_case(case, device, out_dir, rank):
    from deepspeed_tpu_torch.comm import collectives
    from deepspeed_tpu_torch.ops import kernels

    skew = case.get("clock_skew")
    real_monotonic = time.monotonic
    if skew is not None and rank == int(skew["rank"]):
        time.monotonic = lambda: real_monotonic() + float(skew["seconds"])
    try:
        engine = build_engine(case["engine"], device)
        arrays, recs = {}, []
        cuda = engine.device.type == "cuda"
        for i, drive in enumerate(case.get("drives", [])):
            kind = drive["kind"]
            rec = {"kind": kind}
            if cuda:
                torch.cuda.reset_peak_memory_stats(engine.device)
            collectives.reset_counts()
            kernels.reset_launches()
            _sync(engine)
            t0 = time.perf_counter()
            if kind == "forward":
                x = _npz(drive["inputs"])
                ids = x.pop("input_ids")
                out = engine.forward(ids, **x)
                arrays[f"d{i}"] = out.float().cpu().numpy()
                B, T = ids.shape
                act = out.element_size()
                rec["model_bytes"] = engine.comm_model(B, T, logits_bytes=act)
            elif kind == "generate":
                x = _npz(drive["inputs"])
                kw = {k: drive[k] for k in ("max_new_tokens", "do_sample", "temperature",
                                            "top_k", "seed") if k in drive}
                arrays[f"d{i}"] = engine.generate(x["input_ids"],
                                                  attention_mask=x.get("attention_mask"), **kw)
                B, T = x["input_ids"].shape
                first = engine.comm_model(B, T, logits_rows=1)
                step = engine.comm_model(B, 1)
                n = int(drive.get("max_new_tokens", 32)) - 1
                rec["model_bytes"] = {k: first.get(k, 0) + n * step.get(k, 0)
                                      for k in set(first) | set(step)}
            elif kind == "cache":
                k, _ = engine.init_cache(int(drive["batch"]), int(drive["max_len"]))
                rec["shape"] = list((k["q"] if isinstance(k, dict) else k).shape)
            elif kind == "shapes":
                from deepspeed_tpu_torch.runtime.engine import tree_items

                leaves = tree_items(engine.params)
                rec["shapes"] = {p: list(t.shape) for p, t in leaves}
                rec["dtypes"] = sorted({str(t.dtype) for _, t in leaves})
                rec["finite"] = all(bool(torch.isfinite(t).all()) for _, t in leaves)
            elif kind == "params":
                from deepspeed_tpu_torch.runtime.engine import tree_items

                rec["file"] = os.path.join(out_dir, f"{case['name']}.r{rank}.d{i}.npz")
                np.savez(rec["file"], **{path: (t.cpu() if t.dtype == torch.int8
                                                else t.float().cpu()).numpy()
                                         for path, t in tree_items(engine.params)})
            elif kind == "tiers":
                _tiers(engine, drive, rec, os.path.join(out_dir, f"tiers_{case['name']}_{i}"))
            elif kind == "serve":
                _serve(engine, drive, rec, os.path.join(out_dir, f"spill_{case['name']}_{i}"))
            elif kind in ("recover", "sigterm"):
                fn = _recover if kind == "recover" else _sigterm
                fn(engine, drive, rec, os.path.join(out_dir, f"journal_{case['name']}_{i}"))
            else:
                raise ValueError(f"unknown drive kind {kind!r}")
            _sync(engine)
            rec["seconds"] = time.perf_counter() - t0
            rec["comm"] = collectives.counts()
            rec["launches"] = {n: c for n, c in kernels.launches().items() if c}
            rec["variants"] = {n: v for n, v in kernels.launch_variants().items() if v}
            rec["peak_bytes"] = (int(torch.cuda.max_memory_allocated(engine.device)) if cuda
                                 else None)
            recs.append(rec)
    finally:
        time.monotonic = real_monotonic
    result = {
        "name": case["name"], "rank": rank, "drives": recs, "mp_size": engine.mp_world_size,
        "mesh": None if engine.mesh is None else engine.mesh.sizes,
        "local_heads": engine.local_heads,
        "world_size": (torch.distributed.get_world_size()
                       if torch.distributed.is_initialized() else 1),
        "backend": (torch.distributed.get_backend() if torch.distributed.is_initialized()
                    else None),
    }
    base = os.path.join(out_dir, f"{case['name']}.r{rank}")
    np.savez(base + ".npz", **arrays)
    with open(base + ".json", "w") as f:
        json.dump(result, f)
    del engine
    if device == "cuda":
        torch.cuda.empty_cache()


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
    if not distributed.init_distributed(init_method=spec.get("init_method"), device=device):
        raise SystemExit("serve_worker: no launcher environment (RANK, WORLD_SIZE)")
    os.makedirs(spec["out"], exist_ok=True)
    try:
        if spec.get("train_cases"):
            from deepspeed_tpu_torch.tools import zero_worker

            for case in spec["train_cases"]:
                zero_worker.run_case(case, device, spec["out"], distributed.get_rank())
        for case in spec.get("cases", []):
            run_case(case, device, spec["out"], distributed.get_rank())
    finally:
        distributed.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
