"""Serving chaos run: a real ``kill -9`` mid-decode, a SIGTERM mid-drain on
the tiered paged engine, and two tenants under a page quota, each in
child processes, each held bit for bit against an uninterrupted run
(counterpart of the repo's ``tools/serving_chaos.py``).

    python -m deepspeed_tpu_torch.tools.serving_chaos                 # GPT-2 124M, bf16, the card
    python -m deepspeed_tpu_torch.tools.serving_chaos --device cpu    # GPT2_TINY, f32, the CPU
        [--scenarios kill9,sigterm,tenants] [--root DIR] [--out result.json]

On the card every child builds GPT-2 124M at full width (12 layers, 12
heads, d 768, vocab 50257) with weights drawn on the device from a seed
(``init_on_device``), in bf16; on the CPU GPT2_TINY in f32 from the host
init.  Children are re-invocations of this module (``--role``); each
writes one JSON file and reports the kernel launches of its serving
drive.

* ``kill9``: a slot-pool victim with a journal serves 8 requests (7
  greedy, 1 seeded sampling) under ``DS_FAULT_PLAN`` ``{"site":
  "serving.decode", "action": "sigkill"}`` at its 3rd decode — no Python
  unwinding, no atexit.  A fresh child runs ``recover()`` over the
  journal and drains.  The parent holds: the victim died to SIGKILL, the
  replayed ids are the journal's incomplete set, and every replayed
  request's tokens equal the uninterrupted run's (``kill9_reference``).
* ``sigterm``: a tiered paged engine with a journal and the watchdog
  serves turn 1 of every session, submits turn 2 (more sessions than
  slots), then sends itself SIGTERM: the next step drains the in-flight
  turns, flushes every warm session to disk, commits the journal and
  exits 43.  A fresh child runs ``recover()`` (the queued turns replay,
  rebinding their sessions from disk) and then turn 3 of every session.
  Every turn's tokens equal the uninterrupted run's (``sigterm_reference``)
  and the recovered engine hit disk (``hits_t2`` >= 1).
* ``tenants``: two tenants on a journaled paged engine, one with
  ``kv_pages_max`` below its requests' need: that tenant's allocations
  defer (``quota_defers`` > 0, the other's 0), every request's tokens
  equal the same requests on the engine without tenants, and the
  registry's bill equals ``journal_tenant_totals`` over the journal.

Prints one JSON line (``"ok"`` and each scenario's numbers) and exits 0
only when every check held.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENARIOS = ("kill9", "sigterm", "tenants")
KILL_AT_DECODE = 3  # the victim dies at its 3rd decode step
N_KILL9 = 8
SAMPLED = 2  # the one seeded-sampling request of the kill9 workload
EXIT_DRAINED = 43


# -- sizes: the card's GPT-2 124M, the CPU's GPT2_TINY --------------------

def sizes(device: str) -> Dict[str, Any]:
    if device == "cuda":
        return {"chunk": 64, "max_len": 1024, "page_len": 128, "slots": 8,
                "kill9_prompt": (64, 256), "kill9_new": 32,
                "sessions": 6, "sess_slots": 4, "tail": (96, 192), "turn_new": 32,
                "num_pages": 160, "tiers": {"host_pages": 12, "demote_watermark": 0.3,
                                            "residency_window": 256, "demote_batch": 8,
                                            "prefetch_ahead": 2},
                "tenant_reqs": 4, "tenant_prompt": (160, 220), "tenant_new": 32,
                "tenant_pages": 3, "tenant_slots": 8}
    return {"chunk": 8, "max_len": 64, "page_len": 16, "slots": 2,
            "kill9_prompt": (4, 20), "kill9_new": 5,
            "sessions": 3, "sess_slots": 2, "tail": (8, 12), "turn_new": 4,
            "num_pages": 24, "tiers": {"host_pages": 4, "demote_watermark": 0.25,
                                       "residency_window": 16, "demote_batch": 8,
                                       "prefetch_ahead": 2},
            "tenant_reqs": 3, "tenant_prompt": (10, 14), "tenant_new": 4,
            "tenant_pages": 3, "tenant_slots": 4}


def make_engine(device: str):
    """The children's one inference engine: the same weights in every
    process (a seed), the same card or CPU."""
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import gpt2

    if device == "cuda":
        return deepspeed_tpu_torch.init_inference(
            model="gpt2", dtype=torch.bfloat16, init_on_device=True, seed=0,
            max_out_tokens=1024)
    torch.set_num_threads(1)  # the CPU children run side by side
    cfg = gpt2.GPT2_TINY
    params = gpt2.init_params(cfg, seed=7)
    params["wpe"] = params["wpe"] * 40.0  # positions matter: bookkeeping bugs show
    return deepspeed_tpu_torch.init_inference(
        model_config=cfg, params=params, dtype=torch.float32, device="cpu",
        max_out_tokens=cfg.n_positions)


def _vocab(eng) -> int:
    return int(eng.model_config.vocab_size)


def kill9_workload(z, vocab, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = z["kill9_prompt"]
    return [rng.integers(1, vocab, int(rng.integers(lo, hi + 1)), dtype=np.int32)
            for _ in range(N_KILL9)]


def session_tails(z, vocab, seed=1):
    """tails[turn][session]: each turn's new prompt tokens."""
    rng = np.random.default_rng(seed)
    lo, hi = z["tail"]
    return [[rng.integers(1, vocab, int(rng.integers(lo, hi + 1)), dtype=np.int32)
             for _ in range(z["sessions"])] for _ in range(3)]


def tenant_prompts(z, vocab, seed=2):
    rng = np.random.default_rng(seed)
    lo, hi = z["tenant_prompt"]
    return [(tenant, rng.integers(1, vocab, int(rng.integers(lo, hi + 1)), dtype=np.int32))
            for _ in range(z["tenant_reqs"]) for tenant in ("capped", "open")]


def _paged(z, root: Optional[str], journal: bool = True, tiers: bool = True,
           slots: Optional[int] = None) -> Dict[str, Any]:
    kv: Dict[str, Any] = {"enabled": True, "page_len": z["page_len"],
                          "num_pages": z["num_pages"]}
    if tiers:
        kv["tiers"] = {"enabled": True, "disk_dir": os.path.join(root, "t2"), **z["tiers"]}
    cfg: Dict[str, Any] = {"num_slots": slots or z["slots"], "prefill_chunk": z["chunk"],
                           "max_len": z["max_len"], "kvcache": kv}
    if journal:
        cfg["journal_dir"] = os.path.join(root, "journal")
    return cfg


# -- the children ----------------------------------------------------------

def _launches_reset():
    from deepspeed_tpu_torch.ops import kernels

    kernels.reset_launches()


def _launches() -> Dict[str, int]:
    from deepspeed_tpu_torch.ops import kernels

    return {k: int(v) for k, v in kernels.launches().items() if v}


def _submit_kill9(srv, prompts, new):
    rids = []
    for i, p in enumerate(prompts):
        kw = dict(do_sample=True, temperature=0.9, top_k=8, seed=123) if i == SAMPLED else {}
        rids.append(srv.submit(p, max_new_tokens=new, **kw))
    return rids


def _tokens(res) -> Dict[str, List[int]]:
    return {str(rid): [int(t) for t in r.tokens()] for rid, r in res.items()}


def role_kill9(device: str, root: str, role: str) -> Dict[str, Any]:
    from deepspeed_tpu_torch.resilience import faults
    from deepspeed_tpu_torch.serving import ServingEngine

    eng = make_engine(device)
    z = sizes(device)
    cfg = {"num_slots": z["slots"], "prefill_chunk": z["chunk"], "max_len": z["max_len"],
           "journal_dir": os.path.join(root, "journal")}
    srv = ServingEngine(eng, cfg)
    prompts = kill9_workload(z, _vocab(eng))
    _launches_reset()
    if role == "kill9_victim":
        faults.install_from_env(rank=0)
        _submit_kill9(srv, prompts, z["kill9_new"])
        srv.drain()
        raise SystemExit("the victim was not killed: the fault plan did not fire")
    replayed = srv.recover() if role == "kill9_recover" else []
    if role == "kill9_reference":
        _submit_kill9(srv, prompts, z["kill9_new"])
    res = srv.drain()
    return {"replayed": replayed, "tokens": _tokens(res), "launches": _launches()}


def _turn(srv, tails, hist, turn, n_new):
    """Submit ``turn`` of every session: its prompt is the previous turn's
    tokens plus the turn's tail.  Returns sid -> rid."""
    rids = {}
    for s, tail in enumerate(tails[turn]):
        sid = f"chat-{s}"
        prompt = tail if turn == 0 else np.concatenate([hist[sid], tail]).astype(np.int32)
        rids[sid] = srv.submit(prompt, max_new_tokens=n_new, session_id=sid)
    return rids


def role_sigterm(device: str, root: str, role: str) -> Dict[str, Any]:
    from deepspeed_tpu_torch.serving import ServingEngine

    eng = make_engine(device)
    z = sizes(device)
    srv = ServingEngine(eng, _paged(z, root, slots=z["sess_slots"]))
    tails = session_tails(z, _vocab(eng))
    out: Dict[str, Any] = {"turns": {}}
    _launches_reset()
    if role in ("sigterm_victim", "sigterm_reference"):
        hist: Dict[str, np.ndarray] = {}
        n_turns = 3 if role == "sigterm_reference" else 2
        for turn in range(n_turns):
            rids = _turn(srv, tails, hist, turn, z["turn_new"])
            out["turns"][str(turn)] = {sid: int(rid) for sid, rid in rids.items()}
            if role == "sigterm_victim" and turn == 1:
                srv.install_watchdog(drain_deadline_seconds=600.0)
                srv.step()
                srv.step()
                os.kill(os.getpid(), signal.SIGTERM)
                try:
                    while True:
                        srv.step()
                except SystemExit as e:
                    out["exit_code"] = e.code
                    out.setdefault("tokens", {}).update(_tokens(srv.scheduler._finished))
                    out["tiers"] = srv.pool.stats()["tiers"]
                    out["launches"] = _launches()
                    _write(root, role, out)
                    raise
            res = srv.drain()
            for sid, rid in rids.items():
                hist[sid] = res[rid].tokens()
            out.setdefault("tokens", {}).update(_tokens(res))
        out["tiers"] = srv.pool.stats()["tiers"]
        out["launches"] = _launches()
        return out
    # sigterm_recover: replay the journal's undone turns, then turn 3
    with open(os.path.join(root, "sigterm_victim.json")) as f:
        victim = json.load(f)
    replayed = srv.recover()
    res = srv.drain()
    tokens = dict(victim["tokens"])
    tokens.update(_tokens(res))
    hist = {sid: np.asarray(tokens[str(rid)], np.int32)
            for sid, rid in victim["turns"]["1"].items()}
    rids = _turn(srv, tails, hist, 2, z["turn_new"])
    res3 = srv.drain()
    out.update({"replayed": replayed, "tokens": {**_tokens(res), **_tokens(res3)},
                "turn2": {sid: [int(t) for t in hist[sid]] for sid in hist},
                "turns": {"2": {sid: int(rid) for sid, rid in rids.items()}},
                "tiers": srv.pool.stats()["tiers"], "launches": _launches()})
    return out


def role_tenants(device: str, root: str) -> Dict[str, Any]:
    from deepspeed_tpu_torch.serving import ServingEngine, journal_tenant_totals

    eng = make_engine(device)
    z = sizes(device)
    reqs = tenant_prompts(z, _vocab(eng))
    cfg = _paged(z, root, tiers=False, slots=z["tenant_slots"])
    cfg["tenants"] = {"enabled": True,
                      "overrides": {"capped": {"kv_pages_max": z["tenant_pages"]}}}
    srv = ServingEngine(eng, cfg)
    _launches_reset()
    rids = [srv.submit(p, max_new_tokens=z["tenant_new"], tenant=t) for t, p in reqs]
    res = srv.drain()
    launches = _launches()
    snap = srv.stats()["tenants"]
    # the same requests without tenants: the tokens to equal
    plain = ServingEngine(eng, _paged(z, os.path.join(root, "plain"), tiers=False,
                                      slots=z["tenant_slots"]))
    prids = [plain.submit(p, max_new_tokens=z["tenant_new"]) for _, p in reqs]
    pres = plain.drain()
    return {"tenants": [t for t, _ in reqs],
            "tokens": [[int(x) for x in res[r].tokens()] for r in rids],
            "plain_tokens": [[int(x) for x in pres[r].tokens()] for r in prids],
            "snapshot": snap, "journal": journal_tenant_totals(os.path.join(root, "journal")),
            "pool_defers": srv.pool.stats()["tenant_quota_defers"], "launches": launches}


def _write(root: str, role: str, out: Dict[str, Any]) -> None:
    with open(os.path.join(root, f"{role}.json"), "w") as f:
        json.dump(out, f)


def run_child(device: str, root: str, role: str) -> None:
    if role.startswith("kill9"):
        out = role_kill9(device, root, role)
    elif role.startswith("sigterm"):
        out = role_sigterm(device, root, role)
    else:
        out = role_tenants(device, root)
    _write(root, role, out)


# -- the parent --------------------------------------------------------------

def _spawn(device: str, root: str, role: str, plan: Optional[str] = None,
           timeout: float = 900.0) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DS_FAULT_PLAN", None)
    if plan is not None:
        env["DS_FAULT_PLAN"] = plan
    log = open(os.path.join(root, f"{role}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.tools.serving_chaos", "--device", device,
         "--root", root, "--role", role], env=env, cwd=REPO, stdout=log, stderr=log)
    proc.log_path, proc.log_file, proc.role, proc.timeout = log.name, log, role, timeout
    return proc


def _wait(procs: List[subprocess.Popen]) -> Dict[str, int]:
    rcs = {}
    for p in procs:
        try:
            rcs[p.role] = p.wait(timeout=p.timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rcs[p.role] = p.wait()
        p.log_file.close()
    return rcs


def _read(root: str, role: str) -> Dict[str, Any]:
    with open(os.path.join(root, f"{role}.json")) as f:
        return json.load(f)


def _tail(root: str, role: str) -> str:
    try:
        with open(os.path.join(root, f"{role}.log")) as f:
            return f.read()[-3000:]
    except OSError:
        return ""


def _add(total: Dict[str, int], launches: Dict[str, int]) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + int(v)


def run(device: str = "cuda", scenarios=SCENARIOS, root: Optional[str] = None) -> Dict[str, Any]:
    """Run the scenarios' children (the first round concurrently: the
    victims, the references and the tenants child; then the recover
    children) and check them.  Returns ``{"ok", "failures", "launches",
    <scenario>: numbers}``; ``launches`` sums every child's serving
    drives."""
    from deepspeed_tpu_torch.resilience.faults import plan_json
    from deepspeed_tpu_torch.serving.journal import incomplete_requests

    own = root is None
    root = root or tempfile.mkdtemp(prefix="serving_chaos_")
    dirs = {s: os.path.join(root, s) for s in ("kill9", "kill9_ref", "sigterm", "sigterm_ref",
                                               "tenants")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    first = []
    if "kill9" in scenarios:
        plan = plan_json([{"site": "serving.decode", "action": "sigkill",
                           "after": KILL_AT_DECODE - 1}])
        first += [_spawn(device, dirs["kill9"], "kill9_victim", plan),
                  _spawn(device, dirs["kill9_ref"], "kill9_reference")]
    if "sigterm" in scenarios:
        first += [_spawn(device, dirs["sigterm"], "sigterm_victim"),
                  _spawn(device, dirs["sigterm_ref"], "sigterm_reference")]
    if "tenants" in scenarios:
        first.append(_spawn(device, dirs["tenants"], "tenants"))
    rcs = _wait(first)
    second = []
    if "kill9" in scenarios:
        undone = sorted(int(e["id"]) for e in incomplete_requests(
            os.path.join(dirs["kill9"], "journal")))
        second.append(_spawn(device, dirs["kill9"], "kill9_recover"))
    if "sigterm" in scenarios and rcs.get("sigterm_victim") == EXIT_DRAINED:
        st_undone = sorted(int(e["id"]) for e in incomplete_requests(
            os.path.join(dirs["sigterm"], "journal")))
        second.append(_spawn(device, dirs["sigterm"], "sigterm_recover"))
    rcs.update(_wait(second))
    out: Dict[str, Any] = {"device": device, "wall_s": time.perf_counter() - t0,
                           "rcs": rcs, "launches": {}}
    failures: List[str] = []

    def need(cond, msg):
        if not cond:
            failures.append(msg)
        return cond

    def child_ok(role, want=0, d=None):
        return need(rcs.get(role) == want,
                    f"{role} exited {rcs.get(role)}, expected {want}:\n{_tail(d, role)}")

    if "kill9" in scenarios:
        d = dirs["kill9"]
        child_ok("kill9_victim", -signal.SIGKILL, d)
        if child_ok("kill9_recover", 0, d) and child_ok("kill9_reference", 0, dirs["kill9_ref"]):
            rec, ref = _read(d, "kill9_recover"), _read(dirs["kill9_ref"], "kill9_reference")
            need(rec["replayed"] and sorted(rec["replayed"]) == undone,
                 f"kill9: replayed {rec['replayed']}, the journal's incomplete set {undone}")
            differ = [r for r in rec["replayed"]
                      if rec["tokens"].get(str(r)) != ref["tokens"].get(str(r))]
            need(not differ, f"kill9: replayed requests {differ} differ from the "
                             "uninterrupted run")
            _add(out["launches"], rec["launches"])
            _add(out["launches"], ref["launches"])
            first_id = min(map(int, ref["tokens"]))  # every child numbers from the same id
            out["kill9"] = {"victim_rc": rcs["kill9_victim"], "kill_at_decode": KILL_AT_DECODE,
                            "requests": N_KILL9, "replayed": rec["replayed"],
                            "sampled_replayed": first_id + SAMPLED in rec["replayed"],
                            "bit_identical": len(rec["replayed"]) - len(differ)}
    if "sigterm" in scenarios:
        d, dr = dirs["sigterm"], dirs["sigterm_ref"]
        if (child_ok("sigterm_victim", EXIT_DRAINED, d) and child_ok("sigterm_recover", 0, d)
                and child_ok("sigterm_reference", 0, dr)):
            vic, rec = _read(d, "sigterm_victim"), _read(d, "sigterm_recover")
            ref = _read(dr, "sigterm_reference")
            need(sorted(rec["replayed"]) == st_undone,
                 f"sigterm: replayed {rec['replayed']}, undone at drain {st_undone}")
            need(st_undone, "sigterm: the drain left nothing undone to replay")
            differ = []
            for turn, table in (("1", vic["turns"]["1"]), ("2", rec["turns"]["2"])):
                tok = {**vic["tokens"], **rec["tokens"]}
                for sid, rid in table.items():
                    if tok.get(str(rid)) != ref["tokens"][str(ref["turns"][turn][sid])]:
                        differ.append((turn, sid))
            need(not differ, f"sigterm: turns {differ} differ from the uninterrupted run")
            tiers = rec["tiers"]
            need(tiers["hits_t2"] >= 1, f"sigterm: the recovered engine hit disk "
                                        f"{tiers['hits_t2']} times")
            need(vic["tiers"]["disk_entries"] >= 1 and vic["tiers"]["host_entries"] == 0,
                 f"sigterm: the drain left {vic['tiers']['host_entries']} host entries, "
                 f"{vic['tiers']['disk_entries']} on disk")
            for x in (vic, rec, ref):
                _add(out["launches"], x["launches"])
            out["sigterm"] = {"victim_rc": rcs["sigterm_victim"], "undone": st_undone,
                              "replayed": rec["replayed"], "turns_equal": 2 * len(
                                  rec["turns"]["2"]) - len(differ),
                              "drain_flushed_to_disk": vic["tiers"]["disk_entries"],
                              "recovered_hits_t2": tiers["hits_t2"],
                              "recovered_hits_t1": tiers["hits_t1"],
                              "reference_tiers": {k: ref["tiers"][k] for k in (
                                  "demote_t0_t1", "demote_t1_t2", "hits_t1", "hits_t2")}}
    if "tenants" in scenarios and child_ok("tenants", 0, dirs["tenants"]):
        t = _read(dirs["tenants"], "tenants")
        snap, jt = t["snapshot"], t["journal"]
        need(snap["capped"]["quota_defers"] > 0 and snap["open"]["quota_defers"] == 0,
             f"tenants: quota defers capped {snap['capped']['quota_defers']}, "
             f"open {snap['open']['quota_defers']}")
        differ = [i for i, (a, b) in enumerate(zip(t["tokens"], t["plain_tokens"])) if a != b]
        need(not differ, f"tenants: requests {differ} differ from the engine without tenants")
        for name in ("capped", "open"):
            need(snap[name]["billed_tokens"] == jt[name]["billed_tokens"] > 0
                 and snap[name]["admitted"] == jt[name]["admitted"],
                 f"tenants: {name} billed {snap[name]['billed_tokens']} / admitted "
                 f"{snap[name]['admitted']}, the journal {jt[name]}")
        _add(out["launches"], t["launches"])
        out["tenants"] = {"requests": len(t["tokens"]), "equal_to_plain": len(t["tokens"])
                          - len(differ),
                          "quota_defers": {n: snap[n]["quota_defers"] for n in snap},
                          "billed": {n: snap[n]["billed_tokens"] for n in snap},
                          "journal_billed": {n: jt[n]["billed_tokens"] for n in jt}}
    out["failures"] = failures
    out["ok"] = not failures
    if own and not failures:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--root", default=None, help="working directory (a temp dir if absent)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    ap.add_argument("--role", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.role is not None:
        run_child(args.device, args.root, args.role)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("serving_chaos: no CUDA device; pass --device cpu", file=sys.stderr)
            return 2
    scenarios = tuple(s for s in args.scenarios.split(",") if s)
    unknown = set(scenarios) - set(SCENARIOS)
    if unknown:
        ap.error(f"unknown scenarios {sorted(unknown)}; known {SCENARIOS}")
    out = run(args.device, scenarios, args.root)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
