"""Fleet chaos run: real replica processes behind one ``FleetRouter``, one
``kill -9`` mid-decode, supervised restart and journal replay; then an
elastic fleet that scales up under a burst and scales down with live KV
session migration, one victim killed inside ``migrate.export``
(counterpart of the repo's ``tools/fleet_chaos.py``).

    python -m deepspeed_tpu_torch.tools.fleet_chaos                 # GPT-2 124M, bf16, the card
    python -m deepspeed_tpu_torch.tools.fleet_chaos --device cpu    # GPT2_TINY, f32, the CPU
        [--legs failover,elastic] [--root DIR] [--out result.json]

Every replica is a child process (this file with ``--replica``) serving
``serving/frontdoor/transport.py``'s framed codec on its stdio pipes
(``ProcessTransport``), over its own request journal.  On the card each
child builds GPT-2 124M at full width in bf16 with weights drawn on the
device from seed 0 (``init_on_device``), the parent the same engine for
the references; on the CPU GPT2_TINY in f32 (position table scaled up).
The parent builds every kernel before it spawns a child.

* ``failover``: three slot-pool replicas, ``route_retries`` 2, a
  supervisor with ``max_restarts`` 2.  A seeded workload (Poisson router
  steps between submits, greedy requests and two seeded-sampling ones)
  routes through ``router.submit(..., client_key=...)``; the first
  replica carries ``DS_FAULT_PLAN`` ``{"site": "serving.decode",
  "action": "sigkill"}``.  Checked: the victim's first incarnation died
  with rc -9, every acknowledged handle resolves, the restart replayed
  exactly the journal's incomplete set, the router failed over or
  rebound, and every output equals solo ``generate()`` or first differs
  on a near-tie (:func:`first_difference`).
* ``elastic``: one paged replica under a ``FleetAutoscaler`` with a warm
  pool.  A burst scales the fleet up; multi-turn sessions park on the
  elastic replicas; a forced scale-down of a victim armed with
  ``{"site": "migrate.export", "action": "sigkill"}`` dies (rc -9) and
  falls back to journal replay; clean scale-downs migrate the remaining
  sessions to the first replica, whose final turns (it never served
  turns 1-2) rebind the migrated KV.  Checked: a scale-up, rc -9, a
  clean migration that exported and imported, a rebind, every output
  under the same rule.

``run(device)`` returns ``{"ok", "failures", "launches", "failover",
"elastic", "wall_s"}``; ``launches`` sums the kernel launches the
replica children report (``stats()["launches"]``).  The CLI prints it as
one JSON line and exits 0 only when every check held.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LEGS = ("failover", "elastic")
N_REPLICAS = 3
SAMPLED = (5, 17)  # the workload's two seeded-sampling requests
SAMPLING = {"do_sample": True, "temperature": 0.9, "top_k": 8}
# the first difference between a served and a solo token must sit on a
# logit gap below this: f32 sums in another order move logits ~1e-5; bf16
# GEMMs of another batch shape move GPT-2 124M's logits (span ~+-3) by up
# to ~0.04 (chip_smoke.py's logits_bf16 row), twice that between two runs
NEAR_TIE = {"cpu": 1e-3, "cuda": 0.1}
# what the serving path and the solo references launch: B1 (the bf16
# prefill of generate(), on its tensor-core body), B4, B5
SERVING_KERNELS = ("flash_fwd", "flash_fwd_tc", "flash_decode", "flash_decode_paged")


# -- sizes: the card's GPT-2 124M, the CPU's GPT2_TINY --------------------

def sizes(device: str) -> Dict[str, Any]:
    if device == "cuda":
        return {"slots": 4, "chunk": 64, "max_len": 1024, "requests": 18,
                "prompt": (64, 256), "new": (32, 64), "kill_after": 5,
                "page_len": 128, "num_pages": 96, "burst": 16, "burst_new": (32, 48),
                "sessions": 6, "turns": 3, "first": (64, 128), "tail": (32, 64),
                "turn_new": 32, "scale_up_queue_depth": 4}
    return {"slots": 2, "chunk": 8, "max_len": 64, "requests": 9,
            "prompt": (4, 20), "new": (4, 6), "kill_after": 5,
            "page_len": 8, "num_pages": 48, "burst": 8, "burst_new": (4, 6),
            "sessions": 3, "turns": 3, "first": (6, 12), "tail": (4, 7),
            "turn_new": 6, "scale_up_queue_depth": 2}


def make_inference(device: str):
    """The one inference engine of every process: the same weights
    everywhere (a seed), on the card or the CPU."""
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


def serving_block(z, journal_dir: str, paged: bool = False,
                  spill_dir: Optional[str] = None) -> Dict[str, Any]:
    cfg: Dict[str, Any] = {"num_slots": z["slots"], "prefill_chunk": z["chunk"],
                           "max_len": z["max_len"], "journal_dir": journal_dir}
    if paged:
        cfg["kvcache"] = {"enabled": True, "page_len": z["page_len"],
                          "num_pages": z["num_pages"], "spill_dir": spill_dir or ""}
    return cfg


# -- the near-tie rule ------------------------------------------------------

def first_difference(eng, prompt_len: int, got, want, tol: float,
                     sampling: Optional[Dict[str, Any]] = None) -> Optional[Dict[str, Any]]:
    """None when ``got`` equals ``want`` (prompt + tokens, ``want`` solo
    ``generate()``'s); else where they first differ and whether that is a
    near-tie.  On ``eng``'s logits after the common prefix (a third
    evaluation of the step: a prefill, not either run's decode), the
    step's own sampler (argmax, or the request's seeded draw from its
    (seed, position) generator, whatever algorithm ``torch.multinomial``
    runs on the device) must return the served token once ``d / 2`` of
    logit moves from the solo token to the served one, and the solo token
    once it moves back.  ``gap`` is the least ``d`` of a halving ladder
    from ``tol`` for which both hold (inf: none); ``ok`` is ``gap <=
    tol`` — a near-tie that another batch shape may round either way."""
    import torch

    from deepspeed_tpu_torch.inference.engine import _generator, _sample_row

    got, want = np.asarray(got), np.asarray(want)
    if got.shape == want.shape and np.array_equal(got, want):
        return None
    n = min(len(got), len(want))
    diff = np.nonzero(got[:n] != want[:n])[0]
    if len(diff) == 0:
        return {"at": n - prompt_len, "gap": float("inf"), "ok": False,
                "why": f"lengths {len(got)} and {len(want)}"}
    i = int(diff[0])
    a, b = int(want[i]), int(got[i])
    k, v = eng.init_cache(1, i)
    logits, _, _ = eng.prefill(want[:i][None, :], k, v)
    lg = logits[0, -1].float()

    def draw(x):
        if sampling is None:
            return int(torch.argmax(x))
        return _sample_row(x, float(sampling["temperature"]), int(sampling.get("top_k", 0)),
                           _generator(x.device, int(sampling["seed"]), i - 1))

    def moved(to, frm, d):
        x = lg.clone()
        x[to] += d / 2
        x[frm] -= d / 2
        return draw(x)

    gap = float("inf")
    for d in (tol * 2.0 ** -e for e in range(6, -1, -1)):
        if moved(b, a, d) == b and moved(a, b, d) == a:
            gap = d
            break
    return {"at": i - prompt_len, "served": b, "solo": a, "gap": gap,
            "logit_gap": float(lg[a] - lg[b]), "ok": gap <= tol}


def solo(eng, prompt, new: int, sampling: Optional[Dict[str, Any]] = None) -> np.ndarray:
    return np.asarray(eng.generate(np.asarray(prompt)[None, :], max_new_tokens=new,
                                   **(sampling or {})))[0]


# -- the replica child -------------------------------------------------------

def run_replica(args) -> None:
    """One replica process: an engine over ``--journal`` in a
    ``LocalReplica``, served over the framed codec on the stdio pipes.
    fd 0/1 become the private channel BEFORE the port is imported: the
    port's logger writes to stdout, which would tear the framing.  A
    planned SIGKILL never answers; the parent's read hits EOF."""
    rfile = os.fdopen(os.dup(0), "rb")
    wfile = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.resilience import faults
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.serving.fleet import LocalReplica
    from deepspeed_tpu_torch.serving.frontdoor.transport import serve_stream

    faults.install_from_env(rank=0)
    z = sizes(args.device)
    eng = make_inference(args.device)
    block = serving_block(z, args.journal, paged=args.paged, spill_dir=args.spill)

    class CountingReplica(LocalReplica):
        """``stats()`` also reports this process's kernel launches."""

        def stats(self):
            out = super().stats()
            out["launches"] = {k: int(n) for k, n in kernels.launches().items() if n}
            return out

    rep = CountingReplica(args.name, lambda: ServingEngine(eng, block))
    kernels.reset_launches()
    serve_stream(rep, rfile, wfile)


# -- the parent's side of a replica -------------------------------------------

def process_replica(device: str, root: str, name: str, fault_plan: Optional[str] = None,
                    paged: bool = False):
    """The fleet replica surface over a child (``TransportReplica`` over a
    ``ProcessTransport``) that also times its calls: the last ``step``
    sent and the moment it raised the death, and each restart's wall
    (spawn to the end of replay), with the journal's incomplete set read
    just before the respawn."""
    from deepspeed_tpu_torch.serving.fleet import ReplicaDeadError
    from deepspeed_tpu_torch.serving.frontdoor.transport import (
        ProcessTransport,
        TransportReplica,
    )
    from deepspeed_tpu_torch.serving.journal import incomplete_requests

    journal = os.path.join(root, name, "journal")
    spill = os.path.join(root, name, "spill")
    os.makedirs(os.path.dirname(journal), exist_ok=True)
    argv = [sys.executable, os.path.abspath(__file__), "--replica", "--name", name,
            "--device", device, "--journal", journal]
    if paged:
        argv += ["--paged", "--spill", spill]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))

    class TimedReplica(TransportReplica):
        def __init__(self):
            super().__init__(name, ProcessTransport(
                name, argv, fault_plan=fault_plan, env=env,
                stderr_path=os.path.join(root, f"{name}.log")))
            self.journal_dir = journal
            self.step_sent_at: Optional[float] = None
            self.death_seen_at: Optional[float] = None
            self.restarts: List[Dict[str, Any]] = []

        def step(self):
            if self.death_seen_at is None:  # the first death's numbers stay
                self.step_sent_at = time.monotonic()
            try:
                return super().step()
            except ReplicaDeadError:
                if self.death_seen_at is None:
                    self.death_seen_at = time.monotonic()
                raise

        def restart(self):
            undone = sorted(int(e["id"]) for e in incomplete_requests(journal))
            t0 = time.perf_counter()
            replayed = super().restart()
            self.restarts.append({"wall_s": time.perf_counter() - t0, "undone": undone,
                                  "replayed": sorted(int(r) for r in replayed)})
            return replayed

    return TimedReplica()


def _launches_of(rep) -> Dict[str, int]:
    try:
        return dict(rep.stats().get("launches", {}))
    except Exception:  # a dead replica reports nothing
        return {}


def _add(total: Dict[str, int], launches: Dict[str, int]) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + int(v)


def _close(reps) -> None:
    for rep in reps:
        try:
            rep.close()
        except Exception:
            pass


def _tail(root: str, name: str) -> str:
    try:
        with open(os.path.join(root, f"{name}.log"), errors="replace") as f:
            return f.read()[-3000:]
    except OSError:
        return ""


# -- leg (a): failover and supervised restart ---------------------------------

def workload(z, vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(z["requests"]):
        p = rng.integers(1, vocab, int(rng.integers(z["prompt"][0], z["prompt"][1] + 1)),
                         dtype=np.int32)
        new = int(rng.integers(z["new"][0], z["new"][1] + 1))
        sampling = dict(SAMPLING, seed=1000 + i) if i in SAMPLED else None
        out.append((p, new, sampling))
    return out


def leg_failover(device: str, root: str, eng, need) -> Dict[str, Any]:
    from deepspeed_tpu_torch.resilience.faults import plan_json
    from deepspeed_tpu_torch.serving import ServingEngine
    from deepspeed_tpu_torch.serving.fleet import FleetRouter, ReplicaSupervisor

    z = sizes(device)
    vocab = int(eng.model_config.vocab_size)
    reqs = workload(z, vocab)
    plan = plan_json([{"site": "serving.decode", "action": "sigkill",
                       "after": z["kill_after"]}])
    # the children boot while this process draws the solo references
    reps = [process_replica(device, root, f"r{i}", fault_plan=plan if i == 0 else None)
            for i in range(N_REPLICAS)]
    router = FleetRouter(reps, config={"route_retries": 2, "max_restarts": 2},
                         supervisor=ReplicaSupervisor(max_restarts=2))
    rng = np.random.default_rng(1)
    launches: Dict[str, int] = {}
    try:
        want = [solo(eng, p, n, s) for p, n, s in reqs]
        for rep in reps:
            rep.queue_depth()  # every child is up: the traffic's clock starts here
        t0 = time.perf_counter()
        hids = []
        for i, (p, n, s) in enumerate(reqs):
            hids.append(router.submit(p, max_new_tokens=n, client_key=f"chaos-{i}",
                                      **(s or {})))
            for _ in range(int(rng.poisson(1.0))):
                router.step()
        res = router.drain(max_steps=20000)
        wall = time.perf_counter() - t0
        st = router.stats()
        for rep in reps:
            _add(launches, _launches_of(rep))
    finally:
        _close(reps)

    # the same requests through one engine in this process, the children
    # gone: the tokens/s beside the fleet's
    one = ServingEngine(eng, serving_block(z, os.path.join(root, "one", "journal")))
    _sync(device)
    t0 = time.perf_counter()
    for p, n, s in reqs:
        one.submit(p, max_new_tokens=n, **(s or {}))
    one_done = one.drain()
    _sync(device)
    one_wall = time.perf_counter() - t0
    one_tokens = sum(len(r.generated) for r in one_done.values())
    del one
    victim = reps[0]
    need(victim.first_rc == -signal.SIGKILL,
         f"failover: the victim's first incarnation exited {victim.first_rc}, expected "
         f"{-signal.SIGKILL}:\n{_tail(root, 'r0')}")
    missing = sorted(set(hids) - set(res))
    need(not missing, f"failover: acknowledged handles {missing} never resolved")
    restart = victim.restarts[0] if victim.restarts else None
    need(restart is not None and restart["replayed"] == restart["undone"]
         and restart["replayed"], f"failover: restart {restart}")
    need(st["failovers"] + st["refired"] > 0 or (restart and restart["replayed"]),
         f"failover: no failover, refire or rebind: {st}")
    need(launches.get("flash_decode", 0) > 0 or device == "cpu",
         f"failover: flash_decode not launched in the replicas: {launches}")
    flips, equal = [], 0
    for i, hid in enumerate(hids):
        if hid not in res:
            continue
        p, n, s = reqs[i]
        d = first_difference(eng, len(p), res[hid].tokens(), want[i], NEAR_TIE[device], s)
        if d is None:
            equal += 1
            continue
        d["request"] = i
        flips.append(d)
        need(d["ok"], f"failover: request {i} differs from solo generate() off a near-tie: {d}")
    tokens = sum(len(res[h].tokens()) - len(reqs[i][0]) for i, h in enumerate(hids) if h in res)
    health = st["replica_health"]
    restart_wall = sum(r["wall_s"] for r in victim.restarts)
    return {
        "replicas": N_REPLICAS, "requests": len(reqs), "sampled": list(SAMPLED),
        "victim_rc": victim.first_rc, "kill_after_decodes": z["kill_after"],
        "resolved": len(res), "bit_identical": equal, "near_tie_flips": flips,
        "near_tie_tol": NEAR_TIE[device],
        "death_to_mark_ms": (None if victim.death_seen_at is None or victim.step_sent_at is None
                             else (victim.death_seen_at - victim.step_sent_at) * 1e3),
        "restart_wall_s": restart_wall, "restarts": victim.restarts,
        "rebinds": len(restart["replayed"]) if restart else 0,
        "failovers": st["failovers"], "refired": st["refired"], "deaths": st["deaths"],
        "breaker_trips": sum(h["breaker"]["trips"] for h in health.values()),
        "routed": st["routed"], "rejections": st["rejections"],
        "tokens": tokens, "wall_s": wall, "fleet_tokens_per_s": tokens / wall,
        "fleet_tokens_per_s_ex_restart": tokens / max(wall - restart_wall, 1e-9),
        "one_engine_tokens_per_s": one_tokens / one_wall, "one_engine_wall_s": one_wall,
        "launches": launches,
    }


# -- leg (b): elastic scale-up, scale-down with migration ----------------------

def session_scripts(z, eng, vocab: int, seed: int = 2):
    """``sessions`` x ``turns``: turn t's prompt is turn t-1's solo output
    plus fresh tokens; every turn's expected output is solo ``generate()``
    over the whole context."""
    rng = np.random.default_rng(seed)
    prompts, want = [], []
    for _ in range(z["sessions"]):
        p, w = [], []
        ctx = rng.integers(1, vocab, int(rng.integers(z["first"][0], z["first"][1] + 1)),
                           dtype=np.int32)
        for turn in range(z["turns"]):
            if turn:
                tail = rng.integers(1, vocab, int(rng.integers(z["tail"][0], z["tail"][1] + 1)),
                                    dtype=np.int32)
                ctx = np.concatenate([w[-1], tail]).astype(np.int32)
            p.append(ctx.copy())
            w.append(solo(eng, ctx, z["turn_new"]))
        prompts.append(p)
        want.append(w)
    return prompts, want


def _settle(auto, router, deadline_s: float, label: str) -> None:
    deadline = time.monotonic() + deadline_s
    while auto.stats()["phase"] != "idle":
        auto.tick()
        router.step()
        if time.monotonic() > deadline:
            raise RuntimeError(f"{label} never settled: {auto.stats()}")


def leg_elastic(device: str, root: str, eng, need) -> Dict[str, Any]:
    from deepspeed_tpu_torch.resilience.faults import plan_json
    from deepspeed_tpu_torch.serving.fleet import (
        HEALTHY,
        FleetAutoscaler,
        FleetOverloaded,
        FleetRouter,
        ReplicaSupervisor,
    )

    z = sizes(device)
    vocab = int(eng.model_config.vocab_size)

    def factory(name):
        rep = process_replica(device, root, name, paged=True)
        rep.queue_depth()  # block here (the warm pool's thread) until the child serves
        return rep

    # r0, the victim-to-be and the warm pool's first replica boot while
    # this process draws the references
    plan = plan_json([{"site": "migrate.export", "action": "sigkill"}])
    r0 = process_replica(device, root, "r0", paged=True)
    v0 = process_replica(device, root, "v0", fault_plan=plan, paged=True)
    everyone = [r0, v0]
    router = FleetRouter([r0], config={"route_retries": 2},
                         supervisor=ReplicaSupervisor(max_restarts=2))
    auto = FleetAutoscaler(
        router, lambda name: everyone.append(factory(name)) or everyone[-1],
        config={"enabled": True, "min_replicas": 1, "max_replicas": 3,
                "scale_up_queue_depth": z["scale_up_queue_depth"],
                "scale_up_ttft_seconds": 1e6, "scale_down_queue_depth": 1,
                "engage_ticks": 2,
                # scale-down is forced here, never load-driven
                "disengage_ticks": 10 ** 6,
                "scale_up_cooldown_seconds": 0.0, "scale_down_cooldown_seconds": 0.0,
                "warm_pool_size": 1, "migration_deadline_seconds": 600.0,
                "migration_retries": 2},
        handoff_root=root)
    out: Dict[str, Any] = {}
    launches: Dict[str, int] = {}
    hids, res = {}, {}
    t_leg = time.perf_counter()
    try:
        rng = np.random.default_rng(3)
        burst = []
        for _ in range(z["burst"]):
            p = rng.integers(1, vocab, int(rng.integers(z["prompt"][0], z["prompt"][1] + 1)),
                             dtype=np.int32)
            burst.append((p, int(rng.integers(z["burst_new"][0], z["burst_new"][1] + 1))))
        burst_want = [solo(eng, p, n) for p, n in burst]
        sess_prompts, sess_want = session_scripts(z, eng, vocab)
        r0.queue_depth()
        deadline = time.monotonic() + 600
        while auto.pool.ready() < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        need(auto.pool.ready() >= 1, "elastic: the warm pool never produced a replica")
        # (1) a burst past one replica's comfort: adopt a warm replica
        for i, (p, n) in enumerate(burst):
            while True:
                try:
                    hids[("burst", i)] = router.submit(p, max_new_tokens=n, client_key=f"b{i}")
                    break
                except FleetOverloaded as e:
                    time.sleep(min(e.retry_after or 0.05, 0.2))
                    router.step()
            auto.tick()
            if i % 3 == 2:
                router.step()
        st = auto.stats()
        need(st["scale_ups"] >= 1, f"elastic: the burst never scaled up: {st}")
        out["scale_ups"] = st["scale_ups"]
        out["scale_up_reaction_s"] = st["last_scale_up_reaction_s"]
        res.update(router.drain(max_steps=50000))

        # (2) sessions park on the replicas about to be scaled away, spread
        # over them in turn (each submit pinned: the others drain for it);
        # r0 serves none of turns 1..turns-1
        v0.queue_depth()
        router.add_replica(v0)
        homes = [n for n in router._order if n != "r0"]
        for turn in range(z["turns"] - 1):
            for s in range(z["sessions"]):
                home = homes[s % len(homes)]
                for n in router._order:
                    if n != home:
                        router.begin_drain(n, "pin a session")
                hids[("sess", s, turn)] = router.submit(
                    sess_prompts[s][turn], max_new_tokens=z["turn_new"],
                    client_key=f"s{s}t{turn}", session_id=f"sess-{s}")
                for n in router._order:
                    if n != "r0":
                        router.abort_drain(n)
            res.update(router.drain(max_steps=50000))
        router.abort_drain("r0")
        out["session_homes"] = {f"sess-{s}": homes[s % len(homes)]
                                for s in range(z["sessions"])}

        # (3) a forced scale-down of v0, which dies inside migrate.export:
        # the death path (restart + replay), not a hang and no loss
        need(auto.request_scale_down("v0"), "elastic: the scale-down of v0 was refused")
        _settle(auto, router, 600, "the drain of v0")
        need(v0.first_rc == -signal.SIGKILL,
             f"elastic: v0 exited {v0.first_rc}, expected {-signal.SIGKILL}:\n"
             f"{_tail(root, 'v0')}")
        need(auto.migrations_failed >= 1, f"elastic: no failed migration: {auto.stats()}")
        deadline = time.monotonic() + 600
        while not (v0.alive() and router._health["v0"].state == HEALTHY):
            router.step()
            if time.monotonic() > deadline:
                raise RuntimeError("elastic: v0 was never restarted after dying mid-export")
            time.sleep(0.01)
        res.update(router.drain(max_steps=50000))
        out["victim_rc"] = v0.first_rc
        out["victim_restart"] = v0.restarts

        # (4) clean scale-downs back to r0: each victim's sessions migrate
        while len(router._order) > 1:
            victim = [n for n in router._order if n != "r0"][-1]
            rep = router._replicas[victim]
            need(auto.request_scale_down(victim),
                 f"elastic: the scale-down of {victim} was refused: {auto.stats()}")
            t0 = time.perf_counter()
            _settle(auto, router, 600, f"the scale-down of {victim}")
            ev = [e for e in auto.events if e.get("replica") == victim
                  and e["kind"] == "migration"]
            out.setdefault("migrations", []).append({
                "victim": victim, "wall_s": time.perf_counter() - t0,
                "exported": ev[-1]["exported"] if ev else 0,
                "imported": ev[-1]["imported"] if ev else {}})
            _add(launches, _launches_of(rep) if rep.alive() else {})
        st = auto.stats()
        clean = [m for m in out.get("migrations", [])
                 if m["exported"] > 0 and sum(m["imported"].values()) > 0]
        need(clean, f"elastic: no clean migration exported and imported: "
                    f"{out.get('migrations')}")
        out["migration"] = clean[-1] if clean else None
        out["sessions_migrated"] = st["sessions_migrated"]

        # (5) the final turns on r0, which never served turns 1..turns-1
        last = z["turns"] - 1
        for s in range(z["sessions"]):
            hids[("sess", s, last)] = router.submit(
                sess_prompts[s][last], max_new_tokens=z["turn_new"],
                client_key=f"s{s}t{last}", session_id=f"sess-{s}")
        res.update(router.drain(max_steps=50000))
        kv = r0.kv_stats()
        out["survivor_rebinds"] = int(kv.get("session_rebinds", 0)) + int(
            kv.get("session_restores", 0))
        _add(launches, _launches_of(r0))
        out["autoscaler"] = {k: st[k] for k in (
            "scale_ups", "scale_downs", "scale_downs_aborted", "migrations_completed",
            "migrations_failed", "sessions_migrated", "last_scale_up_reaction_s",
            "last_scale_down_reaction_s")}
        out["router"] = {k: v for k, v in router.stats().items()
                         if k not in ("replica_health", "last_failover")}
    finally:
        auto.stop()
        _close(list(router._replicas.values()) + list(auto.pool._ready) + everyone)
    out["wall_s"] = time.perf_counter() - t_leg
    missing = sorted(str(k) for k, h in hids.items() if h not in res)
    need(not missing, f"elastic: acknowledged requests {missing} never resolved")
    need(out["survivor_rebinds"] >= 1,
         f"elastic: the survivor never rebound a migrated session: {out['survivor_rebinds']}")
    need(launches.get("flash_decode_paged", 0) > 0 or device == "cpu",
         f"elastic: flash_decode_paged not launched in the replicas: {launches}")
    flips, equal = [], 0
    for key, hid in hids.items():
        if hid not in res:
            continue
        if key[0] == "burst":
            p, w = burst[key[1]][0], burst_want[key[1]]
        else:
            p, w = sess_prompts[key[1]][key[2]], sess_want[key[1]][key[2]]
        d = first_difference(eng, len(p), res[hid].tokens(), w, NEAR_TIE[device])
        if d is None:
            equal += 1
            continue
        d["request"] = list(map(str, key))
        flips.append(d)
        need(d["ok"], f"elastic: {key} differs from solo generate() off a near-tie: {d}")
    out.update({"requests": len(hids), "bit_identical": equal, "near_tie_flips": flips,
                "near_tie_tol": NEAR_TIE[device], "launches": launches})
    return out


def _sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def run(device: str = "cuda", legs=LEGS, root: Optional[str] = None) -> Dict[str, Any]:
    """Run the legs and check them.  Returns ``{"ok", "failures",
    "launches", <leg>: numbers, "wall_s"}``; ``launches`` sums what the
    replica children report."""
    own = root is None
    root = root or tempfile.mkdtemp(prefix="fleet_chaos_")
    if device == "cuda":
        from deepspeed_tpu_torch.ops import kernels

        kernels.build(SERVING_KERNELS)  # the children only load what is built here
    t0 = time.perf_counter()
    failures: List[str] = []

    def need(cond, msg):
        if not cond:
            failures.append(msg)
        return cond

    eng = make_inference(device)
    out: Dict[str, Any] = {"device": device, "launches": {}}
    for leg, fn in (("failover", leg_failover), ("elastic", leg_elastic)):
        if leg not in legs:
            continue
        d = os.path.join(root, leg)
        os.makedirs(d, exist_ok=True)
        try:
            out[leg] = fn(device, d, eng, need)
            _add(out["launches"], out[leg]["launches"])
        except Exception as e:  # a leg that raised fails the run, never passes over
            failures.append(f"{leg}: {type(e).__name__}: {e}")
    del eng
    out["wall_s"] = time.perf_counter() - t0
    out["failures"] = failures
    out["ok"] = not failures
    if own and not failures:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--root", default=None, help="working directory (a temp dir if absent)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    ap.add_argument("--replica", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--name", default="replica", help=argparse.SUPPRESS)
    ap.add_argument("--journal", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--paged", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--spill", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.replica:
        run_replica(args)
        return 0
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("fleet_chaos: no CUDA device; pass --device cpu", file=sys.stderr)
            return 2
    legs = tuple(x for x in args.legs.split(",") if x)
    unknown = set(legs) - set(LEGS)
    if unknown:
        ap.error(f"unknown legs {sorted(unknown)}; known {LEGS}")
    out = run(args.device, legs, args.root)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
