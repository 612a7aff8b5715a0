"""Deterministic fault injection for the resilience test harness (a copy
of ``deepspeed_tpu/resilience/faults.py``: standard library only, kept
whole so the JAX package's fault plans drive the port unchanged).

The resilience code calls :func:`check`/:func:`check_flag` at named
sites (``"ckpt.commit"``, ``"ckpt.latest"``, ``"engine.force_overflow"``,
...).  In production no injector is installed and both are near-free
attribute checks.  Under test, a seeded :class:`FaultInjector` is
installed as a context manager and fires exactly the failures its plan
describes — I/O errors, kill-mid-save, forced overflow steps — so every
recovery path is provable, repeatably.

Two failure shapes:

* :class:`InjectedFault` (an ``OSError``) — a transient I/O error; the
  retry policy is expected to absorb it.
* :class:`InjectedKill` (a ``BaseException``) — models the process dying
  at that instruction.  Deliberately NOT an ``Exception`` so no
  ``except Exception`` cleanup handler in the code under test can "survive"
  a death the real process would not.

Multi-process plans (the supervision harness): a plan serializes to
JSON, rides to launcher-spawned children in the ``DS_FAULT_PLAN`` env
var, and installs itself at engine init (:func:`install_from_env`).
Each plan entry may carry a ``rank`` filter, so a single env var arms
"SIGKILL rank 1 at its 4th step boundary" across a real 2-process job.
Two plan kinds exist only for real processes:

* ``sigkill`` — ``os.kill(getpid(), SIGKILL)``: the real thing, no
  Python unwinding, no atexit — exactly what a hardware loss looks like
  to the surviving ranks;
* ``stall`` — :func:`check_stall` sleeps ``seconds`` inside a blocking
  sync (site ``collective.stall``), modelling a wedged-but-alive peer
  for the hung-collective watchdog.

Serving sites (``serving.submit``, ``serving.prefill``,
``serving.decode``, ``serving.journal.commit``; docs/resilience.md) use
the same machinery plus the ``latency`` action — a *repeating* sleep
(:func:`check_latency`, default every call) that models a slow decode
step so the overload tests can build real queue pressure without a big
model.  ``stall`` fires ``times`` then disarms; ``latency`` keeps
firing — a degraded chip, not a single wedge.

Fleet sites (``router.route`` — fail + recurring latency on the route
path, ``router.hedge`` — fail at hedge launch, ``replica.death`` — a
``flag`` plan the router polls each step to kill a live replica;
docs/resilience.md §Fleet) drive the front-door chaos matrix in
``tests/test_fleet.py`` and ``tools/fleet_chaos.py``.

Race sites (``race.*``; docs/ds_race.md §Stress mode): the ds_race
schedule-perturbation harness wraps instrumented lock acquire/release
sites with :func:`check_race`, and two recurring, probabilistic plan
kinds widen the interleaving space a seeded run explores:

* ``race.yield`` — ``time.sleep(0)``: drop the GIL so another runnable
  thread is scheduled at this instruction;
* ``race.stall`` — a sub-millisecond sleep: hold a lock (or a gap
  between a read and its write-back) open long enough for a conflicting
  thread to land inside it.

``fire_race`` consults the exact site first, then the ``race.*``
catch-all, so a plan can jitter every instrumented lock while pinning a
heavier stall on one suspect site.
"""
from __future__ import annotations

import json
import os
import random
import signal
import time
from typing import Dict, List, Optional, Tuple

DS_FAULT_PLAN_ENV = "DS_FAULT_PLAN"


class InjectedFault(OSError):
    """A planned transient I/O failure."""


class InjectedKill(BaseException):
    """A planned process death (uncatchable by ``except Exception``)."""


_ACTIVE: Optional["FaultInjector"] = None


def check(site: str, path: Optional[str] = None) -> None:
    """Raise if the active injector has a raising plan armed for ``site``."""
    if _ACTIVE is not None:
        _ACTIVE.fire(site, path)


def check_flag(site: str) -> bool:
    """True if the active injector has a non-raising flag armed for
    ``site`` (e.g. "pretend this step overflowed")."""
    if _ACTIVE is None:
        return False
    return _ACTIVE.fire_flag(site)


def check_stall(site: str) -> float:
    """Sleep for the planned stall duration at ``site`` (0 when no stall
    is armed).  Returns the seconds slept — the hung-collective tests
    assert attribution against it."""
    if _ACTIVE is None:
        return 0.0
    seconds = _ACTIVE.fire_stall(site)
    if seconds > 0:
        time.sleep(seconds)
    return seconds


def check_latency(site: str) -> float:
    """Sleep for the planned *recurring* latency at ``site`` (0 when no
    latency plan is armed).  Unlike :func:`check_stall` this fires on
    every call (up to the plan's ``times``, default unbounded) — the
    slow-decode injection the serving overload tests drive queue
    pressure with."""
    if _ACTIVE is None:
        return 0.0
    seconds = _ACTIVE.fire_latency(site)
    if seconds > 0:
        time.sleep(seconds)
    return seconds


def check_race(site: str) -> None:
    """Schedule-perturbation point for the ds_race stress harness
    (docs/ds_race.md §Stress mode).  Instrumented lock wrappers call
    this before and after acquiring; an armed ``race.yield`` plan drops
    the GIL (``sleep(0)``), a ``race.stall`` plan holds the site open
    for a sub-millisecond beat.  Free when no injector is active — one
    global ``None`` check, same cost model as :func:`check`."""
    if _ACTIVE is not None:
        seconds = _ACTIVE.fire_race(site)
        if seconds >= 0:
            time.sleep(seconds)


class FaultInjector:
    """Seeded, per-site fault plans.  Use as a context manager::

        inj = FaultInjector(seed=0)
        inj.fail("ckpt.save.state", times=2)      # first two calls raise
        inj.kill("ckpt.commit")                   # then die at commit
        with inj:
            engine.save_checkpoint(d)
    """

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self._plans: Dict[str, dict] = {}
        self.log: List[Tuple[str, str]] = []  # (site, event)

    # -- plan registration ------------------------------------------------
    def _plan(self, site: str, exc, times: int, after: int, probability: Optional[float],
              kind: Optional[str] = None, seconds: float = 0.0) -> None:
        self._plans[site] = {
            "exc": exc, "times": times, "after": after,
            "probability": probability, "calls": 0, "fired": 0,
            "kind": kind or ("flag" if exc is None else "raise"),
            "seconds": float(seconds),
        }

    def fail(self, site: str, times: int = 1, after: int = 0, exc=InjectedFault,
             probability: Optional[float] = None) -> "FaultInjector":
        """Arm ``site`` to raise ``exc`` for its next ``times`` triggers
        (skipping the first ``after`` calls)."""
        self._plan(site, exc, times, after, probability)
        return self

    def kill(self, site: str, after: int = 0) -> "FaultInjector":
        """Arm ``site`` to simulate process death (InjectedKill)."""
        self._plan(site, InjectedKill, 1, after, None)
        return self

    def flag(self, site: str, times: int = 1, after: int = 0) -> "FaultInjector":
        """Arm a non-raising flag at ``site`` (check_flag returns True)."""
        self._plan(site, None, times, after, None)
        return self

    def sigkill(self, site: str, after: int = 0) -> "FaultInjector":
        """Arm a REAL ``SIGKILL`` of this process at ``site`` — no Python
        unwinding, no atexit.  Only meaningful in subprocess tests; the
        in-process analog is :meth:`kill`."""
        self._plan(site, None, 1, after, None, kind="sigkill")
        return self

    def stall(self, site: str, seconds: float, times: int = 1, after: int = 0) -> "FaultInjector":
        """Arm a ``seconds``-long sleep at ``site`` (``check_stall``) —
        a wedged-but-alive collective."""
        self._plan(site, None, times, after, None, kind="stall", seconds=seconds)
        return self

    def latency(self, site: str, seconds: float, times: int = 0, after: int = 0) -> "FaultInjector":
        """Arm a *recurring* ``seconds``-long sleep at ``site``
        (``check_latency``): every call sleeps, up to ``times`` fires
        (``0`` = unbounded) — a persistently slow decode step for the
        serving overload harness, not a one-shot wedge."""
        self._plan(site, None, times if times > 0 else 1 << 30, after, None,
                   kind="latency", seconds=seconds)
        return self

    def race_yield(self, site: str, probability: float = 0.5, times: int = 0,
                   after: int = 0) -> "FaultInjector":
        """Arm a *recurring, probabilistic* GIL yield (``sleep(0)``) at
        ``site`` (``check_race``).  ``site`` may be the ``race.*``
        catch-all, which matches every race site without an exact plan
        of its own.  ``times=0`` = unbounded."""
        self._plan(site, None, times if times > 0 else 1 << 30, after,
                   probability, kind="race.yield", seconds=0.0)
        return self

    def race_stall(self, site: str, seconds: float = 0.0002,
                   probability: float = 0.1, times: int = 0,
                   after: int = 0) -> "FaultInjector":
        """Arm a recurring, probabilistic sub-millisecond stall at a
        race site — long enough for a conflicting thread to land inside
        the window the stall holds open."""
        self._plan(site, None, times if times > 0 else 1 << 30, after,
                   probability, kind="race.stall", seconds=seconds)
        return self

    # -- firing -----------------------------------------------------------
    def _triggers(self, plan: dict) -> bool:
        plan["calls"] += 1
        if plan["fired"] >= plan["times"] or plan["calls"] <= plan["after"]:
            return False
        if plan["probability"] is not None and self.rng.random() >= plan["probability"]:
            return False
        plan["fired"] += 1
        return True

    def fire(self, site: str, path: Optional[str] = None) -> None:
        plan = self._plans.get(site)
        if plan is None:
            return
        if plan["kind"] == "sigkill":
            if self._triggers(plan):
                self.log.append((site, "sigkill"))
                os.kill(os.getpid(), signal.SIGKILL)
            return
        if plan["exc"] is None:
            return
        if self._triggers(plan):
            self.log.append((site, plan["exc"].__name__))
            raise plan["exc"](f"injected fault at site '{site}'" + (f" ({path})" if path else ""))

    def fire_flag(self, site: str) -> bool:
        plan = self._plans.get(site)
        if plan is None or plan["kind"] != "flag":
            return False
        if self._triggers(plan):
            self.log.append((site, "flag"))
            return True
        return False

    def fire_stall(self, site: str) -> float:
        plan = self._plans.get(site)
        if plan is None or plan["kind"] != "stall":
            return 0.0
        if self._triggers(plan):
            self.log.append((site, "stall"))
            return plan["seconds"]
        return 0.0

    def fire_latency(self, site: str) -> float:
        plan = self._plans.get(site)
        if plan is None or plan["kind"] != "latency":
            return 0.0
        if self._triggers(plan):
            # one log line per site, not per fire: latency plans fire on
            # every decode step and would otherwise flood the log
            if plan["fired"] == 1:
                self.log.append((site, "latency"))
            return plan["seconds"]
        return 0.0

    def fire_race(self, site: str) -> float:
        """Seconds to sleep at a race site, or ``-1.0`` when nothing
        fires (``check_race`` treats ``>= 0`` as "sleep", so a yield
        plan returns ``0.0`` and still drops the GIL).  The exact site
        is consulted first; sites without their own plan fall through to
        the ``race.*`` catch-all."""
        plan = self._plans.get(site)
        if plan is None or not plan["kind"].startswith("race."):
            plan = self._plans.get("race.*")
        if plan is None or not plan["kind"].startswith("race."):
            return -1.0
        if self._triggers(plan):
            if plan["fired"] == 1:  # one log line per site (see latency)
                self.log.append((site, plan["kind"]))
            return plan["seconds"] if plan["kind"] == "race.stall" else 0.0
        return -1.0

    def calls(self, site: str) -> int:
        plan = self._plans.get(site)
        return plan["calls"] if plan else 0

    # -- direct corruption helpers (for committed tags) -------------------
    @staticmethod
    def truncate_file(path: str, keep_bytes: int = 0) -> None:
        with open(path, "r+b") as f:
            f.truncate(keep_bytes)

    def corrupt_file(self, path: str) -> None:
        """Flip one byte in the middle of the file (seeded position)."""
        size = os.path.getsize(path)
        if size == 0:
            return
        pos = self.rng.randrange(size)
        with open(path, "r+b") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0xFF]))

    # -- multi-process plan propagation (DS_FAULT_PLAN) -------------------
    _EXC_NAMES = {"InjectedFault": InjectedFault, "InjectedKill": InjectedKill,
                  "OSError": OSError, "RuntimeError": RuntimeError}

    def to_plan(self) -> str:
        """Serialize the armed plans to the ``DS_FAULT_PLAN`` JSON form
        (rank filters are added by the caller — see :func:`plan_json`)."""
        entries = []
        for site, p in self._plans.items():
            entries.append({
                "site": site,
                "action": {"raise": "fail", "flag": "flag", "sigkill": "sigkill",
                           "stall": "stall", "latency": "latency",
                           "race.yield": "race.yield",
                           "race.stall": "race.stall"}[p["kind"]],
                "times": p["times"], "after": p["after"], "seconds": p["seconds"],
                **({"exc": p["exc"].__name__} if p["exc"] is not None and p["kind"] == "raise" else {}),
                **({"probability": p["probability"]} if p["probability"] is not None else {}),
            })
        return json.dumps({"seed": 0, "plans": entries})

    @classmethod
    def from_plan(cls, spec: str, rank: Optional[int] = None) -> "FaultInjector":
        """Build an injector from the JSON plan, keeping only entries
        whose ``rank`` filter matches (absent filter = every rank)."""
        d = json.loads(spec)
        inj = cls(seed=int(d.get("seed", 0)))
        for e in d.get("plans", []):
            r = e.get("rank")
            if r is not None and rank is not None:
                ranks = r if isinstance(r, list) else [r]
                if rank not in [int(x) for x in ranks]:
                    continue
            site = e["site"]
            action = e.get("action", "fail")
            times = int(e.get("times", 1))
            after = int(e.get("after", 0))
            if action == "fail":
                exc = cls._EXC_NAMES.get(e.get("exc", "InjectedFault"), InjectedFault)
                inj.fail(site, times=times, after=after, exc=exc,
                         probability=e.get("probability"))
            elif action == "kill":
                inj.kill(site, after=after)
            elif action == "sigkill":
                inj.sigkill(site, after=after)
            elif action == "flag":
                inj.flag(site, times=times, after=after)
            elif action == "stall":
                inj.stall(site, float(e.get("seconds", 1.0)), times=times, after=after)
            elif action == "latency":
                # times defaults to 1 via the shared parse above, but a
                # latency plan's natural default is "every call"
                inj.latency(site, float(e.get("seconds", 0.01)),
                            times=int(e.get("times", 0)), after=after)
            elif action == "race.yield":
                inj.race_yield(site, probability=float(e.get("probability", 0.5)),
                               times=int(e.get("times", 0)), after=after)
            elif action == "race.stall":
                inj.race_stall(site, seconds=float(e.get("seconds", 0.0002)),
                               probability=float(e.get("probability", 0.1)),
                               times=int(e.get("times", 0)), after=after)
            else:
                raise ValueError(f"unknown fault action '{action}' for site '{site}'")
        return inj

    # -- installation -----------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultInjector is already active")
        _ACTIVE = self
        return self

    def __exit__(self, *exc_info) -> None:
        global _ACTIVE
        _ACTIVE = None


def plan_json(plans: List[dict], seed: int = 0) -> str:
    """Compose a ``DS_FAULT_PLAN`` value from raw entries, e.g.::

        plan_json([{"site": "step.boundary", "action": "sigkill",
                    "rank": 1, "after": 3}])
    """
    return json.dumps({"seed": seed, "plans": plans})


def install_from_env(rank: Optional[int] = None) -> Optional[FaultInjector]:
    """Install the injector described by ``DS_FAULT_PLAN`` for the rest
    of this process's life (no context manager: launcher-spawned
    children die with their plan).  ``rank`` defaults to the launcher's
    ``RANK`` env.  No-op (returns None) without the env var, with an
    empty filtered plan, or when an injector is already active."""
    global _ACTIVE
    spec = os.environ.get(DS_FAULT_PLAN_ENV)
    if not spec or _ACTIVE is not None:
        return None
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    inj = FaultInjector.from_plan(spec, rank=rank)
    if not inj._plans:
        return None
    _ACTIVE = inj
    return inj
