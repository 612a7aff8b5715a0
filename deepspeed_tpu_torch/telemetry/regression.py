"""Perf-regression plane: persistent bench history, noise-aware diffs,
and the runtime anomaly watch (counterpart of
``deepspeed_tpu/telemetry/regression.py``: the same history lines,
verdicts and events; a tool's record names the torch device).

Three pieces:

* **bench history** — a benchmark record appends one schema'd line to
  ``bench_history.jsonl`` keyed by ``(rung, metric, config
  fingerprint, git sha, backend)``: a durable, append-only stream any
  tool can diff.
* **bench diff** — :func:`bench_diff` computes noise-aware deltas:
  the newest run's value vs the **median of the prior window** per key,
  with per-metric thresholds widened by the history's own dispersion
  (MAD), and returns ``regress`` / ``improve`` / ``noise`` /
  ``no-baseline`` verdicts; :func:`gate` turns a ``regress`` verdict
  into a failure, :func:`history_bless` records an intentional change
  so the baseline window restarts after it.
* **runtime anomaly watch** — step-wall spikes (window-relative, via
  the gauge ring :meth:`~.registry.Gauge.window_mean`) and cross-rank
  stragglers (rank step wall vs the cluster median, computed on the
  heartbeat aggregation) surface as structured telemetry events
  the moment they happen, not at the next bench run.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple

HISTORY_SCHEMA = 1
HISTORY_FILENAME = "bench_history.jsonl"

# record fields that identify a *configuration* (not an outcome): two
# runs with equal fingerprints are comparable apples-to-apples
_FINGERPRINT_KEYS = (
    "unit", "micro_bs", "gas", "seq", "batch", "prompt_len", "kv",
    "offered_load", "zero_stage", "strategy", "mode",
)

# metrics where LOWER is better (everything else: higher is better)
_LOWER_IS_BETTER_TOKENS = ("_ms", "latency", "ttft", "tpot", "step_ms",
                           "wall", "stall", "p99", "p50")


def default_history_path(base_dir: Optional[str] = None) -> str:
    env = os.environ.get("DS_BENCH_HISTORY_PATH")
    if env:
        return env
    return os.path.join(base_dir or os.getcwd(), HISTORY_FILENAME)


def git_sha(repo_dir: Optional[str] = None) -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir or os.getcwd(), stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, timeout=5,
        )
        sha = out.stdout.decode().strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:  # noqa: BLE001 — history must work outside a checkout
        return "unknown"


def config_fingerprint(record: Dict[str, Any]) -> str:
    """Short digest of the record's configuration keys — the
    apples-to-apples comparability key."""
    payload = {k: record[k] for k in _FINGERPRINT_KEYS if k in record}
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:10]


def new_run_id() -> str:
    return uuid.uuid4().hex[:12]


def history_append(
    records: Iterable[Dict[str, Any]],
    rung: Optional[str] = None,
    path: Optional[str] = None,
    run_id: Optional[str] = None,
    sha: Optional[str] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> int:
    """Append one history line per measured record (skips records with
    no numeric ``value`` and skip markers).  Returns lines written.

    Child bench processes driven by a parent that appends for them set
    ``DS_BENCH_CHILD=1`` — the helper then refuses to double-write."""
    if os.environ.get("DS_BENCH_CHILD") == "1":
        return 0
    path = path or default_history_path()
    run_id = run_id or new_run_id()
    sha = sha or git_sha(os.path.dirname(os.path.abspath(path)) or None)
    lines = []
    for rec in records:
        if rec.get("skipped") or not isinstance(rec.get("value"), (int, float)):
            continue
        lines.append({
            "schema": HISTORY_SCHEMA,
            "kind": "bench",
            "ts": time.time(),
            "run_id": run_id,
            "git_sha": sha,
            "rung": rung or rec.get("rung") or "",
            "metric": rec.get("metric", "?"),
            "value": float(rec["value"]),
            "unit": rec.get("unit", ""),
            "backend": rec.get("backend", ""),
            "fingerprint": config_fingerprint(rec),
            # a DS_BENCH_INJECT-doctored value must stay marked in the
            # durable stream too — bench_diff never baselines on it
            **({"injected": rec["injected"]} if rec.get("injected") else {}),
            **(extra or {}),
        })
    if not lines:
        return 0
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        for line in lines:
            f.write(json.dumps(line, sort_keys=True) + "\n")
    return len(lines)


def history_bless(metric: str = "*", note: str = "", path: Optional[str] = None,
                  sha: Optional[str] = None) -> Dict[str, Any]:
    """Record an INTENTIONAL perf change: diffs for ``metric`` (``*`` =
    every metric) ignore runs before this marker, so the next gate
    compares against the new normal instead of flagging it forever."""
    path = path or default_history_path()
    marker = {
        "schema": HISTORY_SCHEMA, "kind": "bless", "ts": time.time(),
        "git_sha": sha or git_sha(), "metric": metric, "note": note,
    }
    with open(path, "a") as f:
        f.write(json.dumps(marker, sort_keys=True) + "\n")
    return marker


def history_load(path: Optional[str] = None) -> List[Dict[str, Any]]:
    path = path or default_history_path()
    out: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn tail line must not kill the diff
            if isinstance(rec, dict):
                out.append(rec)
    return out


_TOOL_RUN_ID: Optional[str] = None


def device_backend() -> str:
    """The record's ``backend``: the card's name when torch sees one
    (``torch.cuda.get_device_name(0)``), else ``cpu``."""
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def tool_history_emit(rec: Dict[str, Any], rung: str,
                      base_dir: Optional[str] = None) -> int:
    """A standalone tool's hook: append one record to the repo's history
    stream.  No-op in a child process (a parent that appends for its
    children sets ``DS_BENCH_CHILD=1``), shares
    one run_id per tool process, stamps the backend, never raises."""
    global _TOOL_RUN_ID
    try:
        if os.environ.get("DS_BENCH_CHILD") == "1":
            return 0
        if _TOOL_RUN_ID is None:
            _TOOL_RUN_ID = new_run_id()
        if "backend" not in rec:
            rec = dict(rec, backend=device_backend())
        return history_append(
            [rec], rung=rung, path=default_history_path(base_dir),
            run_id=_TOOL_RUN_ID,
        )
    except Exception:  # noqa: BLE001 — history must never kill a bench
        return 0


# ---------------------------------------------------------------------------
# noise-aware diff
# ---------------------------------------------------------------------------

def lower_is_better(metric: str, unit: str = "") -> bool:
    m = (metric or "").lower()
    u = (unit or "").lower()
    return any(t in m for t in _LOWER_IS_BETTER_TOKENS) or u.endswith("ms") or u == "s"


def _noise_band(values: List[float], threshold: float,
                band_cap: Optional[float] = None) -> float:
    """Relative tolerance: the configured threshold widened by the
    baseline window's own dispersion (3·MAD/median) — a metric that
    historically wobbles ±8% must not gate at 5%.  ``band_cap`` bounds
    the widening (the CI sentinel's red check pins it so a few noisy
    seed runs cannot inflate the band past the injected regression)."""
    med = statistics.median(values)
    if med == 0 or len(values) < 3:
        return threshold
    mad = statistics.median(abs(v - med) for v in values)
    band = max(threshold, 3.0 * 1.4826 * mad / abs(med))
    return min(band, band_cap) if band_cap else band


def bench_diff(
    history: List[Dict[str, Any]],
    window: int = 8,
    default_threshold: float = 0.05,
    thresholds: Optional[Dict[str, float]] = None,
    metrics: Optional[Iterable[str]] = None,
    band_cap: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Verdict per (metric, backend, fingerprint) key: the NEWEST run's
    value against the median of up to ``window`` prior runs (after the
    last applicable bless marker).  ``thresholds`` maps metric-name
    substrings to relative thresholds (first match wins)."""
    thresholds = thresholds or {}
    bless_ts: Dict[str, float] = {}
    for rec in history:
        if rec.get("kind") == "bless":
            bless_ts[rec.get("metric", "*")] = max(
                bless_ts.get(rec.get("metric", "*"), 0.0), float(rec.get("ts", 0.0))
            )

    groups: Dict[Tuple[str, str, str], List[Dict[str, Any]]] = {}
    for rec in history:
        if rec.get("kind") != "bench":
            continue
        metric = rec.get("metric", "?")
        if metrics is not None and metric not in metrics:
            continue
        key = (metric, rec.get("backend", ""), rec.get("fingerprint", ""))
        groups.setdefault(key, []).append(rec)

    out: List[Dict[str, Any]] = []
    for (metric, backend, fp), recs in sorted(groups.items()):
        recs.sort(key=lambda r: float(r.get("ts", 0.0)))
        new = recs[-1]
        # bless semantics: the newest run at bless time becomes the new
        # baseline ANCHOR (you bless after seeing the red gate, so the
        # run that embodies the intentional change must seed the new
        # normal); everything older is out of the comparison
        cut = max(bless_ts.get("*", 0.0), bless_ts.get(metric, 0.0))
        pre_cut = [r for r in recs if float(r.get("ts", 0.0)) < cut]
        anchor = pre_cut[-1].get("run_id") if pre_cut else None
        recs = [
            r for r in recs
            if float(r.get("ts", 0.0)) >= cut or r.get("run_id") == anchor
        ]
        # baseline = prior RUNS (not prior lines): exclude every line of
        # the newest run_id so a multi-record rung can't self-baseline,
        # and never baseline on an injected (doctored) value — it exists
        # to be gated against, not to shift the normal
        prior = [
            r for r in recs
            if r.get("run_id") != new.get("run_id") and not r.get("injected")
        ]
        row = {
            "metric": metric, "backend": backend, "fingerprint": fp,
            "value": float(new["value"]), "unit": new.get("unit", ""),
            "run_id": new.get("run_id"), "git_sha": new.get("git_sha"),
            "n_baseline": len(prior),
        }
        if not prior:
            row.update(verdict="no-baseline", baseline=None, delta_pct=None,
                       band_pct=None)
            out.append(row)
            continue
        baseline_vals = [float(r["value"]) for r in prior[-window:]]
        baseline = statistics.median(baseline_vals)
        threshold = default_threshold
        for pat, th in thresholds.items():
            if pat in metric:
                threshold = float(th)
                break
        band = _noise_band(baseline_vals, threshold, band_cap=band_cap)
        delta = (row["value"] - baseline) / baseline if baseline else 0.0
        worse = -delta if not lower_is_better(metric, row["unit"]) else delta
        if worse > band:
            verdict = "regress"
        elif -worse > band:
            verdict = "improve"
        else:
            verdict = "noise"
        row.update(
            verdict=verdict, baseline=baseline,
            delta_pct=round(100.0 * delta, 2), band_pct=round(100.0 * band, 2),
        )
        out.append(row)
    return out


def gate(verdicts: List[Dict[str, Any]]) -> Tuple[bool, List[Dict[str, Any]]]:
    """(ok, regressions) — the gate's contract: ok is False iff
    any key carries a ``regress`` verdict."""
    bad = [v for v in verdicts if v["verdict"] == "regress"]
    return (not bad, bad)


def format_verdicts(verdicts: List[Dict[str, Any]]) -> str:
    lines = [
        f"{'verdict':12s} {'delta%':>8s} {'band%':>7s} {'baseline':>12s} "
        f"{'value':>12s}  metric [backend]"
    ]
    order = {"regress": 0, "improve": 1, "noise": 2, "no-baseline": 3}
    for v in sorted(verdicts, key=lambda v: (order.get(v["verdict"], 9), v["metric"])):
        d = "-" if v["delta_pct"] is None else f"{v['delta_pct']:+.1f}"
        b = "-" if v["band_pct"] is None else f"{v['band_pct']:.1f}"
        base = "-" if v["baseline"] is None else f"{v['baseline']:.1f}"
        lines.append(
            f"{v['verdict']:12s} {d:>8s} {b:>7s} {base:>12s} "
            f"{v['value']:12.1f}  {v['metric']} [{v['backend']}]"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# runtime anomaly watch
# ---------------------------------------------------------------------------

def check_step_spike(
    wall_ms: float,
    window_mean_ms: Optional[float],
    window_count: int,
    spike_factor: float = 2.5,
    min_window: int = 8,
) -> Optional[Dict[str, Any]]:
    """Window-relative step-wall spike test (pure; the manager feeds the
    gauge ring's mean from BEFORE the current sample so a spike can't
    mask itself).  Returns the structured event or None."""
    if window_mean_ms is None or window_count < min_window or window_mean_ms <= 0:
        return None
    if wall_ms <= spike_factor * window_mean_ms:
        return None
    return {
        "event": "step_wall_spike",
        "wall_ms": round(float(wall_ms), 3),
        "window_mean_ms": round(float(window_mean_ms), 3),
        "factor": round(float(wall_ms) / float(window_mean_ms), 2),
        "threshold_factor": spike_factor,
    }


def find_stragglers(
    latest: Dict[int, Dict[str, float]],
    alive: List[int],
    key_substr: str = "step_wall_ms",
    factor: float = 1.5,
) -> List[Dict[str, Any]]:
    """Cross-rank straggler test on the heartbeat-piggybacked snapshots:
    for every step-wall metric present on >= 2 live ranks, flag ranks
    whose wall exceeds ``factor`` x the cluster median."""
    by_metric: Dict[str, List[Tuple[int, float]]] = {}
    for r in alive:
        for name, v in (latest.get(r) or {}).items():
            if key_substr in name:
                by_metric.setdefault(name, []).append((r, float(v)))
    out: List[Dict[str, Any]] = []
    for name, pairs in sorted(by_metric.items()):
        if len(pairs) < 2:
            continue
        med = statistics.median(v for _, v in pairs)
        if med <= 0:
            continue
        for r, v in pairs:
            if v > factor * med:
                out.append({
                    "event": "straggler", "rank": r, "metric": name,
                    "value": round(v, 3), "cluster_median": round(med, 3),
                    "factor": round(v / med, 2), "threshold_factor": factor,
                })
    return out
