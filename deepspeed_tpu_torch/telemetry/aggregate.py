"""Cross-rank metric aggregation over the supervision heartbeat channel
(counterpart of ``deepspeed_tpu/telemetry/aggregate.py``).  The port has
the encoding and the aggregator; the heartbeat that carries them is not
ported yet (ROADMAP A14 resilience/supervision/), so
``telemetry.aggregate: true`` is refused by the config.

Per-rank metric snapshots piggyback on the liveness beats the
supervision plane sends: each beat carries
the rank's :meth:`MetricsRegistry.snapshot_compact` as one compact JSON
payload, so cross-rank observability costs zero extra connections,
zero collectives, and nothing on the hot path (the beat thread already
exists and already wakes on its interval).

Rank 0's supervisor feeds a :class:`CrossRankAggregator`: per metric it
exports min/mean/max/n across the ranks it has heard from, and —
because the channel is the same one that detects death — a dead rank is
flagged **in the same stream** (``dead_ranks``), with its last-seen
snapshot retained so the post-mortem shows where it stopped.

The exported aggregate stream is JSONL (``aggregate_rank0.jsonl`` under
the telemetry output dir): one line per export with ``alive``/``dead``
rank lists and the per-metric min/mean/max table.  Rank 0's registry
also carries the roll-up as ``cluster/*`` gauges so the Prometheus /
TensorBoard exporters see the cluster view alongside the local one.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


def encode_metrics(compact: Dict[str, float]) -> str:
    """Beat-line payload: compact JSON with NO whitespace (the TCP beat
    protocol is whitespace-split) and values rounded upstream."""
    return json.dumps(compact, separators=(",", ":"), sort_keys=True)


def decode_metrics(payload: str) -> Optional[Dict[str, float]]:
    try:
        d = json.loads(payload)
    except ValueError:
        return None
    return d if isinstance(d, dict) else None


class CrossRankAggregator:
    """Rank-0 state: latest (seq, metrics) per rank + liveness marks."""

    def __init__(self, world_size: int, jsonl_path: Optional[str] = None,
                 registry=None, straggler_factor: float = 1.5):
        self.world_size = int(world_size)
        self.jsonl_path = os.path.abspath(jsonl_path) if jsonl_path else None
        self.registry = registry
        self.straggler_factor = float(straggler_factor)
        self._flagged_stragglers: set = set()
        self.exports = 0
        self._lock = threading.Lock()
        self._latest: Dict[int, Dict[str, float]] = {}
        self._seq: Dict[int, int] = {}
        self._dead: Dict[int, str] = {}
        self._bye: set = set()
        self._dirty = False
        if self.jsonl_path:
            d = os.path.dirname(self.jsonl_path)
            if d:
                os.makedirs(d, exist_ok=True)

    # -- feeding -----------------------------------------------------------
    def update(self, rank: int, seq: int, metrics: Optional[Dict[str, float]]) -> None:
        """Feed one rank's beat payload.  Only a strictly newer seq (or
        a first sighting) dirties the aggregator — the supervisor
        re-feeds the channel's latest table every poll cycle, and an
        unchanged beat must not grow the export stream."""
        if metrics is None:
            return
        with self._lock:
            if rank not in self._seq or seq > self._seq[rank]:
                self._seq[int(rank)] = int(seq)
                self._latest[int(rank)] = dict(metrics)
                self._dirty = True

    def mark_dead(self, rank: int, reason: str = "") -> None:
        with self._lock:
            if rank not in self._dead:
                self._dead[int(rank)] = reason
                self._dirty = True

    def mark_bye(self, rank: int) -> None:
        with self._lock:
            self._bye.add(int(rank))
            self._dirty = True

    @property
    def dirty(self) -> bool:
        return self._dirty

    # -- aggregation -------------------------------------------------------
    def aggregate(self) -> Dict[str, Any]:
        with self._lock:
            latest = {r: dict(m) for r, m in self._latest.items()}
            dead = dict(self._dead)
            bye = set(self._bye)
            seqs = dict(self._seq)
        alive = sorted(r for r in latest if r not in dead and r not in bye)
        names: Dict[str, List[float]] = {}
        # aggregate over LIVE ranks only — a dead rank's frozen counters
        # would drag every mean toward its moment of death
        for r in alive:
            for name, v in latest[r].items():
                names.setdefault(name, []).append(float(v))
        table = {
            name: {
                "min": min(vs), "mean": sum(vs) / len(vs), "max": max(vs),
                "n": len(vs),
            }
            for name, vs in sorted(names.items())
        }
        # runtime anomaly watch (regression.py): rank step wall vs the
        # cluster median, flagged in the SAME stream that detects death
        from deepspeed_tpu_torch.telemetry.regression import find_stragglers

        stragglers = find_stragglers(
            latest, alive, factor=self.straggler_factor
        )
        return {
            "ts": time.time(),
            "world_size": self.world_size,
            "alive": alive,
            "stragglers": stragglers,
            "dead": [
                {"rank": r, "reason": reason, "last_seq": seqs.get(r),
                 "last_metrics": latest.get(r)}
                for r, reason in sorted(dead.items())
            ],
            "departed": sorted(bye),
            "metrics": table,
        }

    def export_line(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """Append one aggregate record to the JSONL stream (and mirror
        it into ``cluster/*`` gauges) when anything changed since the
        last export.  Returns the record, or None when clean."""
        if not self._dirty and not force:
            return None
        agg = self.aggregate()
        self._dirty = False
        if self.registry is not None and self.registry.enabled:
            self.registry.gauge("cluster/alive_ranks").set(len(agg["alive"]))
            self.registry.gauge("cluster/dead_ranks").set(len(agg["dead"]))
            flagged = {s["rank"] for s in agg["stragglers"]}
            # rank count, not (rank, metric) pairs — consistent with the
            # sibling alive/dead rank gauges
            self.registry.gauge("cluster/stragglers").set(len(flagged))
            for s in agg["stragglers"]:
                self.registry.gauge(
                    "cluster/straggler_factor", rank=s["rank"]
                ).set(s["factor"])
            # a recovered rank must stop reading as a straggler: zero
            # the per-rank gauge the moment it drops off the list
            for rank in self._flagged_stragglers - flagged:
                self.registry.gauge("cluster/straggler_factor", rank=rank).set(0.0)
            self._flagged_stragglers = flagged
            for name, row in agg["metrics"].items():
                # qualified names may carry labels ({...}); keep them in
                # the gauge name verbatim — the cluster view is keyed by
                # what the ranks sent
                self.registry.gauge(f"cluster/{name}/mean").set(row["mean"])
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(agg) + "\n")
        self.exports += 1
        return agg
