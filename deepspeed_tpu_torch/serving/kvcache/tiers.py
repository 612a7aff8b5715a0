"""Hierarchical KV page tiering: device memory (T0) → pinned host memory
(T1) → disk (T2), with overlap-hidden swaps (counterpart of
``deepspeed_tpu/serving/kvcache/tiers.py``; the policy is the JAX
package's, line for line).

The device :class:`~deepspeed_tpu_torch.serving.kvcache.pages.PagedKVPool`
is tier 0.  Cold state — unreferenced prefix entries past the LRU
watermark, parked-session pages, and the tail pages of contexts beyond
the residency window — demotes T0→T1→T2 so KV capacity becomes a
function of host+disk, not device memory.  Promotion is demand-driven (a
rebind or prefix hit pages the entry back in before the slot binds) plus
scheduler-hinted (queued admits prefetch their pages back to T0 before
their prefill chunk runs).

Threading contract:

* The **engine thread** owns every device touch.  T0↔T1 moves run at
  step boundaries under ``pool._lock`` → ``self._lock`` (always that
  order), so page tables are only ever rewritten between steps: they
  stay fixed-shape device tensors rewritten in place, and tiering never
  changes the shape of a prefill or decode call.  The demotions of one
  :meth:`tick` gather in ONE ``index_select`` per cache leaf over all
  their pages, copied ``non_blocking`` into pinned host tensors
  (``pool._gather_pinned``), and each entry keeps a view of its pages;
  a promotion is one ``index_copy_`` per leaf (``pool._scatter_device``).
* Host memory is read only after its copy completed: every entry
  carries the CUDA event recorded after its gather (``ready``), and
  every host read of its leaves — a disk write, a merge, an export, a
  scatter back — synchronizes it first (:meth:`_leaves`).
* The **migration worker** (one :class:`BoundedWorker` thread) owns the
  slow tier boundary only: T1→T2 npz writes and T2→T1 reads.  It takes
  ``self._lock`` alone, reads and writes host tensors and files only,
  and never touches the pool or a CUDA tensor, so there is no
  lock-order cycle and no background thread races the engine's device
  work.

T2 durability is the checkpoint protocol's stage→manifest: kv.npz +
meta.json staged and fsynced first, ``manifest.json`` written LAST
(fault site ``tier.demote`` sits between the two, so an injected kill
leaves exactly the torn, never-trusted stage the chaos test wants).
``recover()`` trusts only manifest-verified directories.  The disk
format is the session spill's (``sessions.py``), bfloat16 as its uint16
view.

**Across ranks** (``agree`` and ``decide`` given: an engine under a
process group, each ``model`` rank's pool holding its own heads): every
rank demotes and promotes its own pages and writes its T2 entries under
a directory of its own (the engine passes ``disk_dir/model<r>``), and
every rank must take the same branch at every decision.  The engine
thread's decisions read only state that changes at the step boundary on
every rank alike (rank 0's broadcast clock, the pool's allocator, the
entries' tiers); a worker job's end is the one thing that lands at a
different moment on each rank.  So a job's end only records its outcome
on the entry, and :meth:`_settle`, at the tick, applies the outcomes
every rank has (one MIN all-reduce of two flags an entry: finished, and
verified): a write every rank committed moves its entry to T2, a read
every rank verified moves it back to T1, a read that failed on any rank
drops the entry on every rank (a miss: the request re-prefills).  A
demand read of T2 (:meth:`_materialize`) agrees the same way.  A new
job is queued only while the jobs not yet settled (an entry dropped with
its job in flight stays counted until its end is agreed) leave the
worker's queue room, so a submission never fails on one rank alone, and
:meth:`flush` and :meth:`recover` agree on their rounds and on the
entries every rank verified.

Swap-hiding is measured, not assumed: the engine stamps each step's
wall window into a ring; every worker job computes how much of its own
duration overlapped a step window.  ``swap_hidden_ratio`` in
:meth:`stats` is that share.  On a CUDA pool each T0→T1 gather and each
T1→T0 scatter is timed with a pair of CUDA events (``gather_ms`` /
``scatter_ms`` and their page counts in :meth:`stats`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.resilience import atomic, faults
from deepspeed_tpu_torch.runtime.overlap.worker import BoundedWorker
from deepspeed_tpu_torch.serving.kvcache.prefix import PrefixEntry, PrefixIndex
from deepspeed_tpu_torch.serving.kvcache.sessions import (
    DATA_FILE,
    META_FILE,
    Session,
    load_leaves,
    prefix_dir_name,
    save_leaves,
    session_dir_name,
    write_entry,
)
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["PageTierManager", "TierEntry"]

_HOST = "host"
_DISK = "disk"

Leaves = Dict[str, torch.Tensor]


def _pages_for(tokens: int, page_len: int) -> int:
    return -(-int(tokens) // int(page_len))


def _leaf_bytes(leaves: Optional[Leaves]) -> int:
    if not leaves:
        return 0
    return int(sum(t.numel() * t.element_size() for t in leaves.values()))


def _cat(head: Leaves, tail: Leaves) -> Leaves:
    """Two entries' leaves joined along the page axis."""
    if not head:
        return dict(tail)
    return {k: torch.cat([head[k], tail[k]], dim=1) for k in tail}


@dataclasses.dataclass
class TierEntry:
    """One off-device KV entry.  ``kind`` is ``session`` (a whole parked
    session), ``tail`` (the beyond-residency-window tail pages of a
    still-warm session; T1-only by construction), or ``prefix`` (a
    demoted learned prefix)."""

    key: str
    kind: str
    tokens: np.ndarray
    n_pages: int
    tier: str  # _HOST | _DISK
    leaves: Optional[Leaves] = None
    dir_name: str = ""
    last_used: float = 0.0
    pinned: bool = False
    session_id: str = ""
    parked_at: float = 0.0
    writing: bool = False  # T1->T2 write in flight on the worker
    reading: bool = False  # T2->T1 read in flight on the worker
    # the CUDA event recorded after the gather that filled ``leaves``;
    # host reads wait on it (None once waited, and on the CPU)
    ready: Any = None
    # across ranks: a finished worker job's outcome (True: committed or
    # verified), applied by _settle once every rank has one
    outcome: Optional[bool] = None
    read: Optional[Leaves] = None  # a finished read's leaves, until then

    @property
    def host_bytes(self) -> int:
        return _leaf_bytes(self.leaves)


@dataclasses.dataclass
class _Gather:
    """One entry's share of a tick's batched gather: its device pages,
    in order, then (``suffix``) host leaves already off the device."""

    entry: TierEntry
    pages: List[int]
    suffix: Optional[Leaves] = None


class PageTierManager:
    """Three-tier page residency manager over a :class:`PagedKVPool`.

    Engine-thread entry points (``tick`` and every ``promote_*`` /
    ``demote_*``) must hold ``pool._lock`` before this manager's lock;
    :meth:`tick` acquires it itself.  Worker jobs take only
    ``self._lock``.
    """

    def __init__(self, pool: Any, host_pages: int = 0,
                 disk_dir: Optional[str] = None,
                 residency_window: int = 0,
                 demote_watermark: float = 0.75,
                 prefetch_ahead: int = 4,
                 demote_batch: int = 4,
                 worker_depth: int = 32,
                 agree: Optional[Callable[[List[int]], List[int]]] = None,
                 decide: Optional[Callable[[Any], Any]] = None):
        """``agree`` (each flag's MIN over the ranks, a collective) and
        ``decide`` (rank 0's value on every rank) put the manager across
        ranks (module docstring); None: one process."""
        self.pool = pool
        self.telemetry: Any = None  # the engine hands its TelemetryManager
        self._agree = agree
        self._decide = decide if decide is not None else (lambda value: value)
        self._depth = int(worker_depth)
        # across ranks: dropped entries whose worker job is not settled
        self._zombies: List[TierEntry] = []
        self.host_pages = max(0, int(host_pages))  # 0 = unbounded T1
        self.disk_dir = disk_dir or None
        self.residency_window = max(0, int(residency_window))
        self.demote_watermark = float(demote_watermark)
        self.prefetch_ahead = max(0, int(prefetch_ahead))
        self.demote_batch = max(1, int(demote_batch))
        if not (0.0 < self.demote_watermark <= 1.0):
            raise ValueError(
                f"demote_watermark must be in (0, 1], got {demote_watermark}")
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._entries: Dict[str, TierEntry] = {}
        self._pfx = PrefixIndex()  # shadow index over tier-resident prefixes
        self._promoting: set = set()  # session ids mid-promotion: not demotable
        self._dirgen = 0  # T2 dir generation: a re-demoted session never
        # reuses its previous on-disk dir (whose rmtree may be in flight)
        self._worker = BoundedWorker(name="ds-kv-tiers", depth=worker_depth)
        # engine step windows for the swap-hide overlap accounting
        self._steps: Deque[Tuple[float, float]] = deque(maxlen=256)
        # a tick's demotions, gathered together at the end of its pass
        self._batch: Optional[List[_Gather]] = None
        # CUDA event pairs of the device moves: (kind, start, end, pages)
        self._moves: List[Tuple[str, Any, Any, int]] = []
        self.move_ms = {"gather": 0.0, "scatter": 0.0}
        self.move_pages = {"gather": 0, "scatter": 0}
        self.move_calls = {"gather": 0, "scatter": 0}
        # counters (stats() reads these)
        self.demote_t0_t1 = 0
        self.demote_t1_t2 = 0
        self.promote_t1_t0 = 0
        self.promote_t2_t1 = 0
        self.promote_t2_t0 = 0  # demand-driven synchronous disk reads
        self.tail_demotions = 0
        self.tail_promotions = 0
        self.hits_t1 = 0
        self.hits_t2 = 0
        self.misses = 0
        self.drops = 0
        self.prefetch_jobs = 0
        self.swap_seconds_total = 0.0
        self.swap_seconds_hidden = 0.0

    # -- keys ---------------------------------------------------------
    @staticmethod
    def _skey(session_id: str) -> str:
        return "sess:" + session_id

    @staticmethod
    def _tkey(session_id: str) -> str:
        return "tail:" + session_id

    @staticmethod
    def _pkey(tokens: np.ndarray) -> str:
        return "pfx:" + np.asarray(tokens, np.int32).tobytes().hex()[:32]

    # -- device moves (engine thread) ----------------------------------
    def _timed(self, kind: str, n_pages: int, fn):
        """Run one device move; on a CUDA pool a pair of CUDA events
        brackets it (read in :meth:`stats`, never waited on here)."""
        if not self.pool.on_cuda:
            return fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        self._moves.append((kind, start, end, int(n_pages)))
        return out

    def _gather(self, e: TierEntry, pages: Sequence[int],
                suffix: Optional[Leaves] = None) -> None:
        """T0→T1 for ``e``: its leaves become the host copy of ``pages``
        (then ``suffix`` along the page axis).  Inside a tick's demote
        pass the gather joins the pass's batch (one ``index_select`` per
        leaf at the end of the pass); elsewhere it runs now."""
        item = _Gather(e, list(pages), suffix)
        if self._batch is not None:
            self._batch.append(item)
        else:
            self._run_gathers([item])

    def _run_gathers(self, items: List[_Gather]) -> None:
        """One gather over every item's pages; each entry keeps a view
        of its pages.  The freed pages are not reused before this runs:
        a demote pass claims none, and a claim outside one gathers at
        once."""
        pages = [p for it in items for p in it.pages]
        leaves, ready = ({}, None) if not pages else self._timed(
            "gather", len(pages), lambda: self.pool._gather_pinned(pages))
        off = 0
        for it in items:
            n = len(it.pages)
            part = {k: v.narrow(1, off, n) for k, v in leaves.items()} if n else {}
            off += n
            if it.suffix is not None:
                if ready is not None:
                    ready.synchronize()
                part = _cat(part, it.suffix)
                it.entry.ready = None
            else:
                it.entry.ready = ready
            it.entry.leaves = part

    def _leaves(self, e: TierEntry) -> Optional[Leaves]:
        """``e``'s host leaves, once their copy has completed."""
        if e.ready is not None:
            e.ready.synchronize()
            e.ready = None
        return e.leaves

    def _scatter(self, pages: Sequence[int], leaves) -> None:
        """T1→T0: one ``index_copy_`` per leaf into ``pages``."""
        self._timed("scatter", len(pages),
                    lambda: self.pool._scatter_device(pages, leaves))

    def _resolve_moves(self, wait: bool) -> None:
        """Fold the move events into ``move_ms``: every pair (``wait``: a
        wait for the newest), else the completed ones.  Engine thread."""
        if wait and self._moves:
            self._moves[-1][2].synchronize()
        left = []
        for kind, start, end, n in self._moves:
            if not (wait or end.query()):
                left.append((kind, start, end, n))
                continue
            self.move_ms[kind] += start.elapsed_time(end)
            self.move_pages[kind] += n
            self.move_calls[kind] += 1
        self._moves = left

    # -- swap-hide accounting -----------------------------------------
    def note_step(self, start: float, end: float) -> None:
        """Record one engine step's wall window (monotonic stamps)."""
        with self._lock:
            self._steps.append((float(start), float(end)))

    def _hidden_overlap(self, start: float, end: float) -> float:
        with self._lock:
            windows = list(self._steps)
        hidden = 0.0
        for ws, we in windows:
            hidden += max(0.0, min(end, we) - max(start, ws))
        return min(hidden, end - start)

    def _account_swap(self, op: str, start: float, end: float, n_pages: int) -> None:
        dur = max(0.0, end - start)
        hidden = self._hidden_overlap(start, end)
        with self._lock:
            self.swap_seconds_total += dur
            self.swap_seconds_hidden += hidden
        tracer = getattr(self.telemetry, "tracer", None)
        if tracer is not None and getattr(tracer, "enabled", False):
            # one span per disk job on the tiers' lane (host I/O: the host
            # clock is its time)
            tracer.add_span(f"tier.{op}", "serving.tier", start, end, tid=3,
                            tid_name="kv tiers",
                            args={"pages": int(n_pages), "hidden_s": round(hidden, 6)})

    # -- T2 staging (worker thread) -----------------------------------
    def _write_t2(self, entry_dir: str, meta: Dict, leaves) -> str:
        """Stage one tier entry to disk, manifest LAST.  The
        ``tier.demote`` fault site sits between the staged payload and
        the manifest: an injected kill leaves a torn stage that
        :meth:`recover` never trusts."""
        target = os.path.join(self.disk_dir, entry_dir)
        os.makedirs(target, exist_ok=True)
        stale = os.path.join(target, atomic.MANIFEST_FILE)
        if os.path.exists(stale):
            os.remove(stale)
        dtypes = save_leaves(leaves, os.path.join(target, DATA_FILE))
        meta = dict(meta)
        meta["leaf_dtypes"] = dtypes
        atomic.atomic_write_text(os.path.join(target, META_FILE),
                                 json.dumps(meta))
        faults.check("tier.demote")
        atomic.write_manifest(target)
        return target

    def _read_t2(self, entry_dir: str, quiet: bool = False) -> Optional[Leaves]:
        target = os.path.join(self.disk_dir, entry_dir)
        ok, _ = atomic.verify_manifest(target)
        meta_path = os.path.join(target, META_FILE)
        if not ok or not os.path.exists(meta_path):
            if not quiet:
                logger.warning(
                    f"kvcache: tier entry at {target} failed manifest "
                    f"verification; ignoring it")
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        return load_leaves(os.path.join(target, DATA_FILE), meta["leaf_dtypes"])

    def _entry_meta(self, e: TierEntry) -> Dict:
        if e.kind == "session":
            return {"kind": "session", "session_id": e.session_id,
                    "tokens": [int(t) for t in e.tokens],
                    "parked_at": e.parked_at}
        return {"kind": "prefix", "tokens": [int(t) for t in e.tokens],
                "pinned": bool(e.pinned)}

    def _remove_dir(self, dir_name: str) -> None:
        if not (self.disk_dir and dir_name):
            return
        shutil.rmtree(os.path.join(self.disk_dir, dir_name),
                      ignore_errors=True)

    # -- worker jobs ---------------------------------------------------
    def _in_flight(self) -> List[TierEntry]:
        """Registered entries with a job in flight, in key order, then the
        dropped ones whose job is not settled (``self._lock`` held)."""
        return sorted((e for e in self._entries.values() if e.writing or e.reading),
                      key=lambda e: e.key) + self._zombies

    def _room(self) -> bool:
        """Whether a job may be queued.  Across ranks: while the jobs not
        yet settled (the same count on every rank, and never fewer than
        the worker holds) leave its queue room; one process asks the
        worker itself (:meth:`_queue`)."""
        if self._agree is None:
            return True
        with self._lock:
            return len(self._in_flight()) < self._depth

    def _queue(self, job, label: str) -> bool:
        if self._worker.submit(job, label=label):
            return True
        if self._agree is not None:  # _room left the queue room: the worker is closed
            raise RuntimeError(f"kvcache: the tier worker refused {label}")
        return False

    def _end_write(self, entry: TierEntry, ok: Optional[bool]) -> None:
        """A write job's end on the worker: ``ok`` True committed, False
        its directory vanished under it, None it raised (a torn stage
        stays on disk).  Across ranks the outcome waits for
        :meth:`_settle` (a raise counts as a failure)."""
        with self._lock:
            registered = self._entries.get(entry.key) is entry
            if not registered and ok is not None:
                # consumed while the write was in flight: the staged copy
                # is stale (or its staging dir was rmtree'd under the write)
                self._remove_dir(entry.dir_name)
            if self._agree is not None:
                entry.outcome = bool(ok)
            elif ok is None:
                return
            elif ok and registered:
                self._finish_write(entry, True)
            else:
                entry.writing = False
                self._remove_dir(entry.dir_name)

    def _end_read(self, entry: TierEntry, leaves: Optional[Leaves], done: bool) -> None:
        """A read job's end on the worker (``done`` False: it raised)."""
        with self._lock:
            if self._agree is not None:
                entry.read, entry.outcome = leaves, leaves is not None
            elif self._entries.get(entry.key) is not entry:
                if done:
                    entry.reading = False  # consumed or discarded while reading
            elif done:
                self._finish_read(entry, leaves)

    def _finish_write(self, entry: TierEntry, ok: bool) -> None:
        """A T1→T2 write's end (``self._lock`` held): committed, the entry
        moves to T2; failed, it stays in T1 and the staged copy goes."""
        entry.writing = False
        if not ok:
            self._remove_dir(entry.dir_name)
            return
        entry.leaves = None
        entry.tier = _DISK
        self.demote_t1_t2 += 1

    def _finish_read(self, entry: TierEntry, leaves: Optional[Leaves]) -> None:
        """A T2→T1 read's end (``self._lock`` held): verified, the entry
        is host-resident again; torn on disk, it is dropped."""
        entry.reading = False
        if leaves is None:
            logger.warning(f"kvcache: tier entry {entry.key} unreadable at "
                           f"{entry.dir_name}; dropping it")
            self._drop_entry(entry)  # torn on disk: unrecoverable
            return
        if entry.tier == _DISK:
            entry.leaves = leaves
            entry.tier = _HOST
            self.promote_t2_t1 += 1

    def _settle(self) -> None:
        """Across ranks: apply every finished job's outcome that every rank
        has (engine thread, at the tick; a collective when any entry is in
        flight, the same entries on every rank).  An entry whose job has
        not ended on some rank waits for the next tick; a job that ended
        on every rank but failed on one fails on all."""
        if self._agree is None:
            return
        with self._lock:
            pending = self._in_flight()
            flags = [f for e in pending for f in (int(e.outcome is not None),
                                                  int(bool(e.outcome)))]
        if not pending:
            return
        agreed = self._agree(flags)
        with self._lock:
            n_live, ended = len(pending) - len(self._zombies), set()
            for i, e in enumerate(pending):
                if not agreed[2 * i]:
                    continue
                if i >= n_live:  # dropped: its job has simply ended
                    e.writing = e.reading = False
                    ended.add(id(e))
                elif e.writing:
                    self._finish_write(e, bool(agreed[2 * i + 1]))
                else:
                    self._finish_read(e, e.read if agreed[2 * i + 1] else None)
                e.outcome, e.read = None, None
            self._zombies = [z for z in self._zombies if id(z) not in ended]

    def _submit_write(self, e: TierEntry) -> bool:
        """T1→T2: queue ``e``'s leaves for a background disk write.
        Caller (the engine thread) holds ``self._lock``; ``e.writing``
        guards re-submit.  The leaves' copy completes before the job is
        queued: the worker never waits on the device."""
        if not self.disk_dir or e.writing or e.kind == "tail" or not self._room():
            return False
        leaves = self._leaves(e)
        if leaves is None:
            return False
        e.writing = True
        self._dirgen += 1
        base = (session_dir_name(e.session_id) if e.kind == "session"
                else prefix_dir_name(e.tokens))
        e.dir_name = f"{base}-g{self._dirgen}"
        meta = self._entry_meta(e)

        def job(entry=e, leaves=leaves, meta=meta):
            t0 = time.monotonic()
            ok = None
            try:
                self._write_t2(entry.dir_name, meta, leaves)
                ok = True
            except FileNotFoundError:
                # the entry was consumed and _drop_entry rmtree'd the
                # staging dir out from under the write — nothing to keep
                ok = False
            finally:
                self._end_write(entry, ok)
            if ok:
                self._account_swap("demote", t0, time.monotonic(), entry.n_pages)

        if not self._queue(job, label=f"demote:{e.key}"):
            e.writing = False
            return False
        return True

    def _submit_read(self, e: TierEntry) -> bool:
        """T2→T1 prefetch: queue a background disk read so a hinted
        promotion finds the leaves already host-resident.  Caller holds
        ``self._lock``."""
        if e.tier != _DISK or e.reading or e.writing or not self._room():
            return False
        e.reading = True

        def job(entry=e):
            t0 = time.monotonic()
            leaves, done = None, False
            try:
                faults.check("tier.promote")
                # quiet: a demand promotion may consume the entry (and
                # remove its dir) while this prefetch is in flight — that
                # is a benign race, not a torn stage
                leaves = self._read_t2(entry.dir_name, quiet=True)
                done = True
            finally:
                self._end_read(entry, leaves, done)
            if leaves is not None:
                self._account_swap("promote", t0, time.monotonic(), entry.n_pages)

        if not self._queue(job, label=f"prefetch:{e.key}"):
            e.reading = False
            return False
        self.prefetch_jobs += 1
        return True

    def _pump_errors(self) -> None:
        for label, exc in self._worker.errors():
            if isinstance(exc, (faults.InjectedKill, faults.InjectedFault)):
                raise exc  # fault-injection tests want these surfaced
            logger.warning(f"kvcache: tier migration job {label} failed: {exc}")

    # -- registration helpers (self._lock held) ------------------------
    def _register(self, e: TierEntry) -> None:
        self._entries[e.key] = e
        if e.kind == "prefix":
            shadow = PrefixEntry(tokens=e.tokens, pages=[], pinned=e.pinned,
                                 last_used=e.last_used, tier_key=e.key)
            self._pfx.insert(shadow)

    def _drop_entry(self, e: TierEntry) -> None:
        if (self._agree is not None and (e.writing or e.reading)
                and all(z is not e for z in self._zombies)):
            self._zombies.append(e)  # its job's end is agreed as any other's
        self._entries.pop(e.key, None)
        if e.kind == "prefix":
            shadow = self._pfx.get(e.tokens)
            if shadow is not None and shadow.tier_key == e.key:
                self._pfx.remove(shadow)
        if e.tier == _DISK or e.writing:
            self._remove_dir(e.dir_name)

    def _materialize(self, e: TierEntry) -> Optional[Leaves]:
        """Entry leaves, reading T2 synchronously when a demand
        promotion outruns its prefetch.  Returns None (and drops the
        entry) when the disk copy is unverifiable."""
        if e.leaves is not None:
            self.hits_t1 += 1
            return self._leaves(e)
        leaves = self._read_t2(e.dir_name)
        ok = leaves is not None
        if self._agree is not None:
            ok = bool(self._agree([int(ok)])[0])  # verified on every rank, or a miss on all
        if not ok:
            self._drop_entry(e)
            return None
        self.hits_t2 += 1
        self.promote_t2_t0 += 1
        return leaves

    # -- demotion (engine thread, pool lock held) -----------------------
    def _pending(self, e: TierEntry) -> Optional[_Gather]:
        """``e``'s gather, when it waits in the current batch."""
        for it in self._batch or ():
            if it.entry is e:
                return it
        return None

    def demote_session(self, sess: Session, now: float = 0.0) -> bool:
        """Park a whole warm session in T1 (merging any tier-held tail),
        releasing its T0 pages.  The pool's ``_spill_or_drop`` routes
        here when tiering is armed."""
        sid = sess.session_id
        with self._lock:
            if sid in self._promoting:
                return False  # mid-promotion: not a demotion candidate
            tail = self._entries.get(self._tkey(sid))
            n_pages = len(sess.pages) + (tail.n_pages if tail else 0)
            e = TierEntry(
                key=self._skey(sid), kind="session", tokens=sess.tokens,
                n_pages=n_pages, tier=_HOST, last_used=now, session_id=sid,
                parked_at=sess.parked_at,
            )
            pages, suffix = list(sess.pages), None
            if tail is not None:
                self._entries.pop(tail.key, None)
                queued = self._pending(tail)
                if queued is not None:
                    # the tail's gather has not run: its pages (freed in
                    # this pass, not yet reused) join the session's
                    self._batch.remove(queued)
                    pages += queued.pages
                else:
                    suffix = self._leaves(tail)
            self._register(e)
            self.demote_t0_t1 += 1
        self._gather(e, pages, suffix)
        self.pool.sessions.pop_warm(sid)
        self.pool._page_decref(sess.pages)
        sess.pages = []
        return True

    def demote_tail(self, sess: Session, now: float = 0.0) -> int:
        """Demote a warm session's pages beyond the residency window to
        T1 (the session stays warm and rebinds promote the tail back
        first).  Returns the number of pages demoted."""
        if self.residency_window <= 0:
            return 0
        sid = sess.session_id
        keep = max(1, _pages_for(self.residency_window, self.pool.page_len))
        with self._lock:
            if sid in self._promoting or self._tkey(sid) in self._entries:
                return 0
        if len(sess.pages) <= keep:
            return 0
        tail_pages = sess.pages[keep:]
        with self._lock:
            e = TierEntry(
                key=self._tkey(sid), kind="tail", tokens=sess.tokens,
                n_pages=len(tail_pages), tier=_HOST, last_used=now,
                session_id=sid,
            )
            self._register(e)
            self.tail_demotions += 1
        self._gather(e, tail_pages)
        self.pool._page_decref(tail_pages)
        sess.pages = sess.pages[:keep]
        return len(tail_pages)

    def demote_prefix(self, entry: PrefixEntry, now: float = 0.0) -> bool:
        """Move a learned prefix entry out of the device index into T1.
        Pages shared with live slots stay alive through their other
        holders; this only releases the index's reference."""
        with self._lock:
            key = self._pkey(entry.tokens)
            e = None
            if key not in self._entries:  # else already tiered under this key
                e = TierEntry(
                    key=key, kind="prefix", tokens=entry.tokens,
                    n_pages=len(entry.pages), tier=_HOST,
                    last_used=max(now, entry.last_used), pinned=entry.pinned,
                )
                self._register(e)
                self.demote_t0_t1 += 1
        if e is not None:
            self._gather(e, entry.pages)
        self.pool.index.remove(entry)
        self.pool._page_decref(entry.pages)
        return True

    def discard_session(self, session_id: str) -> None:
        """A fresh park supersedes any tiered copy of the session (the
        mirror of ``SessionStore.park`` clearing a stale spill)."""
        with self._lock:
            for key in (self._skey(session_id), self._tkey(session_id)):
                e = self._entries.get(key)
                if e is not None:
                    self._drop_entry(e)

    def drop_session(self, sess: Session) -> None:
        """Give up on a warm session whose tail cannot be paged back in:
        release everything; the next turn re-prefills (bit-identical —
        rebind is only ever an optimisation)."""
        self.pool.sessions.drop(sess.session_id)
        self.pool._page_decref(sess.pages)
        sess.pages = []
        self.discard_session(sess.session_id)
        with self._lock:
            self.drops += 1

    # -- promotion (engine thread, pool lock held) ----------------------
    def has_session(self, session_id: str) -> bool:
        with self._lock:
            return self._skey(session_id) in self._entries

    def has_tail(self, session_id: str) -> bool:
        with self._lock:
            return self._tkey(session_id) in self._entries

    def promote_session(self, session_id: str, now: float) -> Optional[Session]:
        """Page a tiered session back into T0 and park it warm.  On
        page starvation the entry stays tiered and the caller
        re-prefills."""
        with self._lock:
            e = self._entries.get(self._skey(session_id))
            if e is None:
                self.misses += 1
                return None
            self._promoting.add(session_id)
        try:
            with self._lock:
                leaves = self._materialize(e)
                if leaves is None:
                    return None
            pages = self.pool._take_pages(e.n_pages, now)
            if pages is None:
                # routine under oversubscription: the request falls back
                # to a full prefill and the entry stays parked
                logger.debug(
                    f"kvcache: no pages to promote tiered session "
                    f"{session_id!r}; leaving it parked in "
                    f"{'T1' if e.tier == _HOST else 'T2'}")
                return None
            self._scatter(pages, leaves)
            sess = Session(session_id=session_id, tokens=e.tokens,
                           pages=pages, parked_at=now)
            self.pool.sessions.park(sess)
            with self._lock:
                self._drop_entry(e)
                self.promote_t1_t0 += 1
            return sess
        finally:
            with self._lock:
                self._promoting.discard(session_id)

    def promote_tail(self, sess: Session, now: float) -> bool:
        """Page a warm session's tiered tail back in ahead of a rebind.
        False when T0 cannot hold it (caller drops + re-prefills)."""
        sid = sess.session_id
        with self._lock:
            e = self._entries.get(self._tkey(sid))
            if e is None:
                return True
            self._promoting.add(sid)
        try:
            pages = self.pool._take_pages(e.n_pages, now)
            if pages is None:
                return False
            self._scatter(pages, self._leaves(e))
            sess.pages = sess.pages + pages
            with self._lock:
                self._drop_entry(e)
                self.tail_promotions += 1
                self.hits_t1 += 1
            return True
        finally:
            with self._lock:
                self._promoting.discard(sid)

    def lookup_prefix(self, prompt: np.ndarray,
                      stamp: bool = False) -> Optional[TierEntry]:
        """Deepest tier-resident prefix of ``prompt`` (shadow-index
        walk; no device work)."""
        with self._lock:
            shadow = self._pfx.lookup(prompt, stamp=stamp)
            if shadow is None:
                return None
            return self._entries.get(shadow.tier_key)

    def promote_prefix_for(self, prompt: np.ndarray, now: float,
                           min_len: int = 0) -> bool:
        """Demand promotion: if a tier-resident prefix of ``prompt``
        beats the device index's best hit (``min_len``), page it back
        into T0 and re-insert it into the index.  True when the caller
        should re-run its index lookup."""
        with self._lock:
            e = self.lookup_prefix(prompt, stamp=True)
            if e is None or int(e.tokens.shape[0]) <= int(min_len):
                if e is None:
                    self.misses += 1
                return False
            leaves = self._materialize(e)
            if leaves is None:
                return False
        pages = self.pool._take_pages(e.n_pages, now)
        if pages is None:
            return False
        self._scatter(pages, leaves)
        # _insert_entry takes the index's own reference; releasing the
        # promotion's claim leaves the index as the sole holder
        self.pool._insert_entry(e.tokens, pages, pinned=e.pinned, now=now)
        self.pool._page_decref(pages)
        with self._lock:
            self._drop_entry(e)
            self.promote_t1_t0 += 1
        return True

    def merged_session_leaves(self, sess: Session) -> Leaves:
        """Full host leaves for a warm session whose tail may be
        tier-held (migration export needs complete KV coverage)."""
        head = self.pool._gather_host(sess.pages) if sess.pages else {}
        with self._lock:
            tail = self._entries.get(self._tkey(sess.session_id))
            if tail is None or tail.leaves is None:
                return head
            return _cat(head, self._leaves(tail))

    # -- affinity pricing ----------------------------------------------
    def session_hint(self, prompt: np.ndarray,
                     session_id: str) -> Tuple[int, str]:
        """(cached tokens, tier) for a tiered session matching
        ``prompt`` — a router prices T1/T2 residency with this so a
        parked session still beats a cold replica."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            e = self._entries.get(self._skey(session_id))
            if e is None:
                return 0, ""
            cl = int(e.tokens.shape[0])
            if cl > prompt.shape[0] or not np.array_equal(
                    e.tokens, prompt[:cl]):
                return 0, ""
            return cl, e.tier

    def prefix_hint(self, prompt: np.ndarray) -> Tuple[int, str]:
        with self._lock:
            e = self.lookup_prefix(prompt, stamp=False)
            if e is None:
                return 0, ""
            return int(e.tokens.shape[0]), e.tier

    # -- the per-step tick (engine thread) ------------------------------
    def tick(self, now: float,
             hints: Sequence[Tuple[Any, Optional[str]]] = ()) -> None:
        """One migration-queue turn, run at step boundaries (and from
        ``stats()``/``drain()`` so an idle engine still drains pending
        demotions).  Order matters: hinted prefetch first (so imminent
        admits win the free pages), then watermark demotion (its gathers
        batched into one per leaf), then T1 cap enforcement."""
        self._pump_errors()
        self._resolve_moves(wait=False)
        self._settle()
        with self.pool._lock:
            hinted = self._prefetch(now, hints)
            self._batch = []
            try:
                self._demote_pass(now, hinted)
            finally:
                batch, self._batch = self._batch, None
                if batch:
                    self._run_gathers(batch)
            with self._lock:
                self._enforce_host_cap()

    def _prefetch(self, now: float,
                  hints: Sequence[Tuple[Any, Optional[str]]]) -> set:
        hinted: set = set()
        for prompt, sid in list(hints)[: self.prefetch_ahead]:
            if sid is not None:
                hinted.add(sid)
                warm = self.pool.sessions.peek(sid)
                if warm is not None:
                    with self._lock:
                        tail = self._entries.get(self._tkey(sid))
                    if (tail is not None
                            and self.pool.pages_free > tail.n_pages):
                        self.promote_tail(warm, now)
                    continue
                with self._lock:
                    e = self._entries.get(self._skey(sid))
                    if e is not None and e.tier == _DISK:
                        self._submit_read(e)
                        continue
                if (e is not None
                        and self.pool.pages_free > e.n_pages):
                    self.promote_session(sid, now)
                continue
            if prompt is None:
                continue
            with self._lock:
                e = self.lookup_prefix(np.asarray(prompt, np.int32))
                if e is not None and e.tier == _DISK:
                    self._submit_read(e)
                    continue
            if (e is not None and self.pool.pages_free > e.n_pages
                    and self.pool.index.get(e.tokens) is None):
                self.promote_prefix_for(np.asarray(prompt, np.int32), now)
        return hinted

    def _over_watermark(self) -> bool:
        capacity = self.pool.num_pages - 1
        return self.pool.pages_live > self.demote_watermark * capacity

    def _demote_pass(self, now: float, hinted: set) -> None:
        budget = self.demote_batch
        # residency window first: it trims warm sessions without
        # evicting anything, so it is the cheapest pressure valve
        if self.residency_window > 0:
            for sess in sorted(self.pool.sessions.warm(),
                               key=lambda s: s.parked_at):
                if budget <= 0:
                    break
                if sess.session_id in hinted:
                    continue
                if self.demote_tail(sess, now) > 0:
                    budget -= 1
        if not self._over_watermark():
            return
        for entry in self.pool.index.evict_candidates():
            if budget <= 0 or not self._over_watermark():
                return
            self.demote_prefix(entry, now)
            budget -= 1
        for sess in sorted(self.pool.sessions.warm(),
                           key=lambda s: s.parked_at):
            if budget <= 0 or not self._over_watermark():
                return
            if sess.session_id in hinted:
                continue
            if self.demote_session(sess, now):
                budget -= 1

    def _enforce_host_cap(self) -> None:
        """Push LRU T1 entries to T2 (or drop them without a disk tier)
        until the host store fits ``host_pages``.  Caller holds
        ``self._lock``."""
        if self.host_pages <= 0:
            return
        while True:
            resident = [e for e in self._entries.values()
                        if e.tier == _HOST and not e.writing
                        and e.kind != "tail"]
            used = sum(e.n_pages for e in self._entries.values()
                       if e.tier == _HOST)
            if used <= self.host_pages or not resident:
                return
            victim = min(resident, key=lambda e: e.last_used)
            if self.disk_dir:
                if not self._submit_write(victim):
                    return  # worker queue full: retry next tick
            else:
                logger.warning(
                    f"kvcache: host tier over cap with no disk tier; "
                    f"dropping {victim.key}")
                self._drop_entry(victim)
                self.drops += 1

    def export_sessions(self, dest_dir: str,
                        skip: Optional[set] = None) -> List[str]:
        """Scale-down export: write every tier-resident session into
        ``dest_dir`` in the migration wire format.  READ-ONLY on tier
        state (mirrors the pool's export contract — a killed export is
        simply retried)."""
        skip = skip or set()
        exported: List[str] = []
        with self._lock:
            entries = [e for e in self._entries.values()
                       if e.kind == "session" and e.session_id not in skip]
        for e in entries:
            with self._lock:
                leaves = self._leaves(e) if e.leaves is not None else (
                    self._read_t2(e.dir_name) if e.dir_name else None)
            if leaves is None:
                continue
            write_entry(dest_dir, session_dir_name(e.session_id),
                        self._entry_meta(e), leaves)
            exported.append(e.session_id)
        return exported

    # -- lifecycle ------------------------------------------------------
    def flush(self, now: float = 0.0, timeout: float = 30.0) -> int:
        """Drain path: demote every warm session and push every
        disk-eligible T1 entry to T2, then wait for the worker — after
        this, tiered state survives the process.  More entries than the
        worker's queue holds go in rounds: the queue drains, the rest
        follow (the JAX package's flush leaves them in host memory)."""
        moved = 0
        with self.pool._lock:
            for sess in list(self.pool.sessions.warm()):
                if self.demote_session(sess, now):
                    moved += 1
        deadline = time.monotonic() + timeout

        def in_time() -> bool:  # across ranks: every rank within its deadline
            ok = time.monotonic() <= deadline
            return ok if self._agree is None else bool(self._agree([int(ok)])[0])

        while self.disk_dir:
            with self._lock:
                left = sorted((e for e in self._entries.values()
                               if e.tier == _HOST and not e.writing and e.kind != "tail"),
                              key=lambda e: e.key)
                queued = [e for e in left if self._submit_write(e)]
            if len(queued) == len(left) or not in_time():
                break
            self._worker.drain(max(deadline - time.monotonic(), 0.0))  # the queue was full
            self._settle()
        self._worker.drain(max(deadline - time.monotonic(), 0.0))
        self._settle()
        self._pump_errors()
        return moved

    @staticmethod
    def _dir_gen(name: str) -> int:
        """Generation number from a ``<base>-g<N>`` T2 dir name (0 for
        names without one, e.g. dirs written by older builds)."""
        _, sep, tail = name.rpartition("-g")
        return int(tail) if sep and tail.isdigit() else 0

    def recover(self) -> List[str]:
        """Post-crash: re-register every manifest-verified T2 entry.
        Torn stages (kill mid-demotion, before the manifest) are left
        on disk but never trusted; when several committed generations
        of the same entry survive, the newest wins and the superseded
        dirs are removed."""
        found: List[str] = []
        if not self.disk_dir:
            return found
        best: Dict[str, Tuple[float, int, TierEntry]] = {}
        names = sorted(os.listdir(self.disk_dir)) if os.path.isdir(self.disk_dir) else []
        for name in names:
            target = os.path.join(self.disk_dir, name)
            if not (name.startswith("sess_") and os.path.isdir(target)):
                continue
            # verify_manifest() accepts a manifest-less dir as a legacy
            # tag; for tier stages no manifest means torn mid-demotion,
            # so require the commit marker explicitly
            if not os.path.exists(os.path.join(target, atomic.MANIFEST_FILE)):
                logger.warning(
                    f"kvcache: ignoring torn tier stage at {target}")
                continue
            ok, _ = atomic.verify_manifest(target)
            meta_path = os.path.join(target, META_FILE)
            if not ok or not os.path.exists(meta_path):
                logger.warning(
                    f"kvcache: ignoring unverifiable tier entry at {target}")
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            tokens = np.asarray(meta.get("tokens", []), np.int32)
            if tokens.shape[0] < 1:
                continue
            n_pages = _pages_for(tokens.shape[0], self.pool.page_len)
            if meta.get("kind", "session") == "prefix":
                e = TierEntry(
                    key=self._pkey(tokens), kind="prefix", tokens=tokens,
                    n_pages=n_pages, tier=_DISK, dir_name=name,
                    pinned=bool(meta.get("pinned", False)),
                )
            else:
                sid = meta["session_id"]
                e = TierEntry(
                    key=self._skey(sid), kind="session", tokens=tokens,
                    n_pages=n_pages, tier=_DISK, dir_name=name,
                    session_id=sid,
                    parked_at=float(meta.get("parked_at", 0.0)),
                )
            rank = (e.parked_at, self._dir_gen(name))
            prev = best.get(e.key)
            if prev is not None and (prev[0], prev[1]) >= rank:
                self._remove_dir(name)  # committed but superseded
                continue
            if prev is not None:
                self._remove_dir(prev[2].dir_name)
            best[e.key] = (rank[0], rank[1], e)
        if self._agree is not None:
            # across ranks: the entries every rank verified under the same
            # directory (rank 0's list, one flag each); the rest stay on
            # disk untrusted
            listed = self._decide(sorted((k, v[2].dir_name) for k, v in best.items()))
            flags = [int(k in best and best[k][2].dir_name == d) for k, d in listed]
            agreed = self._agree(flags) if listed else []
            best = {k: best[k] for (k, _), ok in zip(listed, agreed) if ok}
        with self._lock:
            for _, gen, e in best.values():
                self._dirgen = max(self._dirgen, gen)
                if e.key not in self._entries:
                    self._register(e)
                    found.append(e.key)
        return sorted(found)

    def close(self) -> None:
        self._worker.close()

    # -- introspection ---------------------------------------------------
    def inflight(self) -> int:
        return self._worker.pending()

    def stats(self) -> Dict[str, Any]:
        self._resolve_moves(wait=True)
        with self._lock:
            host = [e for e in self._entries.values() if e.tier == _HOST]
            disk = [e for e in self._entries.values() if e.tier == _DISK]
            total = self.swap_seconds_total
            hidden = self.swap_seconds_hidden
            out = {
                "host_entries": len(host),
                "host_pages": sum(e.n_pages for e in host),
                "host_bytes": sum(e.host_bytes for e in host),
                "disk_entries": len(disk),
                "disk_pages": sum(e.n_pages for e in disk),
                "demote_t0_t1": self.demote_t0_t1,
                "demote_t1_t2": self.demote_t1_t2,
                "promote_t1_t0": self.promote_t1_t0,
                "promote_t2_t1": self.promote_t2_t1,
                "promote_t2_t0": self.promote_t2_t0,
                "tail_demotions": self.tail_demotions,
                "tail_promotions": self.tail_promotions,
                "hits_t1": self.hits_t1,
                "hits_t2": self.hits_t2,
                "tier_misses": self.misses,
                "tier_drops": self.drops,
                "prefetch_jobs": self.prefetch_jobs,
                "inflight": self._worker.pending(),
                "swap_seconds_total": total,
                "swap_seconds_hidden": hidden,
                "swap_hidden_ratio": (hidden / total) if total > 0 else 1.0,
            }
        # the device moves, by CUDA events (None off the card: not measured)
        for kind in ("gather", "scatter"):
            n = self.move_pages[kind]
            out[f"{kind}_calls"] = self.move_calls[kind]
            out[f"{kind}_pages"] = n
            out[f"{kind}_ms"] = self.move_ms[kind] if self.pool.on_cuda else None
            out[f"{kind}_ms_per_page"] = (
                self.move_ms[kind] / n if self.pool.on_cuda and n else None)
        return out
