"""Write-ahead request journal: crash-recoverable serving state (a copy of
``deepspeed_tpu/serving/journal.py`` on the port's ``resilience``; the
on-disk format is the JAX package's, so a journal either package writes
replays in the other).

A serving engine crash (kill -9, OOM, preemption past the drain
deadline) must not lose accepted work.  The journal records every
request's lifecycle as append-only JSONL segments under one directory:

* ``submit`` — the full request (prompt, budget, eos, priority,
  sampling params), written and **fsynced before the request id is
  returned to the client**: an acknowledged request is durable.
* ``admit`` — the *effective* generation budget at admission (the
  degradation ladder may have clamped ``max_new_tokens``; a replay must
  reproduce the clamped run, not the requested one).
* ``first`` / ``retire`` — progress + completion markers.  A ``retire``
  makes the request complete: it never replays.
* ``reject`` — involuntary retirement (shed / expired), terminal like a
  retire but committed *immediately* by the engine: a crash right after
  a shed must not resurrect the shed request at replay.
* ``drain`` — the graceful-drain marker listing the ids left undone
  (informational; the undone set is derivable from submit−retire).

Recovery is replay-from-scratch: a restarted engine resubmits every
incomplete request (submitted, never retired) under its **original
request id**.  Greedy decoding is deterministic and per-request
sampling draws from generators keyed on (seed, position) — functions of
journaled fields only — so replayed outputs bit-match an uninterrupted
run (pinned in tests/test_torch_serving_resilience.py).

Durability protocol (``resilience/atomic.py``'s discipline):

* appends go to the ACTIVE segment (``wal_<n>.jsonl``); ``commit()``
  flushes + fsyncs it — the serving engine commits on every accepted
  submit and at each step boundary that retired work;
* every line carries a crc32 of its payload, so a torn tail (crash
  mid-append) is detected and dropped at replay instead of poisoning
  it; a corrupt line *followed by valid ones* is real corruption and
  raises;
* a journal instance never appends to a pre-existing file — it opens a
  fresh segment past the highest on disk (the old tail may be torn);
* segment **compaction** (bounded disk): once more than
  ``keep_segments`` sealed segments exist, the incomplete set is
  rewritten into one compact segment through the atomic tmp→rename
  protocol *before* the old segments are deleted — a kill between the
  rename and the deletes leaves duplicates, which replay dedups by id.

``serving.journal.commit`` is a fault-injection site: an injected
commit failure raises :class:`JournalError`, and the engine's response
is a **clean quarantine** — the directory is renamed ``.corrupt`` (kept
for post-mortem, never replayed) and journaling disables, while serving
continues.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.resilience import atomic, faults
from deepspeed_tpu_torch.utils.logging import logger

SEGMENT_RE = re.compile(r"^wal_(\d{6})\.jsonl$")
QUARANTINE_SUFFIX = ".corrupt"

SUBMIT = "submit"
ADMIT = "admit"
FIRST = "first"
RETIRE = "retire"
REJECT = "reject"  # involuntary retirement (shed/expired): never replays
DRAIN = "drain"


class JournalError(RuntimeError):
    """A journal write/commit failed (or the log is corrupt beyond the
    torn-tail case).  The serving engine quarantines on this."""


def _encode(rec: Dict[str, Any]) -> str:
    payload = json.dumps(rec, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(payload.encode()) & 0xFFFFFFFF
    return f"{payload} {crc:08x}\n"


def _decode(line: str) -> Optional[Dict[str, Any]]:
    """Parse one journal line; None when the line fails its crc or does
    not parse (the torn-tail shape)."""
    line = line.rstrip("\n")
    if len(line) < 10 or line[-9] != " ":
        return None
    payload, crc_hex = line[:-9], line[-8:]
    try:
        if (zlib.crc32(payload.encode()) & 0xFFFFFFFF) != int(crc_hex, 16):
            return None
        rec = json.loads(payload)
    except (ValueError, TypeError):
        return None
    return rec if isinstance(rec, dict) and "t" in rec else None


def _segment_files(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except OSError:
        return []
    return sorted(n for n in names if SEGMENT_RE.match(n))


def read_records(path: str) -> List[Dict[str, Any]]:
    """All valid records across the journal's segments, in write order.
    A single invalid TAIL line per segment is dropped (torn append); an
    invalid line followed by valid ones raises :class:`JournalError`."""
    out: List[Dict[str, Any]] = []
    for name in _segment_files(path):
        full = os.path.join(path, name)
        with open(full) as f:
            lines = f.readlines()
        bad_at: Optional[int] = None
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            rec = _decode(line)
            if rec is None:
                bad_at = i
                continue
            if bad_at is not None:
                raise JournalError(
                    f"journal segment {name} line {bad_at + 1} is corrupt but "
                    f"later lines are valid — not a torn tail; quarantine the journal"
                )
            out.append(rec)
        if bad_at is not None:
            logger.warning(
                f"serving journal: dropped torn tail line {bad_at + 1} of {name} "
                "(crash mid-append)"
            )
    return out


def incomplete_requests(path: str) -> List[Dict[str, Any]]:
    """The replay set: merged submit records (admit-effective budget,
    duplicate submits deduped by id — compaction/replay re-journaling
    both produce them) for every id without a ``retire``."""
    merged: Dict[int, Dict[str, Any]] = {}
    for rec in read_records(path):
        t, rid = rec.get("t"), rec.get("id")
        if t == SUBMIT:
            merged[rid] = dict(rec)
        elif t == ADMIT and rid in merged:
            merged[rid]["max_new"] = rec.get("max_new", merged[rid].get("max_new"))
        elif t in (RETIRE, REJECT):
            # a reject is terminal exactly like a retire: a shed/expired
            # request must never be resurrected by recover()
            merged.pop(rid, None)
    return [merged[k] for k in sorted(merged)]


def client_keys(path: str) -> Dict[str, int]:
    """client_key -> request id over every journaled submit (latest
    wins): the at-most-once admission lookup — a resubmit carrying a
    key the journal has already acknowledged is a duplicate, even
    across a crash/restart."""
    out: Dict[str, int] = {}
    for rec in read_records(path):
        if rec.get("t") == SUBMIT and rec.get("ck"):
            out[str(rec["ck"])] = int(rec["id"])
    return out


class RequestJournal:
    def __init__(self, path: str, segment_records: int = 512, keep_segments: int = 4):
        self.path = os.path.abspath(path)
        self.segment_records = max(1, int(segment_records))
        self.keep_segments = max(1, int(keep_segments))
        os.makedirs(self.path, exist_ok=True)
        segs = _segment_files(self.path)
        self._seq = (int(SEGMENT_RE.match(segs[-1]).group(1)) + 1) if segs else 0
        self._fh = None
        self._segment_count = 0  # records in the active segment
        self._pending = 0  # appended-but-uncommitted records
        self.records = 0
        self.commits = 0
        self.quarantined: Optional[str] = None
        # the highest request id ever journaled here: the engine bumps
        # the process-global id counter past it at open, so a restarted
        # process that submits BEFORE recover() cannot reuse an
        # incomplete journaled id (whose retire record would silently
        # drop the old acknowledged request from the replay set)
        self.last_request_id = -1
        # client_key -> id over journaled submits (at-most-once lookup;
        # kept current by record_submit so the engine never re-reads)
        self.client_keys: Dict[str, int] = {}
        if segs:
            try:
                for rec in read_records(self.path):
                    rid = rec.get("id", -1)
                    if isinstance(rid, int):
                        self.last_request_id = max(self.last_request_id, rid)
                    if rec.get("t") == SUBMIT and rec.get("ck"):
                        self.client_keys[str(rec["ck"])] = int(rec["id"])
            except JournalError:
                pass  # replay (recover) surfaces + quarantines corruption
            # restart-loop bound: every construction opens a fresh
            # segment, and count-based rotation may never fire in a
            # crash-looping service — compact here when over the bound
            if len(segs) > self.keep_segments:
                try:
                    self._compact(segs)
                except JournalError:
                    pass  # corrupt log: leave it for recover() to quarantine
        self._open_segment()

    # -- segment plumbing -------------------------------------------------
    def _segment_name(self, seq: int) -> str:
        return os.path.join(self.path, f"wal_{seq:06d}.jsonl")

    def _open_segment(self) -> None:
        self._fh = open(self._segment_name(self._seq), "w")
        self._segment_count = 0

    def _append(self, rec: Dict[str, Any]) -> None:
        if self._fh is None:
            raise JournalError("journal is closed" + (
                f" (quarantined to {self.quarantined})" if self.quarantined else ""))
        try:
            self._fh.write(_encode(rec))
        except OSError as e:
            raise JournalError(f"journal append failed: {e}") from e
        self._segment_count += 1
        self._pending += 1
        self.records += 1
        if self._segment_count >= self.segment_records:
            self._rotate()

    def _rotate(self) -> None:
        """Seal the active segment (commit + close), compact if the
        sealed count exceeds the bound, open the next."""
        self.commit()
        self._fh.close()
        self._fh = None
        self._seq += 1
        sealed = _segment_files(self.path)
        if len(sealed) > self.keep_segments:
            self._compact(sealed)
        self._open_segment()
        atomic.fsync_dir(self.path)

    def _compact(self, sealed: List[str]) -> None:
        """Rewrite the incomplete set into one compact segment via the
        atomic tmp→rename protocol, THEN delete the older segments (a
        kill in between leaves duplicate submits; replay dedups)."""
        live = incomplete_requests(self.path)
        dest = self._segment_name(self._seq)
        self._seq += 1
        tmp = dest + ".tmp"
        with open(tmp, "w") as f:
            for rec in live:
                f.write(_encode(rec))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
        atomic.fsync_dir(self.path)
        for name in sealed:
            try:
                os.unlink(os.path.join(self.path, name))
            except OSError as e:
                logger.warning(f"serving journal: compaction could not delete {name}: {e}")
        logger.info(
            f"serving journal: compacted {len(sealed)} segments -> "
            f"{os.path.basename(dest)} ({len(live)} incomplete requests)"
        )

    # -- record API -------------------------------------------------------
    def record_submit(self, req) -> None:
        """One scheduler Request -> a durable submit record.  The caller
        commits before acknowledging the id to the client."""
        self._append({
            "t": SUBMIT, "id": int(req.request_id),
            "prompt": [int(x) for x in req.prompt],
            "max_new": int(req.max_new_tokens),
            "eos": None if req.eos_token_id is None else int(req.eos_token_id),
            "priority": int(getattr(req, "priority", 1)),
            "deadline": req.deadline_seconds,
            "do_sample": bool(req.do_sample),
            "temperature": float(req.temperature),
            "top_k": int(req.top_k),
            "seed": int(req.seed),
            **({"ck": str(req.client_key)} if getattr(req, "client_key", None) else {}),
            **({"sid": str(req.session_id)} if getattr(req, "session_id", None) else {}),
            **({"tn": str(req.tenant)} if getattr(req, "tenant", None) else {}),
        })
        if getattr(req, "client_key", None):
            self.client_keys[str(req.client_key)] = int(req.request_id)

    def record_admit(self, req) -> None:
        self._append({"t": ADMIT, "id": int(req.request_id),
                      "max_new": int(req.max_new_tokens),
                      "hit": int(getattr(req, "prefix_hint", 0))})

    def record_first_token(self, req) -> None:
        self._append({"t": FIRST, "id": int(req.request_id),
                      "tok": int(req.generated[0]) if req.generated else None})

    def record_retire(self, req) -> None:
        # ``n`` is the REALIZED token count — the billing ground truth
        # per-tenant accounting reconciles against across a crash (at
        # most one retire per id, so a tenant is never double-billed)
        self._append({"t": RETIRE, "id": int(req.request_id),
                      "reason": req.finish_reason or "?",
                      "n": len(getattr(req, "generated", []) or [])})

    def record_reject(self, req) -> None:
        """Involuntary retirement (shed / expired): terminal like a
        retire, but named so post-mortems can tell a served request from
        a shed one.  The engine commits this record IMMEDIATELY — a
        crash between a shed and the next step boundary must not
        resurrect the shed request at recover()."""
        self._append({"t": REJECT, "id": int(req.request_id),
                      "reason": req.finish_reason or "?",
                      "retry_after": req.retry_after})

    def record_drain(self, undone: List[int]) -> None:
        self._append({"t": DRAIN, "id": -1, "undone": [int(x) for x in undone]})

    @property
    def dirty(self) -> bool:
        return self._pending > 0

    def commit(self) -> None:
        """Make every appended record durable (flush + fsync).  Site
        ``serving.journal.commit`` injects failures here; any failure is
        a :class:`JournalError` the engine answers with quarantine."""
        if self._fh is None:
            raise JournalError("journal is closed" + (
                f" (quarantined to {self.quarantined})" if self.quarantined else ""))
        if self._pending == 0:
            return
        try:
            faults.check("serving.journal.commit", path=self.path)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except OSError as e:
            raise JournalError(f"journal commit failed: {e}") from e
        self._pending = 0
        self.commits += 1

    def incomplete(self) -> List[Dict[str, Any]]:
        """The replay set from THIS journal's directory (reads the
        segments back — the on-disk truth, not in-memory state)."""
        if self.dirty:
            self.commit()
        return incomplete_requests(self.path)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self.commit()
            finally:
                self._fh.close()
                self._fh = None

    def quarantine(self) -> str:
        """Move the whole journal directory aside (``.corrupt``, counter
        suffixed) and disable this instance — the clean response to a
        failed commit: serving continues, nothing half-durable ever
        replays, the evidence stays on disk."""
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        dest = self.path + QUARANTINE_SUFFIX
        n = 1
        while os.path.exists(dest):
            dest = f"{self.path}{QUARANTINE_SUFFIX}{n}"
            n += 1
        try:
            os.rename(self.path, dest)
        except OSError as e:
            logger.warning(f"serving journal: quarantine rename failed: {e}")
            dest = self.path
        self.quarantined = dest
        logger.warning(f"serving journal: quarantined to {dest}; journaling disabled")
        return dest


__all__ = [
    "RequestJournal", "JournalError", "incomplete_requests", "read_records",
    "client_keys", "SUBMIT", "ADMIT", "FIRST", "RETIRE", "REJECT", "DRAIN",
]
