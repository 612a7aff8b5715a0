"""Durable session KV: park a finished turn's pages under its
``session_id`` so turn N+1 rebinds instead of re-prefilling (a copy of
``deepspeed_tpu/serving/kvcache/sessions.py`` on the port's ``atomic``).

Warm sessions stay pinned in the device page pool (pure host
bookkeeping here — the pool holds the refcounts).  Cold sessions
(``session_ttl_seconds`` past their park time) are **spilled** to the
host via the atomic protocol: stage the npz + meta under
``spill_dir/sess_<hash>/``, fsync, write ``manifest.json`` last — so a
crash mid-spill leaves either a verifiable spill or recognisable garbage,
never a half-trusted one.  ``recover()`` re-registers every
manifest-verified spill so a restarted engine rebinds its sessions
exactly like warm ones.

Under tensor parallelism each ``model`` rank holds its heads' pages: the
serving engine gives each rank a ``spill_dir`` of its own (a subdirectory
with its own manifests) and an ``agree`` function, one all-reduce (MIN)
of the verified flag over every rank, so that a spill is restorable only
when every rank's manifest is there and verifies, and all ranks take the
same branch
(one rank restoring while another re-prefills would split their
collectives).

The spill format is the JAX package's: ``kv.npz`` with one array per
cache leaf (``k``/``v``, or ``k.q``/``k.s``/``v.q``/``v.s``), bfloat16
stored as a raw uint16 view and named ``"bfloat16"`` in the meta's
``leaf_dtypes``.  Leaves come in and go out as CPU torch tensors of
their dtypes (numpy has no bfloat16 of its own: a bfloat16 leaf is read
back from its uint16 view).  Migration entries (:func:`write_entry`,
session export and import) and the tier manager's disk entries share the
layout.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.resilience import atomic
from deepspeed_tpu_torch.utils.logging import logger

_META_FILE = "meta.json"
_DATA_FILE = "kv.npz"


def session_dir_name(session_id: str) -> str:
    return "sess_" + hashlib.sha256(session_id.encode("utf-8")).hexdigest()[:16]


def pin_dir_name(tokens: "np.ndarray") -> str:
    """Entry dir for a pinned-prefix migration entry, keyed on the token
    run itself (pins have no session_id)."""
    digest = hashlib.sha256(np.asarray(tokens, np.int32).tobytes()).hexdigest()
    return "sess_pin_" + digest[:16]


def prefix_dir_name(tokens: "np.ndarray") -> str:
    """Entry dir for a tier-demoted (learned) prefix entry — distinct
    from pins so tier recovery can tell them apart by name alone."""
    digest = hashlib.sha256(np.asarray(tokens, np.int32).tobytes()).hexdigest()
    return "sess_pfx_" + digest[:16]


# -- migration wire format --------------------------------------------------
# One directory per entry, identical to the spill layout: kv.npz +
# meta.json staged first, manifest.json written LAST.  An export killed
# mid-write leaves a prefix of manifest-verified entries plus at most
# one unverifiable directory — the importer trusts exactly the verified
# subset, which is what makes kill -9 mid-migration lossless.

def write_entry(dest_dir: str, dir_name: str, meta: Dict,
                leaves: Dict[str, torch.Tensor]) -> str:
    """Write one spill-format entry under ``dest_dir/dir_name`` (data +
    meta fsynced, manifest last).  Idempotent: a stale manifest from a
    prior attempt is invalidated before the data is rewritten, so a
    retried export can overwrite its own partial output safely."""
    target = os.path.join(dest_dir, dir_name)
    os.makedirs(target, exist_ok=True)
    stale = os.path.join(target, atomic.MANIFEST_FILE)
    if os.path.exists(stale):
        os.remove(stale)
    dtypes = _save_leaves(leaves, os.path.join(target, _DATA_FILE))
    meta = dict(meta)
    meta["leaf_dtypes"] = dtypes
    atomic.atomic_write_text(os.path.join(target, _META_FILE), json.dumps(meta))
    atomic.write_manifest(target)
    return target


def read_entry(target: str) -> Optional[Tuple[Dict, Dict[str, torch.Tensor]]]:
    """One manifest-verified entry as ``(meta, leaves)``; None when the
    directory is unverifiable (export killed mid-write) — never trusted,
    never fatal."""
    ok, _ = atomic.verify_manifest(target)
    meta_path = os.path.join(target, _META_FILE)
    if not ok or not os.path.exists(meta_path):
        logger.warning(
            f"kvcache: ignoring unverifiable migration entry at {target}"
        )
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    leaves = _load_leaves(os.path.join(target, _DATA_FILE), meta["leaf_dtypes"])
    return meta, leaves


def read_entries(src_dir: str) -> List[Tuple[Dict, Dict[str, torch.Tensor]]]:
    """Every manifest-verified entry under ``src_dir`` as ``(meta,
    leaves)`` pairs, sorted by directory name."""
    out: List[Tuple[Dict, Dict[str, torch.Tensor]]] = []
    if not os.path.isdir(src_dir):
        return out
    for name in sorted(os.listdir(src_dir)):
        target = os.path.join(src_dir, name)
        if not (name.startswith("sess_") and os.path.isdir(target)):
            continue
        loaded = read_entry(target)
        if loaded is not None:
            out.append(loaded)
    return out


@dataclasses.dataclass
class Session:
    """One warm parked session: the token history whose KV the pages
    hold, and the device pages themselves (refcounts held by the pool
    on this session's behalf)."""

    session_id: str
    tokens: np.ndarray  # (cached_len,) int32 — prompt + generated[:-1]
    pages: List[int]
    parked_at: float = 0.0

    @property
    def cached_len(self) -> int:
        return int(self.tokens.shape[0])


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the dtype name the meta records)."""
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = leaf.numpy()
    return arr, str(arr.dtype)


def _save_leaves(leaves: Dict[str, torch.Tensor], path: str) -> Dict[str, str]:
    """npz-save ``leaves``; bfloat16 goes in as a uint16 view.  Returns
    the key -> original-dtype map for the meta file."""
    dtypes: Dict[str, str] = {}
    packed: Dict[str, np.ndarray] = {}
    for key, leaf in leaves.items():
        packed[key], dtypes[key] = _host_array(leaf)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **packed)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return dtypes


def _load_leaves(path: str, dtypes: Dict[str, str]) -> Dict[str, torch.Tensor]:
    """The stored leaves as CPU tensors of their recorded dtypes (a
    ``"bfloat16"`` leaf back from its uint16 view)."""
    out: Dict[str, torch.Tensor] = {}
    with np.load(path) as z:
        for key, dtype in dtypes.items():
            arr = z[key]
            out[key] = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                        if dtype == "bfloat16" else torch.from_numpy(arr))
    return out


# the tier manager stages its own disk entries (it needs a fault site
# between the staged payload and the manifest), so the leaf codec and
# file names are part of this module's public surface
save_leaves = _save_leaves
load_leaves = _load_leaves
META_FILE = _META_FILE
DATA_FILE = _DATA_FILE


class SessionStore:
    """Warm (in-pool) + spilled (host) session registry.  The store
    never touches device memory itself: the pool passes host leaf dicts
    in for :meth:`spill` and gets them back from :meth:`load`."""

    def __init__(self, spill_dir: Optional[str] = None,
                 ttl_seconds: float = 0.0,
                 agree: Optional[Callable[[bool], bool]] = None):
        self.spill_dir = spill_dir
        self.ttl_seconds = float(ttl_seconds)
        # across ranks: whether every rank's flag is True (a collective)
        self.agree = agree
        self._warm: Dict[str, Session] = {}
        self._spilled: Dict[str, str] = {}  # session_id -> verified dir
        self.parks = 0
        self.spills = 0
        self.restores = 0
        self.drops = 0

    # -- warm path --------------------------------------------------------
    def park(self, sess: Session) -> Optional[Session]:
        """Register a warm session; returns the *displaced* session for
        the same id (whose pages the pool must release), if any."""
        prev = self._warm.pop(sess.session_id, None)
        # a fresh park supersedes any stale spill of the same session
        self._spilled.pop(sess.session_id, None)
        self._warm[sess.session_id] = sess
        self.parks += 1
        return prev

    def peek(self, session_id: str) -> Optional[Session]:
        return self._warm.get(session_id)

    def is_spilled(self, session_id: str) -> bool:
        return session_id in self._spilled

    @property
    def collective(self) -> bool:
        """Whether restores are decided across ranks: every rank then asks
        :meth:`load` for every session it does not hold warm."""
        return self.agree is not None and self.spill_dir is not None

    def pop_warm(self, session_id: str) -> Optional[Session]:
        return self._warm.pop(session_id, None)

    def warm(self) -> List[Session]:
        return list(self._warm.values())

    def expired(self, now: float) -> List[Session]:
        if self.ttl_seconds <= 0:
            return []
        return [
            s for s in self._warm.values()
            if now - s.parked_at > self.ttl_seconds
        ]

    def drop(self, session_id: str) -> Optional[Session]:
        self.drops += 1
        self._spilled.pop(session_id, None)
        return self._warm.pop(session_id, None)

    # -- spill / restore --------------------------------------------------
    def spill(self, sess: Session, leaves: Dict[str, torch.Tensor]) -> str:
        """Atomically persist a session's host-gathered KV leaves.
        Stage data + meta, fsync, manifest LAST — only a directory whose
        manifest verifies is ever trusted by :meth:`recover`."""
        if self.spill_dir is None:
            raise ValueError("session spill requested without a spill_dir")
        target = os.path.join(self.spill_dir, session_dir_name(sess.session_id))
        os.makedirs(target, exist_ok=True)
        stale = os.path.join(target, atomic.MANIFEST_FILE)
        if os.path.exists(stale):
            os.remove(stale)  # re-spill: invalidate before rewriting data
        dtypes = _save_leaves(leaves, os.path.join(target, _DATA_FILE))
        atomic.atomic_write_text(
            os.path.join(target, _META_FILE),
            json.dumps({
                "session_id": sess.session_id,
                "tokens": [int(t) for t in sess.tokens],
                "parked_at": sess.parked_at,
                "leaf_dtypes": dtypes,
            }),
        )
        atomic.write_manifest(target)
        self._warm.pop(sess.session_id, None)
        self._spilled[sess.session_id] = target
        self.spills += 1
        return target

    def load(self, session_id: str) -> Optional[Tuple[Session, Dict[str, torch.Tensor]]]:
        """Read a spilled session back (host leaves; the pool re-pages
        them).  The spill entry is consumed — a later park re-persists.
        With ``agree`` this is a collective: None on every rank unless
        every rank's spill verifies."""
        target = self._spilled.get(session_id)
        if target is None and self.agree is None:
            return None
        ok, notes = (False, ["no spill on this rank"]) if target is None else \
            atomic.verify_manifest(target)
        if self.agree is not None and ok and not os.path.exists(
                os.path.join(target, atomic.MANIFEST_FILE)):
            # across ranks a rank's manifest must be there: one rank's
            # crash mid-spill leaves its pages unverifiable
            ok, notes = False, ["no manifest on this rank"]
        every = ok if self.agree is None else self.agree(ok)
        if not every:
            if target is not None:
                why = "; ".join(notes) if not ok else "another rank's spill failed verification"
                logger.warning(
                    f"kvcache: spilled session {session_id!r} failed manifest "
                    f"verification ({why}); dropping it"
                )
            self._spilled.pop(session_id, None)
            return None
        with open(os.path.join(target, _META_FILE)) as f:
            meta = json.load(f)
        leaves = _load_leaves(os.path.join(target, _DATA_FILE), meta["leaf_dtypes"])
        sess = Session(
            session_id=meta["session_id"],
            tokens=np.asarray(meta["tokens"], np.int32),
            pages=[],
            parked_at=float(meta.get("parked_at", 0.0)),
        )
        self._spilled.pop(session_id, None)
        self.restores += 1
        return sess, leaves

    def spilled_ids(self) -> List[str]:
        return sorted(self._spilled)

    def spilled_dir(self, session_id: str) -> Optional[str]:
        """The registered spill directory for ``session_id`` (export
        reads it directly — unlike :meth:`load`, nothing is consumed)."""
        return self._spilled.get(session_id)

    def adopt_spill(self, session_id: str, meta: Dict,
                    leaves: Dict[str, torch.Tensor]) -> Optional[str]:
        """Persist an imported (migrated) session straight into this
        store's own ``spill_dir`` and register it — the landing path for
        migrated sessions when the pool has no free pages.  Returns None
        (entry dropped) without a spill_dir."""
        if self.spill_dir is None:
            return None
        meta = {k: v for k, v in meta.items() if k != "leaf_dtypes"}
        meta["session_id"] = session_id
        target = write_entry(self.spill_dir, session_dir_name(session_id),
                             meta, leaves)
        self._warm.pop(session_id, None)
        self._spilled[session_id] = target
        self.spills += 1
        return target

    def has(self, session_id: str) -> bool:
        return session_id in self._warm or session_id in self._spilled

    # -- crash recovery ---------------------------------------------------
    def recover(self) -> List[str]:
        """Scan ``spill_dir`` and re-register every manifest-verified
        session spill.  Unverifiable directories (crash mid-spill before
        the manifest rename) are left on disk but never trusted."""
        if self.spill_dir is None or not os.path.isdir(self.spill_dir):
            return []
        found: List[str] = []
        for name in sorted(os.listdir(self.spill_dir)):
            target = os.path.join(self.spill_dir, name)
            if not (name.startswith("sess_") and os.path.isdir(target)):
                continue
            ok, _ = atomic.verify_manifest(target)
            meta_path = os.path.join(target, _META_FILE)
            if not ok or not os.path.exists(meta_path):
                logger.warning(
                    f"kvcache: ignoring unverifiable session spill at {target}"
                )
                continue
            with open(meta_path) as f:
                sid = json.load(f)["session_id"]
            self._spilled[sid] = target
            found.append(sid)
        return found

    def stats(self) -> Dict[str, int]:
        return {
            "warm": len(self._warm),
            "spilled": len(self._spilled),
            "parks": self.parks,
            "spills": self.spills,
            "restores": self.restores,
            "drops": self.drops,
        }
