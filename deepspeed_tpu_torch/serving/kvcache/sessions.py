"""Durable session KV: park a finished turn's pages under its
``session_id`` so turn N+1 rebinds instead of re-prefilling (a copy of
``deepspeed_tpu/serving/kvcache/sessions.py`` on the port's ``atomic``;
the fleet's migration wire format is not ported).

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
``leaf_dtypes``.  Leaves come in as torch tensors;
:meth:`SessionStore.load` returns numpy arrays as stored — a bfloat16
leaf stays its uint16 view, which the pool turns back into bfloat16 at
the device scatter (numpy has no bfloat16 of its own).
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


def _load_leaves(path: str, dtypes: Dict[str, str]) -> Dict[str, np.ndarray]:
    """The stored arrays; a ``"bfloat16"`` leaf stays its uint16 view."""
    with np.load(path) as z:
        return {key: z[key] for key in dtypes}


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

    def load(self, session_id: str) -> Optional[Tuple[Session, Dict[str, np.ndarray]]]:
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
