"""Checkpoint-tree operations: staging, commit, quarantine, retention (a
copy of ``deepspeed_tpu/resilience/manager.py``).

Layout of a checkpoint root directory::

    <root>/latest            # atomic pointer file (tag name)
    <root>/<tag>/            # a COMMITTED tag (has manifest.json)
    <root>/<tag>.tmp/        # a staging dir (crashed or in-flight save)
    <root>/<tag>.corrupt*/   # quarantined tags, kept for post-mortem

The commit protocol: everything is written into ``<tag>.tmp``, the
manifest goes in last, then one ``os.rename`` publishes the tag.  A tag
directory without the staging suffix is therefore complete by
construction — a kill at ANY instruction of the save leaves either the
previous tree or the previous tree plus a ``.tmp`` dir, never a
half-written tag.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Iterable, List, Optional, Set, Tuple

from deepspeed_tpu_torch.resilience import atomic, faults
from deepspeed_tpu_torch.utils.logging import logger

LATEST_FILE = "latest"
STAGING_SUFFIX = ".tmp"
QUARANTINE_SUFFIX = ".corrupt"
_STEP_RE = re.compile(r"(\d+)\s*$")

# In-process registry of staging dirs an in-flight save OWNS (sync saves
# between begin_stage and commit/abort; async saves for the lifetime of
# the background commit).  begin_stage refuses to clear an owned dir —
# the "leftover from a crashed save" heuristic must not rmtree a dir a
# live background writer is mid-write into — and retention GC protects
# the tags being (re-)staged.  A real crash clears the registry with the
# process, so crashed leftovers are still reclaimed on the next save.
_ACTIVE_STAGES: Set[str] = set()
_ACTIVE_LOCK = threading.Lock()


class StageInFlightError(RuntimeError):
    """begin_stage was asked for a staging dir an in-flight save owns
    (the caller should drain the pending save first)."""


def stage_path(root: str, tag: str) -> str:
    return os.path.join(os.path.abspath(root), str(tag) + STAGING_SUFFIX)


def release_stage(root: str, tag: str) -> None:
    """Drop ownership of ``<tag>.tmp`` (idempotent; commit/abort call
    this, and an async writer's cleanup calls it after a simulated
    kill so the dead save's leftover behaves like a crash leftover)."""
    with _ACTIVE_LOCK:
        _ACTIVE_STAGES.discard(stage_path(root, tag))


def active_stage_tags(root: str) -> Set[str]:
    """Tags with an owned (in-flight) staging dir under ``root``."""
    root = os.path.abspath(root)
    with _ACTIVE_LOCK:
        owned = set(_ACTIVE_STAGES)
    out = set()
    for path in owned:
        if os.path.dirname(path) == root:
            name = os.path.basename(path)
            out.add(name[: -len(STAGING_SUFFIX)])
    return out


def begin_stage(root: str, tag: str) -> str:
    """Create a fresh staging dir for ``tag`` (clearing any leftover
    from a previous crashed/failed attempt) and take ownership of it.
    Raises :class:`StageInFlightError` if a live save already owns it."""
    path = stage_path(root, tag)
    with _ACTIVE_LOCK:
        if path in _ACTIVE_STAGES:
            raise StageInFlightError(
                f"staging dir {path} is owned by an in-flight save; drain it first"
            )
        _ACTIVE_STAGES.add(path)
    try:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
    except BaseException:
        with _ACTIVE_LOCK:
            _ACTIVE_STAGES.discard(path)
        raise
    return path


def commit_tag(root: str, tag: str) -> str:
    """Atomically publish ``<tag>.tmp`` as ``<tag>``.  Re-saving an
    existing tag replaces it (the old tree is removed first; a kill in
    that window loses only the tag being overwritten, which the save was
    replacing anyway)."""
    root = os.path.abspath(root)
    staged, final = stage_path(root, tag), os.path.join(root, str(tag))
    faults.check("ckpt.commit", path=final)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(staged, final)
    atomic.fsync_dir(root)
    release_stage(root, tag)
    return final


def abort_stage(root: str, tag: str) -> None:
    path = stage_path(root, tag)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    release_stage(root, tag)


def quarantine_tag(root: str, tag: str) -> str:
    """Rename a corrupt tag to ``<tag>.corrupt`` (suffixing a counter if
    a previous quarantine of the same tag exists) so it is never a load
    candidate again but stays on disk for inspection.  Tolerates a tag
    another process already quarantined (returns the existing dest)."""
    root = os.path.abspath(root)
    src = os.path.join(root, str(tag))
    dest = src + QUARANTINE_SUFFIX
    n = 1
    while os.path.exists(dest):
        dest = f"{src}{QUARANTINE_SUFFIX}{n}"
        n += 1
    try:
        os.rename(src, dest)
    except FileNotFoundError:
        # a concurrent quarantine (another rank) won the rename
        return src + QUARANTINE_SUFFIX
    atomic.fsync_dir(root)
    return dest


_TAG_MARKERS = (atomic.MANIFEST_FILE, "meta.json", "state")


def is_tag_dir(path: str) -> bool:
    """Positive signal that a directory is a checkpoint tag: it carries a
    manifest, a meta.json, or a ``state`` tree.  Without this,
    retention GC and the fallback scan would treat ANY user directory
    under the checkpoint root (logs/, tensorboard/, ...) as a tag —
    deletable and restorable."""
    return any(os.path.exists(os.path.join(path, m)) for m in _TAG_MARKERS)


def committed_tags(root: str) -> List[str]:
    """Directories under ``root`` that look like committed tags (staging,
    quarantine and non-checkpoint dirs excluded)."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.endswith(STAGING_SUFFIX) or QUARANTINE_SUFFIX in name:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path) and is_tag_dir(path):
            out.append(name)
    return out


def tag_step(root: str, tag: str) -> Optional[int]:
    """A tag's global step: from ``meta.json`` when present, else parsed
    from a trailing integer in the tag name (``global_step120`` -> 120)."""
    import json

    meta_path = os.path.join(os.path.abspath(root), str(tag), "meta.json")
    try:
        with open(meta_path) as f:
            return int(json.load(f).get("global_step"))
    except (OSError, ValueError, TypeError, KeyError):
        pass
    m = _STEP_RE.search(str(tag))
    return int(m.group(1)) if m else None


def _sort_key(root: str, tag: str) -> Tuple[int, float]:
    step = tag_step(root, tag)
    try:
        mtime = os.path.getmtime(os.path.join(root, tag))
    except OSError:
        mtime = 0.0
    return (step if step is not None else -1, mtime)


def newest_first(root: str) -> List[str]:
    """Committed tags, newest first (by global step, mtime tie-break)."""
    tags = committed_tags(root)
    return sorted(tags, key=lambda t: _sort_key(root, t), reverse=True)


def verify_tag(root: str, tag: str) -> Tuple[bool, List[str]]:
    return atomic.verify_manifest(os.path.join(os.path.abspath(root), str(tag)))


def write_latest(root: str, tag: str) -> None:
    root = os.path.abspath(root)
    faults.check("ckpt.latest", path=os.path.join(root, LATEST_FILE))
    atomic.atomic_write_text(os.path.join(root, LATEST_FILE), str(tag))


def read_latest(root: str) -> Optional[str]:
    path = os.path.join(os.path.abspath(root), LATEST_FILE)
    try:
        with open(path) as f:
            return f.read().strip() or None
    except OSError:
        return None


def retention_gc(
    root: str,
    keep_last_n: int = 0,
    keep_every: int = 0,
    protect: Iterable[str] = (),
) -> List[str]:
    """Delete old committed tags.  ``keep_last_n <= 0`` keeps everything.
    ``keep_every > 0`` additionally pins any tag whose global step is a
    multiple of it (coarse long-horizon history under a tight window).
    Tags in ``protect`` (and the ``latest`` target) are never deleted;
    quarantined/staging dirs are never touched here — ``<tag>.tmp``
    dirs never count toward ``keep_last_n`` and a tag whose staging dir
    an in-flight async save owns is protected, so a background commit
    can never race the sweeper."""
    if keep_last_n <= 0:
        return []
    root = os.path.abspath(root)
    protected = set(str(t) for t in protect)
    protected |= active_stage_tags(root)
    latest = read_latest(root)
    if latest:
        protected.add(latest)
    deleted: List[str] = []
    # newest_first() excludes staging/quarantine names already; the
    # re-check here is deliberate belt-and-braces — a .tmp dir counted
    # toward keep_last_n would silently shrink the durable window
    candidates = [t for t in newest_first(root) if not t.endswith(STAGING_SUFFIX)]
    for i, tag in enumerate(candidates):
        if i < keep_last_n or tag in protected:
            continue
        step = tag_step(root, tag)
        if keep_every > 0 and step is not None and step % keep_every == 0:
            continue
        try:
            shutil.rmtree(os.path.join(root, tag))
            deleted.append(tag)
        except OSError as e:
            logger.warning(f"retention gc: could not delete tag '{tag}': {e}")
    return deleted
