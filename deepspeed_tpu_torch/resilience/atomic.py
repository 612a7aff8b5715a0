"""Durable file primitives: atomic writes and checkpoint manifests (a copy
of ``deepspeed_tpu/resilience/atomic.py``).

A checkpoint tag must either exist completely or not at all.  The two
building blocks here are:

* :func:`atomic_write_text` — the only sanctioned way to write small
  checkpoint metadata (``latest``, ``meta.json``, ``manifest.json``):
  write to ``<path>.tmp``, fsync, ``os.replace``, fsync the directory.
  A crash at any point leaves either the old file or the new file,
  never a torn one.
* :func:`write_manifest` / :func:`verify_manifest` — a per-tag
  ``manifest.json`` recording every file's size and checksum, written
  LAST (so its presence certifies the tag is complete) and re-checked
  on load before any state is restored.
"""
from __future__ import annotations

import hashlib
import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.resilience import faults

MANIFEST_FILE = "manifest.json"
MANIFEST_VERSION = 1
CHECKSUM_ALGORITHMS = ("sha256", "crc32", "none")
_CHUNK = 1 << 20


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable (no-op on
    platforms whose dirfd open fails, e.g. Windows)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically: tmp file + fsync +
    ``os.replace`` + directory fsync."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    faults.check("atomic.replace", path=path)
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def file_digest(path: str, algorithm: str = "sha256") -> str:
    """Streamed checksum of one file (``sha256``, ``crc32`` or ``none``)."""
    if algorithm == "none":
        return ""
    if algorithm == "crc32":
        crc = 0
        with open(path, "rb") as f:
            while chunk := f.read(_CHUNK):
                crc = zlib.crc32(chunk, crc)
        return f"{crc & 0xFFFFFFFF:08x}"
    if algorithm == "sha256":
        h = hashlib.sha256()
        with open(path, "rb") as f:
            while chunk := f.read(_CHUNK):
                h.update(chunk)
        return h.hexdigest()
    raise ValueError(f"unknown checksum algorithm {algorithm!r} (expected one of {CHECKSUM_ALGORITHMS})")


def _walk_files(root: str) -> List[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def write_manifest(tag_dir: str, algorithm: str = "sha256", extra: Optional[dict] = None) -> dict:
    """Record size + checksum for every file under ``tag_dir`` and write
    ``manifest.json`` (atomically) as the tag's completion marker."""
    tag_dir = os.path.abspath(tag_dir)
    files: Dict[str, dict] = {}
    for rel in _walk_files(tag_dir):
        if rel == MANIFEST_FILE or rel.endswith(".tmp"):
            continue
        full = os.path.join(tag_dir, rel)
        files[rel] = {"size": os.path.getsize(full), "digest": file_digest(full, algorithm)}
    manifest = {"version": MANIFEST_VERSION, "algorithm": algorithm, "files": files}
    if extra:
        manifest.update(extra)
    # fsync the data files before the manifest certifies them
    for rel in files:
        try:
            fd = os.open(os.path.join(tag_dir, rel), os.O_RDONLY)
        except OSError:
            continue
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    atomic_write_text(os.path.join(tag_dir, MANIFEST_FILE), json.dumps(manifest, indent=2))
    return manifest


def verify_manifest(tag_dir: str) -> Tuple[bool, List[str]]:
    """Check every manifest entry (existence, size, checksum).  Returns
    ``(ok, notes)``.  A tag with NO manifest is a legacy (pre-resilience)
    tag: accepted with a note rather than quarantined, so old checkpoint
    trees keep loading."""
    tag_dir = os.path.abspath(tag_dir)
    mpath = os.path.join(tag_dir, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return True, ["no manifest (legacy tag); integrity not verified"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, [f"unreadable manifest: {e}"]
    algorithm = manifest.get("algorithm", "sha256")
    errors: List[str] = []
    for rel, entry in manifest.get("files", {}).items():
        full = os.path.join(tag_dir, rel)
        if not os.path.exists(full):
            errors.append(f"missing file '{rel}'")
            continue
        size = os.path.getsize(full)
        if size != entry.get("size"):
            errors.append(f"size mismatch '{rel}' ({size} != {entry.get('size')})")
            continue
        if algorithm != "none" and file_digest(full, algorithm) != entry.get("digest"):
            errors.append(f"checksum mismatch '{rel}'")
    return (not errors), errors
