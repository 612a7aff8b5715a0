"""Host-side prefix index: a radix tree over token ids mapping a new
prompt's longest cached prefix to refcounted read-only page lists (a copy
of ``deepspeed_tpu/serving/kvcache/prefix.py``, numpy only).

The tree is edge-compressed (each edge carries a run of token ids);
entries terminate exactly at nodes, and :meth:`insert` splits edges so
that invariant holds.  Lookup walks the prompt and returns the deepest
entry whose key is a prefix of it — O(prompt_len) regardless of how
many prefixes are cached.  The index is pure host bookkeeping: page
refcounts live in :class:`~deepspeed_tpu_torch.serving.kvcache.pages.PagedKVPool`,
which holds one reference per entry so a cached prefix's pages survive
slot churn until the entry is evicted.

Entries learned from traffic are evictable LRU-style under pool
pressure; entries seeded from ``serving.kvcache.pinned_prefixes`` are
``pinned`` and never evicted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: ``tokens`` (the key) and the device pages
    holding its KV.  ``pages`` covers ``ceil(len(tokens) / page_len)``
    pages; the last page may be partially filled — readers copy-on-write
    it before writing (the COW invariant)."""

    tokens: np.ndarray  # (n,) int32
    pages: List[int]
    pinned: bool = False
    hits: int = 0
    last_used: float = 0.0
    # set only on the tier manager's shadow-index entries: the tier
    # store key holding this prefix's off-device KV (pages is [] there)
    tier_key: str = ""

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])

    def key(self) -> bytes:
        return self.tokens.tobytes()


class _Node:
    __slots__ = ("edge", "children", "entry")

    def __init__(self, edge: Tuple[int, ...] = ()):
        self.edge = edge  # token run from the parent to this node
        self.children: Dict[int, "_Node"] = {}  # first token -> child
        self.entry: Optional[PrefixEntry] = None


def _common_len(a: Tuple[int, ...], b: np.ndarray, off: int) -> int:
    n = min(len(a), b.shape[0] - off)
    i = 0
    while i < n and a[i] == int(b[off + i]):
        i += 1
    return i


class PrefixIndex:
    """Radix tree over int32 token ids with an entry table for O(1)
    exact lookup / removal and LRU eviction scans."""

    def __init__(self):
        self._root = _Node()
        self._entries: Dict[bytes, PrefixEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> Iterable[PrefixEntry]:
        return self._entries.values()

    def get(self, tokens: np.ndarray) -> Optional[PrefixEntry]:
        return self._entries.get(np.asarray(tokens, np.int32).tobytes())

    # -- insert -----------------------------------------------------------
    def insert(self, entry: PrefixEntry) -> PrefixEntry:
        """Insert ``entry`` keyed on its tokens.  If the key is already
        present the existing entry is returned unchanged (first writer
        wins — its pages are already refcounted) and the caller must
        release the duplicate's pages."""
        tokens = np.asarray(entry.tokens, np.int32).reshape(-1)
        if tokens.shape[0] < 1:
            raise ValueError("prefix entry must contain at least one token")
        entry.tokens = tokens
        existing = self._entries.get(entry.key())
        if existing is not None:
            return existing
        node, off = self._root, 0
        while off < tokens.shape[0]:
            first = int(tokens[off])
            child = node.children.get(first)
            if child is None:
                leaf = _Node(tuple(int(t) for t in tokens[off:]))
                node.children[first] = leaf
                node = leaf
                off = tokens.shape[0]
                break
            n = _common_len(child.edge, tokens, off)
            if n == len(child.edge):
                node, off = child, off + n
                continue
            # split child's edge at n: node -> mid -> child
            mid = _Node(child.edge[:n])
            child.edge = child.edge[n:]
            mid.children[child.edge[0]] = child
            node.children[first] = mid
            node, off = mid, off + n
        if off < tokens.shape[0]:  # pragma: no cover - loop always lands
            raise AssertionError("radix insert did not consume the key")
        if node.entry is not None:
            return node.entry
        node.entry = entry
        self._entries[entry.key()] = entry
        return entry

    # -- lookup -----------------------------------------------------------
    def lookup(self, prompt: np.ndarray, now: float = 0.0,
               stamp: bool = True) -> Optional[PrefixEntry]:
        """Deepest entry whose key is a prefix of ``prompt``; stamps
        ``hits``/``last_used`` on the winner unless ``stamp=False``
        (the admission controller's side-effect-free hint path)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        best: Optional[PrefixEntry] = None
        node, off = self._root, 0
        while off < prompt.shape[0]:
            child = node.children.get(int(prompt[off]))
            if child is None:
                break
            n = _common_len(child.edge, prompt, off)
            if n < len(child.edge):
                break  # partial edge match: no entry can end mid-edge
            node, off = child, off + n
            if node.entry is not None:
                best = node.entry
        if best is not None and stamp:
            best.hits += 1
            best.last_used = now
        return best

    def common_prefix_len(self, prompt: np.ndarray) -> int:
        """Longest common prefix between ``prompt`` and ANY stored key —
        deeper than :meth:`lookup`, which only sees runs that terminate
        at an entry.  This is the split point a new prompt shares with
        cached traffic (mid-edge included); the pool learns that run as
        its own entry, which is how a common system prompt becomes
        reusable across requests without being pinned."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        node, off = self._root, 0
        while off < prompt.shape[0]:
            child = node.children.get(int(prompt[off]))
            if child is None:
                break
            n = _common_len(child.edge, prompt, off)
            off += n
            if n < len(child.edge):
                break
            node = child
        return off

    # -- eviction ---------------------------------------------------------
    def remove(self, entry: PrefixEntry) -> bool:
        """Drop an entry (its node stays; edges are not re-merged — the
        tree only ever holds as many nodes as tokens inserted)."""
        found = self._entries.pop(entry.key(), None)
        if found is None:
            return False
        node, off = self._root, 0
        tokens = entry.tokens
        while off < tokens.shape[0]:
            child = node.children.get(int(tokens[off]))
            if child is None:
                return True
            n = _common_len(child.edge, tokens, off)
            if n < len(child.edge):
                return True
            node, off = child, off + n
        node.entry = None
        return True

    def evict_candidates(self) -> List[PrefixEntry]:
        """Unpinned entries, coldest first (LRU by ``last_used``, ties
        broken by fewer hits then shorter keys)."""
        return sorted(
            (e for e in self._entries.values() if not e.pinned),
            key=lambda e: (e.last_used, e.hits, e.length),
        )
