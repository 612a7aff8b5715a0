"""Paged KV pool: a fixed-shape device page pool + host-side page
allocator, prefix index, and session store (counterpart of
``deepspeed_tpu/serving/kvcache/pages.py``; the allocator logic is the
JAX package's, line for line).

Layout: ONE pair of ``(layers, num_pages, heads, page_len, head_dim)``
cache tensors (bf16/f32, or the int8 code+scale pair) whose **page axis
replaces the slot axis** of :class:`~deepspeed_tpu_torch.serving.pool.SlotKVPool`.
Every logical slot is a row of ``pages_per_slot = max_len // page_len``
page ids (``self._tables``) that the serving steps hand to the paged
attention as an int32 tensor, so admitting, retiring, sharing or
remapping pages never changes a step's shapes.  The serving steps write
the page tensors in place.

**Page 0 is the reserved garbage page**: unused table entries point at
it, and the decode step's per-slot ``write_mask`` redirects the writes
of non-decoding slots there.  Reads of page 0 are always behind the
position mask; writes to it are by definition discardable.  This is the
paged analogue of the slot pool's overwrite-before-attend invariant.

Sharing is refcounted: the prefix index holds one reference per cached
prefix, each slot holds one per mapped page, and a parked session holds
one per kept page.  A page returns to the free list only at refcount
zero.  A slot may write a page only while it is the sole holder — a
partially-filled shared tail page is **copied-on-write** into a private
page (the copy lands before the slot's first prefill chunk writes;
``src == dst == 0`` is the identity).

Two optional attachments: a
:class:`~deepspeed_tpu_torch.serving.kvcache.tiers.PageTierManager`
(:meth:`PagedKVPool.attach_tiers`) takes over session spill/drop and
cold prefix demotion, device → pinned host → disk; a
:class:`~deepspeed_tpu_torch.serving.frontdoor.tenants.TenantRegistry`
(:meth:`PagedKVPool.attach_tenants`) caps each tenant's fresh pages and
pinned prefixes.  :meth:`PagedKVPool.export_sessions` /
:meth:`PagedKVPool.import_sessions` move parked sessions and pins between
pools in the spill format.
"""
from __future__ import annotations

import functools
import os
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.transformer.inference import init_kv_cache
from deepspeed_tpu_torch.serving.frontdoor.tenants import DEFAULT_TENANT
from deepspeed_tpu_torch.serving.kvcache.prefix import PrefixEntry, PrefixIndex
from deepspeed_tpu_torch.serving.kvcache.sessions import (
    Session,
    SessionStore,
    pin_dir_name,
    read_entries,
    read_entry,
    session_dir_name,
    write_entry,
)
from deepspeed_tpu_torch.serving.pool import SlotPoolError
from deepspeed_tpu_torch.utils.logging import logger

GARBAGE_PAGE = 0


def _pages_for(tokens: int, page_len: int) -> int:
    return -(-int(tokens) // int(page_len))


def _spill_leaves(tree, prefix: str) -> Dict[str, torch.Tensor]:
    """``{"k": t}`` or ``{"k.q": codes, "k.s": scales}`` — the spill keys."""
    if isinstance(tree, dict):
        return {f"{prefix}.{name}": buf for name, buf in tree.items()}
    return {prefix: tree}


def _locked(fn):
    """Run the method under the pool's re-entrant lock.  The allocator
    state (refcounts, free lists, tables, prefix index, sessions) is one
    invariant-coupled unit, and a context switch between a decref and
    its free-list append double-frees pages.  RLock because the surface
    nests (``free`` -> ``retire``)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return wrapper


class PagedKVPool:
    """Fixed-shape device page pool + host-side allocator with
    shared-prefix dedup, copy-on-write, and durable sessions.

    Duck-compatible with :class:`SlotKVPool` where the scheduler and
    engine touch it (``free_slots`` / ``alloc`` / ``free`` / ``swap`` /
    ``cache_bytes`` / ``shape_math``); the paged extras
    (:meth:`alloc_request`, :meth:`retire`, :meth:`learn_prefix`,
    :meth:`consume_cow`, :meth:`table`) are discovered by ``getattr``
    so the slot pool keeps working unchanged.
    """

    def __init__(self, n_layer: int, num_slots: int, heads: int, max_len: int,
                 head_dim: int, kv_dtype: Any, page_len: int = 128,
                 num_pages: Optional[int] = None, device: Any = "cpu",
                 prefill_chunk: int = 1,
                 pinned_prefixes: Sequence[Sequence[int]] = (),
                 session_ttl_seconds: float = 0.0,
                 spill_dir: Optional[str] = None,
                 agree=None):
        if num_slots < 1:
            raise SlotPoolError(f"num_slots must be >= 1, got {num_slots}")
        if page_len < 1:
            raise SlotPoolError(f"page_len must be >= 1, got {page_len}")
        if max_len < 1 or max_len % page_len != 0:
            raise SlotPoolError(
                f"max_len must be a positive multiple of page_len, got "
                f"max_len={max_len} page_len={page_len}"
            )
        self.n_layer = int(n_layer)
        self.num_slots = int(num_slots)
        self.heads = int(heads)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.kv_dtype = kv_dtype
        self.page_len = int(page_len)
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.pages_per_slot = self.max_len // self.page_len
        full = self.num_slots * self.pages_per_slot
        # default: every slot fully mappable plus an equal share of
        # pages for the prefix index and parked sessions, + garbage page
        self.num_pages = int(num_pages) if num_pages else 1 + 2 * full
        if self.num_pages < 1 + self.pages_per_slot:
            raise SlotPoolError(
                f"num_pages={self.num_pages} cannot map even one slot "
                f"({self.pages_per_slot} pages + the reserved garbage page)"
            )
        if self.num_pages < 1 + full:
            logger.warning(
                f"kvcache: num_pages={self.num_pages} < 1 + "
                f"{self.num_slots} slots x {self.pages_per_slot} pages — "
                f"a full pool of cache misses will wait on page churn"
            )
        self.k, self.v = init_kv_cache(
            n_layer, self.num_pages, heads, self.page_len, head_dim, kv_dtype, device=device
        )
        self.on_cuda = torch.device(device).type == "cuda"
        # host-side allocator state (every public touch goes through
        # @_locked — see the decorator's docstring)
        self._lock = threading.RLock()
        self._free_pages: Deque[int] = deque(range(1, self.num_pages))
        self._ref = np.zeros((self.num_pages,), np.int64)
        self._ref[GARBAGE_PAGE] = 1  # permanently held
        self._free_slots: Deque[int] = deque(range(self.num_slots))
        self._owner: Dict[int, Any] = {}  # slot -> request id
        self._tables = np.zeros((self.num_slots, self.pages_per_slot), np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        self._pending_cow: Dict[int, Tuple[int, int]] = {}
        self.index = PrefixIndex()
        self.sessions = SessionStore(spill_dir=spill_dir,
                                     ttl_seconds=session_ttl_seconds, agree=agree)
        # optional hierarchical tiering (attach_tiers); when armed,
        # session spill/drop and cold prefix eviction route through the
        # PageTierManager instead of dying or hitting spill_dir directly
        self.tiers: Optional[Any] = None
        self._pinned_specs: List[np.ndarray] = [
            np.asarray(list(spec), np.int32) for spec in pinned_prefixes
            if len(list(spec)) >= 1
        ]
        # counters (stats() reads these)
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.tokens_saved = 0
        self.cow_copies = 0
        self.evictions = 0
        self.session_rebinds = 0
        self.alloc_waits = 0  # alloc_request returned None for lack of pages
        # per-tenant quota enforcement, armed via attach_tenants().
        # Charges follow the live slot — fresh pages claimed for a
        # tenant's request count against its kv_pages_max until the slot
        # retires; pinned-prefix inserts count against
        # pinned_prefixes_max (over-quota pins degrade to unpinned
        # entries, which pressure reclaim may evict).
        self.tenants: Optional[Any] = None
        self._tenant_pages: Dict[str, int] = {}
        self._slot_tenant: Dict[int, Tuple[str, int]] = {}
        self._tenant_pinned: Dict[str, int] = {}
        self.tenant_quota_defers = 0
        self.tenant_pin_rejects = 0

    # -- refcounting ------------------------------------------------------
    def _page_incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._ref[p] += 1

    def _page_decref(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p == GARBAGE_PAGE:
                raise SlotPoolError("refcount underflow on the garbage page")
            self._ref[p] -= 1
            if self._ref[p] < 0:
                raise SlotPoolError(f"page {p} refcount underflow")
            if self._ref[p] == 0:
                self._free_pages.append(p)

    def _take_pages(self, n: int, now: float = 0.0) -> Optional[List[int]]:
        """Claim ``n`` fresh pages at refcount 1, reclaiming cold state
        under pressure; None when the pool genuinely cannot satisfy."""
        if n == 0:
            return []
        if len(self._free_pages) < n:
            self._reclaim(n, now)
        if len(self._free_pages) < n:
            return None
        out = [self._free_pages.popleft() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def _reclaim(self, need: int, now: float) -> None:
        """Free pages by retiring cold state, cheapest first: expired
        sessions (spill keeps them recoverable), then unpinned prefix
        entries coldest-first.  Pages still mapped by live slots are
        never touched — decref only returns sole-holder pages."""
        for sess in self.sessions.expired(now):
            self._spill_or_drop(sess)
            if len(self._free_pages) >= need:
                return
        for entry in self.index.evict_candidates():
            if len(self._free_pages) >= need:
                return
            self.index.remove(entry)
            self._page_decref(entry.pages)
            self.evictions += 1
        if len(self._free_pages) < need:
            for sess in sorted(self.sessions.warm(), key=lambda s: s.parked_at):
                if len(self._free_pages) >= need:
                    return
                self._spill_or_drop(sess)

    # -- SlotKVPool-compatible surface ------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def live_slots(self) -> int:
        return self.num_slots - len(self._free_slots)

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_live(self) -> int:
        return self.num_pages - 1 - len(self._free_pages)

    def owner(self, slot: int) -> Optional[Any]:
        return self._owner.get(slot)

    def owners(self) -> Dict[int, Any]:
        return dict(self._owner)

    @_locked
    def alloc(self, request_id: Any) -> Optional[int]:
        """Plain slot claim (no request context): a fully-mapped slot
        with fresh private pages and no prefix/session reuse."""
        if request_id in self._owner.values():
            raise SlotPoolError(
                f"request {request_id!r} already owns a slot"
            )
        if not self._free_slots:
            return None
        pages = self._take_pages(self.pages_per_slot)
        if pages is None:
            self.alloc_waits += 1
            return None
        slot = self._free_slots.popleft()
        self._owner[slot] = request_id
        self._bind(slot, pages, cow=None)
        return slot

    @_locked
    def free(self, slot: int) -> None:
        self.retire(slot, None)

    def swap(self, k, v) -> None:
        self.k, self.v = k, v

    def cache_bytes(self) -> int:
        bufs = list(_spill_leaves(self.k, "k").values()) + list(_spill_leaves(self.v, "v").values())
        return int(sum(t.numel() * t.element_size() for t in bufs))

    def shape_math(self) -> str:
        kind = "int8+f32 scales" if isinstance(self.k, dict) else str(self.k.dtype)
        return (
            f"2 x ({self.n_layer} layers x {self.num_pages} pages x "
            f"{self.heads} heads x {self.page_len} page_len x "
            f"{self.head_dim} head_dim) [{kind}] = "
            f"{self.cache_bytes() / 1e6:.1f} MB "
            f"({self.num_slots} slots x {self.pages_per_slot} pages/slot)"
        )

    # -- paged allocation -------------------------------------------------
    def _aligned_hit(self, cached: int, prompt_len: int) -> int:
        """Usable prefix hit: capped at ``prompt_len - 1`` (at least one
        chunk must run to produce the first-token logits) and rounded
        down to a prefill-chunk multiple (prefill restarts exactly on a
        chunk boundary, so the chunked numerics — and the admission
        TTFT math — stay identical to the cold path)."""
        hit = min(int(cached), int(prompt_len) - 1)
        hit -= hit % self.prefill_chunk
        return max(hit, 0)

    def _match_session(self, session_id: str, prompt: np.ndarray,
                       now: float) -> Optional[Session]:
        sess = self.sessions.peek(session_id)
        if sess is None and (self.sessions.is_spilled(session_id) or self.sessions.collective):
            sess = self._restore_session(session_id, now)
        if sess is None and self.tiers is not None:
            sess = self.tiers.promote_session(session_id, now)
        if sess is None:
            return None
        cl = sess.cached_len
        if cl > prompt.shape[0] or not np.array_equal(sess.tokens, prompt[:cl]):
            return None  # divergent history: leave parked for the TTL sweep
        if self.tiers is not None and not self.tiers.promote_tail(sess, now):
            # the tier-held tail cannot be paged back in: give the
            # session up and re-prefill (rebind is only an optimisation)
            self.tiers.drop_session(sess)
            return None
        return sess

    @_locked
    def alloc_request(self, req: Any, now: float = 0.0) -> Optional[int]:
        """Hit-aware slot claim.  Resolves the request's longest cached
        prefix (session rebind first — it covers prior turns' generation
        — then the prefix index), maps reused pages read-only with a COW
        pair for a partial shared tail, claims fresh pages for the rest,
        and sets ``req.prefill_pos`` / ``req.prefix_hint`` so chunked
        prefill starts at the first uncached chunk boundary.  None when
        out of slots *or* pages (the request waits queued)."""
        if not self._free_slots:
            return None
        rid = req.request_id
        if rid in self._owner.values():
            raise SlotPoolError(f"request {rid!r} already owns a slot")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        self.lookups += 1
        sid = getattr(req, "session_id", None)
        source, sess, entry, hit = None, None, None, 0
        if sid is not None:
            sess = self._match_session(sid, prompt, now)
            if sess is not None:
                hit = self._aligned_hit(sess.cached_len, plen)
                source = "session" if hit > 0 else None
        if source is None:
            entry = self.index.lookup(prompt, now=now)
            if self.tiers is not None:
                best = entry.length if entry is not None else 0
                if self.tiers.promote_prefix_for(prompt, now, min_len=best):
                    entry = self.index.lookup(prompt, now=now) or entry
            if entry is not None:
                hit = self._aligned_hit(entry.length, plen)
                source = "prefix" if hit > 0 else None
        if source is None:
            hit = 0
        src_pages = (sess.pages if source == "session"
                     else entry.pages if source == "prefix" else [])
        n_cover = _pages_for(hit, self.page_len) if hit else 0
        reuse = list(src_pages[:n_cover])
        tail_partial = hit % self.page_len != 0 and bool(reuse)
        # the slot may write the tail page only as its sole holder;
        # after the transfer below its refcount is current + 1 (slot)
        # - 1 (a consumed session's hold)
        need_cow = tail_partial and (
            int(self._ref[reuse[-1]]) + 1 - (1 if source == "session" else 0) > 1
        )
        total = min(plen + int(req.max_new_tokens), self.max_len)
        need = max(_pages_for(total, self.page_len), n_cover)
        # per-tenant page quota: fresh (privately-charged) pages for
        # this slot must fit under the tenant's cap — reused shared
        # pages are free (they are not attributable to one tenant).
        # Over quota the request WAITS (None), exactly like page
        # starvation: the tenant's own retirements free its budget, and
        # other tenants are unaffected — which is the point.
        tenant_key = None
        if self.tenants is not None:
            tenant = getattr(req, "tenant", None)
            tenant_key = tenant or DEFAULT_TENANT
            cap = self.tenants.kv_pages_max(tenant)
            n_fresh = need - n_cover + (1 if need_cow else 0)
            if cap > 0 and self._tenant_pages.get(tenant_key, 0) + n_fresh > cap:
                self.tenant_quota_defers += 1
                self.tenants.note_quota_defer(tenant)
                return None
        # the slot takes its reference on every reused page BEFORE
        # claiming fresh ones: _take_pages may reclaim under pressure,
        # and reclaim is allowed to spill/demote the very session (or
        # evict the very prefix entry) this rebind is consuming — the
        # early incref keeps the reused pages (and their KV) live
        # through that
        self._page_incref(reuse)
        fresh = self._take_pages(need - n_cover + (1 if need_cow else 0), now)
        if fresh is None:
            self._page_decref(reuse)
            self.alloc_waits += 1
            return None
        if source == "session":
            # a consumed session releases all of its holds (tail pages
            # beyond the cover free here unless shared); when reclaim
            # spilled it mid-_take_pages its holds are already released
            # and the spilled copy goes stale — harmless, a later park
            # for the sid supersedes it
            consumed = self.sessions.pop_warm(sid)
            if consumed is not None:
                self._page_decref(consumed.pages)
            self.session_rebinds += 1
        mapping = list(reuse)
        cow: Optional[Tuple[int, int]] = None
        if need_cow:
            cow = (mapping[-1], fresh[0])
            self._page_decref([mapping[-1]])  # slot abandons src for dst
            mapping[-1] = fresh[0]
            mapping.extend(fresh[1:])
            self.cow_copies += 1
        else:
            mapping.extend(fresh)
        slot = self._free_slots.popleft()
        self._owner[slot] = rid
        self._bind(slot, mapping, cow)
        if tenant_key is not None:
            self._tenant_pages[tenant_key] = self._tenant_pages.get(tenant_key, 0) + len(fresh)
            self._slot_tenant[slot] = (tenant_key, len(fresh))
        req.prefill_pos = hit
        req.prefix_hint = hit
        if hit > 0:
            self.hits += 1
            self.tokens_saved += hit
        else:
            self.misses += 1
        return slot

    def _bind(self, slot: int, pages: List[int],
              cow: Optional[Tuple[int, int]]) -> None:
        row = np.zeros((self.pages_per_slot,), np.int32)
        row[: len(pages)] = pages
        self._tables[slot] = row
        self._slot_pages[slot] = pages
        if cow is not None:
            self._pending_cow[slot] = cow

    @_locked
    def consume_cow(self, slot: int) -> Tuple[int, int]:
        """The slot's pending copy-on-write pair, consumed — the engine
        copies it before the slot's FIRST prefill chunk writes.  ``(0,
        0)`` (garbage page onto itself) is the identity when nothing is
        pending."""
        return self._pending_cow.pop(slot, (GARBAGE_PAGE, GARBAGE_PAGE))

    @_locked
    def table(self, slot: int) -> np.ndarray:
        return self._tables[slot].copy()

    @_locked
    def tables(self) -> np.ndarray:
        return self._tables.copy()

    # -- prefix learning --------------------------------------------------
    @_locked
    def learn_prefix(self, req: Any, now: float = 0.0) -> None:
        """Called once per request when its final prefill chunk has
        landed: the slot's pages now hold KV for the whole prompt, so
        the prompt becomes a cached prefix (and any configured pinned
        spec it extends is seeded, pinned).  The index takes its own
        reference on every covered page; the live owner keeps appending
        to the shared tail page — safe, because it only ever writes
        positions >= the entry length, and readers COW first."""
        pages = self._slot_pages.get(req.slot)
        if pages is None:
            return
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        # the run this prompt shares with previously-learned traffic
        # (computed BEFORE inserting the prompt itself): learned as its
        # own entry so a common system prompt becomes a reusable prefix
        # even though no single full prompt is a prefix of another
        split = self.index.common_prefix_len(prompt)
        for spec in self._pinned_specs:
            L = int(spec.shape[0])
            if L <= prompt.shape[0] and np.array_equal(prompt[:L], spec):
                self._insert_entry(spec.copy(), pages, pinned=True, now=now,
                                   tenant=getattr(req, "tenant", None))
        if self.prefill_chunk <= split < prompt.shape[0]:
            self._insert_entry(prompt[:split].copy(), pages, pinned=False, now=now)
        self._insert_entry(prompt.copy(), pages, pinned=False, now=now)

    def _insert_entry(self, tokens: np.ndarray, pages: List[int],
                      pinned: bool, now: float,
                      tenant: Optional[str] = None) -> None:
        key = tenant or DEFAULT_TENANT
        if pinned and self.tenants is not None:
            # per-tenant pinned-prefix quota: an over-quota pin degrades
            # to a plain (evictable) entry instead of pinning — the
            # tenant keeps the cache benefit but cannot exempt unbounded
            # pages from pressure reclaim
            cap = self.tenants.pinned_prefixes_max(tenant)
            if cap > 0 and self._tenant_pinned.get(key, 0) >= cap:
                self.tenant_pin_rejects += 1
                pinned = False
        cover = pages[: _pages_for(tokens.shape[0], self.page_len)]
        entry = PrefixEntry(tokens=tokens, pages=list(cover), pinned=pinned,
                            last_used=now)
        inserted = self.index.insert(entry)
        newly_pinned = False
        if inserted is entry:
            self._page_incref(cover)
            newly_pinned = pinned
        elif pinned and not inserted.pinned:
            inserted.pinned = True  # a learned entry graduates to pinned
            newly_pinned = True
        if newly_pinned and self.tenants is not None:
            self._tenant_pinned[key] = self._tenant_pinned.get(key, 0) + 1

    @_locked
    def prefix_hint_tokens(self, prompt: np.ndarray,
                           session_id: Optional[str] = None) -> int:
        """Expected hit for a prompt *without* touching any state — the
        admission controller prices queued work with this so TTFT
        estimates use the post-hit budget."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 2:
            return 0
        if session_id is not None:
            sess = self.sessions.peek(session_id)
            if (sess is not None and sess.cached_len <= plen
                    and np.array_equal(sess.tokens, prompt[: sess.cached_len])):
                return self._aligned_hit(sess.cached_len, plen)
            if self.tiers is not None:
                cl, _tier = self.tiers.session_hint(prompt, session_id)
                if cl:
                    # a tiered session promotes on demand at alloc, so
                    # the expected hit is as real as a warm one
                    return self._aligned_hit(cl, plen)
        entry = self.index.lookup(prompt, stamp=False)
        best = self._aligned_hit(entry.length, plen) if entry is not None else 0
        if self.tiers is not None:
            tl, _tier = self.tiers.prefix_hint(prompt)
            if tl:
                best = max(best, self._aligned_hit(tl, plen))
        return best

    # residency-discount weights for affinity pricing: reused tokens are
    # worth less when promoting them first costs a host scatter (T1) or a
    # disk read + scatter (T2)
    _TIER_WEIGHTS = {"": 1.0, "host": 0.75, "disk": 0.5}

    @_locked
    def affinity_tokens(self, prompt: np.ndarray,
                        session_id: Optional[str] = None) -> float:
        """Tier-aware :meth:`prefix_hint_tokens` for routing: cached
        tokens discounted by residency (T0 full, T1 3/4, T2 1/2) so a
        session parked in host memory still beats a cold replica but
        loses to a replica holding it on the device."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 2:
            return 0.0
        best = 0.0
        if session_id is not None:
            sess = self.sessions.peek(session_id)
            if (sess is not None and sess.cached_len <= plen
                    and np.array_equal(sess.tokens, prompt[: sess.cached_len])):
                best = float(self._aligned_hit(sess.cached_len, plen))
            elif self.tiers is not None:
                cl, tier = self.tiers.session_hint(prompt, session_id)
                if cl:
                    best = (self._aligned_hit(cl, plen)
                            * self._TIER_WEIGHTS.get(tier, 0.5))
        entry = self.index.lookup(prompt, stamp=False)
        if entry is not None:
            best = max(best, float(self._aligned_hit(entry.length, plen)))
        if self.tiers is not None:
            tl, tier = self.tiers.prefix_hint(prompt)
            if tl:
                best = max(best, self._aligned_hit(tl, plen)
                           * self._TIER_WEIGHTS.get(tier, 0.5))
        return best

    # -- retirement / sessions --------------------------------------------
    @_locked
    def retire(self, slot: int, req: Any = None, now: float = 0.0) -> None:
        """Return a slot.  A finished request with a ``session_id``
        parks the pages holding its turn (prompt + generated[:-1] — the
        last token was never fed, so it has no KV) under the session;
        everything else is dereferenced, freeing sole-holder pages."""
        if slot not in self._owner:
            raise SlotPoolError(f"slot {slot} is not allocated")
        del self._owner[slot]
        charged = self._slot_tenant.pop(slot, None)
        if charged is not None:
            key, n_charged = charged
            left = self._tenant_pages.get(key, 0) - n_charged
            if left > 0:
                self._tenant_pages[key] = left
            else:
                self._tenant_pages.pop(key, None)
        pages = self._slot_pages.pop(slot, [])
        self._pending_cow.pop(slot, None)
        self._tables[slot] = GARBAGE_PAGE
        self._free_slots.append(slot)
        sid = getattr(req, "session_id", None) if req is not None else None
        parked = False
        if sid is not None and getattr(req, "finish_reason", None) in ("eos", "length"):
            gen = list(getattr(req, "generated", []) or [])
            tokens = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(gen[:-1], np.int32)]
            )
            if tokens.shape[0] > 0:
                n_keep = _pages_for(tokens.shape[0], self.page_len)
                kept, dropped = pages[:n_keep], pages[n_keep:]
                prev = self.sessions.park(Session(
                    session_id=sid, tokens=tokens, pages=kept, parked_at=now,
                ))
                if prev is not None:
                    self._page_decref(prev.pages)
                if self.tiers is not None:
                    # a fresh park supersedes any tiered copy (mirror of
                    # park() clearing a stale spill)
                    self.tiers.discard_session(sid)
                self._page_decref(dropped)
                parked = True
        if not parked:
            self._page_decref(pages)

    def _gather_pinned(self, pages: Sequence[int]) -> Tuple[Dict[str, torch.Tensor], Any]:
        """The pages' rows of every cache leaf, copied to the host: one
        ``index_select`` per leaf, ``(layers, len(pages), heads, page_len,
        x)`` tensors keyed as the spill format keys them.  On a CUDA pool
        the copies go ``non_blocking`` into pinned host tensors and the
        second value is the CUDA event recorded after them: the host
        reads them only after it completes.  None on the CPU."""
        ids = torch.as_tensor(list(pages), dtype=torch.int64, device=self.k_device)
        out: Dict[str, torch.Tensor] = {}
        for prefix, tree in (("k", self.k), ("v", self.v)):
            for key, buf in _spill_leaves(tree, prefix).items():
                rows = buf.index_select(1, ids)
                if self.on_cuda:
                    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                    host.copy_(rows, non_blocking=True)
                    rows = host
                out[key] = rows
        if not self.on_cuda:
            return out, None
        ready = torch.cuda.Event()
        ready.record()
        return out, ready

    def _gather_host(self, pages: Sequence[int]) -> Dict[str, torch.Tensor]:
        """:meth:`_gather_pinned`, its copies complete."""
        out, ready = self._gather_pinned(pages)
        if ready is not None:
            ready.synchronize()
        return out

    def _scatter_device(self, pages: Sequence[int], leaves: Dict[str, torch.Tensor]) -> None:
        """Write host leaves into the pages of every cache leaf, in place:
        one ``index_copy_`` per leaf."""
        ids = torch.as_tensor(list(pages), dtype=torch.int64, device=self.k_device)
        for prefix, tree in (("k", self.k), ("v", self.v)):
            for key, buf in _spill_leaves(tree, prefix).items():
                host = leaves[key].to(buf.device, buf.dtype, non_blocking=True)
                buf.index_copy_(1, ids, host)

    @property
    def k_device(self) -> torch.device:
        return next(iter(_spill_leaves(self.k, "k").values())).device

    def _spill_or_drop(self, sess: Session) -> None:
        if self.tiers is not None:
            # tiering replaces direct spill/drop: the session parks in
            # host memory and cascades to disk under host-cap pressure
            self.tiers.demote_session(sess)
            return
        if self.sessions.spill_dir is not None:
            self.sessions.spill(sess, self._gather_host(sess.pages))
        else:
            self.sessions.drop(sess.session_id)
        self._page_decref(sess.pages)
        sess.pages = []

    def _restore_session(self, session_id: str, now: float) -> Optional[Session]:
        loaded = self.sessions.load(session_id)
        if loaded is None:
            return None
        sess, leaves = loaded
        pages = self._take_pages(_pages_for(sess.cached_len, self.page_len), now)
        if pages is None:
            logger.warning(
                f"kvcache: no pages to restore spilled session "
                f"{session_id!r}; dropping it"
            )
            self.sessions.drops += 1
            return None
        self._scatter_device(pages, leaves)
        sess.pages = pages
        sess.parked_at = now
        self.sessions.park(sess)
        return sess

    @_locked
    def sweep(self, now: float) -> int:
        """TTL sweep: spill (or drop) sessions cold past
        ``session_ttl_seconds``.  Cheap; the engine runs it per step."""
        expired = self.sessions.expired(now)
        for sess in expired:
            self._spill_or_drop(sess)
        return len(expired)

    @_locked
    def spill_sessions(self, now: float = 0.0) -> int:
        """Persist every warm session (no-op without a spill_dir — the
        pages die with the process, which only costs a re-prefill)."""
        if self.sessions.spill_dir is None:
            return 0
        warm = self.sessions.warm()
        for sess in warm:
            self._spill_or_drop(sess)
        return len(warm)

    @_locked
    def attach_tiers(self, mgr: Any) -> None:
        """Arm hierarchical tiering: ``mgr`` (a
        :class:`~deepspeed_tpu_torch.serving.kvcache.tiers.PageTierManager`)
        takes over session spill/drop and cold prefix eviction."""
        self.tiers = mgr

    @_locked
    def attach_tenants(self, registry: Any) -> None:
        """Arm per-tenant quota enforcement: ``registry`` (a
        :class:`~deepspeed_tpu_torch.serving.frontdoor.tenants.TenantRegistry`)
        supplies page and pinned-prefix caps; over-cap allocations defer
        (return ``None`` from :meth:`alloc_request`) and over-cap pins
        degrade to unpinned entries."""
        self.tenants = registry

    @_locked
    def recover(self) -> List[str]:
        """After a restart: re-register manifest-verified session spills
        (and, with tiers, their committed disk entries) so rebinds keep
        working.  (Device pages and the learned prefix index died with
        the process — traffic re-prefills and re-learns.)"""
        found = self.sessions.recover()
        if self.tiers is not None:
            found = found + self.tiers.recover()
        return found

    # -- live migration ---------------------------------------------------
    @_locked
    def export_sessions(self, dest_dir: str, now: float = 0.0) -> List[str]:
        """Scale-down export: write every parked session (warm and
        spilled) plus every pinned prefix entry into ``dest_dir`` in the
        spill wire format, one manifest-last directory per entry.

        READ-ONLY on pool state — sessions stay parked, pins stay
        indexed, no refcount moves — so a failed or killed export is
        simply retried, and an abandoned one costs nothing.  A kill -9
        mid-export leaves a manifest-verified prefix of entries the
        importer trusts; the unverified tail is ignored."""
        os.makedirs(dest_dir, exist_ok=True)
        exported: List[str] = []
        for sess in self.sessions.warm():
            # a residency-window session keeps only head pages in T0;
            # the export must carry the tier-held tail too
            leaves = (self.tiers.merged_session_leaves(sess)
                      if self.tiers is not None
                      else self._gather_host(sess.pages))
            write_entry(
                dest_dir, session_dir_name(sess.session_id),
                {
                    "kind": "session",
                    "session_id": sess.session_id,
                    "tokens": [int(t) for t in sess.tokens],
                    "parked_at": sess.parked_at,
                },
                leaves,
            )
            exported.append(sess.session_id)
        for sid in self.sessions.spilled_ids():
            src = self.sessions.spilled_dir(sid)
            loaded = read_entry(src) if src else None
            if loaded is None:
                continue
            meta, leaves = loaded
            meta = {k: v for k, v in meta.items() if k != "leaf_dtypes"}
            meta.setdefault("kind", "session")
            write_entry(dest_dir, session_dir_name(sid), meta, leaves)
            exported.append(sid)
        for entry in self.index.entries():
            if not entry.pinned:
                continue  # learned entries re-learn from traffic
            write_entry(
                dest_dir, pin_dir_name(entry.tokens),
                {
                    "kind": "pinned_prefix",
                    "tokens": [int(t) for t in entry.tokens],
                },
                self._gather_host(entry.pages),
            )
            exported.append(f"pin:{len(entry.tokens)}")
        if self.tiers is not None:
            exported.extend(self.tiers.export_sessions(
                dest_dir, skip=set(exported)))
        return exported

    @_locked
    def import_sessions(self, src_dir: str, now: float = 0.0) -> Dict[str, int]:
        """Scale-up/survivor import: adopt every manifest-verified entry
        under ``src_dir``.  Sessions the pool already knows are skipped
        (the survivor's own copy wins — rebind is an optimisation, so a
        skip only re-prefills, it never changes outputs).  When the pool
        is out of pages a migrated session lands in this pool's own
        spill_dir instead (or is dropped without one)."""
        counts = {"sessions": 0, "pinned": 0, "respilled": 0, "skipped": 0}
        for meta, leaves in read_entries(src_dir):
            kind = meta.get("kind", "session")
            if kind == "pinned_prefix":
                tokens = np.asarray(meta["tokens"], np.int32)
                if tokens.shape[0] < 1:
                    counts["skipped"] += 1
                    continue
                existing = self.index.get(tokens)
                if existing is not None:
                    existing.pinned = True
                    counts["skipped"] += 1
                    continue
                pages = self._take_pages(
                    _pages_for(tokens.shape[0], self.page_len), now
                )
                if pages is None:
                    logger.warning(
                        "kvcache: no pages to import a pinned prefix "
                        f"({tokens.shape[0]} tokens); dropping it"
                    )
                    counts["skipped"] += 1
                    continue
                self._scatter_device(pages, leaves)
                # insert takes the index's own reference (ref -> 2);
                # releasing the import's claim leaves the index as the
                # sole holder, exactly like a learned pinned entry
                self._insert_entry(tokens, pages, pinned=True, now=now)
                self._page_decref(pages)
                counts["pinned"] += 1
                continue
            sid = meta["session_id"]
            if self.sessions.has(sid):
                counts["skipped"] += 1
                continue
            sess = Session(
                session_id=sid,
                tokens=np.asarray(meta["tokens"], np.int32),
                pages=[],
                parked_at=now,
            )
            pages = self._take_pages(
                _pages_for(sess.cached_len, self.page_len), now
            )
            if pages is None:
                if self.sessions.adopt_spill(sid, meta, leaves) is not None:
                    counts["respilled"] += 1
                else:
                    logger.warning(
                        f"kvcache: no pages and no spill_dir for migrated "
                        f"session {sid!r}; dropping it (next turn re-prefills)"
                    )
                    counts["skipped"] += 1
                continue
            self._scatter_device(pages, leaves)
            sess.pages = pages
            self.sessions.park(sess)
            counts["sessions"] += 1
        return counts

    # -- introspection ----------------------------------------------------
    @_locked
    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    @_locked
    def stats(self) -> Dict[str, Any]:
        sess = self.sessions.stats()
        out = {
            "page_len": self.page_len,
            "num_pages": self.num_pages,
            "pages_per_slot": self.pages_per_slot,
            "pages_live": self.pages_live,
            "pages_free": self.pages_free,
            "lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "hit_rate": (self.hits / self.lookups) if self.lookups else 0.0,
            "tokens_saved": self.tokens_saved,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "alloc_waits": self.alloc_waits,
            "prefix_entries": len(self.index),
            "session_rebinds": self.session_rebinds,
            "sessions_warm": sess["warm"],
            "sessions_spilled": sess["spilled"],
            "session_parks": sess["parks"],
            "session_spills": sess["spills"],
            "session_restores": sess["restores"],
            "session_drops": sess["drops"],
        }
        if self.tiers is not None:
            out["tiers"] = self.tiers.stats()
        if self.tenants is not None:
            out["tenant_pages"] = dict(self._tenant_pages)
            out["tenant_pinned"] = dict(self._tenant_pinned)
            out["tenant_quota_defers"] = self.tenant_quota_defers
            out["tenant_pin_rejects"] = self.tenant_pin_rejects
        return out
