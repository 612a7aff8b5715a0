"""Paged KV subsystem: page pool + allocator, shared-prefix dedup,
copy-on-write pages, durable session KV, and hierarchical device → host
→ disk page tiering (counterpart of ``deepspeed_tpu/serving/kvcache``)."""
from deepspeed_tpu_torch.serving.kvcache.pages import GARBAGE_PAGE, PagedKVPool
from deepspeed_tpu_torch.serving.kvcache.prefix import PrefixEntry, PrefixIndex
from deepspeed_tpu_torch.serving.kvcache.sessions import Session, SessionStore
from deepspeed_tpu_torch.serving.kvcache.tiers import PageTierManager, TierEntry

__all__ = [
    "GARBAGE_PAGE",
    "PagedKVPool",
    "PageTierManager",
    "PrefixEntry",
    "PrefixIndex",
    "Session",
    "SessionStore",
    "TierEntry",
]
