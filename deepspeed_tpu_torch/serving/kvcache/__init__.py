"""Paged KV subsystem: page pool + allocator, shared-prefix dedup,
copy-on-write pages and durable session KV (counterpart of
``deepspeed_tpu/serving/kvcache``; the HBM → host → disk tiering is not
ported yet)."""
from deepspeed_tpu_torch.serving.kvcache.pages import GARBAGE_PAGE, PagedKVPool
from deepspeed_tpu_torch.serving.kvcache.prefix import PrefixEntry, PrefixIndex
from deepspeed_tpu_torch.serving.kvcache.sessions import Session, SessionStore

__all__ = [
    "GARBAGE_PAGE",
    "PagedKVPool",
    "PrefixEntry",
    "PrefixIndex",
    "Session",
    "SessionStore",
]
