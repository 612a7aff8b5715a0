"""Slot-pool KV cache: a fixed-shape device cache + a host-side slot
allocator (counterpart of ``deepspeed_tpu/serving/pool.py``).

The pool is ONE pair of ``(layers, num_slots, heads, max_len, head_dim)``
cache tensors (bf16/f32, or the int8 code+scale pair from
``init_kv_cache``) whose **slot axis is the batch axis** of the fused
inference blocks: every serving step sees the same shapes whichever
subset of slots is live.  The serving steps write into these tensors in
place.

The allocator is pure host bookkeeping: ``alloc()`` hands out the
longest-free slot (FIFO over frees), ``free()`` returns it.  Freeing does
not touch device memory — a freed slot's stale keys/values are
unreachable (the next occupant's writes start at position 0 and the
position mask only exposes positions the occupant itself wrote).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Optional

from deepspeed_tpu_torch.ops.transformer.inference import init_kv_cache


class SlotPoolError(RuntimeError):
    pass


def _leaves(c):
    return list(c.values()) if isinstance(c, dict) else [c]


class SlotKVPool:
    """Fixed-shape KV slot pool + host-side allocator.  ``kv_dtype`` is a
    torch dtype for the plain cache or ``"int8"`` for the quantized
    code+scale pair; the tensors live in ``self.k`` / ``self.v`` on
    ``device``."""

    def __init__(self, n_layer: int, num_slots: int, heads: int, max_len: int,
                 head_dim: int, kv_dtype: Any, device: Any = "cpu"):
        if num_slots < 1:
            raise SlotPoolError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 1:
            raise SlotPoolError(f"max_len must be >= 1, got {max_len}")
        self.n_layer = int(n_layer)
        self.num_slots = int(num_slots)
        self.heads = int(heads)
        self.max_len = int(max_len)
        self.head_dim = int(head_dim)
        self.kv_dtype = kv_dtype
        self.k, self.v = init_kv_cache(n_layer, num_slots, heads, max_len, head_dim, kv_dtype,
                                       device=device)
        self._free: Deque[int] = deque(range(num_slots))
        self._owner: Dict[int, Any] = {}  # slot -> request id

    # -- allocator --------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_slots(self) -> int:
        return self.num_slots - len(self._free)

    def owner(self, slot: int) -> Optional[Any]:
        return self._owner.get(slot)

    def owners(self) -> Dict[int, Any]:
        """Snapshot of slot -> request id."""
        return dict(self._owner)

    def alloc(self, request_id: Any) -> Optional[int]:
        """Claim a slot for ``request_id``; None when the pool is full.  A
        request id may own at most one slot."""
        if request_id in self._owner.values():
            raise SlotPoolError(
                f"request {request_id!r} already owns a slot; "
                f"free it before re-allocating"
            )
        if not self._free:
            return None
        slot = self._free.popleft()
        self._owner[slot] = request_id
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise SlotPoolError(f"slot {slot} is not allocated")
        del self._owner[slot]
        self._free.append(slot)

    # -- device buffers ---------------------------------------------------
    def slot_view(self, slot: int):
        """``(k, v)`` views of one slot, ``(layers, 1, heads, max_len,
        head_dim)``: writes through them land in the pool."""
        def take(c):
            if isinstance(c, dict):
                return {name: a[:, slot:slot + 1] for name, a in c.items()}
            return c[:, slot:slot + 1]

        return take(self.k), take(self.v)

    def cache_bytes(self) -> int:
        """Device bytes held by the pool (both caches, all leaves)."""
        return int(sum(t.numel() * t.element_size() for t in _leaves(self.k) + _leaves(self.v)))

    def shape_math(self) -> str:
        """Human-readable pool sizing."""
        kind = "int8+f32 scales" if isinstance(self.k, dict) else str(self.k.dtype)
        return (
            f"2 x ({self.n_layer} layers x {self.num_slots} slots x "
            f"{self.heads} heads x {self.max_len} positions x "
            f"{self.head_dim} head_dim) [{kind}] = "
            f"{self.cache_bytes() / 1e6:.1f} MB"
        )

