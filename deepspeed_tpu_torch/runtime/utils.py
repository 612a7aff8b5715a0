"""Runtime helpers (counterpart of ``deepspeed_tpu/runtime/utils.py``): the
pure-logic partitioning helpers that place a pipeline's layers on its
stages (reference ``runtime/utils.py:352`` ``partition_uniform``, ``:418``
``partition_balanced``) and the instructions' printer."""
from __future__ import annotations

from typing import List, Optional, Sequence


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries that split ``num_items`` into ``num_parts`` near-equal
    contiguous chunks.  Returns ``num_parts + 1`` boundaries; chunk ``p``
    is ``[parts[p], parts[p+1])``."""
    parts = [0] * (num_parts + 1)
    if num_items <= num_parts:
        for p in range(num_parts + 1):
            parts[p] = min(p, num_items)
        return parts
    chunksize = num_items // num_parts
    residual = num_items % num_parts
    for p in range(1, num_parts + 1):
        parts[p] = min(chunksize * p, num_items)
    # the remainder, one item at a time, to the earliest chunks
    for p in range(1, residual + 1):
        for q in range(p, num_parts + 1):
            parts[q] += 1
    return parts


def prefix_sum_inc(weights: Sequence[float]) -> List[float]:
    """Inclusive prefix sum (reference ``runtime/utils.py:406``)."""
    out = []
    total = 0.0
    for w in weights:
        total += w
        out.append(total)
    return out


def partition_balanced(weights: Sequence[float], num_parts: int, eps: float = 1e-3) -> List[int]:
    """Boundaries that split weighted items into ``num_parts`` contiguous
    chunks minimizing the largest chunk's weight (a binary search over the
    bottleneck); the convention of :func:`partition_uniform`."""
    num_items = len(weights)
    if num_items <= num_parts:
        return partition_uniform(num_items, num_parts)

    prefix = prefix_sum_inc(weights)

    def can_pack(limit: float) -> Optional[List[int]]:
        """Greedy: as many items a chunk as fit under ``limit``."""
        parts = [0]
        for _ in range(num_parts):
            start = parts[-1]
            if start == num_items:  # every item placed; trailing chunks empty
                parts.append(start)
                continue
            base = prefix[start - 1] if start > 0 else 0.0
            end = start
            while end < num_items and prefix[end] - base <= limit:
                end += 1
            if end == start:  # one item alone exceeds the limit
                return None
            parts.append(end)
        return parts if parts[-1] == num_items else None

    lo = max(weights)
    hi = prefix[-1]
    while hi - lo > eps * max(1.0, hi):
        mid = (lo + hi) / 2
        if can_pack(mid) is not None:
            hi = mid
        else:
            lo = mid
    parts = can_pack(hi)
    assert parts is not None
    return parts


def call_to_str(base: str, *args, **kwargs) -> str:
    """``name(arg, kw=val)`` (reference ``runtime/utils.py:633``)."""
    name = f"{base}("
    if args:
        name += ", ".join(repr(a) for a in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join(f"{k}={v!r}" for k, v in kwargs.items())
    name += ")"
    return name
