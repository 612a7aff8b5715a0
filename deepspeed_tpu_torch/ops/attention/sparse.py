"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/attention/sparse.py``).

Layout convention: ``(batch, heads, seq, head_dim)``; a layout is a numpy
``(heads, T // block, T // block)`` 0/1 array of active (query block, key
block) pairs.

* The ``SparsityConfig`` family (Dense, Fixed, Variable, BigBird,
  BSLongformer) builds the JAX package's layouts bit for bit: the same
  numpy code, and the same stdlib ``random.Random(0)`` draws in the same
  order for the random blocks.
* :func:`block_sparse_attention` keeps the JAX package's two backends.
  ``"gather"`` is its XLA formulation in plain torch (gather the active
  K/V blocks of each query block, masked dense attention over them),
  differentiable by autograd, with ``key_padding_mask``; rows with no
  active block give zeros.  ``"splash"`` is :func:`splash_attention`: the
  CUDA kernels B8 (:func:`splash_fwd`, ``csrc/splash_attn.cu``), B9a
  (:func:`splash_bwd_dq`) and B9b (:func:`splash_bwd_dkv`; bf16 on their
  tensor-core bodies, ``csrc/splash_attn_tc.cu``) for CUDA tensors, their
  plain versions for CPU tensors, tied together by
  :class:`_SplashAttention` (the JAX package's ``custom_vjp``).  Auto
  (``None``) takes splash when the JAX package's rule holds (``block >=
  64``, ``T % block == 0``, no key-padding mask) and the tensors lie on
  the card, and gather otherwise.  The route is that static rule only.
* Full-degree rows (the horizontal globals of BigBird and Longformer)
  leave the kernels: :func:`_apply_dense_rows` computes them densely and
  overwrites them outside the autograd function, so autograd
  differentiates them.  An all-ones layout is exempt on the splash path
  (``exempt_uniform_full``): there every row stays on the kernels.

The kernels' plain versions (``splash_*_reference``) repeat the kernels'
arithmetic: f32 scores from the operands' values, masked scores at
``DEFAULT_MASK_VALUE`` before the max and the keep mask applied again
after ``exp``, p rounded to v's type before the value product, a row with
no active block giving out 0 and ``lse = +inf``; in the backward ``P =
exp(S - lse)`` with the keep mask, ``dS = P (dP - delta) scale`` rounded to
q's type, dk and dv summed per key block over the column-sorted edge
list (:func:`_layout_dkv_edges`), an untouched column exactly 0.
"""
from __future__ import annotations

import functools
import math
import random as _random
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops import kernels as _kernels
from deepspeed_tpu_torch.ops.attention import flash_attention as _fa
from deepspeed_tpu_torch.ops.attention.flash_attention import (
    _DTYPE_CODES,
    _HEAD_DIMS,
    DEFAULT_MASK_VALUE,
    forward_residuals,
)

# ---------------------------------------------------------------------------
# Layout configs (the JAX package's, same constructor surface and checks)
# ---------------------------------------------------------------------------


class SparsityConfig:
    """Abstract layout generator.  ``block`` is the square block size in
    tokens; layouts are (num_heads, seq_blocks, seq_blocks) uint8 arrays."""

    def __init__(self, num_heads: int, block: int = 16, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be divisible by block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=np.uint8)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks active, for correctness comparisons."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern of the Sparse Transformers: local windows of
    ``num_local_blocks`` plus global attention to the last
    ``num_global_blocks`` of each window (vertical stripes; horizontal too
    when bidirectional)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_local_blocks: int = 4,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        num_different_global_patterns: int = 1,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError("num_local_blocks must be divisible by num_global_blocks")
        if attention not in ("unidirectional", "bidirectional"):
            raise ValueError("attention must be uni/bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError("horizontal global attention requires bidirectional attention")
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 requires different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError("num_different_global_patterns too large")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def _set_local(self, layout: np.ndarray, h: int) -> None:
        nb = layout.shape[1]
        for start in range(0, nb, self.num_local_blocks):
            end = min(start + self.num_local_blocks, nb)
            for r in range(start, end):
                hi = (r + 1) if self.attention == "unidirectional" else end
                layout[h, r, start:hi] = 1

    def _set_global(self, layout: np.ndarray, h: int) -> None:
        nb = layout.shape[1]
        # the block of each window that carries the global stripes rotates
        # across heads when several patterns are asked for
        pattern = h % self.num_different_global_patterns
        first = self.num_local_blocks - (1 + pattern) * self.num_global_blocks
        for wstart in range(0, nb, self.num_local_blocks):
            gstart = wstart + first
            gend = gstart + self.num_global_blocks
            if gstart >= nb:
                continue
            gend = min(gend, nb)
            # vertical stripes: rows at or after the global blocks attend to
            # them (all rows when bidirectional)
            if self.attention == "bidirectional":
                layout[h, :, gstart:gend] = 1
            else:
                layout[h, gstart:, gstart:gend] = 1
            if self.horizontal_global_attention:
                layout[h, gstart:gend, :] = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self._set_local(layout, h)
            self._set_global(layout, h)
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes, explicit global blocks and random
    blocks."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 0,
        local_window_blocks: Optional[List[int]] = None,
        global_block_indices: Optional[List[int]] = None,
        global_block_end_indices: Optional[List[int]] = None,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        if global_block_end_indices is not None and len(global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices must pair with global_block_indices")
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = _random.Random(0)
        for h in range(self.num_layout_heads):
            # local windows of variable width, the last width repeating
            start = 0
            i = 0
            while start < nb:
                w = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + w, nb)
                for r in range(start, end):
                    hi = (r + 1) if self.attention == "unidirectional" else end
                    layout[h, r, start:hi] = 1
                start, i = end, i + 1
            for gi, g in enumerate(self.global_block_indices):
                gend = (
                    self.global_block_end_indices[gi]
                    if self.global_block_end_indices is not None
                    else g + 1
                )
                g0, g1 = min(g, nb), min(gend, nb)
                layout[h, :, g0:g1] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:g1, :] = 1
            for r in range(nb):
                for _ in range(self.num_random_blocks):
                    layout[h, r, rng.randrange(nb)] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC: random blocks, a sliding window and global first (and,
    bidirectional, last) blocks."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 1,
        num_sliding_window_blocks: int = 3,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        if nb < self.num_sliding_window_blocks:
            raise ValueError(f"seq has {nb} blocks < sliding window {self.num_sliding_window_blocks}")
        rng = _random.Random(0)
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        for h in range(self.num_layout_heads):
            for r in range(nb):
                layout[h, r, max(0, r - w): min(nb, r + w + 1)] = 1  # window
                for _ in range(self.num_random_blocks):  # random
                    layout[h, r, rng.randrange(nb)] = 1
            layout[h, :, :g] = 1  # global columns (first blocks)
            layout[h, :g, :] = 1  # global rows
            if self.attention == "bidirectional":
                layout[h, :, nb - g:] = 1
                layout[h, nb - g:, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: a sliding window plus selected global
    blocks."""

    def __init__(
        self,
        num_heads: int,
        block: int = 16,
        different_layout_per_head: bool = False,
        num_sliding_window_blocks: int = 3,
        global_block_indices: Optional[List[int]] = None,
        global_block_end_indices: Optional[List[int]] = None,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for r in range(nb):
                layout[h, r, max(0, r - w): min(nb, r + w + 1)] = 1
            for gi, g in enumerate(self.global_block_indices):
                gend = (
                    self.global_block_end_indices[gi]
                    if self.global_block_end_indices is not None
                    else g + 1
                )
                g0, g1 = min(g, nb), min(gend, nb)
                layout[h, :, g0:g1] = 1
                layout[h, g0:g1, :] = 1
        layout = self.check_and_propagate_first_head_layout(layout)
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return layout


# ---------------------------------------------------------------------------
# Layout prep (host numpy, cached per layout)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _head_uniform(layout: np.ndarray) -> bool:
    """True when every head shares one layout (the default: configs
    propagate head 0 unless ``different_layout_per_head``)."""
    return layout.shape[0] == 1 or bool(np.all(layout == layout[:1]))


def _dense_row_mask(layout: np.ndarray, exempt_uniform_full: bool = False) -> np.ndarray:
    """(H, nb) bool: the query rows at full degree, which go to the dense
    bucket.  The row-major (:func:`_layout_gather_indices`) and column-major
    (:func:`_layout_dkv_edges`) enumerations share this one definition, so
    a dense row's dk/dv is never counted twice or dropped.
    ``exempt_uniform_full`` (the splash path only): when every row of every
    head is full (an all-ones layout), no row goes to the bucket; the gather
    path never takes the exemption, since its per-row K/V gather at full
    degree would copy K/V nb times."""
    mask = layout.sum(-1) >= layout.shape[-1]
    if exempt_uniform_full and mask.all():
        return np.zeros_like(mask)
    return mask


def _layout_key(layout: np.ndarray):
    layout = np.ascontiguousarray(layout)
    return layout.shape, str(layout.dtype), layout.tobytes()


def _layout_gather_indices(layout: np.ndarray, exempt_uniform_full: bool = False
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Row-bucketed layout prep, cached per layout:

    * sparse rows → ``idx (H, nb, deg)``, ``valid (H, nb, deg)``: the
      active key-block ids of each row, padded to the largest degree among
      the sparse rows only; a dense row is all invalid (its output is 0,
      then overwritten by the dense bucket);
    * dense rows → ``dense_rows (H, M)``, ``dense_valid (H, M)``: the
      query-block ids of the full-degree rows, padded to the largest count
      over the heads."""
    return _layout_gather_indices_cached(*_layout_key(layout), bool(exempt_uniform_full))


@functools.lru_cache(maxsize=64)
def _layout_gather_indices_cached(shape, dtype: str, data: bytes, exempt_uniform_full: bool):
    layout = np.frombuffer(data, dtype=dtype).reshape(shape)
    H, nb, _ = layout.shape
    row_deg = layout.sum(-1)
    dense_mask = _dense_row_mask(layout, exempt_uniform_full)
    sparse_deg = int(np.where(dense_mask, 0, row_deg).max())
    deg = max(1, sparse_deg)
    idx = np.zeros((H, nb, deg), np.int32)
    valid = np.zeros((H, nb, deg), bool)
    for h in range(H):
        for r in range(nb):
            if dense_mask[h, r]:
                continue
            cols = np.nonzero(layout[h, r])[0]
            idx[h, r, : len(cols)] = cols
            valid[h, r, : len(cols)] = True
    M = int(dense_mask.sum(-1).max())
    dense_rows = np.zeros((H, max(M, 1)), np.int32)
    dense_valid = np.zeros((H, max(M, 1)), bool)
    for h in range(H):
        rows = np.nonzero(dense_mask[h])[0]
        dense_rows[h, : len(rows)] = rows
        dense_valid[h, : len(rows)] = True
    if M == 0:
        dense_rows = dense_rows[:, :0]
        dense_valid = dense_valid[:, :0]
    return idx, valid, dense_rows, dense_valid


def _layout_dkv_edges(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Column-major (key-block-major) edge list of the dk/dv pass: per head,
    the sparse rows' edges sorted by key column, so a column's edges are
    consecutive; every column appears at least once (an untouched column
    gets one invalid edge), so each dk/dv block is written exactly once.
    Dense (full-degree) rows are left out, as in
    :func:`_layout_gather_indices`: autograd differentiates them.

    Returns ``(qidx, kcol, flags)``, each (LH, E) int32 with LH = 1 for a
    head-uniform layout, else H; flags bit 0 = edge valid, bit 1 = first
    edge of its column's run, bit 2 = last.  Cached per layout."""
    if _head_uniform(layout):
        layout = layout[:1]
    return _layout_dkv_edges_cached(*_layout_key(layout))


@functools.lru_cache(maxsize=64)
def _layout_dkv_edges_cached(shape, dtype: str, data: bytes
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    layout = np.frombuffer(data, dtype=dtype).reshape(shape)
    H, nb, _ = layout.shape
    dense_mask = _dense_row_mask(layout, exempt_uniform_full=True)
    per_head = []
    for h in range(H):
        keep = (layout[h] != 0) & ~dense_mask[h][:, None]  # (row, col)
        # nonzero of the transpose enumerates by (col, row)
        cols, rows = np.nonzero(keep.T)
        empty = np.nonzero(~keep.any(axis=0))[0]  # columns with no edge
        c = np.concatenate([cols, empty])
        r = np.concatenate([rows, np.zeros(len(empty), np.intp)])
        ok = np.concatenate([np.ones(len(cols), np.int32), np.zeros(len(empty), np.int32)])
        # stable: a real column keeps its rows ascending
        order = np.argsort(c, kind="stable")
        c, r, ok = c[order], r[order], ok[order]
        boundary = np.diff(c) != 0
        first = np.concatenate([[True], boundary])
        last = np.concatenate([boundary, [True]])
        per_head.append((r, c, ok | (first << 1) | (last << 2)))
    E = max(len(r) for r, _, _ in per_head)
    qidx = np.zeros((H, E), np.int32)
    # padding rides the final column's run with flags 0
    kcol = np.full((H, E), nb - 1, np.int32)
    flags = np.zeros((H, E), np.int32)
    for h, (r, c, fl) in enumerate(per_head):
        n = len(r)
        qidx[h, :n] = r
        kcol[h, :n] = c
        flags[h, :n] = fl
    return qidx, kcol, flags


def _splash_layout(layout: np.ndarray) -> np.ndarray:
    """The layout the kernels read: one head's when every head shares it
    (one row of indices instead of H), else all H."""
    return layout[:1] if _head_uniform(layout) else layout


def _column_offsets(kcol: np.ndarray, nb: int) -> np.ndarray:
    """(LH, nb + 1) int32: column c's run of the column-sorted edge list is
    ``[off[c], off[c + 1])`` (the padding edges close the last run)."""
    off = np.stack([np.searchsorted(row, np.arange(nb + 1), side="left") for row in kcol])
    off[:, nb] = kcol.shape[1]
    return off.astype(np.int32)


def _dkv_items(kcol: np.ndarray, flags: np.ndarray, nb: int, per_item: int):
    """B9b's work items: each column's run of the edge list cut into pieces
    of at most ``per_item`` valid edges (the run's invalid edges ride its
    last piece; an untouched column is one piece).  Returns ``(item_col
    (LH, W), item_off (LH, W + 1), col_items (LH, nb + 1))``, int32: item w
    covers edges [item_off[w], item_off[w + 1]) of column item_col[w];
    column c's items are [col_items[c], col_items[c + 1]); a head with
    fewer than W items pads item_col with -1."""
    off = _column_offsets(kcol, nb)
    heads = []
    for h in range(kcol.shape[0]):
        cols, starts, col_items = [], [], [0]
        for c in range(nb):
            e0, e1 = int(off[h, c]), int(off[h, c + 1])
            real = e0 + np.nonzero(flags[h, e0:e1] & 1)[0]
            cuts = [e0] + [int(e) for e in real[per_item::per_item]]
            cols += [c] * len(cuts)
            starts += cuts
            col_items.append(len(cols))
        heads.append((cols, starts + [int(off[h, nb])], col_items))
    W = max(len(cols) for cols, _, _ in heads)
    item_col = np.full((len(heads), W), -1, np.int32)
    item_off = np.zeros((len(heads), W + 1), np.int32)
    col_items = np.zeros((len(heads), nb + 1), np.int32)
    for h, (cols, starts, ci) in enumerate(heads):
        item_col[h, :len(cols)] = cols
        item_off[h, :len(starts)] = starts
        item_off[h, len(starts):] = starts[-1]
        col_items[h] = ci
    return item_col, item_off, col_items


@functools.lru_cache(maxsize=64)
def _kernel_arrays_cached(shape, dtype: str, data: bytes, device: str):
    """The kernels' index arrays of one layout on ``device``: ``(idx,
    valid)`` (LH, nb * deg) int32 of the row walk (B8, B9a), deg, and
    ``(qidx, flags, item_col, item_off, col_items)`` of the column walk
    (B9b), its items at most deg valid edges each (:func:`_dkv_items`)."""
    layout = _splash_layout(np.frombuffer(data, dtype=dtype).reshape(shape))
    nb = layout.shape[1]
    idx, valid, _, _ = _layout_gather_indices(layout, exempt_uniform_full=True)
    qidx, kcol, flags = _layout_dkv_edges(layout)
    deg = idx.shape[-1]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32).reshape(a.shape[0], -1),
                               device=device)

    return (dev(idx), dev(valid), deg,
            tuple(dev(a) for a in (qidx, flags, *_dkv_items(kcol, flags, nb, deg))))


# ---------------------------------------------------------------------------
# The gather path (the JAX package's XLA formulation, in plain torch)
# ---------------------------------------------------------------------------


def _masked_softmax(s: torch.Tensor) -> torch.Tensor:
    row_max = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - row_max)
    denom = p.sum(dim=-1, keepdim=True)
    return torch.where(denom > 0, p / denom.clamp_min(1e-30), torch.zeros((), device=s.device))


def _gather_blocks(xb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``xb[b, h, idx[h', n, e]]`` for blocked ``xb`` (B, H, nb, block, d)
    and ``idx`` (LH, nb, deg), h' = h when LH = H, else 0: (B, H, nb, deg,
    block, d) (the (LH, E) edge form gives (B, H, E, block, d))."""
    if idx.shape[0] == 1:
        return xb[:, :, idx[0]]
    hidx = torch.arange(xb.shape[1], device=xb.device).reshape(-1, *([1] * (idx.ndim - 1)))
    return xb[:, hidx, idx]


def block_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    layout: np.ndarray,
    block: int,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Attention restricted to the active blocks of ``layout``.

    ``q, k, v``: (B, H, T, hd); ``layout``: (H, T // block, T // block) 0/1
    numpy.  ``backend``: ``"splash"`` (:func:`splash_attention`: the
    kernels on the card; rows with no active block give zeros), ``"gather"``
    (plain torch, differentiable by autograd) or ``None`` (auto: splash
    when ``block >= 64``, ``T % block == 0``, no ``key_padding_mask`` and
    the tensors lie on the card, else gather).  As in the JAX package, the
    splash kernels run their dots on the operands' type with f32 sums,
    the gather path in f32.  ``causal=True`` also applies the elementwise
    causal mask inside diagonal blocks.  ``key_padding_mask`` (B, T):
    nonzero where a key is real."""
    B, H, T, hd = q.shape
    nb = T // block
    if layout.shape != (H, nb, nb):
        raise ValueError(f"layout {layout.shape} != {(H, nb, nb)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if backend not in (None, "gather", "splash"):
        raise ValueError(f"backend must be None|'gather'|'splash', got {backend!r}")
    if backend != "gather":
        eligible = key_padding_mask is None and block >= 64 and T % block == 0
        if backend == "splash":
            if not eligible:
                raise ValueError("splash backend needs block >= 64 and no key_padding_mask")
            return splash_attention(q, k, v, layout, block, causal=causal, sm_scale=sm_scale)
        if eligible and q.is_cuda:
            return splash_attention(q, k, v, layout, block, causal=causal, sm_scale=sm_scale)
    idx_np, valid_np, drows_np, dvalid_np = _layout_gather_indices(layout)
    dev = q.device
    idx = torch.as_tensor(idx_np, dtype=torch.long, device=dev)  # (H, nb, deg)
    valid = torch.as_tensor(valid_np, device=dev)

    qb = q.reshape(B, H, nb, block, hd)
    kg = _gather_blocks(k.reshape(B, H, nb, block, hd), idx)  # (B, H, nb, deg, block, hd)
    vg = _gather_blocks(v.reshape(B, H, nb, block, hd), idx)

    s = torch.einsum("bhnqd,bhnekd->bhnqek", qb.float(), kg.float()) * sm_scale
    mask = valid[None, :, :, None, :, None]  # (1, H, nb, 1, deg, 1)
    if causal:
        ar = torch.arange(block, device=dev)
        q_pos = torch.arange(nb, device=dev)[:, None] * block + ar[None, :]  # (nb, block)
        k_pos = idx[..., None] * block + ar  # (H, nb, deg, block)
        causal_ok = q_pos[None, :, :, None, None] >= k_pos[:, :, None, :, :]
        mask = mask & causal_ok[None]
    if key_padding_mask is not None:
        kp_blocks = key_padding_mask.to(dev).bool().reshape(B, nb, block)
        kpg = kp_blocks[:, idx]  # (B, H, nb, deg, block)
        mask = mask & kpg[:, :, :, None, :, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    deg = idx.shape[-1]
    s = s.reshape(B, H, nb, block, deg * block)
    # a fully masked row has a uniform exp(0) = 1: the explicit re-mask
    # after the softmax gives it zeros
    p = _masked_softmax(s).reshape(B, H, nb, block, deg, block) * mask.float()
    out = torch.einsum("bhnqek,bhnekd->bhnqd", p, vg.float())

    out = out.reshape(B, H, T, hd).to(q.dtype)
    if drows_np.shape[1] > 0:
        out = _apply_dense_rows(out, q, k, v, drows_np, dvalid_np, block, causal, sm_scale,
                                key_padding_mask)
    return out


def _apply_dense_rows(out, q, k, v, drows_np, dvalid_np, block, causal, sm_scale,
                      key_padding_mask):
    """Overwrite the full-degree (horizontal-global) query rows of ``out``
    with dense attention over all T keys; shared by the gather and splash
    paths and differentiated by autograd."""
    B, H, T, hd = q.shape
    nb = T // block
    dev = q.device
    drows = torch.as_tensor(drows_np, dtype=torch.long, device=dev)  # (H, M)
    dvalid = torch.as_tensor(dvalid_np, device=dev)
    qd = _gather_blocks(q.reshape(B, H, nb, block, hd), drows)  # (B, H, M, block, hd)
    sd = torch.einsum("bhmqd,bhtd->bhmqt", qd.float(), k.float()) * sm_scale
    dmask = torch.ones((1, 1, 1, 1, T), dtype=torch.bool, device=dev)
    if causal:
        q_pos_d = drows[:, :, None] * block + torch.arange(block, device=dev)  # (H, M, block)
        dmask = dmask & (q_pos_d[None, :, :, :, None] >= torch.arange(T, device=dev))
    if key_padding_mask is not None:
        dmask = dmask & key_padding_mask.to(dev).bool()[:, None, None, None, :]
    sd = torch.where(dmask, sd, torch.full((), NEG_INF, device=dev))
    pd = _masked_softmax(sd)
    od = torch.einsum("bhmqt,bhtd->bhmqd", pd, v.float())
    # scatter the dense rows' outputs over the sparse outputs
    onehot = F.one_hot(drows, nb).float() * dvalid[..., None]  # (H, M, nb)
    od_full = torch.einsum("hmn,bhmqd->bhnqd", onehot, od)
    is_dense_row = (onehot.sum(dim=1) > 0)[None, :, :, None, None]
    ob = out.reshape(B, H, nb, block, hd)
    ob = torch.where(is_dense_row, od_full.to(out.dtype), ob)
    return ob.reshape(B, H, T, hd)


# ---------------------------------------------------------------------------
# The splash kernels' plain versions (B8, B9a, B9b)
# ---------------------------------------------------------------------------


def _row_walk(layout: np.ndarray, dev):
    """``(idx, keep_valid)`` of the kernels' row walk on ``dev``: (LH, nb,
    deg) long ids and bool validity, LH = 1 for a head-uniform layout."""
    layout = _splash_layout(layout)
    idx, valid, _, _ = _layout_gather_indices(layout, exempt_uniform_full=True)
    return (torch.as_tensor(idx, dtype=torch.long, device=dev),
            torch.as_tensor(valid, device=dev))


def _edge_keep(ok, qblk, kblk, block: int, causal: bool) -> torch.Tensor:
    """(..., block, block) keep mask of edges with validity ``ok``, query
    blocks ``qblk`` and key blocks ``kblk`` (broadcast against each other):
    the edge's validity, and the elementwise causal constraint from the
    blocks' global positions."""
    keep = ok[..., None, None]
    if causal:
        ar = torch.arange(block, device=ok.device)
        q_pos = qblk[..., None, None] * block + ar[:, None]
        k_pos = kblk[..., None, None] * block + ar[None, :]
        keep = keep & (q_pos >= k_pos)
    return keep


def _row_keep(idx, valid, block: int, causal: bool) -> torch.Tensor:
    """(1, LH, nb, block, deg, block) keep mask of the row walk."""
    nb = idx.shape[1]
    rows = torch.arange(nb, device=idx.device)[None, :, None]
    keep = _edge_keep(valid, rows, idx, block, causal)  # (LH, nb, deg, block, block)
    return keep.permute(0, 1, 3, 2, 4)[None]


def _check_layout(who: str, layout: np.ndarray, H: int, T: int, block: int) -> None:
    if block < 1 or T % block:
        raise ValueError(f"{who}: T = {T} is not a multiple of block = {block}")
    nb = T // block
    if layout.ndim != 3 or layout.shape[0] not in (1, H) or layout.shape[1:] != (nb, nb):
        raise ValueError(f"{who}: layout {layout.shape} is not ({H} or 1, {nb}, {nb})")


def splash_fwd_reference(q, k, v, layout: np.ndarray, block: int, causal: bool,
                         sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8 (the Pallas ``_splash_kernel``): for
    each query block, the softmax over the layout's active key blocks in
    f32, masked scores at ``DEFAULT_MASK_VALUE`` and the keep mask applied
    again after ``exp``, p rounded to v's type before the value product;
    padded edges add nothing, a row with no active block gives out 0 and
    ``lse = +inf``.  Returns ``(out, lse)``, lse (B, H, T) f32."""
    B, H, T, d = q.shape
    _check_layout("splash_fwd_reference", layout, H, T, block)
    nb = T // block
    idx, valid = _row_walk(layout, q.device)
    qb = q.reshape(B, H, nb, block, d)
    kg = _gather_blocks(k.reshape(B, H, nb, block, d), idx)
    vg = _gather_blocks(v.reshape(B, H, nb, block, d), idx)
    keep = _row_keep(idx, valid, block, causal)  # (1, LH, nb, block, deg, block)
    s = torch.einsum("bhnqd,bhnekd->bhnqek", qb.float(), kg.float()) * sm_scale
    s = torch.where(keep, s, torch.full((), DEFAULT_MASK_VALUE, device=q.device))
    m = s.amax(dim=(-2, -1), keepdim=True)
    p = torch.exp(s - m) * keep
    del s
    l = p.sum(dim=(-2, -1), keepdim=True)
    acc = torch.einsum("bhnqek,bhnekd->bhnqd", p.to(v.dtype).float(), vg.float())
    del p
    l, m = l[..., 0, 0], m[..., 0, 0]  # (B, H, nb, block)
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, float("inf")), m + torch.log(l.clamp_min(1e-37)))
    return out.reshape(B, H, T, d), lse.reshape(B, H, T)


def _bwd_p_ds(qe, ge, ke, ve, lse_e, delta_e, keep, sm_scale: float):
    """The backward kernels' shared P/dS rebuild on gathered tiles (query
    rows ``qe``, ``ge``, ``lse_e``, ``delta_e`` against key rows ``ke``,
    ``ve``, ``...qd`` against ``...kd``): ``P = exp(S - lse)`` with the
    keep mask applied again (lse is +inf for a row with no active block,
    so its p is exactly 0), ``dS = P (dP - delta) scale``.  f32."""
    s = torch.einsum("...qd,...kd->...qk", qe.float(), ke.float()) * sm_scale
    s = torch.where(keep, s, torch.full((), DEFAULT_MASK_VALUE, device=s.device))
    p = torch.exp(s - lse_e[..., None]) * keep
    del s
    dp = torch.einsum("...qd,...kd->...qk", ge.float(), ve.float())
    ds = p * (dp - delta_e[..., None]) * sm_scale
    return p, ds


def splash_bwd_dq_reference(q, k, v, do, lse, delta, layout: np.ndarray, block: int,
                            causal: bool, sm_scale: float) -> torch.Tensor:
    """Plain version of B9a (the Pallas ``_splash_dq_kernel``): the row
    walk of the forward, ``dq = dS k`` with dS rounded to k's type, summed
    in f32, in q's type.  ``lse``, ``delta``: (B, H, T) f32."""
    B, H, T, d = q.shape
    _check_layout("splash_bwd_dq_reference", layout, H, T, block)
    nb = T // block
    idx, valid = _row_walk(layout, q.device)
    deg = idx.shape[-1]
    kg = _gather_blocks(k.reshape(B, H, nb, block, d), idx)  # (B, H, nb, deg, block, d)
    vg = _gather_blocks(v.reshape(B, H, nb, block, d), idx)
    # each row's query tile against each of its deg key tiles
    keep = _row_keep(idx, valid, block, causal).permute(0, 1, 2, 4, 3, 5)  # (1, LH, nb, deg, bq, bk)
    rows = (t.reshape(B, H, nb, 1, block, d).expand(B, H, nb, deg, block, d) for t in (q, do))
    qe, ge = rows
    lse_e, delta_e = (t.reshape(B, H, nb, 1, block).expand(B, H, nb, deg, block)
                      for t in (lse, delta))
    _, ds = _bwd_p_ds(qe, ge, kg, vg, lse_e, delta_e, keep, sm_scale)
    dq = torch.einsum("bhneqk,bhnekd->bhnqd", ds.to(k.dtype).float(), kg.float())
    return dq.reshape(B, H, T, d).to(q.dtype)


def splash_bwd_dkv_reference(q, k, v, do, lse, delta, layout: np.ndarray, block: int,
                             causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B9b (the Pallas ``_splash_dkv_kernel``): over the
    column-sorted edge list (:func:`_layout_dkv_edges`), ``dk = dSᵀ q``
    (dS rounded to q's type) and ``dv = Pᵀ dO`` (P rounded to dO's type),
    each summed per key block in f32 in edge order; an untouched column's
    placeholder edge adds exact zeros.  Returns ``(dk, dv)``."""
    B, H, T, d = q.shape
    _check_layout("splash_bwd_dkv_reference", layout, H, T, block)
    nb = T // block
    dev = q.device
    qidx_np, kcol_np, flags_np = _layout_dkv_edges(_splash_layout(layout))
    qidx = torch.as_tensor(qidx_np, dtype=torch.long, device=dev)  # (LH, E)
    kcol = torch.as_tensor(kcol_np, dtype=torch.long, device=dev)
    ok = torch.as_tensor(flags_np & 1 == 1, device=dev)
    E = qidx.shape[1]

    def blocks(t):
        return t.reshape(B, H, nb, block, *t.shape[3:])

    qe, ge = _gather_blocks(blocks(q), qidx), _gather_blocks(blocks(do), qidx)  # (B, H, E, block, d)
    ke, ve = _gather_blocks(blocks(k), kcol), _gather_blocks(blocks(v), kcol)
    lse_e = _gather_blocks(lse.reshape(B, H, nb, block), qidx)  # (B, H, E, block)
    delta_e = _gather_blocks(delta.reshape(B, H, nb, block), qidx)
    keep = _edge_keep(ok, qidx, kcol, block, causal)[None]  # (1, LH, E, block, block)
    p, ds = _bwd_p_ds(qe, ge, ke, ve, lse_e, delta_e, keep, sm_scale)
    dk_e = torch.einsum("bheqk,bheqd->bhekd", ds.to(q.dtype).float(), qe.float())
    del ds
    dv_e = torch.einsum("bheqk,bheqd->bhekd", p.to(do.dtype).float(), ge.float())
    del p
    # sum each edge's share into its column, in edge order
    col = (torch.arange(H, device=dev)[:, None] * nb + kcol.expand(H, E)).reshape(-1)
    out = []
    for share, like in ((dk_e, k), (dv_e, v)):
        acc = torch.zeros((B, H * nb, block, d), dtype=torch.float32, device=dev)
        acc.index_add_(1, col, share.reshape(B, H * E, block, d))
        out.append(acc.reshape(B, H, T, d).to(like.dtype))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# What the kernels are held to (the card tests and chip_smoke.py)
# ---------------------------------------------------------------------------

# (head, key block) pairs that no row of check_layouts()' "untouched-columns" attends
UNTOUCHED_COLUMNS = ((0, 2), (0, 3), (1, 1), (1, 3))


def check_layouts(nb: int) -> dict:
    """Two-head layouts (``nb >= 4``) that no config makes at small nb:
    ``per-head`` (head 0 a window of 2, head 1 a global column and the
    diagonal: the per-head index form), ``untouched-columns`` (every row
    on column 0, head 0 also (1, 1), head 1 also (2, 2): the key blocks of
    ``UNTOUCHED_COLUMNS`` have no edge) and ``zero-degree-row`` (a window
    of 2 with row 1 of head 0 and row 2 of head 1 empty)."""
    per_head = np.zeros((2, nb, nb), np.uint8)
    zero_row = np.zeros((2, nb, nb), np.uint8)
    for r in range(nb):
        per_head[0, r, max(0, r - 1): r + 1] = 1
        per_head[1, r, 0] = per_head[1, r, r] = 1
        zero_row[:, r, max(0, r - 1): r + 1] = 1
    zero_row[0, 1] = 0
    zero_row[1, 2] = 0
    untouched = np.zeros((2, nb, nb), np.uint8)
    untouched[:, :, 0] = 1
    untouched[0, 1, 1] = 1
    untouched[1, 2, 2] = 1
    return {"per-head": np.tril(per_head), "untouched-columns": untouched,
            "zero-degree-row": zero_row}


def _allowed_scores(layout: np.ndarray, block: int, dev) -> torch.Tensor:
    """(1, LH, T, T) bool: the scores the splash kernels compute, the
    layout's active blocks less the dense rows (:func:`_dense_row_mask`,
    which the kernels leave to the dense path) expanded to (T, T)."""
    layout = _splash_layout(layout)
    active = (layout != 0) & ~_dense_row_mask(layout, exempt_uniform_full=True)[:, :, None]
    allowed = torch.as_tensor(active, device=dev)
    return allowed.repeat_interleave(block, 1).repeat_interleave(block, 2)[None]


def splash_fwd_float64(q, k, v, layout: np.ndarray, block: int, causal: bool, sm_scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The splash forward's function in float64 on the same inputs, nothing
    rounded: ``flash_fwd_float64`` over the scores the kernels compute
    (:func:`_allowed_scores`), causal inside diagonal blocks.  Returns
    ``(out, lse)``, float64; a row with no block gives out 0, lse +inf."""
    return _fa.flash_fwd_float64(q, k, v, causal, sm_scale,
                                 allowed=_allowed_scores(layout, block, q.device))


def splash_bwd_float64(q, k, v, do, lse, delta, layout: np.ndarray, block: int, causal: bool,
                       sm_scale: float):
    """The splash backward's function in float64 on the same inputs, and
    the bound of the bf16 contract around it: ``flash_bwd_float64`` over
    the scores the kernels compute, the layout's active blocks less the
    dense rows (:func:`_dense_row_mask`, which the kernels leave to
    autograd) expanded to (T, T), causal inside diagonal blocks.  Returns
    ``((dq, dk, dv), (bound_dq, bound_dk, bound_dv))``, float64; held with
    ``flash_attention.float64_over_bound``."""
    return _fa.flash_bwd_float64(q, k, v, do, lse, delta, causal, sm_scale,
                                 allowed=_allowed_scores(layout, block, q.device))


def splash_grad_bound(grad: str, ref: torch.Tensor, layout: np.ndarray, block: int, tol: float,
                      share: float = 0.5) -> Tuple[torch.Tensor, float]:
    """The entry-by-entry bound a splash gradient ``grad`` ("dq", "dk" or
    "dv") is held to against ``ref``: ``tol * (|ref| + s * rms)``, rms that
    of the entry's own layout block of ``ref`` (its query block for dq,
    its key block for dk and dv), s = ``share`` grown as the square root
    of that block's sum past 1,024 terms.  Per block, because the sums are
    not alike: a key block of BigBird's global column sums every row's
    share (T terms, entries far above the tensor's rms), a query block its
    row's few blocks.  Returns ``(bound, largest s)``, the bound f32 of
    ``ref``'s shape."""
    active = (layout != 0) & ~_dense_row_mask(layout, True)[:, :, None]
    B, H, T, d = ref.shape
    r = ref.float().reshape(B, H, T // block, block * d)
    terms = active.sum(-1 if grad == "dq" else -2) * block  # (H or 1, nb)
    s = share * (torch.as_tensor(terms, dtype=torch.float32, device=ref.device) / 1024
                 ).clamp_min(1.0).sqrt()[None, :, :, None]
    bound = tol * (r.abs() + s * r.square().mean(-1, keepdim=True).sqrt())
    return bound.reshape(B, H, T, d), float(s.max())


# ---------------------------------------------------------------------------
# The kernels (csrc/splash_attn.cu) and their dispatchers
# ---------------------------------------------------------------------------


def _check_tensors(who: str, layout, block, q, k, v, do=None, lse=None, delta=None) -> None:
    """Refuse what the kernels do not take: q, k, v (and dO) of one shape
    (B, H, T, d) and type, f32 (B, H, T) lse and delta, a head dim of
    ``_HEAD_DIMS``, a layout of (H or 1, T / block, T / block), every
    tensor contiguous on one CUDA device."""
    if q.ndim != 4:
        raise ValueError(f"{who}: q must be (B, H, T, d), got {tuple(q.shape)}")
    b, h, t, d = q.shape
    operands = {"q": q, "k": k, "v": v, **({"dO": do} if do is not None else {})}
    rows = {name: x for name, x in (("lse", lse), ("delta", delta)) if x is not None}
    for name, x in operands.items():
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{who}: {name} must be {q.dtype} {tuple(q.shape)} like q, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for name, x in rows.items():
        if x.shape != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"{who}: {name} must be float32 (B, H, T) = ({b}, {h}, {t}), got "
                             f"{x.dtype} {tuple(x.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{who}: q/k/v dtype {q.dtype} not in {list(_DTYPE_CODES)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{who}: head_dim {d} not in {_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"{who}: B*H = {b * h} exceeds the grid's 65535")
    _check_layout(who, layout, h, t, block)
    for name, x in {**operands, **rows}.items():
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{who}: {name} lies on {x.device}, need the CUDA device {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def splash_cost(name: str, q, layout: np.ndarray, block: int, causal: bool):
    """``(flops, bytes)`` of one launch of B8, B9a or B9b (``name`` as the
    dense pass it mirrors: ``flash_fwd``, ``flash_bwd_dq``,
    ``flash_bwd_dkv``), the dense formulas over the (query, key) pairs the
    layout's live tiles hold (a causal diagonal tile half of them)."""
    b, h, t, d = q.shape
    lay = np.asarray(layout).astype(bool)
    lay = np.broadcast_to(lay, (h,) + lay.shape[1:]) if lay.shape[0] == 1 else lay
    nb = lay.shape[-1]
    diag = int(sum(lay[:, i, i].sum() for i in range(nb)))
    full = block * block
    if causal:
        below = int(sum(np.tril(x, -1).sum() for x in lay))
        pairs = below * full + diag * block * (block + 1) / 2.0
    else:
        pairs = float(lay.sum()) * full
    prods, q_rows, k_rows = _fa._ATTN_PASSES[name]
    flops = prods * d * pairs * b
    nbytes = (q_rows + k_rows) * t * b * h * d * q.element_size()
    nbytes += (4 if name == "flash_fwd" else 8) * b * h * t
    return flops, nbytes


def _kernel_arrays(layout: np.ndarray, dev):
    return _kernel_arrays_cached(*_layout_key(layout), str(dev))


def _geometry(q, layout: np.ndarray, block: int):
    """The kernels' shape arguments: BH, H, LH, T, block."""
    b, h, t, _ = q.shape
    return b * h, h, _splash_layout(layout).shape[0], t, int(block)


def splash_fwd_cuda(q, k, v, layout: np.ndarray, block: int, causal: bool, sm_scale: float,
                    want_lse: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch B8 on the current stream, the body by dtype
    (:func:`_splash_body`): ``(out, lse or None)``.  Each row sums its
    listed key tiles in the layout's order and is written once (no atomics,
    so the same bits every launch).  Raises for tensors that are not on one
    CUDA device, not contiguous, or of a type or shape the kernel does not
    take."""
    _check_tensors("splash_fwd_cuda", layout, block, q, k, v)
    b, h, t, d = q.shape
    idx, valid, deg, _ = _kernel_arrays(layout, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if want_lse else None
    entry, body = _splash_body("splash_fwd_cuda", "splash_fwd", q, k, v, out)
    lib = _kernels.library()
    err = lib.fn(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None, idx.data_ptr(), valid.data_ptr(),
        *_geometry(q, layout, block), deg, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    lib.check(entry, err)
    _kernels.count_launch("splash_fwd", "none/" + body,
                          cost=lambda: splash_cost("flash_fwd", q, layout, block, causal))
    return out, lse


def _splash_body(who: str, name: str, q, k, v, x) -> Tuple[str, str]:
    """``(library entry, body)`` of B8, B9a or B9b for q's type, as B2's:
    bf16 the tensor-core body (``csrc/splash_attn_tc.cu``), which refuses a
    view off a 16-byte boundary (``x``: B8's out, the backward's dO), f32
    the CUDA-core one (``csrc/splash_attn.cu``)."""
    entry, body = _fa._body(name, q.dtype)
    if body == "tc":
        _fa._check_aligned(who, ("q", q), ("k", k), ("v", v),
                           ("out" if name == "splash_fwd" else "dO", x))
    return entry, body


def splash_bwd_dq_cuda(q, k, v, do, lse, delta, layout: np.ndarray, block: int, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    """Launch B9a on the current stream, the body by dtype
    (:func:`_splash_body`): dq summed in registers over the row's edges in
    a fixed order and written once (no atomics, so the same bits every
    launch)."""
    _check_tensors("splash_bwd_dq_cuda", layout, block, q, k, v, do, lse, delta)
    entry, body = _splash_body("splash_bwd_dq_cuda", "splash_bwd_dq", q, k, v, do)
    d = q.shape[-1]
    idx, valid, deg, _ = _kernel_arrays(layout, q.device)
    dq = torch.empty_like(q)
    lib = _kernels.library()
    err = lib.fn(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), idx.data_ptr(), valid.data_ptr(),
        *_geometry(q, layout, block), deg, d, _DTYPE_CODES[q.dtype], int(bool(causal)),
        float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    lib.check(entry, err)
    _kernels.count_launch("splash_bwd_dq", "none/" + body,
                          cost=lambda: splash_cost("flash_bwd_dq", q, layout, block, causal))
    return dq


def splash_bwd_dkv_cuda(q, k, v, do, lse, delta, layout: np.ndarray, block: int, causal: bool,
                        sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B9b on the current stream, the body by dtype
    (:func:`_splash_body`): one block per (64-key tile, work item) walks an
    item's piece of its column's run of the column-sorted edge list (at
    most ``deg`` query blocks, :func:`_dkv_items`), dk and dv summed in
    registers; a second kernel sums each column's f32 partials (B*H, W,
    block, d) in item order and writes dk and dv once (an untouched column
    gets zeros; no atomics, so the same bits every launch).  The f32 body
    sends every item through the partials, the tensor-core body only the
    items of a column cut into several (a column of one item writes its
    dk and dv directly).  Returns ``(dk, dv)``."""
    _check_tensors("splash_bwd_dkv_cuda", layout, block, q, k, v, do, lse, delta)
    entry, body = _splash_body("splash_bwd_dkv_cuda", "splash_bwd_dkv", q, k, v, do)
    b, h, t, d = q.shape
    _, _, _, (qidx, flags, item_col, item_off, col_items) = _kernel_arrays(layout, q.device)
    W = item_col.shape[1]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    partials = torch.empty((2, b * h, W, block, d), dtype=torch.float32, device=q.device)
    lib = _kernels.library()
    err = lib.fn(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), partials[0].data_ptr(),
        partials[1].data_ptr(), qidx.data_ptr(), flags.data_ptr(), item_col.data_ptr(),
        item_off.data_ptr(), col_items.data_ptr(), *_geometry(q, layout, block), qidx.shape[1],
        W, d, _DTYPE_CODES[q.dtype], int(bool(causal)), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    lib.check(entry, err)
    _kernels.count_launch("splash_bwd_dkv", "none/" + body,
                          cost=lambda: splash_cost("flash_bwd_dkv", q, layout, block, causal))
    return dk, dv


def splash_fwd(q, k, v, layout: np.ndarray, block: int, causal: bool, sm_scale: float,
               want_lse: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B8's function: ``(out, lse or None)``.  CUDA tensors take the
    kernel, CPU tensors the plain version."""
    if q.device.type == "cpu":
        out, lse = splash_fwd_reference(q, k, v, layout, block, causal, sm_scale)
        return out, (lse if want_lse else None)
    return splash_fwd_cuda(q, k, v, layout, block, causal, sm_scale, want_lse=want_lse)


def splash_bwd_dq(q, k, v, do, lse, delta, layout: np.ndarray, block: int, causal: bool,
                  sm_scale: float) -> torch.Tensor:
    """B9a's function: dq.  CUDA tensors take the kernel, CPU tensors the
    plain version."""
    args = (q, k, v, do, lse, delta, layout, block, causal, sm_scale)
    if q.device.type == "cpu":
        return splash_bwd_dq_reference(*args)
    return splash_bwd_dq_cuda(*args)


def splash_bwd_dkv(q, k, v, do, lse, delta, layout: np.ndarray, block: int, causal: bool,
                   sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9b's function: ``(dk, dv)``.  CUDA tensors take the kernel, CPU
    tensors the plain version."""
    args = (q, k, v, do, lse, delta, layout, block, causal, sm_scale)
    if q.device.type == "cpu":
        return splash_bwd_dkv_reference(*args)
    return splash_bwd_dkv_cuda(*args)


class _SplashAttention(torch.autograd.Function):
    """The splash kernels with their kernel backward (the JAX package's
    ``_splash_attention`` custom_vjp): the forward keeps ``(q, k, v, out,
    lse)``; the backward forms ``delta = rowsum(dO * O)`` in f32 as plain
    torch, then runs B9a (dq) and B9b (dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block: int, causal: bool, sm_scale: float):
        out, lse = forward_residuals(lambda: splash_fwd(q, k, v, layout, block, causal, sm_scale,
                                                        want_lse=True))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (layout, block, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = splash_bwd_dq(q, k, v, g, lse, delta, *ctx.args)
        dk, dv = splash_bwd_dkv(q, k, v, g, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


def splash_attention(q, k, v, layout: np.ndarray, block: int, causal: bool = False,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention through the splash kernels, differentiable.

    The sparse rows run :class:`_SplashAttention` when a gradient is
    wanted, the forward kernel alone without ``lse`` otherwise (the JAX
    package's primal); the few full-degree rows are overwritten by
    :func:`_apply_dense_rows` outside it, so autograd differentiates them
    and the kernels never pad every row's degree up to nb."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _SplashAttention.apply(q, k, v, layout, int(block), bool(causal), float(sm_scale))
    else:
        out = splash_fwd(q, k, v, layout, int(block), bool(causal), float(sm_scale))[0]
    _idx, _valid, drows_np, dvalid_np = _layout_gather_indices(layout, exempt_uniform_full=True)
    if drows_np.shape[1] > 0:
        out = _apply_dense_rows(out, q, k, v, drows_np, dvalid_np, block, causal, sm_scale, None)
    return out


# ---------------------------------------------------------------------------
# Module-level wrappers
# ---------------------------------------------------------------------------


class SparseSelfAttention:
    """Holds a sparsity config, caches one layout per sequence length and
    applies block-sparse attention to projected q/k/v in (B, H, T, hd)."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add", attn_mask_mode: str = "mul"):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self._layouts = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.sparsity_config.make_layout(seq_len)
        return self._layouts[seq_len]

    def __call__(self, query, key, value, key_padding_mask=None, causal: Optional[bool] = None):
        T = query.shape[2]
        layout = self.get_layout(T)
        if causal is None:
            causal = getattr(self.sparsity_config, "attention", "bidirectional") == "unidirectional"
        return block_sparse_attention(
            query, key, value, layout, self.sparsity_config.block,
            causal=causal, key_padding_mask=key_padding_mask,
        )


class SparseAttentionUtils:
    """Helpers for running a model at a block-aligned length."""

    @staticmethod
    def extend_position_embedding(pos_emb: np.ndarray, new_len: int) -> np.ndarray:
        """Tile an existing position table to a longer sequence."""
        cur = pos_emb.shape[0]
        reps = -(-new_len // cur)
        return np.concatenate([pos_emb] * reps, axis=0)[:new_len]

    @staticmethod
    def pad_to_block_size(block: int, tokens: np.ndarray, pad_token_id: int = 0):
        """Right-pad (B, T) token ids to a multiple of ``block``; returns
        ``(padded_tokens, attention_mask, pad_len)``."""
        B, T = tokens.shape
        pad = (-T) % block
        if pad == 0:
            return tokens, np.ones((B, T), np.int32), 0
        padded = np.concatenate([tokens, np.full((B, pad), pad_token_id, tokens.dtype)], axis=1)
        mask = np.concatenate([np.ones((B, T), np.int32), np.zeros((B, pad), np.int32)], axis=1)
        return padded, mask, pad

    @staticmethod
    def unpad_sequence_output(pad_len: int, out):
        return out[:, : out.shape[1] - pad_len] if pad_len else out
