"""Single-query flash decode over the slot-pool and the paged KV layouts
(counterpart of ``deepspeed_tpu/ops/kernels/flash_decode.py``).

Contract (the same as the JAX kernels'):

* ``q``: (B, H, 1, d) — one query per slot (decode step).
* slot caches (B4): (B, H, S, d) tensors in ``q``'s type, or the int8
  pair ``{"q": int8 codes, "s": (B, H, S, 1) f32 scales}`` from
  ``init_kv_cache``.
* page pools (B5): (num_pages, H, page_len, d) in the same forms, with a
  (B, P) int32 ``page_table``: key ``j`` of slot ``b`` lives at page
  ``page_table[b, j // page_len]``, row ``j % page_len``.
* ``pos``: scalar or per-slot (B,) write offsets; key ``j`` is
  attendable iff ``j <= pos[b]`` (serving writes the token's K/V before
  it attends).
* ``key_padding_mask`` (slot caches only): optional (B, S), True =
  attendable.

:func:`flash_decode` and :func:`flash_decode_paged` launch the CUDA
kernels (``csrc/flash_decode.cu``, one body for both) for CUDA tensors
and run :func:`flash_decode_reference` / :func:`flash_decode_paged_reference`,
the plain PyTorch versions of the same functions, for CPU tensors.  The
kernels split each row's keys into chunks of :data:`DECODE_CHUNK`, one
block each, and combine the chunks' softmax states in chunk order;
:func:`flash_decode_split_reference` does that arithmetic in PyTorch (the
tests and the card check hold the kernel to it; no path runs it).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import kernels as _kernels
from deepspeed_tpu_torch.ops.attention.flash_attention import _check_aligned

# Same mask constant as the JAX version: fully-masked rows degrade to a
# uniform softmax instead of NaN (the garbage rows of idle slots).
NEG_INF = -1e30

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the head dims the kernel serves: a lane loads 16 bytes of a row, so a
# row is a power-of-two count of lanes for every cache type
_HEAD_DIMS = (16, 32, 64, 128)
# keys a block of the kernel takes (csrc/flash_decode.cu's kChunk): each
# row's keys split into chunks of this many, combined in chunk order
DECODE_CHUNK = 128


def decode_supported(B: int, H: int, S: int, d: int) -> bool:
    """Shapes the CUDA kernel serves: any cache length, head_dim 16, 32, 64
    or 128, at most 65535 slot-heads.  (The TPU grid needed ``S % 128 ==
    0``; the Hopper kernel masks past ``pos`` and the cache's end itself.)"""
    return B >= 1 and H >= 1 and S >= 1 and d in _HEAD_DIMS and B * H <= 65535


def decode_paged_supported(B: int, H: int, P: int, page_len: int, d: int) -> bool:
    """Paged shapes the CUDA kernel serves: any ``page_len >= 1``, head_dim
    16, 32, 64 or 128, and a logical cache ``P * page_len`` below 2**31.
    (The TPU kernel took one page as one kv block and needed ``page_len %
    128 == 0``; the Hopper kernel stages the page-table entries of its own
    chunk of keys.)"""
    return (decode_supported(B, H, P * page_len, d) and P >= 1 and page_len >= 1
            and P * page_len < 2 ** 31)


def _per_slot(pos) -> bool:
    """True when ``pos`` is a per-example (B,) write-offset vector (the
    slot-pool form) rather than a Python int or a 0-dim tensor."""
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def flash_decode_reference(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                           key_padding_mask=None) -> torch.Tensor:
    """Plain PyTorch attention of queries (B, H, T, d) against a static
    cache (B, H, S, d): the body of ``cache_attention`` in the JAX package
    (any T).  Query ``i`` attends keys ``j <= pos + i``.  q, k and v are
    widened to f32; int8 scales apply outside the dots."""
    quant = isinstance(k_cache, dict)
    if quant:
        k_scale = k_cache["s"][..., 0][:, :, None, :]  # (B, H, 1, S)
        v_scale = v_cache["s"][..., 0][:, :, None, :]
        k_op, v_op = k_cache["q"], v_cache["q"]
    else:
        k_op, v_op = k_cache, v_cache
    B, H, T, d = q.shape
    S = k_op.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k_op.float()) * sm_scale
    if quant:
        s = s * k_scale
    key_idx = torch.arange(S, device=q.device)[None, None, None, :]
    if _per_slot(pos):
        pos_off = pos.to(q.device, torch.int64)[:, None, None, None]
    else:
        pos_off = pos  # Python int or 0-dim tensor broadcast
    q_idx = pos_off + torch.arange(T, device=q.device)[None, None, :, None]
    allowed = key_idx <= q_idx
    if key_padding_mask is not None:
        allowed = allowed & key_padding_mask[:, None, None, :].to(q.device, torch.bool)
    s = torch.where(allowed, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * v_scale
    out = torch.einsum("bhts,bhsd->bhtd", p, v_op.float())
    return out.to(q.dtype)


def flash_decode_split_reference(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                                 key_padding_mask=None, chunk: int = DECODE_CHUNK) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, for the tests and the card
    check (no path runs it): one query a slot (B, H, 1, d) against a slot
    cache.  Row b takes keys ``[0, n_b)``, ``n_b = pos[b] + 1`` (at most S)
    where it has an attendable key, else all S (every score masked at
    ``NEG_INF``: uniform).  Those keys are cut into chunks of ``chunk``;
    each chunk's softmax state is formed on its own (f32 scores from the
    widened operands, the int8 key scale after ``sm_scale``, the value scale
    on p before the value sum, l the sum of p): ``m_c``, ``l_c``, ``acc_c``;
    a chunk past ``n_b`` holds nothing.  The states combine in chunk order,
    ``out = sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c``.  A chunk of
    masked keys in a row with a real key weighs e^(-1e30 - M) = 0.
    Returns (B, H, 1, d) in q's type."""
    quant = isinstance(k_cache, dict)
    k_op = k_cache["q"] if quant else k_cache
    v_op = v_cache["q"] if quant else v_cache
    B, H, T, d = q.shape
    if T != 1:
        raise ValueError(f"flash_decode_split_reference takes one query per slot, got T={T}")
    S = k_op.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    dev = q.device
    s = torch.einsum("bhd,bhsd->bhs", q[:, :, 0].float(), k_op.float()) * sm_scale
    if quant:
        s = s * k_cache["s"][..., 0]
    key = torch.arange(S, device=dev)
    last = _pos_vector(pos, B, dev).long().clamp(max=S - 1)
    allowed = key[None] <= last[:, None]  # (B, S)
    if key_padding_mask is not None:
        allowed = allowed & key_padding_mask.to(dev, torch.bool)
    n = torch.where(allowed.any(-1), last + 1, torch.full_like(last, S))
    s = torch.where(allowed[:, None], s, torch.full((), NEG_INF, device=dev))
    C = -(-S // chunk)
    pad = C * chunk - S
    v = v_op.float()
    if quant:
        v_scale = v_cache["s"][..., 0]  # (B, H, S)
    if pad:
        s = torch.cat([s, s.new_zeros(B, H, pad)], -1)
        v = torch.cat([v, v.new_zeros(B, H, pad, d)], 2)
        if quant:
            v_scale = torch.cat([v_scale, v_scale.new_zeros(B, H, pad)], -1)
    inside = (torch.arange(C * chunk, device=dev)[None] < n[:, None]).view(B, 1, C, chunk)
    sc = s.view(B, H, C, chunk)
    m = torch.where(inside, sc, torch.full((), -math.inf, device=dev)).amax(-1)  # (B, H, C)
    has = torch.isfinite(m)
    m0 = torch.where(has, m, torch.zeros_like(m))
    p = torch.where(inside, torch.exp(sc - m0[..., None]), torch.zeros_like(sc))
    l = p.sum(-1)
    if quant:
        p = p * v_scale.view(B, H, C, chunk)
    acc = torch.einsum("bhck,bhckd->bhcd", p, v.view(B, H, C, chunk, d))
    big = m.amax(-1, keepdim=True)  # finite: the first chunk always holds a key
    w = torch.where(has, torch.exp(m0 - big), torch.zeros_like(m0))
    tot_l = (w * l).sum(-1)
    tot_a = (w[..., None] * acc).sum(-2)
    out = tot_a / torch.where(tot_l == 0, torch.ones_like(tot_l), tot_l)[..., None]
    return out[:, :, None].to(q.dtype)


def paged_gather(cache, page_table: torch.Tensor):
    """The logical slot view of a page pool: gather ``cache`` (num_pages,
    H, page_len, d) — or the int8 ``{"q", "s"}`` pair — through
    ``page_table`` (B, P) into the contiguous (B, H, P * page_len, d)
    layout of a slot cache.  Unused table entries point at the garbage
    page, whose rows lie behind the position mask."""
    B, P = page_table.shape

    def g(buf):
        t = buf[page_table.reshape(-1).to(buf.device, torch.int64)]   # (B*P, H, pl, x)
        t = t.reshape(B, P, buf.shape[1], buf.shape[2], buf.shape[3])
        return t.permute(0, 2, 1, 3, 4).reshape(B, buf.shape[1], P * buf.shape[2], buf.shape[3])

    if isinstance(cache, dict):
        return {name: g(buf) for name, buf in cache.items()}
    return g(cache)


def flash_decode_paged_reference(q, k_cache, v_cache, page_table, pos,
                                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch paged attention: :func:`paged_gather` of both pools,
    then :func:`flash_decode_reference` over the gathered view (the JAX
    package's ground truth in ``paged_cache_attention``; any T)."""
    return flash_decode_reference(q, paged_gather(k_cache, page_table),
                                  paged_gather(v_cache, page_table), pos, sm_scale)


def _check_cuda(name: str, t: torch.Tensor, device: torch.device,
                fn: str = "flash_decode_cuda") -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn}: {name} lies on {t.device}, not on a CUDA device")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, q on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _workspace(B: int, H: int, S: int, d: int, dev) -> torch.Tensor:
    """The kernel's f32 records (B*H, splits, d + 2): each chunk's acc, m
    and l, allocated on the stream (no host sync)."""
    return torch.empty((B * H, -(-S // DECODE_CHUNK), d + 2), dtype=torch.float32, device=dev)


def _pos_vector(pos, B: int, dev) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=dev, dtype=torch.int32).reshape(-1).expand(B).contiguous()
    return torch.full((B,), int(pos), dtype=torch.int32, device=dev)


def decode_cost(q, kv_item: int, pos_vec, S: int, kpm=None, quant: bool = False,
                table_bytes: int = 0):
    """``(flops, bytes)`` of one decode launch, the formula of its bound in
    ``PERF.md``: each attendable K and V row once (all S rows of a slot
    with no attendable key), q, out, the positions, and the int8 scales,
    the mask prefix and the page table where present.  Reads the
    positions (and the mask) back to the host: a counted step's cost,
    never a served step's."""
    B, H, _, d = q.shape
    pos = pos_vec.tolist()
    rows = 0
    for b in range(B):
        n = min(int(pos[b]), S - 1) + 1
        if kpm is not None and not bool(kpm[b, :n].any()):
            n = S
        rows += n
    nbytes = rows * H * d * 2 * kv_item + 2 * B * H * d * q.element_size() + 4 * B
    if quant:
        nbytes += rows * H * 2 * 4
    if kpm is not None:
        nbytes += rows
    return 4 * rows * H * d, nbytes + table_bytes


def flash_decode_cuda(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                      key_padding_mask=None) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/flash_decode.cu``: the split over
    keys, then the combine, on the current stream).  Raises for tensors
    that are not on one CUDA device, not contiguous, a cache off a 16-byte
    boundary, or of a type or shape the kernel does not take."""
    quant = isinstance(k_cache, dict)
    k_op = k_cache["q"] if quant else k_cache
    v_op = v_cache["q"] if quant else v_cache
    if q.ndim != 4:
        raise ValueError(f"flash_decode_cuda: q must be (B, H, 1, d), got {tuple(q.shape)}")
    B, H, T, d = q.shape
    if T != 1:
        raise ValueError(f"flash_decode serves exactly one query per slot, got T={T}")
    S = k_op.shape[2]
    if k_op.shape != (B, H, S, d) or v_op.shape != (B, H, S, d):
        raise ValueError(
            f"flash_decode_cuda: caches must be (B, H, S, d) = ({B}, {H}, S, {d}), "
            f"got {tuple(k_op.shape)} / {tuple(v_op.shape)}"
        )
    if not decode_supported(B, H, S, d):
        raise ValueError(f"flash_decode_cuda cannot serve (B={B}, H={H}, S={S}, d={d})")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"flash_decode_cuda: q dtype {q.dtype} not in {list(_Q_CODES)}")
    if quant:
        if k_op.dtype != torch.int8 or v_op.dtype != torch.int8:
            raise ValueError("flash_decode_cuda: int8 caches need int8 codes")
        for nm, sc in (("k scales", k_cache["s"]), ("v scales", v_cache["s"])):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (B, H, S, 1):
                raise ValueError(f"flash_decode_cuda: {nm} must be f32 (B, H, S, 1)")
    elif k_op.dtype != q.dtype or v_op.dtype != q.dtype:
        raise ValueError(
            f"flash_decode_cuda: cache dtype {k_op.dtype}/{v_op.dtype} must equal q's {q.dtype}"
        )
    dev = q.device
    for nm, t in (("q", q), ("k_cache", k_op), ("v_cache", v_op)):
        _check_cuda(nm, t, dev)
    ks = vs = None
    if quant:
        ks, vs = k_cache["s"], v_cache["s"]
        _check_cuda("k scales", ks, dev)
        _check_cuda("v scales", vs, dev)
    pos_vec = _pos_vector(pos, B, dev)
    kpm = None
    if key_padding_mask is not None:
        if tuple(key_padding_mask.shape) != (B, S):
            raise ValueError(
                f"flash_decode_cuda: key_padding_mask must be (B, S) = ({B}, {S}), "
                f"got {tuple(key_padding_mask.shape)}"
            )
        kpm = key_padding_mask
        # the kernel reads one byte a key (nonzero = attendable): a
        # contiguous bool or uint8 mask on the device is read in place
        if (kpm.dtype not in (torch.bool, torch.uint8) or kpm.device != dev
                or not kpm.is_contiguous()):
            kpm = (kpm.to(dev) != 0).to(torch.uint8).contiguous()
    _check_aligned("flash_decode_cuda", ("k_cache", k_op), ("v_cache", v_op))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty((B, H, 1, d), dtype=q.dtype, device=dev)
    ws = _workspace(B, H, S, d, dev)
    lib = _kernels.library()
    fn = lib.fn("flash_decode")
    err = fn(
        q.data_ptr(), k_op.data_ptr(), v_op.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        pos_vec.data_ptr(), kpm.data_ptr() if kpm is not None else None,
        ws.data_ptr(), out.data_ptr(), B, H, S, ws.shape[1], d, _Q_CODES[q.dtype],
        _KV_CODES[k_op.dtype], float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_decode", err)
    _kernels.count_launch("flash_decode", cost=lambda: decode_cost(
        q, k_op.element_size(), pos_vec, S, kpm=kpm, quant=quant))
    return out


def flash_decode(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                 key_padding_mask=None) -> torch.Tensor:
    """Single-query attention against a slot cache; see module docs.
    Returns (B, H, 1, d) in ``q.dtype``.  CUDA tensors take the kernel,
    CPU tensors the plain version."""
    if q.shape[2] != 1:
        raise ValueError(f"flash_decode serves exactly one query per slot, got T={q.shape[2]}")
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, pos, sm_scale, key_padding_mask)
    return flash_decode_cuda(q, k_cache, v_cache, pos, sm_scale, key_padding_mask)


def flash_decode_paged_cuda(q, k_cache, v_cache, page_table, pos,
                            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch the paged CUDA kernel (``csrc/flash_decode.cu``,
    ``ds_flash_decode_paged``: B4's body and combine) on the current
    stream.  Raises for tensors that are not on one CUDA device, not
    contiguous, a pool off a 16-byte boundary, or of a type or shape the
    kernel does not take.  The page table must be int32 (B, P) with
    entries in ``[0, num_pages)`` (checking that on the host would cost a
    device sync a step; the kernel clamps other entries into the pool, so
    a wrong table reads wrong pages, never memory outside the pool)."""
    fn_name = "flash_decode_paged_cuda"
    quant = isinstance(k_cache, dict)
    k_op = k_cache["q"] if quant else k_cache
    v_op = v_cache["q"] if quant else v_cache
    if q.ndim != 4:
        raise ValueError(f"{fn_name}: q must be (B, H, 1, d), got {tuple(q.shape)}")
    B, H, T, d = q.shape
    if T != 1:
        raise ValueError(f"flash_decode_paged serves exactly one query per slot, got T={T}")
    if k_op.ndim != 4:
        raise ValueError(f"{fn_name}: pools must be (num_pages, H, page_len, d), "
                         f"got {tuple(k_op.shape)}")
    NP, _, page_len, _ = k_op.shape
    if k_op.shape != (NP, H, page_len, d) or v_op.shape != (NP, H, page_len, d):
        raise ValueError(
            f"{fn_name}: pools must be (num_pages, H, page_len, d) = (NP, {H}, page_len, {d}), "
            f"got {tuple(k_op.shape)} / {tuple(v_op.shape)}"
        )
    if page_table.dtype != torch.int32 or page_table.ndim != 2 or page_table.shape[0] != B:
        raise ValueError(f"{fn_name}: page_table must be int32 (B={B}, P), got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    P = page_table.shape[1]
    if not decode_paged_supported(B, H, P, page_len, d):
        raise ValueError(f"{fn_name} cannot serve (B={B}, H={H}, P={P}, page_len={page_len}, d={d})")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"{fn_name}: q dtype {q.dtype} not in {list(_Q_CODES)}")
    if quant:
        if k_op.dtype != torch.int8 or v_op.dtype != torch.int8:
            raise ValueError(f"{fn_name}: int8 pools need int8 codes")
        for nm, sc in (("k scales", k_cache["s"]), ("v scales", v_cache["s"])):
            if sc.dtype != torch.float32 or tuple(sc.shape) != (NP, H, page_len, 1):
                raise ValueError(f"{fn_name}: {nm} must be f32 (num_pages, H, page_len, 1)")
    elif k_op.dtype != q.dtype or v_op.dtype != q.dtype:
        raise ValueError(f"{fn_name}: pool dtype {k_op.dtype}/{v_op.dtype} must equal q's {q.dtype}")
    dev = q.device
    for nm, t in (("q", q), ("k_cache", k_op), ("v_cache", v_op), ("page_table", page_table)):
        _check_cuda(nm, t, dev, fn_name)
    ks = vs = None
    if quant:
        ks, vs = k_cache["s"], v_cache["s"]
        _check_cuda("k scales", ks, dev, fn_name)
        _check_cuda("v scales", vs, dev, fn_name)
    _check_aligned(fn_name, ("k_cache", k_op), ("v_cache", v_op))
    pos_vec = _pos_vector(pos, B, dev)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    out = torch.empty((B, H, 1, d), dtype=q.dtype, device=dev)
    ws = _workspace(B, H, P * page_len, d, dev)
    lib = _kernels.library()
    fn = lib.fn("flash_decode_paged")
    err = fn(
        q.data_ptr(), k_op.data_ptr(), v_op.data_ptr(),
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        page_table.data_ptr(), pos_vec.data_ptr(), ws.data_ptr(), out.data_ptr(),
        B, H, P, page_len, NP, ws.shape[1], d, _Q_CODES[q.dtype], _KV_CODES[k_op.dtype],
        float(sm_scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    lib.check("flash_decode_paged", err)
    _kernels.count_launch("flash_decode_paged", cost=lambda: decode_cost(
        q, k_op.element_size(), pos_vec, P * page_len, quant=quant, table_bytes=B * P * 4))
    return out


def flash_decode_paged(q, k_cache, v_cache, page_table, pos,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-query attention against a page pool through ``page_table``;
    see module docs.  Returns (B, H, 1, d) in ``q.dtype``.  CUDA tensors
    take the kernel, CPU tensors the plain version."""
    if q.shape[2] != 1:
        raise ValueError(f"flash_decode_paged serves exactly one query per slot, got T={q.shape[2]}")
    if q.device.type == "cpu":
        return flash_decode_paged_reference(q, k_cache, v_cache, page_table, pos, sm_scale)
    return flash_decode_paged_cuda(q, k_cache, v_cache, page_table, pos, sm_scale)
