"""Inference transformer ops — KV-cache prefill/decode path (counterpart of
``deepspeed_tpu/ops/transformer/inference.py``).

* Caches are static-capacity tensors ``(layers, batch, heads, max_len,
  head_dim)`` (or the int8 ``{"q", "s"}`` pair), or tuples of per-layer
  ``(batch, heads, max_len, head_dim)`` tensors.
* Cache writes are **in place**: where the JAX package donated the cache
  buffers to get an in-place ``dynamic_update_slice``, the port writes
  into the caller's tensors, and ``forward_with_cache`` returns the same
  tensors it was given.
* The initial prefill (``pos`` the Python int 0) runs the flash-attention
  kernel over the prompt block; a single-token step (T = 1) runs the
  flash-decode kernel against the cache; other steps (chunked prefill,
  mid-stream continuation) take the plain cache attention.
* ``pos`` forms: a Python int (static offset), a 0-dim tensor (a traced
  offset in the JAX package — never the initial-prefill fast path), or a
  (B,) tensor (the slot-pool form: each row at its own position).
* A ``page_table`` (B, P) selects the paged form: the caches are page
  pools ``(layers, num_pages, heads, page_len, head_dim)``, writes scatter
  through the table in place (``write_mask`` sends masked rows to the
  garbage page 0), and a single-token step attends through the table
  with the paged flash-decode kernel.
* Tensor parallelism over ``model`` (``tp``, a ``parallel/tensor.py``
  group of ``cfg.mp_size`` ranks): the parameters are the rank's blocks
  (``models/gpt2.py`` ``tp_spec_fn``, ``qkv`` head-grouped), the caches
  hold the rank's ``heads / mp_size`` heads, and a block runs B1, B4 and
  B5 on them, then sums ``proj`` and ``fc_proj`` over ``model`` (one
  ``tp-all-reduce`` each, as the embedding's lookup has); the tied head
  gives the rank's vocabulary block of the logits, and one all-gather
  (``tp-all-gather``) gives every rank the whole f32 logits.
  Without a group (one rank) the arithmetic is the one-device path's.

Layer-parameter layout matches ``models/gpt2.py`` blocks; a matmul
weight may be a packed int8 ``{"q", "s"}`` pair (:func:`_wmm`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.ops.attention.flash_attention import flash_attention, mha_reference
from deepspeed_tpu_torch.ops.kernels.flash_decode import (
    _per_slot,
    flash_decode,
    flash_decode_paged,
    flash_decode_paged_reference,
    flash_decode_reference,
    paged_gather,  # noqa: F401  (public here, as in the JAX package's module)
)
from deepspeed_tpu_torch.ops.normalize import layer_norm as _ln
from deepspeed_tpu_torch.ops.quantizer.quantizer import int8_matmul
from deepspeed_tpu_torch.parallel.tensor import TP_ALL_REDUCE, vocab_parallel_rows

# the logits' all-gather over ``model`` (``comm/collectives.py`` kind)
LOGITS_GATHER = "tp-all-gather"


def _sum_over_model(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` summed over the ``model`` group, in place (``x`` itself
    without a group).  No autograd operator: nothing here runs backward."""
    return x if tp is None else collectives.all_reduce(x, tp.group, kind=TP_ALL_REDUCE)


@dataclasses.dataclass(frozen=True)
class DeepSpeedInferenceConfig:
    """Reference ``DeepSpeedInferenceConfig``.  ``use_flash_attention``
    routes attention through the hand-written kernels (flash prefill and
    flash decode); False takes their plain PyTorch versions, which is how
    a run on the card compares the two paths."""

    hidden_size: int = 768
    heads: int = 12
    layer_norm_eps: float = 1e-5
    mp_size: int = 1  # ranks on ``model``: a rank runs heads / mp_size heads
    dtype: torch.dtype = torch.bfloat16
    max_out_tokens: int = 1024  # static KV-cache capacity
    use_flash_attention: bool = True
    # MoE decode (layer params with gate_w/w1/b1/w2/b2): the eval capacity
    # must be the training model's eval path's (MoEConfig's default)
    moe_top_k: int = 2
    moe_eval_capacity_factor: float = 2.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads

    @property
    def local_heads(self) -> int:
        """The heads of one ``model`` rank (its caches' head count)."""
        return self.heads // self.mp_size


def _check_tp(cfg: DeepSpeedInferenceConfig, tp) -> None:
    if (tp.size if tp is not None else 1) != cfg.mp_size:
        raise ValueError(f"the model group has {tp.size if tp is not None else 1} ranks, "
                         f"the config mp_size={cfg.mp_size}")


def _wmm(h: torch.Tensor, w) -> torch.Tensor:
    """Weight matmul, ``(in, out)`` layout.  A packed int8 weight
    (``{"q": int8, "s": f32}`` from ``runtime/weight_quantizer.py``
    ``pack_int8_tree``) computes ``(h @ q) * s``: the weight stays int8 at
    rest, and the product reads a transient copy of ``q`` in ``h``'s dtype
    (a plain product outside any kernel, as the JAX package's is)."""
    if isinstance(w, dict):
        return int8_matmul(h, w["q"], w["s"])
    return h @ w.to(h.dtype)


def init_kv_cache(n_layer: int, batch: int, heads: int, max_len: int, head_dim: int,
                  dtype: Any = torch.bfloat16, device: Any = "cpu"):
    """Static-capacity KV cache, stacked on a leading layer dim.
    ``dtype="int8"``: each cache is a ``{"q": int8, "s": f32}`` pair —
    per-(b, h, pos) absmax row quantization over head_dim."""
    shape = (n_layer, batch, heads, max_len, head_dim)
    if dtype == "int8" or dtype == torch.int8:
        def pair():
            return {
                "q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            }
        return pair(), pair()
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _kv_quant(t: torch.Tensor):
    """(..., d) -> (int8 codes, f32 per-row scale): absmax over head_dim.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    t32 = t.float()
    s = torch.clamp(t32.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / s), -127, 127).to(torch.int8)
    return q, s


def _write_index(pos, T: int, S: int, device) -> torch.Tensor:
    """Row positions ``pos[b] + arange(T)`` with the start clamped to
    ``[0, S - T]`` like the JAX package's ``dynamic_update_slice``."""
    start = torch.clamp(pos.to(device, torch.int64), 0, max(S - T, 0))
    return start[:, None] + torch.arange(T, device=device)[None, :]


def slot_cache_write(cache: torch.Tensor, t: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Per-slot cache write, in place: row ``b`` of ``t`` (B, H, T, d)
    lands at ``[b, :, pos[b]:pos[b]+T, :]`` of ``cache`` (B, H, S, d).
    Returns ``cache``."""
    B, H, T, _ = t.shape
    idx = _write_index(pos, T, cache.shape[2], cache.device)      # (B, T)
    rows = torch.arange(B, device=cache.device)[:, None]          # (B, 1)
    cache[rows, :, idx] = t.permute(0, 2, 1, 3).to(cache.dtype)   # (B, T, H, d)
    return cache


def _scalar_cache_write(cache: torch.Tensor, t: torch.Tensor, pos) -> torch.Tensor:
    """In-place write of ``t`` (B, H, T, d) at ``[:, :, pos:pos+T]``
    (start clamped as ``dynamic_update_slice`` clamps)."""
    T, S = t.shape[2], cache.shape[2]
    start = min(max(int(pos), 0), max(S - T, 0))
    cache[:, :, start:start + T] = t.to(cache.dtype)
    return cache


def paged_cache_write(cache, t: torch.Tensor, page_table: torch.Tensor, pos: torch.Tensor,
                      write_mask=None):
    """Per-slot token write through a page table, in place: row ``b`` of
    ``t`` (B, H, T, d) lands at logical positions ``pos[b]:pos[b]+T`` of
    slot ``b``, scattered into ``cache`` (num_pages, H, page_len, d) via
    ``page_table[b]``.  ``write_mask`` (B,) False redirects a row's writes
    to (garbage page 0, row 0); the duplicate targets there are never
    attended.  int8 caches quantize rows as :func:`slot_cache_write`'s
    callers do.  Returns ``cache``."""
    quant = isinstance(cache, dict)
    buf0 = cache["q"] if quant else cache
    page_len, dev = buf0.shape[2], buf0.device
    B, H, T, _ = t.shape
    table = page_table.to(dev, torch.int64)
    idx = pos.to(dev, torch.int64)[:, None] + torch.arange(T, device=dev)[None, :]  # (B, T)
    idx = torch.clamp(idx, 0, table.shape[1] * page_len - 1)
    pid = torch.gather(table, 1, idx // page_len)
    off = idx % page_len
    if write_mask is not None:
        keep = write_mask.to(dev, torch.bool)[:, None]
        pid = torch.where(keep, pid, 0)
        off = torch.where(keep, off, 0)
    pid_f, off_f = pid.reshape(-1), off.reshape(-1)

    def scat(buf, vals):  # vals (B, H, T, x) -> rows (B*T, H, x)
        rows = vals.permute(0, 2, 1, 3).reshape(B * T, H, vals.shape[-1])
        buf[pid_f, :, off_f] = rows.to(buf.dtype)

    if quant:
        cq, cs = _kv_quant(t)
        scat(cache["q"], cq)
        scat(cache["s"], cs)
    else:
        scat(cache, t)
    return cache


def paged_cache_attention(q, k_cache, v_cache, page_table, pos, sm_scale: Optional[float] = None,
                          use_kernel: bool = True) -> torch.Tensor:
    """Attend queries (B, H, T, d) against page pools through
    ``page_table``.  Single-query steps go to the paged flash-decode
    kernel (its plain version on the CPU); other steps, and
    ``use_kernel=False``, take the plain gather + cache attention."""
    if use_kernel and q.shape[2] == 1:
        return flash_decode_paged(q.contiguous(), k_cache, v_cache, page_table, pos,
                                  sm_scale=sm_scale)
    return flash_decode_paged_reference(q, k_cache, v_cache, page_table, pos, sm_scale=sm_scale)


def cache_attention(q, k_cache, v_cache, pos, sm_scale: Optional[float] = None,
                    key_padding_mask=None, use_kernel: bool = True) -> torch.Tensor:
    """Attend queries (B, H, T, d) against a static cache (B, H, S, d):
    query i attends keys ``j <= pos + i`` (``pos`` scalar or per-slot
    (B,)), further masked by ``key_padding_mask`` (B, S) True=attendable.

    Single-query steps (T = 1) go to the flash-decode kernel (its plain
    version on the CPU); ``use_kernel=False`` forces the plain body."""
    if use_kernel and q.shape[2] == 1:
        return flash_decode(q.contiguous(), k_cache, v_cache, pos, sm_scale=sm_scale,
                            key_padding_mask=key_padding_mask)
    return flash_decode_reference(q, k_cache, v_cache, pos, sm_scale=sm_scale,
                                  key_padding_mask=key_padding_mask)


def _cache_head(c, T: int):
    if isinstance(c, dict):
        return {name: a[:, :, :T] for name, a in c.items()}
    return c[:, :, :T]


def inference_block(
    cfg: DeepSpeedInferenceConfig,
    lp: Dict[str, torch.Tensor],
    x: torch.Tensor,
    k_cache,
    v_cache,
    pos,
    key_padding_mask=None,
    page_table=None,
    write_mask=None,
    tp=None,
) -> Tuple[torch.Tensor, Any, Any]:
    """One transformer layer with cache update (in place).

    ``x``: (B, T, D).  Initial prefill = the Python int ``pos=0``: the
    flash/causal fast path over the prompt block.  Any other ``pos``
    (decode, chunked continuation) attends against the whole cache with
    the position mask; a (B,) ``pos`` tensor is the slot-pool form.
    ``page_table`` (B, P) selects the paged form (page pools, a per-slot
    ``pos``, ``write_mask`` for the rows that must not touch real pages,
    no ``key_padding_mask``).  ``tp``: the ``model`` group when ``lp``
    holds the rank's blocks and the caches its heads.  Returns (y,
    k_cache, v_cache)."""
    B, T, _ = x.shape
    H, hd = cfg.local_heads, cfg.head_dim

    h = _ln(x, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_eps)
    qkv = _wmm(h, lp["qkv_w"]) + lp["qkv_b"].to(h.dtype)
    q, k, v = qkv.split(H * hd, dim=-1)

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if page_table is not None:
        if key_padding_mask is not None:
            raise ValueError("paged caches do not support key_padding_mask")
        paged_cache_write(k_cache, k, page_table, pos, write_mask)
        paged_cache_write(v_cache, v, page_table, pos, write_mask)
        attn = paged_cache_attention(q, k_cache, v_cache, page_table, pos,
                                     use_kernel=cfg.use_flash_attention)
        return _block_out(cfg, lp, x, attn, tp), k_cache, v_cache
    slotted = _per_slot(pos)
    if isinstance(k_cache, dict):
        for cache, t in ((k_cache, k), (v_cache, v)):
            cq, cs = _kv_quant(t)
            if slotted:
                slot_cache_write(cache["q"], cq, pos)
                slot_cache_write(cache["s"], cs, pos)
            else:
                _scalar_cache_write(cache["q"], cq, pos)
                _scalar_cache_write(cache["s"], cs, pos)
    elif slotted:
        slot_cache_write(k_cache, k, pos)
        slot_cache_write(v_cache, v, pos)
    else:
        _scalar_cache_write(k_cache, k, pos)
        _scalar_cache_write(v_cache, v, pos)

    kernels = cfg.use_flash_attention
    is_initial_prefill = isinstance(pos, int) and not isinstance(pos, bool) and pos == 0
    if is_initial_prefill and T > 1 and key_padding_mask is None and kernels and T >= 128:
        # prefill fast path: causal attention over the prompt block
        attn = flash_attention(q, k, v, causal=True)
    elif is_initial_prefill and T > 1 and key_padding_mask is None:
        attn = mha_reference(q, k, v, causal=True)
    elif is_initial_prefill and T > 1:
        # masked prefill: keys beyond the prompt block are causally dead —
        # attend the cache's first T rows only
        kp = key_padding_mask[:, :T]
        attn = cache_attention(q, _cache_head(k_cache, T), _cache_head(v_cache, T), 0,
                               key_padding_mask=kp, use_kernel=kernels)
    else:
        attn = cache_attention(q, k_cache, v_cache, pos, key_padding_mask=key_padding_mask,
                               use_kernel=kernels)
    return _block_out(cfg, lp, x, attn, tp), k_cache, v_cache


def _block_out(cfg: DeepSpeedInferenceConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
               attn: torch.Tensor, tp) -> torch.Tensor:
    """The attention's heads (B, H, T, d) through ``proj`` (summed over
    ``model`` before its replicated bias), the residual, then the MLP."""
    B, _, T, _ = attn.shape
    attn = attn.transpose(1, 2).reshape(B, T, -1)
    attn = _sum_over_model(_wmm(attn, lp["proj_w"]), tp) + lp["proj_b"].to(attn.dtype)
    return _block_mlp(cfg, lp, x + attn, tp)


def _block_mlp(cfg: DeepSpeedInferenceConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor, tp=None) -> torch.Tensor:
    """Post-attention half of the block: LN2 + (MoE | dense) MLP +
    residual (``fc`` column-parallel, ``fc_proj`` row-parallel under
    ``tp``).  A MoE block routes in eval mode (no jitter, the eval
    capacity) the step's tokens only, and, as the JAX package's decode,
    with no token mask: a slot pool's free slots and padded rows route
    and take capacity too."""
    h = _ln(x, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_eps)
    if "gate_w" in lp:
        from deepspeed_tpu_torch.moe.layer import moe_ffn_from_block

        h, _ = moe_ffn_from_block(lp, h, top_k=cfg.moe_top_k,
                                  eval_capacity_factor=cfg.moe_eval_capacity_factor,
                                  training=False, tp=tp)
        return x + h
    h = _wmm(h, lp["fc_w"]) + lp["fc_b"].to(h.dtype)
    h = F.gelu(h, approximate="tanh")
    h = _sum_over_model(_wmm(h, lp["fc_proj_w"]), tp) + lp["fc_proj_b"].to(h.dtype)
    return x + h


def _layer_cache(c, i: int):
    """Layer ``i`` of a stacked cache or weight, a ``{"q", "s"}`` pair's
    too (a view: writes land in ``c``)."""
    if isinstance(c, dict):
        return {name: a[i] for name, a in c.items()}
    return c[i]


def forward_with_cache(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    k_cache,
    v_cache,
    pos,
    cfg: DeepSpeedInferenceConfig,
    key_padding_mask=None,
    position_ids=None,
    page_table=None,
    write_mask=None,
    tp=None,
    logits_rows=None,
):
    """Full GPT-2-layout network step with cache: embeddings → cached
    blocks → final LN → tied-embedding logits.

    ``tokens``: (B, T) int.  ``k_cache``/``v_cache``: stacked caches or
    tuples of per-layer caches, updated in place.  ``position_ids`` (B,
    T) overrides the default ``pos + arange(T)`` positions.
    ``page_table`` (B, P) + ``write_mask`` (B,) select the paged form
    (see :func:`inference_block`).  ``tp``: the ``model`` group of
    ``cfg.mp_size`` ranks (module docstring).  ``logits_rows`` (a slice
    of T) keeps only those positions' logits, before the all-gather: a
    caller that reads the last row gathers one row, not T.  Returns
    (logits (B, T or the rows kept, V) f32, k_cache, v_cache)."""
    _check_tp(cfg, tp)
    B, T = tokens.shape
    wpe = params["wpe"]
    dev = wpe.device
    tokens = tokens.to(dev)
    if position_ids is None and _per_slot(pos):
        # per-slot positions, clipped so the garbage rows of idle slots
        # cannot gather out of range
        position_ids = torch.clamp(
            pos.to(dev, torch.int64)[:, None] + torch.arange(T, device=dev)[None, :],
            0, wpe.shape[0] - 1,
        )
    if position_ids is not None:
        pos_emb = wpe[position_ids.to(dev)]                           # (B, T, d)
    else:
        start = min(max(int(pos), 0), wpe.shape[0] - T)               # dynamic_slice clamp
        pos_emb = wpe[start:start + T][None]
    x = (_sum_over_model(vocab_parallel_rows(params["wte"], tokens, tp), tp)
         + pos_emb).to(cfg.dtype)

    blocks = params["blocks"]
    per_layer = isinstance(k_cache, (tuple, list))
    n_layer = len(k_cache) if per_layer else next(iter(
        k_cache.values() if isinstance(k_cache, dict) else [k_cache])).shape[0]
    for i in range(n_layer):
        lp = {name: _layer_cache(a, i) for name, a in blocks.items()}
        ck = k_cache[i] if per_layer else _layer_cache(k_cache, i)
        cv = v_cache[i] if per_layer else _layer_cache(v_cache, i)
        x, _, _ = inference_block(cfg, lp, x, ck, cv, pos, key_padding_mask=key_padding_mask,
                                  page_table=page_table, write_mask=write_mask, tp=tp)
    x = _ln(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_eps)
    logits = x @ params["wte"].t().to(x.dtype)
    if logits_rows is not None:
        logits = logits[:, logits_rows]
    logits = logits.float()
    if tp is not None:  # the rank's vocabulary block -> every rank the whole row
        logits = collectives.all_gather(logits, tp.group, dim=logits.dim() - 1,
                                        kind=LOGITS_GATHER)
    return logits, k_cache, v_cache
