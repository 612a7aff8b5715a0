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

Layer-parameter layout matches ``models/gpt2.py`` blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.attention.flash_attention import flash_attention, mha_reference
from deepspeed_tpu_torch.ops.kernels.flash_decode import (
    _per_slot,
    flash_decode,
    flash_decode_reference,
)
from deepspeed_tpu_torch.ops.normalize import layer_norm as _ln


@dataclasses.dataclass(frozen=True)
class DeepSpeedInferenceConfig:
    """Reference ``DeepSpeedInferenceConfig``.  ``use_flash_attention``
    routes attention through the hand-written kernels (flash prefill and
    flash decode); False takes their plain PyTorch versions, which is how
    a run on the card compares the two paths."""

    hidden_size: int = 768
    heads: int = 12
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    max_out_tokens: int = 1024  # static KV-cache capacity
    use_flash_attention: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads


def _wmm(h: torch.Tensor, w) -> torch.Tensor:
    """Weight matmul, ``(in, out)`` layout.  Packed int8 weights
    (``{"q", "s"}``) are not ported yet."""
    if isinstance(w, dict):
        raise NotImplementedError(
            "packed int8 weights are not ported yet (ROADMAP A7 ops/quantizer/)"
        )
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
) -> Tuple[torch.Tensor, Any, Any]:
    """One transformer layer with cache update (in place).

    ``x``: (B, T, D).  Initial prefill = the Python int ``pos=0``: the
    flash/causal fast path over the prompt block.  Any other ``pos``
    (decode, chunked continuation) attends against the whole cache with
    the position mask; a (B,) ``pos`` tensor is the slot-pool form.
    Returns (y, k_cache, v_cache)."""
    if page_table is not None:
        raise NotImplementedError("paged KV caches are not ported yet (ROADMAP B5 + A8 serving/kvcache/)")
    if "gate_w" in lp:
        raise NotImplementedError("MoE decode blocks are not ported yet (ROADMAP A11)")
    B, T, D = x.shape
    H, hd = cfg.heads, cfg.head_dim

    h = _ln(x, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_eps)
    qkv = _wmm(h, lp["qkv_w"]) + lp["qkv_b"].to(h.dtype)
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
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
    attn = attn.transpose(1, 2).reshape(B, T, D)
    attn = _wmm(attn, lp["proj_w"]) + lp["proj_b"].to(attn.dtype)
    return _block_mlp(cfg, lp, x + attn), k_cache, v_cache


def _block_mlp(cfg: DeepSpeedInferenceConfig, lp: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """Post-attention half of the block: LN2 + dense MLP + residual."""
    h = _ln(x, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_eps)
    h = _wmm(h, lp["fc_w"]) + lp["fc_b"].to(h.dtype)
    h = F.gelu(h, approximate="tanh")
    h = _wmm(h, lp["fc_proj_w"]) + lp["fc_proj_b"].to(h.dtype)
    return x + h


def _layer_cache(c, i: int):
    """Layer ``i`` of a stacked cache (a view: writes land in ``c``)."""
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
):
    """Full GPT-2-layout network step with cache: embeddings → cached
    blocks → final LN → tied-embedding logits.

    ``tokens``: (B, T) int.  ``k_cache``/``v_cache``: stacked caches or
    tuples of per-layer caches, updated in place.  ``position_ids`` (B,
    T) overrides the default ``pos + arange(T)`` positions.  Returns
    (logits (B, T, V) f32, k_cache, v_cache)."""
    if page_table is not None:
        raise NotImplementedError("paged KV caches are not ported yet (ROADMAP B5 + A8 serving/kvcache/)")
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
    x = (params["wte"][tokens] + pos_emb).to(cfg.dtype)

    blocks = params["blocks"]
    per_layer = isinstance(k_cache, (tuple, list))
    n_layer = len(k_cache) if per_layer else next(iter(
        k_cache.values() if isinstance(k_cache, dict) else [k_cache])).shape[0]
    for i in range(n_layer):
        lp = {name: a[i] for name, a in blocks.items()}
        ck = k_cache[i] if per_layer else _layer_cache(k_cache, i)
        cv = v_cache[i] if per_layer else _layer_cache(v_cache, i)
        x, _, _ = inference_block(cfg, lp, x, ck, cv, pos, key_padding_mask=key_padding_mask)
    x = _ln(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_eps)
    logits = x @ params["wte"].t().to(x.dtype)
    return logits.float(), k_cache, v_cache
