"""GPT-2 family: configuration, presets, parameters, forward and loss
(counterpart of ``deepspeed_tpu/models/gpt2.py``).

Parameters are a plain dictionary of tensors in the JAX package's layout:
``wte`` (V, d), ``wpe`` (n_positions, d), the per-layer weights stacked
on a leading layer dim under ``blocks``, and the final LayerNorm.  Weight
matrices keep the ``(in, out)`` layout, so ``h @ w`` is the projection
on both sides of the port.

The layer loop is a Python loop over the stacked parameters (``unbind``
once per key, so the backward stacks each key's gradient once); with
``remat`` (the default, the JAX ``nothing_saveable`` policy) each block
runs under ``torch.utils.checkpoint`` and is recomputed in the backward."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.attention.flash_attention import flash_attention, mha_reference
from deepspeed_tpu_torch.ops.normalize import dropout as _dropout
from deepspeed_tpu_torch.ops.normalize import dropout_generator
from deepspeed_tpu_torch.ops.normalize import layer_norm as _layer_norm
from deepspeed_tpu_torch.ops.normalize import token_nll


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True
    # "flash" only: ring/ulysses/sparse attention are ROADMAP A10
    attention_mode: str = "flash"
    n_experts: int = 0  # MoE FFNs are ROADMAP A11
    remat: bool = True  # activation checkpointing per block
    # >0: cross-entropy in time-chunks of this size, each recomputed in the
    # backward, so the (B, T, vocab) logits never materialize whole
    xent_chunk_size: int = 0
    remat_policy: str = "nothing_saveable"
    remat_save_names: tuple = ()  # selective remat: not ported yet
    # scan_unroll and flash_blocks steer the JAX package's XLA layer scan
    # and Pallas tiles; kept for config compatibility, not read here
    scan_unroll: int = 1
    flash_blocks: tuple = ()

    def __post_init__(self):
        if self.attention_mode != "flash":
            raise NotImplementedError(
                f"attention_mode={self.attention_mode!r} is not ported yet (ROADMAP A10)")
        if self.n_experts > 0:
            raise NotImplementedError("MoE GPT-2 (n_experts > 0) is not ported yet (ROADMAP A11)")
        if self.remat_save_names:
            raise NotImplementedError(
                "selective remat (remat_save_names) is not ported yet "
                "(ROADMAP A13 activation_checkpointing/)")
        if self.remat_policy != "nothing_saveable":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r} is not ported yet "
                "(ROADMAP A13 activation_checkpointing/)")

    @property
    def head_dim(self) -> int:
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} is not a multiple of n_head={self.n_head}")
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        d, l, v, s = self.n_embd, self.n_layer, self.vocab_size, self.n_positions
        return v * d + s * d + l * (12 * d * d + 13 * d) + 2 * d


# Model zoo (sizes as in the GPT-2 paper)
GPT2_TINY = GPT2Config(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=4)
GPT2_SMALL = GPT2Config()  # 124M
GPT2_MEDIUM = GPT2Config(n_embd=1024, n_layer=24, n_head=16)  # 350M
GPT2_LARGE = GPT2Config(n_embd=1280, n_layer=36, n_head=20)  # 774M
GPT2_XL = GPT2Config(n_embd=1600, n_layer=48, n_head=25)  # 1.5B
GPT_NEO_27B = GPT2Config(n_positions=2048, n_embd=2560, n_layer=32, n_head=20)

PRESETS = {
    "tiny": GPT2_TINY,
    "gpt2": GPT2_SMALL,
    "gpt2-small": GPT2_SMALL,
    "gpt2-medium": GPT2_MEDIUM,
    "gpt2-large": GPT2_LARGE,
    "gpt2-xl": GPT2_XL,
    "gpt2-1.5b": GPT2_XL,
    "gpt-neo-2.7b": GPT_NEO_27B,
    "gpt-neo": GPT_NEO_27B,
}

BLOCK_KEYS = (
    "ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "ln2_g", "ln2_b", "fc_w", "fc_b", "fc_proj_w", "fc_proj_b",
)


def init_params(cfg: GPT2Config, seed: int = 0) -> Dict[str, Any]:
    """GPT-2 init as numpy arrays: normal(0.02), residual projections
    scaled by 1/sqrt(2*n_layer).  Same generator, draw order and values
    as the JAX package's ``init_params``."""
    rng = np.random.default_rng(seed)
    d, l = cfg.n_embd, cfg.n_layer
    std = 0.02
    proj_std = std / np.sqrt(2 * l)

    def n(*shape, s=std):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def z(*shape):
        return np.zeros(shape, np.float32)

    def o(*shape):
        return np.ones(shape, np.float32)

    ffn = {
        "fc_w": n(l, d, 4 * d),
        "fc_b": z(l, 4 * d),
        "fc_proj_w": n(l, 4 * d, d, s=proj_std),
        "fc_proj_b": z(l, d),
    }
    return {
        "wte": n(cfg.vocab_size, d),
        "wpe": n(cfg.n_positions, d, s=0.01),
        "blocks": {
            "ln1_g": o(l, d),
            "ln1_b": z(l, d),
            "qkv_w": n(l, d, 3 * d),
            "qkv_b": z(l, 3 * d),
            "proj_w": n(l, d, d, s=proj_std),
            "proj_b": z(l, d),
            "ln2_g": o(l, d),
            "ln2_b": z(l, d),
            **ffn,
        },
        "lnf_g": o(d),
        "lnf_b": z(d),
    }


def params_from_jax(tree: Dict[str, Any], device: Any = "cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's GPT-2 parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) as the port's parameters: the same keys and
    shapes, ``(in, out)`` weights, tensors on ``device`` in ``dtype``
    (default float32)."""

    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
        return t.to(device=device, dtype=dtype or torch.float32)

    missing = [k for k in ("wte", "wpe", "blocks", "lnf_g", "lnf_b") if k not in tree]
    if missing:
        raise KeyError(f"GPT-2 parameter tree lacks {missing}")
    extra = sorted(set(tree["blocks"]) - set(BLOCK_KEYS))
    if extra:
        # MoE blocks (gate_w/w1/...) and packed int8 weights are not ported
        raise NotImplementedError(
            f"GPT-2 blocks carry {extra}; only dense fp blocks are ported (ROADMAP A11/A7)"
        )
    return {
        "wte": conv(tree["wte"]),
        "wpe": conv(tree["wpe"]),
        "blocks": {k: conv(tree["blocks"][k]) for k in BLOCK_KEYS},
        "lnf_g": conv(tree["lnf_g"]),
        "lnf_b": conv(tree["lnf_b"]),
    }


def _block(cfg: GPT2Config, x: torch.Tensor, lp: Dict[str, torch.Tensor],
           seeds: Optional[tuple], deterministic: bool) -> torch.Tensor:
    """One transformer block; ``lp`` holds this layer's slice of the
    stacked params.  ``seeds``: three ints for the block's dropout
    generators (None in eval), so a recomputed block draws the same
    masks."""
    B, T, D = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    r1, r2, r3 = (dropout_generator(s, x.device) for s in (seeds or (None,) * 3))

    h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    qkv = h @ lp["qkv_w"].to(h.dtype) + lp["qkv_b"].to(h.dtype)
    q, k, v = qkv.split(D, dim=-1)

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if cfg.use_flash_attention and T >= 128:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = mha_reference(q, k, v, causal=True)
    attn = attn.transpose(1, 2).reshape(B, T, D)
    attn = attn @ lp["proj_w"].to(attn.dtype) + lp["proj_b"].to(attn.dtype)
    x = x + _dropout(attn, cfg.dropout, r1, deterministic)

    h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    h = h @ lp["fc_w"].to(h.dtype) + lp["fc_b"].to(h.dtype)
    h = F.gelu(h, approximate="tanh")
    h = _dropout(h, cfg.dropout, r2, deterministic)
    h = h @ lp["fc_proj_w"].to(h.dtype) + lp["fc_proj_b"].to(h.dtype)
    return x + _dropout(h, cfg.dropout, r3, deterministic)


def apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: GPT2Config,
          generator: Optional[torch.Generator] = None, deterministic: bool = True,
          return_hidden: bool = False) -> torch.Tensor:
    """Forward pass: ``tokens (B, T)`` → logits ``(B, T, V)`` in the
    parameters' type.  ``return_hidden=True`` returns the post-final-LN
    hidden states (B, T, D) instead (the chunked-xent loss).
    ``generator`` draws the dropout seeds (a CPU generator keeps the draw
    off the device); None or ``deterministic`` means no dropout."""
    B, T = tokens.shape
    tokens = tokens.long()
    x = params["wte"][tokens] + params["wpe"][:T][None]
    x = x.to(params["blocks"]["qkv_w"].dtype)
    layers = {key: params["blocks"][key].unbind(0) for key in BLOCK_KEYS}
    seeds = [None] * cfg.n_layer
    if generator is not None and not deterministic and cfg.dropout > 0.0:
        draw = torch.randint(0, 2**62, (cfg.n_layer, 3), generator=generator,
                             device=generator.device)
        seeds = [tuple(row) for row in draw.tolist()]
    block_fn = functools.partial(_block, cfg)
    for i in range(cfg.n_layer):
        lp = {key: layers[key][i] for key in BLOCK_KEYS}
        if cfg.remat:
            x = checkpoint(block_fn, x, lp, seeds[i], deterministic, use_reentrant=False)
        else:
            x = block_fn(x, lp, seeds[i], deterministic)
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"], cfg.layer_norm_epsilon)
    if return_hidden:
        return x
    return x @ params["wte"].t().to(x.dtype)  # tied embedding head


def _xent_chunk(xc, wte, lc, mc):
    logits = xc @ wte.t().to(xc.dtype)
    nll = token_nll(logits, lc) * mc
    return nll.sum(), mc.sum()


def _chunked_xent(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, chunk: int) -> torch.Tensor:
    """Masked-mean next-token NLL computed per time-chunk, each chunk
    recomputed in the backward: peak memory holds one chunk of logits
    instead of the whole (B, T, V) tensor."""
    T = hidden.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, T, chunk):
        s, c = checkpoint(_xent_chunk, hidden[:, c0:c0 + chunk], wte, labels[:, c0:c0 + chunk],
                          mask[:, c0:c0 + chunk], use_reentrant=False)
        total = total + s
        count = count + c
    return total / torch.clamp(count, min=1.0)


def loss_fn(params: Dict[str, Any], batch: Dict[str, Any], generator=None,
            cfg: GPT2Config = None, deterministic: bool = False) -> torch.Tensor:
    """Next-token cross entropy.  ``batch``: {"input_ids": (B, T)} with
    optional "labels" (default: shifted input_ids) and "attention_mask"."""
    tokens = batch["input_ids"]
    chunked = cfg.xent_chunk_size > 0
    out = apply(params, tokens, cfg, generator=generator, deterministic=deterministic,
                return_hidden=chunked)
    # mask indexes the *label* position (tokens[:, 1:]), not the query
    if "labels" in batch:
        labels, out_shift = batch["labels"], out
        mask = batch.get("attention_mask")
        mask = mask[:, : labels.shape[1]].float() if mask is not None else None
    else:
        labels, out_shift = tokens[:, 1:], out[:, :-1]
        mask = batch.get("attention_mask")
        mask = mask[:, 1: 1 + labels.shape[1]].float() if mask is not None else None

    if chunked:
        ones = torch.ones(labels.shape, dtype=torch.float32, device=out.device) if mask is None else mask
        return _chunked_xent(out_shift, params["wte"], labels, ones, cfg.xent_chunk_size)

    nll = token_nll(out_shift, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def make_model(cfg: GPT2Config):
    """Returns ``(model_fn, init_fn, tp_spec_fn)``; ``model_fn(params,
    batch, generator) -> loss`` plugs into
    ``deepspeed_tpu_torch.initialize(model=...)``.  ``generator=None``
    means eval.  ``tp_spec_fn`` is None: tensor parallelism is ROADMAP A6
    (and the layer-streaming ``stream_spec`` is A12)."""

    def model_fn(params, batch, generator):
        deterministic = generator is None or cfg.dropout == 0.0
        return loss_fn(params, batch, generator=generator, cfg=cfg, deterministic=deterministic)

    return model_fn, functools.partial(init_params, cfg), None
