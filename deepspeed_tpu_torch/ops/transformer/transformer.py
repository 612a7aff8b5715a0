"""Training transformer layer op (counterpart of
``deepspeed_tpu/ops/transformer/transformer.py``).

The reference's ``DeepSpeedTransformerLayer``: one BERT-style encoder
layer (self-attention and a GELU MLP, pre- or post-LN, attention-
probability dropout and hidden dropout), whose CUDA fusions the JAX
package left to XLA.  Here the attention core is the flash kernels (B1
forward, B2 or B6 backward, with the mask as their bias and the dropout
keep-bits generated in-kernel); LayerNorm, GELU, the hidden dropout and the
GEMMs are plain torch ops.  The gradient comes from autograd (no hand
backward of the layer); ``attn_dropout_checkpoint`` / ``gelu_checkpoint``
recompute the attention and MLP parts with ``torch.utils.checkpoint``.

:func:`encoder_block` is the one encoder layer of the port:
``models/bert.py``'s block calls it with a slice of its stacked weights,
and :func:`transformer_layer_fn` only turns the mask into a bias first.
Weights keep the BERT block's layout (``ln1_g ln1_b qkv_w qkv_b proj_w
proj_b ln2_g ln2_b fc_w fc_b fc_proj_w fc_proj_b``, (in, out) matrices).
Randomness: the JAX layer splits its key three ways (attention,
hidden after attention, hidden after the MLP); here the layer takes
``seeds = (attn_key, s2, s3)``, the attention key as a pair of uint32 words
(bit for bit the JAX package's keep-bits for the same key words) and two
ints for the hidden-dropout generators (other masks than JAX's).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.ops.attention.flash_attention import (
    flash_attention,
    keep_mask,
    make_dropout,
    mha_reference,
)
from deepspeed_tpu_torch.ops.normalize import dropout as _dropout
from deepspeed_tpu_torch.ops.normalize import dropout_generator
from deepspeed_tpu_torch.ops.normalize import layer_norm as _ln
from deepspeed_tpu_torch.utils.device import resolve_device

MASK_BIAS = -1e9  # the score bias of a padded key

PARAM_KEYS = (
    "ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
    "ln2_g", "ln2_b", "fc_w", "fc_b", "fc_proj_w", "fc_proj_b",
)


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """The JAX package's ``DeepSpeedTransformerConfig`` (the reference's
    knobs minus CUDA-isms), ``dtype`` a torch dtype.  As there, ``dtype``
    is carried and not read by the math: the layer computes in its input's
    type over f32 weights.  ``use_flash_attention`` (the port's, as
    ``BertConfig``'s): False sends the attention core to the plain
    reference with the same keep-bits, the yardstick of the kernels on the
    card."""

    batch_size: int = -1
    hidden_size: int = 768
    intermediate_size: int = 3072
    heads: int = 12
    attn_dropout_ratio: float = 0.1
    hidden_dropout_ratio: float = 0.1
    num_hidden_layers: int = 12
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    seed: int = 42
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    adjust_init_range: bool = True
    return_tuple: bool = False
    training: bool = True
    dtype: Any = torch.bfloat16
    use_flash_attention: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads


def init_transformer_params(cfg: DeepSpeedTransformerConfig,
                            seed: Optional[int] = None) -> Dict[str, np.ndarray]:
    """One layer's weights as numpy arrays: normal(initializer_range), the
    output projections scaled by 1/sqrt(2L) with ``adjust_init_range``;
    the same generator, draw order and values as the JAX package's."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    d, i = cfg.hidden_size, cfg.intermediate_size
    std = cfg.initializer_range
    out_std = std
    if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
        out_std = std / np.sqrt(2.0 * cfg.num_hidden_layers)

    def n(*shape, s=std):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {
        "ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
        "qkv_w": n(d, 3 * d), "qkv_b": np.zeros(3 * d, np.float32),
        "proj_w": n(d, d, s=out_std), "proj_b": np.zeros(d, np.float32),
        "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
        "fc_w": n(d, i), "fc_b": np.zeros(i, np.float32),
        "fc_proj_w": n(i, d, s=out_std), "fc_proj_b": np.zeros(d, np.float32),
    }


def params_from_jax(tree: Dict[str, Any], device: Any = "cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's layer weights (numpy arrays, or anything
    ``np.asarray`` takes) as tensors on ``device`` in ``dtype`` (default
    float32), the same keys and shapes.  Refuses missing or extra keys."""
    missing = sorted(set(PARAM_KEYS) - set(tree))
    extra = sorted(set(tree) - set(PARAM_KEYS))
    if missing or extra:
        raise KeyError(f"transformer layer parameters: missing {missing}, extra {extra}")
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(tree[k], np.float32))).to(
        device=device, dtype=dtype or torch.float32) for k in PARAM_KEYS}


def draw_seeds(generator: torch.Generator) -> tuple:
    """``(attn_key, s2, s3)`` for one layer from ``generator`` (drawn on
    the generator's device; a CPU generator keeps the draw off the card)."""
    key = torch.randint(0, 2**32, (2,), generator=generator, dtype=torch.int64,
                        device=generator.device).tolist()
    s2, s3 = torch.randint(0, 2**62, (2,), generator=generator, device=generator.device).tolist()
    return tuple(key), s2, s3


def key_padding_bias(attention_mask: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    """A (B, T) mask, nonzero where a key is real, as the f32 (B, 1, 1, T)
    score bias 0 / ``MASK_BIAS`` that the flash kernels take as their
    key-row bias (None stays None)."""
    if attention_mask is None:
        return None
    keep = attention_mask[:, None, None, :].bool()
    return torch.where(keep, torch.zeros((), dtype=torch.float32, device=device),
                       torch.full((), MASK_BIAS, dtype=torch.float32, device=device))


def attention(q, k, v, bias, rate: float, attn_key, use_flash: bool) -> torch.Tensor:
    """Non-causal attention with an additive ``bias`` and attention
    dropout at ``rate`` keyed by ``attn_key`` (a pair of uint32 words, or
    None for no dropout): the flash kernels, or with ``use_flash`` False
    the plain reference with the same keep-bits materialized."""
    if attn_key is None:
        rate = 0.0
    if use_flash:
        return flash_attention(q, k, v, causal=False, bias=bias, dropout_rate=rate,
                               dropout_rng=attn_key)
    return mha_reference(q, k, v, causal=False, bias=bias,
                         dropout_mask=keep_mask(make_dropout(rate, attn_key), q, k),
                         keep_prob=1.0 - rate)


def encoder_block(p: Dict[str, torch.Tensor], x: torch.Tensor, bias: Optional[torch.Tensor],
                  seeds: Optional[tuple], *, heads: int, pre_layer_norm: bool, eps: float,
                  hidden_rate: float, attn_rate: float, use_flash: bool, deterministic: bool,
                  checkpoint_parts: bool = False) -> torch.Tensor:
    """One encoder layer, the BERT block and this op alike.  ``x``: (B, T,
    D); ``p``: the layer's weights (``PARAM_KEYS``); ``bias``: an additive
    f32 score bias broadcastable to (B, H, T, T) or None.  ``seeds``
    (ignored when ``deterministic``): ``(attn_key, s1, s2)``, the attention
    dropout's key (a pair of uint32 words, or None) and two ints for the
    hidden-dropout generators after the attention and after the MLP (None:
    no such dropout), so a recomputed block draws the same masks.
    ``checkpoint_parts`` recomputes the attention and MLP parts in the
    backward (``torch.utils.checkpoint``)."""
    B, T, D = x.shape
    hd = D // heads
    attn_key, s1, s2 = (None, None, None) if deterministic or seeds is None else seeds
    r1, r2 = dropout_generator(s1, x.device), dropout_generator(s2, x.device)

    def attn_part(h):
        qkv = h @ p["qkv_w"].to(h.dtype) + p["qkv_b"].to(h.dtype)
        q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        o = attention(q, k, v, bias, attn_rate, attn_key, use_flash)
        o = o.transpose(1, 2).reshape(B, T, D)
        return o @ p["proj_w"].to(o.dtype) + p["proj_b"].to(o.dtype)

    def mlp_part(h):
        h = F.gelu(h @ p["fc_w"].to(h.dtype) + p["fc_b"].to(h.dtype))
        return h @ p["fc_proj_w"].to(h.dtype) + p["fc_proj_b"].to(h.dtype)

    attn_fn, mlp_fn = attn_part, mlp_part
    if checkpoint_parts:
        attn_fn = lambda h: checkpoint(attn_part, h, use_reentrant=False)  # noqa: E731
        mlp_fn = lambda h: checkpoint(mlp_part, h, use_reentrant=False)  # noqa: E731

    det = deterministic
    if pre_layer_norm:
        x = x + _dropout(attn_fn(_ln(x, p["ln1_g"], p["ln1_b"], eps)), hidden_rate, r1, det)
        return x + _dropout(mlp_fn(_ln(x, p["ln2_g"], p["ln2_b"], eps)), hidden_rate, r2, det)
    x = _ln(x + _dropout(attn_fn(x), hidden_rate, r1, det), p["ln1_g"], p["ln1_b"], eps)
    return _ln(x + _dropout(mlp_fn(x), hidden_rate, r2, det), p["ln2_g"], p["ln2_b"], eps)


def transformer_layer_fn(params: Dict[str, torch.Tensor], x: torch.Tensor,
                         cfg: DeepSpeedTransformerConfig,
                         attention_mask: Optional[torch.Tensor] = None,
                         seeds: Optional[tuple] = None, training: bool = True) -> torch.Tensor:
    """The fused layer (the reference's ``DeepSpeedTransformerFunction.
    forward``).  ``x``: (B, T, D); ``attention_mask``: (B, T) with 1 on a
    key to keep (the key-row bias 0 / -1e9), or an additive bias
    broadcastable to (B, H, T, T), e.g. (B, 1, T, T) (the full form).
    ``seeds``: ``(attn_key, s2, s3)`` or None (no dropout), used only when
    ``training``."""
    if attention_mask is not None and attention_mask.ndim != 2:
        bias = attention_mask.float()
    else:
        bias = key_padding_bias(attention_mask, x.device)
    return encoder_block(
        params, x, bias, seeds, heads=cfg.heads, pre_layer_norm=cfg.pre_layer_norm,
        eps=cfg.layer_norm_eps, hidden_rate=cfg.hidden_dropout_ratio,
        attn_rate=cfg.attn_dropout_ratio, use_flash=cfg.use_flash_attention,
        deterministic=not training,
        checkpoint_parts=cfg.attn_dropout_checkpoint or cfg.gelu_checkpoint)


class DeepSpeedTransformerLayer(nn.Module):
    """One layer owning its weights as ``nn.Parameter`` s (f32, named as
    the BERT block's keys; the reference's ``DeepSpeedTransformerLayer``).
    ``initial_weights`` / ``initial_biases``: the reference's packing,
    ``[q, k, v, proj, fc, fc_proj]`` weights as (out, in) matrices and
    their biases.  ``device`` defaults to the card (``device="cpu"`` runs
    the plain versions of the kernels)."""

    def __init__(self, config: DeepSpeedTransformerConfig, initial_weights=None,
                 initial_biases=None, seed: Optional[int] = None, device: Any = "cuda"):
        super().__init__()
        self.config = config
        params = init_transformer_params(config, seed=seed)
        if initial_weights is not None:
            qw, kw, vw, pw, fw, fpw = [np.asarray(w, np.float32) for w in initial_weights]
            params["qkv_w"] = np.concatenate([qw.T, kw.T, vw.T], axis=1)
            params["proj_w"], params["fc_w"], params["fc_proj_w"] = pw.T, fw.T, fpw.T
        if initial_biases is not None:
            qb, kb, vb, pb, fb, fpb = [np.asarray(b, np.float32) for b in initial_biases]
            params["qkv_b"] = np.concatenate([qb, kb, vb])
            params["proj_b"], params["fc_b"], params["fc_proj_b"] = pb, fb, fpb
        for name, t in params_from_jax(params, device=resolve_device(device)).items():
            self.register_parameter(name, nn.Parameter(t))

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return {name: getattr(self, name) for name in PARAM_KEYS}

    def forward(self, hidden_states: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                rng=None, training: Optional[bool] = None) -> torch.Tensor:
        """``rng``: a ``torch.Generator`` (the layer's three seeds are drawn
        from it, :func:`draw_seeds`), an explicit ``(attn_key, s2, s3)``, or
        None (no dropout).  ``training`` defaults to the config's, off after
        ``eval()``."""
        if training is None:
            training = self.training and self.config.training
        seeds = draw_seeds(rng) if isinstance(rng, torch.Generator) else rng
        return transformer_layer_fn(self.params, hidden_states, self.config,
                                    attention_mask=attention_mask, seeds=seeds,
                                    training=training)
