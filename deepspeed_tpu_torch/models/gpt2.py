"""GPT-2 family: configuration, presets and parameters (counterpart of
``deepspeed_tpu/models/gpt2.py``).

Parameters are a plain dictionary of tensors in the JAX package's layout:
``wte`` (V, d), ``wpe`` (n_positions, d), the per-layer weights stacked
on a leading layer dim under ``blocks``, and the final LayerNorm.  Weight
matrices keep the ``(in, out)`` layout, so ``h @ w`` is the projection
on both sides of the port."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


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
