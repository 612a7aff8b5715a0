"""Kernel injection: an HF or Megatron model's weights in the port's fused
layout (counterpart of ``deepspeed_tpu/inference/injection.py``).

A policy maps a source model's state dict into the stacked-block
parameter tree of ``models/gpt2.py`` or ``models/bert.py``, after which
the whole network runs through the inference path
(``ops/transformer/inference.py``); :func:`replace_transformer_layer`
returns ``(model_config, params)``.  Policies take a live
``torch.nn.Module`` (a ``transformers`` model), any object with
``state_dict()`` and a ``.config``, or a plain ``{name: tensor}`` state
dict (Megatron checkpoints, merged by ``inference/checkpoint.py``).

The tensors stay on the device they arrive on and are stacked in torch,
in their own floating dtype (the engine casts each leaf to its own dtype
as it places it): a model on the card is never staged on the host.  On
float32 weights the trees equal the JAX package's policies' (which stack
float32 numpy), leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

_MEGATRON_PROBE = "language_model.transformer.layers.0.input_layernorm.weight"


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _state_dict_of(model) -> Dict[str, torch.Tensor]:
    sd = model if isinstance(model, dict) else model.state_dict()
    return {k: _as_tensor(v) for k, v in sd.items()}


def _stack(sd: Dict[str, torch.Tensor], fmt: str, n_layer: int,
           transpose: bool = False) -> torch.Tensor:
    mats = [sd[fmt.format(i)] for i in range(n_layer)]
    return torch.stack([m.t() if transpose else m for m in mats])


class DSPolicy:
    """Base policy: a subclass declares how to read one architecture.
    ``convert(model)`` returns ``(model_config, params)``, the stacked
    GPT-2 or BERT layout of ``models/``."""

    architectures: Tuple[str, ...] = ()

    @classmethod
    def matches(cls, model) -> bool:
        cfg = getattr(model, "config", None)
        archs = tuple(getattr(cfg, "architectures", None) or ()) if cfg is not None else ()
        name = type(model).__name__
        return any(a in cls.architectures for a in archs) or name in cls.architectures


class HFGPT2LayerPolicy(DSPolicy):
    """transformers GPT-2 (reference ``replace_policy.py:195``): its
    Conv1D weights are already (in, out) and its fused ``c_attn`` is the
    q|k|v concatenation the blocks use."""

    # (GPT2ForSequenceClassification is left out: its score head has no
    # counterpart in the fused LM layout)
    architectures = ("GPT2LMHeadModel", "GPT2Model")

    @classmethod
    def convert(cls, model, hf_config=None):
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config

        sd = _state_dict_of(model)
        hf = hf_config if hf_config is not None else model.config
        # GPT2Model ("h.0...") or GPT2LMHeadModel ("transformer.h.0...")
        p = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        n_layer = hf.n_layer
        cfg = GPT2Config(vocab_size=hf.vocab_size, n_positions=hf.n_positions, n_embd=hf.n_embd,
                         n_layer=n_layer, n_head=hf.n_head,
                         layer_norm_epsilon=hf.layer_norm_epsilon, remat=False)

        def stacked(key):
            return _stack(sd, p + "h.{}." + key, n_layer)

        params = {
            "wte": sd[p + "wte.weight"],
            "wpe": sd[p + "wpe.weight"],
            "blocks": {
                "ln1_g": stacked("ln_1.weight"),
                "ln1_b": stacked("ln_1.bias"),
                "qkv_w": stacked("attn.c_attn.weight"),
                "qkv_b": stacked("attn.c_attn.bias"),
                "proj_w": stacked("attn.c_proj.weight"),
                "proj_b": stacked("attn.c_proj.bias"),
                "ln2_g": stacked("ln_2.weight"),
                "ln2_b": stacked("ln_2.bias"),
                "fc_w": stacked("mlp.c_fc.weight"),
                "fc_b": stacked("mlp.c_fc.bias"),
                "fc_proj_w": stacked("mlp.c_proj.weight"),
                "fc_proj_b": stacked("mlp.c_proj.bias"),
            },
            "lnf_g": sd[p + "ln_f.weight"],
            "lnf_b": sd[p + "ln_f.bias"],
        }
        return cfg, params


class HFGPTNEOLayerPolicy(DSPolicy):
    """transformers GPT-Neo (reference ``replace_policy.py:102``): separate
    (out, in) q/k/v Linears without biases, transposed and concatenated
    q|k|v.  GPT-Neo scales no attention scores by 1/sqrt(head_dim) and the
    blocks always do, so sqrt(head_dim) is folded into the query weights.
    Its local-attention layers run as full attention, as in the JAX
    package (ROADMAP C4): the same result while a sequence fits the
    window."""

    architectures = ("GPTNeoForCausalLM", "GPTNeoModel")

    @classmethod
    def convert(cls, model, hf_config=None):
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config

        sd = _state_dict_of(model)
        hf = hf_config if hf_config is not None else model.config
        p = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
        n_layer, d = hf.num_layers, hf.hidden_size
        cfg = GPT2Config(vocab_size=hf.vocab_size, n_positions=hf.max_position_embeddings,
                         n_embd=d, n_layer=n_layer, n_head=hf.num_heads,
                         layer_norm_epsilon=hf.layer_norm_epsilon, remat=False)
        q_scale = float(np.sqrt(d // hf.num_heads))
        wte = sd[p + "wte.weight"]
        qkv_w, qkv_b = [], []
        for i in range(n_layer):
            base = f"{p}h.{i}.attn.attention."
            parts_w = [sd[base + f"{n}_proj.weight"].t() for n in ("q", "k", "v")]
            parts_w[0] = parts_w[0] * q_scale
            qkv_w.append(torch.cat(parts_w, dim=1))
            parts_b = [sd.get(base + f"{n}_proj.bias",
                              torch.zeros(d, dtype=wte.dtype, device=wte.device))
                       for n in ("q", "k", "v")]
            parts_b[0] = parts_b[0] * q_scale
            qkv_b.append(torch.cat(parts_b))
        blocks = {"qkv_w": torch.stack(qkv_w), "qkv_b": torch.stack(qkv_b)}
        del qkv_w, qkv_b
        blocks["ln1_g"] = _stack(sd, p + "h.{}.ln_1.weight", n_layer)
        blocks["ln1_b"] = _stack(sd, p + "h.{}.ln_1.bias", n_layer)
        blocks["proj_w"] = _stack(sd, p + "h.{}.attn.attention.out_proj.weight", n_layer,
                                  transpose=True)
        blocks["proj_b"] = _stack(sd, p + "h.{}.attn.attention.out_proj.bias", n_layer)
        blocks["ln2_g"] = _stack(sd, p + "h.{}.ln_2.weight", n_layer)
        blocks["ln2_b"] = _stack(sd, p + "h.{}.ln_2.bias", n_layer)
        blocks["fc_w"] = _stack(sd, p + "h.{}.mlp.c_fc.weight", n_layer, transpose=True)
        blocks["fc_b"] = _stack(sd, p + "h.{}.mlp.c_fc.bias", n_layer)
        blocks["fc_proj_w"] = _stack(sd, p + "h.{}.mlp.c_proj.weight", n_layer, transpose=True)
        blocks["fc_proj_b"] = _stack(sd, p + "h.{}.mlp.c_proj.bias", n_layer)
        params = {
            "wte": wte,
            "wpe": sd[p + "wpe.weight"],
            "blocks": blocks,
            "lnf_g": sd[p + "ln_f.weight"],
            "lnf_b": sd[p + "ln_f.bias"],
        }
        return cfg, params


class HFBertLayerPolicy(DSPolicy):
    """transformers BERT (reference ``replace_policy.py:43``) → the post-LN
    BERT layout of ``models/bert.py``; heads the source lacks (pooler,
    MLM, NSP) are zeros, unit LayerNorm gains."""

    architectures = ("BertModel", "BertForMaskedLM", "BertForPreTraining",
                     "BertForSequenceClassification")

    @classmethod
    def convert(cls, model, hf_config=None):
        from deepspeed_tpu_torch.models.bert import BertConfig

        sd = _state_dict_of(model)
        hf = hf_config if hf_config is not None else model.config
        prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
        n_layer = hf.num_hidden_layers
        cfg = BertConfig(
            vocab_size=hf.vocab_size,
            max_position_embeddings=hf.max_position_embeddings,
            type_vocab_size=hf.type_vocab_size,
            hidden_size=hf.hidden_size,
            num_hidden_layers=n_layer,
            num_attention_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            layer_norm_eps=hf.layer_norm_eps,
            pre_layer_norm=False,
            remat=False,
        )
        p = prefix + "encoder.layer.{}."
        qkv_w, qkv_b = [], []
        for i in range(n_layer):
            base = p.format(i) + "attention.self."
            names = ("query", "key", "value")
            qkv_w.append(torch.cat([sd[base + f"{n}.weight"].t() for n in names], dim=1))
            qkv_b.append(torch.cat([sd[base + f"{n}.bias"] for n in names]))
        blocks = {
            "qkv_w": torch.stack(qkv_w),
            "qkv_b": torch.stack(qkv_b),
            "proj_w": _stack(sd, p + "attention.output.dense.weight", n_layer, transpose=True),
            "proj_b": _stack(sd, p + "attention.output.dense.bias", n_layer),
            "ln1_g": _stack(sd, p + "attention.output.LayerNorm.weight", n_layer),
            "ln1_b": _stack(sd, p + "attention.output.LayerNorm.bias", n_layer),
            "fc_w": _stack(sd, p + "intermediate.dense.weight", n_layer, transpose=True),
            "fc_b": _stack(sd, p + "intermediate.dense.bias", n_layer),
            "fc_proj_w": _stack(sd, p + "output.dense.weight", n_layer, transpose=True),
            "fc_proj_b": _stack(sd, p + "output.dense.bias", n_layer),
            "ln2_g": _stack(sd, p + "output.LayerNorm.weight", n_layer),
            "ln2_b": _stack(sd, p + "output.LayerNorm.bias", n_layer),
        }
        e = prefix + "embeddings."
        tok = sd[e + "word_embeddings.weight"]
        d = hf.hidden_size
        zeros = lambda *shape: torch.zeros(shape, dtype=tok.dtype, device=tok.device)  # noqa: E731
        pool_w = prefix + "pooler.dense.weight"
        params = {
            "tok_emb": tok,
            "pos_emb": sd[e + "position_embeddings.weight"],
            "type_emb": sd[e + "token_type_embeddings.weight"],
            "emb_ln_g": sd[e + "LayerNorm.weight"],
            "emb_ln_b": sd[e + "LayerNorm.bias"],
            "blocks": blocks,
            "pooler_w": sd[pool_w].t() if pool_w in sd else zeros(d, d),
            "pooler_b": sd.get(prefix + "pooler.dense.bias", zeros(d)),
            "mlm_dense_w": zeros(d, d),
            "mlm_dense_b": zeros(d),
            "mlm_ln_g": torch.ones(d, dtype=tok.dtype, device=tok.device),
            "mlm_ln_b": zeros(d),
            "mlm_bias": zeros(hf.vocab_size),
            "nsp_w": zeros(d, 2),
            "nsp_b": zeros(2),
        }
        # the MLM head where the source has one (BertForMaskedLM / ForPreTraining)
        mlm = "cls.predictions."
        if mlm + "transform.dense.weight" in sd:
            params["mlm_dense_w"] = sd[mlm + "transform.dense.weight"].t()
            params["mlm_dense_b"] = sd[mlm + "transform.dense.bias"]
            params["mlm_ln_g"] = sd[mlm + "transform.LayerNorm.weight"]
            params["mlm_ln_b"] = sd[mlm + "transform.LayerNorm.bias"]
            params["mlm_bias"] = sd[mlm + "bias"]
        if "cls.seq_relationship.weight" in sd:
            params["nsp_w"] = sd["cls.seq_relationship.weight"].t()
            params["nsp_b"] = sd["cls.seq_relationship.bias"]
        return cfg, params


class MegatronLayerPolicy(DSPolicy):
    """Megatron-LM GPT checkpoints (reference ``replace_policy.py:146``):
    (out, in) Linears under ``language_model.transformer.layers.N.*`` with
    a fused ``query_key_value`` whose output dimension is interleaved by
    head, (heads, 3, head_dim); tensor-parallel shards merged beforehand
    (``inference/checkpoint.py`` ``MegatronSDLoader``)."""

    architectures = ("GPT2Model_megatron", "MegatronGPT")

    @classmethod
    def matches(cls, model) -> bool:
        # Megatron checkpoints usually arrive as plain state dicts: probe
        # for the transformer's key prefix
        if isinstance(model, dict):
            return _MEGATRON_PROBE in model
        sd = model.state_dict() if hasattr(model, "state_dict") else {}
        return super().matches(model) or _MEGATRON_PROBE in sd

    @classmethod
    def convert(cls, model, hf_config=None):
        from deepspeed_tpu_torch.models.gpt2 import GPT2Config

        sd = _state_dict_of(model)
        cfgsrc = hf_config if hf_config is not None else getattr(model, "config", None)
        p = "language_model.transformer.layers.{}."
        n_layer = 0
        while (p.format(n_layer) + "input_layernorm.weight") in sd:
            n_layer += 1
        if n_layer == 0:
            raise ValueError("not a Megatron GPT state dict (no transformer.layers.*)")
        wte = sd["language_model.embedding.word_embeddings.weight"]
        wpe = sd["language_model.embedding.position_embeddings.weight"]
        d = wte.shape[1]
        n_head = getattr(cfgsrc, "num_attention_heads", None) or max(1, d // 64)
        cfg = GPT2Config(vocab_size=wte.shape[0], n_positions=wpe.shape[0], n_embd=d,
                         n_layer=n_layer, n_head=n_head, remat=False)
        # the fused QKV's output dimension per head, (heads, 3, head_dim),
        # as contiguous q|k|v, (3, heads, head_dim)
        hd = d // n_head
        qkv_w = _stack(sd, p + "attention.query_key_value.weight", n_layer, transpose=True)
        qkv_b = _stack(sd, p + "attention.query_key_value.bias", n_layer)
        blocks = {
            "ln1_g": _stack(sd, p + "input_layernorm.weight", n_layer),
            "ln1_b": _stack(sd, p + "input_layernorm.bias", n_layer),
            "qkv_w": qkv_w.reshape(n_layer, d, n_head, 3, hd).permute(0, 1, 3, 2, 4)
                          .reshape(n_layer, d, 3 * d),
            "qkv_b": qkv_b.reshape(n_layer, n_head, 3, hd).permute(0, 2, 1, 3)
                          .reshape(n_layer, 3 * d),
            "proj_w": _stack(sd, p + "attention.dense.weight", n_layer, transpose=True),
            "proj_b": _stack(sd, p + "attention.dense.bias", n_layer),
            "ln2_g": _stack(sd, p + "post_attention_layernorm.weight", n_layer),
            "ln2_b": _stack(sd, p + "post_attention_layernorm.bias", n_layer),
            "fc_w": _stack(sd, p + "mlp.dense_h_to_4h.weight", n_layer, transpose=True),
            "fc_b": _stack(sd, p + "mlp.dense_h_to_4h.bias", n_layer),
            "fc_proj_w": _stack(sd, p + "mlp.dense_4h_to_h.weight", n_layer, transpose=True),
            "fc_proj_b": _stack(sd, p + "mlp.dense_4h_to_h.bias", n_layer),
        }
        params = {
            "wte": wte,
            "wpe": wpe,
            "blocks": blocks,
            "lnf_g": sd["language_model.transformer.final_layernorm.weight"],
            "lnf_b": sd["language_model.transformer.final_layernorm.bias"],
        }
        return cfg, params


# the policies, walked in order (the reference's list of policies)
ALL_POLICIES = [HFGPT2LayerPolicy, HFGPTNEOLayerPolicy, HFBertLayerPolicy, MegatronLayerPolicy]


def replace_transformer_layer(model, policy: Optional[type] = None,
                              hf_config: Any = None):
    """Reference ``replace_transformer_layer`` (``replace_module.py:89``):
    resolve a policy (``policy``, else the first of :data:`ALL_POLICIES`
    that matches) and convert the whole model to the fused layout.
    Returns ``(model_config, params)``."""
    if policy is not None:
        return policy.convert(model, hf_config=hf_config)
    for pol in ALL_POLICIES:
        if pol.matches(model):
            logger.info(f"injection: matched policy {pol.__name__}")
            return pol.convert(model, hf_config=hf_config)
    raise ValueError(
        f"No injection policy for {type(model).__name__}; pass injection_policy= "
        f"(available: {[p.__name__ for p in ALL_POLICIES]})"
    )
