"""BERT family: configuration, presets, parameters, encoder and the
MLM + NSP pretraining loss (counterpart of ``deepspeed_tpu/models/bert.py``).

Parameters are a plain dictionary of tensors in the JAX package's layout:
the embeddings, the per-layer weights stacked on a leading layer dim under
``blocks`` (26 leaves in all), the pooler and the two heads.  The stacking
is part of the optimizer's contract: LAMB takes one trust ratio per leaf,
so a ``(L, ...)`` leaf gets one ratio for all its layers, as in the JAX
package; a list of per-layer weights would change the update.  Weight
matrices keep the ``(in, out)`` layout, so ``h @ w`` is the projection on
both sides of the port.

The layer loop is a Python loop over the stacked parameters; with
``remat`` each block runs under ``torch.utils.checkpoint`` and is
recomputed in the backward.  A block is the training layer op's
``encoder_block`` (``ops/transformer/transformer.py``).  Attention is
non-causal with the key-padding mask as an f32 (B, 1, 1, T) bias of 0 or
-1e9, which the flash kernels take as their key-row bias.  Attention-probability dropout is keyed per layer by
a pair of uint32 words drawn outside the checkpoint: the kernels regenerate
its keep-bits from each score's position (so a recomputed block drops the
same scores), and the plain-attention branch applies the same bits from
``flash_attention.keep_mask``.  Hidden dropout is
:func:`deepspeed_tpu_torch.ops.normalize.dropout` (another generator than
the JAX package's, so its masks differ).

**Tensor parallelism** (a ``model`` axis of m > 1 ranks in the engine's
ambient mesh; the JAX BERT has no sequence-parallel mode, nor does this
one): the tensor-parallel leaves arrive as the rank's blocks
(``tp_spec_fn``: the JAX package's ``bert`` rule table), each block runs
``num_attention_heads / m`` heads with the Megatron operators
(``encoder_block(tp=...)``), ``tok_emb`` is a vocab-parallel embedding
and the MLM decoder a vocab-parallel loss (``parallel/tensor.py``).
``mlm_bias`` (V,) is replicated, as in the JAX table, yet a rank adds
only its vocabulary block of it: it enters through ``copy_to_model``, so
its gradient is all-reduced over ``model`` and the ranks keep equal
copies.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.param_init import LeafSpec, draw_device, draw_host
from deepspeed_tpu_torch.ops.normalize import layer_norm as _layer_norm
from deepspeed_tpu_torch.ops.normalize import token_nll
from deepspeed_tpu_torch.ops.transformer.transformer import (
    PARAM_KEYS,
    encoder_block,
    key_padding_bias,
)
from deepspeed_tpu_torch.parallel.sequence import get_global_mesh
from deepspeed_tpu_torch.parallel.tensor import (
    copy_to_model,
    tp_group,
    vocab_parallel_embedding,
    vocab_parallel_nll,
)
from deepspeed_tpu_torch.runtime.zero.partition import materialize, unstack


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = True
    use_flash_attention: bool = True
    remat: bool = True
    # steers the JAX package's XLA layer scan; kept for config
    # compatibility, not read here
    scan_unroll: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def num_params(self) -> int:
        d, l, i = self.hidden_size, self.num_hidden_layers, self.intermediate_size
        per_layer = 4 * d * d + 2 * d * i + 9 * d + i
        emb = (self.vocab_size + self.max_position_embeddings + self.type_vocab_size) * d + 2 * d
        # + the pooler and the MLM transform (d*d + d each), their LN (2d),
        # the MLM bias (vocab) and the NSP head (2d + 2)
        heads = 2 * (d * d + d) + 2 * d + self.vocab_size + 2 * d + 2
        return emb + l * per_layer + heads


BERT_TINY = BertConfig(vocab_size=512, max_position_embeddings=128, hidden_size=64,
                       num_hidden_layers=2, num_attention_heads=4, intermediate_size=128)
BERT_BASE = BertConfig()
BERT_LARGE = BertConfig(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                        intermediate_size=4096)

PRESETS = {"tiny": BERT_TINY, "bert-base": BERT_BASE, "bert-large": BERT_LARGE}

BLOCK_KEYS = PARAM_KEYS  # the encoder layer's weights, stacked under "blocks"
TOP_KEYS = (
    "tok_emb", "pos_emb", "type_emb", "emb_ln_g", "emb_ln_b", "pooler_w", "pooler_b",
    "mlm_dense_w", "mlm_dense_b", "mlm_ln_g", "mlm_ln_b", "mlm_bias", "nsp_w", "nsp_b",
)


def param_specs(cfg: BertConfig) -> Dict[str, Any]:
    """The parameter tree as :class:`~deepspeed_tpu_torch.models.param_init.LeafSpec`
    leaves: normal(0.02) weights, zero biases, unit LayerNorm gains."""
    d, l, i = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    n = lambda *shape: LeafSpec("n", shape, 0.02)  # noqa: E731
    z = lambda *shape: LeafSpec("z", shape)  # noqa: E731
    o = lambda *shape: LeafSpec("o", shape)  # noqa: E731
    return {
        "tok_emb": n(cfg.vocab_size, d),
        "pos_emb": n(cfg.max_position_embeddings, d),
        "type_emb": n(cfg.type_vocab_size, d),
        "emb_ln_g": o(d),
        "emb_ln_b": z(d),
        "blocks": {
            "ln1_g": o(l, d), "ln1_b": z(l, d),
            "qkv_w": n(l, d, 3 * d), "qkv_b": z(l, 3 * d),
            "proj_w": n(l, d, d), "proj_b": z(l, d),
            "ln2_g": o(l, d), "ln2_b": z(l, d),
            "fc_w": n(l, d, i), "fc_b": z(l, i),
            "fc_proj_w": n(l, i, d), "fc_proj_b": z(l, d),
        },
        "pooler_w": n(d, d),
        "pooler_b": z(d),
        # MLM head: transform + tied decoder bias; NSP head
        "mlm_dense_w": n(d, d),
        "mlm_dense_b": z(d),
        "mlm_ln_g": o(d),
        "mlm_ln_b": z(d),
        "mlm_bias": z(cfg.vocab_size),
        "nsp_w": n(d, 2),
        "nsp_b": z(2),
    }


def init_params(cfg: BertConfig, seed: int = 0) -> Dict[str, Any]:
    """BERT init as numpy arrays (:func:`param_specs`).  Same generator,
    draw order and values as the JAX package's ``init_params``."""
    return draw_host(param_specs(cfg), seed)


def init_params_device(cfg: BertConfig, seed: int = 0, dtype: torch.dtype = torch.float32,
                       device: Any = "cuda", keep=None) -> Dict[str, Any]:
    """Random init drawn on ``device`` (the JAX package's
    ``init_params_device``): the tree, shapes and scales of
    :func:`init_params`, an independent stream; see
    ``models/gpt2.py`` ``init_params_device`` for when to use which, and
    for ``keep``."""
    return draw_device(param_specs(cfg), seed, dtype, device, keep)


def params_from_jax(tree: Dict[str, Any], device: Any = "cpu",
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX package's BERT parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) as the port's parameters: the same keys and
    shapes, ``(in, out)`` weights, tensors on ``device`` in ``dtype``
    (default float32).  Refuses a tree with missing or extra keys."""

    def conv(a):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
        return t.to(device=device, dtype=dtype or torch.float32)

    top = set(tree) - {"blocks"}
    blocks = set(tree.get("blocks", {}))
    missing = sorted((set(TOP_KEYS) - top) | {f"blocks/{k}" for k in set(BLOCK_KEYS) - blocks})
    extra = sorted((top - set(TOP_KEYS)) | {f"blocks/{k}" for k in blocks - set(BLOCK_KEYS)})
    if "blocks" not in tree:
        missing.append("blocks")
    if missing or extra:
        raise KeyError(f"BERT parameter tree: missing {missing}, extra {extra}")
    return {**{k: conv(tree[k]) for k in TOP_KEYS},
            "blocks": {k: conv(tree["blocks"][k]) for k in BLOCK_KEYS}}


def _bert_block(cfg: BertConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
                mask_bias: Optional[torch.Tensor], seeds: Optional[tuple],
                deterministic: bool, tp=None) -> torch.Tensor:
    """One encoder block, pre-LN or post-LN: the training layer op's
    :func:`encoder_block` on this layer's slice of the stacked params.
    ``seeds`` (None in eval): ``(s1, s2, attn_key)``, two ints for the
    block's hidden-dropout generators (None without hidden dropout) and
    the attention dropout's key, a pair of uint32 words (None without
    attention dropout; the JAX package's ``r_attn``), so a recomputed block
    draws the same masks."""
    s1, s2, attn_key = seeds or (None, None, None)
    lp = {k: materialize(v) for k, v in lp.items()}
    return encoder_block(
        lp, x, mask_bias, (attn_key, s1, s2), heads=cfg.num_attention_heads,
        pre_layer_norm=cfg.pre_layer_norm, eps=cfg.layer_norm_eps,
        hidden_rate=cfg.hidden_dropout_prob, attn_rate=cfg.attention_probs_dropout_prob,
        use_flash=cfg.use_flash_attention, deterministic=deterministic, tp=tp)


def encode(params: Dict[str, Any], input_ids: torch.Tensor, cfg: BertConfig,
           token_type_ids: Optional[torch.Tensor] = None,
           attention_mask: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None,
           deterministic: bool = True, tp=None) -> torch.Tensor:
    """The encoder: ``input_ids (B, T)`` → hidden states ``(B, T, d)`` in
    the parameters' type.  ``attention_mask`` (B, T), nonzero where a key
    is real, becomes the f32 bias 0 / -1e9 on every head's scores.
    ``generator`` draws the per-layer dropout seeds before the layers run
    (a CPU generator keeps the draw off the device): two hidden-dropout
    seeds where ``hidden_dropout_prob > 0``, then an attention key of two
    uint32 words where ``attention_probs_dropout_prob > 0``; None or
    ``deterministic`` means no dropout.  ``tp``: the ``model`` group when
    the parameters are the rank's tensor-parallel blocks."""
    B, T = input_ids.shape
    dtype = params["blocks"]["qkv_w"].dtype
    x = (vocab_parallel_embedding(materialize(params["tok_emb"]), input_ids.long(), tp)
         + materialize(params["pos_emb"])[:T][None])
    type_emb = materialize(params["type_emb"])
    if token_type_ids is None:
        # absent segment ids mean "all segment A": the type-0 embedding is
        # still added
        x = x + type_emb[0][None, None]
    else:
        x = x + type_emb[token_type_ids.long()]
    x = _layer_norm(x.to(dtype), materialize(params["emb_ln_g"]), materialize(params["emb_ln_b"]),
                    cfg.layer_norm_eps)

    mask_bias = key_padding_bias(attention_mask, x.device)

    L = cfg.num_hidden_layers
    layers = {key: unstack(params["blocks"][key]) for key in BLOCK_KEYS}
    seeds = [None] * L
    if generator is not None and not deterministic:
        hidden, attn = [(None, None)] * L, [None] * L
        if cfg.hidden_dropout_prob > 0.0:
            hidden = torch.randint(0, 2**62, (L, 2), generator=generator,
                                   device=generator.device).tolist()
        if cfg.attention_probs_dropout_prob > 0.0:
            attn = [tuple(a) for a in torch.randint(0, 2**32, (L, 2), generator=generator,
                                                    dtype=torch.int64,
                                                    device=generator.device).tolist()]
        seeds = [(s1, s2, a) for (s1, s2), a in zip(hidden, attn)]
    block_fn = functools.partial(_bert_block, cfg, tp=tp)
    for i in range(L):
        lp = {key: layers[key][i] for key in BLOCK_KEYS}
        if cfg.remat:
            x = checkpoint(block_fn, x, lp, mask_bias, seeds[i], deterministic,
                           use_reentrant=False)
        else:
            x = block_fn(x, lp, mask_bias, seeds[i], deterministic)
    return x


def mlm_nsp_loss(params: Dict[str, Any], batch: Dict[str, Any], generator=None,
                 cfg: BertConfig = None, deterministic: bool = False) -> torch.Tensor:
    """Pretraining loss: masked-LM plus next-sentence prediction.

    ``batch``: ``input_ids``, ``masked_lm_labels`` (-100 = not masked),
    optional ``token_type_ids`` / ``attention_mask`` /
    ``next_sentence_label``.  Under the ambient mesh's ``model`` axis the
    decoder's logits are this rank's vocabulary block (module
    docstring)."""
    tp = tp_group(get_global_mesh())
    x = encode(params, batch["input_ids"], cfg, token_type_ids=batch.get("token_type_ids"),
               attention_mask=batch.get("attention_mask"), generator=generator,
               deterministic=deterministic, tp=tp)
    params = {k: materialize(v) for k, v in params.items() if k != "blocks"}
    # MLM: transform, then the decoder tied to the token embeddings
    h = x @ params["mlm_dense_w"].to(x.dtype) + params["mlm_dense_b"].to(x.dtype)
    h = F.gelu(h)
    h = _layer_norm(h, params["mlm_ln_g"], params["mlm_ln_b"], cfg.layer_norm_eps)
    bias = params["mlm_bias"]
    if tp is not None:
        n = params["tok_emb"].shape[0]
        bias = copy_to_model(bias, tp)[tp.rank * n:(tp.rank + 1) * n]
    logits = (copy_to_model(h, tp) @ params["tok_emb"].t().to(h.dtype)).float() + bias
    labels = batch["masked_lm_labels"].long()
    valid = (labels >= 0).float()
    nll = vocab_parallel_nll(logits, torch.where(labels >= 0, labels, torch.zeros_like(labels)),
                             tp) * valid
    loss = nll.sum() / torch.clamp(valid.sum(), min=1.0)
    if "next_sentence_label" in batch:
        pooled = torch.tanh(x[:, 0] @ params["pooler_w"].to(x.dtype)
                            + params["pooler_b"].to(x.dtype))
        nsp_logits = (pooled @ params["nsp_w"].to(pooled.dtype)
                      + params["nsp_b"].to(pooled.dtype)).float()
        loss = loss + token_nll(nsp_logits, batch["next_sentence_label"]).mean()
    return loss


def tp_spec_fn(path: str, shape) -> Any:
    """The tensor-parallel base spec of a BERT leaf: the JAX package's
    ``bert`` rule table (qkv/fc column-parallel, proj/fc_proj
    row-parallel, ``tok_emb`` by vocabulary)."""
    from deepspeed_tpu_torch.sharding.rules import rules_for_family

    return rules_for_family("bert").spec(path, shape)


def check_mesh(cfg: BertConfig, sizes: Dict[str, int]) -> None:
    """What the port refuses of a mesh for BERT, at ``initialize``: a
    ``seq`` axis (no sequence-parallel mode) and heads the ``model`` axis
    does not divide (a tensor-parallel rank runs whole heads)."""
    m, P = int(sizes.get("model", 1)), int(sizes.get("seq", 1))
    if P > 1:
        raise ValueError(f"BERT has no sequence-parallel mode: a seq axis of {P} is refused")
    if m > 1 and cfg.num_attention_heads % m:
        raise ValueError(f"num_attention_heads {cfg.num_attention_heads} is not divisible by "
                         f"the model axis ({m}): a tensor-parallel rank runs whole heads "
                         "(ROADMAP C4)")


def parallel_comm_model(cfg: BertConfig, sizes: Dict[str, int], rows: int, T: int,
                        act_bytes: int, gas: int = 1, labels_given: bool = False) -> Dict[str, int]:
    """``runtime/zero/stages.py::port_parallel_comm_model`` for this
    config: the MLM loss over every position (``rows * T``), and the
    ``mlm_bias`` gradient's all-reduce over ``model`` (each rank adds only
    its vocabulary slice), ``2 V act_bytes``."""
    from deepspeed_tpu_torch.runtime.zero.stages import port_parallel_comm_model

    return port_parallel_comm_model(
        cfg.num_hidden_layers, cfg.hidden_size, rows, T, sizes, loss_positions=rows * T,
        tp_extra_bytes=2 * cfg.vocab_size * act_bytes, gas=gas, act_bytes=act_bytes,
        remat=cfg.remat,
        mlp_recompute=cfg.remat and (cfg.hidden_dropout_prob > 0.0 or not cfg.pre_layer_norm))


def make_model(cfg: BertConfig):
    """Returns ``(model_fn, init_fn, tp_spec_fn)``; ``model_fn(params,
    batch, generator) -> loss`` plugs into
    ``deepspeed_tpu_torch.initialize(model=...)``.  ``generator=None``
    means eval.  ``tp_spec_fn`` gives the tensor-parallel leaves' specs
    (pass it to ``initialize`` for a ``model`` axis, with
    ``mesh_check=functools.partial(check_mesh, cfg)`` for this config's
    refusals and ``comm_model=functools.partial(parallel_comm_model,
    cfg)``)."""

    def model_fn(params, batch, generator):
        deterministic = generator is None or (cfg.hidden_dropout_prob == 0.0
                                              and cfg.attention_probs_dropout_prob == 0.0)
        return mlm_nsp_loss(params, batch, generator=generator, cfg=cfg,
                            deterministic=deterministic)

    return model_fn, functools.partial(init_params, cfg), tp_spec_fn
