"""GPT-2 family: configuration, presets, parameters, forward and loss
(counterpart of ``deepspeed_tpu/models/gpt2.py``).

Parameters are a plain dictionary of tensors in the JAX package's layout:
``wte`` (V, d), ``wpe`` (n_positions, d), the per-layer weights stacked
on a leading layer dim under ``blocks``, and the final LayerNorm.  Weight
matrices keep the ``(in, out)`` layout, so ``h @ w`` is the projection
on both sides of the port.

The layer loop is a Python loop over the stacked parameters (``unbind``
once per key, so the backward stacks each key's gradient once); with
``remat`` (the default) each block runs under ``torch.utils.checkpoint``
and is recomputed in the backward, keeping what its policy saves
(``runtime/activation_checkpointing/checkpointing.py``):
``remat_policy`` ``nothing_saveable`` (the default; under an engine whose
``activation_checkpointing`` block sets ``cpu_checkpointing``, the weight
matmuls' outputs and the block's input wait on the host),
``everything_saveable`` (no recompute), ``dots_saveable``,
``dots_with_no_batch_dims_saveable``, or ``remat_save_names`` over the
JAX tags ``qkv``, ``attn_ctx``, ``ffn_pre`` (``saved_matmul`` /
``saved_value``: the projections kept before their bias add) and
``attn_o`` / ``attn_lse``, the attention kernel's output and log-sum-exp.
With both of those saved the recompute takes them back instead of
launching the forward kernel (B1) again, so a micro-step launches B1 once
a layer, not twice, and the backward kernel runs from them.  The
checkpoint's ``context_fn`` carries the policy out, rather than explicit
segments: a segment boundary keeps every tensor that crosses it and still
recomputes the op that made the saved value.

**Progressive layer drop**: a batch carrying
``runtime/progressive_layer_drop.PLD_THETA_KEY`` (the engine's theta) keeps
layer l with probability ``1 - (l+1)/L * (1 - theta)`` when training
(a generator, not deterministic), drawn on the host from the generator
after the dropout seeds; a dropped layer is skipped whole (no kernel
launch), a kept layer's residual delta is scaled by ``1 / keep_p``.

Under ZeRO stage 3 a sharded leaf arrives as a handle
(``runtime/zero/partition.py``): :func:`materialize` gathers the
embeddings and the final LayerNorm once per forward, and a block's
weights inside the block (its checkpoint region), so the recompute
gathers them again and they are freed after the block.

**Tensor parallelism** (a ``model`` axis of m > 1 ranks in the engine's
ambient mesh): the tensor-parallel leaves arrive as the rank's blocks
(``tp_spec_fn``: the JAX package's ``gpt2`` rule table) and a block runs
over the rank's ``n_head / m`` heads with the Megatron operators of
``parallel/tensor.py``: ``copy_to_model`` before ``qkv`` and ``fc``,
``reduce_from_model`` after ``proj`` and ``fc_proj``, whose replicated
biases are added after the reduction; the token embedding and the tied
head are vocab-parallel (the loss from ``vocab_parallel_nll``).
**Sequence parallelism** (a ``seq`` axis of P > 1, ``attention_mode``
``ring`` or ``ulysses``, ``parallel/sequence.py``): the rank runs its
positions ``[r*T/P, (r+1)*T/P)`` of every row (the position embedding's
rows too); the label of its last position is the next shard's first
token, taken from the whole rows before the cut, and the sequence's last
position is masked on the last rank.  The loss is the token NLLs' sum
all-reduced over ``seq`` over the global count, as ``jnp.mean`` (or the
masked mean) gives it.  With one rank on either axis the arithmetic is
the one-device model's."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.param_init import LeafSpec, draw_device, draw_host
from deepspeed_tpu_torch.moe.layer import (
    MOE_PARAM_KEYS,
    MoEConfig,
    expert_group,
    init_moe_params,
    moe_ffn_from_block,
    recompute_contexts,
    route_group,
)
from deepspeed_tpu_torch.ops.attention.flash_attention import flash_attention, mha_reference
from deepspeed_tpu_torch.ops.attention.sparse import BigBirdSparsityConfig, block_sparse_attention
from deepspeed_tpu_torch.ops.normalize import dropout as _dropout
from deepspeed_tpu_torch.ops.normalize import dropout_generator
from deepspeed_tpu_torch.ops.normalize import layer_norm as _layer_norm
from deepspeed_tpu_torch.parallel import sequence as _seq
from deepspeed_tpu_torch.parallel.tensor import (
    copy_to_model,
    reduce_from_model,
    tp_group,
    vocab_parallel_embedding,
    vocab_parallel_nll,
)
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as _act_ckpt
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
    saved_matmul,
    saved_value,
)
from deepspeed_tpu_torch.runtime.progressive_layer_drop import PLD_THETA_KEY, layer_keep_probs
from deepspeed_tpu_torch.runtime.zero.partition import materialize, unstack


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
    # "flash" | "ring" | "ulysses" | "sparse": ring/ulysses run sequence
    # parallel over the mesh's `seq` axis (parallel/sequence.py); sparse
    # runs the block-sparse kernels with `sparsity_config` (default:
    # unidirectional BigBird), the long-sequence recipe
    attention_mode: str = "flash"
    # a SparsityConfig instance (ops/attention/sparse.py); None: BigBird
    sparsity_config: Any = None
    # MoE: >0 replaces every block's FFN with an n_experts MoE layer
    # (experts cut over the `expert` mesh axis, moe/layer.py)
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    remat: bool = True  # activation checkpointing per block
    # >0: cross-entropy in time-chunks of this size, each recomputed in the
    # backward, so the (B, T, vocab) logits never materialize whole
    xent_chunk_size: int = 0
    # nothing_saveable | everything_saveable | dots_saveable |
    # dots_with_no_batch_dims_saveable (runtime/activation_checkpointing)
    remat_policy: str = "nothing_saveable"
    # selective remat: non-empty overrides remat_policy with the tags kept
    # (qkv, attn_ctx, ffn_pre, attn_o, attn_lse)
    remat_save_names: tuple = ()
    # scan_unroll and flash_blocks steer the JAX package's XLA layer scan
    # and Pallas tiles; kept for config compatibility, not read here
    scan_unroll: int = 1
    flash_blocks: tuple = ()

    def __post_init__(self):
        self.save_policy()  # refuses an unported policy or an unknown name

    def save_policy(self) -> "_act_ckpt.SavePolicy":
        """The block checkpoint's save policy: ``remat_save_names`` when
        set, else ``remat_policy``."""
        return _act_ckpt.SavePolicy(self.remat_policy, tuple(self.remat_save_names))

    @property
    def head_dim(self) -> int:
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} is not a multiple of n_head={self.n_head}")
        return self.n_embd // self.n_head

    def num_params(self) -> int:
        d, l, v, s = self.n_embd, self.n_layer, self.vocab_size, self.n_positions
        if self.n_experts > 0:
            E = self.n_experts
            # attention (qkv+proj) + LNs + router + E expert FFNs
            per_layer = 4 * d * d + 8 * d + d * E + E * (8 * d * d + 5 * d)
        else:
            per_layer = 12 * d * d + 13 * d
        return v * d + s * d + l * per_layer + 2 * d


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
# a MoE block: the attention half and the expert FFN (moe/layer.py)
MOE_BLOCK_KEYS = BLOCK_KEYS[:8] + MOE_PARAM_KEYS


def block_keys(cfg: GPT2Config) -> tuple:
    return MOE_BLOCK_KEYS if cfg.n_experts > 0 else BLOCK_KEYS


# the JAX package's ``init_params`` draws the MLP's leaves first
_FFN_FIRST = ("blocks/fc_w", "blocks/fc_b", "blocks/fc_proj_w", "blocks/fc_proj_b")


def param_specs(cfg: GPT2Config) -> Dict[str, Any]:
    """The parameter tree as :class:`~deepspeed_tpu_torch.models.param_init.LeafSpec`
    leaves: normal(0.02), ``wpe`` normal(0.01), residual projections
    scaled by 1/sqrt(2*n_layer), zero biases, unit LayerNorm gains.  Both
    inits draw it, and an engine checks its shapes before any leaf
    exists."""
    d, l = cfg.n_embd, cfg.n_layer
    std, proj_std = 0.02, 0.02 / np.sqrt(2 * l)
    n = lambda *shape, s=std: LeafSpec("n", shape, s)  # noqa: E731
    z = lambda *shape: LeafSpec("z", shape)  # noqa: E731
    o = lambda *shape: LeafSpec("o", shape)  # noqa: E731
    if cfg.n_experts > 0:
        E = cfg.n_experts
        ffn = {"gate_w": n(l, d, E), "w1": n(l, E, d, 4 * d), "b1": z(l, E, 4 * d),
               "w2": n(l, E, 4 * d, d, s=proj_std), "b2": z(l, E, d)}
    else:
        ffn = {"fc_w": n(l, d, 4 * d), "fc_b": z(l, 4 * d),
               "fc_proj_w": n(l, 4 * d, d, s=proj_std), "fc_proj_b": z(l, d)}
    return {
        "wte": n(cfg.vocab_size, d),
        "wpe": n(cfg.n_positions, d, s=0.01),
        "blocks": {
            "ln1_g": o(l, d), "ln1_b": z(l, d),
            "qkv_w": n(l, d, 3 * d), "qkv_b": z(l, 3 * d),
            "proj_w": n(l, d, d, s=proj_std), "proj_b": z(l, d),
            "ln2_g": o(l, d), "ln2_b": z(l, d),
            **ffn,
        },
        "lnf_g": o(d),
        "lnf_b": z(d),
    }


def init_params(cfg: GPT2Config, seed: int = 0) -> Dict[str, Any]:
    """GPT-2 init as numpy arrays (:func:`param_specs`).  Same generator,
    draw order and values as the JAX package's ``init_params``: the FFN
    first (a MoE model's layer by layer, ``init_moe_params``), then the
    rest in the tree's order."""
    if cfg.n_experts == 0:
        return draw_host(param_specs(cfg), seed, first=_FFN_FIRST)
    d, l = cfg.n_embd, cfg.n_layer
    std = 0.02
    rng = np.random.default_rng(seed)
    mcfg = MoEConfig(num_experts=cfg.n_experts, d_model=d, d_ff=4 * d)
    per_layer = [init_moe_params(mcfg, rng, std=std, proj_std=std / np.sqrt(2 * l))
                 for _ in range(l)]
    specs = param_specs(cfg)
    for k in MOE_PARAM_KEYS:
        specs["blocks"].pop(k)
    out = draw_host(specs, seed, rng=rng)
    out["blocks"].update({k: np.stack([p[k] for p in per_layer]) for k in MOE_PARAM_KEYS})
    return out


def init_params_device(cfg: GPT2Config, seed: int = 0, dtype: torch.dtype = torch.float32,
                       device: Any = "cuda", keep=None) -> Dict[str, Any]:
    """Random init drawn on ``device`` (the JAX package's
    ``init_params_device``): the tree, shapes and scales of
    :func:`init_params`, an independent stream (not bitwise-equal to the
    host init).  For serving paths where drawing an XL-class model on the
    host and copying it costs more than drawing it on the card.  ``keep``:
    see ``param_init.draw_device`` (``InferenceEngine`` passes a rank's
    cut)."""
    if cfg.n_experts > 0:
        raise NotImplementedError("device init does not cover MoE; use init_params")
    return draw_device(param_specs(cfg), seed, dtype, device, keep)


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
    keys = MOE_BLOCK_KEYS if "gate_w" in tree["blocks"] else BLOCK_KEYS
    if set(tree["blocks"]) != set(keys):
        raise KeyError(f"GPT-2 blocks carry {sorted(tree['blocks'])}, expected {sorted(keys)}")
    return {
        "wte": conv(tree["wte"]),
        "wpe": conv(tree["wpe"]),
        "blocks": {k: conv(tree["blocks"][k]) for k in keys},
        "lnf_g": conv(tree["lnf_g"]),
        "lnf_b": conv(tree["lnf_b"]),
    }


# per-(config values, seq) layout cache: layouts are static numpy, built once
_SPARSE_LAYOUTS: Dict[Any, Any] = {}


def _sparsity_cache_key(sc, T: int):
    # by value: id() would collide after gc and never hit for per-call
    # default configs
    vals = tuple(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in sorted(vars(sc).items())
        if isinstance(v, (int, float, str, bool, list, tuple, type(None)))
    )
    return (type(sc).__name__, vals, T)


def sparse_layout(cfg: GPT2Config, T: int):
    """``(layout, block)`` of the sparse attention at length ``T``: the
    config's ``sparsity_config``, or the default unidirectional BigBird
    (one random block, a window of 3, one global block) at the largest
    block of 256/128/64/16 that divides T with at least the 3-block window
    (make_layout refuses fewer).  Cached by config values."""
    sc = cfg.sparsity_config
    if sc is None:
        block = next((b for b in (256, 128, 64, 16) if T % b == 0 and T // b >= 3), 16)
        sc = BigBirdSparsityConfig(
            num_heads=cfg.n_head, block=block, num_random_blocks=1,
            num_sliding_window_blocks=3, num_global_blocks=1, attention="unidirectional",
        )
    key = _sparsity_cache_key(sc, T)
    if key not in _SPARSE_LAYOUTS:
        _SPARSE_LAYOUTS[key] = sc.make_layout(T)
    return _SPARSE_LAYOUTS[key], sc.block


def _sparse_attn(cfg: GPT2Config, q, k, v, T: int, tp=None):
    layout, block = sparse_layout(cfg, T)
    if tp is not None:  # this rank's heads of the per-head layout
        n = q.shape[1]
        layout = layout[tp.rank * n:(tp.rank + 1) * n]
    return block_sparse_attention(q, k, v, layout, block, causal=True)


class _Parallel:
    """What a forward reads of the ambient mesh: the ``model`` group (None
    for one rank), this rank's place on ``seq`` (``P`` ranks), the
    ``expert`` group, and (``route_dp``: a training loss) the data-parallel
    grid a MoE layer routes over."""

    __slots__ = ("mesh", "tp", "P", "r", "ep", "dp")

    def __init__(self, route_dp: bool = False):
        self.mesh = _seq.get_global_mesh()
        self.tp = tp_group(self.mesh)
        self.P = 1 if self.mesh is None else int(self.mesh.sizes.get("seq", 1))
        self.r = 0 if self.P == 1 else int(self.mesh.coords["seq"])
        self.ep = expert_group(self.mesh)
        self.dp = route_group(self.mesh) if route_dp else None

    def fold(self, seed: Optional[int], tp_too: bool = False) -> Optional[int]:
        """A dropout seed of this rank's own: its ``seq`` place (and its
        ``model`` place for an activation cut over ``model``) folded in, so
        shards draw masks of their own (unchanged on one rank)."""
        if seed is None:
            return None
        k = self.r * (self.tp.size if self.tp else 1) + (self.tp.rank if tp_too and self.tp else 0)
        return seed + k * (1 << 40)


def _block(cfg: GPT2Config, x: torch.Tensor, lp: Dict[str, torch.Tensor],
           seeds: Optional[tuple], deterministic: bool,
           par: Optional[_Parallel] = None, training: bool = False,
           token_mask: Optional[torch.Tensor] = None):
    """One transformer block; ``lp`` holds this layer's slice of the
    stacked params (the rank's blocks under tensor parallelism).
    ``seeds``: three ints for the block's dropout generators (None in
    eval), so a recomputed block draws the same masks.  Returns ``(x,
    aux)``: the MoE layer's load-balancing loss (zero for a dense block).
    ``training`` (a generator was threaded in, the JAX package's ``rng is
    not None``) picks the MoE's training capacity; ``token_mask`` keeps
    pads out of its routing."""
    B, T, D = x.shape
    tp = par.tp if par is not None else None
    H, hd = cfg.n_head // (tp.size if tp else 1), cfg.head_dim
    s1, s2, s3 = seeds or (None,) * 3
    if par is not None:
        s1, s2, s3 = par.fold(s1), par.fold(s2, tp_too=True), par.fold(s3)
    r1, r2, r3 = (dropout_generator(s, x.device) for s in (s1, s2, s3))
    lp = {k: materialize(v) for k, v in lp.items()}

    h = _layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.layer_norm_epsilon)
    h = copy_to_model(h, tp)
    qkv = saved_matmul("qkv", h, lp["qkv_w"].to(h.dtype)) + lp["qkv_b"].to(h.dtype)
    q, k, v = qkv.split(H * hd, dim=-1)

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if cfg.attention_mode == "sparse":
        attn = _sparse_attn(cfg, q, k, v, T, tp)
    elif cfg.attention_mode == "ring":
        # the forward's mesh, also when the recompute runs in the backward
        attn = _seq.ring_attention(q, k, v, causal=True, mesh=par.mesh if par else None)
    elif cfg.attention_mode == "ulysses":
        attn = _seq.ulysses_attention(q, k, v, causal=True, mesh=par.mesh if par else None,
                                      use_flash=cfg.use_flash_attention)
    elif cfg.attention_mode != "flash":
        raise ValueError(f"unknown attention_mode {cfg.attention_mode!r} (flash|ring|ulysses|sparse)")
    elif cfg.use_flash_attention and T >= 128:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = mha_reference(q, k, v, causal=True)
    attn = saved_value("attn_ctx", lambda: attn.transpose(1, 2).reshape(B, T, H * hd))
    attn = reduce_from_model(attn @ lp["proj_w"].to(attn.dtype), tp) + lp["proj_b"].to(attn.dtype)
    x = x + _dropout(attn, cfg.dropout, r1, deterministic)

    h = _layer_norm(x, lp["ln2_g"], lp["ln2_b"], cfg.layer_norm_epsilon)
    if cfg.n_experts > 0:
        h, aux = moe_ffn_from_block(
            lp, h, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
            generator=r2, training=training, token_mask=token_mask,
            ep=par.ep if par is not None else None, tp=tp,
            dp=par.dp if par is not None else None)
    else:
        h = copy_to_model(h, tp)
        h = saved_matmul("ffn_pre", h, lp["fc_w"].to(h.dtype)) + lp["fc_b"].to(h.dtype)
        h = F.gelu(h, approximate="tanh")
        h = _dropout(h, cfg.dropout, r2, deterministic)
        h = reduce_from_model(h @ lp["fc_proj_w"].to(h.dtype), tp) + lp["fc_proj_b"].to(h.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + _dropout(h, cfg.dropout, r3, deterministic), aux


def _run_block(cfg: GPT2Config, block_fn, x, lp, seeds, deterministic: bool):
    """One block under the config's remat: checkpointed with its save
    policy (a MoE block's recompute records no drops, ``moe/layer.py``
    ``record_drops``), run as is under ``everything_saveable`` or without
    ``remat``.  Under ``nothing_saveable`` the engine's configured
    ``activation_checkpointing`` block decides (``cpu_checkpointing``: the
    weight matmuls' outputs and the block's input on the host)."""
    policy = cfg.save_policy()
    if not cfg.remat or policy.kind == "everything_saveable" and not policy.names:
        return block_fn(x, lp, seeds, deterministic)
    if policy.saves_nothing:
        policy = _act_ckpt.config_policy()
    extra = recompute_contexts if cfg.n_experts > 0 else None
    return _act_ckpt.remat(block_fn, x, lp, seeds, deterministic, policy=policy,
                           offload_args=(0,), context_fn=extra)


def apply(params: Dict[str, Any], tokens: torch.Tensor, cfg: GPT2Config,
          generator: Optional[torch.Generator] = None, deterministic: bool = True,
          return_hidden: bool = False, par: Optional[_Parallel] = None,
          return_aux: bool = False, token_mask: Optional[torch.Tensor] = None,
          pld_theta=None):
    """Forward pass: ``tokens (B, T)`` → logits ``(B, T, V)`` in the
    parameters' type.  ``return_hidden=True`` returns the post-final-LN
    hidden states (B, T, D) instead (the chunked-xent loss).
    ``generator`` draws the dropout seeds (a CPU generator keeps the draw
    off the device); None or ``deterministic`` means no dropout.  Under
    the ambient mesh's ``seq`` axis the result covers this rank's
    positions, under its ``model`` axis the logits this rank's vocabulary
    block (module docstring).  ``return_aux=True`` also returns the MoE
    load-balancing loss summed over the blocks (zero for a dense model);
    ``token_mask (B, T)`` keeps pads out of the MoE routing.  ``pld_theta``:
    progressive layer drop's theta (module docstring)."""
    par = par or _Parallel()
    B, T = tokens.shape
    pos = slice(0, T)
    if par.P > 1:
        _seq.check_seq_len(T, par.P)
        pos = _seq.local_positions(par.mesh, T)
    wte = materialize(params["wte"])
    x = _embed(wte, materialize(params["wpe"]), tokens, pos, par.tp)
    x = x.to(params["blocks"]["qkv_w"].dtype)
    keys = block_keys(cfg)
    layers = {key: unstack(params["blocks"][key]) for key in keys}
    seeds = _layer_seeds(cfg, None if deterministic else generator)
    if token_mask is not None:
        token_mask = token_mask[:, pos]
    block_fn = functools.partial(_block, cfg, par=par, training=generator is not None,
                                 token_mask=token_mask)
    keep_probs = kept = None
    if pld_theta is not None and generator is not None and not deterministic:
        keep_probs = layer_keep_probs(pld_theta, cfg.n_layer)
        kept = (torch.rand(cfg.n_layer, generator=generator) < keep_probs).tolist()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layer):
        if kept is not None and not kept[i]:
            continue  # a dropped layer: nothing runs
        lp = {key: layers[key][i] for key in keys}
        y, aux = _run_block(cfg, block_fn, x, lp, seeds[i], deterministic)
        if keep_probs is not None:
            # the residual delta scaled by 1/keep_p: the training-time
            # expectation is the deterministic forward's
            y = x + (y - x) / float(keep_probs[i].to(y.dtype))
        x = y
        aux_total = aux_total + aux
    x = _head(x, materialize(params["lnf_g"]), materialize(params["lnf_b"]), wte, cfg,
              return_hidden, par.tp)
    return (x, aux_total) if return_aux else x


def _embed(wte: torch.Tensor, wpe: torch.Tensor, tokens: torch.Tensor, pos: slice, tp=None):
    """Token + position embedding of the positions ``pos`` of ``tokens``."""
    return vocab_parallel_embedding(wte, tokens[:, pos].long(), tp) + wpe[pos][None]


def _head(x: torch.Tensor, lnf_g, lnf_b, wte: torch.Tensor, cfg: GPT2Config,
          return_hidden: bool, tp=None) -> torch.Tensor:
    """The final LayerNorm, then the tied embedding head (the logits), or
    the normed hidden states with ``return_hidden``."""
    x = _layer_norm(x, lnf_g, lnf_b, cfg.layer_norm_epsilon)
    if not return_hidden:
        x = copy_to_model(x, tp) @ wte.t().to(x.dtype)
    return x


def _xent_chunk(xc, wte, lc, mc, tp=None):
    logits = xc @ wte.t().to(xc.dtype)
    nll = vocab_parallel_nll(logits, lc, tp) * mc
    return nll.sum(), mc.sum()


def _chunked_sums(hidden: torch.Tensor, wte: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, chunk: int, tp=None):
    """The masked next-token NLL's ``(sum, count)`` computed per
    time-chunk, each chunk recomputed in the backward: peak memory holds
    one chunk of logits instead of the whole (B, T, V) tensor."""
    T = hidden.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, T, chunk):
        s, c = checkpoint(_xent_chunk, hidden[:, c0:c0 + chunk], wte, labels[:, c0:c0 + chunk],
                          mask[:, c0:c0 + chunk], tp, use_reentrant=False)
        total = total + s
        count = count + c
    return total, count


def _seq_labels(batch: Dict[str, Any], tokens: torch.Tensor, pos: slice):
    """This ``seq`` rank's labels and label mask, taken from the whole rows
    before the cut: the next token of each of its positions (the first
    token of the next shard for its last one); the sequence's last
    position, which has none, is masked."""
    mask = batch.get("attention_mask")
    if "labels" in batch:
        labels = batch["labels"][:, pos]
        mask = mask[:, pos].float() if mask is not None else torch.ones(
            labels.shape, dtype=torch.float32, device=labels.device)
        return labels, mask
    B, T = tokens.shape
    pad = torch.zeros((B, 1), dtype=tokens.dtype, device=tokens.device)
    labels = torch.cat([tokens[:, 1:], pad], dim=1)[:, pos]
    keep = torch.ones((B, T), dtype=torch.float32, device=tokens.device)
    keep[:, T - 1] = 0.0
    if mask is not None:
        keep = keep * torch.cat([mask[:, 1:].float(), pad.float()], dim=1)
    return labels, keep[:, pos]


def loss_fn(params: Dict[str, Any], batch: Dict[str, Any], generator=None,
            cfg: GPT2Config = None, deterministic: bool = False) -> torch.Tensor:
    """Next-token cross entropy.  ``batch``: {"input_ids": (B, T)} with
    optional "labels" (default: shifted input_ids) and "attention_mask"."""
    par = _Parallel(route_dp=True)
    tokens = batch["input_ids"]
    chunked = cfg.xent_chunk_size > 0
    moe = cfg.n_experts > 0
    out, moe_aux = apply(params, tokens, cfg, generator=generator, deterministic=deterministic,
                         return_hidden=chunked, par=par, return_aux=True,
                         token_mask=batch.get("attention_mask") if moe else None,
                         pld_theta=batch.get(PLD_THETA_KEY))
    aux = cfg.moe_aux_weight * moe_aux if moe else 0.0
    return _head_nll(out, materialize(params["wte"]), batch, cfg, par) + aux


def _head_nll(out: torch.Tensor, wte: torch.Tensor, batch: Dict[str, Any], cfg: GPT2Config,
              par: _Parallel) -> torch.Tensor:
    """The mean masked next-token NLL of :func:`_head`'s output ``out``:
    the logits, or under ``xent_chunk_size`` the hidden states, whose
    logits against ``wte`` are made chunk by chunk."""
    tokens = batch["input_ids"]
    chunked = cfg.xent_chunk_size > 0
    if chunked:  # the hidden states feed the vocab-parallel head
        out = copy_to_model(out, par.tp)
    if par.P > 1:
        labels, mask = _seq_labels(batch, tokens, _seq.local_positions(par.mesh, tokens.shape[1]))
        out_shift = out
    # mask indexes the *label* position (tokens[:, 1:]), not the query
    elif "labels" in batch:
        labels, out_shift = batch["labels"], out
        mask = batch.get("attention_mask")
        mask = mask[:, : labels.shape[1]].float() if mask is not None else None
    else:
        labels, out_shift = tokens[:, 1:], out[:, :-1]
        mask = batch.get("attention_mask")
        mask = mask[:, 1: 1 + labels.shape[1]].float() if mask is not None else None

    if chunked:
        ones = torch.ones(labels.shape, dtype=torch.float32, device=out.device) if mask is None else mask
        total, count = _chunked_sums(out_shift, wte, labels, ones, cfg.xent_chunk_size, par.tp)
    else:
        nll = vocab_parallel_nll(out_shift, labels, par.tp)
        if mask is None:
            return nll.mean()
        total, count = (nll * mask).sum(), mask.sum()
    if par.P > 1:
        total, count = _seq.reduce_from_seq(torch.stack([total, count]), par.mesh)
    return total / torch.clamp(count, min=1.0)


def _layer_seeds(cfg: GPT2Config, generator: Optional[torch.Generator]) -> list:
    """Every layer's three dropout seeds, drawn as :func:`apply` draws them
    (None per layer without dropout or without a generator)."""
    if generator is None or cfg.dropout == 0.0:
        return [None] * cfg.n_layer
    draw = torch.randint(0, 2**62, (cfg.n_layer, 3), generator=generator, device=generator.device)
    return [tuple(row) for row in draw.tolist()]


def _stream_embed(cfg: GPT2Config, resident: Dict[str, torch.Tensor], tokens: torch.Tensor):
    """The streaming engine's first stage: :func:`apply`'s embedding (the
    JAX package's ``_stream_embed``)."""
    return _embed(resident["wte"], resident["wpe"], tokens, slice(0, tokens.shape[1]))


def _stream_group(cfg: GPT2Config, gblocks: Dict[str, torch.Tensor], x: torch.Tensor,
                  seeds: list, deterministic: bool, remat: bool = True):
    """The streaming engine's repeated stage: the blocks of one layer
    group (``gblocks`` leaves lead with the group's layers), each under
    ``torch.utils.checkpoint`` when ``remat`` (the JAX ``_stream_group``'s
    per-block remat) with the config's save policy, as :func:`apply`;
    ``seeds``: the group's layers' dropout seeds.  Progressive layer drop
    does not apply (the JAX package's streamed group takes no theta)."""
    keys = block_keys(cfg)
    layers = {key: unstack(gblocks[key]) for key in keys}
    block_fn = functools.partial(_block, cfg, par=_Parallel(), training=seeds[0] is not None)
    run_cfg = cfg if remat == cfg.remat else dataclasses.replace(cfg, remat=remat)
    for j in range(len(layers[keys[0]])):
        lp = {key: layers[key][j] for key in keys}
        x, _ = _run_block(run_cfg, block_fn, x, lp, seeds[j], deterministic)
    return x


def _stream_head_loss(cfg: GPT2Config, resident: Dict[str, torch.Tensor], x: torch.Tensor,
                      batch: Dict[str, Any]) -> torch.Tensor:
    """The streaming engine's last stage: :func:`apply`'s head and
    :func:`loss_fn`'s loss (chunked when configured)."""
    out = _head(x, resident["lnf_g"], resident["lnf_b"], resident["wte"], cfg,
                cfg.xent_chunk_size > 0)
    return _head_nll(out, resident["wte"], batch, cfg, _Parallel())


def tp_spec_fn(path: str, shape) -> Any:
    """The tensor-parallel base spec of a GPT-2 leaf: the JAX package's
    ``gpt2`` rule table (qkv/fc column-parallel, proj/fc_proj
    row-parallel, ``wte`` by vocabulary)."""
    from deepspeed_tpu_torch.sharding.rules import rules_for_family

    return rules_for_family("gpt2").spec(path, shape)


def check_mesh(cfg: GPT2Config, sizes: Dict[str, int]) -> None:
    """What the port refuses of a mesh for this config, at ``initialize``:
    heads the ``model`` axis does not divide (a rank runs whole heads),
    ``n_positions`` the ``seq`` axis does not divide (the JAX package's
    wording), a ``seq`` axis under an attention other than ``ring`` or
    ``ulysses``, and Ulysses over heads the ``seq`` axis does not divide
    (a rank's ``n_head / model`` heads)."""
    m, P = int(sizes.get("model", 1)), int(sizes.get("seq", 1))
    ep = int(sizes.get("expert", 1))
    if cfg.n_experts > 0 and cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} is not divisible by the expert axis ({ep})")
    if cfg.n_experts > 0 and P > 1:
        raise ValueError("a MoE GPT-2 under a seq axis would route each rank's positions apart "
                         "from the rest of its rows: not ported (ROADMAP C4)")
    if m > 1 and cfg.n_head % m:
        raise ValueError(f"n_head {cfg.n_head} is not divisible by the model axis ({m}): "
                         "a tensor-parallel rank runs whole heads (ROADMAP C4)")
    if P > 1:
        if cfg.attention_mode not in ("ring", "ulysses"):
            raise ValueError(f"a seq axis of {P} needs attention_mode 'ring' or 'ulysses', got "
                             f"{cfg.attention_mode!r}")
        _seq.check_seq_len(cfg.n_positions, P)
        if cfg.attention_mode == "ulysses":
            _seq.check_ulysses_heads(cfg.n_head // m, P)


def parallel_comm_model(cfg: GPT2Config, sizes: Dict[str, int], rows: int, T: int,
                        act_bytes: int, gas: int = 1, labels_given: bool = False) -> Dict[str, int]:
    """``runtime/zero/stages.py::port_parallel_comm_model`` for this
    config.  The loss's positions: the label shift drops each row's last
    (``rows * (T - 1)``; ``rows * T`` with labels given) without ``seq``;
    with it each rank scores its ``rows * T / seq``, the last rank's final
    position masked, not dropped."""
    from deepspeed_tpu_torch.runtime.zero.stages import port_parallel_comm_model

    P = int(sizes.get("seq", 1))
    n = rows * (T // P) if P > 1 else rows * (T if labels_given else T - 1)
    out = port_parallel_comm_model(
        cfg.n_layer, cfg.n_embd, rows, T, sizes, loss_positions=n, gas=gas,
        act_bytes=act_bytes, attention_mode=cfg.attention_mode, remat=cfg.remat,
        xent_chunk=cfg.xent_chunk_size, mlp_recompute=cfg.remat and cfg.dropout > 0.0)
    if cfg.n_experts > 0:
        for kind, n in moe_comm_model(cfg, sizes, rows * T, act_bytes, gas=gas).items():
            out[kind] = out.get(kind, 0) + n
    return out


def moe_comm_model(cfg: GPT2Config, sizes: Dict[str, int], tokens: int, act_bytes: int,
                   gas: int = 1) -> Dict[str, int]:
    """A MoE GPT-2's own collectives a step, ``tokens`` a rank's rows x
    positions a micro-step: ``expert-all-reduce``
    (``moe/layer.py`` ``expert_comm_model``; the combine's forward sum runs
    again in a checkpointed block's recompute only where something after
    it keeps a tensor, hidden dropout's mask) and ``moe-routing``, the
    data-parallel grid's router logits and pad masks (f32, ``n_experts +
    1`` a token) gathered by every MoE layer, again in the recompute.
    Under a ``model`` axis the experts' ``tp-all-reduce`` moves the
    ``(E, C, d)`` expert buffer where a dense MLP moves the tokens, and
    the recompute sums it again (the combine keeps its rows): the
    difference from ``port_parallel_comm_model``'s dense count."""
    from deepspeed_tpu_torch.moe.layer import _capacity, expert_comm_model

    ep, dp = int(sizes.get("expert", 1)), int(sizes.get("data", 1)) * int(sizes.get("fsdp", 1))
    m = int(sizes.get("model", 1))
    ear = expert_comm_model(cfg.n_layer, tokens, cfg.n_embd, cfg.moe_top_k, ep, act_bytes,
                            recompute=cfg.remat and cfg.dropout > 0.0)
    rc = 1 if cfg.remat else 0
    route = cfg.n_layer * (1 + rc) * dp * tokens * (cfg.n_experts + 1) * 4 if dp > 1 else 0
    out = {"expert-all-reduce": int(ear * gas), "moe-routing": int(route * gas)}
    if m > 1:
        C = _capacity(tokens * dp, cfg.n_experts, cfg.moe_capacity_factor, 4)
        a_moe = (cfg.n_experts // ep) * C * cfg.n_embd * act_bytes
        a = tokens * cfg.n_embd * act_bytes
        dense = (2 + rc * int(cfg.dropout > 0.0)) * 2 * a
        out["tp-all-reduce"] = int(cfg.n_layer * ((2 + rc) * 2 * a_moe - dense) * gas)
    return out


def make_model(cfg: GPT2Config):
    """Returns ``(model_fn, init_fn, tp_spec_fn)``; ``model_fn(params,
    batch, generator) -> loss`` plugs into
    ``deepspeed_tpu_torch.initialize(model=...)``.  ``generator=None``
    means eval.  ``tp_spec_fn`` gives the tensor-parallel leaves' specs
    (pass it to ``initialize`` for a ``model`` axis, with
    ``mesh_check=functools.partial(check_mesh, cfg)`` for this config's
    refusals and ``comm_model=functools.partial(parallel_comm_model,
    cfg)``).

    ``model_fn.stream_spec`` gives the layer-streaming structure the
    ZeRO-Infinity engine needs (``runtime/zero/param_offload.py``): the
    stacked ``blocks`` and the embed / layer-group / head stages, with
    the JAX package's ``supported`` rule (no MoE; ``flash`` or ``sparse``
    attention)."""
    from deepspeed_tpu_torch.runtime.zero.param_offload import StreamSpec

    def model_fn(params, batch, generator):
        deterministic = generator is None or cfg.dropout == 0.0
        return loss_fn(params, batch, generator=generator, cfg=cfg, deterministic=deterministic)

    model_fn.stream_spec = StreamSpec(
        n_layer=cfg.n_layer,
        blocks_key="blocks",
        embed=functools.partial(_stream_embed, cfg),
        group=functools.partial(_stream_group, cfg),
        head_loss=functools.partial(_stream_head_loss, cfg),
        layer_seeds=functools.partial(_layer_seeds, cfg),
        deterministic=cfg.dropout == 0.0,
        remat=cfg.remat,
        supported=cfg.n_experts == 0 and cfg.attention_mode in ("flash", "sparse"),
    )
    return model_fn, functools.partial(init_params, cfg), tp_spec_fn
