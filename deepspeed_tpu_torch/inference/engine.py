"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

GPT-2 and BERT models.  The engine owns the parameters on its ``device``
and offers the full-sequence ``forward`` (GPT logits, BERT encoder
states); for GPT models also the external-cache surface (``init_cache`` /
``prefill`` / ``decode_step``) that the serving engine builds on, and the
closed ``generate()`` loop.  PyTorch runs eagerly, so there is no
compiled-executable cache: each call runs the kernels directly.

**Tensor parallelism** (``mp_size=M``, under a process group started
from the launcher environment, as ``initialize`` starts it): the mesh is
``{model: M, data: world // M}`` (``comm/mesh.py`` ``inference_mesh``,
the JAX engine's), each data replica computing the same result.  A
``model`` rank holds its block of every leaf the family's rule table
cuts (``tp_spec_fn``; the fused ``qkv`` head-grouped as training stores
it, ``runtime/zero/partition.py``) and ``n_head / M`` heads of every KV
cache; the blocks run the Megatron operators of ``parallel/tensor.py``
and the logits' vocabulary blocks are all-gathered, so ``forward``,
``prefill``, ``decode_step`` and ``generate`` give every rank the whole
result, as the JAX engine returns it replicated.  Without a group
``mp_size`` must be 1 and the engine is one process; with a group and
``mp_size=1`` the ``model`` group has one rank and the arithmetic is the
one-process engine's, bit for bit.  :func:`inference_comm_model` counts
the collectives' bytes.  ``checkpoint=`` reads the parameters of a tag
the port's training wrote at any mesh (``runtime/checkpointing.py``
``load_params``); ``init_on_device`` draws them on the card.

**Models from outside the repo** (``model=`` a ``transformers`` GPT-2,
GPT-Neo or BERT module, any object with ``state_dict()`` and a
``.config``, or a merged Megatron state dict, ``inference/checkpoint.py``):
an injection policy (``inference/injection.py``) maps the weights into the
fused layout, on the device they arrive on.  **int8 weights at rest**
(``quantize_bits=8`` on a GPT model): every matmul weight is packed whole
(``runtime/weight_quantizer.py`` ``pack_one``, ``pack_int8_tree``'s step:
per-output-channel scales over the whole input dimension) before a rank
cuts its block, the float weight released once packed, and the blocks
compute ``(x @ q) * s``;
the codes stay int8 and the scales f32 on the device.  Any other
``quantize_bits`` (4 bits, or a BERT model) quantizes and dequantizes the
weights (``quantize_dequantize_tree``), as the JAX engine does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import collectives
from deepspeed_tpu_torch.models import bert as bert_mod
from deepspeed_tpu_torch.models import gpt2 as gpt2_mod
from deepspeed_tpu_torch.ops.transformer.inference import (
    LOGITS_GATHER,
    DeepSpeedInferenceConfig,
    forward_with_cache,
    init_kv_cache,
)
from deepspeed_tpu_torch.parallel.sequence import ambient_mesh
from deepspeed_tpu_torch.parallel.tensor import TP_ALL_REDUCE, tp_group
from deepspeed_tpu_torch.runtime.engine import tree_from_paths, tree_items
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist

_MASK64 = (1 << 64) - 1


def _generator(device: torch.device, seed: int, position: int) -> torch.Generator:
    """A generator keyed on (request seed, position of the fed token):
    the same draw wherever the request runs (any slot, any pool churn).
    The pair is mixed (splitmix64 finalizer) because the CPU generator
    keeps only the low 32 bits of its seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(position)) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    g = torch.Generator(device=device)
    g.manual_seed((x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF)
    return g


def _sample_row(logits32: torch.Tensor, temperature: float, top_k: int,
                gen: torch.Generator) -> int:
    lg = logits32 / max(float(temperature), 1e-6)
    if top_k > 0:
        k = min(int(top_k), lg.shape[-1])
        kth = torch.topk(lg, k).values[-1]
        lg = torch.where(lg < kth, torch.full_like(lg, float("-inf")), lg)
    probs = torch.softmax(lg, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen).item())


def sample_logits(logits32: torch.Tensor, do_sample: bool, temperature: float, top_k: int,
                  seed: int = 0, position: int = 0) -> torch.Tensor:
    """The generation sampling head.  ``logits32`` (B, V) float32; greedy
    (argmax, first index on ties as in JAX) when ``do_sample`` is False.
    Sampled draws come from a generator keyed on (seed, position)."""
    if not do_sample:
        return torch.argmax(logits32 / max(temperature, 1e-6), dim=-1).to(torch.int32)
    out = [
        _sample_row(logits32[b], temperature, top_k,
                    _generator(logits32.device, seed + b, position))
        for b in range(logits32.shape[0])
    ]
    return torch.tensor(out, dtype=torch.int32, device=logits32.device)


def sample_logits_pooled(logits32: torch.Tensor, sample_flag, temperature, top_k,
                         seeds, positions, max_top_k: int) -> np.ndarray:
    """:func:`sample_logits` for a slot pool, with per-row parameters
    (host arrays of length S).  Rows with ``sample_flag`` False take the
    bare argmax — the serving ⇄ solo-``generate()`` greedy parity
    contract.  Sampled rows draw from a generator keyed on (request
    seed, fed token's position), so a request's tokens do not depend on
    its slot.  ``top_k`` above ``max_top_k`` is rejected at submit."""
    out = torch.argmax(logits32, dim=-1).to(torch.int32).cpu().numpy()
    V = logits32.shape[-1]
    for row in np.nonzero(np.asarray(sample_flag))[0]:
        k = min(int(top_k[row]), max_top_k, V)
        out[row] = _sample_row(logits32[row], float(temperature[row]), k,
                               _generator(logits32.device, int(seeds[row]), int(positions[row])))
    return out


def inference_comm_model(cfg: Any, mp_size: int, rows: int, T: int, act_bytes: int,
                         logits_rows: Optional[int] = None,
                         logits_bytes: int = 4) -> Dict[str, int]:
    """Bytes the collectives of one tensor-parallel forward move, by
    ``comm/collectives.py`` kind and convention (an all-reduce twice its
    payload, an all-gather its whole result): the embedding's all-reduce
    and two all-reduces a layer (after ``proj`` and ``fc_proj``) of
    ``rows * T * d`` elements of ``act_bytes`` each, all ``tp-all-reduce``;
    for a GPT model the logits' all-gather, ``rows * logits_rows * V``
    elements of ``logits_bytes`` (``logits_rows`` None: all T), as
    ``tp-all-gather``.  Nothing at ``mp_size`` 1."""
    if int(mp_size) <= 1:
        return {}
    gpt = isinstance(cfg, gpt2_mod.GPT2Config)
    d = cfg.n_embd if gpt else cfg.hidden_size
    n_layer = cfg.n_layer if gpt else cfg.num_hidden_layers
    out = {TP_ALL_REDUCE: (1 + 2 * n_layer) * 2 * rows * T * d * act_bytes}
    if gpt:
        kept = T if logits_rows is None else int(logits_rows)
        out[LOGITS_GATHER] = rows * kept * cfg.vocab_size * logits_bytes
    return out


class InferenceEngine:
    def __init__(
        self,
        model: Any = None,
        mp_size: int = 1,
        dtype: Optional[torch.dtype] = None,
        checkpoint: Optional[str] = None,
        checkpoint_tag: Optional[str] = None,
        max_out_tokens: int = 1024,
        model_config: Any = None,
        params: Any = None,
        quantize_bits: int = 0,
        quantize_groups: int = 1,
        injection_policy: Optional[type] = None,
        replace_with_kernel_inject: bool = True,
        kv_cache_dtype: str = "model",
        seed: int = 0,
        init_on_device: bool = False,
        device: Any = "cuda",
    ):
        """``model`` may be a preset name (``"gpt2"``, ...; GPT-2 presets
        win a shared name such as ``"tiny"``, ``"bert-*"`` names the BERT
        family); an HF/torch module or a plain state dict, converted
        through an injection policy (``injection_policy``, else the first
        of ``inference/injection.py``'s that matches; with
        ``replace_with_kernel_inject=False`` and no policy it is refused,
        as in the JAX engine); or None with explicit ``model_config`` (a
        ``GPT2Config`` or a ``BertConfig``; + optional ``params``, the JAX
        package's tree as numpy arrays or the port's tensors, whole).
        ``checkpoint``: a training save directory or tag directory of the
        port (its ``latest`` or ``checkpoint_tag``); else
        ``init_on_device`` draws the random init from ``seed`` on the
        engine's device (another stream than the host init's).
        ``mp_size`` (the ``model`` ranks) and ``quantize_bits`` /
        ``quantize_groups``: the module docstring.  ``device`` defaults to ``"cuda"`` and raises
        when there is no card; tests pass ``device="cpu"``."""
        from deepspeed_tpu_torch.comm.distributed import init_distributed
        from deepspeed_tpu_torch.comm.mesh import inference_mesh

        self.device = resolve_device(device)
        self.mp_world_size = int(mp_size)
        self.dtype = dtype if dtype is not None else torch.bfloat16
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {self.dtype}")
        self.max_out_tokens = int(max_out_tokens)
        if self.max_out_tokens < 1:
            raise ValueError(
                f"max_out_tokens must be >= 1 (it bounds prompt+generated "
                f"length and sizes the KV cache), got {self.max_out_tokens}"
            )
        if kv_cache_dtype not in ("model", "int8"):
            raise ValueError(f"kv_cache_dtype must be 'model' or 'int8', got {kv_cache_dtype!r}")
        self.kv_cache_dtype = kv_cache_dtype
        self._kv_dtype = "int8" if kv_cache_dtype == "int8" else self.dtype

        owned = False  # whether the engine may release the leaves of `params` as it places them
        if isinstance(model, str):
            bert_name = model if model in bert_mod.PRESETS else model.replace("bert-", "")
            if model in gpt2_mod.PRESETS:
                self.model_config = gpt2_mod.PRESETS[model]
            elif bert_name in bert_mod.PRESETS:
                self.model_config = bert_mod.PRESETS[bert_name]
            else:
                raise ValueError(f"unknown model preset '{model}'")
        elif model is not None and (hasattr(model, "state_dict") or isinstance(model, dict)):
            if not replace_with_kernel_inject and injection_policy is None:
                raise ValueError("torch/state-dict models require kernel injection "
                                 "(replace_with_kernel_inject)")
            from deepspeed_tpu_torch.inference.injection import replace_transformer_layer

            self.model_config, params = replace_transformer_layer(model, policy=injection_policy)
            owned = True  # the injected tree is the engine's (its leaves may be the source's)
        elif model_config is not None:
            if not isinstance(model_config, (gpt2_mod.GPT2Config, bert_mod.BertConfig)):
                raise ValueError(
                    f"model_config must be a GPT2Config or a BertConfig of "
                    f"deepspeed_tpu_torch.models, got {type(model_config).__name__}; a "
                    "transformers or Megatron model goes through model= and its injection "
                    "policy (inference/injection.py)")
            self.model_config = model_config
        else:
            raise ValueError("init_inference needs `model` (module/state_dict/preset) "
                             "or model_config=")

        self._is_gpt = isinstance(self.model_config, gpt2_mod.GPT2Config)
        self._family = gpt2_mod if self._is_gpt else bert_mod
        # no backward to save memory for
        if self.model_config.remat:
            self.model_config = dataclasses.replace(self.model_config, remat=False)

        # -- refusals, then the mesh (a launcher environment starts the group) --
        if self.mp_world_size > 1:
            from deepspeed_tpu_torch.sharding.rules import check_model_cut

            self._family.check_mesh(self.model_config, {"model": self.mp_world_size})
            specs = self._family.param_specs(self.model_config)
            check_model_cut([(path, spec.shape) for path, spec in tree_items(specs)],
                            self._family.tp_spec_fn, self.mp_world_size)
        init_distributed(device=self.device)
        self.mesh = inference_mesh(self.mp_world_size)
        self.tp = tp_group(self.mesh) if self.mesh is not None else None

        # -- parameters: each leaf whole quantized where asked, then cut to
        # this rank's block ------------------------------------------------------
        self._packed_int8 = bool(quantize_bits == 8 and self._is_gpt)
        self._simulate = None
        if quantize_bits and not self._packed_int8:
            from deepspeed_tpu_torch.runtime.weight_quantizer import WeightQuantization

            self._simulate = WeightQuantization(bits=quantize_bits, groups=quantize_groups)
        from_file = False  # a tag's memory-mapped leaves are copied off the file
        if checkpoint is not None:
            from deepspeed_tpu_torch.runtime.checkpointing import load_params

            _, flat = load_params(checkpoint, checkpoint_tag)
            params, from_file, owned = tree_from_paths(flat), True, True
        if params is None and init_on_device and getattr(self.model_config, "n_experts", 0) == 0:
            self.params = self._family.init_params_device(
                self.model_config, seed=seed, dtype=self.dtype, device=self.device, keep=self._keep)
        else:
            if params is None:
                params, owned = self._family.init_params(self.model_config, seed=seed), True
            if not all(isinstance(v, (torch.Tensor, dict)) for v in params["blocks"].values()):
                params, owned = self._family.params_from_jax(params), True  # f32 on the host
            flat = dict(tree_items(params))
            del params
            placed = {}
            for path in list(flat):
                # an owned float leaf is released as soon as its block is placed,
                # so the whole tree is never held both as floats and as int8
                t = flat.pop(path) if owned else flat[path]
                for sub, leaf in self._prepare(path, t):
                    placed[sub] = self._place(sub, leaf, from_file)
                del t
            self.params = tree_from_paths(placed)
        n_params = self.model_config.num_params()
        log_dist(
            f"inference engine: {type(self.model_config).__name__} "
            f"params={n_params / 1e6:.1f}M mp={self.mp_world_size} dtype={self.dtype} "
            f"device={self.device} mesh={self.mesh}"
        )

    def _cut(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """This ``model`` rank's block of the whole leaf ``t`` (``t`` itself
        at one rank): the family's tensor-parallel spec, the fused ``qkv``
        head-grouped first, so that rank ``r`` holds ``[q_r | k_r | v_r]``.
        A dimension the axis does not divide is refused in the JAX
        package's words."""
        if self.tp is None:
            return t
        from deepspeed_tpu_torch.runtime.zero.partition import _group_parts
        from deepspeed_tpu_torch.sharding.rules import check_model_cut, fused_tp_parts

        shape = tuple(t.shape)
        spec = self._family.tp_spec_fn(path, shape)
        if not check_model_cut([(path, shape)], self._family.tp_spec_fn, self.tp.size):
            return t
        parts = fused_tp_parts(path)
        if parts > 1:
            t = _group_parts(t, parts, self.tp.size)
        return self.mesh.local_block(t, spec)

    def _prepare(self, path: str, t: torch.Tensor):
        """``[(path, whole leaf)]`` of one leaf as the engine keeps it, on
        ``t``'s device: under ``quantize_bits=8`` a matmul weight becomes
        its ``path/q`` and ``path/s`` pair (``runtime/weight_quantizer.py``
        ``pack_one``, the step of ``pack_int8_tree``), under other bits it
        is quantized and dequantized; the quantizer always sees the whole
        weight, before any cut."""
        from deepspeed_tpu_torch.runtime.weight_quantizer import is_packed_weight, pack_one

        name = path.rsplit("/", 1)[-1]
        if self._packed_int8 and is_packed_weight(name, tuple(t.shape)):
            return [(f"{path}/{k}", v) for k, v in pack_one(t).items()]
        if self._simulate is not None:
            t = self._simulate.quantize_dequantize_leaf(name, t)
        return [(path, t)]

    def _keep(self, path: str, t: torch.Tensor):
        """``init_on_device``'s keep: :meth:`_prepare` on the whole drawn
        leaf, then this rank's blocks (a packed weight's ``q`` and ``s``)."""
        parts = self._prepare(path, t)
        if len(parts) == 1 and parts[0][0] == path:
            return self._cut(path, parts[0][1])
        return {sub.rsplit("/", 1)[-1]: self._cut(sub, v) for sub, v in parts}

    def _leaf_dtype(self, path: str, t: torch.Tensor) -> torch.dtype:
        """int8 codes stay int8 and their scales f32 (the JAX engine's
        ``_shard_params``); every other leaf takes the engine's dtype."""
        if t.dtype == torch.int8:
            return torch.int8
        return torch.float32 if path.endswith("/s") else self.dtype

    def _place(self, path: str, t: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """A whole leaf as this rank's block on the engine's device, in its
        dtype (cut where it lies, then moved: the host never holds a copy
        of the whole tree in the target dtype)."""
        return self._cut(path, t).to(self.device, self._leaf_dtype(path, t), copy=copy)

    def weight_bytes(self) -> int:
        """Bytes of this rank's parameters on the device."""
        return sum(t.numel() * t.element_size() for _, t in tree_items(self.params))

    @property
    def local_heads(self) -> int:
        """The attention heads this rank runs and caches: ``n_head / M``."""
        cfg = self.model_config
        return (cfg.n_head if self._is_gpt else cfg.num_attention_heads) // self.mp_world_size

    def comm_model(self, rows: int, T: int, logits_rows: Optional[int] = None,
                   logits_bytes: int = 4) -> Dict[str, int]:
        """:func:`inference_comm_model` for this engine's config, ``mp_size``
        and dtype."""
        act = torch.empty((), dtype=self.dtype).element_size()
        return inference_comm_model(self.model_config, self.mp_world_size, rows, T, act,
                                    logits_rows=logits_rows, logits_bytes=logits_bytes)

    @property
    def generation_capacity(self) -> int:
        """Hard bound on prompt + generated length: ``max_out_tokens``
        clamped by the model's positional table (GPT models)."""
        if self._is_gpt:
            return min(self.max_out_tokens, self.model_config.n_positions)
        return self.max_out_tokens

    def _require_gpt(self, what: str) -> None:
        if not self._is_gpt:
            raise ValueError(f"{what} requires a causal-LM (GPT-family) model")

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, input_ids, **kw) -> torch.Tensor:
        """Full-sequence forward: GPT → logits (B, T, V); BERT → encoder
        hidden states (B, T, d) (BERT takes ``token_type_ids`` and
        ``attention_mask``)."""
        if self._is_gpt and kw:
            raise TypeError(
                f"forward() got unexpected kwargs {sorted(kw)} for a GPT-family "
                "model (token_type_ids/attention_mask are BERT-only)"
            )
        ids = self._tokens(input_ids)
        if self._is_gpt and ids.shape[1] > self.model_config.n_positions:
            # past n_positions the position lookup would fail; raise with
            # the numbers instead
            raise ValueError(
                f"forward() sequence length {ids.shape[1]} exceeds the "
                f"model's n_positions={self.model_config.n_positions}"
            )
        if self._packed_int8:
            # packed weights are read by the inference blocks only: the
            # whole sequence runs through the cache path (a prefill at 0)
            B, T = ids.shape
            k, v = init_kv_cache(self.model_config.n_layer, B, self.local_heads, T,
                                 self.model_config.head_dim, self._kv_dtype, device=self.device)
            with torch.inference_mode():
                return forward_with_cache(self.params, ids, k, v, 0, self.inference_config(T),
                                          tp=self.tp)[0]
        with torch.inference_mode(), ambient_mesh(self.mesh):
            if self._is_gpt:
                logits = gpt2_mod.apply(self.params, ids, self.model_config, deterministic=True)
                if self.tp is not None:  # the rank's vocabulary block -> the whole logits
                    logits = collectives.all_gather(logits, self.tp.group, dim=logits.dim() - 1,
                                                    kind=LOGITS_GATHER)
                return logits
            kw = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in kw.items()}
            return bert_mod.encode(self.params, ids, self.model_config, deterministic=True,
                                   tp=self.tp, **kw)

    __call__ = forward

    # ------------------------------------------------------------------
    # external-cache prefill/decode surface
    # ------------------------------------------------------------------
    def inference_config(self, max_len: int) -> DeepSpeedInferenceConfig:
        cfg = self.model_config
        return DeepSpeedInferenceConfig(
            hidden_size=cfg.n_embd,
            heads=cfg.n_head,
            layer_norm_eps=cfg.layer_norm_epsilon,
            mp_size=self.mp_world_size,
            dtype=self.dtype,
            max_out_tokens=int(max_len),
            use_flash_attention=cfg.use_flash_attention,
            moe_top_k=getattr(cfg, "moe_top_k", 2),
        )

    def init_cache(self, batch: int, max_len: int):
        """Externally-owned KV cache ``(layers, batch, heads, max_len,
        head_dim)`` on the engine's device, in its cache dtype; ``heads``
        is this rank's :attr:`local_heads`."""
        self._require_gpt("init_cache()")
        if max_len > self.generation_capacity:
            raise ValueError(
                f"cache max_len={max_len} exceeds the generation capacity "
                f"min(max_out_tokens={self.max_out_tokens}, "
                f"n_positions={self.model_config.n_positions}) = "
                f"{self.generation_capacity}"
            )
        cfg = self.model_config
        return init_kv_cache(cfg.n_layer, int(batch), self.local_heads, int(max_len),
                             cfg.head_dim, self._kv_dtype, device=self.device)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens), dtype=torch.int64).to(self.device)

    @staticmethod
    def _cache_len(k_cache) -> int:
        leaf = k_cache["q"] if isinstance(k_cache, dict) else k_cache
        return leaf.shape[3]

    def prefill(self, tokens, k_cache, v_cache):
        """Initial prefill (write offset 0, causal fast path) into an
        externally-owned cache, in place.  Returns ``(logits, k_cache,
        v_cache)``."""
        self._require_gpt("prefill()")
        tokens = self._tokens(tokens)
        T, S = tokens.shape[1], self._cache_len(k_cache)
        if T > S:
            raise ValueError(f"prefill length {T} exceeds the cache capacity {S}")
        with torch.inference_mode():
            return forward_with_cache(self.params, tokens, k_cache, v_cache, 0,
                                      self.inference_config(S), tp=self.tp)

    def decode_step(self, tokens, k_cache, v_cache, pos):
        """One decode/continuation step at write offset ``pos`` (scalar,
        or a per-row (B,) vector for slot-pool continuous batching).
        Returns ``(logits, k_cache, v_cache)``."""
        self._require_gpt("decode_step()")
        tokens = self._tokens(tokens)
        T, S = tokens.shape[1], self._cache_len(k_cache)
        pos_host = np.asarray(pos)
        if int(pos_host.max()) + T > S:
            raise ValueError(
                f"decode_step write offset pos={int(pos_host.max())} + T={T} "
                f"exceeds the cache capacity {S}; the sequence is out of "
                f"room (grow the cache via init_cache, or stop generating)"
            )
        # a tensor offset: never the initial-prefill fast path, as in JAX
        pos_t = torch.as_tensor(pos_host, dtype=torch.int32).to(self.device)
        with torch.inference_mode():
            return forward_with_cache(self.params, tokens, k_cache, v_cache, pos_t,
                                      self.inference_config(S), tp=self.tp)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------
    def generate(
        self,
        input_ids,
        max_new_tokens: int = 32,
        do_sample: bool = False,
        temperature: float = 1.0,
        top_k: int = 0,
        eos_token_id: Optional[int] = None,
        seed: int = 0,
        attention_mask=None,
    ) -> np.ndarray:
        """Autoregressive generation (KV-cache decode).  ``input_ids``
        (B, T); ragged prompts are LEFT-padded with ``attention_mask``
        (B, T, 1=real).  Returns (B, T + max_new_tokens) int32 numpy."""
        self._require_gpt("generate()")
        ids = np.asarray(input_ids).astype(np.int64)
        B, T = ids.shape
        N = int(max_new_tokens)
        if N < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {N}")
        if T + N > self.generation_capacity:
            raise ValueError(
                f"T+max_new_tokens = {T}+{N} = {T + N} exceeds the generation capacity "
                f"min(max_out_tokens={self.max_out_tokens}, "
                f"n_positions={self.model_config.n_positions}) = "
                f"{self.generation_capacity} (raise max_out_tokens in "
                f"init_inference, or shorten the prompt)"
            )
        masked = attention_mask is not None
        if masked:
            am_np = np.asarray(attention_mask)
            if not np.array_equal(np.sort(am_np, axis=1), am_np):
                raise ValueError(
                    "attention_mask must be LEFT-padded (rows of 0s then 1s); "
                    "right-padded prompts would silently generate from a pad position"
                )
            if np.all(am_np == 1):
                masked = False  # all-real prompts: take the unmasked fast path
        dev = self.device
        S = T + N  # any cache length: the decode kernel needs no alignment
        icfg = self.inference_config(S)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        cfg = self.model_config
        k_cache, v_cache = init_kv_cache(cfg.n_layer, B, self.local_heads, S, cfg.head_dim,
                                         self._kv_dtype, device=dev)
        tokens = torch.as_tensor(ids, device=dev)

        def sample(logits32, step):
            return sample_logits(logits32, do_sample, temperature, top_k,
                                 seed=seed, position=step)

        last = slice(T - 1, T)  # the prompt's logits that generation reads
        # telemetry: generate calls and the tokens they ask for; the span
        # closes after the tokens are read back to the host, so it holds
        # the card's work
        from deepspeed_tpu_torch.telemetry import get_registry, get_tracer

        reg, tracer = get_registry(), get_tracer()
        if reg.enabled:
            reg.counter("inference/generate_calls", engine="inference").inc()
            reg.counter("inference/tokens_requested", engine="inference").inc(B * N)
        with tracer.span("generate", "inference",
                         args={"batch": B, "prompt_len": T, "max_new_tokens": N}), \
                torch.inference_mode():
            if masked:
                prompt_mask = torch.as_tensor(am_np, device=dev).bool()
                position_ids = torch.clamp(torch.cumsum(prompt_mask.long(), dim=1) - 1, min=0)
                real_len = prompt_mask.long().sum(dim=1)                  # (B,)
                full_mask = torch.cat(
                    [prompt_mask, torch.ones((B, N), dtype=torch.bool, device=dev)], dim=1)
                logits, _, _ = forward_with_cache(
                    self.params, tokens, k_cache, v_cache, 0, icfg,
                    key_padding_mask=full_mask, position_ids=position_ids, tp=self.tp,
                    logits_rows=last)
            else:
                full_mask = None
                logits, _, _ = forward_with_cache(self.params, tokens, k_cache, v_cache, 0, icfg,
                                                  tp=self.tp, logits_rows=last)
            nxt = sample(logits[:, -1], T - 1)
            out = [nxt]
            finished = nxt == eos
            # the decode loop runs on per-layer views of the stacked cache
            n_layer = cfg.n_layer
            k_tup = tuple(({n: a[i] for n, a in k_cache.items()} if isinstance(k_cache, dict)
                           else k_cache[i]) for i in range(n_layer))
            v_tup = tuple(({n: a[i] for n, a in v_cache.items()} if isinstance(v_cache, dict)
                           else v_cache[i]) for i in range(n_layer))
            for step in range(1, N):
                pos = T + step - 1  # the fed token was generated at step-1
                pos_ids = (real_len + step - 1)[:, None] if masked else None
                lg, _, _ = forward_with_cache(
                    self.params, nxt[:, None].long(), k_tup, v_tup, pos, icfg,
                    key_padding_mask=full_mask, position_ids=pos_ids, tp=self.tp)
                tok = sample(lg[:, -1], pos)
                tok = torch.where(finished, torch.full_like(tok, eos if eos >= 0 else 0), tok)
                finished = finished | (tok == eos)
                nxt = tok
                out.append(tok)
            gen = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return np.concatenate([ids.astype(np.int32), gen], axis=1)

