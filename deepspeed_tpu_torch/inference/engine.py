"""Inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

GPT-family models only, one device (``mp_size=1``).  The engine owns
the parameters on its ``device`` and offers the external-cache surface
(``init_cache`` / ``prefill`` / ``decode_step``) that the serving engine
builds on, plus the closed ``generate()`` loop.  PyTorch runs eagerly, so
there is no compiled-executable cache: each call runs the kernels
directly.  HF injection, checkpoints and int8 weights are later slices.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models import gpt2 as gpt2_mod
from deepspeed_tpu_torch.ops.transformer.inference import (
    DeepSpeedInferenceConfig,
    forward_with_cache,
    init_kv_cache,
)
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


class InferenceEngine:
    def __init__(
        self,
        model: Any = None,
        mp_size: int = 1,
        dtype: Optional[torch.dtype] = None,
        max_out_tokens: int = 1024,
        model_config: Any = None,
        params: Any = None,
        quantize_bits: int = 0,
        kv_cache_dtype: str = "model",
        seed: int = 0,
        device: Any = "cuda",
    ):
        """``model`` may be a preset name (``"gpt2"``, ...), or None with
        explicit ``model_config`` (+ optional ``params``, the JAX
        package's GPT-2 tree as numpy arrays or the port's tensors).
        ``device`` defaults to ``"cuda"`` and raises when there is no
        card; tests pass ``device="cpu"``."""
        self.device = resolve_device(device)
        if int(mp_size) != 1:
            raise NotImplementedError("mp_size > 1 (tensor parallelism) is not ported yet (ROADMAP A6)")
        if quantize_bits:
            raise NotImplementedError("quantize_bits (int8 weights) is not ported yet (ROADMAP A7)")
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

        if isinstance(model, str):
            if model not in gpt2_mod.PRESETS:
                raise ValueError(f"unknown model preset '{model}' (GPT-2 family only in the port)")
            self.model_config = gpt2_mod.PRESETS[model]
        elif model is not None:
            raise NotImplementedError(
                "HF/torch module injection is not ported yet (ROADMAP A7 inference/injection.py)"
            )
        elif model_config is not None:
            if not isinstance(model_config, gpt2_mod.GPT2Config):
                raise NotImplementedError("only GPT2Config models are ported (ROADMAP A9 for BERT)")
            self.model_config = model_config
        else:
            raise ValueError("init_inference needs `model` (a preset name) or model_config=")

        if params is None:
            params = gpt2_mod.init_params(self.model_config, seed=seed)
        if isinstance(params["wte"], torch.Tensor):
            self.params = {
                k: ({n: t.to(self.device, self.dtype) for n, t in v.items()}
                    if isinstance(v, dict) else v.to(self.device, self.dtype))
                for k, v in params.items()
            }
        else:
            self.params = gpt2_mod.params_from_jax(params, device=self.device, dtype=self.dtype)
        n_params = self.model_config.num_params()
        log_dist(
            f"inference engine: GPT2Config params={n_params / 1e6:.1f}M "
            f"dtype={self.dtype} device={self.device}"
        )

    @property
    def generation_capacity(self) -> int:
        """Hard bound on prompt + generated length: ``max_out_tokens``
        clamped by the model's positional table."""
        return min(self.max_out_tokens, self.model_config.n_positions)

    # ------------------------------------------------------------------
    # external-cache prefill/decode surface
    # ------------------------------------------------------------------
    def inference_config(self, max_len: int) -> DeepSpeedInferenceConfig:
        cfg = self.model_config
        return DeepSpeedInferenceConfig(
            hidden_size=cfg.n_embd,
            heads=cfg.n_head,
            layer_norm_eps=cfg.layer_norm_epsilon,
            dtype=self.dtype,
            max_out_tokens=int(max_len),
            use_flash_attention=cfg.use_flash_attention,
        )

    def init_cache(self, batch: int, max_len: int):
        """Externally-owned KV cache ``(layers, batch, heads, max_len,
        head_dim)`` on the engine's device, in its cache dtype."""
        if max_len > self.generation_capacity:
            raise ValueError(
                f"cache max_len={max_len} exceeds the generation capacity "
                f"min(max_out_tokens={self.max_out_tokens}, "
                f"n_positions={self.model_config.n_positions}) = "
                f"{self.generation_capacity}"
            )
        cfg = self.model_config
        return init_kv_cache(cfg.n_layer, int(batch), cfg.n_head, int(max_len), cfg.head_dim,
                             self._kv_dtype, device=self.device)

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
        tokens = self._tokens(tokens)
        T, S = tokens.shape[1], self._cache_len(k_cache)
        if T > S:
            raise ValueError(f"prefill length {T} exceeds the cache capacity {S}")
        with torch.inference_mode():
            return forward_with_cache(self.params, tokens, k_cache, v_cache, 0,
                                      self.inference_config(S))

    def decode_step(self, tokens, k_cache, v_cache, pos):
        """One decode/continuation step at write offset ``pos`` (scalar,
        or a per-row (B,) vector for slot-pool continuous batching).
        Returns ``(logits, k_cache, v_cache)``."""
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
                                      self.inference_config(S))

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
        k_cache, v_cache = init_kv_cache(cfg.n_layer, B, cfg.n_head, S, cfg.head_dim,
                                         self._kv_dtype, device=dev)
        tokens = torch.as_tensor(ids, device=dev)

        def sample(logits32, step):
            return sample_logits(logits32, do_sample, temperature, top_k,
                                 seed=seed, position=step)

        with torch.inference_mode():
            if masked:
                prompt_mask = torch.as_tensor(am_np, device=dev).bool()
                position_ids = torch.clamp(torch.cumsum(prompt_mask.long(), dim=1) - 1, min=0)
                real_len = prompt_mask.long().sum(dim=1)                  # (B,)
                full_mask = torch.cat(
                    [prompt_mask, torch.ones((B, N), dtype=torch.bool, device=dev)], dim=1)
                logits, _, _ = forward_with_cache(
                    self.params, tokens, k_cache, v_cache, 0, icfg,
                    key_padding_mask=full_mask, position_ids=position_ids)
            else:
                full_mask = None
                logits, _, _ = forward_with_cache(self.params, tokens, k_cache, v_cache, 0, icfg)
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
                    key_padding_mask=full_mask, position_ids=pos_ids)
                tok = sample(lg[:, -1], pos)
                tok = torch.where(finished, torch.full_like(tok, eos if eos >= 0 else 0), tok)
                finished = finished | (tok == eos)
                nxt = tok
                out.append(tok)
            gen = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return np.concatenate([ids.astype(np.int32), gen], axis=1)

