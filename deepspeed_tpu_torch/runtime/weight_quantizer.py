"""Post-training weight quantization for inference (counterpart of
``deepspeed_tpu/runtime/weight_quantizer.py``).

Two forms, as in the JAX package:

* simulated quantization (:meth:`WeightQuantization.quantize_dequantize_tree`):
  every matmul weight grouped-quantized to ``bits`` and dequantized back
  to its dtype, the numerics of the reference's dequantized path;
* int8 at rest (:func:`pack_int8_tree`): every matmul weight becomes
  ``{"q": int8, "s": f32}`` with per-output-channel scales, and the
  inference blocks compute ``(x @ q) * s``
  (``ops/transformer/inference.py`` ``_wmm``).

A matmul weight is a leaf named ``*_w`` with two or more dimensions whose
name holds no ``emb`` (the JAX package's name rule).  Everything runs in
torch on the tensors' own device: packing on the card gives the same bits
as packing on the host.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.quantizer.quantizer import _div, quantize_per_channel


def _tensor(w: Any) -> torch.Tensor:
    return w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w, np.float32))


def _map_with_name(tree: Any, fn, path: str = "") -> Any:
    """``fn(path, leaf)`` over every leaf of a tree of dicts (a new tree)."""
    if isinstance(tree, dict):
        return {k: _map_with_name(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


class WeightQuantization:
    def __init__(self, bits: int = 8, groups: int = 1, mlp_extra_grouping: bool = False):
        if bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.groups = max(1, int(groups))
        self.mlp_extra_grouping = mlp_extra_grouping

    # -- the grouped symmetric quantizer ----------------------------------
    def quantize(self, w: Any, groups: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(q int8, scales f32 (rows, groups, 1))``: each row of the
        matrix (every leading dim flattened, so a stacked (L, in, out)
        weight quantizes per layer and input row, never across layers)
        split into ``groups`` column groups when they divide it, else one
        scale a row."""
        groups = groups or self.groups
        w = _tensor(w).float()
        C = w.shape[-1]
        if C % groups != 0:
            groups = 1
        flat = w.reshape(-1, groups, C // groups)
        qmax = (1 << (self.bits - 1)) - 1
        scale = _div(flat.abs().amax(dim=2, keepdim=True), qmax)
        scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(flat / scale), -qmax - 1, qmax).to(torch.int8)
        return q.reshape(w.shape), scale

    def dequantize(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        rows, groups = scale.shape[0], scale.shape[1]
        return (q.float().reshape(rows, groups, -1) * scale).reshape(q.shape)

    def quantize_dequantize(self, w: Any) -> torch.Tensor:
        q, s = self.quantize(w)
        return self.dequantize(q, s)

    # -- over a parameter tree --------------------------------------------
    def _is_matmul_weight(self, name: str, shape) -> bool:
        return len(shape) >= 2 and name.endswith("_w")

    def _quantizes(self, name: str, shape) -> bool:
        return self._is_matmul_weight(name, shape) and "emb" not in name and name != "wte"

    def quantize_dequantize_tree(self, params: Any) -> Any:
        """Simulated quantization over a parameter tree: every matmul
        weight quantized and dequantized to its own dtype; norms, biases
        and embedding tables as they are."""
        return _map_with_name(
            params, lambda path, leaf: self.quantize_dequantize_leaf(path.rsplit("/", 1)[-1], leaf))

    def quantize_dequantize_leaf(self, name: str, leaf: Any) -> Any:
        """One leaf of :meth:`quantize_dequantize_tree`, by its name."""
        if not self._quantizes(name, tuple(np.shape(leaf))):
            return leaf
        groups = self.groups * (2 if self.mlp_extra_grouping and "fc" in name else 1)
        t = _tensor(leaf)
        q, s = self.quantize(t, groups=groups)
        return self.dequantize(q, s).to(t.dtype)

    def quantize_tree_packed(self, params: Any) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """``{path: (q, scales)}`` of every matmul weight."""
        packed = {}

        def visit(path, leaf):
            if self._quantizes(path.rsplit("/", 1)[-1], tuple(np.shape(leaf))):
                packed[path] = self.quantize(leaf)
            return leaf

        _map_with_name(params, visit)
        return packed


def quantize_transformer_layer(params: Any, bits: int = 8, groups: int = 1) -> Any:
    """Name-compatible shim for ``module_inject/module_quantize.py``."""
    return WeightQuantization(bits=bits, groups=groups).quantize_dequantize_tree(params)


def is_packed_weight(name: str, shape) -> bool:
    """Whether :func:`pack_int8_tree` packs a leaf of this name and shape."""
    return len(shape) >= 2 and name.endswith("_w") and "emb" not in name


def pack_one(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One weight as its ``{"q": int8, "s": f32}`` pair, on its device."""
    q, s = quantize_per_channel(w)
    return {"q": q, "s": s}


def pack_int8_tree(params: Any) -> Any:
    """int8 at rest for the serving path: every matmul weight becomes
    ``{"q": int8, "s": f32}`` with per-output-channel scales
    (:func:`~deepspeed_tpu_torch.ops.quantizer.quantizer.quantize_per_channel`),
    on the leaf's own device; other leaves are kept as they are.  (The
    inference engine packs leaf by leaf with :func:`pack_one`, releasing
    each float weight as it goes.)"""
    return _map_with_name(
        params, lambda path, leaf: (pack_one(_tensor(leaf)) if is_packed_weight(
            path.rsplit("/", 1)[-1], tuple(np.shape(leaf))) else leaf))
