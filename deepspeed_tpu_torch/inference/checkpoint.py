"""Checkpoint loaders for external torch checkpoints (counterpart of
``deepspeed_tpu/inference/checkpoint.py``).

Reference: ``runtime/state_dict_factory.py``, ``SDLoaderFactory`` (:17)
and ``MegatronSDLoader`` (:199): read Megatron-LM's tensor-parallel
shards (``mp_rank_XX_model_states.pt``) and merge them into one full
state dict before kernel injection (``inference/injection.py``).  As in
the JAX package only the merge is needed: the serving engine cuts the
merged weights for its own ``mp_size`` as it places them.

Merge rules by Megatron weight role (a torch Linear is (out, in)):

* column-parallel (``query_key_value``, ``dense_h_to_4h``): concatenated
  along dim 0 (each rank owns a slice of the output dimension; for QKV
  this gives the full layout interleaved by head that the injection
  policy expects);
* row-parallel (``attention.dense``, ``dense_4h_to_h``): along dim 1;
* vocab-parallel ``word_embeddings``: along dim 0;
* replicated (layernorms, position embeddings, the biases of
  row-parallel layers): rank 0's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.logging import logger

COLUMN_PARALLEL_PATTERNS = ("query_key_value.weight", "query_key_value.bias",
                            "dense_h_to_4h.weight", "dense_h_to_4h.bias")
ROW_PARALLEL_PATTERNS = ("attention.dense.weight", "mlp.dense_4h_to_h.weight")
VOCAB_PARALLEL_PATTERNS = ("word_embeddings.weight",)


class SDLoaderFactory:
    @staticmethod
    def get_sd_loader_json(json_file) -> "MegatronSDLoader":
        """Reference :17: a json file (or its parsed dict) holding
        ``{"type", "checkpoints": [...], "version"}``."""
        data = json_file
        if isinstance(json_file, str):
            with open(json_file) as f:
                data = json.load(f)
        sd_type = data.get("type", "Megatron")
        ckpt_list = data["checkpoints"]
        version = data.get("version")
        return SDLoaderFactory.get_sd_loader(ckpt_list, sd_type, version)

    @staticmethod
    def get_sd_loader(ckpt_list: List[str], sd_type: str = "Megatron",
                      version=None) -> "MegatronSDLoader":
        if sd_type.lower() != "megatron":
            raise ValueError(f"unsupported checkpoint type '{sd_type}' (Megatron only)")
        return MegatronSDLoader(ckpt_list, version=version)


class MegatronSDLoader:
    """Loads Megatron tensor-parallel shards and merges them into one full
    state dict."""

    def __init__(self, ckpt_list: List[str], version=None):
        if not ckpt_list:
            raise ValueError("empty checkpoint list")
        self.ckpt_list = list(ckpt_list)
        self.version = version

    def _load_one(self, path: str, map_location="cpu") -> Dict[str, torch.Tensor]:
        sd = torch.load(path, map_location=map_location, weights_only=False)
        # Megatron nests the model under 'model' or 'module'
        for key in ("model", "module"):
            if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
                sd = sd[key]
        return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
                for k, v in sd.items() if isinstance(v, (torch.Tensor, np.ndarray))}

    @staticmethod
    def _merge_qkv(parts: List[torch.Tensor], version, num_heads: Optional[int]) -> torch.Tensor:
        """The fused QKV's shards.  Newer Megatron (version > 1.0, or none
        given) stores each rank's slice interleaved by head: concatenation
        along dim 0 gives the full interleaved layout.  Version <= 1.0
        stores each rank's slice as contiguous [q|k|v], re-interleaved by
        head here (as the reference's ``merge_query_key_value`` branches),
        which needs the head count."""
        if version is None or float(version) > 1.0:
            return torch.cat(parts, dim=0)
        if num_heads is None:
            raise ValueError(
                "Megatron checkpoint version <= 1.0 stores QKV as contiguous [q|k|v]; "
                "pass num_heads= to load() so shards can be re-interleaved"
            )
        heads_per_rank = num_heads // len(parts)
        out = []
        for part in parts:
            three_hd, rest = part.shape[0], tuple(part.shape[1:])
            hd = three_hd // (3 * heads_per_rank)
            # [q|k|v] (3, heads_r, hd, ...) -> by head (heads_r, 3, hd, ...)
            out.append(part.reshape((3, heads_per_rank, hd) + rest).transpose(0, 1)
                       .reshape((three_hd,) + rest))
        return torch.cat(out, dim=0)

    @classmethod
    def merge_state_dicts(cls, shards: List[Dict[str, torch.Tensor]], version=None,
                          num_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
        if len(shards) == 1:
            return dict(shards[0])
        merged: Dict[str, torch.Tensor] = {}
        for key in shards[0]:
            parts = [s[key] for s in shards]
            if key.endswith("query_key_value.weight") or key.endswith("query_key_value.bias"):
                merged[key] = cls._merge_qkv(parts, version, num_heads)
            elif any(key.endswith(p) for p in COLUMN_PARALLEL_PATTERNS):
                merged[key] = torch.cat(parts, dim=0)
            elif any(key.endswith(p) for p in ROW_PARALLEL_PATTERNS):
                merged[key] = torch.cat(parts, dim=1)
            elif any(key.endswith(p) for p in VOCAB_PARALLEL_PATTERNS):
                merged[key] = torch.cat(parts, dim=0)
            else:
                merged[key] = parts[0]  # replicated
        return merged

    def load(self, mp_world_size: int = 1, mp_rank: int = 0,
             num_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The whole merged state dict (the serving engine cuts it for its
        own ``mp_size``; ``mp_world_size`` / ``mp_rank`` are the
        reference's arguments, unused).  ``ckpt_list``'s order is the
        tensor-parallel rank order (no sorting: lexicographic order breaks
        for unpadded rank numbers)."""
        shards = [self._load_one(p) for p in self.ckpt_list]
        logger.info(f"MegatronSDLoader: merged {len(shards)} TP shard(s)")
        return self.merge_state_dicts(shards, version=self.version, num_heads=num_heads)


def find_megatron_checkpoints(ckpt_dir: str, tag: Optional[str] = None) -> List[str]:
    """The ``mp_rank_XX_model_states.pt`` files under a checkpoint directory
    (the reference's naming, ``engine.py:1624``): under ``tag``, else the
    tag its ``latest`` file names, else the directory itself."""
    if tag is None:
        latest = os.path.join(ckpt_dir, "latest")
        if os.path.exists(latest):
            with open(latest) as f:
                tag = f.read().strip()
    search = os.path.join(ckpt_dir, tag) if tag else ckpt_dir
    return [os.path.join(search, name) for name in sorted(os.listdir(search))
            if name.startswith("mp_rank_") and name.endswith(".pt")]
