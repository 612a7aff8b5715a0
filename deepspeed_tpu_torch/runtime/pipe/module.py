"""Pipeline module: the model as a list of layers (counterpart of
``deepspeed_tpu/runtime/pipe/module.py``; reference ``PipelineModule``
:87, ``LayerSpec`` :25, ``TiedLayerSpec`` :73, ``_partition_layers``
:355).

* A layer is an object with ``init(rng) -> params`` (``rng`` a numpy
  ``Generator``; ``params`` a tree of arrays or tensors) and ``apply(params,
  x, generator=None) -> x`` (or ``__call__``), an ``nn.Module`` (its
  parameters are the tree, applied with ``torch.func.functional_call``),
  or a plain callable ``f(x)`` without parameters.
* The repeated blocks (the *body*) must be homogeneous — the same class
  built with the same arguments — so their leaves stack into ``[L, ...]``
  under ``blocks``, the tree the engine cuts over the ``pipe`` axis: stage
  ``s`` holds blocks ``[s*K, (s+1)*K)`` (``K = L / stages``).  Layers
  before the body (the embedding) run on the first stage, layers after it
  (final norm, head) on the last; their parameters sit under ``pre`` and
  ``post``, and tied layers' (``TiedLayerSpec``, embedding ⇄ head) under
  ``tied``, one entry for every site of the key.  The engine sums those
  leaves' gradients over the stages (the reference's ``ReduceTiedGrads``).
* The parameters stay in the engine's ``(params, batch, generator)``
  tree: ``{"pre": {idx: p}, "blocks": stacked leaves, "post": {idx: p},
  "tied": {key: p}}``.
"""
from __future__ import annotations

import inspect
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.runtime.engine import tree_flatten, tree_paths
from deepspeed_tpu_torch.runtime.utils import partition_balanced, partition_uniform
from deepspeed_tpu_torch.utils.logging import logger


class LayerSpec:
    """Lazy layer description: ``typename(*args, **kwargs)`` built when the
    module is (reference pipe/module.py:25-70)."""

    def __init__(self, typename: Callable, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not callable(typename):
            raise RuntimeError("LayerSpec requires a callable typename")

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"

    def build(self):
        return self.typename(*self.module_args, **self.module_kwargs)


class TiedLayerSpec(LayerSpec):
    """A layer whose parameters every other tied layer of the same ``key``
    shares (reference pipe/module.py:73-85).  ``forward_fn(params, x)``
    optionally replaces how this site applies them (the embedding's
    weights as the LM head)."""

    def __init__(self, key: str, typename: Callable, *module_args, forward_fn=None,
                 **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn


def _accepts_generator(fn) -> bool:
    """Decided once when the layer is built (never by catching a
    TypeError from inside a layer body, which would hide the layer's
    own bugs)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    params = sig.parameters
    if "generator" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class _BuiltLayer:
    """One layer position's ``(init, apply)`` pair."""

    def __init__(self, obj: Any, tied_key: Optional[str] = None, forward_fn=None, name: str = ""):
        self.obj = obj
        self.tied_key = tied_key
        self.forward_fn = forward_fn
        self.name = name or type(obj).__name__
        self.is_module = isinstance(obj, torch.nn.Module)
        self.has_params = self.is_module or hasattr(obj, "init")
        if forward_fn is not None:
            self._fn = forward_fn
        elif self.is_module:
            self._fn = None
        elif self.has_params:
            self._fn = getattr(obj, "apply", None) or obj
        else:
            self._fn = obj
        self._accepts_gen = self._fn is not None and _accepts_generator(self._fn)

    def init(self, rng: np.random.Generator) -> Any:
        if self.is_module:
            return {n: p.detach().cpu().float().numpy().copy()
                    for n, p in self.obj.named_parameters()}
        return self.obj.init(rng) if self.has_params else None

    def num_params(self) -> int:
        if not self.has_params:
            return 0
        if self.is_module:
            return sum(p.numel() for p in self.obj.parameters())
        if hasattr(self.obj, "num_params"):
            return int(self.obj.num_params())
        leaves = tree_flatten(self.init(np.random.default_rng(0)))[0]
        return int(sum(np.prod(np.shape(a)) for a in leaves))

    def apply(self, params: Any, x: Any, generator=None) -> Any:
        if self.is_module and self.forward_fn is None:
            return torch.func.functional_call(self.obj, params, (x,))
        if not self.has_params and self.forward_fn is None:
            return self._fn(x)
        if self._accepts_gen:
            return self._fn(params, x, generator=generator)
        return self._fn(params, x)


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(list(xs))
    return np.stack([np.asarray(x) for x in xs])


def layer_generator(seed: Optional[int], layer: int) -> Optional[torch.Generator]:
    """The generator a layer position gets from a micro-batch's seed (None
    in eval): the same for a layer whatever stage runs it."""
    if seed is None:
        return None
    return torch.Generator().manual_seed((int(seed) * 1_000_003 + int(layer)) & ((1 << 63) - 1))


class PipelineModule:
    """The model as a layer list, for pipeline-parallel execution.

    Args:
        layers: :class:`LayerSpec` / layer objects / callables.
        loss_fn: ``loss_fn(outputs, labels) -> scalar``.
        num_stages: pipeline stages; by default the mesh's ``pipe`` axis
            when the engine adopts the module.
        partition_method: ``'uniform'`` | ``'parameters'`` |
            ``'type:<regex>'`` — the reference's stage-boundary balancing
            (``_partition_layers``).  The stages run the homogeneous body
            split evenly, so the partition is advisory, as in the JAX
            package: computed, logged, and used for checkpoint layer names.
        activation_checkpoint_interval: recompute every N body layers in
            the backward (0 = off).
        seed_layers: give each layer an init stream of its own.
    """

    def __init__(
        self,
        layers: Sequence[Any],
        num_stages: Optional[int] = None,
        topology=None,
        loss_fn: Optional[Callable] = None,
        seed_layers: bool = False,
        partition_method: str = "parameters",
        activation_checkpoint_interval: int = 0,
        base_seed: int = 1234,
    ):
        self.specs = list(layers)
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self._topology = topology
        if topology is not None and num_stages is None:
            num_stages = topology.get_dim("pipe")
        self.num_stages = num_stages
        self.parts: Optional[List[int]] = None

        self._layers: List[_BuiltLayer] = [self._build_one(i, s) for i, s in enumerate(self.specs)]
        self._classify_body()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _build_one(self, idx: int, spec: Any) -> _BuiltLayer:
        if isinstance(spec, TiedLayerSpec):
            layer = _BuiltLayer(spec.build(), tied_key=spec.key, forward_fn=spec.forward_fn,
                                name=f"{idx}:{spec.typename.__name__}")
        elif isinstance(spec, LayerSpec):
            layer = _BuiltLayer(spec.build(), name=f"{idx}:{spec.typename.__name__}")
        else:
            layer = _BuiltLayer(spec, name=f"{idx}:{type(spec).__name__}")
        # stacked body layers must share behaviour, not only the tree's
        # structure: the same class built with the same arguments
        if isinstance(spec, LayerSpec):
            layer.homo_key = (spec.typename, repr(spec.module_args),
                              repr(sorted(spec.module_kwargs.items())))
        else:
            layer.homo_key = (type(spec), repr(sorted(getattr(spec, "__dict__", {}).items())))
        return layer

    def _classify_body(self) -> None:
        """The longest run of homogeneous layers with parameters is the
        pipelined body; what comes before runs on the first stage, what
        comes after on the last."""
        runs: List[Tuple[int, int]] = []  # (start, length)
        i = 0
        n = len(self._layers)
        while i < n:
            lay = self._layers[i]
            if not lay.has_params or lay.tied_key is not None:
                i += 1
                continue
            j = i
            key = lay.homo_key
            while (j < n and self._layers[j].has_params and self._layers[j].tied_key is None
                   and self._layers[j].homo_key == key):
                j += 1
            runs.append((i, j - i))
            i = j
        if runs:
            start, length = max(runs, key=lambda r: r[1])
        else:
            start, length = len(self._layers), 0
        self.body_start = start
        self.body_len = length
        self.pre_ids = list(range(0, start))
        self.body_ids = list(range(start, start + length))
        self.post_ids = list(range(start + length, n))

    def build_params(self, seed: int = 0) -> Dict[str, Any]:
        """The whole parameter tree::

            {"pre": {idx: p}, "blocks": stacked [L, ...] leaves,
             "post": {idx: p}, "tied": {key: p}}

        Layer ``i`` draws from ``np.random.default_rng((seed, i))`` with
        ``seed_layers``, else every layer from ``(seed, 0)`` (the JAX
        package folds ``i`` or 0 into its key alike)."""
        params: Dict[str, Any] = {"pre": {}, "blocks": {}, "post": {}, "tied": {}}

        def layer_rng(i):
            return np.random.default_rng((int(seed), i if self.seed_layers else 0))

        for section, ids in (("pre", self.pre_ids), ("post", self.post_ids)):
            for i in ids:
                layer = self._layers[i]
                if layer.tied_key is not None:
                    if layer.tied_key not in params["tied"]:
                        params["tied"][layer.tied_key] = layer.init(layer_rng(i))
                elif layer.has_params:
                    params[section][str(i)] = layer.init(layer_rng(i))

        if self.body_ids:
            per_layer = [self._layers[i].init(layer_rng(i)) for i in self.body_ids]
            flat = [tree_flatten(p) for p in per_layer]

            def structure(p, leaves):
                return tree_paths(p), [np.shape(a) for a in leaves]

            first = structure(per_layer[0], flat[0][0])
            if any(structure(p, f[0]) != first for p, f in zip(per_layer[1:], flat[1:])):
                raise ValueError("pipeline body layers must have identical param structure")
            params["blocks"] = flat[0][1]([_stack(xs) for xs in zip(*(f[0] for f in flat))])
        return params

    # ------------------------------------------------------------------
    # application
    # ------------------------------------------------------------------
    def _apply_section(self, params: Dict[str, Any], ids: List[int], section: str, x,
                       seed: Optional[int]):
        for i in ids:
            layer = self._layers[i]
            if layer.tied_key is not None:
                p = params["tied"][layer.tied_key]
            elif layer.has_params:
                p = params[section][str(i)]
            else:
                p = None
            x = layer.apply(p, x, generator=layer_generator(seed, i))
        return x

    def apply_pre(self, params, x, seed: Optional[int] = None):
        return self._apply_section(params, self.pre_ids, "pre", x, seed)

    def apply_post(self, params, x, seed: Optional[int] = None):
        return self._apply_section(params, self.post_ids, "post", x, seed)

    def apply_block(self, block_params, x, generator=None):
        """One body block, given its (unstacked) parameters."""
        return self._layers[self.body_ids[0]].apply(block_params, x, generator=generator)

    def apply_blocks(self, blocks: Dict[str, Any], x, first: int = 0, seed: Optional[int] = None,
                     remat: bool = False):
        """The body blocks whose stacked leaves ``blocks`` holds, in order;
        ``first`` is the first one's place in the body (a stage's offset).
        With ``activation_checkpoint_interval`` (or ``remat``: every
        block) each run of that many blocks is recomputed in the backward
        (``runtime/activation_checkpointing`` ``checkpoint_sequential``, as
        the JAX module routes it)."""
        from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (
            checkpoint_sequential,
        )

        flat, rebuild = tree_flatten(blocks)
        if not flat:
            return x
        interval = self.activation_checkpoint_interval
        if remat and interval <= 0:
            interval = 1

        def block(p, h, g):
            return self.apply_block(p, h, generator=g)

        def gen(j):
            return layer_generator(seed, self.body_ids[first + j])

        if interval > 0:
            return checkpoint_sequential(block, blocks, x, generator_for=gen, every=interval)
        # one unbind a leaf, so the backward stacks each leaf's gradient once
        per_leaf = [t.unbind(0) for t in flat]
        for j in range(len(per_leaf[0])):
            x = block(rebuild([u[j] for u in per_leaf]), x, gen(j))
        return x

    def apply_body(self, params, x, seed: Optional[int] = None, remat: bool = False):
        """Every body block in order (one process, one stage)."""
        return self.apply_blocks(params["blocks"], x, 0, seed, remat=remat)

    def sequential(self, params, x, seed: Optional[int] = None, remat: bool = False):
        """The whole forward without pipelining (one stage, eval, tests)."""
        x = self.apply_pre(params, x, seed)
        x = self.apply_body(params, x, seed, remat=remat)
        return self.apply_post(params, x, seed)

    # ------------------------------------------------------------------
    # partitioning bookkeeping (advisory, reference :355-410)
    # ------------------------------------------------------------------
    def configure_stages(self, num_stages: int) -> None:
        self.num_stages = num_stages
        if num_stages > 1:
            if not self.body_ids:
                raise ValueError(
                    "pipe parallelism needs a homogeneous run of layers to pipeline; "
                    "none found in this layer list"
                )
            if self.body_len % num_stages != 0:
                raise ValueError(
                    f"pipeline body of {self.body_len} layers does not divide "
                    f"evenly over {num_stages} stages"
                )
        self.parts = self._partition_layers(num_stages)
        for s in range(num_stages):
            logger.info(f"pipe stage {s}: layers [{self.parts[s]}, {self.parts[s + 1]})")

    def _partition_layers(self, num_stages: int) -> List[int]:
        method = (self.partition_method or "uniform").lower()
        n = len(self._layers)
        if method == "uniform":
            return partition_uniform(n, num_stages)
        if method == "parameters":
            weights = [self._layer_param_count(i) for i in range(n)]
            return partition_balanced(weights, num_stages)
        if method.startswith("type:"):
            pat = method.split(":", 1)[1]
            weights = [1 if re.search(pat, self._layers[i].name, re.IGNORECASE) else 0
                       for i in range(n)]
            return partition_balanced(weights, num_stages)
        raise NotImplementedError(f"partition_method '{method}'")

    def _layer_param_count(self, i: int) -> int:
        return self._layers[i].num_params()

    def stage_of_layer(self, layer_idx: int) -> int:
        assert self.parts is not None, "configure_stages() first"
        for s in range(len(self.parts) - 1):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise ValueError(layer_idx)

    @property
    def num_layers(self) -> int:
        return len(self._layers)

    def topology(self):
        return self._topology

    def ckpt_layer_path(self, ckpt_dir: str, local_layer_idx: int) -> str:
        return os.path.join(ckpt_dir, f"layer_{local_layer_idx:02d}-model_states.pt")
