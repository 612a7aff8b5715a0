"""ZeRO stages 1–3 as sharding rules (counterpart of
``deepspeed_tpu/runtime/zero/stages.py``).

The rules are the JAX package's: for a parameter tree, a mesh and a
stage they name, leaf by leaf, how the parameters, the gradients and the
optimizer state are cut over the mesh axes (a
:class:`~deepspeed_tpu_torch.sharding.spec.PartitionSpec` per leaf), and
the JAX engine hands them to GSPMD.  The port's engine
(``runtime/engine.py``) reads the same specs and carries them out with
explicit ``torch.distributed`` collectives:

* **Stage 1** — optimizer state sharded over the ``fsdp`` axis (and over
  ``data`` too, by cross-replica weight-update sharding, arXiv:2004.13336):
  each rank updates its slice of the masters, then the updated masters are
  all-gathered.
* **Stage 2** — + gradients reduce-scattered over ``fsdp`` every
  micro-step (``grad_spec``), unless ``reduce_scatter`` is false.
* **Stage 3** — + parameters sharded over ``fsdp``; a block's weights are
  gathered inside that block's checkpoint region, so the recompute
  gathers them again and they are freed after the block
  (``runtime/zero/partition.py``).  Leaves under the persistence
  threshold stay replicated.

Leaves with no fsdp-divisible dimension take the flat, zero-padded 1-D
layout of :meth:`ZeroShardingRules.plan_flat`.  The rules compose with
tensor-parallel specs: fsdp goes on the largest dimension not taken by
``model``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.sharding.layout import DEFAULT_LAYOUT, dp_rows_spec
from deepspeed_tpu_torch.sharding.spec import PartitionSpec as P
from deepspeed_tpu_torch.sharding.update import (
    add_mesh_axis,
    add_update_axis,
    spec_tuple as _spec_tuple,
)


def add_fsdp_axis(
    shape: Sequence[int],
    base_spec: Optional[P],
    fsdp_size: int,
    min_size: int = 0,
) -> P:
    """Add the ``fsdp`` axis to a param's PartitionSpec.

    Picks the largest dim that (a) is not already sharded by another axis
    and (b) is divisible by ``fsdp_size``.  Params smaller than
    ``min_size`` elements (the ZeRO-3 persistence threshold,
    stage3.py:1416) or with no divisible dim stay as-is (replicated over
    fsdp) — matching the reference's ``persistent_parameters`` behavior.
    (Thin wrapper over the axis-placement primitive in sharding/update.py.)
    """
    return add_mesh_axis(shape, base_spec, DEFAULT_LAYOUT.fsdp_axis, fsdp_size, min_size=min_size)


class ZeroShardingRules:
    """Produces PartitionSpecs for params / grads / optimizer state for a
    given ZeRO stage.  ``tp_spec_fn(path, shape)`` supplies the
    tensor-parallel base spec (the ``model`` axis) if any — in practice
    the partition-rule engine's adapter
    (:meth:`deepspeed_tpu_torch.sharding.rules.PartitionRules.tp_spec_fn`).

    ``data_size`` enables **cross-replica weight-update sharding**
    (arXiv:2004.13336; ``zero_optimization.cross_replica_weight_update``,
    default on): optimizer state — and with it the update computation —
    shards across the pure ``data`` axis too, so stage 1 on a pure-DP
    mesh cuts per-replica update FLOPs and optimizer-state bytes ~dp×
    for one updated-params all-gather per step."""

    def __init__(self, zero_config, fsdp_size: int, tp_spec_fn=None, data_size: int = 1):
        self.config = zero_config
        self.stage = zero_config.stage
        self.fsdp_size = fsdp_size
        self.data_size = data_size
        self.tp_spec_fn = tp_spec_fn or (lambda path, shape: None)
        # paths stored flat-padded in engine state (see plan_flat)
        self.flat_paths: set = set()

    @property
    def cross_replica_active(self) -> bool:
        """Whether optimizer state shards across the pure data axis."""
        return (
            self.stage >= 1
            and self.data_size > 1
            and getattr(self.config, "cross_replica_weight_update", True)
        )

    # -- flat-fallback plan ------------------------------------------------
    def plan_flat(self, params: Any) -> dict:
        """Choose leaves that dimension-wise sharding cannot cover — no
        axis divisible by ``fsdp_size`` and no tensor-parallel spec — and
        return ``{path: (shape, size, padded_size)}`` for them.

        The engine stores those leaves (params / grads / optimizer state)
        as zero-padded 1-D fp32 vectors sharded over ``fsdp``, the JAX
        analog of the reference's flattened contiguous partitions
        (``stage2.py:432``, ``partition_parameters.py:688``): every
        element shards 1/W regardless of tensor shape.
        """
        plan: dict = {}
        if self.fsdp_size <= 1 or self.stage < 1:
            self.flat_paths = set()
            return plan
        threshold = self.config.param_persistence_threshold if self.stage >= 3 else 0

        def visit(p, leaf):
            shape = tuple(np.shape(leaf))
            n = int(np.prod(shape)) if shape else 1
            if not shape or n < max(self.fsdp_size, threshold):
                return
            if self.tp_spec_fn(p, shape) is not None:
                return
            spec = add_fsdp_axis(shape, None, self.fsdp_size)
            if any(a == "fsdp" for a in _spec_tuple(spec, len(shape))):
                return  # dim-shardable: the normal path covers it
            padded = -(-n // self.fsdp_size) * self.fsdp_size
            plan[p] = (shape, n, padded)

        tree_map_with_path(visit, params)
        self.flat_paths = set(plan)
        return plan

    def _flat_spec(self) -> P:
        """Spec of a flat-padded 1-D state leaf (sharded over fsdp)."""
        return dp_rows_spec(DEFAULT_LAYOUT.fsdp_axis)

    # -- params ------------------------------------------------------------
    def param_spec(self, path, shape) -> P:
        if path in self.flat_paths:
            return self._flat_spec() if self.stage >= 3 else P()
        base = self.tp_spec_fn(path, shape)
        if self.stage >= 3 and self.fsdp_size > 1:
            return add_fsdp_axis(shape, base, self.fsdp_size, min_size=self.config.param_persistence_threshold)
        return base if base is not None else P()

    # -- grads -------------------------------------------------------------
    def grad_spec(self, path, shape) -> P:
        # zero_optimization.reduce_scatter = false (reference stage2.py's
        # allreduce fallback): grads stay replicated over fsdp, so the
        # engine all-reduces instead of reduce-scattering — ~2x the wire
        # and a params-sized grad buffer per rank; the engine warns once
        # and the comm layer records the forced-dense decision
        if path in self.flat_paths:
            return self._flat_spec() if self.stage >= 2 and self.config.reduce_scatter else P()
        base = self.tp_spec_fn(path, shape)
        if self.stage >= 2 and self.fsdp_size > 1 and self.config.reduce_scatter:
            # stage 3 grads are sharded the same way as the param so the
            # reduce-scatter lands at the owner (partition_parameters.py:934)
            min_size = self.config.param_persistence_threshold if self.stage >= 3 else 0
            return add_fsdp_axis(shape, base, self.fsdp_size, min_size=min_size)
        return base if base is not None else P()

    # -- optimizer state ---------------------------------------------------
    def opt_spec(self, path, shape) -> P:
        if path in self.flat_paths:
            # flat leaves keep their fsdp-only layout (their padded size
            # is a function of fsdp_size alone — see plan_flat); the
            # cross-replica win on these rare awkward leaves is not
            # worth a second padding geometry
            return self._flat_spec()
        base = self.tp_spec_fn(path, shape)
        spec = base if base is not None else P()
        if self.stage >= 1 and self.fsdp_size > 1:
            min_size = self.config.param_persistence_threshold if self.stage >= 3 else 0
            spec = add_fsdp_axis(shape, base, self.fsdp_size, min_size=min_size)
        if self.cross_replica_active:
            # cross-replica weight-update sharding: the update math
            # follows the optimizer-state placement, so extending the
            # state across ``data`` shards the update ~dp× (the params
            # all-gather back at the constraint in the engine's update)
            spec = add_update_axis(
                shape, spec, DEFAULT_LAYOUT.data_axis, self.data_size,
                fsdp_axis=DEFAULT_LAYOUT.fsdp_axis, fsdp_size=self.fsdp_size,
            )
        return spec

    # -- pytree helpers ----------------------------------------------------
    def tree_param_specs(self, params: Any) -> Any:
        return _tree_specs_with_paths(params, self.param_spec)

    def tree_grad_specs(self, params: Any) -> Any:
        return _tree_specs_with_paths(params, self.grad_spec)

    def tree_opt_specs_like(self, params: Any) -> Any:
        """Specs for one params-shaped slot of optimizer state (m or v)."""
        return _tree_specs_with_paths(params, self.opt_spec)


def _path_str(path) -> str:
    """A leaf's path as the JAX package writes it: dict keys, sequence
    indices and field names joined by ``/``."""
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, tree: Any, _path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of a tree of dicts (sorted keys,
    as a JAX pytree flattens), lists and tuples; ``path`` is the leaf's
    ``/``-joined path.  Returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], _path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, x, _path + (i,)) for i, x in enumerate(tree))
    return fn(_path_str(_path), tree)


def _tree_specs_with_paths(tree: Any, spec_fn) -> Any:
    return tree_map_with_path(lambda path, leaf: spec_fn(path, tuple(np.shape(leaf))), tree)


def zero_step_comm_model(
    n_params: int,
    fsdp: int,
    stage: int,
    gas: int = 1,
    param_bytes: int = 2,
    grad_bytes: int = 4,
    reduce_scatter: bool = True,
) -> dict:
    """First-order per-train-step collective-byte model for a ZeRO step
    over the ``fsdp`` axis (the JAX package's, unchanged).

    Ring-traffic convention: an all-reduce counts twice its payload, an
    all-gather its (full) result bytes once, a reduce-scatter its
    (sharded) result bytes once; ``comm/collectives.py`` counts every
    call the same way.  Stage 3 gathers the params (``param_bytes``, the
    compute type) once in forward and once in the backward per micro
    batch; grads reduce-scatter once per micro batch at stage >= 2,
    all-reduce (2x) at stage <= 1 — or always, when the
    ``zero_optimization.reduce_scatter`` flag forces the dense all-reduce
    fallback.  The data-axis gradient exchange is
    :func:`deepspeed_tpu_torch.comm.strategy.step_comm_bytes`' term.

    The port's engine meets this model kind by kind when every leaf is
    sharded (no leaf under the persistence threshold, ``n_params``
    counting flat leaves at their padded size, as the JAX engine's state
    does).  Its stage-3 backward gathers a block's weights again in the
    block's recompute, and the other sharded leaves again at the first
    use of any of them in the backward (``runtime/zero/partition.py``).

    Kinds the model leaves out, which the port counts under their own
    names (:func:`port_step_comm_extras` models the first):

    * ``update-all-gather`` — the updated masters gathered after a sharded
      update at stage >= 1 (the JAX package's "one updated-params
      all-gather per step", ``sharding/update.py::weight_update_model``);
    * ``step-scalars`` — one all-reduce per step of four f32 values (the
      squared gradient norm, the overflow count, the loss sum and the
      ranks' preemption flags): 32 bytes;
    * ``lamb-norms`` — LAMB's two squared norms per sharded leaf: 16 bytes
      a leaf a step;
    * ``checkpoint`` — the gathers of a save, outside the step;
    * ``seq-grad-exchange`` (:func:`port_step_comm_extras`) and the
      activations' ``tp-all-reduce``, ``seq-p2p``, ``seq-all-to-all`` and
      ``seq-loss`` (:func:`port_parallel_comm_model`), under tensor and
      sequence parallelism; there ``n_params`` counts one ``model``
      rank's blocks.
    """
    if fsdp <= 1:
        return {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0, "total": 0}
    ag = 2 * n_params * param_bytes * gas if stage >= 3 else 0
    rs = n_params // fsdp * grad_bytes * gas if stage >= 2 and reduce_scatter else 0
    ar = 2 * n_params * grad_bytes * gas if (stage < 2 or not reduce_scatter) else 0
    return {"all-gather": ag, "reduce-scatter": rs, "all-reduce": ar, "total": ag + rs + ar}


def port_step_comm_extras(
    n_params: int,
    mesh_sizes: Dict[str, int],
    stage: int,
    cross_replica: bool = True,
    master_bytes: int = 4,
    gas: int = 1,
    grad_bytes: int = 4,
) -> Dict[str, int]:
    """The port's ``update-all-gather`` and ``seq-grad-exchange`` bytes a
    step.  ``update-all-gather``: after a sharded
    update the f32 masters are gathered back to the parameter layout.  At
    stages 1 and 2 the masters are whole on every rank, so a sharded
    update gathers every master (``master_bytes * n_params``, the JAX
    package's ``weight_update_model``); at stage 3 they stay fsdp-sharded,
    and only the cross-replica ``data`` cut is gathered
    (``master_bytes * n_params / fsdp``).  First-order as
    :func:`zero_step_comm_model`: every leaf's update sharded (flat leaves
    keep their fsdp-only layout).  ``seq-grad-exchange``: every
    micro-step's f32 gradient all-reduced over ``seq`` before the
    data-parallel reduction (each ``seq`` rank saw other positions), ``2 *
    n_params * grad_bytes * gas``.  ``n_params``: one ``model`` rank's
    elements."""
    fsdp = mesh_sizes.get("fsdp", 1)
    data = mesh_sizes.get("data", 1)
    extra = data if (cross_replica and data > 1 and stage >= 1) else 1
    if stage < 1:
        ag = 0
    elif stage >= 3:
        ag = master_bytes * n_params // fsdp if extra > 1 else 0
    else:
        ag = master_bytes * n_params if fsdp * extra > 1 else 0
    seq = mesh_sizes.get("seq", 1)
    sg = 2 * n_params * grad_bytes * gas if seq > 1 else 0
    return {"update-all-gather": int(ag), "seq-grad-exchange": int(sg)}


def port_parallel_comm_model(
    n_layer: int,
    d_model: int,
    rows: int,
    T: int,
    mesh_sizes: Dict[str, int],
    loss_positions: int,
    tp_extra_bytes: int = 0,
    gas: int = 1,
    act_bytes: int = 2,
    attention_mode: str = "flash",
    remat: bool = True,
    xent_chunk: int = 0,
    mlp_recompute: bool = False,
) -> Dict[str, int]:
    """Bytes a step of the activations' collectives under tensor and
    sequence parallelism, first-order (the conventions of
    ``comm/collectives.py``), for a stack of ``n_layer`` pre-/post-LN
    blocks with a vocab-parallel embedding and tied head, ``rows`` rows of
    ``T`` tokens a micro-step and ``act_bytes`` the compute type's size.
    The model supplies what is its own: ``loss_positions`` (``N``, the
    positions whose NLL a rank computes) and ``tp_extra_bytes`` (any
    further ``model`` all-reduce a micro-step).  With ``Tl = T / seq`` and
    ``a = rows * Tl * d_model * act_bytes`` (one rank's activations):

    * ``tp-all-reduce`` (``model`` m > 1): a block all-reduces its
      attention and MLP outputs forward (``reduce_from_model``) and the
      gradients of their inputs backward (``copy_to_model``), ``4 * 2a``
      a layer; under ``remat`` the recompute runs the attention's again,
      and the MLP's only where something after it keeps a tensor for the
      backward (``mlp_recompute``: hidden dropout's mask, a post-LN
      LayerNorm) — ``torch.utils.checkpoint`` stops a recompute once it
      has every tensor the backward needs;
      the vocab-parallel embedding ``2a``; the tied head's input gradient
      ``2a``; the vocab-parallel NLL over ``N`` positions, the max and
      then the sum and the target (f32), ``24 N`` bytes, twice with
      chunked cross-entropy (each chunk recomputed); ``tp_extra_bytes``.
    * ``seq-p2p`` (``ring``, seq P > 1): K and V (``kv = a / m`` each) P-1
      times forward (again in the recompute), backward K and V P-1 times
      and the f32 dK and dV P times.
    * ``seq-all-to-all`` (``ulysses``): q, k, v and the output forward
      (again in the recompute), their gradients backward, ``a / m``
      each.
    * ``seq-loss``: the loss's (sum, count) all-reduced over ``seq``, 16
      bytes.
    """
    m, P = mesh_sizes.get("model", 1), mesh_sizes.get("seq", 1)
    Tl = T // P
    a = rows * Tl * d_model * act_bytes
    rc = 1 if remat else 0
    out = {"tp-all-reduce": 0, "seq-p2p": 0, "seq-all-to-all": 0, "seq-loss": 0}
    if m > 1:
        tp = n_layer * (4 + rc * (1 + int(mlp_recompute))) * 2 * a + 2 * 2 * a
        tp += 24 * loss_positions * (2 if xent_chunk > 0 else 1)
        out["tp-all-reduce"] = tp + tp_extra_bytes
    if P > 1:
        kv = a // m
        if attention_mode == "ring":
            fwd = (P - 1) * 2 * kv
            bwd = (P - 1) * 2 * kv + P * 2 * (kv // act_bytes) * 4
            out["seq-p2p"] = n_layer * ((1 + rc) * fwd + bwd)
        elif attention_mode == "ulysses":
            out["seq-all-to-all"] = n_layer * (4 * (1 + rc) + 4) * kv
        out["seq-loss"] = 16
    return {k: int(v * gas) for k, v in out.items()}
