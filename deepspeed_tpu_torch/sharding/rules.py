"""Ordered regex partition-rule tables (counterpart of
``deepspeed_tpu/sharding/rules.py``; fmengine ``match_partition_rules`` /
T5X logical-axes style).

The port's engine reads these tables as the JAX engine does: a leaf
with a tensor-parallel base spec is kept out of
``ZeroShardingRules.plan_flat``, keeps its ``model`` entry in every spec,
and each ``model`` rank holds its block of it; the models run the
Megatron operators of ``parallel/tensor.py`` on those blocks.  One leaf
kind is laid out otherwise than JAX's ``NamedSharding`` would cut it:
:func:`fused_tp_parts` names the fused ``q|k|v`` projection, whose rank
block is the columns of the rank's heads of each part
(``runtime/zero/partition.py``).

A rule table is an ordered sequence of ``(regex, PartitionSpec|None)``
pairs matched against the ``/``-joined path of each parameter leaf;
the FIRST match wins, ``None`` means "no tensor-parallel base spec"
(the ZeRO layer may still add fsdp/data axes).  Built-in tables cover
the model families the repo ships (gpt2 / bert / gpt-neo / MoE) and new
families register with :func:`register_family` — sharding for free, no
engine changes.

Packed int8 weights (the JAX package's ``runtime/weight_quantizer.pack_int8_tree``) nest one
level: ``.../<name>_w/q`` carries the weight spec and ``.../<name>_w/s``
drops the contracted (input) dim — the rule engine normalizes those
paths so every consumer (inference, serving pools) resolves identically.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
from deepspeed_tpu_torch.sharding.layout import DEFAULT_LAYOUT, SpecLayout
from deepspeed_tpu_torch.sharding.spec import PartitionSpec

Rule = Tuple[str, Optional[PartitionSpec]]
SpecFn = Callable[[str, Sequence[int]], Optional[PartitionSpec]]


# ---------------------------------------------------------------------------
# MoE expert-parallel specs — the single source of truth for the MoE
# weight layout (experts over ``expert``, FFN hidden dim over the tp
# axis).
# ---------------------------------------------------------------------------

def moe_param_specs(
    layer_dim: bool = False, tp_axis: Optional[str] = None, layout: SpecLayout = DEFAULT_LAYOUT
) -> Dict[str, PartitionSpec]:
    """PartitionSpecs for MoE weights: experts over ``expert`` and
    (optionally) the expert-FFN hidden dim over ``tp_axis`` (EP × TP).
    ``layer_dim=True`` prepends a replicated leading dim for models that
    stack per-layer weights for ``lax.scan`` (models/gpt2.py)."""
    e = layout.expert_axis
    specs = {
        "gate_w": PartitionSpec(),
        "w1": PartitionSpec(e, None, tp_axis),
        "b1": PartitionSpec(e, tp_axis),
        "w2": PartitionSpec(e, tp_axis, None),
        "b2": PartitionSpec(e, None),
    }
    if layer_dim:
        specs = {k: PartitionSpec(None, *v) for k, v in specs.items()}
    return specs


# ---------------------------------------------------------------------------
# core matcher
# ---------------------------------------------------------------------------

class PartitionRules:
    """An ordered (regex → PartitionSpec) table with the packed-int8
    path normalization.  ``spec(path, shape)`` returns the
    tensor-parallel base spec for one leaf (None = replicated over tp),
    the contract :class:`~deepspeed_tpu_torch.runtime.zero.stages.ZeroShardingRules`
    consumes."""

    def __init__(self, rules: Sequence[Rule], name: str = "custom", layout: SpecLayout = DEFAULT_LAYOUT):
        self.name = name
        self.layout = layout
        self.rules: Tuple[Tuple[re.Pattern, Optional[PartitionSpec]], ...] = tuple(
            (re.compile(rx), spec) for rx, spec in rules
        )

    # -- construction ---------------------------------------------------
    @classmethod
    def from_fn(cls, fn: SpecFn, name: str = "client-fn") -> "PartitionRules":
        """Wrap a legacy ``tp_spec_fn(path, shape)`` callable so every
        consumer sees one interface."""
        self = cls((), name=name)
        self._fn = fn
        return self

    @classmethod
    def empty(cls) -> "PartitionRules":
        return cls((), name="none")

    @classmethod
    def coerce(cls, partition_rules=None, tp_spec_fn=None) -> "PartitionRules":
        """Normalize the engines' layout inputs — a legacy ``tp_spec_fn``
        callable, a :class:`PartitionRules`, a family name, an ordered
        rule table, or nothing — into one :class:`PartitionRules` (the
        single coercion both DeepSpeedEngine and PipelineEngine use)."""
        if tp_spec_fn is not None:
            return cls.from_fn(tp_spec_fn)
        if partition_rules is None:
            return cls.empty()
        if isinstance(partition_rules, cls):
            return partition_rules
        if isinstance(partition_rules, str):
            return rules_for_family(partition_rules)
        return cls(partition_rules)

    # -- resolution -----------------------------------------------------
    _fn: Optional[SpecFn] = None

    def _match(self, path: str) -> Optional[PartitionSpec]:
        for rx, spec in self.rules:
            if rx.search(path) is not None:
                return spec
        return None

    def matches(self, path: str) -> bool:
        """Whether ANY rule covers ``path`` (a matched ``None`` spec —
        "explicitly replicated" — still counts; fn-backed tables are
        treated as total)."""
        if self._fn is not None:
            return True
        return any(rx.search(path) is not None for rx, _ in self.rules)

    def base_spec(self, path: str, shape: Sequence[int]) -> Optional[PartitionSpec]:
        """The raw table lookup (no packed normalization)."""
        if self._fn is not None:
            return self._fn(path, shape)
        return self._match(path)

    def spec(self, path: str, shape: Sequence[int]) -> Optional[PartitionSpec]:
        """Table lookup with packed-int8 normalization: ``.../x/q``
        resolves as ``.../x``; ``.../x/s`` additionally drops the
        contracted (second-to-last) dim of the resolved spec.

        Legacy client fns see the RAW path: the q/s convention belongs
        to the family tables (packed-int8 trees the inference engines
        build); a client ``tp_spec_fn`` may legitimately name leaves
        ``q`` or ``s`` and must keep its pre-rule-engine behavior."""
        if self._fn is not None:
            return self._fn(path, shape)
        parts = path.split("/")
        packed_kind = parts[-1] if len(parts) > 1 and parts[-1] in ("q", "s") else None
        if packed_kind is None:
            return self.base_spec(path, shape)
        base = self.base_spec("/".join(parts[:-1]), shape)
        if base is None:
            return None
        if packed_kind == "s":
            dims = tuple(base)
            if len(dims) < 2:
                return PartitionSpec()
            return PartitionSpec(*(dims[:-2] + (dims[-1],)))
        return base

    def tp_spec_fn(self) -> SpecFn:
        """Adapter with the legacy ``tp_spec_fn(path, shape)`` shape."""
        return self.spec

    # -- composition ----------------------------------------------------
    def stacked(self, axis: Optional[str] = None, prefix: str = "blocks") -> "PartitionRules":
        """Pipeline-stacked view: leaves under ``prefix`` gained a
        leading stacked-layer dim sharded over ``axis`` (default: the
        layout's pipe axis).  Per-block specs (rank < leaf rank — legacy
        client fns see the per-block shape) shift right by one; full-rank
        specs (the built-in family tables already carry a replicated
        stacked-layer dim) get the axis composed onto their leading dim."""
        ax = axis if axis is not None else self.layout.pipe_axis

        def fn(path: str, shape: Sequence[int]) -> Optional[PartitionSpec]:
            if path == prefix or path.startswith(prefix + "/"):
                base = self.spec(path, tuple(shape)[1:])
                dims = tuple(base) if base is not None else ()
                if len(shape) and len(dims) >= len(shape):
                    lead = dims[0]
                    if lead is None:
                        return PartitionSpec(ax, *dims[1:])
                    lead_axes = (lead,) if isinstance(lead, str) else tuple(lead)
                    return PartitionSpec((ax,) + lead_axes, *dims[1:])
                return PartitionSpec(ax, *dims)
            return self.spec(path, shape)

        out = PartitionRules.from_fn(fn, name=f"{self.name}+stacked({ax})")
        out.layout = self.layout
        return out

    # -- whole-tree resolution (fmengine match_partition_rules) ---------
    def tree_specs(self, params: Any, strict: bool = False) -> Any:
        """Resolve the whole param tree to base specs: scalars →
        replicated; unmatched leaves → replicated (or raise when
        ``strict``)."""
        from deepspeed_tpu_torch.runtime.zero.stages import tree_map_with_path

        def get(path, leaf):
            shape = tuple(np.shape(leaf))
            if len(shape) == 0 or int(np.prod(shape)) == 1:
                return PartitionSpec()
            spec = self.spec(path, shape)
            if spec is None:
                # a matched None rule means "explicitly replicated";
                # only a path NO rule covers is a strict-mode error
                if strict and not self.matches(path):
                    raise ValueError(f"partition rule not found for param: {path}")
                return PartitionSpec()
            return spec

        return tree_map_with_path(get, params)

    def __repr__(self) -> str:
        kind = "fn" if self._fn is not None else f"{len(self.rules)} rules"
        return f"PartitionRules({self.name!r}, {kind})"


def match_partition_rules(rules: Sequence[Rule], params: Any, strict: bool = True) -> Any:
    """fmengine-style convenience: resolve a pytree of PartitionSpecs
    from an ordered rule table; scalar leaves stay replicated; unmatched
    leaves raise (pass ``strict=False`` to replicate them instead)."""
    return PartitionRules(rules, name="inline").tree_specs(params, strict=strict)


# ---------------------------------------------------------------------------
# built-in family tables
# ---------------------------------------------------------------------------

def _transformer_tp_rules(layout: SpecLayout) -> Tuple[Rule, ...]:
    """Megatron column/row split for the stacked fused-block layout both
    model families share (models/gpt2.py, models/bert.py): qkv/fc
    column-parallel, proj row-parallel.  Block weights carry a leading
    stacked-layer dim, so the specs are rank-3."""
    tp = layout.tp_axis
    return (
        # column-parallel: output features over tp
        (r"(^|/)qkv_w$", PartitionSpec(None, None, tp)),
        (r"(^|/)qkv_b$", PartitionSpec(None, tp)),
        (r"(^|/)fc_w$", PartitionSpec(None, None, tp)),
        (r"(^|/)fc_b$", PartitionSpec(None, tp)),
        # row-parallel: input (contracted) features over tp
        (r"(^|/)proj_w$", PartitionSpec(None, tp, None)),
        (r"(^|/)fc_proj_w$", PartitionSpec(None, tp, None)),
    )


def _moe_rules(layout: SpecLayout) -> Tuple[Rule, ...]:
    """Expert weights (stacked layer dim leading) from the canonical MoE
    layout; the router (gate_w) stays replicated so it is NOT ruled here
    (the default replication covers it)."""
    specs = moe_param_specs(layer_dim=True, tp_axis=layout.tp_axis, layout=layout)
    return tuple((rf"(^|/){name}$", spec) for name, spec in specs.items() if name != "gate_w")


def _gpt2_rules(layout: SpecLayout) -> Tuple[Rule, ...]:
    return _transformer_tp_rules(layout) + _moe_rules(layout) + (
        # vocab-parallel token embedding (tied head resolves to the same
        # table); wpe/layernorms/biases fall through to replicated
        (r"(^|/)wte$", layout.vocab_embedding()),
    )


def _bert_rules(layout: SpecLayout) -> Tuple[Rule, ...]:
    return _transformer_tp_rules(layout) + (
        (r"(^|/)tok_emb$", layout.vocab_embedding()),
    )


_FAMILIES: Dict[str, Callable[[SpecLayout], Tuple[Rule, ...]]] = {}


def register_family(name: str, builder: Callable[[SpecLayout], Tuple[Rule, ...]]) -> None:
    """Register a family rule-table builder (new model families get
    sharding by adding one table, not by touching engines)."""
    _FAMILIES[name] = builder


def _neo_rules(layout: SpecLayout) -> Tuple[Rule, ...]:
    """GPT-Neo shares the GPT-2 param schema (models/gpt2.py PRESETS
    "gpt-neo-2.7b" is a GPT2Config with local-attention layers) but is
    dense-only, so its table carries no MoE expert rows — every row
    here matches a leaf a Neo checkpoint can actually contain
    (the JAX package's ds_shard ``dead-rule-row``)."""
    return _transformer_tp_rules(layout) + (
        (r"(^|/)wte$", layout.vocab_embedding()),
    )


def _moe_family_rules(layout: SpecLayout) -> Tuple[Rule, ...]:
    """MoE GPT-2 (models/gpt2.py with n_experts > 0): attention stays
    Megatron-split, the FFN is the expert stack — the dense fc_w/fc_b/
    fc_proj_w rows never match an MoE tree (the experts replace the
    dense FFN entirely), so they are omitted rather than kept dead."""
    tp = layout.tp_axis
    return (
        (r"(^|/)qkv_w$", PartitionSpec(None, None, tp)),
        (r"(^|/)qkv_b$", PartitionSpec(None, tp)),
        (r"(^|/)proj_w$", PartitionSpec(None, tp, None)),
    ) + _moe_rules(layout) + (
        (r"(^|/)wte$", layout.vocab_embedding()),
    )


register_family("gpt2", _gpt2_rules)
register_family("bert", _bert_rules)
register_family("neo", _neo_rules)
register_family("moe", _moe_family_rules)

_RULES_CACHE: Dict[Tuple[str, SpecLayout], PartitionRules] = {}


def rules_for_family(name: str, layout: SpecLayout = DEFAULT_LAYOUT) -> PartitionRules:
    """The built-in rule table for a model family (``gpt2`` / ``bert`` /
    ``neo`` / ``moe``)."""
    key = (name, layout)
    if key not in _RULES_CACHE:
        if name not in _FAMILIES:
            raise ValueError(f"unknown model family {name!r}; known: {sorted(_FAMILIES)}")
        _RULES_CACHE[key] = PartitionRules(_FAMILIES[name](layout), name=name, layout=layout)
    return _RULES_CACHE[key]


def rules_for_config(model_config: Any, layout: SpecLayout = DEFAULT_LAYOUT) -> PartitionRules:
    """Family rules for a model config object (GPT2Config → gpt2,
    BertConfig → bert) — how the inference/serving engines resolve."""
    for klass in type(model_config).__mro__:
        if klass.__name__ == "GPT2Config":
            return rules_for_family("gpt2", layout)
        if klass.__name__ == "BertConfig":
            return rules_for_family("bert", layout)
    raise ValueError(
        f"no built-in partition rules for model config {type(model_config).__name__}"
    )


# leaves whose model-cut (last) dimension packs equal parts side by side:
# GPT-2's and BERT's fused q|k|v projection.  JAX's P(None, None, 'model')
# cuts the packed columns contiguously (at model 2, rank 0 would hold all
# of q and half of k, and GSPMD reshards); a rank here holds
# [q_r | k_r | v_r], the columns of its own heads of each part.
# (a packed int8 qkv_w's codes and per-channel scales are cut alike)
FUSED_TP_PARTS: Tuple[Tuple[str, int], ...] = ((r"(^|/)qkv_[wb](/[qs])?$", 3),)


def fused_tp_parts(path: str) -> int:
    """How many equal parts a leaf's model-cut dimension packs (1: none)."""
    for rx, parts in FUSED_TP_PARTS:
        if re.search(rx, path):
            return parts
    return 1


def check_model_cut(leaves: Sequence[Tuple[str, Sequence[int]]], spec_fn: SpecFn, m: int) -> int:
    """Refuse, in the JAX package's words, every dimension a ``model`` axis
    of ``m`` ranks cuts and does not divide (the parts of a fused leaf
    each alike); ``leaves`` are ``(path, shape)`` pairs, ``spec_fn`` the
    tensor-parallel specs.  Returns how many leaves ``model`` cuts."""
    from deepspeed_tpu_torch.sharding.spec import entry_axes, spec_tuple

    cut = 0
    for path, shape in leaves:
        shape = tuple(int(n) for n in shape)
        for d, e in enumerate(spec_tuple(spec_fn(path, shape), len(shape))):
            if "model" not in entry_axes(e):
                continue
            cut += 1
            parts = fused_tp_parts(path) if d == len(shape) - 1 else 1
            if shape[d] % (parts * m):
                what = (f"each of its {parts} packed parts" if parts > 1
                        else f"the global size of its dimension {d}")
                raise ValueError(
                    f"{path}: its sharding over 'model' ({m} ranks) implies that {what} "
                    f"should be divisible by {m}, but it is equal to "
                    f"{shape[d] // parts} (full shape: {shape})")
    return cut


def family_catalog() -> Dict[str, int]:
    """{family: rule count}."""
    return {name: len(builder(DEFAULT_LAYOUT)) for name, builder in sorted(_FAMILIES.items())}
