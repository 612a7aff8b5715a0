"""Partition-rule engine of the port (counterpart of
``deepspeed_tpu/sharding/``): spec constructors (:mod:`.layout`), ordered
regex rule tables (:mod:`.rules`), mesh shapes and topology
(:mod:`.mesh`) and the cross-replica update placement (:mod:`.update`),
on the port's own :class:`~deepspeed_tpu_torch.sharding.spec.PartitionSpec`.
"""
from deepspeed_tpu_torch.sharding.layout import (
    DEFAULT_LAYOUT,
    SpecLayout,
    batch_pspec,
    dp_rows_spec,
    fsdp_trailing_spec,
    replicated_pspec,
    stacked_batch_pspec,
    stacked_micro_batch_pspec,
)
from deepspeed_tpu_torch.sharding.mesh import MESH_AXES, MeshTopology, resolve_mesh_shape
from deepspeed_tpu_torch.sharding.rules import (
    PartitionRules,
    match_partition_rules,
    moe_param_specs,
    rules_for_config,
    rules_for_family,
)
from deepspeed_tpu_torch.sharding.spec import PartitionSpec
from deepspeed_tpu_torch.sharding.update import (
    add_mesh_axis,
    add_update_axis,
    spec_tuple,
    weight_update_model,
)

__all__ = [
    "DEFAULT_LAYOUT",
    "SpecLayout",
    "batch_pspec",
    "dp_rows_spec",
    "fsdp_trailing_spec",
    "replicated_pspec",
    "stacked_batch_pspec",
    "stacked_micro_batch_pspec",
    "MESH_AXES",
    "MeshTopology",
    "resolve_mesh_shape",
    "PartitionRules",
    "PartitionSpec",
    "match_partition_rules",
    "moe_param_specs",
    "rules_for_config",
    "rules_for_family",
    "add_mesh_axis",
    "add_update_axis",
    "spec_tuple",
    "weight_update_model",
]
