"""Logical-axis sharding on a torch ``DeviceMesh`` (port of
``repro.sharding``): parameter annotations, the strategies' rule tables
(``rules``, a byte copy), their resolution to PartitionSpecs and DTensor
placements, and the activation sharding context."""
from repro_torch.sharding.rules import AXIS_RULES, rules_for_strategy
from repro_torch.sharding.spec import (
    Param,
    PartitionSpec,
    ShardCtx,
    axes_tree,
    current_ctx,
    param,
    placements,
    shard_act,
    spec_tree,
    to_pspec,
    use_shard_ctx,
    values_tree,
)

__all__ = ["AXIS_RULES", "Param", "PartitionSpec", "ShardCtx", "axes_tree",
           "current_ctx", "param", "placements", "rules_for_strategy",
           "shard_act", "spec_tree", "to_pspec", "use_shard_ctx",
           "values_tree"]
