"""Parameter annotations by logical axis; the single-device half of
``repro.sharding`` (meshes and rules come with the sharding slice)."""
from repro_torch.sharding.spec import (
    Param,
    axes_tree,
    param,
    shard_act,
    values_tree,
)

__all__ = ["Param", "axes_tree", "param", "shard_act", "values_tree"]
