from repro_torch.distributed.sharding import (
    LOGICAL_RULES,
    PartitionSpec,
    distribute_tree,
    logical_constraint,
    param_specs,
    placements_for,
    set_mesh,
    spec_for,
    use_mesh,
)

__all__ = [
    "LOGICAL_RULES",
    "PartitionSpec",
    "distribute_tree",
    "logical_constraint",
    "param_specs",
    "placements_for",
    "set_mesh",
    "spec_for",
    "use_mesh",
]
