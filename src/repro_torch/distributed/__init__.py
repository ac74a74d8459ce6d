"""Distribution on a torch ``DeviceMesh``: logical-axis partitioning,
collectives and the sharded decode attention."""

from repro_torch.distributed.axes import (
    clear_logical_rules,
    constrain,
    current_mesh,
    current_rules,
    logical_rules,
    logical_to_spec,
    set_logical_rules,
)

__all__ = [
    "clear_logical_rules",
    "constrain",
    "current_mesh",
    "current_rules",
    "logical_rules",
    "logical_to_spec",
    "set_logical_rules",
]
