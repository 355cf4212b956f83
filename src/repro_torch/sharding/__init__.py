"""Logical-axis partitioning of the port (``repro.sharding``)."""
from repro_torch.sharding.partition import (
    DEFAULT_RULES,
    AbstractMesh,
    AxisRules,
    Param,
    abstract_mesh,
    activate,
    boxed_axes,
    current_mesh_and_rules,
    is_param,
    local_shape,
    logical_to_mesh_axes,
    param_spec,
    tree_shardings,
    unbox,
    with_logical_constraint,
)
