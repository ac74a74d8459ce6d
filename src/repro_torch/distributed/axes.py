"""Logical-axis sharding (t5x-style) on a torch ``DeviceMesh``.

Model code names tensor dimensions with *logical* axes ("embed", "mlp",
"q_heads", ...).  A rule table maps logical names to mesh axes ("data",
"model", "pod", None); changing the sharding strategy means changing the
rule table only.  The counterpart of ``repro.distributed.axes``: a spec
is a tuple with one entry per dimension, a mesh-axis name, a tuple of
names or None, as the entries of the reference's ``PartitionSpec``.

``constrain(x, *names)`` redistributes a ``DTensor`` to the placements
its names give when a mesh and rules are active, and returns anything
else unchanged, so the same model code runs on one device and under a
mesh.  ``constrain`` applies ``partitioning.spec_for``'s divisibility
guard, as the reference's rule tables intend: a dimension the axis does
not divide stays whole, unless the strategy's ``_uneven`` suffix lifts
the guard, where GSPMD pads and DTensor splits in ``torch.chunk``'s
layout (40 heads over 16 ranks: 3 a rank, the last ranks fewer or none;
the model's local products and attention take such splits).
"""

from __future__ import annotations

import contextlib
import types
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisRule = Union[str, Tuple[str, ...], None]

# Process-wide, not thread-local (the reference's are): autograd runs a
# CUDA backward on a device thread of its own, and the forward that a
# checkpointed block recomputes there must see the rules it first ran under.
_state = types.SimpleNamespace(rules=None, mesh=None)


def set_logical_rules(rules: Dict[str, AxisRule], mesh) -> None:
    _state.rules = dict(rules)
    _state.mesh = mesh


def clear_logical_rules() -> None:
    _state.rules = None
    _state.mesh = None


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> Optional[Dict[str, AxisRule]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: Dict[str, AxisRule], mesh):
    """Rules and mesh active inside the block, the previous ones after."""
    before = current_rules(), current_mesh()
    set_logical_rules(rules, mesh)
    try:
        yield
    finally:
        if before[0] is None:
            clear_logical_rules()
        else:
            set_logical_rules(*before)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dimension names, or a stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def logical_to_spec(names: Sequence[Optional[str]]) -> Tuple:
    """Map a tuple of logical axis names to a spec (no divisibility guard)."""
    rules = current_rules() or {}
    mesh = current_mesh()
    mesh_axes = set(mesh_axis_names(mesh)) if mesh is not None else set()
    used: set = set()

    def resolve(name: Optional[str]):
        if name is None:
            return None
        axis = rules.get(name)
        if axis is None:
            return None
        # one mesh axis may shard only one dim of a given tensor, and the
        # axis must exist in the active mesh (e.g. no "pod" single-pod)
        flat = (axis,) if isinstance(axis, str) else tuple(axis)
        free = tuple(a for a in flat if a not in used and a in mesh_axes)
        if not free:
            return None
        used.update(free)
        return free if len(free) > 1 else free[0]

    return tuple(resolve(n) for n in names)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Redistribute ``x`` to its logical sharding (no-op without a mesh
    and rules, or on a plain tensor)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.partitioning import placements_for, spec_for

    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or not isinstance(x, DTensor):
        return x
    if x.ndim != len(names):
        raise ValueError(f"rank {x.ndim} vs names {names}")
    return x.redistribute(mesh, placements_for(mesh, spec_for(mesh, rules, names, x.shape)))
