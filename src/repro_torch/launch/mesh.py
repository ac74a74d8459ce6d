"""Mesh construction over the process group that is already up.

The counterpart of ``repro.launch.mesh``.  The caller brings up the
process group (``torch.distributed.run`` sets the rendezvous
environment; a test or a one-card run calls ``init_process_group``
itself with its address, world size and rank), and these functions lay
a named ``DeviceMesh`` over its ranks.  A world of one is a valid mesh:
(1, 1) over one rank runs every step of the distributed path with no
traffic between ranks.
"""

from __future__ import annotations

from typing import Sequence


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` (e.g. ((1, 1),
    ("data", "model"))) over the current process group's ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: init_process_group first")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has {dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """16x16 ("data", "model"), or 2x16x16 ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
