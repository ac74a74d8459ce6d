"""Hand-rolled collectives: the int8-compressed gradient all-reduce.

The counterpart of ``repro.distributed.collectives``: each rank
quantizes to int8 against a globally agreed scale (one float32 MAX
all-reduce for the scale), with stochastic rounding, and the payload
moves as an int32 SUM all-reduce before the mean is taken.  The
rounding draws come from an explicit ``torch.Generator``;
``int8_allreduce_mean_drawn`` takes them as a tensor, so that two
implementations can be fed the same draws.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.param_util import tree_map


def stochastic_round_int8(x: torch.Tensor, scale: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x / scale on the int8 grid [-127, 127], rounded up where the
    uniform draw ``u`` falls below the fraction."""
    y = x / scale * 127.0
    lo = torch.floor(y)
    bern = (u < (y - lo)).to(torch.float32)
    return torch.clamp(lo + bern, -127, 127).to(torch.int8)


def int8_allreduce_mean_drawn(x: torch.Tensor, u: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce-mean of ``x`` over ``group`` with an int8 payload,
    rounding with the uniform draws ``u`` (``x``'s shape, [0, 1))."""
    n = dist.get_world_size(group)
    # shared scale, so that every rank quantizes against the same grid;
    # the max and its epsilon in x's dtype, as the reference's
    scale = torch.max(torch.abs(x)).float().reshape(1)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    scale = (scale[0].to(x.dtype) + 1e-12).float()
    q = stochastic_round_int8(x.float(), scale, u)
    s = q.to(torch.int32)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return (s.float() * scale / 127.0 / n).to(x.dtype)


def int8_allreduce_mean(x: torch.Tensor, gen: torch.Generator, group=None) -> torch.Tensor:
    """``int8_allreduce_mean_drawn`` with draws from ``gen`` (on ``x``'s device)."""
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32)
    return int8_allreduce_mean_drawn(x, u, group)


def compressed_grad_mean(grads: Any, mesh, axis_name: str, gen: torch.Generator) -> Any:
    """Tree-wide int8 all-reduce-mean over one mesh axis's group.

    Each rank passes its own gradients (a DTensor leaf contributes its
    local shard and comes back with the same placements); they are
    assumed replicated along every other mesh axis.  Each leaf is
    flattened and zero-padded to a multiple of the axis size, as in the
    reference, and its draws come from ``gen`` leaf by leaf.
    """
    from torch.distributed.tensor import DTensor

    group = mesh.get_group(axis_name)
    n_dev = dist.get_world_size(group)

    def one(leaf):
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        flat = local.reshape(-1)
        pad = (-flat.shape[0]) % n_dev
        if pad:
            flat = F.pad(flat, (0, pad))
        red = int8_allreduce_mean(flat, gen, group)
        out = red[: local.numel()].reshape(local.shape).to(local.dtype)
        if isinstance(leaf, DTensor):
            return DTensor.from_local(out, leaf.device_mesh, leaf.placements,
                                      shape=leaf.shape, stride=leaf.stride())
        return out

    return tree_map(one, grads)
