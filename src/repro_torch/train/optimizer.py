"""AdamW with fp32 master weights over trees of tensors.

Model parameters are stored in the compute dtype (bf16 at scale); the
optimizer keeps fp32 first and second moments plus an fp32 master copy,
and each step writes ``master.to(param.dtype)`` back into the
parameter.  Global-norm clipping and the warmup-cosine schedule follow
``repro.train.optimizer``, operation for operation, in float32.

Unlike the reference's pure functions, :func:`adamw_update` updates the
moments, the master copy, the count and the parameters in place and
returns the same objects: at full width this saves a second copy of the
16.5 GB state on the card.  Under a mesh the parameters and moments are
DTensors with the same placements: each gradient is first redistributed
to its parameter's placements (a reduce-scatter where it is a partial
sum), the global norm is summed over the whole tensors, and the update
runs on each rank's local shards.  A leaf larger than
``_UPDATE_ELEMENTS`` (a stacked layer's weight) is updated in slices of
its leading dimension, so that the update's float32 temporaries stay
small: each element's arithmetic, and so the result, is the same (at
full width h2o-danube3-4b's (24, 3840, 10240) leaves took 3.5 GiB a
temporary, and its 1 x 8192 training step ran out of the card's 80 GB).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed.partitioning import full, is_distributed
from repro_torch.models.param_util import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), as a float32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments, an fp32 master copy and an int32 count, on the
    parameters' device (placed as the parameters are, under a mesh; the
    count is a plain tensor, the same on every rank)."""
    device = next(iter(tree_leaves(params))).device
    return {
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


# elements of a leaf that one pass of the update covers
_UPDATE_ELEMENTS = 1 << 26


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_distributed(t) else t


def _row_slices(t: torch.Tensor):
    """Indices that cut ``t`` along its leading dimension into pieces of
    at most ``_UPDATE_ELEMENTS`` elements (or of one row), or ``()``, the
    whole tensor, when it is that small."""
    if t.ndim == 0 or t.numel() <= _UPDATE_ELEMENTS:
        return [()]
    rows = max(1, _UPDATE_ELEMENTS // (t.numel() // t.shape[0]))
    return [(slice(i, i + rows),) for i in range(0, t.shape[0], rows)]


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([full(torch.sum(torch.square(x.float())))
                                             for x in leaves])))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, grads, opt_state, params
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  ``grads`` has the parameters' tree
    structure (or is the list of their leaves in ``tree_leaves`` order).
    Returns (params, opt_state, stats)."""
    flat_g = list(tree_leaves(grads))
    flat_p = list(tree_leaves(params))
    flat_mu = list(tree_leaves(opt_state["mu"]))
    flat_nu = list(tree_leaves(opt_state["nu"]))
    flat_ma = list(tree_leaves(opt_state["master"]))
    if not len(flat_g) == len(flat_p) == len(flat_mu) == len(flat_nu) == len(flat_ma):
        raise ValueError("grads, params and optimizer state differ in structure")
    flat_g = [g.redistribute(p.device_mesh, p.placements) if is_distributed(p) else g
              for g, p in zip(flat_g, flat_p)]
    count = opt_state["count"]
    count.add_(1)
    gnorm = global_norm(flat_g)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())
    for leaves in zip(flat_g, flat_p, flat_mu, flat_nu, flat_ma):
        g_all, p_all, mu_all, nu_all, ma_all = (_local(t) for t in leaves)
        for rows in _row_slices(g_all):
            g, mu, nu, master = g_all[rows].float(), mu_all[rows], nu_all[rows], ma_all[rows]
            if scale is not None:
                g = g * scale
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) + cfg.weight_decay * master
            master.sub_(lr * step)
            p_all[rows].copy_(master)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
