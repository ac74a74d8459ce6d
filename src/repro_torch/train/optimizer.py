"""AdamW with fp32 master weights over trees of tensors.

Model parameters are stored in the compute dtype (bf16 at scale); the
optimizer keeps fp32 first and second moments plus an fp32 master copy,
and each step writes ``master.to(param.dtype)`` back into the
parameter.  Global-norm clipping and the warmup-cosine schedule follow
``repro.train.optimizer``, operation for operation, in float32.

Unlike the reference's pure functions, :func:`adamw_update` updates the
moments, the master copy, the count and the parameters in place and
returns the same objects: at full width this saves a second copy of the
16.5 GB state on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

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
    parameters' device."""
    device = next(iter(tree_leaves(params))).device
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([torch.sum(torch.square(x.float()))
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
    count = opt_state["count"]
    count.add_(1)
    gnorm = global_norm(flat_g)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())
    for g, p, mu, nu, master in zip(flat_g, flat_p, flat_mu, flat_nu, flat_ma):
        g = g.float()
        if scale is not None:
            g = g * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) + cfg.weight_decay * master
        master.sub_(lr * step)
        p.copy_(master)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
