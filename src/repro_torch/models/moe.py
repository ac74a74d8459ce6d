"""Mixture-of-Experts FFN (olmoe-1b-7b, granite-moe-1b-a400m).

The reference's GShard/Switch capacity routing, value for value: a
float32 router and softmax, top-k with the gates renormalised, each
(token, choice) given a slot in its expert's buffer in k-major order
(every token's first choice before anyone's second), overflow beyond the
capacity dropped, SwiGLU experts as batched products over (B, E, C, D),
and the Switch load-balancing loss.

Where the reference forms the dispatch tensor as a dense one-hot einsum
over a (B, K*T, E, C) intermediate, the port scatters a one into
(B, T, E, C) for each kept (token, choice): a token's K experts are
distinct, so no two choices share an entry and the tensors are equal.
The scatter needs no (B, K*T, E, C) buffer, which at training lengths is
gigabytes a layer, and no host sync (the kept set is not gathered).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.axes import constrain
from repro_torch.distributed.partitioning import is_distributed
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import leaf, normal


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": leaf(normal(gen, (d, e), torch.float32), "embed", "experts"),
        "wi": leaf(normal(gen, (e, d, f), dtype), "experts", "embed", "mlp"),
        "wg": leaf(normal(gen, (e, d, f), dtype), "experts", "embed", "mlp"),
        "wo": leaf(normal(gen, (e, f, d), dtype), "experts", "mlp", "embed"),
    }


def route(p: Dict, cfg: ModelConfig, x: torch.Tensor):
    """Top-k capacity routing of x: (B, T, D), already regrouped.

    Returns (probs (B,T,E), expert_idx (B,T,K), gates (B,T,K),
    slot (B,T,K) float position in the expert's buffer, kept (B,T,K)
    bool, capacity).
    """
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    capacity = max(1, int(cfg.capacity_factor * K * T / E))
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    # descending, as lax.top_k; ties between equal probabilities are the
    # only place the two could part, and the tests hold the indices equal
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1, sorted=True)
    gates = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # priority: choice k=0 of every token first, then k=1, ... (GShard).
    # The count runs along the last axis, (B, E, K*T): a cumsum along an
    # outer axis is a scan with one thread per (b, e) on the card, a
    # fifth of a MoE train step's device time at 2 x 2048 tokens.
    flat = F.one_hot(expert_idx, E).float().permute(0, 3, 2, 1).reshape(B, E, K * T)
    slot = ((torch.cumsum(flat, dim=-1) - flat) * flat).sum(1)  # (B,K*T)
    slot = slot.reshape(B, K, T).transpose(1, 2)               # (B,T,K)
    return probs, expert_idx, gates, slot, slot < capacity, capacity


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss)."""
    B0, T0, D = x.shape
    if is_distributed(x) and x.requires_grad and x.device_mesh.size() > 1:
        raise NotImplementedError(
            "the MoE FFN's backward over more than one rank: DTensor's backward of the "
            "dispatch einsums views a non-contiguous local tensor")
    if cfg.moe_group is not None and T0 > cfg.moe_group and T0 % cfg.moe_group == 0:
        # re-group tokens: dispatch cost drops from O(T^2) to O(T*group)
        x = x.reshape(B0 * (T0 // cfg.moe_group), cfg.moe_group, D)
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, expert_idx, gates, slot, kept, capacity = route(p, cfg, x)

    # dispatch[b, t, e, c] = 1 where choice k of token t went to expert e
    # at slot c and fit.  A token's K experts are distinct, so its K
    # entries land in distinct places, a dropped one's (clamped) as a 0.
    where = expert_idx * capacity + slot.clamp(max=capacity - 1).long()
    dispatch = torch.zeros((B, T, E * capacity), dtype=torch.float32, device=x.device)
    dispatch = dispatch.scatter(2, where, kept.float()).view(B, T, E, capacity)
    # the gate of expert e for token t (zero where unchosen)
    weight = torch.zeros((B, T, E), dtype=torch.float32, device=x.device)
    weight = weight.scatter_add(2, expert_idx, gates)
    combine = dispatch * weight[..., None]                     # (B,T,E,C)

    xin = torch.einsum("btec,btd->becd", dispatch.to(x.dtype), x)   # (B,E,C,D)
    xin = constrain(xin, "batch", "experts_act", None, None)
    h = torch.einsum("becd,edf->becf", xin, p["wi"])
    g = F.silu(torch.einsum("becd,edf->becf", xin, p["wg"]))
    eout = torch.einsum("becf,efd->becd", h * g, p["wo"])            # (B,E,C,D)
    eout = constrain(eout, "batch", "experts_act", None, None)
    out = torch.einsum("btec,becd->btd", combine.to(x.dtype), eout)

    # auxiliary load-balance loss (Switch eq. 4)
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(2).mean(dim=(0, 1))   # fraction routed
    aux = E * torch.sum(me * ce / K)
    if out.shape[0] != B0:
        out = out.reshape(B0, T0, D)
    return out, aux.float()
