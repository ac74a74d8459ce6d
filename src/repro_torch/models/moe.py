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
from repro_torch.distributed.partitioning import (is_distributed, local_range, placements_for,
                                                  spec_for)
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
    # the router's logits whole over "model" (its expert columns may be
    # split there): a softmax over split experts makes DTensor split the
    # tokens instead, a layout the router's own gradient cannot flatten
    probs = torch.softmax(constrain(x.float() @ p["router"], "batch", None, None), dim=-1)
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


def _dispatch_slice(expert_idx, gates, slot, kept, C: int, e0: int, n: int):
    """dispatch (B,T,n,C) and weight (B,T,n) for experts [e0, e0 + n).

    dispatch[b, t, e, c] = 1 where choice k of token t went to expert e at
    slot c and fit; weight[b, t, e] is that choice's gate (zero where
    unchosen).  Choices outside the slice, and dropped ones (their slot
    clamped), add a 0, so they may share an entry with a kept choice."""
    B, T, _ = expert_idx.shape
    inside = (expert_idx >= e0) & (expert_idx < e0 + n)
    local = (expert_idx - e0).clamp(0, n - 1)
    where = local * C + slot.clamp(max=C - 1).long()
    dispatch = torch.zeros((B, T, n * C), dtype=torch.float32, device=gates.device)
    dispatch = dispatch.scatter_add(2, where, (kept & inside).float()).view(B, T, n, C)
    weight = torch.zeros((B, T, n), dtype=torch.float32, device=gates.device)
    return dispatch, weight.scatter_add(2, local, gates * inside)


def _dispatch(expert_idx, gates, slot, kept, E: int, C: int):
    """``_dispatch_slice`` of every expert; under a mesh each rank builds
    its own rows and experts alone (the experts split as the expert inputs
    are, ``experts_act``), and the results are DTensors placed so: made
    whole first, the dispatch would be a whole batch's (B, T, E*C) on every
    rank, tens of GiB a layer at training lengths."""
    if not is_distributed(gates):
        return _dispatch_slice(expert_idx, gates, slot, kept, C, 0, E)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distributed import axes as AX

    mesh = gates.device_mesh
    B, T, _ = gates.shape
    placed = placements_for(mesh, spec_for(mesh, AX.current_rules() or {},
                                           ("batch", None, "experts_act", None), (B, T, E, C)))
    rows = tuple(p if p.is_shard(0) else Replicate() for p in placed)
    e0, n = local_range(mesh, placed, 2, E)
    # the gates' gradient from this rank's experts: a partial sum over the
    # mesh axes that split the experts
    grad = tuple(Partial() if p.is_shard(2) else r for p, r in zip(placed, rows))
    args = [t.redistribute(mesh, rows).to_local() for t in (expert_idx, slot, kept)]
    g = gates.redistribute(mesh, rows).to_local(grad_placements=grad)
    dispatch, weight = _dispatch_slice(args[0], g, args[1], args[2], C, e0, n)
    return (DTensor.from_local(dispatch, mesh, placed, run_check=False),
            DTensor.from_local(weight, mesh, placed, run_check=False))


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss)."""
    B0, T0, D = x.shape
    if cfg.moe_group is not None and T0 > cfg.moe_group and T0 % cfg.moe_group == 0:
        # re-group tokens: dispatch cost drops from O(T^2) to O(T*group)
        x = x.reshape(B0 * (T0 // cfg.moe_group), cfg.moe_group, D)
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, expert_idx, gates, slot, kept, capacity = route(p, cfg, x)

    dispatch, weight = _dispatch(expert_idx, gates, slot, kept, E, capacity)
    combine = dispatch * weight[..., None]                     # (B,T,E,C)

    # the reference's "btec,btd->becd" and "btec,becd->btd" as batched
    # products over (E*C) flattened expert-major, the expert dimension
    # outermost: under a mesh that splits the experts, DTensor can then
    # flatten and unflatten (E, C) as a split of its outer dimension, where
    # einsum's own layout flattens it behind C and cannot
    C = capacity
    xin = torch.bmm(dispatch.to(x.dtype).reshape(B, T, E * C).transpose(1, 2), x)
    xin = constrain(xin.reshape(B, E, C, D), "batch", "experts_act", None, None)
    # the experts' products batched over E on (E, B*C, D) rows, laid out
    # contiguously first (DTensor's views of a permuted local tensor fail)
    xe = xin.transpose(0, 1).contiguous().reshape(E, B * C, D)
    h = torch.bmm(xe, p["wi"])
    g = F.silu(torch.bmm(xe, p["wg"]))
    eout = torch.bmm(h * g, p["wo"]).reshape(E, B, C, D).transpose(0, 1).contiguous()
    eout = constrain(eout, "batch", "experts_act", None, None)        # (B,E,C,D)
    out = torch.bmm(combine.to(x.dtype).reshape(B, T, E * C), eout.reshape(B, E * C, D))

    # auxiliary load-balance loss (Switch eq. 4)
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(expert_idx, E).float().sum(2).mean(dim=(0, 1))   # fraction routed
    aux = E * torch.sum(me * ce / K)
    if out.shape[0] != B0:
        out = out.reshape(B0, T0, D)
    return out, aux.float()
