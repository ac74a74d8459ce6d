"""Hand-scheduled sharded decode attention.

The counterpart of ``repro.distributed.decode_attn``: one decode step
over a KV cache whose sequence dimension is sharded over "model",

* the new token's K, V are written **locally** by the rank that owns
  the slot (a one-slot write with a where-select: no traffic between
  ranks);
* each rank runs an online-softmax pass over its own chunk;
* ranks combine with three small all-reduces over the sharding axis's
  group: MAX of the running max, then SUM of the rescaled normaliser
  and accumulator, O(B·H·dh) bytes a layer instead of O(cache).

The cache stays as it was placed (``partitioning.cache_axes_for`` under
``tp_serve_sm``): where kv_heads divides "model" the cache is split by
heads instead, each rank holds every slot of its heads, the query is
split the same way and there is nothing to combine.  Where the reference
re-shards such a cache by sequence in its ``shard_map``, the port keeps
it; the arithmetic is the same.  Exact up to float associativity.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.partitioning import local_range


def _local_step(q, ck, cv, cpos, k_new, v_new, positions, off, group,
                *, causal, window, softcap):
    """On one rank: the owner's write, the local online softmax over the
    chunk at ``off``, the combine over ``group`` (None: no combine)."""
    B, Hq, Tq, D = q.shape
    Hkv = ck.shape[1]
    g = Hq // Hkv
    local_len = ck.shape[2]
    slot = positions[0] % cpos.shape[0]
    mine = (slot >= off) & (slot < off + local_len)
    local_slot = (slot - off).clamp(0, local_len - 1).reshape(1)

    # -- local in-place write: the owner takes the new KV, the others
    #    rewrite the slot's existing value
    for c, new in ((ck, k_new), (cv, v_new)):
        old = c.index_select(2, local_slot)
        c.index_copy_(2, local_slot, torch.where(mine, new.to(c.dtype), old))
    cpos.index_copy_(0, slot.reshape(1), positions)       # replicated: every rank
    kpos = cpos[off:off + local_len]

    # -- local online softmax over this rank's chunk (the cache dtype's
    #    operands, exactly upcast, with float32 sums)
    qf = (q.to(ck.dtype) * (D ** -0.5)).reshape(B, Hkv, g, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf.float(), ck.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = kpos[None, :] >= 0
    if causal:
        mask = mask & (kpos[None, :] <= positions[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > positions[:, None] - window)
    s = s.masked_fill(~mask, -1e30)
    m_loc = s.amax(-1)                                      # (B,Hkv,g,Tq)
    p = torch.exp(s - m_loc[..., None]).masked_fill(~mask, 0.0)
    l_loc = p.sum(-1)
    acc_loc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(cv.dtype).float(), cv.float())

    # -- the small combine between ranks
    if group is None:
        l_g, acc_g = l_loc, acc_loc
    else:
        m_g = m_loc.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
        scale = torch.exp(m_loc - m_g)
        l_g = (l_loc * scale).contiguous()
        acc_g = (acc_loc * scale[..., None]).contiguous()
        dist.all_reduce(l_g, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(acc_g, op=dist.ReduceOp.SUM, group=group)
    l_g = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return (acc_g / l_g[..., None]).reshape(B, Hq, Tq, D).to(q.dtype)


def sharded_decode_attention(
    mesh,
    q: torch.Tensor,            # (B, Hq, 1, D) DTensor
    cache: Dict,                # {"k","v"} (B, Hkv, L, D), "pos" (L,) replicated; DTensors
    k_new: torch.Tensor,        # (B, Hkv, 1, D) DTensor
    v_new: torch.Tensor,
    positions: torch.Tensor,    # (1,) absolute position
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step's attention output (a DTensor split over batch and
    heads as the cache is, replicated elsewhere); the cache is updated in
    place and returned."""
    from torch.distributed.tensor import DTensor, Replicate

    cp = cache["k"].placements
    seq_dims = [i for i, p in enumerate(cp) if p.is_shard(2)]
    if len(seq_dims) > 1 or any(p.is_shard(3) for p in cp):
        raise NotImplementedError(f"sharded decode over a cache placed {cp}")
    if not all(p.is_replicate() for p in cache["pos"].placements):
        raise NotImplementedError("sharded decode needs the cache positions replicated")
    # the query and the new K, V split over batch and heads as the cache
    qp = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in cp)
    ql, kl, vl = (t.redistribute(mesh, qp).to_local() for t in (q, k_new, v_new))
    if seq_dims:
        off, _ = local_range(mesh, cp, 2, cache["k"].shape[2])
        group = mesh.get_group(seq_dims[0])
    else:
        off, group = 0, None
    out = _local_step(ql, cache["k"].to_local(), cache["v"].to_local(),
                      cache["pos"].to_local(), kl, vl, positions.to(ql.device), off, group,
                      causal=causal, window=window, softcap=softcap)
    return DTensor.from_local(out, mesh, qp, run_check=False), cache
