"""Shared transformer layers: norms, RoPE, MLP, GQA attention.

Plain functions over parameter dicts of tensors, the counterparts of
``repro.models.layers``.  Covers qk-norm, QKV bias, the three norm kinds,
sliding-window and local attention (recurrentgemma), GQA and the
encoder-decoder's cross-attention over precomputed encoder K/V.  Attention
takes the reference's three paths: dense scores up to
``BLOCKWISE_KV_THRESHOLD`` kv positions (``kernels.ref.ref_attention``,
as ``layers.py:257`` of the reference), online-softmax attention above it
(``kernels.ops.flash_attention``: the CUDA kernel on the card, the
chunked plain version on the CPU; the reference's
``_blockwise_attention``), and dense scores over the cache for decode.

Under a mesh (``distributed``: parameters, batch and caches are
DTensors) the ``constrain`` calls sit where the reference's do (naming
the sequence, which only ``tp_fsdp_sp`` splits), and the products over
heads and attention run on each rank's local slices (``project_heads``,
``project_out``, ``_local_attention``: the CUDA kernels read plain
tensors, and DTensor's view rules refuse heads split unevenly or on the
head dimension); the cache writes are local; a decode step under
``tp_serve_sm`` goes to ``decode_attn.sharded_decode_attention``, one
under ``tp_serve_hd`` over a cache split on its head dimension to
``_head_dim_attention``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import axes as AX
from repro_torch.distributed import partitioning as PT
from repro_torch.distributed.axes import constrain
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import leaf, normal, ones, zeros

# Above this many kv positions attention is blockwise (online softmax),
# as in the reference; the plain version walks the keys in slices of
# BLOCKWISE_CHUNK (``ref_flash_attention``'s default, the reference's
# chunk), so its memory is O(Tq * chunk) per head.
BLOCKWISE_KV_THRESHOLD = 4096
BLOCKWISE_CHUNK = 1024


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device) -> Dict:
    if cfg.norm_kind == "rmsnorm":
        return {"scale": leaf(ones((cfg.d_model,), torch.float32, device), "embed")}
    if cfg.norm_kind == "layernorm":
        return {
            "scale": leaf(ones((cfg.d_model,), torch.float32, device), "embed"),
            "bias": leaf(zeros((cfg.d_model,), torch.float32, device), "embed"),
        }
    if cfg.norm_kind == "nonparam_ln":  # OLMo: no learnable affine
        return {}
    raise ValueError(cfg.norm_kind)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A table on a mesh of more than one rank goes
    through ``F.embedding``, which DTensor shards as the table and the
    tokens are, forward and backward: the advanced index's backward is an
    ``index_put`` into a replicated zero table (a whole vocab x embed
    gradient on every rank), and in some torch versions DTensor's sharding
    propagation fails for the index on tokens split over two mesh axes and
    for that ``index_put``.  Elsewhere the index stays, whose gradient sums
    the rows in another order (the (1, 1) mesh stays bit-equal to one
    device)."""
    if PT.is_distributed(table) and table.device_mesh.size() > 1:
        return F.embedding(tokens, table)
    return table[tokens]


def _placed(t: torch.Tensor):
    """A DTensor's placements, Partial ones as Replicate (a reduction)."""
    from torch.distributed.tensor import Replicate

    return [p if p.is_shard() else Replicate() for p in t.placements]


def split_only_over(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor gathered over every mesh axis that does not split its
    dimension ``dim`` (a vocabulary weight kept split over vocab, gathered
    over the fsdp axes of its embed dimension); anything else as it is."""
    if not PT.is_distributed(t):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh,
                          [p if p.is_shard(dim) else Replicate() for p in t.placements])


def gathered_table(params: Dict) -> Dict:
    """``params`` with the embedding table gathered over the mesh axes that
    split its embed dimension (fsdp), kept split over vocab: one tensor
    for the lookup and, when tied, the logits, so that both gradients meet
    in one placement and reach the parameter through one reduce-scatter
    (DTensor of some torch versions cannot add a gradient split over
    "data" to a partial one).  Plain tensors are returned as they are."""
    t = params["embed"]["table"]
    if not PT.is_distributed(t):
        return params
    return dict(params, embed=dict(params["embed"], table=split_only_over(t, 0)))


def vocab_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a (d_model, vocab) head, its weight gathered over the
    fsdp axes first (``split_only_over``), as GSPMD gathers an fsdp weight
    for its product.  Left to itself, DTensor contracts a microbatch of a
    few rows a rank the other way (the rows gathered, the embed dimension
    split): every rank then holds a partial sum of the whole microbatch's
    logits, and does that product over every vocab column."""
    return x @ split_only_over(w, 1)


def apply_norm(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The norm of the residual stream, whole over "model" (``constrain``).

    Under a mesh the constraint matters in backward: the gradient that
    reaches the norm's output from the next products is a partial sum over
    "model", and DTensor passes a partial gradient through the norm and
    the residual adds unreduced, so the products further back would run on
    it with gathered weights (a whole layer's work on every rank).  The
    constraint's backward reduces it here, as Megatron's all-reduce at the
    input of a tensor-parallel region does."""
    dt = x.dtype
    xf = x.float()
    if cfg.norm_kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        out = (xf * p["scale"]).to(dt)
    else:
        mean = torch.mean(xf, -1, keepdim=True)
        var = torch.mean((xf - mean) ** 2, -1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + 1e-5)
        if cfg.norm_kind == "layernorm":
            xf = xf * p["scale"] + p["bias"]
        out = xf.to(dt)
    # the reference's constraints name the sequence None; "seq" maps to a
    # mesh axis only under ``tp_fsdp_sp`` (its "data"), and only where the
    # batch leaves that axis free (``spec_for``'s used-axis guard: a batch
    # of 1), so elsewhere the placements are the reference's
    lead = ("batch", "seq") if out.ndim == 3 else ("batch",) + (None,) * (out.ndim - 2)
    return constrain(out, *lead, "embed_act")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, T, D); positions: (T,) absolute token positions."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = positions.float()[:, None] * freqs[None, :]  # (T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": leaf(normal(gen, (d, f), dtype), "embed", "mlp"),
         "wo": leaf(normal(gen, (f, d), dtype), "mlp", "embed")}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["wg"] = leaf(normal(gen, (d, f), dtype), "embed", "mlp")
    return p


def apply_mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; so does the port.
    h = x @ p["wi"]
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, "batch", "seq", "mlp_act")
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, cross: bool = False) -> Dict:
    """A cross-attention block (``cross``) has no QKV bias and no qk-norm."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": leaf(normal(gen, (d, h, dh), dtype), "embed", "q_heads", "head"),
        "wk": leaf(normal(gen, (d, hkv, dh), dtype), "embed", "kv_heads", "head"),
        "wv": leaf(normal(gen, (d, hkv, dh), dtype), "embed", "kv_heads", "head"),
        "wo": leaf(normal(gen, (h, dh, d), dtype), "q_heads", "head", "embed"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = leaf(zeros((h, dh), dtype, dev), "q_heads", "head")
        p["bk"] = leaf(zeros((hkv, dh), dtype, dev), "kv_heads", "head")
        p["bv"] = leaf(zeros((hkv, dh), dtype, dev), "kv_heads", "head")
    if cfg.qk_norm and not cross:
        p["q_scale"] = leaf(ones((dh,), torch.float32, dev), "head")
        p["k_scale"] = leaf(ones((dh,), torch.float32, dev), "head")
    return p


def _head_rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (xf * scale).to(x.dtype)


def _heads_whole(w: torch.Tensor) -> torch.Tensor:
    """A (d, heads, head_dim) projection whose heads no mesh axis splits
    (kv_heads=8 on a 16-way "model" axis), gathered whole first: DTensor
    would otherwise split the product's flattened heads x head_dim over
    "model" and could not unflatten 8 heads over 16 ranks.  Under fsdp
    this is the weight's all-gather the product needs anyway."""
    if PT.is_distributed(w) and not any(pl.is_shard(1) for pl in w.placements):
        from torch.distributed.tensor import Replicate

        return w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)
    return w


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H * Dh).  Heads that no mesh axis splits
    (40 on a 16-way "model" axis) keep the merged dimension whole
    (``constrain``, a no-op forward): the next product may split its
    gradient there, which DTensor cannot unflatten into the heads."""
    B, H, T, Dh = x.shape
    out = x.transpose(1, 2).reshape(B, T, H * Dh)
    if PT.is_distributed(x) and not any(p.is_shard(1) for p in x.placements):
        out = constrain(out, "batch", None, None)
    return out


def _split_unmergeably(w: torch.Tensor, heads: int) -> bool:
    """Whether a DTensor weight's heads (dimension ``heads``) are split
    unevenly or the head dimension after them is split: layouts DTensor's
    view rules cannot merge into (heads x head_dim)."""
    mesh = w.device_mesh
    ways = math.prod(mesh.size(i) for i, p in enumerate(w.placements) if p.is_shard(heads))
    return w.shape[heads] % ways != 0 or any(p.is_shard(heads + 1) for p in w.placements)


def project_heads(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """``einsum("btd,dhk->bhtk", x, w) (+ b)``: a (d, heads, head_dim)
    projection.

    Where a mesh axis splits the heads unevenly (40 over 16 ranks under
    ``_uneven``, ``torch.chunk``'s layout) or the head dimension
    (``tp_serve_hd``), which DTensor's view rules cannot flatten into the
    product's (heads x head_dim) columns, each rank multiplies its local
    rows of ``x`` by its local heads or head-dim slice of ``w`` (gathered
    over the axes that split its embed dimension, as fsdp gathers a weight
    for its product) and the result is a DTensor split as both; ``x``'s
    gradient is a partial sum over the axes that split ``w``, ``w``'s over
    those that split ``x``'s rows.  Elsewhere DTensor places the product."""
    if not PT.is_distributed(w) or not _split_unmergeably(w, 1):
        y = torch.einsum("btd,dhk->bhtk", x, _heads_whole(w))
        return y if b is None else y + b[None, :, None, :]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = w.device_mesh
    wp = [p if p.is_shard(1) or p.is_shard(2) else Replicate() for p in w.placements]
    xp = [Replicate() if q.is_shard() else p for p, q in zip(_placed(x), wp)]
    xl = x.redistribute(mesh, xp).to_local(
        grad_placements=[Partial() if q.is_shard() else p for p, q in zip(xp, wp)])
    wgrad = lambda pl: [Partial() if p.is_shard() else q for p, q in zip(xp, pl)]
    y = torch.einsum("btd,dhk->bhtk", xl, w.redistribute(mesh, wp).to_local(
        grad_placements=wgrad(wp)))
    if b is not None:
        bp = [Shard(q.dim - 1) if q.is_shard() else Replicate() for q in wp]
        y = y + b.redistribute(mesh, bp).to_local(grad_placements=wgrad(bp))[None, :, None, :]
    yp = [Shard(2 * q.dim - 1) if q.is_shard() else Shard(2 * p.dim) if p.is_shard()
          else Replicate() for p, q in zip(xp, wp)]       # heads 1, head dim 3; batch 0, seq 2
    B, T, _ = x.shape
    return PT.from_local(y, mesh, yp, (B, w.shape[1], T, w.shape[2]))


def project_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The attention output projection ``einsum("bhtk,hkd->btd")``, one
    product over the merged heads.

    Where a mesh axis splits the heads unevenly (``_uneven``) or the head
    dimension (``tp_serve_hd``), which DTensor cannot merge, each rank
    multiplies its local heads (or head-dim slice) of ``out`` by the same
    slice of ``wo`` (gathered over its fsdp axes): ``out`` is first placed
    as ``wo`` splits its heads or head dimension (a no-op where the
    attention left it so), and the result is a partial sum over those
    axes, split over batch and sequence as ``out`` is.  Elsewhere DTensor
    places the product (heads no axis splits: it splits the output's
    embed columns over "model")."""
    H, Dh, D = wo.shape
    if not PT.is_distributed(out) or not (_split_unmergeably(wo, 0) or
                                          any(p.is_shard(3) for p in out.placements)):
        return merge_heads(out) @ wo.reshape(H * Dh, D)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = out.device_mesh
    wp = [p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in wo.placements]
    op = [Shard(2 * q.dim + 1) if q.is_shard() else p if p.is_shard(0) or p.is_shard(2)
          else Replicate() for p, q in zip(_placed(out), wp)]
    ol = out.redistribute(mesh, op).to_local()
    wl = wo.redistribute(mesh, wp).to_local(
        grad_placements=[Partial() if p.is_shard() and not q.is_shard() else q
                         for p, q in zip(op, wp)])
    b, h, t, dh = ol.shape
    y = ol.transpose(1, 2).reshape(b, t, h * dh) @ wl.reshape(h * dh, D)
    yp = [Partial() if q.is_shard() else Shard(p.dim // 2) if p.is_shard() else Replicate()
          for p, q in zip(op, wp)]
    B, _, T, _ = out.shape
    return PT.from_local(y, mesh, yp, (B, T, D))


def _project_qkv(p, cfg, x, positions, apply_rope: bool = True):
    q = project_heads(x, p["wq"], p.get("bq"))
    k = project_heads(x, p["wk"], p.get("bk"))
    v = project_heads(x, p["wv"], p.get("bv"))
    if "q_scale" in p:
        q = _head_rmsnorm(q, p["q_scale"])
        k = _head_rmsnorm(k, p["k_scale"])
    if apply_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_core(q, k, v, *, causal, window, q_offset, softcap,
                   kv_positions: Optional[torch.Tensor] = None,
                   q_positions: Optional[torch.Tensor] = None):
    """Dense, blockwise (above ``BLOCKWISE_KV_THRESHOLD`` kv positions) or
    cache (decode) attention.

    ``kv_positions``: absolute positions of cache slots for decode
    (entries < 0 are empty slots).  When given, masking uses positions
    (``q_positions``) rather than indices.  DTensor inputs run on each
    rank's local slices (``_local_attention``).
    """
    if PT.is_distributed(q):
        return _local_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                softcap=softcap, kv_positions=kv_positions,
                                q_positions=q_positions)
    Tk = k.shape[2]
    if kv_positions is not None:
        return _cache_attention(q, k, v, kv_positions, q_positions, causal=causal,
                                window=window, softcap=softcap, scale=q.shape[-1] ** -0.5)
    if Tk > BLOCKWISE_KV_THRESHOLD:
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, softcap=softcap)
    return ref_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                         softcap=softcap)


def _cache_attention(q, k, v, kv_positions, q_positions, *, causal, window, softcap, scale,
                     reduce_scores=None):
    """Decode: scores against the cache.  The reference multiplies the
    cache-dtype operands with float32 accumulation; upcasting the operands
    exactly and multiplying in float32 is the same sum.  ``reduce_scores``
    completes scores that are partial sums over a split head dimension."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    qf = (q.to(k.dtype) * scale).reshape(B, Hkv, group, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf.float(), k.float())
    if reduce_scores is not None:
        s = reduce_scores(s)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    mask = kv_positions[None, :] >= 0
    if causal:
        mask = mask & (kv_positions[None, :] <= q_positions[:, None])
    if window is not None:
        mask = mask & (kv_positions[None, :] > q_positions[:, None] - window)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(k.dtype).float(), v.float())
    return out.reshape(B, Hq, Tq, D).to(q.dtype)


def _local_attention(q, k, v, *, kv_positions, q_offset, **kw):
    """``attention_core`` on each rank's local q, k, v, the output rebuilt
    as a DTensor split as q is.

    q keeps its batch, head and sequence splits (anything else is
    gathered); k and v follow its batch split, and its head split where
    they split alike (kv_heads divides that axis, or there are as many kv
    heads as q heads, split unevenly alike).  Otherwise (``spec_for``'s
    guard replicated k and v) each rank takes the kv heads its local q
    heads read, ``h // group`` for q head h; and over a split sequence k
    and v are whole, the local q rows offset by their first position.
    Those gradients of k and v are partial sums over the ranks.  A k split
    on its head dimension (``tp_serve_hd``: a decode step's cache, or the
    encoder-decoder's memories in every cross-attention) goes to
    ``_head_dim_attention``, which never gathers it."""
    from torch.distributed.tensor import Partial, Replicate

    if any(p.is_shard(3) for p in k.placements):
        return _head_dim_attention(q, k, v, kv_positions=kv_positions, q_offset=q_offset, **kw)
    mesh = q.device_mesh
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    qp = tuple(p if p.is_shard(0) or p.is_shard(1) or p.is_shard(2) else Replicate()
               for p in q.placements)
    alike = Hkv == Hq or all(Hkv % mesh.size(i) == 0 for i, p in enumerate(qp) if p.is_shard(1))
    kvp = tuple(p if p.is_shard(0) or (alike and p.is_shard(1)) else Replicate() for p in qp)
    grad_p = tuple(Partial() if p.is_shard(2) or (p.is_shard(1) and not alike) else kp
                   for p, kp in zip(qp, kvp))
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl = (t.redistribute(mesh, kvp).to_local(grad_placements=grad_p) for t in (k, v))
    t0, _ = PT.local_range(mesh, qp, 2, Tq)
    h0, hl = PT.local_range(mesh, qp, 1, Hq)
    if hl == 0:
        # no head here: an empty output, k and v kept in the graph (their
        # sums times 0) so that every rank joins their gradients' collectives
        out = ql + 0 * (kl.sum() + vl.sum()).to(ql.dtype)
        return PT.from_local(out, mesh, qp, q.shape)
    if not alike:
        group = Hq // Hkv
        lo, hi = h0 // group, (h0 + hl - 1) // group + 1
        if not (h0 % group == 0 and hl % group == 0) and hi - lo > 1:
            # the local heads straddle groups: one kv head for each
            idx = torch.arange(h0, h0 + hl, device=kl.device) // group
            kl, vl = kl[:, idx], vl[:, idx]
        else:
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
    if PT.is_distributed(kv_positions):
        kv_positions = kv_positions.full_tensor()
    out = attention_core(ql, kl, vl, kv_positions=kv_positions, q_offset=q_offset + t0, **kw)
    return PT.from_local(out, mesh, qp, q.shape)


def _head_dim_attention(q, k, v, *, kv_positions, q_positions, q_offset, causal, window,
                        softcap):
    """Attention over k and v split on their head dimension
    (``tp_serve_hd``, where kv_heads does not divide "model"): a decode
    step's cache, or the encoder-decoder's memories.  q is split as k (its
    heads whole), each rank's dot products over its slice of the head
    dimension are partial scores, all-reduced (a sum) over the axes that
    split it before the softcap, mask and softmax, and the output
    ``p @ v`` stays split on the head dimension, as k and v, for
    ``project_out``.  k and v are never gathered.  Without
    ``kv_positions`` (the memories) the mask takes key j at position j and
    query i at ``q_offset + i``; the scores are dense, so a memory over
    ``BLOCKWISE_KV_THRESHOLD`` frames takes (B, H, Tq, S) float32 scores
    a rank, a decode step's (B, H, 1, S)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = k.device_mesh
    if kv_positions is None:
        kv_positions = torch.arange(k.shape[2], device=k.to_local().device)
        q_positions = q_offset + torch.arange(q.shape[2], device=kv_positions.device)
    cp = tuple(p if p.is_shard(0) or p.is_shard(3) else Replicate() for p in k.placements)
    ql, kl, vl = (t.redistribute(mesh, cp).to_local() for t in (q, k, v))
    partial = tuple(Partial() if p.is_shard(3) else p for p in cp)
    whole = tuple(Replicate() if p.is_shard(3) else p for p in cp)

    def reduce_scores(s):
        shape = (q.shape[0],) + tuple(s.shape[1:])
        return PT.from_local(s, mesh, partial, shape).redistribute(mesh, whole).to_local()

    if PT.is_distributed(kv_positions):
        kv_positions = kv_positions.full_tensor()
    out = _cache_attention(ql, kl, vl, kv_positions, q_positions, causal=causal, window=window,
                           softcap=softcap, scale=q.shape[-1] ** -0.5,
                           reduce_scores=reduce_scores)
    return PT.from_local(out, mesh, cp, q.shape)


def _write_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor) -> None:
    """Slot invariant: position pos lives at slot pos % cache_len.  Only
    the last cache_len positions can survive, so a prefill longer than a
    window-limited cache writes its last cache_len positions, which lands
    the window rolled into place (the reference's jnp.roll branch); a
    shorter prefill or a decode step is the reference's contiguous write.
    The write is in place.  A DTensor cache is written on each rank's own
    slices: the new K, V split as the cache is over batch, heads and head
    dimension, and over a split sequence each rank writes the slots it
    holds."""
    cache_len = cache["k"].shape[2]
    pw = positions[-cache_len:]
    slots = pw % cache_len
    kw, vw = k[:, :, -cache_len:], v[:, :, -cache_len:]
    if PT.is_distributed(cache["k"]):
        from torch.distributed.tensor import Replicate

        mesh, cp = cache["k"].device_mesh, cache["k"].placements
        kp = tuple(p if p.is_shard(0) or p.is_shard(1) or p.is_shard(3) else Replicate()
                   for p in cp)
        kw, vw = (t.redistribute(mesh, kp).to_local() for t in (kw, vw))
        cache["pos"].to_local().index_copy_(0, slots, pw)
        ck, cv = cache["k"].to_local(), cache["v"].to_local()
        if any(p.is_shard(2) for p in cp):
            # the written positions are consecutive, so the slot off + l that
            # a rank holds takes write (off + l - pw[0]) mod cache_len when
            # that is below their count, and keeps its value otherwise: a
            # select over the rank's slots, whose shapes do not depend on the
            # positions (a fake tensor has no values to select by)
            off, n = PT.local_range(mesh, cp, 2, cache_len)
            rel = (torch.arange(off, off + n, device=pw.device) - pw[0]) % cache_len
            hit = (rel < pw.shape[0])[None, None, :, None]
            idx = rel.clamp(max=pw.shape[0] - 1)
            ck.copy_(torch.where(hit, kw[:, :, idx].to(ck.dtype), ck))
            cv.copy_(torch.where(hit, vw[:, :, idx].to(cv.dtype), cv))
            return
    else:
        ck, cv = cache["k"], cache["v"]
        cache["pos"].index_copy_(0, slots, pw)
    ck.index_copy_(2, slots, kw.to(ck.dtype))
    cv.index_copy_(2, slots, vw.to(cv.dtype))


def _use_shard_decode() -> bool:
    rules, mesh = AX.current_rules(), AX.current_mesh()
    return bool(rules and rules.get(PT.SHARD_DECODE_FLAG)
                and mesh is not None and "model" in AX.mesh_axis_names(mesh))


def apply_attention(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    kind: str = "attn",              # attn | local | swa
    causal: bool = True,
    cache: Optional[Dict] = None,    # {"k","v","pos"}; decode/prefill KV cache
) -> Tuple[torch.Tensor, Optional[Dict]]:
    window = cfg.window if kind in ("local", "swa") else None
    is_decode = cache is not None and x.shape[1] == 1
    q, k, v = _project_qkv(p, cfg, x, positions)
    # q keeps a sequence split (``tp_fsdp_sp``); k and v are whole over it
    q = constrain(q, "batch", "heads_act", "seq", None)
    k = constrain(k, "batch", "kv_act", None, None)
    v = constrain(v, "batch", "kv_act", None, None)

    if is_decode and _use_shard_decode():
        from repro_torch.distributed.decode_attn import sharded_decode_attention

        out, new_cache = sharded_decode_attention(
            AX.current_mesh(), q, cache, k, v, positions,
            causal=causal, window=window, softcap=cfg.softcap)
        return project_out(out, p["wo"]), new_cache

    new_cache = None
    kv_positions = None
    if cache is not None:
        # the caller's cache tensors are updated in place and returned
        _write_cache(cache, k, v, positions)
        new_cache = cache
        if is_decode:
            # decode: attend over the cache (positions mask empty slots)
            k, v, kv_positions = cache["k"], cache["v"], cache["pos"]
    out = attention_core(
        q, k, v, causal=causal, window=window, q_offset=0,
        softcap=cfg.softcap, kv_positions=kv_positions, q_positions=positions,
    )
    return project_out(out, p["wo"]), new_cache


def apply_cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                          memory_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V: no RoPE, no
    mask.  A memory longer than ``BLOCKWISE_KV_THRESHOLD`` goes to
    ``ops.flash_attention``, in the prefill and in every decode step.  The
    projections go through ``project_heads``/``project_out``, as the
    self-attention's, so heads split unevenly or on the head dimension
    stay on local slices; q keeps a sequence split (``tp_fsdp_sp``), as
    the self-attention's does."""
    q = constrain(project_heads(x, p["wq"]), "batch", "heads_act", "seq", None)
    k, v = memory_kv
    out = attention_core(q, k, v, causal=False, window=None, q_offset=0, softcap=None)
    return project_out(out, p["wo"])


def cross_attention_memory(p: Dict, cfg: ModelConfig,
                           enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, V) of the encoder output for one cross-attention block, each
    (B, Hkv, S, Dh): views of the projections' (B, S, Hkv, Dh) results,
    whose strides the attention kernels take as they are."""
    return project_heads(enc_out, p["wk"]), project_heads(enc_out, p["wv"])


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict:
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": zeros((batch, hkv, max_len, dh), dtype, device),
        "v": zeros((batch, hkv, max_len, dh), dtype, device),
        "pos": torch.full((max_len,), -1, dtype=torch.int64, device=device),
    }
