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
DTensors) the ``constrain`` calls sit where the reference's do, attention
runs on each rank's local q, k, v (``_local_attention``: the CUDA
kernels read plain tensors) and the cache writes are local; a decode
step under ``tp_serve_sm`` goes to ``decode_attn.sharded_decode_attention``.
"""

from __future__ import annotations

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
    """``table[tokens]``.  A table that a mesh axis splits goes through
    ``F.embedding``, which DTensor shards as the table is, forward and
    backward: the advanced index's backward is an ``index_put`` into a
    replicated zero table (a whole vocab x embed gradient on every rank),
    and DTensor's sharding propagation of it fails in some torch
    versions.  A whole table keeps the index, whose gradient sums the rows
    in another order (the (1, 1) mesh stays bit-equal to one device)."""
    if PT.is_distributed(table) and any(p.is_shard() for p in table.placements):
        return F.embedding(tokens, table)
    return table[tokens]


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
    from torch.distributed.tensor import Replicate

    pl = [p if p.is_shard(0) else Replicate() for p in t.placements]
    return dict(params, embed=dict(params["embed"], table=t.redistribute(t.device_mesh, pl)))


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
    return constrain(out, "batch", *([None] * (out.ndim - 2)), "embed_act")


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
    h = constrain(h, "batch", None, "mlp_act")
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


def _project_qkv(p, cfg, x, positions, apply_rope: bool = True):
    q = torch.einsum("btd,dhk->bhtk", x, _heads_whole(p["wq"]))
    k = torch.einsum("btd,dhk->bhtk", x, _heads_whole(p["wk"]))
    v = torch.einsum("btd,dhk->bhtk", x, _heads_whole(p["wv"]))
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
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
        # decode: scores against the cache.  The reference multiplies the
        # cache-dtype operands with float32 accumulation; upcasting the
        # operands exactly and multiplying in float32 is the same sum.
        B, Hq, Tq, D = q.shape
        Hkv = k.shape[1]
        group = Hq // Hkv
        qf = (q.to(k.dtype) * (D ** -0.5)).reshape(B, Hkv, group, Tq, D)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf.float(), k.float())
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
    if Tk > BLOCKWISE_KV_THRESHOLD:
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, softcap=softcap)
    return ref_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                         softcap=softcap)


def _local_attention(q, k, v, *, kv_positions, **kw):
    """``attention_core`` on each rank's local q, k, v, the output rebuilt
    as a DTensor split as q is.

    q keeps its batch and head splits (anything else is gathered); k and
    v follow its batch split, and its head split where kv_heads divides
    that axis.  Where it does not (``spec_for``'s guard replicated k and
    v), each rank takes the kv heads its local q heads read: a slice of
    ``group = Hq / Hkv`` consecutive q heads reads one kv head.  Those
    gradients of k and v are partial sums over the ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = q.device_mesh
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    qp = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in q.placements)
    even = all(Hkv % mesh.size(i) == 0 for i, p in enumerate(qp) if p.is_shard(1))
    kvp = tuple(p if p.is_shard(0) or (even and p.is_shard(1)) else Replicate() for p in qp)
    grad_p = tuple(Partial() if p.is_shard(1) and not even else kp for p, kp in zip(qp, kvp))
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl = (t.redistribute(mesh, kvp).to_local(grad_placements=grad_p) for t in (k, v))
    if not even:
        h0, hl = PT.local_range(mesh, qp, 1, Hq)
        group = Hq // Hkv
        if not (group % hl == 0 or hl % group == 0):
            raise NotImplementedError(
                f"{hl} local q heads of {Hq} do not map onto whole groups of {group} "
                f"over {Hkv} kv heads")
        lo, n = h0 // group, max(hl // group, 1)
        kl, vl = kl[:, lo:lo + n], vl[:, lo:lo + n]
    if isinstance(kv_positions, DTensor):
        kv_positions = kv_positions.full_tensor()
    out = attention_core(ql, kl, vl, kv_positions=kv_positions, **kw)
    return DTensor.from_local(out, mesh, qp, run_check=False)


def _write_cache(cache: Dict, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor) -> None:
    """Slot invariant: position pos lives at slot pos % cache_len.  Only
    the last cache_len positions can survive, so a prefill longer than a
    window-limited cache writes its last cache_len positions, which lands
    the window rolled into place (the reference's jnp.roll branch); a
    shorter prefill or a decode step is the reference's contiguous write.
    The write is in place.  A DTensor cache is written on each rank's own
    slices: the new K, V split as the cache is over batch and heads, and
    over a split sequence each rank writes the slots it holds."""
    cache_len = cache["k"].shape[2]
    pw = positions[-cache_len:]
    slots = pw % cache_len
    kw, vw = k[:, :, -cache_len:], v[:, :, -cache_len:]
    if PT.is_distributed(cache["k"]):
        from torch.distributed.tensor import Replicate

        mesh, cp = cache["k"].device_mesh, cache["k"].placements
        kp = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate() for p in cp)
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
    q = constrain(q, "batch", "heads_act", None, None)
    k = constrain(k, "batch", "kv_act", None, None)
    v = constrain(v, "batch", "kv_act", None, None)

    if is_decode and _use_shard_decode():
        from repro_torch.distributed.decode_attn import sharded_decode_attention

        out, new_cache = sharded_decode_attention(
            AX.current_mesh(), q, cache, k, v, positions,
            causal=causal, window=window, softcap=cfg.softcap)
        return torch.einsum("bhtk,hkd->btd", out, p["wo"]), new_cache

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
    y = torch.einsum("bhtk,hkd->btd", out, p["wo"])
    return y, new_cache


def apply_cross_attention(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                          memory_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V: no RoPE, no
    mask.  A memory longer than ``BLOCKWISE_KV_THRESHOLD`` goes to
    ``ops.flash_attention``, in the prefill and in every decode step."""
    q = torch.einsum("btd,dhk->bhtk", x, p["wq"])
    k, v = memory_kv
    out = attention_core(q, k, v, causal=False, window=None, q_offset=0, softcap=None)
    return torch.einsum("bhtk,hkd->btd", out, p["wo"])


def cross_attention_memory(p: Dict, cfg: ModelConfig,
                           enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, V) of the encoder output for one cross-attention block, each
    (B, Hkv, S, Dh): views of the projections' (B, S, Hkv, Dh) results,
    whose strides the attention kernels take as they are."""
    k = torch.einsum("btd,dhk->bhtk", enc_out, p["wk"])
    v = torch.einsum("btd,dhk->bhtk", enc_out, p["wv"])
    return k, v


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict:
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": zeros((batch, hkv, max_len, dh), dtype, device),
        "v": zeros((batch, hkv, max_len, dh), dtype, device),
        "pos": torch.full((max_len,), -1, dtype=torch.int64, device=device),
    }
