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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import normal, ones, zeros

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
        return {"scale": ones((cfg.d_model,), torch.float32, device)}
    if cfg.norm_kind == "layernorm":
        return {
            "scale": ones((cfg.d_model,), torch.float32, device),
            "bias": zeros((cfg.d_model,), torch.float32, device),
        }
    if cfg.norm_kind == "nonparam_ln":  # OLMo: no learnable affine
        return {}
    raise ValueError(cfg.norm_kind)


def apply_norm(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    if cfg.norm_kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
        return (xf * p["scale"]).to(dt)
    mean = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, -1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + 1e-5)
    if cfg.norm_kind == "layernorm":
        xf = xf * p["scale"] + p["bias"]
    return xf.to(dt)


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
    p = {"wi": normal(gen, (d, f), dtype), "wo": normal(gen, (f, d), dtype)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["wg"] = normal(gen, (d, f), dtype)
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
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, cross: bool = False) -> Dict:
    """A cross-attention block (``cross``) has no QKV bias and no qk-norm."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": normal(gen, (d, h, dh), dtype),
        "wk": normal(gen, (d, hkv, dh), dtype),
        "wv": normal(gen, (d, hkv, dh), dtype),
        "wo": normal(gen, (h, dh, d), dtype),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = zeros((h, dh), dtype, dev)
        p["bk"] = zeros((hkv, dh), dtype, dev)
        p["bv"] = zeros((hkv, dh), dtype, dev)
    if cfg.qk_norm and not cross:
        p["q_scale"] = ones((dh,), torch.float32, dev)
        p["k_scale"] = ones((dh,), torch.float32, dev)
    return p


def _head_rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (xf * scale).to(x.dtype)


def _project_qkv(p, cfg, x, positions, apply_rope: bool = True):
    q = torch.einsum("btd,dhk->bhtk", x, p["wq"])
    k = torch.einsum("btd,dhk->bhtk", x, p["wk"])
    v = torch.einsum("btd,dhk->bhtk", x, p["wv"])
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
    (``q_positions``) rather than indices.
    """
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

    new_cache = None
    kv_positions = None
    if cache is not None:
        # Slot invariant: position pos lives at slot pos % cache_len.  Only
        # the last cache_len positions can survive, so a prefill longer
        # than a window-limited cache writes its last cache_len positions,
        # which lands the window rolled into place (the reference's
        # jnp.roll branch); a shorter prefill or a decode step is the
        # reference's contiguous write.  The write is in place: the
        # caller's cache tensors are updated and returned.
        cache_len = cache["k"].shape[2]
        pw = positions[-cache_len:]
        slots = pw % cache_len
        cache["k"].index_copy_(2, slots, k[:, :, -cache_len:].to(cache["k"].dtype))
        cache["v"].index_copy_(2, slots, v[:, :, -cache_len:].to(cache["v"].dtype))
        cache["pos"].index_copy_(0, slots, pw)
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
