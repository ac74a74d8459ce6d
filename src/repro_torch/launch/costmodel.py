"""Analytic roofline cost model per (arch x shape x mesh x strategy).

The counterpart of ``repro.launch.costmodel``, the same arithmetic term
for term: only the roofline's constants differ (the H100's,
``launch/hlo.py``).  A mesh is a ``DeviceMesh`` or any stand-in whose
``shape`` maps axis names to sizes (``partitioning.mesh_sizes``).  The
reference's account of why the model is analytic follows; in the port
the traced count (``launch/dryrun.py``) runs every loop, so it is held
to this model's FLOPs at full trip counts as well.

Why analytic: XLA's ``cost_analysis()`` counts every ``while`` body
exactly once, and all our programs scan (layer groups, grad-accum
microbatches, blockwise-attention KV chunks, recurrent time steps) — so
raw HLO FLOPs/bytes undercount by the product of trip counts.  The
compiled artifact remains the source for *memory feasibility*
(``memory_analysis``) and *collective structure* (which collectives, at
what per-call payload); FLOPs/bytes/collective-volume come from this
model, which mirrors the implementation op-for-op.  It is validated
against ``cost_analysis()`` on scan-free configurations (trip counts of
1, no blockwise attention) in ``tests/test_costmodel.py`` and
EXPERIMENTS.md §Dry-run.

Conventions:

* matmul flops = 2·m·n·k; vector ops ignored (standard MFU accounting);
* backward = 2x forward matmul flops; remat "full" adds one forward;
* a tensor dimension that fails the divisibility guard is *replicated*,
  so the corresponding compute is NOT divided by that mesh axis — this
  surfaces e.g. qwen1.5's 40 heads on a 16-way TP axis as real waste;
* collective bytes are ring-transfer payloads: all-reduce moves
  ~2·size, all-gather/reduce-scatter ~1·size per device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed.partitioning import mesh_sizes
from repro_torch.launch import hlo as H
from repro_torch.models.config import ModelConfig

ATTN_KINDS = ("attn", "local", "swa")
MLSTM_CHUNK = 256
BLOCKWISE_THRESHOLD = 4096  # must match models.layers


def _mesh_factor(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _mesh_size(mesh) -> int:
    """Devices in the mesh (the reference's ``mesh.size``)."""
    return math.prod(mesh_sizes(mesh).values())


def _itemsize(dtype: str) -> int:
    """Bytes of one element of a config's dtype name ("bfloat16", ...)."""
    import torch

    return torch.empty((), dtype=getattr(torch, dtype), device="meta").element_size()


def _div(dim: int, ways: int) -> int:
    """Shard factor with the divisibility guard: replicate when it
    doesn't divide (matching partitioning.spec_for)."""
    return ways if dim % ways == 0 else 1


def _div_eff(dim: int, ways: int, uneven: bool) -> float:
    """Effective shard factor; uneven sharding pads to ceil(dim/ways)."""
    if dim % ways == 0:
        return float(ways)
    if uneven and dim >= ways:
        return dim / math.ceil(dim / ways)
    return 1.0


def avg_attended(T: int, causal: bool, window: Optional[int]) -> float:
    """Average #keys attended per query position."""
    if not causal:
        return float(T)
    if window is None or window >= T:
        return (T + 1) / 2.0
    W = window
    return (W * (W + 1) / 2.0 + (T - W) * W) / T


@dataclass
class CellCosts:
    """Per-device costs + per-component global flops breakdown."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    global_flops: float
    breakdown: Dict[str, float] = field(default_factory=dict)
    notes: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# forward flops per token, by layer kind (global, unsharded)
# ---------------------------------------------------------------------------


def _attn_proj_flops(cfg: ModelConfig) -> float:
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return 2 * d * H * dh + 2 * 2 * d * Hkv * dh + 2 * H * dh * d


def _attn_score_flops(cfg: ModelConfig, t_eff: float) -> float:
    return 4 * cfg.n_heads * cfg.head_dim * t_eff  # qk^T + pv


def _mlp_flops(cfg: ModelConfig) -> float:
    if cfg.d_ff == 0:
        return 0.0
    n_mat = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return 2 * n_mat * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, T: int) -> Dict[str, float]:
    """Per-token flops for one MoE layer (capacity-based einsum impl).

    Routing-group size g (= seq_len unless cfg.moe_group re-groups):
    capacity C = cf·K·g/E, so the dispatch/combine einsums cost
    2·E·C·d = 2·K·cf·g·d per token — linear in g, the §Perf lever.
    """
    d, f, E, K, cf = (cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                      cfg.capacity_factor)
    g = T if cfg.moe_group is None or T <= cfg.moe_group else cfg.moe_group
    C = max(1, int(cf * K * g / E))
    experts = 2 * 3 * d * f * (E * C / g)       # slots incl. padding
    router = 2 * d * E
    dispatch = 2 * 2 * E * C * d
    return {"moe_experts": experts, "moe_router": router,
            "moe_dispatch": dispatch}


def _rglru_flops(cfg: ModelConfig) -> float:
    d, r, W = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return 2 * 2 * d * r + 2 * W * r + 2 * 2 * r * r + 8 * r + 2 * r * d


def _mlstm_flops(cfg: ModelConfig) -> float:
    d, r, Hn = cfg.d_model, cfg.rnn_width, cfg.n_heads
    dh = r // Hn
    up = 2 * d * 2 * r
    qkv = 3 * 2 * r * r
    gates = 2 * r * 2 * Hn
    intra = 4 * MLSTM_CHUNK * r          # chunk scores + av
    inter = 6 * r * dh                   # state read/update amortized
    down = 2 * r * d
    return up + qkv + gates + intra + inter + down + 2 * cfg.conv_width * r


def _slstm_flops(cfg: ModelConfig) -> float:
    d, r = cfg.d_model, cfg.rnn_width
    return 2 * d * 4 * r + 2 * r * 4 * r + 24 * r


def _layer_kinds(cfg: ModelConfig):
    P = len(cfg.block_pattern)
    return [cfg.block_pattern[i % P] for i in range(cfg.n_layers)]


def fwd_flops_per_token(cfg: ModelConfig, T: int, t_eff: float,
                        with_logits: bool = True) -> Dict[str, float]:
    """Global forward flops per token, by component."""
    out: Dict[str, float] = {}

    def add(k, v):
        out[k] = out.get(k, 0.0) + v

    for kind in _layer_kinds(cfg):
        if kind in ATTN_KINDS:
            win = cfg.window if kind in ("local", "swa") else None
            te = t_eff if win is None else min(t_eff, avg_attended(
                int(max(t_eff * 2 - 1, 1)), True, win))
            add("attn_proj", _attn_proj_flops(cfg))
            add("attn_scores", _attn_score_flops(
                cfg, avg_attended(T, True, win) if T > 1 else te))
            if cfg.moe:
                for k, v in _moe_flops(cfg, T).items():
                    add(k, v)
            else:
                add("mlp", _mlp_flops(cfg))
        elif kind == "rglru":
            add("recurrent", _rglru_flops(cfg))
            if cfg.moe:
                for k, v in _moe_flops(cfg, T).items():
                    add(k, v)
            else:
                add("mlp", _mlp_flops(cfg))
        elif kind == "mlstm":
            add("recurrent", _mlstm_flops(cfg))
        elif kind == "slstm":
            add("recurrent", _slstm_flops(cfg))
    if cfg.arch_kind == "encdec":
        # encoder stack (full bidirectional attention over T)
        enc = cfg.n_enc_layers * (
            _attn_proj_flops(cfg) + _attn_score_flops(cfg, T) + _mlp_flops(cfg)
        )
        add("encoder", enc)
        # decoder cross-attention per layer (memory of length T)
        add("cross_attn", cfg.n_layers * (
            _attn_proj_flops(cfg) + _attn_score_flops(cfg, T)))
    if with_logits:
        add("logits", 2 * cfg.d_model * cfg.vocab_size)
    return out


# ---------------------------------------------------------------------------
# shard factors per component
# ---------------------------------------------------------------------------


def _shard_factors(cfg: ModelConfig, mesh, batch: int,
                   strategy: str = "tp") -> Dict[str, float]:
    """Effective compute-shard factor per component.

    Compute follows the *activation* sharding constraints, which GSPMD
    honours even for indivisible dims (padded): verified by probe —
    40 q-heads on a 16-way axis compile to the same per-device FLOPs as
    48 heads.  Hence ceil-based effective factors here, while *storage*
    (params/caches, which are jit arguments) keeps the hard guard.
    """
    tp = _mesh_factor(mesh, "model")
    dp = _mesh_factor(mesh, ("pod", "data"))
    if strategy.startswith("dp"):
        dp, tp = _mesh_size(mesh), 1      # pure data-parallel layout
    eff = lambda dim: _div_eff(dim, tp, uneven=True) if tp > 1 else 1.0
    bshard = _div(batch, dp)
    f = {
        "attn_proj": bshard * eff(cfg.n_heads),
        "attn_scores": bshard * eff(cfg.n_heads),
        "mlp": bshard * (eff(cfg.d_ff) if cfg.d_ff else 1),
        "moe_experts": bshard * eff(cfg.n_experts),
        "moe_router": bshard,
        "moe_dispatch": bshard * eff(cfg.n_experts),
        "recurrent": bshard * eff(cfg.rnn_width),
        "logits": bshard * eff(cfg.vocab_size),
        "encoder": bshard * eff(cfg.n_heads),
        "cross_attn": bshard * eff(cfg.n_heads),
        "optimizer": _mesh_size(mesh),  # fsdp: fully sharded states
    }
    return f


# ---------------------------------------------------------------------------
# the three terms per cell
# ---------------------------------------------------------------------------


def cell_costs(
    cfg: ModelConfig,
    cell: ShapeCell,
    mesh,
    strategy: str,
    remat: str = "full",
    accum: int = 1,
) -> CellCosts:
    B, T = cell.global_batch, cell.seq_len
    tp = _mesh_factor(mesh, "model")
    dp = _mesh_factor(mesh, ("pod", "data"))
    chips = _mesh_size(mesh)
    d = cfg.d_model
    esz = _itemsize(cfg.dtype)
    N_active = cfg.active_param_count()
    fsdp = "fsdp" in strategy
    uneven = "_uneven" in strategy
    zero2 = "_zero2" in strategy
    notes: Dict[str, str] = {}

    if cell.step == "train":
        per_tok = fwd_flops_per_token(cfg, T, avg_attended(T, True, None))
        tokens = B * T
        # remat surcharges calibrated against compiled scan-free probes
        # (XLA DCEs part of the recompute): full ~= +0.4 fwd, dots ~= +0.15
        mult = 3.0 + (0.4 if remat == "full" else 0.15 if remat == "dots" else 0.0)
        comp = {k: v * tokens * mult for k, v in per_tok.items()}
        comp["optimizer"] = 12.0 * cfg.param_count()
    elif cell.step == "prefill":
        per_tok = fwd_flops_per_token(cfg, T, avg_attended(T, True, None),
                                      with_logits=False)
        tokens = B * T
        comp = {k: v * tokens for k, v in per_tok.items()}
        comp["logits"] = 2.0 * d * cfg.vocab_size * B  # last position only
    else:  # decode: one token against a cache of length T
        win_cache = min(T, cfg.window) if cfg.window else T
        per_tok = fwd_flops_per_token(cfg, 1, float(T))
        # overwrite attention score term with true cache lengths
        sc = 0.0
        for kind in _layer_kinds(cfg):
            if kind == "attn":
                sc += _attn_score_flops(cfg, float(T))
            elif kind in ("local", "swa"):
                sc += _attn_score_flops(cfg, float(win_cache))
        per_tok["attn_scores"] = sc
        if cfg.arch_kind == "encdec":
            from repro_torch.launch.specs import ENC_MEMORY_LEN
            per_tok["cross_attn"] = cfg.n_layers * (
                _attn_proj_flops(cfg) + _attn_score_flops(cfg, ENC_MEMORY_LEN))
            per_tok["encoder"] = 0.0  # encoder ran at prefill
        comp = {k: v * B for k, v in per_tok.items()}

    shard = _shard_factors(cfg, mesh, B, strategy)
    if strategy.startswith("dp"):
        dp, tp = chips, 1
    flops_dev = 0.0
    global_flops = 0.0
    for k, v in comp.items():
        global_flops += v
        s = shard.get(k, dp)
        flops_dev += v / s
        if tp > 1 and k in ("attn_proj", "attn_scores") and cfg.n_heads % tp:
            pad = math.ceil(cfg.n_heads / tp) * tp / cfg.n_heads
            notes[k] = f"uneven heads on {tp}-way axis: {pad:.2f}x padding"

    # ----------------------------------------------------------- HBM bytes
    # Fused-granularity traffic model: weights/states/caches/stored
    # activations each move once per semantic use.  (HLO "bytes accessed"
    # counts every op unfused and overcounts real HBM traffic several-x;
    # both numbers are recorded in the dry-run artifacts.)
    bytes_dev = 0.0
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.arch_kind == "encdec" else 0)
    p_local = esz * cfg.param_count() / min(tp, chips)  # TP param shard
    if cell.step == "train":
        b_micro = max(B // (dp * accum), 1)
        uses = 2.0 + (1.0 if remat == "full" else 0.0)  # fwd + bwd (+recompute)
        bytes_dev += uses * accum * p_local              # weight reads
        bytes_dev += accum * p_local                     # grad writes
        bytes_dev += 2 * accum * 4.0 * cfg.param_count() / chips  # fp32 accum rmw
        bytes_dev += 7 * 4.0 * cfg.param_count() / chips          # adam + master
        if zero2:
            bytes_dev += p_local                         # resident gathered copy
        act = 20.0 * b_micro * T * d * esz * L  # activations (not model-sharded)
        bytes_dev += accum * act
        if cfg.moe:
            disp = 2.0 * b_micro * T * (cfg.top_k * cfg.capacity_factor * T) * esz
            bytes_dev += accum * disp * cfg.n_layers / _div(cfg.n_experts, tp)
        bytes_dev += accum * b_micro * T * cfg.vocab_size * esz / _div(cfg.vocab_size, tp) * 2
    elif cell.step == "prefill":
        b_loc = max(B // dp, 1)
        bytes_dev += p_local
        bytes_dev += 12.0 * b_loc * T * d * esz * L
        kv_pages = 2 * L * cfg.n_kv_heads * cfg.head_dim * T * b_loc * esz
        bytes_dev += kv_pages / _div(cfg.n_kv_heads, tp)
        bytes_dev += b_loc * cfg.vocab_size * esz / _div(cfg.vocab_size, tp)
    else:
        b_loc = max(B // dp, 1)
        win_cache = min(T, cfg.window) if cfg.window else T
        bytes_dev += p_local                              # all weights once
        kv_bytes = 0.0
        for kind in _layer_kinds(cfg):
            if kind == "attn":
                kv_bytes += 2 * cfg.n_kv_heads * cfg.head_dim * T * b_loc * esz
            elif kind in ("local", "swa"):
                kv_bytes += 2 * cfg.n_kv_heads * cfg.head_dim * win_cache * b_loc * esz
            elif kind == "rglru":
                kv_bytes += (cfg.rnn_width * b_loc * 4) * 2
            elif kind == "mlstm":
                dh = cfg.rnn_width // cfg.n_heads
                kv_bytes += (cfg.n_heads * dh * dh * b_loc * 4) * 2
            elif kind == "slstm":
                kv_bytes += 4 * cfg.rnn_width * b_loc * 4 * 2
        kv_shard = _div_eff(cfg.n_kv_heads, tp, uneven)
        if "tp_serve_hd" in strategy and kv_shard == 1:
            # head-dim cache sharding (partitioning.tp_serve_hd)
            kv_shard = _div(cfg.head_dim, tp)
        elif "tp_serve" in strategy and kv_shard == 1:
            # cache falls back to seq-dim sharding (partitioning.tp_serve)
            kv_shard = _div(win_cache if cfg.window else T, tp)
        bytes_dev += kv_bytes / max(kv_shard, 1)
        bytes_dev += b_loc * cfg.vocab_size * esz / _div(cfg.vocab_size, tp)
        if cfg.arch_kind == "encdec":
            from repro_torch.launch.specs import ENC_MEMORY_LEN
            bytes_dev += (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                          * ENC_MEMORY_LEN * b_loc * esz) / _div(cfg.n_kv_heads, tp)

    # ----------------------------------------------------- collective bytes
    coll = 0.0
    act_bytes = lambda b, t: b * t * d * esz
    if cell.step == "train":
        b_micro = max(B // (dp * accum), 1)
        n_ar_layers = sum(1 for k in _layer_kinds(cfg)) * 2
        if cfg.arch_kind == "encdec":
            n_ar_layers += cfg.n_enc_layers * 2 + cfg.n_layers
        if tp > 1:
            coll += accum * n_ar_layers * 2.0 * act_bytes(b_micro, T)
        if fsdp and dp > 1 and zero2:
            coll += 1.0 * p_local                # ONE param all-gather per step
            coll += accum * 1.0 * p_local        # grad reduce-scatter per microbatch
        elif fsdp and dp > 1:
            coll += accum * 2.0 * p_local        # param all-gathers (fwd+bwd)
            coll += accum * 1.0 * p_local        # grad reduce-scatter
        elif dp > 1:
            coll += 2.0 * esz * cfg.param_count() / tp  # grad all-reduce (ring)
        if cfg.moe and _div(cfg.n_experts, tp) > 1:
            C = max(1, int(cfg.capacity_factor * cfg.top_k * T / cfg.n_experts))
            a2a = b_micro * cfg.n_experts * C * d * esz
            coll += accum * cfg.n_layers * 2 * 2 * a2a / tp
    else:
        b_loc = max(B // dp, 1)
        t_q = T if cell.step == "prefill" else 1
        n_ar_layers = len(_layer_kinds(cfg)) * 2
        if cfg.arch_kind == "encdec":
            n_ar_layers += cfg.n_enc_layers * 2 + cfg.n_layers
        if tp > 1:
            coll += n_ar_layers * 2.0 * act_bytes(b_loc, t_q)
        if ("tp_serve_hd" in strategy and cell.step == "decode"
                and cfg.n_kv_heads % tp != 0):
            # partial-score all-reduce per attention layer (dh sharded)
            win_cache = min(T, cfg.window) if cfg.window else T
            for kind in _layer_kinds(cfg):
                if kind == "attn":
                    coll += 2.0 * b_loc * cfg.n_heads * T * 4
                elif kind in ("local", "swa"):
                    coll += 2.0 * b_loc * cfg.n_heads * win_cache * 4
        if cfg.moe and _div(cfg.n_experts, tp) > 1:
            C = max(1, int(cfg.capacity_factor * cfg.top_k * max(t_q, 1)
                           / cfg.n_experts))
            coll += cfg.n_layers * 2 * (b_loc * cfg.n_experts * C * d * esz) / tp

    return CellCosts(
        flops_per_device=flops_dev,
        hbm_bytes_per_device=bytes_dev,
        collective_bytes_per_device=coll,
        global_flops=global_flops,
        breakdown=comp,
        notes=notes,
    )


def analytic_roofline(cfg, cell, mesh, strategy, remat="full", accum=1,
                      model_flops: Optional[float] = None) -> H.Roofline:
    c = cell_costs(cfg, cell, mesh, strategy, remat, accum)
    return H.Roofline(
        flops=c.flops_per_device,
        hbm_bytes=c.hbm_bytes_per_device,
        collective_bytes=c.collective_bytes_per_device,
        n_chips=_mesh_size(mesh),
        model_flops=model_flops,
    )
