"""Decoder-only LM assembly: embed -> pattern blocks -> norm -> logits.

Layers follow ``cfg.block_pattern`` cycled over ``cfg.n_layers``.  As in
the reference, whole pattern groups are stacked along a leading axis
(``params["groups"][p]`` holds pattern position ``p`` of every group)
and remainder layers are listed in ``params["rest"]``; where the
reference drives the groups with ``lax.scan``, the port loops in Python.
Group ``g``, pattern position ``p`` is layer ``g * P + p``; the ``rest``
layers come after.

Entry points: ``apply_stack_train`` (full forward without caches),
``lm_prefill`` (forward the prompt, fill the caches) and
``lm_decode_step`` (one token against the caches), and ``lm_loss`` for
training.  MoE, the VLM frontend and mLSTM/sLSTM are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import index_tree, normal, stack_trees

ATTN_KINDS = ("attn", "local", "swa")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet")


# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Dict:
    dt = L.torch_dtype(cfg)
    p: Dict = {"norm1": L.init_norm(cfg, gen.device)}
    if kind in ATTN_KINDS:
        p["mixer"] = L.init_attention(gen, cfg, dt)
    elif kind == "rglru":
        p["mixer"] = R.init_rglru(gen, cfg, dt)
    else:
        raise _not_ported(f"block kind {kind!r}")
    if cfg.d_ff > 0:
        if cfg.moe:
            raise _not_ported("MoE")
        p["norm2"] = L.init_norm(cfg, gen.device)
        p["ffn"] = L.init_mlp(gen, cfg, dt)
    return p


def apply_block(p: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, cache):
    """Returns (x, new_cache, aux_loss); aux is zero without MoE."""
    h = L.apply_norm(p["norm1"], cfg, x)
    if kind in ATTN_KINDS:
        y, new_cache = L.apply_attention(p["mixer"], cfg, h, positions, kind=kind, cache=cache)
    elif kind == "rglru":
        y, new_cache = R.apply_rglru(p["mixer"], cfg, h, cache)
    else:
        raise _not_ported(f"block kind {kind!r}")
    x = x + y
    if "ffn" in p:
        if cfg.moe:
            raise _not_ported("MoE")
        x = x + L.apply_mlp(p["ffn"], cfg, L.apply_norm(p["norm2"], cfg, x))
    return x, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    dt = L.torch_dtype(cfg)
    if kind in ATTN_KINDS:
        length = max_len if kind == "attn" or cfg.window is None else min(max_len, cfg.window)
        return L.init_kv_cache(cfg, batch, length, dt, device)
    if kind == "rglru":
        return R.init_rglru_state(cfg, batch, dt, device)
    raise _not_ported(f"block kind {kind!r}")


# ---------------------------------------------------------------------------
# whole-model params
# ---------------------------------------------------------------------------


def _pattern_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(n_groups, remainder_kinds)."""
    P = len(cfg.block_pattern)
    return cfg.n_layers // P, tuple(
        cfg.block_pattern[i % P] for i in range(cfg.n_layers - cfg.n_layers % P, cfg.n_layers)
    )


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    if cfg.arch_kind != "decoder":
        raise _not_ported(f"arch_kind {cfg.arch_kind!r}")
    dt = L.torch_dtype(cfg)
    n_groups, rest = _pattern_layout(cfg)
    tree: Dict = {
        "embed": {"table": normal(gen, (cfg.vocab_size, cfg.d_model), dt)},
        "final_norm": L.init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": normal(gen, (cfg.d_model, cfg.vocab_size), dt)}
    tree["groups"] = [
        stack_trees([init_block(gen, cfg, kind) for _ in range(n_groups)])
        for kind in (cfg.block_pattern if n_groups > 0 else ())
    ]
    tree["rest"] = [init_block(gen, cfg, kind) for kind in rest]
    return tree


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def _embed(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    if cfg.frontend is not None and "vision_embeds" in batch:
        raise _not_ported("the VLM frontend")
    return params["embed"]["table"][batch["tokens"]]


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], cfg, x)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return x @ w


def _layers(params, cfg: ModelConfig):
    """(params, kind, group index or None, pattern/rest index) in layer order."""
    n_groups, rest = _pattern_layout(cfg)
    for g in range(n_groups):
        for p_idx, kind in enumerate(cfg.block_pattern):
            yield index_tree(params["groups"][p_idx], g), kind, g, p_idx
    for i, kind in enumerate(rest):
        yield params["rest"][i], kind, None, i


def apply_stack_train(params, cfg: ModelConfig, x, positions):
    """Full forward pass without caches. Returns (x, aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind, _, _ in _layers(params, cfg):
        x, _, a = apply_block(p, cfg, kind, x, positions, None)
        aux_total = aux_total + a
    return x, aux_total


def apply_stack_cached(params, cfg: ModelConfig, x, positions, cache):
    """Prefill/decode pass threading caches. Returns (x, cache).

    The cache is updated in place (``cache["groups"][p]`` is stacked over
    groups like the parameters) and returned.
    """
    for p, kind, g, i in _layers(params, cfg):
        entry = index_tree(cache["groups"][i], g) if g is not None else cache["rest"][i]
        x, new_entry, _ = apply_block(p, cfg, kind, x, positions, entry)
        for key, val in new_entry.items():
            if val is not entry[key]:       # attention already wrote in place
                entry[key].copy_(val)
    return x, cache


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    n_groups, rest_kinds = _pattern_layout(cfg)
    groups = [
        stack_trees([init_cache_entry(cfg, kind, batch, max_len, device)
                     for _ in range(n_groups)])
        for kind in (cfg.block_pattern if n_groups > 0 else ())
    ]
    rest = [init_cache_entry(cfg, kind, batch, max_len, device) for kind in rest_kinds]
    return {"groups": groups, "rest": rest}


# ---------------------------------------------------------------------------
# public heads
# ---------------------------------------------------------------------------


def lm_loss(params, cfg: ModelConfig, batch: Dict, remat_policy: str = "none"):
    """Next-token CE over ``labels`` (mask: labels < 0) plus the z-loss
    ``1e-4 * mean(lse^2)`` and ``1e-2 * aux``.  Returns (loss, metrics).

    ``remat_policy``: only ``"none"``; the port keeps every activation.
    """
    if remat_policy != "none":
        raise _not_ported(f"remat_policy {remat_policy!r}")
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = apply_stack_train(params, cfg, x, positions)
    logits = _logits(params, cfg, x).float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lbl = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
    ce = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = ce.sum() / denom
    zloss = 1e-4 * ((lse * mask) ** 2).sum() / denom
    total = loss + zloss + 1e-2 * aux
    return total, {"ce": loss, "zloss": zloss, "aux": aux, "tokens": denom}


def lm_prefill(params, cfg: ModelConfig, batch: Dict, cache):
    """Forward the prompt, filling caches; returns (last_logits, cache)."""
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, cache = apply_stack_cached(params, cfg, x, positions, cache)
    return _logits(params, cfg, x[:, -1:, :])[:, 0], cache


def lm_decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int, cache):
    """One decode step. token: (B,) int64; pos: absolute position."""
    x = params["embed"]["table"][token][:, None, :]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    x, cache = apply_stack_cached(params, cfg, x, positions, cache)
    return _logits(params, cfg, x)[:, 0], cache
