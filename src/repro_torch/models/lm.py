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
training.  Everything the reference's decoder does is ported: attention
(global, local, sliding-window), RG-LRU, mLSTM and sLSTM blocks (the
last two without an FFN), dense and MoE FFNs (the MoE aux loss enters
``lm_loss``), the VLM frontend stub (``batch["vision_embeds"]`` replaces
the embeddings of the first positions) and the three rematerialisation
policies, which wrap each pattern group as the reference wraps its scan
body.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.axes import constrain
from repro_torch.distributed.partitioning import is_distributed
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.config import ModelConfig
from repro_torch.models.param_util import index_tree, leaf, normal, stack_trees

ATTN_KINDS = ("attn", "local", "swa")
RECURRENT = {"rglru": (R.init_rglru, R.apply_rglru, R.init_rglru_state),
             "mlstm": (R.init_mlstm, R.apply_mlstm, R.init_mlstm_state),
             "slstm": (R.init_slstm, R.apply_slstm, R.init_slstm_state)}

# ---------------------------------------------------------------------------
# block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Dict:
    dt = L.torch_dtype(cfg)
    p: Dict = {"norm1": L.init_norm(cfg, gen.device)}
    if kind in ATTN_KINDS:
        p["mixer"] = L.init_attention(gen, cfg, dt)
    elif kind in RECURRENT:
        p["mixer"] = RECURRENT[kind][0](gen, cfg, dt)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0 and kind not in ("mlstm", "slstm"):
        p["norm2"] = L.init_norm(cfg, gen.device)
        p["ffn"] = M.init_moe(gen, cfg, dt) if cfg.moe else L.init_mlp(gen, cfg, dt)
    return p


def apply_block(p: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, cache):
    """Returns (x, new_cache, aux_loss); aux is zero without MoE."""
    h = L.apply_norm(p["norm1"], cfg, x)
    if kind in ATTN_KINDS:
        y, new_cache = L.apply_attention(p["mixer"], cfg, h, positions, kind=kind, cache=cache)
    elif kind in RECURRENT:
        y, new_cache = RECURRENT[kind][1](p["mixer"], cfg, h, cache)
    else:
        raise ValueError(kind)
    # the residual stream whole over "model" before the next norm: left a
    # partial sum of the mixer's output projection, the norm's output stays
    # partial and DTensor runs the FFN's products on it with gathered
    # weights, a whole layer's work on every rank
    x = constrain(x + y, "batch", "seq", "embed_act")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "ffn" in p:
        h2 = L.apply_norm(p["norm2"], cfg, x)
        if cfg.moe:
            y2, aux = M.apply_moe(p["ffn"], cfg, h2)
        else:
            y2 = L.apply_mlp(p["ffn"], cfg, h2)
        x = x + y2
    return constrain(x, "batch", "seq", "embed_act"), new_cache, aux


def init_cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int, device):
    dt = L.torch_dtype(cfg)
    if kind in ATTN_KINDS:
        length = max_len if kind == "attn" or cfg.window is None else min(max_len, cfg.window)
        return L.init_kv_cache(cfg, batch, length, dt, device)
    if kind in RECURRENT:
        return RECURRENT[kind][2](cfg, batch, dt, device)
    raise ValueError(kind)


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
        raise ValueError(f"init_lm builds decoder-only models, not arch_kind {cfg.arch_kind!r}: "
                         f"models.build_model builds an encoder-decoder through models.encdec")
    dt = L.torch_dtype(cfg)
    n_groups, rest = _pattern_layout(cfg)
    tree: Dict = {
        "embed": {"table": leaf(normal(gen, (cfg.vocab_size, cfg.d_model), dt),
                                "vocab", "embed")},
        "final_norm": L.init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": leaf(normal(gen, (cfg.d_model, cfg.vocab_size), dt),
                                     "embed", "vocab")}
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
    # whole over "model" before the splice: a lookup in a vocab-split table
    # is a masked partial sum, which ``torch.cat`` would reduce by its mask's
    # values (none on fake tensors)
    x = constrain(L.embed_lookup(params["embed"]["table"], batch["tokens"]),
                  "batch", "seq", "embed_act")
    if cfg.frontend is not None and "vision_embeds" in batch:
        # the stub frontend's embeddings replace the first n positions
        fe = batch["vision_embeds"].to(x.dtype)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    return constrain(x, "batch", "seq", "embed_act")


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], cfg, x)
    w = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return constrain(L.vocab_logits(x, w), "batch", "seq", "vocab_act")


def _layers(params, cfg: ModelConfig):
    """(params, kind, group index or None, pattern/rest index) in layer order."""
    n_groups, rest = _pattern_layout(cfg)
    for g in range(n_groups):
        for p_idx, kind in enumerate(cfg.block_pattern):
            yield index_tree(params["groups"][p_idx], g), kind, g, p_idx
    for i, kind in enumerate(rest):
        yield params["rest"][i], kind, None, i


def _save_dots(ctx, op, *args, **kwargs):
    """jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims: keep the
    outputs of products without batch dimensions, recompute the rest.
    ``x @ w`` reaches autograd as ``mm``; ``torch.einsum`` makes every
    contraction a ``bmm``, one without batch dimensions a ``bmm`` of batch 1."""
    dot = op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
        op == torch.ops.aten.bmm.default and args[0].shape[0] == 1)
    return CheckpointPolicy.MUST_SAVE if dot else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(policy)


def apply_stack_train(params, cfg: ModelConfig, x, positions, remat_policy: str = "none"):
    """Full forward pass without caches. Returns (x, aux).

    ``remat_policy`` (``"none"``, ``"full"``, ``"dots"``) wraps each
    pattern group's body, as the reference wraps its scan body; the
    ``rest`` layers stay unwrapped."""
    n_groups, rest = _pattern_layout(cfg)

    def group_body(x, g):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p_idx, kind in enumerate(cfg.block_pattern):
            p = index_tree(params["groups"][p_idx], g)
            x, _, a = apply_block(p, cfg, kind, x, positions, None)
            aux = aux + a
        return x, aux

    body = _remat(group_body, remat_policy)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(n_groups):
        x, a = body(x, g)
        aux_total = aux_total + a
    for p, kind in zip(params["rest"], rest):
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


def gold_logits(logits: torch.Tensor, lbl: torch.Tensor) -> torch.Tensor:
    """``logits[..., lbl]``: each position's logit of its label.

    A plain gather on plain tensors.  Under a mesh each rank multiplies its
    slice of the logits by the matching slice of the labels' one-hot mask
    and sums it: where the vocab dimension is split, DTensor's gather keeps
    a masked partial result that no longer fits once the gathered dimension
    is dropped (the product is a partial sum over the axis, reduced where
    it is used), and where it is whole, the gather's backward scatters into
    zeros of the logits' global shape, a whole microbatch's float32 logits
    on every rank.  Exactly one term of the sum is not zero, so both give
    the same value, bit for bit; the mask and the product cost two tensors
    of the local logits' size.
    """
    v = logits.ndim - 1
    if not is_distributed(logits):
        return torch.gather(logits, -1, lbl[..., None])[..., 0]
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = logits.device_mesh
    vocab = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.to_local().device), mesh,
        [Shard(0) if p.is_shard(v) else Replicate() for p in logits.placements],
        src_data_rank=None)
    return (logits * (lbl[..., None] == vocab)).sum(-1)


def lm_loss(params, cfg: ModelConfig, batch: Dict, remat_policy: str = "none"):
    """Next-token CE over ``labels`` (mask: labels < 0) plus the z-loss
    ``1e-4 * mean(lse^2)`` and ``1e-2 * aux``.  Returns (loss, metrics).

    ``remat_policy``: ``"none"`` keeps every activation, ``"full"``
    recomputes each pattern group in backward, ``"dots"`` keeps only the
    outputs of its plain matrix products (``apply_stack_train``).
    """
    params = L.gathered_table(params)
    x = _embed(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = apply_stack_train(params, cfg, x, positions, remat_policy)
    logits = _logits(params, cfg, x).float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lbl = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = gold_logits(logits, lbl)
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
    x = _embed(L.gathered_table(params), cfg, {"tokens": token[:, None]})
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    x, cache = apply_stack_cached(params, cfg, x, positions, cache)
    return _logits(params, cfg, x)[:, 0], cache
