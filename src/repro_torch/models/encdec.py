"""Encoder-decoder assembly (seamless-m4t-large-v2 backbone).

The counterpart of ``repro.models.encdec``: a bidirectional encoder over
stub frame embeddings (``batch["enc_embeds"]``, (B, S_enc, d_model); the
speech frontend is out of scope, as in the reference) and a causal
decoder with per-layer cross-attention over encoder K/V.  As in the
reference, ``enc_blocks`` and ``dec_blocks`` are stacked along a leading
layer axis and the LM head is untied; where the reference scans over the
stacks, the port loops in Python.

Serving computes the cross-attention memories once, in the prefill, and
hands them to every decode step: ``encdec_prefill`` returns
``(last_logits, cache, memories)`` and ``encdec_decode_step`` takes the
memories.  Training (``encdec_loss``) recomputes each layer's memory
inside the rematerialised body, as the reference does.  Attention over
more than ``layers.BLOCKWISE_KV_THRESHOLD`` encoder frames (the
encoder's self-attention and every cross-attention) goes to
``ops.flash_attention``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import axes as AX
from repro_torch.distributed import partitioning as PT
from repro_torch.distributed.axes import constrain
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import _remat, gold_logits
from repro_torch.models.param_util import index_tree, leaf, normal, stack_trees

# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig, dt) -> Dict:
    return {
        "norm1": L.init_norm(cfg, gen.device),
        "attn": L.init_attention(gen, cfg, dt),
        "norm2": L.init_norm(cfg, gen.device),
        "mlp": L.init_mlp(gen, cfg, dt),
    }


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig, dt) -> Dict:
    return {
        "norm1": L.init_norm(cfg, gen.device),
        "self": L.init_attention(gen, cfg, dt),
        "norm_x": L.init_norm(cfg, gen.device),
        "cross": L.init_attention(gen, cfg, dt, cross=True),
        "norm2": L.init_norm(cfg, gen.device),
        "mlp": L.init_mlp(gen, cfg, dt),
    }


def _apply_enc_block(p, cfg: ModelConfig, x, positions):
    h = L.apply_norm(p["norm1"], cfg, x)
    y, _ = L.apply_attention(p["attn"], cfg, h, positions, causal=False)
    x = constrain(x + y, "batch", None, "embed_act")     # whole before the norm (lm.apply_block)
    h = L.apply_norm(p["norm2"], cfg, x)
    return constrain(x + L.apply_mlp(p["mlp"], cfg, h), "batch", None, "embed_act")


def _apply_dec_block(p, cfg: ModelConfig, x, positions, memory_kv, cache):
    h = L.apply_norm(p["norm1"], cfg, x)
    y, new_cache = L.apply_attention(p["self"], cfg, h, positions, cache=cache)
    x = constrain(x + y, "batch", None, "embed_act")     # whole before the norm (lm.apply_block)
    h = L.apply_norm(p["norm_x"], cfg, x)
    x = constrain(x + L.apply_cross_attention(p["cross"], cfg, h, memory_kv),
                  "batch", None, "embed_act")
    h = L.apply_norm(p["norm2"], cfg, x)
    return constrain(x + L.apply_mlp(p["mlp"], cfg, h), "batch", None, "embed_act"), new_cache


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def init_encdec(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Random parameters on ``gen``'s device, drawn from ``gen``."""
    dt = L.torch_dtype(cfg)
    return {
        "embed": {"table": leaf(normal(gen, (cfg.vocab_size, cfg.d_model), dt),
                                "vocab", "embed")},
        "enc_blocks": stack_trees([_init_enc_block(gen, cfg, dt)
                                   for _ in range(cfg.n_enc_layers)]),
        "enc_norm": L.init_norm(cfg, gen.device),
        "dec_blocks": stack_trees([_init_dec_block(gen, cfg, dt) for _ in range(cfg.n_layers)]),
        "final_norm": L.init_norm(cfg, gen.device),
        "lm_head": {"w": leaf(normal(gen, (cfg.d_model, cfg.vocab_size), dt),
                              "embed", "vocab")},
    }


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
           remat_policy: str = "none") -> torch.Tensor:
    """enc_embeds: (B, S_enc, D) stub frontend output, cast to the model's
    dtype.  ``remat_policy`` wraps each encoder layer (``lm._remat``)."""
    x = constrain(enc_embeds.to(L.torch_dtype(cfg)), "batch", None, "embed_act")
    positions = torch.arange(x.shape[1], device=x.device)
    body = _remat(lambda x, i: _apply_enc_block(index_tree(params["enc_blocks"], i), cfg, x,
                                                positions), remat_policy)
    for i in range(cfg.n_enc_layers):
        x = body(x, i)
    return L.apply_norm(params["enc_norm"], cfg, x)


def cross_memories(params, cfg: ModelConfig,
                   enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention (K, V) of ``enc_out``, each
    (n_dec, B, Hkv, S_enc, Dh), contiguous: layer i's memory is the
    view ``K[i]``, ``V[i]``.  Each layer's projection is written into the
    stacks as it is made, so no second copy of the stacks is ever held.

    Under a mesh (a DTensor ``enc_out``) the stacks are DTensors placed by
    the active rules' memories axes (``partitioning.memories_axes_for``:
    split as the cache's kv heads and batch are), each rank writing its
    own slices of every layer into one local stack."""
    B, S = enc_out.shape[:2]
    wk = params["dec_blocks"]["cross"]["wk"]
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    dt = torch.promote_types(enc_out.dtype, wk.dtype)
    placed = None
    if PT.is_distributed(enc_out):
        from torch.distributed.tensor import DTensor, Shard

        mesh = enc_out.device_mesh
        names = PT.memories_axes_for((torch.empty(shape, device="meta"),))[0]
        placed = PT.placements_for(mesh, PT.spec_for(mesh, AX.current_rules() or {}, names,
                                                     shape))
        # a layer's placements: the stack's one dimension down ("layers"
        # is never split)
        layer = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in placed)
    k = v = None
    for i in range(cfg.n_layers):
        ki, vi = L.cross_attention_memory(index_tree(params["dec_blocks"], i)["cross"], cfg,
                                          enc_out)
        if placed is not None:
            ki, vi = (t.redistribute(mesh, layer).to_local() for t in (ki, vi))
        if k is None:
            k = torch.empty((cfg.n_layers,) + tuple(ki.shape), dtype=dt, device=ki.device)
            v = torch.empty_like(k)
        k[i].copy_(ki)
        v[i].copy_(vi)
    if placed is not None:
        k, v = (DTensor.from_local(t, mesh, placed, run_check=False) for t in (k, v))
    return k, v


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return L.vocab_logits(L.apply_norm(params["final_norm"], cfg, x), params["lm_head"]["w"])


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
                 remat_policy: str = "none") -> torch.Tensor:
    """Teacher-forced decoder logits (B, T, vocab) over ``enc_out``; each
    layer's memory is recomputed inside its (rematerialised) body."""
    # whole over "model" (a lookup in a vocab-split table is a partial sum)
    x = constrain(L.embed_lookup(params["embed"]["table"], tokens), "batch", None, "embed_act")
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, enc_out, i):
        p = index_tree(params["dec_blocks"], i)
        mem = L.cross_attention_memory(p["cross"], cfg, enc_out)
        return _apply_dec_block(p, cfg, x, positions, mem, None)[0]

    body = _remat(body, remat_policy)
    for i in range(cfg.n_layers):
        x = body(x, enc_out, i)
    return _logits(params, cfg, x)


def encdec_loss(params, cfg: ModelConfig, batch: Dict, remat_policy: str = "none"):
    """batch: enc_embeds (B, S, D), tokens (B, T), labels (B, T) (mask:
    labels < 0).  Next-token CE plus the z-loss ``1e-4 * mean(lse^2)``;
    returns (loss, metrics)."""
    params = L.gathered_table(params)
    enc_out = encode(params, cfg, batch["enc_embeds"], remat_policy)
    logits = decode_train(params, cfg, batch["tokens"], enc_out, remat_policy)
    logits = constrain(logits, "batch", None, "vocab_act").float()
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lbl = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = gold_logits(logits, lbl)
    denom = mask.sum().clamp_min(1.0)
    loss = ((lse - gold) * mask).sum() / denom
    zloss = 1e-4 * ((lse * mask) ** 2).sum() / denom
    return loss + zloss, {"ce": loss, "zloss": zloss, "tokens": denom}


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    """The decoder's self-attention caches, stacked over its layers."""
    dt = L.torch_dtype(cfg)
    return stack_trees([L.init_kv_cache(cfg, batch, max_len, dt, device)
                        for _ in range(cfg.n_layers)])


def _decoder_cached(params, cfg: ModelConfig, x, positions, cache, memories):
    k, v = memories
    for i in range(cfg.n_layers):
        # the self-attention writes its cache entry in place, through the view
        x, _ = _apply_dec_block(index_tree(params["dec_blocks"], i), cfg, x, positions,
                                (k[i], v[i]), index_tree(cache, i))
    return x


def encdec_prefill(params, cfg: ModelConfig, batch: Dict, cache):
    """Encode, compute the memories, run the decoder prompt; returns
    (last_logits, cache, memories).  The cache is updated in place."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    memories = cross_memories(params, cfg, enc_out)
    del enc_out
    x = constrain(L.embed_lookup(params["embed"]["table"], batch["tokens"]),
                  "batch", None, "embed_act")
    positions = torch.arange(x.shape[1], device=x.device)
    x = _decoder_cached(params, cfg, x, positions, cache, memories)
    return _logits(params, cfg, x[:, -1:, :])[:, 0], cache, memories


def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: int, cache,
                       memories):
    """One decoder step. token: (B,) int64; pos: absolute position;
    ``memories``: what the prefill returned."""
    x = constrain(L.embed_lookup(L.gathered_table(params)["embed"]["table"], token[:, None]),
                  "batch", None, "embed_act")
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    x = _decoder_cached(params, cfg, x, positions, cache, memories)
    return _logits(params, cfg, x)[:, 0], cache
