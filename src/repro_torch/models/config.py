"""Architecture configuration schema.

One :class:`ModelConfig` instance per assigned architecture lives in
``repro_torch.configs.<id>``; reduced copies (via :meth:`ModelConfig.reduced`)
drive the CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | moe | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None     # default: d_model // n_heads

    # -- attention flavour ---------------------------------------------------
    window: Optional[int] = None     # sliding-window size (SWA / local attn)
    qk_norm: bool = False            # per-head RMSNorm on q,k (qwen3)
    qkv_bias: bool = False           # bias on qkv projections (qwen1.5)
    rope_theta: float = 10_000.0
    softcap: Optional[float] = None

    # -- norms / mlp ----------------------------------------------------------
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    tie_embeddings: bool = False

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # routing-group size: dispatch/combine einsums cost O(group * E * C)
    # per token with C ∝ group, i.e. quadratic in the group — None groups
    # per batch row (group = seq_len, the naive GShard layout); the perf
    # pass re-groups to a few hundred tokens (see EXPERIMENTS.md §Perf).
    moe_group: Optional[int] = None

    # -- layer pattern (cycled; heterogeneous for hybrid/ssm) -------------------
    # entries: "attn" | "local" | "swa" | "rglru" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)
    d_rnn: Optional[int] = None      # RG-LRU / xLSTM state width
    conv_width: int = 4              # temporal conv in recurrent blocks

    # -- topology ----------------------------------------------------------------
    arch_kind: str = "decoder"       # decoder | encdec
    n_enc_layers: int = 0

    # -- modality frontend (STUB: precomputed embeddings via input_specs) --------
    frontend: Optional[str] = None   # None | "vision_stub" | "audio_stub"
    n_frontend_tokens: int = 0       # patches / frames prepended to the sequence

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ derived
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def rnn_width(self) -> int:
        return self.d_rnn if self.d_rnn is not None else self.d_model

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(k in ("rglru", "mlstm", "slstm") for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (no full-attention layer)?"""
        return all(k != "attn" for k in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, dh = self.d_model, self.head_dim
        emb = self.vocab_size * d
        per_layer = {}
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (self.n_heads * dh) * d
        if self.mlp_kind in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.moe:
            mlp = self.n_experts * (3 * d * self.d_ff) + d * self.n_experts
        rnn = self.rnn_width
        rec = 2 * d * rnn + rnn * d + self.conv_width * rnn + 3 * rnn  # griffin-ish
        mls = 2 * d * 2 * rnn + 2 * rnn * d + (3 + 3) * rnn            # mlstm-ish
        total = emb
        n_stacks = (1 if self.arch_kind == "decoder" else 2)
        pattern = self.block_pattern
        for i in range(self.n_layers):
            kind = pattern[i % len(pattern)]
            if kind in ("attn", "local", "swa"):
                total += attn + (mlp if self.d_ff > 0 else 0)
            elif kind == "rglru":
                total += rec + (mlp if self.d_ff > 0 else 0)
            else:
                total += mls
        if self.arch_kind == "encdec":
            # encoder stack + cross attention in decoder
            total += self.n_enc_layers * (attn + mlp)
            total += self.n_layers * attn  # cross-attn
        if not self.tie_embeddings:
            total += self.vocab_size * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.d_ff
        moe_active = self.n_layers * self.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_active

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family copy for CPU smoke tests."""
        shrink = dict(
            n_layers=min(self.n_layers, len(self.block_pattern) + 1),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=96 if self.d_ff > 0 else 0,
            vocab_size=257,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 8) if self.window else None,
            d_rnn=64 if self.d_rnn else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 4),
            dtype="float32",
        )
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)
