"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]

Qwen3 uses an explicit head_dim of 128 (64 x 128 = 8192 > d_model) and
per-head RMSNorm on q/k.  Full attention -> long_500k is skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    block_pattern=("attn",),
)
