"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]

d_ff is per-expert; ~1B active of ~7B total parameters.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    qk_norm=True,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    block_pattern=("attn",),
)
