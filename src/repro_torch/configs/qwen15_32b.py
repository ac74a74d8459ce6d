"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

Qwen1.5: biases on the QKV projections, MHA (kv = heads = 40),
full attention -> long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    block_pattern=("attn",),
)
