"""internvl2-76b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + (Llama3-70B-style) LM backbone.
[arXiv:2404.16821; unverified]

The InternViT vision frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (B, n_frontend_tokens, d_model) that
replace the first positions of the sequence.  Full attention ->
long_500k skipped.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    block_pattern=("attn",),
    frontend="vision_stub",
    n_frontend_tokens=256,
)
