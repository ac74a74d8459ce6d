"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192
vocab=50304 — non-parametric LN. [arXiv:2402.00838; hf]

OLMo: LayerNorm without learnable scale/bias, tied embeddings,
plain-GeLU-free SwiGLU (OLMo uses SwiGLU), full attention (MHA: kv=16).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_kind="nonparam_ln",
    mlp_kind="swiglu",
    tie_embeddings=True,
    block_pattern=("attn",),
)
