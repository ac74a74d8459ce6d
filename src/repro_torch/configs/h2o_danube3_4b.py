"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA. [arXiv:2401.16818; unverified]

Mistral-style sliding-window attention (window 4096) on every layer.
SWA decode state is O(window), so decode cells use a rolling cache.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    window=4096,
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    mlp_kind="swiglu",
    block_pattern=("swa",),
)
