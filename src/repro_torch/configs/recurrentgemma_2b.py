"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attn, 1:2. [arXiv:2402.19427; hf]

Griffin pattern: (recurrent, recurrent, local-attention) repeating;
26 layers = 8 full patterns + 2 trailing recurrent layers.  Local
attention window 2048, MQA (kv=1).  Sub-quadratic -> long_500k runs.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    norm_kind="rmsnorm",
    mlp_kind="geglu",
    block_pattern=("rglru", "rglru", "local"),
    d_rnn=2560,
    conv_width=4,
    tie_embeddings=True,
)
