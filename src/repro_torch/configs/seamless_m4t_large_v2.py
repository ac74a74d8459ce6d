"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal. [arXiv:2308.11596; hf]

Interpreted as 24 layers per stack (24 encoder + 24 decoder), matching
the HF checkpoint layout.  The speech frontend (conformer feature
extractor) is a STUB: ``input_specs`` provides precomputed frame
embeddings (B, S_enc, d_model) as encoder input.  Decode shapes lower
the decoder step; long_500k skipped (full self+cross attention).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,            # decoder layers
    n_enc_layers=24,        # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    norm_kind="layernorm",
    mlp_kind="gelu",
    arch_kind="encdec",
    frontend="audio_stub",
    block_pattern=("attn",),
)
