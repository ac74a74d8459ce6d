"""xlstm-350m [ssm]: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304
— sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

xLSTM[7:1]: seven mLSTM blocks per sLSTM block; d_ff=0 — the blocks
integrate their own up/down projections.  Attention-free ->
long_500k runs with O(1) state.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm_kind="layernorm",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    d_rnn=2048,          # 2x up-projection inside the blocks
    conv_width=4,
    tie_embeddings=True,
)
