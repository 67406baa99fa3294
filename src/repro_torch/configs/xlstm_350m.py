"""xlstm-350m [ssm]: alternating mLSTM / sLSTM blocks (arXiv:2405.04517).
24L d_model=1024 4H (kv=4) d_ff=0 (feed-forward lives inside the blocks)
vocab=50304. Pattern: (mLSTM, sLSTM) x 12."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    norm="layernorm",
    slstm_every=2,
)
