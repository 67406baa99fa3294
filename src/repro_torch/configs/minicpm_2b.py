"""minicpm-2b [dense]: llama-like arch trained with the WSD schedule
(arXiv:2404.06395). 40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753.
Tied embeddings; train with TrainConfig(schedule="wsd")."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
)
