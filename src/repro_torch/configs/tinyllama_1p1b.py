"""tinyllama-1.1b [dense]: llama2-architecture small model (arXiv:2401.02385).
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv=4,
    d_ff=5632,
    vocab=32000,
)
