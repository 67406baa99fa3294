"""stablelm-1.6b [dense] (hf:stabilityai/stablelm-2-1_6b). 24L d_model=2048
32H (kv=32) d_ff=5632 vocab=100352. LayerNorm + partial rotary (25%)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=5632,
    vocab=100352,
    norm="layernorm",
    rope_pct=0.25,
    rope_theta=10000.0,
)
