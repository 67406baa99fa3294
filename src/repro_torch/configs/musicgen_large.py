"""musicgen-large [audio]: decoder-only transformer over EnCodec tokens
(arXiv:2306.05284). 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend is a STUB: inputs are precomputed frame embeddings
(B, S, d_model); the backbone + LM head over the 2048-codebook vocab are real.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=2048,
    norm="layernorm",
    embed_frontend_stub=True,
)
