"""zamba2-1.2b [hybrid]: Mamba2 backbone + ONE shared attention block applied
every 6th layer (arXiv:2411.15242). 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000 ssm_state=64. Pattern: (5 mamba + shared_attn) x 6 + 2 mamba."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(state=64, conv=4, headdim=64, expand=2, attn_every=6, shared_attn=True),
)
