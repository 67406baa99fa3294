"""llama-3.2-vision-90b [vlm]: cross-attention image layers every 5th layer
(hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment). 100L
d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The ViT frontend is a
STUB: inputs include precomputed patch embeddings (B, n_vis, d_model)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    n_vis_tokens=256,
)
