"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention
(arXiv:2401.16818). 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000,
window=4096. The SWA window makes this arch sub-quadratic: it runs the
long_500k decode shape with an O(window) ring-buffer cache."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv=8,
    d_ff=6912,
    vocab=32000,
    window=4096,
)
