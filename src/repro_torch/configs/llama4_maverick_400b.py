"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert,
interleaved MoE layers, early-fusion multimodal (text path built here)
(hf:meta-llama/Llama-4 family). 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048. m=128 buckets is the paper's large-m regime; dispatch =
multisplit. bf16 optimizer moments (memory: 400B params on one pod)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv=8,
    d_ff=8192,
    vocab=202048,
    moe=MoEConfig(num_experts=128, top_k=1, every=2, shared_expert=True,
                  dispatch="multisplit", capacity_factor=1.25),
)
