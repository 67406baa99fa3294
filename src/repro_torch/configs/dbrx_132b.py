"""dbrx-132b [moe]: fine-grained MoE, 16 experts top-4
(hf:databricks/dbrx-base). 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352. Every layer is MoE; dispatch = multisplit (the paper's
technique; see repro_torch.models.moe)."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(num_experts=16, top_k=4, every=1, dispatch="multisplit",
                  capacity_factor=1.25),
)
