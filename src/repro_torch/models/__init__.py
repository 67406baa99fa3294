"""Model-side consumers of the port (counterpart of ``repro/models``): the
MoE routing and block (:mod:`repro_torch.models.moe`), the layers and the
model stack of the dense and MoE families (:mod:`~repro_torch.models.layers`,
:mod:`~repro_torch.models.model`); the other families are ROADMAP A13a."""
