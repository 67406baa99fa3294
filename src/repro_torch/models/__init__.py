"""Model-side consumers of the port (counterpart of ``repro/models``): the
MoE routing and block (:mod:`repro_torch.models.moe`), the layers, the
Mamba2 and xLSTM blocks (:mod:`~repro_torch.models.layers`,
:mod:`~repro_torch.models.ssm`, :mod:`~repro_torch.models.xlstm`) and the
model stack of every family (:mod:`~repro_torch.models.model`)."""
