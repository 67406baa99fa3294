"""Model-side consumers of the port (counterpart of ``repro/models``): so
far the MoE routing functions of :mod:`repro_torch.models.moe`; the model
stack is ROADMAP A13."""
