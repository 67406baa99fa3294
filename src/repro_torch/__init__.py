"""repro_torch — the PyTorch and CUDA port of the multisplit system.

It sits beside the JAX package ``repro`` and mirrors its paths
(``repro_torch/core/pipeline/spec.py`` is the counterpart of
``repro/core/pipeline/spec.py``). It imports torch and numpy, never JAX and
nothing of ``repro``. Its kernels are hand-written CUDA C++ for Hopper
(``kernels/csrc``), built at first use. The public API is
:mod:`repro_torch.ops`.
"""

__all__ = ["ops"]
