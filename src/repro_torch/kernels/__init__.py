"""Hopper kernels of the multisplit pipeline (CUDA C++ in ``csrc/``, built
at first use by :mod:`repro_torch.kernels.build`) and their plain PyTorch
versions. Importing this package builds nothing and needs no card."""
