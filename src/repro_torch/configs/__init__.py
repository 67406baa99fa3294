"""Architecture registry: one module per assigned architecture (counterpart
of ``repro/configs/__init__.py``)."""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "zamba2_1p2b",
    "musicgen_large",
    "xlstm_350m",
    "tinyllama_1p1b",
    "stablelm_1p6b",
    "h2o_danube_1p8b",
    "minicpm_2b",
    "llama32_vision_90b",
    "dbrx_132b",
    "llama4_maverick_400b",
]

# canonical external names -> module names
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-large": "musicgen_large",
    "xlstm-350m": "xlstm_350m",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "stablelm-1.6b": "stablelm_1p6b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "minicpm-2b": "minicpm_2b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
}


def get_config(arch: str):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
