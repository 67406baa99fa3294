"""Abstract inputs for every (arch x shape) cell, as ``meta`` tensors
(counterpart of ``repro/launch/input_specs.py``).

The four assigned input shapes:

    train_4k      seq=4,096    global_batch=256   -> train_step
    prefill_32k   seq=32,768   global_batch=32    -> prefill_step
    decode_32k    seq=32,768   global_batch=128   -> decode_step (KV cache of seq)
    long_500k     seq=524,288  global_batch=1     -> decode_step, sub-quadratic archs only

Each stand-in is a tensor on the ``meta`` device with the shape and dtype of
the JAX package's ``ShapeDtypeStruct``: no storage anywhere. The decode
cache is the port's ``models.model.cache_decl``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

Tensor = torch.Tensor

SHAPES: Dict[str, dict] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}


def _meta(shape, dtype) -> Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k only runs on sub-quadratic archs (DESIGN.md §6)."""
    if shape == "long_500k":
        return cfg.is_subquadratic()
    return True


def batch_specs(cfg: ModelConfig, shape: str, with_labels: bool) -> Dict[str, Tensor]:
    info = SHAPES[shape]
    return sized_batch_specs(cfg, info["batch"], info["seq"], with_labels)


def sized_batch_specs(cfg: ModelConfig, b: int, s: int, with_labels: bool) -> Dict[str, Tensor]:
    """:func:`batch_specs` of a batch of ``b`` sequences of ``s``."""
    dt = getattr(torch, cfg.dtype)
    batch: Dict[str, Tensor] = {}
    if cfg.embed_frontend_stub:
        batch["embeds"] = _meta((b, s, cfg.d_model), dt)
    else:
        batch["tokens"] = _meta((b, s), torch.int32)
    if with_labels:
        batch["labels"] = _meta((b, s), torch.int32)
    if cfg.n_vis_tokens:
        batch["vis_embeds"] = _meta((b, cfg.n_vis_tokens, cfg.d_model), dt)
    return batch


def decode_specs(cfg: ModelConfig, shape: str):
    """(cache, token_or_embed, position) abstract args for decode shapes."""
    info = SHAPES[shape]
    return sized_decode_specs(cfg, info["batch"], info["seq"])


def sized_decode_specs(cfg: ModelConfig, b: int, s: int):
    """:func:`decode_specs` of ``b`` rows over a cache of ``s`` positions."""
    cache = M.cache_decl(cfg, b, max_len=s)
    if cfg.embed_frontend_stub:
        token = _meta((b, 1, cfg.d_model), getattr(torch, cfg.dtype))
    else:
        token = _meta((b, 1), torch.int32)
    position = _meta((), torch.int32)
    return cache, token, position


def input_specs(cfg: ModelConfig, shape: str):
    """The complete abstract argument tuple for the cell's step function
    (excluding model/optimizer state, which comes from steps.abstract_state)."""
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        return (batch_specs(cfg, shape, with_labels=True),)
    if kind == "prefill":
        return (batch_specs(cfg, shape, with_labels=False),)
    if kind == "decode":
        return decode_specs(cfg, shape)
    raise ValueError(shape)
