"""Carry bucket specs, arrays, model configs and parameter trees across
from the JAX package.

The JAX package's specs are frozen dataclasses with the same class names
and fields as the port's. :func:`spec_from_fields` rebuilds the port's spec
from a class name and a field dictionary, such as ``type(s).__name__`` and
``dataclasses.asdict(s)`` of a JAX spec, so that the tests and
``chip_smoke.py`` hand both packages the same spec. :func:`tensor_from_numpy`
carries an array, ``np.asarray`` of a JAX array, into a tensor bit for bit.
:func:`convert_config` reads a JAX ``ModelConfig`` field by field into the
port's, :func:`params_from_numpy` carries a parameter tree of numpy
arrays (``jax.tree.map(np.asarray, params)``) into the port's tree on a
device, bit for bit, and :func:`train_state_from_numpy` a whole train state
(params, the AdamW moments and step, the float32 master) likewise. This module imports nothing of the JAX package: it
reads only plain values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.core import identifiers as _id
from repro_torch.parallel.sharding import tree_map

_KINDS = {
    "DeltaSpec": _id.DeltaSpec,
    "IdentitySpec": _id.IdentitySpec,
    "BitfieldSpec": _id.BitfieldSpec,
    "RangeSpec": _id.RangeSpec,
    "EvenSpec": _id.EvenSpec,
}


def spec_from_fields(kind: str, fields: Mapping[str, Any]) -> _id.BucketSpec:
    """The port's spec of class ``kind`` with the given field values.
    Callable specs hold a function of the other framework and cannot cross."""
    cls = _KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"no declarative port spec named {kind!r}; expected one of {sorted(_KINDS)}"
        )
    return cls(**dict(fields))


def convert_spec(spec) -> _id.BucketSpec:
    """The port's counterpart of any dataclass spec (a JAX spec included),
    read by class name and fields."""
    return spec_from_fields(type(spec).__name__, dataclasses.asdict(spec))


def tensor_from_numpy(a: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
    """A tensor with the bits of ``a``, on ``device`` (the CPU if None).
    bfloat16, which numpy knows only through an extension type, is read by
    its dtype's name and carried as its 16-bit words."""
    a = np.array(a, order="C")           # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if device is None else t.to(device)


def convert_config(cfg) -> ModelConfig:
    """The port's counterpart of a ``ModelConfig`` (a JAX one included), read
    by its fields; its nested MoE and SSM configs likewise."""
    fields = dataclasses.asdict(cfg)
    return ModelConfig(**{**fields, "moe": MoEConfig(**fields["moe"]),
                          "ssm": SSMConfig(**fields["ssm"])})


def params_from_numpy(tree, device: Optional[torch.device] = None):
    """A parameter tree of numpy arrays (nested dicts and lists, as the JAX
    package's) as the port's tree of tensors on ``device``, bit for bit."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def train_state_from_numpy(state, device: Optional[torch.device] = None):
    """A train state of numpy arrays (``jax.tree.map(np.asarray, state)`` of
    a JAX ``TrainState``, read by its field names) as the port's
    :class:`repro_torch.launch.steps.TrainState` on ``device``, bit for
    bit; a missing master stays None."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim import AdamWState

    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=AdamWState(step=tensor_from_numpy(np.asarray(opt.step), device),
                       mu=params_from_numpy(opt.mu, device),
                       nu=params_from_numpy(opt.nu, device),
                       master=None if opt.master is None else params_from_numpy(opt.master,
                                                                                 device)))
