"""Carry bucket specs across from the JAX package.

The JAX package's specs are frozen dataclasses with the same class names
and fields as the port's. :func:`spec_from_fields` rebuilds the port's spec
from a class name and a field dictionary, such as ``type(s).__name__`` and
``dataclasses.asdict(s)`` of a JAX spec, so that the tests and
``chip_smoke.py`` hand both packages the same spec. This module imports
nothing of the JAX package: it reads only plain values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core import identifiers as _id

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
