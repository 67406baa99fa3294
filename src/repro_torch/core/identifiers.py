"""Bucket specs (paper §3.1, §6 "Bucket identification"): declarative,
value-hashable descriptions of the function that puts a key in a bucket.

Counterpart of ``repro/core/identifiers.py``. Every spec is a frozen
dataclass, so two ``delta_buckets(32)`` calls give EQUAL specs and a plan or
kernel-parameter cache keyed on a spec hits by value. ``emit`` is plain
vectorised torch and gives int32 bucket ids bitwise equal to the JAX
package's; the CUDA kernels evaluate the same functions in-register
(``kernels/csrc/multisplit_common.cuh``), so the label array never exists
on the device for the declarative specs. :class:`CallableSpec` is the
escape hatch for arbitrary functions and is the only spec that is not
``fusable``.

Key arithmetic follows the JAX package's promotion rules exactly:

* integer keys are carried as int64, which holds every int32 and uint32
  value (PyTorch on the CPU has no ``>>`` or ``<`` for uint32);
* a float key converted to an integer saturates, and NaN becomes 0 (what
  XLA's ``convert`` and CUDA's ``cvt.rzi`` both do);
* float arithmetic (EvenSpec, float-plane RangeSpec) runs in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def is_unsigned(dtype: torch.dtype) -> bool:
    return dtype in _UNSIGNED


def is_integer(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool


def itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bits_dtype(dtype: torch.dtype) -> torch.dtype:
    """The signed integer type of the same width: data movement (padding,
    scatter, gather) runs on bit-pattern views of this type, which every
    PyTorch indexing op supports."""
    return {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[itemsize(dtype)]


def as_int64(keys: Tensor) -> Tensor:
    """Integer keys as exact int64 values (uint32 up to 2^32 - 1 included)."""
    return keys.to(torch.int64)


def _float_to_int(x: Tensor, lo: int, hi: int) -> Tensor:
    """Saturating float -> integer conversion toward zero, NaN -> 0: XLA's
    ``convert`` and CUDA's ``__float2uint_rz``/``__float2int_rz``. (A plain
    ``.to(int64)`` is undefined out of range.)"""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return torch.trunc(x).clamp(lo, hi).to(torch.int64)


def as_u32(keys: Tensor) -> Tensor:
    """``keys.astype(uint32)`` as int64 values in [0, 2^32): integers wrap
    to their low 32 bits, floats convert by value."""
    if keys.dtype.is_floating_point:
        return _float_to_int(keys, 0, (1 << 32) - 1)
    return as_int64(keys) & 0xFFFFFFFF


def as_i32(keys: Tensor) -> Tensor:
    """``keys.astype(int32)``: integers wrap, floats convert by value."""
    if keys.dtype.is_floating_point:
        return _float_to_int(keys, -(1 << 31), (1 << 31) - 1).to(torch.int32)
    u = as_int64(keys) & 0xFFFFFFFF
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def as_float32(keys: Tensor) -> Tensor:
    """Keys converted by value to float32 (float keys keep their type when
    wider)."""
    if keys.dtype.is_floating_point:
        return keys if itemsize(keys.dtype) >= 4 else keys.to(torch.float32)
    return as_int64(keys).to(torch.float32)


class BucketSpec:
    """Base class: a declarative bucket identifier ``emit(keys) -> ids``.

    ``fusable`` marks specs the CUDA kernels evaluate in-register;
    :meth:`pad_key` returns a key whose bucket is ``num_buckets - 1``
    (layout pads ride in the last bucket and are cut off the tail)."""

    fusable: bool = True

    def emit(self, keys: Tensor) -> Tensor:
        """int32 bucket ids in ``[0, num_buckets)``; shape-preserving."""
        raise NotImplementedError

    def pad_key(self, dtype: torch.dtype):
        """The dtype maximum (every spec here is monotone and clamps its
        top bucket)."""
        if is_unsigned(dtype):
            return (1 << (8 * itemsize(dtype))) - 1
        if dtype.is_floating_point:
            return float(torch.finfo(dtype).max)
        return int(torch.iinfo(dtype).max)

    def __call__(self, keys: Tensor) -> Tensor:
        return self.emit(keys)


@dataclasses.dataclass(frozen=True)
class DeltaSpec(BucketSpec):
    """Equal-width buckets: ``f(u) = min(u // delta, m - 1)`` over the keys
    as uint32 (paper §6)."""

    num_buckets: int
    key_max: int = 2**30

    @property
    def delta(self) -> int:
        return max(1, self.key_max // self.num_buckets)

    def emit(self, keys: Tensor) -> Tensor:
        ids = torch.div(as_u32(keys), self.delta, rounding_mode="floor")
        return ids.clamp(max=self.num_buckets - 1).to(torch.int32)

    def pad_key(self, dtype: torch.dtype):
        """For signed integer keys the all-ones key (-1), the largest key as
        uint32, so the pad lands in bucket m-1 for every ``key_max``. The
        JAX package pads them with the signed maximum, whose bucket is below
        m-1 once ``key_max`` exceeds about 2^31 (ROADMAP §C)."""
        if is_integer(dtype) and not is_unsigned(dtype):
            return -1
        return super().pad_key(dtype)

    @property
    def name(self) -> str:
        return f"delta{self.num_buckets}"


@dataclasses.dataclass(frozen=True)
class IdentitySpec(BucketSpec):
    """Keys are already bucket ids: ``f(u) = u`` (paper §7.1). Keys must lie
    in ``[0, num_buckets)``."""

    num_buckets: int

    def emit(self, keys: Tensor) -> Tensor:
        return as_i32(keys)

    def pad_key(self, dtype: torch.dtype):
        return self.num_buckets - 1                # all-ones would leave range

    @property
    def name(self) -> str:
        return f"identity{self.num_buckets}"


@dataclasses.dataclass(frozen=True)
class BitfieldSpec(BucketSpec):
    """``f(u) = (u >> shift) & (2^bits - 1)``: one LSD radix digit (paper
    §7.1). Its all-ones pad key has digit ``m - 1`` in every pass, which lets
    the chained radix sort pad once."""

    shift: int
    bits: int

    @property
    def num_buckets(self) -> int:
        return 1 << self.bits

    @property
    def mask(self) -> int:
        return (1 << self.bits) - 1

    def emit(self, keys: Tensor) -> Tensor:
        self._check_integer(keys.dtype)
        u = as_int64(keys) & 0xFFFFFFFF
        return ((u >> self.shift) & self.mask).to(torch.int32)

    @staticmethod
    def _check_integer(dtype: torch.dtype) -> None:
        if not is_integer(dtype):
            raise TypeError(
                f"radix digit buckets (BitfieldSpec) require integer keys, got "
                f"{dtype}; bitfield digits of float keys are value conversions, "
                f"not bit patterns: reinterpret the buffer (tensor.view("
                f"torch.uint32)) first"
            )

    def pad_key(self, dtype: torch.dtype):
        """The all-ones bit pattern (not the signed maximum)."""
        self._check_integer(dtype)
        if is_unsigned(dtype):
            return (1 << (8 * itemsize(dtype))) - 1
        return -1

    @property
    def name(self) -> str:
        return f"radix[{self.shift}:{self.shift + self.bits}]"


@dataclasses.dataclass(frozen=True)
class RangeSpec(BucketSpec):
    """Splitter buckets (paper §7.3 "Range Histogram"): key u lands in the
    count of splitters ``<= u``; ``m = len(splitters) + 1``. Splitters are
    sorted at construction and compared in the key dtype."""

    splitters: Tuple

    def __post_init__(self):
        sp = np.asarray(self.splitters)
        if sp.ndim != 1:
            raise ValueError(f"splitters must be 1-D, got shape {sp.shape}")
        if np.isnan(sp.astype(np.float64)).any():
            raise ValueError("splitters must not contain NaN")
        object.__setattr__(self, "splitters", tuple(np.sort(sp).tolist()))

    @property
    def num_buckets(self) -> int:
        return len(self.splitters) + 1

    def compare_plane(self, key_dtype: torch.dtype):
        """(plane, values): integer keys with integral splitters compare in
        the KEY dtype (splitters outside its range are rejected: they would
        make the last bucket unreachable); anything with fractional
        splitters or float keys compares in float (float32 for integer
        keys)."""
        integral = all(float(s) == int(s) for s in self.splitters)
        if is_integer(key_dtype) and integral:
            if is_unsigned(key_dtype):
                lo, hi = 0, (1 << (8 * itemsize(key_dtype))) - 1
            else:
                info = torch.iinfo(key_dtype)
                lo, hi = info.min, info.max
            for s in self.splitters:
                if not lo <= int(s) <= hi:
                    raise ValueError(
                        f"splitter {s} is out of range for {key_dtype} keys "
                        f"[{lo}, {hi}]"
                    )
            return key_dtype, [int(s) for s in self.splitters]
        plane = key_dtype if key_dtype.is_floating_point else torch.float32
        return plane, [float(s) for s in self.splitters]

    def emit(self, keys: Tensor) -> Tensor:
        if not self.splitters:
            return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
        plane, vals = self.compare_plane(keys.dtype)
        if plane.is_floating_point:
            kc = keys.to(plane) if keys.dtype.is_floating_point else as_float32(keys)
            sp = torch.tensor(vals, dtype=plane, device=keys.device)
        else:
            kc = as_int64(keys)
            sp = torch.tensor(vals, dtype=torch.int64, device=keys.device)
        # count of splitters <= key (splitters are sorted)
        ids = torch.searchsorted(sp, kc.reshape(-1).contiguous(), right=True)
        return ids.reshape(keys.shape).to(torch.int32)

    @property
    def name(self) -> str:
        return f"range{self.num_buckets}"


@dataclasses.dataclass(frozen=True)
class EvenSpec(BucketSpec):
    """Evenly spaced float buckets (paper §7.3 "Even Histogram"):
    ``floor((k - lo) / width)`` in float32, clipped, NaN to the last
    bucket."""

    lo: float
    hi: float
    num_buckets: int

    @property
    def width(self) -> float:
        return (self.hi - self.lo) / self.num_buckets

    def emit(self, keys: Tensor) -> Tensor:
        x = as_float32(keys)
        lo = torch.tensor(self.lo, dtype=x.dtype, device=x.device)
        width = torch.tensor(self.width, dtype=x.dtype, device=x.device)
        ids = torch.floor((x - lo) / width)
        ids = ids.clamp(0, self.num_buckets - 1)   # float domain: +inf/fmax pads
        ids = torch.where(torch.isnan(ids), float(self.num_buckets - 1), ids)
        return ids.to(torch.int32)

    @property
    def name(self) -> str:
        return f"even{self.num_buckets}"


@dataclasses.dataclass(frozen=True)
class CallableSpec(BucketSpec):
    """Escape hatch: an arbitrary user function. Not fusable (its labels are
    materialised), hashed by function identity."""

    fn: Callable[[Tensor], Tensor]
    num_buckets: int
    name: str = "custom"

    fusable = False

    def emit(self, keys: Tensor) -> Tensor:
        return self.fn(keys).to(torch.int32)

    def pad_key(self, dtype: torch.dtype):
        raise NotImplementedError(
            f"no pad key exists for the arbitrary bucket function {self.name!r}; "
            "callable specs pad labels (not keys)"
        )


def delta_buckets(num_buckets: int, key_max: int = 2**30) -> DeltaSpec:
    return DeltaSpec(num_buckets, key_max)


def identity_buckets(num_buckets: int) -> IdentitySpec:
    return IdentitySpec(num_buckets)


def radix_buckets(pass_idx: int, radix_bits: int) -> BitfieldSpec:
    return BitfieldSpec(pass_idx * radix_bits, radix_bits)


def range_buckets(splitters) -> RangeSpec:
    return RangeSpec(tuple(np.asarray(splitters).tolist()))


def even_buckets(lo: float, hi: float, num_buckets: int) -> EvenSpec:
    return EvenSpec(float(lo), float(hi), num_buckets)


def from_fn(fn: Callable[[Tensor], Tensor], num_buckets: int, name: str = "user") -> CallableSpec:
    return CallableSpec(fn, num_buckets, name=name)


def as_spec(spec) -> BucketSpec:
    """Coerce a user-supplied identifier into a :class:`BucketSpec`: specs
    pass as they are; a bare callable is wrapped iff it has ``num_buckets``."""
    if isinstance(spec, BucketSpec):
        return spec
    if callable(spec) and hasattr(spec, "num_buckets"):
        return CallableSpec(spec, int(spec.num_buckets))
    raise TypeError(
        f"expected a BucketSpec (see repro_torch.core.identifiers), got {spec!r}"
    )
