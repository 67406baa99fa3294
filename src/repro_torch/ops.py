"""repro_torch.ops — the public API of the PyTorch port (counterpart of
``repro/ops.py:264-389``, flat layout).

Every op takes the JAX package's arguments plus ``device``: inputs (tensors
or numpy arrays) are placed on ``device``, ``"cuda"`` by default, and run
on ``backend``, ``"cuda"`` by default: the hand-written Hopper kernels.
Tests pass ``device="cpu"``, where the cuda backend's kernel wrappers run
their plain versions. Nothing looks for a card and carries on without one:
on a machine without CUDA the default device fails where torch does.

:func:`multisplit_key_value` is a :class:`torch.autograd.Function`: the
backward of the permutation is its inverse gather, ``d_in[i] =
ct_out[perm[i]]``. Plans are cached per (spec, shape, config); declarative
specs hash by value, so the cache is exact.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import sort as _sort
from repro_torch.core.identifiers import (
    BitfieldSpec,
    BucketSpec,
    CallableSpec,
    DeltaSpec,
    EvenSpec,
    IdentitySpec,
    RangeSpec,
    as_spec,
    delta_buckets,
    even_buckets,
    from_fn,
    identity_buckets,
    radix_buckets,
    range_buckets,
)
from repro_torch.core.pipeline import MultisplitPlan, MultisplitResult, make_plan

Tensor = torch.Tensor

__all__ = [
    "BucketSpec", "BitfieldSpec", "CallableSpec", "DeltaSpec", "EvenSpec",
    "IdentitySpec", "RangeSpec",
    "as_spec", "delta_buckets", "even_buckets", "from_fn",
    "identity_buckets", "radix_buckets", "range_buckets",
    "MultisplitResult",
    "multisplit", "multisplit_key_value", "histogram", "radix_sort",
]


def _place(x, device) -> Optional[Tensor]:
    """A tensor or numpy array on ``device`` (no copy when it is there)."""
    if x is None:
        return None
    return torch.as_tensor(x).to(device)


def _check_flat(keys: Tensor, what: str) -> None:
    if keys.dim() != 1:
        raise ValueError(
            f"{what} takes rank-1 keys (got shape {tuple(keys.shape)}); the "
            f"batched layout is ROADMAP queue A item 5"
        )


_plan_cached = functools.lru_cache(maxsize=512)(make_plan)


def _plan(spec: BucketSpec, n: int, **kw) -> MultisplitPlan:
    # CallableSpec hashes by function identity: caching it would miss for
    # per-call closures and pin them for the life of the process.
    build = make_plan if isinstance(spec, CallableSpec) else _plan_cached
    return build(n, spec.num_buckets, bucket_fn=spec, **kw)


def multisplit(
    keys,
    spec: BucketSpec,
    values=None,
    *,
    method: str = "bms",
    backend: str = "cuda",
    tile: Optional[int] = None,
    mode: str = "reorder",
    family: Optional[str] = None,
    device="cuda",
) -> MultisplitResult:
    """Stable multisplit of ``keys`` (and optional ``values``) into the
    buckets of a declarative ``spec`` (paper §3.1). ``mode`` selects a
    partial pipeline (``counts_only`` / ``positions_only``, key-only)."""
    spec = as_spec(spec)
    keys = _place(keys, device)
    _check_flat(keys, "ops.multisplit")
    if values is not None:
        if mode != "reorder":
            raise ValueError(f"mode={mode!r} never touches values")
        return multisplit_key_value(
            keys, values, spec, method=method, backend=backend, tile=tile,
            family=family, device=device,
        )
    plan = _plan(spec, keys.shape[0], method=method, backend=backend, tile=tile,
                 mode=mode, family=family)
    return plan(keys)


class _KeyValueMultisplit(torch.autograd.Function):
    """Forward: the key-value plan. Backward: the inverse gather of the
    forward permutation (``out[perm[i]] = in[i]`` gives ``d_in[i] =
    d_out[perm[i]]``) — one gather an operand, no scatter."""

    @staticmethod
    def forward(ctx, keys, values, plan):
        res = plan(keys, values)
        ctx.save_for_backward(res.permutation)
        ctx.mark_non_differentiable(
            *[t for t in (res.keys, res.values) if not t.is_floating_point()],
            res.bucket_starts, res.bucket_counts, res.permutation,
        )
        return res.keys, res.values, res.bucket_starts, res.bucket_counts, res.permutation

    @staticmethod
    def backward(ctx, d_keys, d_values, *_):
        (perm,) = ctx.saved_tensors
        idx = perm.long()
        d_in_keys = d_keys[idx] if ctx.needs_input_grad[0] else None
        d_in_values = d_values[idx] if ctx.needs_input_grad[1] else None
        return d_in_keys, d_in_values, None


def multisplit_key_value(
    keys,
    values,
    spec: BucketSpec,
    *,
    method: str = "bms",
    backend: str = "cuda",
    tile: Optional[int] = None,
    family: Optional[str] = None,
    device="cuda",
) -> MultisplitResult:
    """Key-value multisplit, differentiable in ``values`` (and in ``keys``
    when they are float): the backward is the inverse gather of the forward
    permutation."""
    spec = as_spec(spec)
    keys, values = _place(keys, device), _place(values, device)
    _check_flat(keys, "ops.multisplit_key_value")
    plan = _plan(spec, keys.shape[0], method=method, key_value=True, backend=backend,
                 tile=tile, family=family)
    return MultisplitResult(*_KeyValueMultisplit.apply(keys, values, plan))


def histogram(
    keys,
    spec: BucketSpec,
    *,
    backend: str = "cuda",
    tile: Optional[int] = None,
    family: Optional[str] = None,
    device="cuda",
) -> Tensor:
    """Device-wide bucket counts (paper §7.3): the ``counts_only`` partial
    pipeline — {prescan, reduce}, no scan, no scatter."""
    return multisplit(
        keys, spec, backend=backend, tile=tile, mode="counts_only", family=family,
        device=device,
    ).bucket_counts


def radix_sort(
    keys,
    values=None,
    *,
    radix_bits: int = 8,
    key_bits: int = 32,
    method: str = "bms",
    backend: str = "cuda",
    tile: Optional[int] = None,
    family: Optional[str] = None,
    device="cuda",
) -> Tuple[Tensor, Optional[Tensor]]:
    """Stable LSD radix sort of integer keys (and values) from chained
    multisplit passes (paper §7.1)."""
    return _sort.radix_sort(
        _place(keys, device), _place(values, device), radix_bits=radix_bits,
        key_bits=key_bits, method=method, backend=backend, tile=tile, family=family,
    )
