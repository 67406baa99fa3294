"""repro_torch.ops — the public API of the PyTorch port (counterpart of
``repro/ops.py:264-389``, flat and segmented layouts).

Every op takes the JAX package's arguments plus ``device``: inputs (tensors
or numpy arrays) are placed on ``device``, ``"cuda"`` by default, and run
on ``backend``, ``"cuda"`` by default: the hand-written Hopper kernels.
Tests pass ``device="cpu"``, where the cuda backend's kernel wrappers run
their plain versions. Nothing looks for a card and carries on without one:
on a machine without CUDA the default device fails where torch does.

:func:`multisplit_key_value` is a :class:`torch.autograd.Function`: the
backward of the permutation is its inverse gather, ``d_in[i] =
ct_out[perm[i]]``; the key-value :func:`segmented_multisplit` gathers by the
global destination ``perm[i] + starts[seg[i]]``. Plans are cached per
(spec, shape, config); declarative specs hash by value, so the cache is
exact. A :class:`CallableSpec` (``from_fn``: a programmer's bucket
function) runs on the keys' device, its int32 labels go to the ids-strip
kernels, and its plan is never cached.
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
from repro_torch.core import multisplit as _multisplit
from repro_torch.core.pipeline import (
    MultisplitPlan,
    MultisplitResult,
    make_plan,
    segment_ids_from_starts,
)

Tensor = torch.Tensor

__all__ = [
    "BucketSpec", "BitfieldSpec", "CallableSpec", "DeltaSpec", "EvenSpec",
    "IdentitySpec", "RangeSpec",
    "as_spec", "delta_buckets", "even_buckets", "from_fn",
    "identity_buckets", "radix_buckets", "range_buckets",
    "MultisplitResult",
    "multisplit", "multisplit_key_value", "segmented_multisplit", "histogram",
    "radix_sort", "segmented_radix_sort",
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


def _segmented_plan(n: int, s: int, m: int, *, bucket_fn: BucketSpec, **kw) -> MultisplitPlan:
    """:func:`make_segmented_plan`'s signature onto :func:`_plan`'s cache."""
    return _plan(bucket_fn, n, segments=s, **kw)


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
    buckets of ``spec``, declarative or a ``CallableSpec`` (paper §3.1).
    ``mode`` selects a partial pipeline (``counts_only`` /
    ``positions_only``, key-only), which also takes keys that are not 32
    bits wide on the cuda backend (their labels are materialised)."""
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


def _segment_starts(segment_starts, n: int, device) -> Tensor:
    """The (s,) int32 start offsets on ``device``, checked: ``starts[0] ==
    0``, non-decreasing, at most n. The kernels index by segment id, so a
    malformed vector is refused here rather than read out of bounds. The
    check runs where the starts lie: host starts (numpy, as a serving step
    passes them) cost no wait on the device, device starts one."""
    starts = torch.as_tensor(segment_starts)
    if starts.dim() != 1:
        raise ValueError(f"segment_starts must be rank-1, got shape {tuple(starts.shape)}")
    if starts.dtype.is_floating_point or starts.dtype == torch.bool:
        raise ValueError(f"segment_starts must be integers, got {starts.dtype}")
    if starts.numel():
        bad = (starts[0] != 0) | (starts[1:] < starts[:-1]).any() | (starts[-1] > n)
        if bool(bad):
            raise ValueError(
                "segment_starts must start at 0, never decrease and end at most at "
                f"n = {n}; got {starts.tolist() if starts.numel() <= 16 else tuple(starts.shape)}"
            )
    return starts.to(device=device, dtype=torch.int32)


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


class _SegmentedKeyValue(torch.autograd.Function):
    """Forward: the segmented key-value op, ``run``. Backward: the inverse gather
    by the global destination ``perm[i] + starts[seg[i]]`` (the permutation
    itself is segment-local)."""

    @staticmethod
    def forward(ctx, keys, values, starts, run):
        res = run(keys, values=values)
        if any(ctx.needs_input_grad[:2]):
            seg = segment_ids_from_starts(starts, keys.shape[0])
            ctx.save_for_backward(res.permutation + starts.index_select(0, seg))
        ctx.mark_non_differentiable(
            *[t for t in (res.keys, res.values) if not t.is_floating_point()],
            res.bucket_starts, res.bucket_counts, res.permutation,
        )
        return res.keys, res.values, res.bucket_starts, res.bucket_counts, res.permutation

    @staticmethod
    def backward(ctx, d_keys, d_values, *_):
        (dest,) = ctx.saved_tensors
        idx = dest.long()
        d_in_keys = d_keys[idx] if ctx.needs_input_grad[0] else None
        d_in_values = d_values[idx] if ctx.needs_input_grad[1] else None
        return d_in_keys, d_in_values, None, None


def segmented_multisplit(
    keys,
    spec: BucketSpec,
    segment_starts,
    values=None,
    *,
    method: str = "bms",
    backend: str = "cuda",
    tile: Optional[int] = None,
    mode: str = "reorder",
    family: Optional[str] = None,
    device="cuda",
) -> MultisplitResult:
    """Multisplit every ragged segment of flat ``keys`` on its own, in one
    plan launch a stage. ``segment_starts`` is the (s,) start-offset vector:
    ``starts[0] == 0``, non-decreasing, at most n (a ``ValueError``
    otherwise); empty segments are allowed, and ``s == 0`` with empty keys
    returns (0, m) counts. Bitwise equal to a :func:`multisplit` of each
    segment alone; counts, starts and the permutation come back
    segment-local, counts and starts as (s, m). With ``values`` of a float
    dtype (or float keys) the op is differentiable."""
    spec = as_spec(spec)
    keys = _place(keys, device)
    _check_flat(keys, "ops.segmented_multisplit")
    if values is not None and mode != "reorder":
        raise ValueError(f"mode={mode!r} never touches values")
    values = _place(values, device)
    starts = _segment_starts(segment_starts, keys.shape[0], keys.device)
    run = functools.partial(
        _multisplit.segmented_multisplit, bucket_fn=spec, segment_starts=starts,
        method=method, backend=backend, tile=tile, mode=mode, family=family,
        build_plan=_segmented_plan, device=keys.device,
    )
    if values is None:
        return run(keys)
    return MultisplitResult(*_SegmentedKeyValue.apply(keys, values, starts, run))


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
        keys, values, radix_bits=radix_bits, key_bits=key_bits, method=method,
        backend=backend, tile=tile, family=family, device=device,
    )


def segmented_radix_sort(
    keys,
    segment_starts,
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
    """Stable LSD radix sort of every ragged segment of flat integer keys
    (and values) on its own, in one chained sequence of segmented passes.
    ``segment_starts`` is checked as in :func:`segmented_multisplit`."""
    keys = _place(keys, device)
    _check_flat(keys, "ops.segmented_radix_sort")
    return _sort.segmented_radix_sort(
        keys, _segment_starts(segment_starts, keys.shape[0], keys.device),
        values, radix_bits=radix_bits, key_bits=key_bits, method=method,
        backend=backend, tile=tile, family=family, device=keys.device,
    )
