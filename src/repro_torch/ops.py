"""repro_torch.ops — the public API of the PyTorch port (counterpart of
``repro/ops.py:90-389``).

Every op takes the JAX package's arguments plus ``device``: inputs (tensors
or numpy arrays) are placed on ``device``, ``"cuda"`` by default, and run
on ``backend``, ``"cuda"`` by default: the hand-written Hopper kernels.
Tests pass ``device="cpu"``, where the cuda backend's kernel wrappers run
their plain versions. Nothing looks for a card and carries on without one:
on a machine without CUDA the default device fails where torch does.

The flat ops are transform-native, as the JAX package's are:

* ``torch.vmap`` — :func:`multisplit`, :func:`multisplit_key_value` and
  :func:`histogram` run through :class:`torch.autograd.Function` s whose
  ``vmap`` rule resolves the batched plan (``make_batched_plan``): the whole
  batch is ONE launch a stage, bitwise equal to the per-row loop. An input
  that is not batched is broadcast over the batch. The Functions return
  tensors only (a ``counts_only`` call has no keys) and the
  :class:`MultisplitResult` is rebuilt outside them. ``torch.vmap`` refuses
  None outputs under an ``out_dims`` of 0, so a call that leaves fields
  None takes :func:`vmap_out_dims` as its ``out_dims``.
* ``grad`` — the key-value op's backward is the inverse gather of the
  forward permutation, ``d_in[i] = ct_out[perm[i]]``, written with
  ``gather`` so that ``torch.func.grad`` and ``vmap`` of it batch it; the
  key-value :func:`segmented_multisplit` gathers by the global destination
  ``perm[i] + starts[seg[i]]``.

:func:`radix_sort` takes ``(b, n)`` keys and sorts every row. Plans are
cached per
(spec, shape, config); declarative specs hash by value, so the cache is
exact. A :class:`CallableSpec` (``from_fn``: a programmer's bucket
function) runs on the keys' device, its int32 labels go to the ids-strip
kernels, and its plan is never cached. :func:`set_autotune` arms the
autotuner (``core/pipeline/autotune.py``): a plan cache miss then times the
tile and family candidates on the card once and keeps the winner on disk.
The JAX package's ``set_strict`` and ``set_verify`` come with the
resilience layer (ROADMAP A10).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import sort as _sort
from repro_torch.core.identifiers import (
    BitfieldSpec,
    BucketIdentifier,
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
    make_batched_plan,
    make_plan,
    segment_ids_from_starts,
    set_autotune,
)
from repro_torch.core.pipeline.tiles import on_clear

Tensor = torch.Tensor

__all__ = [
    "BucketSpec", "BitfieldSpec", "CallableSpec", "DeltaSpec", "EvenSpec",
    "IdentitySpec", "RangeSpec", "BucketIdentifier",
    "as_spec", "delta_buckets", "even_buckets", "from_fn",
    "identity_buckets", "radix_buckets", "range_buckets",
    "MultisplitResult",
    "multisplit", "multisplit_key_value", "segmented_multisplit", "histogram",
    "radix_sort", "segmented_radix_sort",
    "set_autotune",
    "vmap_out_dims",
]


def _place(x, device) -> Optional[Tensor]:
    """A tensor or numpy array on ``device`` (no copy when it is there)."""
    if x is None:
        return None
    return torch.as_tensor(x).to(device)


def _check_flat(keys: Tensor, what: str, batch_with_vmap: bool = True) -> None:
    if keys.dim() != 1:
        hint = (f"; batch with torch.vmap({what}): it dispatches to ONE batched-plan launch"
                if batch_with_vmap else "")
        raise ValueError(f"{what} takes rank-1 keys (got shape {tuple(keys.shape)}){hint}")


_plan_cached = functools.lru_cache(maxsize=512)(make_plan)
_batched_plan_cached = functools.lru_cache(maxsize=512)(make_batched_plan)
# the cached plans hold resolved tiles: clear_tile_cache drops them too
on_clear(_plan_cached.cache_clear)
on_clear(_batched_plan_cached.cache_clear)


def _plan(spec: BucketSpec, n: int, **kw) -> MultisplitPlan:
    # CallableSpec hashes by function identity: caching it would miss for
    # per-call closures and pin them for the life of the process.
    build = make_plan if isinstance(spec, CallableSpec) else _plan_cached
    return build(n, spec.num_buckets, bucket_fn=spec, **kw)


def _batched(plan: MultisplitPlan, b: int) -> MultisplitPlan:
    """The vmap rule's plan: ``plan`` over ``b`` rows, with its resolved
    tile and family."""
    build = make_batched_plan if isinstance(plan.bucket_fn, CallableSpec) else _batched_plan_cached
    return build(b, plan.n, plan.num_buckets, method=plan.method, key_value=plan.key_value,
                 backend=plan.backend, tile=plan.tile, bucket_fn=plan.bucket_fn,
                 mode=plan.mode, family=plan.family)


def _batch_first(x: Tensor, in_dim: Optional[int], b: int) -> Tensor:
    """A vmap rule's input with its batch axis first; an unbatched input is
    broadcast over the batch."""
    return x.expand(b, *x.shape) if in_dim is None else x.movedim(in_dim, 0)


def _tensors(res: MultisplitResult) -> Tuple[Tensor, ...]:
    """The fields a plan computed, in order (a Function returns tensors)."""
    return tuple(t for t in res if t is not None)


def vmap_out_dims(mode: str = "reorder", key_value: bool = False) -> MultisplitResult:
    """The ``out_dims`` of ``torch.vmap`` over :func:`multisplit` in
    ``mode``: 0 for every field the call returns, None for the fields it
    leaves None (the values of a key-only call, the keys of a partial
    mode), which ``torch.vmap`` refuses under an ``out_dims`` of 0.
    ``torch.vmap(ops.multisplit, in_dims=(0, None),
    out_dims=ops.vmap_out_dims())(keys, spec)``; a key-value call and
    :func:`histogram` need none."""
    return MultisplitResult(0 if mode == "reorder" else None, 0 if key_value else None, 0, 0,
                            None if mode == "counts_only" else 0)


def _result(plan: MultisplitPlan, outs: Tuple[Tensor, ...]) -> MultisplitResult:
    """The inverse of :func:`_tensors` for ``plan``'s mode."""
    it = iter(outs)
    return MultisplitResult(*(None if d is None else next(it)
                              for d in vmap_out_dims(plan.mode, plan.key_value)))


class _Multisplit(torch.autograd.Function):
    """The key-only op: the flat plan, or under ``torch.vmap`` the batched
    plan, one launch a stage for the whole batch. Its outputs take no
    gradient."""

    @staticmethod
    def forward(keys, plan):
        return _tensors(plan(keys))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def vmap(info, in_dims, keys, plan):
        outs = _tensors(_batched(plan, info.batch_size)(_batch_first(keys, in_dims[0],
                                                                     info.batch_size)))
        return outs, (0,) * len(outs)


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
    bits wide on the cuda backend (their labels are materialised).
    ``torch.vmap(ops.multisplit)`` runs the whole batch as ONE batched-plan
    launch a stage, bitwise equal to the per-row loop (its ``out_dims``:
    :func:`vmap_out_dims`)."""
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
    return _result(plan, _Multisplit.apply(keys, plan))


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
    """Forward: the key-value plan, or under ``torch.vmap`` the batched
    plan. Backward: the inverse gather of the forward permutation
    (``out[perm[i]] = in[i]`` gives ``d_in[i] = d_out[perm[i]]``) — one
    gather an operand, no scatter, which ``vmap`` batches."""

    @staticmethod
    def forward(keys, values, plan):
        return _tensors(plan(keys, values))

    @staticmethod
    def setup_context(ctx, inputs, output):
        keys_out, values_out, starts, counts, perm = output
        ctx.save_for_backward(perm)
        ctx.mark_non_differentiable(
            *[t for t in (keys_out, values_out) if not t.is_floating_point()],
            starts, counts, perm,
        )

    @staticmethod
    def backward(ctx, d_keys, d_values, *_):
        (perm,) = ctx.saved_tensors
        idx = perm.long()
        d_in_keys = d_keys.gather(-1, idx) if ctx.needs_input_grad[0] else None
        d_in_values = d_values.gather(-1, idx) if ctx.needs_input_grad[1] else None
        return d_in_keys, d_in_values, None

    @staticmethod
    def vmap(info, in_dims, keys, values, plan):
        b = info.batch_size
        outs = _tensors(_batched(plan, b)(_batch_first(keys, in_dims[0], b),
                                          _batch_first(values, in_dims[1], b)))
        return outs, (0,) * len(outs)


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
    permutation. ``torch.vmap`` of this op, with or without
    ``torch.func.grad``, runs ONE batched-plan launch a stage."""
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
    _check_flat(keys, "ops.segmented_multisplit", batch_with_vmap=False)
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
    pipeline — {prescan, reduce}, no scan, no scatter. ``torch.vmap`` of it
    counts every row in one launch."""
    keys = _place(keys, device)
    _check_flat(keys, "ops.histogram")
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
    fuse_digits: bool = False,
    device="cuda",
) -> Tuple[Tensor, Optional[Tensor]]:
    """Stable LSD radix sort of integer keys (and values) from chained
    multisplit passes (paper §7.1). ``fuse_digits=True`` sorts two digits a
    sweep (the fused two-digit kernels on ``cuda``), bitwise equal.
    ``(b, n)`` keys sort every row on its own, one launch a stage for all
    rows."""
    return _sort.radix_sort(
        keys, values, radix_bits=radix_bits, key_bits=key_bits, method=method,
        backend=backend, tile=tile, family=family, fuse_digits=fuse_digits, device=device,
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
    fuse_digits: bool = False,
    device="cuda",
) -> Tuple[Tensor, Optional[Tensor]]:
    """Stable LSD radix sort of every ragged segment of flat integer keys
    (and values) on its own, in one chained sequence of segmented passes.
    ``segment_starts`` is checked as in :func:`segmented_multisplit`;
    ``fuse_digits`` as in :func:`radix_sort`."""
    keys = _place(keys, device)
    _check_flat(keys, "ops.segmented_radix_sort", batch_with_vmap=False)
    return _sort.segmented_radix_sort(
        keys, _segment_starts(segment_starts, keys.shape[0], keys.device),
        values, radix_bits=radix_bits, key_bits=key_bits, method=method,
        backend=backend, tile=tile, family=family, fuse_digits=fuse_digits,
        device=keys.device,
    )
