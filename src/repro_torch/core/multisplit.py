"""The multisplit primitive's execution layer (counterpart of
``repro/core/multisplit.py:82-180, 218-284``), flat and segmented.

:func:`multisplit` resolves a plan for one flat problem and runs it: the
paper's {local prescan} -> {one global scan} -> {local postscan + scatter}
(§4.1), with methods dms / wms / bms. :func:`tile_histogram`,
:func:`prescan`, :func:`postscan_positions` and :func:`multisplit_ref` are
the stage helpers and the eq. (1) oracle the JAX package keeps public.
:func:`segmented_multisplit` multisplits every ragged segment of flat keys
on its own, in one plan launch a stage. The batched layout
(``batched_multisplit``) and the unfused baseline (``multisplit_unfused``)
are ROADMAP queue A item 5. ``repro_torch.ops`` is the public facade over
this module.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.identifiers import BucketSpec
from repro_torch.core.pipeline import (
    MultisplitPlan,
    MultisplitResult,
    direct_solve_ids,
    make_plan,
    make_segmented_plan,
)
from repro_torch.kernels import common as _body

Tensor = torch.Tensor


def tile_histogram(bucket_ids: Tensor, num_buckets: int) -> Tensor:
    """Histogram of one (T,) tile of bucket ids: (m,) int32."""
    return _body.counts_body(bucket_ids.reshape(1, -1), num_buckets)[0]


def multisplit_ref(
    keys: Tensor, bucket_fn: BucketSpec, values: Optional[Tensor] = None
) -> MultisplitResult:
    """O(n·m) direct evaluation of paper eq. (1): the oracle."""
    return direct_solve_ids(keys, bucket_fn(keys).to(torch.int32), bucket_fn.num_buckets, values)


def prescan(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    """Local stage 1: per-tile histograms, H with shape (L, m)."""
    return _body.counts_body(ids_tiled, num_buckets)


def postscan_positions(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    """Local stage 2 (unfused form): each element's destination
    ``G[b] + rank``, eq. (2)."""
    return _body.positions_body(ids_tiled, g, num_buckets)


def multisplit(
    keys,
    bucket_fn: BucketSpec,
    values=None,
    *,
    method: str = "bms",
    tile: Optional[int] = None,
    backend: str = "cuda",
    mode: str = "reorder",
    family: Optional[str] = None,
    device="cuda",
) -> MultisplitResult:
    """Stable multisplit of ``keys`` (and optional ``values``) into the
    buckets of ``bucket_fn``, a declarative spec or a ``CallableSpec`` (a
    programmer's bucket function, which runs on ``device``). Inputs, tensors
    or numpy arrays, are placed on ``device``. ``method``: dms (no tile
    reorder), wms or bms (bucket-major tile reorder); all three give the
    same bits. ``mode``: reorder, counts_only or positions_only (key-only)."""
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    plan = make_plan(
        keys.shape[0], bucket_fn.num_buckets, method=method, key_value=values is not None,
        backend=backend, tile=tile, bucket_fn=bucket_fn, mode=mode, family=family,
    )
    return plan(keys, values)


def _empty_segmented_result(
    keys: Tensor, values: Optional[Tensor], m: int, mode: str
) -> MultisplitResult:
    """The s == 0 result (a step with no requests): (0, m) counts and
    starts and empty data. Zero segments can own no keys."""
    if keys.shape[0] != 0:
        raise ValueError(
            f"segment_starts is empty but keys has {keys.shape[0]} elements; "
            f"0 segments can only own 0 keys"
        )
    zeros = torch.zeros((0, m), dtype=torch.int32, device=keys.device)
    perm = torch.zeros((0,), dtype=torch.int32, device=keys.device)
    if mode == "counts_only":
        return MultisplitResult(None, None, zeros, zeros, None)
    if mode == "positions_only":
        return MultisplitResult(None, None, zeros, zeros, perm)
    return MultisplitResult(keys, values, zeros, zeros, perm)


def segmented_multisplit(
    keys,
    bucket_fn: BucketSpec,
    segment_starts,
    values=None,
    *,
    method: str = "bms",
    tile: Optional[int] = None,
    backend: str = "cuda",
    mode: str = "reorder",
    family: Optional[str] = None,
    build_plan: Callable[..., MultisplitPlan] = make_segmented_plan,
    device="cuda",
) -> MultisplitResult:
    """Multisplit every ragged segment of flat ``keys`` independently in one
    launch. ``segment_starts`` is an (s,) ascending vector of start offsets
    with ``segment_starts[0] == 0``; segment i spans ``[starts[i],
    starts[i+1])`` (the last ends at n) and may be empty.

    Bitwise equal to slicing out each segment and multisplitting it alone:
    each segment keeps its input span in the output, ``bucket_starts`` and
    ``bucket_counts`` are (s, m) segment-local, and so is ``permutation``.
    ``s == 0`` is legal with empty keys. ``build_plan`` resolves the plan
    with :func:`make_segmented_plan`'s signature (``ops`` passes its
    cached one). Inputs, tensors or numpy arrays, are placed on
    ``device``."""
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    starts = torch.as_tensor(segment_starts)
    if starts.shape[0] == 0:
        return _empty_segmented_result(keys, values, bucket_fn.num_buckets, mode)
    plan = build_plan(
        keys.shape[0], int(starts.shape[0]), bucket_fn.num_buckets,
        method=method, key_value=values is not None, backend=backend, tile=tile,
        bucket_fn=bucket_fn, mode=mode, family=family,
    )
    return plan(keys, values, segment_starts=starts)
