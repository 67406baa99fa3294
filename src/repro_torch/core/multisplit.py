"""Segmented multisplit (counterpart of ``repro/core/multisplit.py:218-284``).

:func:`segmented_multisplit` multisplits every ragged segment of flat keys
on its own, in one plan launch a stage. The batched layout
(``batched_multisplit``) and the unfused baseline (``multisplit_unfused``)
are ROADMAP queue A item 5.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.identifiers import BucketSpec
from repro_torch.core.pipeline import MultisplitPlan, MultisplitResult, make_segmented_plan

Tensor = torch.Tensor


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
    keys: Tensor,
    bucket_fn: BucketSpec,
    segment_starts,
    values: Optional[Tensor] = None,
    *,
    method: str = "bms",
    tile: Optional[int] = None,
    backend: str = "vmap",
    mode: str = "reorder",
    family: Optional[str] = None,
    build_plan: Callable[..., MultisplitPlan] = make_segmented_plan,
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
    cached one)."""
    starts = torch.as_tensor(segment_starts)
    if starts.shape[0] == 0:
        return _empty_segmented_result(keys, values, bucket_fn.num_buckets, mode)
    plan = build_plan(
        keys.shape[0], int(starts.shape[0]), bucket_fn.num_buckets,
        method=method, key_value=values is not None, backend=backend, tile=tile,
        bucket_fn=bucket_fn, mode=mode, family=family,
    )
    return plan(keys, values, segment_starts=starts)
