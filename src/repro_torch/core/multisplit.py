"""The multisplit primitive's execution layer (counterpart of
``repro/core/multisplit.py``), flat, batched and segmented.

:func:`multisplit` resolves a plan for one flat problem and runs it: the
paper's {local prescan} -> {one global scan} -> {local postscan + scatter}
(§4.1), with methods dms / wms / bms. :func:`tile_histogram`,
:func:`prescan`, :func:`postscan_positions` and :func:`multisplit_ref` are
the stage helpers and the eq. (1) oracle the JAX package keeps public.
:func:`batched_multisplit` multisplits every row of ``(b, n)`` keys on its
own and :func:`segmented_multisplit` every ragged segment of flat keys, each
in one plan launch a stage. :func:`multisplit_unfused` is the benchmark
baseline the fused plan replaced: three passes a tile, the reorders through
the standalone tile reorder (B10). ``repro_torch.ops`` is the public facade
over this module.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.identifiers import BucketSpec
from repro_torch.core.pipeline import (
    BMS_TILE,
    WMS_TILE,
    MultisplitPlan,
    MultisplitResult,
    direct_solve_ids,
    exclusive_rows,
    global_scan,
    make_batched_plan,
    make_plan,
    make_segmented_plan,
    pad_to_tiles,
)
from repro_torch.core.pipeline.stages import scatter
from repro_torch.kernels import common as _body
from repro_torch.kernels import ops as _kops

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


def batched_multisplit(
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
    """Multisplit every row of ``keys`` (b, n) on its own, in one plan
    launch a stage. Bitwise equal to :func:`multisplit` on each row: (b, n)
    keys, values and permutation, (b, m) per-row starts and counts.
    ``mode`` selects a partial pipeline as in :func:`multisplit`. Inputs,
    tensors or numpy arrays, are placed on ``device``."""
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    if keys.dim() != 2:
        raise ValueError(f"batched_multisplit expects (b, n) keys, got {tuple(keys.shape)}")
    b, n = keys.shape
    plan = make_batched_plan(
        b, n, bucket_fn.num_buckets, method=method, key_value=values is not None,
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


def multisplit_unfused(
    keys,
    bucket_fn: BucketSpec,
    values=None,
    *,
    method: str = "bms",
    tile: Optional[int] = None,
    device="cuda",
) -> MultisplitResult:
    """The three-pass host orchestration the fused plan replaced, kept as
    the benchmark baseline (``repro/core/multisplit.py:294-372``): labels
    written out; K1 on the ids for the prescan; one global scan; K3 on the
    ids for pass 1, the destinations; for wms / bms the standalone tile
    reorder (B10) for pass 2, the keys with the destinations riding as the
    values, and again for pass 3, the values alone; then one scatter. The
    stages run the kernels on a CUDA device and their plain versions on the
    CPU. Bitwise equal to :func:`multisplit`."""
    if method not in ("dms", "wms", "bms"):
        raise ValueError(f"unknown multisplit method {method!r}")
    if tile is None:
        tile = WMS_TILE if method in ("dms", "wms") else BMS_TILE
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    m, n = bucket_fn.num_buckets, keys.shape[0]

    ids_p, _ = pad_to_tiles(bucket_fn(keys).to(torch.int32).contiguous(), tile, m - 1)
    n_total = ids_p.shape[0]
    ids_tiled = ids_p.view(-1, tile)
    hist = _kops.tile_histograms(ids_tiled, m)                   # prescan
    pos_tiled = _kops.tile_positions(ids_tiled, global_scan(hist), m)   # pass 1
    perm_full = pos_tiled.view(-1)

    def tiled(x: Tensor) -> Tensor:
        return pad_to_tiles(x.contiguous(), tile, 0)[0].view(-1, tile)

    src_vals = None
    if method in ("wms", "bms"):
        src_keys, pos_r, _ = _kops.tile_reorder(ids_tiled, tiled(keys), pos_tiled, m)   # pass 2
        scatter_pos = pos_r.view(-1)
        if values is not None:
            src_vals = _kops.tile_reorder(ids_tiled, tiled(values), None, m)[0]       # pass 3
    else:
        src_keys, scatter_pos = tiled(keys), perm_full
        if values is not None:
            src_vals = tiled(values)

    idx = scatter_pos.long()
    keys_out = scatter(src_keys, idx, n_total)[:n]
    values_out = scatter(src_vals, idx, n_total)[:n] if values is not None else None
    counts = hist.sum(0, dtype=torch.int32)
    counts[m - 1] -= n_total - n                                 # drop the pad sentinels
    return MultisplitResult(keys_out, values_out, exclusive_rows(counts), counts, perm_full[:n])
