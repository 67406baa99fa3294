"""Device-wide histogram built from the multisplit prescan (paper §7.3;
counterpart of ``repro/core/histogram.py:27-62``).

The paper reuses the prescan (tile histograms) and sums across subproblems
instead of scanning: a ``counts_only`` partial pipeline, {prescan, reduce},
no scan and no scatter, so :func:`histogram` is one plan call.
:func:`histogram_even` and :func:`histogram_range` mirror CUB's
HistogramEven and HistogramRange, the paper's comparison.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.identifiers import BucketSpec, even_buckets, range_buckets
from repro_torch.core.pipeline import make_plan

Tensor = torch.Tensor


def histogram(
    keys,
    bucket_fn: BucketSpec,
    *,
    tile: Optional[int] = None,
    backend: str = "cuda",
    device="cuda",
) -> Tensor:
    """Global (m,) int32 bucket counts of ``keys`` placed on ``device``."""
    keys = torch.as_tensor(keys).to(device)
    plan = make_plan(
        keys.shape[0], bucket_fn.num_buckets, method="bms", backend=backend, tile=tile,
        bucket_fn=bucket_fn, mode="counts_only",
    )
    return plan(keys).bucket_counts


def histogram_even(keys, lo: float, hi: float, num_buckets: int, **kw) -> Tensor:
    """Evenly spaced bins (paper §7.3 scenario 1)."""
    return histogram(keys, even_buckets(lo, hi, num_buckets), **kw)


def histogram_range(keys, splitters, **kw) -> Tensor:
    """Arbitrary splitter bins by binary search (paper §7.3 scenario 2)."""
    return histogram(keys, range_buckets(splitters), **kw)
