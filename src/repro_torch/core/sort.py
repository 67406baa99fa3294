"""Multisplit-based radix sort (paper §7.1) and the reduced-bit-sort
baseline (§3.4). Counterpart of ``repro/core/sort.py``.

* :func:`radix_sort` — LSD radix sort from chained multisplit passes with
  radix-digit buckets, as one :class:`~repro_torch.core.pipeline.radix.
  RadixPipeline`.
* :func:`segmented_radix_sort` — every ragged segment sorted on its own, in
  one chained sequence of segmented passes.
* :func:`rb_sort_multisplit` — multisplit by a stable ``torch.sort`` of the
  labels. It is the oracle and the library baseline of the port's checks on
  the card, and never runs on the main path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.identifiers import BucketSpec
from repro_torch.core.pipeline import MultisplitResult, RadixPipeline
from repro_torch.core.pipeline.stages import as_bits, exclusive_rows

Tensor = torch.Tensor


def _place(x, device) -> Optional[Tensor]:
    return None if x is None else torch.as_tensor(x).to(device)


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
    """Stable sort of integer keys (and values) by their low ``key_bits``
    bits as unsigned integers, in ⌈key_bits/radix_bits⌉ multisplit passes.
    ``radix_bits=8`` makes each pass a 256-bucket multisplit. Inputs,
    tensors or numpy arrays, are placed on ``device``.

    ``fuse_digits=True`` sorts two digits a sweep on backends that fuse
    digit pairs (``vmap``, ``cuda``): r = 8 runs 2 sweeps over 16-bit pairs
    instead of 4 passes; an odd schedule ends in one single-digit pass.
    Bitwise equal to the unfused sort on every backend."""
    keys, values = _place(keys, device), _place(values, device)
    if keys.dim() != 1:
        raise NotImplementedError("batched (b, n) radix sort is ROADMAP queue A item 5")
    pipe = RadixPipeline(
        keys.shape[0], radix_bits=radix_bits, key_bits=key_bits, method=method,
        key_value=values is not None, backend=backend, tile=tile, family=family,
        fuse_digits=fuse_digits,
    )
    return pipe(keys, values)


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
    """Sort every ragged segment of flat integer ``keys`` on its own, in ONE
    chained sequence of ⌈key_bits/radix_bits⌉ segmented multisplit passes,
    not one sequence a segment. ``segment_starts`` is the (s,) ascending
    start-offset vector of :func:`~repro_torch.core.multisplit.
    segmented_multisplit`. Stable; bitwise equal to sorting each segment
    alone with :func:`radix_sort`. Inputs are placed on ``device``.
    ``fuse_digits`` as in :func:`radix_sort`."""
    keys, values = _place(keys, device), _place(values, device)
    starts = torch.as_tensor(segment_starts)
    pipe = RadixPipeline(
        keys.shape[0], radix_bits=radix_bits, key_bits=key_bits, method=method,
        key_value=values is not None, backend=backend, tile=tile,
        segments=int(starts.shape[0]), family=family, fuse_digits=fuse_digits,
    )
    return pipe(keys, values, segment_starts=starts)


def rb_sort_multisplit(
    keys: Tensor, bucket_fn: BucketSpec, values: Optional[Tensor] = None
) -> MultisplitResult:
    """Reduced-bit-sort multisplit (§3.4): a stable sort of the labels
    carries keys (and values) along. Same result as the pipeline."""
    m = bucket_fn.num_buckets
    labels = bucket_fn(keys)
    _, order = torch.sort(labels, stable=True)
    keys_s = as_bits(keys)[order].view(keys.dtype)
    values_s = as_bits(values)[order].view(values.dtype) if values is not None else None
    counts = torch.bincount(labels.long(), minlength=m).to(torch.int32)
    perm = torch.empty_like(labels)
    perm[order] = torch.arange(labels.shape[0], dtype=torch.int32, device=keys.device)
    return MultisplitResult(keys_s, values_s, exclusive_rows(counts), counts, perm)
