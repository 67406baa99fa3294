"""Mixture-of-Experts token routing by multisplit (counterpart of the
routing functions of ``repro/models/moe.py:85-225``).

Routing a token to an expert is a multisplit: the keys are the tokens'
expert ids, the spec the identity over E experts, and the dispatch
permutation is paper eq. (2). Every function here is one ``repro_torch.ops``
call (or, for the baseline, a stable sort) and gives the JAX package's
function's bits:

* :func:`expert_load_stats` — ``counts_only`` calls: the (E,) or (s, E)
  expert load, and the share of tokens a capacity would drop;
* :func:`_ranks_multisplit` — one ``positions_only`` call, flat or
  segmented: each token's stable rank within its expert;
* :func:`route_tokens_segmented` — the serving step's one segmented launch:
  each token's slot in its request's (expert, capacity) block;
* :func:`_ranks_sort` — the RB-sort baseline: ranks from a stable sort.

Each takes ``device`` (inputs are placed there, the card by default) and,
but for the sort, ``backend`` (``cuda`` by default). The tile: the JAX
package passes ``min(DISPATCH_TILE, n)``; on ``cuda`` the port leaves the
tile to ``core/pipeline/tiles.py`` (a tile changes no bits, and K1s writes a
whole L·s·E row of H a tile), on ``vmap`` it passes the JAX package's.

``MoEAux``, ``_router``, ``moe_block`` and the expert dispatch come with the
model stack (ROADMAP A13).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import ops
from repro_torch.core.pipeline import get_backend, segment_ids_from_starts

Tensor = torch.Tensor

DISPATCH_TILE = 2048


def _place(x, device) -> Tensor:
    return torch.as_tensor(x).to(device)


def _dispatch_tile(n: int, backend: str) -> Optional[int]:
    """The JAX package's ``min(DISPATCH_TILE, n)``, or None (the resolved
    tile) on a kernel backend."""
    return None if get_backend(backend).uses_kernels else min(DISPATCH_TILE, max(int(n), 1))


def expert_load_stats(
    expert_ids,
    num_experts: int,
    capacity: Optional[int] = None,
    segment_starts=None,
    *,
    backend: str = "cuda",
    device="cuda",
) -> Tuple[Tensor, Tensor]:
    """Per-expert token load from ``counts_only`` calls ({prescan, reduce},
    no scan, no permutation). Returns ``(counts, overflow_fraction)``:
    ``counts`` the (E,) histogram, or (s, E) with ``segment_starts``, and
    the fraction of tokens beyond ``capacity`` an expert (0.0 without a
    capacity), the drop rate a capacity-bounded dispatch would incur."""
    ids = _place(expert_ids, device)
    n = ids.shape[0]
    spec = ops.identity_buckets(num_experts)
    tile = _dispatch_tile(n, backend)
    if segment_starts is None:
        counts = ops.multisplit(ids, spec, method="dms", tile=tile, mode="counts_only",
                                backend=backend, device=device).bucket_counts
    else:
        counts = ops.segmented_multisplit(ids, spec, segment_starts, method="dms", tile=tile,
                                          mode="counts_only", backend=backend,
                                          device=device).bucket_counts
    if capacity is None or n == 0:
        return counts, torch.zeros((), dtype=torch.float32, device=counts.device)
    dropped = (counts - capacity).clamp_min(0).sum()
    return counts, dropped.to(torch.float32) / n


def _ranks_multisplit(
    expert_ids, num_experts: int, segment_starts=None, *, backend: str = "cuda",
    device="cuda",
) -> Tuple[Tensor, Tensor]:
    """Each token's stable rank within its expert, and the expert counts,
    from ONE ``positions_only`` call (no key moves). With ``segment_starts``
    one segmented call: ranks restart each segment and the counts are
    (s, E)."""
    ids = _place(expert_ids, device)
    tile = _dispatch_tile(ids.shape[0], backend)
    if segment_starts is None:
        res = ops.multisplit(ids, ops.identity_buckets(num_experts), method="dms", tile=tile,
                             mode="positions_only", backend=backend, device=device)
        ranks = res.permutation - res.bucket_starts[ids.long()]
        return ranks.to(torch.int32), res.bucket_counts
    ranks, counts, _ = _segmented_ranks(ids, segment_starts, num_experts, tile,
                                        backend=backend, device=device)
    return ranks, counts


def _segmented_ranks(
    expert_ids, seg, num_experts: int, tile: Optional[int], backend: str = "cuda",
    device="cuda",
) -> Tuple[Tensor, Tensor, Tensor]:
    """One segmented ``positions_only`` call -> (ranks, (s, E) counts,
    segment id a token), the segment ids returned so a caller does not
    derive them twice."""
    ids = _place(expert_ids, device)
    n = ids.shape[0]
    res = ops.segmented_multisplit(ids, ops.identity_buckets(num_experts), seg, method="dms",
                                   tile=tile, mode="positions_only", backend=backend,
                                   device=device)
    starts = torch.as_tensor(seg).to(device=ids.device, dtype=torch.int32)
    seg_ids = segment_ids_from_starts(starts, n)
    ranks = res.permutation - res.bucket_starts[seg_ids.long(), ids.long()]
    return ranks.to(torch.int32), res.bucket_counts, seg_ids


def route_tokens_segmented(
    expert_ids,
    segment_starts,
    num_experts: int,
    capacity: int,
    *,
    backend: str = "cuda",
    device="cuda",
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-request token routing: ONE segmented multisplit call gives every
    token a slot in its request's (expert, capacity) block.

    ``expert_ids`` is the flat concatenation of the requests' expert ids,
    ``segment_starts`` the (s,) request boundaries. Returns ``(slot, keep,
    counts)``: ``slot[i] = (seg_i·E + expert_i)·capacity + rank_i`` for a
    kept token (an index into an (s·E·capacity,) dispatch buffer; a dropped
    token points one past its end), the keep mask (rank < capacity, stable
    within each (request, expert) pair) and the (s, E) load. ``s == 0``
    returns empty slots and (0, E) counts; an empty request gets a row of
    zeros."""
    ids = _place(expert_ids, device)
    s = len(segment_starts)
    ranks, counts, seg_ids = _segmented_ranks(ids, segment_starts, num_experts,
                                              _dispatch_tile(ids.shape[0], backend),
                                              backend=backend, device=device)
    keep = ranks < capacity
    slot = torch.where(keep, (seg_ids * num_experts + ids) * capacity + ranks,
                       s * num_experts * capacity)
    return slot.to(torch.int32), keep, counts


def _ranks_sort(expert_ids, num_experts: int, *, device="cuda") -> Tuple[Tensor, Tensor]:
    """The baseline: ranks from a stable sort of the expert ids (the
    paper's RB-sort). A library call, so it takes no backend."""
    ids = _place(expert_ids, device)
    n = ids.shape[0]
    order = torch.sort(ids, stable=True).indices
    counts = torch.bincount(ids.long(), minlength=num_experts).to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    ranks_sorted = torch.arange(n, dtype=torch.int32, device=ids.device) - starts[ids[order].long()]
    ranks = torch.zeros(n, dtype=torch.int32, device=ids.device).index_copy_(0, order,
                                                                            ranks_sorted)
    return ranks, counts
