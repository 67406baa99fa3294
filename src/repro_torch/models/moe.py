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

The MoE block (counterpart of ``moe.py:41-80, 226-410``): :func:`moe_decl`,
:func:`_router` (softmax, top-k, the Switch load-balance and z losses; its
top-1 load count is :func:`expert_load_stats`, a ``counts_only`` call),
:func:`_expert_ffn` and :func:`moe_block` with three dispatches that give
the same output: ``dense`` (every expert on every token), ``sort`` (ranks
from :func:`_ranks_sort`) and ``multisplit`` (ranks from
:func:`_ranks_multisplit`, one ``positions_only`` call: K1 + K3 on the
card). ``multisplit_ep`` does what the JAX block does with no mesh in
scope: the ``multisplit`` dispatch (its expert-parallel body over a process
group comes with the mesh slice). The block's ``backend`` is that of the
routing calls; they run where the activations lie.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import get_backend, segment_ids_from_starts
from repro_torch.models.layers import apply_norm, mlp_block, mlp_decl, norm_decl
from repro_torch.parallel.sharding import ParamDecl

Tensor = torch.Tensor

DISPATCH_TILE = 2048


class MoEAux(NamedTuple):
    load_balance: Tensor
    router_z: Tensor
    drop_fraction: Tensor


def moe_decl(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    decl = {
        "norm": norm_decl(cfg),
        "router": ParamDecl((d, e), ("embed", "experts"), scale=0.02),
        "w_gate": ParamDecl((e, d, f), ("experts", "embed", "ff")),
        "w_up": ParamDecl((e, d, f), ("experts", "embed", "ff")),
        "w_down": ParamDecl((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.moe.shared_expert:
        decl["shared"] = mlp_decl(cfg)
    return decl


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = int(math.ceil(n_tokens * k / e * cfg.moe.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def _router(p, xn: Tensor, cfg: ModelConfig, *, backend: str = "cuda"):
    """xn: (n, d) -> (gates (n, k), experts (n, k), load-balance loss,
    z-loss). The top-1 dispatch fraction is a ``counts_only`` call
    (:func:`expert_load_stats`): exact integer counts."""
    logits = torch.einsum("nd,de->ne", xn, p["router"].to(xn.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.moe.top_k, dim=-1)
    experts = experts.to(torch.int32)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = cfg.moe.num_experts
    me = probs.mean(0)
    counts, _ = expert_load_stats(experts[:, 0].contiguous(), e, backend=backend,
                                  device=xn.device)
    ce = counts.float() / experts.shape[0]
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, experts, lb, z


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


def _expert_ffn(p, x: Tensor, dtype) -> Tensor:
    """x: (E, C, d) -> (E, C, d), SwiGLU per expert (batched over E)."""
    gate = torch.einsum("ecd,edf->ecf", x, p["w_gate"].to(dtype))
    up = torch.einsum("ecd,edf->ecf", x, p["w_up"].to(dtype))
    act = F.silu(gate.float()).to(dtype) * up
    return torch.einsum("ecf,efd->ecd", act, p["w_down"].to(dtype))


def moe_block(p, x: Tensor, cfg: ModelConfig, *, backend: str = "cuda") -> Tuple[Tensor, MoEAux]:
    """x: (B, S, d) -> (residual delta, aux losses)."""
    if cfg.moe.dispatch == "multisplit_ep":
        # no process group in scope: the JAX block's own fallback
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit"))
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    dtype = x.dtype
    xn = apply_norm(p["norm"], x, cfg).reshape(b * s, d)
    n = b * s
    gates, experts, lb, z = _router(p, xn, cfg, backend=backend)

    if cfg.moe.dispatch == "dense":
        # every expert on every token (no data movement, O(n·E) compute)
        all_out = _expert_ffn(p, xn[None].expand(e, n, d), dtype)          # (E, n, d)
        combine = torch.zeros((n, e), dtype=torch.float32, device=x.device)
        combine.scatter_add_(1, experts.long(), gates)
        y = torch.einsum("ne,end->nd", combine.to(dtype), all_out)
        drop = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        cap = _capacity(n, cfg)
        flat_experts = experts.reshape(-1)                          # (n·k,) virtual tokens
        if cfg.moe.dispatch == "multisplit":
            ranks, _ = _ranks_multisplit(flat_experts, e, backend=backend, device=x.device)
        elif cfg.moe.dispatch == "sort":
            ranks, _ = _ranks_sort(flat_experts, e, device=x.device)
        else:
            raise ValueError(f"unknown dispatch {cfg.moe.dispatch!r}")

        keep = ranks < cap
        slot = torch.where(keep, flat_experts * cap + ranks, e * cap).long()   # e·cap: dropped
        token_idx = torch.arange(n * k, dtype=torch.int32, device=x.device) // k
        # one spare row takes the dropped tokens, then is cut off (JAX: mode="drop")
        token_for_slot = torch.full((e * cap + 1,), n, dtype=torch.int32, device=x.device)
        token_for_slot = token_for_slot.index_put_((slot,), token_idx)[:e * cap]
        valid_slot = (token_for_slot < n)[:, None].to(dtype)                 # (E·C, 1)
        expert_in = xn[token_for_slot.clamp(max=n - 1).long()] * valid_slot
        flat_out = _expert_ffn(p, expert_in.view(e, cap, d), dtype).reshape(e * cap, d)
        # combine: a loop over the k routed experts, one (n, d) gather each;
        # a dropped slot's gate times keep is 0
        w = (gates * keep.view(n, k)).to(dtype)                             # (n, k)
        slot_nk = slot.view(n, k).clamp(max=e * cap - 1)
        y = torch.zeros((n, d), dtype=dtype, device=x.device)
        for kk in range(k):
            y = y + flat_out[slot_nk[:, kk]] * w[:, kk:kk + 1]
        drop = 1.0 - keep.float().mean()

    y = y.view(b, s, d)
    if cfg.moe.shared_expert:
        y = y + mlp_block(p["shared"], x, cfg)   # always-on shared expert (own pre-norm)
    return y, MoEAux(lb, z, drop)
