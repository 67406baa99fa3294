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
card). ``multisplit_ep`` is the expert-parallel dispatch over the mesh in
scope (:func:`_dispatch_multisplit_ep`: each rank multisplits its token
shard over its own expert group, and one all-reduce over ``model`` combines
the outputs); with no ``model`` axis in scope, or experts or tokens that do
not divide, it is ``multisplit``, as the JAX block falls back. The block's
``backend`` is that of the routing calls; they run where the activations
lie.

Under a mesh the activations are DTensors. The router makes its weight
whole on every rank and routes each rank's token shard; the load-balance
fraction is global, as in JAX, so the local ``counts_only`` counts are
summed over the data axes. A dispatch other than the expert-parallel one
runs on whole tensors on every rank (:func:`_replicated`), which is
GSPMD's answer without its layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import get_backend, segment_ids_from_starts
from repro_torch.models.layers import apply_norm, mlp_block, mlp_decl, norm_decl
from repro_torch.parallel.sharding import (
    ParamDecl,
    anchor_grad,
    constrain,
    data_axes_of,
    get_mesh,
    mesh_shape,
    redistribute,
    replicate,
    settle,
)

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
    logits = torch.einsum("nd,de->ne", xn, replicate(p["router"]).to(xn.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.moe.top_k, dim=-1)
    experts = experts.to(torch.int32)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = cfg.moe.num_experts
    me = probs.mean(0)
    top1 = experts[:, 0]
    if isinstance(top1, DTensor):
        # each rank counts its token shard (K1); the counts are summed over
        # the data axes, a partial over them
        local, _ = expert_load_stats(top1.to_local().contiguous(), e, backend=backend,
                                     device=top1.device)
        parts = [Partial() if pl.is_shard() else Replicate() for pl in top1.placements]
        counts = settle(DTensor.from_local(local, top1.device_mesh, parts, run_check=False))
    else:
        counts, _ = expert_load_stats(top1.contiguous(), e, backend=backend, device=xn.device)
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


def _ep_slots(experts_l: Tensor, j: int, e_loc: int, cap_loc: int, *, backend: str = "cuda",
              device="cuda") -> Tuple[Tensor, Tensor, Tensor]:
    """A model rank's share of the expert-parallel routing: its local
    tokens' (n_loc, k) expert ids restricted to its group ``[j·e_loc,
    (j+1)·e_loc)``, the foreign experts in bucket ``e_loc``; ranks from ONE
    ``positions_only`` call over ``e_loc + 1`` buckets. Returns (ranks, keep:
    in the group and under ``cap_loc``, slot: ``sub_id·cap_loc + rank``, or
    ``e_loc·cap_loc`` for a token the rank does not keep)."""
    lo = j * e_loc
    flat_e = experts_l.reshape(-1)                                  # (n_loc·k,)
    in_group = (flat_e >= lo) & (flat_e < lo + e_loc)
    sub_ids = torch.where(in_group, flat_e - lo, e_loc).to(torch.int32)   # e_loc: foreign
    ranks, _ = _ranks_multisplit(sub_ids, e_loc + 1, backend=backend, device=device)
    keep = in_group & (ranks < cap_loc)
    slot = torch.where(keep, sub_ids * cap_loc + ranks, e_loc * cap_loc).long()
    return ranks, keep, slot


def _dispatch_multisplit_ep(p, xn, gates, experts, cfg: ModelConfig, cap: int, dtype, *,
                            backend: str = "cuda"):
    """Manual expert-parallel dispatch over the mesh in scope
    (dispatch="multisplit_ep"), the JAX ``shard_map`` body line for line.

    The paper's {local, global, local} model mapped by hand:

      * local:  each (data, model) rank multisplits ITS token shard by
                expert id restricted to ITS model rank's expert group (one
                ``positions_only`` call over ``e_loc + 1`` buckets, bucket
                ``e_loc`` the foreign experts: K1 + K3 on the card);
      * global: the ONLY collective is one all-reduce of the combined
                output over the model axis (tokens are replicated across
                "model", experts are sharded across it — no token moves);
      * local:  capacity-bounded gather + grouped FFN + weighted combine.

    Capacity is per data shard (cap / DP), the standard local-capacity MoE
    semantics. The output matches the ``multisplit`` dispatch when nothing
    drops. Returns None where JAX's does (no ``model`` axis in scope,
    experts or tokens that do not divide), and the caller falls back.

    The region is DTensor-exact for autograd: the token shard's local
    gradient is a partial sum over ``model`` (each rank reads the tokens for
    its own experts), and the expert weights' a partial sum over the data
    axes; the combined output is a partial over ``model`` reduced once."""
    mesh = get_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    shape = mesh_shape(mesh)
    dp_axes = data_axes_of(mesh)
    n, e = xn.shape[0], cfg.moe.num_experts
    tp = shape["model"]
    n_dp = math.prod(shape[a] for a in dp_axes)
    if e % tp != 0 or n % n_dp != 0:
        return None
    e_loc = e // tp
    cap_loc = max(8, ((-(-cap // n_dp) + 7) // 8) * 8)
    mi = names.index("model")

    # tokens: the batch over the data axes, whole over model
    tok = tuple(Shard(0) if a in dp_axes else Replicate() for a in names)
    tok_grad = tuple(Partial() if a == "model" else pl for a, pl in zip(names, tok))
    xn_l = anchor_grad(redistribute(xn, tok)).to_local(grad_placements=tok_grad)
    gates_l = anchor_grad(redistribute(gates, tok)).to_local(grad_placements=tok_grad)
    experts_l = redistribute(experts, tok).to_local()
    # expert weights: experts over model, whole over the data axes
    wsh = tuple(Shard(0) if a == "model" else Replicate() for a in names)
    wgrad = tuple(Partial() if a in dp_axes else pl for a, pl in zip(names, wsh))
    w = {name: anchor_grad(redistribute(anchor_grad(p[name]), wsh)).to_local(
        grad_placements=wgrad).to(dtype) for name in ("w_gate", "w_up", "w_down")}

    _, keep, slot = _ep_slots(experts_l, mesh.get_coordinate()[mi], e_loc, cap_loc,
                              backend=backend, device=xn_l.device)
    y = _slots_ffn_combine(w, xn_l, gates_l, keep, slot, e_loc, cap_loc, dtype)
    # the ONE global op: combine the partial outputs across expert groups
    y = settle(DTensor.from_local(y, mesh, tok_grad, run_check=False))
    # each virtual token is kept on exactly one model rank => global kept
    # fraction = tp * mean(keep); drop = 1 - that, averaged over the ranks
    drop = 1.0 - tp * keep.float().mean()
    for i in range(mesh.ndim):
        dist.all_reduce(drop, group=mesh.get_group(i))
    return y, drop / mesh.size()


def _replicated(fn, *args):
    """``fn`` on whole tensors on every rank: each DTensor argument made
    whole (a leaf of a dict argument too), the result's tensors wrapped as
    replicated DTensors. A dispatch that is not expert-parallel computes
    GSPMD's answer this way under a mesh."""
    mesh = get_mesh()

    def whole(x):
        if isinstance(x, dict):
            return {k: whole(v) for k, v in x.items()}
        return replicate(x).to_local() if isinstance(x, DTensor) else x

    out = fn(*(whole(a) for a in args))
    wrap = lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return tuple(wrap(t) for t in out)


def moe_block(p, x: Tensor, cfg: ModelConfig, *, backend: str = "cuda") -> Tuple[Tensor, MoEAux]:
    """x: (B, S, d) -> (residual delta, aux losses)."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    dtype = x.dtype
    # the (b, s) -> (n,) flatten keeps the data-sharded batch dim (the JAX anchor)
    xn = constrain(apply_norm(p["norm"], x, cfg).reshape(b * s, d), "dp", None)
    n = b * s
    gates, experts, lb, z = _router(p, xn, cfg, backend=backend)

    dispatch = cfg.moe.dispatch
    if dispatch == "multisplit_ep":
        out = _dispatch_multisplit_ep(p, xn, gates, experts, cfg, _capacity(n, cfg), dtype,
                                      backend=backend)
        if out is not None:
            y, drop = out
            y = y.view(b, s, d)
            if cfg.moe.shared_expert:
                y = y + mlp_block(p["shared"], x, cfg)
            return y, MoEAux(lb, z, drop)
        dispatch = "multisplit"    # no model axis in scope: JAX's own fallback
    experts_p = {name: p[name] for name in ("w_gate", "w_up", "w_down")}
    if isinstance(xn, DTensor):
        y, drop = _replicated(
            lambda *a: _dispatch(*a, dispatch=dispatch, cfg=cfg, backend=backend),
            experts_p, xn, gates, experts)
        y = constrain(y, "dp", None)
    else:
        y, drop = _dispatch(experts_p, xn, gates, experts, dispatch=dispatch, cfg=cfg,
                            backend=backend)
    y = y.view(b, s, d)
    if cfg.moe.shared_expert:
        y = y + mlp_block(p["shared"], x, cfg)   # always-on shared expert (own pre-norm)
    return y, MoEAux(lb, z, drop)


def _dispatch(p, xn: Tensor, gates: Tensor, experts: Tensor, *, dispatch: str,
              cfg: ModelConfig, backend: str) -> Tuple[Tensor, Tensor]:
    """The one-device dispatches: (n, d) output and drop fraction."""
    n, d = xn.shape
    e = cfg.moe.num_experts
    dtype = xn.dtype
    if dispatch == "dense":
        # every expert on every token (no data movement, O(n·E) compute)
        all_out = _expert_ffn(p, xn[None].expand(e, n, d), dtype)          # (E, n, d)
        combine = torch.zeros((n, e), dtype=torch.float32, device=xn.device)
        combine.scatter_add_(1, experts.long(), gates)
        y = torch.einsum("ne,end->nd", combine.to(dtype), all_out)
        return y, torch.zeros((), dtype=torch.float32, device=xn.device)
    cap = _capacity(n, cfg)
    flat_experts = experts.reshape(-1)                          # (n·k,) virtual tokens
    if dispatch == "multisplit":
        ranks, _ = _ranks_multisplit(flat_experts, e, backend=backend, device=xn.device)
    elif dispatch == "sort":
        ranks, _ = _ranks_sort(flat_experts, e, device=xn.device)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")

    keep = ranks < cap
    slot = torch.where(keep, flat_experts * cap + ranks, e * cap)   # e·cap: dropped
    y = _slots_ffn_combine(p, xn, gates, keep, slot, e, cap, dtype)
    return y, 1.0 - keep.float().mean()


def _slots_ffn_combine(p, x: Tensor, gates: Tensor, keep: Tensor, slot: Tensor, n_exp: int,
                       cap: int, dtype) -> Tensor:
    """The capacity-bounded half of a dispatch: the (n, d) tokens ``x``
    gathered into ``n_exp`` buckets of ``cap`` slots by ``slot`` ((n·k,),
    ``n_exp·cap`` for a token not kept), the grouped FFN on ``p``'s
    ``n_exp`` experts, and the combine weighted by ``gates`` times ``keep``
    ((n, k) each). Returns (n, d)."""
    n, d = x.shape
    k = gates.shape[-1]
    slot = slot.long()
    token_idx = torch.arange(n * k, dtype=torch.int32, device=x.device) // k
    # one spare row takes the dropped tokens, then is cut off (JAX: mode="drop")
    token_for_slot = torch.full((n_exp * cap + 1,), n, dtype=torch.int32, device=x.device)
    token_for_slot = token_for_slot.index_put_((slot,), token_idx)[:n_exp * cap]
    valid_slot = (token_for_slot < n)[:, None].to(dtype)                 # (E·C, 1)
    expert_in = x[token_for_slot.clamp(max=n - 1).long()] * valid_slot
    flat_out = _expert_ffn(p, expert_in.view(n_exp, cap, d), dtype).reshape(n_exp * cap, d)
    # combine: a loop over the k routed experts, one (n, d) gather each;
    # a dropped slot's gate times keep is 0
    w = (gates * keep.view(n, k)).to(dtype)                             # (n, k)
    slot_nk = slot.view(n, k).clamp(max=n_exp * cap - 1)
    y = torch.zeros((n, d), dtype=dtype, device=x.device)
    for kk in range(k):
        y = y + flat_out[slot_nk[:, kk]] * w[:, kk:kk + 1]
    return y
