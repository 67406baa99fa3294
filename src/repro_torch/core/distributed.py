"""Device-level multisplit: the paper's {local, global, local} model lifted
onto a ``torch.distributed`` process group (counterpart of
``repro/core/distributed.py``).

Hierarchy (paper §4.4, one more level than the GPU version):

    tile (a block's direct solve)  ->  device (the plan's grid)
        ->  process group (THIS module: one tiny all-gather + an all-to-all)

Key property (paper §4.7 lifted to the interconnect): after each rank
*locally reorders* its shard bucket-major, the map ``local index -> global
output position`` is strictly increasing, so what a rank sends to any one
peer is ONE contiguous run of its local buffer: the ragged transport is one
``all_to_all_single`` with per-peer split sizes.

Entry points:

* :func:`multisplit_all_shards` — one process, a ``(D, n_shard)`` stack: the
  local stage is ONE batched plan (one launch a stage for all shards), the
  global stage the closed-form scan over the ``(D, m)`` histogram H.
* :func:`multisplit_sharded` — every rank of a process group calls it with
  its equal-size shard; rank ``d`` gets global positions ``[d·n_dev,
  (d+1)·n_dev)`` of the bucket-major output.
* :func:`multisplit_bucket_sharded` — rank ``d`` gets buckets ``[d·m/D,
  (d+1)·m/D)`` (the MoE expert-dispatch layout), padded to ``capacity``.
* :func:`make_multisplit_sharded` — :func:`multisplit_sharded` bound to a
  group.

The JAX ``axis_name`` is the ``group`` here (None: the default group).
Transport placement is explicit, by the group's backend: with ``nccl`` the
collectives take the tensors where they lie, on the card; with ``gloo`` (a
host transport) each send buffer is copied to the host before its
collective and the received buffer back to ``device`` after it. The local
stages run on ``device`` either way. A CPU-only machine can run gloo; one
card can run gloo with several ranks on it (NCCL refuses two ranks on one
device), and NCCL needs a card a rank. The collectives move 4-byte words as
their int32 bit patterns, so uint32 and float32 keys cross either backend.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import ops
from repro_torch.core.identifiers import BucketSpec
from repro_torch.core.pipeline import MultisplitResult, make_plan, resolve_backend
from repro_torch.core.pipeline.stages import as_bits, scatter

Tensor = torch.Tensor
TRANSPORTS = ("dense", "ragged")


def _exclusive(x: Tensor, dim: int = -1) -> Tensor:
    """Exclusive int32 prefix sum along ``dim``."""
    return (torch.cumsum(x, dim, dtype=torch.int32) - x).to(torch.int32)


def _global_positions(hist: Tensor, offsets: Tensor, n_shard: int) -> Tensor:
    """The global output position of every slot of bucket-major reordered
    shards: slot j of shard d, in bucket b, goes to ``j + offsets[d, b]``.
    ``hist`` and ``offsets`` are (D, m), or (m,) for one shard; the result
    is (D, n_shard), or (n_shard,), int32, strictly increasing along a
    shard (paper §4.7). The shards' counts sum to ``D·n_shard``, which
    sizes the expansion without a read of the counts."""
    d_num = hist.numel() // hist.shape[-1]
    per_slot = torch.repeat_interleave(offsets.reshape(-1), hist.reshape(-1).long(),
                                       output_size=d_num * n_shard)
    lidx = torch.arange(n_shard, dtype=torch.int32, device=hist.device)
    return (per_slot.view(d_num, n_shard) + lidx).view(hist.shape[:-1] + (n_shard,))


def multisplit_all_shards(
    keys,
    bucket_fn: BucketSpec,
    values=None,
    *,
    method: str = "bms",
    backend: Optional[str] = None,
    tile: Optional[int] = None,
    device="cuda",
) -> MultisplitResult:
    """The device-level pipeline with the LOCAL stage as ONE batched plan.

    ``keys`` is the (D, n_shard) stack of all shards. Stage 1 runs every
    shard's bucket-major reorder and histogram in one batched plan (one
    launch a stage for all D shards); stage 2 is the closed-form global
    scan over the (D, m) histogram H, the math :func:`_send_plan` does from
    the gathered H. The result is the global stable bucket-major multisplit
    of the concatenated shards (bitwise the flat multisplit of
    ``keys.reshape(-1)``), with the element-ordered permutation in flat
    global coordinates. Inputs, tensors or numpy arrays, are placed on
    ``device``.
    """
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    d_num, n_shard = keys.shape
    plan = make_plan(n_shard, bucket_fn.num_buckets, method=method,
                     key_value=values is not None, backend=resolve_backend(backend),
                     tile=tile, bucket_fn=bucket_fn, batch=d_num)
    local = plan(keys, values)                               # one launch a stage, D shards
    hist = local.bucket_counts                               # (D, m) == H
    totals = hist.sum(0, dtype=torch.int32)
    g_flat = _exclusive(totals)
    offsets = g_flat + _exclusive(hist, 0) - local.bucket_starts
    pos = _global_positions(hist, offsets, n_shard)          # (D, n_shard)
    flat = pos.reshape(-1).long()
    keys_out = scatter(local.keys.reshape(-1), flat, d_num * n_shard)
    values_out = None if values is None else scatter(local.values.reshape(-1), flat,
                                                     d_num * n_shard)
    # element i of shard d went to local slot perm[d, i], hence globally to
    # that slot's position
    perm = pos.gather(1, local.permutation.long()).reshape(-1)
    return MultisplitResult(keys_out, values_out, g_flat, totals, perm)


def _local_plan(keys: Tensor, bucket_fn: BucketSpec, values, method: str, backend, tile):
    """The rank's local stage IS a multisplit plan: the shard is one
    subproblem of the same {prescan, scan, postscan} pipeline tiles are."""
    plan = make_plan(keys.shape[0], bucket_fn.num_buckets, method=method,
                     key_value=values is not None, backend=resolve_backend(backend),
                     tile=tile, bucket_fn=bucket_fn)
    return plan(keys, values)


class ShardedMultisplitResult(NamedTuple):
    keys: Tensor                # this rank's shard of the global bucket-major output
    values: Optional[Tensor]
    bucket_starts: Tensor       # (m,) GLOBAL bucket start positions (replicated)
    bucket_counts: Tensor       # (m,) GLOBAL histogram (replicated)


def _send_plan(hist_all: Tensor, n_dev: int):
    """The all-to-all plan from the gathered histogram.

    ``hist_all``: (D, m) per-rank bucket counts, the paper's matrix H with
    L = D columns. Everything below is O(D·m + D²) scalar work, computed
    redundantly on every rank (recompute over communicate, paper §5.3).
    Returns the full (D_src, D_dst) input offsets and send counts, the
    global bucket starts and the totals."""
    d_num = hist_all.shape[0]
    totals = hist_all.sum(0, dtype=torch.int32)
    g_flat = _exclusive(totals)
    run_start = g_flat[None, :] + _exclusive(hist_all, 0)     # (D, m) global start of (s, b)
    bounds = torch.arange(d_num + 1, dtype=torch.int64, device=hist_all.device) * n_dev
    # count of rank s's elements with global position < X, per boundary X
    below = torch.minimum((bounds[None, :, None] - run_start[:, None, :]).clamp(min=0),
                          hist_all[:, None, :]).sum(-1)       # (D, D+1)
    send_matrix = (below[:, 1:] - below[:, :-1]).to(torch.int32)
    return below[:, :-1].to(torch.int32), send_matrix, g_flat, totals


def _host_transport(group) -> bool:
    """True for a host transport (gloo), False for the card's (nccl)."""
    return dist.get_backend(group) == dist.Backend.GLOO


def _all_gather_rows(x: Tensor, group, host: bool) -> Tensor:
    """The (D, ...) stack of every rank's ``x``, on ``x``'s device."""
    src = x.cpu() if host else x.contiguous()
    out = torch.empty((dist.get_world_size(group),) + tuple(src.shape), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(x.device)


def _all_to_all(send: Tensor, group, host: bool, out_splits: Optional[List[int]] = None,
                in_splits: Optional[List[int]] = None) -> Tensor:
    """``all_to_all_single`` of ``send`` (equal splits along dim 0, or the
    given split sizes), the result on ``send``'s device."""
    src = send.cpu() if host else send.contiguous()
    n_out = src.shape[0] if out_splits is None else sum(out_splits)
    recv = torch.empty((n_out,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
    dist.all_to_all_single(recv, src, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=group)
    return recv.to(send.device)


def _pack(buf: Tensor, in_off: Tensor, send: Tensor, fill: int) -> Tensor:
    """(D, n_dev): row d the run ``buf[in_off[d] : in_off[d] + send[d]]``,
    padded with ``fill`` to the shard size (the dense transport)."""
    n_dev = buf.shape[0]
    idx = torch.arange(n_dev, dtype=torch.int32, device=buf.device)
    gidx = (in_off[:, None] + idx[None, :]).clamp(0, n_dev - 1).long()
    return torch.where(idx[None, :] < send[:, None], buf[gidx], fill)


def _place_by(recv: Tensor, dest: Tensor, size: int) -> Tensor:
    """``out[dest[i]] = recv[i]`` into ``size`` zeroed slots; a destination
    of ``size`` (a pad, or past a capacity) is dropped."""
    out = torch.zeros(size + 1, dtype=recv.dtype, device=recv.device)
    out.index_copy_(0, dest.reshape(-1).long(), recv.reshape(-1))
    return out[:size]


def _check_transport(transport: str) -> None:
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")


def multisplit_sharded(
    keys,
    bucket_fn: BucketSpec,
    values=None,
    *,
    group=None,
    method: str = "bms",
    backend: Optional[str] = None,
    tile: Optional[int] = None,
    transport: str = "dense",
    device="cuda",
) -> ShardedMultisplitResult:
    """Exact global stable multisplit across a process group.

    Every rank of ``group`` calls it with its equal-size shard. Output:
    rank ``d`` holds global positions ``[d·n_dev, (d+1)·n_dev)`` of the
    bucket-major output; ``bucket_starts`` and ``bucket_counts`` are global.
    The data moves by the position-carrying dense transport: each run for a
    peer padded to the shard size, (data, global position) pairs through an
    equal-split ``all_to_all_single``, the receiver scattering by position.
    ``transport`` is taken and gives the same result either way, as the
    JAX function takes and ignores it.
    """
    _check_transport(transport)
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    n_dev = keys.shape[0]
    rank, host = dist.get_rank(group), _host_transport(group)

    # ---- local stage: reorder the shard bucket-major, its histogram
    local = _local_plan(keys, bucket_fn, values, method, backend, tile)

    # ---- global stage: ONE tiny collective over H (D, m) + the replicated scan
    hist_all = _all_gather_rows(local.bucket_counts, group, host)       # (D, m)
    in_off_all, send_all, g_flat, totals = _send_plan(hist_all, n_dev)
    in_off, send = in_off_all[rank], send_all[rank]
    offsets = g_flat + _exclusive(hist_all, 0)[rank] - local.bucket_starts
    positions = _global_positions(local.bucket_counts, offsets, n_dev)  # (n_dev,)

    send_pos = _pack(positions, in_off, send, -1)
    recv_pos = _all_to_all(send_pos, group, host).reshape(-1)
    dest = torch.where(recv_pos < 0, n_dev, recv_pos - rank * n_dev)   # pads -> dropped

    def move(buf):                       # on the int32 bit patterns
        sent = _all_to_all(_pack(as_bits(buf), in_off, send, 0), group, host)
        return _place_by(sent, dest, n_dev).view(buf.dtype)

    values_out = None if values is None else move(local.values)
    return ShardedMultisplitResult(move(local.keys), values_out, g_flat, totals)


class BucketShardedResult(NamedTuple):
    keys: Tensor                # (capacity,) this rank's bucket-group elements, bucket-major
    values: Optional[Tensor]
    count: Tensor               # (1,) number of valid elements in this shard
    group_counts: Tensor        # (m/D,) per-bucket counts within my group
    bucket_counts: Tensor       # (m,) GLOBAL histogram (replicated)


def multisplit_bucket_sharded(
    keys,
    bucket_fn: BucketSpec,
    values=None,
    *,
    capacity: int,
    group=None,
    method: str = "bms",
    backend: Optional[str] = None,
    tile: Optional[int] = None,
    transport: str = "dense",
    device="cuda",
) -> BucketShardedResult:
    """Bucket-sharded multisplit: rank ``d`` receives all elements of
    buckets ``[d·m/D, (d+1)·m/D)``, bucket-major, padded to ``capacity``.

    This is the MoE expert-dispatch layout. Per (src, dst) pair the payload
    is ONE contiguous run of the source's reordered buffer and one of the
    receiver's buffer (src-major). ``transport="ragged"`` moves it with one
    ``all_to_all_single`` whose split sizes come from the (D, D) send
    matrix, read to the host once a call; ``"dense"`` pads each run to the
    shard size. A final LOCAL multisplit (one ``positions_only`` call on
    the sub-bucket ids) restores bucket-major order: local -> global ->
    local, the paper's model verbatim.

    Elements past ``capacity`` are dropped in src-major order (standard MoE
    semantics), pads ride in the last sub-bucket, and ``count`` is
    ``min(received, capacity)``; ``group_counts`` and ``bucket_counts``
    report the true load so callers can monitor drops.
    """
    _check_transport(transport)
    keys = torch.as_tensor(keys).to(device)
    values = None if values is None else torch.as_tensor(values).to(device)
    d_num, rank = dist.get_world_size(group), dist.get_rank(group)
    host = _host_transport(group)
    m = bucket_fn.num_buckets
    if m % d_num != 0:
        raise ValueError(f"num_buckets {m} must divide over the group's size {d_num}")
    mb = m // d_num
    n_dev = keys.shape[0]

    # local stage
    local = _local_plan(keys, bucket_fn, values, method, backend, tile)
    hist_all = _all_gather_rows(local.bucket_counts, group, host)      # (D, m)
    send_matrix = hist_all.view(d_num, d_num, mb).sum(-1, dtype=torch.int32)   # (src, dst)
    recv = send_matrix[:, rank]                                         # (src,)

    if transport == "ragged":
        sizes = send_matrix.tolist()                  # the one read of the send matrix
        send_sizes, recv_sizes = sizes[rank], [row[rank] for row in sizes]
        kept = torch.arange(sum(recv_sizes), device=keys.device).clamp(max=capacity)

        def move(buf):                   # on the int32 bit patterns
            got = _all_to_all(as_bits(buf), group, host, out_splits=recv_sizes,
                              in_splits=send_sizes)
            return _place_by(got, kept, capacity).view(buf.dtype)
    else:
        in_off = local.bucket_starts[torch.arange(d_num, device=keys.device) * mb]  # (dst,)
        send = send_matrix[rank]
        idx = torch.arange(n_dev, dtype=torch.int32, device=keys.device)
        pos = _exclusive(recv)[:, None] + idx[None, :]                  # src-major layout
        pos = torch.where(idx[None, :] < recv[:, None], pos, capacity).clamp(0, capacity)

        def move(buf):                   # on the int32 bit patterns
            sent = _all_to_all(_pack(as_bits(buf), in_off, send, 0), group, host)
            return _place_by(sent, pos, capacity).view(buf.dtype)

    keys_rx = move(local.keys)
    vals_rx = None if values is None else move(local.values)

    # final local stage: src-major -> bucket-major within my group
    count = torch.clamp(recv.sum(dtype=torch.int32), max=capacity)
    sub_ids = (bucket_fn(keys_rx) - rank * mb).clamp(0, mb - 1)
    valid = torch.arange(capacity, device=keys.device) < count
    sub_ids = torch.where(valid, sub_ids, mb - 1).to(torch.int32)  # pads ride in the last one
    dest = ops.multisplit(sub_ids, ops.identity_buckets(mb), method="dms",
                          mode="positions_only", backend=resolve_backend(backend),
                          device=keys.device).permutation.long()
    keys_out = scatter(keys_rx, dest, capacity)
    vals_out = None if vals_rx is None else scatter(vals_rx, dest, capacity)

    totals = hist_all.sum(0, dtype=torch.int32)
    return BucketShardedResult(keys_out, vals_out, count[None],
                               totals.view(d_num, mb)[rank].clone(), totals)


def make_multisplit_sharded(bucket_fn: BucketSpec, group=None, key_value: bool = False, **kw):
    """:func:`multisplit_sharded` bound to ``bucket_fn`` and ``group``:
    ``fn(keys)``, or ``fn(keys, values)`` with ``key_value``."""
    if key_value:
        def fn(keys, values):
            return multisplit_sharded(keys, bucket_fn, values, group=group, **kw)
    else:
        def fn(keys):
            return multisplit_sharded(keys, bucket_fn, group=group, **kw)
    return fn
