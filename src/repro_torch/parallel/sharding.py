"""Declarative parameters with logical sharding axes (counterpart of
``repro/parallel/sharding.py``).

Every model parameter is declared as a :class:`ParamDecl` carrying its shape
and a tuple of *logical* axis names. From one declaration tree (nested dicts
and lists, as the JAX package's) the port derives (a) materialised
parameters on a device, drawn from an explicit ``torch.Generator``
(:func:`init_params`), (b) a tree of :class:`NamedSharding` onto a device
mesh (:func:`decl_to_sharding`, the JAX rule of :func:`spec_for_decl`), and
(c) shape-only stand-ins on the ``meta`` device (:func:`decl_to_abstract`)
— no allocation.

The mesh layer. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with named dimensions (``launch/mesh.py`` builds them); :func:`set_mesh`
puts one in scope, as ``jax.set_mesh`` does, and :func:`get_mesh` reads it.
A :class:`PartitionSpec` is JAX's: one entry a tensor dimension, None, a
mesh axis name or a tuple of names. A :class:`NamedSharding` turns its spec
into DTensor placements, one a mesh dimension: ``Shard(i)`` where tensor
dimension ``i`` names that axis, else ``Replicate()``. :func:`place` is
what ``jit(in_shardings=...)`` does: every rank holds its own slice of each
leaf as a DTensor. Under a mesh the model's activations are DTensors and
DTensor's sharding propagation plays the part of GSPMD: the program means
what it means on one device, and :func:`constrain` (a ``redistribute``)
pins the layout where the JAX package pins it. With no mesh in scope
:func:`constrain` is the identity and :func:`tp_size` is 1.

The training step's gradients come back in their parameters' layout
(:func:`grad_layout`: a partial sum reduced by c10d, an all-reduce or a
reduce-scatter, where GSPMD puts its psum); an ``fsdp`` weight is gathered
at use (:func:`gather_fsdp`, ZeRO-3). The optimizer and the checkpoints
read a leaf as its local shard (:func:`local_shard`, :func:`shard_slices`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names (None = replicated)
    dtype: Any = torch.float32
    init: str = "normal"                      # normal | zeros | ones
    scale: Optional[float] = None             # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


# Logical axes. "model"-sharded: tensor-parallel dims. "fsdp"-sharded: the
# ZeRO-3 dim (only when ParallelConfig.fsdp). Everything else replicated.
TP_AXES = frozenset({"heads", "kv_heads", "ff", "vocab", "experts", "inner", "state_heads"})
FSDP_AXES = frozenset({"embed", "embed_fsdp"})


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists, tuples and named
    tuples (several trees of one structure leaf by leaf); None stays None,
    as a JAX pytree keeps it, and a :class:`PartitionSpec` is a leaf, as
    JAX's is under ``is_leaf``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in the JAX package's order
    (dict keys sorted, as ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [] if tree is None else [tree]


def tree_leaves_with_path(tree, prefix: str = "") -> list:
    """(path, leaf) in :func:`tree_leaves`' order, the path JAX's
    ``keystr``: a named tuple's fields ``.name``, a dict's keys ``['key']``,
    a sequence's items ``[i]``."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        return [kv for name, sub in zip(tree._fields, tree)
                for kv in tree_leaves_with_path(sub, f"{prefix}.{name}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, sub in enumerate(tree)
                for kv in tree_leaves_with_path(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` (a sequence in
    :func:`tree_leaves`' order) in place of its own."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if hasattr(t, "_fields"):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, dict):
            out = {k: walk(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return next(it)

    return walk(like)


# ---------------------------------------------------------------------------
# The mesh in scope
# ---------------------------------------------------------------------------

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)

# DTensor's implicit replication is one switch for the process, which its
# context manager clears on exit. It is entered once, by the outermost
# set_mesh of a mesh of several devices, and the blocks inside it are
# counted on every thread: remat's recomputation enters the mesh again on
# the card's autograd thread while the caller's block is still open.
_IMPLICIT_LOCK = threading.Lock()
_IMPLICIT = {"depth": 0, "block": None}


def _enter_implicit() -> None:
    with _IMPLICIT_LOCK:
        if _IMPLICIT["depth"] == 0:
            block = implicit_replication()
            block.__enter__()
            _IMPLICIT["block"] = block
        _IMPLICIT["depth"] += 1


def _leave_implicit() -> None:
    with _IMPLICIT_LOCK:
        _IMPLICIT["depth"] -= 1
        if _IMPLICIT["depth"] == 0:
            block, _IMPLICIT["block"] = _IMPLICIT["block"], None
            block.__exit__(None, None, None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Put ``mesh`` (a named ``DeviceMesh``, or None) in scope for the block,
    as ``jax.set_mesh`` does. Under a mesh of more than one device the
    block also runs under DTensor's ``implicit_replication``: a plain tensor
    the model makes (positions, masks, zeros) meets a DTensor as a
    replicated one, as a constant meets a sharded array under GSPMD. A
    nested block, on this thread or another, leaves it on for the outer."""
    token = _MESH.set(mesh)
    wide = mesh is not None and mesh.size() > 1
    if wide:
        _enter_implicit()
    try:
        yield mesh
    finally:
        if wide:
            _leave_implicit()
        _MESH.reset(token)


def get_mesh():
    """The mesh in scope (:func:`set_mesh`), or None."""
    return _MESH.get()


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a named mesh, in the mesh's order (JAX's
    ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The data-parallel axes (``pod``, ``data``) of ``mesh``, in its order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a tensor dimension — None
    (replicated), a mesh axis name, or a tuple of names (the dimension split
    over their product, the first the outermost). Missing trailing entries
    are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def placements_of(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dimension:
    ``Shard(i)`` where tensor dimension ``i`` names the axis (an axis of
    size 1 excepted), else ``Replicate()``. A dimension split over several axes takes them in the
    mesh's order, as DTensor shards over successive mesh dimensions; a tuple
    in another order has no DTensor placement and raises."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for name, size in zip(names, mesh.shape):
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"axis {name!r} shards two dimensions of {spec}")
        # a one-wide axis splits nothing; DTensor would still refuse to
        # merge or split the dimension it "shards" in a view
        out.append(Shard(dims[0]) if dims and size > 1 else Replicate())
    for e in spec:
        if isinstance(e, tuple) and list(e) != sorted(e, key=names.index):
            raise ValueError(f"entry {e} of {spec} is not in the mesh's axis order {names}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a mesh and a :class:`PartitionSpec`;
    :attr:`placements` are its DTensor placements."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh)


def local_slices(shape, sharding: NamedSharding) -> Tuple[slice, ...]:
    """The slice of a ``shape`` tensor that this rank holds under
    ``sharding``: a dimension split over axes ``a1, a2, ...`` (mesh order)
    is cut into their product of equal pieces, and the rank at coordinate
    ``c`` holds piece ``(c1·|a2| + c2)·...`` — JAX's
    ``devices_indices_map`` (:func:`shard_slices` of its placements). A
    dimension that the pieces do not divide raises, as JAX refuses it."""
    mesh = sharding.mesh
    return shard_slices(shape, mesh, sharding.placements, mesh.get_coordinate())


def place(tree, shardings):
    """What ``jit(in_shardings=...)`` does to its inputs: each leaf of
    ``tree`` (a tensor holding the whole value, the same on every rank)
    laid out by its :class:`NamedSharding` in ``shardings`` (a tree of the
    same structure; a None sharding, or a DTensor already placed by it,
    leaves the leaf as it is; a DTensor placed otherwise raises). Each rank
    keeps its own slice (:func:`local_slices`) and wraps it with
    ``DTensor.from_local`` — no scatter, so nothing here depends on which
    collectives the group's backend offers. :func:`init_params` with
    ``shardings`` draws and places a parameter tree one leaf at a time.

    On a one-device mesh every placement holds the whole tensor, and
    ``place`` returns the leaves as they are: a one-device DTensor computes
    nothing a plain tensor does not, and costs the host a dispatch an op."""
    def one(full, sh):
        if sh is None or sh.mesh.size() == 1:
            return full
        if isinstance(full, DTensor):
            if full.device_mesh == sh.mesh and tuple(full.placements) == sh.placements:
                return full
            raise ValueError(f"a leaf placed as {tuple(full.placements)} on "
                             f"{full.device_mesh}, asked for {sh.placements} on {sh.mesh}")
        local = full[local_slices(full.shape, sh)].clone()
        return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False)

    return tree_map(one, tree, shardings)


class _Gather(torch.autograd.Function):
    """Shard -> Replicate of a DTensor on one mesh dimension, by c10d's
    ``all_gather_into_tensor`` on that dimension's group; the backward is
    DTensor's redistribute back (a local slice of a replicated gradient, a
    reduce-scatter of a partial one).

    DTensor's own Shard -> Replicate goes through the functional
    ``all_gather_into_tensor``, which gloo does not run on CUDA tensors (on
    torch 2.11 it crashes the process); c10d's does run, so every gather of
    the port's mesh path is this one."""

    @staticmethod
    def forward(ctx, x, mesh_dim: int):
        mesh, placements = x.device_mesh, tuple(x.placements)
        ctx.spec = (mesh, placements)
        d = placements[mesh_dim].dim
        group = mesh.get_group(mesh_dim)
        src = x.to_local().movedim(d, 0).contiguous()
        out = torch.empty((dist.get_world_size(group) * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        new = list(placements)
        new[mesh_dim] = Replicate()
        return DTensor.from_local(out.movedim(0, d), mesh, new, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        return grad_layout(grad, ctx.spec[1]), None


def redistribute(x: Tensor, placements) -> Tensor:
    """``x.redistribute(mesh, placements)`` with every Shard -> Replicate (or
    Shard -> another Shard) step taken by :class:`_Gather` first, from the
    innermost mesh dimension out; what is left (a local slice, a partial
    sum's all-reduce or reduce-scatter) is DTensor's."""
    mesh = x.device_mesh
    placements = tuple(placements)
    for i in reversed(range(mesh.ndim)):
        cur = x.placements[i]
        if cur.is_shard() and cur != placements[i]:
            x = _Gather.apply(x, i)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    return x


class _AnchorGrad(torch.autograd.Function):
    """The identity; the backward lays the gradient out as the input was
    (:func:`grad_layout`: a partial gradient is reduced, a replicated one
    sliced) — :func:`constrain` for the gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad_layout(grad, ctx.placements)


def anchor_grad(x: Tensor) -> Tensor:
    """``x``, whose gradient comes back in ``x``'s own layout (a DTensor);
    a plain tensor as it is. The boundary of a local region whose inputs'
    gradients are partial sums."""
    return _AnchorGrad.apply(x) if isinstance(x, DTensor) else x


def grad_layout(grad: Tensor, placements) -> Tensor:
    """A gradient (a DTensor) laid out as ``placements`` (its parameter's or
    input's, none partial): each partial sum reduced by c10d on its mesh
    dimension's group, outermost dimension first — ``reduce_scatter_tensor``
    where ``placements`` shards a dimension the pieces divide, else
    ``all_reduce`` — then :func:`redistribute` for what is left (a local
    slice of a replicated gradient, a gather). This is the ``psum`` (or
    reduce-scatter) that GSPMD puts after a gradient; the port issues it
    through c10d, whose collectives gloo runs on CUDA tensors. A plain
    tensor is returned as it is."""
    if not isinstance(grad, DTensor):
        return grad
    mesh, placements = grad.device_mesh, tuple(placements)
    cur = list(grad.placements)
    if not any(p.is_partial() for p in cur):
        return grad if tuple(cur) == placements else redistribute(grad, placements)
    local = grad.to_local()
    for i, (c, want) in enumerate(zip(grad.placements, placements)):
        if not c.is_partial():
            continue
        if getattr(c, "reduce_op", "sum") != "sum":
            raise ValueError(f"a gradient partial over {c} on mesh dimension {i}")
        group = mesh.get_group(i)
        n = dist.get_world_size(group)
        if want.is_shard() and local.shape[want.dim] % n == 0:
            src = local.movedim(want.dim, 0).contiguous()
            out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                              device=src.device)
            dist.reduce_scatter_tensor(out, src, group=group)
            local, cur[i] = out.movedim(0, want.dim).contiguous(), want
        else:
            local = local.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(local, group=group)
            cur[i] = Replicate()
    grad = DTensor.from_local(local, mesh, cur, run_check=False)
    return grad if tuple(cur) == placements else redistribute(grad, placements)


def gather_fsdp(tree):
    """``tree``'s leaves made whole over the data axes (``pod``, ``data``)
    where the ``fsdp`` rule sharded them: each such DTensor gathered by
    :func:`redistribute` (c10d), its gradient reduce-scattered back to the
    shard (:func:`grad_layout`) — ZeRO-3, a weight whole only while it is in
    use. Other leaves as they are (with ``fsdp`` off, every leaf)."""
    def one(x):
        if not isinstance(x, DTensor):
            return x
        names, data = x.device_mesh.mesh_dim_names, data_axes_of(x.device_mesh)
        want = tuple(Replicate() if n in data and p.is_shard() else p
                     for n, p in zip(names, x.placements))
        return x if want == tuple(x.placements) else redistribute(x, want)

    return tree_map(one, tree)


def local_shard(x: Tensor) -> Tuple[Tensor, Tuple[int, ...]]:
    """(the part of leaf ``x`` this rank holds, the mesh dimensions that
    replicate it): a DTensor's local tensor and its dimensions placed
    ``Replicate``; a plain tensor whole, replicated over nothing. The
    optimizer and the checkpoints read the state through it: the elements
    of a leaf are the union of its ranks' shards, each held once on the
    ranks at coordinate 0 of its replicated dimensions."""
    if not isinstance(x, DTensor):
        return x, ()
    return x.to_local(), tuple(i for i, p in enumerate(x.placements) if p.is_replicate())


def shard_slices(shape, mesh, placements, coord) -> Tuple[slice, ...]:
    """The slice of a ``shape`` tensor that the rank at mesh coordinate
    ``coord`` holds under DTensor ``placements`` (even pieces, a dimension
    sharded over several mesh dimensions cut outermost first: JAX's
    ``devices_indices_map``)."""
    lo, hi = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d, n = p.dim, mesh.shape[i]
            step = (hi[d] - lo[d]) // n
            if step * n != hi[d] - lo[d]:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not divide over {n}")
            lo[d] += coord[i] * step
            hi[d] = lo[d] + step
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def replicate(x: Tensor) -> Tensor:
    """A DTensor made whole on every rank (every placement Replicate:
    gathers and all-reduces); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, (Replicate(),) * x.device_mesh.ndim)


def whole_over_model(x: Tensor) -> Tensor:
    """A DTensor made whole over ``model`` (gathered or reduced there), its
    placements on the other mesh dimensions kept; anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    want = tuple(Replicate() if a == "model" else p
                 for a, p in zip(x.device_mesh.mesh_dim_names, x.placements))
    return x if want == tuple(x.placements) else redistribute(x, want)


def gather_full(x: Tensor) -> Tensor:
    """The whole value of ``x`` as a plain tensor on every rank (DTensor's
    ``full_tensor()``, through :func:`redistribute`)."""
    return replicate(x).to_local() if isinstance(x, DTensor) else x


def constrain(x: Tensor, *entries) -> Tensor:
    """Divisibility-aware layout anchor for activations (JAX's
    ``with_sharding_constraint`` rule): a :func:`redistribute` of the
    DTensor ``x``.

    Entries: "dp" (the data-parallel axes: pod+data), "model", or None.
    The identity outside a mesh and on a plain tensor, and a per-dimension
    no-op where the dimension does not divide."""
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    names = tuple(mesh.mesh_dim_names)
    shape = mesh_shape(mesh)
    resolved = []
    for dim, e in enumerate(entries):
        if e is None:
            resolved.append(None)
            continue
        if e == "dp":
            axes = data_axes_of(mesh)
        elif e == "model":
            axes = ("model",) if "model" in names else ()
        else:
            axes = (e,) if e in names else ()
        size = math.prod(shape[a] for a in axes)
        if not axes or size <= 1 or x.shape[dim] % size != 0 or x.shape[dim] < size:
            resolved.append(None)
        else:
            resolved.append(axes if len(axes) > 1 else axes[0])
    if all(r is None for r in resolved):
        return x
    placements = placements_of(P(*resolved), mesh)
    if tuple(x.placements) == placements:
        return x
    return redistribute(x, placements)


def settle(x: Tensor) -> Tensor:
    """A DTensor with a pending (partial) reduction reduced to replicated on
    those mesh dimensions (an all-reduce); anything else as it is. A
    vocab-sharded lookup gives a partial that may be reduced only once."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return redistribute(x, [Replicate() if p.is_partial() else p for p in x.placements])


def distribute_input(x: Tensor, *entries) -> Tensor:
    """An input that every rank holds whole (tokens, positions, embeddings)
    as a DTensor under the multi-device mesh in scope, laid out by
    :func:`constrain`'s ``entries`` (a local slice: no collective); as it is
    otherwise."""
    mesh = get_mesh()
    if mesh is None or mesh.size() == 1 or isinstance(x, DTensor):
        return x
    x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return constrain(x, *entries)


def on_local_rows(fn, tensors, head_dims, out_head_dims, n_heads: int, row_dims=None):
    """``fn(*local tensors)`` on each rank's rows and heads of DTensor
    ``tensors``, for a computation independent across rows (dimension 0)
    and heads: the rows over the data axes where they divide, the heads
    over ``model`` where ``n_heads`` divides its size (each tensor's head
    dimension is its entry of ``head_dims``; None keeps it whole over
    ``model``), every other dimension whole; ``row_dims`` (one entry a
    tensor, 0 by default) names the tensors whose dimension 0 is not rows
    (None: whole over the data axes, a weight). The outputs, rows first,
    come back as DTensors laid out likewise (``out_head_dims``). A tensor whole over
    ``model`` while the heads are split gets a gradient partial over
    ``model``, reduced by :func:`anchor_grad`. On the DTensors themselves a
    scan's einsums would merge a sharded batch with sharded heads into a
    strided shard, which DTensor lays out only with data in hand."""
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    names, sizes = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    data = data_axes_of(mesh)
    n_dp = math.prod(n for a, n in zip(names, sizes) if a in data)
    rows = tensors[0].shape[0] % n_dp == 0 and tensors[0].shape[0] >= n_dp
    tp = dict(zip(names, sizes)).get("model", 1)
    heads = tp > 1 and n_heads % tp == 0

    def layout(head_dim, row_dim=0):
        return tuple(Shard(row_dim) if a in data and n > 1 and rows and row_dim is not None
                     else Shard(head_dim) if a == "model" and heads and head_dim is not None
                     else Replicate() for a, n in zip(names, sizes))

    def local(x, head_dim, row_dim):
        pl = layout(head_dim, row_dim)
        # a tensor whole over an axis that splits the work: its gradient is partial there
        grad = tuple(Partial() if (head_dim is None and a == "model" and heads)
                     or (row_dim is None and a in data and n > 1 and rows) else p
                     for a, n, p in zip(names, sizes, pl))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        return anchor_grad(redistribute(x, pl)).to_local(grad_placements=grad)

    row_dims = row_dims or (0,) * len(tensors)
    outs = fn(*(local(x, d, r) for x, d, r in zip(tensors, head_dims, row_dims)))
    return tuple(DTensor.from_local(t, mesh, layout(d), run_check=False)
                 for t, d in zip(outs, out_head_dims))


def tp_size() -> int:
    """The tensor-parallel width: the ``model`` size of the mesh in scope,
    else 1."""
    mesh = get_mesh()
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    return mesh_shape(mesh)["model"] if "model" in names else 1


# ---------------------------------------------------------------------------
# Logical axes onto the mesh
# ---------------------------------------------------------------------------

def spec_for_decl(decl: ParamDecl, pcfg, mesh) -> PartitionSpec:
    """Divisibility-aware logical->mesh assignment (the JAX rule).

    Dims must divide evenly over their mesh axes. When the nominated TP dim
    doesn't divide (e.g. minicpm's 36 heads over model=16, GQA kv=8 over
    16), the model sharding FALLS BACK to the next dim to the right that
    divides (typically head_dim) — a contraction over a sharded inner dim
    becomes a partial sum, reduced where it is read. ``mesh`` is anything
    with ``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``)."""
    shape = mesh_shape(mesh)
    tp = pcfg.tp_axis if pcfg.tp_axis in shape else None
    tp_size = shape[tp] if tp else 1
    dp_size = 1
    for a in pcfg.dp_axes:
        dp_size *= shape[a]
    dp_entry = pcfg.dp_axes if len(pcfg.dp_axes) > 1 else pcfg.dp_axes[0]

    entries = [None] * len(decl.shape)
    # FSDP (ZeRO-3) dims first
    if pcfg.fsdp:
        for i, ax in enumerate(decl.axes):
            if ax in FSDP_AXES and decl.shape[i] % dp_size == 0 and decl.shape[i] >= dp_size:
                entries[i] = dp_entry
                break
    # TP dim: first nominated dim that divides; else fall back rightward
    tp_dims = [i for i, ax in enumerate(decl.axes) if ax in TP_AXES] if tp else []
    if tp_dims:
        placed = False
        for i in tp_dims:
            if entries[i] is None and decl.shape[i] % tp_size == 0 and decl.shape[i] >= tp_size:
                entries[i] = tp
                placed = True
                break
        if not placed:
            for i in range(tp_dims[0] + 1, len(decl.shape)):
                if entries[i] is None and decl.shape[i] % tp_size == 0 and decl.shape[i] >= tp_size:
                    entries[i] = tp
                    break
    return P(*entries)


def decl_to_sharding(decls, pcfg, mesh):
    """Declaration tree -> :class:`NamedSharding` tree (same structure)."""
    return tree_map(lambda d: NamedSharding(mesh, spec_for_decl(d, pcfg, mesh)), decls)


def decl_to_abstract(decls):
    """Declaration tree -> tree of ``meta`` tensors (shape and dtype, no
    storage)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), decls)


def init_params(decls, generator: torch.Generator, dtype: Optional[torch.dtype] = None, *,
                shardings=None):
    """Materialise a declaration tree on ``generator``'s device, drawn from
    ``generator`` leaf by leaf, with the JAX package's rules:
    ``zeros``, ``ones``, else a float32 normal times ``scale`` (default
    ``1/sqrt(fan_in)``, fan_in the second-to-last dim) cast to the leaf's
    dtype. ``dtype``, if given, replaces every leaf's dtype (a serving model
    held in its compute dtype: no float32 copy of the weights).

    ``shardings`` (a :func:`decl_to_sharding` tree) places the tree as
    :func:`place` does: every rank draws each whole leaf from the same
    stream, keeps its own slice (scaled and cast after the cut, so the bits
    are those of the whole draw) and frees the rest before the next leaf.
    On a one-device mesh the leaves stay plain tensors."""
    device = generator.device

    def one(decl: ParamDecl, sh=None) -> Tensor:
        dt = dtype or decl.dtype
        cut = sh is not None and sh.mesh.size() > 1
        sl = local_slices(decl.shape, sh) if cut else ()
        shape = tuple(s.stop - s.start for s in sl) if cut else decl.shape
        if decl.init == "zeros":
            local = torch.zeros(shape, dtype=dt, device=device)
        elif decl.init == "ones":
            local = torch.ones(shape, dtype=dt, device=device)
        else:
            fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
            scale = decl.scale if decl.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            w = torch.randn(decl.shape, generator=generator, dtype=torch.float32, device=device)
            # a cut is copied out, so the whole draw is freed (a float32
            # slice would otherwise be a view that keeps it alive)
            local = w[sl].mul_(scale).to(dt, copy=cut)
            del w
        if not cut:
            return local
        return DTensor.from_local(local.contiguous(), sh.mesh, sh.placements, run_check=False)

    if shardings is None:
        return tree_map(one, decls)
    return tree_map(one, decls, shardings)


def param_count(decls) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(decls))


def param_bytes(decls) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in tree_leaves(decls))
