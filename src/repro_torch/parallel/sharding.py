"""Declarative parameters, the parameter half (counterpart of
``repro/parallel/sharding.py``).

Every model parameter is declared as a :class:`ParamDecl` carrying its shape
and a tuple of *logical* axis names. From one declaration tree (nested dicts
and lists, as the JAX package's) the port derives (a) materialised
parameters on a device, drawn from an explicit ``torch.Generator``
(:func:`init_params`), and (b) shape-only stand-ins on the ``meta`` device
(:func:`decl_to_abstract`) — no allocation.

This slice runs on one device: :func:`constrain` is the identity and
:func:`tp_size` is 1. The mesh layer (``spec_for_decl``,
``decl_to_sharding``: logical axes onto a device mesh) comes with the mesh
slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

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
    as a JAX pytree keeps it."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
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


def constrain(x: Tensor, *entries) -> Tensor:
    """The activation layout anchor: the identity on one device."""
    return x


def tp_size() -> int:
    """The tensor-parallel width: 1 on one device."""
    return 1


def decl_to_abstract(decls):
    """Declaration tree -> tree of ``meta`` tensors (shape and dtype, no
    storage)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype, device="meta"), decls)


def init_params(decls, generator: torch.Generator, dtype: Optional[torch.dtype] = None):
    """Materialise a declaration tree on ``generator``'s device, drawn from
    ``generator`` leaf by leaf, with the JAX package's rules:
    ``zeros``, ``ones``, else a float32 normal times ``scale`` (default
    ``1/sqrt(fan_in)``, fan_in the second-to-last dim) cast to the leaf's
    dtype. ``dtype``, if given, replaces every leaf's dtype (a serving model
    held in its compute dtype: no float32 copy of the weights)."""
    device = generator.device

    def one(decl: ParamDecl) -> Tensor:
        dt = dtype or decl.dtype
        if decl.init == "zeros":
            return torch.zeros(decl.shape, dtype=dt, device=device)
        if decl.init == "ones":
            return torch.ones(decl.shape, dtype=dt, device=device)
        fan_in = decl.shape[-2] if len(decl.shape) >= 2 else decl.shape[-1]
        scale = decl.scale if decl.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        w = torch.randn(decl.shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(scale).to(dt)

    return tree_map(one, decls)


def param_count(decls) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(decls))


def param_bytes(decls) -> int:
    return sum(math.prod(d.shape) * d.dtype.itemsize for d in tree_leaves(decls))
