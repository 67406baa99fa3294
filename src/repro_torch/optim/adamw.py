"""AdamW with dtype-configurable moments and global-norm clipping
(counterpart of ``repro/optim/adamw.py``).

The JAX semantics: the gradients are clipped by their global norm, the
moments are bias-corrected, the weight decay is decoupled and applied to
the float32 weights, the moments are stored in ``moments_dtype``, and with
``params_dtype`` other than float32 a float32 master copy lives in the
state and drives the update, the parameters being re-emitted from it.

The update runs in place, leaf by leaf and, within a leaf, over slices of
:data:`CHUNK` elements: the float32 temporaries of a step are a few slices,
never a whole leaf (one expert leaf of dbrx-132b is 1.06 G elements, whose
float32 copies JAX-style would be 4.2 GB each). So :func:`adamw_update`
consumes its inputs, as a jitted JAX step does its donated state; it still
returns ``(new_params, new_state, metrics)``, whose tensors are the
updated inputs. A failure after its first write raises
:class:`StateConsumedError`: the state is then partly updated, and only a
restore makes it whole again.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import TrainConfig
from repro_torch.parallel.sharding import local_shard, tree_leaves, tree_map

CHUNK = 1 << 24              # elements of a leaf updated at a time


class StateConsumedError(RuntimeError):
    """An in-place update failed after it began writing its state: the step
    counter has advanced and some leaves hold the new values, so the state
    must not be updated again (the supervisor restores a checkpoint)."""


class AdamWState(NamedTuple):
    step: Any
    mu: Any
    nu: Any
    master: Any = None       # fp32 master copy when params are not fp32


def adamw_init(params, tc: TrainConfig) -> AdamWState:
    """Zero moments in ``moments_dtype`` beside each parameter (DTensors
    laid out as theirs), a step counter (int32, on the parameters' device)
    and, when ``params_dtype`` is not float32, the float32 master copy of
    the parameters."""
    mdt = getattr(torch, tc.moments_dtype)
    leaves = tree_leaves(params)
    device = local_shard(leaves[0])[0].device if leaves else None
    master = None
    if tc.params_dtype != "float32":
        master = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        master=master,
    )


def _slices(t: torch.Tensor):
    flat = local_shard(t)[0].view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a plain tensor).

    Over a mesh (DTensor leaves) each rank sums the squares of its shards,
    and the sums are all-reduced over the mesh dimensions that shard each
    leaf, and only those: the leaves are grouped by those dimensions, so a
    leaf replicated over ``data`` counts once, as in JAX's norm of the whole
    tree."""
    sums, mesh = {}, None
    for g in tree_leaves(tree):
        local, rep = local_shard(g.detach())
        if isinstance(g, DTensor):
            mesh = g.device_mesh
            if any(p.is_partial() for p in g.placements):
                raise ValueError(f"a partial leaf {g.placements} has no norm until it is reduced")
            key = tuple(i for i in range(mesh.ndim) if i not in rep)
        else:
            key = ()
        for part in _slices(local):
            sq = part.float().square().sum()
            sums[key] = sq if key not in sums else sums[key] + sq
    if not sums:
        return torch.zeros((), dtype=torch.float32)
    total = None
    for key in sorted(sums):
        part = sums[key]
        for i in key:
            dist.all_reduce(part, group=mesh.get_group(i))
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, tc: TrainConfig, lr):
    """Returns (new_params, new_state, metrics), updating ``params`` and
    ``state`` in place.

    Over a mesh every leaf (parameter, gradient, moments, master) is a
    DTensor of one layout, and each rank updates its own shards
    (``to_local()``); the clip scale, the step, ``lr`` and the bias
    corrections are the same on every rank. The norm's all-reduces come
    before the first write, so a failure after it is this rank's alone.

    With ``params_dtype="bfloat16"`` the update reads and writes the fp32
    MASTER weights held in the state and re-emits the bf16 params.
    ``lr`` is a number or a 0-d tensor."""
    gnorm = global_norm(grads)
    device = gnorm.device
    scale = torch.clamp(tc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = torch.as_tensor(local_shard(lr)[0], dtype=torch.float32, device=device)
    counter = local_shard(state.step)[0]
    try:
        counter.add_(1)
        b1, b2 = tc.beta1, tc.beta2
        step = counter.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=device), step)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=device), step)
        flat_p, flat_g = tree_leaves(params), tree_leaves(grads)
        flat_m, flat_v = tree_leaves(state.mu), tree_leaves(state.nu)
        flat_w = tree_leaves(state.master) if state.master is not None else [None] * len(flat_p)
        for p, g, m, v, master in zip(flat_p, flat_g, flat_m, flat_v, flat_w):
            w_src = master if master is not None else p
            for ps, gs, ms, vs, ws in zip(_slices(p), _slices(g), _slices(m), _slices(v),
                                          _slices(w_src)):
                gf = gs.float() * scale
                m1 = b1 * ms.float() + (1 - b1) * gf
                v1 = b2 * vs.float() + (1 - b2) * gf * gf
                mhat = m1 / bc1
                vhat = v1 / bc2
                w = ws.float()
                delta = mhat / (torch.sqrt(vhat) + tc.eps) + tc.weight_decay * w
                w1 = w - lr * delta
                ms.copy_(m1)
                vs.copy_(v1)
                if master is not None:
                    ws.copy_(w1)
                ps.copy_(w1)
    except Exception as e:
        raise StateConsumedError(f"adamw_update failed after it began updating its state in "
                                 f"place: {e}") from e
    return params, state, {"grad_norm": gnorm, "lr": lr}
