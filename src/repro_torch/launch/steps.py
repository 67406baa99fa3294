"""Step functions (train / prefill / decode), the abstract train state and
the shardings of the state, a batch and a decode cache over a mesh
(counterpart of ``repro/launch/steps.py``).

The JAX package jits these steps and donates the train state; the port runs
them eagerly, and the train step updates its state in place
(:func:`repro_torch.optim.adamw_update`), so a state handed to it is
consumed, as a donated one is. ``backend`` is the model's (the MoE
routing's multisplit backend; on ``cuda`` attention inside B11's contract
runs its forward on the kernel); the device is the tensors'.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.models.layers import lm_head
from repro_torch.optim import AdamWState, adamw_update, make_schedule
from repro_torch.parallel.sharding import (
    NamedSharding,
    P,
    data_axes_of,
    decl_to_abstract,
    decl_to_sharding,
    gather_full,
    grad_layout,
    local_shard,
    mesh_shape,
    place,
    replicate,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def _plain(x: Tensor) -> Tensor:
    """A replicated (or partial) DTensor's whole value as a plain tensor,
    the same on every rank; a plain tensor as it is."""
    return replicate(x).to_local() if isinstance(x, DTensor) else x


def grads_of(params, cfg: ModelConfig, batch: Dict[str, Tensor], *, backend: str = "cuda"):
    """((loss, metrics), grads): :func:`repro_torch.models.model.loss_fn`
    and its gradient for every parameter, as ``jax.value_and_grad`` gives
    them (a parameter the loss does not reach gets zeros). The loss and the
    metrics are detached plain tensors, the same on every rank.

    Under a mesh the parameters are DTensors and each gradient comes back in
    its parameter's layout (:func:`~repro_torch.parallel.sharding.grad_layout`):
    the partial sums over the data axes that a data-sharded batch leaves
    are all-reduced (reduce-scattered for an ``fsdp`` shard), the psum
    GSPMD inserts after ``value_and_grad``."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree_unflatten(params, leaves), cfg, batch,
                                  backend=backend)
        root = loss.to_local() if isinstance(loss, DTensor) else loss
        grads = torch.autograd.grad(root, leaves, allow_unused=True)
    # contiguous: the optimizer reads each leaf's shard as one flat view
    grads = [torch.zeros_like(p) if g is None
             else grad_layout(g, p.placements).contiguous() if isinstance(p, DTensor) else g
             for p, g in zip(leaves, grads)]
    metrics = {k: _plain(v.detach()) for k, v in metrics.items()}
    return (_plain(loss.detach()), metrics), tree_unflatten(params, grads)


def _whole(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The global batch as plain tensors on every rank (a placed leaf
    gathered by c10d)."""
    return {k: gather_full(v) for k, v in batch.items()}


def _placed_like(batch: Dict[str, Tensor], part: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """``part`` (plain tensors, whole on every rank) placed as ``batch`` is:
    by :func:`batch_sharding` on the mesh of ``batch``'s DTensors, each
    rank keeping its slice; as it is when ``batch`` holds no DTensor."""
    placed = [v for v in batch.values() if isinstance(v, DTensor)]
    if not placed:
        return part
    mesh = placed[0].device_mesh
    return place(part, batch_sharding(None, mesh, part))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, backend: str = "cuda"):
    """The train step ``(state, batch) -> (state, metrics)``: JAX's
    ``value_and_grad`` of :func:`~repro_torch.models.model.loss_fn`, the
    ``accum_steps`` microbatches, the schedule and AdamW, the state updated
    in place. On a mesh the state is placed by :func:`state_shardings` and
    the batch by :func:`batch_sharding` (DTensors), the step runs inside
    ``parallel.sharding.set_mesh`` of that mesh, and it computes what JAX's
    step jitted with those shardings computes: a microbatch is the JAX one
    (global rows ``[i·B/a, (i+1)·B/a)``, placed again over the data axes),
    the gradients are reduced over the data axes in :func:`grads_of`, and
    the metrics are plain tensors, the same on every rank."""
    sched = make_schedule(tc)

    def train_step(state: TrainState, batch: Dict[str, Tensor]):
        if tc.accum_steps <= 1:
            (loss, metrics), grads = grads_of(state.params, cfg, batch, backend=backend)
        else:
            # gradient-accumulation microbatching: the global batch is split
            # on the batch dim into accum_steps microbatches run one after
            # another — activation memory scales by 1/accum_steps while the
            # optimizer math is unchanged
            a = tc.accum_steps
            micro = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))
                     for k, v in _whole(batch).items()}
            grads = metrics = None
            for i in range(a):
                mb = _placed_like(batch, {k: v[i] for k, v in micro.items()})
                (_, m), g = grads_of(state.params, cfg, mb, backend=backend)
                if grads is None:
                    grads, metrics = g, m
                else:
                    for acc, x in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.add_(x)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            inv = 1.0 / a
            for g in tree_leaves(grads):
                g.mul_(inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        lr = sched(local_shard(state.opt.step)[0])
        new_params, new_opt, om = adamw_update(grads, state.opt, state.params, tc, lr)
        metrics = dict(metrics, **om)
        return TrainState(new_params, new_opt), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, backend: str = "cuda"):
    """Full-sequence forward, returning ONLY last-position logits (the
    (B, S, V) tensor is never materialized — serving-realistic)."""

    def prefill_step(params, batch):
        hidden, _, _ = M._forward_trunk(params, cfg, batch, backend=backend)
        return lm_head(params["embed"], hidden[:, -1:], cfg)[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, token_or_embed, position):
        return M.decode_step(params, cfg, cache, token_or_embed, position)

    return decode_step


def abstract_state(decls, tc: TrainConfig) -> TrainState:
    """The train state of ``decls`` as ``meta`` tensors (shape and dtype, no
    storage): params in ``params_dtype``, moments in ``moments_dtype``, the
    float32 master when the params are not float32."""
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    pdt, mdt = getattr(torch, tc.params_dtype), getattr(torch, tc.moments_dtype)
    params = tree_map(lambda s: meta(s.shape, pdt), decl_to_abstract(decls))
    mom = lambda: tree_map(lambda s: meta(s.shape, mdt), params)
    master = None
    if pdt != torch.float32:
        master = tree_map(lambda s: meta(s.shape, torch.float32), params)
    return TrainState(params=params,
                      opt=AdamWState(step=meta((), torch.int32), mu=mom(), nu=mom(),
                                     master=master))


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def state_shardings(decls, pcfg, mesh, tc: TrainConfig) -> TrainState:
    """The train state's :class:`NamedSharding` tree: parameters and both
    moments by :func:`decl_to_sharding`, the step replicated, the float32
    master (only for a non-float32 ``params_dtype``) as the parameters."""
    p_sh = decl_to_sharding(decls, pcfg, mesh)
    rep = NamedSharding(mesh, P())
    master = p_sh if getattr(torch, tc.params_dtype) != torch.float32 else None
    return TrainState(params=p_sh, opt=AdamWState(step=rep, mu=p_sh, nu=p_sh, master=master))


def _dp(mesh):
    """(the data axes' entry, their size) of ``mesh``."""
    dp = data_axes_of(mesh)
    return (dp if len(dp) > 1 else dp[0]), math.prod(mesh_shape(mesh)[a] for a in dp)


def batch_sharding(cfg: ModelConfig, mesh, batch_tree):
    """Batch dict -> shardings: batch dim over (pod, data); rest replicated.
    Batch dims that don't divide the dp axes (long_500k's batch=1)
    replicate. The leaves need only ``ndim`` and ``shape``."""
    dp_entry, n_dp = _dp(mesh)

    def spec(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] % n_dp == 0 and leaf.shape[0] >= n_dp:
            return NamedSharding(mesh, P(*((dp_entry,) + (None,) * (leaf.ndim - 1))))
        return NamedSharding(mesh, P(*((None,) * leaf.ndim)))

    return tree_map(spec, batch_tree)


def _block_cache_spec(kind: str, cfg: ModelConfig, batch_entry):
    """PartitionSpecs for one block's decode cache. Self-attention caches are
    TIME-sharded over the model axis (decode attention reduces over time
    across the model ranks — flash-decoding style)."""
    b = batch_entry
    if kind in ("attn", "attn_moe", "shared_attn"):
        return {
            "k": P(b, "model", None, None),
            "v": P(b, "model", None, None),
            "positions": P(None),
            "pos": P(),
        }
    if kind == "cross":
        return {"k": P(b, "model", None, None), "v": P(b, "model", None, None)}
    if kind == "mamba":
        return {"conv": P(b, None, "model"), "ssm": P(b, "model", None, None), "pos": P()}
    if kind == "mlstm":
        return {"c": P(b, None, "model", None), "n": P(b, None, "model"), "m": P(b, None),
                "pos": P()}
    if kind == "slstm":
        return {k: P(b, None, "model") for k in ("c", "n", "h", "m")} | {"pos": P()}
    raise ValueError(kind)


def cache_shardings(cfg: ModelConfig, mesh, batch: int):
    """Sharding tree parallel to ``model.init_cache(params, cfg, batch,
    max_len)``'s: each pattern slot's specs behind the stacked ``n_super``
    axis, the tail's as they are."""
    dp_entry, n_dp = _dp(mesh)
    batch_entry = dp_entry if batch % n_dp == 0 and batch >= n_dp else None
    pattern, n_super, tail = M.block_pattern(cfg)

    def stack_spec(spec_tree):
        return tree_map(lambda s: P(*((None,) + tuple(s))), spec_tree)

    tree = {
        "pattern": [stack_spec(_block_cache_spec(k, cfg, batch_entry)) for k in pattern],
        "tail": [_block_cache_spec(k, cfg, batch_entry) for k in tail],
    }
    return tree_map(lambda s: NamedSharding(mesh, s), tree)
