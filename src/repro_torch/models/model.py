"""Model assembly: super-block patterns, stacked layer parameters, caches
(counterpart of ``repro/models/model.py``), for every family.

Every architecture is a repeating *super-block* pattern (a list of block
kinds) stacked ``n_super`` times, plus an optional unrolled tail:

    dense           ["attn"]                        x n_layers
    dbrx            ["attn_moe"]                    x 40
    llama4-maverick ["attn", "attn_moe"]            x 24   (interleaved MoE)
    zamba2          ["mamba"]*5 + ["shared_attn"]   x 6  + ["mamba"]*2
    xlstm           ["mlstm", "slstm"]              x 12
    llama3.2-vision ["attn"]*4 + ["cross"]          x 20

zamba2's shared attention block reuses ONE parameter set
(``params["shared_attn"]``) at every occurrence; each occurrence has its
own KV cache, stacked over ``n_super``. The modality frontends are stubs:
an ``embed_frontend_stub`` architecture (musicgen) takes precomputed frame
embeddings, and the vlm's cross-attention reads patch embeddings
(``vis_embeds``), whose K/V :func:`init_cache` computes once for decode.

The stacked parameters keep their leading ``n_super`` axis, so the
parameter tree matches the JAX package's name for name and shape for shape
(:func:`repro_torch.convert.params_from_numpy` carries one across);
:func:`forward` loops over that axis where JAX scans it. The scan levers of
the config are compile levers and are dead here.

Training (:func:`loss_fn`, over :func:`_forward_trunk`): the causal LM loss,
a chunked cross entropy over ``loss_chunk`` positions so the (B, S, V)
logits never exist at once, plus the MoE aux terms. ``cfg.remat`` is JAX's
``jax.checkpoint`` as ``torch.utils.checkpoint`` (non-reentrant): a
super-block and a loss chunk keep only their inputs and run again in the
backward. The recomputation re-runs the MoE routing, which must route as
the first run did: a token's rank is its stable position among the tokens
of its expert, which K1 and K3 (and every backend) compute without
atomics, so the ranks come out bitwise the same.

:class:`Transformer` is a thin ``nn.Module`` over these functions: it
registers the parameter tree and calls them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (
    apply_norm,
    attention_block,
    attention_decl,
    embed_decl,
    embed_tokens,
    lm_head,
    mlp_block,
    mlp_decl,
)
from repro_torch.parallel.sharding import (
    ParamDecl,
    distribute_input,
    gather_fsdp,
    get_mesh,
    init_params,
    place,
    set_mesh,
    settle,
    tree_map,
)

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Patterns
# ---------------------------------------------------------------------------

def block_pattern(cfg: ModelConfig) -> Tuple[List[str], int, List[str]]:
    """Returns (pattern, n_super, tail), for every family (the JAX rules)."""
    if cfg.family == "hybrid" and cfg.ssm.attn_every:
        per = cfg.ssm.attn_every
        pattern = ["mamba"] * (per - 1) + ["shared_attn" if cfg.ssm.shared_attn else "attn"]
        n_super = cfg.n_layers // per
        return pattern, n_super, ["mamba"] * (cfg.n_layers - n_super * per)
    if cfg.family == "ssm" and cfg.slstm_every:
        per = cfg.slstm_every
        n_super = cfg.n_layers // per
        tail = ["mlstm"] * (cfg.n_layers - n_super * per)
        return ["mlstm"] * (per - 1) + ["slstm"], n_super, tail
    if cfg.family == "vlm" and cfg.cross_attn_every:
        per = cfg.cross_attn_every
        n_super = cfg.n_layers // per
        tail = ["attn"] * (cfg.n_layers - n_super * per)
        return ["attn"] * (per - 1) + ["cross"], n_super, tail
    if cfg.family == "moe":
        per = cfg.moe.every
        if per <= 1:
            return ["attn_moe"], cfg.n_layers, []
        n_super = cfg.n_layers // per
        tail = ["attn"] * (cfg.n_layers - n_super * per)
        return ["attn"] * (per - 1) + ["attn_moe"], n_super, tail
    return ["attn"], cfg.n_layers, []


def _block_decl(kind: str, cfg: ModelConfig):
    if kind == "attn":
        return {"attn": attention_decl(cfg), "mlp": mlp_decl(cfg)}
    if kind == "attn_moe":
        return {"attn": attention_decl(cfg), "moe": moe_mod.moe_decl(cfg)}
    if kind == "cross":
        return {"cross": attention_decl(cfg, cross=True), "mlp": mlp_decl(cfg)}
    if kind == "mamba":
        return ssm_mod.mamba2_decl(cfg)
    if kind == "mlstm":
        return xlstm_mod.mlstm_decl(cfg)
    if kind == "slstm":
        return xlstm_mod.slstm_decl(cfg)
    if kind == "shared_attn":
        return None  # parameters live once in params["shared_attn"]
    raise ValueError(kind)


def _stack_decl(decl, n: int):
    return tree_map(lambda d: ParamDecl((n,) + d.shape, (None,) + d.axes, d.dtype, d.init,
                                        d.scale), decl)


def decl_model(cfg: ModelConfig):
    """Full declaration tree for one architecture."""
    pattern, n_super, tail = block_pattern(cfg)
    decl = {
        "embed": embed_decl(cfg),
        "blocks": [_stack_decl(_block_decl(kind, cfg), n_super) for kind in pattern
                   if kind != "shared_attn"],
        "tail": [_block_decl(kind, cfg) for kind in tail],
    }
    if "shared_attn" in pattern:
        decl["shared_attn"] = {"attn": attention_decl(cfg), "mlp": mlp_decl(cfg)}
    return decl


def _pattern_param_slots(pattern: List[str]) -> List[Optional[int]]:
    """pattern position -> index into params['blocks'] (None for shared)."""
    slots, i = [], 0
    for kind in pattern:
        if kind == "shared_attn":
            slots.append(None)
        else:
            slots.append(i)
            i += 1
    return slots


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _attn_cache_decl(cfg: ModelConfig, batch: int, max_len: int, window: Optional[int]):
    k, hd = cfg.n_kv, cfg.hd()
    size = min(window, max_len) if window else max_len
    dt = getattr(torch, cfg.dtype)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    return {
        "k": meta((batch, size, k, hd), dt),
        "v": meta((batch, size, k, hd), dt),
        "positions": meta((size,), torch.int32),
        "pos": meta((), torch.int32),
    }


def _block_cache_decl(kind: str, cfg: ModelConfig, batch: int, max_len: int):
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    if kind in ("attn", "attn_moe", "shared_attn"):
        return _attn_cache_decl(cfg, batch, max_len, cfg.window)
    if kind == "cross":
        k, hd = cfg.n_kv, cfg.hd()
        dt = getattr(torch, cfg.dtype)
        return {"k": meta((batch, cfg.n_vis_tokens, k, hd), dt),
                "v": meta((batch, cfg.n_vis_tokens, k, hd), dt)}
    if kind == "mamba":
        return ssm_mod.mamba2_cache_decl(cfg, batch)
    if kind == "mlstm":
        d_inner, nh, hd = xlstm_mod._mdims(cfg)
        return {"c": meta((batch, nh, hd, hd), torch.float32),
                "n": meta((batch, nh, hd), torch.float32),
                "m": meta((batch, nh), torch.float32),
                "pos": meta((), torch.int32)}
    if kind == "slstm":
        nh = cfg.n_heads
        shp = (batch, nh, cfg.d_model // nh)
        return {**{name: meta(shp, torch.float32) for name in ("c", "n", "h", "m")},
                "pos": meta((), torch.int32)}
    raise ValueError(kind)


def cache_decl(cfg: ModelConfig, batch: int, max_len: int):
    """Abstract cache tree (``meta`` tensors; no allocation)."""
    pattern, n_super, tail = block_pattern(cfg)
    stack = lambda tree, n: tree_map(
        lambda s: torch.empty((n,) + tuple(s.shape), dtype=s.dtype, device="meta"), tree)
    return {
        "pattern": [stack(_block_cache_decl(kind, cfg, batch, max_len), n_super)
                    for kind in pattern],
        "tail": [_block_cache_decl(kind, cfg, batch, max_len) for kind in tail],
    }


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int, vis_embeds=None):
    """Concrete zero cache on the parameters' device; positions start at -1
    (invalid). Under a mesh of more than one device it is placed by
    ``launch.steps.cache_shardings`` (K/V time-sharded over ``model``). The caches of one pattern slot are stacked over ``n_super``
    like its parameters. Each cross slot's K/V are computed here, once,
    from ``vis_embeds`` (B, n_vis, d): ``norm_kv``, then ``wk`` and ``wv``
    of each stacked layer, in ``vis_embeds``' dtype. The recurrent states
    start at zero (mLSTM and sLSTM ``m`` too, as in the JAX cache)."""
    device = params["embed"]["norm_f"]["scale"].device
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                     cache_decl(cfg, batch, max_len))
    cache = _map_named(cache, "positions", lambda z: z - 1)
    mesh = get_mesh()
    if mesh is not None and mesh.size() > 1:
        from repro_torch.launch.steps import cache_shardings

        cache = place(cache, cache_shardings(cfg, mesh, batch))
    if vis_embeds is not None:
        pattern, n_super, _ = block_pattern(cfg)
        slots = _pattern_param_slots(pattern)
        dt = vis_embeds.dtype
        for pi, kind in enumerate(pattern):
            if kind != "cross":
                continue
            layers = [_layer(params["blocks"][slots[pi]], i)["cross"] for i in range(n_super)]
            srcs = [apply_norm(lp["norm_kv"], vis_embeds, cfg) for lp in layers]
            cache["pattern"][pi] = {
                name: torch.stack([torch.einsum("bsd,dhk->bshk", src, lp[w].to(dt))
                                   for lp, src in zip(layers, srcs)])
                for name, w in (("k", "wk"), ("v", "wv"))}
    return cache


def _map_named(tree, name, fn):
    def walk(t):
        if isinstance(t, dict):
            return {k: (fn(v) if k == name else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t

    return walk(tree)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_block(
    kind: str,
    p,
    x: Tensor,
    cfg: ModelConfig,
    *,
    positions: Tensor,
    cache=None,
    vis_embeds=None,
    shared_params=None,
    backend: str = "cuda",
):
    """Returns (x_out, cache, aux). A decode cache is updated in place."""
    aux = _zero_aux(x.device)
    if kind in ("attn", "attn_moe", "shared_attn"):
        pp = shared_params if kind == "shared_attn" else p
        dx, cache = attention_block(pp["attn"], x, cfg, positions=positions, cache=cache,
                                    window=cfg.window, backend=backend)
        x = x + dx
        if kind == "attn_moe":
            dx, aux = moe_mod.moe_block(p["moe"], x, cfg, backend=backend)
            x = x + dx
        else:
            x = x + mlp_block(pp["mlp"], x, cfg)
        return x, cache, aux
    if kind == "cross":
        dx, cache = attention_block(p["cross"], x, cfg, positions=positions, cross=True,
                                    kv_src=vis_embeds if cache is None else None, cache=cache,
                                    backend=backend)
        x = x + dx
        return x + mlp_block(p["mlp"], x, cfg), cache, aux
    blocks = {"mamba": ssm_mod.mamba2_block, "mlstm": xlstm_mod.mlstm_block,
              "slstm": xlstm_mod.slstm_block}
    if kind not in blocks:
        raise ValueError(kind)
    dx, cache = blocks[kind](p, x, cfg, cache=cache)
    return x + dx, cache, aux


def _zero_aux(device) -> moe_mod.MoEAux:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return moe_mod.MoEAux(z, z, z)


def _add_aux(a, b):
    return moe_mod.MoEAux(*(x + y for x, y in zip(a, b)))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: a view of every leaf."""
    return tree_map(lambda t: t[i], tree)


def forward(
    params,
    cfg: ModelConfig,
    *,
    tokens: Optional[Tensor] = None,      # (B, S) integers
    embeds: Optional[Tensor] = None,      # (B, S, d): frontend-stub archs
    positions: Optional[Tensor] = None,   # (S,)
    cache=None,
    vis_embeds: Optional[Tensor] = None,  # (B, n_vis, d): vlm prefill
    backend: str = "cuda",
):
    """Returns (logits, cache, aux). With a cache (decode, one token a
    step) every layer's cache is updated in place and the tree returned.
    ``backend`` is the MoE routing's multisplit backend; on ``cuda``
    attention inside B11's contract goes through the kernel door, on any
    other backend through its plain version. ``embeds`` replaces the token
    table's lookup (frontend-stub archs); ``vis_embeds`` is the source of
    the cross blocks at prefill (at decode they read the cache)."""
    pattern, n_super, tail = block_pattern(cfg)
    slots = _pattern_param_slots(pattern)
    dtype = getattr(torch, cfg.dtype)
    # fsdp: the weights are gathered at use, as in the trunk (a no-op without fsdp)
    embed = gather_fsdp(params["embed"])
    if embeds is None:
        x = embed_tokens(embed, distribute_input(tokens, "dp", None), cfg)
    else:
        x = distribute_input(embeds.to(dtype), "dp", None, None)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    if vis_embeds is not None:
        vis_embeds = distribute_input(vis_embeds.to(dtype), "dp", None, None)
    run = dict(positions=positions, vis_embeds=vis_embeds,
               shared_params=gather_fsdp(params.get("shared_attn")), backend=backend)

    aux = _zero_aux(x.device)
    for i in range(n_super):
        for pi, kind in enumerate(pattern):
            c = None if cache is None else _layer(cache["pattern"][pi], i)
            p = None if slots[pi] is None else gather_fsdp(_layer(params["blocks"][slots[pi]], i))
            x, _, a = apply_block(kind, p, x, cfg, cache=c, **run)
            aux = _add_aux(aux, a)
    for ti, kind in enumerate(tail):
        c = None if cache is None else cache["tail"][ti]
        x, _, a = apply_block(kind, gather_fsdp(params["tail"][ti]), x, cfg, cache=c, **run)
        aux = _add_aux(aux, a)
    return lm_head(embed, x, cfg), cache, aux


# ---------------------------------------------------------------------------
# Loss (chunked over the sequence: the (B, S, V) logits never exist at once)
# ---------------------------------------------------------------------------

def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` (JAX's
    ``jax.checkpoint``): its activations are recomputed in the backward.
    The recomputation runs in the mesh that was in scope at the call
    (:func:`set_mesh` again: on the card the backward runs on autograd's
    device thread, where the caller's context is not), so it takes the
    same branches and layouts as the first run."""
    if not cfg.remat:
        return fn
    mesh = get_mesh()

    def body(*args):
        with set_mesh(mesh):
            return fn(*args)

    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, each leaf split once along its
    leading axis (one gradient for the stack, where ``t[i]`` a layer would
    scatter a full-size gradient per layer); one layer is a plain view."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        per = [_unstack(v, n) for v in tree]
        return [type(tree)(p[i] for p in per) for i in range(n)]
    if tree is None:
        return [None] * n
    return [tree.squeeze(0)] if n == 1 else list(tree.unbind(0))


def _forward_trunk(params, cfg: ModelConfig, batch: Dict[str, Tensor], *,
                   backend: str = "cuda"):
    """:func:`forward` minus the LM head, with no cache: returns (final
    hidden states (B, S, d), None, aux). ``batch`` holds ``tokens`` (or
    ``embeds`` for a frontend-stub arch) and, for a vlm, ``vis_embeds``.
    Each super-block is one checkpointed region under ``cfg.remat``; the
    tail's blocks are not, as in JAX."""
    pattern, n_super, tail = block_pattern(cfg)
    slots = _pattern_param_slots(pattern)
    dtype = getattr(torch, cfg.dtype)
    if cfg.embed_frontend_stub:
        x = distribute_input(batch["embeds"].to(dtype), "dp", None, None)
    else:
        x = embed_tokens(gather_fsdp(params["embed"]), distribute_input(batch["tokens"], "dp",
                                                                        None), cfg)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    vis_embeds = batch.get("vis_embeds")
    if vis_embeds is not None:
        vis_embeds = distribute_input(vis_embeds.to(dtype), "dp", None, None)
    run = dict(positions=positions, vis_embeds=vis_embeds, backend=backend)
    layers = [_unstack(stack, n_super) for stack in params["blocks"]]

    def superblock(x, i):
        # fsdp: a layer's weights are gathered here, at use, and again in
        # the recomputation (ZeRO-3); with fsdp off this changes nothing
        shared = gather_fsdp(params.get("shared_attn"))
        aux = _zero_aux(x.device)
        for pi, kind in enumerate(pattern):
            p = None if slots[pi] is None else gather_fsdp(layers[slots[pi]][i])
            x, _, a = apply_block(kind, p, x, cfg, shared_params=shared, **run)
            aux = _add_aux(aux, a)
        return (x, *aux)

    superblock = _remat(superblock, cfg)
    aux = _zero_aux(x.device)
    for i in range(n_super):
        x, *a = superblock(x, i)
        aux = _add_aux(aux, moe_mod.MoEAux(*a))
    shared = gather_fsdp(params.get("shared_attn"))
    for ti, kind in enumerate(tail):
        x, _, a = apply_block(kind, gather_fsdp(params["tail"][ti]), x, cfg,
                              shared_params=shared, **run)
        aux = _add_aux(aux, a)
    return x, None, aux


def _sharded_xent_terms(logits: Tensor, lab: Tensor) -> Tuple[Tensor, Tensor]:
    """(logsumexp, the label's logit) of DTensor ``logits`` (B, chunk, V),
    vocab-sharded or not, in float32: the max and the sum over the vocab
    reduced where they arise (:func:`settle`: a MAX and a SUM all-reduce
    over ``model`` when the vocab is sharded), and the label's logit picked
    in each rank's vocab shard by a mask — the other shards add exact zeros
    — as GSPMD lowers ``take_along_axis``; DTensor's own ``gather`` has no
    sharded rule and would replicate the logits. The max is held constant
    in the gradient, as ``logsumexp``'s is."""
    m = settle(logits.detach().amax(-1))
    lse = m.float() + torch.log(settle(torch.exp(logits - m[..., None]).sum(
        -1, dtype=torch.float32)))
    col = torch.arange(logits.shape[-1], device=logits.device)
    hit = col == lab.clamp_min(0).long()[..., None]
    picked = settle(torch.where(hit, logits, 0.0).sum(-1)).float()
    return lse, picked


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Tensor], *, backend: str = "cuda"):
    """Causal LM loss: (loss, metrics). ``batch``: ``tokens`` (or
    ``embeds``), ``labels`` (B, S) with -1 where no token is predicted, and
    ``vis_embeds`` for a vlm. The cross entropy runs over chunks of
    ``loss_chunk`` positions (the labels padded with -1 to a whole chunk),
    each chunk's logits in float32, or, with ``loss_bf16_logits``, in the
    compute dtype with the logsumexp summed in float32; the MoE aux terms
    are added to the mean. The metrics are JAX's: loss, the two aux losses,
    the drop fraction and the count of labelled tokens. Under a mesh the
    labels are sharded as the tokens, the head's logits are vocab-sharded
    DTensors (:func:`_sharded_xent_terms`), and a chunk's sums are reduced
    over the data axes where they are made, so the mean is the global
    batch's."""
    labels = distribute_input(batch["labels"], "dp", None)
    trunk_out, _, aux = _forward_trunk(params, cfg, batch, backend=backend)
    head = gather_fsdp(params["embed"])
    b, s, d = trunk_out.shape
    chunk = min(cfg.loss_chunk, s)
    pad = (-s) % chunk
    if pad:
        trunk_out = torch.nn.functional.pad(trunk_out, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def chunk_loss(h, lab):
        logits = lm_head(head, h, cfg)
        if not cfg.loss_bf16_logits:
            logits = logits.float()
        if isinstance(logits, DTensor):
            lse, picked = _sharded_xent_terms(logits, lab)
        else:
            if cfg.loss_bf16_logits:
                # the logsumexp accumulates in fp32 without an fp32 (B, chunk, V) tensor
                m = logits.amax(-1)
                lse = m.float() + torch.log(torch.exp(logits - m[..., None]).sum(
                    -1, dtype=torch.float32))
            else:
                lse = torch.logsumexp(logits, -1)
            picked = logits.gather(-1, lab.clamp_min(0).long()[..., None])[..., 0].float()
        valid = lab >= 0
        # a data-sharded chunk's sums are partial over the data axes: reduced here
        return (settle(torch.where(valid, lse - picked, 0.0).sum()),
                settle(valid.sum(dtype=torch.int32)))

    body = _remat(chunk_loss, cfg)
    total = torch.zeros((), dtype=torch.float32, device=trunk_out.device)
    count = torch.zeros((), dtype=torch.int32, device=trunk_out.device)
    for c in range(trunk_out.shape[1] // chunk):
        nll, n = body(trunk_out[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk])
        total, count = total + nll, count + n
    loss = total / count.clamp_min(1)
    if cfg.moe.num_experts:
        loss = loss + cfg.moe.aux_loss * aux.load_balance + cfg.moe.router_z_loss * aux.router_z
    metrics = {
        "loss": loss,
        "aux_load_balance": aux.load_balance,
        "aux_router_z": aux.router_z,
        "moe_drop_fraction": aux.drop_fraction,
        "tokens": count,
    }
    return loss, metrics


def decode_step(params, cfg: ModelConfig, cache, token_or_embed, position):
    """One serving step: (B, 1) tokens (a (B, 1, d) frame embedding for a
    frontend-stub arch) + cache -> logits (B, 1, V). ``position``: the
    scalar absolute position of the new token (an int or a 0-d tensor)."""
    device = token_or_embed.device
    if isinstance(position, int):              # filled on the device: no host copy
        positions = torch.full((1,), position, dtype=torch.int32, device=device)
    else:
        position = torch.as_tensor(position, dtype=torch.int32, device=device)
        positions = position[None] if position.dim() == 0 else position
    key = "embeds" if cfg.embed_frontend_stub else "tokens"
    logits, cache, _ = forward(params, cfg, positions=positions, cache=cache,
                               **{key: token_or_embed})
    return logits, cache


class Transformer(nn.Module):
    """Every family as an ``nn.Module``: the parameter tree of
    :func:`decl_model`, drawn by :func:`init_params` from ``generator``
    (or carried in as ``params``), registered leaf by leaf under its tree
    path as trainable parameters; ``forward``, ``init_cache``,
    ``decode_step`` and ``loss`` call the functions of this module."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 params=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(decl_model(cfg), generator, dtype)
        def register(path, t):
            name = "_".join(path)
            self.register_parameter(name, nn.Parameter(t))
            return name

        def walk(tree, path):
            if isinstance(tree, dict):
                return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
            return register(path, tree)

        self._layout = walk(params, ())

    @property
    def params(self):
        """The parameter tree, its leaves the registered parameters."""
        return tree_map(lambda name: getattr(self, name), self._layout)

    def forward(self, tokens: Optional[Tensor] = None, embeds: Optional[Tensor] = None,
                vis_embeds: Optional[Tensor] = None):
        return forward(self.params, self.cfg, tokens=tokens, embeds=embeds,
                       vis_embeds=vis_embeds)

    def init_cache(self, batch: int, max_len: int, vis_embeds: Optional[Tensor] = None):
        return init_cache(self.params, self.cfg, batch, max_len, vis_embeds=vis_embeds)

    def decode_step(self, cache, token_or_embed: Tensor, position):
        return decode_step(self.params, self.cfg, cache, token_or_embed, position)

    def loss(self, batch: Dict[str, Tensor], *, backend: str = "cuda"):
        """:func:`loss_fn` on the registered parameters: (loss, metrics)."""
        return loss_fn(self.params, self.cfg, batch, backend=backend)
