"""Model assembly: super-block patterns, stacked layer parameters, caches
(counterpart of ``repro/models/model.py``) for the ``dense`` and ``moe``
families.

Every architecture is a repeating *super-block* pattern (a list of block
kinds) stacked ``n_super`` times, plus an optional unrolled tail:

    dense           ["attn"]                        x n_layers
    dbrx            ["attn_moe"]                    x 40
    llama4-maverick ["attn", "attn_moe"]            x 24   (interleaved MoE)

The stacked parameters keep their leading ``n_super`` axis, so the
parameter tree matches the JAX package's name for name and shape for shape
(:func:`repro_torch.convert.params_from_numpy` carries one across);
:func:`forward` loops over that axis where JAX scans it. The scan and remat
levers of the config are compile and training levers and are dead here.
The ``hybrid``, ``ssm``, ``vlm`` and ``audio`` families come with ROADMAP
A13a: :func:`decl_model`, :func:`init_cache` and :func:`forward` raise
``NotImplementedError`` for them.

:class:`Transformer` is a thin ``nn.Module`` over these functions: it
registers the parameter tree and calls them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    attention_block,
    attention_decl,
    embed_decl,
    embed_tokens,
    lm_head,
    mlp_block,
    mlp_decl,
)
from repro_torch.parallel.sharding import ParamDecl, init_params, tree_map

Tensor = torch.Tensor

FAMILIES = ("dense", "moe")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family has no port yet (ROADMAP A13a brings the "
            f"hybrid, ssm, vlm and audio families); the port runs {FAMILIES}")


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
    raise NotImplementedError(f"block kind {kind!r} comes with ROADMAP A13a")


def _stack_decl(decl, n: int):
    return tree_map(lambda d: ParamDecl((n,) + d.shape, (None,) + d.axes, d.dtype, d.init,
                                        d.scale), decl)


def decl_model(cfg: ModelConfig):
    """Full declaration tree for one architecture."""
    _check_family(cfg)
    pattern, n_super, tail = block_pattern(cfg)
    return {
        "embed": embed_decl(cfg),
        "blocks": [_stack_decl(_block_decl(kind, cfg), n_super) for kind in pattern],
        "tail": [_block_decl(kind, cfg) for kind in tail],
    }


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


def cache_decl(cfg: ModelConfig, batch: int, max_len: int):
    """Abstract cache tree (``meta`` tensors; no allocation)."""
    _check_family(cfg)
    pattern, n_super, tail = block_pattern(cfg)
    stack = lambda tree, n: tree_map(
        lambda s: torch.empty((n,) + tuple(s.shape), dtype=s.dtype, device="meta"), tree)
    one = lambda: _attn_cache_decl(cfg, batch, max_len, cfg.window)
    return {"pattern": [stack(one(), n_super) for _ in pattern], "tail": [one() for _ in tail]}


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int, vis_embeds=None):
    """Concrete zero cache on the parameters' device; positions start at -1
    (invalid). The caches of one pattern slot are stacked over ``n_super``
    like its parameters. Cross-attention K/V (``vis_embeds``) come with the
    vlm family (ROADMAP A13a)."""
    _check_family(cfg)
    if vis_embeds is not None:
        raise NotImplementedError("cross-attention K/V come with ROADMAP A13a")
    device = params["embed"]["norm_f"]["scale"].device
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
                     cache_decl(cfg, batch, max_len))
    return _map_named(cache, "positions", lambda z: z - 1)


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
    backend: str = "cuda",
):
    """Returns (x_out, cache, aux)."""
    if kind not in ("attn", "attn_moe"):
        raise NotImplementedError(f"block kind {kind!r} comes with ROADMAP A13a")
    aux = _zero_aux(x.device)
    dx, cache = attention_block(p["attn"], x, cfg, positions=positions, cache=cache,
                                window=cfg.window, backend=backend)
    x = x + dx
    if kind == "attn_moe":
        dx, aux = moe_mod.moe_block(p["moe"], x, cfg, backend=backend)
        x = x + dx
    else:
        x = x + mlp_block(p["mlp"], x, cfg)
    return x, cache, aux


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
    embeds: Optional[Tensor] = None,      # (B, S, d): frontend-stub archs (ROADMAP A13a)
    positions: Optional[Tensor] = None,   # (S,)
    cache=None,
    vis_embeds: Optional[Tensor] = None,  # (B, n_vis, d): vlm (ROADMAP A13a)
    backend: str = "cuda",
):
    """Returns (logits, cache, aux). With a cache (decode, one token a
    step) every layer's cache is updated in place and the tree returned.
    ``backend`` is the MoE routing's multisplit backend; on ``cuda``
    attention inside B11's contract goes through the kernel door, on any
    other backend through its plain version."""
    _check_family(cfg)
    if embeds is not None or vis_embeds is not None:
        raise NotImplementedError("frame and vision embeddings come with ROADMAP A13a")
    pattern, n_super, tail = block_pattern(cfg)
    slots = _pattern_param_slots(pattern)
    x = embed_tokens(params["embed"], tokens, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    run = dict(positions=positions, backend=backend)

    aux = _zero_aux(x.device)
    for i in range(n_super):
        for pi, kind in enumerate(pattern):
            c = None if cache is None else _layer(cache["pattern"][pi], i)
            x, _, a = apply_block(kind, _layer(params["blocks"][slots[pi]], i), x, cfg,
                                  cache=c, **run)
            aux = _add_aux(aux, a)
    for ti, kind in enumerate(tail):
        c = None if cache is None else cache["tail"][ti]
        x, _, a = apply_block(kind, params["tail"][ti], x, cfg, cache=c, **run)
        aux = _add_aux(aux, a)
    return lm_head(params["embed"], x, cfg), cache, aux


def decode_step(params, cfg: ModelConfig, cache, token, position):
    """One serving step: (B, 1) tokens + cache -> logits (B, 1, V).
    ``position``: the scalar absolute position of the new token (an int or
    a 0-d tensor)."""
    if isinstance(position, int):              # filled on the device: no host copy
        positions = torch.full((1,), position, dtype=torch.int32, device=token.device)
    else:
        position = torch.as_tensor(position, dtype=torch.int32, device=token.device)
        positions = position[None] if position.dim() == 0 else position
    logits, cache, _ = forward(params, cfg, tokens=token, positions=positions, cache=cache)
    return logits, cache


class Transformer(nn.Module):
    """The dense and MoE families as an ``nn.Module``: the parameter tree of
    :func:`decl_model`, drawn by :func:`init_params` from ``generator``
    (or carried in as ``params``), registered leaf by leaf under its tree
    path; ``forward``, ``init_cache`` and ``decode_step`` call the
    functions of this module."""

    def __init__(self, cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                 params=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(decl_model(cfg), generator, dtype)
        def register(path, t):
            name = "_".join(path)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
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

    def forward(self, tokens: Tensor):
        return forward(self.params, self.cfg, tokens=tokens)

    def init_cache(self, batch: int, max_len: int):
        return init_cache(self.params, self.cfg, batch, max_len)

    def decode_step(self, cache, token: Tensor, position):
        return decode_step(self.params, self.cfg, cache, token, position)
