#!/usr/bin/env python3
"""The global gradient norm of tinyllama-1.1b at its init, by depth, in the
JAX package's model and the port's.

    JAX_PLATFORMS=cpu python3 tools/grad_norm_depth.py --jax [--layers 1 2 3 4]
    JAX_PLATFORMS=cpu python3 tools/grad_norm_depth.py --jax --narrow --layers 2 12 22
    python3 tools/grad_norm_depth.py [--layers 1 2 4 8 12 16 22] [--tokens 4 2048]   # one CUDA card

``--jax`` (the CPU): for each depth, parameters drawn by the JAX package's
``init_params`` from ``PRNGKey(0)``, one batch of 1 x 32 tokens from numpy
seed 0, float32 compute; ``jax.value_and_grad`` of the JAX ``loss_fn`` and
the port's ``launch.steps.grads_of`` on the same parameters and batch. Both
global norms are printed, with their ratio, and JAX's own norm, as a
ratio to the unperturbed one, when every parameter is scaled by
(1 + 2^-21 · N(0, 1)), for three draws: how far rounding alone moves the
JAX model's norm at that depth. Every width is tinyllama's
(d_model 2048, 32 heads, 4 kv heads, d_ff 5632, vocab 32000); ``--narrow``
takes the widths of ``tests/test_torch_train.py``'s depth test (d_model
256, 8 heads, 2 kv heads, head_dim 32, the smoke config's d_ff and vocab)
so that the full depth of 22 layers fits a small host.

Without ``--jax`` (one CUDA card, no JAX): the port alone at full width,
its own ``init_params`` from a seeded generator, the same batch recipe
(``--tokens`` sets its batch and length), in float32 and in the config's
bfloat16 compute, at each depth. Also printed: each projection's standard
deviation at init, which the init rule sets from ``shape[-2]``
(``repro/parallel/sharding.py:154``; for the 3-d projections that is the
head axis, not d_model); and at the deepest depth, in bfloat16, the
leaves that hold most of the squared norm and the share of all elements
whose gradient, clipped to a global norm of 1 as AdamW's ``clip_norm``
does, is below AdamW's ``eps``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEQ = 32


def _batch(vocab, batch=1, seq=SEQ):
    import numpy as np

    t = np.random.RandomState(0).randint(0, vocab, (batch, seq + 1)).astype(np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _narrow(cfg):
    return dataclasses.replace(cfg, d_model=256, n_heads=8, n_kv=2, head_dim=32)


def jax_against_port(layers, narrow: bool) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as jget
    from repro.models import model as JM
    from repro.optim import adamw as jadamw
    from repro.parallel.sharding import init_params as jinit
    from repro_torch import convert
    from repro_torch.launch import steps as TS
    from repro_torch.optim import adamw as tadamw

    base = _narrow(jget("tinyllama-1.1b").smoke()) if narrow else jget("tinyllama-1.1b")
    print(f"tinyllama-1.1b widths: d_model {base.d_model}, heads {base.n_heads}, kv "
          f"{base.n_kv}, head_dim {base.head_dim}, d_ff {base.d_ff}, vocab {base.vocab}; "
          f"1 x {SEQ} tokens, float32")
    for n in layers:
        jc = dataclasses.replace(base, n_layers=n, dtype="float32")
        batch = _batch(jc.vocab)
        jp = jinit(JM.decl_model(jc), jax.random.PRNGKey(0))
        _, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jc, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        j_norm = float(jadamw.global_norm(jg))
        leaves, tdef = jax.tree.flatten(jp)
        moved_norms = []
        for draw in range(1, 4):
            keys = jax.random.split(jax.random.PRNGKey(draw), len(leaves))
            moved = jax.tree.unflatten(tdef, [
                w * (1 + 2.0 ** -21 * jax.random.normal(kk, w.shape, w.dtype))
                for w, kk in zip(leaves, keys)])
            _, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jc, b),
                                               has_aux=True))(
                moved, {k: jnp.asarray(v) for k, v in batch.items()})
            moved_norms.append(float(jadamw.global_norm(jg)))
            del jg, moved
        del leaves
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        del jp
        (_, _), tg = TS.grads_of(params, convert.convert_config(jc),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
        t_norm = float(tadamw.global_norm(tg))
        del params, tg
        print(f"{n} layers: JAX {j_norm:.6e}, port {t_norm:.6e}, port / JAX "
              f"{t_norm / j_norm:.6f}; JAX perturbed / JAX "
              + ", ".join(f"{m / j_norm:.6f}" for m in moved_norms), flush=True)


def port_on_card(layers, tokens) -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import build
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as tadamw
    from repro_torch.parallel.sharding import init_params, tree_leaves_with_path

    if not torch.cuda.is_available():
        print("grad_norm_depth: without --jax this script needs a CUDA card", file=sys.stderr)
        return 2
    build.build_all()
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; the port alone, {tokens[0]} x {tokens[1]} tokens")
    full = get_config("tinyllama-1.1b")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _batch(full.vocab, *tokens).items()}
    tc = TrainConfig()
    for n in layers:
        row = []
        for dtype in dict.fromkeys(("float32", full.dtype)):
            cfg = dataclasses.replace(full, n_layers=n, dtype=dtype)
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            params = init_params(M.decl_model(cfg), g)
            if n == layers[0] and dtype == "float32":
                attn = params["blocks"][0]["attn"]
                print("init std of layer 0's projections: "
                      + ", ".join(f"{w} {float(attn[w][0].std()):.4f}"
                                  for w in ("wq", "wk", "wv", "wo"))
                      + f" (1/sqrt(d_model) = {full.d_model ** -0.5:.4f})")
            (_, _), grads = TS.grads_of(params, cfg, batch)
            norm = float(tadamw.global_norm(grads))
            row.append(f"{dtype} {norm:.6e}")
            if n == layers[-1] and dtype == full.dtype:
                leaves = tree_leaves_with_path(grads)
                sq = {p: float(g.double().square().sum()) for p, g in leaves}
                top = sorted(sq, key=sq.get, reverse=True)[:5]
                clip = min(1.0, tc.clip_norm / norm)
                small = sum(int((g.abs() * clip < tc.eps).sum()) for _, g in leaves)
                total = sum(g.numel() for _, g in leaves)
                detail = (f"  {n} layers, {dtype}: the squared norm's largest shares "
                          + ", ".join(f"{p} {sq[p] / norm ** 2:.4f}" for p in top)
                          + f"; clipped gradient below eps {tc.eps:g}: {small / total:.6f} "
                          f"of {total} elements")
            del params, grads
            torch.cuda.empty_cache()
        print(f"{n} layers: " + ", ".join(row), flush=True)
    print(detail)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax", action="store_true", help="JAX against the port, on the CPU")
    ap.add_argument("--narrow", action="store_true", help="with --jax: the test's widths")
    ap.add_argument("--layers", type=int, nargs="+")
    ap.add_argument("--tokens", type=int, nargs=2, default=(1, SEQ), metavar=("BATCH", "SEQ"),
                    help="without --jax: the batch's shape")
    args = ap.parse_args(argv)
    if args.jax:
        jax_against_port(args.layers or [1, 2, 3, 4], args.narrow)
        return 0
    return port_on_card(args.layers or [1, 2, 4, 8, 12, 16, 22], tuple(args.tokens))


if __name__ == "__main__":
    sys.exit(main())
