"""Training launcher (counterpart of ``repro/launch/train.py``), on the card
by default::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --batch 8 --seq 128 --device cpu

``--smoke`` runs the reduced config; without it the full config runs. The
launcher builds its mesh as the JAX launcher does and prints it on its
first line (``launch.mesh.launch_mesh``: the production mesh in a world of
256 or 512 ranks, else the host mesh over the world — on one card a
``(1,)`` ``data`` mesh of one rank) and places the train state by
``state_shardings`` (``parallel.sharding.place``; on one rank the leaves
stay plain tensors). The sharded train step over several ranks is not
ported yet (``ROADMAP.md`` A13d): a world of more than one rank raises.
Parameters are drawn from ``--seed`` on
``--device`` in ``TrainConfig.params_dtype`` (a bfloat16 one keeps a
float32 master in the optimizer state), batches come from the port's
:class:`~repro_torch.data.DataPipeline`, and the loop always runs under the
fault-tolerant :class:`~repro_torch.runtime.Supervisor` (checkpoint/restart,
retry, straggler tracking). On ``cuda`` attention inside B11's contract runs
its forward on the kernel and an MoE model routes on K1 and K3;
``--device cpu`` runs their plain versions. Without a card and without
``--device cpu`` the launcher raises. Returns the supervisor (its
``history`` and ``stats``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import data_axes, describe, launch_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import init_params, param_count, place, set_mesh
from repro_torch.runtime import Supervisor, TrainLoopConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default=None, choices=[None, "cosine", "wsd"])
    ap.add_argument("--dispatch", default=None, choices=[None, "dense", "sort", "multisplit"])
    ap.add_argument("--ckpt-dir", default=TrainLoopConfig().checkpoint_dir)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on the card by default and none is present; pass "
                           "--device cpu to run it on the host")
    mesh, started, device = launch_mesh(device)
    try:
        print(f"[train] {describe(mesh)}")
        if mesh.size() > 1:
            raise NotImplementedError(f"the sharded train step over {mesh.size()} ranks is not "
                                      f"ported yet (ROADMAP.md A13d); train on one rank")
        return _train(args, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device, mesh):
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.dispatch and cfg.moe.num_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.dispatch))
    schedule = args.schedule or ("wsd" if cfg.name.startswith("minicpm") else "cosine")
    tc = TrainConfig(
        global_batch=args.batch, seq_len=args.seq, lr=args.lr, schedule=schedule,
        total_steps=args.steps, warmup_steps=max(args.steps // 20, 5), seed=args.seed,
    )

    pcfg = ParallelConfig(dp_axes=data_axes(mesh))

    decls = M.decl_model(cfg)
    print(f"[train] {cfg.name}: {param_count(decls) / 1e6:.1f}M params, device {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(tc.seed)
    params = init_params(decls, gen, getattr(torch, tc.params_dtype))
    state = S.TrainState(params=params, opt=adamw_init(params, tc))
    state = place(state, S.state_shardings(decls, pcfg, mesh, tc))

    pipeline = DataPipeline(
        vocab=cfg.vocab, seq_len=tc.seq_len, batch_per_host=tc.global_batch,
        seed=tc.seed, frontend_stub_dim=cfg.d_model if cfg.embed_frontend_stub else None,
        device=device,
    )

    def batch_fn(step: int):
        b = pipeline.batch_at(step)
        if cfg.n_vis_tokens:
            rng = np.random.RandomState(step)
            b["vis_embeds"] = rng.randn(
                tc.global_batch, cfg.n_vis_tokens, cfg.d_model
            ).astype(np.float32)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    sup = Supervisor(
        S.make_train_step(cfg, tc), batch_fn,
        TrainLoopConfig(total_steps=tc.total_steps, checkpoint_every=args.ckpt_every,
                        checkpoint_dir=args.ckpt_dir),
    )
    with set_mesh(mesh):
        sup.run(state)
    print(f"[train] done; stats={sup.stats}")
    if sup.history:
        print(f"[train] first loss={sup.history[0]['loss']:.4f} "
              f"last loss={sup.history[-1]['loss']:.4f}")
    return sup


if __name__ == "__main__":
    main()
