"""Serving launcher (counterpart of ``repro/launch/serve.py``): two entry
points behind one CLI, on the card by default.

Batched incremental decoding with a KV cache (the model demo)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --batch 4 --prompt-len 32 --gen-len 32

``--smoke`` runs the reduced config. Parameters are drawn from ``--seed``
in the config's dtype on ``--device``; prompts are consumed through the
decode path (single-token steps), then generation continues greedily. The
JAX demo jits its step; the port runs it eagerly under
``torch.inference_mode()``, so a small batch's ms/step is the time the host
takes to issue the step. The demo runs under a mesh, as the JAX demo runs
under ``jax.set_mesh`` (``launch.mesh.launch_mesh``, printed on the first
line): the production mesh in a world of 256 or 512 ranks, else the host
mesh over the world — on one card one rank, a ``(1,)`` ``data`` mesh, where
the parameters stay plain tensors. Every family is served on one rank; a
mesh of several ranks serves the dense and MoE families (parameters placed
by ``decl_to_sharding``, the cache by ``cache_shardings``; a ``multisplit``
MoE dispatch runs as ``multisplit_ep`` where the mesh has a ``model`` axis,
``launch.mesh.expert_parallel``, printed on the second line).
A vlm's patch embeddings (batch, n_vis_tokens, d_model) are drawn from the
prompts' ``np.random.RandomState(seed)`` right after the prompts and fill
the cross-attention cache. A frontend-stub arch (musicgen) takes its
prompt as seeded random frame embeddings, drawn from a
``torch.Generator`` on ``--seed`` (JAX's ``PRNGKey(t)`` stream has no
PyTorch counterpart); it has no token table to feed generation back
through, so, as in the JAX demo, ``--gen-len 1`` serves the prompt and a
longer generation exits.

Continuous-batching traffic over the segmented routing plan (DESIGN.md §16)
— many concurrent synthetic users coalesced into ONE segmented multisplit
launch per step, on the card by default::

    PYTHONPATH=src python -m repro_torch.launch.serve --traffic \\
        --requests 5000 --qps 2000 --fault-rate 0.01

Open-loop Poisson arrivals drive a :class:`repro_torch.serving.ServerLoop`;
the run prints the exported metrics (p50/p95/p99 latency, sustained QPS,
occupancy, shed/failed/retry counters) and conservation-checks that no
request was silently dropped. ``--device cpu`` runs the kernels' plain
versions on the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def run_traffic(args) -> dict:
    """The continuous-batching path: open-loop Poisson traffic through a
    prewarmed :class:`~repro_torch.serving.ServerLoop` (ONE segmented plan
    launch per step), with optional seeded fault injection exercising the
    retry/requeue/shed machinery under load."""
    from repro_torch.runtime.supervisor import FaultInjector
    from repro_torch.serving import (
        ServerLoop, ServingConfig, open_loop, poisson_arrivals, synthetic_requests,
    )

    cfg = ServingConfig(
        num_experts=args.num_experts,
        capacity=args.capacity,
        max_batch_requests=args.max_batch_requests,
        max_batch_tokens=args.max_batch_tokens,
        max_wait=args.max_wait,
        backend=args.backend,
        device=args.device,
    )
    faults = None
    if args.fault_rate:
        faults = FaultInjector(rate=args.fault_rate, seed=args.seed)
    loop = ServerLoop(cfg, fault_injector=faults)
    t0 = time.monotonic()
    loop.prewarm()
    print(f"[serve] prewarm {time.monotonic() - t0:.2f}s "
          f"(shape classes {cfg.token_pad_classes}, backend {cfg.backend}, "
          f"device {cfg.device})")

    reqs = synthetic_requests(args.requests, cfg.num_experts, seed=args.seed)
    arrivals = poisson_arrivals(args.requests, args.qps, seed=args.seed)
    print(f"[serve] open loop: {args.requests} requests at {args.qps:.0f} QPS "
          f"(Poisson), fault rate {args.fault_rate}")
    open_loop(loop, reqs, arrivals)

    s = loop.metrics_summary()
    if s["dropped_by_bug"] != 0:
        raise AssertionError(f"request accounting violated: {s}")
    print(f"[serve] completed {s['completed']}/{s['submitted']} "
          f"(shed {s['shed']}, failed {s['failed']}, retries {s['retries']})")
    print(f"[serve] latency ms: p50 {s['latency_p50_ms']:.2f}  "
          f"p95 {s['latency_p95_ms']:.2f}  p99 {s['latency_p99_ms']:.2f}")
    print(f"[serve] sustained {s['qps_sustained']:.0f} QPS over {s['steps']} steps, "
          f"occupancy {s['batch_token_occupancy']:.2f}, "
          f"mean batch {s['batch_requests_mean']:.1f} requests")
    return s


def run_decode(args) -> torch.Tensor:
    """The decode demo: ``decl_model`` -> ``init_params`` on the device ->
    ``init_cache`` -> the prompt through ``decode_step`` one token at a
    time -> greedy generation. Prints the parameter count, ms/step, tok/s
    and a sample continuation; returns the generated tokens (B, gen_len) on
    the host."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import data_axes, describe, expert_parallel, launch_mesh

    cfg = get_config(args.arch).smoke() if args.smoke else get_config(args.arch)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the decode demo runs on the card by default and none is present; "
                           "pass --device cpu to run it on the host")
    mesh, started, device = launch_mesh(device)
    try:
        print(f"[serve] {describe(mesh)}")
        ep = expert_parallel(cfg, mesh)
        if ep is not cfg:
            print(f"[serve] MoE dispatch {cfg.moe.dispatch} -> {ep.moe.dispatch} over the "
                  f"mesh's model axis")
        return _decode(args, ep, device, mesh, ParallelConfig(dp_axes=data_axes(mesh)))
    finally:
        if started:
            dist.destroy_process_group()


def _decode(args, cfg, device, mesh, pcfg):
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import (
        decl_to_sharding, gather_full, init_params, param_count, set_mesh,
    )

    max_len = args.prompt_len + args.gen_len
    decls = M.decl_model(cfg)
    print(f"[serve] {cfg.name}: {param_count(decls) / 1e6:.1f}M params, {cfg.dtype}, "
          f"device {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = init_params(decls, gen, getattr(torch, cfg.dtype),
                         shardings=decl_to_sharding(decls, pcfg, mesh))
    rng = np.random.RandomState(args.seed)
    prompts = rng.randint(1, cfg.vocab, size=(args.batch, args.prompt_len), dtype=np.int32)
    tokens = torch.from_numpy(prompts).to(device)
    vis = None
    if cfg.n_vis_tokens:
        vis = torch.from_numpy(rng.randn(args.batch, cfg.n_vis_tokens, cfg.d_model)).to(
            device=device, dtype=getattr(torch, cfg.dtype))
    if cfg.embed_frontend_stub:                   # the prompt as frame embeddings
        frames = torch.Generator(device=device)
        frames.manual_seed(args.seed)
        tokens = torch.randn((args.batch, args.prompt_len, cfg.d_model), generator=frames,
                             device=device).to(getattr(torch, cfg.dtype))

    def step(cache, tok, t):
        logits, cache = M.decode_step(params, cfg, cache, tok, t)
        return gather_full(logits[:, -1]).argmax(-1).to(torch.int32), cache

    # DTensor views refuse inference tensors: a mesh of several ranks runs under no_grad
    no_grad = torch.inference_mode() if mesh.size() == 1 else torch.no_grad()
    with no_grad, set_mesh(mesh):
        cache = M.init_cache(params, cfg, args.batch, max_len=max_len, vis_embeds=vis)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        nxt = None
        for t in range(args.prompt_len):          # the prompt, token by token
            nxt, cache = step(cache, tokens[:, t:t + 1], t)
        generated = [nxt]
        for t in range(args.prompt_len, max_len - 1):
            if cfg.embed_frontend_stub:
                raise SystemExit("generation loop for frontend-stub archs needs "
                                 "external frame embeddings; serve supports "
                                 "token archs")
            nxt, cache = step(cache, generated[-1][:, None], t)
            generated.append(nxt)
        gen_tokens = torch.stack(generated, dim=1).cpu()
        dt = time.perf_counter() - t0
    n_steps = args.prompt_len + len(generated) - 1
    print(f"[serve] {n_steps} decode steps, batch {args.batch}: "
          f"{1000 * dt / n_steps:.1f} ms/step, {args.batch * n_steps / dt:.1f} tok/s")
    print(f"[serve] sample continuation: {gen_tokens[0, :16].tolist()}")
    return gen_tokens


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model arch for the decode demo (required unless --traffic)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traffic", action="store_true",
                    help="serve synthetic open-loop traffic through the "
                         "continuous-batching ServerLoop")
    ap.add_argument("--requests", type=int, default=5000)
    ap.add_argument("--qps", type=float, default=2000.0)
    ap.add_argument("--num-experts", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--max-batch-requests", type=int, default=64)
    ap.add_argument("--max-batch-tokens", type=int, default=4096)
    ap.add_argument("--max-wait", type=float, default=0.02)
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault-rate", type=float, default=0.0)
    args = ap.parse_args(argv)

    if args.traffic:
        return run_traffic(args)
    if args.arch is None:
        ap.error("--arch is required unless --traffic is given")
    return run_decode(args)


if __name__ == "__main__":
    main()
