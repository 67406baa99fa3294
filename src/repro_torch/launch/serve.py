"""Serving launcher (counterpart of ``repro/launch/serve.py``).

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

The JAX launcher's decode demo (``--arch``) needs the model stack, which
the port does not have yet (ROADMAP A13): without ``--traffic`` the
launcher exits with an error that says so.
"""

from __future__ import annotations

import argparse
import time


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="the decode demo's model (needs the model stack, ROADMAP A13)")
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

    if not args.traffic:
        ap.error("only --traffic is served: the decode demo (--arch) needs the model "
                 "stack, which comes with ROADMAP A13")
    return run_traffic(args)


if __name__ == "__main__":
    main()
