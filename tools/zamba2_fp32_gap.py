#!/usr/bin/env python3
"""Where zamba2-1.2b's float32 logits part between the kernels and their
plain versions, on one CUDA card.

    python3 tools/zamba2_fp32_gap.py

zamba2-1.2b at its full config (38 layers: 32 Mamba2 blocks and 6
occurrences of one shared attention block), parameters drawn from seed 0 in
float32, 2 x 2048 tokens, as ``chip_smoke.py`` runs it. ``forward`` runs on
the kernels (backend ``cuda``: B11's 3xTF32 route for the six attention
calls) and on their plain versions (``vmap``, ``flash_attention_plain``),
recording every block's output and every attention call. Printed: each
attention call's gap in the forward and on the same inputs (the plain run's
q, k, v through both routes), each block's output gap beside its largest
value; the logits' gap, by position; and the model's own sensitivity: the
plain run again with every parameter perturbed by a relative 2^-21 (about
what 3xTF32 keeps of a product), and by 1e-6.
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params, tree_map

    if not torch.cuda.is_available():
        print("zamba2_fp32_gap: this script needs a CUDA card", file=sys.stderr)
        return 2
    build.build_all()
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; TF32 matmuls allowed: "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = init_params(M.decl_model(cfg), g)
    tokens = torch.randint(0, cfg.vocab, (2, 2048), device=dev, generator=g, dtype=torch.int32)

    seen = {"attention": {}, "block": {}}
    b11, block = L._attention_b11, M.apply_block

    def rec_b11(q, k, v, backend):
        out = b11(q, k, v, backend)
        seen["attention"].setdefault(backend, []).append((q.clone(), k.clone(), v.clone(), out))
        return out

    def rec_block(kind, p, x, c, **kw):
        out = block(kind, p, x, c, **kw)
        seen["block"].setdefault(kw["backend"], []).append((kind, out[0].clone()))
        return out

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    L._attention_b11, M.apply_block = rec_b11, rec_block
    try:
        with torch.inference_mode():
            logits = {be: M.forward(params, cfg, tokens=tokens, backend=be)[0]
                      for be in ("cuda", "vmap")}
    finally:
        L._attention_b11, M.apply_block = b11, block
    with torch.inference_mode():
        for i, ((_, _, _, ok), (qp, kp, vp, op)) in enumerate(zip(seen["attention"]["cuda"],
                                                                  seen["attention"]["vmap"])):
            a, b = b11(qp, kp, vp, "cuda"), b11(qp, kp, vp, "vmap")
            print(f"attention call {i}: |q| max {qp.abs().max():.3f}, |k| max "
                  f"{kp.abs().max():.3f}; out |x| max {op.abs().max():.4f}, gap in the forward "
                  f"{rel(ok, op):.3e}, on the same inputs {rel(a, b):.3e} (of the largest)")
        for i, ((kind, hk), (_, hp)) in enumerate(zip(seen["block"]["cuda"],
                                                       seen["block"]["vmap"])):
            print(f"block {i:2d} {kind:11s} out |x| max {hp.abs().max():10.3f}, gap "
                  f"{(hk - hp).abs().max():.3e} ({rel(hk, hp):.3e} of the largest)")
        base = logits["vmap"]
        print(f"logits |x| max {base.abs().max():.4f}, gap {rel(logits['cuda'], base):.3e} "
              f"of the largest")
        per_pos = (logits["cuda"] - base).abs().amax(-1).amax(0) / base.abs().max()
        for lo in range(0, per_pos.shape[0], 256):
            print(f"  positions {lo}-{lo + 255}: largest gap {per_pos[lo:lo + 256].max():.3e}")
        again = M.forward(params, cfg, tokens=tokens, backend="vmap")[0]
        print(f"plain run twice: gap {rel(again, base):.3e}")
        for scale, what in ((2.0 ** -21, "2^-21"), (1e-6, "1e-6")):
            pg = torch.Generator(device=dev)
            pg.manual_seed(1)
            moved = tree_map(lambda t: t * (1 + scale * torch.randn(
                t.shape, device=dev, generator=pg)), params)
            out = M.forward(moved, cfg, tokens=tokens, backend="vmap")[0]
            print(f"plain run, every parameter perturbed by a relative {what}: logits move "
                  f"{rel(out, base):.3e} of the largest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
