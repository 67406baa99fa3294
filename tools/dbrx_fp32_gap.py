#!/usr/bin/env python3
"""Where dbrx-132b's float32 logits part between the kernels and their plain
versions, on one CUDA card.

    python3 tools/dbrx_fp32_gap.py

dbrx-132b at full width with its depth cut to 2 layers (as ``chip_smoke.py``
runs it), parameters drawn from seed 0 in bfloat16 and held in float32,
2 x 2048 tokens. ``forward`` runs twice, on the kernels (backend ``cuda``:
B11's 3xTF32 route, K1, K3) and on their plain versions (``vmap``,
``flash_attention_plain``), recording each layer's attention inputs and
output, block output and routing. Printed for each layer: the largest q and
k (the scores' scale), the attention outputs' gap in the forward and on the
same inputs (the plain run's q, k, v through both routes), the block
outputs' gap, the share of tokens whose top-k experts agree and the gates'
gap where they do; then the logits' gap and the worst tokens of each row.
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
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import init_params, tree_map

    if not torch.cuda.is_available():
        print("dbrx_fp32_gap: this script needs a CUDA card", file=sys.stderr)
        return 2
    build.build_all()
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}; TF32 matmuls allowed: "
          f"{torch.backends.cuda.matmul.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()}")
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=2, dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = tree_map(lambda t: t.float(), init_params(M.decl_model(cfg), g, torch.bfloat16))
    tokens = torch.randint(0, cfg.vocab, (2, 2048), device=dev, generator=g, dtype=torch.int32)

    seen = {"attention": {}, "block": {}, "router": {}}
    b11, block, router = L._attention_b11, M.apply_block, moe_mod._router

    def rec_b11(q, k, v, backend):
        out = b11(q, k, v, backend)
        seen["attention"].setdefault(backend, []).append((q.clone(), k.clone(), v.clone(), out))
        return out

    def rec_block(kind, p, x, c, **kw):
        out = block(kind, p, x, c, **kw)
        seen["block"].setdefault(kw["backend"], []).append(out[0].clone())
        return out

    def rec_router(p, xn, c, **kw):
        out = router(p, xn, c, **kw)
        seen["router"].setdefault(kw["backend"], []).append((out[0].clone(), out[1].clone()))
        return out

    L._attention_b11, M.apply_block, moe_mod._router = rec_b11, rec_block, rec_router
    try:
        with torch.inference_mode():
            logits = {be: M.forward(params, cfg, tokens=tokens, backend=be)[0]
                      for be in ("cuda", "vmap")}
            for i in range(cfg.n_layers):
                q, k, _, ok = seen["attention"]["cuda"][i]
                qp, kp, vp, op = seen["attention"]["vmap"][i]
                a, b = b11(qp, kp, vp, "cuda"), b11(qp, kp, vp, "vmap")
                print(f"layer {i}: |q| max {q.abs().max():.3f}, |k| max {k.abs().max():.3f}; "
                      f"attention out |x| max {op.abs().max():.4f}, gap in the forward "
                      f"{(ok - op).abs().max():.3e}, on the same inputs "
                      f"{(a - b).abs().max():.3e} ({(a - b).abs().max() / b.abs().max():.3e} "
                      f"of the largest)")
                hk, hp = seen["block"]["cuda"][i], seen["block"]["vmap"][i]
                (gk, ek), (gp, ep) = seen["router"]["cuda"][i], seen["router"]["vmap"][i]
                same = (ek.sort(-1).values == ep.sort(-1).values).all(-1)
                print(f"   block out |x| max {hp.abs().max():.3f}, gap {(hk - hp).abs().max():.3e};"
                      f" top-k experts agree for {same.float().mean():.6f} of the tokens, gates' "
                      f"gap there {(gk - gp)[same].abs().max():.3e}")
            gap = (logits["cuda"] - logits["vmap"]).abs()
            print(f"logits |x| max {logits['vmap'].abs().max():.4f}, gap {gap.max():.3e}")
            per_token = gap.amax(-1)
            for r in range(per_token.shape[0]):
                worst = per_token[r].topk(5)
                print(f"row {r}: worst tokens {worst.indices.tolist()} "
                      f"{[f'{x:.3e}' for x in worst.values.tolist()]}, median "
                      f"{per_token[r].median():.3e}")
    finally:
        L._attention_b11, M.apply_block, moe_mod._router = b11, block, router
    return 0


if __name__ == "__main__":
    sys.exit(main())
