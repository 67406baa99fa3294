#!/usr/bin/env python3
"""Time K3 and K2s against variants of their own sources, on one CUDA card.

    python3 tools/k3k2s_variants.py

Each variant is the committed ``tile_positions.cu`` or
``seg_fused_postscan_reorder.cu`` with one design choice changed by a text
edit, as ``tools/k1k2_variants.py`` does for K1 and K2 (and through its
``build_variants``): a choice the design rejected (for K3: the rank's ballots over
the label bits unrolled to eight, ``__match_any_sync`` peer masks, six
blocks an SM, one stage, pos stored from registers 4 bytes at a time; for
K2s: one stage, the write-out in one loop over the three planes) or the
rank cut out to see what it costs (the result is then wrong by design and
marked so). K3 runs at the main shape, n = 2^25 keys in 8192 tiles of
4096, uniform keys under ``DeltaSpec(256, 2^32)``, ``DeltaSpec(32, 2^32)``
(the shift form) and an even 32-bucket ``EvenSpec`` (the general form);
K2s at S1 (the same keys over 64 ragged segments, ``DeltaSpec(32, 2^32)``,
key-value and key-only) and over about 58,000 one- to eight-key segments
(64 tiles of 4096, key-value, m = 256). Each line gives the median ms of
7 x 3 calls, the better of two such medians, the ptxas registers and
spills, and whether the result is bitwise the plain version's. A variant
whose edit no longer applies to the sources is reported and skipped.
"""

from __future__ import annotations

import os
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TOOLS)
import k1k2_variants as base  # noqa: E402  (build_variants and cuda_ms)

ROOT = base.ROOT
sys.path.insert(0, os.path.join(ROOT, "src"))

K3_RANK = "    sm90::warp_rank<kR, kForm>(ks, T, F, sp, mine, r0, r1, nbits, meta);\n"


def k3_rank(peers: str) -> str:
    """K3's rank written out in the kernel with another peer mask."""
    return """#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r0 + r < r1) {
        const int i = ((r0 + r) << 5) + lane;
        const bool valid = i < T;
        const int b = valid ? sm90::label_of<kForm>(ks[i], F, sp) : 0;
""" + peers + """
        const int before = valid ? mine[b] : 0;
        __syncwarp();
        if (valid && lane == __ffs(peers) - 1) mine[b] = before + __popc(peers);
        __syncwarp();
        meta[r] = ((before + __popc(peers & ((1u << lane) - 1u))) << ms::kLabelBits) | b;
      }
    }
"""


BALLOTS_UNROLLED = """        unsigned peers = __ballot_sync(ms::kFull, valid);
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          if (bit < nbits) {
            const bool on = (b >> bit) & 1;
            const unsigned bal = __ballot_sync(ms::kFull, on);
            peers &= on ? bal : ~bal;
          }
        }"""
MATCH_ANY = "        const unsigned peers = __match_any_sync(ms::kFull, valid ? b : -1);"
RANK_CUT = "#pragma unroll\n    for (int r = 0; r < kR; ++r) meta[r] = 0;\n"
K2S_RANK = "      sm90::warp_rank<kR, kForm>(src + a, len, F, sp, mine, r0, r1, nbits, meta);\n"
K2S_RANK_CUT = "#pragma unroll\n      for (int r = 0; r < kR; ++r) meta[r] = 0;\n"
ONE_STAGE = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 1;\n  smem = one;\n")
K3_STORES = [
    ("        ks[i] = static_cast<uint32_t>(mine[meta[r] & label_mask] + (meta[r] >> ms::kLabelBits));",
     "        pos[static_cast<size_t>(tile) * T + i] =\n"
     "            mine[meta[r] & label_mask] + (meta[r] >> ms::kLabelBits);"),
    ("    if (vec) {\n      int4* const po", "    if (false) {\n      int4* const po"),
    ("      for (int j = tid; j < T; j += kThreads) pos[base + j] = static_cast<int>(ks[j]);", "")]
K2S_WRITE_ONE_LOOP = [(
    """      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(kr)[v];
      if (has_vals)
        for (int v = tid; v < nv; v += kThreads)
          reinterpret_cast<uint4*>(vals_r + base)[v] = reinterpret_cast<const uint4*>(vr)[v];
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(pos_r + base)[v] = reinterpret_cast<const uint4*>(ks)[v];""",
    """      for (int v = tid; v < nv; v += kThreads) {
        reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(kr)[v];
        if (has_vals)
          reinterpret_cast<uint4*>(vals_r + base)[v] = reinterpret_cast<const uint4*>(vr)[v];
        reinterpret_cast<uint4*>(pos_r + base)[v] = reinterpret_cast<const uint4*>(ks)[v];
      }""")]

# name -> (source, [(old, new), ...], True when the result must stay right)
VARIANTS = {
    "K3": ("tile_positions", [], True),
    "K3 rank cut": ("tile_positions", [(K3_RANK, RANK_CUT)], False),
    "K3 ballots unrolled": ("tile_positions", [(K3_RANK, k3_rank(BALLOTS_UNROLLED))], True),
    "K3 match_any peers": ("tile_positions", [(K3_RANK, k3_rank(MATCH_ANY))], True),
    "K3 six blocks an SM": ("tile_positions", [
        ("(kForm == sm90::kAnySpec ? 3 : 4)", "(kForm == sm90::kAnySpec ? 3 : 6)")], True),
    "K3 one stage": ("tile_positions", [ONE_STAGE], True),
    "K3 4-byte stores from registers": ("tile_positions", K3_STORES, True),
    "K2s": ("seg_fused_postscan_reorder", [], True),
    "K2s rank cut": ("seg_fused_postscan_reorder", [(K2S_RANK, K2S_RANK_CUT)], False),
    "K2s one stage": ("seg_fused_postscan_reorder", [ONE_STAGE], True),
    "K2s write-out in one loop": ("seg_fused_postscan_reorder", K2S_WRITE_ONE_LOOP, True),
}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3k2s_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import ops
    from repro_torch.core.pipeline import stages as st
    from repro_torch.kernels import build
    from repro_torch.kernels import multisplit_tile as mst

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    fns = base.build_variants(build, VARIANTS, "variants_k3k2s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n_tiles, t = (1 << 25) // 4096, 4096
    keys = torch.randint(-2**31, 2**31, (n_tiles, t), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n_tiles, t), dtype=torch.int32, device=dev, generator=gen)

    def strip(lens, shape):
        starts = (np.cumsum(lens) - lens).astype(np.int64)
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        seg = st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), shape[0] * shape[1])
        return seg.view(shape), int(starts.size)

    share = rng.random(64) + 0.05                    # S1: 64 ragged segments, three empty
    share[[0, 31, 63]] = 0
    lens = np.floor(share / share.sum() * (1 << 25)).astype(np.int64)
    lens[-1] += (1 << 25) - lens.sum()
    seg1, s1 = strip(lens, (n_tiles, t))
    tiny_shape = (64, t)
    tseg, ts = strip(rng.integers(1, 9, tiny_shape[0] * t), tiny_shape)
    tkeys, tvals = keys[: tiny_shape[0]], vals[: tiny_shape[0]]
    outs = [torch.empty((n_tiles, t), dtype=torch.int32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream().cuda_stream

    def same(got, want):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want) if b is not None)

    k3_cases = []
    for spec in (ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32),
                 ops.EvenSpec(0.0, float(1 << 32), 32)):
        g = st.global_scan(mst.spec_tile_histograms_plain(keys, spec))
        k3_cases.append((spec, g, mst.spec_tile_positions_plain(keys, g, spec)))
    spec1, spec_t = ops.DeltaSpec(32, 1 << 32), ops.DeltaSpec(256, 1 << 32)
    g1 = st.global_scan(mst.seg_spec_tile_histograms_plain(keys, seg1, spec1, s1))
    gt = st.global_scan(mst.seg_spec_tile_histograms_plain(tkeys, tseg, spec_t, ts))
    k2s_cases = [
        ("S1 key-value", keys, seg1, g1, vals, spec1, s1, outs),
        ("S1 key-only", keys, seg1, g1, None, spec1, s1, outs),
        (f"{ts} one- to eight-key segments, key-value", tkeys, tseg, gt, tvals, spec_t, ts,
         [o[: tiny_shape[0]] for o in outs]),
    ]
    for source in ("tile_positions", "seg_fused_postscan_reorder"):
        cases = k3_cases if source == "tile_positions" else k2s_cases
        for case in cases:
            parts = []
            for name, (src_name, fn) in fns.items():
                if src_name != source:
                    continue
                if source == "tile_positions":
                    spec, g, want = case
                    what = spec.name
                    label = mst.label_args(spec, keys.dtype, dev)

                    def call(fn=fn, g=g, label=label):
                        return fn(keys.data_ptr(), g.data_ptr(), outs[0].data_ptr(), n_tiles, t,
                                  *label, stream)
                    got, want = [outs[0]], [want]
                else:
                    what, k, sg, g, v, spec, s, out = case
                    label = mst.label_args(spec, k.dtype, dev)
                    want = mst.seg_spec_fused_postscan_reorder_plain(k, sg, g, v, spec, s)

                    def call(fn=fn, k=k, sg=sg, g=g, v=v, s=s, out=out, label=label):
                        return fn(k.data_ptr(), sg.data_ptr(), g.data_ptr(),
                                  v.data_ptr() if v is not None else None, out[0].data_ptr(),
                                  out[1].data_ptr() if v is not None else None,
                                  out[2].data_ptr(), out[3].data_ptr(), k.shape[0], t, s,
                                  *label, stream)
                    got = [out[0], out[1] if v is not None else None, out[2], out[3]]
                if call() != 0:
                    raise RuntimeError(f"variant {name} failed to launch")
                torch.cuda.synchronize()
                right = same(got, want)
                if VARIANTS[name][2] and not right:
                    raise AssertionError(f"variant {name} differs from the plain version ({what})")
                ms = min(base.cuda_ms(call), base.cuda_ms(call))
                parts.append(f"{name} {ms:.4f}" + ("" if right else " (result wrong by design)"))
            print(f"[variants] {what}: " + "; ".join(parts) +
                  f" ms [tiles {n_tiles} x {t} ({tiny_shape[0]} for the short runs); {smi}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
