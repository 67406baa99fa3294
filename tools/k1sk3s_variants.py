#!/usr/bin/env python3
"""Time K1s and K3s against variants of their own sources, on one CUDA card.

    python3 tools/k1sk3s_variants.py [--against TREE]

Each variant is the committed ``seg_tile_histograms.cu`` or
``seg_tile_positions.cu`` with one design choice changed by a text edit, as
``tools/k1k2_variants.py`` does for K1 and K2 (and through its
``build_variants``): for K1s, the strip read for every tile (no skip of a
one-run tile's ids), windows of 2056 and 8224 counter words against the
design's 4112, three blocks an SM against four (and four at T <= 2048, for
its ptxas spills), the end ids loaded into registers beside the keys
instead of copied into shared memory a tile ahead; for K3s, one stage and two
stages against the launch's own choice, the strip staged for every tile
(G's row in a slot of its own), the strip read from device memory and not
staged (two stages at K3's footprint), three blocks an SM against four.
Both run at S1, n = 2^25 keys in 8192 tiles of 4096 over 64 ragged
segments, ``DeltaSpec(32, 2^32)``, with labels in the kernel and on the ids
strip (the identity label), and over about 58,000 one- to eight-key
segments (64 tiles of 4096, m = 32: hundreds of runs a tile, 8 windows a
tile at 4112 words).

With ``--against TREE`` (an unpacked parent commit), K1 (m = 256, the main
shape), K3 (m = 256) and K2s (S1 key-value) are built from TREE's sources
too and timed in turns with this tree's: parent, this, this, parent; the
sources of all three share helpers with K1s and K3s. Then the segmented
entry points run end to end, each tree's package in a process of its own,
in the same turns: S1 key-value ``bms`` and ``dms``, the S2 key-value
sort (r = 8 over 16 segments) and the S3 routing launch (2^20 ids over
256 requests, ``positions_only``), medians of 5 calls.

Each line gives the median ms of 7 x 3 calls, the better of two such
medians, and whether the result is bitwise the plain version's; the build
lines give each variant's ptxas registers and spills. A variant whose edit
no longer applies to the sources is reported and skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TOOLS)
import k1k2_variants as base  # noqa: E402  (build_variants and cuda_ms)

ROOT = base.ROOT
sys.path.insert(0, os.path.join(ROOT, "src"))

K1S, K3S = "seg_tile_histograms", "seg_tile_positions"
ONE_STAGE = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 1;\n  smem = one;\n")
TWO_STAGES = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 2;\n  smem = two;\n")
K3S_LAYOUT = ("  Y.stage_words = Y.pitch + (Y.pitch > g_words ? Y.pitch : g_words);\n")
K3S_STRIP_COPY = "    } else {\n      sm90::stage_row<kThreads>(ks + Y.pitch,"

# name -> (source, [(old, new), ...], True when the result must stay right)
VARIANTS = {
    "K1s": (K1S, [], True),
    "K1s strip read for every tile": (K1S, [("      if (lo == hi) {\n", "      if (false) {\n")],
                                      True),
    "K1s window 2056 words": (K1S, [("kSetWords = 4112;", "kSetWords = 2056;")], True),
    "K1s window 8224 words": (K1S, [("kSetWords = 4112;", "kSetWords = 8224;")], True),
    "K1s three blocks an SM": (K1S, [("kVec == 2 ? 4 :", "kVec == 2 ? 3 :")], True),
    "K1s four blocks at T <= 2048": (K1S, [("(kVec == 1 ? 3 : 2)", "(kVec == 1 ? 4 : 2)")],
                                     True),
    "K1s end ids in registers": (K1S, [
        ("  __shared__ int2 ends[2];                           // a tile's end ids, beside its set\n",
         ""),
        ("""    const int after = tile + static_cast<int>(gridDim.x);
    if (tid == 0 && after < n_tiles) {
      const int* sa = segs + static_cast<size_t>(after) * T;
      sm90::copy4(&ends[set ^ 1].x, sa);
      sm90::copy4(&ends[set ^ 1].y, sa + T - 1);
    }
  };""", """    const int* sa = segs + static_cast<size_t>(tile) * T;
    lo_ = min(max(__ldg(sa), 0), s - 1);
    hi_ = max(lo_, min(__ldg(sa + T - 1), s - 1));
  };"""),
        ("  uint32_t cur[4 * kVec];\n", "  uint32_t cur[4 * kVec];\n  int lo_ = 0, hi_ = 0;\n"),
        ("""    if (tid == 0) {
      const int* s0 = segs + static_cast<size_t>(blockIdx.x) * T;
      ends[0] = make_int2(s0[0], s0[T - 1]);
    }
""", ""),
        ("""    const int lo = min(max(ends[set].x, 0), s - 1);
    const int hi = max(lo, min(ends[set].y, s - 1));""", """    const int lo = lo_, hi = hi_;""")], True),
    "K3s": (K3S, [], True),
    "K3s one stage": (K3S, [ONE_STAGE], True),
    "K3s two stages": (K3S, [TWO_STAGES], True),
    "K3s strip staged for every tile": (K3S, [
        ("  Y.g_off = Y.pitch;\n", "  Y.g_off = 2 * Y.pitch;\n"),
        (K3S_LAYOUT, "  Y.stage_words = 2 * Y.pitch + g_words;\n"),
        (K3S_STRIP_COPY, "    }\n    {\n      sm90::stage_row<kThreads>(ks + Y.pitch,")], True),
    "K3s strip from device memory": (K3S, [
        (K3S_LAYOUT, "  Y.stage_words = Y.pitch + g_words;\n"),
        (K3S_STRIP_COPY, "    } else if (false) {\n      sm90::stage_row<kThreads>(ks + Y.pitch,"),
        ("    const int* const sg = reinterpret_cast<const int*>(ks + Y.pitch);",
         "    const int* const sg = segs + static_cast<size_t>(tile) * T;")], True),
    "K3s three blocks an SM": (K3S, [("(kForm == sm90::kAnySpec ? 3 : 4)",
                                      "(kForm == sm90::kAnySpec ? 3 : 3)")], True),
}
# the kernels that share helpers with K1s and K3s, built from this tree and,
# with --against, from the parent's
SHARED = {"K1": "tile_histograms", "K3": "tile_positions", "K2s": "seg_fused_postscan_reorder"}
E2E = ("S1 kv bms", "S1 kv dms", "S2 kv sort", "S3 routing")


def ragged(rng, n, s, empty=()):
    """s segment starts over n keys, the segments in ``empty`` holding none."""
    import numpy as np
    w = rng.random(s) + 0.05
    w[list(empty)] = 0
    lens = np.floor(w / w.sum() * n).astype(np.int64)
    lens[-1] += n - lens.sum()
    return (np.cumsum(lens) - lens).astype(np.int32)


def e2e_child(tree: str) -> int:
    """Time the segmented entry points of ``tree``'s package end to end and
    print one JSON object, name -> ms."""
    import json
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from repro_torch import ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n, n3 = 1 << 25, 1 << 20
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    ids3 = torch.randint(0, 64, (n3,), dtype=torch.int32, device=dev, generator=gen)
    s1, s2, s3 = (torch.from_numpy(ragged(rng, n_, s_, e_)).to(dev) for n_, s_, e_ in
                  ((n, 64, (0, 31, 63)), (n, 16, (5,)), (n3, 256, range(0, 256, 37))))
    spec = ops.DeltaSpec(32, 1 << 32)
    calls = {
        "S1 kv bms": lambda: ops.segmented_multisplit(keys, spec, s1, vals, method="bms", device=dev),
        "S1 kv dms": lambda: ops.segmented_multisplit(keys, spec, s1, vals, method="dms", device=dev),
        "S2 kv sort": lambda: ops.segmented_radix_sort(keys, s2, vals, device=dev),
        "S3 routing": lambda: ops.segmented_multisplit(ids3, ops.IdentitySpec(64), s3, method="dms",
                                                       mode="positions_only", device=dev),
    }
    print(json.dumps({name: base.cuda_ms(fn, reps=5, inner=1) for name, fn in calls.items()}),
          flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="a tree (unpacked commit) whose K1, K3 and K2s to time "
                                          "in turns with this tree's")
    parser.add_argument("--e2e-child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.e2e_child:
        return e2e_child(args.e2e_child)
    if not torch.cuda.is_available():
        print("k1sk3s_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import ops
    from repro_torch.core.pipeline import stages as st
    from repro_torch.kernels import build
    from repro_torch.kernels import multisplit_tile as mst

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    variants = dict(VARIANTS)
    if args.against:
        other = os.path.join(os.path.abspath(args.against), "src", "repro_torch", "kernels", "csrc")
        for name, source in SHARED.items():
            variants[name] = (source, [], True)
            variants[f"{name} parent"] = (source, [], True, other)
    fns = base.build_variants(build, variants, "variants_k1sk3s")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n_tiles, t = (1 << 25) // 4096, 4096
    keys = torch.randint(-2**31, 2**31, (n_tiles, t), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n_tiles, t), dtype=torch.int32, device=dev, generator=gen)
    stream = torch.cuda.current_stream().cuda_stream

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
    spec = ops.DeltaSpec(32, 1 << 32)
    ids = mst.spec_bucket_ids_plain(keys, spec)

    # (what, keys or ids, segment strip, s, label arguments, G, the plain
    # histograms and positions)
    cases = []
    for what, k, sg, s in (("S1", keys, seg1, s1),
                           (f"{ts} one- to eight-key segments", keys[: tiny_shape[0]], tseg, ts)):
        hist = mst.seg_spec_tile_histograms_plain(k, sg, spec, s)
        g = st.global_scan(hist) + (1 << 24) + 1
        want = mst.seg_spec_tile_positions_plain(k, sg, g, spec, s)
        cases.append((f"{what}, labels in the kernel", k, sg, s,
                      mst.label_args(spec, k.dtype, dev), g, hist, want))
        cases.append((f"{what}, ids strip", ids[: k.shape[0]], sg, s, mst.identity_args(32), g,
                      hist, want))
    multi = int((seg1[:, 0] != seg1[:, -1]).sum())
    print(f"[variants] S1: {multi} of {n_tiles} tiles hold more than one segment run", flush=True)

    def timed(name, call, got, want):
        if call() != 0:
            raise RuntimeError(f"variant {name} failed to launch")
        torch.cuda.synchronize()
        right = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got, want) if b is not None)
        if variants[name][2] and not right:
            raise AssertionError(f"variant {name} differs from the plain version")
        ms = min(base.cuda_ms(call), base.cuda_ms(call))
        return f"{name} {ms:.4f}" + ("" if right else " (result wrong by design)")

    for what, k, sg, s, label, g, hist_want, pos_want in cases:
        hist = torch.empty_like(hist_want)
        pos = torch.empty_like(pos_want)
        parts = []
        for name, (source, fn) in fns.items():
            if source == K1S:
                def call(fn=fn):
                    return fn(k.data_ptr(), sg.data_ptr(), hist.data_ptr(), k.shape[0], t, s,
                              *label, stream)
                parts.append(timed(name, call, [hist], [hist_want]))
            elif source == K3S:
                def call(fn=fn):
                    return fn(k.data_ptr(), sg.data_ptr(), g.data_ptr(), pos.data_ptr(),
                              k.shape[0], t, s, *label, stream)
                parts.append(timed(name, call, [pos], [pos_want]))
        print(f"[variants] {what}: " + "; ".join(parts) +
              f" ms [tiles {k.shape[0]} x {t}, s = {s}, m = 32; {smi}]", flush=True)

    if args.against:
        # K1 and K3 at the main shape (m = 256), K2s at S1 key-value: parent,
        # this, this, parent
        spec256 = ops.DeltaSpec(256, 1 << 32)
        label256, label32 = mst.label_args(spec256, keys.dtype, dev), mst.label_args(spec, keys.dtype, dev)
        h256 = mst.spec_tile_histograms_plain(keys, spec256)
        g256 = st.global_scan(h256)
        g1 = st.global_scan(mst.seg_spec_tile_histograms_plain(keys, seg1, spec, s1))
        p256 = mst.spec_tile_positions_plain(keys, g256, spec256)
        k2s_want = mst.seg_spec_fused_postscan_reorder_plain(keys, seg1, g1, vals, spec, s1)
        hist = torch.empty_like(h256)
        outs = [torch.empty((n_tiles, t), dtype=torch.int32, device=dev) for _ in range(4)]
        for kernel in SHARED:
            parts = []
            for name in (f"{kernel} parent", kernel, kernel, f"{kernel} parent"):
                fn = fns[name][1]
                if kernel == "K1":
                    def call(fn=fn):
                        return fn(keys.data_ptr(), hist.data_ptr(), n_tiles, t, *label256, stream)
                    got, want = [hist], [h256]
                elif kernel == "K3":
                    def call(fn=fn):
                        return fn(keys.data_ptr(), g256.data_ptr(), outs[0].data_ptr(), n_tiles, t,
                                  *label256, stream)
                    got, want = [outs[0]], [p256]
                else:
                    def call(fn=fn):
                        return fn(keys.data_ptr(), seg1.data_ptr(), g1.data_ptr(), vals.data_ptr(),
                                  *(o.data_ptr() for o in outs), n_tiles, t, s1, *label32, stream)
                    got, want = outs, k2s_want
                parts.append(timed(name, call, got, want))
            shape = ("n = 2^25, m = 256, tiles 8192 x 4096" if kernel != "K2s" else
                     "S1 key-value, s = 64, m = 32")
            print(f"[variants] {kernel} in turns: " + "; ".join(parts) + f" ms [{shape}; {smi}]",
                  flush=True)
        # the segmented entry points end to end, each tree in its own process
        runs = []
        for name, tree in (("parent", args.against), ("this", ROOT), ("this", ROOT),
                           ("parent", args.against)):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--e2e-child", tree],
                                 capture_output=True, text=True, check=True)
            runs.append((name, json.loads(out.stdout.strip().splitlines()[-1])))
        for what in E2E:
            print(f"[variants] end to end {what} in turns: " + "; ".join(
                f"{name} {ms[what]:.3f}" for name, ms in runs) + f" ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
