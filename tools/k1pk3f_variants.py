#!/usr/bin/env python3
"""Time K1p and K3f against variants of their own sources, on one CUDA card.

    python3 tools/k1pk3f_variants.py [--against TREE]

Each variant is the committed ``packed_tile_histograms.cu`` (K1p) or
``fused2_tile_positions.cu`` (K3f, whose body ``fused2::postscan_kernel``
lives in ``multisplit_fused2.cuh`` beside K2f's) with one design choice
changed by a text edit, built by ``tools/k1k2_variants.py``'s
``build_variants`` (an edit that matches nothing in the source applies to
the local header that holds its text). For K1p: K1's int32 copies of the
counters instead of the packed 8-bit lanes (K1's copy rule, 8 copies at m
= 256; the figure A8 weighs the families by), no guard of the lane cap (32
copies at T = 8192, right on uniform keys only), the other guard (32
copies and an unpack between the halves of a thread's keys in the flat
count; its segmented count unguarded), four blocks an SM in every
form and three in every form (the design gives the segmented forms three
at T <= 4096, whose instances spill at four). K1p runs flat at n = 2^25 in
8192 tiles of 4096, ``DeltaSpec(256, 2^32)``, with labels in the kernel and
on the ids strip, in 4096 tiles of 8192 (where the cap's guard acts), and
at S1 (64 ragged segments, ``DeltaSpec(32, 2^32)``). For K3f: the next
tile's keys staged (two stages, one block an SM at T = 8192) and one block
an SM instead of two, and the G reads cut (a result wrong by design: what
the bases cost). K3f runs at F1, n = 2^25 keys in 4096 tiles of 8192, the
pair (0, 16) in stages of 8 bits, in both families, and segmented at F3
(2^22 keys over 16 ragged segments).

With ``--against TREE`` (an unpacked parent commit), the parent's K1p and
K3f are built too, whole and with a phase cut out to show where their time
goes (K1p: the two-level rank; K3f: the walk over the sorted tile, or the
sweep of the sort; results wrong by design and marked so). K2f, K1f, K3p
and K2p, whose sources or headers this change touches, are built from both
trees and timed in turns: parent, this, this, parent. Then the entry points
run end to end, each tree's package in a process of its own, in the same
turns: the flat packed key-value ``bms`` at m = 256, S1 packed, the packed
r = 8 key-value sort, the F1 fused ``dms`` key-only sort and key-value
sort, F3, and the default (onehot, unfused) flat key-value ``bms`` and sort
beside them; medians of 5 calls.

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
from k1sk3s_variants import ragged  # noqa: E402

ROOT = base.ROOT
sys.path.insert(0, os.path.join(ROOT, "src"))

K1P, K3F = "packed_tile_histograms", "fused2_tile_positions"
K2F, K1F, K3P, K2P = ("fused2_fused_postscan_reorder", "fused2_tile_histograms",
                      "packed_tile_positions", "packed_fused_postscan_reorder")
# K1p with K1's int32 copies: a word a counter, lane l adding into copy l %
# C with C as K1 picks it (C·(words | 1) <= 2056), windows of (kSetWords -
# 1) / m segments, the sum over the copies a column a thread
K1P_UNPACK = """      for (int j = tid; j < pw; j += kThreads) {
        uint32_t even = 0u, odd = 0u;
#pragma unroll 8
        for (int c = 0; c < kCopies; ++c) {
          const uint32_t x = base[c * stride + j];
          base[c * stride + j] = 0u;
          even += x & 0x00ff00ffu;
          odd += (x >> 8) & 0x00ff00ffu;
        }
        const int4 v = make_int4(static_cast<int>(even & 0xffffu), static_cast<int>(odd & 0xffffu),
                                 static_cast<int>(even >> 16), static_cast<int>(odd >> 16));
        if (vec_out) {
          reinterpret_cast<int4*>(out)[j] = v;
        } else {
          const int c = 4 * j;
          out[c] = v.x;
          if (c + 1 < words) out[c + 1] = v.y;
          if (c + 2 < words) out[c + 2] = v.z;
          if (c + 3 < words) out[c + 3] = v.w;
        }
      }
"""
K1P_INT32_SUM = """      for (int j = tid; j < words; j += kThreads) {
        int x = 0;
        for (int c = 0; c < copies; ++c) {
          x += static_cast<int>(base[c * stride + j]);
          base[c * stride + j] = 0u;
        }
        out[j] = x;
      }
"""
INT32_COPIES = [
    ("  const int per = max(1, 4 * ((kCopyWords - 1) | 1) / m);",
     "  const int per = (kSetWords - 1) / m;"),
    ("      const int words = wn * m, pw = (words + 3) >> 2, stride = pw | 1;\n"
     "      uint32_t* const mine = base + copy * stride;",
     "      const int words = wn * m, stride = words | 1;\n"
     "      const int copies = sm90::counter_copies(words, 2056);\n"
     "      uint32_t* const mine = base + (lane & (copies - 1)) * stride;"),
    ("          atomicAdd(mine + (b >> 2), 1u << ((b & 3) << 3));",
     "          atomicAdd(mine + b, 1u);"),
    ("          if (q >= 0 && q < wn) atomicAdd(mine + (c >> 2), 1u << ((c & 3) << 3));",
     "          if (q >= 0 && q < wn) atomicAdd(mine + c, 1u);"),
    (K1P_UNPACK, K1P_INT32_SUM),
]
# K1p's other guard of the lane cap at T > 4096: one copy a lane (32), the
# flat count in two halves of a thread's 16 keys with an unpack between them
# (a barrier, word tid of every copy into registers, zeroed, a barrier)
NO_GUARD = [("  return kVec == 4 ? 2 : 1;", "  return 1;"),
            ("static_assert(lane_cap<1>()", "static_assert(true || lane_cap<1>()")]
K1P_FLAT_COUNT = """      if (!kSeg || lo == hi) {
        sm90::count_keys<kVec, kThreads, kForm>(cur, T, F, sp, [&](int, int b) {
          atomicAdd(mine + (b >> 2), 1u << ((b & 3) << 3));
        });
      } else {"""
K1P_HALVES_COUNT = """      uint32_t half_even = 0u, half_odd = 0u;   // the first half's unpack of word tid
      if (!kSeg || lo == hi) {
#pragma unroll
        for (int j = 0; j < 4 * kVec; ++j) {
          if (kVec == 4 && j == 8) {
            __syncthreads();
            if (tid < pw) {
              for (int c = 0; c < kCopies; ++c) {
                const uint32_t x = base[c * stride + tid];
                base[c * stride + tid] = 0u;
                half_even += x & 0x00ff00ffu;
                half_odd += (x >> 8) & 0x00ff00ffu;
              }
            }
            __syncthreads();
          }
          const int e = sm90::key_at<kThreads>(j);
          if (e < T) {
            const int b = sm90::label_of<kForm>(cur[j], F, sp);
            atomicAdd(mine + (b >> 2), 1u << ((b & 3) << 3));
          }
        }
      } else {"""
UNPACK_HALVES = NO_GUARD + [
    (K1P_FLAT_COUNT, K1P_HALVES_COUNT),
    ("        uint32_t even = 0u, odd = 0u;\n",
     "        uint32_t even = half_even, odd = half_odd;\n")]
K1P_BLOCKS = "  return kVec == 4 ? 2 : (kSeg ? 3 : 4);"
TWO_STAGES = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 2;\n  smem = two;\n")

# name -> (source, [(old, new), ...], True when the result must stay right)
VARIANTS = {
    "K1p": (K1P, [], True),
    "K1p int32 copies (K1's)": (K1P, INT32_COPIES, True),
    "K1p no cap guard": (K1P, NO_GUARD, True),
    "K1p unpack between halves": (K1P, UNPACK_HALVES, True),
    "K1p four blocks an SM": (K1P, [(K1P_BLOCKS, "  return kVec == 4 ? 2 : 4;")], True),
    "K1p three blocks an SM": (K1P, [(K1P_BLOCKS, "  return kVec == 4 ? 2 : 3;")], True),
    "K3f": (K3F, [], True),
    "K3f two stages": (K3F, [TWO_STAGES], True),
    "K3f one block an SM": (K3F, [("__launch_bounds__(kThreads, 2)",
                                   "__launch_bounds__(kThreads, 1)")], True),
    "K3f G reads cut": (K3F, [("          gv[r - h] = valid ? __ldg(at) : 0;",
                               "          gv[r - h] = 0 * static_cast<int>(at - grow);")], False),
}
# the parent's K1p and K3f, whole and with a phase cut out
PARENT_VARIANTS = {
    "K1p parent": (K1P, [], True),
    "K1p parent, rank cut": (K1P, [("    ms::packed_rank_range<false, false, kIds>(",
                                    "    if (false) ms::packed_rank_range<false, false, kIds>(")],
                             False),
    "K3f parent": (K3F, [], True),
    "K3f parent, walk cut": (K3F, [("  ms::walk_cells<kSeg>(kb[fin], seg, T, s, shift, bits, wsum,",
                                    "  if (false) ms::walk_cells<kSeg>(kb[fin], seg, T, s, shift, "
                                    "bits, wsum,")], False),
    "K3f parent, sweep cut": (K3F, [("(keys + base, T, runs, nruns, shift, bits,",
                                     "(keys + base, T, runs, nruns, shift, 0,")], False),
}
# the kernels whose sources or headers this change touches, built from both trees
SHARED = {"K2f": K2F, "K1f": K1F, "K3p": K3P, "K2p": K2P}
E2E = ("flat packed kv bms m=256", "S1 packed kv bms", "packed kv sort r=8",
       "F1 fused dms sort", "F1 fused kv sort", "F3 fused kv sort", "flat kv bms m=256",
       "kv sort r=8")


def e2e_child(tree: str) -> int:
    """Time the packed and fused entry points of ``tree``'s package end to
    end and print one JSON object, name -> ms."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from repro_torch import ops
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n, n_small = 1 << 25, 1 << 22
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    s1, f3 = (torch.from_numpy(ragged(rng, n_, s_, e_)).to(dev) for n_, s_, e_ in
              ((n, 64, (0, 31, 63)), (n_small, 16, (5,))))
    spec256, spec32 = ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32)
    ks, vs = keys[:n_small], vals[:n_small]
    calls = {
        "flat packed kv bms m=256": lambda: ops.multisplit(keys, spec256, vals, method="bms",
                                                           family="packed", device=dev),
        "S1 packed kv bms": lambda: ops.segmented_multisplit(keys, spec32, s1, vals, method="bms",
                                                             family="packed", device=dev),
        "packed kv sort r=8": lambda: ops.radix_sort(keys, vals, family="packed", device=dev),
        "F1 fused dms sort": lambda: ops.radix_sort(keys, method="dms", fuse_digits=True,
                                                    device=dev),
        "F1 fused kv sort": lambda: ops.radix_sort(keys, vals, fuse_digits=True, device=dev),
        "F3 fused kv sort": lambda: ops.segmented_radix_sort(ks, f3, vs, fuse_digits=True,
                                                             device=dev),
        "flat kv bms m=256": lambda: ops.multisplit(keys, spec256, vals, method="bms", device=dev),
        "kv sort r=8": lambda: ops.radix_sort(keys, vals, device=dev),
    }
    print(json.dumps({name: base.cuda_ms(fn, reps=5, inner=1) for name, fn in calls.items()}),
          flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="a tree (unpacked commit) whose K1p and K3f to break "
                                          "down, and whose K2f, K1f, K3p and K2p to time in "
                                          "turns with this tree's")
    parser.add_argument("--e2e-child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.e2e_child:
        return e2e_child(args.e2e_child)
    if not torch.cuda.is_available():
        print("k1pk3f_variants: needs a CUDA card", file=sys.stderr)
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
        for name, (source, edits, right) in PARENT_VARIANTS.items():
            variants[name] = (source, edits, right, other)
        for name, source in SHARED.items():
            variants[name] = (source, [], True)
            variants[f"{name} parent"] = (source, [], True, other)
    fns = base.build_variants(build, variants, "variants_k1pk3f")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n = 1 << 25
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    stream = torch.cuda.current_stream().cuda_stream

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

    def seg_strip(starts, shape):
        seg = st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), shape[0] * shape[1])
        return seg.view(shape)

    # K1p: flat m = 256 in tiles of 4096 (labels in the kernel and on the
    # ids strip) and of 8192, and S1
    t4, t8 = 4096, 8192
    kt, vt = keys.view(-1, t4), vals.view(-1, t4)
    spec256, spec32 = ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32)
    seg1 = seg_strip(ragged(rng, n, 64, (0, 31, 63)), kt.shape)
    ids256 = mst.spec_bucket_ids_plain(kt, spec256)
    k1p_cases = []
    for what, tiled, spec, m, seg, s in (
            ("flat m = 256, tiles of 4096, labels in the kernel", kt, spec256, None, None, 1),
            ("flat m = 256, tiles of 4096, ids strip", ids256, None, 256, None, 1),
            ("flat m = 256, tiles of 8192, labels in the kernel", keys.view(-1, t8), spec256, None,
             None, 1),
            ("S1 (s = 64, m = 32), labels in the kernel", kt, spec32, None, seg1, 64)):
        kw = dict(spec=spec) if spec is not None else dict(num_buckets=m)
        want = mst.packed_tile_histograms_plain(tiled, seg, num_segments=s, **kw)
        label = (mst.label_args(spec, tiled.dtype, dev) if spec is not None
                 else mst.identity_args(m))
        k1p_cases.append((what, tiled, seg, s, label, want, spec is None))
    for what, tiled, seg, s, label, want, ids_entry in k1p_cases:
        hist = torch.empty_like(want)
        parts = []
        for name, (source, fn) in fns.items():
            if source != K1P:
                continue
            def call(fn=fn):
                return fn(None if ids_entry else tiled.data_ptr(),
                          tiled.data_ptr() if ids_entry else None,
                          seg.data_ptr() if seg is not None else None, hist.data_ptr(),
                          tiled.shape[0], tiled.shape[1], s, 128, *label, stream)
            parts.append(timed(name, call, [hist], [want]))
        print(f"[variants] K1p {what}: " + "; ".join(parts) + f" ms [n = 2^25, subtile 128; {smi}]",
              flush=True)

    # K3f: F1 in both families, F3 segmented (onehot)
    small = 1 << 22
    spec16 = ops.BitfieldSpec(0, 16)
    f3 = ragged(rng, small, 16, (5,))
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    for what, k, sg, s, family in (("F1 onehot", keys, None, 1, "onehot"),
                                   ("F1 packed", keys, None, 1, "packed"),
                                   ("F3 onehot, 16 segments", keys[:small], f3, 16, "onehot")):
        kt8 = k.view(-1, t8)
        seg = seg_strip(sg, kt8.shape) if sg is not None else None
        g = st.global_scan(mst.fused2_tile_histograms_plain(kt8, seg, spec=spec16, num_segments=s))
        want = mst.fused2_tile_positions_plain(kt8, g, seg, spec=spec16, split=8, num_segments=s,
                                               family=family)
        got = pos[: kt8.numel()].view(kt8.shape)
        parts = []
        for name, (source, fn) in fns.items():
            if source != K3F:
                continue
            def call(fn=fn):
                return fn(kt8.data_ptr(), seg.data_ptr() if seg is not None else None, g.data_ptr(),
                          pos.data_ptr(), kt8.shape[0], t8, s, 0, 16, 8,
                          int(family == "packed"), stream)
            parts.append(timed(name, call, [got], [want]))
        print(f"[variants] K3f {what}: " + "; ".join(parts) +
              f" ms [tiles {kt8.shape[0]} x {t8}, pair (0, 16), sub_bits 8; {smi}]", flush=True)

    if args.against:
        # K2f key-value and K1f at F1; K3p and K2p key-value at flat m = 256:
        # parent, this, this, parent
        label256 = mst.label_args(spec256, kt.dtype, dev)
        g256 = st.global_scan(mst.spec_tile_histograms_plain(kt, spec256))
        kt8, vt8 = keys.view(-1, t8), vals.view(-1, t8)
        g16 = st.global_scan(mst.fused2_tile_histograms_plain(kt8, spec=spec16))
        wants = {
            "K2f": mst.fused2_fused_postscan_reorder_plain(kt8, g16, vt8, spec=spec16, split=8),
            "K1f": [mst.fused2_tile_histograms_plain(kt8, spec=spec16)],
            "K3p": [mst.packed_tile_positions_plain(kt, g256, spec=spec256)],
            "K2p": mst.packed_fused_postscan_reorder_plain(kt, g256, None, vt, spec=spec256),
        }
        outs = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(4)]
        hist16 = torch.empty_like(wants["K1f"][0])
        for kernel in SHARED:
            parts = []
            for name in (f"{kernel} parent", kernel, kernel, f"{kernel} parent"):
                fn = fns[name][1]
                if kernel == "K2f":
                    def call(fn=fn):
                        return fn(kt8.data_ptr(), None, g16.data_ptr(), vt8.data_ptr(),
                                  *(o.data_ptr() for o in outs), kt8.shape[0], t8, 1, 0, 16, 8, 0,
                                  stream)
                    got = [o.view(kt8.shape) for o in outs]
                elif kernel == "K1f":
                    def call(fn=fn):
                        return fn(kt8.data_ptr(), None, hist16.data_ptr(), kt8.shape[0], t8, 1, 0,
                                  16, stream)
                    got = [hist16]
                elif kernel == "K3p":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), None, None, g256.data_ptr(), outs[0].data_ptr(),
                                  kt.shape[0], t4, 1, 128, *label256, stream)
                    got = [outs[0].view(kt.shape)]
                else:
                    def call(fn=fn):
                        return fn(kt.data_ptr(), None, None, g256.data_ptr(), vt.data_ptr(),
                                  *(o.data_ptr() for o in outs), kt.shape[0], t4, 1, 128,
                                  *label256, stream)
                    got = [o.view(kt.shape) for o in outs]
                parts.append(timed(name, call, got, wants[kernel]))
            shape = ("F1, tiles 4096 x 8192, pair (0, 16)" + (", sub_bits 8, onehot, key-value"
                                                              if kernel == "K2f" else "")
                     if kernel in ("K2f", "K1f")
                     else "n = 2^25, m = 256, tiles 8192 x 4096" + (", key-value" * (kernel == "K2p")))
            print(f"[variants] {kernel} in turns: " + "; ".join(parts) + f" ms [{shape}; {smi}]",
                  flush=True)
        # the entry points end to end, each tree in its own process
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
