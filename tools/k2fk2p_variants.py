#!/usr/bin/env python3
"""Time K2f and K2p against variants of their own sources, on one CUDA card.

    python3 tools/k2fk2p_variants.py [--against TREE]

Each variant is the committed ``fused2_fused_postscan_reorder.cu`` (K2f) or
``packed_fused_postscan_reorder.cu`` (K2p) with one design choice changed by
a text edit, as ``tools/k1k2_variants.py`` does for K1 and K2 (and through
its ``build_variants``; an edit that matches nothing in the source applies
to the local header that holds its text: ``multisplit_sm90.cuh``, where the
packed rank lives, or ``multisplit_fused2.cuh``, where K2f's body lives
beside K3f's), each a choice the design rejected: for K2p, the packed
rank's peers from ballots over the
label bits instead of ``__match_any_sync``, one stage and two stages
instead of the launch's own choice, one block an SM instead of two; for
K2f, the values gathered from the tile's row in device memory instead of
through the free key buffer, G read once a cell run instead of once a key,
the next tile's keys staged (two stages, one block an SM at T = 8192), one
block an SM instead of two. K2f runs at F1, n = 2^25 keys in 4096 tiles of
8192, the pair (0, 16) in stages of 8 bits, key-value, in both families,
and segmented at F3 (2^22 keys over 16 ragged segments); K2p flat at n =
2^25 in 8192 tiles of 4096, key-value, ``DeltaSpec(256, 2^32)`` with labels
in the kernel and on the ids strip, and at S1 (64 ragged segments,
``DeltaSpec(32, 2^32)``).

With ``--against TREE`` (an unpacked parent commit), the parent's K2f and
K2p are built too, whole and with a phase cut out to show where their time
goes (K2f: the walk over the sorted tile, or the sweep of the sort; K2p:
the scatter and write-out, or the write-out alone; results wrong by design
and marked so). K2, K3f, K1p and K3p, whose sources share headers with
K2f's and K2p's, are built from both trees and timed in turns: parent,
this, this, parent. Then the packed and fused entry points run end to end,
each tree's package in a process of its own, in the same turns: the flat
packed key-value ``bms`` at m = 256, S1 packed, the F1 fused key-value sort
and its packed family, F3, and the default (onehot, unfused) flat
key-value ``bms`` and sort beside them; medians of 5 calls.

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

K2F, K2P = "fused2_fused_postscan_reorder", "packed_fused_postscan_reorder"
ONE_STAGE = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 1;\n  smem = one;\n")
TWO_STAGES = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 2;\n  smem = two;\n")
PACKED_PEERS = "      const unsigned peers = __match_any_sync(ms::kFull, valid ? b : -1);"
BALLOT_PEERS = """      unsigned peers = __ballot_sync(ms::kFull, valid);
      for (int bit = 0; bit < nbits; ++bit) {
        const bool on = (b >> bit) & 1;
        const unsigned bal = __ballot_sync(ms::kFull, on);
        peers &= on ? bal : ~bal;
      }"""
# K2f: G read at the cell runs' head lanes only, each key's base then read
# at its head's position (where pos = base, so the rewrite leaves it)
G_ONCE_A_RUN = [
    ("          gv[r - h] = valid ? __ldg(at) : 0;", "          gv[r - h] = head ? __ldg(at) : 0;"),
    ("        if (r0 + r < r1 && p < T)\n          free_k[p]",
     "        if (r0 + r < r1 && ((hmask[r0 + r] >> lane) & 1u))\n          free_k[p]"),
    ("          const int pos = static_cast<int>(free_k[p]) + p - head;",
     "          const int pos = static_cast<int>(free_k[head]) + p - head;")]
# K2f: the values gathered by source index from the tile's row in device
# memory, pos_r staged in the free key buffer and written 16 bytes a store
VALS_FROM_DEVICE = [
    ("          if (!kPositions) pos_r[base + p] = pos;\n",
     "          if (!kPositions) free_k[p] = static_cast<uint32_t>(pos);\n"),
    ("      if (has_vals) {\n        sm90::stage_row<kThreads>(free_k, vals + base, T, vec);\n"
     "        sm90::copy_wait_all();\n      }\n      __syncthreads();\n", ""),
    ("        reinterpret_cast<uint4*>(perm + base)[v] = reinterpret_cast<const uint4*>(fk)[v];\n",
     "        reinterpret_cast<uint4*>(perm + base)[v] = reinterpret_cast<const uint4*>(fk)[v];\n"
     "      for (int v = tid; v < nv; v += kThreads)\n"
     "        reinterpret_cast<uint4*>(pos_r + base)[v] = reinterpret_cast<const uint4*>(free_k)[v];\n"),
    ("              make_uint4(free_k[x.x], free_k[x.y], free_k[x.z], free_k[x.w]);",
     "              make_uint4(__ldg(vals + base + x.x), __ldg(vals + base + x.y),\n"
     "                         __ldg(vals + base + x.z), __ldg(vals + base + x.w));"),
    ("        if (has_vals) vals_r[base + j] = free_k[fi[j]];",
     "        pos_r[base + j] = static_cast<int>(free_k[j]);\n"
     "        if (has_vals) vals_r[base + j] = __ldg(vals + base + fi[j]);")]

# name -> (source, [(old, new), ...], True when the result must stay right)
VARIANTS = {
    "K2p": (K2P, [], True),
    "K2p ballot peers": (K2P, [(PACKED_PEERS, BALLOT_PEERS)], True),
    "K2p one stage": (K2P, [ONE_STAGE], True),
    "K2p two stages": (K2P, [TWO_STAGES], True),
    "K2p one block an SM": (K2P, [("kR <= 16 ? 2 : 1)", "1)")], True),
    "K2f": (K2F, [], True),
    "K2f values from device memory": (K2F, VALS_FROM_DEVICE, True),
    "K2f G once a cell run": (K2F, G_ONCE_A_RUN, True),
    "K2f two stages": (K2F, [TWO_STAGES], True),
    "K2f one block an SM": (K2F, [("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")],
                            True),
}
# the parent's K2f and K2p, whole and with a phase cut out
PARENT_VARIANTS = {
    "K2f parent": (K2F, [], True),
    "K2f parent, walk cut": (K2F, [("  ms::walk_cells<kSeg>(fk, seg, T, s, shift, bits, wsum,",
                                    "  if (false) ms::walk_cells<kSeg>(fk, seg, T, s, shift, bits, "
                                    "wsum,")], False),
    "K2f parent, sweep cut": (K2F, [("(keys + base, T, runs, nruns, shift, bits,",
                                     "(keys + base, T, runs, nruns, shift, 0,")], False),
    "K2p parent": (K2P, [], True),
    "K2p parent, scatter and write-out cut": (K2P, [
        ("    for (int j = threadIdx.x; j < len; j += blockDim.x) {\n      const int i = a + j;",
         "    for (int j = threadIdx.x; j < 0; j += blockDim.x) {\n      const int i = a + j;"),
        ("  for (int j = threadIdx.x; j < T; j += blockDim.x) {\n    keys_r[base + j] = sk[j];",
         "  for (int j = threadIdx.x; j < 0; j += blockDim.x) {\n    keys_r[base + j] = sk[j];")],
        False),
    "K2p parent, write-out cut": (K2P, [
        ("  for (int j = threadIdx.x; j < T; j += blockDim.x) {\n    keys_r[base + j] = sk[j];",
         "  for (int j = threadIdx.x; j < 0; j += blockDim.x) {\n    keys_r[base + j] = sk[j];")],
        False),
}
# the kernels that share headers with K2f and K2p, built from both trees
SHARED = {"K2": "fused_postscan_reorder", "K3f": "fused2_tile_positions",
          "K1p": "packed_tile_histograms", "K3p": "packed_tile_positions"}
E2E = ("flat packed kv bms m=256", "S1 packed kv bms", "F1 fused kv sort", "F1 fused packed kv sort",
       "F3 fused kv sort", "flat kv bms m=256", "kv sort r=8")


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
        "F1 fused kv sort": lambda: ops.radix_sort(keys, vals, fuse_digits=True, device=dev),
        "F1 fused packed kv sort": lambda: ops.radix_sort(keys, vals, family="packed",
                                                          fuse_digits=True, device=dev),
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
    parser.add_argument("--against", help="a tree (unpacked commit) whose K2f and K2p to break "
                                          "down, and whose K2, K3f, K1p and K3p to time in turns "
                                          "with this tree's")
    parser.add_argument("--e2e-child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.e2e_child:
        return e2e_child(args.e2e_child)
    if not torch.cuda.is_available():
        print("k2fk2p_variants: needs a CUDA card", file=sys.stderr)
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
    fns = base.build_variants(build, variants, "variants_k2fk2p")
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

    # K2f: F1 in both families, F3 segmented (onehot)
    t8, small = 8192, 1 << 22
    spec16 = ops.BitfieldSpec(0, 16)
    f3 = ragged(rng, small, 16, (5,))
    k2f_cases = []
    for what, k, v, sg, s, family in (
            ("F1 onehot", keys, vals, None, 1, "onehot"),
            ("F1 packed", keys, vals, None, 1, "packed"),
            ("F3 onehot, 16 segments", keys[:small], vals[:small], f3, 16, "onehot")):
        kt, vt = k.view(-1, t8), v.view(-1, t8)
        seg = seg_strip(sg, kt.shape) if sg is not None else None
        g = st.global_scan(mst.fused2_tile_histograms_plain(kt, seg, spec=spec16, num_segments=s))
        want = mst.fused2_fused_postscan_reorder_plain(kt, g, vt, seg, spec=spec16, split=8,
                                                       num_segments=s, family=family)
        k2f_cases.append((what, kt, vt, seg, s, int(family == "packed"), g, want))
    # K2p: flat m = 256 with labels in the kernel and on the ids strip, S1
    t4 = 4096
    kt, vt = keys.view(-1, t4), vals.view(-1, t4)
    spec256, spec32 = ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32)
    seg1 = seg_strip(ragged(rng, n, 64, (0, 31, 63)), kt.shape)
    ids256 = mst.spec_bucket_ids_plain(kt, spec256)
    k2p_cases = []
    for what, tiled, spec, m, seg, s in (
            ("flat m = 256, labels in the kernel", kt, spec256, None, None, 1),
            ("flat m = 256, ids strip", ids256, None, 256, None, 1),
            ("S1 (s = 64, m = 32), labels in the kernel", kt, spec32, None, seg1, 64)):
        kw = dict(spec=spec) if spec is not None else dict(num_buckets=m)
        h = mst.packed_tile_histograms_plain(tiled, seg, num_segments=s, **kw)
        g = st.global_scan(h)
        keys_tiled = None if spec is not None else kt
        want = mst.packed_fused_postscan_reorder_plain(tiled, g, keys_tiled, vt, seg,
                                                       num_segments=s, **kw)
        label = (mst.label_args(spec, kt.dtype, dev) if spec is not None else mst.identity_args(m))
        k2p_cases.append((what, tiled, seg, s, label, g, want, spec is None))
    outs = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(4)]

    for what, kt_, vt_, seg, s, packed, g, want in k2f_cases:
        parts = []
        for name, (source, fn) in fns.items():
            if source != K2F:
                continue
            def call(fn=fn):
                return fn(kt_.data_ptr(), seg.data_ptr() if seg is not None else None, g.data_ptr(),
                          vt_.data_ptr(), *(o.data_ptr() for o in outs), kt_.shape[0], t8, s, 0,
                          16, 8, packed, stream)
            got = [o[: kt_.numel()].view(kt_.shape) for o in outs]
            parts.append(timed(name, call, got, want))
        print(f"[variants] K2f {what}: " + "; ".join(parts) +
              f" ms [tiles {kt_.shape[0]} x {t8}, pair (0, 16), sub_bits 8, key-value; {smi}]",
              flush=True)
    for what, tiled, seg, s, label, g, want, ids_entry in k2p_cases:
        parts = []
        for name, (source, fn) in fns.items():
            if source != K2P:
                continue
            def call(fn=fn):
                return fn(kt.data_ptr(), tiled.data_ptr() if ids_entry else None,
                          seg.data_ptr() if seg is not None else None, g.data_ptr(), vt.data_ptr(),
                          *(o.data_ptr() for o in outs), kt.shape[0], t4, s, 128, *label, stream)
            got = [o.view(kt.shape) for o in outs]
            parts.append(timed(name, call, got, want))
        print(f"[variants] K2p {what}: " + "; ".join(parts) +
              f" ms [tiles {kt.shape[0]} x {t4}, subtile 128, key-value; {smi}]", flush=True)

    if args.against:
        # K2 (m = 256 key-value) and K1p / K3p (m = 256) at the main shape,
        # K3f at F1: parent, this, this, parent
        label256 = mst.label_args(spec256, kt.dtype, dev)
        g256 = st.global_scan(mst.spec_tile_histograms_plain(kt, spec256))
        h_want = mst.packed_tile_histograms_plain(kt, spec=spec256)
        p_want = mst.packed_tile_positions_plain(kt, g256, spec=spec256)
        k2_want = mst.spec_fused_postscan_reorder_plain(kt, g256, vt, spec256)
        kt8 = keys.view(-1, t8)
        g16 = st.global_scan(mst.fused2_tile_histograms_plain(kt8, spec=spec16))
        k3f_want = mst.fused2_tile_positions_plain(kt8, g16, spec=spec16, split=8)
        hist = torch.empty_like(h_want)
        for kernel in SHARED:
            parts = []
            for name in (f"{kernel} parent", kernel, kernel, f"{kernel} parent"):
                fn = fns[name][1]
                if kernel == "K2":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), g256.data_ptr(), vt.data_ptr(),
                                  *(o.data_ptr() for o in outs), kt.shape[0], t4, *label256, stream)
                    got, want = [o.view(kt.shape) for o in outs], k2_want
                elif kernel == "K3f":
                    def call(fn=fn):
                        return fn(kt8.data_ptr(), None, g16.data_ptr(), outs[0].data_ptr(),
                                  kt8.shape[0], t8, 1, 0, 16, 8, 0, stream)
                    got, want = [outs[0].view(kt8.shape)], [k3f_want]
                elif kernel == "K1p":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), None, None, hist.data_ptr(), kt.shape[0], t4, 1,
                                  128, *label256, stream)
                    got, want = [hist], [h_want]
                else:
                    def call(fn=fn):
                        return fn(kt.data_ptr(), None, None, g256.data_ptr(), outs[0].data_ptr(),
                                  kt.shape[0], t4, 1, 128, *label256, stream)
                    got, want = [outs[0].view(kt.shape)], [p_want]
                parts.append(timed(name, call, got, want))
            shape = ("F1, tiles 4096 x 8192, pair (0, 16), sub_bits 8, onehot" if kernel == "K3f"
                     else "n = 2^25, m = 256, tiles 8192 x 4096" + (", key-value" * (kernel == "K2")))
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
