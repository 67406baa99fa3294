#!/usr/bin/env python3
"""Time K3p and B10 against variants of their own sources, on one CUDA card.

    python3 tools/k3pb10_variants.py [--against TREE]

Each variant is the committed ``packed_tile_positions.cu`` (K3p) or
``tile_reorder.cu`` (B10) with one design choice changed by a text edit,
built by ``tools/k1k2_variants.py``'s ``build_variants`` (an edit that
matches nothing in the source applies to the local header that holds its
text). For K3p: three blocks an SM in every form at T <= 4096 (the design
asks four) and in the general form alone, one block an SM at T = 8192, the
packed rank's unpack as a loop or as one 16-byte read-modify-write of four
carries, its peers from ballots over the label's bits (and both), one
stage, and K3's ballot rank
(``sm90::warp_rank``) in place of the packed rank (the figure A8 weighs the
families by). K3p runs flat at n = 2^25 in 8192 tiles of 4096 at m = 256 in
the shift form (``DeltaSpec(256, 2^32)``), on the ids strip (the clamp
form) and at m = 255 in the general form, in 4096 tiles of 8192, at S1 (64
ragged segments, ``DeltaSpec(32, 2^32)``) and at S3 (2^20 ids over 256
requests, m = 64, the clamp form), all at subtile 128. For B10: one stage,
tiles of at most 1024 keys at four blocks an SM and, as kR = 16 at two,
K2's in-place reorder (keys, then values, through registers) in place of
the moves into the dead planes; key-value and key-only at n = 2^25, m =
256 in tiles of 4096, key-value in tiles of 1024 (``multisplit_unfused``'s
wms tile) and of 8192. Each kernel is also broken down by phase: its rank
cut out (identity ranks), its scan of the warp counters cut out, its
write-out cut out (results wrong by design and marked so).

With ``--against TREE`` (an unpacked parent commit), the parent's K3p and
B10 are built too, whole and with the rank cut out (every key in bucket 0
at its own index), and timed beside the design; K3, K3s, K2, K2 on ids, K2p and
K1p, whose headers this change touches, are built from both trees and timed
in turns: parent, this, this, parent. Then the entry points run end to end,
each tree's package in a process of its own, in the same turns: the packed
flat key-value ``dms`` at m = 256, packed S1 key-value ``dms``, S3 packed
and onehot, ``multisplit_unfused`` key-value and key-only ``bms`` and
key-value ``wms`` at m = 256, and the default flat key-value ``bms`` and
``dms`` beside them; medians of 5 calls.

Each line gives the median ms of 7 x 3 calls, the better of two such
medians, and whether the result is bitwise the plain version's; the build
lines give each variant's ptxas registers and spills. A variant whose edit
no longer applies to the sources is reported and skipped.
"""

from __future__ import annotations

import argparse
import ctypes
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
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")

K3P, B10 = "packed_tile_positions", "tile_reorder"
K3, K3S, K2, K2P, K1P = ("tile_positions", "seg_tile_positions", "fused_postscan_reorder",
                         "packed_fused_postscan_reorder", "packed_tile_histograms")
OUT_DIR = "variants_k3pb10"

K3P_BLOCKS = "  return kR <= 16 ? 4 : (kForm == sm90::kAnySpec ? 1 : 2);"
K3P_RANK = "      sm90::packed_warp_rank<kR, kForm>(ks + a, len, F, sp, mine, pw, r0, r1, nbits, sub, rb);"
LOOP_UNPACK = (K3P_RANK, K3P_RANK.replace("<kR, kForm>", "<kR, kForm, false>"))
ONE_STAGE = ("&Y.stages, &smem);\n", "&Y.stages, &smem);\n  Y.stages = 1;\n  smem = one;\n")
# every key at its own index in bucket 0: the rank's cost, with the rest
# of the kernel's traffic as it is
IDENTITY_RANKS = """#pragma unroll
      for (int r = 0; r < kR; ++r) rb[r] = (((r0 + r) << 5) + lane) << ms::kLabelBits;"""
# the packed rank's peers from ballots over the label's bits, as K3's
MATCH_PEERS = "      const unsigned peers = __match_any_sync(ms::kFull, valid ? b : -1);"
BALLOT_PEERS = """      unsigned peers = __ballot_sync(ms::kFull, valid);
      for (int bit = 0; bit < nbits; ++bit) {
        const bool on = (b >> bit) & 1;
        const unsigned bal = __ballot_sync(ms::kFull, on);
        peers &= on ? bal : ~bal;
      }"""
# the packed rank's unpack as one 16-byte read-modify-write of four carries
# a word (m % 4 == 0), skipped for a zero word
UNPACK = """#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (4 * w + t < m) mine[4 * w + t] += static_cast<int>((x >> (8 * t)) & 0xffu);"""
UNPACK_INT4 = """          if ((m & 3) == 0) {
            if (x) {
              int4* const c = reinterpret_cast<int4*>(mine + 4 * w);
              int4 v = *c;
              v.x += static_cast<int>(x & 0xffu);
              v.y += static_cast<int>((x >> 8) & 0xffu);
              v.z += static_cast<int>((x >> 16) & 0xffu);
              v.w += static_cast<int>(x >> 24);
              *c = v;
            }
          } else {
            for (int t = 0; t < 4; ++t)
              if (4 * w + t < m) mine[4 * w + t] += static_cast<int>((x >> (8 * t)) & 0xffu);
          }"""
B10_BLOCKS = "  return kR <= 4 ? 3 : (kR <= 16 ? 2 : 1);"
B10_RANK = "    sm90::warp_rank<kR, sm90::kClampedId>(ip, T, F, nullptr, mine, r0, r1, nbits, rb);"


def b10_in_place() -> tuple:
    """K2's in-place reorder in B10: (old, new) over the source's steps 3 to 5."""
    with open(os.path.join(CSRC, f"{B10}.cu")) as f:
        text = f.read()
    a = text.index("    // 3. dest in element order")
    e = text.index("\n  }\n}\n\ntemplate <int kR>")
    new = """    // 3. dest in element order, the keys into registers
    const int label_mask = (1 << ms::kLabelBits) - 1;
    uint32_t word[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ((r0 + r) << 5) + lane;
      if (r0 + r < r1 && i < T) {
        const int d = mine[rb[r] & label_mask] + (rb[r] >> ms::kLabelBits);
        dest[base + i] = d;
        word[r] = ks[i];
        rb[r] = d;
      }
    }
    __syncthreads();                                 // every key of the stage is read
    for (int j = tid; j < kWarps * m; j += kThreads) cnt[j] = 0;
    // 4. the reorder in place, a plane at a time
    uint32_t* const vw = plane(st, 2);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ((r0 + r) << 5) + lane;
      if (r0 + r < r1 && i < T) {
        ks[rb[r]] = word[r];
        if (has_vals) word[r] = vs[i];
      }
    }
    if (has_vals) {
      __syncthreads();                               // every value of the stage is read
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ((r0 + r) << 5) + lane;
        if (r0 + r < r1 && i < T) vw[rb[r]] = word[r];
      }
    }
    __syncthreads();
    // 5. write-out of keys_r and vals_r rows from the key and value planes
    if (vec) {
      const int nv = T >> 2;
      for (int v = tid; v < nv; v += kThreads)
        reinterpret_cast<uint4*>(keys_r + base)[v] = reinterpret_cast<const uint4*>(ks)[v];
      if (has_vals)
        for (int v = tid; v < nv; v += kThreads)
          reinterpret_cast<uint4*>(vals_r + base)[v] = reinterpret_cast<const uint4*>(vw)[v];
    } else {
      for (int j = tid; j < T; j += kThreads) {
        keys_r[base + j] = ks[j];
        if (has_vals) vals_r[base + j] = vw[j];
      }
    }"""
    return text[a:e], new


# name -> (source, [(old, new), ...], True when the result must stay right)
VARIANTS = {
    "K3p": (K3P, [], True),
    "K3p three blocks an SM": (K3P, [(K3P_BLOCKS, K3P_BLOCKS.replace("16 ? 4", "16 ? 3"))], True),
    "K3p general form at three blocks an SM": (K3P, [(K3P_BLOCKS, K3P_BLOCKS.replace(
        "16 ? 4", "16 ? (kForm == sm90::kAnySpec ? 3 : 4)"))], True),
    "K3p one block an SM at T = 8192": (K3P, [(K3P_BLOCKS, "  return kR <= 16 ? 4 : 1;")], True),
    "K3p loop unpack": (K3P, [LOOP_UNPACK], True),
    "K3p ballot peers in the packed rank": (K3P, [(MATCH_PEERS, BALLOT_PEERS)], True),
    "K3p 16-byte unpack": (K3P, [(UNPACK, UNPACK_INT4)], True),
    "K3p ballot peers, 16-byte unpack": (K3P, [(MATCH_PEERS, BALLOT_PEERS), (UNPACK, UNPACK_INT4)],
                                         True),
    "K3p one stage": (K3P, [ONE_STAGE], True),
    "K3p ballots (sm90::warp_rank)": (K3P, [(K3P_RANK, "      sm90::warp_rank<kR, kForm>(ks + a, "
                                                       "len, F, sp, mine, r0, r1, nbits, rb);")],
                                      True),
    "K3p, rank cut": (K3P, [(K3P_RANK, IDENTITY_RANKS)], False),
    "K3p, scan cut": (K3P, [("      if (tid < m) {\n        int run = one_run",
                             "      if (tid < 0) {\n        int run = one_run")], False),
    "K3p, write-out cut": (K3P, [("v < (T >> 2); v += kThreads) po[v]",
                                  "v < 0; v += kThreads) po[v]")], False),
    "B10": (B10, [], True),
    "B10 one stage": (B10, [ONE_STAGE], True),
    "B10 T <= 1024 at two blocks an SM (kR = 16)": (B10, [(
        "  if (T <= 4 * 32 * kWarps)\n    return launch<4>",
        "  if (false)\n    return launch<4>")], True),
    "B10 T <= 1024 at four blocks an SM": (B10, [(B10_BLOCKS, B10_BLOCKS.replace("4 ? 3", "4 ? 4"))],
                                           True),
    "B10 in-place reorder (K2's)": (B10, [b10_in_place()], True),
    "B10, rank cut": (B10, [(B10_RANK, IDENTITY_RANKS.replace("\n      ", "\n    "))], False),
    "B10, scan cut": (B10, [("    const int first = ms::block_exclusive_scan(total, wsum);",
                             "    const int first = 0;")], False),
    "B10, write-out cut": (B10, [("      const int nv = T >> 2;", "      const int nv = 0;")],
                           False),
}
# the parent's K3p and B10, whole and with the rank cut out: its meta plane
# filled with bucket 0 at each key's own index, so every write stays in
# bounds
PARENT_VARIANTS = {
    "K3p parent": (K3P, [], True),
    "K3p parent, rank cut": (K3P, [(
        "    ms::packed_rank_range<true, false, kIds>(k + a, kIds ? id + a : nullptr, len, sub, L, "
        "sp,\n                                             cnt, words, meta + a, nullptr);",
        "    for (int j = threadIdx.x; j < len; j += blockDim.x) meta[a + j] = j << ms::kLabelBits;")],
        False),
    "B10 parent": (B10, [], True),
    "B10 parent, rank cut": (B10, [(
        "  ms::rank_tile<true, true>(nullptr, ids + base, T, L, nullptr, cnt, meta);",
        "  for (int i = threadIdx.x; i < T; i += blockDim.x) meta[i] = i << ms::kLabelBits;")],
        False),
}
# the kernels whose headers this change touches, built from both trees
SHARED = {"K3": K3, "K3s": K3S, "K2": K2, "K2 on ids": K2, "K2p": K2P, "K1p": K1P}
E2E = ("packed flat kv dms m=256", "packed S1 kv dms", "packed S3 routing", "S3 routing",
       "unfused kv bms m=256", "unfused key-only bms m=256", "unfused kv wms m=256",
       "flat kv bms m=256", "flat kv dms m=256")


def e2e_child(tree: str) -> int:
    """Time the entry points of ``tree``'s package end to end and print one
    JSON object, name -> ms."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import numpy as np
    import torch
    from repro_torch import ops
    from repro_torch.core import multisplit as core_ms
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    n, n3 = 1 << 25, 1 << 20
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    ids3 = torch.randint(0, 64, (n3,), dtype=torch.int32, device=dev, generator=gen)
    s1, s3 = (torch.from_numpy(ragged(rng, n_, s_, e_)).to(dev) for n_, s_, e_ in
              ((n, 64, (0, 31, 63)), (n3, 256, range(0, 256, 37))))
    spec256, spec32, spec64 = (ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32),
                               ops.IdentitySpec(64))
    calls = {
        "packed flat kv dms m=256": lambda: ops.multisplit(keys, spec256, vals, method="dms",
                                                           family="packed", device=dev),
        "packed S1 kv dms": lambda: ops.segmented_multisplit(keys, spec32, s1, vals, method="dms",
                                                             family="packed", device=dev),
        "packed S3 routing": lambda: ops.segmented_multisplit(
            ids3, spec64, s3, method="dms", mode="positions_only", family="packed", device=dev),
        "S3 routing": lambda: ops.segmented_multisplit(ids3, spec64, s3, method="dms",
                                                       mode="positions_only", device=dev),
        "unfused kv bms m=256": lambda: core_ms.multisplit_unfused(keys, spec256, vals,
                                                                   method="bms", device=dev),
        "unfused key-only bms m=256": lambda: core_ms.multisplit_unfused(keys, spec256,
                                                                         method="bms", device=dev),
        "unfused kv wms m=256": lambda: core_ms.multisplit_unfused(keys, spec256, vals,
                                                                   method="wms", device=dev),
        "flat kv bms m=256": lambda: ops.multisplit(keys, spec256, vals, method="bms", device=dev),
        "flat kv dms m=256": lambda: ops.multisplit(keys, spec256, vals, method="dms", device=dev),
    }
    print(json.dumps({name: base.cuda_ms(fn, reps=5, inner=1) for name, fn in calls.items()}),
          flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="a tree (unpacked commit) whose K3p and B10 to time "
                                          "beside the design, and whose K3, K3s, K2, K2p and K1p "
                                          "to time in turns with this tree's")
    parser.add_argument("--e2e-child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.e2e_child:
        return e2e_child(args.e2e_child)
    if not torch.cuda.is_available():
        print("k3pb10_variants: needs a CUDA card", file=sys.stderr)
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
            if name != "K2 on ids":
                variants[name] = (source, [], True)
                variants[f"{name} parent"] = (source, [], True, other)
    fns = base.build_variants(build, variants, OUT_DIR)
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

    # K3p: flat m = 256 in tiles of 4096 (shift form, ids strip), the general
    # form at m = 255, tiles of 8192, S1 and S3
    t4, t8 = 4096, 8192
    kt, vt = keys.view(-1, t4), vals.view(-1, t4)
    spec256, spec32 = ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32)
    spec255 = ops.DeltaSpec(255, 1 << 32)
    seg1 = seg_strip(ragged(rng, n, 64, (0, 31, 63)), kt.shape)
    n3 = 1 << 20
    ids3 = torch.randint(0, 64, (n3 // t4, t4), dtype=torch.int32, device=dev, generator=gen)
    seg3 = seg_strip(ragged(rng, n3, 256, range(0, 256, 37)), ids3.shape)
    ids256 = mst.spec_bucket_ids_plain(kt, spec256)
    pos = torch.empty((n,), dtype=torch.int32, device=dev)
    k3p_cases = []
    for what, tiled, spec, m, seg, s in (
            ("flat m = 256, tiles of 4096, labels in the kernel (shift form)", kt, spec256, None,
             None, 1),
            ("flat m = 256, tiles of 4096, ids strip (clamp form)", ids256, None, 256, None, 1),
            ("flat m = 255, tiles of 4096, labels in the kernel (general form)", kt, spec255, None,
             None, 1),
            ("flat m = 256, tiles of 8192, labels in the kernel", keys.view(-1, t8), spec256, None,
             None, 1),
            ("S1 (s = 64, m = 32), labels in the kernel", kt, spec32, None, seg1, 64),
            ("S3 (2^20 ids, s = 256, m = 64), ids strip", ids3, None, 64, seg3, 256)):
        kw = dict(spec=spec) if spec is not None else dict(num_buckets=m)
        g = st.global_scan(mst.packed_tile_histograms_plain(tiled, seg, num_segments=s, **kw))
        want = mst.packed_tile_positions_plain(tiled, g, seg, num_segments=s, subtile=128, **kw)
        label = (mst.label_args(spec, tiled.dtype, dev) if spec is not None
                 else mst.identity_args(m))
        k3p_cases.append((what, tiled, seg, s, g, label, want, spec is None))
    for what, tiled, seg, s, g, label, want, ids_entry in k3p_cases:
        got = pos[: tiled.numel()].view(tiled.shape)
        parts = []
        for name, (source, fn) in fns.items():
            if source != K3P:
                continue
            def call(fn=fn, tiled=tiled, seg=seg, s=s, g=g, label=label, ids_entry=ids_entry):
                return fn(None if ids_entry else tiled.data_ptr(),
                          tiled.data_ptr() if ids_entry else None,
                          seg.data_ptr() if seg is not None else None, g.data_ptr(),
                          pos.data_ptr(), tiled.shape[0], tiled.shape[1], s, 128, *label, stream)
            parts.append(timed(name, call, [got], [want]))
        print(f"[variants] K3p {what}: " + "; ".join(parts) + f" ms [subtile 128; {smi}]",
              flush=True)

    # B10: key-value and key-only at m = 256 in tiles of 4096, key-value in
    # tiles of 1024 and 8192
    outs = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(3)]
    for what, t, key_value in (("key-value, tiles of 4096", t4, True),
                               ("key-only, tiles of 4096", t4, False),
                               ("key-value, tiles of 1024", 1024, True),
                               ("key-value, tiles of 8192", t8, True)):
        ids = mst.spec_bucket_ids_plain(keys.view(-1, t), spec256)
        k_, v_ = keys.view(-1, t), vals.view(-1, t) if key_value else None
        want = mst.tile_reorder_plain(ids, k_, v_, 256)
        got = [o.view(-1, t) for o in outs]
        got = [got[0], got[1] if key_value else None, got[2]]
        parts = []
        for name, (source, fn) in fns.items():
            if source != B10:
                continue
            def call(fn=fn, ids=ids, k_=k_, v_=v_, t=t):
                return fn(ids.data_ptr(), k_.data_ptr(), v_.data_ptr() if v_ is not None else None,
                          outs[0].data_ptr(), outs[1].data_ptr() if v_ is not None else None,
                          outs[2].data_ptr(), ids.shape[0], t, 256, stream)
            parts.append(timed(name, call, got, want))
        print(f"[variants] B10 {what}: " + "; ".join(parts) +
              f" ms [n = 2^25, m = 256; {smi}]", flush=True)

    if args.against:
        # K3, K3s, K2, K2 on ids, K2p and K1p from both trees: parent, this,
        # this, parent
        label256 = mst.label_args(spec256, kt.dtype, dev)
        label32 = mst.label_args(spec32, kt.dtype, dev)
        g256 = st.global_scan(mst.spec_tile_histograms_plain(kt, spec256))
        g1 = st.global_scan(mst.seg_spec_tile_histograms_plain(kt, seg1, spec32, 64))
        wants = {
            "K3": [mst.spec_tile_positions_plain(kt, g256, spec256)],
            "K3s": [mst.seg_spec_tile_positions_plain(kt, seg1, g1, spec32, 64)],
            "K2": mst.spec_fused_postscan_reorder_plain(kt, g256, vt, spec256),
            "K2 on ids": mst.fused_postscan_reorder_plain(ids256, g256, kt, vt, 256),
            "K2p": mst.packed_fused_postscan_reorder_plain(kt, g256, None, vt, spec=spec256),
            "K1p": [mst.packed_tile_histograms_plain(kt, spec=spec256)],
        }
        outs = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(4)]
        hist = torch.empty_like(wants["K1p"][0])
        lib = {name: os.path.join(ROOT, "build", OUT_DIR, f"v{i}", f"lib{spec[0]}.so")
               for i, (name, spec) in enumerate(variants.items())}
        for kernel in SHARED:
            parts = []
            for name in (f"{kernel} parent", kernel, kernel, f"{kernel} parent"):
                built = name.replace("K2 on ids", "K2")
                fn = fns[built][1]
                shaped = [o.view(kt.shape) for o in outs]
                if kernel == "K3":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), g256.data_ptr(), outs[0].data_ptr(), kt.shape[0],
                                  t4, *label256, stream)
                    got = shaped[:1]
                elif kernel == "K3s":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), seg1.data_ptr(), g1.data_ptr(),
                                  outs[0].data_ptr(), kt.shape[0], t4, 64, *label32, stream)
                    got = shaped[:1]
                elif kernel == "K2":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), g256.data_ptr(), vt.data_ptr(),
                                  *(o.data_ptr() for o in outs), kt.shape[0], t4, *label256,
                                  stream)
                    got = shaped
                elif kernel == "K2 on ids":
                    symbol, argtypes = build.ENTRY_POINTS["fused_postscan_reorder_ids"]
                    fn = getattr(ctypes.CDLL(lib[built]), symbol)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int

                    def call(fn=fn):
                        return fn(ids256.data_ptr(), g256.data_ptr(), kt.data_ptr(), vt.data_ptr(),
                                  *(o.data_ptr() for o in outs), kt.shape[0], t4, 256, stream)
                    got = shaped
                elif kernel == "K2p":
                    def call(fn=fn):
                        return fn(kt.data_ptr(), None, None, g256.data_ptr(), vt.data_ptr(),
                                  *(o.data_ptr() for o in outs), kt.shape[0], t4, 1, 128,
                                  *label256, stream)
                    got = shaped
                else:
                    def call(fn=fn):
                        return fn(kt.data_ptr(), None, None, hist.data_ptr(), kt.shape[0], t4, 1,
                                  128, *label256, stream)
                    got = [hist]
                variants[name] = variants[built]
                parts.append(timed(name, call, got, wants[kernel]))
            shape = ("S1, s = 64, m = 32" if kernel == "K3s" else "n = 2^25, m = 256") + \
                ", tiles 8192 x 4096" + (", key-value" if kernel.startswith("K2") else "")
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
