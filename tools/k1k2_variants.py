#!/usr/bin/env python3
"""Time K1 and K2 against variants of their own sources, on one CUDA card.

    python3 tools/k1k2_variants.py

Each variant is the committed ``tile_histograms.cu`` or
``fused_postscan_reorder.cu`` with one design choice changed by a text
edit: a choice the design rejected (for K1: a warp-uniform shortcut, the
next tile's keys loaded into a second register set while the current one
counts, the general label form, three blocks an SM; for K2: one stage,
16-warp blocks, every round's labels ahead of the carry, ``__match_any_sync``
peer masks, TMA bulk stores of the rows) or a phase cut out to see what it
costs (K2's rank, its perm store, its write-out, all but the staging and
the write-out: those results are wrong by design and marked so). All
variants are built in parallel into ``build/variants/`` and called through
the same C entry points on the main shape: n = 2^25 keys in 8192 tiles of
4096, key-value, ``DeltaSpec(m, 2^32)`` with uniform keys at m in {2, 32,
256} and every key in one bucket at m = 256. Each line gives the median ms
of 7 x 3 calls, the better of two such medians, and whether the result is
bitwise the plain version's. A variant whose edit no longer applies to the
sources is reported and skipped.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

K1_COUNT = """    sm90::count_keys<kVec, kThreads, kForm>(
        cur, T, F, sp, [&](int, int b) { atomicAdd(mine + set * set_words + b, 1); });"""
K1_SHORTCUT = """#pragma unroll
    for (int j = 0; j < 4 * kVec; ++j) {
      const int e = sm90::key_at<kThreads>(j);
      const int b = e < T ? sm90::label_of<kForm>(cur[j], F, sp) : -1;
      if (__all_sync(ms::kFull, b == __shfl_sync(ms::kFull, b, 0))) {
        if (lane == 0 && b >= 0) atomicAdd(base + b, 32);
      } else if (b >= 0) {
        atomicAdd(mine + set * set_words + b, 1);
      }
    }"""
# K2's rank is sm90::warp_rank in the header (shared with K3 and K2s); an
# edit of it applies to the header copy that the K2 variant is built with
K2_PEERS = """      unsigned peers = __ballot_sync(ms::kFull, valid);
      for (int bit = 0; bit < nbits; ++bit) {
        const bool on = (b >> bit) & 1;
        const unsigned bal = __ballot_sync(ms::kFull, on);
        peers &= on ? bal : ~bal;
      }"""
K2_WALK = """#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r0 + r < r1) {
      const int i = ((r0 + r) << 5) + lane;
      const bool valid = i < len;
      const int b = valid ? label_of<kForm>(src[i], F, sp) : 0;
""" + K2_PEERS + """
      const int before = valid ? mine[b] : 0;        // the same value for all peers
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) mine[b] = before + __popc(peers);
      __syncwarp();
      meta[r] = ((before + __popc(peers & lanemask_lt)) << ms::kLabelBits) | b;
    }
  }"""
K2_WALK_AHEAD = """  unsigned peer_masks[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r0 + r < r1) {
      const int i = ((r0 + r) << 5) + lane;
      const bool valid = i < len;
      const int b = valid ? label_of<kForm>(src[i], F, sp) : 0;
""" + K2_PEERS + """
      meta[r] = b;
      peer_masks[r] = peers;
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r0 + r < r1) {
      const bool valid = ((r0 + r) << 5) + lane < len;
      const int b = meta[r];
      const unsigned peers = peer_masks[r];
      const int before = valid ? mine[b] : 0;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) mine[b] = before + __popc(peers);
      __syncwarp();
      meta[r] = ((before + __popc(peers & lanemask_lt)) << ms::kLabelBits) | b;
    }
  }"""
K2_WRITE_VEC = """      for (int v = tid; v < nv; v += kThreads) {
        ko[v] = reinterpret_cast<const uint4*>(ks)[v];
        if (has_vals) vo[v] = reinterpret_cast<const uint4*>(vs)[v];
"""
K2_TMA_WRITE = """      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
      __syncthreads();
      if (tid == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                     ::"l"(keys_r + base), "r"(static_cast<unsigned>(__cvta_generic_to_shared(ks))),
                     "r"(T * 4) : "memory");
        if (has_vals)
          asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
                       ::"l"(vals_r + base), "r"(static_cast<unsigned>(__cvta_generic_to_shared(vs))),
                       "r"(T * 4) : "memory");
        asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
      }
      for (int v = tid; v < nv; v += kThreads) {
"""
K2_STAGE_TOP = "    const int s = Y.stages == 2 ? (k & 1) : 0;\n"
K2_LOOP_END = """        pos_r[base + j] = j + delta[sb[j]];
      }
    }
  }
"""
# an exclusive block scan over kWarps warps, for blocks wider than the
# 8 warps of ms::block_exclusive_scan
WIDE_SCAN = """__device__ __forceinline__ int wide_exclusive_scan(int h, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = h;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(ms::kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? wsum[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(ms::kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) wsum[lane] = s;
  }
  __syncthreads();
  return (warp ? wsum[warp - 1] : 0) + x - h;
}"""
CUT_RANK = ("        const int dest = mine[b] + (meta[r] >> ms::kLabelBits);",
            "        const int dest = i;")
CUT_PERM = ("        perm[base + i] = dest + delta[b];\n", "")
CUT_WRITE = [("    if (vec) {\n      const int nv = T >> 2;", "    if (T < 0) {\n      const int nv = T >> 2;"),
             ("    } else {\n      for (int j = tid; j < T; j += kThreads) {",
              "    } else if (T < 0) {\n      for (int j = tid; j < T; j += kThreads) {")]
CUT_SCATTER = [("        ks[dest] = word[r];\n", ""),
               ("        if (r0 + r < r1 && i < T) vs[meta[r] & 0xffff] = word[r];", "")]

# name -> (source, [(old, new), ...], True when the result must stay right)
VARIANTS = {
    "K1": ("tile_histograms", [], True),
    "K1 warp-uniform shortcut": ("tile_histograms", [(K1_COUNT, K1_SHORTCUT)], True),
    "K1 next tile loaded while counting": ("tile_histograms", [
        ("  uint32_t cur[4 * kVec];\n", "  uint32_t cur[4 * kVec], nxt[4 * kVec];\n"),
        ("    int* const base = cnt + set * set_words;\n",
         "    if (tile + static_cast<int>(gridDim.x) < n_tiles)\n"
         "      load(nxt, tile + static_cast<int>(gridDim.x));\n"
         "    int* const base = cnt + set * set_words;\n"),
        ("    if (next < n_tiles) load(cur, next);\n",
         "    for (int j = 0; j < 4 * kVec; ++j) cur[j] = nxt[j];\n")], True),
    "K1 general label form": ("tile_histograms", [
        ("  if (F.form == sm90::kShiftMask)\n", "  if (false)\n"),
        ("  if (F.form == sm90::kClampedId)\n", "  if (false)\n")], True),
    "K1 three blocks an SM": ("tile_histograms", [("kVec <= 2 ? 4 : 2", "kVec <= 2 ? 3 : 2")], True),
    "K2": ("fused_postscan_reorder", [], True),
    "K2 one stage": ("fused_postscan_reorder", [(
        "  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);\n",
        "  cudaError_t err = sm90::pick_stages(kernel, kThreads, one, two, &Y.stages, &smem);\n"
        "  Y.stages = 1;\n  smem = one;\n")], True),
    "K2 16 warps, 64 registers": ("fused_postscan_reorder", [
        ("constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
        ("static_assert(kWarps == ms::kWarps, \"the block scan of multisplit_common.cuh\");",
         WIDE_SCAN),
        ("ms::block_exclusive_scan(total, wsum)", "wide_exclusive_scan(total, wsum)"),
        ("kR <= 16 ? 2 : 1", "kR <= 8 ? 2 : 1"),
        ("  if (T <= 16 * 32 * kWarps)", "  if (T <= 8 * 32 * kWarps)"),
        ("launch_kernel<kIds, 16>(", "launch_kernel<kIds, 8>("),
        ("launch_kernel<kIds, 32>(", "launch_kernel<kIds, 16>(")], True),
    "K2 rounds' labels ahead": ("fused_postscan_reorder", [(K2_WALK, K2_WALK_AHEAD)], True),
    "K2 match_any peers": ("fused_postscan_reorder", [
        (K2_PEERS, "      const unsigned peers = __match_any_sync(ms::kFull, valid ? b : -1);")],
        True),
    "K2 TMA bulk store of rows": ("fused_postscan_reorder", [
        (K2_WRITE_VEC, K2_TMA_WRITE),
        (K2_STAGE_TOP, K2_STAGE_TOP +
         '    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");\n'),
        (K2_LOOP_END, K2_LOOP_END +
         '  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n')], True),
    "K2 rank cut": ("fused_postscan_reorder", [CUT_RANK], False),
    "K2 perm store cut": ("fused_postscan_reorder", [CUT_PERM], False),
    "K2 write-out cut": ("fused_postscan_reorder", CUT_WRITE, False),
    "K2 staging, labels and write-out only": (
        "fused_postscan_reorder", [CUT_RANK, CUT_PERM] + CUT_SCATTER, False),
}


def cuda_ms(fn, reps=7, inner=3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def build_variants(build, variants=None, out_name="variants"):
    """Build each variant (VARIANTS unless given) into build/<out_name>/,
    all in parallel; returns name -> (source, C entry point). A variant is
    (source, edits, right) or (source, edits, right, csrc): the sources of
    another tree's ``csrc`` directory, a parent commit's say, in place of
    this one's."""
    out_dir = os.path.join(ROOT, "build", out_name)
    procs = {}
    for i, (name, (source, edits, _, *other)) in enumerate((variants or VARIANTS).items()):
        csrc = Path(other[0]) if other else build.CSRC
        # an edit applies to the source or, failing that, to the first local
        # header that holds its text; every header of the tree is copied
        # beside the variant's source, so each quoted include finds the
        # (edited) copy there first
        texts = {f"{source}.cu": (csrc / f"{source}.cu").read_text()}
        texts.update((h.name, h.read_text()) for h in sorted(csrc.glob("*.cuh")))
        missing = [old for old, _ in edits if not any(old in x for x in texts.values())]
        if missing:
            print(f"[variants] {name}: edit no longer applies ({missing[0][:60]!r}); skipped",
                  flush=True)
            continue
        for old, new in edits:
            where = next(f for f, x in texts.items() if old in x)
            texts[where] = texts[where].replace(old, new)
        var_dir = os.path.join(out_dir, f"v{i}")
        os.makedirs(var_dir, exist_ok=True)
        for fname, text in texts.items():
            with open(os.path.join(var_dir, fname), "w") as f:
                f.write(text)
        path = os.path.join(var_dir, f"{source}.cu")
        lib = os.path.join(var_dir, f"lib{source}.so")
        procs[name] = (source, lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (source, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build:\n{log[-4000:]}")
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)), key=int)
        print(f"[variants] {name}: ptxas {', '.join(regs)} registers, spill stores "
              f"{', '.join(spills) or '0'} B", flush=True)
        symbol, argtypes = build.ENTRY_POINTS[source]
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = (source, fn)
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1k2_variants: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch import ops
    from repro_torch.core.pipeline import stages as st
    from repro_torch.kernels import build
    from repro_torch.kernels import multisplit_tile as mst

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    fns = build_variants(build)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_tiles, t = (1 << 25) // 4096, 4096
    uniform = torch.randint(-2**31, 2**31, (n_tiles, t), dtype=torch.int32, device=dev,
                            generator=gen).view(torch.uint32)
    one = torch.full((n_tiles, t), 0x7F000000, dtype=torch.int32, device=dev).view(torch.uint32)
    vals = torch.randint(-2**31, 2**31, (n_tiles, t), dtype=torch.int32, device=dev, generator=gen)
    outs = [torch.empty((n_tiles, t), dtype=torch.int32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream().cuda_stream
    for what, keys, m in (("uniform", uniform, 2), ("uniform", uniform, 32),
                          ("uniform", uniform, 256), ("one bucket", one, 256)):
        spec = ops.DeltaSpec(m, 1 << 32)
        label = mst.label_args(spec, keys.dtype, dev)
        hist_want = mst.spec_tile_histograms_plain(keys, spec)
        g = st.global_scan(hist_want)
        want = mst.spec_fused_postscan_reorder_plain(keys, g, vals, spec)
        hist = torch.empty((n_tiles, m), dtype=torch.int32, device=dev)
        parts = []
        for name, (source, fn) in fns.items():
            if source == "tile_histograms":
                def call(fn=fn):
                    return fn(keys.data_ptr(), hist.data_ptr(), n_tiles, t, *label, stream)
                got = [hist]
                expect = [hist_want]
            else:
                def call(fn=fn):
                    return fn(keys.data_ptr(), g.data_ptr(), vals.data_ptr(),
                              *(o.data_ptr() for o in outs), n_tiles, t, *label, stream)
                got, expect = outs, want
            if call() != 0:
                raise RuntimeError(f"variant {name} failed to launch")
            torch.cuda.synchronize()
            right = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, expect))
            if VARIANTS[name][2] and not right:
                raise AssertionError(f"variant {name} differs from the plain version ({what}, m = {m})")
            ms = min(cuda_ms(call), cuda_ms(call))
            parts.append(f"{name} {ms:.4f}" + ("" if right else " (result wrong by design)"))
        print(f"[variants] {what} keys, m = {m}: " + "; ".join(parts) +
              f" ms [n = 2^25, tiles 8192 x 4096, key-value; {smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
