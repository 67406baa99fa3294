#!/usr/bin/env python3
"""Drive the PyTorch port of the multisplit system on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with a CUDA card (an H100
is the target). It needs nothing but the checkout: the Hopper kernels are
built from ``src/repro_torch/kernels/csrc`` into ``build/repro_torch/``.
Phases, one line or more each, every one of which must pass:

1. device  — ``nvidia-smi`` name and power limit, the torch device.
2. build   — nvcc of every kernel source, in parallel; seconds and ptxas use.
3. kernels — K1-K3 held bitwise against their plain PyTorch versions on the
   card: the main path's shapes (n = 2^25 keys in 8192 tiles of 4096), every
   spec kind, m in {2, 32, 256}, key-only and key-value, int32 / uint32 /
   float32 keys, NaN and inf keys, bases G above 2^24, ragged tiles. In
   every case the ids path equals the fused path: ``spec_bucket_ids`` (held
   against its plain version) writes the labels out, and K1, K3 and K2 on
   those ids equal K1, K3 and K2 with the labels in the kernel.
   The segmented kernels K1s-K3s likewise: the segmented main path's
   shapes, every spec kind with ragged segment strips that hold empty
   segments, bases above 2^24, and a strip of about 50,000 one- to
   eight-key segments (hundreds of runs a tile).
   The six ids kernels (K1-K3 and K1s-K3s on a materialised int32 ids
   strip) likewise: the main paths' shapes at m = 10 and 256, m in {1, 2,
   7, 32, 255, 256}, tails and tiles up to ``MAX_TILE``, labels outside
   [0, m) (both sides clamp them), bases above 2^24, empty and one- to
   eight-key segments.
   The packed kernels K1p-K3p in their four forms ({labels in the kernel |
   ids strip} x {flat | segmented}), each held bitwise against its plain
   version and against the onehot kernel of the same form: the main shapes
   (flat at m in {8, 32, 256} and two radix digits, S1, S3), m in {1, 2, 7,
   8, 255, 256}, tiles of 128 to ``MAX_TILE`` keys, subtiles 1, 32, 128 and
   255, one-bucket tiles that drive a counter lane to the 255 cap, labels
   outside [0, m), bases above 2^24, empty and one- to eight-key segments.
   The fused two-digit kernels K1f-K3f ({flat | segmented} x {keys |
   key-value} x {onehot | packed stage rank}), each held bitwise against its
   plain version: the fused paths' shapes (F1's 2^25 keys in 4096 tiles of
   8192 with both 16-bit pairs, F2's 14-bit pair and F3's 16 segments at
   2^22), tiles of 128 to 8192 keys and ragged ones, the pairs (16, 8), (14,
   7) and (6, 4), stage widths 1, 3, 4 and 8, int32 and uint32 keys,
   one-cell tiles, bases above 2^24, empty and one- to eight-key segments.
   B10, the standalone tile reorder of the unfused baseline, key-only and
   key-value, against its plain version: the main shape (8192 tiles of
   4096, m = 256, the destinations riding as the values too), m in {1, 2,
   7, 32, 255, 256}, tiles of 1 to ``MAX_TILE`` keys and ragged ones,
   int32 / uint32 / float32 keys with NaN and inf, ids outside [0, m).
4. main    — the port's entry points at the paper's size, n = 2^25 uniform
   random 32-bit keys on the cuda backend: ``ops.multisplit`` for
   ``DeltaSpec(m, 2^32)`` (equal widths over the whole key range, so the
   buckets are uniform) for m in {2, 32, 256}, methods bms and dms,
   key-only and key-value; ``ops.histogram``; ``ops.radix_sort`` at r = 8 (4 passes), key-only and
   key-value. Every result is held bitwise against a stable ``torch.sort``
   of the labels (``rb_sort_multisplit``), or of the keys for the sort.
5. segmented — the segmented entry points, held bitwise against a stable
   ``torch.sort`` of the int64 combined key: S1 ``ops.segmented_multisplit``
   at n = 2^25 over 64 ragged segments (``DeltaSpec(32, 2^32)``, m_eff =
   2048), bms and dms, key-only and key-value, positions_only and
   counts_only; S2 ``ops.segmented_radix_sort`` at n = 2^25 over 16
   segments, r = 8; S3 the serving routing launch, 2^20 expert ids over 256
   requests (``IdentitySpec(64)``, dms, positions_only).
   Callable — a programmer's bucket functions (``ops.from_fn``) at n =
   2^25 through the ids kernels, held against the same oracles: the
   delta-stepping bucket of ``examples/sssp.py`` (m = 10, int32 distances,
   vertex-id values, wms and bms); a multiplicative hash at m in {2, 32,
   256} (bms and dms, key-only and key-value, counts_only, positions_only);
   int16 and int64 keys through ``histogram`` and positions_only; the
   ``even_bucket_ids`` / ``device_histogram`` doors; and the hash at S1's
   shape through ``ops.segmented_multisplit``.
   Packed — the same entry points with ``family="packed"`` at n = 2^25, one
   path a form: flat (key-value bms, dms and ``histogram`` at m in {8, 32,
   256}; ``radix_sort`` r = 8), segmented (S1 key-value bms, S2, S3), flat
   callable (the hash at m = 32) and segmented callable (the hash at S1's
   shape). Every result is held bitwise against the same call on the
   default (onehot) family and against the stable-sort oracle.
   Fused — ``fuse_digits=True``: F1 ``ops.radix_sort`` r = 8 at n = 2^25
   (two 16-bit pairs; key-value bms, key-only dms, ``family="packed"``), F2
   r = 7 at 2^22 (two 14-bit pairs and a 4-bit single pass), F3
   ``ops.segmented_radix_sort`` over 16 ragged segments at 2^22 (S2's
   shape, cut from 2^25 because a pair's H over 16 segments would be 16
   GiB). Each is held bitwise against the unfused sort and a stable
   ``torch.sort``, with H's size and the call's peak device memory.
   Batched — ``(b, n)`` rows, one launch a stage for the whole batch: B1
   the keys as 8 rows of 2^22 (an 8-shard split's local step) at
   ``DeltaSpec(m, 2^32)``, m in {32, 256}, through ``torch.vmap`` of
   ``ops.multisplit_key_value``, ``ops.multisplit`` and ``ops.histogram`` and
   through ``core.batched_multisplit`` (bms and dms, key-only and
   key-value, counts_only, positions_only); B2 256 rows of 2^17 + 37 keys
   at m = 32, every row with pads; B3 the batched ``radix_sort`` r = 8,
   unfused and ``fuse_digits=True``; one packed and one callable batch.
   Every row is held bitwise against the stable-sort oracle, and B1's
   against the flat op on that row.
   Unfused — ``multisplit_unfused`` at n = 2^25, m = 256 (kv bms, key-only
   bms, kv dms: K1 and K3 on the ids, B10 for passes 2 and 3) against the
   fused plan and the oracle; ``radix_sort_per_pass`` flat and batched
   against ``radix_sort``.
6. launches — every kernel's launch count from its own path's run alone
   (flat, segmented, flat callable, segmented callable, and the four
   packed paths, which launch K1p-K3p and no onehot kernel; each fused
   call, which launches K1f with K2f or K3f twice, F2 also K1 and K2 once;
   each batched call one K1 and one K2 or K3 for all rows, a batched sort
   one of each a sweep; each unfused call K1 and K3 on the ids once and B10
   twice, once or never); every kernel is launched on one of them.
7. times   — per kernel: ms, the plain version's ms, the bound (bytes moved
   over 3.35 TB/s, the H100 SXM data-sheet rate) and one PyTorch call as a
   yardstick; the onehot and packed kernels side by side on the same
   inputs (flat at m in {8, 32, 256}, S1, both label sources); end to end:
   ms and Gkeys/s, with the same labels as ``DeltaSpec`` and as a
   callable, and every packed path's call beside its onehot twin; stage
   splits; peak device memory. The fused kernels at F1's shapes, K2f and K3f
   at stage widths 4 and 8 in both families, F1-F3 fused against unfused end
   to end in turns, F1 fused at sub_bits 4 and 8 and at tile 4096, and the
   stages of one fused pair (prescan, the scan over H, postscan, scatter)
   beside those of one single-digit pass. The batched calls against the
   loop of flat calls and ``torch.vmap`` against ``batched_multisplit``,
   ``multisplit_unfused`` against the fused plan with its stages,
   ``radix_sort_per_pass`` against ``radix_sort``.

The last lines are the ``nvidia-smi`` line, one JSON line of the kernels
and ``{"ok": true, "device": {...}}``. The script exits non-zero, printing
no result, when no CUDA device is present or a phase fails.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_MAIN = 1 << 25
# F2 and F3 (the fused r = 7 sort and the fused segmented sort) run at 2^22
# keys: F3's H is (L, s·m²) int32, 2 GiB at s = 16, m² = 65536 in tiles of
# 8192 keys, and would be 16 GiB at 2^25 before the scan's temporaries
N_FUSED_SMALL = 1 << 22
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
SEED = 0
# K1-K3 at n = 2^25, m = 256 on an H100 80GB HBM3 at 700 W, as this script
# measured them when they were added (PERF.md's kernel table)
FLAT_MS_BEFORE = {"spec_tile_histograms": 0.3485, "spec_fused_postscan_reorder": 0.7949,
                  "spec_tile_positions": 0.3852}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch import ops
        from repro_torch.core.pipeline import stages as st
        from repro_torch.core.sort import rb_sort_multisplit
        from repro_torch.kernels import build
        from repro_torch.kernels import multisplit_tile as mst
    except ImportError as err:
        print(f"chip_smoke: cannot import the port from {ROOT}/src: {err}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    # ---- 1. device
    smi = smi_line()
    log("device", f"nvidia-smi: {smi}")
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"{torch.cuda.get_device_name(0)} sm_{''.join(map(str, torch.cuda.get_device_capability(0)))} "
                  f"count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    paths = build.build_all()
    log("build", f"{len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
                 f"(nvcc seconds each: { {k: round(v, 1) for k, v in build.BUILD_SECONDS.items()} })")
    for name, text in build.PTXAS_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line:
                log("build", f"{name}: {line.strip()}")

    # ---- helpers
    def rand_i32(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=gen)

    def bits(x):
        return x.view(torch.int32)

    def max_err(a, b) -> int:
        """0 when bitwise equal; else the largest |difference| of the int32
        bit patterns."""
        if a is None or b is None:
            assert a is None and b is None, "one side is missing an output"
            return 0
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if torch.equal(bits(a), bits(b)):
            return 0
        return int((bits(a).long() - bits(b).long()).abs().max().item())

    def main_spec(m):
        """The main path's buckets: equal widths over all 2^32 keys."""
        return ops.DeltaSpec(m, 1 << 32)

    # ---- 3. kernels against their plain versions
    errs = {fn.__name__: 0 for fn in mst.KERNELS}
    n_checks = n_ids_paths = 0

    def check_case(what, keys_tiled, spec, values_tiled, g_offset=0):
        nonlocal n_checks
        h_plain = mst.spec_tile_histograms_plain(keys_tiled, spec)
        h = mst.spec_tile_histograms(keys_tiled, spec)
        e1 = max_err(h, h_plain)
        g = st.global_scan(h_plain) + g_offset
        p = mst.spec_tile_positions(keys_tiled, g, spec)
        e3 = max_err(p, mst.spec_tile_positions_plain(keys_tiled, g, spec))
        e2 = 0
        for vals in (None, values_tiled):
            got = mst.spec_fused_postscan_reorder(keys_tiled, g, vals, spec)
            want = mst.spec_fused_postscan_reorder_plain(keys_tiled, g, vals, spec)
            e2 = max(e2, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        errs["spec_tile_histograms"] = max(errs["spec_tile_histograms"], e1)
        errs["spec_tile_positions"] = max(errs["spec_tile_positions"], e3)
        errs["spec_fused_postscan_reorder"] = max(errs["spec_fused_postscan_reorder"], e2)
        n_checks += 1
        if e1 or e2 or e3:
            raise AssertionError(f"kernel != plain for {what}: K1 {e1}, K2 {e2}, K3 {e3}")
        check_ids_path(what, keys_tiled, spec, values_tiled, g)

    def check_ids_path(what, keys_tiled, spec, values_tiled, g):
        """The labels written out by spec_bucket_ids (held against its plain
        version) through the ids kernels equal the fused kernels' result."""
        nonlocal n_ids_paths
        m = spec.num_buckets
        ids = mst.spec_bucket_ids(keys_tiled, spec)
        e0 = max_err(ids, mst.spec_bucket_ids_plain(keys_tiled, spec))
        errs["spec_bucket_ids"] = max(errs["spec_bucket_ids"], e0)
        d = [max_err(mst.tile_histograms(ids, m), mst.spec_tile_histograms(keys_tiled, spec)),
             max_err(mst.tile_positions(ids, g, m), mst.spec_tile_positions(keys_tiled, g, spec))]
        got = mst.fused_postscan_reorder(ids, g, keys_tiled, values_tiled, m)
        want = mst.spec_fused_postscan_reorder(keys_tiled, g, values_tiled, spec)
        d.append(max(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_ids_paths += 1
        if e0 or any(d):
            raise AssertionError(f"ids path != fused path for {what}: spec_bucket_ids {e0} "
                                 f"(vs plain), K1/K3/K2 on ids vs fused {d}")

    t0 = time.perf_counter()
    # the main path's shapes: 8192 tiles of 4096 keys, G up to 2^25
    l_main, t_main = N_MAIN // 4096, 4096
    keys_main = rand_i32((l_main, t_main)).view(torch.uint32)
    vals_main = rand_i32((l_main, t_main))
    for spec in (main_spec(2), main_spec(32), main_spec(256), ops.DeltaSpec(256),
                 ops.BitfieldSpec(0, 8), ops.BitfieldSpec(24, 8)):
        check_case(f"main shape {spec.name}", keys_main, spec, vals_main)
    log("kernels", f"main-path shapes ({l_main} x {t_main}): K1-K3 bitwise equal to plain "
                   f"({time.perf_counter() - t0:.1f} s)")

    def keys_for(dtype, shape, lo, hi):
        if dtype == torch.float32:
            return (torch.rand(shape, device=dev, generator=gen) * (hi - lo) + lo).float()
        if dtype == torch.int32:
            return torch.randint(int(lo), int(hi), shape, dtype=torch.int64, device=dev,
                                 generator=gen).to(torch.int32)
        return torch.randint(int(lo), int(hi), shape, dtype=torch.int64, device=dev,
                             generator=gen).to(torch.int32).view(torch.uint32)

    np_rng = np.random.default_rng(SEED)
    spans = {torch.int32: (-2**31, 2**31), torch.uint32: (0, 2**32), torch.float32: (-1e9, 5e9)}
    for shape in ((64, 4096), (3, 1000), (5, 100)):
        for dtype in (torch.int32, torch.uint32, torch.float32):
            lo, hi = spans[dtype]
            for m in (2, 32, 256):
                vals = rand_i32(shape)
                k_full = keys_for(dtype, shape, lo, hi)
                specs = [ops.DeltaSpec(m), ops.EvenSpec(-3.7, 11.3, m)]
                if dtype != torch.float32:
                    specs.append(ops.BitfieldSpec({2: 31, 32: 7, 256: 24}[m], m.bit_length() - 1))
                if dtype == torch.float32:
                    sp = np_rng.uniform(lo, hi, m - 1).astype(np.float32).tolist()
                else:
                    sp = np_rng.integers(lo, hi, m - 1).tolist()
                specs.append(ops.RangeSpec(tuple(sp)))
                if dtype == torch.int32:
                    specs.append(ops.RangeSpec(tuple(s + 0.5 for s in sp)))
                for spec in specs:
                    keys = k_full
                    if isinstance(spec, ops.EvenSpec):
                        keys = keys_for(dtype, shape, -5, 14)
                        if dtype == torch.float32:
                            flat = keys.view(-1)
                            edges = torch.tensor([float("nan"), float("inf"), -float("inf"), -3.7, 11.3],
                                                 device=dev)
                            flat[: edges.numel()] = edges
                    check_case(f"{spec.name} {dtype} {shape}", keys, spec, vals)
                    check_case(f"{spec.name} {dtype} {shape} G+2^24", keys, spec, vals,
                               g_offset=(1 << 24) + 1)
                ident = keys_for(dtype, shape, 0, m)
                check_case(f"identity{m} {dtype} {shape}", ident, ops.IdentitySpec(m), vals)
    fvals = torch.rand((64, 4096), device=dev, generator=gen)
    check_case("float32 values", keys_for(torch.uint32, (64, 4096), 0, 2**32), ops.DeltaSpec(32), fvals)
    log("kernels", f"{n_checks} cases over every spec kind, m in (2, 32, 256), int32/uint32/"
                   f"float32 keys, key-only and key-value, G above 2^24: all bitwise equal "
                   f"({time.perf_counter() - t0:.1f} s)")
    log("kernels", f"{n_ids_paths} of them through the ids path as well: spec_bucket_ids equal "
                   f"to its plain version, then tile_histograms / tile_positions / "
                   f"fused_postscan_reorder on those ids equal to K1 / K3 / K2")

    # ---- 3b. the segmented kernels K1s-K3s against their plain versions
    def ragged_starts(n, s, rng, empty=(), fixed=None):
        """s start offsets over n: the segments in ``empty`` hold no key,
        those in ``fixed`` the given number, the others random shares."""
        fixed = dict(fixed or {})
        lens = np.zeros(s, np.int64)
        free = [i for i in range(s) if i not in empty and i not in fixed]
        for i, k in fixed.items():
            lens[i] = k
        w = rng.random(len(free)) + 0.05
        share = np.floor(w / w.sum() * (n - lens.sum())).astype(np.int64)
        share[-1] += n - lens.sum() - share.sum()
        lens[free] = share
        assert lens.min() >= 0 and lens.sum() == n
        return (np.cumsum(lens) - lens).astype(np.int32)

    def seg_strip(starts, shape):
        return st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), shape[0] * shape[1]).view(shape)

    def check_seg_case(what, keys_tiled, seg_tiled, s, spec, values_tiled, g_offset=0):
        nonlocal n_checks
        h_plain = mst.seg_spec_tile_histograms_plain(keys_tiled, seg_tiled, spec, s)
        e1 = max_err(mst.seg_spec_tile_histograms(keys_tiled, seg_tiled, spec, s), h_plain)
        g = st.global_scan(h_plain) + g_offset
        del h_plain
        e3 = max_err(mst.seg_spec_tile_positions(keys_tiled, seg_tiled, g, spec, s),
                     mst.seg_spec_tile_positions_plain(keys_tiled, seg_tiled, g, spec, s))
        e2 = 0
        for vals in (None, values_tiled):
            got = mst.seg_spec_fused_postscan_reorder(keys_tiled, seg_tiled, g, vals, spec, s)
            want = mst.seg_spec_fused_postscan_reorder_plain(keys_tiled, seg_tiled, g, vals, spec, s)
            e2 = max(e2, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        errs["seg_spec_tile_histograms"] = max(errs["seg_spec_tile_histograms"], e1)
        errs["seg_spec_tile_positions"] = max(errs["seg_spec_tile_positions"], e3)
        errs["seg_spec_fused_postscan_reorder"] = max(errs["seg_spec_fused_postscan_reorder"], e2)
        n_checks += 1
        if e1 or e2 or e3:
            raise AssertionError(f"segmented kernel != plain for {what}: K1s {e1}, K2s {e2}, K3s {e3}")

    t0, n0 = time.perf_counter(), n_checks
    # (a) the segmented main path's shapes: S1 (m = 32, s = 64), S2 (radix
    # digits, s = 16) and S3 (IdentitySpec(64), s = 256 over 2^20 keys)
    s1_starts = ragged_starts(N_MAIN, 64, np_rng, empty=(0, 31, 63), fixed={7: 1, 40: 1000})
    s2_starts = ragged_starts(N_MAIN, 16, np_rng, empty=(5,))
    n3 = 1 << 20
    s3_starts = ragged_starts(n3, 256, np_rng, empty=tuple(range(0, 256, 37)),
                              fixed={3: 1, 100: 17})
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    check_seg_case("S1 shape", keys_main, seg_main, 64, main_spec(32), vals_main)
    seg2_main = seg_strip(s2_starts, (l_main, t_main))
    for shift in (0, 24):
        check_seg_case(f"S2 shape digit {shift}", keys_main, seg2_main, 16,
                       ops.BitfieldSpec(shift, 8), vals_main)
    del seg2_main
    ids3 = torch.randint(0, 64, (n3 // 4096, 4096), dtype=torch.int32, device=dev, generator=gen)
    check_seg_case("S3 shape", ids3, seg_strip(s3_starts, (n3 // 4096, 4096)), 256,
                   ops.IdentitySpec(64), None)
    # (b) every spec kind, m in (2, 32, 256), every key type, ragged strips
    for shape, s in (((64, 4096), 37), ((3, 1000), 5), ((5, 100), 9)):
        for dtype in (torch.int32, torch.uint32, torch.float32):
            lo, hi = spans[dtype]
            for m in (2, 32, 256):
                starts = ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1),
                                       fixed={2: 1})
                seg = seg_strip(starts, shape)
                vals = rand_i32(shape)
                specs = [(ops.DeltaSpec(m), keys_for(dtype, shape, lo, hi)),
                         (ops.EvenSpec(-3.7, 11.3, m), keys_for(dtype, shape, -5, 14)),
                         (ops.IdentitySpec(m), keys_for(dtype, shape, 0, m))]
                if dtype != torch.float32:
                    specs.append((ops.BitfieldSpec({2: 31, 32: 7, 256: 24}[m], m.bit_length() - 1),
                                  keys_for(dtype, shape, lo, hi)))
                sp = (np_rng.uniform(lo, hi, m - 1).astype(np.float32).tolist()
                      if dtype == torch.float32 else np_rng.integers(lo, hi, m - 1).tolist())
                specs.append((ops.RangeSpec(tuple(sp)), keys_for(dtype, shape, lo, hi)))
                for spec, keys in specs:
                    check_seg_case(f"{spec.name} {dtype} {shape} s={s}", keys, seg, s, spec, vals)
                # (c) bases past 2^24
                check_seg_case(f"{specs[0][0].name} {dtype} {shape} G+2^24", specs[0][1], seg, s,
                               specs[0][0], vals, g_offset=(1 << 24) + 1)
    # (d) one- to eight-key segments: hundreds of runs in every tile
    for shape, m in (((64, 4096), 2), ((16, 4096), 256)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = (np.cumsum(lens) - lens)
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        keys = keys_for(torch.uint32, shape, 0, 2**32)
        check_seg_case(f"{starts.size} tiny segments m={m}", keys, seg_strip(starts, shape),
                       starts.size, ops.DeltaSpec(m, 1 << 32), rand_i32(shape))
        log("kernels", f"{starts.size} segments of 1-8 keys over {shape}, m = {m}: K1s-K3s "
                       f"bitwise equal")
    del ids3, seg_main
    log("kernels", f"{n_checks - n0} segmented cases (main shapes of S1-S3, every spec kind, "
                   f"m in (2, 32, 256), int32/uint32/float32 keys, empty segments, G above "
                   f"2^24, tiny segments): K1s-K3s all bitwise equal "
                   f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3c. the ids kernels (materialised labels) against their plain versions
    def check_ids_case(what, ids, keys_tiled, values_tiled, m, seg=None, s=1, g_offset=0):
        """The six ids wrappers on one (L, T) ids strip (labels outside
        [0, m) included: both clamp), flat and, with a strip, segmented."""
        nonlocal n_checks
        e = {}
        h_plain = mst.tile_histograms_plain(ids, m)
        e["tile_histograms"] = max_err(mst.tile_histograms(ids, m), h_plain)
        g = st.global_scan(h_plain) + g_offset
        del h_plain
        e["tile_positions"] = max_err(mst.tile_positions(ids, g, m),
                                      mst.tile_positions_plain(ids, g, m))
        e["fused_postscan_reorder"] = 0
        for vals in (None, values_tiled):
            got = mst.fused_postscan_reorder(ids, g, keys_tiled, vals, m)
            want = mst.fused_postscan_reorder_plain(ids, g, keys_tiled, vals, m)
            e["fused_postscan_reorder"] = max(e["fused_postscan_reorder"],
                                              *(max_err(a, b) for a, b in zip(got, want)))
        del g
        if seg is not None:
            h_plain = mst.seg_tile_histograms_plain(ids, seg, m, s)
            e["seg_tile_histograms"] = max_err(mst.seg_tile_histograms(ids, seg, m, s), h_plain)
            g = st.global_scan(h_plain) + g_offset
            del h_plain
            e["seg_tile_positions"] = max_err(mst.seg_tile_positions(ids, seg, g, m, s),
                                              mst.seg_tile_positions_plain(ids, seg, g, m, s))
            e["seg_fused_postscan_reorder"] = 0
            for vals in (None, values_tiled):
                got = mst.seg_fused_postscan_reorder(ids, seg, g, keys_tiled, vals, m, s)
                want = mst.seg_fused_postscan_reorder_plain(ids, seg, g, keys_tiled, vals, m, s)
                e["seg_fused_postscan_reorder"] = max(e["seg_fused_postscan_reorder"],
                                                      *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        if any(e.values()):
            raise AssertionError(f"ids kernel != plain for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    # the main paths' shapes: 8192 tiles of 4096 ids, labels of m = 10 (the
    # delta-stepping buckets) and 256, segmented as S1, G up to 2^25
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    for m in (10, 256):
        ids = torch.randint(0, m, (l_main, t_main), dtype=torch.int32, device=dev, generator=gen)
        check_ids_case(f"main shape m={m}", ids, keys_main, vals_main, m, seg_main, 64)
    del ids, seg_main
    # every m, tails and tiles up to MAX_TILE, labels outside [0, m) (they
    # clamp), bases above 2^24, ragged strips with empty segments
    for shape, s in (((64, 4096), 37), ((3, mst.MAX_TILE), 5), ((5, 100), 9), ((7, 33), 3),
                     ((2, 1), 2)):
        for i, m in enumerate((1, 2, 7, 32, 255, 256)):
            starts = ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1))
            ids = torch.randint(-3, m + 3, shape, dtype=torch.int32, device=dev, generator=gen)
            dtype = (torch.int32, torch.uint32, torch.float32)[i % 3]     # the moved keys' type
            keys = keys_for(dtype, shape, *spans[dtype])
            check_ids_case(f"ids m={m} {dtype} {shape} s={s}", ids, keys, rand_i32(shape), m,
                           seg_strip(starts, shape), s, g_offset=(1 << 24) + 1 if i % 2 else 0)
    # one- to eight-key segments: hundreds of runs in every tile
    for shape, m in (((64, 4096), 2), ((16, 4096), 256)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        ids = torch.randint(-1, m + 1, shape, dtype=torch.int32, device=dev, generator=gen)
        check_ids_case(f"ids {starts.size} tiny segments m={m}", ids,
                       keys_for(torch.uint32, shape, 0, 2**32), rand_i32(shape), m,
                       seg_strip(starts, shape), starts.size)
    del ids
    log("kernels", f"{n_checks - n0} ids cases (the main shapes at m = 10 and 256, m in (1, 2, 7, "
                   f"32, 255, 256), tiles up to {mst.MAX_TILE}, labels outside [0, m), G above "
                   f"2^24, empty and tiny segments): the six ids kernels all bitwise equal to "
                   f"their plain versions ({time.perf_counter() - t0:.1f} s)")

    # ---- 3d. the packed kernels K1p-K3p against their plain versions and the
    # onehot kernels, in their four forms ({spec labels | ids strip} x {flat |
    # segmented})
    def onehot_stages(tiled, keys_tiled, spec, m, seg, s):
        """The onehot wrappers of the same form: (histograms, positions(g),
        reorder(g, vals))."""
        if spec is not None and seg is None:
            return (lambda: mst.spec_tile_histograms(tiled, spec),
                    lambda g: mst.spec_tile_positions(tiled, g, spec),
                    lambda g, v: mst.spec_fused_postscan_reorder(tiled, g, v, spec))
        if spec is not None:
            return (lambda: mst.seg_spec_tile_histograms(tiled, seg, spec, s),
                    lambda g: mst.seg_spec_tile_positions(tiled, seg, g, spec, s),
                    lambda g, v: mst.seg_spec_fused_postscan_reorder(tiled, seg, g, v, spec, s))
        if seg is None:
            return (lambda: mst.tile_histograms(tiled, m),
                    lambda g: mst.tile_positions(tiled, g, m),
                    lambda g, v: mst.fused_postscan_reorder(tiled, g, keys_tiled, v, m))
        return (lambda: mst.seg_tile_histograms(tiled, seg, m, s),
                lambda g: mst.seg_tile_positions(tiled, seg, g, m, s),
                lambda g, v: mst.seg_fused_postscan_reorder(tiled, seg, g, keys_tiled, v, m, s))

    packed_forms = set()

    def check_packed_case(what, tiled, values_tiled, spec=None, m=None, keys_tiled=None, seg=None,
                          s=1, g_offset=0, subtile=None):
        """K1p, K3p and K2p (key-only and key-value) on one form, each held
        bitwise against its plain version and against the onehot kernel of
        the same form."""
        nonlocal n_checks
        kw = dict(seg_tiled=seg, num_segments=s, subtile=subtile)
        kw.update(spec=spec) if spec is not None else kw.update(num_buckets=m)
        hist, positions, reorder = onehot_stages(tiled, keys_tiled, spec, m, seg, s)
        e = {}
        h_plain = mst.packed_tile_histograms_plain(tiled, **kw)
        h = mst.packed_tile_histograms(tiled, **kw)
        e["packed_tile_histograms"] = max(max_err(h, h_plain), max_err(h, hist()))
        g = st.global_scan(h_plain) + g_offset
        del h, h_plain
        p = mst.packed_tile_positions(tiled, g, **kw)
        e["packed_tile_positions"] = max(max_err(p, mst.packed_tile_positions_plain(tiled, g, **kw)),
                                         max_err(p, positions(g)))
        del p
        e["packed_fused_postscan_reorder"] = 0
        for vals in (None, values_tiled):
            got = mst.packed_fused_postscan_reorder(tiled, g, keys_tiled, vals, **kw)
            for want in (mst.packed_fused_postscan_reorder_plain(tiled, g, keys_tiled, vals, **kw),
                         reorder(g, vals)):
                e["packed_fused_postscan_reorder"] = max(
                    e["packed_fused_postscan_reorder"], *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        packed_forms.add(("spec" if spec is not None else "ids", "flat" if seg is None else "segmented"))
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        if any(e.values()):
            raise AssertionError(f"packed kernel != plain or onehot for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    # (a) the main shapes: 8192 tiles of 4096 keys at m = 8, 32, 256 and the
    # radix digits, flat; S1 (s = 64, m = 32) and S3 (s = 256, m = 64); the
    # ids forms beside them; G up to 2^25
    for spec in (main_spec(8), main_spec(32), main_spec(256), ops.BitfieldSpec(0, 8),
                 ops.BitfieldSpec(24, 8)):
        check_packed_case(f"main shape {spec.name}", keys_main, vals_main, spec=spec)
    ids = torch.randint(0, 256, (l_main, t_main), dtype=torch.int32, device=dev, generator=gen)
    check_packed_case("main shape ids m=256", ids, vals_main, m=256, keys_tiled=keys_main)
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    check_packed_case("S1 shape", keys_main, vals_main, spec=main_spec(32), seg=seg_main, s=64)
    ids = torch.randint(0, 32, (l_main, t_main), dtype=torch.int32, device=dev, generator=gen)
    check_packed_case("S1 shape ids", ids, vals_main, m=32, keys_tiled=keys_main, seg=seg_main, s=64)
    del ids, seg_main
    shape3 = (n3 // 4096, 4096)
    ids3 = torch.randint(0, 64, shape3, dtype=torch.int32, device=dev, generator=gen)
    seg3 = seg_strip(s3_starts, shape3)
    check_packed_case("S3 shape", ids3, None, spec=ops.IdentitySpec(64), seg=seg3, s=256)
    check_packed_case("S3 shape ids", ids3, rand_i32(shape3), m=64, keys_tiled=rand_i32(shape3),
                      seg=seg3, s=256)
    del ids3, seg3
    log("kernels", f"packed, main shapes (flat {l_main} x {t_main} at m = 8, 32, 256 and two radix "
                   f"digits; S1; S3; spec and ids forms): K1p-K3p bitwise equal to their plain "
                   f"versions and to the onehot kernels ({time.perf_counter() - t0:.1f} s)")
    # (b) m in (1, 2, 7, 8, 255, 256), tiles of 128 to 8192 keys, every
    # subtile the kernels take on one shape, labels outside [0, m) (both
    # families clamp them), bases above 2^24, ragged strips with empty
    # segments; every form
    for shape, s in (((16, 128), 5), ((3, 1000), 9), ((8, 4096), 37), ((3, mst.MAX_TILE), 5),
                     ((7, 33), 3)):
        for i, m in enumerate((1, 2, 7, 8, 255, 256)):
            starts = ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1))
            seg = seg_strip(starts, shape)
            keys = keys_for(torch.uint32, shape, 0, 2**32)
            spec = main_spec(m) if m > 1 else ops.DeltaSpec(1)
            ids = torch.randint(-3, m + 3, shape, dtype=torch.int32, device=dev, generator=gen)
            vals = rand_i32(shape)
            off = (1 << 24) + 1 if i % 2 else 0
            for sub in ((None, 255, 32, 1) if shape == (3, 1000) else (None,)):
                tag = f"m={m} {shape} s={s} subtile={sub}"
                check_packed_case(f"spec {tag}", keys, vals, spec=spec, g_offset=off, subtile=sub)
                check_packed_case(f"spec seg {tag}", keys, vals, spec=spec, seg=seg, s=s,
                                  g_offset=off, subtile=sub)
                check_packed_case(f"ids {tag}", ids, vals, m=m, keys_tiled=keys, g_offset=off,
                                  subtile=sub)
                check_packed_case(f"ids seg {tag}", ids, vals, m=m, keys_tiled=keys, seg=seg, s=s,
                                  g_offset=off, subtile=sub)
    # (c) adversarial tiles: every key in one bucket, so a counter lane
    # reaches exactly the subtile cap of 255 keys (flat, and long runs)
    for sub in (255, None):
        keys = torch.full((8, 4096), 7, dtype=torch.int32, device=dev)
        seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), (8, 4096))
        check_packed_case(f"one bucket subtile={sub}", keys, rand_i32((8, 4096)),
                          spec=ops.IdentitySpec(8), subtile=sub, g_offset=(1 << 24) + 1)
        check_packed_case(f"one bucket seg subtile={sub}", keys, rand_i32((8, 4096)),
                          spec=ops.IdentitySpec(8), seg=seg, s=4, subtile=sub)
        check_packed_case(f"one bucket ids subtile={sub}", keys, rand_i32((8, 4096)), m=256,
                          keys_tiled=rand_i32((8, 4096)), subtile=sub)
    # (d) one- to eight-key segments: hundreds of runs in every tile
    for shape, m in (((64, 4096), 2), ((16, 4096), 256)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        seg = seg_strip(starts, shape)
        keys = keys_for(torch.uint32, shape, 0, 2**32)
        check_packed_case(f"{starts.size} tiny segments m={m}", keys, rand_i32(shape),
                          spec=main_spec(m), seg=seg, s=starts.size)
        ids = torch.randint(-1, m + 1, shape, dtype=torch.int32, device=dev, generator=gen)
        check_packed_case(f"ids {starts.size} tiny segments m={m}", ids, rand_i32(shape), m=m,
                          keys_tiled=keys, seg=seg, s=starts.size)
    del ids, seg, keys, vals
    if len(packed_forms) != 4:
        raise AssertionError(f"packed forms checked: {sorted(packed_forms)}")
    log("kernels", f"{n_checks - n0} packed cases (the main shapes, m in (1, 2, 7, 8, 255, 256), "
                   f"tiles of 128 to {mst.MAX_TILE}, subtiles 1, 32, 128 and 255, one-bucket tiles "
                   f"at the 255 cap, labels outside [0, m), G above 2^24, empty and tiny segments; "
                   f"all four forms): K1p-K3p all bitwise equal to their plain versions and to the "
                   f"onehot kernels ({time.perf_counter() - t0:.1f} s)")

    # ---- 3e. the fused two-digit kernels K1f-K3f against their plain versions:
    # {flat | segmented} x {keys | key-value} x {onehot | packed stage rank} x
    # stage widths
    fused_forms = set()

    def check_fused2_case(what, keys_tiled, values_tiled, spec, split, seg=None, s=1, g_offset=0,
                          families=("onehot", "packed"), subs=(1, 3, 4, 8)):
        """K1f, then K3f and K2f (key-only and key-value) in each family and
        stage width, each held bitwise against its plain version."""
        nonlocal n_checks
        kw = dict(spec=spec, num_segments=s)
        e = {}
        h_plain = mst.fused2_tile_histograms_plain(keys_tiled, seg, **kw)
        e["fused2_tile_histograms"] = max_err(mst.fused2_tile_histograms(keys_tiled, seg, **kw),
                                              h_plain)
        g = st.global_scan(h_plain) + g_offset
        del h_plain
        e["fused2_tile_positions"] = e["fused2_fused_postscan_reorder"] = 0
        for fam in families:
            for sub in subs:
                kw2 = dict(kw, split=split, family=fam, sub_bits=sub)
                e["fused2_tile_positions"] = max(
                    e["fused2_tile_positions"],
                    max_err(mst.fused2_tile_positions(keys_tiled, g, seg, **kw2),
                            mst.fused2_tile_positions_plain(keys_tiled, g, seg, **kw2)))
                for vals in (None, values_tiled):
                    got = mst.fused2_fused_postscan_reorder(keys_tiled, g, vals, seg, **kw2)
                    want = mst.fused2_fused_postscan_reorder_plain(keys_tiled, g, vals, seg, **kw2)
                    e["fused2_fused_postscan_reorder"] = max(
                        e["fused2_fused_postscan_reorder"], *(max_err(a, b) for a, b in zip(got, want)))
                fused_forms.add(("flat" if seg is None else "segmented", fam))
        torch.cuda.synchronize()
        n_checks += 1
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        if any(e.values()):
            raise AssertionError(f"fused2 kernel != plain for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    t_fused = mst.MAX_TILE                               # the cuda backend's fused-pair tile
    # (a) the fused paths' shapes: F1 (2^25 keys in 4096 tiles of 8192, both
    # pairs of r = 8), F2 (2^22 keys, the 14-bit pair of r = 7), F3 (2^22 keys
    # over 16 ragged segments, the 16-bit pair); G up to 2^25
    kt_f1, vt_f1 = keys_main.view(-1, t_fused), vals_main.view(-1, t_fused)
    check_fused2_case("F1 shape pair 0", kt_f1, vt_f1, ops.BitfieldSpec(0, 16), 8, subs=(None,))
    check_fused2_case("F1 shape pair 1", kt_f1, vt_f1, ops.BitfieldSpec(16, 16), 8,
                      families=("onehot",), subs=(4,))
    shape_small = (N_FUSED_SMALL // t_fused, t_fused)
    kt_small = keys_main.view(-1)[:N_FUSED_SMALL].view(shape_small)
    vt_small = vals_main.view(-1)[:N_FUSED_SMALL].view(shape_small)
    check_fused2_case("F2 shape", kt_small, vt_small, ops.BitfieldSpec(14, 14), 7, subs=(None,))
    f3_starts = ragged_starts(N_FUSED_SMALL, 16, np_rng, empty=(5,))
    check_fused2_case("F3 shape", kt_small, vt_small, ops.BitfieldSpec(0, 16), 8,
                      seg_strip(f3_starts, shape_small), 16, subs=(None,))
    del kt_f1, vt_f1, kt_small, vt_small
    log("kernels", f"fused2, main shapes (F1 {N_MAIN // t_fused} x {t_fused}, both 16-bit pairs; "
                   f"F2's 14-bit pair and F3's 16 segments over {shape_small}): K1f-K3f bitwise "
                   f"equal to their plain versions ({time.perf_counter() - t0:.1f} s)")
    # (b) every form: tiles of 128 to the fused tile and ragged ones, the
    # pairs (16, 8), (14, 7) and the uneven (6, 4), every stage width, int32
    # and uint32 keys, ragged strips with empty segments, bases past 2^24
    for shape, s in (((16, 128), 5), ((3, 1000), 9), ((8, 4096), 37), ((3, t_fused), 5),
                     ((7, 33), 3)):
        for i, (shift, pbits, split) in enumerate(((0, 16, 8), (14, 14, 7), (26, 6, 4))):
            dtype = (torch.int32, torch.uint32)[i % 2]
            keys = keys_for(dtype, shape, *spans[dtype])
            vals = rand_i32(shape)
            seg = seg_strip(ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1)), shape)
            off = (1 << 24) + 1 if i != 1 else 0
            spec = ops.BitfieldSpec(shift, pbits)
            check_fused2_case(f"{spec.name} {dtype} {shape}", keys, vals, spec, split, g_offset=off)
            check_fused2_case(f"{spec.name} {dtype} {shape} s={s}", keys, vals, spec, split, seg, s,
                              g_offset=off)
    # (c) one-cell tiles: every key of a tile in one (segment, pair) cell
    keys = torch.full((8, t_fused), 0x5A5A1234, dtype=torch.int32, device=dev)
    keys[4:] ^= rand_i32(tuple(keys[4:].shape)) & 0xFFFF0000       # one pair, other high bits
    seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), (8, t_fused))
    check_fused2_case("one-cell tiles", keys, rand_i32((8, t_fused)), ops.BitfieldSpec(0, 16), 8,
                      g_offset=(1 << 24) + 1)
    check_fused2_case("one-cell tiles seg", keys, rand_i32((8, t_fused)), ops.BitfieldSpec(0, 16), 8,
                      seg, 4)
    # (d) one- to eight-key segments: thousands of runs of at most 32 keys
    for shape, (shift, pbits, split) in (((16, 4096), (8, 6, 4)), ((64, 4096), (30, 2, 1))):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        check_fused2_case(f"{starts.size} tiny segments pair {pbits}",
                          keys_for(torch.uint32, shape, 0, 2**32), rand_i32(shape),
                          ops.BitfieldSpec(shift, pbits), split, seg_strip(starts, shape),
                          int(starts.size), subs=(1, 8))
        log("kernels", f"{starts.size} segments of 1-8 keys over {shape}, a {pbits}-bit pair: "
                       f"K1f-K3f bitwise equal")
    del keys, vals, seg
    if len(fused_forms) != 4:
        raise AssertionError(f"fused2 forms checked: {sorted(fused_forms)}")
    log("kernels", f"{n_checks - n0} fused2 cases (the fused paths' shapes, tiles of 128 to {t_fused}, "
                   f"pairs (16, 8), (14, 7), (6, 4), stage widths 1, 3, 4 and 8, both families, "
                   f"one-cell tiles, G above 2^24, empty and tiny segments; flat and segmented, "
                   f"keys and key-value): K1f-K3f all bitwise equal to their plain versions "
                   f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3f. B10, the standalone tile reorder of the unfused baseline, against
    # its plain version: key-only (null values) and key-value
    def check_reorder_case(what, ids, keys_tiled, values_tiled, m):
        nonlocal n_checks
        e = 0
        for vals in (None, values_tiled):
            got = mst.tile_reorder(ids, keys_tiled, vals, m)
            want = mst.tile_reorder_plain(ids, keys_tiled, vals, m)
            e = max(e, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        errs["tile_reorder"] = max(errs["tile_reorder"], e)
        if e:
            raise AssertionError(f"tile_reorder != plain for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    # (a) the main shape: 8192 tiles of 4096, the labels of the unfused
    # baseline's m = 256 pass; the destinations riding as the values, as
    # pass 2 of multisplit_unfused takes them
    ids = mst.spec_bucket_ids_plain(keys_main, main_spec(256))
    check_reorder_case("main shape m=256", ids, keys_main, vals_main, 256)
    check_reorder_case("main shape m=256, destinations as values", ids, keys_main,
                       mst.tile_positions_plain(ids, st.global_scan(mst.tile_histograms_plain(ids, 256)),
                                                256), 256)
    del ids
    # (b) m in (1, 2, 7, 32, 255, 256), tiles of 1 to MAX_TILE keys, ragged
    # ones among them, int32 / uint32 / float32 keys with NaN and inf, ids
    # outside [0, m) (both sides clamp them)
    for shape in ((64, 4096), (3, mst.MAX_TILE), (5, 1000), (7, 33), (9, 100), (4, 1)):
        for i, m in enumerate((1, 2, 7, 32, 255, 256)):
            dtype = (torch.int32, torch.uint32, torch.float32)[i % 3]
            keys = keys_for(dtype, shape, *spans[dtype])
            if dtype == torch.float32:
                flat = keys.view(-1)
                edges = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0], device=dev)
                flat[: min(4, flat.numel())] = edges[: min(4, flat.numel())]
            lo, hi = (-3, m + 3) if i % 2 else (0, m)
            ids = torch.randint(lo, hi, shape, dtype=torch.int32, device=dev, generator=gen)
            check_reorder_case(f"m={m} {dtype} {shape} ids in [{lo}, {hi})", ids, keys,
                               rand_i32(shape), m)
    del ids, keys
    log("kernels", f"{n_checks - n0} tile_reorder cases (the main shape at m = 256, m in (1, 2, 7, "
                   f"32, 255, 256), tiles of 1 to {mst.MAX_TILE} keys and ragged ones, int32/uint32/"
                   f"float32 keys with NaN and inf, ids outside [0, m), key-only and key-value): B10 "
                   f"bitwise equal to its plain version ({time.perf_counter() - t0:.1f} s)")

    # ---- 4. main path at the paper's size, with the launch counts of that run alone
    keys = rand_i32((N_MAIN,)).view(torch.uint32)
    values = rand_i32((N_MAIN,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    mst.reset_launches()
    runs = {}
    t0 = time.perf_counter()
    for m in (2, 32, 256):
        spec = main_spec(m)
        for method in ("bms", "dms"):
            runs[(m, method, False)] = ops.multisplit(keys, spec, method=method, device=dev)
            runs[(m, method, True)] = ops.multisplit(keys, spec, values, method=method, device=dev)
        runs[(m, "hist")] = ops.histogram(keys, spec, device=dev)
    runs["sort"] = ops.radix_sort(keys, device=dev)
    runs["sort_kv"] = ops.radix_sort(keys, values, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = mst.launch_counts()
    peak_main = torch.cuda.max_memory_allocated() - base_mem
    log("main", f"n = {N_MAIN}: 12 multisplits, 3 histograms, 2 radix sorts in {main_s:.2f} s "
                f"(first calls); peak device memory above the inputs {peak_main / 2**30:.2f} GiB")

    fields = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")
    for m in (2, 32, 256):
        spec = main_spec(m)
        want = rb_sort_multisplit(keys, spec, values)
        for method in ("bms", "dms"):
            for kv in (False, True):
                got = runs[(m, method, kv)]
                for f in fields:
                    w = getattr(want, f)
                    if f == "values" and not kv:
                        w = None
                    if max_err(getattr(got, f), w):
                        raise AssertionError(f"multisplit m={m} {method} kv={kv}: {f} differs")
        if max_err(runs[(m, "hist")], want.bucket_counts):
            raise AssertionError(f"histogram m={m} differs")
        del want
    # stable sort of uint32 keys: flip the sign bit so signed order is unsigned order
    _, order = torch.sort(bits(keys) ^ torch.iinfo(torch.int32).min, stable=True)
    want_keys, want_vals = bits(keys)[order].view(torch.uint32), values[order]
    if max_err(runs["sort"][0], want_keys) or runs["sort"][1] is not None:
        raise AssertionError("radix_sort keys differ")
    if max_err(runs["sort_kv"][0], want_keys) or max_err(runs["sort_kv"][1], want_vals):
        raise AssertionError("radix_sort key-value differs")
    del runs, order, want_keys, want_vals
    log("main", "every multisplit, histogram and radix sort is bitwise equal to the "
                "stable-sort oracle")

    # ---- 5. launches
    for name, count in launches.items():
        log("launches", f"flat path: {name}: {count}")
    # per run: a multisplit launches K1 once and K2 (bms) or K3 (dms) once; a
    # histogram K1 once; a radix sort K1 and K2 once a pass, 4 passes; no
    # other kernel
    expect = {name: 0 for name in launches}
    expect.update({"spec_tile_histograms": 12 + 3 + 8, "spec_fused_postscan_reorder": 6 + 8,
                   "spec_tile_positions": 6})
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

    # ---- 5b. the segmented main path, with its own launch counts
    def seg_oracle(keys, starts, spec, values=None):
        """Stable torch.sort of the int64 combined key seg·m + label."""
        m = spec.num_buckets
        n = keys.shape[0]
        starts_t = torch.from_numpy(starts).to(dev)
        seg = st.segment_ids_from_starts(starts_t, n)
        cid = seg.long() * m + spec.emit(keys).long()
        _, order = torch.sort(cid, stable=True)
        counts = torch.bincount(cid, minlength=len(starts) * m).to(torch.int32).view(-1, m)
        dest = torch.empty(n, dtype=torch.int32, device=dev)
        dest[order] = torch.arange(n, dtype=torch.int32, device=dev)
        return ops.MultisplitResult(
            bits(keys)[order].view(keys.dtype),
            None if values is None else bits(values)[order].view(values.dtype),
            st.exclusive_rows(counts), counts, dest - starts_t.index_select(0, seg))

    def check_result(what, got, want, fields):
        for f in fields:
            if max_err(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{what}: {f} differs from the stable-sort oracle")

    def seg_sort_oracle(keys, starts, values=None):
        seg = st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), keys.shape[0])
        _, order = torch.sort((seg.long() << 32) | (bits(keys).long() & 0xFFFFFFFF), stable=True)
        return bits(keys)[order].view(keys.dtype), None if values is None else values[order]

    spec1 = main_spec(32)
    ids3_flat = torch.randint(0, 64, (n3,), dtype=torch.int32, device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mst.reset_launches()
    t0 = time.perf_counter()
    seg_runs = {}
    for method in ("bms", "dms"):
        seg_runs[(method, False)] = ops.segmented_multisplit(keys, spec1, s1_starts, method=method,
                                                             device=dev)
        seg_runs[(method, True)] = ops.segmented_multisplit(keys, spec1, s1_starts, values,
                                                            method=method, device=dev)
    seg_runs["positions_only"] = ops.segmented_multisplit(keys, spec1, s1_starts,
                                                          mode="positions_only", device=dev)
    seg_runs["counts_only"] = ops.segmented_multisplit(keys, spec1, s1_starts,
                                                       mode="counts_only", device=dev)
    seg_runs["S2"] = ops.segmented_radix_sort(keys, s2_starts, device=dev)
    seg_runs["S2 kv"] = ops.segmented_radix_sort(keys, s2_starts, values, device=dev)
    seg_runs["S3"] = ops.segmented_multisplit(ids3_flat, ops.IdentitySpec(64), s3_starts,
                                              method="dms", mode="positions_only", device=dev)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    seg_launches = mst.launch_counts()
    peak_seg = torch.cuda.max_memory_allocated() - base_mem
    log("segmented", f"S1 4 multisplits + positions_only + counts_only (n = 2^25, s = 64, m = 32), "
                     f"S2 2 radix sorts (s = 16), S3 routing (n = 2^20, s = 256, m = 64) in "
                     f"{seg_s:.2f} s (first calls); peak device memory above the inputs "
                     f"{peak_seg / 2**30:.2f} GiB")
    want = seg_oracle(keys, s1_starts, spec1, values)
    for (method, kv), got in [(k, v) for k, v in seg_runs.items() if isinstance(k, tuple)]:
        check_result(f"S1 {method} kv={kv}", got, want if kv else want._replace(values=None),
                     ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    check_result("S1 positions_only", seg_runs["positions_only"],
                 want._replace(keys=None, values=None),
                 ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    check_result("S1 counts_only", seg_runs["counts_only"],
                 want._replace(keys=None, values=None, permutation=None),
                 ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    del want
    want_k, want_v = seg_sort_oracle(keys, s2_starts, values)
    if max_err(seg_runs["S2"][0], want_k) or seg_runs["S2"][1] is not None:
        raise AssertionError("S2 segmented_radix_sort keys differ")
    if max_err(seg_runs["S2 kv"][0], want_k) or max_err(seg_runs["S2 kv"][1], want_v):
        raise AssertionError("S2 segmented_radix_sort key-value differs")
    del want_k, want_v
    check_result("S3 routing", seg_runs["S3"],
                 seg_oracle(ids3_flat, s3_starts, ops.IdentitySpec(64))._replace(keys=None),
                 ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    del seg_runs
    log("segmented", "S1 (bms, dms, key-only, key-value, positions_only, counts_only), S2 and S3 "
                     "are bitwise equal to the stable-sort oracle")
    for name, count in seg_launches.items():
        log("launches", f"segmented path: {name}: {count}")
    # S1: K1s in each of the 6 calls, K2s in the 2 bms calls, K3s in the 2
    # dms calls and positions_only; S2: K1s and K2s once a pass, 2 x 4
    # passes; S3: K1s and K3s once
    seg_expect = {name: 0 for name in expect}
    seg_expect.update({"seg_spec_tile_histograms": 6 + 8 + 1,
                       "seg_spec_fused_postscan_reorder": 2 + 8,
                       "seg_spec_tile_positions": 3 + 1})
    if seg_launches != seg_expect:
        raise AssertionError(f"segmented launch counts {seg_launches} != expected {seg_expect}")
    for name, count in seg_launches.items():
        launches[name] = launches.get(name, 0) + count

    # ---- 5c. the flat callable path: a programmer's bucket functions (and
    # off-width keys in the partial modes) at n = 2^25, through the ids kernels
    def sssp_fn(floor, delta, m):
        """The delta-stepping bucket of examples/sssp.py: clip((u - floor) //
        delta, 0, m - 1), returned as int64 as a user's function may."""
        return lambda u: torch.clamp((u.long() - floor) // delta, 0, m - 1)

    def hash_fn(bits_):
        """A multiplicative (Fibonacci) hash of the 32-bit word into 2^bits
        buckets, which no declarative spec expresses."""
        return lambda u: (((bits(u).long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF) >> (32 - bits_)

    # int32 distances around the delta-stepping window, vertex ids as values
    floor, delta, m_sssp = 1 << 20, 1 << 16, 10
    dist = torch.randint(floor - (1 << 18), floor + delta * (m_sssp + 2), (N_MAIN,),
                         dtype=torch.int32, device=dev, generator=gen)
    verts = torch.randperm(N_MAIN, dtype=torch.int32, device=dev, generator=gen)
    sssp = ops.from_fn(sssp_fn(floor, delta, m_sssp), m_sssp, "sssp")
    hashes = {m: ops.from_fn(hash_fn(m.bit_length() - 1), m, f"hash{m}") for m in (2, 32, 256)}
    keys16 = (keys.view(torch.int32) >> 16).to(torch.int16)
    keys64 = keys.view(torch.int32).long() * 3
    spec16, spec64 = ops.DeltaSpec(16, 1 << 15), ops.DeltaSpec(256, 1 << 32)
    torch.cuda.synchronize()
    mst.reset_launches()
    t0 = time.perf_counter()
    cruns = {}
    for method in ("wms", "bms"):
        cruns[("sssp", method)] = ops.multisplit(dist, sssp, verts, method=method, device=dev)
    for m, spec in hashes.items():
        for method in ("bms", "dms"):
            cruns[(m, method, False)] = ops.multisplit(keys, spec, method=method, device=dev)
            cruns[(m, method, True)] = ops.multisplit(keys, spec, values, method=method, device=dev)
        cruns[(m, "counts_only")] = ops.multisplit(keys, spec, mode="counts_only", device=dev)
        cruns[(m, "positions_only")] = ops.multisplit(keys, spec, mode="positions_only",
                                                      device=dev)
    for name, k, spec in (("int16", keys16, spec16), ("int64", keys64, spec64)):
        cruns[(name, "hist")] = ops.histogram(k, spec, device=dev)
        cruns[(name, "positions_only")] = ops.multisplit(k, spec, mode="positions_only",
                                                         device=dev)
    # the kernel doors: even-width labels written out, then their histogram
    from repro_torch.kernels import ops as kops

    even = ops.EvenSpec(0.0, float(1 << 32), 256)
    cruns["door"] = kops.device_histogram(kops.even_bucket_ids(keys.view(l_main, t_main), 0.0,
                                                               float(1 << 32), 256), 256)
    torch.cuda.synchronize()
    callable_s = time.perf_counter() - t0
    call_launches = mst.launch_counts()
    log("callable", f"n = 2^25: 2 delta-stepping multisplits (m = 10, int32 distances, vertex-id "
                    f"values), 18 hash multisplits (m = 2, 32, 256), int16 and int64 keys through "
                    f"histogram and positions_only, the even-ids door: {callable_s:.2f} s "
                    f"(first calls)")
    for method in ("wms", "bms"):
        check_result(f"sssp {method}", cruns[("sssp", method)],
                     rb_sort_multisplit(dist, sssp, verts), fields)
    for m, spec in hashes.items():
        want = rb_sort_multisplit(keys, spec, values)
        for method in ("bms", "dms"):
            check_result(f"hash{m} {method}", cruns[(m, method, False)],
                         want._replace(values=None), fields)
            check_result(f"hash{m} {method} kv", cruns[(m, method, True)], want, fields)
        check_result(f"hash{m} counts_only", cruns[(m, "counts_only")],
                     want._replace(keys=None, values=None, permutation=None), fields)
        check_result(f"hash{m} positions_only", cruns[(m, "positions_only")],
                     want._replace(keys=None, values=None), fields)
        del want
    for name, k, spec in (("int16", keys16, spec16), ("int64", keys64, spec64)):
        want = rb_sort_multisplit(k, spec)
        if max_err(cruns[(name, "hist")], want.bucket_counts):
            raise AssertionError(f"{name} keys: histogram differs")
        check_result(f"{name} positions_only", cruns[(name, "positions_only")],
                     want._replace(keys=None, values=None), fields)
        del want
    if max_err(cruns["door"], torch.bincount(even.emit(keys).long(), minlength=256).to(torch.int32)):
        raise AssertionError("device_histogram(even_bucket_ids) differs from bincount")
    del cruns, keys16, keys64
    log("callable", "every callable multisplit (bms, wms, dms, key-only, key-value, counts_only, "
                    "positions_only), the off-width keys and the door are bitwise equal to the "
                    "stable-sort oracle")
    for name, count in call_launches.items():
        log("launches", f"flat callable path: {name}: {count}")
    # sssp: K1 and K2 on ids twice; each hash m: K1 on ids 6 times, K2 twice
    # (bms), K3 3 times (dms twice, positions_only); each off-width type: K1
    # twice, K3 once; the door: spec_bucket_ids and K1 on ids once
    call_expect = {name: 0 for name in call_launches}
    call_expect.update({"tile_histograms": 2 + 3 * 6 + 2 * 2 + 1,
                        "fused_postscan_reorder": 2 + 3 * 2,
                        "tile_positions": 3 * 3 + 2, "spec_bucket_ids": 1})
    if call_launches != call_expect:
        raise AssertionError(f"callable launch counts {call_launches} != expected {call_expect}")
    for name, count in call_launches.items():
        launches[name] += count


    # ---- 5d. the segmented callable path at S1's shape: 2^25 keys, 64 ragged
    # segments, a hash into 32 buckets (m_eff = 2048)
    hash32 = hashes[32]
    torch.cuda.synchronize()
    mst.reset_launches()
    t0 = time.perf_counter()
    sruns = {}
    for method in ("bms", "dms"):
        sruns[(method, False)] = ops.segmented_multisplit(keys, hash32, s1_starts, method=method,
                                                          device=dev)
        sruns[(method, True)] = ops.segmented_multisplit(keys, hash32, s1_starts, values,
                                                         method=method, device=dev)
    sruns["positions_only"] = ops.segmented_multisplit(keys, hash32, s1_starts,
                                                       mode="positions_only", device=dev)
    sruns["counts_only"] = ops.segmented_multisplit(keys, hash32, s1_starts, mode="counts_only",
                                                    device=dev)
    torch.cuda.synchronize()
    seg_call_s = time.perf_counter() - t0
    seg_call_launches = mst.launch_counts()
    want = seg_oracle(keys, s1_starts, hash32, values)
    for (method, kv), got in [(k, v) for k, v in sruns.items() if isinstance(k, tuple)]:
        check_result(f"S1 callable {method} kv={kv}", got,
                     want if kv else want._replace(values=None), fields)
    check_result("S1 callable positions_only", sruns["positions_only"],
                 want._replace(keys=None, values=None), fields)
    check_result("S1 callable counts_only", sruns["counts_only"],
                 want._replace(keys=None, values=None, permutation=None), fields)
    del want, sruns
    log("callable", f"S1 shape with the hash into 32 buckets: 4 segmented multisplits + "
                    f"positions_only + counts_only in {seg_call_s:.2f} s (first calls), bitwise "
                    f"equal to the stable-sort oracle")
    for name, count in seg_call_launches.items():
        log("launches", f"segmented callable path: {name}: {count}")
    # K1s on ids in each of the 6 calls, K2s on ids in the 2 bms calls, K3s on
    # ids in the 2 dms calls and positions_only
    seg_call_expect = {name: 0 for name in seg_call_launches}
    seg_call_expect.update({"seg_tile_histograms": 6, "seg_fused_postscan_reorder": 2,
                            "seg_tile_positions": 3})
    if seg_call_launches != seg_call_expect:
        raise AssertionError(f"segmented callable launch counts {seg_call_launches} != "
                             f"expected {seg_call_expect}")
    for name, count in seg_call_launches.items():
        launches[name] += count

    # ---- 5e. the packed family's paths (family="packed"), one form each, each
    # with its own launch counts and held bitwise against the stable-sort
    # oracle and against the same call on the default (onehot) family
    sort_key = bits(keys) ^ torch.iinfo(torch.int32).min        # unsigned order as signed
    _, order = torch.sort(sort_key, stable=True)
    sorted_kv = (bits(keys)[order].view(torch.uint32), values[order])
    del order, sort_key
    ref_ms = {}                                  # what -> (packed call, its onehot twin)

    def packed_path(path, calls, expect, oracles):
        """Run ``calls`` (label -> a function of the family) with the packed
        family alone, check the launch counts, then every result against
        its oracle and the onehot family's result."""
        torch.cuda.synchronize()
        mst.reset_launches()
        t0 = time.perf_counter()
        got = {what: fn("packed") for what, fn in calls.items()}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = mst.launch_counts()
        want = {name: 0 for name in counts}
        want.update(expect)
        if counts != want:
            raise AssertionError(f"packed {path} launch counts {counts} != expected {want}")
        for name, count in counts.items():
            launches[name] += count
            if count:
                log("launches", f"packed {path} path: {name}: {count}")
        for what, fn in calls.items():
            res, onehot = got.pop(what), fn(None)
            if isinstance(res, tuple) and not hasattr(res, "_fields"):        # a sort
                for a, b, c in zip(res, onehot, oracles[what]()):
                    if max_err(a, b) or max_err(a, c):
                        raise AssertionError(f"packed {what} differs from onehot or the oracle")
            elif isinstance(res, torch.Tensor):                                # a histogram
                if max_err(res, onehot) or max_err(res, oracles[what]()):
                    raise AssertionError(f"packed {what} differs from onehot or the oracle")
            else:
                check_result(f"packed {what}", res, onehot, fields)
                check_result(f"packed {what}", res, oracles[what](), fields)
            ref_ms[what] = fn
        log("packed", f"{path}: {len(calls)} calls in {secs:.2f} s (first calls), every one bitwise "
                      f"equal to the onehot family and to the stable-sort oracle")

    flat_calls, flat_oracles = {}, {}
    for m in (8, 32, 256):
        spec_m = main_spec(m)
        want_m = functools.lru_cache(None)(lambda spec_m=spec_m: rb_sort_multisplit(keys, spec_m, values))
        flat_calls[f"multisplit kv bms m={m}"] = (
            lambda fam, spec_m=spec_m: ops.multisplit(keys, spec_m, values, method="bms", family=fam,
                                                      device=dev))
        flat_oracles[f"multisplit kv bms m={m}"] = want_m
        flat_calls[f"multisplit dms m={m}"] = (
            lambda fam, spec_m=spec_m: ops.multisplit(keys, spec_m, method="dms", family=fam,
                                                      device=dev))
        flat_oracles[f"multisplit dms m={m}"] = lambda want_m=want_m: want_m()._replace(values=None)
        flat_calls[f"histogram m={m}"] = (
            lambda fam, spec_m=spec_m: ops.histogram(keys, spec_m, family=fam, device=dev))
        flat_oracles[f"histogram m={m}"] = lambda want_m=want_m: want_m().bucket_counts
    flat_calls["radix_sort kv r=8"] = lambda fam: ops.radix_sort(keys, values, family=fam, device=dev)
    flat_oracles["radix_sort kv r=8"] = lambda: sorted_kv
    # per m: K1p in 3 calls, K2p in the bms call, K3p in the dms call; the
    # sort: K1p and K2p once a pass, 4 passes
    packed_path("flat (labels in the kernels)", flat_calls,
                {"packed_tile_histograms": 3 * 3 + 4, "packed_fused_postscan_reorder": 3 + 4,
                 "packed_tile_positions": 3}, flat_oracles)
    del flat_calls, flat_oracles

    s1_want = functools.lru_cache(None)(lambda: seg_oracle(keys, s1_starts, spec1, values))
    seg_calls = {
        "S1 segmented_multisplit kv bms": lambda fam: ops.segmented_multisplit(
            keys, spec1, s1_starts, values, method="bms", family=fam, device=dev),
        "S2 segmented_radix_sort kv": lambda fam: ops.segmented_radix_sort(
            keys, s2_starts, values, family=fam, device=dev),
        "S3 routing positions_only": lambda fam: ops.segmented_multisplit(
            ids3_flat, ops.IdentitySpec(64), s3_starts, method="dms", mode="positions_only",
            family=fam, device=dev),
    }
    seg_oracles = {
        "S1 segmented_multisplit kv bms": s1_want,
        "S2 segmented_radix_sort kv": lambda: seg_sort_oracle(keys, s2_starts, values),
        "S3 routing positions_only": lambda: seg_oracle(ids3_flat, s3_starts, ops.IdentitySpec(64))._replace(keys=None),
    }
    # S1: K1p, K2p; S2: K1p and K2p once a pass; S3: K1p, K3p
    packed_path("segmented (labels in the kernels)", seg_calls,
                {"packed_tile_histograms": 1 + 4 + 1, "packed_fused_postscan_reorder": 1 + 4,
                 "packed_tile_positions": 1}, seg_oracles)
    del seg_calls, seg_oracles

    h32_want = functools.lru_cache(None)(lambda: rb_sort_multisplit(keys, hash32, values))
    call_calls = {
        "hash32 multisplit kv bms": lambda fam: ops.multisplit(keys, hash32, values, method="bms",
                                                               family=fam, device=dev),
        "hash32 multisplit dms": lambda fam: ops.multisplit(keys, hash32, method="dms", family=fam,
                                                            device=dev),
        "hash32 histogram": lambda fam: ops.histogram(keys, hash32, family=fam, device=dev),
    }
    call_oracles = {
        "hash32 multisplit kv bms": h32_want,
        "hash32 multisplit dms": lambda: h32_want()._replace(values=None),
        "hash32 histogram": lambda: h32_want().bucket_counts,
    }
    packed_path("flat callable (ids strip)", call_calls,
                {"packed_tile_histograms": 3, "packed_fused_postscan_reorder": 1,
                 "packed_tile_positions": 1}, call_oracles)
    del call_calls, call_oracles, h32_want

    s1h_want = functools.lru_cache(None)(lambda: seg_oracle(keys, s1_starts, hash32, values))
    segc_calls = {
        "S1 hash32 segmented_multisplit kv bms": lambda fam: ops.segmented_multisplit(
            keys, hash32, s1_starts, values, method="bms", family=fam, device=dev),
        "S1 hash32 positions_only": lambda fam: ops.segmented_multisplit(
            keys, hash32, s1_starts, method="dms", mode="positions_only", family=fam, device=dev),
    }
    segc_oracles = {
        "S1 hash32 segmented_multisplit kv bms": s1h_want,
        "S1 hash32 positions_only": lambda: s1h_want()._replace(keys=None, values=None),
    }
    packed_path("segmented callable (ids strip)", segc_calls,
                {"packed_tile_histograms": 2, "packed_fused_postscan_reorder": 1,
                 "packed_tile_positions": 1}, segc_oracles)
    del segc_calls, segc_oracles, s1h_want, s1_want, sorted_kv

    # ---- 5f. the fused two-digit paths (fuse_digits=True), each call with its
    # own launch counts, each result held bitwise against the unfused sort and
    # a stable torch.sort: F1 radix_sort r = 8 at n = 2^25 (two 16-bit pairs:
    # key-value bms, key-only dms, the packed family), F2 r = 7 at 2^22 (two
    # 14-bit pairs and a 4-bit single pass), F3 segmented_radix_sort over 16
    # ragged segments at 2^22
    def h_bytes(n_keys, s_, bits_):
        """The size of one pair's H: L tiles of the fused tile, s·m² columns."""
        return 4 * (-(-n_keys // t_fused)) * s_ * (1 << bits_)

    def fused_call(path, fn, expect, oracles, h_size):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        mst.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = mst.launch_counts()
        want = {name: 0 for name in counts}
        want.update(expect)
        if counts != want:
            raise AssertionError(f"{path} launch counts {counts} != expected {want}")
        for name, count in counts.items():
            launches[name] += count
            if count:
                log("launches", f"{path}: {name}: {count}")
        for what, oracle in oracles.items():
            for a, b in zip(res, oracle):
                if max_err(a, b):
                    raise AssertionError(f"{path} differs from {what}")
        log("fused", f"{path}: {secs:.2f} s (first call); H {h_size / 2**30:.2f} GiB a pair; peak "
                     f"device memory above its inputs {(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} "
                     f"GiB; bitwise equal to {' and '.join(oracles)}")
        return res

    def stable_sort(k, v=None):
        _, order = torch.sort(bits(k) ^ torch.iinfo(torch.int32).min, stable=True)
        return bits(k)[order].view(k.dtype), None if v is None else v[order]

    want_sort = stable_sort(keys, values)
    unfused = ops.radix_sort(keys, values, device=dev)
    k1f, k2f, k3f = "fused2_tile_histograms", "fused2_fused_postscan_reorder", "fused2_tile_positions"
    h_f1 = h_bytes(N_MAIN, 1, 16)
    fused_call("F1 radix_sort kv bms r=8, fuse_digits", lambda: ops.radix_sort(
        keys, values, radix_bits=8, fuse_digits=True, device=dev), {k1f: 2, k2f: 2},
        {"the unfused radix_sort": unfused, "a stable torch.sort": want_sort}, h_f1)
    fused_call("F1 radix_sort dms r=8, fuse_digits, key-only", lambda: ops.radix_sort(
        keys, method="dms", fuse_digits=True, device=dev), {k1f: 2, k3f: 2},
        {"the unfused radix_sort": (unfused[0], None), "a stable torch.sort": (want_sort[0], None)},
        h_f1)
    fused_call("F1 radix_sort kv bms r=8, fuse_digits, family=packed", lambda: ops.radix_sort(
        keys, values, fuse_digits=True, family="packed", device=dev), {k1f: 2, k2f: 2},
        {"the unfused radix_sort": unfused, "a stable torch.sort": want_sort}, h_f1)
    del unfused, want_sort
    keys_s, values_s = keys[:N_FUSED_SMALL], values[:N_FUSED_SMALL]
    fused_call("F2 radix_sort kv bms r=7, fuse_digits, n=2^22", lambda: ops.radix_sort(
        keys_s, values_s, radix_bits=7, fuse_digits=True, device=dev),
        {k1f: 2, k2f: 2, "spec_tile_histograms": 1, "spec_fused_postscan_reorder": 1},
        {"the unfused radix_sort": ops.radix_sort(keys_s, values_s, radix_bits=7, device=dev),
         "a stable torch.sort": stable_sort(keys_s, values_s)}, h_bytes(N_FUSED_SMALL, 1, 14))
    fused_call("F3 segmented_radix_sort kv bms r=8 s=16, fuse_digits, n=2^22",
               lambda: ops.segmented_radix_sort(keys_s, f3_starts, values_s, fuse_digits=True,
                                                device=dev), {k1f: 2, k2f: 2},
               {"the unfused segmented_radix_sort": ops.segmented_radix_sort(
                   keys_s, f3_starts, values_s, device=dev),
                "a stable torch.sort": seg_sort_oracle(keys_s, f3_starts, values_s)},
               h_bytes(N_FUSED_SMALL, 16, 16))
    # ---- 5g. the batched layout: (b, n) rows, each multisplit or sorted on its
    # own in one launch a stage for the whole batch (B1 8 rows of 2^22, the
    # local step of an 8-shard split; B2 256 short rows with ragged tails; B3
    # the batched radix sort), torch.vmap of the ops, one packed and one
    # callable batch; each call with its own launch counts, each row held
    # bitwise against the stable-sort oracle and, for B1, the flat op on it
    from repro_torch.core import multisplit as core_ms
    from repro_torch.core import sort as core_sort

    def counted(what, fn, expect):
        """Run ``fn`` alone with the counts at 0; its launches must be
        ``expect`` exactly. They add to the paths' counts."""
        torch.cuda.synchronize()
        mst.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        counts = mst.launch_counts()
        want = {name: 0 for name in counts}
        want.update(expect)
        if counts != want:
            raise AssertionError(f"{what}: launch counts {counts} != expected {want}")
        for name, count in counts.items():
            launches[name] += count
        return res

    def batch_oracle(kb_, spec_, vb_=None):
        """Every row's multisplit at once: a stable torch.sort of the int64
        key row·m + label; (b, n) data, (b, m) counts, row-local perm."""
        b_, n_ = kb_.shape
        m_ = spec_.num_buckets
        row = torch.arange(b_, device=dev, dtype=torch.int64)[:, None]
        cid = (row * m_ + spec_.emit(kb_).long()).view(-1)
        _, order = torch.sort(cid, stable=True)
        counts = torch.bincount(cid, minlength=b_ * m_).to(torch.int32).view(b_, m_)
        dest = torch.empty(b_ * n_, dtype=torch.int64, device=dev)
        dest[order] = torch.arange(b_ * n_, device=dev)

        def take(x):
            return bits(x).reshape(-1)[order].view(b_, n_).view(x.dtype)

        return ops.MultisplitResult(take(kb_), None if vb_ is None else take(vb_),
                                    st.exclusive_rows(counts), counts,
                                    (dest.view(b_, n_) - row * n_).to(torch.int32))

    def batch_sort_oracle(kb_, vb_):
        b_, n_ = kb_.shape
        row = torch.arange(b_, device=dev, dtype=torch.int64)[:, None]
        _, order = torch.sort(((row << 32) | (bits(kb_).long() & 0xFFFFFFFF)).view(-1), stable=True)
        return tuple(bits(x).reshape(-1)[order].view(b_, n_).view(x.dtype) for x in (kb_, vb_))

    b1 = 8
    kb, vb = keys.view(b1, -1), values.view(b1, -1)
    n_b2 = (1 << 17) + 37
    kb2, vb2 = rand_i32((256, n_b2)).view(torch.uint32), rand_i32((256, n_b2))
    vmap_kv = torch.vmap(ops.multisplit_key_value, in_dims=(0, 0, None))
    vmap_ms = torch.vmap(ops.multisplit, in_dims=(0, None), out_dims=ops.vmap_out_dims())
    vmap_hist = torch.vmap(ops.histogram, in_dims=(0, None))
    k1, k2, k3 = "spec_tile_histograms", "spec_fused_postscan_reorder", "spec_tile_positions"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    n_batched = 0
    for m_ in (32, 256):
        sp = main_spec(m_)
        want = batch_oracle(kb, sp, vb)
        for r in range(b1):
            check_result(f"B1 m={m_} flat op on row {r}", ops.multisplit(kb[r], sp, vb[r], device=dev),
                         ops.MultisplitResult(*(x[r] for x in want)), fields)
        b_calls = [
            ("torch.vmap(multisplit_key_value) bms", lambda: vmap_kv(kb, vb, sp, method="bms",
                                                                      device=dev), {k1: 1, k2: 1}, want),
            ("torch.vmap(multisplit) dms", lambda: vmap_ms(kb, sp, method="dms", device=dev),
             {k1: 1, k3: 1}, want._replace(values=None)),
            ("batched_multisplit kv bms", lambda: core_ms.batched_multisplit(
                kb, sp, vb, method="bms", device=dev), {k1: 1, k2: 1}, want),
            ("batched_multisplit kv dms", lambda: core_ms.batched_multisplit(
                kb, sp, vb, method="dms", device=dev), {k1: 1, k3: 1}, want),
            ("batched_multisplit bms", lambda: core_ms.batched_multisplit(
                kb, sp, method="bms", device=dev), {k1: 1, k2: 1}, want._replace(values=None)),
            ("batched_multisplit dms", lambda: core_ms.batched_multisplit(
                kb, sp, method="dms", device=dev), {k1: 1, k3: 1}, want._replace(values=None)),
            ("batched_multisplit counts_only", lambda: core_ms.batched_multisplit(
                kb, sp, mode="counts_only", device=dev), {k1: 1},
             want._replace(keys=None, values=None, permutation=None)),
            ("batched_multisplit positions_only", lambda: core_ms.batched_multisplit(
                kb, sp, method="dms", mode="positions_only", device=dev), {k1: 1, k3: 1},
             want._replace(keys=None, values=None)),
        ]
        for what, fn, expect, want_ in b_calls:
            check_result(f"B1 m={m_} {what}", counted(f"B1 m={m_} {what}", fn, expect), want_, fields)
            n_batched += 1
        hist_b = counted(f"B1 m={m_} torch.vmap(histogram)", lambda: vmap_hist(kb, sp, device=dev),
                         {k1: 1})
        if max_err(hist_b, want.bucket_counts):
            raise AssertionError(f"B1 m={m_} torch.vmap(histogram) differs")
        n_batched += 1
        del want, hist_b
    want = batch_oracle(kb2, main_spec(32), vb2)
    check_result("B2 batched_multisplit kv bms", counted(
        "B2 batched_multisplit kv bms", lambda: core_ms.batched_multisplit(
            kb2, main_spec(32), vb2, device=dev), {k1: 1, k2: 1}), want, fields)
    check_result("B2 torch.vmap(multisplit) dms", counted(
        "B2 torch.vmap(multisplit) dms", lambda: vmap_ms(kb2, main_spec(32), method="dms", device=dev),
        {k1: 1, k3: 1}), want._replace(values=None), fields)
    del want
    want_sort_b = batch_sort_oracle(kb, vb)
    for what, fn, expect in (
            ("B3 radix_sort kv r=8", lambda: ops.radix_sort(kb, vb, device=dev), {k1: 4, k2: 4}),
            ("B3 radix_sort kv r=8, fuse_digits", lambda: ops.radix_sort(
                kb, vb, fuse_digits=True, device=dev),
             {"fused2_tile_histograms": 2, "fused2_fused_postscan_reorder": 2})):
        for a, b_ in zip(counted(what, fn, expect), want_sort_b):
            if max_err(a, b_):
                raise AssertionError(f"{what} differs from a stable torch.sort of each row")
    del want_sort_b
    check_result("batched packed kv bms", counted(
        "batched packed kv bms", lambda: core_ms.batched_multisplit(
            kb, main_spec(32), vb, family="packed", device=dev),
        {"packed_tile_histograms": 1, "packed_fused_postscan_reorder": 1}),
        batch_oracle(kb, main_spec(32), vb), fields)
    check_result("batched callable kv bms", counted(
        "batched callable kv bms", lambda: core_ms.batched_multisplit(kb, hashes[32], vb, device=dev),
        {"tile_histograms": 1, "fused_postscan_reorder": 1}),
        batch_oracle(kb, hashes[32], vb), fields)
    log("batched", f"B1 (8, 2^22) at m = 32 and 256: {n_batched} batched calls (torch.vmap of "
                   f"multisplit_key_value, multisplit and histogram; batched_multisplit bms and dms, "
                   f"key-only and key-value, counts_only, positions_only), each one K1 and one K2 or "
                   f"K3 for all 8 rows, each row bitwise equal to the flat op on it and to the "
                   f"stable-sort oracle; B2 (256, 2^17 + 37) m = 32, every row with pads; B3 batched "
                   f"radix_sort r = 8, unfused (K1, K2 4 times) and fused (K1f, K2f twice); a packed "
                   f"and a callable batch: all bitwise equal ({time.perf_counter() - t0:.1f} s with "
                   f"the oracles; peak device memory above the inputs "
                   f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} GiB)")

    # ---- 5h. the unfused baselines: multisplit_unfused (K1 and K3 on the ids,
    # then B10 for pass 2 and, key-value, pass 3) and radix_sort_per_pass (one
    # plan round trip a pass), each against the fused plan or radix_sort
    spec256 = main_spec(256)
    u_calls = [
        ("multisplit_unfused kv bms m=256", lambda: core_ms.multisplit_unfused(
            keys, spec256, values, method="bms", device=dev),
         {"tile_histograms": 1, "tile_positions": 1, "tile_reorder": 2},
         lambda: ops.multisplit(keys, spec256, values, method="bms", device=dev)),
        ("multisplit_unfused bms key-only m=256", lambda: core_ms.multisplit_unfused(
            keys, spec256, method="bms", device=dev),
         {"tile_histograms": 1, "tile_positions": 1, "tile_reorder": 1},
         lambda: ops.multisplit(keys, spec256, method="bms", device=dev)),
        ("multisplit_unfused kv dms m=256", lambda: core_ms.multisplit_unfused(
            keys, spec256, values, method="dms", device=dev),
         {"tile_histograms": 1, "tile_positions": 1},
         lambda: ops.multisplit(keys, spec256, values, method="dms", device=dev)),
    ]
    want = rb_sort_multisplit(keys, spec256, values)
    for what, fn, expect, fused_fn in u_calls:
        got = counted(what, fn, expect)
        check_result(f"{what} against the fused plan", got, fused_fn(), fields)
        check_result(what, got, want if got.values is not None else want._replace(values=None), fields)
        del got
    del want
    for what, fn, ref_fn in (
            ("radix_sort_per_pass kv r=8, n=2^25", lambda: core_sort.radix_sort_per_pass(
                keys, values, device=dev), lambda: ops.radix_sort(keys, values, device=dev)),
            ("radix_sort_per_pass kv r=8, (8, 2^22)", lambda: core_sort.radix_sort_per_pass(
                kb, vb, device=dev), lambda: ops.radix_sort(kb, vb, device=dev))):
        for a, b_ in zip(counted(what, fn, {k1: 4, k2: 4}), ref_fn()):
            if max_err(a, b_):
                raise AssertionError(f"{what} differs from radix_sort")
    log("unfused", "multisplit_unfused at n = 2^25, m = 256 (kv bms: K1 and K3 on the ids once, B10 "
                   "twice; key-only bms: B10 once; kv dms: B10 never) and radix_sort_per_pass flat "
                   "and batched: bitwise equal to the fused plan, the stable-sort oracle and "
                   "radix_sort")

    for name in launches:
        if launches[name] == 0:
            raise AssertionError(f"{name} was launched on none of the paths")

    # ---- 6. times
    def cuda_ms(fn, reps=7, inner=3) -> float:
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

    spec = main_spec(256)
    m = spec.num_buckets
    kt, vt = keys.view(l_main, t_main), values.view(l_main, t_main)
    g = st.global_scan(mst.spec_tile_histograms_plain(kt, spec))
    cid = (torch.arange(l_main, device=dev, dtype=torch.int32)[:, None] * m + spec.emit(kt)).view(-1)
    n = N_MAIN
    gbytes = 4 * l_main * m
    sort_cid_ms = cuda_ms(lambda: torch.sort(cid, stable=True))
    bincount_ms = cuda_ms(lambda: torch.bincount(cid, minlength=l_main * m))
    # the ids kernels on the same labels, materialised: what the ids path adds
    ids = mst.spec_bucket_ids_plain(kt, spec)
    even = ops.EvenSpec(0.0, float(1 << 32), 256)
    rows = [
        ("spec_tile_histograms", "tile_histograms.cu", "src/repro/kernels/multisplit_tile.py:368",
         lambda: mst.spec_tile_histograms(kt, spec),
         lambda: mst.spec_tile_histograms_plain(kt, spec),
         4 * n + gbytes, bincount_ms),
        ("spec_fused_postscan_reorder", "fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:460",
         lambda: mst.spec_fused_postscan_reorder(kt, g, vt, spec),
         lambda: mst.spec_fused_postscan_reorder_plain(kt, g, vt, spec),
         8 * n + gbytes + 16 * n, sort_cid_ms),
        ("spec_tile_positions", "tile_positions.cu", "src/repro/kernels/multisplit_tile.py:396",
         lambda: mst.spec_tile_positions(kt, g, spec),
         lambda: mst.spec_tile_positions_plain(kt, g, spec),
         4 * n + gbytes + 4 * n, sort_cid_ms),
        ("tile_histograms", "tile_histograms.cu", "src/repro/kernels/multisplit_tile.py:94",
         lambda: mst.tile_histograms(ids, m), lambda: mst.tile_histograms_plain(ids, m),
         4 * n + gbytes, bincount_ms),
        ("fused_postscan_reorder", "fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:168",
         lambda: mst.fused_postscan_reorder(ids, g, kt, vt, m),
         lambda: mst.fused_postscan_reorder_plain(ids, g, kt, vt, m),
         4 * n + 8 * n + gbytes + 16 * n, sort_cid_ms),
        ("tile_positions", "tile_positions.cu", "src/repro/kernels/multisplit_tile.py:123",
         lambda: mst.tile_positions(ids, g, m), lambda: mst.tile_positions_plain(ids, g, m),
         4 * n + gbytes + 4 * n, sort_cid_ms),
        # no single PyTorch call computes a spec's labels: library_ms is null
        ("spec_bucket_ids", "spec_bucket_ids.cu", "src/repro/kernels/multisplit_tile.py:421",
         lambda: mst.spec_bucket_ids(kt, even), lambda: mst.spec_bucket_ids_plain(kt, even),
         4 * n + 4 * n, None),
        # the packed family: the bytes of K1, K2 and K3 at the same shapes
        ("packed_tile_histograms", "packed_tile_histograms.cu",
         "src/repro/kernels/multisplit_tile.py:662",
         lambda: mst.packed_tile_histograms(kt, spec=spec),
         lambda: mst.packed_tile_histograms_plain(kt, spec=spec), 4 * n + gbytes, bincount_ms),
        ("packed_fused_postscan_reorder", "packed_fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:772",
         lambda: mst.packed_fused_postscan_reorder(kt, g, None, vt, spec=spec),
         lambda: mst.packed_fused_postscan_reorder_plain(kt, g, None, vt, spec=spec),
         8 * n + gbytes + 16 * n, sort_cid_ms),
        ("packed_tile_positions", "packed_tile_positions.cu",
         "src/repro/kernels/multisplit_tile.py:706",
         lambda: mst.packed_tile_positions(kt, g, spec=spec),
         lambda: mst.packed_tile_positions_plain(kt, g, spec=spec), 4 * n + gbytes + 4 * n,
         sort_cid_ms),
        # B10 key-value: ids, keys and values read; keys_r, vals_r and dest
        # written, 24 bytes a key; the yardstick is the postscans' sort
        ("tile_reorder", "tile_reorder.cu", "src/repro/kernels/multisplit_tile.py:1061",
         lambda: mst.tile_reorder(ids, kt, vt, m), lambda: mst.tile_reorder_plain(ids, kt, vt, m),
         24 * n, sort_cid_ms),
    ]
    kernels = []
    for name, src, replaces, kern, plain, nbytes, lib_ms in rows:
        ms_k = cuda_ms(kern)
        ms_p = cuda_ms(plain, reps=3, inner=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "bitwise": errs[name] == 0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        before = f"when added: {FLAT_MS_BEFORE[name]:.4f} ms; " if name in FLAT_MS_BEFORE else ""
        library = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (no single PyTorch call)"
        label = even if name == "spec_bucket_ids" else spec
        log("times", f"{name}: {ms_k:.4f} ms ({before}bound {bound:.4f} ms = {nbytes / 2**20:.0f} "
                     f"MiB / 3.35 TB/s, {bound / ms_k:.1%} of it), plain {ms_p:.2f} ms, library "
                     f"{library}; {launches[name]} launches on the main paths [n = 2^25, {label}, "
                     f"tiles 8192 x 4096; {smi}]")

    # the two families side by side, kernel by kernel, on the same inputs
    def family_pair(label, onehot_fn, packed_fn) -> str:
        a, b = cuda_ms(onehot_fn), cuda_ms(packed_fn)
        return f"{label} {a:.4f} / {b:.4f} ms ({b / a:.3f}x)"

    for m_ in (8, 32, 256):
        spec_ = main_spec(m_)
        g_ = st.global_scan(mst.spec_tile_histograms(kt, spec_))
        log("times", f"onehot / packed, flat m = {m_}, labels in the kernels: " + "; ".join([
            family_pair("K1 / K1p", lambda: mst.spec_tile_histograms(kt, spec_),
                        lambda: mst.packed_tile_histograms(kt, spec=spec_)),
            family_pair("K3 / K3p", lambda: mst.spec_tile_positions(kt, g_, spec_),
                        lambda: mst.packed_tile_positions(kt, g_, spec=spec_)),
            family_pair("K2 / K2p key-value",
                        lambda: mst.spec_fused_postscan_reorder(kt, g_, vt, spec_),
                        lambda: mst.packed_fused_postscan_reorder(kt, g_, None, vt, spec=spec_)),
        ]) + f" [n = 2^25, tiles 8192 x 4096; {smi}]")
    del g_
    log("times", "onehot / packed, flat m = 256, labels from the ids strip: " + "; ".join([
        family_pair("K1 / K1p", lambda: mst.tile_histograms(ids, m),
                    lambda: mst.packed_tile_histograms(ids, num_buckets=m)),
        family_pair("K3 / K3p", lambda: mst.tile_positions(ids, g, m),
                    lambda: mst.packed_tile_positions(ids, g, num_buckets=m)),
        family_pair("K2 / K2p key-value", lambda: mst.fused_postscan_reorder(ids, g, kt, vt, m),
                    lambda: mst.packed_fused_postscan_reorder(ids, g, kt, vt, num_buckets=m)),
    ]) + f" [n = 2^25, tiles 8192 x 4096; {smi}]")
    del g, cid, ids

    # the segmented kernels at S1's shape: 8192 tiles of 4096, s = 64, m = 32
    s, m1 = 64, spec1.num_buckets
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    hist1 = mst.seg_spec_tile_histograms_plain(kt, seg_main, spec1, s)
    g1 = st.global_scan(hist1)
    # K1s writes its whole (L, s·m) row; K2s and K3s need only the bases
    # their keys hit, one for each distinct (tile, cid): the nonzeros of H
    hbytes = 4 * l_main * s * m1
    gbytes_hit = 4 * int(torch.count_nonzero(hist1))
    del hist1
    cid1 = (torch.arange(l_main, device=dev, dtype=torch.int32)[:, None] * (s * m1)
            + seg_main * m1 + spec1.emit(kt)).view(-1)
    sort1_ms = cuda_ms(lambda: torch.sort(cid1, stable=True))
    log("times", f"G bases the S1 keys hit: {gbytes_hit // 4} of {hbytes // 4} "
                 f"({gbytes_hit / 2**20:.2f} of {hbytes / 2**20:.0f} MiB)")
    bincount1_ms = cuda_ms(lambda: torch.bincount(cid1, minlength=l_main * s * m1))
    ids1 = mst.spec_bucket_ids_plain(kt, spec1)
    seg_rows = [
        ("seg_spec_tile_histograms", "seg_tile_histograms.cu",
         "src/repro/kernels/multisplit_tile.py:512",
         lambda: mst.seg_spec_tile_histograms(kt, seg_main, spec1, s),
         lambda: mst.seg_spec_tile_histograms_plain(kt, seg_main, spec1, s),
         4 * n + 4 * n + hbytes, bincount1_ms),
        ("seg_spec_fused_postscan_reorder", "seg_fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:587",
         lambda: mst.seg_spec_fused_postscan_reorder(kt, seg_main, g1, vt, spec1, s),
         lambda: mst.seg_spec_fused_postscan_reorder_plain(kt, seg_main, g1, vt, spec1, s),
         4 * n + 4 * n + gbytes_hit + 4 * n + 16 * n, sort1_ms),
        ("seg_spec_tile_positions", "seg_tile_positions.cu",
         "src/repro/kernels/multisplit_tile.py:544",
         lambda: mst.seg_spec_tile_positions(kt, seg_main, g1, spec1, s),
         lambda: mst.seg_spec_tile_positions_plain(kt, seg_main, g1, spec1, s),
         4 * n + 4 * n + gbytes_hit + 4 * n, sort1_ms),
        # the ids kernels on the same labels, materialised
        ("seg_tile_histograms", "seg_tile_histograms.cu",
         "src/repro/kernels/multisplit_tile.py:227",
         lambda: mst.seg_tile_histograms(ids1, seg_main, m1, s),
         lambda: mst.seg_tile_histograms_plain(ids1, seg_main, m1, s),
         4 * n + 4 * n + hbytes, bincount1_ms),
        ("seg_fused_postscan_reorder", "seg_fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:303",
         lambda: mst.seg_fused_postscan_reorder(ids1, seg_main, g1, kt, vt, m1, s),
         lambda: mst.seg_fused_postscan_reorder_plain(ids1, seg_main, g1, kt, vt, m1, s),
         4 * n + 4 * n + 4 * n + gbytes_hit + 4 * n + 16 * n, sort1_ms),
        ("seg_tile_positions", "seg_tile_positions.cu",
         "src/repro/kernels/multisplit_tile.py:259",
         lambda: mst.seg_tile_positions(ids1, seg_main, g1, m1, s),
         lambda: mst.seg_tile_positions_plain(ids1, seg_main, g1, m1, s),
         4 * n + 4 * n + gbytes_hit + 4 * n, sort1_ms),
    ]
    for name, src, replaces, kern, plain, nbytes, lib_ms in seg_rows:
        ms_k = cuda_ms(kern)
        ms_p = cuda_ms(plain, reps=3, inner=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "bitwise": errs[name] == 0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        log("times", f"{name}: {ms_k:.4f} ms (bound {bound:.4f} ms = {nbytes / 2**20:.0f} MiB / "
                     f"3.35 TB/s, {bound / ms_k:.1%} of it), plain {ms_p:.2f} ms, library "
                     f"{lib_ms:.4f} ms; {launches[name]} launches on the segmented paths "
                     f"[S1: n = 2^25, s = 64, {spec1}, m_eff = 2048, tiles 8192 x 4096; {smi}]")
    # the flat kernels at S1's m and keys: what the segment layer adds
    g32 = st.global_scan(mst.spec_tile_histograms_plain(kt, spec1))
    same_m = {
        "K1": cuda_ms(lambda: mst.spec_tile_histograms(kt, spec1)),
        "K2 key-value": cuda_ms(lambda: mst.spec_fused_postscan_reorder(kt, g32, vt, spec1)),
        "K3": cuda_ms(lambda: mst.spec_tile_positions(kt, g32, spec1)),
    }
    log("times", "flat kernels at S1's m = 32 on the same keys: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in same_m.items()) + f" [{smi}]")
    seg_kw = dict(seg_tiled=seg_main, num_segments=s)
    log("times", "onehot / packed at S1, labels in the kernels: " + "; ".join([
        family_pair("K1s / K1p", lambda: mst.seg_spec_tile_histograms(kt, seg_main, spec1, s),
                    lambda: mst.packed_tile_histograms(kt, spec=spec1, **seg_kw)),
        family_pair("K3s / K3p", lambda: mst.seg_spec_tile_positions(kt, seg_main, g1, spec1, s),
                    lambda: mst.packed_tile_positions(kt, g1, spec=spec1, **seg_kw)),
        family_pair("K2s / K2p key-value",
                    lambda: mst.seg_spec_fused_postscan_reorder(kt, seg_main, g1, vt, spec1, s),
                    lambda: mst.packed_fused_postscan_reorder(kt, g1, None, vt, spec=spec1,
                                                              **seg_kw)),
    ]) + f" [S1: n = 2^25, s = 64, m = 32, tiles 8192 x 4096; {smi}]")
    log("times", "onehot / packed at S1, labels from the ids strip: " + "; ".join([
        family_pair("K1s / K1p", lambda: mst.seg_tile_histograms(ids1, seg_main, m1, s),
                    lambda: mst.packed_tile_histograms(ids1, num_buckets=m1, **seg_kw)),
        family_pair("K3s / K3p", lambda: mst.seg_tile_positions(ids1, seg_main, g1, m1, s),
                    lambda: mst.packed_tile_positions(ids1, g1, num_buckets=m1, **seg_kw)),
        family_pair("K2s / K2p key-value",
                    lambda: mst.seg_fused_postscan_reorder(ids1, seg_main, g1, kt, vt, m1, s),
                    lambda: mst.packed_fused_postscan_reorder(ids1, g1, kt, vt, num_buckets=m1,
                                                              **seg_kw)),
    ]) + f" [S1: n = 2^25, s = 64, m = 32, tiles 8192 x 4096; {smi}]")
    del cid1, g1, g32, ids1, seg_kw

    # the fused two-digit kernels at F1's shapes: 2^25 keys in 4096 tiles of
    # 8192, the pair (0, 16, 8), G of (4096, 65536)
    kt8, vt8 = keys.view(-1, t_fused), values.view(-1, t_fused)
    l8, spec16 = kt8.shape[0], ops.BitfieldSpec(0, 16)
    hist16 = mst.fused2_tile_histograms_plain(kt8, spec=spec16)
    g16 = st.global_scan(hist16)
    h16_bytes = 4 * hist16.numel()
    nnz16 = int(torch.count_nonzero(hist16))             # the G bases the keys hit
    del hist16
    cid16 = (torch.arange(l8, device=dev, dtype=torch.int64)[:, None] * 65536
             + spec16.emit(kt8).long()).view(-1)
    sort16_ms = cuda_ms(lambda: torch.sort(cid16, stable=True))
    bincount16_ms = cuda_ms(lambda: torch.bincount(cid16, minlength=l8 * 65536))
    del cid16
    log("times", f"fused2 at F1's shape: H {h16_bytes / 2**30:.2f} GiB, {nnz16} of its "
                 f"{h16_bytes // 4} bases hit by the keys")
    fkw = dict(spec=spec16, split=8)
    fused_rows = [
        ("fused2_tile_histograms", "fused2_tile_histograms.cu",
         "src/repro/kernels/multisplit_tile.py:863",
         lambda: mst.fused2_tile_histograms(kt8, spec=spec16),
         lambda: mst.fused2_tile_histograms_plain(kt8, spec=spec16), 4 * n + h16_bytes,
         bincount16_ms),
        ("fused2_fused_postscan_reorder", "fused2_fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:973",
         lambda: mst.fused2_fused_postscan_reorder(kt8, g16, vt8, **fkw),
         lambda: mst.fused2_fused_postscan_reorder_plain(kt8, g16, vt8, **fkw),
         8 * n + 4 * nnz16 + 16 * n, sort16_ms),
        ("fused2_tile_positions", "fused2_tile_positions.cu",
         "src/repro/kernels/multisplit_tile.py:909",
         lambda: mst.fused2_tile_positions(kt8, g16, **fkw),
         lambda: mst.fused2_tile_positions_plain(kt8, g16, **fkw), 4 * n + 4 * nnz16 + 4 * n,
         sort16_ms),
    ]
    for name, src, replaces, kern, plain, nbytes, lib_ms in fused_rows:
        ms_k = cuda_ms(kern)
        ms_p = cuda_ms(plain, reps=3, inner=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "bitwise": errs[name] == 0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        log("times", f"{name}: {ms_k:.4f} ms (bound {bound:.4f} ms = {nbytes / 2**20:.0f} MiB / "
                     f"3.35 TB/s, {bound / ms_k:.1%} of it), plain {ms_p:.2f} ms, library "
                     f"{lib_ms:.4f} ms; {launches[name]} launches on the fused paths [F1: n = 2^25, "
                     f"pair (0, 16, 8), sub_bits {mst.CUDA_SUB_BITS}, onehot, tiles {l8} x {t_fused}; "
                     f"{smi}]")
    # the stage width and the family, K2f and K3f on the same inputs
    for fam in ("onehot", "packed"):
        parts = []
        for label, fn in (("K2f key-value", lambda sb: mst.fused2_fused_postscan_reorder(
                                 kt8, g16, vt8, family=fam, sub_bits=sb, **fkw)),
                          ("K3f", lambda sb: mst.fused2_tile_positions(
                                 kt8, g16, family=fam, sub_bits=sb, **fkw))):
            a, b = cuda_ms(lambda: fn(4)), cuda_ms(lambda: fn(8))
            parts.append(f"{label} {a:.4f} / {b:.4f} ms ({b / a:.3f}x)")
        log("times", f"fused2 sub_bits 4 / 8, {fam}: " + "; ".join(parts)
            + f" [F1: n = 2^25, tiles {l8} x {t_fused}; {smi}]")
    del g16

    top8 = ops.from_fn(lambda u: (bits(u) >> 24) & 255, 256, "top8")
    check_result("top-byte callable against DeltaSpec(256, 2^32)",
                 ops.multisplit(keys, top8, values, device=dev),
                 ops.multisplit(keys, spec, values, device=dev), fields)
    e2e = {
        "multisplit kv bms m=256": (lambda: ops.multisplit(keys, spec, values, method="bms", device=dev),
                                    lambda: rb_sort_multisplit(keys, spec, values)),
        "multisplit bms m=256": (lambda: ops.multisplit(keys, spec, method="bms", device=dev),
                                 lambda: rb_sort_multisplit(keys, spec)),
        "multisplit dms m=32": (lambda: ops.multisplit(keys, main_spec(32), method="dms", device=dev),
                                lambda: rb_sort_multisplit(keys, main_spec(32))),
        "histogram m=256": (lambda: ops.histogram(keys, spec, device=dev),
                            lambda: torch.bincount(spec.emit(keys).long(), minlength=m)),
        "radix_sort r=8": (lambda: ops.radix_sort(keys, device=dev),
                           lambda: torch.sort(bits(keys) ^ torch.iinfo(torch.int32).min, stable=True)),
        "radix_sort kv r=8": (lambda: ops.radix_sort(keys, values, device=dev),
                              lambda: torch.sort(bits(keys) ^ torch.iinfo(torch.int32).min, stable=True)),
        # the escape hatch: DeltaSpec(256, 2^32)'s labels (the top byte) as a callable
        "multisplit kv bms m=256, the same labels as a callable": (
            lambda: ops.multisplit(keys, top8, values, method="bms", device=dev),
            lambda: rb_sort_multisplit(keys, spec, values)),
        "multisplit kv bms m=256, hash callable": (
            lambda: ops.multisplit(keys, hashes[256], values, method="bms", device=dev),
            lambda: rb_sort_multisplit(keys, hashes[256], values)),
        "delta-stepping multisplit kv wms m=10 (callable)": (
            lambda: ops.multisplit(dist, sssp, verts, method="wms", device=dev),
            lambda: rb_sort_multisplit(dist, sssp, verts)),
        "histogram m=256, hash callable": (
            lambda: ops.histogram(keys, hashes[256], device=dev),
            lambda: torch.bincount(hashes[256].emit(keys).long(), minlength=256)),
    }
    s1_t = torch.from_numpy(s1_starts).to(dev)
    s2_t = torch.from_numpy(s2_starts).to(dev)
    s3_t = torch.from_numpy(s3_starts).to(dev)

    def combined_sort(k, starts_t, spec_):
        seg = st.segment_ids_from_starts(starts_t, k.shape[0])
        return torch.sort(seg.long() * spec_.num_buckets + spec_.emit(k).long(), stable=True)

    def seg_key_sort(k, starts_t):
        seg = st.segment_ids_from_starts(starts_t, k.shape[0])
        return torch.sort((seg.long() << 32) | (bits(k).long() & 0xFFFFFFFF), stable=True)

    e2e.update({
        "S1 segmented_multisplit kv bms s=64 m=32": (
            lambda: ops.segmented_multisplit(keys, spec1, s1_t, values, method="bms", device=dev),
            lambda: combined_sort(keys, s1_t, spec1)),
        "S1 segmented_multisplit kv bms s=64 m=32, hash callable": (
            lambda: ops.segmented_multisplit(keys, hash32, s1_t, values, method="bms", device=dev),
            lambda: combined_sort(keys, s1_t, hash32)),
        "S2 segmented_radix_sort s=16 r=8": (
            lambda: ops.segmented_radix_sort(keys, s2_t, device=dev),
            lambda: seg_key_sort(keys, s2_t)),
        "S2 segmented_radix_sort kv s=16 r=8": (
            lambda: ops.segmented_radix_sort(keys, s2_t, values, device=dev),
            lambda: seg_key_sort(keys, s2_t)),
        "S3 routing positions_only s=256 m=64 n=2^20": (
            lambda: ops.segmented_multisplit(ids3_flat, ops.IdentitySpec(64), s3_t, method="dms",
                                             mode="positions_only", device=dev),
            lambda: combined_sort(ids3_flat, s3_t, ops.IdentitySpec(64))),
        # the serving step's own input: starts as a host numpy array
        "S3 routing, host starts": (
            lambda: ops.segmented_multisplit(ids3_flat, ops.IdentitySpec(64), s3_starts,
                                             method="dms", mode="positions_only", device=dev),
            lambda: combined_sort(ids3_flat, s3_t, ops.IdentitySpec(64))),
    })
    torch.cuda.reset_peak_memory_stats()
    for what, (fn, lib) in e2e.items():
        ms_e, ms_l = cuda_ms(fn, reps=5, inner=1), cuda_ms(lib, reps=5, inner=1)
        n_keys = n3 if what.startswith("S3") else n
        log("times", f"end to end {what}: {ms_e:.3f} ms = {n_keys / ms_e / 1e6:.2f} Gkeys/s; "
                     f"library (stable torch.sort / bincount; for S1-S3 the oracle's sort of the "
                     f"combined key) {ms_l:.3f} ms [{smi}]")
    # the two families end to end, in turns on the same inputs
    for what, fn in ref_ms.items():
        ms_o = cuda_ms(lambda: fn(None), reps=5, inner=1)
        ms_p = cuda_ms(lambda: fn("packed"), reps=5, inner=1)
        n_keys = n3 if what.startswith("S3") else n
        log("times", f"end to end onehot / packed, {what}: {ms_o:.3f} / {ms_p:.3f} ms "
                     f"({ms_p / ms_o:.3f}x) = {n_keys / ms_o / 1e6:.2f} / {n_keys / ms_p / 1e6:.2f} "
                     f"Gkeys/s [{smi}]")
    # where the time of one key-value bms multisplit (m = 256) goes, stage by stage
    from repro_torch.core.pipeline import make_plan

    plan = make_plan(n, m, method="bms", key_value=True, backend="cuda", bucket_fn=spec)
    hist = plan.prescan(kt, None)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, None, vt)
    stage_ms = {
        "prescan K1": cuda_ms(lambda: plan.prescan(kt, None)),
        "global scan": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K2": cuda_ms(lambda: plan.postscan(g, kt, None, vt)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of multisplit kv bms m=256: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del hist, g, src_k, src_v, pos
    # the same labels through the escape hatch: the user's function, the
    # int32 strip, then K1 and K2 on the ids
    plan = make_plan(n, m, method="bms", key_value=True, backend="cuda", bucket_fn=top8)
    ids_t = plan._host_labels(keys).view(-1, plan.tile)
    hist = plan.prescan(None, ids_t)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, ids_t, vt)
    stage_ms = {
        "the user's function": cuda_ms(lambda: top8.fn(keys)),
        "labels as an int32 strip (function + cast)": cuda_ms(lambda: plan._host_labels(keys)),
        "prescan K1 on ids": cuda_ms(lambda: plan.prescan(None, ids_t)),
        "global scan": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K2 on ids": cuda_ms(lambda: plan.postscan(g, kt, ids_t, vt)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of multisplit kv bms m=256, the top-byte callable: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del ids_t, hist, g, src_k, src_v, pos
    # where the time of one S1 key-value bms segmented multisplit goes
    plan = make_plan(n, m1, method="bms", key_value=True, backend="cuda", bucket_fn=spec1,
                     segments=s)
    hist = plan.prescan(kt, None, seg_main)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, None, vt, seg_main)
    stage_ms = {
        "segment ids (prefix sum of start marks)": cuda_ms(lambda: st.segment_ids_from_starts(s1_t, n)),
        "prescan K1s": cuda_ms(lambda: plan.prescan(kt, None, seg_main)),
        "global scan (8192 x 2048)": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K2s": cuda_ms(lambda: plan.postscan(g, kt, None, vt, seg_main)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of S1 segmented multisplit kv bms s=64 m=32: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del hist, g, src_k, src_v, pos, seg_main
    # the device stages of one S3 routing launch, each timed alone: their
    # sum against the end-to-end calls above is what the host adds
    spec3 = ops.IdentitySpec(64)
    plan = make_plan(n3, 64, method="dms", backend="cuda", bucket_fn=spec3, segments=256,
                     mode="positions_only")
    seg3 = st.segment_ids_from_starts(s3_t, n3)
    ids3_t, seg3_t = ids3_flat.view(-1, plan.tile), seg3.view(-1, plan.tile)
    hist = plan.prescan(ids3_t, None, seg3_t)
    g = st.global_scan(hist)
    pos = plan.postscan(g, ids3_t, None, None, seg3_t)[2]
    stage_ms = {
        "segment ids": cuda_ms(lambda: st.segment_ids_from_starts(s3_t, n3)),
        "prescan K1s": cuda_ms(lambda: plan.prescan(ids3_t, None, seg3_t)),
        "global scan (256 x 16384)": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K3s": cuda_ms(lambda: plan.postscan(g, ids3_t, None, None, seg3_t)),
        "counts, starts, segment-local perm": cuda_ms(lambda: (
            st.exclusive_rows(hist.sum(0, dtype=torch.int32).view(256, 64)),
            pos.reshape(-1) - s3_t.index_select(0, seg3))),
    }
    log("times", "device stages of S3 routing (each alone): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.4f} ms [{smi}]")
    del hist, g, pos, seg3
    # fused against unfused, end to end in turns on the same inputs, and the
    # stages of one fused pair against those of one single-digit pass
    from repro_torch.core.pipeline import RadixPipeline

    f3_t = torch.from_numpy(f3_starts).to(dev)
    keys_s, values_s = keys[:N_FUSED_SMALL], values[:N_FUSED_SMALL]
    pairs = [
        ("F1 radix_sort kv bms r=8", N_MAIN,
         lambda: ops.radix_sort(keys, values, device=dev),
         lambda: ops.radix_sort(keys, values, fuse_digits=True, device=dev)),
        ("F1 radix_sort dms r=8, key-only", N_MAIN,
         lambda: ops.radix_sort(keys, method="dms", device=dev),
         lambda: ops.radix_sort(keys, method="dms", fuse_digits=True, device=dev)),
        ("F1 radix_sort kv bms r=8, family=packed", N_MAIN,
         lambda: ops.radix_sort(keys, values, family="packed", device=dev),
         lambda: ops.radix_sort(keys, values, family="packed", fuse_digits=True, device=dev)),
        ("F2 radix_sort kv bms r=7, n=2^22", N_FUSED_SMALL,
         lambda: ops.radix_sort(keys_s, values_s, radix_bits=7, device=dev),
         lambda: ops.radix_sort(keys_s, values_s, radix_bits=7, fuse_digits=True, device=dev)),
        ("F3 segmented_radix_sort kv bms r=8 s=16, n=2^22", N_FUSED_SMALL,
         lambda: ops.segmented_radix_sort(keys_s, f3_t, values_s, device=dev),
         lambda: ops.segmented_radix_sort(keys_s, f3_t, values_s, fuse_digits=True, device=dev)),
    ]
    for what, n_keys, plain_fn, fused_fn in pairs:
        ms_u, ms_f = cuda_ms(plain_fn, reps=5, inner=1), cuda_ms(fused_fn, reps=5, inner=1)
        ms_u2 = cuda_ms(plain_fn, reps=5, inner=1)
        log("times", f"end to end unfused / fused, {what}: {ms_u:.3f} (again {ms_u2:.3f}) / "
                     f"{ms_f:.3f} ms ({ms_f / ms_u:.3f}x) = {n_keys / ms_u / 1e6:.2f} / "
                     f"{n_keys / ms_f / 1e6:.2f} Gkeys/s [{smi}]")
    variants = {
        "sub_bits 4": RadixPipeline(N_MAIN, key_value=True, backend="cuda", fuse_digits=True,
                                    sub_bits=4),
        f"sub_bits 8 (the default)": RadixPipeline(N_MAIN, key_value=True, backend="cuda",
                                                   fuse_digits=True),
        "tile 4096": RadixPipeline(N_MAIN, key_value=True, backend="cuda", fuse_digits=True,
                                   tile=4096),
    }
    log("times", "end to end F1 radix_sort kv bms r=8, fused: " + "; ".join(
        f"{k} {cuda_ms(lambda p=p: p(keys, values), reps=5, inner=1):.3f} ms"
        for k, p in variants.items()) + f" [{smi}]")
    del variants

    def pair_stages(plan, kt_, vt_, seg_=None):
        """Each stage of one sweep of ``plan`` timed alone."""
        hist_ = plan.prescan(kt_, None, seg_)
        g_ = st.global_scan(hist_)
        src_k_, src_v_, pos_, _ = plan.postscan(g_, kt_, None, vt_, seg_)
        n_ = kt_.numel()
        out = {
            "prescan": cuda_ms(lambda: plan.prescan(kt_, None, seg_), reps=5),
            f"global scan ({hist_.shape[0]} x {hist_.shape[1]}, {4 * hist_.numel() / 2**30:.3f} GiB)":
                cuda_ms(lambda: st.global_scan(hist_), reps=5),
            "postscan": cuda_ms(lambda: plan.postscan(g_, kt_, None, vt_, seg_), reps=5),
            "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
                lambda idx: (st.scatter(src_k_, idx, n_), st.scatter(src_v_, idx, n_)))(
                    pos_.reshape(-1).long()), reps=5),
        }
        del hist_, g_, src_k_, src_v_, pos_
        return out

    for what, pipe, kk, vv, seg_t in (
        ("F1 unfused, one 8-bit pass (K1, K2)",
         RadixPipeline(N_MAIN, key_value=True, backend="cuda"), keys, values, None),
        ("F1 fused, one 16-bit pair (K1f, K2f)",
         RadixPipeline(N_MAIN, key_value=True, backend="cuda", fuse_digits=True), keys, values, None),
        ("F3 unfused, one 8-bit pass (K1s, K2s)",
         RadixPipeline(N_FUSED_SMALL, key_value=True, backend="cuda", segments=16),
         keys_s, values_s, f3_t),
        ("F3 fused, one 16-bit pair (K1f, K2f)",
         RadixPipeline(N_FUSED_SMALL, key_value=True, backend="cuda", segments=16, fuse_digits=True),
         keys_s, values_s, f3_t),
    ):
        t_ = pipe.tile
        seg_tiled = None
        if seg_t is not None:
            seg_tiled = st.segment_ids_from_starts(seg_t, kk.shape[0]).view(-1, t_)
        stage_ms = pair_stages(pipe.plans[0], kk.view(-1, t_), vv.view(-1, t_), seg_tiled)
        log("times", f"stages of {what}, tiles of {t_}: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in stage_ms.items())
            + f"; sum {sum(stage_ms.values()):.4f} ms, {pipe.n_sweeps} sweeps a sort [{smi}]")
    del keys_s, values_s
    # the batched layout and the unfused baselines end to end, each in turns
    # with what it is measured against (a, b, a) on the same inputs
    turns = [
        ("B1 batched_multisplit kv bms m=256, (8, 2^22)", N_MAIN,
         lambda: core_ms.batched_multisplit(kb, spec, vb, device=dev),
         "the loop of 8 flat ops.multisplit",
         lambda: [ops.multisplit(kb[r], spec, vb[r], device=dev) for r in range(b1)]),
        ("B1 torch.vmap(ops.multisplit_key_value) bms m=256, (8, 2^22)", N_MAIN,
         lambda: vmap_kv(kb, vb, spec, device=dev), "batched_multisplit",
         lambda: core_ms.batched_multisplit(kb, spec, vb, device=dev)),
        ("B1 torch.vmap(ops.multisplit) dms m=32, (8, 2^22)", N_MAIN,
         lambda: vmap_ms(kb, main_spec(32), method="dms", device=dev),
         "the loop of 8 flat ops.multisplit",
         lambda: [ops.multisplit(kb[r], main_spec(32), method="dms", device=dev) for r in range(b1)]),
        ("B2 batched_multisplit kv bms m=32, (256, 2^17 + 37)", 256 * n_b2,
         lambda: core_ms.batched_multisplit(kb2, main_spec(32), vb2, device=dev),
         "the loop of 256 flat ops.multisplit",
         lambda: [ops.multisplit(kb2[r], main_spec(32), vb2[r], device=dev) for r in range(256)]),
        ("B3 batched radix_sort kv r=8, (8, 2^22)", N_MAIN,
         lambda: ops.radix_sort(kb, vb, device=dev), "the loop of 8 flat ops.radix_sort",
         lambda: [ops.radix_sort(kb[r], vb[r], device=dev) for r in range(b1)]),
        ("multisplit_unfused kv bms m=256, n=2^25", N_MAIN,
         lambda: core_ms.multisplit_unfused(keys, spec, values, device=dev),
         "the fused plan (ops.multisplit)", lambda: ops.multisplit(keys, spec, values, device=dev)),
        ("multisplit_unfused bms key-only m=256, n=2^25", N_MAIN,
         lambda: core_ms.multisplit_unfused(keys, spec, device=dev),
         "the fused plan (ops.multisplit)", lambda: ops.multisplit(keys, spec, device=dev)),
        ("radix_sort_per_pass kv r=8, n=2^25", N_MAIN,
         lambda: core_sort.radix_sort_per_pass(keys, values, device=dev), "radix_sort",
         lambda: ops.radix_sort(keys, values, device=dev)),
    ]
    for what, n_keys, fn, other_what, other in turns:
        ms_a, ms_b = cuda_ms(fn, reps=5, inner=1), cuda_ms(other, reps=5, inner=1)
        ms_a2 = cuda_ms(fn, reps=5, inner=1)
        log("times", f"end to end {what}: {ms_a:.3f} (again {ms_a2:.3f}) ms = "
                     f"{n_keys / ms_a / 1e6:.2f} Gkeys/s; {other_what} {ms_b:.3f} ms "
                     f"({ms_a / ms_b:.3f}x) [{smi}]")
    # where the time of one B1 batched key-value bms multisplit goes (m =
    # 256): its grid is the flat call's 8192 tiles; beside the row scan, the
    # same scan as a cumsum along the 8 rows
    from repro_torch.core.pipeline import make_batched_plan

    bplan = make_batched_plan(b1, N_MAIN // b1, m, method="bms", key_value=True, backend="cuda",
                              bucket_fn=spec)
    hist_b = bplan.prescan(kt, None)
    g_b = st.global_scan(hist_b, b1)
    src_k, src_v, pos_b, _ = bplan.postscan(g_b, kt, None, vt)
    h_rows = hist_b.view(b1, -1, m).transpose(1, 2).reshape(b1, -1)
    stage_ms = {
        "prescan K1": cuda_ms(lambda: bplan.prescan(kt, None)),
        "row scan (one cumsum, less each row's base)": cuda_ms(lambda: st.global_scan(hist_b, b1)),
        "beside it: torch.cumsum along the 8 rows": cuda_ms(
            lambda: torch.cumsum(h_rows, 1, dtype=torch.int32)),
        "postscan K2": cuda_ms(lambda: bplan.postscan(g_b, kt, None, vt)),
        "row index + scatter": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(
                st.row_index(pos_b, b1))),
    }
    log("times", "stages of B1 batched_multisplit kv bms m=256, (8, 2^22): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del hist_b, g_b, src_k, src_v, pos_b, h_rows
    # where the time of one unfused key-value bms multisplit goes (m = 256,
    # tiles of 4096: the bms tile)
    ids_u = spec(keys).to(torch.int32).view(-1, 4096)
    hist_u = mst.tile_histograms(ids_u, m)
    g_u = st.global_scan(hist_u)
    pos_u = mst.tile_positions(ids_u, g_u, m)
    src_u, pos_r_u, _ = mst.tile_reorder(ids_u, kt, pos_u, m)
    stage_ms = {
        "labels (the spec on the keys, as int32)": cuda_ms(lambda: spec(keys).to(torch.int32)),
        "prescan K1 on ids": cuda_ms(lambda: mst.tile_histograms(ids_u, m)),
        "global scan": cuda_ms(lambda: st.global_scan(hist_u)),
        "pass 1 K3 on ids": cuda_ms(lambda: mst.tile_positions(ids_u, g_u, m)),
        "pass 2 B10 (keys, destinations as values)": cuda_ms(lambda: mst.tile_reorder(ids_u, kt, pos_u, m)),
        "pass 3 B10 (values, key-only)": cuda_ms(lambda: mst.tile_reorder(ids_u, vt, None, m)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_u, idx, n), st.scatter(src_u, idx, n)))(
                pos_r_u.reshape(-1).long())),
    }
    log("times", "stages of multisplit_unfused kv bms m=256: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.4f} ms [{smi}]")
    del ids_u, hist_u, g_u, pos_u, src_u, pos_r_u, kb2, vb2
    log("times", f"peak device memory of the timed runs above the inputs: "
                 f"{(torch.cuda.max_memory_allocated() - base_mem) / 2**30:.2f} GiB")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
