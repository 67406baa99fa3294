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
   float32 keys, NaN and inf keys, bases G above 2^24, ragged tiles.
4. main    — the port's entry points at the paper's size, n = 2^25 uniform
   random 32-bit keys on the cuda backend: ``ops.multisplit`` for
   ``DeltaSpec(m, 2^32)`` (equal widths over the whole key range, so the
   buckets are uniform) for m in {2, 32, 256}, methods bms and dms,
   key-only and key-value; ``ops.histogram``; ``ops.radix_sort`` at r = 8 (4 passes), key-only and
   key-value. Every result is held bitwise against a stable ``torch.sort``
   of the labels (``rb_sort_multisplit``), or of the keys for the sort.
5. launches — every kernel's launch count from the main path's run alone.
6. times   — per kernel: ms, the plain version's ms, the bound (bytes moved
   over 3.35 TB/s, the H100 SXM data-sheet rate) and one PyTorch call as a
   yardstick; end to end: ms and Gkeys/s; peak device memory.

The last lines are the ``nvidia-smi`` line, one JSON line of the kernels
and ``{"ok": true, "device": {...}}``. The script exits non-zero, printing
no result, when no CUDA device is present or a phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_MAIN = 1 << 25
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
SEED = 0


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
    errs = {"spec_tile_histograms": 0, "spec_fused_postscan_reorder": 0, "spec_tile_positions": 0}
    n_checks = 0

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
        log("launches", f"{name}: {count}")
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    # per run: a multisplit launches K1 once and K2 (bms) or K3 (dms) once; a
    # histogram K1 once; a radix sort K1 and K2 once a pass, 4 passes
    expect = {"spec_tile_histograms": 12 + 3 + 8, "spec_fused_postscan_reorder": 6 + 8,
              "spec_tile_positions": 6}
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

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
    rows = [
        ("spec_tile_histograms", "tile_histograms.cu", "src/repro/kernels/multisplit_tile.py:368",
         lambda: mst.spec_tile_histograms(kt, spec),
         lambda: mst.spec_tile_histograms_plain(kt, spec),
         4 * n + gbytes,
         cuda_ms(lambda: torch.bincount(cid, minlength=l_main * m))),
        ("spec_fused_postscan_reorder", "fused_postscan_reorder.cu",
         "src/repro/kernels/multisplit_tile.py:460",
         lambda: mst.spec_fused_postscan_reorder(kt, g, vt, spec),
         lambda: mst.spec_fused_postscan_reorder_plain(kt, g, vt, spec),
         8 * n + gbytes + 16 * n, sort_cid_ms),
        ("spec_tile_positions", "tile_positions.cu", "src/repro/kernels/multisplit_tile.py:396",
         lambda: mst.spec_tile_positions(kt, g, spec),
         lambda: mst.spec_tile_positions_plain(kt, g, spec),
         4 * n + gbytes + 4 * n, sort_cid_ms),
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
        log("times", f"{name}: {ms_k:.4f} ms (bound {bound:.4f} ms = {nbytes / 2**20:.0f} MiB / "
                     f"3.35 TB/s, {bound / ms_k:.1%} of it), plain {ms_p:.2f} ms, library "
                     f"{lib_ms:.4f} ms; {launches[name]} launches on the main path "
                     f"[n = 2^25, {spec}, tiles 8192 x 4096; {smi}]")
    del g, cid

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
    }
    torch.cuda.reset_peak_memory_stats()
    for what, (fn, lib) in e2e.items():
        ms_e, ms_l = cuda_ms(fn, reps=5, inner=1), cuda_ms(lib, reps=5, inner=1)
        log("times", f"end to end {what}: {ms_e:.3f} ms = {n / ms_e / 1e6:.2f} Gkeys/s; "
                     f"library (stable torch.sort / bincount) {ms_l:.3f} ms [{smi}]")
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
