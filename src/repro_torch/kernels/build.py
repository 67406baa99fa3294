"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). All sources build at once, one ``nvcc`` process each, started
together. Libraries land in ``build/repro_torch/`` at the repository root,
named by a hash of their sources and flags, so an edited source never loads
a stale build. A failed build raises :class:`KernelBuildError` with the
compiler's output; nothing falls back. :func:`launch_report` asks a
launcher what it would launch with (stages, shared bytes, blocks an SM,
registers) and launches nothing. Beside :func:`load` sit the
helpers every wrapper launches through: :func:`on_cuda` picks the kernel or
the plain version by the tensor's device, :func:`stream` is the current CUDA
stream, and :func:`raise_on` turns a failed launch into
:class:`KernelLaunchError`.

The flags never include ``--use_fast_math``: EvenSpec labels need IEEE
float32 division to match the JAX package bitwise, and flash attention's
softmax takes ``exp2f``, not its fast approximation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

SOURCES = (
    "tile_histograms", "tile_positions", "fused_postscan_reorder",
    "seg_tile_histograms", "seg_tile_positions", "seg_fused_postscan_reorder",
    "spec_bucket_ids",
    "packed_tile_histograms", "packed_tile_positions", "packed_fused_postscan_reorder",
    "fused2_tile_histograms", "fused2_tile_positions", "fused2_fused_postscan_reorder",
    "tile_reorder",
    "flash_attention_f32_sm90", "flash_attention_sm90",
)
HEADERS = ("multisplit_common.cuh", "multisplit_segmented.cuh", "multisplit_fused2.cuh",
           "multisplit_sm90.cuh", "flash_attention_sm90.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LABEL_ARGTYPES = [_I, _I, _I, _U, _U, _F, _F, _P, _I, _I]
# entry point -> (C symbol, argtypes); the entry point of each source is
# named after it, and the label arguments come before the stream
ENTRY_POINTS = {
    "tile_histograms": ("ms_tile_histograms", [_P, _P, _I, _I] + _LABEL_ARGTYPES + [_P]),
    "tile_positions": ("ms_tile_positions", [_P, _P, _P, _I, _I] + _LABEL_ARGTYPES + [_P]),
    "fused_postscan_reorder": (
        "ms_fused_postscan_reorder",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    "seg_tile_histograms": (
        "ms_seg_tile_histograms", [_P, _P, _P, _I, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    "seg_tile_positions": (
        "ms_seg_tile_positions", [_P, _P, _P, _P, _I, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    "seg_fused_postscan_reorder": (
        "ms_seg_fused_postscan_reorder",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    "spec_bucket_ids": ("ms_spec_bucket_ids", [_P, _P, _I, _I] + _LABEL_ARGTYPES + [_P]),
    # the packed family: keys, ids and segment strip (either of the last two
    # null), then n_tiles, T, s and the subtile
    "packed_tile_histograms": (
        "ms_packed_tile_histograms", [_P, _P, _P, _P, _I, _I, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    "packed_tile_positions": (
        "ms_packed_tile_positions", [_P, _P, _P, _P, _P, _I, _I, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    "packed_fused_postscan_reorder": (
        "ms_packed_fused_postscan_reorder",
        [_P] * 9 + [_I, _I, _I, _I] + _LABEL_ARGTYPES + [_P],
    ),
    # the fused two-digit family: keys and segment strip (null when flat),
    # n_tiles, T, s, the pair's shift and bits, then the stage width and the
    # family (1 = packed) of the postscans; no label arguments
    "fused2_tile_histograms": (
        "ms_fused2_tile_histograms", [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "fused2_tile_positions": (
        "ms_fused2_tile_positions", [_P] * 4 + [_I] * 7 + [_P],
    ),
    "fused2_fused_postscan_reorder": (
        "ms_fused2_fused_postscan_reorder", [_P] * 8 + [_I] * 7 + [_P],
    ),
    # the standalone reorder: ids, keys, values (null when key-only), keys_r,
    # vals_r, dest, then n_tiles, T and m
    "tile_reorder": ("ms_tile_reorder", [_P] * 6 + [_I, _I, _I, _P]),
    # attention: q, k, v and o, then BH, S, hd and causal; float32 as three
    # TF32 products and bfloat16 / float16 (the dtype code), both on the
    # tensor cores
    "flash_attention_f32_sm90": ("ms_flash_attention_f32_sm90", [_P] * 4 + [_I] * 4 + [_P]),
    "flash_attention_sm90": ("ms_flash_attention_sm90", [_P] * 4 + [_I] * 5 + [_P]),
    # the ids-plane entry points of the K2 and K2s sources: m, not a label
    "fused_postscan_reorder_ids": (
        "ms_fused_postscan_reorder_ids", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "seg_fused_postscan_reorder_ids": (
        "ms_seg_fused_postscan_reorder_ids",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
}
# entry point -> its source, where the two names differ
ENTRY_SOURCE = {
    "fused_postscan_reorder_ids": "fused_postscan_reorder",
    "seg_fused_postscan_reorder_ids": "seg_fused_postscan_reorder",
}

# sources whose launchers report instead of launching while asked to
# (``ms_launch_report`` of multisplit_sm90.cuh): the plans' kernels
REPORTING = (
    "tile_histograms", "tile_positions", "fused_postscan_reorder",
    "seg_tile_histograms", "seg_tile_positions", "seg_fused_postscan_reorder",
    "packed_tile_histograms", "packed_tile_positions", "packed_fused_postscan_reorder",
    "fused2_tile_histograms", "fused2_tile_positions", "fused2_fused_postscan_reorder",
)
REPORT_FIELDS = ("stages", "smem", "blocks", "registers", "static_smem", "threads")

_LOCK = threading.Lock()
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}     # source -> wall seconds of its nvcc run
PTXAS_LOG: Dict[str, str] = {}           # source -> nvcc/ptxas report


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
        "the repro_torch CUDA kernels are built from source at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no current library, all in parallel;
    raise on the first failure. Returns source -> library path."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS_LOG[name] = out
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])        # atomic: a library is whole or absent
    if failures:
        raise KernelBuildError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def ptxas_summary(name: str) -> list:
    """One line a kernel of ``name``'s last build: its (mangled) function,
    its registers and shared memory, spill stores and loads, from ``-Xptxas
    -v``; then every ptxas warning (a serialized wgmma among them)."""
    lines, func, spill = [], None, ""
    for line in PTXAS_LOG.get(name, "").splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            func = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif (m := re.search(r"Used (\d+ registers.*)", line)) and func:
            lines.append(f"{func}: {m.group(1)}; {spill}")
            func, spill = None, ""
        elif "warning" in line:
            lines.append(line.strip())
    return lines


def load(name: str):
    """One C entry point (a key of ``ENTRY_POINTS``), its source built on
    first use."""
    with _LOCK:
        fn = _FNS.get(name)
        if fn is None:
            symbol, argtypes = ENTRY_POINTS[name]
            source = ENTRY_SOURCE.get(name, name)
            lib = _LIBS.get(source)
            if lib is None:
                lib = _LIBS[source] = ctypes.CDLL(str(build_all()[source]))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
    return fn


def launch_report(name: str, *args) -> Dict[str, int]:
    """What the entry point ``name`` would launch with for ``args``, without
    launching: the launcher's stages and dynamic shared bytes, the blocks an
    SM the occupancy API allows, the instance's registers and static shared
    bytes, and its threads. The data pointers are never read, so any
    16-byte-aligned address stands for a plane. Only this thread's call
    reports: the slot is the thread's own."""
    fn = load(name)
    source = ENTRY_SOURCE.get(name, name)
    if source not in REPORTING:
        raise ValueError(f"{source}.cu does not report its launches")
    slot = _LIBS[source].ms_launch_report
    slot.argtypes, slot.restype = [_P], None
    out = (ctypes.c_int * len(REPORT_FIELDS))()
    slot(ctypes.addressof(out))
    try:
        err = fn(*args)
    finally:
        slot(None)
    raise_on(err, name)
    return dict(zip(REPORT_FIELDS, out))


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: tensors must lie on the CPU or a CUDA device, got {x.device}")


def stream(x: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def raise_on(err: int, kernel: str) -> None:
    """Raise :class:`KernelLaunchError` for a nonzero CUDA error code."""
    if err != 0:
        raise KernelLaunchError(f"{kernel} kernel launch failed with CUDA error {err}")
