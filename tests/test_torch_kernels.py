"""The kernels' plain versions against the Pallas kernels, bitwise.

On the CPU a kernel wrapper runs its plain version, so these tests hold the
port's K1-K3 contract (``repro_torch.kernels.multisplit_tile``) against
``repro.kernels.ops.spec_*`` in interpret mode, on the same numpy inputs,
wherever the Pallas float32 ``G + rank`` is exact (G < 2^24). Above 2^24
the port is held against numpy instead. The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import identifiers as jid
from repro.kernels import ops as jkops
from repro_torch.convert import convert_spec
from repro_torch.core import identifiers as tid
from repro_torch.core.pipeline.stages import global_scan
import repro_torch.kernels as kernels
from repro_torch.kernels import build, common, flash_attention, multisplit_tile as mst, ops as tkops
from repro_torch.kernels import radix_pass

import _torch_threads

_torch_threads.pin()

CSRC = Path(mst.__file__).resolve().parent / "csrc"


def _keys(dtype, shape, rng, spec):
    if isinstance(spec, jid.IdentitySpec):
        return rng.integers(0, spec.num_buckets, shape).astype(dtype)
    if isinstance(spec, jid.EvenSpec):
        k = rng.uniform(spec.lo - 2, spec.hi + 2, shape).astype(dtype)
        if dtype == np.float32:
            k.reshape(-1)[:4] = [np.nan, np.inf, -np.inf, spec.lo]
        return k
    if dtype == np.float32:
        return rng.uniform(-1e9, 5e9, shape).astype(np.float32)
    if dtype == np.uint32:
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


SPECS = [
    jid.DeltaSpec(2), jid.DeltaSpec(32), jid.DeltaSpec(256, 2**32 - 1),
    jid.BitfieldSpec(0, 8), jid.BitfieldSpec(11, 5),
    jid.RangeSpec((7, 100, 2**20, 2**29)), jid.RangeSpec((0.5, 3e8, 1e9)),
    jid.EvenSpec(-3.7, 11.3, 37), jid.IdentitySpec(32),
]
_DTYPES = (np.uint32, np.int32, np.float32)
_SHAPES = ((1, 128), (4, 512), (3, 200))
# every spec once, key types and shapes in turn; DeltaSpec(32) with every key type
CASES = [
    (spec, np.int32 if isinstance(spec, jid.BitfieldSpec) and i % 3 == 2 else _DTYPES[i % 3],
     _SHAPES[i % 3])
    for i, spec in enumerate(SPECS)
] + [(jid.DeltaSpec(32), dtype, (2, 256)) for dtype in _DTYPES]


def _case(spec, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    keys = _keys(dtype, shape, rng, spec)
    vals = rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    return keys, vals, convert_spec(spec)


def _id(case):
    spec, dtype, shape = case
    return f"{spec.name}-{np.dtype(dtype).name}-{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_histograms_plain_vs_pallas(case):
    spec, dtype, shape = case
    keys, _, tspec = _case(spec, dtype, shape, 1)
    want = jkops.spec_tile_histograms(jnp.asarray(keys), spec, interpret=True)
    _eq(mst.spec_tile_histograms(torch.from_numpy(keys), tspec), want)


def _bases(tspec, keys):
    """G = global scan of the tile histograms (far below 2^24 here)."""
    return global_scan(mst.spec_tile_histograms_plain(torch.from_numpy(keys), tspec))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_positions_plain_vs_pallas(case):
    spec, dtype, shape = case
    keys, _, tspec = _case(spec, dtype, shape, 2)
    g = _bases(tspec, keys)
    want = jkops.spec_tile_positions(jnp.asarray(keys), jnp.asarray(g.numpy()), spec, interpret=True)
    _eq(mst.spec_tile_positions(torch.from_numpy(keys), g, tspec), want)


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_fused_postscan_reorder_plain_vs_pallas(case, key_value):
    spec, dtype, shape = case
    keys, vals, tspec = _case(spec, dtype, shape, 3)
    g = _bases(tspec, keys)
    want = jkops.spec_fused_postscan_reorder(
        jnp.asarray(keys), jnp.asarray(g.numpy()),
        jnp.asarray(vals) if key_value else None, spec, interpret=True,
    )
    got = mst.spec_fused_postscan_reorder(
        torch.from_numpy(keys), g, torch.from_numpy(vals) if key_value else None, tspec
    )
    assert (got[1] is None) == (not key_value)
    for a, b in zip(got, want):
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype
            _eq(a, b)


def _numpy_positions(ids: np.ndarray, g: np.ndarray) -> np.ndarray:
    """G[l, b] + (number of earlier keys of bucket b in tile l), in int64."""
    out = np.empty(ids.shape, np.int64)
    for l, row in enumerate(ids):
        seen = {}
        for i, b in enumerate(row):
            out[l, i] = int(g[l, b]) + seen.get(b, 0)
            seen[b] = seen.get(b, 0) + 1
    return out


@pytest.mark.parametrize("offset", [(1 << 24) + 1, (1 << 30) + 3])
def test_bases_above_2_24_exact(offset):
    """The Pallas onehot kernels add G and the rank in float32, wrong from
    2^24 on (ROADMAP §C). The port's int32 bodies are exact: held against
    numpy, with distinct destinations."""
    rng = np.random.default_rng(offset % 97)
    spec = tid.DeltaSpec(8, 2**32 - 1)
    keys = rng.integers(0, 2**32, (3, 256), dtype=np.uint64).astype(np.uint32)
    kt = torch.from_numpy(keys)
    g = global_scan(mst.spec_tile_histograms_plain(kt, spec)) + offset
    want = _numpy_positions(spec.emit(kt).numpy(), g.numpy())
    pos = mst.spec_tile_positions(kt, g, spec)
    np.testing.assert_array_equal(pos.numpy(), want)
    keys_r, _, pos_r, perm = mst.spec_fused_postscan_reorder(kt, g, None, spec)
    np.testing.assert_array_equal(perm.numpy(), want)
    assert np.unique(pos_r.numpy()).size == pos_r.numel()
    np.testing.assert_array_equal(np.sort(pos_r.numpy(), axis=1), np.sort(want, axis=1))


def test_rounding_fault_input_above_2_24():
    """The bases that expose the Pallas float32 rounding: G = [2^24+1,
    2^24+3, 2^25+5, 7] with one key in each of the first three buckets and
    two in the last."""
    g = torch.tensor([[2**24 + 1, 2**24 + 3, 2**25 + 5, 7]], dtype=torch.int32)
    keys = torch.tensor([[0, 1, 2, 3, 3]], dtype=torch.int32)
    spec = tid.IdentitySpec(4)
    want = [2**24 + 1, 2**24 + 3, 2**25 + 5, 7, 8]
    assert mst.spec_tile_positions(keys, g, spec).tolist() == [want]
    assert mst.spec_fused_postscan_reorder(keys, g, None, spec)[3].tolist() == [want]
    # the Pallas kernel's float32 sum rounds these (the fault the port avoids)
    pallas = jkops.spec_tile_positions(jnp.asarray(keys.numpy()), jnp.asarray(g.numpy()),
                                       jid.IdentitySpec(4), interpret=True)
    assert np.asarray(pallas).tolist() != [want]


@pytest.mark.parametrize("m", [1, 2, 33, 256])
def test_tile_rank_is_stable_int32(m):
    rng = np.random.default_rng(m)
    ids = torch.from_numpy(rng.integers(0, m, (3, 300)).astype(np.int32))
    rank, hist, starts = common.tile_rank(ids, m)
    for l in range(3):
        row = ids[l].numpy()
        for b in range(m):
            where = np.flatnonzero(row == b)
            np.testing.assert_array_equal(rank[l].numpy()[where], np.arange(where.size))
            assert hist[l, b] == where.size
        np.testing.assert_array_equal(starts[l].numpy(), np.cumsum(hist[l].numpy()) - hist[l].numpy())
    assert rank.dtype == hist.dtype == starts.dtype == torch.int32


def test_radix_doors_are_bitfield_instances():
    keys = torch.from_numpy(np.random.default_rng(5).integers(0, 2**32, (2, 256), dtype=np.uint64).astype(np.uint32))
    spec = tid.BitfieldSpec(8, 8)
    g = global_scan(radix_pass.radix_tile_histograms(keys, 8, 8))
    assert torch.equal(g, global_scan(tkops.spec_tile_histograms(keys, spec)))
    assert torch.equal(radix_pass.radix_tile_positions(keys, g, 8, 8), tkops.spec_tile_positions(keys, g, spec))
    for a, b in zip(radix_pass.radix_fused_postscan_reorder(keys, g, None, 8, 8),
                    tkops.spec_fused_postscan_reorder(keys, g, None, spec)):
        assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launches()
    keys = torch.arange(512, dtype=torch.int32).view(2, 256)
    spec = tid.DeltaSpec(4, 512)
    g = global_scan(mst.spec_tile_histograms(keys, spec))
    mst.spec_tile_positions(keys, g, spec)
    mst.spec_fused_postscan_reorder(keys, g, keys, spec)
    seg = torch.zeros((2, 256), dtype=torch.int32)
    h = mst.seg_spec_tile_histograms(keys, seg, spec, 1)
    mst.seg_spec_tile_positions(keys, seg, global_scan(h), spec, 1)
    mst.seg_spec_fused_postscan_reorder(keys, seg, global_scan(h), None, spec, 1)
    ids = mst.spec_bucket_ids(keys, spec)
    mst.tile_positions(ids, mst.tile_histograms(ids, 4), 4)
    mst.fused_postscan_reorder(ids, g, keys, None, 4)
    mst.seg_tile_positions(ids, seg, global_scan(mst.seg_tile_histograms(ids, seg, 4, 1)), 4, 1)
    mst.seg_fused_postscan_reorder(ids, seg, global_scan(h), keys, keys, 4, 1)
    mst.packed_tile_positions(keys, global_scan(mst.packed_tile_histograms(keys, spec=spec)),
                              spec=spec)
    mst.packed_fused_postscan_reorder(ids, g, keys, None, seg, num_buckets=4)
    pair = tid.BitfieldSpec(0, 6)
    g2 = global_scan(mst.fused2_tile_histograms(keys, seg, spec=pair))
    mst.fused2_tile_positions(keys, g2, seg, spec=pair, split=3)
    mst.fused2_fused_postscan_reorder(keys, g2, keys, spec=pair, split=3, family="packed")
    mst.tile_reorder(ids, keys, keys, 4)
    mst.tile_reorder(ids, keys, None, 4)
    assert kernels.launch_counts() == {
        "spec_tile_histograms": 0, "spec_fused_postscan_reorder": 0, "spec_tile_positions": 0,
        "seg_spec_tile_histograms": 0, "seg_spec_fused_postscan_reorder": 0,
        "seg_spec_tile_positions": 0, "tile_histograms": 0, "fused_postscan_reorder": 0,
        "tile_positions": 0, "seg_tile_histograms": 0, "seg_fused_postscan_reorder": 0,
        "seg_tile_positions": 0, "spec_bucket_ids": 0, "packed_tile_histograms": 0,
        "packed_fused_postscan_reorder": 0, "packed_tile_positions": 0,
        "fused2_tile_histograms": 0, "fused2_fused_postscan_reorder": 0,
        "fused2_tile_positions": 0, "tile_reorder": 0, "flash_attention": 0,
    }


def test_other_devices_raise():
    keys = torch.empty((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        mst.spec_tile_histograms(keys, tid.DeltaSpec(4))


SPLIT_SPEC = tid.RangeSpec((-3, 10, 2**20))


@pytest.mark.parametrize("spec,dtype,expect", [
    (tid.DeltaSpec(32), torch.uint32, (0, 1, 32, 2**30 // 32, 0, 0.0, 0.0, None, 0, 0)),
    (tid.BitfieldSpec(24, 8), torch.int32, (2, 0, 256, 24, 255, 0.0, 0.0, None, 0, 0)),
    (tid.IdentitySpec(5), torch.float32, (1, 2, 5, 0, 0, 0.0, 0.0, None, 0, 0)),
    (tid.EvenSpec(-3.7, 11.3, 37), torch.float32,
     (4, 2, 37, 0, 0, float(np.float32(-3.7)), float(np.float32(15.0 / 37)), None, 0, 0)),
])
def test_label_args(spec, dtype, expect):
    assert mst.label_args(spec, dtype, torch.device("cpu")) == expect


@pytest.mark.parametrize("dtype,plane,words", [
    (torch.int32, 0, [-3, 10, 2**20]),
    (torch.float32, 2, list(np.asarray([-3, 10, 2**20], np.float32).view(np.int32))),
])
def test_label_args_range_plane(dtype, plane, words):
    args = mst.label_args(SPLIT_SPEC, dtype, torch.device("cpu"))
    assert args[0] == 3 and args[8] == 3 and args[9] == plane
    _, sp = mst._splitter_words(SPLIT_SPEC, dtype, torch.device("cpu"))
    assert sp.data_ptr() == args[7] and sp.tolist() == words


@pytest.mark.parametrize("spec,dtype,err", [
    (tid.from_fn(lambda k: k % 2, 2), torch.int32, NotImplementedError),
    (tid.BitfieldSpec(0, 8), torch.float32, TypeError),
    (tid.DeltaSpec(512), torch.int32, ValueError),
    (tid.DeltaSpec(2, 2**33), torch.uint32, ValueError),
    (tid.DeltaSpec(4), torch.int64, ValueError),
    (tid.RangeSpec((-1,)), torch.uint32, ValueError),
])
def test_label_args_refuses(spec, dtype, err):
    with pytest.raises(err):
        mst.label_args(spec, dtype, torch.device("cpu"))


@pytest.mark.parametrize("source,replaces", [
    ("tile_histograms.cu", ["spec_tile_histograms_pallas", "radix_tile_histograms_pallas"]),
    ("tile_positions.cu", ["spec_tile_positions_pallas", "radix_tile_positions_pallas"]),
    ("fused_postscan_reorder.cu", ["spec_fused_postscan_reorder_pallas",
                                   "radix_fused_postscan_reorder_pallas"]),
    ("seg_tile_histograms.cu", ["seg_spec_tile_histograms_pallas",
                                "seg_radix_tile_histograms_pallas"]),
    ("seg_tile_positions.cu", ["seg_spec_tile_positions_pallas",
                               "seg_radix_tile_positions_pallas"]),
    ("seg_fused_postscan_reorder.cu", ["seg_spec_fused_postscan_reorder_pallas",
                                       "seg_radix_fused_postscan_reorder_pallas"]),
    ("spec_bucket_ids.cu", ["spec_bucket_ids_pallas"]),
    ("tile_histograms.cu", ["tile_histograms_pallas (src/repro/kernels/multisplit_tile.py:94)"]),
    ("tile_positions.cu", ["tile_positions_pallas (src/repro/kernels/multisplit_tile.py:123)"]),
    ("fused_postscan_reorder.cu", ["fused_postscan_reorder_pallas\n//   (src/repro/kernels/"
                                   "multisplit_tile.py:168)"]),
    ("seg_tile_histograms.cu", ["seg_tile_histograms_pallas\n// (src/repro/kernels/"
                                "multisplit_tile.py:227)"]),
    ("seg_tile_positions.cu", ["seg_tile_positions_pallas\n// (src/repro/kernels/"
                               "multisplit_tile.py:259)"]),
    ("seg_fused_postscan_reorder.cu", ["seg_fused_postscan_reorder_pallas\n//   (src/repro/kernels/"
                                       "multisplit_tile.py:303)"]),
    ("packed_tile_histograms.cu", ["packed_tile_histograms_pallas\n// (src/repro/kernels/"
                                   "multisplit_tile.py:662)"]),
    ("packed_tile_positions.cu", ["packed_tile_positions_pallas\n// (src/repro/kernels/"
                                  "multisplit_tile.py:706)"]),
    ("packed_fused_postscan_reorder.cu", ["packed_fused_postscan_reorder_pallas\n// (src/repro/"
                                          "kernels/multisplit_tile.py:772)"]),
    ("fused2_tile_histograms.cu", ["fused2_tile_histograms_pallas\n// (src/repro/kernels/"
                                   "multisplit_tile.py:863)"]),
    ("fused2_tile_positions.cu", ["fused2_tile_positions_pallas\n// (src/repro/kernels/"
                                  "multisplit_tile.py:909)"]),
    ("fused2_fused_postscan_reorder.cu", ["fused2_fused_postscan_reorder_pallas\n// (src/repro/"
                                          "kernels/multisplit_tile.py:973)"]),
    ("tile_reorder.cu", ["tile_reorder_pallas (src/repro/kernels/multisplit_tile.py:1061)",
                         "tile_reorder (src/repro/kernels/ref.py:37)"]),
])
def test_kernel_sources_carry_their_note(source, replaces):
    """Each kernel names the Pallas function it replaces and its bound, and
    its ctypes entry point is declared."""
    text = (CSRC / source).read_text()
    for name in replaces:
        assert name in text
    assert "Bound: memory" in text and "3.35 TB/s" in text
    symbol, argtypes = build.ENTRY_POINTS[source[:-3]]
    assert f'extern "C" int {symbol}(' in text
    assert source[:-3] in build.SOURCES


@pytest.mark.parametrize("entry", sorted(build.ENTRY_SOURCE))
def test_ids_entry_points_live_in_their_source(entry):
    """The ids entry points of K2 and K2s are declared in the K2 and K2s
    sources, with the number of buckets in place of the label arguments."""
    symbol, argtypes = build.ENTRY_POINTS[entry]
    text = (CSRC / f"{build.ENTRY_SOURCE[entry]}.cu").read_text()
    assert f'extern "C" int {symbol}(' in text
    assert build.ENTRY_SOURCE[entry] in build.SOURCES
    fused_argtypes = build.ENTRY_POINTS[build.ENTRY_SOURCE[entry]][1]
    # the ids pointer and m in place of the ten label arguments
    assert len(argtypes) == len(fused_argtypes) - len(build._LABEL_ARGTYPES) + 2


LIBRARY_MARKS = ("cub::", "thrust::", "cublas", "cusparse", "cutlass::", "cute::", "at::",
                 "c10::", "torch::")


@pytest.mark.parametrize("source", sorted(p.name for p in CSRC.iterdir()))
def test_kernel_sources_call_no_library(source):
    """Every kernel is written by hand: its source includes only the CUDA
    runtime, the driver API's types (``cuda.h``, for the tensor maps of TMA)
    and the repository's own headers, and calls no library kernel."""
    text = (CSRC / source).read_text()
    for mark in LIBRARY_MARKS:
        assert mark not in text, (source, mark)
    includes = [line.split()[1] for line in text.splitlines() if line.startswith("#include")]
    assert set(includes) <= {"<cuda.h>", "<cuda_runtime.h>", "<stdint.h>",
                             *(f'"{header}"' for header in build.HEADERS)}, includes


def test_build_flags_and_missing_nvcc(monkeypatch, tmp_path):
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda _: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.nvcc_path()
    assert build.library_path("tile_histograms").parent == build.BUILD_DIR


def test_kernel_modules_defer_cuda_work_to_the_launch():
    """Importing the kernel modules builds nothing: nvcc and ctypes loading
    happen inside ``build.load``, called only where a kernel launches."""
    calls = [n for mod in (mst, flash_attention)
             for n in ast.walk(ast.parse(Path(mod.__file__).read_text()))
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "load"]
    # one load a wrapper, and a second for flash attention's 16-bit route
    assert len(calls) == len(kernels.KERNELS) + 1 == 22
    assert len(build.SOURCES) == 16
    assert set(build.ENTRY_POINTS) == set(build.SOURCES) | set(build.ENTRY_SOURCE)
    assert not build._FNS
