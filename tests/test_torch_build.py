"""The kernel build's lists of sources and headers against ``csrc/``.

``build.library_path`` names each library by a hash of its source, the
headers in ``build.HEADERS`` and the flags, so a header that a source
includes but the list leaves out could load a stale library after an edit.
These tests hold the lists to the files: every ``#include "..."`` of a
source or header names a listed header, every listed header exists, and the
sources are exactly the ``csrc/*.cu`` files."""

import re
from pathlib import Path

import pytest

from repro_torch.kernels import build

import _torch_threads

_torch_threads.pin()

CSRC = Path(build.__file__).resolve().parent / "csrc"
LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _local_includes(path: Path) -> list:
    return LOCAL_INCLUDE.findall(path.read_text())


@pytest.mark.parametrize("name", sorted(p.name for p in CSRC.iterdir()
                                        if p.suffix in (".cu", ".cuh")))
def test_every_local_include_is_a_listed_header(name):
    for header in _local_includes(CSRC / name):
        assert header in build.HEADERS, (name, header)


def test_sources_are_the_cu_files():
    assert len(build.SOURCES) == len(set(build.SOURCES))
    assert set(build.SOURCES) == {p.stem for p in CSRC.glob("*.cu")}


def test_listed_headers_are_the_cuh_files():
    assert len(build.HEADERS) == len(set(build.HEADERS))
    assert set(build.HEADERS) == {p.name for p in CSRC.glob("*.cuh")}


def _includes_transitively(name: str) -> set:
    seen, todo = set(), [name]
    while todo:
        for header in _local_includes(CSRC / todo.pop()):
            if header not in seen:
                seen.add(header)
                todo.append(header)
    return seen


@pytest.mark.parametrize("header", build.HEADERS)
def test_an_edited_header_renames_every_library_that_includes_it(header, tmp_path, monkeypatch):
    """Editing a header changes the library name of every source that
    includes it, directly or through another header, so no stale build is
    loaded."""
    for f in CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    users = [s for s in build.SOURCES if header in _includes_transitively(f"{s}.cu")]
    assert users, f"no source includes {header}"
    before = {s: build.library_path(s) for s in build.SOURCES}
    (tmp_path / header).write_text((tmp_path / header).read_text() + "\n// edited\n")
    for s in users:
        assert build.library_path(s) != before[s], (header, s)


def test_k1_and_k2_share_the_hopper_header():
    """K1 and K2 in their Hopper designs: persistent blocks over tiles, rows
    loaded ahead, K1 counting without the rank walk, K2 ranking from its
    staged tile; both through ``multisplit_sm90.cuh``, which is listed and
    holds K1's 16-byte register loads (shared with K1s) and the
    cp.async staging that K2 calls."""
    k1 = (CSRC / "tile_histograms.cu").read_text()
    k2 = (CSRC / "fused_postscan_reorder.cu").read_text()
    sm90 = (CSRC / "multisplit_sm90.cuh").read_text()
    for text in (k1, k2):
        assert '#include "multisplit_sm90.cuh"' in text
        assert "tile += gridDim.x" in text and "persistent_grid" in text
    assert "rank_tile" not in k1 and "__match_any_sync" not in k1 and "atomicAdd" in k1
    assert "sm90::load_keys" in k1 and "sm90::count_keys" in k1
    assert "__ldg(reinterpret_cast<const uint4*>" in sm90
    assert "stage_row" in k2 and "copy_wait_all" in k2
    assert "cp.async.cg.shared.global" in sm90 and "cp.async.ca.shared.global" in sm90
    assert "multisplit_sm90.cuh" in build.HEADERS


@pytest.mark.parametrize("name", ["tile_positions", "seg_fused_postscan_reorder"])
def test_k3_and_k2s_share_the_hopper_header(name):
    """K3 and K2s in their Hopper designs: persistent blocks over staged
    tiles, the labels' cheap forms, and K2's register-held rank
    (``sm90::warp_rank``) in place of ``ms::rank_tile``'s meta plane, all
    through ``multisplit_sm90.cuh``, which is listed."""
    text = (CSRC / f"{name}.cu").read_text()
    assert '#include "multisplit_sm90.cuh"' in text
    assert "tile += gridDim.x" in text and "persistent_grid" in text
    assert "stage_row" in text and "copy_wait_all" in text and "pick_stages" in text
    assert "sm90::warp_rank<kR, kForm>" in text and "sm90::kShiftMask" in text
    assert "rank_tile" not in text and "meta[i]" not in text
    assert "int4" in text
    assert "multisplit_sm90.cuh" in build.HEADERS
    k2 = (CSRC / "fused_postscan_reorder.cu").read_text()
    assert "sm90::warp_rank<kR, sm90::kAnySpec>" in k2      # one rank for K2, K3 and K2s


def test_k1s_and_k3s_share_the_hopper_headers():
    """K1s and K3s in their Hopper designs: persistent blocks over tiles,
    no run list (``ms::find_runs``) and no meta-plane rank
    (``ms::rank_tile``). K1s counts order-free with K1's register loads and
    count (``multisplit_sm90.cuh``) and reads a tile's strip only past a
    one-run test of its two end ids; K3s stages its tiles, ranks with K3's
    ``sm90::warp_rank`` and splits a tile of several runs with the
    ``ms::split_runs`` it shares with K2s (``multisplit_segmented.cuh``)."""
    k1s = (CSRC / "seg_tile_histograms.cu").read_text()
    k3s = (CSRC / "seg_tile_positions.cu").read_text()
    k2s = (CSRC / "seg_fused_postscan_reorder.cu").read_text()
    for text in (k1s, k3s):
        assert '#include "multisplit_sm90.cuh"' in text
        assert "tile += gridDim.x" in text and "persistent_grid" in text
        assert "find_runs" not in text and "rank_tile" not in text
    assert "sm90::load_keys" in k1s and "sm90::count_keys" in k1s and "atomicAdd" in k1s
    assert "if (lo == hi)" in k1s and "kSetWords" in k1s and "int4" in k1s
    assert "stage_row" in k3s and "copy_wait_all" in k3s and "pick_stages" in k3s
    assert "sm90::warp_rank<kR, kForm>" in k3s and "int4" in k3s
    for text in (k3s, k2s):
        assert '#include "multisplit_segmented.cuh"' in text and "ms::split_runs(" in text
    assert "multisplit_segmented.cuh" in build.HEADERS and "multisplit_sm90.cuh" in build.HEADERS


@pytest.mark.parametrize("name", ["packed_tile_positions", "tile_reorder"])
def test_k3p_and_b10_are_persistent_and_staged(name):
    """K3p and B10 in their Hopper designs: persistent blocks over tiles
    staged by ``cp.async`` (``multisplit_sm90.cuh``), K3p on the packed rank
    that K2p shares (``sm90::packed_warp_rank``) with K3s's run split, B10 on
    K2's ballot rank (``sm90::warp_rank``); neither walks a run list or a
    meta plane, and the first design's helpers (``ms::find_runs``,
    ``ms::rank_tile``, ``ms::rounds_per_warp`` and the packed header with
    ``ms::packed_rank_range``) are gone from the headers and the build."""
    text = (CSRC / f"{name}.cu").read_text()
    assert '#include "multisplit_sm90.cuh"' in text
    assert "tile += gridDim.x" in text and "sm90::persistent_grid(" in text
    assert "sm90::stage_row<" in text and "copy_wait_all" in text and "sm90::pick_stages(" in text
    for gone in ("rank_tile", "packed_rank_range", "find_runs", "meta[", "multisplit_packed"):
        assert gone not in text, gone
    if name == "packed_tile_positions":
        assert "sm90::packed_warp_rank<kR, kForm>(" in text and "ms::split_runs(" in text
        assert '#include "multisplit_segmented.cuh"' in text and "sm90::kClampedId" in text
    else:
        assert "sm90::warp_rank<kR, sm90::kClampedId>(" in text and "uint4" in text
    assert not (CSRC / "multisplit_packed.cuh").exists()
    assert "multisplit_packed.cuh" not in build.HEADERS
    headers = {h: (CSRC / h).read_text() for h in build.HEADERS}
    assert "find_runs" not in headers["multisplit_segmented.cuh"]
    for gone in ("rank_tile", "rounds_per_warp"):
        assert gone not in headers["multisplit_common.cuh"], gone
    assert "label_at" in headers["multisplit_common.cuh"]     # ms::short_run_rank's
