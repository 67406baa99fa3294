"""The port's self-tuning layer (``core/pipeline/autotune.py``, the tile
autotuner and the Hopper shared-memory model of ``core/pipeline/tiles.py``)
against the JAX package's ``tests/test_autotune.py`` cases that apply to it.

Every search here runs on the CPU on the ``vmap`` backend (or the ``cuda``
backend's plain versions) at n <= 2^12 with one trial and two candidates,
against a cache directory under ``tmp_path``: nothing reads or writes the
home directory. A tuned plan gives the untuned plan's bits. The model's
shared-memory bytes are held against the launchers' own formulas, written
out here from ``csrc/*.cu`` (their constants read from the sources);
``chip_smoke.py`` holds the model against each launcher's report on the
card."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.core.identifiers import EvenSpec
from repro_torch.core.pipeline import (
    autotune_tile,
    clear_tile_cache,
    family_decision,
    fusion_decision,
    make_plan,
    make_radix_plan,
    pin_tile,
    resolve_kernel_family,
    resolve_tile,
    set_autotune,
    tile_decision,
)
from repro_torch.core.pipeline import autotune as at
from repro_torch.core.pipeline import tiles

N = 4096
M = 32
CSRC = Path(tiles.__file__).resolve().parents[2] / "kernels" / "csrc"


def _spec(m=M):
    return EvenSpec(0.0, float(1 << 20), m)


def _keys(n=N, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 1 << 20, n).astype(np.int32))


@pytest.fixture(autouse=True)
def _fresh():
    """Every test starts and ends disarmed, with empty caches."""
    prev = at._CONFIG
    clear_tile_cache()
    yield
    at._CONFIG = prev
    at._LOADED = None
    clear_tile_cache()


@pytest.fixture
def armed(tmp_path):
    """Armed against a throwaway cache directory; returns the file's path."""
    set_autotune(True, cache_dir=str(tmp_path), trials=1, candidates=(256, 1024))
    clear_tile_cache()
    return tmp_path / at.CACHE_FILE


def _disk(path):
    with open(path) as f:
        return json.load(f)


def _disk_kinds(path):
    return sorted({k.split("|")[1] for k in _disk(path)["entries"]})


def _boom(*a, **kw):                                  # pragma: no cover
    raise AssertionError("a timing search ran")


def test_disarmed_no_search_runs(monkeypatch, tmp_path):
    monkeypatch.setattr(tiles, "autotune_tile", _boom)
    monkeypatch.setattr(at, "autotune_fused2", _boom)
    monkeypatch.setattr(at, "autotune_label_fusion", _boom)
    set_autotune(cache_dir=str(tmp_path))
    p = make_plan(N, M, bucket_fn=_spec())
    assert int(p(_keys()).bucket_counts.sum()) == N
    assert "autotuned" not in family_decision(N, M, "bms", "vmap")[1]
    assert not (tmp_path / at.CACHE_FILE).exists()


def test_armed_miss_runs_the_joint_search_once_and_persists(armed):
    s0 = at._SEARCHES
    p = make_plan(N, M, bucket_fn=_spec())
    assert at._SEARCHES - s0 == 1
    assert "autotuned" in family_decision(N, M, "bms", "vmap")[1]
    assert p.tile in (256, 1024)
    assert "autotuned" in tile_decision(N, M, "bms", False, "vmap")[1]
    assert len(at.last_times()) == 2 * 2                 # tiles x families
    data = _disk(armed)
    assert data["version"] == at.SCHEMA_VERSION
    assert {"family", "tile"} <= set(_disk_kinds(armed))
    fp = at.host_fingerprint()
    assert fp.endswith("-cpu")
    assert f"{fp}|tile|{N}|{M}|bms|False|vmap" in data["entries"]
    make_plan(N, M, bucket_fn=_spec())                   # a hit: no second search
    assert at._SEARCHES - s0 == 1


def test_env_flag_arms(monkeypatch):
    assert set_autotune() == at._CONFIG                  # no-op: the current state
    for value, on in (("1", True), ("true", True), ("on", True), ("0", False), ("", False)):
        monkeypatch.setenv("REPRO_AUTOTUNE", value)
        assert at._env_enabled() is on
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", "/some/dir")
    assert at.cache_path() == Path("/some/dir") / at.CACHE_FILE
    assert at.CACHE_FILE != "multisplit_autotune.json"  # never the JAX package's file
    status = at.autotune_status()
    assert {"config", "cache_path", "disk_entries", "fingerprint"} <= set(status)


def test_fresh_process_resolves_from_disk_without_timing(armed, monkeypatch):
    p = make_plan(N, M, bucket_fn=_spec())
    clear_tile_cache()                                   # a fresh process, a warm file
    monkeypatch.setattr(tiles, "autotune_tile", _boom)
    monkeypatch.setattr(at, "autotune_fused2", _boom)
    p2 = make_plan(N, M, bucket_fn=_spec())
    assert (p2.tile, p2.family) == (p.tile, p.family)
    assert family_decision(N, M, "bms", "vmap")[1] == at._DISK_REASON
    assert tile_decision(N, M, "bms", False, "vmap")[1] == at._DISK_REASON


@pytest.mark.parametrize("content", ["{ not json !!", json.dumps({"version": 0, "entries": {}})])
def test_corrupt_or_old_file_loads_as_empty(armed, content):
    armed.parent.mkdir(parents=True, exist_ok=True)
    fp = at.host_fingerprint()
    if content.startswith("{ not"):
        armed.write_text(content)
    else:
        armed.write_text(json.dumps({"version": at.SCHEMA_VERSION + 1,
                                     "entries": {f"{fp}|tile|{N}|{M}|bms|False|vmap": 64}}))
    clear_tile_cache()
    assert at.lookup("tile", (N, M, "bms", False, "vmap")) is None
    p = make_plan(N, M, bucket_fn=_spec())               # searches again, rewrites the file
    assert int(p(_keys()).bucket_counts.sum()) == N
    assert _disk(armed)["version"] == at.SCHEMA_VERSION


def test_clear_tile_cache_disk_deletes_the_file(armed):
    make_plan(N, M, bucket_fn=_spec())
    assert armed.exists()
    clear_tile_cache(disk=True)
    assert not armed.exists() and at._entries() == {}


def test_unwritable_dir_tunes_in_memory(armed, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    set_autotune(cache_dir=str(blocker / "sub"))         # a directory under a file
    p = make_plan(N, M, bucket_fn=_spec())
    assert family_decision(N, M, "bms", "vmap")[1].startswith("autotuned")
    assert p.tile in (256, 1024)


@pytest.mark.parametrize("armed_", [False, True])
def test_explicit_tile_and_family_are_never_cached(armed_, tmp_path, monkeypatch):
    if armed_:
        set_autotune(True, cache_dir=str(tmp_path), trials=1, candidates=(256, 1024))
        monkeypatch.setattr(tiles, "autotune_tile", _boom)
    p = make_plan(N, M, bucket_fn=_spec(), tile=512, family="packed")
    assert (p.tile, p.family) == (512, "packed")
    assert not tiles._TILE_CACHE and not tiles._FAMILY_CACHE
    assert resolve_tile(N, M, "bms", False, "vmap", requested=2048) == 2048
    assert resolve_kernel_family(N, M, "bms", "vmap", "packed") == "packed"
    assert not tiles._TILE_CACHE and not tiles._FAMILY_CACHE


def test_searches_leave_the_hooks_inert(monkeypatch):
    set_autotune(True, persist=False, trials=1, candidates=(256,))
    monkeypatch.setattr(tiles, "autotune_tile", _boom)
    monkeypatch.setattr(at, "autotune_label_fusion", _boom)
    with at.searching():
        p = make_plan(N, M, bucket_fn=_spec())
        p(_keys())
    assert "autotuned" not in family_decision(N, M, "bms", "vmap")[1]
    # the fusion choice was made without pinning: a later call measures it
    assert fusion_decision("vmap", "EvenSpec", M) is None


def test_fused_tile_key_carries_stage_m():
    assert (tiles._tile_key(N, 256, "bms", False, "vmap", 2, 16)
            != tiles._tile_key(N, 256, "bms", False, "vmap", 2, 4))
    assert tiles._tile_key(N, 256, "bms", False, "vmap", 1, None) == (N, 256, "bms", False,
                                                                        "vmap")


@pytest.mark.parametrize("pinned_digits", [1, 2])
def test_digits_2_never_collides_with_digits_1(pinned_digits):
    """A pinned family of one slot does not leak into the other, and a
    fused plan resolves through its own slot end to end."""
    key1, key2 = (N, 16, "bms", "vmap"), (N, 16, "bms", "vmap", 2)
    tiles._FAMILY_CACHE[key1 if pinned_digits == 1 else key2] = ("packed", "test pin")
    other = 2 if pinned_digits == 1 else 1
    fam = resolve_kernel_family(N, 16, "bms", "vmap", digits=other, pair_m=256)
    assert fam == "onehot"
    assert tiles._FAMILY_CACHE[key2 if other == 2 else key1][0] == "onehot"
    plan = make_radix_plan(N, 0, 8, digit_split=4)
    assert plan.family == ("packed" if pinned_digits == 2 else "onehot")
    k = _keys()
    got = plan(k).keys.numpy() & 0xFF
    assert (np.diff(got) >= 0).all()


def test_autotune_tile_drops_the_key_value_sibling():
    sib = (N, M, "bms", True, "vmap")
    assert resolve_tile(N, M, "bms", True, "vmap") == tiles._TILE_CACHE[sib]
    tile = autotune_tile(N, _spec(), backend="vmap", candidates=(256, 512), trials=1)
    assert tiles._TILE_CACHE[(N, M, "bms", False, "vmap")] == tile
    assert sib not in tiles._TILE_CACHE


def test_fused2_grid_pins_tile_family_and_sub_bits(armed):
    out = at.autotune_fused2(N, 0, 8, 4, backend="vmap", candidates=(1024, 2048),
                             sub_bits_candidates=(2, 4), trials=1)
    tile, fam, sb = out
    assert tile in (1024, 2048) and fam in tiles.FAMILIES and sb in (2, 4)
    assert len(at.last_times()) == 2 * 2 * 2
    assert resolve_tile(N, 256, "bms", False, "vmap", digits=2, stage_m=16) == tile
    fam_, reason = family_decision(N, 16, "bms", "vmap", digits=2)
    assert fam_ == fam and "autotuned over fused-pair grid" in reason
    assert tiles.resolve_sub_bits(N, 256, "bms", False, "vmap", 16) == sb
    plan = make_radix_plan(N, 0, 8, digit_split=4, backend="vmap")
    assert (plan.tile, plan.family, plan.sub_bits) == (tile, fam, sb)
    assert {"family", "sub_bits", "tile"} <= set(_disk_kinds(armed))
    clear_tile_cache()                                   # and back from the file
    plan = make_radix_plan(N, 0, 8, digit_split=4, backend="vmap")
    assert (plan.tile, plan.family, plan.sub_bits) == (tile, fam, sb)


@pytest.mark.parametrize("backend,kv", [("vmap", False), ("vmap", True), ("cuda", True)])
def test_a_tuned_call_is_bitwise_the_untuned_call(tmp_path, backend, kv):
    keys = _keys(3000, 5)
    vals = torch.arange(3000, dtype=torch.int32) if kv else None
    spec = ops.DeltaSpec(16, 1 << 20)
    untuned = ops.multisplit(keys, spec, vals, backend=backend, device="cpu")
    set_autotune(True, cache_dir=str(tmp_path), trials=1, candidates=(256, 1024))
    clear_tile_cache()
    s0 = at._SEARCHES
    tuned = ops.multisplit(keys, spec, vals, backend=backend, device="cpu")
    assert at._SEARCHES > s0
    for a, b in zip(untuned, tuned):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_clear_tile_cache_clears_the_ops_plan_cache():
    spec = ops.DeltaSpec(16, 1 << 20)
    ops.multisplit(_keys(3000), spec, backend="vmap", device="cpu")
    assert ops._plan_cached.cache_info().currsize >= 1
    clear_tile_cache()
    assert ops._plan_cached.cache_info().currsize == 0
    pin_tile(3000, 16, "bms", False, "vmap", 512)
    assert ops._plan(spec, 3000, backend="vmap").tile == 512
    assert tile_decision(3000, 16, "bms", False, "vmap") == (512, "pinned by pin_tile (512)")


@pytest.mark.parametrize("layout", ["segmented", "batched"])
def test_layout_searches_pin_their_shape_class(layout):
    kw = {"segments": 2} if layout == "segmented" else {"batch": 2}
    tile = autotune_tile(1024, _spec(8), backend="vmap", candidates=(256, 512), trials=1, **kw)
    m_eff = 16 if layout == "segmented" else 8
    assert tiles._TILE_CACHE[(1024, m_eff, "bms", False, "vmap")] == tile


def test_the_cuda_search_drops_tiles_the_kernels_cannot_take():
    """On the cuda backend (plain versions on the CPU) the model drops the
    candidate above MAX_TILE before timing, and the tile's reason names the
    blocks an SM of the plan's kernels."""
    tile = autotune_tile(N, ops.DeltaSpec(16, 1 << 20), backend="cuda", candidates=(2048, 16384),
                         families=("onehot",), trials=1, device="cpu")
    assert tile == 2048
    assert [t for t, _, _ in at.last_times()] == [2048]
    reason = tile_decision(N, 16, "bms", False, "cuda")[1]
    assert "blocks an SM" in reason and "spec_fused_postscan_reorder" in reason
    assert "blocks an SM" in tile_decision(1 << 25, 256, "bms", True, "cuda")[1]


@pytest.mark.parametrize("dropped", ["onehot", "packed"])
def test_the_cuda_search_drops_each_family_by_its_own_kernels(dropped, monkeypatch):
    """The launchability check is made for each (tile, family) pair with that
    family's kernels: a family none of whose plans can launch is not timed,
    and the winner's reason names the winning family's kernels."""
    real = tiles.plan_occupancy
    seen = []

    def occupancy(tile, bucket_fn, **kw):
        seen.append(kw["family"])
        occs = real(tile, bucket_fn, **kw)
        if kw["family"] == dropped:
            return tuple((k, tiles.Occupancy(o.stages, o.smem, 0)) for k, o in occs)
        return occs

    monkeypatch.setattr(tiles, "plan_occupancy", occupancy)
    autotune_tile(N, ops.DeltaSpec(16, 1 << 20), backend="cuda", candidates=(1024, 2048),
                  families=("onehot", "packed"), trials=1, device="cpu")
    kept = "packed" if dropped == "onehot" else "onehot"
    assert sorted(set(seen)) == ["onehot", "packed"]
    assert {f for _, f, _ in at.last_times()} == {kept}
    assert family_decision(N, 16, "bms", "cuda")[0] == kept
    reason = tile_decision(N, 16, "bms", False, "cuda")[1]
    post = "packed_fused_postscan_reorder" if kept == "packed" else "spec_fused_postscan_reorder"
    assert post in reason and ("packed_" in reason) == (kept == "packed")


@pytest.mark.parametrize("kw", [dict(key_value=True), dict(method="dms", segments=4),
                                dict(family="packed", key_value=True)])
def test_plan_occupancy_off_the_card_is_the_model(kw):
    spec = ops.DeltaSpec(64, 1 << 20)
    kw = dict(kw)
    method = kw.pop("method", "bms")
    lays = tiles.plan_kernels(2048, 64, method=method, **kw)
    assert tiles.plan_occupancy(2048, spec, method=method, device="cpu", **kw) == tuple(
        (lay.kernel, tiles.occupancy(lay)) for lay in lays)


@pytest.mark.parametrize("spec", [ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32),
                                  ops.DeltaSpec(16, 1 << 20), ops.IdentitySpec(64),
                                  ops.BitfieldSpec(8, 8), ops.EvenSpec(0.0, 2.0 ** 30, 64),
                                  ops.EvenSpec(100.0, 612.0, 8)],
                         ids=lambda s: f"{type(s).__name__}{s.num_buckets}")
def test_search_keys_fill_every_bucket_of_the_spec(spec):
    """The synthetic keys span the spec's own key range (a DeltaSpec over
    2^32 keys as uint32 bit patterns), so every bucket the search's plans
    see is live; the values and segment starts follow the layout."""
    keys, values, starts = at.synthetic_inputs(1 << 14, spec, key_value=True, segments=4)
    assert keys.dtype == torch.int32 and keys.shape == (1 << 14,)
    counts = torch.bincount(spec(keys).long(), minlength=spec.num_buckets)
    assert counts.numel() == spec.num_buckets and bool((counts > 0).all())
    assert torch.equal(values, torch.arange(1 << 14, dtype=torch.int32))
    assert starts.tolist() == [0, 4096, 8192, 12288]
    again, _, _ = at.synthetic_inputs(1 << 14, spec)
    assert torch.equal(keys, again)


def test_clear_tile_cache_runs_the_registered_hooks():
    """clear_tile_cache reaches the caches above it only through on_clear:
    ops registered its two plan caches, and a new hook runs once a clear."""
    assert ops._plan_cached.cache_clear in tiles._CLEAR_HOOKS
    assert ops._batched_plan_cached.cache_clear in tiles._CLEAR_HOOKS
    calls = []
    hook = lambda: calls.append(1)                       # noqa: E731
    tiles.on_clear(hook)
    tiles.on_clear(hook)
    try:
        clear_tile_cache()
        assert calls == [1]
    finally:
        tiles._CLEAR_HOOKS.remove(hook)
    assert "repro_torch.ops" not in Path(tiles.__file__).read_text()


def test_label_fusion_is_measured_and_read_back(armed):
    p = make_plan(N, M, bucket_fn=_spec())
    p.label_fusion(_keys())
    dec = fusion_decision("vmap", "EvenSpec", M)
    assert dec is not None and "autotuned" in dec[1]
    assert "fusion" in _disk_kinds(armed)
    clear_tile_cache()
    p.label_fusion(_keys())
    assert fusion_decision("vmap", "EvenSpec", M)[1] == at._DISK_REASON


def test_fusion_records_its_reason_disarmed():
    p = make_plan(N, M, bucket_fn=_spec(), backend="cuda")
    assert p.label_fusion(_keys())
    assert fusion_decision("cuda", "EvenSpec", M) == (
        True, "kernel backend: the CUDA kernels compute the labels in registers")
    p = make_plan(N, M, bucket_fn=_spec())
    assert p.label_fusion(_keys())
    reason = fusion_decision("vmap", "EvenSpec", M)[1]
    assert "CPU host" in reason and "set_autotune" in reason


# ---------------------------------------------------------------------------
# The shared-memory model against the launchers' formulas
# ---------------------------------------------------------------------------

def _const(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", (CSRC / source).read_text())
    assert m, (source, name)
    expr = m.group(1).split("//")[0].replace("::", ".")
    return int(eval(expr, {"kMaxTile": 8192, "kBlock": 1024,
                           "ms": type("ms", (), {"kMaxPairBits": 16})}))


def _launcher_bytes(kernel, T, m, kv, seg, ids=False):
    """(one, two) as each launcher computes them (``csrc/*.cu``)."""
    pitch = (T + 3) & ~3
    g4 = (m + 3) & ~3
    w = 8                                                 # kWarps
    if kernel == "spec_tile_histograms":
        copies = 32
        while copies > 1 and copies * (m | 1) > _const("tile_histograms.cu", "kCopyWords"):
            copies >>= 1
        return 4 * 2 * copies * (m | 1), None
    if kernel == "seg_spec_tile_histograms":
        return 4 * 2 * _const("seg_tile_histograms.cu", "kSetWords"), None
    if kernel == "packed_tile_histograms":
        return 4 * 2 * _const("packed_tile_histograms.cu", "kSetWords"), None
    if kernel == "spec_fused_postscan_reorder":
        stage = (1 + kv) * pitch + g4
        fixed = 4 * (w * m + m) + pitch
        return 4 * stage + fixed, 4 * 2 * stage + fixed
    if kernel == "spec_tile_positions":
        stage = pitch + g4
        return 4 * stage + 4 * w * m, 4 * 2 * stage + 4 * w * m
    if kernel == "seg_spec_fused_postscan_reorder":
        stage = 4 * (2 + kv) * pitch
        return stage + 4 * (w * m + m), 2 * stage + 4 * (w * m + m)
    if kernel == "seg_spec_tile_positions":
        stage = pitch + max(pitch, g4)
        return 4 * stage + 4 * w * m, 4 * 2 * stage + 4 * w * m
    if kernel == "packed_fused_postscan_reorder":
        stage = 4 * (1 + kv + int(ids) + int(bool(seg) or not ids)) * pitch
        one = stage + 4 * (w * m + m) + (0 if seg else pitch)
        return one, one + stage
    if kernel == "packed_tile_positions":
        stage = pitch + (pitch if seg and pitch > g4 else g4)
        return 4 * stage + 4 * w * m, 4 * 2 * stage + 4 * w * m
    if kernel in ("fused2_fused_postscan_reorder", "fused2_tile_positions"):
        one = 4 * (3 * pitch + w * 256 + 8192 // 32)
        return one, one + 4 * pitch
    if kernel == "fused2_tile_histograms":
        cells = _const("fused2_tile_histograms.cu", "kWindowCells")
        win = min(seg or 1, max(cells // m, 1))
        return win * m // 2 * 4, None
    raise AssertionError(kernel)


TILES = (256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("family,segments", [("onehot", None), ("onehot", 64), ("packed", None),
                                             ("packed", 64)])
@pytest.mark.parametrize("method,kv", [("bms", False), ("bms", True), ("dms", False)])
def test_model_bytes_equal_the_launchers_formulas(family, segments, method, kv):
    for T in TILES:
        for m in (2, 32, 255, 256):
            for lay in tiles.plan_kernels(T, m, method=method, key_value=kv, segments=segments,
                                          family=family):
                name = lay.kernel
                assert (lay.one, lay.two) == _launcher_bytes(name, T, m, kv, segments is not None)


@pytest.mark.parametrize("bits,segments", [(16, None), (14, None), (8, 64), (16, 16)])
def test_model_bytes_of_the_fused_pairs(bits, segments):
    for T in TILES:
        for lay in tiles.plan_kernels(T, 1 << bits, key_value=True, segments=segments,
                                      pair_bits=bits):
            assert (lay.one, lay.two) == _launcher_bytes(lay.kernel, T, 1 << bits, True, segments)


def test_model_bytes_of_the_packed_ids_postscan():
    for seg in (None, 4):
        lay, = tiles.plan_kernels(4096, 256, key_value=True, family="packed", ids=True,
                                  segments=seg)[1:]
        assert (lay.one, lay.two) == _launcher_bytes(lay.kernel, 4096, 256, True, seg, ids=True)


def test_occupancy_follows_pick_stages_and_the_card_limits():
    """Known H100 facts (PERF.md §6): K1 four blocks an SM at T <= 4096 and
    two above; K2 key-value two staged tiles, two blocks an SM at 128
    registers; K3 four; K2f two at T = 8192; a tile past the per-block
    limit cannot launch."""
    occ = tiles.occupancy
    k1, k2 = tiles.plan_kernels(4096, 256, key_value=True)
    assert occ(k1).blocks == 4 and occ(k1, registers=32).blocks == 4
    assert occ(k2) == tiles.Occupancy(2, k2.two, 2) == occ(k2, registers=128)
    assert occ(tiles.plan_kernels(8192, 256)[0]).blocks == 2
    _, k3 = tiles.plan_kernels(4096, 256, method="dms")
    assert occ(k3).stages == 2 and occ(k3).blocks == 4
    _, k2f = tiles.plan_kernels(8192, 1 << 16, key_value=True, pair_bits=16)
    assert occ(k2f).blocks == 2
    huge = tiles.KernelLayout("x", 256, 1, 240 * 1024, None, 0)
    assert occ(huge).blocks == 0 and not tiles._launchable([("x", occ(huge))])
    assert tiles.register_ceiling(256, 2) == 128 and tiles.register_ceiling(512, 4) == 32
    assert tiles.blocks_per_sm(256, 0, 0, 64) == 4 and tiles.blocks_per_sm(256, 0, 0, 32) == 8
    with pytest.raises(ValueError, match="tiles of 1..8192"):
        tiles.plan_kernels(16384, 256)
