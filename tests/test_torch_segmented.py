"""The port's segmented layout against the JAX package, bitwise.

The same numpy keys, values and segment starts (made from a seed) go
through ``repro`` and through ``repro_torch`` on the CPU:

* the segmented kernels' plain versions (the cuda wrappers on CPU tensors)
  against ``repro.kernels.ops.seg_spec_*`` in interpret mode, where the
  Pallas float32 ``G + rank`` is exact (G < 2^24), and against numpy above;
* the segment ids and the carry-form rank against ``repro.core.pipeline.
  stages``;
* ``repro_torch.ops.segmented_multisplit`` and ``segmented_radix_sort`` on
  the ``reference``, ``vmap`` and ``cuda`` backends against ``repro.ops``
  (backend ``reference``), in every field, and the key-value gradient
  against ``jax.grad``.

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import identifiers as jid
from repro.core.pipeline import stages as jst
from repro.kernels import ops as jkops
from repro_torch import ops
from repro_torch.convert import convert_spec
from repro_torch.core import pipeline as tpipe
from repro_torch.core.multisplit import segmented_multisplit as core_segmented
from repro_torch.core.pipeline import stages as tst
from repro_torch.kernels import multisplit_tile as mst
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import radix_pass

import _torch_threads

_torch_threads.pin()

BACKENDS = ["reference", "vmap", "cuda"]
METHODS = ["dms", "wms", "bms"]
FIELDS = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")


def _bits(a) -> np.ndarray:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _assert_result(got, want, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.detach().numpy().dtype == np.asarray(w).dtype, f
            assert tuple(g.shape) == np.asarray(w).shape, f
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)


def _starts(n, s, rng, empty=3):
    """s ascending starts over n with ``starts[0] == 0`` and some empty
    segments (repeated starts), the last one too when ``empty`` allows."""
    cuts = np.sort(rng.integers(0, n + 1, s - 1))
    starts = np.concatenate([[0], cuts]).astype(np.int32)
    for i in rng.choice(np.arange(1, s), min(empty, s - 1), replace=False):
        starts[i] = starts[i - 1]
    return np.maximum.accumulate(starts).astype(np.int32)


def _seg_strip(shape, s, rng):
    """(L, T) int32 segment ids of ragged segments (some empty) over the
    flattened tiles: non-decreasing along every tile."""
    n = shape[0] * shape[1]
    starts = _starts(n, s, rng)
    seg = np.searchsorted(starts, np.arange(n), side="right") - 1
    return seg.astype(np.int32).reshape(shape)


# ---------------------------------------------------------------------------
# (1) the kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

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


# (spec, key dtype, (L, T), s): every spec kind, every key type, m up to 256,
# segments shorter than a tile, longer than one, and one key long
KERNEL_CASES = [
    (jid.DeltaSpec(2), np.uint32, (4, 512), 9),
    (jid.DeltaSpec(32), np.int32, (3, 200), 5),
    (jid.DeltaSpec(32), np.float32, (2, 256), 4),
    (jid.DeltaSpec(256, 2**32 - 1), np.uint32, (2, 1024), 3),
    (jid.BitfieldSpec(0, 8), np.uint32, (1, 128), 2),
    (jid.BitfieldSpec(11, 5), np.int32, (4, 512), 40),
    (jid.RangeSpec((7, 100, 2**20, 2**29)), np.int32, (3, 200), 6),
    (jid.RangeSpec((0.5, 3e8, 1e9)), np.float32, (4, 512), 7),
    (jid.EvenSpec(-3.7, 11.3, 37), np.float32, (2, 256), 5),
    (jid.IdentitySpec(32), np.uint32, (8, 512), 200),
]


def _kernel_case(case, seed):
    spec, dtype, shape, s = case
    rng = np.random.default_rng(seed)
    keys = _keys(dtype, shape, rng, spec)
    vals = rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    return keys, vals, _seg_strip(shape, s, rng), convert_spec(spec)


def _kid(case):
    spec, dtype, shape, s = case
    return f"{spec.name}-{np.dtype(dtype).name}-{shape[0]}x{shape[1]}-s{s}"


def _bases(tspec, keys, seg, s):
    return tst.global_scan(mst.seg_spec_tile_histograms_plain(
        torch.from_numpy(keys), torch.from_numpy(seg), tspec, s))


@pytest.mark.parametrize("case", KERNEL_CASES, ids=_kid)
def test_seg_histograms_plain_vs_pallas(case):
    spec, _, _, s = case
    keys, _, seg, tspec = _kernel_case(case, 1)
    want = jkops.seg_spec_tile_histograms(jnp.asarray(keys), jnp.asarray(seg), spec, s,
                                          interpret=True)
    got = mst.seg_spec_tile_histograms(torch.from_numpy(keys), torch.from_numpy(seg), tspec, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", KERNEL_CASES, ids=_kid)
def test_seg_positions_plain_vs_pallas(case):
    spec, _, _, s = case
    keys, _, seg, tspec = _kernel_case(case, 2)
    g = _bases(tspec, keys, seg, s)
    want = jkops.seg_spec_tile_positions(jnp.asarray(keys), jnp.asarray(seg),
                                         jnp.asarray(g.numpy()), spec, s, interpret=True)
    got = mst.seg_spec_tile_positions(torch.from_numpy(keys), torch.from_numpy(seg), g, tspec, s)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("case", KERNEL_CASES, ids=_kid)
def test_seg_fused_postscan_reorder_plain_vs_pallas(case, key_value):
    spec, _, _, s = case
    keys, vals, seg, tspec = _kernel_case(case, 3)
    g = _bases(tspec, keys, seg, s)
    want = jkops.seg_spec_fused_postscan_reorder(
        jnp.asarray(keys), jnp.asarray(seg), jnp.asarray(g.numpy()),
        jnp.asarray(vals) if key_value else None, spec, s, interpret=True,
    )
    got = mst.seg_spec_fused_postscan_reorder(
        torch.from_numpy(keys), torch.from_numpy(seg), g,
        torch.from_numpy(vals) if key_value else None, tspec, s,
    )
    assert (got[1] is None) == (not key_value)
    for a, b in zip(got, want):
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))


def _numpy_seg_positions(ids, seg, g, m):
    """G[l, seg·m + b] + (earlier keys of the same (seg, b) in tile l), int64."""
    out = np.empty(ids.shape, np.int64)
    for l in range(ids.shape[0]):
        seen = {}
        for i in range(ids.shape[1]):
            c = int(seg[l, i]) * m + int(ids[l, i])
            out[l, i] = int(g[l, c]) + seen.get(c, 0)
            seen[c] = seen.get(c, 0) + 1
    return out


@pytest.mark.parametrize("offset", [(1 << 24) + 1, (1 << 30) + 3])
def test_seg_bases_above_2_24_exact(offset):
    """Above 2^24 the Pallas float32 sum rounds; the port's int32 bodies are
    held against numpy, with distinct destinations."""
    rng = np.random.default_rng(offset % 89)
    spec, s = ops.DeltaSpec(8, 2**32 - 1), 11
    keys = torch.from_numpy(rng.integers(0, 2**32, (3, 256), dtype=np.uint64).astype(np.uint32))
    seg = torch.from_numpy(_seg_strip((3, 256), s, rng))
    g = tst.global_scan(mst.seg_spec_tile_histograms_plain(keys, seg, spec, s)) + offset
    want = _numpy_seg_positions(spec.emit(keys).numpy(), seg.numpy(), g.numpy(), 8)
    np.testing.assert_array_equal(mst.seg_spec_tile_positions(keys, seg, g, spec, s).numpy(), want)
    keys_r, _, pos_r, perm = mst.seg_spec_fused_postscan_reorder(keys, seg, g, None, spec, s)
    np.testing.assert_array_equal(perm.numpy(), want)
    assert np.unique(pos_r.numpy()).size == pos_r.numel()
    np.testing.assert_array_equal(np.sort(pos_r.numpy(), axis=1), np.sort(want, axis=1))


def test_one_key_segments_and_empty_rows():
    """A strip of one- to eight-key segments: every tile holds many runs,
    and most histogram columns are zero."""
    rng = np.random.default_rng(5)
    lens = rng.integers(1, 9, 2048)
    starts = (np.cumsum(lens) - lens)[np.cumsum(lens) - lens < 2048]
    seg = (np.searchsorted(starts, np.arange(2048), side="right") - 1).astype(np.int32)
    s = starts.size
    keys = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    spec = ops.DeltaSpec(2, 2**32)
    kt, st_ = torch.from_numpy(keys).view(4, 512), torch.from_numpy(seg).view(4, 512)
    hist = mst.seg_spec_tile_histograms(kt, st_, spec, s)
    assert hist.shape == (4, 2 * s) and int(hist.sum()) == 2048
    keys_r, _, _, perm = mst.seg_spec_fused_postscan_reorder(
        kt, st_, tst.global_scan(hist), None, spec, s)
    cid = seg * 2 + (keys >= 2**31)
    order = np.argsort(cid, kind="stable")
    np.testing.assert_array_equal(np.sort(perm.numpy().ravel()), np.arange(2048))
    np.testing.assert_array_equal(keys[order][perm.numpy().ravel()], keys)
    # within every tile the reorder is (segment, bucket)-major and stable
    for l in range(4):
        c = cid[512 * l:512 * (l + 1)]
        np.testing.assert_array_equal(keys_r[l].numpy(), keys[512 * l:512 * (l + 1)][np.argsort(c, kind="stable")])


def test_seg_radix_doors_are_bitfield_instances():
    rng = np.random.default_rng(6)
    keys = torch.from_numpy(rng.integers(0, 2**32, (2, 256), dtype=np.uint64).astype(np.uint32))
    seg = torch.from_numpy(_seg_strip((2, 256), 5, rng))
    spec = ops.BitfieldSpec(8, 8)
    h = radix_pass.seg_radix_tile_histograms(keys, seg, 8, 8, 5)
    assert torch.equal(h, tkops.seg_spec_tile_histograms(keys, seg, spec, 5))
    assert torch.equal(h, tkops.seg_radix_tile_histograms(keys, seg, 8, 8, 5))
    g = tst.global_scan(h)
    assert torch.equal(tkops.seg_radix_tile_positions(keys, seg, g, 8, 8, 5),
                       tkops.seg_spec_tile_positions(keys, seg, g, spec, 5))
    for a, b in zip(tkops.seg_radix_fused_postscan_reorder(keys, seg, g, None, 8, 8, 5),
                    tkops.seg_spec_fused_postscan_reorder(keys, seg, g, None, spec, 5)):
        assert (a is None and b is None) or torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_seg_wrappers_check_what_the_kernels_take():
    keys = torch.zeros((2, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        mst.seg_spec_tile_histograms(keys, keys, ops.DeltaSpec(4), 2)
    keys = torch.zeros((2, 256), dtype=torch.int32)
    seg = torch.zeros((2, 256), dtype=torch.int32)
    m = ops.DeltaSpec(4).num_buckets
    with pytest.raises(ValueError, match="segment ids"):
        mst._check_segments(seg.long(), keys, m, 2)
    with pytest.raises(ValueError, match="num_segments"):
        mst._check_segments(seg, keys, m, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        mst._check_segments(seg, keys, m, 1 << 30)
    assert mst._check_segments(seg, keys, m, 3) == 12


# ---------------------------------------------------------------------------
# (2) segment ids and the carry-form rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("starts,n", [
    ([0], 7), ([0, 0, 3, 3, 7], 7), ([0, 2, 5], 5), ([0, 0, 0], 0), ([0, 1, 2, 3], 4),
])
def test_segment_ids_from_starts_matches_jax(starts, n):
    want = jst.segment_ids_from_starts(jnp.asarray(starts, jnp.int32), n)
    got = tst.segment_ids_from_starts(torch.tensor(starts, dtype=torch.int32), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,s", [(1, 3), (2, 40), (13, 6), (256, 4)])
def test_seg_tile_local_matches_jax(m, s):
    rng = np.random.default_rng(m * 31 + s)
    ids = rng.integers(0, m, 600).astype(np.int32)
    segs = _seg_strip((1, 600), s, rng)[0]
    want = jst.seg_tile_local(jnp.asarray(ids), jnp.asarray(segs), m)
    got = tst.seg_tile_local(torch.from_numpy(ids), torch.from_numpy(segs), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# (3) the public op on every backend against repro.ops
# ---------------------------------------------------------------------------

def _uint_keys(n, rng):
    keys = rng.integers(0, 2**30, n, dtype=np.int64)
    wide = rng.random(n) < 0.05
    keys[wide] = rng.integers(0, 2**32, int(wide.sum()), dtype=np.int64)
    return keys.astype(np.uint32)


# name -> (n, starts, spec): empty first, middle (consecutive) and last
# segments, one segment, a single key, NaN keys per segment
def _op_case(name):
    rng = np.random.default_rng(len(name) * 7)
    if name == "empties":
        n = 1500
        return _uint_keys(n, rng), np.array([0, 0, 200, 200, 200, 1500], np.int32), jid.DeltaSpec(8)
    if name == "ragged-m256":
        n = 4099
        return _uint_keys(n, rng), _starts(n, 6, rng), jid.DeltaSpec(256, 2**32 - 1)
    if name == "one-segment":
        return _uint_keys(1000, rng), np.array([0], np.int32), jid.DeltaSpec(32)
    if name == "short-segments":
        n = 700
        lens = rng.integers(0, 5, 400)
        starts = np.minimum(np.cumsum(lens) - lens, n).astype(np.int32)
        return _uint_keys(n, rng), starts, jid.DeltaSpec(4)
    if name == "nan-even-f32":
        keys = rng.uniform(0.0, 1.0, 1024).astype(np.float32)
        keys[rng.choice(1024, 60, replace=False)] = np.nan
        return keys, np.array([0, 512, 900], np.int32), jid.EvenSpec(0.0, 1.0, 8)
    if name == "range-i32":
        keys = rng.integers(-(2**31), 2**31, 900, dtype=np.int64).astype(np.int32)
        return keys, _starts(900, 5, rng), jid.RangeSpec((-(2**30), 0, 5, 2**29))
    raise KeyError(name)


OP_CASES = ["empties", "ragged-m256", "one-segment", "short-segments", "nan-even-f32", "range-i32"]


@functools.lru_cache(maxsize=None)
def _jax_op(name):
    keys, starts, jspec = _op_case(name)
    vals = np.arange(keys.size, dtype=np.float32) * np.float32(0.25)
    kw = dict(backend="reference")
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    k, st_ = jnp.asarray(keys), jnp.asarray(starts)
    want = {
        "kv": tree(jops.segmented_multisplit(k, jspec, st_, jnp.asarray(vals), **kw)),
        "keys": tree(jops.segmented_multisplit(k, jspec, st_, **kw)),
        "counts_only": tree(jops.segmented_multisplit(k, jspec, st_, mode="counts_only", **kw)),
        "positions_only": tree(jops.segmented_multisplit(k, jspec, st_, mode="positions_only", **kw)),
    }
    return keys, vals, starts, convert_spec(jspec), want


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", OP_CASES)
def test_segmented_multisplit_matches_jax(name, backend, method):
    """Key-value and key-only reorder, counts_only and positions_only."""
    keys, vals, starts, spec, want = _jax_op(name)
    kw = dict(method=method, backend=backend, device="cpu")
    _assert_result(ops.segmented_multisplit(keys, spec, starts, vals, **kw), want["kv"])
    _assert_result(ops.segmented_multisplit(keys, spec, starts, **kw), want["keys"])
    for mode in ("counts_only", "positions_only"):
        _assert_result(ops.segmented_multisplit(keys, spec, starts, mode=mode, **kw), want[mode])


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_segment_equals_flat(backend):
    keys = _uint_keys(3000, np.random.default_rng(2))
    vals = np.arange(3000, dtype=np.int32)
    spec = ops.DeltaSpec(32)
    flat = ops.multisplit(keys, spec, vals, backend=backend, device="cpu")
    seg = ops.segmented_multisplit(keys, spec, [0], vals, backend=backend, device="cpu")
    assert seg.bucket_counts.shape == (1, 32)
    for f in ("keys", "values", "permutation"):
        assert torch.equal(getattr(seg, f).view(torch.int32), getattr(flat, f).view(torch.int32))
    assert torch.equal(seg.bucket_counts[0], flat.bucket_counts)
    assert torch.equal(seg.bucket_starts[0], flat.bucket_starts)


@pytest.mark.parametrize("mode", ["reorder", "counts_only", "positions_only"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_no_keys_and_no_segments(backend, mode):
    """n = 0 with s >= 1 and s = 0 with empty keys, against repro.ops."""
    spec, jspec = ops.DeltaSpec(4, 2**10), jid.DeltaSpec(4, 2**10)
    keys = np.zeros((0,), np.uint32)
    for starts in (np.zeros((3,), np.int32), np.zeros((0,), np.int32)):
        want = jops.segmented_multisplit(jnp.asarray(keys), jspec, jnp.asarray(starts),
                                         backend="reference", mode=mode)
        got = ops.segmented_multisplit(keys, spec, starts, backend=backend, mode=mode, device="cpu")
        _assert_result(got, jax.tree_util.tree_map(np.asarray, want))
        got = core_segmented(torch.from_numpy(keys), spec, starts, backend=backend, mode=mode,
                             device="cpu")
        _assert_result(got, jax.tree_util.tree_map(np.asarray, want))


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_keys_and_no_segments_key_value(backend):
    """s = 0 with empty keys and values, through the differentiable path."""
    keys, vals = np.zeros((0,), np.float32), np.zeros((0,), np.float32)
    starts = np.zeros((0,), np.int32)
    want = jops.segmented_multisplit(jnp.asarray(keys), jid.EvenSpec(0.0, 1.0, 4),
                                     jnp.asarray(starts), jnp.asarray(vals), backend="reference")
    got = ops.segmented_multisplit(keys, ops.EvenSpec(0.0, 1.0, 4), starts, vals,
                                   backend=backend, device="cpu")
    _assert_result(got, jax.tree_util.tree_map(np.asarray, want))


@pytest.mark.parametrize("kv", [False, True])
def test_ops_builds_the_segmented_plan_through_its_cache(kv):
    keys, vals, starts, spec, want = _jax_op("ragged-m256")
    vals = vals if kv else None
    ops.segmented_multisplit(keys, spec, starts, vals, method="wms", device="cpu")
    hits = ops._plan_cached.cache_info().hits
    got = ops.segmented_multisplit(keys, spec, starts, vals, method="wms", device="cpu")
    assert ops._plan_cached.cache_info().hits == hits + 1
    _assert_result(got, want["kv"] if kv else want["keys"])


@pytest.mark.parametrize("starts,ok", [
    ([0, 3, 5], True), ([0, 5, 3], False), ([1, 5], False), ([0, 11], False),
])
def test_host_segment_starts_are_checked_before_they_move(starts, ok):
    """Host starts are checked on the host: the target device (meta here,
    which cannot be read back) is never asked."""
    for host in (np.asarray(starts, np.int32), torch.tensor(starts)):
        if ok:
            out = ops._segment_starts(host, 10, "meta")
            assert out.device.type == "meta" and out.dtype == torch.int32
        else:
            with pytest.raises(ValueError, match="segment_starts"):
                ops._segment_starts(host, 10, "meta")


def test_no_segments_refuse_keys():
    with pytest.raises(ValueError, match="0 segments"):
        ops.segmented_multisplit(np.zeros(8, np.uint32), ops.DeltaSpec(4), np.zeros(0, np.int32),
                                 device="cpu")
    with pytest.raises(ValueError):
        jops.segmented_multisplit(jnp.zeros((8,), jnp.uint32), jid.DeltaSpec(4),
                                  np.zeros((0,), np.int32))


def test_nan_keys_land_in_each_segments_last_bucket():
    keys, _, starts, spec, _ = _jax_op("nan-even-f32")
    out = ops.segmented_multisplit(keys, spec, starts, backend="cuda", device="cpu")
    ends = list(starts[1:]) + [keys.size]
    for i, (lo, hi) in enumerate(zip(starts, ends)):
        b0 = lo + int(out.bucket_starts[i, -1])
        span = out.keys.numpy()[b0:b0 + int(out.bucket_counts[i, -1])]
        assert np.isnan(span).sum() == np.isnan(keys[lo:hi]).sum() > 0


def test_cuda_backend_routes_through_the_segmented_doors(monkeypatch):
    calls = []
    for name in ("seg_spec_tile_histograms", "seg_spec_tile_positions",
                 "seg_spec_fused_postscan_reorder", "spec_tile_histograms"):
        real = getattr(tkops, name)
        monkeypatch.setattr(tkops, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    keys = _uint_keys(5000, np.random.default_rng(1))
    starts = np.array([0, 10, 10, 4000], np.int32)
    spec = ops.DeltaSpec(64)
    ops.segmented_multisplit(keys, spec, starts, keys, method="bms", device="cpu")
    ops.segmented_multisplit(keys, spec, starts, method="dms", device="cpu")
    ops.segmented_multisplit(keys, spec, starts, mode="counts_only", device="cpu")
    ops.segmented_radix_sort(keys, starts, radix_bits=8, key_bits=16, device="cpu")
    assert calls == (["seg_spec_tile_histograms", "seg_spec_fused_postscan_reorder",
                      "seg_spec_tile_histograms", "seg_spec_tile_positions",
                      "seg_spec_tile_histograms"]
                     + ["seg_spec_tile_histograms", "seg_spec_fused_postscan_reorder"] * 2)
    plan = tpipe.make_segmented_plan(5000, 4, 64, backend="cuda", bucket_fn=spec)
    assert plan.stages() == ("layout:segmented[4]", "prescan:fused-label-kernel", "scan:global",
                             "postscan:fused-label-reorder-kernel", "scatter:bucket-major")
    assert plan.tile == tpipe.CUDA_TILE and plan.m_eff == 256 and plan.layout == "segmented"


# ---------------------------------------------------------------------------
# (4) segmented radix sort
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_seg_sort(n, s, kv, radix_bits):
    rng = np.random.default_rng(n + s + radix_bits)
    keys = _uint_keys(n, rng) ^ np.uint32(0x5A5A5A5A)
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    starts = _starts(n, s, rng) if n else np.zeros(s, np.int32)
    res = jops.segmented_radix_sort(jnp.asarray(keys), jnp.asarray(starts),
                                    jnp.asarray(vals) if kv else None,
                                    radix_bits=radix_bits, backend="reference")
    return keys, vals, starts, [None if r is None else np.asarray(r) for r in res]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("n,s,radix_bits", [(0, 2, 8), (1, 1, 8), (2000, 7, 8), (1000, 4, 5)])
def test_segmented_radix_sort_matches_jax(n, s, radix_bits, kv, backend):
    keys, vals, starts, (want_k, want_v) = _jax_seg_sort(n, s, kv, radix_bits)
    got_k, got_v = ops.segmented_radix_sort(keys, starts, vals if kv else None,
                                            radix_bits=radix_bits, backend=backend, device="cpu")
    np.testing.assert_array_equal(_bits(got_k), _bits(want_k))
    assert (got_v is None) == (not kv)
    if kv:
        np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
    ends = list(starts[1:]) + [n]
    for a, e in zip(starts, ends):                       # each segment sorted alone
        np.testing.assert_array_equal(got_k.numpy()[a:e], np.sort(keys[a:e]))


def test_segmented_radix_pipeline_builds_the_strip_once(monkeypatch):
    ids_made = []
    real = tst.segment_ids_from_starts
    monkeypatch.setattr(tst, "segment_ids_from_starts", lambda *a: ids_made.append(1) or real(*a))
    rng = np.random.default_rng(4)
    keys = _uint_keys(3000, rng)
    starts = _starts(3000, 5, rng)
    out, _ = ops.segmented_radix_sort(keys, starts, backend="vmap", device="cpu")
    assert len(ids_made) == 1
    for a, e in zip(starts, list(starts[1:]) + [3000]):
        np.testing.assert_array_equal(out.numpy()[a:e], np.sort(keys[a:e]))


# ---------------------------------------------------------------------------
# (5) the key-value gradient, (6) malformed starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_segmented_key_value_gradient_matches_jax_grad(backend):
    rng = np.random.default_rng(3)
    n = 777
    keys = rng.uniform(-4, 12, n).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    wk = rng.standard_normal(n).astype(np.float32)
    wv = rng.standard_normal(n).astype(np.float32)
    starts = np.array([0, 0, 100, 400, 400, 777], np.int32)
    jspec = jid.EvenSpec(-3.7, 11.3, 37)

    def loss(k, v):
        r = jops.segmented_multisplit(k, jspec, jnp.asarray(starts), v, backend="reference")
        return (r.keys * wk).sum() + (r.values * wv).sum()

    gk_want, gv_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(keys), jnp.asarray(vals))
    kt = torch.tensor(keys, requires_grad=True)
    vt = torch.tensor(vals, requires_grad=True)
    res = ops.segmented_multisplit(kt, convert_spec(jspec), starts, vt, backend=backend,
                                   device="cpu")
    assert res.permutation.requires_grad is False
    ((res.keys * torch.from_numpy(wk)).sum() + (res.values * torch.from_numpy(wv)).sum()).backward()
    np.testing.assert_array_equal(_bits(kt.grad), _bits(gk_want))
    np.testing.assert_array_equal(_bits(vt.grad), _bits(gv_want))


@pytest.mark.parametrize("starts", [
    [1, 5], [0, 5, 3], [0, 2, 11], [-1, 0], [[0, 1]], [0.0, 1.0],
])
def test_malformed_segment_starts_raise(starts):
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises(ValueError, match="segment_starts"):
        ops.segmented_multisplit(keys, ops.DeltaSpec(4, 16), np.asarray(starts), device="cpu")
    with pytest.raises(ValueError, match="segment_starts"):
        ops.segmented_radix_sort(keys, np.asarray(starts), device="cpu")


@pytest.mark.parametrize("call,err", [
    (lambda: tpipe.make_plan(8, 4, segments=0), ValueError),
    (lambda: tpipe.make_plan(8, 4, segments=2, batch=2), ValueError),
    (lambda: tpipe.make_segmented_plan(8, 2, 4)(torch.zeros(8, dtype=torch.int32)), ValueError),
    (lambda: tpipe.make_segmented_plan(8, 2, 4, bucket_fn=ops.DeltaSpec(4))(
        torch.zeros(8, dtype=torch.int32), segment_starts=[0, 1, 2]), ValueError),
    (lambda: tpipe.make_plan(8, 4, bucket_fn=ops.DeltaSpec(4))(
        torch.zeros(8, dtype=torch.int32), segment_starts=[0]), ValueError),
    (lambda: ops.segmented_multisplit(np.zeros(8, np.uint32), ops.DeltaSpec(4), [0],
                                      np.zeros(8, np.int32), mode="counts_only", device="cpu"),
     ValueError),
])
def test_segmented_plan_refusals(call, err):
    with pytest.raises(err):
        call()
