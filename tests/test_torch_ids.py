"""Materialised labels (the ids strip) against the JAX package, bitwise.

A programmer's bucket function (``CallableSpec``), and a declarative spec
over keys that are not 32 bits wide in a partial mode, materialise their
labels: the ``cuda`` backend then runs the ids kernels. On the CPU their
wrappers run their plain versions, so these tests hold, on the same numpy
inputs made from a seed:

* each of the seven ids wrappers (``tile_histograms``, ``tile_positions``,
  ``fused_postscan_reorder``, their ``seg_`` forms and ``spec_bucket_ids``)
  against its Pallas twin through ``repro.kernels.ops`` in interpret mode,
  where the Pallas float32 ``G + rank`` is exact (G < 2^24), and against
  numpy above it;
* ``repro_torch.ops`` and ``repro_torch.core`` with callable specs on the
  ``cuda`` backend against ``repro.ops`` and ``repro.core`` (backends
  ``reference`` and ``pallas-interpret``), in every field, and the
  key-value gradient against ``jax.grad``;
* off-width keys in the partial modes against ``pallas-interpret``.

Keys and values are compared as int32 bit patterns. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.histogram as jhist
import repro.core.multisplit as jcore
import repro.ops as jops
from repro.core import identifiers as jid
from repro.kernels import ops as jkops
from repro_torch import ops
from repro_torch.convert import convert_spec
from repro_torch.core import histogram as thist
from repro_torch.core import multisplit as tcore
from repro_torch.core import pipeline as tpipe
from repro_torch.core.pipeline import stages as tst
from repro_torch.kernels import multisplit_tile as mst
from repro_torch.kernels import ops as tkops
from test_torch_kernels import SPECS, _keys

import _torch_threads

_torch_threads.pin()

METHODS = ["dms", "wms", "bms"]
MODES = ["reorder", "counts_only", "positions_only"]
FIELDS = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")


def _bits(a) -> np.ndarray:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _eq(got, want) -> None:
    assert (got is None) == (want is None)
    if got is not None:
        assert got.detach().numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _assert_result(got, want, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert tuple(g.shape) == np.asarray(w).shape, f
            _eq(g, w)


def _seg_strip(shape, s, rng):
    """(L, T) int32 segment ids of s ragged segments over the flattened
    tiles, two of them empty when s > 2: non-decreasing along every tile."""
    n = shape[0] * shape[1]
    starts = np.concatenate([[0], np.sort(rng.integers(0, n + 1, s - 1))])
    if s > 2:
        starts[1] = starts[0]
        starts[-1] = starts[-2]
    seg = np.searchsorted(starts, np.arange(n), side="right") - 1
    return seg.astype(np.int32).reshape(shape)


# ---------------------------------------------------------------------------
# (1) the ids wrappers' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

# (m, (L, T), key dtype, s): m from 1 to 256, every key type, one segment,
# a few (two of them empty) and more segments than some tiles hold keys
IDS_CASES = [
    (1, (2, 128), np.int32, 1),
    (2, (4, 512), np.uint32, 3),
    (7, (3, 200), np.float32, 17),
    (32, (2, 256), np.int32, 3),
    (256, (2, 1024), np.uint32, 17),
]


def _ids_case(case, seed):
    m, shape, dtype, s = case
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, m, shape).astype(np.int32)
    keys = _keys(dtype, shape, rng, jid.DeltaSpec(2))
    vals = rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    return ids, keys, vals, _seg_strip(shape, s, rng)


def _iid(case):
    m, shape, dtype, s = case
    return f"m{m}-{np.dtype(dtype).name}-{shape[0]}x{shape[1]}-s{s}"


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", IDS_CASES, ids=_iid)
def test_tile_histograms_plain_vs_pallas(case):
    m = case[0]
    ids, _, _, _ = _ids_case(case, 1)
    want = jkops.tile_histograms(jnp.asarray(ids), m, interpret=True)
    _eq(tkops.tile_histograms(torch.from_numpy(ids), m), want)


@pytest.mark.parametrize("case", IDS_CASES, ids=_iid)
def test_tile_positions_plain_vs_pallas(case):
    m = case[0]
    ids, _, _, _ = _ids_case(case, 2)
    (tids,) = _t(ids)
    g = tst.global_scan(mst.tile_histograms_plain(tids, m))
    want = jkops.tile_positions(jnp.asarray(ids), jnp.asarray(g.numpy()), m, interpret=True)
    _eq(tkops.tile_positions(tids, g, m), want)


# key-only and key-value in turn over the cases: each is one Pallas compile
REORDER_CASES = [(case, i % 2 == 1) for i, case in enumerate(IDS_CASES)] + [(IDS_CASES[1], False)]
_RID = [f"{_iid(c)}-{'kv' if kv else 'k'}" for c, kv in REORDER_CASES]


@pytest.mark.parametrize("case,key_value", REORDER_CASES, ids=_RID)
def test_fused_postscan_reorder_plain_vs_pallas(case, key_value):
    m = case[0]
    ids, keys, vals, _ = _ids_case(case, 3)
    tids, tkeys, tvals = _t(ids, keys, vals)
    g = tst.global_scan(mst.tile_histograms_plain(tids, m))
    want = jkops.fused_postscan_reorder(
        jnp.asarray(ids), jnp.asarray(g.numpy()), jnp.asarray(keys),
        jnp.asarray(vals) if key_value else None, m, interpret=True)
    got = tkops.fused_postscan_reorder(tids, g, tkeys, tvals if key_value else None, m)
    assert (got[1] is None) == (not key_value)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("case", IDS_CASES, ids=_iid)
def test_seg_tile_histograms_plain_vs_pallas(case):
    m, s = case[0], case[3]
    ids, _, _, seg = _ids_case(case, 4)
    want = jkops.seg_tile_histograms(jnp.asarray(ids), jnp.asarray(seg), m, s, interpret=True)
    _eq(tkops.seg_tile_histograms(*_t(ids, seg), m, s), want)


@pytest.mark.parametrize("case", IDS_CASES, ids=_iid)
def test_seg_tile_positions_plain_vs_pallas(case):
    m, s = case[0], case[3]
    ids, _, _, seg = _ids_case(case, 5)
    tids, tseg = _t(ids, seg)
    g = tst.global_scan(mst.seg_tile_histograms_plain(tids, tseg, m, s))
    want = jkops.seg_tile_positions(jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(g.numpy()),
                                    m, s, interpret=True)
    _eq(tkops.seg_tile_positions(tids, tseg, g, m, s), want)


@pytest.mark.parametrize("case,key_value", REORDER_CASES, ids=_RID)
def test_seg_fused_postscan_reorder_plain_vs_pallas(case, key_value):
    m, s = case[0], case[3]
    ids, keys, vals, seg = _ids_case(case, 6)
    tids, tseg, tkeys, tvals = _t(ids, seg, keys, vals)
    g = tst.global_scan(mst.seg_tile_histograms_plain(tids, tseg, m, s))
    want = jkops.seg_fused_postscan_reorder(
        jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(g.numpy()), jnp.asarray(keys),
        jnp.asarray(vals) if key_value else None, m, s, interpret=True)
    got = tkops.seg_fused_postscan_reorder(tids, tseg, g, tkeys, tvals if key_value else None, m, s)
    for a, b in zip(got, want):
        _eq(a, b)


def _np_destinations(ids, g):
    """eq. (2) in numpy: G[l, b] + the stable rank of each id in its tile."""
    out = np.empty(ids.shape, np.int64)
    for l, row in enumerate(ids):
        rank = np.zeros_like(row)
        for b in np.unique(row):
            at = np.nonzero(row == b)[0]
            rank[at] = np.arange(at.size)
        out[l] = g[l, row] + rank
    return out


@pytest.mark.parametrize("segmented", [False, True])
def test_destinations_past_2_24_are_exact(segmented):
    """Bases above 2^24, where the Pallas float32 sum rounds: the plain
    versions (and so the kernels held against them) stay exact int32."""
    rng = np.random.default_rng(7)
    m, s, shape = 32, 5, (4, 512)
    ids = rng.integers(0, m, shape).astype(np.int32)
    seg = _seg_strip(shape, s, rng)
    keys = rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    tids, tseg, tkeys = _t(ids, seg, keys)
    if segmented:
        hist = mst.seg_tile_histograms_plain(tids, tseg, m, s)
        cid = seg * m + ids
    else:
        hist = mst.tile_histograms_plain(tids, m)
        cid = ids
    g = tst.global_scan(hist) + (1 << 24) + 1
    want = _np_destinations(cid, g.numpy().astype(np.int64))
    assert want.max() > 1 << 24
    if segmented:
        pos = mst.seg_tile_positions_plain(tids, tseg, g, m, s)
        perm = mst.seg_fused_postscan_reorder_plain(tids, tseg, g, tkeys, None, m, s)[3]
    else:
        pos = mst.tile_positions_plain(tids, g, m)
        perm = mst.fused_postscan_reorder_plain(tids, g, tkeys, None, m)[3]
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(perm.numpy(), want)


def test_ids_outside_the_buckets_clamp():
    """An id outside [0, m) is outside the contract; every ids wrapper reads
    it as min(max(id, 0), m - 1), as the kernels' identity label does."""
    rng = np.random.default_rng(8)
    m, s, shape = 9, 3, (3, 256)
    raw = rng.integers(-20, m + 20, shape).astype(np.int32)
    seg = _seg_strip(shape, s, rng)
    keys = rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)
    traw, tclip, tseg, tkeys = _t(raw, np.clip(raw, 0, m - 1), seg, keys)
    np.testing.assert_array_equal(mst.clamp_ids(traw, m).numpy(), np.clip(raw, 0, m - 1))
    g = tst.global_scan(mst.tile_histograms_plain(tclip, m))
    gs = tst.global_scan(mst.seg_tile_histograms_plain(tclip, tseg, m, s))
    pairs = [
        (tkops.tile_histograms(traw, m), mst.spec_tile_histograms_plain(tclip, convert_spec(
            jid.IdentitySpec(m)))),
        (tkops.tile_positions(traw, g, m), tkops.tile_positions(tclip, g, m)),
        (tkops.seg_tile_histograms(traw, tseg, m, s), tkops.seg_tile_histograms(tclip, tseg, m, s)),
        (tkops.seg_tile_positions(traw, tseg, gs, m, s),
         tkops.seg_tile_positions(tclip, tseg, gs, m, s)),
    ]
    pairs += list(zip(tkops.fused_postscan_reorder(traw, g, tkeys, None, m),
                      tkops.fused_postscan_reorder(tclip, g, tkeys, None, m)))
    pairs += list(zip(tkops.seg_fused_postscan_reorder(traw, tseg, gs, tkeys, tkeys, m, s),
                      tkops.seg_fused_postscan_reorder(tclip, tseg, gs, tkeys, tkeys, m, s)))
    for got, want in pairs:
        assert (got is None and want is None) or torch.equal(got, want)


# ---------------------------------------------------------------------------
# (2) spec_bucket_ids, even_bucket_ids and device_histogram
# ---------------------------------------------------------------------------

SPEC_ID_CASES = [
    (spec, dtype) for spec in SPECS for dtype in (np.uint32, np.int32, np.float32)
    if not (isinstance(spec, jid.BitfieldSpec) and dtype == np.float32)
]


@pytest.mark.parametrize("spec,dtype", SPEC_ID_CASES,
                         ids=[f"{s.name}-{np.dtype(d).name}" for s, d in SPEC_ID_CASES])
def test_spec_bucket_ids_plain_vs_pallas(spec, dtype):
    rng = np.random.default_rng(9)
    keys = _keys(dtype, (2, 256), rng, spec)
    want = jkops.spec_bucket_ids(jnp.asarray(keys), spec, interpret=True)
    tkeys = torch.from_numpy(keys)
    got = tkops.spec_bucket_ids(tkeys, convert_spec(spec))
    _eq(got, want)
    # the ids path of a declarative spec is its fused path
    tspec = convert_spec(spec)
    assert torch.equal(tkops.tile_histograms(got, spec.num_buckets),
                       tkops.spec_tile_histograms(tkeys, tspec))


@pytest.mark.parametrize("lo,hi,m", [(-3.7, 11.3, 37), (0.0, 1.0, 256), (-1e9, 1e9, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_even_bucket_ids_plain_vs_pallas(lo, hi, m, dtype):
    rng = np.random.default_rng(10)
    keys = _keys(dtype, (3, 200), rng, jid.EvenSpec(lo, hi, m))
    want = jkops.even_bucket_ids(jnp.asarray(keys), lo, hi, m, interpret=True)
    _eq(tkops.even_bucket_ids(torch.from_numpy(keys), lo, hi, m), want)


@pytest.mark.parametrize("m,shape", [(7, (3, 200)), (256, (2, 1024))])
def test_device_histogram_plain_vs_pallas(m, shape):
    ids = np.random.default_rng(11).integers(0, m, shape).astype(np.int32)
    want = jkops.device_histogram(jnp.asarray(ids), m, interpret=True)
    got = tkops.device_histogram(torch.from_numpy(ids), m)
    assert tuple(got.shape) == (m,)
    _eq(got, want)


# ---------------------------------------------------------------------------
# (3) callable specs end to end on the cuda backend
# ---------------------------------------------------------------------------

DELTA, FLOOR, M_SSSP = 150, 1000, 10


def _sssp_jax(u):
    return jnp.clip((u - FLOOR) // DELTA, 0, M_SSSP - 1).astype(jnp.int32)


def _sssp_torch(u):
    """The delta-stepping bucket of ``examples/sssp.py``, returned as int64
    (the plan casts it)."""
    return torch.clamp((u.long() - FLOOR) // DELTA, 0, M_SSSP - 1)


def _hash_jax(u):
    return ((u.astype(jnp.uint32) * jnp.uint32(2654435761)) >> 27).astype(jnp.int32)


def _hash_torch(u):
    """A multiplicative hash into 32 buckets; a strided view of its result."""
    h = (((u.long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF) >> 27
    return torch.stack([h, h], 1)[:, 0]


CALLABLES = {
    "sssp": (jid.from_fn(_sssp_jax, M_SSSP), ops.from_fn(_sssp_torch, M_SSSP, "sssp")),
    "hash": (jid.from_fn(_hash_jax, 32), ops.from_fn(_hash_torch, 32, "hash")),
}


def _dist_keys(n, seed):
    """int32 distances around the delta-stepping window, and vertex ids."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, FLOOR + DELTA * (M_SSSP + 3), n).astype(np.int32)
    return keys, rng.permutation(n).astype(np.int32)


def _tree(res):
    return jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("which", sorted(CALLABLES))
def test_callable_multisplit_on_cuda_matches_jax(which, method, mode):
    jspec, tspec = CALLABLES[which]
    keys, vals = _dist_keys(5000, 12)
    want = _tree(jops.multisplit(jnp.asarray(keys), jspec, method=method, mode=mode,
                                 backend="reference"))
    _assert_result(ops.multisplit(keys, tspec, method=method, mode=mode, backend="cuda",
                                  device="cpu"), want)
    if mode == "reorder":
        want = _tree(jops.multisplit(jnp.asarray(keys), jspec, jnp.asarray(vals), method=method,
                                     backend="reference"))
        _assert_result(ops.multisplit(keys, tspec, vals, method=method, backend="cuda",
                                      device="cpu"), want)


@pytest.mark.parametrize("method", METHODS)
def test_callable_key_value_gradient_matches_jax_grad(method):
    jspec, tspec = CALLABLES["hash"]
    rng = np.random.default_rng(13)
    keys = rng.integers(-(2**31), 2**31, 3000, dtype=np.int64).astype(np.int32)
    vals = rng.standard_normal(3000).astype(np.float32)
    w = rng.standard_normal(3000).astype(np.float32)

    def loss(v):
        r = jops.multisplit_key_value(jnp.asarray(keys), v, jspec, method=method,
                                      backend="reference")
        return (r.values * w).sum()

    g_want = jax.grad(loss)(jnp.asarray(vals))
    vt = torch.tensor(vals, requires_grad=True)
    res = ops.multisplit_key_value(keys, vt, tspec, method=method, backend="cuda", device="cpu")
    want = _tree(jops.multisplit_key_value(jnp.asarray(keys), jnp.asarray(vals), jspec,
                                           method=method, backend="reference"))
    _assert_result(res, want)
    (res.values * torch.from_numpy(w)).sum().backward()
    _eq(vt.grad, g_want)


@pytest.mark.parametrize("which", sorted(CALLABLES))
def test_callable_histogram_on_cuda_matches_jax(which):
    jspec, tspec = CALLABLES[which]
    keys, _ = _dist_keys(7000, 14)
    want = jops.histogram(jnp.asarray(keys), jspec, backend="pallas-interpret")
    _eq(ops.histogram(keys, tspec, backend="cuda", device="cpu"), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method", METHODS)
def test_callable_segmented_multisplit_on_cuda_matches_jax(method, mode):
    jspec, tspec = CALLABLES["sssp"]
    keys, vals = _dist_keys(6000, 15)
    starts = np.array([0, 0, 700, 700, 4100, 5999, 6000], np.int32)
    kw = dict(method=method, mode=mode)
    want = _tree(jops.segmented_multisplit(jnp.asarray(keys), jspec, jnp.asarray(starts),
                                           backend="reference", **kw))
    _assert_result(ops.segmented_multisplit(keys, tspec, starts, backend="cuda", device="cpu",
                                            **kw), want)
    if mode == "reorder":
        want = _tree(jops.segmented_multisplit(jnp.asarray(keys), jspec, jnp.asarray(starts),
                                               jnp.asarray(vals), backend="reference", **kw))
        _assert_result(ops.segmented_multisplit(keys, tspec, starts, vals, backend="cuda",
                                                device="cpu", **kw), want)


def test_core_multisplit_runs_the_sssp_bucketing_like_jax():
    """The call ``examples/sssp.py`` makes: a closure over the frontier's
    floor, vertex ids as values, wms at tile 1024."""
    jspec, tspec = CALLABLES["sssp"]
    keys, vals = _dist_keys(4096, 17)
    want = _tree(jcore.multisplit(jnp.asarray(keys), jspec, jnp.asarray(vals), method="wms",
                                  tile=1024, backend="reference"))
    got = tcore.multisplit(keys, tspec, vals, method="wms", tile=1024, device="cpu")
    _assert_result(got, want)
    _assert_result(tcore.multisplit_ref(torch.from_numpy(keys), tspec, torch.from_numpy(vals)),
                   _tree(jcore.multisplit_ref(jnp.asarray(keys), jspec, jnp.asarray(vals))))


def test_core_stage_helpers_match_jax():
    rng = np.random.default_rng(18)
    ids = rng.integers(0, 13, (4, 300)).astype(np.int32)
    tids = torch.from_numpy(ids)
    h = tcore.prescan(tids, 13)
    _eq(h, jcore.prescan(jnp.asarray(ids), 13))
    _eq(tcore.tile_histogram(tids[0], 13), jcore.tile_histogram(jnp.asarray(ids[0]), 13))
    g = tst.global_scan(h)
    _eq(tcore.postscan_positions(tids, g, 13),
        jcore.postscan_positions(jnp.asarray(ids), jnp.asarray(g.numpy()), 13))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32])
def test_core_histogram_even_and_range_match_jax(dtype):
    rng = np.random.default_rng(19)
    keys = _keys(dtype, (5000,), rng, jid.EvenSpec(-3.7, 11.3, 37))
    want = jhist.histogram_even(jnp.asarray(keys), -3.7, 11.3, 37, backend="pallas-interpret")
    _eq(thist.histogram_even(keys, -3.7, 11.3, 37, backend="cuda", device="cpu"), want)
    splitters = np.array([0, 3, 7, 10], dtype)
    want = jhist.histogram_range(jnp.asarray(keys), jnp.asarray(splitters), backend="reference")
    _eq(thist.histogram_range(keys, splitters, device="cpu"), want)
    _eq(thist.histogram(keys, ops.range_buckets(splitters), backend="vmap", device="cpu"), want)


@pytest.mark.parametrize("bad", ["device", "shape"])
def test_labels_must_lie_beside_the_keys(bad):
    """The callable runs where the keys lie and returns their shape: labels
    elsewhere are refused, never copied there."""
    if bad == "device":
        fn = ops.from_fn(lambda k: (k % 4).to("meta"), 4)
    else:
        fn = ops.from_fn(lambda k: (k % 4)[:-1], 4)
    with pytest.raises(ValueError, match="bucket function"):
        ops.multisplit(np.arange(100, dtype=np.int32), fn, backend="cuda", device="cpu")


# ---------------------------------------------------------------------------
# (4) off-width keys in the partial modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.int64])
def test_off_width_keys_take_the_ids_path_in_partial_modes(dtype):
    """The JAX rule: the key width is checked only where keys are reordered;
    counts_only and positions_only materialise the labels of off-width keys
    and run the ids kernels (int64 under JAX's 64-bit mode)."""
    rng = np.random.default_rng(20)
    info = np.iinfo(dtype)
    keys = rng.integers(max(info.min, -(2**40)), min(info.max, 2**40), 1500).astype(dtype)
    delta = jid.DeltaSpec(16, 2**15 if dtype == np.int16 else 2**32)
    with jax.enable_x64(dtype == np.int64):
        jkeys = jnp.asarray(keys)
        assert jkeys.dtype == dtype
        want = jops.histogram(jkeys, delta, backend="pallas-interpret")
        _eq(ops.histogram(keys, convert_spec(delta), backend="cuda", device="cpu"), want)
        want = _tree(jops.multisplit(jkeys, delta, mode="positions_only",
                                     backend="pallas-interpret"))
    _assert_result(ops.multisplit(keys, convert_spec(delta), mode="positions_only",
                                  backend="cuda", device="cpu"), want)
    with pytest.raises(ValueError, match="32-bit keys"):
        ops.multisplit(keys, convert_spec(delta), backend="cuda", device="cpu")


# ---------------------------------------------------------------------------
# (5) routing: callable plans take the ids doors
# ---------------------------------------------------------------------------

IDS_DOORS = ("tile_histograms", "tile_positions", "fused_postscan_reorder",
             "seg_tile_histograms", "seg_tile_positions", "seg_fused_postscan_reorder")
SPEC_DOORS = tuple(f"spec_{d}" for d in IDS_DOORS[:3]) + tuple(
    f"seg_spec_{d[4:]}" for d in IDS_DOORS[3:])


def test_callable_plans_route_through_the_ids_doors(monkeypatch):
    calls = []
    for name in IDS_DOORS + SPEC_DOORS:
        real = getattr(tkops, name)
        monkeypatch.setattr(tkops, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    _, tspec = CALLABLES["sssp"]
    keys, vals = _dist_keys(5000, 21)
    starts = np.array([0, 10, 10, 4000], np.int32)
    ops.multisplit(keys, tspec, vals, method="bms", backend="cuda", device="cpu")
    ops.multisplit(keys, tspec, method="dms", backend="cuda", device="cpu")
    ops.histogram(keys, tspec, backend="cuda", device="cpu")
    ops.segmented_multisplit(keys, tspec, starts, vals, method="wms", device="cpu")
    ops.segmented_multisplit(keys, tspec, starts, mode="positions_only", device="cpu")
    ops.histogram(keys.astype(np.int16), ops.DeltaSpec(16, 2**15), backend="cuda", device="cpu")
    assert calls == ["tile_histograms", "fused_postscan_reorder",
                     "tile_histograms", "tile_positions", "tile_histograms",
                     "seg_tile_histograms", "seg_fused_postscan_reorder",
                     "seg_tile_histograms", "seg_tile_positions", "tile_histograms"]
    plan = tpipe.make_plan(5000, M_SSSP, backend="cuda", bucket_fn=tspec)
    assert plan.stages() == ("prescan:kernel", "scan:global", "postscan:fused-reorder-kernel",
                             "scatter:bucket-major")
    assert tpipe.make_plan(5000, M_SSSP, method="dms", mode="positions_only", backend="cuda",
                           bucket_fn=tspec, segments=3).stages() == (
        "layout:segmented[3]", "prescan:kernel", "scan:global", "postscan:positions-kernel")
    assert tpipe.make_plan(5000, M_SSSP, backend="vmap", bucket_fn=tspec).stages()[2] == (
        "postscan:fused-reorder-vmap")
