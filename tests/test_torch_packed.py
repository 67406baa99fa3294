"""The packed-counter family (K1p-K3p) against the JAX package, bitwise.

The packed family ranks with 8-bit subword counters, four to a word, and a
two-level (subtile -> tile) scan (paper §4.3). It gives the onehot family's
bits; it is a cost axis. On the CPU the cuda backend's packed wrappers run
their plain versions, so these tests hold, on the same numpy inputs made
from a seed:

* ``packed_layout``'s guard and auto subtile, and the plain bodies, against
  ``repro.kernels.common``;
* each packed wrapper, in its four forms ({spec labels | ids strip} ×
  {flat | segmented}), against its Pallas twin through
  ``repro.kernels.ops`` in interpret mode, bases past 2^24 included (the
  JAX packed kernels pick G in 16-bit halves and are exact there), and
  against the port's onehot wrappers;
* the ops with ``family="packed"`` on ``reference``, ``vmap`` and ``cuda``
  against ``repro.ops`` with ``family="packed"`` on ``vmap`` and
  ``pallas-interpret``;
* family resolution, the stage tags, and the core entry points' defaults.

Integers, keys and values are compared as int32 bit patterns. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import identifiers as jid
from repro.kernels import common as jcommon
from repro.kernels import ops as jkops
from repro_torch import ops
from repro_torch.convert import convert_spec
from repro_torch.core import multisplit as tcore
from repro_torch.core import pipeline as tpipe
from repro_torch.core import sort as tsort
from repro_torch.core.pipeline import registry as tregistry
from repro_torch.core.pipeline import stages as tst
from repro_torch.kernels import common, multisplit_tile as mst
from repro_torch.kernels import ops as tkops

import _fresh_process
import _torch_threads

_torch_threads.pin()

BACKENDS = ["reference", "vmap", "cuda"]
FIELDS = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")
BIG = (1 << 24) + 1          # bases past 2^24


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
    """(L, T) int32 ids of s ragged segments, two empty when s > 2."""
    n = shape[0] * shape[1]
    starts = np.concatenate([[0], np.sort(rng.integers(0, n + 1, s - 1))])
    if s > 2:
        starts[1] = starts[0]
        starts[-1] = starts[-2]
    return (np.searchsorted(starts, np.arange(n), side="right") - 1).astype(np.int32).reshape(shape)


def _uint_keys(shape, rng):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _vals(shape, rng):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


# ---------------------------------------------------------------------------
# (1) the layout guard and the plain bodies against repro.kernels.common
# ---------------------------------------------------------------------------

LAYOUTS = [
    (4096, 256, 8, None), (100, 3, 8, None), (1, 1, 8, None), (300, 5, 8, 255),
    (1000, 7, 4, 15), (1000, 7, 16, 1000), (64, 2, 2, None), (70000, 9, 16, None),
    (0, 4, 8, None), (10, 0, 8, None), (10, 4, 3, None), (10, 4, 8, 0), (300, 4, 8, 256),
    (100, 4, 4, 16), (100, 4, 1, 2),
]


@pytest.mark.parametrize("tile,m,bits,subtile", LAYOUTS)
def test_packed_layout_matches_jax(tile, m, bits, subtile):
    """The same geometry, or the same ValueError, for the same arguments;
    subtile = 2^bits - 1 (the cap) is accepted."""
    kw = {} if subtile is None else {"subtile": subtile}
    try:
        want = jcommon.packed_layout(tile, m, bits, **kw)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            common.packed_layout(tile, m, bits, **kw)
        assert str(got.value) == str(err)
        return
    got = common.packed_layout(tile, m, bits, **kw)
    for f in ("tile", "m_eff", "bits", "k", "w", "subtile", "n_sub"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.lane_mask == int(want.lane_mask)


# (T, m, subtile, one bucket): tails, every m from 1 to 256, the cap
BODIES = [
    (128, 1, None, False), (300, 7, 255, True), (1000, 256, None, False),
    (513, 17, 64, False), (256, 8, None, True), (200, 2, 1, False),
]


@pytest.mark.parametrize("t,m,subtile,one_bucket", BODIES)
def test_plain_bodies_match_jax(t, m, subtile, one_bucket):
    rng = np.random.default_rng(t + m)
    ids = rng.integers(0, m, (3, t)).astype(np.int32)
    if one_bucket:
        ids[:] = m - 1                              # every counter lane to the subtile
    kw = {} if subtile is None else {"subtile": subtile}
    layout = common.packed_layout(t, m, **kw)
    jlayout = jcommon.packed_layout(t, m, **kw)
    local, hist = common.packed_local_offsets(torch.from_numpy(ids), layout)
    counts = common.packed_counts(torch.from_numpy(ids), layout)
    for row in range(3):
        jl, jh = jcommon.packed_local_offsets(jnp.asarray(ids[row]), jlayout)
        _eq(local[row], jl)
        _eq(hist[row], jh)
        _eq(counts[row], jcommon.packed_counts(jnp.asarray(ids[row]), jlayout))
    rank, hist1, _ = common.tile_rank(torch.from_numpy(ids), m)
    assert torch.equal(local, rank) and torch.equal(hist, hist1)


# ---------------------------------------------------------------------------
# (2) the packed wrappers against the Pallas kernels, in their four forms
# ---------------------------------------------------------------------------

# form -> (spec or m, key dtype, (L, T), s)
FORMS = {
    "spec-flat": (jid.EvenSpec(-3.7, 11.3, 37), np.float32, (4, 512), 1),
    "spec-seg": (jid.BitfieldSpec(11, 5), np.uint32, (3, 1024), 5),
    "ids-flat": (256, np.uint32, (2, 1024), 1),
    "ids-seg": (7, np.int32, (4, 256), 17),
}


@functools.lru_cache(maxsize=None)
def _form(form):
    """(tiled, seg, keys, vals, jax kwargs, port kwargs) of one form."""
    what, dtype, shape, s = FORMS[form]
    rng = np.random.default_rng(len(form))
    vals = _vals(shape, rng)
    seg = _seg_strip(shape, s, rng) if s > 1 else None
    if isinstance(what, int):
        tiled = rng.integers(0, what, shape).astype(np.int32)
        keys = (rng.uniform(-9, 9, shape) if dtype == np.float32
                else rng.integers(-(2**31), 2**31, shape)).astype(dtype)
        jkw = tkw = {"num_buckets": what}
    else:
        if dtype == np.float32:
            tiled = rng.uniform(what.lo - 2, what.hi + 2, shape).astype(np.float32)
            tiled.reshape(-1)[:3] = [np.nan, np.inf, what.lo]
        else:
            tiled = _uint_keys(shape, rng).astype(dtype)
        keys = None
        jkw, tkw = {"spec": what}, {"spec": convert_spec(what)}
    return tiled, seg, keys, vals, dict(jkw, num_segments=s), dict(tkw, num_segments=s)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _bases(form, offset):
    tiled, seg, _, _, _, tkw = _form(form)
    hist = mst.packed_tile_histograms(_t(tiled), _t(seg), **tkw)
    return tst.global_scan(hist) + offset


@pytest.mark.parametrize("form", sorted(FORMS))
def test_packed_histograms_vs_pallas(form):
    tiled, seg, _, _, jkw, tkw = _form(form)
    want = jkops.packed_tile_histograms(_j(tiled), _j(seg), interpret=True, **jkw)
    _eq(mst.packed_tile_histograms(_t(tiled), _t(seg), **tkw), want)


@pytest.mark.parametrize("offset", [0, BIG])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_packed_positions_vs_pallas(form, offset):
    tiled, seg, _, _, jkw, tkw = _form(form)
    g = _bases(form, offset)
    want = jkops.packed_tile_positions(_j(tiled), jnp.asarray(g.numpy()), _j(seg),
                                       interpret=True, **jkw)
    _eq(tkops.packed_tile_positions(_t(tiled), g, _t(seg), **tkw), want)


@pytest.mark.parametrize("key_value", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_packed_fused_postscan_reorder_vs_pallas(form, key_value):
    tiled, seg, keys, vals, jkw, tkw = _form(form)
    g = _bases(form, BIG if key_value else 0)
    vals = vals if key_value else None
    want = jkops.packed_fused_postscan_reorder(
        _j(tiled), jnp.asarray(g.numpy()), _j(keys), _j(vals), _j(seg), interpret=True, **jkw)
    got = tkops.packed_fused_postscan_reorder(_t(tiled), g, _t(keys), _t(vals), _t(seg), **tkw)
    assert (got[1] is None) == (not key_value)
    for a, b in zip(got, want):
        _eq(a, None if b is None else np.asarray(b))


def test_rounding_fault_input_is_exact_on_both_packed_sides():
    """The bases of ROADMAP §C 1: the JAX packed kernel is exact past 2^24
    (the onehot one rounds), and the port's packed kernel agrees with it."""
    g = np.array([[2**24 + 1, 2**24 + 3, 2**25 + 5, 7]], np.int32)
    ids = np.array([[0, 1, 2, 3, 3]], np.int32)
    want = [[2**24 + 1, 2**24 + 3, 2**25 + 5, 7, 8]]
    jax_packed = jkops.packed_tile_positions(jnp.asarray(ids), jnp.asarray(g), num_buckets=4,
                                             interpret=True)
    assert np.asarray(jax_packed).tolist() == want
    assert mst.packed_tile_positions(torch.from_numpy(ids), torch.from_numpy(g),
                                     num_buckets=4).tolist() == want
    assert mst.packed_tile_positions(torch.from_numpy(ids), torch.from_numpy(g),
                                     spec=ops.IdentitySpec(4)).tolist() == want


@pytest.mark.parametrize("subtile", [None, 255, 1])
@pytest.mark.parametrize("m", [1, 2, 7, 8, 255, 256])
def test_packed_wrappers_equal_onehot_wrappers(m, subtile):
    """All four forms, every subtile the kernels take, labels outside
    [0, m) (both families clamp them), bases past 2^24: the packed
    wrappers give the onehot wrappers' bits."""
    rng = np.random.default_rng(m)
    shape, s = (3, 700), 9
    ids = torch.from_numpy(rng.integers(-2, m + 2, shape).astype(np.int32))
    keys = torch.from_numpy(_uint_keys(shape, rng))
    vals = torch.from_numpy(_vals(shape, rng))
    seg = torch.from_numpy(_seg_strip(shape, s, rng))
    spec = ops.DeltaSpec(m, 2**32) if m > 1 else ops.DeltaSpec(1)
    kw = {"subtile": subtile}
    onehot = {
        ("spec", False): (lambda: mst.spec_tile_histograms(keys, spec),
                          lambda g: mst.spec_tile_positions(keys, g, spec),
                          lambda g: mst.spec_fused_postscan_reorder(keys, g, vals, spec)),
        ("spec", True): (lambda: mst.seg_spec_tile_histograms(keys, seg, spec, s),
                         lambda g: mst.seg_spec_tile_positions(keys, seg, g, spec, s),
                         lambda g: mst.seg_spec_fused_postscan_reorder(keys, seg, g, vals, spec, s)),
        ("ids", False): (lambda: mst.tile_histograms(ids, m),
                         lambda g: mst.tile_positions(ids, g, m),
                         lambda g: mst.fused_postscan_reorder(ids, g, keys, vals, m)),
        ("ids", True): (lambda: mst.seg_tile_histograms(ids, seg, m, s),
                        lambda g: mst.seg_tile_positions(ids, seg, g, m, s),
                        lambda g: mst.seg_fused_postscan_reorder(ids, seg, g, keys, vals, m, s)),
    }
    for (src, segmented), (hist, positions, reorder) in onehot.items():
        tiled = keys if src == "spec" else ids
        lkw = dict(kw, spec=spec) if src == "spec" else dict(kw, num_buckets=m)
        sg = seg if segmented else None
        if segmented:
            lkw["num_segments"] = s
        h = mst.packed_tile_histograms(tiled, sg, **lkw)
        assert torch.equal(h, hist())
        g = tst.global_scan(h) + BIG
        assert torch.equal(mst.packed_tile_positions(tiled, g, sg, **lkw), positions(g))
        got = mst.packed_fused_postscan_reorder(tiled, g, None if src == "spec" else keys, vals,
                                                sg, **lkw)
        for a, b in zip(got, reorder(g)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_packed_launch_checks_what_the_kernels_take():
    """What a CUDA launch is given, checked without a card: 8-bit counters
    only, the guard's subtiles (1 to 255), the auto subtile 128."""
    keys = torch.zeros((2, 512), dtype=torch.uint32)
    spec = ops.DeltaSpec(8)
    args = functools.partial(mst._packed_launch_args, keys, None, None, spec, 1)
    assert args(None, None)[3] == 128
    assert args(8, 255)[3] == 255
    with pytest.raises(ValueError, match="8-bit counters"):
        args(4, None)
    with pytest.raises(ValueError, match="overflows 8-bit packed counters"):
        args(None, 256)
    with pytest.raises(ValueError, match="needs a segment strip"):
        mst._packed_launch_args(keys, None, None, spec, 3, None, None)
    with pytest.raises(ValueError, match="needs keys_tiled"):
        mst.packed_fused_postscan_reorder(keys.view(torch.int32), torch.zeros((2, 8), dtype=torch.int32),
                                          num_buckets=8)
    # the plain versions take every width JAX takes
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 8, (2, 512)).astype(np.int32))
    want = jkops.packed_tile_histograms(jnp.asarray(ids.numpy()), num_buckets=8, bits=4,
                                        interpret=True)
    _eq(mst.packed_tile_histograms(ids, num_buckets=8, bits=4), want)


# ---------------------------------------------------------------------------
# (3) the ops with family="packed" against repro.ops
# ---------------------------------------------------------------------------

N, TILE = 1500, 512
JSPEC = jid.DeltaSpec(32, 2**32)


@functools.lru_cache(maxsize=None)
def _data(n=N):
    rng = np.random.default_rng(n)
    return _uint_keys(n, rng), _vals(n, rng)


def _jax_twice(call):
    """repro.ops on vmap and pallas-interpret (packed), held equal to each
    other; returns the numpy result."""
    a, b = call("vmap"), call("pallas-interpret")
    a, b = jax.tree_util.tree_map(np.asarray, a), jax.tree_util.tree_map(np.asarray, b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    return a


@functools.lru_cache(maxsize=None)
def _jax_multisplit(method, mode, key_value):
    keys, vals = _data()
    return _jax_twice(lambda be: jops.multisplit(
        jnp.asarray(keys), JSPEC, jnp.asarray(vals) if key_value else None, method=method,
        backend=be, tile=TILE, mode=mode, family="packed"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method,mode,key_value", [
    ("dms", "reorder", True), ("wms", "reorder", True), ("bms", "reorder", True),
    ("bms", "reorder", False), ("bms", "positions_only", False), ("bms", "counts_only", False),
])
def test_packed_multisplit_matches_jax(method, mode, key_value, backend):
    keys, vals = _data()
    want = _jax_multisplit(method, mode, key_value)
    got = ops.multisplit(keys, convert_spec(JSPEC), vals if key_value else None, method=method,
                         backend=backend, tile=TILE, mode=mode, family="packed", device="cpu")
    _assert_result(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_packed_histogram_matches_jax(backend):
    keys, _ = _data()
    want = _jax_multisplit("bms", "counts_only", False).bucket_counts
    _eq(ops.histogram(keys, convert_spec(JSPEC), backend=backend, tile=TILE, family="packed",
                      device="cpu"), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_packed_key_value_gradient_matches_jax_grad(backend):
    rng = np.random.default_rng(3)
    keys = rng.uniform(-4, 12, 777).astype(np.float32)
    vals = rng.standard_normal(777).astype(np.float32)
    wk, wv = rng.standard_normal(777).astype(np.float32), rng.standard_normal(777).astype(np.float32)
    jspec = jid.EvenSpec(-3.7, 11.3, 37)

    def loss(k, v):
        r = jops.multisplit_key_value(k, v, jspec, backend="vmap", tile=256, family="packed")
        return (r.keys * wk).sum() + (r.values * wv).sum()

    gk_want, gv_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(keys), jnp.asarray(vals))
    kt, vt = torch.tensor(keys, requires_grad=True), torch.tensor(vals, requires_grad=True)
    res = ops.multisplit_key_value(kt, vt, convert_spec(jspec), backend=backend, tile=256,
                                   family="packed", device="cpu")
    ((res.keys * torch.from_numpy(wk)).sum() + (res.values * torch.from_numpy(wv)).sum()).backward()
    _eq(kt.grad, gk_want)
    _eq(vt.grad, gv_want)


STARTS = np.array([0, 0, 17, 600, 601, 601, 1400], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_segmented(method, mode, key_value):
    keys, vals = _data()
    return _jax_twice(lambda be: jops.segmented_multisplit(
        jnp.asarray(keys), JSPEC, jnp.asarray(STARTS), jnp.asarray(vals) if key_value else None,
        method=method, backend=be, tile=TILE, mode=mode, family="packed"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method,mode,key_value", [
    ("bms", "reorder", True), ("dms", "positions_only", False), ("bms", "counts_only", False),
])
def test_packed_segmented_multisplit_matches_jax(method, mode, key_value, backend):
    keys, vals = _data()
    want = _jax_segmented(method, mode, key_value)
    got = ops.segmented_multisplit(keys, convert_spec(JSPEC), STARTS,
                                   vals if key_value else None, method=method, backend=backend,
                                   tile=TILE, mode=mode, family="packed", device="cpu")
    _assert_result(got, want)
    got = tcore.segmented_multisplit(torch.from_numpy(keys), convert_spec(JSPEC), STARTS,
                                     torch.from_numpy(vals) if key_value else None, method=method,
                                     backend=backend, tile=TILE, mode=mode, family="packed",
                                     device="cpu")
    _assert_result(got, want)


@functools.lru_cache(maxsize=None)
def _jax_sort(segmented):
    keys, vals = _data()
    if segmented:
        return _jax_twice(lambda be: jops.segmented_radix_sort(
            jnp.asarray(keys), jnp.asarray(STARTS), jnp.asarray(vals), key_bits=16,
            backend=be, tile=TILE, family="packed"))
    return _jax_twice(lambda be: jops.radix_sort(
        jnp.asarray(keys), jnp.asarray(vals), key_bits=16, backend=be, tile=TILE,
        family="packed"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("segmented", [False, True])
def test_packed_radix_sorts_match_jax(segmented, backend):
    keys, vals = _data()
    want_k, want_v = _jax_sort(segmented)
    kw = dict(key_bits=16, backend=backend, tile=TILE, family="packed", device="cpu")
    if segmented:
        got = [ops.segmented_radix_sort(keys, STARTS, vals, **kw),
               tsort.segmented_radix_sort(torch.from_numpy(keys), STARTS, torch.from_numpy(vals),
                                          **kw)]
    else:
        got = [ops.radix_sort(keys, vals, **kw),
               tsort.radix_sort(torch.from_numpy(keys), torch.from_numpy(vals), **kw)]
    for k, v in got:
        _eq(k, want_k)
        _eq(v, want_v)


@pytest.mark.parametrize("backend", BACKENDS)
def test_packed_callable_spec_takes_the_packed_ids_doors(backend):
    """A programmer's bucket function on the packed family: the ids strip
    goes through the packed doors (the cuda backend's), with the onehot
    family's bits."""
    keys, vals = _data()
    fn = ops.from_fn(lambda u: (u.view(torch.int32) >> 7) & 15, 16, "bits7")
    got = ops.multisplit(keys, fn, vals, backend=backend, tile=TILE, family="packed", device="cpu")
    want = ops.multisplit(keys, fn, vals, backend=backend, tile=TILE, device="cpu")
    _assert_result(got, jax.tree_util.tree_map(lambda t: t.numpy(), want))
    got = ops.segmented_multisplit(keys, fn, STARTS, backend=backend, tile=TILE, method="dms",
                                   family="packed", device="cpu")
    want = ops.segmented_multisplit(keys, fn, STARTS, backend=backend, tile=TILE, method="dms",
                                    device="cpu")
    _assert_result(got, jax.tree_util.tree_map(lambda t: t.numpy(), want))


# ---------------------------------------------------------------------------
# (4) family resolution, stage tags, defaults, imports
# ---------------------------------------------------------------------------

def test_family_validation_matches_jax(monkeypatch):
    for bad in ("dense", "PACKED"):
        with pytest.raises(ValueError) as want:
            jops.multisplit(jnp.zeros(8, jnp.uint32), JSPEC, family=bad)
        with pytest.raises(ValueError) as got:
            tpipe.make_plan(8, 32, family=bad)
        assert str(got.value) == str(want.value)
    assert tpipe.FAMILIES == ("onehot", "packed")
    for name in BACKENDS:
        assert tpipe.get_backend(name).families == ("onehot", "packed")
    narrow = tregistry.Backend(name="onehot-only", description="test", stages=tregistry.VmapStages())
    monkeypatch.setitem(tregistry._REGISTRY, "onehot-only", narrow)
    with pytest.raises(ValueError, match=r"supports kernel families \('onehot',\), not 'packed'"):
        tpipe.resolve_kernel_family(8, 4, "bms", "onehot-only", "packed")
    assert tpipe.family_decision(8, 4, "bms", "onehot-only") == (
        "onehot", "backend 'onehot-only' advertises no packed support")


@pytest.mark.parametrize("backend", ["vmap", "cuda"])
@pytest.mark.parametrize("m", [2, 8, 256])
def test_default_family_is_onehot_with_its_reason(backend, m):
    """No constant of the CPU era becomes the port's default: onehot at
    every m, with the reason recorded, which cites the H100 measurements
    the default was pinned from; the reference backend's reason is that it
    has no tile solve."""
    family, reason = tpipe.family_decision(4096 + m, m, "bms", backend)
    assert family == "onehot"
    assert "CPU host" in reason and "H100" in reason
    assert tpipe.family_decisions()[(4096 + m, m, "bms", backend)] == (family, reason)
    assert tpipe.make_plan(4096 + m, m, backend=backend).family == "onehot"
    assert tpipe.family_decision(7, m, "dms", "reference") == (
        "onehot", "untiled direct-solve backend: no tile local solve")


def test_explicit_family_is_never_cached():
    key = (12345, 16, "wms", "cuda")
    assert key not in tpipe.family_decisions()
    plan = tpipe.make_plan(12345, 16, method="wms", backend="cuda", family="packed")
    assert plan.family == "packed"
    assert key not in tpipe.family_decisions()
    assert tpipe.make_plan(12345, 16, method="wms", backend="cuda").family == "onehot"
    assert tpipe.family_decisions()[key][0] == "onehot"


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["reorder", "counts_only", "positions_only"])
@pytest.mark.parametrize("method", ["dms", "bms"])
def test_packed_stage_tags(method, mode, backend):
    """Packed plans carry ``-packed`` on their local-solve stages, but for
    the vmap counts_only prescan (a scatter-add on either family) and the
    untiled reference; onehot plans carry none."""
    spec = ops.DeltaSpec(8)
    for segments in (None, 3):
        packed = tpipe.make_plan(100, 8, method=method, backend=backend, bucket_fn=spec,
                                 mode=mode, segments=segments, family="packed").stages()
        onehot = tpipe.make_plan(100, 8, method=method, backend=backend, bucket_fn=spec,
                                 mode=mode, segments=segments, family="onehot").stages()
        assert not any("packed" in t for t in onehot)
        if backend == "reference":
            assert packed == onehot
            continue
        assert packed == tuple(
            t + "-packed" if t.startswith("postscan:") or (
                t.startswith("prescan:") and (backend == "cuda" or mode != "counts_only"))
            else t
            for t in onehot)


CORE_ENTRY_POINTS = [tcore.multisplit, tcore.segmented_multisplit, tsort.radix_sort,
                     tsort.segmented_radix_sort]


@pytest.mark.parametrize("fn", CORE_ENTRY_POINTS, ids=lambda f: f"{f.__module__}.{f.__name__}")
def test_core_entry_points_default_to_the_card(fn):
    """The core entry points run the kernels by default, as the ops do:
    backend "cuda" on device "cuda". Without a card a call with the
    defaults fails; it does not carry on with the plain stages."""
    params = inspect.signature(fn).parameters
    assert params["backend"].default == "cuda"
    assert params["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    keys = np.arange(10, dtype=np.uint32)
    with pytest.raises((AssertionError, RuntimeError)):
        if fn is tcore.multisplit:
            fn(keys, ops.DeltaSpec(4, 10))
        elif fn is tcore.segmented_multisplit:
            fn(keys, ops.DeltaSpec(4, 10), np.array([0, 4], np.int32))
        elif fn is tsort.radix_sort:
            fn(keys)
        else:
            fn(keys, np.array([0, 4], np.int32))


_PATH_CODE = (
    "import sys, numpy as np; from repro_torch import ops\n"
    "k = np.arange(3000, dtype=np.uint32) * 2654435761\n"
    "ops.multisplit(k, ops.DeltaSpec(32, 2**32), k.view(np.int32), family='packed', device='cpu')\n"
    "ops.segmented_radix_sort(k, np.array([0, 100]), family='packed', device='cpu')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
    "assert not bad, bad\n"
)
fresh_process = _fresh_process.started(_PATH_CODE)


def test_packed_path_loads_neither_jax_nor_repro(fresh_process):
    """Running the packed path on the CPU, in a fresh process, imports no
    module of JAX and none of the JAX package."""
    rc, _, err = _fresh_process.finished(fresh_process)
    assert rc == 0, err
