"""The batched layout, the transform-native ops and the unfused baselines,
with the standalone tile reorder (B10), against the JAX package, bitwise.

The same numpy inputs, made from a seed, go through the JAX package and
through the port on the CPU, where the cuda backend's kernel wrappers run
their plain versions. These tests hold:

* B10's plain version and its door against ``repro.kernels.ops.tile_reorder``
  (the Pallas kernel in interpret mode) and ``repro.kernels.ref.tile_reorder``
  over the JAX kernel tests' shapes; the clamp of ids outside ``[0, m)``
  against the plain version alone (the JAX bodies give such an id
  destination 0);
* ``batched_multisplit`` on every backend, method and mode, the packed
  family and a callable, batched ``radix_sort`` (unfused and
  ``fuse_digits=True``), ``radix_sort_per_pass`` (flat, batched, segmented),
  ``multisplit_unfused`` and ``direct_sort_multisplit`` against their
  ``repro.core`` twins (JAX on ``reference``, which its own tests hold
  bitwise equal to its tiled backends, and on ``pallas-interpret`` and
  ``vmap`` for the packed, callable and fused cases);
* ``torch.vmap`` of ``ops.multisplit``, ``multisplit_key_value`` and
  ``histogram`` against the per-row loop and ``jax.vmap`` of ``repro.ops``,
  ``torch.func.grad`` and ``vmap`` of it against the per-row backward;
* one launch a stage for a whole batch, the unfused baseline's door
  sequence, the plan rules, and that the new paths load neither JAX nor the
  JAX package.

Keys and values are compared as int32 bit patterns. The CUDA kernels are
held against these plain versions on the card by ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import identifiers as jid
from repro.core import multisplit as jcore
from repro.core import sort as jsort
from repro.core.pipeline import make_batched_plan as jmake_batched_plan
from repro.kernels import ops as jkops
from repro.kernels import ref as jref
from repro_torch import ops
from repro_torch.convert import convert_spec
from repro_torch.core import multisplit as tcore
from repro_torch.core import pipeline as tpipe
from repro_torch.core import sort as tsort
from repro_torch.kernels import multisplit_tile as mst
from repro_torch.kernels import ops as tkops

import _fresh_process
import _torch_threads

_torch_threads.pin()

FIELDS = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")
METHODS = ["dms", "wms", "bms"]
SWEEP = [(1, 128, 2), (4, 256, 8), (2, 1024, 32), (3, 512, 256), (2, 384, 13)]
B, N, TILE = 5, 700, 256          # n is no multiple of the tile: every row carries pads
# the oracle jitted once a shape: op by op, it compiles every primitive anew
jref_tile_reorder = jax.jit(jref.tile_reorder, static_argnums=3)


def _bits(a) -> np.ndarray:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _eq(got, want, what="") -> None:
    assert (got is None) == (want is None), what
    if got is not None:
        assert tuple(got.shape) == tuple(np.shape(want)), what
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _eq_result(got, want, fields=FIELDS) -> None:
    for f in fields:
        _eq(getattr(got, f), getattr(want, f), f)


def _rows(b, n, seed, hi=2**32):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, hi, (b, n), dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(-(2**31), 2**31, (b, n), dtype=np.int64).astype(np.int32)
    return keys, vals


# ---------------------------------------------------------------------------
# B10: the standalone tile reorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,T,m", SWEEP)
@pytest.mark.parametrize("kdtype", [np.uint32, np.int32])
def test_tile_reorder_plain_vs_pallas(L, T, m, kdtype):
    rng = np.random.RandomState(T)
    ids = rng.randint(0, m, (L, T), dtype=np.int32)
    keys = rng.randint(0, 2**31 - 1, (L, T)).astype(kdtype)
    vals = rng.randint(0, 2**31 - 1, (L, T), dtype=np.int32)
    pallas = jkops.tile_reorder(jnp.asarray(ids), jnp.asarray(keys), jnp.asarray(vals), m)
    oracle = jref_tile_reorder(jnp.asarray(ids), jnp.asarray(keys), jnp.asarray(vals), m)
    t = [torch.from_numpy(x) for x in (ids, keys, vals)]
    for got in (mst.tile_reorder_plain(*t, m), tkops.tile_reorder(*t, m)):
        for g, p, o in zip(got, pallas, oracle):
            _eq(g, p)
            _eq(g, o)
    # key-only: the same keys and destinations, no values
    k_only = mst.tile_reorder(t[0], t[1], None, m)
    assert k_only[1] is None
    _eq(k_only[0], oracle[0])
    _eq(k_only[2], oracle[2])


def test_tile_reorder_moves_float_bit_patterns():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 7, (3, 300)).astype(np.int32)
    keys = rng.standard_normal((3, 300)).astype(np.float32)
    keys[0, :4] = [np.nan, np.inf, -np.inf, -0.0]
    vals = rng.standard_normal((3, 300)).astype(np.float32)
    want = jref_tile_reorder(jnp.asarray(ids), jnp.asarray(keys), jnp.asarray(vals), 7)
    got = mst.tile_reorder(*(torch.from_numpy(x) for x in (ids, keys, vals)), 7)
    for g, w in zip(got, want):
        _eq(g, w)


def test_tile_reorder_clamps_ids_outside_the_buckets():
    """An id outside [0, m) is outside the contract; the kernel and its
    plain version clamp it into [0, m), as every ids kernel does. The JAX
    bodies give it destination 0 instead, so this is held against the plain
    version on the clamped ids alone."""
    rng = np.random.default_rng(11)
    m = 7
    ids = torch.from_numpy(rng.integers(-3, m + 3, (4, 200)).astype(np.int32))
    keys, vals = (torch.from_numpy(x) for x in _rows(4, 200, 12))
    got = mst.tile_reorder(ids, keys, vals, m)
    want = mst.tile_reorder_plain(ids.clamp(0, m - 1), keys, vals, m)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    dest = got[2]
    assert torch.equal(dest.sort(1).values, torch.arange(200, dtype=torch.int32).expand(4, 200))


# ---------------------------------------------------------------------------
# The batched layout against repro.core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,l_b,m", [(1, 1024, 256), (1, 1, 5), (4, 3, 7), (5, 1, 1)])
def test_row_scan_and_pads_match_jax(rows, l_b, m):
    """The per-row scan is ``jax.vmap(global_scan)`` over (b, l_b, m), and
    contiguous (the kernels take G only so); ``pad_rows`` is the JAX one."""
    from repro.core.pipeline import stages as jst
    from repro_torch.core.pipeline import stages as tst

    hist = np.random.default_rng(rows * l_b + m).integers(0, 50, (rows * l_b, m)).astype(np.int32)
    g = tst.global_scan(torch.from_numpy(hist), rows)
    assert g.is_contiguous()
    want = jax.vmap(jst.global_scan)(jnp.asarray(hist).reshape(rows, l_b, m))
    _eq(g, np.asarray(want).reshape(rows * l_b, m))
    keys, _ = _rows(rows, 10, 1)
    _eq(tst.pad_rows(torch.from_numpy(keys), 16, 2**32 - 1),
        jst.pad_rows(jnp.asarray(keys), 16, 2**32 - 1))


# JAX runs its cheapest backend to compile where its backends agree bit for
# bit (its own tests hold them so); the tiled JAX bodies are the twins of the
# packed, callable and fused cases below


@functools.lru_cache(maxsize=None)
def _jax_batched(method, mode, key_value):
    keys, vals = _rows(B, N, 5)
    res = jcore.batched_multisplit(
        jnp.asarray(keys), jid.DeltaSpec(13, 2**32), jnp.asarray(vals) if key_value else None,
        method=method, tile=TILE, backend="reference", mode=mode)
    return keys, vals, jax.tree_util.tree_map(np.asarray, res)


MODES = [("reorder", True), ("reorder", False), ("counts_only", False),
         ("positions_only", False)]


@pytest.mark.parametrize("mode,key_value", MODES, ids=lambda x: str(x))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", ["reference", "vmap", "cuda"])
def test_batched_multisplit_matches_jax(backend, method, mode, key_value):
    keys, vals, want = _jax_batched(method, mode, key_value)
    got = tcore.batched_multisplit(keys, ops.DeltaSpec(13, 2**32), vals if key_value else None,
                                   method=method, tile=TILE, backend=backend, mode=mode,
                                   device="cpu")
    _eq_result(got, want)
    # and each row is the flat op on that row
    for r in (0, B - 1):
        row = ops.multisplit(keys[r], ops.DeltaSpec(13, 2**32), vals[r] if key_value else None,
                             method=method, tile=TILE, backend=backend, mode=mode, device="cpu")
        for f in FIELDS:
            a = getattr(got, f)
            _eq(None if a is None else a[r], None if getattr(row, f) is None else getattr(row, f))


@functools.lru_cache(maxsize=None)
def _jax_packed_and_callable():
    keys, vals = _rows(4, 500, 21)
    packed = jcore.batched_multisplit(jnp.asarray(keys), jid.DeltaSpec(32, 2**32),
                                      jnp.asarray(vals), tile=128, backend="pallas-interpret",
                                      family="packed")
    jhash = jid.from_fn(lambda u: (u.astype(jnp.uint32) * jnp.uint32(2654435761)) >> 27, 32)
    hashed = jcore.batched_multisplit(jnp.asarray(keys), jhash, jnp.asarray(vals), method="wms",
                                      tile=128, backend="vmap")
    return keys, vals, jax.tree_util.tree_map(np.asarray, (packed, hashed))


@pytest.mark.parametrize("backend", ["vmap", "cuda"])
def test_batched_packed_family_and_callable_match_jax(backend):
    keys, vals, (packed, hashed) = _jax_packed_and_callable()
    got = tcore.batched_multisplit(keys, ops.DeltaSpec(32, 2**32), vals, tile=128,
                                   backend=backend, family="packed", device="cpu")
    _eq_result(got, packed)
    # a programmer's bucket function: the labels go through the ids doors
    thash = ops.from_fn(
        lambda u: (((u.view(torch.int32).long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF) >> 27, 32)
    got = tcore.batched_multisplit(keys, thash, vals, method="wms", tile=128, backend=backend,
                                   device="cpu")
    _eq_result(got, hashed)


@pytest.mark.parametrize("backend", ["vmap", "cuda"])
def test_batched_empty_rows_match_jax(backend):
    keys = np.zeros((3, 0), np.uint32)
    for mode in ("reorder", "counts_only", "positions_only"):
        want = jcore.batched_multisplit(jnp.asarray(keys), jid.DeltaSpec(4), mode=mode,
                                        backend="vmap")
        got = tcore.batched_multisplit(keys, ops.DeltaSpec(4), mode=mode, backend=backend,
                                       device="cpu")
        _eq_result(got, want)


SORT_ROWS = (3, 400)           # one shape for every sort test: JAX compiles it once


@functools.lru_cache(maxsize=None)
def _jax_sort(radix_bits, fuse):
    """The JAX batched sort; fused on its Pallas fused-pair kernels."""
    keys, vals = _rows(*SORT_ROWS, 31)
    out = jsort.radix_sort(jnp.asarray(keys), jnp.asarray(vals), radix_bits=radix_bits,
                           backend="pallas-interpret" if fuse else "reference", tile=TILE,
                           fuse_digits=fuse)
    return keys, vals, tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("radix_bits,fuse", [(8, False), (8, True)])
@pytest.mark.parametrize("backend", ["reference", "vmap", "cuda"])
def test_batched_radix_sort_matches_jax(backend, radix_bits, fuse):
    keys, vals, want = _jax_sort(radix_bits, fuse)
    got = tsort.radix_sort(keys, vals, radix_bits=radix_bits, backend=backend, tile=TILE,
                           fuse_digits=fuse, device="cpu")
    for g, w in zip(got, want):
        _eq(g, w)
    order = np.argsort(keys, axis=1, kind="stable")
    _eq(got[0], np.take_along_axis(keys, order, 1))
    # key-only, the ops facade
    k_only = ops.radix_sort(keys, radix_bits=radix_bits, backend=backend, tile=TILE,
                            fuse_digits=fuse, device="cpu")
    assert k_only[1] is None
    _eq(k_only[0], want[0])


PER_PASS_STARTS = np.array([0, 100, 100, 650, 1199], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_per_pass(layout):
    keys, vals = _rows(*SORT_ROWS, 31)
    if layout != "batched":
        keys, vals = keys.reshape(-1), vals.reshape(-1)
    starts = PER_PASS_STARTS if layout == "segmented" else None
    want = jsort.radix_sort_per_pass(jnp.asarray(keys), jnp.asarray(vals), backend="reference",
                                     tile=TILE, segment_starts=starts)
    return keys, vals, starts, tuple(np.asarray(x) for x in want)


@pytest.mark.parametrize("layout", ["flat", "batched", "segmented"])
@pytest.mark.parametrize("backend", ["vmap", "cuda"])
def test_radix_sort_per_pass_matches_jax(backend, layout):
    keys, vals, starts, want = _jax_per_pass(layout)
    got = tsort.radix_sort_per_pass(keys, vals, backend=backend, tile=TILE,
                                    segment_starts=starts, device="cpu")
    for g, w in zip(got, want):
        _eq(g, w)
    if layout == "segmented":
        chained = tsort.segmented_radix_sort(keys, starts, vals, backend=backend, tile=TILE,
                                             device="cpu")
    else:
        chained = tsort.radix_sort(keys, vals, backend=backend, tile=TILE, device="cpu")
    for g, c in zip(got, chained):
        assert torch.equal(g.view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("method", ["dms", "bms"])
def test_multisplit_unfused_matches_jax(method):
    """Against the JAX baseline key-value (wms runs bms's passes at another
    default tile); the key-only call moves the same keys, and both equal the
    fused plan."""
    keys, vals = (x.reshape(-1) for x in _rows(1, 1000, 61))
    jspec = jid.DeltaSpec(32, 2**32)
    want = jcore.multisplit_unfused(jnp.asarray(keys), jspec, jnp.asarray(vals), method=method,
                                    tile=TILE)
    spec = convert_spec(jspec)
    for v in (vals, None):
        got = tcore.multisplit_unfused(keys, spec, v, method=method, tile=TILE, device="cpu")
        _eq_result(got, want if v is not None else want._replace(values=None))
        _eq_result(got, ops.multisplit(keys, spec, v, method=method, backend="cuda", device="cpu"))


def test_multisplit_unfused_default_tiles():
    """The JAX defaults: the warp tile for dms and wms, the block tile for
    bms, both within what the kernels take; any tile gives the same bits."""
    assert (tpipe.WMS_TILE, tpipe.BMS_TILE) == (1024, 4096) and tpipe.BMS_TILE <= mst.MAX_TILE
    keys, vals = (x.reshape(-1) for x in _rows(1, 5000, 62))
    spec = ops.DeltaSpec(8, 2**32)
    for method in METHODS:
        got = tcore.multisplit_unfused(keys, spec, vals, method=method, device="cpu")
        _eq_result(got, tcore.multisplit_unfused(keys, spec, vals, method=method, tile=128,
                                                 device="cpu"))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("kind", ["uint32", "int32", "float32"])
def test_direct_sort_multisplit_matches_jax(kind, batched):
    rng = np.random.default_rng(71)
    shape = (3, 300) if batched else (900,)
    if kind == "float32":
        keys = rng.standard_normal(shape).astype(np.float32)
        keys.reshape(-1)[:3] = [np.inf, -np.inf, np.nan]
    else:
        keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(kind)
        keys.reshape(-1)[:50] = keys.reshape(-1)[50:100]          # equal keys: stability shows
    vals = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    for v in (None, vals):
        want = jsort.direct_sort_multisplit(jnp.asarray(keys), None if v is None else jnp.asarray(v))
        got = tsort.direct_sort_multisplit(torch.from_numpy(keys),
                                           None if v is None else torch.from_numpy(v))
        for g, w in zip(got, want):
            _eq(g, w)


# ---------------------------------------------------------------------------
# torch.vmap, torch.func.grad and the launches
# ---------------------------------------------------------------------------

VMAP_SPEC = jid.DeltaSpec(16, 2**32)


def _vmap_inputs():
    """Keys, float values (the gradient's) and a cotangent weight."""
    keys, _ = _rows(4, 300, 81)
    rng = np.random.default_rng(82)
    vals, w = (rng.standard_normal((4, 300)).astype(np.float32) for _ in range(2))
    return keys, vals, w


@functools.lru_cache(maxsize=None)
def _jax_vmap(method):
    """jax.vmap of repro.ops: key-only, key-value, key-value with the keys
    unbatched, histogram and positions_only."""
    keys, vals, _ = _vmap_inputs()
    k, v = jnp.asarray(keys), jnp.asarray(vals)
    kw = dict(method=method, backend="reference")
    out = (jax.vmap(lambda k: jops.multisplit(k, VMAP_SPEC, **kw))(k),
           jax.vmap(lambda k, v: jops.multisplit_key_value(k, v, VMAP_SPEC, **kw))(k, v),
           jax.vmap(lambda v: jops.multisplit_key_value(k[0], v, VMAP_SPEC, **kw))(v),
           jax.vmap(lambda k: jops.histogram(k, VMAP_SPEC, backend="reference"))(k),
           jax.vmap(lambda k: jops.multisplit(k, VMAP_SPEC, mode="positions_only", **kw))(k))
    return keys, vals, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("backend", ["vmap", "cuda"])
@pytest.mark.parametrize("method", ["dms", "bms"])
def test_vmap_of_the_ops_equals_the_loop_and_jax_vmap(method, backend):
    keys, vals, (j_ms, j_kv, j_bcast, j_hist, j_pos) = _jax_vmap(method)
    spec = convert_spec(VMAP_SPEC)
    kw = dict(method=method, backend=backend, device="cpu")
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    cases = [
        (torch.vmap(ops.multisplit, in_dims=(0, None), out_dims=ops.vmap_out_dims())(
            tk, spec, **kw), j_ms, lambda r: ops.multisplit(keys[r], spec, **kw)),
        (torch.vmap(ops.multisplit_key_value, in_dims=(0, 0, None))(tk, tv, spec, **kw), j_kv,
         lambda r: ops.multisplit_key_value(keys[r], vals[r], spec, **kw)),
        # the keys unbatched, broadcast over the batch
        (torch.vmap(ops.multisplit_key_value, in_dims=(None, 0, None))(tk[0], tv, spec, **kw),
         j_bcast, lambda r: ops.multisplit_key_value(keys[0], vals[r], spec, **kw)),
    ]
    for got, want, row in cases:
        _eq_result(got, want)
        for r in range(4):
            loop = row(r)
            for f in FIELDS:
                a = getattr(got, f)
                _eq(None if a is None else a[r], getattr(loop, f))
    hist = torch.vmap(ops.histogram, in_dims=(0, None))(tk, spec, backend=backend, device="cpu")
    _eq(hist, j_hist)
    partial = torch.vmap(ops.multisplit, in_dims=(0, None),
                         out_dims=ops.vmap_out_dims("positions_only"))(
        tk, spec, mode="positions_only", backend=backend, device="cpu")
    _eq_result(partial, j_pos)


@pytest.mark.parametrize("backend", ["vmap", "cuda"])
def test_grad_and_vmap_of_grad_of_the_kv_op(backend):
    """The key-value op's backward is the inverse gather of the forward
    permutation, under ``torch.func.grad`` and under ``vmap`` of it; it
    equals the per-row ``backward()`` and ``jax.vmap(jax.grad)``."""
    keys, vals, w = _vmap_inputs()
    spec = convert_spec(VMAP_SPEC)

    def loss(v, k, ww):
        return (ops.multisplit_key_value(k, v, spec, backend=backend, device="cpu").values
                * ww).sum()

    tk, tv, tw = (torch.from_numpy(x) for x in (keys, vals, w))
    batched = torch.vmap(torch.func.grad(loss))(tv, tk, tw)
    for r in range(4):
        v = tv[r].clone().requires_grad_()
        loss(v, tk[r], tw[r]).backward()
        assert torch.equal(torch.func.grad(loss)(tv[r], tk[r], tw[r]), v.grad)
        assert torch.equal(batched[r], v.grad)
    _eq(batched, _jax_vmap_grad())


@functools.lru_cache(maxsize=None)
def _jax_vmap_grad():
    keys, vals, w = _vmap_inputs()
    jgrad = jax.vmap(jax.grad(lambda v, k, ww: (jops.multisplit_key_value(
        k, v, VMAP_SPEC, method="bms", backend="reference").values * ww).sum()))
    return np.asarray(jgrad(jnp.asarray(vals), jnp.asarray(keys), jnp.asarray(w)))


def _spy(monkeypatch, names):
    calls = []
    for name in names:
        real = getattr(tkops, name)
        monkeypatch.setattr(tkops, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    return calls


def test_a_batch_is_one_launch_a_stage(monkeypatch):
    """Eight rows, one prescan and one postscan call: through the batched
    plan, ``torch.vmap`` of the key-only and key-value ops, the histogram
    and the batched radix sort (one of each a pass)."""
    calls = _spy(monkeypatch, ["spec_tile_histograms", "spec_fused_postscan_reorder",
                               "spec_tile_positions"])
    keys, vals = _rows(8, 512, 101)
    spec = ops.DeltaSpec(4, 2**32)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    tcore.batched_multisplit(tk, spec, tile=256, device="cpu")
    assert calls == ["spec_tile_histograms", "spec_fused_postscan_reorder"]
    del calls[:]
    torch.vmap(ops.multisplit, in_dims=(0, None), out_dims=ops.vmap_out_dims())(
        tk, spec, method="dms", device="cpu")
    torch.vmap(ops.multisplit_key_value, in_dims=(0, 0, None))(tk, tv, spec, device="cpu")
    torch.vmap(ops.histogram, in_dims=(0, None))(tk, spec, device="cpu")
    assert calls == ["spec_tile_histograms", "spec_tile_positions",
                     "spec_tile_histograms", "spec_fused_postscan_reorder",
                     "spec_tile_histograms"]
    del calls[:]
    ops.radix_sort(tk, tv, device="cpu")
    assert calls == ["spec_tile_histograms", "spec_fused_postscan_reorder"] * 4


@pytest.mark.parametrize("method,key_value,reorders", [
    ("bms", True, 2), ("bms", False, 1), ("wms", True, 2), ("dms", True, 0)])
def test_multisplit_unfused_runs_k1_k3_and_b10(monkeypatch, method, key_value, reorders):
    calls = _spy(monkeypatch, ["tile_histograms", "tile_positions", "tile_reorder",
                               "fused_postscan_reorder"])
    keys, vals = (x.reshape(-1) for x in _rows(1, 3000, 111))
    tcore.multisplit_unfused(keys, ops.DeltaSpec(32, 2**32), vals if key_value else None,
                             method=method, device="cpu")
    assert calls == ["tile_histograms", "tile_positions"] + ["tile_reorder"] * reorders


# ---------------------------------------------------------------------------
# Plan rules, the shim and the imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["reorder", "counts_only", "positions_only"])
@pytest.mark.parametrize("backend", ["reference", "vmap", "cuda"])
def test_batched_plans_match_jax_rules(backend, mode):
    spec = ops.DeltaSpec(8)
    flat = tpipe.make_plan(700, 8, backend=backend, bucket_fn=spec, mode=mode)
    plan = tpipe.make_batched_plan(3, 700, 8, backend=backend, bucket_fn=spec, mode=mode)
    assert plan.layout == "batched" and flat.layout == "flat"
    assert plan.stages() == ("layout:batched[3]",) + flat.stages()
    assert (plan.tile, plan.family) == (flat.tile, flat.family)
    jplan = jmake_batched_plan(3, 700, 8, backend="vmap", bucket_fn=jid.DeltaSpec(8), mode=mode)
    assert jplan.stages()[0] == plan.stages()[0] and jplan.layout == plan.layout
    radix = tpipe.RadixPipeline(700, backend=backend, batch=3, fuse_digits=True)
    assert all(p.batch == 3 for p in radix.plans)


@pytest.mark.parametrize("call,match", [
    (lambda: tpipe.make_plan(8, 4, batch=0), "batch must be >= 1"),
    (lambda: tpipe.make_plan(8, 4, batch=2, segments=2), "mutually exclusive"),
    (lambda: tpipe.make_batched_plan(2, 8, 4, bucket_fn=ops.DeltaSpec(4))(
        torch.zeros((3, 8), dtype=torch.int32)), "resolved for shape"),
    (lambda: tpipe.make_batched_plan(2, 8, 4, key_value=True, bucket_fn=ops.DeltaSpec(4))(
        torch.zeros((2, 8), dtype=torch.int32), torch.zeros((2, 7), dtype=torch.int32)),
     "values of shape"),
    (lambda: tcore.batched_multisplit(np.zeros(8, np.int32), ops.DeltaSpec(4), device="cpu"),
     "expects \\(b, n\\) keys"),
    (lambda: ops.radix_sort(np.zeros((2, 2, 4), np.uint32), device="cpu"), "or \\(b, n\\) keys"),
    (lambda: ops.multisplit(np.zeros((2, 4), np.int32), ops.DeltaSpec(4), device="cpu"),
     "torch.vmap\\(ops.multisplit\\)"),
    (lambda: tcore.multisplit_unfused(np.zeros(8, np.int32), ops.DeltaSpec(4), method="xms",
                                      device="cpu"), "unknown multisplit method"),
])
def test_batched_refusals_carry_the_jax_messages(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_plan_shim_reexports_the_pipeline():
    from repro_torch.core import plan as tplan

    for name in tplan.__all__:
        assert getattr(tplan, name) is getattr(tpipe, name), name
    assert tplan._TILE_CACHE is tpipe.tiles._TILE_CACHE
    assert tplan.make_batched_plan(2, 100, 4, bucket_fn=ops.DeltaSpec(4)).batch == 2


@pytest.mark.parametrize("fn", [tcore.batched_multisplit, tsort.radix_sort_per_pass],
                         ids=lambda f: f.__name__)
def test_new_entry_points_default_to_the_card(fn):
    import inspect

    params = inspect.signature(fn).parameters
    assert params["backend"].default == "cuda" and params["device"].default == "cuda"
    assert inspect.signature(tcore.multisplit_unfused).parameters["device"].default == "cuda"


_PATH_CODE = (
    "import sys, torch, numpy as np; from repro_torch import ops\n"
    "from repro_torch.core import multisplit as c, sort as s, plan\n"
    "k = torch.from_numpy((np.arange(3000, dtype=np.uint32) * 2654435761).reshape(3, 1000))\n"
    "c.batched_multisplit(k, ops.DeltaSpec(8, 2**32), k.view(torch.int32), device='cpu')\n"
    "torch.vmap(ops.histogram, in_dims=(0, None))(k, ops.DeltaSpec(8, 2**32), device='cpu')\n"
    "ops.radix_sort(k, fuse_digits=True, device='cpu')\n"
    "s.radix_sort_per_pass(k, device='cpu'); s.direct_sort_multisplit(k)\n"
    "c.multisplit_unfused(k[0], ops.DeltaSpec(8, 2**32), k[1], device='cpu')\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
    "assert not bad, bad\n"
)
fresh_process = _fresh_process.started(_PATH_CODE)


def test_batched_path_loads_neither_jax_nor_repro(fresh_process):
    """The batched ops, torch.vmap, the unfused baselines and the shim, in a
    fresh process, import no module of JAX and none of the JAX package."""
    rc, _, err = _fresh_process.finished(fresh_process)
    assert rc == 0, err
