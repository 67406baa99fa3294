"""The fused two-digit radix (K1f-K3f, ``fuse_digits=True``) against the JAX
package, bitwise.

A fused pair is one stable pass over the combined digit of two adjacent
radix digits; by the LSD identity it equals the two chained single-digit
passes bit for bit, and the in-tile sweep's stage width (``sub_bits``), the
split and the kernel family change the cost only. On the CPU the cuda
backend's fused2 wrappers run their plain versions, so these tests hold, on
the same numpy inputs made from a seed:

* the pair schedule (``radix_pass_pairs``) against the JAX package's;
* the plain bodies against ``repro.kernels.common``'s fused2 bodies in
  their gather form, bases past 2^24 included;
* the three wrappers against their Pallas twins in interpret mode;
* ``radix_sort`` and ``segmented_radix_sort`` with ``fuse_digits=True`` on
  ``vmap`` and ``cuda`` against the JAX package's fused sorts on ``vmap``
  and ``pallas-interpret`` (segmented: ``vmap``, and ``pallas-interpret`` at
  r = 8) and against the port's unfused sorts;
* the plan rules: the ``digit_split`` refusals, the stage tags, the sweep
  counts, the digits slot of the family and tile caches, what a CUDA launch
  refuses, and that the fused path loads neither JAX nor the JAX package.

Keys and values are compared as int32 bit patterns. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import identifiers as jid
from repro.core import sort as jsort
from repro.core.pipeline import make_plan as jmake_plan
from repro.core.pipeline import radix as jradix
from repro.kernels import common as jcommon
from repro.kernels import ops as jkops
from repro_torch import ops
from repro_torch.core import pipeline as tpipe
from repro_torch.core import sort as tsort
from repro_torch.core.pipeline import stages as tst
from repro_torch.kernels import common, multisplit_tile as mst
from repro_torch.kernels import ops as tkops

BIG = (1 << 24) + 1          # bases past 2^24


def _bits(a) -> np.ndarray:
    a = np.asarray(a.detach().numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _eq(got, want) -> None:
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _uint_keys(shape, rng):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _vals(shape, rng):
    return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(np.int32)


def _seg_strip(shape, s, rng):
    """(L, T) int32 ids of s ragged segments, two of them empty."""
    n = shape[0] * shape[1]
    starts = np.concatenate([[0], np.sort(rng.integers(0, n + 1, s - 1))])
    starts[1] = starts[0]
    starts[-1] = starts[-2]
    return (np.searchsorted(starts, np.arange(n), side="right") - 1).astype(np.int32).reshape(shape)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


# ---------------------------------------------------------------------------
# (1) the pair schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key_bits", [16, 30, 32])
@pytest.mark.parametrize("r", range(1, 17))
def test_radix_pass_pairs_match_jax(r, key_bits):
    got = tpipe.radix_pass_pairs(r, key_bits)
    assert got == jradix.radix_pass_pairs(r, key_bits)
    assert tpipe.radix_passes(r, key_bits) == jradix.radix_passes(r, key_bits)
    covered = [b for sh, bits, _ in got for b in range(sh, sh + bits)]
    assert covered == list(range(key_bits))          # every bit once, in order


@pytest.mark.parametrize("max_pair_bits", [1, 9, 12])
def test_radix_pass_pairs_under_a_narrow_ceiling_match_jax(max_pair_bits):
    for r in range(1, 17):
        for key_bits in (16, 30, 32):
            assert (tpipe.radix_pass_pairs(r, key_bits, max_pair_bits)
                    == jradix.radix_pass_pairs(r, key_bits, max_pair_bits))
    assert tpipe.MAX_PAIR_BITS == jradix.MAX_PAIR_BITS == mst.MAX_PAIR_BITS


# ---------------------------------------------------------------------------
# (2) the plain bodies against repro.kernels.common (gather form)
# ---------------------------------------------------------------------------

# (bits, split, shift, family, sub_bits, segments, key_value): the splits
# (16, 8), (14, 7) and the uneven (6, 4), both families, every sub_bits,
# flat and segmented, keys and key-value
BODY_CASES = [
    (16, 8, 0, "onehot", 4, 1, True),
    (16, 8, 16, "packed", 8, 5, False),
    (14, 7, 7, "onehot", 1, 5, True),
    (14, 7, 18, "packed", 3, 1, True),
    (6, 4, 26, "packed", 1, 9, False),
]


def _body_case(case):
    bits, split, shift, family, sub_bits, s, key_value = case
    rng = np.random.default_rng(bits * 100 + shift)
    shape = (3, 256)
    keys = _uint_keys(shape, rng)
    keys[1] = keys[1, 0]                               # a one-cell tile
    keys[2, :40] = keys[2, 40]
    seg = _seg_strip(shape, s, rng) if s > 1 else None
    vals = _vals(shape, rng) if key_value else None
    return keys, seg, vals


@pytest.mark.parametrize("case", BODY_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_bodies_match_jax(case):
    bits, split, shift, family, sub_bits, s, key_value = case
    keys, seg, vals = _body_case(case)
    hist = common.fused2_counts_body(_t(keys), shift, bits, _t(seg), s)
    kw = dict(num_segments=s, family=family, sub_bits=sub_bits)

    def jax_body(k, sg, g, v):
        h = jcommon.fused2_counts_body(k, shift, bits, seg=sg, num_segments=s)
        return h, jcommon.fused2_postscan_body(k, g, v, shift, split, bits, seg=sg, **kw)

    g = tst.global_scan(hist) + BIG
    jh, (jk, jv, jp, jperm) = jax.jit(jax.vmap(jax_body))(
        _j(keys), _j(seg), jnp.asarray(g.numpy()), _j(vals))
    _eq(hist, jh)
    got = common.fused2_postscan_body(_t(keys), g, _t(vals), shift, split, bits, seg=_t(seg), **kw)
    for a, b in zip(got, (jk, jv, jp, jperm)):
        _eq(a, b)
    _eq(common.fused2_positions_body(_t(keys), g, shift, split, bits, seg=_t(seg), **kw), jperm)
    row = 2                                            # the stage primitives on one strip
    sg = None if seg is None else _t(seg[row])
    _eq(tst.fused2_tile_counts(_t(keys[row]), shift, bits, sg, s), jh[row])
    strip = tst.fused2_tile_postscan(_t(keys[row]), g[row], None if vals is None else _t(vals[row]),
                                     shift, split, bits, sg, **kw)
    for a, b in zip(strip, (jk, jv, jp, jperm)):
        _eq(a, None if b is None else b[row])
    lo, hi = common.fused2_split_digits(_t(keys), shift, split, bits - split)
    jlo, jhi = jcommon.fused2_split_digits(_j(keys), shift, split, bits - split)
    _eq(lo, jlo)
    _eq(hi, jhi)


def test_plain_body_is_split_sub_bits_and_family_invariant():
    """The LSD identity: every decomposition of the pair gives the bits of
    the single-digit postscan over the pair's BitfieldSpec."""
    rng = np.random.default_rng(7)
    keys = torch.from_numpy(_uint_keys((2, 300), rng))
    vals = torch.from_numpy(_vals((2, 300), rng))
    spec = ops.BitfieldSpec(4, 10)
    g = tst.global_scan(common.counts_body(spec.emit(keys), 1024))
    want = common.postscan_body(spec.emit(keys), g, keys, vals, 1024)
    for split in (1, 5, 9):
        for sub_bits in (1, 3, 4, 8, 10):
            for family in ("onehot", "packed"):
                got = common.fused2_postscan_body(keys, g, vals, 4, split, 10, family=family,
                                                  sub_bits=sub_bits)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (3) the wrappers against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

# form -> (bits, split, shift, (L, T), s, family, sub_bits)
FORMS = {
    "flat-onehot": (16, 8, 0, (2, 512), 1, "onehot", 4),
    "flat-packed": (14, 7, 14, (3, 256), 1, "packed", None),
    "seg-onehot": (6, 4, 26, (4, 256), 17, "onehot", 1),
    "seg-packed": (16, 8, 16, (2, 384), 5, "packed", 8),
}


@functools.lru_cache(maxsize=None)
def _form(form):
    bits, split, shift, shape, s, family, sub_bits = FORMS[form]
    rng = np.random.default_rng(len(form) + bits)
    keys = _uint_keys(shape, rng)
    keys[0, 100:200] = keys[0, 100]
    seg = _seg_strip(shape, s, rng) if s > 1 else None
    jspec, tspec = jid.BitfieldSpec(shift, bits), ops.BitfieldSpec(shift, bits)
    kw = dict(split=split, num_segments=s, family=family, sub_bits=sub_bits)
    return keys, seg, _vals(shape, rng), jspec, tspec, kw


def _bases(form, offset):
    keys, seg, _, _, tspec, kw = _form(form)
    hist = mst.fused2_tile_histograms(_t(keys), _t(seg), spec=tspec,
                                      num_segments=kw["num_segments"])
    return tst.global_scan(hist) + offset


@pytest.mark.parametrize("form", ["flat-onehot", "seg-packed"])
def test_fused2_histograms_vs_pallas(form):
    keys, seg, _, jspec, tspec, kw = _form(form)
    s = kw["num_segments"]
    want = jkops.fused2_tile_histograms(_j(keys), _j(seg), spec=jspec, num_segments=s,
                                        oblivious=False)
    _eq(tkops.fused2_tile_histograms(_t(keys), _t(seg), spec=tspec, num_segments=s), want)


K1F_WINDOW_CELLS = 1 << mst.MAX_PAIR_BITS     # the 16-bit counters K1f keeps in shared memory


def _k1f_packed_counts(keys, seg, shift, bits, s):
    """K1f's counting (csrc/fused2_tile_histograms.cu) in torch: for each
    tile, the windows of whole segments between its lowest and highest one,
    each counted into 16-bit halves of int32 words (``cell >> 1`` gets ``1
    << 16·(cell & 1)`` a key) and unpacked to int32; zeros elsewhere. A half
    that passed 2^16 would carry into its neighbour and show."""
    n_tiles, t = keys.shape
    m2 = 1 << bits
    win = min(s, max(1, K1F_WINDOW_CELLS // m2))
    pair = (torch.from_numpy(keys.astype(np.int64)) >> shift) & (m2 - 1)
    segs = torch.zeros((n_tiles, t), dtype=torch.int64) if seg is None else torch.from_numpy(
        seg.astype(np.int64))
    out = torch.zeros((n_tiles, s * m2), dtype=torch.int32)
    for tile in range(n_tiles):
        lo, hi = int(segs[tile].min()), int(segs[tile].max())
        for a in range(0, s, win):
            wn = min(win, s - a)
            if a > hi or a + wn <= lo:
                continue
            inside = (segs[tile] >= a) & (segs[tile] < a + wn)
            cell = (segs[tile][inside] - a) * m2 + pair[tile][inside]
            words = torch.zeros(wn * m2 // 2, dtype=torch.int32)
            words.index_add_(0, cell >> 1, (1 << (16 * (cell & 1))).to(torch.int32))
            out[tile, a * m2:(a + wn) * m2] = torch.stack([words & 0xFFFF, words >> 16], 1).view(-1)
    return out


@pytest.mark.parametrize("segmented", [False, True], ids=["flat", "segmented"])
@pytest.mark.parametrize("fill", ["even-cell", "odd-cell", "both-halves"])
def test_k1f_packed_counting_vs_jax_at_full_tiles(fill, segmented):
    """The design of K1f's 16-bit counters, emulated in torch, against the JAX
    fused2_tile_histograms on tiles of MAX_TILE = 8192 keys at the 16-bit
    pair: every key in the even cell of one word, every key in its odd cell,
    and 4096 keys in each cell of it. The emulation runs none of the
    kernel's code, and the wrapper on CPU tensors takes the plain version;
    the kernel itself is held bitwise against its plain version on these
    cases on the card, in phase 3e of chip_smoke.py."""
    t = mst.MAX_TILE
    keys = np.full((2, t), 0x5A5A1234, np.uint32)
    if fill == "odd-cell":
        keys += 1
    elif fill == "both-halves":
        keys[:, np.random.default_rng(t).permutation(t)[: t // 2]] += 1
    seg, s = (np.array([[1] * t, [2] * t], np.int32), 3) if segmented else (None, 1)
    want = jkops.fused2_tile_histograms(_j(keys), _j(seg), spec=jid.BitfieldSpec(0, 16),
                                        num_segments=s, oblivious=False)
    got = _k1f_packed_counts(keys, seg, 0, 16, s)
    _eq(got, want)
    assert int(got.max()) == (t if fill != "both-halves" else t // 2)
    _eq(mst.fused2_tile_histograms(_t(keys), _t(seg), spec=ops.BitfieldSpec(0, 16),
                                   num_segments=s), want)


@pytest.mark.parametrize("form,offset", [("flat-packed", BIG)])
def test_fused2_positions_vs_pallas(form, offset):
    keys, seg, _, jspec, tspec, kw = _form(form)
    g = _bases(form, offset)
    want = jkops.fused2_tile_positions(_j(keys), jnp.asarray(g.numpy()), _j(seg), spec=jspec,
                                       oblivious=False, **kw)
    _eq(tkops.fused2_tile_positions(_t(keys), g, _t(seg), spec=tspec, **kw), want)


@pytest.mark.parametrize("form,key_value", [
    ("flat-onehot", True), ("seg-onehot", False), ("seg-packed", True),
])
def test_fused2_fused_postscan_reorder_vs_pallas(form, key_value):
    keys, seg, vals, jspec, tspec, kw = _form(form)
    g = _bases(form, BIG if key_value else 0)
    vals = vals if key_value else None
    want = jkops.fused2_fused_postscan_reorder(_j(keys), jnp.asarray(g.numpy()), _j(vals),
                                               _j(seg), spec=jspec, oblivious=False, **kw)
    got = tkops.fused2_fused_postscan_reorder(_t(keys), g, _t(vals), _t(seg), spec=tspec, **kw)
    assert (got[1] is None) == (not key_value)
    for a, b in zip(got, want):
        _eq(a, b)


def test_fused2_wrappers_vs_oblivious_pallas_at_128():
    """The compiled-path (oblivious) Pallas forms give the same bits."""
    rng = np.random.default_rng(128)
    keys, vals = _uint_keys((2, 128), rng), _vals((2, 128), rng)
    jspec, tspec = jid.BitfieldSpec(3, 12), ops.BitfieldSpec(3, 12)
    hist = jkops.fused2_tile_histograms(_j(keys), spec=jspec, oblivious=True)
    _eq(mst.fused2_tile_histograms(_t(keys), spec=tspec), hist)
    g = tst.global_scan(torch.tensor(np.asarray(hist))) + BIG
    want = jkops.fused2_fused_postscan_reorder(_j(keys), jnp.asarray(g.numpy()), _j(vals),
                                               spec=jspec, split=6, oblivious=True)
    got = mst.fused2_fused_postscan_reorder(_t(keys), g, _t(vals), spec=tspec, split=6)
    for a, b in zip(got, want):
        _eq(a, b)


def test_fused2_launch_checks_what_the_kernels_take():
    """What a CUDA launch is given, checked without a card: pairs of 1..16
    bits inside the key, stages of 1..8 bits (the default 8), integer keys,
    a known family, a segment strip for s > 1; the plain versions take any
    stage width, as JAX does."""
    keys = torch.zeros((2, 512), dtype=torch.uint32)
    spec = ops.BitfieldSpec(16, 16)
    args = functools.partial(mst._fused2_launch_args, keys, None, spec, 1)
    assert args() == (2, 512, 65536, mst.CUDA_SUB_BITS)
    assert args("packed", 1)[3] == 1
    for sub in (0, 9, 16):
        with pytest.raises(ValueError, match="stages of 1..8 bits"):
            args("onehot", sub)
    with pytest.raises(ValueError, match="pairs of 1..16 bits"):
        mst._fused2_launch_args(keys, None, ops.BitfieldSpec(0, 17), 1)
    with pytest.raises(ValueError, match="pairs of 1..16 bits"):
        mst._fused2_launch_args(keys, None, ops.BitfieldSpec(20, 16), 1)
    with pytest.raises(ValueError, match="unknown kernel family"):
        args("dense")
    with pytest.raises(ValueError, match="needs a segment strip"):
        mst._fused2_launch_args(keys, None, spec, 3)
    with pytest.raises(ValueError, match="must be one of"):
        mst._fused2_launch_args(keys.to(torch.int16), None, ops.BitfieldSpec(0, 8), 1)
    with pytest.raises(TypeError, match="integer keys"):
        mst._fused2_launch_args(keys.float(), None, ops.BitfieldSpec(0, 8), 1)
    with pytest.raises(TypeError, match="integer keys"):
        mst.fused2_tile_histograms(keys.float(), spec=ops.BitfieldSpec(0, 8))
    with pytest.raises(ValueError, match="BitfieldSpec"):
        mst._fused2_launch_args(keys, None, ops.DeltaSpec(8), 1)
    ids = _t(np.random.default_rng(0).integers(0, 2**32, (2, 64), dtype=np.uint64)
             .astype(np.uint32))
    g = tst.global_scan(mst.fused2_tile_histograms(ids, spec=ops.BitfieldSpec(0, 12)))
    want = mst.fused2_tile_positions(ids, g, spec=ops.BitfieldSpec(0, 12), split=6)
    _eq(mst.fused2_tile_positions(ids, g, spec=ops.BitfieldSpec(0, 12), split=6, sub_bits=12),
        want)


# ---------------------------------------------------------------------------
# (4) the fused sorts against repro's, on vmap and pallas-interpret
# ---------------------------------------------------------------------------

N, TILE = 1500, 512
STARTS = np.array([0, 0, 17, 600, 601, 601, 1400], np.int32)
# the key bits each radix width sorts, one pair each: r = 4 an uneven pair
# (4 + 2 bits), r = 7 a 14-bit pair, r = 8 a 16-bit pair (the trailing
# single pass: test_fused_sort_methods_and_full_keys_equal_the_unfused_port)
KEY_BITS = {4: 6, 7: 14, 8: 16}


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(N)
    keys = _uint_keys(N, rng)
    keys[300:500] = keys[300]                          # a run of one pair digit
    return keys, _vals(N, rng)


@functools.lru_cache(maxsize=None)
def _jax_sort(radix_bits, segmented):
    """The JAX package's fused key-value sort on vmap (onehot) and on
    pallas-interpret (packed), held equal to each other; numpy keys and
    values. Segmented at r = 4 and 7 on vmap alone: each pallas-interpret
    sort costs about 2 s of tracing on the CPU."""
    keys, vals = _data()

    def run(backend, family):
        kw = dict(radix_bits=radix_bits, key_bits=KEY_BITS[radix_bits], backend=backend,
                  tile=TILE, family=family, fuse_digits=True)
        if segmented:
            return lambda k, v: jsort.segmented_radix_sort(k, jnp.asarray(STARTS), v, **kw)
        return lambda k, v: jsort.radix_sort(k, v, **kw)

    # the vmap stages compile faster under one jit than they run op by op
    a = jax.jit(run("vmap", "onehot"))(jnp.asarray(keys), jnp.asarray(vals))
    if not segmented or radix_bits == 8:
        b = run("pallas-interpret", "packed")(jnp.asarray(keys), jnp.asarray(vals))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_bits(x), _bits(y))
    return np.asarray(a[0]), np.asarray(a[1])


@pytest.mark.parametrize("family", ["onehot", "packed"])
@pytest.mark.parametrize("backend", ["vmap", "cuda"])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("radix_bits", [4, 7, 8])
def test_fused_sorts_match_jax_and_the_unfused_port(radix_bits, segmented, backend, family):
    keys, vals = _data()
    want_k, want_v = _jax_sort(radix_bits, segmented)
    kw = dict(radix_bits=radix_bits, key_bits=KEY_BITS[radix_bits], backend=backend, tile=TILE,
              family=family, device="cpu")
    if segmented:
        fused = [ops.segmented_radix_sort(keys, STARTS, vals, fuse_digits=True, **kw),
                 tsort.segmented_radix_sort(_t(keys), STARTS, _t(vals), fuse_digits=True, **kw),
                 ops.segmented_radix_sort(keys, STARTS, fuse_digits=True, **kw)]
        unfused = ops.segmented_radix_sort(keys, STARTS, vals, **kw)
    else:
        fused = [ops.radix_sort(keys, vals, fuse_digits=True, **kw),
                 tsort.radix_sort(_t(keys), _t(vals), fuse_digits=True, **kw),
                 ops.radix_sort(keys, fuse_digits=True, **kw)]
        unfused = ops.radix_sort(keys, vals, **kw)
    for k, v in fused:
        _eq(k, want_k)
        _eq(v, None if v is None else want_v)
    assert fused[2][1] is None
    _eq(unfused[0], want_k)
    _eq(unfused[1], want_v)


@pytest.mark.parametrize("method", ["dms", "wms"])
@pytest.mark.parametrize("backend", ["vmap", "cuda"])
def test_fused_sort_methods_and_full_keys_equal_the_unfused_port(backend, method):
    """32-bit keys at r = 8 (two 16-bit pairs) and r = 7 (two 14-bit pairs
    and a 4-bit trailing pass), dms (K3f) and wms, flat and segmented."""
    keys, vals = _data()
    for r in (7, 8):
        kw = dict(radix_bits=r, method=method, backend=backend, device="cpu")
        for fused, unfused in (
            (ops.radix_sort(keys, vals, fuse_digits=True, **kw), ops.radix_sort(keys, vals, **kw)),
            (ops.segmented_radix_sort(keys, STARTS, fuse_digits=True, **kw),
             ops.segmented_radix_sort(keys, STARTS, **kw)),
        ):
            for a, b in zip(fused, unfused):
                _eq(a, None if b is None else b.numpy())


def test_reference_keeps_the_single_digit_schedule():
    p = tpipe.RadixPipeline(4096, radix_bits=8, backend="reference", fuse_digits=True)
    jp = jradix.RadixPipeline(4096, radix_bits=8, backend="reference", fuse_digits=True)
    assert p.schedule == jp.schedule == [(0, 8, None), (8, 8, None), (16, 8, None), (24, 8, None)]
    assert p.n_sweeps == p.n_passes == 4
    assert all(plan.digit_split is None for plan in p.plans)
    assert not tpipe.get_backend("reference").fuses_digits
    assert tpipe.get_backend("vmap").fuses_digits and tpipe.get_backend("cuda").fuses_digits
    keys, vals = _data()
    got = ops.radix_sort(keys, vals, key_bits=16, backend="reference", fuse_digits=True,
                         device="cpu")
    want_k, want_v = _jax_sort(8, False)
    _eq(got[0], want_k)
    _eq(got[1], want_v)


# ---------------------------------------------------------------------------
# (5) plan rules: refusals, stage tags, sweeps, the digits slot, imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,spec,split", [
    ("reference", (0, 16), 8), ("vmap", None, 4), ("cuda", (0, 16), 0), ("vmap", (0, 16), 16),
    ("cuda", (4, 6), 9),
])
def test_digit_split_refusals_carry_the_jax_messages(backend, spec, split):
    jbackend = "pallas-interpret" if backend == "cuda" else backend
    if spec is None:
        jkw, tkw = dict(bucket_fn=jid.DeltaSpec(256)), dict(bucket_fn=ops.DeltaSpec(256))
        m = 256
    else:
        jkw, tkw = dict(bucket_fn=jid.BitfieldSpec(*spec)), dict(bucket_fn=ops.BitfieldSpec(*spec))
        m = 1 << spec[1]
    with pytest.raises(ValueError) as want:
        jmake_plan(1000, m, backend=jbackend, digit_split=split, **jkw)
    with pytest.raises(ValueError) as got:
        tpipe.make_plan(1000, m, backend=backend, digit_split=split, **tkw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("segments", [None, 3])
@pytest.mark.parametrize("mode", ["reorder", "counts_only", "positions_only"])
@pytest.mark.parametrize("method", ["dms", "bms"])
def test_fused2_stage_tags_match_jax(method, mode, segments):
    for backend, jbackend in (("vmap", "vmap"), ("cuda", "pallas-interpret")):
        for family in ("onehot", "packed"):
            got = tpipe.make_radix_plan(5000, 8, 12, method=method, backend=backend, mode=mode,
                                        segments=segments, family=family, digit_split=5).stages()
            want = jmake_plan(5000, 4096, method=method, backend=jbackend, mode=mode,
                              segments=segments, family=family, digit_split=5,
                              bucket_fn=jid.BitfieldSpec(8, 12)).stages()
            assert got == want
            assert got[0 if segments is None else 1] == (
                f"prescan:fused2-pair-{'kernel' if backend == 'cuda' else 'vmap'}")


@pytest.mark.parametrize("backend", ["vmap", "cuda"])
def test_sweeps_schedule_and_plans(backend):
    p = tpipe.RadixPipeline(1 << 16, radix_bits=8, backend=backend, fuse_digits=True)
    assert p.n_passes == 4 and p.n_sweeps == 2
    assert p.schedule == [(0, 16, 8), (16, 16, 8)]
    assert all(plan.digit_split == 8 and plan.tile == p.tile for plan in p.plans)
    p7 = tpipe.RadixPipeline(1 << 16, radix_bits=7, key_value=True, backend=backend,
                             fuse_digits=True, sub_bits=3)
    jp7 = jradix.RadixPipeline(1 << 16, radix_bits=7, key_value=True, backend="vmap",
                               fuse_digits=True)
    assert p7.schedule == jp7.schedule and p7.n_sweeps == jp7.n_sweeps == 3
    assert p7.n_passes == jp7.n_passes == 5
    assert [plan.sub_bits for plan in p7.plans] == [3, 3, None]
    assert p7.plans[-1].digit_split is None and p7.plans[-1].num_buckets == 16
    assert p7.plans[-1].stages()[1] == "scan:global"
    unfused = tpipe.RadixPipeline(1 << 16, radix_bits=8, backend=backend)
    assert unfused.n_sweeps == unfused.n_passes == 4
    assert unfused.schedule == [(0, 8, None), (8, 8, None), (16, 8, None), (24, 8, None)]


def test_the_digits_slot_keeps_fused_decisions_apart():
    """A fused pair's family is decided at its stage width with a digits
    slot, so it never collides with a digits=1 plan of m == stage_m, and
    its tile (the fused-pair constant) is cached apart from that plan's."""
    n = 123457
    p = tpipe.RadixPipeline(n, radix_bits=8, backend="cuda", fuse_digits=True)
    decisions = tpipe.family_decisions()
    assert (n, 256, "bms", "cuda", 2) in decisions
    assert (n, 256, "bms", "cuda") not in decisions
    assert tpipe.family_decision(n, 256, "bms", "cuda", digits=2)[0] == "onehot"
    assert p.tile == tpipe.FUSED2_CUDA_TILE == mst.MAX_TILE
    assert tpipe.resolve_tile(n, 65536, "bms", False, "cuda", digits=2, stage_m=256) == p.tile
    single = tpipe.make_plan(n, 256, backend="cuda")
    assert single.tile == tpipe.CUDA_TILE != p.tile
    assert (n, 256, "bms", "cuda") in tpipe.family_decisions()
    # a different split of the same pair width keys its own tile entry
    assert tpipe.resolve_tile(n, 65536, "bms", False, "cuda", digits=2, stage_m=64) == p.tile
    assert tpipe.make_radix_plan(n, 0, 16, backend="cuda", digit_split=6).family == "onehot"
    assert (n, 64, "bms", "cuda", 2) in tpipe.family_decisions()
    assert tpipe.RadixPipeline(n, radix_bits=8, backend="vmap", fuse_digits=True).tile == \
        tpipe.FUSED2_VMAP_TILE
    assert tpipe.RadixPipeline(100, radix_bits=8, backend="cuda", fuse_digits=True).tile == 256


def test_fused_path_loads_neither_jax_nor_repro():
    """Running the fused sorts on the CPU, in a fresh process, imports no
    module of JAX and none of the JAX package."""
    code = (
        "import sys, numpy as np; from repro_torch import ops\n"
        "k = np.arange(3000, dtype=np.uint32) * 2654435761\n"
        "ops.radix_sort(k, k.view(np.int32), radix_bits=7, fuse_digits=True, device='cpu')\n"
        "ops.segmented_radix_sort(k, np.array([0, 100]), fuse_digits=True, family='packed',\n"
        "                         method='dms', device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
