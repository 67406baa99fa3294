"""The Hopper designs of K1p and K3f, emulated step by step in numpy, against
the JAX package's Pallas kernels on the CPU (interpret mode).

K1p (``csrc/packed_tile_histograms.cu``) is K1's order-free count (and
K1s's window of segments) on the packed family's counters: a copy of a
window's counters is ⌈words/4⌉ 32-bit words of four 8-bit lanes, lane l of
warp w adds 1 << 8·(c mod 4) to word c / 4 of copy l + 32·(w mod groups)
(two copies a lane, 64 in all, at T > 4096; one, 32 in all, below), and
the unpack once a window sums word j of every copy in two accumulators of
16-bit lanes (even and odd bytes) into four columns of the row. A lane may
take at most 255 adds: with one copy a lane, a one-bucket tile of 8192 keys
would put 256 into one. Segmented, the tile's clamped end ids [lo, hi]
bound its window; a one-run tile (lo == hi) reads no other id, any other
counts at (seg - lo)·m + b and walks windows of as many whole segments as a
copy's words allow; each column of the row is written once.

K3f (``csrc/fused2_tile_positions.cu``) is K2f's body
(``fused2::postscan_kernel`` in ``csrc/multisplit_fused2.cuh``) in its
positions-only form, so its steps are ``k2f_design``'s and its output is
that design's perm.

The CUDA kernels themselves are held against the plain versions on the card
by ``chip_smoke.py``; these tests hold the designs' arithmetic to the Pallas
functions they replace."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import identifiers as jid
from repro.kernels import ops as jkops
from test_torch_k2fk2p_design import _fused_bases, _same, k2f_design
from test_torch_k3k2s_design import _strip

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
K1P_SRC = (CSRC / "packed_tile_histograms.cu").read_text()
# the block, the words of a set of copies and the copies a lane at T > 4096,
# as the kernel's source sets them
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", K1P_SRC).group(1))
SET_WORDS = int(re.search(r"constexpr int kSetWords = (\d+);", K1P_SRC).group(1))
WIDE_GROUPS = int(re.search(r"return kVec == 4 \? (\d+) : 1;", K1P_SRC).group(1))
MAX_TILE = 8192
LANE_CAP = 255           # an 8-bit lane


def _geometry(t: int, m: int):
    """(copies, words a copy may take, segments a window) at tile width t."""
    k_vec = 1 if t <= 4 * THREADS else 2 if t <= 8 * THREADS else 4
    copies = 32 * (WIDE_GROUPS if k_vec == 4 else 1)
    copy_words = SET_WORDS // copies
    per = max(1, 4 * ((copy_words - 1) | 1) // m)
    return copies, copy_words, per


def _copy_of(t: int, copies: int) -> np.ndarray:
    """The copy each key of a tile counts into: key e is thread (e / 4) mod
    kThreads's (sm90::key_at), lane l of warp w adds into l + 32·(w mod
    copies / 32)."""
    thread = (np.arange(t) >> 2) % THREADS
    return (thread & 31) + 32 * ((thread >> 5) % (copies // 32))


def k1p_design(labels: np.ndarray, seg, m: int, s: int, vec_row: bool):
    """The K1p kernel's steps on one (L, T) strip (seg None: flat): hist
    (L, s·m) and the fullest lane any unpack found. Every column of a row
    must be written exactly once, and no lane may pass 255."""
    n_tiles, t = labels.shape
    width = s * m
    copies, copy_words, per = _geometry(t, m)
    copy = _copy_of(t, copies)
    hist = np.zeros((n_tiles, width), np.int64)
    fullest = 0
    for tile in range(n_tiles):
        if seg is None:
            lo = hi = 0
        else:
            lo = min(max(int(seg[tile, 0]), 0), s - 1)
            hi = max(lo, min(int(seg[tile, -1]), s - 1))
        writes = np.zeros(width, np.int64)
        r0, r1 = lo * m, (hi + 1) * m
        for w in range((hi - lo) // per + 1):
            wlo = lo + w * per
            wn = min(per, hi + 1 - wlo)
            words = wn * m
            pw = (words + 3) >> 2
            stride = pw | 1
            assert copies * stride <= SET_WORDS
            packed = np.zeros(copies * stride, np.int64)   # 32-bit words of four lanes
            truth = np.zeros((copies, 4 * pw), np.int64)   # the lanes' counts
            if lo == hi:                                    # one run: the ends alone
                cell = labels[tile].astype(np.int64)
                keep = np.ones(t, bool)
            else:
                q = np.clip(seg[tile], lo, hi) - wlo
                keep = (q >= 0) & (q < wn)
                cell = q * m + labels[tile]
            for e in np.flatnonzero(keep):                  # the shared atomicAdds
                c = int(cell[e])
                packed[copy[e] * stride + (c >> 2)] += 1 << (8 * (c & 3))
                truth[copy[e], c] += 1
            assert truth.max(initial=0) <= LANE_CAP, "a lane carried into the next"
            fullest = max(fullest, int(truth.max(initial=0)))
            assert packed.max(initial=0) < 2**32
            lanes = (packed[:, None] >> (8 * np.arange(4))) & 0xFF
            assert (lanes.reshape(copies, stride, 4)[:, :pw].reshape(copies, -1) == truth).all()
            if seg is not None and w == 0:                  # zeros outside [r0, r1)
                if vec_row:
                    for v in range(width // 4):
                        if 4 * v + 4 <= r0 or 4 * v >= r1:
                            writes[4 * v:4 * v + 4] += 1
                    writes[r0 & ~3:r0] += 1
                    writes[r1:(r1 + 3) & ~3] += 1
                else:
                    writes[np.r_[0:r0, r1:width]] += 1
            for j in range(pw):                             # the unpack, four columns a thread
                x = packed.reshape(copies, stride)[:, j]
                # no 16-bit lane of the two accumulators carries: each sums
                # one byte lane over the copies, at most the tile's width
                assert max(int(np.sum((x >> (8 * k)) & 0xFF)) for k in range(4)) < 2**16
                even = int(np.sum(x & 0x00FF00FF)) & 0xFFFFFFFF
                odd = int(np.sum((x >> 8) & 0x00FF00FF)) & 0xFFFFFFFF
                four = (even & 0xFFFF, odd & 0xFFFF, even >> 16, odd >> 16)
                for k in range(4):
                    if 4 * j + k < words:
                        hist[tile, wlo * m + 4 * j + k] = four[k]
                        writes[wlo * m + 4 * j + k] += 1
        assert (writes == 1).all(), f"tile {tile}: a column written {writes.min()}-{writes.max()} times"
    return hist, fullest


def _window_overflow(shape, m, rng):
    """Tiles of one window of segment ids and of two and three (repeated
    starts make empty segments)."""
    n_tiles, t = shape
    per = _geometry(t, m)[2]
    starts = []
    for tile, k in enumerate([per, per + 1, 2 * per + 1][:n_tiles]):
        assert k <= t
        inner = np.sort(rng.integers(1, t, k - 1))
        starts.extend([tile * t] + (tile * t + inner).tolist())
    starts = np.asarray(starts, np.int64)
    seg = np.searchsorted(starts, np.arange(n_tiles * t), side="right") - 1
    return seg.reshape(shape).astype(np.int32), starts.size


K1P_SPECS = {1: jid.DeltaSpec(1), 2: jid.DeltaSpec(2, 2**32), 7: jid.DeltaSpec(7),
             8: jid.BitfieldSpec(5, 3), 255: jid.DeltaSpec(255, 2**32),
             256: jid.BitfieldSpec(24, 8)}
K1P_CASES = [
    # (kind of strip, (L, T), m)
    ("flat", (2, 128), 1),
    ("flat", (3, 1000), 2),
    ("flat", (2, 1024), 7),
    ("flat", (2, 256), 8),
    ("flat", (2, 512), 255),
    ("flat", (2, 1024), 256),
    ("one run a tile", (3, 256), 7),
    ("runs of 32 and 33", (2, 512), 8),
    ("tiny segments", (2, 512), 256),
    ("tiny segments", (2, 256), 2),
    ("window overflow", (3, 512), 7),
    ("window overflow", (3, 256), 255),
]


@pytest.mark.parametrize("kind,shape,m", K1P_CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-m{m}" for k, s, m in K1P_CASES])
def test_k1p_design_vs_pallas(kind, shape, m):
    """Labels in the kernel and from the ids strip, against the Pallas call
    of each label source."""
    rng = np.random.default_rng(shape[1] * 1000 + m)
    spec = K1P_SPECS[m]
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    labels = np.asarray(spec.emit(jnp.asarray(keys))).astype(np.int64)
    ids = rng.integers(0, m, shape).astype(np.int32)     # ids in [0, m) (ROADMAP §C 3)
    if kind == "flat":
        seg, s = None, 1
    elif kind == "window overflow":
        seg, s = _window_overflow(shape, m, rng)
    else:
        seg, s = _strip(kind, shape, rng)
    segs = None if seg is None else jnp.asarray(seg)
    vec_row = (s * m) % 4 == 0
    want = jkops.packed_tile_histograms(jnp.asarray(keys), segs, spec=spec, num_segments=s,
                                        interpret=True)
    got, _ = k1p_design(labels, seg, m, s, vec_row)
    _same(got, want, f"K1p spec {kind}")
    want = jkops.packed_tile_histograms(jnp.asarray(ids), segs, num_buckets=m, num_segments=s,
                                        interpret=True)
    got, _ = k1p_design(ids, seg, m, s, vec_row)
    _same(got, want, f"K1p ids {kind}")


@pytest.mark.parametrize("t,m", [(MAX_TILE, 1), (MAX_TILE, 256), (4096, 8)],
                         ids=["8192-m1", "8192-m256", "4096-m8"])
def test_k1p_one_bucket_tile_stays_under_the_lane_cap(t, m):
    """Every key of a full tile in one bucket: under the source's copies and
    threads no lane passes 255 (128 at T = 8192 with two copies a lane, and
    at T = 4096 with one), flat and as a one-run segmented tile, and the
    count is the tile's width; one copy a lane at T = 8192 would put 256
    into one lane."""
    labels = np.full((1, t), m - 1, np.int64)
    for seg, s in ((None, 1), (np.full((1, t), 2, np.int32), 4)):
        hist, fullest = k1p_design(labels, seg, m, s, (s * m) % 4 == 0)
        assert fullest == 128, fullest
        assert hist[0, (2 if seg is not None else 0) * m + m - 1] == t
    naive = np.bincount(_copy_of(t, 32), minlength=32).max()
    assert naive == t // 32 and (t < MAX_TILE or naive > LANE_CAP)


def test_k1p_writes_each_column_once_outside_the_contract():
    """A strip outside the contract (decreasing ids, ids past [0, s)) still
    has every column of its row written exactly once and counts every key
    inside the row: K1p clamps each id into [lo, hi]."""
    rng = np.random.default_rng(11)
    for vec_row, s in ((True, 12), (False, 9)):
        shape, m = (3, 256), 7 if not vec_row else 8
        labels = rng.integers(0, m, shape)
        seg = rng.integers(-3, s + 3, shape).astype(np.int32)
        hist, _ = k1p_design(labels, seg, m, s, vec_row)
        assert (hist.sum(axis=1) == shape[1]).all()


K3F_CASES = [
    # (kind of strip, (L, T), (shift, bits, split))
    ("flat", (2, 256), (0, 8, 4)),
    ("flat", (2, 512), (26, 6, 4)),
    ("one cell", (2, 256), (0, 8, 4)),
    ("one run a tile", (2, 256), (26, 6, 4)),
    ("runs of 32 and 33", (2, 256), (0, 8, 4)),
    ("tiny segments", (2, 256), (26, 6, 4)),
]


@pytest.mark.parametrize("kind,shape,pair", K3F_CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-bits{p[1]}"
                              for k, s, p in K3F_CASES])
def test_k3f_design_vs_pallas(kind, shape, pair):
    """K2f's steps in the positions-only form, every stage width in both
    families, against one Pallas call (its result depends on none of
    them)."""
    rng = np.random.default_rng(shape[1] * 10 + pair[1] + 1)
    shift, bits, split = pair
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    if kind == "one cell":                             # one pair, other bits vary
        keys = (keys & ~np.uint32(((1 << bits) - 1) << shift)) | np.uint32(0x2A << shift)
    seg, s = (None, 1) if kind in ("flat", "one cell") else _strip(kind, shape, rng)
    g = _fused_bases(keys, seg, shift, bits, s)
    want = jkops.fused2_tile_positions(
        jnp.asarray(keys), jnp.asarray(g), None if seg is None else jnp.asarray(seg),
        spec=jid.BitfieldSpec(shift, bits), split=split, num_segments=s, oblivious=False)
    for sub in (1, 3, 4, 8):
        for packed in (False, True):
            perm = k2f_design(keys.astype(np.int64), seg, g, None, shift, bits, sub, packed, s,
                              False)[3]
            _same(perm, want, f"K3f {kind} sub={sub} packed={packed}")
