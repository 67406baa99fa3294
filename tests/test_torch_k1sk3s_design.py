"""The Hopper designs of K1s and K3s, emulated step by step in numpy, against
the JAX package's Pallas kernels on the CPU (interpret mode).

K1s (``csrc/seg_tile_histograms.cu``) clamps a tile's two end ids into
[lo, hi] and counts each key at (seg - lo)·m + b into copies of the
window's counters, lane l adding into copy l % C; a tile of one run (lo ==
hi) reads no other id. A tile of more segment ids than a window holds
((kSetWords - 1) / m) walks its windows in order, each counting only its
own keys. The row is written once: the window's columns from the copies,
zeros outside [lo·m, (hi + 1)·m), 16 bytes a store where s·m % 4 == 0.
K3s (``csrc/seg_tile_positions.cu``) takes a tile whose end ids agree as
one run on K3's path (the warps' ballot rank, G's staged m-wide row plus
the warps' offsets); any other tile is split as K2s splits it: chunk
flags, a warp a run of at most 32 keys (its rank among the run's keys of
its bucket, G read directly), the longer runs on K3's path over their
range. The CUDA kernels themselves are held against the plain versions on
the card by ``chip_smoke.py``; these tests hold the designs' arithmetic to
the Pallas functions they replace."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import identifiers as jid
from repro.kernels import ops as jkops
from test_torch_k1k2_design import COPY_WORDS               # K1's copy budget
from test_torch_k3k2s_design import SHORT_RUN, _bases, _runs, _strip, warp_rank

import _torch_threads

_torch_threads.pin()

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# the words of K1s's window of counters, as the kernel's source sets them
SET_WORDS = int(re.search(r"kSetWords = (\d+);",
                          (CSRC / "seg_tile_histograms.cu").read_text()).group(1))


def _copies(words: int) -> int:
    """sm90::counter_copies(words, 2056)."""
    copies = 32
    while copies > 1 and copies * (words | 1) > COPY_WORDS:
        copies >>= 1
    return copies


def _ends(seg_row: np.ndarray, s: int):
    lo = min(max(int(seg_row[0]), 0), s - 1)
    return lo, max(lo, min(int(seg_row[-1]), s - 1))


def k1s_design(labels: np.ndarray, seg: np.ndarray, m: int, s: int,
               vec_row: bool) -> np.ndarray:
    """The K1s kernel's steps on one (L, T) strip: hist (L, s·m). Every
    column of a row must be written exactly once."""
    n_tiles, t = labels.shape
    width = s * m
    per = (SET_WORDS - 1) // m
    lane = (np.arange(t) // 4) % 32                 # the lane that holds key e
    hist = np.zeros((n_tiles, width), np.int64)
    for tile in range(n_tiles):
        lo, hi = _ends(seg[tile], s)
        writes = np.zeros(width, np.int64)
        r0, r1 = lo * m, (hi + 1) * m
        nwin = (hi - lo) // per + 1
        for w in range(nwin):
            wlo = lo + w * per
            wn = min(per, hi + 1 - wlo)
            words = wn * m
            stride, copies = words | 1, _copies(words)
            cnt = np.zeros(copies * stride, np.int64)
            if lo == hi:                            # one run: the ends alone
                idx = labels[tile].astype(np.int64)
                keep = np.ones(t, bool)
            else:
                q = np.clip(seg[tile], lo, hi) - wlo
                keep = (q >= 0) & (q < wn)
                idx = q * m + labels[tile]
            np.add.at(cnt, ((lane % copies) * stride + idx)[keep], 1)
            if w == 0:                              # zeros outside [r0, r1)
                if vec_row:
                    for v in range(width // 4):
                        if 4 * v + 4 <= r0 or 4 * v >= r1:
                            writes[4 * v:4 * v + 4] += 1
                    writes[r0 & ~3:r0] += 1
                    writes[r1:(r1 + 3) & ~3] += 1
                else:
                    out = np.r_[0:r0, r1:width]
                    writes[out] += 1
            cols = wlo * m + np.arange(words)       # the window's sums
            hist[tile, cols] = cnt.reshape(copies, stride)[:, :words].sum(axis=0)
            writes[cols] += 1
        assert (writes == 1).all(), f"tile {tile}: a column written {writes.min()}-{writes.max()} times"
    return hist


def k3s_design(labels: np.ndarray, seg: np.ndarray, g: np.ndarray, m: int,
               s: int) -> np.ndarray:
    """The K3s kernel's steps on one (L, T) strip: pos (L, T)."""
    n_tiles, t = labels.shape
    pos = np.empty((n_tiles, t), np.int64)
    for tile in range(n_tiles):
        lab = labels[tile].astype(np.int64)
        short, long_ = _runs(seg[tile])             # one run: [(0, T)] on K3's path
        for a, e in short:                          # a warp a short run, G read directly
            b = lab[a:e]
            rank = np.array([np.sum(b[:j] == b[j]) for j in range(e - a)])
            sid = min(max(int(seg[tile, a]), 0), s - 1)
            pos[tile, a:e] = g[tile, sid * m + b] + rank
        for a, e in long_:                          # K3's path over [a, e)
            b = lab[a:e]
            rank, owner, cnt = warp_rank(b, m)
            sid = min(max(int(seg[tile, a]), 0), s - 1)
            row = g[tile, sid * m:(sid + 1) * m].astype(np.int64)   # staged, or read
            off = row[None, :] + np.cumsum(cnt, axis=0) - cnt
            pos[tile, a:e] = off[owner, b] + rank
    return pos


def _window_strip(shape, m, rng):
    """A tile of exactly one window of segment ids, one of one id past it
    (two windows), one of two windows and one more; repeated starts make
    empty segments."""
    n_tiles, t = shape
    per = (SET_WORDS - 1) // m
    starts = []
    for tile, k in enumerate([per, per + 1, 2 * per + 1][:n_tiles]):
        assert k <= t
        inner = np.sort(rng.integers(1, t, k - 1))
        starts.extend([tile * t] + (tile * t + inner).tolist())
    starts = np.asarray(starts, np.int64)
    seg = np.searchsorted(starts, np.arange(n_tiles * t), side="right") - 1
    return seg.reshape(shape).astype(np.int32), starts.size


def _strip_of(kind, shape, m):
    rng = np.random.default_rng(shape[0] * 100 + m)
    if kind == "window overflow":
        return _window_strip(shape, m, rng)
    return _strip(kind, shape, rng)


SPECS = {2: jid.DeltaSpec(2, 2**32), 7: jid.DeltaSpec(7), 32: jid.BitfieldSpec(3, 5),
         256: jid.BitfieldSpec(24, 8)}
CASES = [
    ("one run a tile", (3, 256), 7),
    ("one run a tile", (2, 512), 256),
    ("round boundaries", (3, 256), 2),
    ("runs of 32 and 33", (2, 512), 32),
    ("empty segments", (3, 200), 7),
    ("tiny segments", (2, 256), 256),
    ("tiny segments", (3, 128), 2),
    ("window overflow", (3, 256), 256),
    ("window overflow", (2, 512), 32),
]


@pytest.mark.parametrize("kind,shape,m", CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-m{m}" for k, s, m in CASES])
def test_k1s_and_k3s_designs_vs_pallas(kind, shape, m):
    rng = np.random.default_rng(shape[1] * 1000 + m)
    spec = SPECS[m]
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    labels = np.asarray(spec.emit(jnp.asarray(keys))).astype(np.int64)
    ids = rng.integers(0, m, shape).astype(np.int32)     # ids in [0, m) (ROADMAP §C 3)
    seg, s = _strip_of(kind, shape, m)
    vec_row = (s * m) % 4 == 0

    def same(got, want, what):
        np.testing.assert_array_equal(got.astype(np.int64), np.asarray(want).astype(np.int64),
                                      err_msg=what)

    # K1s: labels in the kernel and from the ids strip
    same(k1s_design(labels, seg, m, s, vec_row), jkops.seg_spec_tile_histograms(
        jnp.asarray(keys), jnp.asarray(seg), spec, s, interpret=True), "K1s spec")
    same(k1s_design(ids, seg, m, s, vec_row), jkops.seg_tile_histograms(
        jnp.asarray(ids), jnp.asarray(seg), m, s, interpret=True), "K1s ids")

    # K3s: both entries, G far below 2^24
    g = _bases(seg.astype(np.int64) * m + labels, s * m)
    same(k3s_design(labels, seg, g, m, s), jkops.seg_spec_tile_positions(
        jnp.asarray(keys), jnp.asarray(seg), jnp.asarray(g), spec, s, interpret=True), "K3s spec")
    g = _bases(seg.astype(np.int64) * m + ids, s * m)
    same(k3s_design(ids, seg, g, m, s), jkops.seg_tile_positions(
        jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(g), m, s, interpret=True), "K3s ids")


@pytest.mark.parametrize("vec_row", [True, False], ids=["16-byte-rows", "4-byte-rows"])
def test_k1s_writes_each_column_once_outside_the_contract(vec_row):
    """A strip outside the contract (decreasing ids, ids past [0, s)) still
    has every column of its row written exactly once and counts every key
    inside the row: K1s clamps each id into [lo, hi]."""
    rng = np.random.default_rng(7)
    shape, m, s = (4, 256), 7, 9 if not vec_row else 12
    labels = rng.integers(0, m, shape)
    seg = rng.integers(-3, s + 3, shape).astype(np.int32)
    hist = k1s_design(labels, seg, m, s, vec_row)
    assert (hist.sum(axis=1) == shape[1]).all()


def test_the_strips_reach_every_path():
    """The strips above drive every path of the two designs: K1s's one-run
    tiles, tiles of several runs in one window, a tile of exactly one window
    and tiles of two and three; K3s's one-run tiles, short runs of exactly
    32 keys and long ones of 33, runs that start inside a round and on its
    boundary, empty segments, and tiles of dozens of runs."""
    seen = set()
    for kind, shape, m in CASES:
        seg, s = _strip_of(kind, shape, m)
        per = (SET_WORDS - 1) // m
        for tile in range(shape[0]):
            lo, hi = _ends(seg[tile], s)
            nwin = (hi - lo) // per + 1
            if lo == hi:
                seen.add("K1s one run")
            elif nwin == 1:
                seen.add("K1s several runs, one window")
            if hi - lo + 1 == per:
                seen.add("K1s exactly one window")
            if nwin > 1:
                seen.add(f"K1s {min(nwin, 3)} windows")
            short, long_ = _runs(seg[tile])
            if not short and long_ == [(0, shape[1])]:
                seen.add("one run")
            lens = {e - a for a, e in short + long_}
            seen.update({"32" for n in lens if n == SHORT_RUN} |
                        {"33" for n in lens if n == SHORT_RUN + 1})
            starts = [a for a, _ in short + long_]
            seen.update({"in a round" for a in starts if a % 32} |
                        {"on a boundary" for a in starts if a and a % 32 == 0})
            if len(short) >= 25:
                seen.add("dozens")
        if len(np.unique(seg)) < s:
            seen.add("empty")
    assert seen == {"K1s one run", "K1s several runs, one window", "K1s exactly one window",
                    "K1s 2 windows", "K1s 3 windows", "one run", "32", "33", "in a round",
                    "on a boundary", "dozens", "empty"}
