"""The Hopper designs of K3 and K2s, emulated step by step in numpy, against
the JAX package's Pallas kernels on the CPU (interpret mode).

K3 (``csrc/tile_positions.cu``) ranks each tile with eight warps walking
contiguous runs of 32-key rounds in order, a round's peers found by
ballots over the label's bits, turns the warp counters into G[b] + the
warps' offsets and writes pos = counter + rank into the staged key slot it
read, from which the row is written. K2s (``csrc/seg_fused_postscan_reorder.cu``)
takes a tile whose first and last segment ids agree as one run; otherwise
it flags the run starts of each 32-key chunk, walks them chunk by chunk (a
run's end is the next flag), solves a run of at most 32 keys in one warp
(its keys' ranks among the run's keys of their bucket, the run's keys of
smaller buckets before them) and lists the longer ones, which then take
K2's path over their range one after another. Each run's keys go to their
slots in the segment id plane, its values to theirs in the ids plane (ids
entry) or in place, and its pos_r[j] into the key plane at slot j. The
CUDA kernels themselves are held against the plain versions on the card by
``chip_smoke.py``; these tests hold the designs' arithmetic to the Pallas
functions they replace."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import identifiers as jid
from repro.kernels import ops as jkops
from test_torch_k1k2_design import WARPS, _label_bits, _peers   # K2's block and ballots

import _torch_threads

_torch_threads.pin()

SHORT_RUN = 32           # ms::kShortRun: the longest run one warp solves alone


def warp_rank(labels: np.ndarray, m: int):
    """sm90::warp_rank over one run's labels: each key's rank within its
    warp's rounds, its warp, and the warp counters (WARPS, m)."""
    n = labels.size
    nbits = _label_bits(m)
    nr = -(-n // 32)
    r_per_warp = -(-nr // WARPS)
    cnt = np.zeros((WARPS, m), np.int64)
    rank = np.zeros(n, np.int64)
    owner = np.zeros(n, np.int64)
    lower = np.tril(np.ones((32, 32), bool), -1)       # lanes below each lane
    for w in range(WARPS):
        for rd in range(w * r_per_warp, min((w + 1) * r_per_warp, nr)):
            i = rd * 32 + np.arange(32)
            valid = i < n
            b = np.where(valid, labels[np.minimum(i, n - 1)], 0)
            peers = _peers(b, valid, nbits)
            for lane in np.flatnonzero(valid):
                rank[i[lane]] = cnt[w, b[lane]] + np.sum(peers[lane] & lower[lane])
                owner[i[lane]] = w
            for bucket in np.unique(b[valid]):
                cnt[w, bucket] += np.sum(valid & (b == bucket))
    return rank, owner, cnt


def k3_design(labels: np.ndarray, g: np.ndarray, m: int) -> np.ndarray:
    """The K3 kernel's steps on one (L, T) strip of labels: pos (L, T)."""
    pos = np.empty(labels.shape, np.int64)
    for tile in range(labels.shape[0]):
        b = labels[tile]
        rank, owner, cnt = warp_rank(b, m)              # 1. the ordered walk
        off = g[tile][None, :] + np.cumsum(cnt, axis=0) - cnt   # 2. G[b] + warp offsets
        stage = off[owner, b] + rank                    # 3. into the key slots read
        pos[tile] = stage                               # 4. the row from the stage
    return pos


def _runs(seg_row: np.ndarray):
    """K2s's runs of one tile: [(a, e)] of the short runs in the order the
    chunk walk meets them and of the long runs it lists, each tagged."""
    t = seg_row.size
    if seg_row[0] == seg_row[t - 1]:
        return [], [(0, t)]                             # one run: K2's path whole
    nch = -(-t // 32)
    flags = np.zeros(nch, np.int64)                     # A. a ballot of starts a chunk
    for i in range(t):
        if i == 0 or seg_row[i] != seg_row[i - 1]:
            flags[i // 32] |= 1 << (i % 32)
    short, long_ = [], []
    for c in range(nch):                                # B. the walk, chunk by chunk
        f = int(flags[c])
        while f:
            a = c * 32 + (f & -f).bit_length() - 1
            f &= f - 1
            if f:
                e = c * 32 + (f & -f).bit_length() - 1
            else:
                nz = [cc for cc in range(c + 1, nch) if flags[cc]]
                e = nz[0] * 32 + (int(flags[nz[0]]) & -int(flags[nz[0]])).bit_length() - 1 \
                    if nz else t
            (short if e - a <= SHORT_RUN else long_).append((a, e))
    return short, long_


def k2s_design(labels, seg, g, keys, vals, m, s, ids_entry):
    """The K2s kernel's steps on one (L, T) strip: (keys_r, vals_r, pos_r,
    perm). Planes hold 32-bit words as int64."""
    n_tiles, t = labels.shape
    out = [np.empty((n_tiles, t), np.int64) for _ in range(4)]
    for tile in range(n_tiles):
        lab = labels[tile].astype(np.int64)
        ks = keys[tile].astype(np.int64)                # keys, then pos_r
        vs = vals[tile].astype(np.int64) if vals is not None else None
        ip = lab.copy()                                 # the ids plane (ids entry)
        kr = seg[tile].astype(np.int64)                 # segment ids, then keys_r
        vr = ip if ids_entry else vs                    # vals_r
        perm = np.empty(t, np.int64)
        short, long_ = _runs(seg[tile])
        for a, e in short:                              # one warp a short run
            b = lab[a:e]
            rank = np.array([np.sum(b[:j] == b[j]) for j in range(e - a)])
            before = np.array([np.sum(b < b[j]) for j in range(e - a)])
            sid = min(max(int(kr[a]), 0), s - 1)
            gpos = g[tile, sid * m + b] + rank
            w, v = ks[a:e].copy(), vs[a:e].copy() if vs is not None else None
            dest = a + before + rank
            perm[a:e] = gpos
            kr[dest], ks[dest] = w, gpos
            if vs is not None:
                vr[dest] = v
        for a, e in long_:                              # C. K2's path over [a, e)
            b = lab[a:e]
            rank, owner, cnt = warp_rank(b, m)
            totals = cnt.sum(axis=0)
            start = a + np.cumsum(totals) - totals      # 2. the run's bucket starts
            base = start[None, :] + np.cumsum(cnt, axis=0) - cnt
            sid = min(max(int(kr[a]), 0), s - 1)
            delta = g[tile, sid * m:(sid + 1) * m].astype(np.int64) - start
            dest = base[owner, b] + rank                # 3. perm, keys to kr, values
            perm[a:e] = dest + delta[b]
            kr[dest] = ks[a:e]
            word = vs[a:e].copy() if vs is not None else None
            if vs is not None and ids_entry:
                vr[dest] = word
            ks[dest] = dest + delta[b]                  # 4. pos_r, values in place
            if vs is not None and not ids_entry:
                vs[dest] = word
        out[0][tile], out[2][tile], out[3][tile] = kr, ks, perm
        if vs is not None:
            out[1][tile] = vr
    return out[0], (out[1] if vals is not None else None), out[2], out[3]


def _bases(cid: np.ndarray, width: int, offset: int = 5) -> np.ndarray:
    """G (L, width): the bucket-major global scan of the tiles' counts of
    each combined id, plus an offset; far below 2^24 (ROADMAP §C 1)."""
    n_tiles = cid.shape[0]
    counts = np.zeros((n_tiles, width), np.int64)
    for tile in range(n_tiles):
        np.add.at(counts[tile], cid[tile], 1)
    flat = counts.T.reshape(-1)
    return ((np.cumsum(flat) - flat).reshape(width, n_tiles).T + offset).astype(np.int32)


def _strip(kind: str, shape, rng):
    """Segment starts over the (L, T) strip and the segment count s."""
    n_tiles, t = shape
    n = n_tiles * t
    if kind == "one run a tile":                        # and an empty last segment
        starts = np.arange(0, n + 1, t)
    elif kind == "round boundaries":                    # inside a round, on one, across tiles
        starts = np.unique([x for x in (0, 40, 64, 100, 160, t + 5, t + 37, 2 * t - 31) if x < n])
    elif kind == "runs of 32 and 33":
        lens = np.tile([32, 33], n // 65 + 1)
        starts = (np.cumsum(lens) - lens)
        starts = starts[starts < n]
    elif kind == "empty segments":                      # repeated starts, an empty first one
        starts = np.array([0, 0, 3, 3, 3, 90, 300, 300, n - 1, n, n])
    else:                                               # one- to eight-key segments
        lens = rng.integers(1, 9, n)
        starts = np.cumsum(lens) - lens
        starts = starts[starts < n]
    starts = np.asarray(starts, np.int64)
    seg = np.searchsorted(starts, np.arange(n), side="right") - 1
    return seg.reshape(shape).astype(np.int32), starts.size


SPECS = {1: jid.DeltaSpec(1), 2: jid.DeltaSpec(2, 2**32), 7: jid.DeltaSpec(7),
         256: jid.BitfieldSpec(24, 8)}
CASES = [
    ("one run a tile", (3, 256), 2),
    ("one run a tile", (2, 512), 256),
    ("round boundaries", (3, 256), 7),
    ("round boundaries", (2, 128), 1),
    ("runs of 32 and 33", (2, 512), 7),
    ("runs of 32 and 33", (3, 256), 256),
    ("empty segments", (3, 200), 2),
    ("tiny segments", (2, 256), 256),
    ("tiny segments", (3, 128), 2),
]


@pytest.mark.parametrize("kind,shape,m", CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-m{m}" for k, s, m in CASES])
def test_k3_and_k2s_designs_vs_pallas(kind, shape, m):
    rng = np.random.default_rng(shape[1] * 1000 + m)
    spec = SPECS[m]
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    labels = np.asarray(spec.emit(jnp.asarray(keys))).astype(np.int64)
    ids = rng.integers(0, m, shape).astype(np.int32)     # ids in [0, m) (ROADMAP §C 3)

    def same(got, want, what):
        np.testing.assert_array_equal(got.astype(np.uint32).view(np.int32),
                                      np.asarray(want).view(np.int32), err_msg=what)

    # K3: labels in the kernel and from the ids strip
    g = _bases(labels, m)
    same(k3_design(labels, g, m), jkops.spec_tile_positions(
        jnp.asarray(keys), jnp.asarray(g), spec, interpret=True), "K3 spec")
    g_ids = _bases(ids, m)
    same(k3_design(ids, g_ids, m), jkops.tile_positions(
        jnp.asarray(ids), jnp.asarray(g_ids), m, interpret=True), "K3 ids")

    # K2s: both entries, key-value, and the spec entry key-only too
    seg, s = _strip(kind, shape, rng)
    names = ("keys_r", "vals_r", "pos_r", "perm")
    for values in (vals, None):
        g = _bases(seg.astype(np.int64) * m + labels, s * m)
        got = k2s_design(labels, seg, g, keys, values, m, s, ids_entry=False)
        want = jkops.seg_spec_fused_postscan_reorder(
            jnp.asarray(keys), jnp.asarray(seg), jnp.asarray(g),
            None if values is None else jnp.asarray(values), spec, s, interpret=True)
        for a, b, name in zip(got, want, names):
            assert (a is None) == (b is None), name
            if a is not None:
                same(a, b, f"K2s spec {name}")
    g = _bases(seg.astype(np.int64) * m + ids, s * m)
    got = k2s_design(ids, seg, g, keys, vals, m, s, ids_entry=True)
    want = jkops.seg_fused_postscan_reorder(
        jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(g), jnp.asarray(keys), jnp.asarray(vals),
        m, s, interpret=True)
    for a, b, name in zip(got, want, names):
        same(a, b, f"K2s ids {name}")


def test_the_strips_reach_every_path():
    """The strips above drive every path of the K2s design: one-run tiles,
    short runs of exactly 32 keys and long ones of 33, runs that start
    inside a round and on its boundary, empty segments, and tiles of dozens
    of runs."""
    rng = np.random.default_rng(0)
    seen = set()
    for kind, shape, _ in CASES:
        seg, s = _strip(kind, shape, rng)
        for tile in range(shape[0]):
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
    assert seen == {"one run", "32", "33", "in a round", "on a boundary", "dozens", "empty"}
