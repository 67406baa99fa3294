"""The Hopper designs of K2f and K2p, emulated step by step in numpy, against
the JAX package's Pallas kernels on the CPU (interpret mode).

K2p (``csrc/packed_fused_postscan_reorder.cu``) is K2s's skeleton with the
packed family's rank (``sm90::packed_warp_rank`` in
``csrc/multisplit_sm90.cuh``): eight warps walk contiguous runs of 32-key
rounds in order, a round's peers found by ballots over the label's bits,
the warp's counters 8-bit lanes four to a word, a round's groups adding
their counts, the lanes unpacked into the warp's int32 carry after each
subtile (max(1, subtile // 32) whole rounds from the run's start) and after
the warp's last round; rank = carry + lane + the lanes of the group below. A one-run tile takes that path whole; any
other is split as K2s splits it (a warp a run of at most 32 keys, the
longer runs on the path above over their range). Keys go to their slots in
a dead plane, values to the ids plane (segmented ids) or in place, pos_r
into the key plane.

K2f (``csrc/fused2_fused_postscan_reorder.cu``, its body
``fused2::postscan_kernel`` in ``csrc/multisplit_fused2.cuh``) sorts a tile
by (segment run, pair): a run of at most 32 keys in one warp by shuffles,
the tile or a longer run by an LSD sweep of ``sub``-bit stages between two
key buffers, each stage ranked by the onehot ballots (K2's
``sm90::warp_rank``) or the packed rank on subtiles of ``kStageSubtile``
keys, the first stage taking the positions as the source indices. Then a
first walk marks each round's cell heads in a word and reads each key's
base G[cell]; the second finds each key's head in its round's word, or
carries the last head across rounds and, through the head words, across
warps: pos = base + p - head; perm scattered by source index, the values
gathered by it.

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
from test_torch_k1k2_design import _label_bits, _peers
from test_torch_k3k2s_design import SHORT_RUN, _bases, _runs, _strip, warp_rank

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
# K2f's body, shared with K3f, lives in the fused-pair header
K2F_SRC = (CSRC / "multisplit_fused2.cuh").read_text()
K2P_SRC = (CSRC / "packed_fused_postscan_reorder.cu").read_text()
# the packed stage's subtile and the warps a block, as the sources set them
STAGE_SUBTILE = int(re.search(r"kStageSubtile = (\d+);", K2F_SRC).group(1))
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", K2P_SRC).group(1))
assert WARPS == int(re.search(r"constexpr int kWarps = (\d+);", K2F_SRC).group(1))
LANE_CAP = 255           # an 8-bit lane


def packed_warp_rank(labels: np.ndarray, m: int, sub: int):
    """sm90::packed_warp_rank over one run's labels: each key's rank within
    its warp's rounds, its warp, the warp carries (WARPS, m), and the fullest
    lane any unpack found. The lanes live in words of four, as on the card;
    a lane that carried into the next would show as a wrong byte. A subtile
    is max(1, sub // 32) whole rounds, counted from the run's start."""
    n = labels.size
    nbits = _label_bits(m)
    nr = -(-n // 32)
    r_per_warp = -(-nr // WARPS)
    nw = -(-m // 4)
    rounds = max(1, sub >> 5)
    carry = np.zeros((WARPS, m), np.int64)
    words = np.zeros((WARPS, nw), np.int64)
    truth = np.zeros((WARPS, m), np.int64)           # the lanes' counts, unpacked
    rank = np.zeros(n, np.int64)
    owner = np.zeros(n, np.int64)
    lanes = np.arange(32)
    lower = lanes[None, :] < lanes[:, None]
    fullest = 0
    for w in range(WARPS):
        r0, r1 = w * r_per_warp, min((w + 1) * r_per_warp, nr)
        for rd in range(r0, r1):
            i = rd * 32 + lanes
            valid = i < n
            b = np.where(valid, labels[np.minimum(i, n - 1)], 0)
            peers = _peers(b, valid, nbits)
            for lane in np.flatnonzero(valid):
                byte = (words[w, b[lane] >> 2] >> (8 * (b[lane] & 3))) & 0xFF
                assert byte == truth[w, b[lane]]
                rank[i[lane]] = carry[w, b[lane]] + byte + np.sum(peers[lane] & lower[lane])
                owner[i[lane]] = w
            for lane in np.flatnonzero(valid):
                if lane == np.flatnonzero(peers[lane])[0]:   # the group's leader adds
                    words[w, b[lane] >> 2] += int(peers[lane].sum()) << (8 * (b[lane] & 3))
                    truth[w, b[lane]] += int(peers[lane].sum())
            assert words[w].max(initial=0) < 2**32 and truth[w].max() <= LANE_CAP
            if (rd + 1) % rounds == 0 or rd + 1 == r1:   # unpack into the carry
                carry[w] += ((words[w][:, None] >> (8 * np.arange(4))) & 0xFF).reshape(-1)[:m]
                fullest = max(fullest, int(truth[w].max()))
                words[w] = 0
                truth[w] = 0
        assert not words[w].any()                       # zero on exit
    return rank, owner, carry, fullest


def _run_offsets(a, labels, rank, owner, cnt):
    """a + the run's bucket starts + the warps' offsets + rank: each key's
    slot in the run's (bucket-major) range."""
    totals = cnt.sum(axis=0)
    start = a + np.cumsum(totals) - totals
    base = start[None, :] + np.cumsum(cnt, axis=0) - cnt
    return base[owner, labels] + rank, start


def k2p_design(labels, seg, g, keys, vals, m, s, sub, ids_entry):
    """The K2p kernel's steps on one (L, T) strip (seg None: flat): (keys_r,
    vals_r, pos_r, perm) and the fullest lane. Planes hold 32-bit words as
    int64, aliased as the kernel aliases them."""
    n_tiles, t = labels.shape
    out = [np.empty((n_tiles, t), np.int64) for _ in range(4)]
    fullest = 0
    for tile in range(n_tiles):
        lab = labels[tile].astype(np.int64)
        ks = keys[tile].astype(np.int64)                # keys, then pos_r
        vs = vals[tile].astype(np.int64) if vals is not None else None
        ip = lab.copy()                                 # the ids plane (ids entry)
        last = (seg[tile].astype(np.int64) if seg is not None else np.zeros(t, np.int64))
        kr = last if seg is not None or not ids_entry else ip    # keys_r's plane
        in_place = not (seg is not None and ids_entry)
        vr = vs if in_place else ip
        perm = np.empty(t, np.int64)
        if seg is None or seg[tile, 0] == seg[tile, -1]:
            short, long_ = [], [(0, t)]
        else:
            short, long_ = _runs(seg[tile])
        for a, e in short:                              # one warp a short run
            b = lab[a:e]
            rank = np.array([np.sum(b[:j] == b[j]) for j in range(e - a)])
            before = np.array([np.sum(b < b[j]) for j in range(e - a)])
            sid = min(max(int(last[a]), 0), s - 1)
            gpos = g[tile, sid * m + b] + rank
            w, v = ks[a:e].copy(), vs[a:e].copy() if vs is not None else None
            dest = a + before + rank
            perm[a:e] = gpos
            kr[dest], ks[dest] = w, gpos
            if vs is not None:
                vr[dest] = v
        for a, e in long_:                              # the flat path over [a, e)
            sid = min(max(int(last[a]), 0), s - 1) if seg is not None else 0
            gb = g[tile, sid * m:(sid + 1) * m].astype(np.int64)   # read before the rank
            b = lab[a:e]
            rank, owner, cnt, full = packed_warp_rank(b, m, sub)   # 1. the packed rank
            fullest = max(fullest, full)
            dest, start = _run_offsets(a, b, rank, owner, cnt)    # 2. offsets, starts
            delta = gb - start
            perm[a:e] = dest + delta[b]                 # 3. perm, keys, values
            word = vs[a:e].copy() if vs is not None else None
            kr[dest] = ks[a:e].copy()
            if vs is not None and not in_place:
                vr[dest] = word
            ks[dest] = dest + delta[b]                  # 4. pos_r, values in place
            if vs is not None and in_place:
                vs[dest] = word
        out[0][tile], out[2][tile], out[3][tile] = kr, ks, perm
        if vs is not None:
            out[1][tile] = vr
    return (out[0], out[1] if vals is not None else None, out[2], out[3]), fullest


def k2f_design(keys, seg, g, vals, shift, bits, sub, packed, s, staged):
    """The K2f kernel's steps on one (L, T) strip (seg None: flat): (keys_r,
    vals_r, pos_r, perm). Keys are uint32 values as int64; with `staged`
    False the tile's keys sit in key buffer 0, as on the card at T = 8192."""
    n_tiles, t = keys.shape
    nst = -(-bits // sub)
    nr = -(-t // 32)
    r_per_warp = -(-nr // WARPS)
    lanes = np.arange(32)
    out = [np.empty((n_tiles, t), np.int64) for _ in range(4)]
    for tile in range(n_tiles):
        inb = keys[tile].astype(np.int64)               # the tile's keys, element order
        kb = [inb if not staged else np.zeros(t, np.int64), np.zeros(t, np.int64)]
        ib = [np.zeros(t, np.int64), np.zeros(t, np.int64)]
        fk, fi = kb[nst & 1], ib[(nst - 1) & 1]
        one_run = seg is None or seg[tile, 0] == seg[tile, -1]
        short, long_ = ([], [(0, t)]) if one_run else _runs(seg[tile])
        for a, e in short:                              # 1. a warp a short run
            w = inb[a:e].copy()
            p = (w >> shift) & ((1 << bits) - 1)
            pos = np.array([np.sum((p < p[j]) | ((p == p[j]) & (np.arange(e - a) < j)))
                            for j in range(e - a)])
            fk[a + pos], fi[a + pos] = w, a + np.arange(e - a)
        for a, e in long_:                              # the sweep over [a, e)
            for j in range(nst):
                off = j * sub
                mb = 1 << min(sub, bits - off)
                sk = inb if j == 0 else kb[j & 1]
                words = sk[a:e].copy()
                idx = a + np.arange(e - a) if j == 0 else ib[(j - 1) & 1][a:e].copy()
                lab = (words >> (shift + off)) & (mb - 1)
                if packed:
                    rank, owner, cnt, _ = packed_warp_rank(lab, mb, STAGE_SUBTILE)
                else:
                    rank, owner, cnt = warp_rank(lab, mb)
                dest, _ = _run_offsets(a, lab, rank, owner, cnt)
                kb[(j + 1) & 1][dest], ib[j & 1][dest] = words, idx
        # 2. the walk: heads a round, each key's base G[cell] at its position
        sg = (np.full(t, min(max(int(seg[tile, 0]), 0), s - 1)) if seg is not None and one_run
              else np.clip(seg[tile], 0, s - 1) if seg is not None else np.zeros(t, np.int64))
        pair = (fk >> shift) & ((1 << bits) - 1)
        hmask = np.zeros(nr, np.int64)
        for rd in range(nr):
            p = rd * 32 + lanes
            valid = p < t
            pc = np.minimum(p, t - 1)
            head = valid & ((p == 0) | (pair[pc] != pair[np.maximum(pc - 1, 0)]) |
                            (sg[pc] != sg[np.maximum(pc - 1, 0)]))
            hmask[rd] = int(np.sum(head.astype(np.int64) << lanes))
        gv = g[tile, (sg << bits) + pair].astype(np.int64)
        pos = np.empty(t, np.int64)
        for w in range(WARPS):                          # 4. base + p - head
            r0, r1 = w * r_per_warp, min((w + 1) * r_per_warp, nr)
            hc = 0
            if r0 < r1 and r0 > 0:                      # the run the warp's first key continues
                rd = max(r for r in range(r0) if hmask[r])
                hc = rd * 32 + int(hmask[rd]).bit_length() - 1
            for rd in range(r0, r1):
                hm = int(hmask[rd])
                for lane in range(32):
                    p = rd * 32 + lane
                    mh = hm & ((2 << lane) - 1)
                    if p < t:
                        head = rd * 32 + mh.bit_length() - 1 if mh else hc
                        pos[p] = gv[p] + p - head
                if hm:
                    hc = rd * 32 + hm.bit_length() - 1
        out[0][tile], out[2][tile] = fk, pos
        out[3][tile][fi] = pos
        if vals is not None:
            out[1][tile] = vals[tile][fi]
    return out[0], out[1] if vals is not None else None, out[2], out[3]


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint32).view(np.int32),
                                  np.asarray(want).view(np.int32), err_msg=what)


def _fused_bases(keys, seg, shift, bits, s):
    cid = (seg.astype(np.int64) << bits if seg is not None else 0) + \
        ((keys.astype(np.int64) >> shift) & ((1 << bits) - 1))
    return _bases(cid, s << bits)


K2F_CASES = [
    # (kind of strip, (L, T), (shift, bits, split))
    ("flat", (2, 128), (0, 8, 4)),
    ("flat", (2, 1024), (26, 6, 4)),
    ("flat", (1, 512), (0, 8, 4)),
    ("one cell", (2, 256), (0, 8, 4)),
    ("one run a tile", (2, 256), (26, 6, 4)),
    ("round boundaries", (2, 256), (0, 8, 4)),
    ("tiny segments", (2, 256), (26, 6, 4)),
]


@pytest.mark.parametrize("kind,shape,pair", K2F_CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-bits{p[1]}"
                              for k, s, p in K2F_CASES])
def test_k2f_design_vs_pallas(kind, shape, pair):
    """Every stage width and family, staged or not, key-value and key-only,
    against one Pallas call (its result depends on none of them)."""
    rng = np.random.default_rng(shape[1] * 10 + pair[1])
    shift, bits, split = pair
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    if kind == "one cell":                             # one pair, other bits vary
        keys = (keys & ~np.uint32(((1 << bits) - 1) << shift)) | np.uint32(0x5A << shift)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    seg, s = (None, 1) if kind in ("flat", "one cell") else _strip(kind, shape, rng)
    g = _fused_bases(keys, seg, shift, bits, s)
    spec = jid.BitfieldSpec(shift, bits)
    names = ("keys_r", "vals_r", "pos_r", "perm")
    for values in (vals, None):
        want = jkops.fused2_fused_postscan_reorder(
            jnp.asarray(keys), jnp.asarray(g), None if values is None else jnp.asarray(values),
            None if seg is None else jnp.asarray(seg), spec=spec, split=split, num_segments=s,
            oblivious=False)
        for sub in (1, 3, 4, 8):
            for packed in (False, True):
                for staged in ((False, True) if sub in (1, 8) else (False,)):
                    got = k2f_design(keys.astype(np.int64), seg, g, values, shift, bits, sub,
                                     packed, s, staged)
                    for a, b, name in zip(got, want, names):
                        assert (a is None) == (b is None), name
                        if a is not None:
                            _same(a, b, f"K2f {kind} sub={sub} packed={packed} staged={staged} "
                                        f"{name}")


K2P_SPECS = {1: jid.DeltaSpec(1), 2: jid.DeltaSpec(2, 2**32), 7: jid.DeltaSpec(7),
             8: jid.BitfieldSpec(5, 3), 255: jid.DeltaSpec(255, 2**32),
             256: jid.BitfieldSpec(24, 8)}
K2P_CASES = [
    # (kind of strip, (L, T), m)
    ("flat", (2, 512), 256),
    ("flat", (2, 256), 7),
    ("flat", (1, 1024), 1),
    ("flat", (2, 128), 255),
    ("one run a tile", (2, 256), 2),
    ("round boundaries", (2, 256), 8),
    ("runs of 32 and 33", (2, 512), 256),
    ("tiny segments", (2, 256), 7),
]


@pytest.mark.parametrize("kind,shape,m", K2P_CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-m{m}" for k, s, m in K2P_CASES])
def test_k2p_design_vs_pallas(kind, shape, m):
    """Subtiles 1, 32, 128 and 255, labels in the kernel and from the ids
    strip, key-value and key-only, against the Pallas call of each label
    source (its result depends on no subtile)."""
    rng = np.random.default_rng(shape[1] * 1000 + m)
    spec = K2P_SPECS[m]
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    labels = np.asarray(spec.emit(jnp.asarray(keys))).astype(np.int64)
    ids = rng.integers(0, m, shape).astype(np.int32)     # ids in [0, m) (ROADMAP §C 3)
    seg, s = (None, 1) if kind == "flat" else _strip(kind, shape, rng)
    names = ("keys_r", "vals_r", "pos_r", "perm")
    segs = None if seg is None else jnp.asarray(seg)
    for ids_entry, lab in ((False, labels), (True, ids)):
        cid = (seg.astype(np.int64) * m if seg is not None else 0) + lab
        g = _bases(cid, s * m)
        for values in ((vals, None) if not ids_entry else (vals,)):
            jv = None if values is None else jnp.asarray(values)
            if ids_entry:
                want = jkops.packed_fused_postscan_reorder(
                    jnp.asarray(ids), jnp.asarray(g), jnp.asarray(keys), jv, segs, num_buckets=m,
                    num_segments=s, oblivious=False)
            else:
                want = jkops.packed_fused_postscan_reorder(
                    jnp.asarray(keys), jnp.asarray(g), None, jv, segs, spec=spec, num_segments=s,
                    oblivious=False)
            for sub in (1, 32, 128, 255):
                got, fullest = k2p_design(lab, seg, g, keys, values, m, s, sub, ids_entry)
                assert fullest <= max(sub, 32)
                for a, b, name in zip(got, want, names):
                    assert (a is None) == (b is None), name
                    if a is not None:
                        _same(a, b, f"K2p {kind} ids={ids_entry} sub={sub} {name}")


def test_k2p_one_bucket_subtile_stays_under_the_lane_cap():
    """A one-bucket tile at subtile 255 and below: each warp's 256 keys fill
    its lane to a subtile's whole rounds (224 keys at 255) before the unpack,
    never past 255; the result is the Pallas kernel's."""
    shape, m = (1, 2048), 8
    keys = np.full(shape, 5, np.uint32)                  # IdentitySpec(8): bucket 5
    vals = np.arange(shape[1], dtype=np.int32)[None, :]
    spec = jid.IdentitySpec(m)
    g = _bases(np.full(shape, 5, np.int64), m)
    want = jkops.packed_fused_postscan_reorder(jnp.asarray(keys), jnp.asarray(g), None,
                                               jnp.asarray(vals), spec=spec, subtile=255,
                                               oblivious=False)
    for sub, cap in ((255, 224), (128, 128), (100, 96), (32, 32), (7, 32)):
        got, fullest = k2p_design(keys.astype(np.int64), None, g, keys, vals, m, 1, sub, False)
        assert fullest == cap, (sub, fullest)
        for a, b in zip(got, want):
            _same(a, b, f"one bucket sub={sub}")


def test_the_strips_reach_every_path():
    """The strips above drive one-run tiles, runs of at most 32 keys and
    longer ones, and runs that start inside a round and on its boundary."""
    rng = np.random.default_rng(0)
    seen = set()
    for kind, shape, _ in K2F_CASES + K2P_CASES:
        if kind in ("flat", "one cell"):
            continue
        seg, _ = _strip(kind, shape, rng)
        for tile in range(shape[0]):
            if seg[tile, 0] == seg[tile, -1]:
                seen.add("one run")
                continue
            short, long_ = _runs(seg[tile])
            seen.update({"short" for _ in short[:1]} | {"long" for _ in long_[:1]})
            starts = [a for a, _ in short + long_]
            seen.update({"in a round" for a in starts if a % 32} |
                        {"on a boundary" for a in starts if a and a % 32 == 0})
            if any(e - a == SHORT_RUN for a, e in short):
                seen.add("32")
    assert seen == {"one run", "short", "long", "in a round", "on a boundary", "32"}
