"""The Hopper designs of K3p and B10, emulated step by step in numpy, against
the JAX package's Pallas kernels on the CPU (interpret mode).

K3p (``csrc/packed_tile_positions.cu``) is K3's path (flat) and K3s's
(segmented) on the packed family's rank ``sm90::packed_warp_rank``: eight
warps walk contiguous runs of 32-key rounds in order, the warp's counters
8-bit lanes four to a word, unpacked into the warp's int32 carry after each
subtile (max(1, sub // 32) whole rounds counted from the run's start) and
after the warp's last round. A tile whose end ids agree (every flat tile)
takes that path whole, its base G's m-wide row at tile·s·m + seg·m; any
other is split as K2s splits it: a run of at most 32 keys in one warp, the
longer runs on the path above over their range. One thread a bucket turns
the carries into G + the warps' exclusive offsets, and each lane writes
pos = counter + rank into the key slot it read. An ids strip is read as the
keys under the clamp form.

B10 (``csrc/tile_reorder.cu``) is K2's ids body without G: K2's ballot rank
on the staged ids (``sm90::warp_rank``, ids clamped into [0, m)), the warp
offsets and one block scan give the tile's bucket starts, dest = start +
warp offset + rank in element order; each key goes to its slot in the dead
ids plane, then each value to its slot in the key plane, and the rows are
written from those planes.

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
from test_torch_k1k2_design import WARPS as K2_WARPS
from test_torch_k2fk2p_design import LANE_CAP, packed_warp_rank
from test_torch_k3k2s_design import SHORT_RUN, _bases, _runs, _strip, warp_rank

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
K3P_SRC = (CSRC / "packed_tile_positions.cu").read_text()
B10_SRC = (CSRC / "tile_reorder.cu").read_text()
# the warps a block and the blocks an SM each asks for, as the sources set them
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", K3P_SRC).group(1))
assert WARPS == int(re.search(r"constexpr int kWarps = (\d+);", B10_SRC).group(1)) == K2_WARPS
# K3p: blocks an SM at T <= 4096, then above it in the general and other
# forms; B10: at T <= 1024, up to 4096 and above
K3P_BLOCKS = tuple(int(x) for x in re.search(
    r"return kR <= 16 \? (\d) : \(kForm == sm90::kAnySpec \? (\d) : (\d)\);", K3P_SRC).groups())
B10_BLOCKS = tuple(int(x) for x in re.search(
    r"return kR <= 4 \? (\d) : \(kR <= 16 \? (\d) : (\d)\);", B10_SRC).groups())
MAX_SUB = int(re.search(r"constexpr int kMaxSub = (\d+);", K3P_SRC).group(1))
MAX_TILE = 8192
SMEM_PER_SM = 228 * 1024         # an H100 SM's shared memory, 1 KiB of it the block's reserve


def k3p_design(labels: np.ndarray, seg, g: np.ndarray, m: int, s: int, sub: int):
    """The K3p kernel's steps on one (L, T) strip of labels (seg None:
    flat): pos (L, T) and the fullest lane any unpack found."""
    n_tiles, t = labels.shape
    pos = np.empty((n_tiles, t), np.int64)
    fullest = 0
    for tile in range(n_tiles):
        lab = labels[tile].astype(np.int64)
        stage = np.empty(t, np.int64)                   # the key plane, then pos
        if seg is None or seg[tile, 0] == seg[tile, -1]:
            short, long_ = [], [(0, t)]                 # one run: the flat path whole
        else:
            short, long_ = _runs(seg[tile])
        sid = (np.zeros(t, np.int64) if seg is None
               else np.clip(seg[tile].astype(np.int64), 0, s - 1))
        for a, e in short:                              # one warp a short run
            b = lab[a:e]
            rank = np.array([np.sum(b[:j] == b[j]) for j in range(e - a)])
            stage[a:e] = g[tile, sid[a] * m + b] + rank
        for a, e in long_:                              # the flat path over [a, e)
            b = lab[a:e]
            rank, owner, carry, full = packed_warp_rank(b, m, sub)   # 1. the packed rank
            fullest = max(fullest, full)
            gb = g[tile, sid[a] * m:(sid[a] + 1) * m].astype(np.int64)
            cnt = gb[None, :] + np.cumsum(carry, axis=0) - carry      # 2. G + warp offsets
            stage[a:e] = cnt[owner, b] + rank           # 3. into the key slots read
        pos[tile] = stage                               # 4. the row from the stage
    return pos, fullest


def b10_design(ids: np.ndarray, keys: np.ndarray, vals, m: int):
    """The B10 kernel's steps on one (L, T) strip: (keys_r, vals_r, dest).
    Planes hold 32-bit words as int64."""
    n_tiles, t = ids.shape
    out = [np.empty((n_tiles, t), np.int64) for _ in range(3)]
    for tile in range(n_tiles):
        ip = np.clip(ids[tile].astype(np.int64), 0, m - 1)   # the ids plane, clamp form
        ks = keys[tile].astype(np.int64)                # the key plane
        rank, owner, cnt = warp_rank(ip, m)             # 1. K2's ballot rank
        totals = cnt.sum(axis=0)
        start = np.cumsum(totals) - totals              # 2. the block scan
        base = start[None, :] + np.cumsum(cnt, axis=0) - cnt
        dest = base[owner, ip] + rank                   # 3. dest; keys into the ids plane
        kr = np.empty(t, np.int64)
        kr[dest] = ks
        ip = kr
        if vals is not None:                            # 4. values into the key plane
            ks = np.empty(t, np.int64)
            ks[dest] = vals[tile].astype(np.int64)
            out[1][tile] = ks
        out[0][tile], out[2][tile] = ip, dest           # 5. the rows from the planes
    return out[0], out[1] if vals is not None else None, out[2]


def _same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint32).view(np.int32),
                                  np.asarray(want).view(np.int32), err_msg=what)


K3P_SPECS = {1: jid.DeltaSpec(1), 2: jid.DeltaSpec(2, 2**32), 7: jid.DeltaSpec(7),
             256: jid.BitfieldSpec(24, 8)}
K3P_CASES = [
    # (kind of strip, (L, T), m)
    ("flat", (3, 37), 7),
    ("flat", (2, 1000), 256),
    ("flat", (1, 4096), 2),
    ("flat", (1, MAX_TILE), 256),
    ("flat", (2, 128), 1),
    ("one run a tile", (2, 1000), 2),
    ("one run a tile", (1, MAX_TILE), 1),
    ("runs of 32 and 33", (2, 1000), 7),
    ("round boundaries", (1, 4096), 256),
    ("tiny segments", (2, 1000), 256),
    ("tiny segments", (1, 4096), 2),
    ("empty segments", (1, 1000), 7),
]


@pytest.mark.parametrize("kind,shape,m", K3P_CASES,
                         ids=[f"{k.replace(' ', '-')}-{s[0]}x{s[1]}-m{m}" for k, s, m in K3P_CASES])
def test_k3p_design_vs_pallas(kind, shape, m):
    """Labels in the kernel and from the ids strip (the clamp form), at
    subtiles 1, 32 and 255 (1 and 255 in tiles of 4096 and more), against
    the Pallas call of each label source (its result depends on no
    subtile)."""
    rng = np.random.default_rng(shape[1] * 1000 + m)
    spec = K3P_SPECS[m]
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    labels = np.asarray(spec.emit(jnp.asarray(keys))).astype(np.int64)
    ids = rng.integers(0, m, shape).astype(np.int32)     # ids in [0, m) (ROADMAP §C 3)
    seg, s = (None, 1) if kind == "flat" else _strip(kind, shape, rng)
    segs = None if seg is None else jnp.asarray(seg)
    for ids_entry, lab in ((False, labels), (True, ids)):
        cid = (seg.astype(np.int64) * m if seg is not None else 0) + lab
        g = _bases(cid, s * m)
        if ids_entry:
            want = jkops.packed_tile_positions(jnp.asarray(ids), jnp.asarray(g), segs,
                                               num_buckets=m, num_segments=s, oblivious=False)
        else:
            want = jkops.packed_tile_positions(jnp.asarray(keys), jnp.asarray(g), segs, spec=spec,
                                               num_segments=s, oblivious=False)
        for sub in (1, 32, MAX_SUB) if shape[1] < 4096 else (1, MAX_SUB):
            got, fullest = k3p_design(lab, seg, g, m, s, sub)
            assert fullest <= max(sub, 32) <= LANE_CAP
            _same(got, want, f"K3p {kind} ids={ids_entry} sub={sub}")


@pytest.mark.parametrize("seg_kind", ["flat", "one run a tile"])
def test_k3p_one_bucket_tile_of_8192_stays_under_the_lane_cap(seg_kind):
    """Every key of a tile of 8192 in one bucket (kR = 32 rounds a warp):
    each warp's 1024 keys fill its lane to a subtile's whole rounds before
    the unpack (224 at subtile 255), never past 255; the result is the
    Pallas kernel's, flat and as a one-run segmented tile."""
    shape, m = (1, MAX_TILE), 8
    ids = np.full(shape, 5, np.int32)
    seg, s = (None, 1) if seg_kind == "flat" else (np.full(shape, 2, np.int32), 4)
    cid = (seg.astype(np.int64) * m if seg is not None else 0) + ids
    g = _bases(cid, s * m)
    want = jkops.packed_tile_positions(jnp.asarray(ids), jnp.asarray(g),
                                       None if seg is None else jnp.asarray(seg), num_buckets=m,
                                       num_segments=s, subtile=MAX_SUB, oblivious=False)
    for sub, cap in ((MAX_SUB, 224), (128, 128), (100, 96), (32, 32), (7, 32)):
        got, fullest = k3p_design(ids.astype(np.int64), seg, g, m, s, sub)
        assert fullest == cap, (sub, fullest)
        _same(got, want, f"one bucket sub={sub}")
    # at the largest subtile a lane counts 32 keys a round for at most
    # MAX_SUB // 32 rounds between two unpacks, at any tile width
    assert 32 * max(1, MAX_SUB >> 5) <= LANE_CAP


def test_k3p_strips_reach_every_path():
    """The strips above drive one-run tiles, runs of at most 32 keys and
    longer ones, and runs that start inside a round and on its boundary."""
    rng = np.random.default_rng(0)
    seen = set()
    for kind, shape, _ in K3P_CASES:
        if kind == "flat":
            continue
        seg, _ = _strip(kind, shape, rng)
        for tile in range(shape[0]):
            short, long_ = _runs(seg[tile])
            if not short and long_ == [(0, shape[1])]:
                seen.add("one run")
                continue
            seen.update({"short" for _ in short[:1]} | {"long" for _ in long_[:1]})
            starts = [a for a, _ in short + long_]
            seen.update({"in a round" for a in starts if a % 32} |
                        {"on a boundary" for a in starts if a and a % 32 == 0})
            if any(e - a == SHORT_RUN for a, e in short):
                seen.add("32")
    assert seen == {"one run", "short", "long", "in a round", "on a boundary", "32"}


B10_CASES = [
    # ((L, T), m, key dtype)
    ((3, 37), 7, "float32"),
    ((2, 1024), 256, "float32"),
    ((2, 1024), 2, "int32"),
    ((1, 4096), 256, "uint32"),
    ((1, 4096), 1, "float32"),
]


@pytest.mark.parametrize("shape,m,dtype", B10_CASES,
                         ids=[f"{s[0]}x{s[1]}-m{m}-{d}" for s, m, d in B10_CASES])
def test_b10_design_vs_pallas(shape, m, dtype):
    """Key-value and key-only (the keys and dest of the key-value call:
    the Pallas kernel always takes values), float32 keys with NaN and ±inf
    moved as bit patterns, against the Pallas kernel."""
    rng = np.random.default_rng(shape[1] * 10 + m)
    words = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    if dtype == "float32":
        edges = np.array([np.nan, np.inf, -np.inf, -0.0], np.float32).view(np.uint32)
        words.reshape(-1)[:4] = edges
        words.reshape(-1)[-2:] = np.array([0x7FC00001, 0xFF800001], np.uint32)   # payload NaNs
    keys = words.view(np.dtype(dtype))
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    ids = rng.integers(0, m, shape).astype(np.int32)     # ids in [0, m) (ROADMAP §C 3)
    want = jkops.tile_reorder(jnp.asarray(ids), jnp.asarray(keys), jnp.asarray(vals), m)
    names = ("keys_r", "vals_r", "dest")
    for values in (vals, None):
        got = b10_design(ids, words, values, m)
        for a, b, name in zip(got, want, names):
            if a is None:
                assert values is None and name == "vals_r"
                continue
            _same(a, np.asarray(b).view(np.uint32), f"B10 {shape} m={m} {dtype} {name} "
                                                    f"values={values is not None}")


def test_b10_clamps_ids_outside_the_buckets():
    """An id outside [0, m) is ranked as its clamp, as every ids kernel
    reads it: the design equals the Pallas kernel on the clamped ids."""
    rng = np.random.default_rng(5)
    shape, m = (2, 256), 7
    ids = rng.integers(-3, m + 3, shape).astype(np.int32)
    keys = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    want = jkops.tile_reorder(jnp.asarray(np.clip(ids, 0, m - 1)), jnp.asarray(keys),
                              jnp.asarray(keys), m)
    got = b10_design(ids, keys, keys, m)
    for a, b in zip(got, want):
        _same(a, b, "B10 clamped ids")


def test_stages_fit_the_blocks_an_sm():
    """The blocks an SM that each kernel's launch bounds ask for, against
    the stages ``sm90::pick_stages`` can give them at the main shapes, shared
    memory counted from the sources' layouts: K3p flat at T = 4096, m = 256
    keeps two stages at four blocks an SM; segmented (the strip's slot beside
    the keys) one stage at four, since two would leave three; B10 key-value
    keeps two stages at its blocks an SM: three at T = 1024, two at 4096
    (104 KiB a block), one at 8192."""
    t, m = 4096, 256
    counters = 4 * WARPS * m
    # K3p's static arrays: splitters, the packed words, chunk flags, long runs, end ids
    k3p_static = 4 * 256 + 4 * WARPS * 64 + 4 * (MAX_TILE // 32) + 8 * (MAX_TILE // 33 + 1) + 32

    def k3p_block(stage_words, stages):
        return 4 * stage_words * stages + counters + k3p_static + 1024

    assert K3P_BLOCKS == (4, 1, 2)
    assert K3P_BLOCKS[0] * k3p_block(t + m, 2) <= SMEM_PER_SM
    assert K3P_BLOCKS[0] * k3p_block(2 * t, 1) <= SMEM_PER_SM < K3P_BLOCKS[0] * k3p_block(2 * t, 2)
    assert B10_BLOCKS == (3, 2, 1)
    for width, blocks in zip((1024, 4096, MAX_TILE), B10_BLOCKS):
        two = 4 * 3 * width * 2 + counters + 4 * WARPS
        assert blocks * (two + 1024) <= SMEM_PER_SM, width
    assert 4 * 3 * t * 2 + counters + 4 * WARPS <= 104 * 1024 + 64
