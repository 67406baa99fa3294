"""The Hopper designs of K1 and K2, emulated step by step in numpy, against
the JAX package's Pallas kernels on the CPU (interpret mode).

K1 (``csrc/tile_histograms.cu``) counts each tile into copies of the m
counters, lane l of a 32-lane round adding into copy l % C, and sums the
copies into the row. K2 (``csrc/fused_postscan_reorder.cu``) ranks each
tile with eight warps walking contiguous runs of 32-key rounds in order,
a round's peers found by ballots over the label's bits, turns the warp
counters into start[b] + warp offset, writes perm in element order,
reorders keys and values in place into bucket-major slots with a byte of
bucket beside each slot, and writes pos_r[j] = j + G[b] - start[b] from
that byte. The CUDA kernels themselves are held against the plain versions
on the card by ``chip_smoke.py``; these tests hold the designs' arithmetic
to the Pallas functions they replace, and the cheap label forms of
``csrc/multisplit_sm90.cuh`` to the specs' labels."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import identifiers as jid
from repro.kernels import ops as jkops

WARPS = 8                # K2's warps a block
COPY_WORDS = 2056        # K1's words a set of counter copies


def _label_bits(m: int) -> int:
    return int(m - 1).bit_length() if m > 1 else 0


def _k1_copies(m: int):
    stride = m | 1
    copies = 32
    while copies > 1 and copies * stride > COPY_WORDS:
        copies >>= 1
    return copies, stride


def k1_design(labels: np.ndarray, m: int) -> np.ndarray:
    """(L, T) labels -> (L, m) counts as K1 adds them: key e of a tile is
    counted by lane (e // 4) % 32 of its warp (four keys a 16-byte vector)
    into copy lane % C, the copies summed into the row."""
    n_tiles, t = labels.shape
    copies, stride = _k1_copies(m)
    hist = np.zeros((n_tiles, m), np.int32)
    lane = (np.arange(t) // 4) % 32
    for tile in range(n_tiles):
        cnt = np.zeros(copies * stride, np.int64)
        np.add.at(cnt, (lane % copies) * stride + labels[tile], 1)
        hist[tile] = cnt.reshape(copies, stride)[:, :m].sum(axis=0)
    return hist


def _peers(b: np.ndarray, valid: np.ndarray, nbits: int) -> np.ndarray:
    """Each lane's peer mask from ballots over the label bits, as a (32, 32)
    boolean matrix: peers[l, j] is lane j in lane l's group."""
    same = valid[None, :] & np.ones((32, 32), bool)
    for bit in range(nbits):
        on = (b >> bit) & 1
        same &= on[:, None] == on[None, :]
    return same


def k2_design(labels, g, keys, vals, m):
    """The K2 kernel's steps on one (L, T) strip: (keys_r, vals_r, pos_r,
    perm)."""
    n_tiles, t = labels.shape
    nbits = _label_bits(m)
    nr = -(-t // 32)
    r_per_warp = -(-nr // WARPS)
    out = [np.empty_like(keys), np.empty_like(vals), np.empty((n_tiles, t), np.int32),
           np.empty((n_tiles, t), np.int32)]
    for tile in range(n_tiles):
        b_all = labels[tile]
        cnt = np.zeros((WARPS, m), np.int64)
        rank = np.zeros(t, np.int64)
        owner = np.zeros(t, np.int64)
        for w in range(WARPS):                       # 1. the ordered walk
            for rd in range(w * r_per_warp, min((w + 1) * r_per_warp, nr)):
                i = rd * 32 + np.arange(32)
                valid = i < t
                b = np.where(valid, b_all[np.minimum(i, t - 1)], 0)
                peers = _peers(b, valid, nbits)
                lower = np.tril(np.ones((32, 32), bool), -1)   # lanes below each lane
                for lane in np.flatnonzero(valid):
                    rank[i[lane]] = cnt[w, b[lane]] + np.sum(peers[lane] & lower[lane])
                    owner[i[lane]] = w
                for bucket in np.unique(b[valid]):
                    cnt[w, bucket] += np.sum(valid & (b == bucket))
        totals = cnt.sum(axis=0)                     # 2. offsets, starts, G - start
        start = np.concatenate([[0], np.cumsum(totals)[:-1]])
        base = start[None, :] + np.cumsum(cnt, axis=0) - cnt
        delta = g[tile].astype(np.int64) - start
        dest = base[owner, b_all] + rank             # 3. destinations, perm
        out[3][tile] = dest + delta[b_all]
        ks, vs, sb = np.empty_like(keys[tile]), np.empty_like(vals[tile]), np.empty(t, np.int64)
        ks[dest], vs[dest], sb[dest] = keys[tile], vals[tile], b_all   # 4. in place
        out[0][tile], out[1][tile] = ks, vs          # 5. write-out
        out[2][tile] = np.arange(t) + delta[sb]
    return tuple(out)


CASES = [(shape, m) for shape in ((2, 100), (2, 1000), (1, 37)) for m in (1, 2, 7, 256)]


@pytest.mark.parametrize("shape,m", CASES, ids=[f"{s[0]}x{s[1]}-m{m}" for s, m in CASES])
def test_k1_and_k2_designs_vs_pallas(shape, m):
    rng = np.random.default_rng(shape[1] * 1000 + m)
    if m == 7:                                       # skewed: most keys in bucket 3
        ids = np.where(rng.random(shape) < 0.8, 3, rng.integers(0, m, shape)).astype(np.int32)
    else:
        ids = rng.integers(0, m, shape).astype(np.int32)
    keys = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(-2**31, 2**31, shape).astype(np.int32)

    hist = k1_design(ids, m)
    want_hist = np.asarray(jkops.tile_histograms(jnp.asarray(ids), m, interpret=True))
    np.testing.assert_array_equal(hist, want_hist)

    counts = hist.reshape(-1)
    g = (np.cumsum(counts) - counts).reshape(hist.shape).astype(np.int32) + 5
    got = k2_design(ids, g, keys, vals, m)
    want = jkops.fused_postscan_reorder(jnp.asarray(ids), jnp.asarray(g), jnp.asarray(keys),
                                        jnp.asarray(vals), m, interpret=True)
    for a, b, name in zip(got, want, ("keys_r", "vals_r", "pos_r", "perm")):
        np.testing.assert_array_equal(a.view(np.int32), np.asarray(b).view(np.int32), err_msg=name)


def _label_form(words: np.ndarray, spec) -> np.ndarray:
    """The cheap forms of multisplit_sm90.cuh's make_label / label_of on
    integer key words: a shift and a mask, or a clamped id."""
    u = words.astype(np.uint64)
    m = spec.num_buckets
    if isinstance(spec, jid.DeltaSpec):
        delta = max(1, spec.key_max // m)
        assert delta & (delta - 1) == 0, "the shift form takes a delta of 2^k"
        return np.minimum(u >> int(delta).bit_length() - 1, m - 1)
    if isinstance(spec, jid.BitfieldSpec):
        return np.minimum((u >> spec.shift) & ((1 << spec.bits) - 1), m - 1)
    return np.clip(words.view(np.int32), 0, m - 1)


@pytest.mark.parametrize("spec", [
    jid.DeltaSpec(1), jid.DeltaSpec(2, 2**32), jid.DeltaSpec(256, 2**32), jid.DeltaSpec(256),
    jid.BitfieldSpec(0, 8), jid.BitfieldSpec(24, 8), jid.BitfieldSpec(31, 1), jid.IdentitySpec(7),
], ids=lambda s: s.name)
def test_label_forms_equal_the_specs(spec):
    rng = np.random.default_rng(7)
    if isinstance(spec, jid.IdentitySpec):
        words = rng.integers(0, spec.num_buckets, 4096).astype(np.int32).view(np.uint32)
    else:
        words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
        words[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(spec.emit(jnp.asarray(words)))
    np.testing.assert_array_equal(_label_form(words, spec), want.astype(np.int64))
