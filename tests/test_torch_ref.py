"""The port's kernel oracles (``repro_torch.kernels.ref``) against the JAX
oracles (``repro.kernels.ref``) and the port's plain versions, bitwise.

Ids are drawn in ``[0, m)``: outside it the one-hot oracles give
destination 0 where the kernels clamp (ROADMAP §C 3). Flash attention's
oracle is held in ``tests/test_torch_flash_attention.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.identifiers import BitfieldSpec
from repro_torch.core.pipeline.stages import global_scan
from repro_torch.kernels import multisplit_tile as mst
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import ref as tref

# (tiles, tile width, buckets): one bucket, an odd m over a ragged tile, the
# widest m; for the radix oracles (shift, bits) of a 4- and an 8-bit digit
SHAPES = [(2, 64, 1), (3, 100, 7), (2, 256, 256)]
DIGITS = [(4, 4), (24, 8)]


def _eq(got, want) -> None:
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ids(shape, seed):
    n_tiles, t, m = shape
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, m, (n_tiles, t)).astype(np.int32)
    g = rng.integers(0, 2**20, (n_tiles, m)).astype(np.int32)
    return ids, g, m, rng


def _words(rng, shape, dtype):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(dtype)


def _id(shape):
    return f"{shape[0]}x{shape[1]}-m{shape[2]}"


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_histograms(shape):
    ids, _, m, _ = _ids(shape, 0)
    got = tref.tile_histograms(torch.from_numpy(ids), m)
    _eq(got, jref.tile_histograms(jnp.asarray(ids), m))
    assert torch.equal(got, mst.tile_histograms_plain(torch.from_numpy(ids), m))
    dev = tref.device_histogram(torch.from_numpy(ids), m)
    _eq(dev, jref.device_histogram(jnp.asarray(ids), m))
    assert torch.equal(dev, tkops.device_histogram(torch.from_numpy(ids), m))


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_positions(shape):
    ids, g, m, _ = _ids(shape, 1)
    got = tref.tile_positions(torch.from_numpy(ids), torch.from_numpy(g), m)
    _eq(got, jref.tile_positions(jnp.asarray(ids), jnp.asarray(g), m))
    assert torch.equal(got, mst.tile_positions_plain(torch.from_numpy(ids), torch.from_numpy(g), m))


@pytest.mark.parametrize("key_value", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("dtype", [np.uint32, np.float32], ids=["uint32", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_reorder(shape, dtype, key_value):
    ids, g, m, rng = _ids(shape, 2)
    keys = _words(rng, ids.shape, dtype)
    vals = _words(rng, ids.shape, np.int32) if key_value else None
    t_vals = None if vals is None else torch.from_numpy(vals)
    j_vals = None if vals is None else jnp.asarray(vals)
    t_ids, t_keys, t_g = torch.from_numpy(ids), torch.from_numpy(keys), torch.from_numpy(g)

    got = tref.tile_reorder(t_ids, t_keys, t_vals, m)
    for a, b in zip(got, jref.tile_reorder(jnp.asarray(ids), jnp.asarray(keys), j_vals, m)):
        _eq(a, b)
    for a, b in zip(got, mst.tile_reorder_plain(t_ids, t_keys, t_vals, m)):
        _eq(a, b)

    got = tref.fused_postscan_reorder(t_ids, t_g, t_keys, t_vals, m)
    want = jref.fused_postscan_reorder(jnp.asarray(ids), jnp.asarray(g), jnp.asarray(keys),
                                       j_vals, m)
    for a, b in zip(got, want):
        _eq(a, b)
    for a, b in zip(got, mst.fused_postscan_reorder_plain(t_ids, t_g, t_keys, t_vals, m)):
        _eq(a, b)


@pytest.mark.parametrize("key_value", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32], ids=["uint32", "int32"])
@pytest.mark.parametrize("shift,bits", DIGITS)
def test_radix(shift, bits, dtype, key_value):
    rng = np.random.default_rng(shift + bits)
    keys = _words(rng, (3, 128), dtype)
    vals = _words(rng, (3, 128), np.int32) if key_value else None
    t_keys, spec = torch.from_numpy(keys), BitfieldSpec(shift, bits)
    t_vals = None if vals is None else torch.from_numpy(vals)

    hist = tref.radix_tile_histograms(t_keys, shift, bits)
    _eq(hist, jref.radix_tile_histograms(jnp.asarray(keys), shift, bits))
    assert torch.equal(hist, mst.spec_tile_histograms_plain(t_keys, spec))
    g = global_scan(hist)
    got = tref.radix_fused_postscan_reorder(t_keys, g, t_vals, shift, bits)
    want = jref.radix_fused_postscan_reorder(jnp.asarray(keys), jnp.asarray(g.numpy()),
                                             None if vals is None else jnp.asarray(vals),
                                             shift, bits)
    for a, b in zip(got, want):
        _eq(a, b)
    for a, b in zip(got, mst.spec_fused_postscan_reorder_plain(t_keys, g, t_vals, spec)):
        _eq(a, b)
