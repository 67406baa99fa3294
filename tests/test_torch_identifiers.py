"""Bucket specs of the PyTorch port against the JAX package's, bitwise.

The same numpy keys (made from a seed) go through ``repro``'s ``emit`` and
``repro_torch``'s; the int32 labels must be equal element for element,
across int32 / uint32 / float32 keys and the edges each spec pins."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import identifiers as jid
from repro_torch.convert import convert_spec, spec_from_fields
from repro_torch.core import identifiers as tid

import _torch_threads

_torch_threads.pin()

U32_MAX = 2**32 - 1
I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _keys(dtype, n=2000, seed=0):
    """Random keys over the whole dtype range plus its edges."""
    rng = np.random.default_rng(seed)
    if dtype == np.uint32:
        k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        edges = [0, 1, 2**30 - 1, 2**30, 2**31, U32_MAX - 1, U32_MAX]
    elif dtype == np.int32:
        k = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
        edges = [I32_MIN, -1, 0, 1, 2**30 - 1, 2**30, I32_MAX]
    else:
        k = rng.uniform(-3e9, 6e9, n).astype(np.float32)
        edges = [np.nan, np.inf, -np.inf, -0.0, 0.0, -1.5, 0.5, 4.2e9, 5e9,
                 np.finfo(np.float32).max, -np.finfo(np.float32).max]
    return np.concatenate([np.asarray(edges, dtype), k])


def _emit_both(jspec, keys: np.ndarray):
    want = np.asarray(jspec.emit(jnp.asarray(keys)))
    got = convert_spec(jspec).emit(torch.from_numpy(keys)).numpy()
    return got, want


def _assert_emit_equal(jspec, keys):
    got, want = _emit_both(jspec, keys)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


DTYPES = [np.uint32, np.int32, np.float32]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,key_max", [(2, 2**30), (32, 2**30), (256, 2**30), (7, 2**32 - 1), (256, 1000)])
def test_delta_emit(dtype, m, key_max):
    """Negative int32 keys wrap to uint32; float keys convert by value and
    saturate (NaN -> 0)."""
    _assert_emit_equal(jid.DeltaSpec(m, key_max), _keys(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [2, 32, 256])
def test_identity_emit(dtype, m):
    keys = np.random.default_rng(m).integers(0, m, 500).astype(dtype)
    if dtype == np.float32:
        keys = keys + np.float32(0.75)
    _assert_emit_equal(jid.IdentitySpec(m), keys)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("shift,bits", [(0, 8), (8, 8), (24, 8), (31, 1), (7, 5), (28, 4)])
def test_bitfield_emit(dtype, shift, bits):
    _assert_emit_equal(jid.BitfieldSpec(shift, bits), _keys(dtype))


def test_bitfield_rejects_float_keys():
    spec = tid.BitfieldSpec(0, 8)
    with pytest.raises(TypeError):
        spec.emit(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(TypeError):
        spec.pad_key(torch.float32)
    with pytest.raises(TypeError):
        jid.BitfieldSpec(0, 8).pad_key(jnp.float32)


RANGE_CASES = {
    "unsorted": [900, -5, 40, 40, 7],
    "u32_top": [3, 2**31, U32_MAX - 1, U32_MAX],
    "negative": [I32_MIN, -(2**20), -1, 0],
    "fractional": [-2.5, 0.5, 1e9 + 0.25, 3.75e9],
    "single": [2**30],
    "wide": list(range(-(2**31), 2**31, 2**24))[:255],
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range_emit(dtype, case):
    """Splitters are sorted at construction and compared in the key dtype
    (float32 for integer keys with fractional splitters)."""
    splitters = RANGE_CASES[case]
    try:
        jspec = jid.RangeSpec(tuple(splitters))
        jspec._compare_plane(jnp.dtype(dtype))
    except ValueError:
        # out of range for this key dtype: the port must refuse it too
        with pytest.raises(ValueError):
            tid.RangeSpec(tuple(splitters)).emit(torch.from_numpy(_keys(dtype, 8)))
        return
    keys = _keys(dtype)
    if dtype == np.float32:
        keys = keys[~np.isnan(keys)]       # NaN keys are not a RangeSpec contract
    _assert_emit_equal(jspec, keys)
    assert convert_spec(jspec).splitters == tuple(sorted(splitters))


def test_range_rejects_out_of_range_and_nan_splitters():
    with pytest.raises(ValueError):
        tid.RangeSpec((2**31,)).emit(torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tid.RangeSpec((-1,)).emit(torch.zeros(3, dtype=torch.uint32))
    with pytest.raises(ValueError):
        tid.RangeSpec((1.0, float("nan")))
    assert tid.RangeSpec(()).emit(torch.arange(5)).tolist() == [0] * 5


def _even_keys(lo, hi, m, dtype):
    width = np.float32((hi - lo) / m)
    edges = np.float32(lo) + np.arange(m + 1, dtype=np.float32) * width
    if dtype != np.float32:
        near = np.floor(edges.astype(np.float64)).astype(np.int64)
        rnd = np.random.default_rng(m).integers(int(lo) - 3, int(hi) + 3, 2000)
        k = np.concatenate([near - 1, near, near + 1, rnd])
        return k[k >= 0].astype(dtype) if dtype == np.uint32 else k.astype(dtype)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf))])
    rnd = np.random.default_rng(m).uniform(lo - 2, hi + 2, 3000).astype(np.float32)
    special = np.asarray([np.nan, -np.nan, np.inf, -np.inf, lo, hi, 0.0, -0.0,
                          np.finfo(np.float32).max], np.float32)
    return np.concatenate([near, rnd, special]).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lo,hi,m", [(-3.7, 11.3, 37), (0.0, 1.0, 256), (-100.0, 100.0, 2), (0.0, 1e9, 32)])
def test_even_emit(dtype, lo, hi, m):
    """Bucket boundaries in float32, NaN to the last bucket, ±inf clipped."""
    _assert_emit_equal(jid.EvenSpec(lo, hi, m), _even_keys(lo, hi, m, dtype))


PAD_SPECS = [
    jid.DeltaSpec(32), jid.IdentitySpec(17), jid.BitfieldSpec(8, 8),
    jid.RangeSpec((1, 5, 9)), jid.EvenSpec(-1.0, 1.0, 8),
]
PAD_DTYPES = [(np.uint32, torch.uint32), (np.int32, torch.int32), (np.float32, torch.float32)]


@pytest.mark.parametrize("jspec", PAD_SPECS, ids=lambda s: s.name)
@pytest.mark.parametrize("np_dt,t_dt", PAD_DTYPES, ids=lambda d: str(d))
def test_pad_key(jspec, np_dt, t_dt):
    """Every spec's pad key equals the JAX package's and lands in bucket m-1."""
    spec = convert_spec(jspec)
    if isinstance(jspec, jid.BitfieldSpec) and np_dt == np.float32:
        with pytest.raises(TypeError):
            spec.pad_key(t_dt)
        return
    want = jspec.pad_key(jnp.dtype(np_dt))
    got = spec.pad_key(t_dt)
    if isinstance(jspec, jid.DeltaSpec) and np_dt == np.int32:
        want = -1                          # the all-ones key: see the next test
    assert got == want
    assert spec.emit(torch.tensor([got], dtype=t_dt)).tolist() == [spec.num_buckets - 1]


def test_delta_pad_key_of_signed_keys_lands_in_the_last_bucket():
    """The JAX package pads int32 keys of a DeltaSpec with the signed
    maximum, whose bucket is 16 of 32 when key_max = 2^32 - 1 (its tiled
    backends then miscount; ROADMAP §C). The port pads with -1, whose bucket
    is m-1 for every key_max."""
    jspec = jid.DeltaSpec(32, 2**32 - 1)
    jpad = jspec.pad_key(jnp.int32)
    assert np.asarray(jspec.emit(jnp.asarray([jpad], jnp.int32))).tolist() == [16]
    spec = convert_spec(jspec)
    for key_max in (2**30, 2**31 + 5, 2**32 - 1):
        s = tid.DeltaSpec(32, key_max)
        assert s.emit(torch.tensor([s.pad_key(torch.int32)], dtype=torch.int32)).tolist() == [31]
    assert spec.pad_key(torch.int32) == -1


def test_callable_spec_pads_labels_not_keys():
    spec = tid.from_fn(lambda k: k % 3, 3)
    assert not spec.fusable
    with pytest.raises(NotImplementedError):
        spec.pad_key(torch.int32)
    assert spec.emit(torch.arange(6)).tolist() == [0, 1, 2, 0, 1, 2]


@pytest.mark.parametrize("jspec", PAD_SPECS, ids=lambda s: s.name)
def test_specs_hash_by_value_and_convert(jspec):
    spec = convert_spec(jspec)
    assert spec == convert_spec(jspec) and hash(spec) == hash(convert_spec(jspec))
    assert spec.name == jspec.name and spec.num_buckets == jspec.num_buckets
    assert spec == spec_from_fields(type(jspec).__name__, dataclasses.asdict(jspec))


def test_convert_rejects_callable_and_as_spec():
    with pytest.raises(ValueError):
        spec_from_fields("CallableSpec", {})
    with pytest.raises(TypeError):
        tid.as_spec(42)

    def fn(k):
        return k % 4

    fn.num_buckets = 4
    assert isinstance(tid.as_spec(fn), tid.CallableSpec)
    assert tid.as_spec(tid.DeltaSpec(4)) == tid.delta_buckets(4)
    assert tid.radix_buckets(2, 8) == tid.BitfieldSpec(16, 8)
    assert tid.range_buckets([5, 1]) == tid.RangeSpec((1, 5))
    assert tid.even_buckets(0, 1, 4) == tid.EvenSpec(0.0, 1.0, 4)
    assert tid.identity_buckets(3) == tid.IdentitySpec(3)
