"""Subnormal float32 keys: the port keeps IEEE subnormals, as numpy does.

XLA flushes float32 subnormals to zero (``ROADMAP.md`` §C 4: on the CPU
``jnp.asarray(np.float32(-1e-38)) < 0`` is False, and TPUs flush too), so
the JAX package files -1e-38 beside -0.0. The port's labels compare the
keys as they are. These tests hold the port's ``reference`` and ``vmap``
backends to numpy's IEEE answer, not to JAX's: ``RangeSpec((-2.0, -0.0,
0.5, 1.0, 4.0))`` and ``EvenSpec(-1e-38, 1e-38, 4)`` (whose bucket width,
5e-39, is itself subnormal), flat and segmented, every method and mode,
key-value; and ``direct_sort_multisplit``. ``chip_smoke.py`` holds the
``cuda`` labels to ``vmap`` on the same keys.
"""

import numpy as np
import pytest
import torch

from repro_torch import ops
from repro_torch.core.sort import direct_sort_multisplit

import _torch_threads

_torch_threads.pin()

TINY = np.array([1e-38, -1e-38, 1e-39, -1e-39, 1.4e-45, -1.4e-45, 5e-39, -5e-39, 0.0, -0.0],
                np.float32)
SPECS = {"range": ops.RangeSpec((-2.0, -0.0, 0.5, 1.0, 4.0)),
         "even": ops.EvenSpec(-1e-38, 1e-38, 4)}
SEGMENTS = np.array([0, 40, 40, 101, 180], np.int64)          # one empty segment
METHODS = ("dms", "wms", "bms")
MODES = ("reorder", "counts_only", "positions_only")
N = 257


def subnormal_keys(n: int = N, seed: int = 0) -> np.ndarray:
    """Normal keys in (-3, 5) with every subnormal probe (and ±0) several
    times among them."""
    rng = np.random.RandomState(seed)
    keys = rng.uniform(-3, 5, n).astype(np.float32)
    at = rng.choice(n, 6 * len(TINY), replace=False)
    keys[at] = np.tile(TINY, 6)
    return keys


def ieee_labels(name: str, keys: np.ndarray) -> np.ndarray:
    """numpy's float32 answer, subnormals kept."""
    spec = SPECS[name]
    if name == "range":
        sp = np.asarray(spec.splitters, np.float32)
        return (sp[None, :] <= keys[:, None]).sum(1)
    lo, width = np.float32(spec.lo), np.float32(spec.width)
    with np.errstate(over="ignore"):
        ids = np.floor((keys - lo) / width)
    return np.clip(ids, 0, spec.num_buckets - 1).astype(np.int64)


def oracle(keys, labels, m, starts=None):
    """Stable multisplit of each segment (the whole input without
    ``starts``): output keys, counts, starts and the permutation (output
    position of each input), the last two segment-local as the port gives
    them; and the output's source positions."""
    n = len(keys)
    bounds = list(starts if starts is not None else [0]) + [n]
    perm, src, counts, firsts = np.empty(n, np.int64), np.empty(n, np.int64), [], []
    for a, e in zip(bounds[:-1], bounds[1:]):
        lab = labels[a:e]
        c = np.bincount(lab, minlength=m)
        order = np.argsort(lab, kind="stable")
        perm[a + order] = np.arange(e - a)
        src[a:e] = a + order
        counts.append(c)
        firsts.append(np.concatenate([[0], np.cumsum(c)[:-1]]))
    if starts is None:
        return keys[src], counts[0], firsts[0], perm, src
    return keys[src], np.stack(counts), np.stack(firsts), perm, src


def _bits(x) -> np.ndarray:
    return x.numpy().view(np.int32)


def test_the_probe_separates_ieee_from_flushing():
    """Flushing the subnormals to ±0 changes both specs' labels: the probe
    tells the port's answer from JAX's."""
    keys = subnormal_keys()
    tiny = np.abs(keys) < np.finfo(np.float32).tiny
    flushed = np.where(tiny, np.copysign(np.float32(0), keys), keys).astype(np.float32)
    for name in SPECS:
        assert (ieee_labels(name, keys) != ieee_labels(name, flushed)).any(), name


@pytest.mark.parametrize("segmented", [False, True], ids=["flat", "segmented"])
@pytest.mark.parametrize("backend", ["reference", "vmap"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_labels_keep_subnormals(spec, backend, segmented):
    keys = subnormal_keys()
    vals = np.arange(N, dtype=np.int32)
    m = SPECS[spec].num_buckets
    starts = SEGMENTS if segmented else None
    want_keys, want_counts, want_starts, want_perm, src = oracle(
        keys, ieee_labels(spec, keys), m, starts)
    tk = torch.from_numpy(keys)
    for method in METHODS:
        for mode in MODES:
            kw = dict(method=method, mode=mode, backend=backend, device="cpu")
            tv = torch.from_numpy(vals) if mode == "reorder" else None
            if segmented:
                r = ops.segmented_multisplit(tk, SPECS[spec], torch.from_numpy(starts), tv, **kw)
            else:
                r = ops.multisplit(tk, SPECS[spec], tv, **kw)
            what = f"{spec} {backend} {method} {mode}"
            np.testing.assert_array_equal(r.bucket_counts.numpy(), want_counts, err_msg=what)
            if mode == "counts_only":
                continue
            np.testing.assert_array_equal(r.bucket_starts.numpy(), want_starts, err_msg=what)
            if r.permutation is not None:
                np.testing.assert_array_equal(r.permutation.numpy(), want_perm, err_msg=what)
            if mode == "reorder":
                np.testing.assert_array_equal(_bits(r.keys), want_keys.view(np.int32),
                                              err_msg=what)
                np.testing.assert_array_equal(r.values.numpy(), vals[src], err_msg=what)


def test_histogram_keeps_subnormals():
    keys = subnormal_keys()
    for name, spec in SPECS.items():
        want = np.bincount(ieee_labels(name, keys), minlength=spec.num_buckets)
        for backend in ("reference", "vmap"):
            got = ops.histogram(torch.from_numpy(keys), spec, backend=backend, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {backend}")


def test_direct_sort_orders_subnormals_as_numpy():
    """numpy's stable sort: subnormals by value, -0.0 and 0.0 equal (input
    order kept), where JAX's ``lax.sort`` ties every subnormal with ±0."""
    keys = subnormal_keys()
    vals = np.arange(N, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    k, v = direct_sort_multisplit(torch.from_numpy(keys), torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(k), keys[order].view(np.int32))
    np.testing.assert_array_equal(v.numpy(), vals[order])
