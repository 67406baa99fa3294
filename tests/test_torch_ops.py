"""The port's public ops against ``repro.ops`` (backend ``reference``), bitwise.

The same numpy keys and values (made from a seed) go through the JAX
package and through ``repro_torch.ops`` on the port's three backends on the
CPU — ``reference`` (direct solve), ``vmap`` (tiled torch stages) and
``cuda`` (the kernel wrappers, which run their plain versions for CPU
tensors). Keys and values are compared as int32 bit patterns."""

import ast
import functools
import os
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as jops
from repro.core import identifiers as jid
from repro_torch import ops
from repro_torch.convert import convert_spec
from repro_torch.core import pipeline as tpipe
from repro_torch.core.pipeline import radix as tradix
from repro_torch.core.sort import rb_sort_multisplit
from repro_torch.kernels import ops as tkops

import _fresh_process
import _torch_threads

_torch_threads.pin()

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["reference", "vmap", "cuda"]
METHODS = ["dms", "wms", "bms"]
FIELDS = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")


def _bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _assert_result(got, want, fields=FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.numpy().dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)


def _keys_vals(n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**30, n, dtype=np.int64)
    wide = rng.random(n) < 0.05                       # some keys past key_max
    keys[wide] = rng.integers(0, 2**32, int(wide.sum()), dtype=np.int64)
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    return keys.astype(np.uint32), vals


@functools.lru_cache(maxsize=None)
def _jax_multisplit(n, m):
    keys, vals = _keys_vals(n, n * 7 + m)
    res = jops.multisplit_key_value(jnp.asarray(keys), jnp.asarray(vals), jid.DeltaSpec(m),
                                    backend="reference")
    return keys, vals, jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("m", [2, 32, 256])
@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
def test_multisplit_matches_jax(n, m, backend, method):
    """Key-only and key-value reorder, counts_only and positions_only."""
    keys, vals, want = _jax_multisplit(n, m)
    spec = ops.DeltaSpec(m)
    kw = dict(method=method, backend=backend, device="cpu")
    _assert_result(ops.multisplit_key_value(keys, vals, spec, **kw), want)
    _assert_result(ops.multisplit(keys, spec, **kw), want._replace(values=None))
    counts = ops.multisplit(keys, spec, mode="counts_only", **kw)
    _assert_result(counts, want._replace(keys=None, values=None, permutation=None))
    np.testing.assert_array_equal(ops.histogram(keys, spec, backend=backend, device="cpu").numpy(),
                                  want.bucket_counts)
    positions = ops.multisplit(keys, spec, mode="positions_only", **kw)
    _assert_result(positions, want._replace(keys=None, values=None))


@pytest.mark.parametrize("m", [2, 32, 256])
def test_partial_modes_match_jax_partial_modes(m):
    """The JAX package's own counts_only / positions_only ops."""
    keys, _ = _keys_vals(1000, m)
    jspec = jid.DeltaSpec(m)
    want_h = np.asarray(jops.histogram(jnp.asarray(keys), jspec, backend="reference"))
    want_p = jops.multisplit(jnp.asarray(keys), jspec, backend="reference", mode="positions_only")
    for backend in BACKENDS:
        got_h = ops.histogram(keys, convert_spec(jspec), backend=backend, device="cpu")
        np.testing.assert_array_equal(got_h.numpy(), want_h)
        got_p = ops.multisplit(keys, convert_spec(jspec), backend=backend, mode="positions_only",
                               device="cpu")
        _assert_result(got_p, jax.tree_util.tree_map(np.asarray, want_p))


def _spec_case(name):
    rng = np.random.default_rng(len(name))
    n = 1000
    if name == "range-u32":
        keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        return jid.RangeSpec((2**32 - 1, 5, 2**31, 2**20)), keys
    if name == "even-f32":
        keys = rng.uniform(-5, 14, n).astype(np.float32)
        keys[:6] = [np.nan, np.inf, -np.inf, -3.7, 11.3, np.nan]
        return jid.EvenSpec(-3.7, 11.3, 37), keys
    if name == "identity-i32":
        return jid.IdentitySpec(13), rng.integers(0, 13, n).astype(np.int32)
    if name == "bitfield-i32":
        return jid.BitfieldSpec(20, 6), rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    if name == "delta-f32":
        return jid.DeltaSpec(32), rng.uniform(-1e9, 3e9, n).astype(np.float32)
    if name == "delta-i32-negative":
        return jid.DeltaSpec(32, 2**32 - 1), rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    raise KeyError(name)


SPEC_CASES = ["range-u32", "even-f32", "identity-i32", "bitfield-i32", "delta-f32", "delta-i32-negative"]


@functools.lru_cache(maxsize=None)
def _jax_spec_case(name):
    jspec, keys = _spec_case(name)
    vals = np.arange(keys.size, dtype=np.float32) * np.float32(0.5)
    res = jops.multisplit_key_value(jnp.asarray(keys), jnp.asarray(vals), jspec, backend="reference")
    return jspec, keys, vals, jax.tree_util.tree_map(np.asarray, res)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SPEC_CASES)
def test_specs_and_key_types_match_jax(name, backend):
    jspec, keys, vals, want = _jax_spec_case(name)
    spec = convert_spec(jspec)
    for method in METHODS:
        got = ops.multisplit(keys, spec, vals, method=method, backend=backend, device="cpu")
        _assert_result(got, want)
    hist = ops.histogram(keys, spec, backend=backend, device="cpu")
    np.testing.assert_array_equal(hist.numpy(), want.bucket_counts)


@functools.lru_cache(maxsize=None)
def _jax_sort(n, kv, radix_bits):
    keys, vals = _keys_vals(n, n + radix_bits)
    keys = keys ^ np.uint32(0x5A5A5A5A)                  # use every bit
    res = jops.radix_sort(jnp.asarray(keys), jnp.asarray(vals) if kv else None,
                          radix_bits=radix_bits, backend="reference")
    return keys, vals, [None if r is None else np.asarray(r) for r in res]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("n,radix_bits", [(0, 8), (1, 8), (1000, 8), (4099, 8), (1000, 5)])
def test_radix_sort_matches_jax(n, radix_bits, kv, backend):
    keys, vals, (want_k, want_v) = _jax_sort(n, kv, radix_bits)
    got_k, got_v = ops.radix_sort(keys, vals if kv else None, radix_bits=radix_bits,
                                  backend=backend, device="cpu")
    np.testing.assert_array_equal(_bits(got_k), _bits(want_k))
    assert (got_v is None) == (not kv)
    if kv:
        np.testing.assert_array_equal(_bits(got_v), _bits(want_v))


@pytest.mark.parametrize("backend", BACKENDS)
def test_key_value_gradient_matches_jax_grad(backend):
    """d_in[i] = ct_out[perm[i]] for values and for float keys."""
    rng = np.random.default_rng(3)
    keys = rng.uniform(-4, 12, 777).astype(np.float32)
    vals = rng.standard_normal(777).astype(np.float32)
    wk = rng.standard_normal(777).astype(np.float32)
    wv = rng.standard_normal(777).astype(np.float32)
    jspec = jid.EvenSpec(-3.7, 11.3, 37)

    def loss(k, v):
        r = jops.multisplit_key_value(k, v, jspec, backend="reference")
        return (r.keys * wk).sum() + (r.values * wv).sum()

    gk_want, gv_want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(keys), jnp.asarray(vals))
    kt = torch.tensor(keys, requires_grad=True)
    vt = torch.tensor(vals, requires_grad=True)
    res = ops.multisplit_key_value(kt, vt, convert_spec(jspec), backend=backend, device="cpu")
    assert res.permutation.requires_grad is False
    ((res.keys * torch.from_numpy(wk)).sum() + (res.values * torch.from_numpy(wv)).sum()).backward()
    np.testing.assert_array_equal(_bits(kt.grad), _bits(gk_want))
    np.testing.assert_array_equal(_bits(vt.grad), _bits(gv_want))


def test_integer_values_take_no_gradient():
    keys = torch.arange(100, dtype=torch.int32)
    vals = torch.linspace(0, 1, 100, requires_grad=True)
    res = ops.multisplit_key_value(keys, vals, ops.DeltaSpec(4, 100), backend="vmap", device="cpu")
    assert not res.keys.requires_grad and res.values.requires_grad
    res.values.sum().backward()
    assert torch.equal(vals.grad, torch.ones(100))


@pytest.mark.parametrize("backend", ["reference", "vmap"])
def test_callable_spec_matches_jax(backend):
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 10**6, 1500).astype(np.int32)
    want = jops.multisplit(jnp.asarray(keys), jid.from_fn(lambda k: k % 7, 7), backend="reference")
    spec = ops.from_fn(lambda k: k % 7, 7)
    for method in METHODS:
        got = ops.multisplit(keys, spec, method=method, backend=backend, device="cpu")
        _assert_result(got, jax.tree_util.tree_map(np.asarray, want))


def test_rb_sort_oracle_matches_pipeline():
    keys, vals = _keys_vals(3000, 9)
    spec = ops.DeltaSpec(32)
    want = rb_sort_multisplit(torch.from_numpy(keys), spec, torch.from_numpy(vals))
    _assert_result(ops.multisplit(keys, spec, vals, backend="vmap", device="cpu"),
                   jax.tree_util.tree_map(lambda t: t.numpy(), want))


def test_cuda_backend_routes_through_the_kernel_doors(monkeypatch):
    calls = []
    for name in ("spec_tile_histograms", "spec_tile_positions", "spec_fused_postscan_reorder"):
        real = getattr(tkops, name)
        monkeypatch.setattr(tkops, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    keys, vals = _keys_vals(5000, 1)
    spec = ops.DeltaSpec(64)
    ops.multisplit(keys, spec, vals, method="bms", backend="cuda", device="cpu")
    ops.multisplit(keys, spec, method="dms", backend="cuda", device="cpu")
    ops.histogram(keys, spec, backend="cuda", device="cpu")
    ops.radix_sort(keys, backend="cuda", device="cpu")
    assert calls == (["spec_tile_histograms", "spec_fused_postscan_reorder",
                      "spec_tile_histograms", "spec_tile_positions", "spec_tile_histograms"]
                     + ["spec_tile_histograms", "spec_fused_postscan_reorder"] * 4)
    plan = tpipe.make_plan(5000, 64, backend="cuda", bucket_fn=spec)
    assert plan.stages() == ("prescan:fused-label-kernel", "scan:global",
                             "postscan:fused-label-reorder-kernel", "scatter:bucket-major")
    assert plan.tile == tpipe.CUDA_TILE


def test_radix_pipeline_pads_once(monkeypatch):
    pads, sweeps = [], []
    real_pad, real_run = tradix._st.pad_to_tiles, tpipe.MultisplitPlan.run_tiled
    monkeypatch.setattr(tradix._st, "pad_to_tiles", lambda *a: pads.append(1) or real_pad(*a))
    monkeypatch.setattr(tpipe.MultisplitPlan, "run_tiled",
                        lambda self, *a: sweeps.append(1) or real_run(self, *a))
    keys, vals = _keys_vals(3000, 2)
    out_k, out_v = ops.radix_sort(keys, vals, backend="vmap", device="cpu")
    assert len(pads) == 2 and len(sweeps) == 4
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out_k.numpy(), keys[order])
    np.testing.assert_array_equal(out_v.numpy(), vals[order])


@pytest.mark.parametrize("call,err", [
    (lambda: tpipe.make_plan(8, 4, batch=0), ValueError),
    (lambda: tpipe.make_plan(8, 4, method="xms"), ValueError),
    (lambda: tpipe.make_plan(8, 4, backend="pallas"), ValueError),
    (lambda: tpipe.make_plan(8, 4, mode="sorted"), ValueError),
    (lambda: tpipe.make_plan(8, 4, mode="counts_only", key_value=True), ValueError),
    (lambda: tpipe.make_plan(8, 4, family="dense"), ValueError),
    (lambda: ops.multisplit(np.zeros(8, np.int64), ops.DeltaSpec(4), backend="cuda", device="cpu"),
     ValueError),
    (lambda: ops.multisplit(np.zeros((2, 4), np.int32), ops.DeltaSpec(4), device="cpu"), ValueError),
    (lambda: ops.radix_sort(np.zeros(4, np.float32), backend="vmap", device="cpu"), TypeError),
    (lambda: ops.radix_sort(np.zeros((2, 2, 4), np.uint32), device="cpu"), ValueError),
])
def test_refusals(call, err):
    with pytest.raises(err):
        call()


def test_default_device_is_the_card():
    """No device argument means CUDA; without a card the call fails rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        ops.multisplit(np.arange(10, dtype=np.uint32), ops.DeltaSpec(4))


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


fresh_process = _fresh_process.started(
    "import sys, repro_torch.ops, repro_torch.convert, repro_torch.kernels.build, "
    "repro_torch.runtime, repro_torch.serving, repro_torch.launch.serve; "
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
    "assert not bad, bad; print('clean')")


def test_importing_the_port_loads_no_jax(fresh_process):
    rc, out, err = _fresh_process.finished(fresh_process)
    assert rc == 0 and out.strip() == "clean", err


def test_chip_smoke_fails_without_a_card(tmp_path, capsys):
    """No CUDA device: non-zero exit and no result line, both from the
    repository and from a directory that holds the script alone."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = ROOT / "chip_smoke.py"
    assert runpy.run_path(str(script), run_name="chip_smoke")["main"]() != 0
    assert '"ok"' not in capsys.readouterr().out
    shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
