"""Kernel-door coverage: every Pallas function of the JAX package has its
Hopper kernel, and every JAX kernel door its door in the port.

* Each function of ``src/repro/kernels/*.py`` that calls ``pl.pallas_call``
  is claimed by exactly one wrapper in ``repro_torch.kernels.PALLAS_TWIN``,
  at the line of its ``def``; the ``radix_pass.py`` functions, which reach
  the call through ``multisplit_tile``, map to the wrapper their port
  delegates to.
* Each wrapper of ``repro_torch.kernels.KERNELS`` has its plain version
  beside it, a door in ``repro_torch/kernels/ops.py`` and a test that calls
  it.
* Each public function of ``src/repro/kernels/ops.py`` has a same-named
  door in the port with the same parameters, less the two that choose how
  a TPU runs a kernel body (``interpret``, ``oblivious``); the flat radix
  doors are held against the JAX doors bitwise.

The sources are read with ``ast``, so adding a Pallas function or a door
without its counterpart fails here."""

import ast
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jkops
import repro_torch.kernels as kernels
from repro_torch.core.pipeline.stages import global_scan
from repro_torch.kernels import PALLAS_TWIN
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import multisplit_tile as mst
from repro_torch.kernels import ops as tkops

ROOT = Path(__file__).resolve().parents[1]
JAX_KERNELS = ROOT / "src" / "repro" / "kernels"
PORT_KERNELS = ROOT / "src" / "repro_torch" / "kernels"
TPU_ONLY = ("interpret", "oblivious")
# the JAX door module's helpers that pick a TPU lowering, not kernels
TPU_HELPERS = ("_tpu_available", "resolve_interpret")


def _functions(path: Path):
    return [n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef)]


def _calls(fn: ast.FunctionDef, owner: str):
    """Names of the ``owner.<name>`` attributes that ``fn`` calls."""
    return [c.func.attr for c in ast.walk(fn) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Attribute) and isinstance(c.func.value, ast.Name)
            and c.func.value.id == owner]


def _pallas_functions():
    found = []
    for path in sorted(JAX_KERNELS.glob("*.py")):
        for fn in ast.walk(ast.parse(path.read_text())):
            if isinstance(fn, ast.FunctionDef) and "pallas_call" in _calls(fn, "pl"):
                found.append(f"{path.name}:{fn.lineno}:{fn.name}")
    return found


def _params(fn: ast.FunctionDef):
    """(name, positional or keyword, default source) of each parameter,
    less the TPU-only ones."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, "positional", d) for p, d in zip(pos, defaults)]
    out += [(p.arg, "keyword", d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return [(name, kind, None if d is None else ast.unparse(d))
            for name, kind, d in out if name not in TPU_ONLY]


PALLAS = _pallas_functions()
WRAPPERS = [f"{fn.__module__.rsplit('.', 1)[1]}.{fn.__name__}" for fn in kernels.KERNELS]
RADIX_PASS = [fn.name for fn in _functions(JAX_KERNELS / "radix_pass.py")]
JAX_DOORS = {fn.name: fn for fn in _functions(JAX_KERNELS / "ops.py")
             if not fn.name.startswith("_") and fn.name not in TPU_HELPERS}
PORT_DOORS = {fn.name: fn for fn in _functions(PORT_KERNELS / "ops.py")}
PORT_TESTS = {p: p.read_text() for p in sorted((ROOT / "tests").glob("test_torch_*.py"))
              if p.name != Path(__file__).name}


def _wrapper(qualified: str):
    mod, name = qualified.split(".")
    return importlib.import_module(f"repro_torch.kernels.{mod}"), name


def test_twins_and_wrappers_match_one_to_one():
    assert sorted(PALLAS_TWIN.values()) == sorted(PALLAS)
    assert sorted(PALLAS_TWIN) == sorted(WRAPPERS)


@pytest.mark.parametrize("pallas", PALLAS)
def test_every_pallas_function_is_claimed_once(pallas):
    claims = [w for w, twin in PALLAS_TWIN.items() if twin == pallas]
    assert len(claims) == 1, (pallas, claims)
    mod, name = _wrapper(claims[0])
    assert getattr(mod, name) in kernels.KERNELS
    file, line, _ = pallas.split(":")
    assert kernels.replaces(name) == f"src/repro/kernels/{file}:{line}"


@pytest.mark.parametrize("name", RADIX_PASS)
def test_radix_pass_functions_map_to_the_wrapper_they_delegate_to(name):
    jax_fn = next(fn for fn in _functions(JAX_KERNELS / "radix_pass.py") if fn.name == name)
    (target,) = _calls(jax_fn, "_mst")
    port_name = name.removesuffix("_pallas")
    port_fn = next(fn for fn in _functions(PORT_KERNELS / "radix_pass.py")
                   if fn.name == port_name)
    (wrapper,) = _calls(port_fn, "_mst")
    file, _, twin = PALLAS_TWIN[f"multisplit_tile.{wrapper}"].split(":")
    assert (file, twin) == ("multisplit_tile.py", target)


@pytest.mark.parametrize("qualified", WRAPPERS)
def test_kernel_has_its_plain_version_door_and_test(qualified):
    mod, name = _wrapper(qualified)
    assert callable(getattr(mod, f"{name}_plain", None)), f"{qualified} has no {name}_plain"
    assert isinstance(getattr(mod, name).launches, int)
    door = PORT_DOORS.get(name)
    assert door is not None and name in _calls(door, {mst: "_mst", fa: "_fa"}[mod]), \
        f"repro_torch/kernels/ops.py has no door {name} onto {qualified}"
    call = re.compile(rf"\.{name}(_plain)?\(")
    assert any(call.search(text) for text in PORT_TESTS.values()), \
        f"no tests/test_torch_*.py calls {name} or {name}_plain"


@pytest.mark.parametrize("name", sorted(JAX_DOORS))
def test_every_jax_door_has_its_port_door(name):
    assert name in PORT_DOORS, f"repro_torch/kernels/ops.py has no door {name}"
    assert _params(PORT_DOORS[name]) == _params(JAX_DOORS[name])
    assert callable(getattr(tkops, name))


@pytest.mark.parametrize("key_value", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("shift,bits", [(4, 4), (8, 8)])
def test_flat_radix_doors_vs_jax(shift, bits, key_value):
    rng = np.random.default_rng(bits + key_value)
    keys = rng.integers(0, 2**32, (2, 256), dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(-(2**31), 2**31, (2, 256), dtype=np.int64).astype(np.int32)
    t_keys = torch.from_numpy(keys)
    t_vals = torch.from_numpy(vals) if key_value else None

    hist = tkops.radix_tile_histograms(t_keys, shift, bits)
    np.testing.assert_array_equal(
        hist.numpy(), np.asarray(jkops.radix_tile_histograms(jnp.asarray(keys), shift, bits)))
    g = global_scan(hist)
    j_g = jnp.asarray(g.numpy())
    np.testing.assert_array_equal(
        tkops.radix_tile_positions(t_keys, g, shift, bits).numpy(),
        np.asarray(jkops.radix_tile_positions(jnp.asarray(keys), j_g, shift, bits)))
    got = tkops.radix_fused_postscan_reorder(t_keys, g, t_vals, shift, bits)
    want = jkops.radix_fused_postscan_reorder(jnp.asarray(keys), j_g,
                                              jnp.asarray(vals) if key_value else None,
                                              shift, bits)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))
