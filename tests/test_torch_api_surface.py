"""The port's public surface against the JAX package's.

Every module of ``src/repro/`` that has a twin under ``src/repro_torch/``
(the same path) is imported with its twin. Each public name of the JAX
module (its ``__all__``, else the names it defines or takes from the
package, not from JAX or numpy) must exist in the twin, or be listed below:
against the queue item of ``ROADMAP.md`` that brings it, or as having no
port by design, with the reason. A listed name that the twin has after all
fails too, so the lists stay true. The ``ops`` entry points and
``set_autotune`` keep the JAX signatures, less the TPU knobs
(``use_pallas``, ``interpret``), plus ``device=``, on the ``cuda`` backend
by default."""

import importlib
import inspect
import types
from pathlib import Path

import pytest

import repro
import repro_torch

SRC = Path(repro.__file__).resolve().parent

# name -> the ROADMAP queue item that brings it
PENDING = {}

_TPU_HELPER = ("a TPU workaround inside the Pallas bodies (one-hot MXU matmuls, 128-lane "
               "padding, VMEM budgets); the Hopper kernels do not need it")
_CPU_ERA = ("a constant measured on a CPU host with jnp, which is not the port's default "
            "(tiles.py, spec.py)")
# name -> why the port has none
NO_PORT = {
    "repro.kernels.common": {name: _TPU_HELPER for name in (
        "pad_lanes", "one_hot_f32", "cumsum_mxu", "exclusive_starts_mxu", "permutation_matrix",
        "select_columns", "pick_row_32", "rank_plane_pack16", "fused_postscan_body",
        "fused2_vmem_bytes", "permute_matmul_32")},
    "repro.kernels.ops": {"resolve_interpret": "picks Pallas interpret mode; the port has no "
                                               "interpret mode"},
    "repro.core.pipeline": {"VMAP_FUSION_MAX_BUCKETS": _CPU_ERA},
    "repro.core.pipeline.spec": {"VMAP_FUSION_MAX_BUCKETS": _CPU_ERA},
    "repro.core.pipeline.tiles": {"PACKED_MIN_BUCKETS": _CPU_ERA},
}
# ``*_pallas``: the Pallas functions themselves, mapped to their Hopper
# kernels by tests/test_torch_kernel_doors.py (ROADMAP A15)
PALLAS_SUFFIX = "_pallas"


def _twins():
    root = Path(repro_torch.__file__).resolve().parent
    out = []
    for path in SRC.rglob("*.py"):
        rel = path.relative_to(SRC).with_suffix("")
        if (root / rel).with_suffix(".py").exists():
            parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
            out.append(".".join(("repro",) + parts))
    return sorted(out)


TWINS = _twins()


def _public(mod: types.ModuleType):
    """``__all__``, else the public names the module defines (a package: or
    takes from its own modules); constants count, imports from elsewhere do
    not."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return list(names)
    own = (mod.__name__ + ".") if hasattr(mod, "__path__") else None
    out = []
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        origin = getattr(value, "__module__", None)
        if origin is None and not callable(value) or origin == mod.__name__ or (
                own and origin and origin.startswith(own)):
            out.append(name)
    return out


def test_the_twins_cover_the_ported_modules():
    for name in ("repro.ops", "repro.core.pipeline.autotune", "repro.models.moe",
                 "repro.data.pipeline", "repro.data", "repro.core.multisplit",
                 "repro.runtime", "repro.runtime.resilience", "repro.runtime.supervisor",
                 "repro.serving", "repro.serving.engine", "repro.serving.admission",
                 "repro.launch.serve", "repro.core.distributed", "repro.configs",
                 "repro.configs.base", "repro.configs.dbrx_132b", "repro.parallel.sharding",
                 "repro.models.layers", "repro.models.model", "repro.models.ssm",
                 "repro.models.xlstm", "repro.launch.mesh", "repro.launch.steps"):
        assert name in TWINS


@pytest.mark.parametrize("name", TWINS)
def test_every_public_name_has_a_port_or_a_listed_reason(name):
    mod = importlib.import_module(name)
    twin = importlib.import_module("repro_torch" + name[len("repro"):])
    pending, no_port = PENDING.get(name, {}), NO_PORT.get(name, {})
    missing = []
    for attr in _public(mod):
        has = hasattr(twin, attr)
        if attr in pending or attr in no_port:
            assert not has, f"{name}.{attr} is listed as missing but the port has it"
        elif attr.endswith(PALLAS_SUFFIX):
            assert not has
        elif not has:
            missing.append(attr)
    assert not missing, f"{twin.__name__} lacks {missing}"
    for attr in list(pending) + list(no_port):
        assert attr in _public(mod), f"{name}.{attr} is listed but is not public there"


def test_the_pending_items_are_open_in_the_roadmap():
    roadmap = (SRC.parents[1] / "ROADMAP.md").read_text()
    for items in PENDING.values():
        for item in set(items.values()):
            assert f"**{item}." in roadmap


@pytest.mark.parametrize("attr", ["BucketIdentifier", "set_autotune", "segment_ids_from_starts",
                                  "tile_local_offsets", "available_backends", "resolve_backend",
                                  "route_tokens_segmented", "direct_solve_reference"])
def test_the_names_this_slice_ports(attr):
    """The names the JAX package exports and the port lacked, each where the
    JAX package keeps it."""
    where = {
        "BucketIdentifier": ["repro.ops", "repro.core.identifiers"],
        "set_autotune": ["repro.ops", "repro.core.pipeline", "repro.core.pipeline.autotune"],
        "segment_ids_from_starts": ["repro.core.multisplit", "repro.core.pipeline"],
        "tile_local_offsets": ["repro.core.multisplit", "repro.core.pipeline.stages"],
        "available_backends": ["repro.core.pipeline", "repro.core.plan"],
        "resolve_backend": ["repro.core.pipeline", "repro.core.pipeline.registry"],
        "route_tokens_segmented": ["repro.models.moe"],
        "direct_solve_reference": ["repro.core.pipeline", "repro.core.pipeline.stages"],
    }[attr]
    for name in where:
        assert attr in _public(importlib.import_module(name))
        assert hasattr(importlib.import_module("repro_torch" + name[len("repro"):]), attr)


def test_bucket_identifier_is_a_callable_spec():
    from repro_torch import ops

    spec = ops.BucketIdentifier(lambda k: k % 3, 3, "mod3")
    assert isinstance(spec, ops.CallableSpec) and not spec.fusable
    assert (spec.num_buckets, spec.name) == (3, "mod3")


def test_backend_resolution():
    from repro_torch.core import pipeline as tp

    assert tp.resolve_backend() == "cuda"
    assert tp.resolve_backend("vmap") == "vmap"
    with pytest.raises(ValueError, match="unknown backend"):
        tp.resolve_backend("pallas")
    assert tuple(b.name for b in tp.available_backends()) == tp.backend_names() == tp.BACKENDS
    assert "use_pallas" not in inspect.signature(tp.resolve_backend).parameters


ENTRY_POINTS = ["multisplit", "multisplit_key_value", "segmented_multisplit", "histogram",
                "radix_sort", "segmented_radix_sort", "set_autotune"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_signatures(name):
    import repro.ops as jops
    from repro_torch import ops

    def params(fn, drop=()):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]

    want = params(getattr(jops, name), ("interpret", "use_pallas"))
    if name != "set_autotune":
        want = [(n, k, "cuda" if n == "backend" else d) for n, k, d in want]
        want.append(("device", inspect.Parameter.KEYWORD_ONLY, "cuda"))
    assert params(getattr(ops, name)) == want


def test_stage_graph_and_fusion_records():
    from repro_torch.core import pipeline as tp
    from repro_torch.core.identifiers import DeltaSpec

    plan = tp.make_plan(100, 4, bucket_fn=DeltaSpec(4, 100), segments=3, backend="vmap")
    graph = plan.stage_graph()
    assert all(isinstance(s, tp.Stage) for s in graph)
    assert [f"{s.name}:{s.impl}" for s in graph] == list(plan.stages())
    assert tp.fusion_decisions() == {k: tp.fusion_decision(*k) for k in tp.fusion_decisions()}
