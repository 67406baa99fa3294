"""The port's mesh layer (``repro_torch.launch.mesh``, the mesh half of
``parallel.sharding`` and the shardings of ``launch.steps``) against the JAX
package's on the CPU.

* ``spec_for_decl`` / ``decl_to_sharding`` for every config's
  ``decl_model`` on both production meshes, ``fsdp`` off and on; the train
  state's, a batch's and the decode caches' shardings. JAX's side runs on an
  ``AbstractMesh`` (no devices); the port's on ``DeviceMesh``es of a fake
  process group of 256 and 512 ranks (``torch.testing``'s ``FakeStore``).
  The fake group is global to its process, so each is started and ended
  inside one fixture, and the module leaves no group behind.
* The slice a rank holds: on a ``(2, 2, 2)`` ``(pod, data, model)`` mesh,
  for specs with multi-axis entries, each of 8 fake ranks' slice (the
  port's ``local_slices``, and the offset and shape DTensor derives from
  the placements) against JAX's ``devices_indices_map`` over 8 XLA host
  devices in one subprocess.
* ``place`` and ``init_params`` on a one-device mesh give plain tensors,
  and the launchers' mesh on one rank, under ``torchrun``'s environment
  (stubbed: the card bound to ``LOCAL_RANK``) and their MoE dispatch on a
  production mesh (``expert_parallel``).
"""

import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as ts

import _torch_threads

_torch_threads.pin()

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_BATCHES = (32, 1)                 # divides both meshes' data axes; does not


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks in this process, ended on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized(), "a process group is already running in this process"
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_specs(tree):
    """(path, tuple(PartitionSpec)) of a NamedSharding tree, JAX's order."""
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return [(jax.tree_util.keystr(p), tuple(s.spec)) for p, s in flat]


def _port_specs(tree):
    return [(p, tuple(s.spec)) for p, s in ts.tree_leaves_with_path(tree)]


def _pcfgs(names, fsdp):
    dp = tuple(a for a in names if a in ("pod", "data"))
    return JParallelConfig(fsdp=fsdp, dp_axes=dp), ParallelConfig(fsdp=fsdp, dp_axes=dp)


def _batch(b, s, meta):
    if meta:
        return {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
                "labels": torch.empty((b, s), dtype=torch.int32, device="meta")}
    return {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
            "labels": jax.ShapeDtypeStruct((b, s), jnp.int32)}


@pytest.fixture(scope="module")
def production():
    """Every spec tree on both production meshes, from both packages:
    mesh name -> {case: (JAX's, the port's)}, plus the port's meshes'
    shapes and data axes."""
    out = {}
    for name, (shape, names) in MESHES.items():
        amesh = AbstractMesh(shape, names)
        got = {}
        with fake_world(int(np.prod(shape))):
            mesh = tmesh.make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu")
            got["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names), tmesh.data_axes(mesh),
                           mesh.size())
            got["ep"] = {arch: tmesh.expert_parallel(get_config(arch), mesh).moe.dispatch
                         for arch in ARCH_IDS}
            for arch in ARCH_IDS:
                jc, tc = jget_config(arch), get_config(arch)
                jd, td = JM.decl_model(jc), TM.decl_model(tc)
                for fsdp in (False, True):
                    jp, tp = _pcfgs(names, fsdp)
                    got[(arch, "params", fsdp)] = (
                        _jax_specs(jsharding.decl_to_sharding(jd, jp, amesh)),
                        _port_specs(ts.decl_to_sharding(td, tp, mesh)))
                    leaves = ts.tree_leaves(td)
                    got[(arch, "spec_for_decl", fsdp)] = (
                        [tuple(jsharding.spec_for_decl(d, jp, amesh))
                         for d in jax.tree.leaves(jd, is_leaf=jsharding.is_decl)],
                        [tuple(ts.spec_for_decl(d, tp, mesh)) for d in leaves])
                for batch in CACHE_BATCHES:
                    got[(arch, "cache", batch)] = (
                        _jax_specs(jsteps.cache_shardings(jc, amesh, batch)),
                        _port_specs(tsteps.cache_shardings(tc, mesh, batch)))
            jd = JM.decl_model(jget_config("tinyllama-1.1b"))
            td = TM.decl_model(get_config("tinyllama-1.1b"))
            for dtype in ("float32", "bfloat16"):
                jp, tp = _pcfgs(names, False)
                got[("state", dtype)] = (
                    _jax_specs(jsteps.state_shardings(jd, jp, amesh,
                                                      JTrainConfig(params_dtype=dtype))),
                    _port_specs(tsteps.state_shardings(td, tp, mesh,
                                                       TrainConfig(params_dtype=dtype))))
            for b in (64, 1):
                got[("batch", b)] = (
                    _jax_specs(jsteps.batch_sharding(None, amesh, _batch(b, 128, False))),
                    _port_specs(tsteps.batch_sharding(None, mesh, _batch(b, 128, True))))
        out[name] = got
    return out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decl_to_sharding_equals_jax(production, arch, mesh, fsdp):
    want, got = production[mesh][(arch, "params", fsdp)]
    assert got == want
    want, got = production[mesh][(arch, "spec_for_decl", fsdp)]
    assert got == want
    if mesh == "pod2" and fsdp:
        assert any(("pod", "data") in spec for _, spec in production[mesh][(arch, "params",
                                                                             fsdp)][1])


@pytest.mark.parametrize("batch", CACHE_BATCHES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_jax(production, arch, mesh, batch):
    want, got = production[mesh][(arch, "cache", batch)]
    assert got == want and got


def test_cache_shardings_cover_every_block_kind():
    kinds = set()
    for arch in ARCH_IDS:
        pattern, _, tail = TM.block_pattern(get_config(arch))
        kinds |= set(pattern) | set(tail)
    assert kinds == {"attn", "attn_moe", "shared_attn", "cross", "mamba", "mlstm", "slstm"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_state_shardings_equal_jax(production, mesh, dtype):
    want, got = production[mesh][("state", dtype)]
    assert got == want
    has_master = any(p.startswith(".opt.master") for p, _ in got)
    assert has_master == (dtype == "bfloat16")


@pytest.mark.parametrize("batch", [64, 1])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_equals_jax(production, mesh, batch):
    want, got = production[mesh][("batch", batch)]
    assert got == want
    assert all(spec[0] is None for _, spec in got) == (batch == 1)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_production_mesh_on_the_fake_group(production, mesh):
    shape, names = MESHES[mesh]
    got_shape, got_names, dp, size = production[mesh]["mesh"]
    assert (got_shape, got_names, size) == (shape, names, int(np.prod(shape)))
    assert dp == tuple(a for a in names if a in ("pod", "data"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_parallel_takes_multisplit_on_a_model_axis(production, mesh):
    """The launchers' MoE dispatch on a production mesh: ``multisplit``
    runs as ``multisplit_ep`` (the experts stay sharded over ``model``),
    every other dispatch as configured."""
    for arch in ARCH_IDS:
        moe = get_config(arch).moe
        want = ("multisplit_ep" if moe.num_experts and moe.dispatch == "multisplit"
                else moe.dispatch)
        assert production[mesh]["ep"][arch] == want, arch
    assert "multisplit_ep" in production[mesh]["ep"].values()


def test_launch_mesh_binds_the_local_rank_under_torchrun(monkeypatch):
    """Under ``torchrun`` (``WORLD_SIZE`` and ``LOCAL_RANK`` set) a card
    device with no index is bound to the rank's ``LOCAL_RANK`` before the
    nccl group starts, and returned for the launcher's tensors; an indexed
    device and the host are left as given. The group and the mesh are
    stubs: the order of the calls is what is checked."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", torch.device(d))))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(("init", backend, kw)))
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setattr(tmesh, "make_host_mesh",
                        lambda **kw: calls.append(("host", kw["device_type"])) or "mesh")
    assert tmesh.launch_mesh("cuda") == ("mesh", True, torch.device("cuda", 3))
    assert calls == [("set_device", torch.device("cuda", 3)), ("init", "nccl", {}),
                     ("host", "cuda")]
    calls.clear()
    assert tmesh.launch_mesh("cuda:1")[2] == torch.device("cuda", 1)
    assert calls == [("init", "nccl", {}), ("host", "cuda")]
    calls.clear()
    assert tmesh.launch_mesh("cpu")[2] == torch.device("cpu")
    assert calls == [("init", "gloo", {}), ("host", "cpu")]


def test_placements_follow_the_spec():
    with fake_world(512):
        mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
        sh = ts.NamedSharding(mesh, ts.P(("pod", "data"), None, "model"))
        assert sh.placements == (ts.Shard(0), ts.Shard(0), ts.Shard(2))
        assert ts.NamedSharding(mesh, ts.P()).placements == (ts.Replicate(),) * 3
        with pytest.raises(ValueError, match="axis order"):
            ts.NamedSharding(mesh, ts.P(("data", "pod"))).placements


def test_constrain_and_tp_size_without_a_mesh():
    x = torch.ones(4, 4)
    assert ts.get_mesh() is None and ts.tp_size() == 1
    assert ts.constrain(x, "dp", "model") is x
    assert ts.settle(x) is x and ts.gather_full(x) is x


@pytest.fixture
def one_rank():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_host_mesh_on_one_rank(one_rank):
    mesh = tmesh.make_host_mesh(device_type="cpu")
    assert tuple(mesh.shape) == (1,) and tuple(mesh.mesh_dim_names) == ("data",)
    assert tmesh.data_axes(mesh) == ("data",)
    mesh2, started, device = tmesh.launch_mesh("cpu")
    assert not started and tuple(mesh2.shape) == (1,) and device == torch.device("cpu")
    cfg = get_config("dbrx-132b")
    assert tmesh.expert_parallel(cfg, mesh2) is cfg           # no model axis: as configured
    assert "mesh {'data': 1} over 1 rank(s), gloo on cpu" in tmesh.describe(mesh)


def test_place_on_one_device_gives_plain_tensors(one_rank):
    """On a one-device mesh every placement holds the whole tensor, so
    ``place`` and ``init_params(..., shardings=)`` return plain tensors —
    the one-card paths keep their host cost — with the bits of the
    unsharded draw."""
    mesh = tmesh.make_host_mesh(device_type="cpu")
    cfg = get_config("dbrx-132b").smoke()
    decls = TM.decl_model(cfg)
    sh = ts.decl_to_sharding(decls, ParallelConfig(), mesh)
    placed = ts.init_params(decls, torch.Generator().manual_seed(3), shardings=sh)
    plain = ts.init_params(decls, torch.Generator().manual_seed(3))
    for a, b in zip(ts.tree_leaves(placed), ts.tree_leaves(plain)):
        assert type(a) is torch.Tensor and torch.equal(a, b)
    again = ts.place(plain, sh)
    assert all(a is b for a, b in zip(ts.tree_leaves(again), ts.tree_leaves(plain)))
    with ts.set_mesh(mesh):
        assert ts.get_mesh() is mesh and ts.tp_size() == 1
    assert ts.get_mesh() is None


# ---------------------------------------------------------------------------
# the slice a rank holds, against JAX's devices_indices_map
# ---------------------------------------------------------------------------

SLICE_SHAPE = (8, 12, 4)
SLICE_SPECS = [(("pod", "data"), "model", None), ("model", ("pod", "data"), None),
               (None, "data", "model"), ("pod", None, "model"), (("pod", "data", "model"),),
               (("data", "model"), "pod", None), ()]

_JAX_SLICES = """
import json, jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {{}}
for i, spec in enumerate({specs}):
    sh = NamedSharding(mesh, P(*spec))
    idx = sh.devices_indices_map({shape})
    for coord in np.ndindex(2, 2, 2):
        d = mesh.devices[coord]
        out[f"{{i}}:{{coord}}"] = [[s.start or 0, {shape}[k] if s.stop is None else s.stop]
                                  for k, s in enumerate(idx[d])]
print(json.dumps(out))
"""


def test_local_slices_equal_jax_devices_indices_map():
    code = textwrap.dedent(_JAX_SLICES).format(specs=SLICE_SPECS, shape=SLICE_SHAPE)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    for rank in range(8):
        with fake_world(8, rank):
            mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
            coord = tuple(mesh.get_coordinate())
            assert coord == tuple(int(c) for c in np.unravel_index(rank, (2, 2, 2)))
            for i, spec in enumerate(SLICE_SPECS):
                sh = ts.NamedSharding(mesh, ts.P(*spec))
                got = [[s.start, s.stop] for s in ts.local_slices(SLICE_SHAPE, sh)]
                assert got == want[f"{i}:{coord}"], (spec, coord)
                shape, offset = compute_local_shape_and_global_offset(SLICE_SHAPE, mesh,
                                                                      sh.placements)
                assert [[o, o + n] for o, n in zip(offset, shape)] == got, (spec, coord)


@pytest.mark.parametrize("name", ["launch.mesh.make_production_mesh", "launch.mesh.data_axes",
                                  "launch.mesh.make_host_mesh",
                                  "parallel.sharding.spec_for_decl",
                                  "parallel.sharding.decl_to_sharding",
                                  "parallel.sharding.constrain", "parallel.sharding.tp_size",
                                  "launch.steps.state_shardings", "launch.steps.batch_sharding",
                                  "launch.steps._block_cache_spec",
                                  "launch.steps.cache_shardings"])
def test_signatures_are_jax_s(name):
    """The mesh layer keeps JAX's parameters, in order and with their
    defaults; the meshes add only a keyword-only ``device_type``."""
    import importlib
    import inspect

    mod, fn = name.rsplit(".", 1)
    want = inspect.signature(getattr(importlib.import_module("repro." + mod), fn)).parameters
    got = inspect.signature(getattr(importlib.import_module("repro_torch." + mod), fn)).parameters
    sig = lambda ps: [(p.name, p.kind, p.default) for p in ps.values()]
    assert sig(got)[:len(want)] == sig(want)
    extra = sig(got)[len(want):]
    assert extra in ([], [("device_type", inspect.Parameter.KEYWORD_ONLY, None)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_keeps_each_rank_its_slice(dtype):
    """``init_params(..., shardings=)`` on a (2, 2) mesh: every rank's leaf
    is bitwise its slice of the whole draw, and holds no more storage than
    the slice (a float32 slice left as a view would keep the whole draw)."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("dbrx-132b").smoke()
    decls = TM.decl_model(cfg)
    whole = ts.init_params(decls, torch.Generator().manual_seed(5), dtype)
    for rank in range(4):
        with fake_world(4, rank):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            sh = ts.decl_to_sharding(decls, ParallelConfig(), mesh)
            placed = ts.init_params(decls, torch.Generator().manual_seed(5), dtype, shardings=sh)
            for w, p, s in zip(ts.tree_leaves(whole), ts.tree_leaves(placed), ts.tree_leaves(sh)):
                local = p.to_local()
                assert torch.equal(local, w[ts.local_slices(w.shape, s)])
                assert local.untyped_storage().nbytes() == local.numel() * local.element_size()
                assert tuple(p.placements) == s.placements and tuple(p.shape) == tuple(w.shape)
