"""The port's dry-run and its accounting (``repro_torch.launch.input_specs``,
``hlo_analysis`` and ``dryrun``) against the JAX package's on the CPU.

* The abstract inputs of every arch × shape cell: the same keys, shapes and
  dtypes as JAX's ``ShapeDtypeStruct`` s.
* The pure functions of the config (``parallel_config``, ``train_config``,
  ``active_param_count``, ``model_flops_estimate``): equal to JAX's.
* ``roofline_terms`` and ``dominant_term`` with the H100 constants.
* The kernel doors on ``FakeTensor`` s: no launch, the contract's shapes and
  dtypes, and their formulas' work reported to the counting mode.
* A dense ``smoke()`` config traced on fake process groups of 1 and 2
  ranks: per-device flops against one process's, collectives, argument
  bytes.
* ``lower_cell`` on both production meshes (256 and 512 fake ranks) for a
  dense and a MoE ``smoke()`` cell.

The fake process group is global to its process, so each test that needs
one starts and ends it itself. ``repro.launch.dryrun`` sets ``XLA_FLAGS``
(512 host devices) at import: it is imported with the variable saved and
restored, so later JAX tests in this worker see the default device count.
"""

import contextlib
import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.launch import hlo_analysis as jha
from repro.launch import input_specs as jis
from repro.models import model as JM
import repro_torch.kernels as registry
from repro_torch.configs import get_config
from repro_torch.core.identifiers import IdentitySpec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import multisplit_tile as mst
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import hlo_analysis as tha
from repro_torch.launch import input_specs as tis
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as ts

import _torch_threads

_torch_threads.pin()


def _jax_dryrun():
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdr


jdr = _jax_dryrun()

MESH_AXES = {"single": ((16, 16), ("data", "model")),
             "multi": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in this process (rank 0),
    ended on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized(), "a process group is already running in this process"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# (a) input specs, (b) the pure functions, (c) the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    jc, tc = jget_config(arch), get_config(arch)
    for shape in tis.SHAPES:
        assert tis.SHAPES[shape] == jis.SHAPES[shape]
        assert tis.shape_applicable(tc, shape) == jis.shape_applicable(jc, shape)
        want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(jis.input_specs(jc, shape))]
        got = [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in ts.tree_leaves_with_path(tis.input_specs(tc, shape))]
        assert got == want, shape
        assert all(x.device.type == "meta" for x in ts.tree_leaves(tis.input_specs(tc, shape)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_functions_match_jax(arch):
    jc, tc = jget_config(arch), get_config(arch)
    jd, td = JM.decl_model(jc), TM.decl_model(tc)
    n = ts.param_count(td)
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jd, is_leaf=lambda x: hasattr(x, "axes")))
    for shape_, names in MESH_AXES.values():
        want = jdr.parallel_config(jc, AbstractMesh(shape_, names), n)
        got = tdr.parallel_config(tc, types.SimpleNamespace(mesh_dim_names=names), n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(tdr.train_config(n)) == dataclasses.asdict(jdr.train_config(n))
    assert tdr.active_param_count(tc, td) == jdr.active_param_count(jc, jd)
    for shape in tis.SHAPES:
        assert tdr.model_flops_estimate(tc, td, shape) == jdr.model_flops_estimate(jc, jd, shape)
    assert (tdr.FSDP_THRESHOLD, tdr.BF16_MOMENTS_THRESHOLD) == (jdr.FSDP_THRESHOLD,
                                                               jdr.BF16_MOMENTS_THRESHOLD)


def test_roofline_terms_and_dominant_with_h100_constants():
    assert (tha.PEAK_FLOPS, tha.HBM_BW, tha.ICI_BW) == (989e12, 3.35e12, 50e9)
    assert tha.COLLECTIVES == jha.COLLECTIVES
    terms = tha.roofline_terms(
        flops=256 * tha.PEAK_FLOPS,          # exactly 1 s of compute on 256 chips
        bytes_accessed=256 * tha.HBM_BW * 2,  # 2 s of HBM
        collective_bytes=256 * tha.ICI_BW * 0.5,
        n_chips=256,
    )
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(2.0)
    assert terms["collective_s"] == pytest.approx(0.5)
    assert tha.dominant_term(terms) == "memory"
    assert tha.dominant_term(dict(terms, compute_s=3.0)) == "compute"


# ---------------------------------------------------------------------------
# (d) the doors on fake tensors, and their reports
# ---------------------------------------------------------------------------

def _door_calls(q, k, v, keys, g, spec):
    o = kops.flash_attention(q, k, v, causal=True)
    h = mst.spec_tile_histograms(keys, spec)
    p = mst.spec_tile_positions(keys, g, spec)
    return o, h, p


def test_doors_on_fake_tensors_launch_nothing_and_report_their_formulas():
    bh, s, hd, n_tiles, t, m = 6, 512, 64, 8, 4096, 16
    spec = IdentitySpec(m)
    before = registry.launch_counts()
    with FakeTensorMode():
        q, k, v = (torch.empty((bh, s, hd), dtype=torch.bfloat16) for _ in range(3))
        keys = torch.empty((n_tiles, t), dtype=torch.int32)
        g = torch.empty((n_tiles, m), dtype=torch.int32)
        for counted in (False, True):
            with tha.CountingMode() if counted else contextlib.nullcontext() as c:
                o, h, p = _door_calls(q, k, v, keys, g, spec)
            assert all(isinstance(x, FakeTensor) for x in (o, h, p))
            assert (o.shape, o.dtype) == (q.shape, torch.bfloat16)
            assert (h.shape, h.dtype) == ((n_tiles, m), torch.int32)
            assert (p.shape, p.dtype) == ((n_tiles, t), torch.int32)
        b11_flops = 4 * hd * bh * s * (s + 1) // 2
        assert c.door_work == {
            "flash_attention": {"calls": 1, "flops": b11_flops, "bytes": 4 * bh * s * hd * 2},
            "spec_tile_histograms": {"calls": 1, "flops": 0, "bytes": 4 * n_tiles * (t + m)},
            "spec_tile_positions": {"calls": 1, "flops": 0,
                                    "bytes": 4 * n_tiles * (2 * t + m)},
        }
        # the doors' own allocations and nothing else: their work is the formulas'
        assert (c.flops, c.bytes) == (b11_flops, sum(r["bytes"] for r in c.door_work.values()))
    assert registry.launch_counts() == before


def test_doors_on_real_tensors_count_their_work_once():
    """Under a counting mode a real CPU call runs the plain version, gives
    its result, and counts the formula's work, not the plain version's
    ops; without a mode nothing is counted and the result is the same."""
    g_ = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 256, 32), generator=g_) for _ in range(3))
    keys = torch.randint(0, 8, (4, 256), dtype=torch.int32, generator=g_)
    spec = IdentitySpec(8)
    g = torch.zeros((4, 8), dtype=torch.int32)
    plain = (fa.flash_attention_plain(q, k, v, True), mst.spec_tile_histograms_plain(keys, spec),
             mst.spec_tile_positions_plain(keys, g, spec))
    with tha.CountingMode() as c:
        got = _door_calls(q, k, v, keys, g, spec)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert c.flops == fa.work(q, True)[0] == 4 * 32 * 2 * 256 * 257 // 2
    assert sorted(c.door_work) == ["flash_attention", "spec_tile_histograms",
                                   "spec_tile_positions"]
    assert all(r["calls"] == 1 for r in c.door_work.values())


# ---------------------------------------------------------------------------
# (e) a dense smoke config traced exactly on small fake worlds
# ---------------------------------------------------------------------------

B, SEQ = 4, 64


@pytest.fixture(scope="module")
def smoke_runs():
    """tinyllama's smoke config at one layer: train and prefill steps of
    4 × 64 traced in one process and on (1, 1), (2, 1) and (1, 2) (data,
    model) worlds;
    with each world's expected argument bytes (the local slices of the
    state, or params, and the batch, by the JAX rule's shardings)."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").smoke(), n_layers=1)
    decls = TM.decl_model(cfg)
    runs = {("one", kind): tdr.trace_step(cfg, kind, B, SEQ, None, device="cpu")
            for kind in ("train", "prefill")}
    for shape in ((1, 1), (2, 1), (1, 2)):
        with fake_world(shape[0] * shape[1]):
            mesh = _mesh(shape)
            pcfg = tdr.ParallelConfig(dp_axes=("data",))
            p_sh = ts.decl_to_sharding(decls, pcfg, mesh)

            def local(shape_, sh):
                sl = ts.local_slices(shape_, sh) if mesh.size() > 1 else ()
                return int(np.prod([x.stop - x.start for x in sl] or shape_))

            p_bytes = sum(4 * local(d.shape, sh) for d, sh in
                          zip(ts.tree_leaves(decls), ts.tree_leaves(p_sh)))
            tok = 4 * local((B, SEQ), ts.NamedSharding(mesh, ts.P("data", None)))
            for kind in ("train", "prefill"):
                r = tdr.trace_step(cfg, kind, B, SEQ, mesh, device="cpu")
                # train: params, mu and nu (float32), the step, tokens and labels
                r["want_args"] = (3 * p_bytes + 4 + 2 * tok if kind == "train"
                                  else p_bytes + tok)
                runs[(shape, kind)] = r
    runs["param_bytes"] = 4 * ts.param_count(decls)
    runs["loss_chunks"] = -(-SEQ // cfg.loss_chunk)
    return runs


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_one_device_mesh_counts_one_process(smoke_runs, kind):
    one, r = smoke_runs[("one", kind)], smoke_runs[((1, 1), kind)]
    assert r["flops"] == one["flops"] > 0
    assert r["bytes"] == one["bytes"]
    assert r["collectives"] == {} == one["collectives"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_data_parallel_halves_every_device_s_flops(smoke_runs, kind):
    one, r = smoke_runs[("one", kind)], smoke_runs[((2, 1), kind)]
    assert 2 * r["flops"] == one["flops"]
    assert 2 * r["door_work"]["flash_attention"]["flops"] == \
        one["door_work"]["flash_attention"]["flops"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_tensor_parallel_halves_the_projections_and_attention(smoke_runs, kind):
    """On (1, 2) the heads, the MLP width and the vocab divide over
    ``model``: every matmul of the smoke step is a projection, the head or
    the attention door, so each device's flops are half one process's, and
    so are the door's."""
    one, r = smoke_runs[("one", kind)], smoke_runs[((1, 2), kind)]
    assert 2 * r["flops"] == one["flops"]
    assert 2 * r["door_work"]["flash_attention"]["flops"] == \
        one["door_work"]["flash_attention"]["flops"]
    assert r["collectives"]["all-reduce"]["count"] > 0


def test_data_parallel_train_step_all_reduces_the_gradients_and_the_loss_terms(smoke_runs):
    """On (2, 1) the train step's only collectives are all-reduces: every
    float32 gradient (replicated parameters), and per loss chunk the
    chunk's summed negative log-likelihood (float32) and its count of
    labelled tokens (int32)."""
    r = smoke_runs[((2, 1), "train")]
    assert set(r["collectives"]) == {"all-reduce"}
    want = smoke_runs["param_bytes"] + smoke_runs["loss_chunks"] * (4 + 4)
    assert r["collectives"]["all-reduce"]["operand_bytes"] == want


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_are_the_local_slices(smoke_runs, shape, kind):
    r = smoke_runs[(shape, kind)]
    assert r["memory"]["argument_size_in_bytes"] == r["want_args"]
    assert r["memory"]["peak_size_in_bytes"] >= r["memory"]["argument_size_in_bytes"]


# ---------------------------------------------------------------------------
# The sLSTM time loop, counted from its fit
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _loop_not_fitted(counts):
    yield {"calls": 0}


@pytest.mark.parametrize("shape,kind", [(None, "prefill"), ((1, 2), "train")])
def test_the_fitted_slstm_loop_counts_what_the_loop_does(shape, kind, monkeypatch):
    """xlstm's smoke step (one mLSTM and one sLSTM block) over 8 tokens,
    traced with its sLSTM time loop counted from the fit (lengths 2-4,
    checked at 5) and with the loop run step by step: the same flops,
    bytes and collectives. A prefill in one process; a train step, forward
    and backward (under remat, whose recompute runs the loop again), with
    the mLSTM heads split over a (1, 2) world (the gates reach the loop in
    another memory layout there)."""
    cfg = dataclasses.replace(get_config("xlstm-350m").smoke(), n_layers=2)   # mLSTM, sLSTM
    with fake_world(2) if shape else contextlib.nullcontext():
        mesh = _mesh(shape) if shape else None
        fitted = tdr.trace_step(cfg, kind, 1, 8, mesh, device="cpu")
        monkeypatch.setattr(tdr, "_fitted_slstm_loop", _loop_not_fitted)
        real = tdr.trace_step(cfg, kind, 1, 8, mesh, device="cpu")
    n_slstm = cfg.n_layers // cfg.slstm_every
    assert fitted["loop_fitted"]["calls"] == n_slstm * (2 if kind == "train" else 1)
    assert real["loop_fitted"] == {}
    for key in ("flops", "bytes", "collectives"):
        assert fitted[key] == real[key], key
    assert fitted["memory"]["argument_size_in_bytes"] == real["memory"]["argument_size_in_bytes"]


def test_the_fit_is_exact_beyond_a_double_s_precision():
    """Counts at 524288 steps pass 2^53; the fit stays exact."""
    big = lambda x: 3 * 2 ** 40 * x * x + 7 * x + 5
    assert tdr._at((2, 3, 4), [big(2), big(3), big(4)], 524288) == big(524288)
    assert tdr._at((2, 3, 4), [5, 7, 9], 10) == 21


# ---------------------------------------------------------------------------
# The torch internals the counting relies on
# ---------------------------------------------------------------------------

def test_the_torch_internals_the_counting_relies_on_exist():
    """The counting mode pauses in DTensor's global-shape propagation
    (``ShardingPropagator._propagate_tensor_meta*``) and puts DTensor's own
    methods back when the outermost mode exits; the dry-run keeps DTensor's
    propagation cache on under a fake mode by swapping
    ``_sharding_prop._are_we_tracing``, which ``propagate`` must read."""
    from torch.distributed.tensor import _sharding_prop
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if hasattr(ShardingPropagator, n)]
    assert names
    assert callable(_sharding_prop._are_we_tracing)
    assert "_are_we_tracing" in ShardingPropagator.propagate.__code__.co_names
    own = {n: getattr(ShardingPropagator, n) for n in names}
    with tha.CountingMode():
        assert all(getattr(ShardingPropagator, n) is not own[n] for n in names)
        with tha.CountingMode():
            pass
        assert all(getattr(ShardingPropagator, n) is not own[n] for n in names)
    assert all(getattr(ShardingPropagator, n) is own[n] for n in names)
    with tdr._cached_sharding_propagation():
        assert not _sharding_prop._are_we_tracing()


# ---------------------------------------------------------------------------
# (f) lower_cell on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "dbrx-132b"])
def test_lower_cell_smoke_on_the_production_meshes(arch, mesh_kind, monkeypatch):
    """A decode step of 128 rows over a 32768-position cache (``decode_32k``)
    of each smoke config; the MoE one routes through K1 and K3 on each
    rank's expert group."""
    monkeypatch.setattr(tdr, "get_config", lambda a: get_config(a).smoke())
    before = registry.launch_counts()
    rec = tdr.lower_cell(arch, "decode_32k", mesh_kind, device="cpu")
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["n_chips"] == (256 if mesh_kind == "single" else 512)
    assert rec["per_device"]["flops"] > 0 and rec["per_device"]["bytes"] > 0
    assert rec["hlo_flops"] == rec["per_device"]["flops"] * rec["n_chips"]
    assert rec["collective_bytes"] > 0 and rec["collectives_full_graph"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    if arch == "dbrx-132b":
        assert rec["dispatch"] == "multisplit_ep"
        assert set(rec["door_work"]) == {"spec_tile_histograms", "spec_tile_positions"}
    else:
        assert rec["door_work"] == {} and rec["dispatch"] is None
    assert registry.launch_counts() == before


def test_the_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this torch has CUDA: the default device traces")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdr.lower_cell("tinyllama-1.1b", "decode_32k", "single")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdr.main(["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "single"])
    assert not dist.is_initialized()
