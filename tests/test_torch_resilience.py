"""The port's resilience layer (``repro_torch/runtime``) against the JAX
package's ``repro.runtime`` (``tests/test_resilience.py``): the failure
taxonomy on the JAX table and on the port's CUDA surfaces, the seeded fault
injector, chaos at ``dispatch_rate=0.05`` against ``repro.ops`` without
faults, the ladder rung by rung (``cuda -> vmap -> reference``, tile
shrink, transient retries, context-fatal errors, the breaker and its
quarantine sidecar), strict mode, runtime verification, the capability
summary, and the functorch bypass.

Everything runs on the CPU, where the ``cuda`` backend's kernel wrappers run
their plain versions. Every sidecar lives under ``tmp_path``, and the
port's counters, injector and settings are reset around each test."""

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ops as jops
from repro.core.pipeline import autotune as jat
from repro.runtime import resilience as jrz
from repro.runtime.supervisor import FaultInjector as JaxFaultInjector
from repro_torch import ops
from repro_torch.core.identifiers import EvenSpec
from repro_torch.core.pipeline import autotune as at
from repro_torch.core.pipeline import clear_tile_cache, get_backend, set_autotune, tiles
from repro_torch.kernels import build
from repro_torch.models import moe
from repro_torch.runtime import FaultInjector
from repro_torch.runtime import resilience as rz

import _torch_threads

_torch_threads.pin()

N = 1024
M = 8
FAULT_RATE = 0.05
CSRC = Path(build.__file__).resolve().parent / "csrc"


def _spec(m=M):
    return EvenSpec(0.0, float(1 << 20), m)


def _keys(n=N, seed=0):
    return np.random.RandomState(seed).randint(0, 1 << 20, n).astype(np.uint32)


@pytest.fixture(autouse=True)
def iso(tmp_path, monkeypatch):
    """A throwaway autotune / quarantine directory for both packages, clean
    counters, no injector, default strict, fallback and verify."""
    monkeypatch.delenv("REPRO_FALLBACK", raising=False)
    rz.set_fallback(None)
    prev, jprev = at._CONFIG, jat._CONFIG
    set_autotune(cache_dir=str(tmp_path))
    jat.set_autotune(cache_dir=str(tmp_path / "jax"))
    for mod in (rz, jrz):
        mod.clear_quarantine(disk=True)
        mod.reset_stats()
        mod.set_fault_injector(None)
        mod.set_strict(None)
        mod.set_verify(None)
    clear_tile_cache()
    yield tmp_path
    rz.set_fallback(None)
    for mod in (rz, jrz):
        mod.set_fault_injector(None)
        mod.set_strict(None)
        mod.set_verify(None)
        mod.clear_quarantine(disk=True)
        mod.reset_stats()
    at._CONFIG, jat._CONFIG = prev, jprev
    at._LOADED = jat._LOADED = None
    clear_tile_cache()


def _same(got, want):
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g).view(np.asarray(w).dtype),
                                          np.asarray(w), err_msg=field)


# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------

JAX_TABLE = [
    RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating VMEM scratch"),
    MemoryError("oom"),
    RuntimeError("Mosaic lowering failed: unsupported primitive"),
    NotImplementedError("no kernel for this"),
    RuntimeError("UNAVAILABLE: transient backend interruption"),
    RuntimeError("DEADLINE_EXCEEDED: preempted"),
    RuntimeError("something else entirely"),
    OSError("device file vanished"),
    ValueError("keys must be rank-1"),
    TypeError("expected a BucketSpec"),
    KeyError("nope"),
    ValueError("mosaic lowering rejected op"),
    RuntimeError("boom"),
    RuntimeError("OOM on device 0"),
    RuntimeError("failed allocating 4MiB"),
]


@pytest.mark.parametrize("exc", JAX_TABLE, ids=lambda e: f"{type(e).__name__}:{e}")
def test_classify_matches_the_jax_taxonomy(exc):
    want = jrz.classify(exc, backend="vmap")
    got = rz.classify(exc, backend="vmap", plan_class=("s", (N,)))
    assert (got is None) == (want is None)
    if got is not None:
        assert type(got).__name__ == type(want).__name__
        assert got.original is exc and got.__cause__ is exc and got.backend == "vmap"
        assert got.transient == want.transient


CUDA_TABLE = [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     rz.KernelResourceError),
    (build.KernelBuildError("nvcc not found"), rz.KernelLoweringError),
    (build.KernelLaunchError("tile_histograms", 2), rz.KernelResourceError),
    (build.KernelLaunchError("tile_histograms", 701), rz.KernelResourceError),
    (build.KernelLaunchError("tile_histograms", 1, smem_refused=True), rz.KernelResourceError),
    (build.KernelLaunchError("tile_histograms", 1), rz.KernelDispatchError),
    (build.KernelLaunchError("tile_histograms", 98), rz.KernelLoweringError),
    (build.KernelLaunchError("tile_histograms", 209), rz.KernelLoweringError),
    (build.KernelLaunchError("tile_histograms", 700), rz.KernelContextError),
    (build.KernelLaunchError("tile_histograms", 714), rz.KernelContextError),
    (build.KernelLaunchError("tile_histograms", 715), rz.KernelContextError),
    (build.KernelLaunchError("tile_histograms", 716), rz.KernelContextError),
    (build.KernelLaunchError("tile_histograms", 719), rz.KernelContextError),
    (build.KernelLaunchError("tile_histograms", 700, smem_refused=True), rz.KernelContextError),
    # a kernel with no image fails its shared-memory set-up too: still lowering
    (build.KernelLaunchError("tile_histograms", 209, smem_refused=True), rz.KernelLoweringError),
    (build.KernelLaunchError("tile_histograms", 98, smem_refused=True), rz.KernelLoweringError),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     rz.KernelContextError),
    (RuntimeError("CUDA error: unspecified launch failure"), rz.KernelContextError),
]


@pytest.mark.parametrize("exc,cls", CUDA_TABLE, ids=lambda x: str(x)[:60])
def test_classify_the_cuda_surfaces(exc, cls):
    err = rz.classify(exc, backend="cuda")
    assert type(err) is cls
    assert err.original is exc and not err.transient


@pytest.mark.parametrize("err,code,name,refused", [
    (2, 2, "cudaErrorMemoryAllocation", False),
    (700, 700, "cudaErrorIllegalAddress", False),
    (build.SMEM_REFUSED | 1, 1, "cudaErrorInvalidValue", True),
    (4242, 4242, "cudaError 4242", False),
])
def test_raise_on_reads_the_code_and_the_shared_memory_flag(err, code, name, refused):
    with pytest.raises(build.KernelLaunchError) as info:
        build.raise_on(err, "tile_positions")
    exc = info.value
    assert (exc.code, exc.name, exc.smem_refused) == (code, name, refused)
    assert f"CUDA error {code} ({name})" in str(exc)
    build.raise_on(0, "tile_positions")


def test_every_shared_memory_request_flags_its_failure():
    """The launchers return ``smem_refused(err)`` right after every request
    of dynamic shared memory (allow_smem, pick_stages, a raw attribute
    set), both headers' flag is ``build.SMEM_REFUSED``, and it is set only
    on ``cudaErrorInvalidValue`` (a size above the card's limit): another
    code of that set-up passes unflagged."""
    for header in ("multisplit_common.cuh", "flash_attention_sm90.cuh"):
        text = (CSRC / header).read_text()
        flag = re.search(r"constexpr int kSmemRefused = 1 << (\d+);", text)
        assert flag and 1 << int(flag.group(1)) == build.SMEM_REFUSED
        body = re.search(r"inline int smem_refused\(cudaError_t err\) \{(.*?)\n\}", text, re.S)
        assert body and re.sub(r"\s+", " ", body.group(1)).strip() == (
            "return err == cudaErrorInvalidValue ? kSmemRefused | static_cast<int>(err) "
            ": static_cast<int>(err);")
    sites = 0
    for path in sorted(CSRC.glob("*.cu")) + [CSRC / "multisplit_fused2.cuh"]:
        text = path.read_text()
        for m in re.finditer(r"cudaError_t err = (ms::allow_smem|sm90::pick_stages|"
                             r"cudaFuncSetAttribute)\(", text):
            tail = text[m.end():].split(";", 1)[1]
            nxt = tail.lstrip().split("\n", 1)[0]
            assert re.fullmatch(r"if \(err != cudaSuccess\) return (ms|fa90)::smem_refused\(err\);",
                                nxt), f"{path.name}: {nxt}"
            sites += 1
    assert sites == 14


def test_a_library_that_does_not_load_is_a_build_error(monkeypatch, tmp_path):
    bad = tmp_path / "libtile_histograms.so"
    bad.write_text("not a library")
    monkeypatch.setattr(build, "_FNS", {})
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "build_all", lambda: {"tile_histograms": bad})
    with pytest.raises(build.KernelBuildError, match="cannot load") as info:
        build.load("tile_histograms")
    assert type(rz.classify(info.value)) is rz.KernelLoweringError


def test_demote_chain():
    err = rz.KernelLoweringError("x")
    assert rz.classify(err) is err
    chain, b = [], "cuda"
    while b is not None:
        chain.append(b)
        b = rz.demote(b)
    assert chain == list(rz.DEMOTION_ORDER) == ["cuda", "vmap", "reference"]
    assert rz.demote("pallas") == "reference"       # outside the chain: the oracle


# ---------------------------------------------------------------------------
# The fault injector: the JAX package's streams
# ---------------------------------------------------------------------------

def _pattern(check, calls):
    out = []
    for i in range(calls):
        try:
            check(i)
            out.append(None)
        except RuntimeError as e:
            out.append(type(rz.classify(e)).__name__)
    return out


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_fault_injector_draws_as_the_jax_injector(seed):
    kw = dict(rate=0.3, seed=seed, dispatch_rate=0.3)
    mine, theirs = FaultInjector(**kw), JaxFaultInjector(**kw)
    got = _pattern(lambda i: mine.check_dispatch("vmap"), 200)
    want = _pattern(lambda i: theirs.check_dispatch("vmap"), 200)
    assert got == want and sum(x is not None for x in got) > 20
    got = _pattern(mine.check, 200)
    want = _pattern(theirs.check, 200)
    assert [x is None for x in got] == [x is None for x in want]
    assert mine.injected == theirs.injected
    # the reference rung is exempt unless listed
    FaultInjector(dispatch_rate=0.999999).check_dispatch("reference")
    with pytest.raises(ValueError):
        FaultInjector(rate=1.0)
    with pytest.raises(ValueError):
        FaultInjector(dispatch_kinds=("bogus",))


# ---------------------------------------------------------------------------
# Chaos: the port's ops under injected dispatch faults against repro.ops on
# vmap without faults
# ---------------------------------------------------------------------------

SEG = np.asarray([0, 100, 100, 700], np.int32)        # with an empty segment


@pytest.fixture(scope="module")
def jax_want():
    keys, spec = _keys(), _spec()
    vals = np.arange(N, dtype=np.int32)
    return {
        "flat": jops.multisplit(jnp.asarray(keys), spec_j(), backend="vmap"),
        "kv": jops.multisplit_key_value(jnp.asarray(keys), jnp.asarray(vals), spec_j(),
                                        backend="vmap"),
        "seg": jops.segmented_multisplit(jnp.asarray(keys), spec_j(), SEG, backend="vmap"),
        "seg kv": jops.segmented_multisplit(jnp.asarray(keys), spec_j(), SEG, jnp.asarray(vals),
                                            backend="vmap"),
    }


def spec_j():
    from repro.core.identifiers import EvenSpec as JEvenSpec

    return JEvenSpec(0.0, float(1 << 20), M)


def _call(layout, backend):
    keys, spec = _keys(), _spec()
    vals = np.arange(N, dtype=np.int32)
    kw = dict(backend=backend, device="cpu")
    return {
        "flat": lambda: ops.multisplit(keys, spec, **kw),
        "kv": lambda: ops.multisplit_key_value(keys, vals, spec, **kw),
        "seg": lambda: ops.segmented_multisplit(keys, spec, SEG, **kw),
        "seg kv": lambda: ops.segmented_multisplit(keys, spec, SEG, vals, **kw),
    }[layout]


@pytest.mark.parametrize("backend", ["cuda", "vmap"])
@pytest.mark.parametrize("layout", ["flat", "kv", "seg", "seg kv"])
def test_chaos_is_bitwise_the_jax_ops_without_faults(jax_want, layout, backend):
    call = _call(layout, backend)
    inj = FaultInjector(dispatch_rate=FAULT_RATE, seed=3)
    rz.set_fault_injector(inj)
    for _ in range(12):
        _same(call(), jax_want[layout])
    rz.set_fault_injector(None)
    assert rz.stats()["verify_mismatches"] == 0


def test_chaos_injects_and_heals():
    """A seed whose stream fires: every kind reaches the ladder, which
    retries, shrinks or demotes, and every result stays bitwise right."""
    want = ops.multisplit(_keys(), _spec(), backend="reference", device="cpu")
    inj = FaultInjector(dispatch_rate=0.5, seed=1)
    rz.set_fault_injector(inj)
    for _ in range(20):
        _same(ops.multisplit(_keys(), _spec(), device="cpu"), want)
    s = rz.stats()
    assert inj.dispatch_injected > 5
    assert s["transient_retries"] and s["tile_shrinks"] and s["backend_demotions"]


def test_chaos_with_verify2_never_mismatches():
    want = ops.multisplit(_keys(seed=11), _spec(), backend="reference", device="cpu")
    ops.set_verify(2)
    rz.set_fault_injector(FaultInjector(dispatch_rate=FAULT_RATE, seed=13))
    for _ in range(8):
        _same(ops.multisplit(_keys(seed=11), _spec(), device="cpu"), want)
    assert rz.stats()["verify_mismatches"] == 0 and rz.stats()["verify_checks"] > 0


# ---------------------------------------------------------------------------
# The ladder, rung by rung
# ---------------------------------------------------------------------------

def _ctx(**kw):
    base = dict(spec_name="even", shape=(N,), num_buckets=M, device="cpu")
    base.update(kw)
    return rz.DispatchContext(**base)


def _always(msg, on=("cuda",)):
    def run(backend, tile):
        if backend in on:
            raise RuntimeError(msg)
        return backend
    return run


def test_demotion_order_respected():
    attempts = []

    def run(backend, tile):
        attempts.append(backend)
        if backend != "reference":
            raise build.KernelBuildError("nvcc refused the source")
        return "ok"

    assert rz.dispatch(run, _ctx(), backend="cuda") == "ok"
    assert attempts == ["cuda", "vmap", "reference"]
    s = rz.stats()
    assert s["backend_demotions"] == 2 and s["degradations"] == 2


def test_resource_error_halves_tile_and_pins_survivor():
    tried, pinned = [], []

    def run(backend, tile):
        tried.append((backend, tile))
        if tile is None or tile > 512:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return "ok"

    out = rz.dispatch(run, _ctx(), backend="cuda", resolved_tile=lambda b: 2048,
                      pin_tile=lambda b, t: pinned.append((b, t)))
    assert out == "ok"
    assert tried == [("cuda", None), ("cuda", 1024), ("cuda", 512)]
    assert pinned == [("cuda", 512)]
    assert rz.stats()["tile_shrinks"] == 2 and rz.stats()["backend_demotions"] == 0


def test_resource_error_demotes_below_min_tile():
    def run(backend, tile):
        if backend == "cuda":
            raise build.KernelLaunchError("tile_histograms", 1, smem_refused=True)
        return backend

    assert rz.dispatch(run, _ctx(), backend="cuda", resolved_tile=lambda b: 512) == "vmap"
    assert rz.stats()["tile_shrinks"] == 1 and rz.stats()["backend_demotions"] == 1


def test_invalid_value_without_the_flag_demotes_without_shrinking():
    run = lambda b, t: (_ for _ in ()).throw(build.KernelLaunchError("k", 1)) \
        if b == "cuda" else b                                        # noqa: E731
    assert rz.dispatch(run, _ctx(), backend="cuda", resolved_tile=lambda b: 4096) == "vmap"
    assert rz.stats()["tile_shrinks"] == 0 and rz.stats()["backend_demotions"] == 1


def test_transient_retries_in_place_then_demotes():
    calls = {"cuda": 0}

    def run(backend, tile):
        if backend == "cuda":
            calls["cuda"] += 1
            raise RuntimeError("UNAVAILABLE: transient link flap")
        return backend

    assert rz.dispatch(run, _ctx(), backend="cuda") == "vmap"
    assert calls["cuda"] == 1 + rz.MAX_TRANSIENT_RETRIES
    assert rz.stats()["transient_retries"] == rz.MAX_TRANSIENT_RETRIES


def test_transient_recovery_no_demotion():
    calls = {"n": 0}

    def run(backend, tile):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("UNAVAILABLE: preempted")
        return backend

    assert rz.dispatch(run, _ctx(), backend="cuda") == "cuda"
    assert rz.stats()["backend_demotions"] == 0


@pytest.mark.parametrize("exc", [build.KernelLaunchError("tile_positions", 700),
                                 RuntimeError("CUDA error: an illegal memory access was "
                                              "encountered")])
def test_a_context_fatal_error_strikes_its_rung_and_reraises(exc):
    """A sticky CUDA error: no demotion onto the dead context, one strike on
    the rung that raised it, the original re-raised; the breaker trips at
    the threshold like any persistent failure."""
    attempts = []

    def run(backend, tile):
        attempts.append(backend)
        raise exc

    ctx = _ctx()
    key = rz.class_key(ctx.plan_class(), "cuda", "cpu")
    for i in range(rz.BREAKER_THRESHOLD):
        with pytest.raises(type(exc)) as info:
            rz.dispatch(run, ctx, backend="cuda", resolved_tile=lambda b: 4096)
        assert info.value is exc
    assert attempts == ["cuda"] * rz.BREAKER_THRESHOLD
    assert rz.breaker_strikes() == {key: rz.BREAKER_THRESHOLD}
    assert rz.is_quarantined(key)
    assert rz.class_key(ctx.plan_class(), "vmap", "cpu") not in rz.quarantine_snapshot()
    s = rz.stats()
    assert s["breaker_trips"] == 1
    assert s["backend_demotions"] == s["tile_shrinks"] == s["degradations"] == 0


def test_programming_error_propagates_on_every_rung():
    def run(backend, tile):
        raise ValueError("keys must be rank-1")

    with pytest.raises(ValueError, match="rank-1"):
        rz.dispatch(run, _ctx(), backend="cuda")
    assert rz.stats()["degradations"] == 0


def test_reference_failure_propagates():
    with pytest.raises(RuntimeError):
        rz.dispatch(_always("nvcc failed", on=("reference",)), _ctx(), backend="reference")


# ---------------------------------------------------------------------------
# On the card: no demotion, no quarantine, unless the caller opts in
# ---------------------------------------------------------------------------

def test_fallback_defaults_to_off_on_the_card_and_on_for_the_cpu(monkeypatch):
    assert not rz.fallback("cuda") and not rz.fallback("cuda:0")
    assert not rz.fallback(torch.device("cuda", 0))
    assert rz.fallback("cpu") and rz.fallback(None)
    monkeypatch.setenv("REPRO_FALLBACK", "1")
    assert rz.fallback("cuda") and rz.fallback("cpu")
    monkeypatch.setenv("REPRO_FALLBACK", "0")
    assert not rz.fallback("cuda") and not rz.fallback("cpu")
    rz.set_fallback(True)                        # the setter beats the variable
    assert rz.fallback("cuda")
    rz.set_fallback(None)
    assert not rz.fallback("cuda")
    assert ops.set_fallback is rz.set_fallback


@pytest.mark.parametrize("exc", [
    build.KernelBuildError("nvcc refused the source"),
    build.KernelLaunchError("tile_histograms", 209),
    build.KernelLaunchError("tile_histograms", 1),
    RuntimeError("something else entirely"),
], ids=lambda x: str(x)[:40])
def test_on_the_card_a_persistent_failure_reraises_without_demoting(exc):
    """A dispatch whose tensors lie on the card stays on its kernels: the
    original error comes back, nothing runs on vmap or reference, and no
    strike or quarantine entry is kept, however often it fails."""
    attempts = []

    def run(backend, tile):
        attempts.append(backend)
        if backend == "cuda":
            raise exc
        return backend

    for _ in range(rz.BREAKER_THRESHOLD + 1):
        with pytest.raises(type(exc)) as info:
            rz.dispatch(run, _ctx(device="cuda:0"), backend="cuda")
        assert info.value is exc
    assert attempts == ["cuda"] * (rz.BREAKER_THRESHOLD + 1)
    assert not rz.breaker_strikes() and not rz.quarantine_snapshot()
    assert not rz.quarantine_path().exists()
    s = rz.stats()
    assert s["backend_demotions"] == s["degradations"] == s["breaker_trips"] == 0


def test_on_the_card_a_resource_error_shrinks_then_reraises():
    """The out-of-memory ladder on the card: halve the tile down to the
    smallest, then re-raise the out-of-memory; no demotion, no quarantine."""
    tried = []

    def run(backend, tile):
        tried.append((backend, tile))
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(torch.OutOfMemoryError):
        rz.dispatch(run, _ctx(device="cuda:0"), backend="cuda", resolved_tile=lambda b: 1024)
    assert tried == [("cuda", None), ("cuda", 512), ("cuda", 256)]
    assert tiles._MIN_TILE == 256
    s = rz.stats()
    assert s["tile_shrinks"] == 2 and s["backend_demotions"] == 0
    assert not rz.quarantine_snapshot() and not rz.quarantine_path().exists()
    # a survivor is pinned, as on the CPU: the shrink keeps the kernel
    pinned = []
    out = rz.dispatch(lambda b, t: (_ for _ in ()).throw(torch.OutOfMemoryError("CUDA out of "
                                                                                "memory"))
                      if t is None or t > 512 else (b, t), _ctx(device="cuda:0"),
                      backend="cuda", resolved_tile=lambda b: 1024,
                      pin_tile=lambda b, t: pinned.append((b, t)))
    assert out == ("cuda", 512) and pinned == [("cuda", 512)]


def test_on_the_card_transients_retry_then_reraise():
    calls = []

    def run(backend, tile):
        calls.append(backend)
        raise RuntimeError("UNAVAILABLE: transient link flap")

    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        rz.dispatch(run, _ctx(device="cuda:0"), backend="cuda")
    assert calls == ["cuda"] * (1 + rz.MAX_TRANSIENT_RETRIES)
    assert rz.stats()["transient_retries"] == rz.MAX_TRANSIENT_RETRIES
    assert rz.stats()["backend_demotions"] == 0


def test_on_the_card_a_verify_mismatch_is_reported_and_raised():
    rz.set_verify(1)
    ran = []

    def run(backend, tile):
        ran.append(backend)
        return backend

    def verifier(result, backend):
        raise rz.KernelResultError("counts conservation")

    with pytest.raises(rz.KernelResultError):
        rz.dispatch(run, _ctx(device="cuda:0"), backend="cuda", verifier=verifier)
    assert ran == ["cuda"]
    s = rz.stats()
    assert s["verify_mismatches"] == 1 and s["reference_reruns"] == 0
    assert rz.last_report()["backend"] == "cuda" and not rz.quarantine_snapshot()


def test_on_the_card_an_existing_quarantine_is_not_read(monkeypatch):
    """A quarantine that an opted-in run wrote does not demote a later
    default run on the card."""
    monkeypatch.setitem(at._FINGERPRINTS, ("cuda", 0), "x86_64-cuda-NVIDIA_H100-sm90")
    ctx = _ctx(device="cuda:0")
    rz.set_fallback(True)
    for _ in range(rz.BREAKER_THRESHOLD):
        assert rz.dispatch(_lowering, ctx, backend="cuda") == "vmap"
    key = rz.class_key(ctx.plan_class(), "cuda", "cuda:0")
    assert rz.is_quarantined(key) and rz.quarantine_path().exists()
    rz.set_fallback(None)
    ran = []

    def healthy(backend, tile):
        ran.append(backend)
        return backend

    assert rz.dispatch(healthy, ctx, backend="cuda") == "cuda"
    assert ran == ["cuda"] and rz.stats()["quarantine_skips"] == 0


def test_on_the_card_opting_in_demotes_as_the_jax_ladder(monkeypatch):
    monkeypatch.setitem(at._FINGERPRINTS, ("cuda", 0), "x86_64-cuda-NVIDIA_H100-sm90")
    monkeypatch.setenv("REPRO_FALLBACK", "1")
    attempts = []

    def run(backend, tile):
        attempts.append(backend)
        if backend != "reference":
            raise build.KernelBuildError("nvcc refused the source")
        return "ok"

    assert rz.dispatch(run, _ctx(device="cuda:0"), backend="cuda") == "ok"
    assert attempts == ["cuda", "vmap", "reference"]
    assert rz.stats()["backend_demotions"] == 2


# ---------------------------------------------------------------------------
# Circuit breaker + persistent quarantine
# ---------------------------------------------------------------------------

_lowering = _always("CUDA kernel build failed: nvcc refused the source")


def test_breaker_trips_after_threshold_then_skips_statically():
    ctx = _ctx()
    for _ in range(rz.BREAKER_THRESHOLD):
        assert rz.dispatch(_lowering, ctx, backend="cuda") == "vmap"
    assert rz.stats()["breaker_trips"] == 1 and rz.stats()["quarantine_skips"] == 0
    attempts = []

    def spy(backend, tile):
        attempts.append(backend)
        return _lowering(backend, tile)

    assert rz.dispatch(spy, ctx, backend="cuda") == "vmap"
    assert attempts == ["vmap"]
    assert rz.stats()["quarantine_skips"] == 1


def test_breaker_keys_are_per_plan_class_and_per_device(monkeypatch):
    for _ in range(rz.BREAKER_THRESHOLD):
        rz.dispatch(_lowering, _ctx(), backend="cuda")
    hit = rz.class_key(_ctx().plan_class(), "cuda", "cpu")
    assert rz.is_quarantined(hit)
    assert not rz.is_quarantined(rz.class_key(_ctx(shape=(2 * N,)).plan_class(), "cuda", "cpu"))
    # a card's fingerprint keys its own quarantine: the CPU's does not apply
    monkeypatch.setitem(at._FINGERPRINTS, ("cuda", 0), "x86_64-cuda-NVIDIA_H100-sm90")
    card = rz.class_key(_ctx().plan_class(), "cuda", "cuda:0")
    assert card != hit and "H100" in card and at.host_fingerprint("cpu") in hit
    assert not rz.is_quarantined(card)


def test_quarantine_survives_clear_tile_cache_roundtrip(iso):
    ctx = _ctx()
    for _ in range(rz.BREAKER_THRESHOLD):
        rz.dispatch(_lowering, ctx, backend="cuda")
    key = rz.class_key(ctx.plan_class(), "cuda", "cpu")
    path = rz.quarantine_path()
    assert path == iso / "multisplit_resilience_torch.json"
    raw = json.loads(path.read_text())
    assert raw["version"] == rz.SCHEMA_VERSION and key in raw["entries"]
    clear_tile_cache()                          # memory dropped, disk kept
    assert not rz.breaker_strikes()
    assert rz.is_quarantined(key) and key in rz.quarantine_snapshot()
    clear_tile_cache(disk=True)                 # the file deleted too
    assert not rz.is_quarantined(key)
    assert not path.exists()
    # the pipeline layer reaches the quarantine only through on_clear
    source = Path(tiles.__file__).read_text()
    assert "repro_torch.runtime" not in source and "_rz" not in source


def test_quarantine_corrupt_file_loads_empty_and_unwritable_dir_stays_in_memory(iso):
    rz.quarantine_path().write_text("{not json")
    rz.drop_loaded()
    assert rz.quarantine_snapshot() == {}
    blocker = iso / "a_file"
    blocker.write_text("")
    set_autotune(cache_dir=str(blocker / "sub"))
    rz.drop_loaded()
    rz.quarantine("some|key", "reason")          # must not raise
    assert rz.is_quarantined("some|key")
    assert not (blocker / "sub").exists()


# ---------------------------------------------------------------------------
# Strict mode
# ---------------------------------------------------------------------------

def test_strict_reraises_original():
    ops.set_strict(True)
    boom = build.KernelBuildError("nvcc refused the source")

    def run(backend, tile):
        raise boom

    with pytest.raises(build.KernelBuildError) as info:
        rz.dispatch(run, _ctx(), backend="cuda")
    assert info.value is boom and rz.stats()["degradations"] == 0


def test_strict_env_var(monkeypatch):
    monkeypatch.setenv("REPRO_STRICT", "1")
    rz.set_strict(None)
    assert rz.strict()
    with pytest.raises(torch.OutOfMemoryError):
        rz.dispatch(lambda b, t: (_ for _ in ()).throw(torch.OutOfMemoryError("CUDA out of "
                                                                              "memory")),
                    _ctx(), backend="cuda", resolved_tile=lambda b: 2048)


def test_strict_facade_reraises_injected_fault():
    ops.multisplit(_keys(), _spec(), device="cpu")            # warm the plan cache
    ops.set_strict(True)
    inj = FaultInjector(dispatch_rate=0.999999, seed=0)
    rz.set_fault_injector(inj)
    with pytest.raises(RuntimeError, match="injected dispatch fault"):
        ops.multisplit(_keys(), _spec(), device="cpu")
    assert inj.dispatch_injected == 1


def test_ops_resource_error_shrinks_the_tile_and_pins_it(monkeypatch):
    """A launcher that refuses its shared memory above tiles of 1024 keys:
    the cuda rung halves its tile 4096 -> 1024 (two strikes, below the
    breaker's threshold), pins it, and the next call takes the pinned tile
    at once."""
    stages = get_backend("cuda").stages
    real = type(stages).prescan
    tiles_seen = []

    def prescan(self, spec, keys_tiled, ids_tiled, seg_tiled):
        tiles_seen.append(keys_tiled.shape[1])
        if keys_tiled.shape[1] > 1024:
            raise build.KernelLaunchError("tile_histograms", 1, smem_refused=True)
        return real(self, spec, keys_tiled, ids_tiled, seg_tiled)

    monkeypatch.setattr(type(stages), "prescan", prescan)
    keys = _keys(4096)
    want = ops.multisplit(keys, _spec(), backend="reference", device="cpu")
    _same(ops.multisplit(keys, _spec(), device="cpu"), want)
    assert tiles_seen == [4096, 2048, 1024]
    assert tiles.tile_decision(4096, M, "bms", False, "cuda") == (1024,
                                                                   "pinned by pin_tile (1024)")
    assert rz.stats()["tile_shrinks"] == 2 and rz.stats()["backend_demotions"] == 0
    _same(ops.multisplit(keys, _spec(), device="cpu"), want)
    assert tiles_seen[3:] == [1024] and rz.stats()["tile_shrinks"] == 2


# ---------------------------------------------------------------------------
# Runtime verification
# ---------------------------------------------------------------------------

def _tampered(res, field, fn):
    """``res`` with ``fn`` applied in place to a copy of one field (on its
    int32 bit pattern: torch has no CPU index_put for uint32)."""
    t = getattr(res, field)
    bits = t.view(torch.int32).clone() if t.dtype == torch.uint32 else t.clone()
    fn(bits)
    return res._replace(**{field: bits.view(t.dtype)})


def _flip(t):
    return t.view(torch.int32).flip(0).view(t.dtype)


def _both_raise(port_res, jax_res, level, match=None, **kw):
    """The same tampering raises in both packages."""
    keys = _keys()
    with pytest.raises(rz.KernelResultError, match=match):
        rz.verify_result(port_res, keys=torch.from_numpy(keys), spec=_spec(), n=N, level=level,
                         **kw)
    jkw = {k: (jnp.asarray(np.asarray(v)) if k in ("segment_starts", "values") else v)
           for k, v in kw.items()}
    jres = jax_res._replace(**{f: jnp.asarray(np.asarray(getattr(port_res, f)))
                               for f in port_res._fields if getattr(port_res, f) is not None})
    with pytest.raises(jrz.KernelResultError, match=match):
        jrz.verify_result(jres, keys=jnp.asarray(keys), spec=spec_j(), n=N, level=level, **jkw)


def test_verify_level1_catches_count_tampering(jax_want):
    good = ops.multisplit(_keys(), _spec(), device="cpu")
    rz.verify_result(good, keys=torch.from_numpy(_keys()), spec=_spec(), n=N, level=2)
    bad = _tampered(good, "bucket_counts", lambda t: t.__setitem__(0, t[0] + 1))
    _both_raise(bad, jax_want["flat"], 1, "conservation")
    bad = _tampered(good, "bucket_starts", lambda t: t.__setitem__(-1, t[-1] - 1))
    _both_raise(bad, jax_want["flat"], 1, "monotonicity")


def test_verify_level2_catches_key_value_and_perm_tampering(jax_want):
    vals = np.arange(N, dtype=np.int32)
    good = ops.multisplit_key_value(_keys(), vals, _spec(), device="cpu")
    kw = dict(values=torch.from_numpy(vals))
    rz.verify_result(good, keys=torch.from_numpy(_keys()), spec=_spec(), n=N, level=2, **kw)

    def swap(t):
        t[[0, -1]] = t[[-1, 0]]

    _both_raise(_tampered(good, "keys", swap), jax_want["kv"], 2, **kw)
    _both_raise(_tampered(good, "permutation", lambda t: t.__setitem__(0, t[1])),
                jax_want["kv"], 2, "permutation", **kw)
    _both_raise(_tampered(good, "values", swap), jax_want["kv"], 2, "values", **kw)


def test_verify_segmented_segment_local_invariants(jax_want):
    good = ops.segmented_multisplit(_keys(), _spec(), SEG, device="cpu")
    seg = torch.from_numpy(SEG)
    rz.verify_result(good, keys=torch.from_numpy(_keys()), spec=_spec(), n=N,
                     segment_starts=seg, level=2)
    bad = _tampered(good, "bucket_counts", lambda t: t.__setitem__((1, 0), t[1, 0] + 1))
    _both_raise(bad, jax_want["seg"], 1, "segment", segment_starts=seg)
    # a permutation that crosses a segment boundary: not segment-local
    bad = _tampered(good, "permutation", lambda t: t.__setitem__(150, 650))
    _both_raise(bad, jax_want["seg"], 2, "segment", segment_starts=seg)


def test_verify2_recovers_a_lying_backend_through_reference(monkeypatch):
    want = ops.multisplit(_keys(), _spec(), backend="reference", device="cpu")
    real = ops._result

    def lying(plan, outs):
        res = real(plan, outs)
        return res if plan.backend == "reference" else res._replace(keys=_flip(res.keys))

    monkeypatch.setattr(ops, "_result", lying)
    ops.set_verify(2)
    _same(ops.multisplit(_keys(), _spec(), device="cpu"), want)
    s = rz.stats()
    assert s["verify_mismatches"] == 1 and s["reference_reruns"] == 1
    report = rz.last_report()
    assert report["backend"] == "cuda" and report["shape"] == (N,)
    assert report["spec"] == _spec().name and report["num_buckets"] == M


def test_verify_strict_raises_instead_of_recovering():
    ops.set_strict(True)
    ops.set_verify(2)

    def run(backend, tile):
        r = ops.multisplit(_keys(), _spec(), backend="reference", device="cpu")
        return r._replace(keys=_flip(r.keys))

    def verifier(result, backend):
        rz.verify_result(result, keys=torch.from_numpy(_keys()), spec=_spec(), n=N,
                         backend=backend)

    with pytest.raises(rz.KernelResultError):
        rz.dispatch(run, _ctx(), backend="vmap", verifier=verifier)


def test_verify_routing_invariants():
    ids = np.random.RandomState(0).randint(0, 4, 64).astype(np.int32)
    starts = np.asarray([0, 16, 48], np.int32)
    out = moe.route_tokens_segmented(ids, starts, 4, 8, device="cpu")
    rz.verify_routing(out, ids, starts, 4, 8, level=2)
    slot, keep, counts = out
    bad = counts.clone()
    bad[0, 0] += 1
    with pytest.raises(rz.KernelResultError, match="conservation"):
        rz.verify_routing((slot, keep, bad), ids, starts, 4, 8, level=1)
    bad_keep = keep.clone()
    bad_keep[int(torch.nonzero(bad_keep)[0])] = False
    with pytest.raises(rz.KernelResultError, match="kept token count"):
        rz.verify_routing((slot, bad_keep, counts), ids, starts, 4, 8, level=2)
    bad_slot = slot.clone()
    kept = torch.nonzero(keep).flatten()
    bad_slot[kept[1]] = bad_slot[kept[0]]
    with pytest.raises(rz.KernelResultError, match="collide"):
        rz.verify_routing((bad_slot, keep, counts), ids, starts, 4, 8, level=2)


def test_set_verify_validation_and_env(monkeypatch):
    with pytest.raises(ValueError):
        ops.set_verify(3)
    ops.set_verify(2)
    assert rz.verify_level() == 2
    ops.set_verify(None)
    for raw, level in (("2", 2), ("true", 1), ("garbage", 0)):
        monkeypatch.setenv("REPRO_VERIFY", raw)
        assert rz.verify_level() == level


# ---------------------------------------------------------------------------
# Registry summary and the functorch bypass
# ---------------------------------------------------------------------------

def test_capability_summary_has_the_jax_keys():
    from repro.core.pipeline.registry import capability_summary as jsummary
    from repro_torch.core.pipeline.registry import capability_summary

    ops.set_verify(1)
    s, j = capability_summary(), jsummary()
    assert set(s) == set(j) and set(s["resilience"]) == set(j["resilience"])
    assert set(s["resilience"]["counters"]) == set(j["resilience"]["counters"])
    assert set(s["backends"]) == {"reference", "vmap", "cuda"}
    for entry in s["backends"].values():
        assert set(entry) == set(j["backends"]["vmap"])
    assert s["backends"]["cuda"]["demotes_to"] == "vmap"
    assert s["backends"]["reference"]["demotes_to"] is None
    r = s["resilience"]
    assert r["verify"] == 1 and r["strict"] is False
    assert tuple(r["demotion_order"]) == rz.DEMOTION_ORDER


def test_torch_vmap_and_grad_bypass_the_ladder():
    """Functorch-wrapped inputs see the plain op: an injector that fires at
    every dispatch under strict mode never fires."""
    rng = np.random.RandomState(1)
    keys = torch.from_numpy(rng.randint(0, 1 << 20, (4, 256)).astype(np.int32))
    vals = torch.from_numpy(rng.randn(4, 256).astype(np.float32))
    want = [ops.multisplit_key_value(keys[r], vals[r], _spec(), device="cpu") for r in range(4)]
    ops.set_strict(True)
    inj = FaultInjector(dispatch_rate=0.999999, seed=0)
    rz.set_fault_injector(inj)
    got = torch.vmap(ops.multisplit_key_value, in_dims=(0, 0, None))(keys, vals, _spec(),
                                                                     device="cpu")
    for r in range(4):
        assert torch.equal(got.keys[r], want[r].keys) and torch.equal(got.values[r],
                                                                      want[r].values)

    def loss(v, k):
        return (ops.multisplit_key_value(k, v, _spec(), device="cpu").values ** 2).sum()

    grad = torch.func.grad(loss)(vals[0], keys[0])
    assert torch.equal(grad, 2 * vals[0])
    assert inj.dispatch_injected == 0


def test_bypass_runs_the_plain_op():
    """Inside ``bypass()`` (the serving loop's launches) an op runs without
    the ladder: no fault check, no verification; the ladder is back after."""
    want = ops.multisplit(_keys(), _spec(), device="cpu")
    ops.set_strict(True)
    ops.set_verify(2)
    inj = FaultInjector(dispatch_rate=0.999999, seed=0)
    rz.set_fault_injector(inj)
    with rz.bypass():
        with rz.bypass():
            _same(ops.multisplit(_keys(), _spec(), device="cpu"), want)
        assert rz.bypassed()
        _same(ops.multisplit(_keys(), _spec(), device="cpu"), want)
    assert not rz.bypassed()
    assert inj.dispatch_injected == 0 and rz.stats()["verify_checks"] == 0
    with pytest.raises(RuntimeError, match="injected dispatch fault"):
        ops.multisplit(_keys(), _spec(), device="cpu")
