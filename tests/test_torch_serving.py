"""The port's continuous-batching serving (``repro_torch/serving``,
``repro_torch/launch/serve.py``) against the JAX package's
``repro.serving``, on the CPU.

The same request stream on the same fake clock goes through
``repro.serving.ServerLoop`` on ``vmap`` and the port's loop on
``device="cpu"`` (the ``cuda`` backend's plain versions): the step reports,
the packed buffers, the routing outputs, the batches and their order, and
the metrics summary must be the same. The config is small (E = 4, two token
classes of at most 256 tokens) so that JAX compiles little. The port alone
then mirrors ``tests/test_serving.py``: retries, requeues, failures,
shedding, degradation to ``reference``, strict mode, verification, config
checks, open-loop conservation, one routing call a step, warm plans, and
the ``--traffic`` launcher."""

import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.runtime import resilience as jrz
from repro_torch import ops
from repro_torch import serving as tserving
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.runtime import FaultInjector
from repro_torch.runtime import resilience as rz
from repro_torch.serving import (
    ServerLoop,
    ServingConfig,
    closed_loop,
    engine,
    open_loop,
    percentiles,
    poisson_arrivals,
    synthetic_requests,
)

E = 4
CLASSES = (64, 256)


def _cfg(**kw) -> ServingConfig:
    base = dict(num_experts=E, capacity=8, max_batch_requests=8, max_batch_tokens=256,
                token_pad_classes=CLASSES, max_wait=0.0, max_queue_depth=64, device="cpu")
    base.update(kw)
    return ServingConfig(**base)


def _reqs(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, E, size=n).astype(np.int32) for n in lengths]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


class AlwaysFail:
    def check(self, step):
        raise RuntimeError("boom")


class AlwaysKernelFault:
    """A persistent kernel failure the classifier recognizes (a CUDA
    out-of-memory): the step must degrade to reference, not requeue."""

    def check(self, step):
        raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("REPRO_FALLBACK", raising=False)
    rz.set_fallback(None)
    for mod in (rz, jrz):
        mod.reset_stats()
        mod.set_verify(None)
        mod.set_strict(None)
        mod.set_fault_injector(None)
    yield
    rz.set_fallback(None)
    for mod in (rz, jrz):
        mod.reset_stats()
        mod.set_verify(None)
        mod.set_strict(None)
        mod.set_fault_injector(None)


# ---------------------------------------------------------------------------
# The port against repro.serving on the same requests and clock
# ---------------------------------------------------------------------------

def _recorded(loop, step_attr):
    """Record every _pack buffer and routing output of ``loop``."""
    packs, outs = [], []
    pack, step = loop._pack, getattr(loop, step_attr)

    def pack_spy(batch):
        got = pack(batch)
        packs.append(got)
        return got

    def step_spy(ids, starts):
        out = step(ids, starts)
        outs.append(tuple(np.asarray(x) for x in out))
        return out

    loop._pack = pack_spy
    setattr(loop, step_attr, step_spy)
    return packs, outs


def _drive(mod, loop, clk, reqs, arrivals, reports):
    """``open_loop`` on a fake clock, the step reports kept."""
    step = loop.step

    def step_spy(force=False):
        rep = step(force=force)
        if rep is not None:
            reports.append(rep)
        clk.t += 1e-4
        return rep

    loop.step = step_spy
    return mod.open_loop(loop, reqs, arrivals, sleep=clk.sleep)


def test_the_port_serves_as_the_jax_loop():
    reqs = synthetic_requests(60, E, seed=5, mean_len=24, max_len=96)
    jreqs = jserving.synthetic_requests(60, E, seed=5, mean_len=24, max_len=96)
    assert all(np.array_equal(a, b) for a, b in zip(reqs, jreqs))
    arrivals = poisson_arrivals(60, 3000.0, seed=5)
    assert np.array_equal(arrivals, jserving.poisson_arrivals(60, 3000.0, seed=5))
    kw = dict(num_experts=E, capacity=8, max_batch_requests=8, max_batch_tokens=256,
              token_pad_classes=CLASSES, max_wait=0.002, max_queue_depth=64,
              length_splitters=(16, 48))
    results = []
    for mod, cfg, attr in ((jserving, jserving.ServingConfig(backend="vmap", **kw),
                            "_jit_step"),
                           (tserving, ServingConfig(device="cpu", **kw), "_step_fn")):
        clk = FakeClock()
        loop = mod.ServerLoop(cfg, clock=clk)
        packs, outs = _recorded(loop, attr)
        reports = []
        summary = _drive(mod, loop, clk, reqs, arrivals, reports)
        recs = [(r.step, r.requests, r.tokens, r.tokens_padded, r.queue_depth, r.wall_s,
                 r.attempts, r.ok) for r in loop.metrics.step_records]
        results.append((summary, reports, packs, outs, loop.completed, recs))
    (js, jrep, jpacks, jouts, jdone, jrecs), (ts, trep, tpacks, touts, tdone, trecs) = results
    assert trep == jrep and len(trep) > 5
    assert len(tpacks) == len(jpacks)
    for (ti, tst, tn), (ji, jst, jn) in zip(tpacks, jpacks):
        assert tn == jn and np.array_equal(ti, ji) and np.array_equal(tst, jst)
    assert len(touts) == len(jouts)
    for t_out, j_out in zip(touts, jouts):
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a, b)
    assert tdone == jdone                  # batch membership, order and latency
    assert trecs == jrecs
    assert ts.keys() == js.keys()
    for k in ts:
        assert ts[k] == js[k] or (np.isnan(ts[k]) and np.isnan(js[k])), k
    assert ts["dropped_by_bug"] == 0 and ts["completed"] == 60


@pytest.mark.parametrize("lengths", [[20, 2, 2, 20, 2], [0, 5, 17, 64, 1, 0, 33, 16, 15, 70]])
def test_length_bucketing_is_the_jax_bucketing(lengths):
    from repro.serving.request import Request as JRequest
    from repro_torch.serving.request import Request

    cfg = _cfg(length_splitters=(4, 16, 64))
    jcfg = jserving.ServingConfig(num_experts=E, max_batch_requests=8, max_batch_tokens=256,
                                  token_pad_classes=CLASSES, length_splitters=(4, 16, 64))
    reqs = _reqs(lengths)
    got = ServerLoop(cfg).policy.length_groups([Request(i, r, 0.0) for i, r in enumerate(reqs)])
    want = jserving.ServerLoop(jcfg).policy.length_groups(
        [JRequest(i, r, 0.0) for i, r in enumerate(reqs)])
    assert got == want


def test_percentiles_are_the_inverted_cdf():
    xs = np.random.RandomState(3).uniform(0, 1e3, size=97)
    ps = (1.0, 50.0, 95.0, 99.0, 100.0)
    got = percentiles(xs.tolist(), ps)
    assert got == jserving.percentiles(xs.tolist(), ps)
    assert [got[p] for p in ps] == list(np.percentile(xs, ps, method="inverted_cdf"))
    assert all(np.isnan(v) for v in percentiles([]).values())
    with pytest.raises(ValueError):
        percentiles([1.0], (101.0,))


# ---------------------------------------------------------------------------
# The port alone: one routing call a step, packing, warm plans
# ---------------------------------------------------------------------------

def test_one_step_is_one_segmented_routing_call(monkeypatch):
    loop = ServerLoop(_cfg())
    calls = []
    orig = moe.route_tokens_segmented

    def spy(ids, starts, *a, **k):
        calls.append((int(np.asarray(ids).shape[0]), int(np.asarray(starts).shape[0])))
        return orig(ids, starts, *a, **k)

    monkeypatch.setattr(moe, "route_tokens_segmented", spy)
    for r in _reqs([3, 5, 0, 7, 2]):
        assert loop.submit(r)
    rep = loop.step(force=True)
    loop.flush()
    assert rep["requests"] == 5 and rep["tokens"] == 17
    assert calls == [(rep["tokens_padded"], loop._s_pad)]
    s = loop.metrics_summary()
    assert s["completed"] == 5 and s["dropped_by_bug"] == 0


def test_pack_pads_with_last_expert_into_pad_segment():
    loop = ServerLoop(_cfg())
    reqs = _reqs([3, 0, 5])
    for r in reqs:
        loop.submit(r)
    ids, starts, n_tok = loop._pack(loop.queue.snapshot())
    assert n_tok == 8 and ids.shape == (CLASSES[0],)
    np.testing.assert_array_equal(ids[:8], np.concatenate([reqs[0], reqs[2]]))
    assert (ids[8:] == E - 1).all()
    assert starts.shape == (loop._s_pad,)
    np.testing.assert_array_equal(starts[:4], [0, 3, 3, 8])
    assert (starts[4:] == 8).all()


def test_no_plan_is_rebuilt_after_the_first_step_of_a_class():
    loop = ServerLoop(_cfg())
    for r in _reqs([4, 4]):
        loop.submit(r)
    loop.step(force=True)
    loop.flush()
    built = ops._plan_cached.cache_info().misses
    for r in _reqs([2, 3, 5], seed=1):                 # other raggedness, same class
        loop.submit(r)
    loop.step(force=True)
    loop.flush()
    assert ops._plan_cached.cache_info().misses == built
    assert loop.metrics_summary()["completed"] == 5


def test_prewarm_builds_every_plan_traffic_needs():
    cfg = _cfg(max_wait=0.002, max_queue_depth=256)
    loop = ServerLoop(cfg)
    loop.prewarm()
    built = ops._plan_cached.cache_info().misses
    reqs = synthetic_requests(120, E, seed=2, mean_len=24, max_len=200)
    clk = FakeClock()
    loop.clock = clk
    s = open_loop(loop, reqs, poisson_arrivals(120, 5000.0, seed=2), sleep=clk.sleep)
    assert s["completed"] == 120 and s["dropped_by_bug"] == 0
    assert ops._plan_cached.cache_info().misses == built


def test_routing_op_shared_across_loops():
    a, b = ServerLoop(_cfg()), ServerLoop(_cfg())
    assert a._step_fn is b._step_fn
    assert ServerLoop(_cfg(capacity=16))._step_fn is not a._step_fn
    assert ServerLoop(_cfg(backend="vmap"))._step_fn is not a._step_fn


# ---------------------------------------------------------------------------
# Robustness: retry, requeue, bounded failure, shedding, degradation
# ---------------------------------------------------------------------------

def test_fault_transient_retries_in_step():
    loop = ServerLoop(_cfg(), fault_injector=FaultInjector(fail_at={0: 1}))
    for r in _reqs([2, 3, 4]):
        loop.submit(r)
    loop.step(force=True)
    loop.flush()
    s = loop.metrics_summary()
    assert s["completed"] == 3 and s["failed"] == 0 and s["requeued"] == 0
    assert s["retries"] == 1 and s["dropped_by_bug"] == 0
    assert loop.metrics.step_records[0].attempts == 2


def test_an_asynchronous_failure_surfaces_in_flush(monkeypatch):
    """The event a launch recorded raises when flush waits on it (a kernel
    that failed after its launch returned): flush retries in place."""
    class FailingEvent:
        def synchronize(self):
            raise RuntimeError("UNAVAILABLE: transient device interruption")

    events = iter([FailingEvent()])
    monkeypatch.setattr(engine, "_record", lambda out: next(events, None))
    loop = ServerLoop(_cfg())
    for r in _reqs([2, 3]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 2 and s["retries"] == 1 and s["dropped_by_bug"] == 0


def test_fault_exhausts_attempts_requeues_then_succeeds():
    loop = ServerLoop(_cfg(max_step_attempts=3), fault_injector=FaultInjector(fail_at={0: 3}))
    for r in _reqs([2, 3, 4]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 3 and s["failed"] == 0
    assert s["requeued"] == 3 and s["retries"] == 2
    assert s["dropped_by_bug"] == 0 and s["queued"] == 0
    assert [rid for rid, _ in loop.completed] == [0, 1, 2]
    assert [r.ok for r in loop.metrics.step_records] == [False, True]


def test_fault_persistent_fails_requests_counted():
    loop = ServerLoop(_cfg(max_step_attempts=1, max_requeues=1), fault_injector=AlwaysFail())
    for r in _reqs([2, 3, 4, 5]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 0 and s["failed"] == 4
    assert s["dropped_by_bug"] == 0 and s["queued"] == 0


def test_load_shed_on_queue_bound_and_oversized_request():
    loop = ServerLoop(_cfg(max_queue_depth=4))
    assert [loop.submit(r) for r in _reqs([1] * 6)] == [True] * 4 + [False] * 2
    assert not loop.submit(np.zeros(257, np.int32))   # can never fit a batch
    s = loop.drain()
    assert s["shed"] == 3 and s["completed"] == 4 and s["dropped_by_bug"] == 0


def test_persistent_kernel_fault_degrades_to_reference():
    loop = ServerLoop(_cfg(max_step_attempts=1, max_requeues=0),
                      fault_injector=AlwaysKernelFault())
    for r in _reqs([2, 3, 4, 5]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 4 and s["failed"] == 0
    assert s["degradations"] >= 1 and s["dropped_by_bug"] == 0
    assert rz.stats()["degradations"] >= 1 and rz.stats()["backend_demotions"] >= 1


def test_degrade_respects_strict_mode():
    rz.set_strict(True)
    loop = ServerLoop(_cfg(max_step_attempts=1, max_requeues=0),
                      fault_injector=AlwaysKernelFault())
    for r in _reqs([2, 3]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 0 and s["failed"] == 2
    assert s["degradations"] == 0 and s["dropped_by_bug"] == 0


def test_degrade_needs_fallback_as_on_the_card(monkeypatch):
    """Without fallback (the default for a loop on the card) a persistent
    kernel fault requeues and fails the step's requests: nothing runs on
    the reference backend."""
    rz.set_fallback(False)
    loop = ServerLoop(_cfg(max_step_attempts=1, max_requeues=0),
                      fault_injector=AlwaysKernelFault())
    ran = []
    real = engine._routing_op

    def spy(e, cap, backend, device):
        ran.append(backend)
        return real(e, cap, backend, device)

    monkeypatch.setattr(engine, "_routing_op", spy)
    for r in _reqs([2, 3]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 0 and s["failed"] == 2 and s["requeued"] == 0
    assert s["degradations"] == 0 and s["dropped_by_bug"] == 0
    assert "reference" not in ran and rz.stats()["backend_demotions"] == 0


def test_verify_mismatch_counted_and_healed_by_reference():
    rz.set_verify(2)
    loop = ServerLoop(_cfg(verify_sample_rate=1.0))
    real = loop._step_fn

    def lying(ids, starts):
        slot, keep, counts = real(ids, starts)
        counts = counts.clone()
        counts[0, 0] += 1                                # breaks token conservation
        return slot, keep, counts

    loop._step_fn = lying
    for r in _reqs([2, 3, 4]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 3 and s["failed"] == 0
    assert s["verify_mismatches"] >= 1 and s["degradations"] >= 1
    assert s["dropped_by_bug"] == 0
    assert rz.last_report()["spec"] == "route_tokens_segmented"
    assert rz.stats()["verify_mismatches"] == s["verify_mismatches"]


def test_verify_checks_every_step_and_strict_raises_on_a_mismatch():
    """Every step's routing is checked once: the ops a step calls (and the
    admission's bucketing) run outside the ops' ladder."""
    rz.set_verify(2)
    loop = ServerLoop(_cfg(length_splitters=(4, 16)))
    for r in _reqs([2, 3, 4, 30, 7, 0, 12, 9, 40, 3]):
        loop.submit(r)
    s = loop.drain()
    assert rz.stats()["verify_checks"] == s["steps"] == 2 and s["verify_mismatches"] == 0
    rz.set_strict(True)
    loop = ServerLoop(_cfg())
    real = loop._step_fn
    loop._step_fn = lambda ids, starts: (lambda o: (o[0], o[1] & False, o[2]))(real(ids, starts))
    loop.submit(_reqs([5])[0])
    with pytest.raises(rz.KernelResultError):
        loop.drain()


def test_verify_mismatch_without_fallback_is_reported_and_raised():
    rz.set_verify(2)
    rz.set_fallback(False)
    loop = ServerLoop(_cfg(verify_sample_rate=1.0))
    real = loop._step_fn
    loop._step_fn = lambda ids, starts: (lambda o: (o[0], o[1] & False, o[2]))(real(ids, starts))
    loop.submit(_reqs([5])[0])
    with pytest.raises(rz.KernelResultError):
        loop.drain()
    assert rz.stats()["verify_mismatches"] == 1 and rz.stats()["reference_reruns"] == 0
    assert rz.last_report()["spec"] == "route_tokens_segmented"


def test_verify_sample_rate_zero_never_checks():
    rz.set_verify(2)
    loop = ServerLoop(_cfg(verify_sample_rate=0.0))
    for r in _reqs([2, 3]):
        loop.submit(r)
    s = loop.drain()
    assert s["completed"] == 2 and s["verify_mismatches"] == 0
    assert rz.stats()["verify_checks"] == 0


@pytest.mark.parametrize("kw", [dict(token_pad_classes=(16,)), dict(max_step_attempts=0),
                                dict(lookahead_batches=0), dict(length_splitters=(16, 4)),
                                dict(verify_sample_rate=1.5)])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        _cfg(**kw)


def test_the_defaults_are_the_card():
    cfg = ServingConfig()
    assert (cfg.backend, cfg.device) == ("cuda", "cuda")
    assert (cfg.admission().backend, cfg.admission().device) == ("cuda", "cuda")


# ---------------------------------------------------------------------------
# Open and closed loops, edges, the launcher
# ---------------------------------------------------------------------------

def test_open_and_closed_loop_conserve_requests():
    cfg = _cfg(max_queue_depth=512, max_wait=0.002)
    loop = ServerLoop(cfg)
    loop.prewarm()
    n = 300
    s = open_loop(loop, synthetic_requests(n, E, seed=7),
                  poisson_arrivals(n, qps=20_000.0, seed=7))
    assert s["submitted"] == n and s["completed"] + s["shed"] == n and s["failed"] == 0
    assert s["dropped_by_bug"] == 0 and s["queued"] == 0
    assert np.isfinite(s["latency_p99_ms"]) and 0 < s["batch_token_occupancy"] <= 1.0
    loop = ServerLoop(cfg)
    s = closed_loop(loop, synthetic_requests(200, E, seed=8))
    assert s["completed"] == 200 and s["dropped_by_bug"] == 0


def test_empty_step_and_empty_drain():
    loop = ServerLoop(_cfg())
    assert loop.step(force=True) is None
    s = loop.drain()
    assert s["steps"] == 0 and s["dropped_by_bug"] == 0
    assert np.isnan(s["latency_p50_ms"])


def test_launcher_serves_traffic_on_the_cpu(capsys):
    s = serve.main(["--traffic", "--device", "cpu", "--requests", "200", "--qps", "20000",
                    "--max-batch-tokens", "1024", "--fault-rate", "0.05", "--seed", "4"])
    assert s["dropped_by_bug"] == 0 and s["submitted"] == 200
    assert s["completed"] + s["shed"] + s["failed"] == 200
    assert "[serve] completed" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main([])
    assert "--arch is required" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # the decode demo runs on the card by default: no card, no demo
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(["--arch", "tinyllama-1.1b"])


def test_chaos_serving_conserves_and_verifies():
    """Step faults at rate 0.01 and dispatch faults at 0.05 (the chip
    smoke's chaos): every request completes or fails counted, and every
    step's routing that completes passes level-2 verification."""
    rz.set_verify(2)
    inj = FaultInjector(rate=0.01, dispatch_rate=0.05, seed=26)
    rz.set_fault_injector(inj)
    loop = ServerLoop(_cfg(max_queue_depth=512), fault_injector=inj)
    s = closed_loop(loop, synthetic_requests(400, E, seed=9, mean_len=24, max_len=200))
    assert inj.injected > 0
    assert s["dropped_by_bug"] == 0 and s["verify_mismatches"] == 0
    assert s["completed"] == s["submitted"] - s["shed"] - s["failed"]
    assert rz.stats()["verify_checks"] == s["steps"] - sum(
        not r.ok for r in loop.metrics.step_records)
