"""The consumers of the port against the JAX package, bitwise: the MoE
routing functions of ``repro_torch.models.moe`` and the length bucketing of
``repro_torch.data.DataPipeline``.

Each case makes its inputs from a seed with numpy and calls both packages'
functions on them: the port on the CPU (``device="cpu"``), where the cuda
backend's kernel wrappers run their plain versions, and on ``vmap``; the JAX
package on its own default backend. Routing outputs are int32 (and a bool
keep mask, and a float32 drop share), compared bit for bit; batches are
numpy arrays, compared whole. ``chip_smoke.py`` drives the same functions on
the card and holds them against a stable ``torch.sort``."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from repro.data import pipeline as jdata
from repro.models import moe as jmoe
from repro_torch import data as tdata
from repro_torch.models import moe as tmoe

BACKENDS = ["cuda", "vmap"]


def _same(a, b) -> None:
    a, b = np.asarray(a), b.detach().cpu().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _ids(seed: int, n: int, e: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, e, n).astype(np.int32)


def _starts(seed: int, n: int, s: int, empty: bool) -> np.ndarray:
    """(s,) starts of s ragged requests over n tokens; with ``empty`` some
    requests hold no token (repeated starts, and one at n)."""
    rng = np.random.RandomState(seed + 1)
    cuts = np.sort(rng.randint(0, n + 1, max(s - 1, 0)))
    if empty and s > 2:
        cuts[1] = cuts[0]
        cuts[-1] = n
    return np.concatenate([[0], cuts]).astype(np.int32)[:s]


# n below and above DISPATCH_TILE; capacities that keep every token and that
# drop some; requests with empty ones. Cases share shapes where they can:
# the JAX side compiles once a shape.
ROUTE_CASES = [
    (0, 0, 8, 4, False),
    (1500, 16, 8, 16, True),
    (1500, 16, 8, 1000, False),
    (5000, 40, 16, 6, True),
    (5000, 40, 16, 200, False),
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,s,e,capacity,empty", ROUTE_CASES)
def test_route_tokens_segmented(backend, n, s, e, capacity, empty):
    ids, starts = _ids(n, n, e), _starts(n, n, s, empty)
    want = jmoe.route_tokens_segmented(jnp.asarray(ids), jnp.asarray(starts), e, capacity)
    got = tmoe.route_tokens_segmented(ids, starts, e, capacity, backend=backend, device="cpu")
    for w, g in zip(want, got):
        _same(w, g)
    if n and capacity < n // max(s, 1):
        assert not bool(got[1].all())           # the capacity drops tokens


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("capacity,segmented", list(itertools.product([None, 30], [False, True])))
def test_expert_load_stats(backend, capacity, segmented):
    n, e = 3000, 16
    ids = _ids(7, n, e)
    starts = _starts(7, n, 9, True) if segmented else None
    want = jmoe.expert_load_stats(jnp.asarray(ids), e, capacity=capacity,
                                  segment_starts=None if starts is None else jnp.asarray(starts))
    got = tmoe.expert_load_stats(ids, e, capacity=capacity, segment_starts=starts,
                                 backend=backend, device="cpu")
    _same(want[0], got[0])
    _same(want[1], got[1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,e,segmented", [(1500, 8, False), (5000, 16, True)])
def test_ranks_multisplit(backend, n, e, segmented):
    ids = _ids(n + 3, n, e)
    starts = _starts(n, n, 40, True) if segmented else None
    want = jmoe._ranks_multisplit(jnp.asarray(ids), e,
                                  None if starts is None else jnp.asarray(starts))
    got = tmoe._ranks_multisplit(ids, e, starts, backend=backend, device="cpu")
    for w, g in zip(want, got):
        _same(w, g)


@pytest.mark.parametrize("n,e", [(0, 4), (1, 4), (2500, 8), (2500, 64)])
def test_ranks_sort(n, e):
    ids = _ids(n + 11, n, e)
    want = jmoe._ranks_sort(jnp.asarray(ids), e)
    got = tmoe._ranks_sort(ids, e, device="cpu")
    for w, g in zip(want, got):
        _same(w, g)
    if n:
        # the baseline and the multisplit give the same ranks
        for a, b in zip(got, tmoe._ranks_multisplit(ids, e, device="cpu")):
            assert a.tolist() == b.tolist()


def _same_batches(want, got) -> None:
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert sorted(w) == sorted(g)
        for key in w:
            assert w[key].dtype == g[key].dtype and np.array_equal(w[key], g[key]), key


# (vocab, seq_len, batch, seed, frontend_stub_dim, host, hosts); every
# pipeline buckets 16 documents a step, so the JAX side compiles once
PIPELINES = [
    (1000, 128, 4, 3, None, 0, 1),
    (5000, 256, 4, 11, None, 0, 2),
    (5000, 256, 4, 11, None, 1, 2),
    (300, 64, 4, 5, 8, 0, 1),
]


@pytest.mark.parametrize("vocab,seq,batch,seed,stub,host,hosts", PIPELINES)
def test_data_pipeline_batches_at(vocab, seq, batch, seed, stub, host, hosts):
    kw = dict(seed=seed, host_index=host, n_hosts=hosts, frontend_stub_dim=stub)
    jp = jdata.DataPipeline(vocab, seq, batch, **kw)
    tp = tdata.DataPipeline(vocab, seq, batch, device="cpu", **kw)
    got = tp.batches_at(4, 3)
    _same_batches(jp.batches_at(4, 3), got)
    # batches_at(s, k)[i] is batch_at(s + i)
    _same_batches([tp.batch_at(4 + i) for i in range(3)], got)
    assert ("embeds" in got[0]) == bool(stub) and ("tokens" in got[0]) != bool(stub)


def test_data_pipeline_hosts_of_a_shard_differ():
    a = tdata.DataPipeline(5000, 256, 4, seed=11, host_index=0, n_hosts=2, device="cpu")
    b = tdata.DataPipeline(5000, 256, 4, seed=11, host_index=1, n_hosts=2, device="cpu")
    assert not np.array_equal(a.batch_at(0)["tokens"], b.batch_at(0)["tokens"])


@pytest.mark.parametrize("start,prefetch", [(0, 2), (5, 1)])
def test_make_batch_iterator(start, prefetch):
    jp = jdata.DataPipeline(1000, 128, 4, seed=1)
    tp = tdata.DataPipeline(1000, 128, 4, seed=1, device="cpu")
    want = jp.batches_at(start, 3)
    it = tdata.make_batch_iterator(tp, start_step=start, prefetch=prefetch)
    got = [next(it) for _ in range(3)]
    it.close()
    _same_batches(want, got)


def test_routing_defaults_to_the_card():
    """The routing functions default to the cuda backend on the card; the
    port leaves the tile to the resolver there and takes the JAX package's
    tile on vmap."""
    import inspect

    for fn in (tmoe.expert_load_stats, tmoe._ranks_multisplit, tmoe.route_tokens_segmented):
        params = inspect.signature(fn).parameters
        assert params["backend"].default == "cuda" and params["device"].default == "cuda"
    assert inspect.signature(tmoe._ranks_sort).parameters["device"].default == "cuda"
    assert tmoe.DISPATCH_TILE == jmoe.DISPATCH_TILE
    assert tmoe._dispatch_tile(10_000, "cuda") is None
    assert tmoe._dispatch_tile(10_000, "vmap") == jmoe.DISPATCH_TILE
    assert tmoe._dispatch_tile(100, "vmap") == 100
    assert inspect.signature(tdata.DataPipeline).parameters["device"].default == "cuda"
