"""The port's distributed stage (``repro_torch.core.distributed``) against
the JAX package's (``repro.core.distributed``) on the CPU.

* ``multisplit_all_shards`` in process against JAX's and ``multisplit_ref``,
  bitwise: keys, values, starts, counts and the permutation.
* Four gloo ranks, spawned once as processes with a file store, run every
  collective case in one session and save what they got; the tests hold
  ``multisplit_sharded`` against the flat oracle's slices and
  ``multisplit_bucket_sharded`` (both transports, with and without drops)
  against an oracle of JAX's drop rule built from ``multisplit_ref``.
* One subprocess with four XLA host devices, started beside the ranks,
  runs JAX's own ``multisplit_bucket_sharded`` at the dropping capacity,
  since the drop rule is where a port can differ.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core.identifiers import delta_buckets
from repro.core.multisplit import multisplit_ref
from repro_torch.convert import convert_spec
from repro_torch.core import distributed as tdist

import _torch_threads

_torch_threads.pin()

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
N_DEV = 512                           # keys a rank
SHARDED_M = (2, 11, 64, 256)
BUCKET_M = (8, 64, 256)
CAPACITIES = {"nodrop": 2 * N_DEV, "drop": N_DEV // 2}
KEY_RANGE = 2 ** 30


def _inputs(m: int):
    rng = np.random.RandomState(m)
    keys = rng.randint(0, KEY_RANGE, WORLD * N_DEV, dtype=np.uint32)
    return keys, np.arange(keys.shape[0], dtype=np.int32)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


# ---------------------------------------------------------------------------
# multisplit_all_shards, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key_value", [False, True], ids=["keys", "kv"])
@pytest.mark.parametrize("m", SHARDED_M)
def test_all_shards_equals_jax_and_the_oracle(m, key_value):
    keys, vals = _inputs(m)
    shards, vshards = keys.reshape(WORLD, N_DEV), vals.reshape(WORLD, N_DEV)
    spec = delta_buckets(m, KEY_RANGE)
    vj = jnp.asarray(vshards) if key_value else None
    want = jdist.multisplit_all_shards(jnp.asarray(shards), spec, vj)
    ref = multisplit_ref(jnp.asarray(keys), spec, jnp.asarray(vals) if key_value else None)
    got = tdist.multisplit_all_shards(shards, convert_spec(spec), vshards if key_value else None,
                                      device="cpu")
    for field in ("keys", "values", "bucket_starts", "bucket_counts", "permutation"):
        g, w, r = getattr(got, field), getattr(want, field), getattr(ref, field)
        if w is None:
            assert g is None and r is None, field
            continue
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=field)
        np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=field)


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from repro_torch.core import distributed as D
from repro_torch.core.identifiers import DeltaSpec
n = {n_dev}
got = {{}}
def cases():
    for m in {sharded_m}:
        yield "sharded", m, None, None
    for m in {bucket_m}:
        for transport in ("dense", "ragged"):
            for name, cap in {capacities}.items():
                yield "bucket", m, transport, (name, cap)
for kind, m, transport, cap in cases():
    rng = np.random.RandomState(m)
    keys = rng.randint(0, {key_range}, world * n, dtype=np.uint32)
    vals = np.arange(world * n, dtype=np.int32)
    sl = slice(rank * n, (rank + 1) * n)
    spec = DeltaSpec(m, {key_range})
    if kind == "sharded":
        fn = D.make_multisplit_sharded(spec, key_value=True, device="cpu")
        r = fn(keys[sl], vals[sl])
        tag = f"sharded-{{m}}"
    else:
        r = D.multisplit_bucket_sharded(keys[sl], spec, vals[sl], capacity=cap[1],
                                        transport=transport, device="cpu")
        tag = f"bucket-{{m}}-{{transport}}-{{cap[0]}}"
    for field, x in r._asdict().items():
        got[tag + ":" + field] = (x.view(torch.int32) if x.dtype == torch.uint32 else x).numpy()
np.savez(out, **got)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The four gloo ranks, and the JAX subprocess of
    :func:`test_bucket_sharded_drops_as_jax_does`, started together:
    (work directory, the ranks, the JAX process); any still running at the
    module's end is killed."""
    tmp = tmp_path_factory.mktemp("gloo")
    script = tmp / "worker.py"
    script.write_text(textwrap.dedent(_WORKER).format(
        n_dev=N_DEV, sharded_m=SHARDED_M, bucket_m=BUCKET_M, capacities=CAPACITIES,
        key_range=KEY_RANGE))
    path = str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", "")
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    code = textwrap.dedent(_JAX_BUCKET).format(world=WORLD, n_dev=N_DEV,
                                               capacity=CAPACITIES["drop"], bucket_m=BUCKET_M,
                                               key_range=KEY_RANGE, out=tmp / "jax.npz")
    jax_env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                   PYTHONPATH=path)
    jax_proc = subprocess.Popen([sys.executable, "-c", code], env=jax_env,
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield tmp, procs, jax_proc
    for p in procs + [jax_proc]:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def gloo_results(spawned):
    """Every collective case, run once by four gloo ranks: rank -> {tag:field
    -> array}."""
    tmp, procs, _ = spawned
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("m", SHARDED_M)
def test_sharded_slices_equal_the_flat_result(gloo_results, m):
    keys, vals = _inputs(m)
    ref = multisplit_ref(jnp.asarray(keys), delta_buckets(m, KEY_RANGE), jnp.asarray(vals))
    for r, res in enumerate(gloo_results):
        sl = slice(r * N_DEV, (r + 1) * N_DEV)
        got = lambda f: res[f"sharded-{m}:{f}"]
        np.testing.assert_array_equal(got("keys"), _bits(ref.keys)[sl])
        np.testing.assert_array_equal(got("values"), _bits(ref.values)[sl])
        np.testing.assert_array_equal(got("bucket_starts"), _bits(ref.bucket_starts))
        np.testing.assert_array_equal(got("bucket_counts"), _bits(ref.bucket_counts))


def _bucket_oracle(m: int, capacity: int):
    """JAX's rule from the flat oracle: rank d gets the elements of buckets
    [d·m/D, (d+1)·m/D) in the src-major order they arrive in (source rank,
    then its bucket-major order), drops those past ``capacity``, and puts
    the kept ones back bucket-major, zeros after them."""
    keys, vals = _inputs(m)
    ref = multisplit_ref(jnp.asarray(keys), delta_buckets(m, KEY_RANGE), jnp.asarray(vals))
    rk, rv = _bits(ref.keys), _bits(ref.values)
    counts, starts = np.asarray(ref.bucket_counts), np.asarray(ref.bucket_starts)
    src = np.empty(keys.shape[0], np.int64)
    src[np.asarray(ref.permutation)] = np.arange(keys.shape[0]) // N_DEV   # source of a slot
    mb = m // WORLD
    out = []
    for d in range(WORLD):
        lo, hi = starts[d * mb], starts[d * mb] + counts[d * mb:(d + 1) * mb].sum()
        s = src[lo:hi]
        before = np.array([(s < x).sum() for x in range(WORLD)])       # src-major bases
        rank_in_src = np.array([(s[:i] == s[i]).sum() for i in range(len(s))], np.int64)
        kept = before[s] + rank_in_src < capacity
        ko, vo = np.zeros(capacity, np.int32), np.zeros(capacity, np.int32)
        ko[:kept.sum()], vo[:kept.sum()] = rk[lo:hi][kept], rv[lo:hi][kept]
        out.append((ko, vo, min(hi - lo, capacity), counts[d * mb:(d + 1) * mb], counts))
    return out


@pytest.mark.parametrize("cap", list(CAPACITIES))
@pytest.mark.parametrize("transport", ["dense", "ragged"])
@pytest.mark.parametrize("m", BUCKET_M)
def test_bucket_sharded_follows_the_drop_rule(gloo_results, m, transport, cap):
    oracle = _bucket_oracle(m, CAPACITIES[cap])
    dropped = 0
    for r, res in enumerate(gloo_results):
        got = lambda f: res[f"bucket-{m}-{transport}-{cap}:{f}"]
        ko, vo, count, group_counts, totals = oracle[r]
        np.testing.assert_array_equal(got("keys"), ko)
        np.testing.assert_array_equal(got("values"), vo)
        np.testing.assert_array_equal(got("count"), [count])
        np.testing.assert_array_equal(got("group_counts"), group_counts)
        np.testing.assert_array_equal(got("bucket_counts"), totals)
        dropped += group_counts.sum() - count
    assert (dropped > 0) == (cap == "drop")


_JAX_BUCKET = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.distributed import multisplit_bucket_sharded, BucketShardedResult
from repro.core.identifiers import delta_buckets
D, n, cap = {world}, {n_dev}, {capacity}
mesh = jax.make_mesh((D,), ("x",), axis_types=(jax.sharding.AxisType.Auto,))
got = {{}}
for m in {bucket_m}:
    rng = np.random.RandomState(m)
    keys = jnp.asarray(rng.randint(0, {key_range}, D * n, dtype=np.uint32))
    vals = jnp.arange(D * n, dtype=jnp.int32)
    bf = delta_buckets(m, {key_range})
    fn = lambda k, v: multisplit_bucket_sharded(k, bf, v, axis_name="x", capacity=cap)
    f = jax.shard_map(fn, mesh=mesh, in_specs=(P("x"), P("x")),
        out_specs=BucketShardedResult(P("x"), P("x"), P("x"), P("x"), P()), check_vma=False)
    with jax.set_mesh(mesh):
        out = jax.jit(f)(keys, vals)
    for field, x in out._asdict().items():
        a = np.asarray(x)
        got[f"{{m}}:{{field}}"] = a.view(np.int32) if a.dtype == np.uint32 else a
np.savez("{out}", **got)
"""


def test_bucket_sharded_drops_as_jax_does(gloo_results, spawned):
    """JAX's own ``multisplit_bucket_sharded`` on four XLA host devices at
    the dropping capacity (a subprocess started beside the ranks), against
    the gloo ranks' results."""
    tmp, _, proc = spawned
    out = tmp / "jax.npz"
    stdout = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, stdout
    want = np.load(out)
    for m in BUCKET_M:
        for transport in ("dense", "ragged"):
            for field in ("keys", "values", "count", "group_counts"):
                got = np.stack([res[f"bucket-{m}-{transport}-drop:{field}"]
                                for res in gloo_results])
                np.testing.assert_array_equal(got.reshape(-1), want[f"{m}:{field}"].reshape(-1),
                                              err_msg=f"m={m} {transport} {field}")
            totals = gloo_results[0][f"bucket-{m}-{transport}-drop:bucket_counts"]
            np.testing.assert_array_equal(totals, want[f"{m}:bucket_counts"])


def test_transport_is_checked():
    with pytest.raises(ValueError, match="transport"):
        tdist._check_transport("ring")


def test_send_plan_equals_jax():
    """The (D, D) input offsets and send counts of the dense transport from a
    gathered H, against JAX's ``_send_plan``."""
    rng = np.random.RandomState(7)
    hist = rng.multinomial(N_DEV, np.ones(16) / 16, size=WORLD).astype(np.int32)
    want = jdist._send_plan(jnp.asarray(hist), N_DEV)
    got = tdist._send_plan(torch.from_numpy(hist), N_DEV)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int32))
