"""The port's training stack around the model (``repro_torch.optim``,
``repro_torch.checkpoint``, ``runtime.Supervisor``, ``launch.train``)
against the JAX package's on the CPU.

Each function is fed the same numpy inputs as its JAX twin: the schedules
at every step, AdamW in float32, with bfloat16 params and their float32
master, with bfloat16 moments and with the global-norm clip biting;
``quantize`` / ``dequantize`` bitwise; ``compressed_psum`` on four gloo
ranks (two groups of two) against JAX's on a (2, 2) mesh of XLA host
devices. Checkpoints cross-read bitwise in both directions, with equal
manifests. The supervisor runs the JAX tests' fault schedules
(``tests/test_substrate.py``) beside JAX's own supervisor: the same stats,
history steps and backoff sleeps; a fault inside the in-place AdamW
update, or at the wait for its metrics, restores rather than retries. The
launcher trains tinyllama and dbrx
(multisplit dispatch) on their smoke configs, and the loss falls as in
``tests/test_system.py``. A training step and a checkpoint save, in a
fresh process, load no module of JAX or of the JAX package.
"""

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

from repro.checkpoint import manager as jckpt
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch.steps import TrainState as JTrainState
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedules as jsched
from repro.runtime import supervisor as jsup
from repro_torch import convert
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainState
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.optim import schedules as tsched
from repro_torch.parallel.sharding import tree_leaves, tree_map
from repro_torch.runtime import supervisor as tsup

SRC = Path(__file__).resolve().parents[1] / "src"


def _np(x) -> np.ndarray:
    """A tensor or JAX array as numpy, bfloat16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(schedule="cosine", warmup_steps=10, total_steps=100),
    dict(schedule="cosine", warmup_steps=0, total_steps=7),
    dict(schedule="wsd", warmup_steps=5, total_steps=80, decay_start=0.75),
    dict(schedule="wsd", warmup_steps=20, total_steps=20),
], ids=["cosine", "cosine-nowarmup", "wsd", "wsd-all-warmup"])
def test_schedules_equal_jax_at_every_step(kw):
    jf, tf = jsched.make_schedule(JTrainConfig(lr=3e-3, **kw)), tsched.make_schedule(
        TrainConfig(lr=3e-3, **kw))
    steps = np.arange(kw["total_steps"] + 6, dtype=np.float32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    # cos near pi rounds by an ulp either way, and 1 + cos cancels there:
    # the tail is held to 1e-6 of the peak rate
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * 3e-3)
    assert float(tf(3)) == pytest.approx(float(jf(jnp.float32(3))), rel=1e-6)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng, dtype=np.float32, scale=1.0):
    return {"b": [rng.randn(3, 70).astype(np.float32) * scale, rng.randn(5).astype(np.float32)],
            "a": {"w": (rng.randn(4, 33, 2) * scale).astype(np.float32)}}


ADAMW_CASES = {
    "float32": dict(),
    "bf16-params-master": dict(params_dtype="bfloat16"),
    "bf16-moments": dict(moments_dtype="bfloat16"),
    "clipped": dict(clip_norm=0.5),
}


@pytest.mark.parametrize("chunk", [tadamw.CHUNK, 37], ids=["whole", "sliced"])
@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_equals_jax(case, chunk, monkeypatch):
    """Three updates from the same params and gradients (scaled so the clip
    bites where it is set); the port's in-place update, whole leaves or in
    slices of 37 elements, against JAX's. The clip scale comes from a sum
    over every element in another order, so float32 values are held to
    1e-5 relative (and 1e-6 of their leaf's largest, where the moment's
    update cancels), bfloat16 values to one unit in the last place; the
    bfloat16 params equal the master cast."""
    monkeypatch.setattr(tadamw, "CHUNK", chunk)
    kw = dict(lr=1e-2, weight_decay=0.1, **ADAMW_CASES[case])
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.RandomState(0)
    pdt = jnp.dtype(jtc.params_dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(pdt), _tree(rng))
    jstate = jadamw.adamw_init(jp, jtc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    tstate = tadamw.adamw_init(tp, ttc)
    assert (tstate.master is None) == (jstate.master is None)
    for i, lr in enumerate((1e-2, 3e-3, 5e-2)):
        grads = _tree(np.random.RandomState(i + 1), scale=10.0)
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(pdt), grads)
        jp, jstate, jm = jadamw.adamw_update(jg, jstate, jp, jtc, lr)
        tg = convert.params_from_numpy(jax.tree.map(np.asarray, jg))
        tp, tstate, tm = tadamw.adamw_update(tg, tstate, tp, ttc, lr)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert float(tm["lr"]) == pytest.approx(lr, rel=1e-7)
    if case == "clipped":
        assert float(jm["grad_norm"]) > 2 * jtc.clip_norm
    assert int(tstate.step) == int(jstate.step) == 3
    pairs = [("mu", jstate.mu, tstate.mu), ("nu", jstate.nu, tstate.nu), ("params", jp, tp)]
    if jstate.master is not None:
        pairs.append(("master", jstate.master, tstate.master))
        for p, w in zip(tree_leaves(tp), tree_leaves(tstate.master)):
            assert p.dtype == torch.bfloat16 and torch.equal(p, w.to(torch.bfloat16))
    for name, j_tree, t_tree in pairs:
        for w, g in zip(jax.tree.leaves(j_tree), tree_leaves(t_tree)):
            rtol = 2.0 ** -7 if np.asarray(w).dtype.name == "bfloat16" else 1e-5
            w, g = np.asarray(w).astype(np.float32), g.float().numpy()
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{case} {name}")


def test_adamw_update_is_in_place():
    """The update writes into the tensors it was given (a train step's state
    is consumed, as JAX's donated one is) and returns them."""
    tc = TrainConfig()
    p = {"w": torch.ones(10)}
    st = tadamw.adamw_init(p, tc)
    mu = st.mu["w"]
    new_p, new_st, _ = tadamw.adamw_update({"w": torch.full((10,), 0.5)}, st, p, tc, 0.1)
    assert new_p["w"] is p["w"] and new_st.mu["w"] is mu and bool((mu != 0).all())
    assert int(st.step) == 1


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 11, 5), (1,)])
def test_quantize_dequantize_bitwise_equal_jax(shape):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 50.0], size=shape)).astype(np.float32)
    jq, jres = jcompress.quantize(jnp.asarray(x))
    tq, tres = tcompress.quantize(torch.from_numpy(x))
    assert tq.n == jq.n and tq.q.dtype == torch.int8
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(_np(tq.scale).view(np.int32),
                                  np.asarray(jq.scale).view(np.int32))
    np.testing.assert_array_equal(_np(tres).view(np.int32), np.asarray(jres).view(np.int32))
    jd = jcompress.dequantize(jq, shape, jnp.float32)
    td = tcompress.dequantize(tq, shape, torch.float32)
    np.testing.assert_array_equal(_np(td).view(np.int32), np.asarray(jd).view(np.int32))


PSUM_SHAPE, PSUM_WORLD = (8, 125), 4

_PSUM_WORKER = """
import sys
import numpy as np, torch, torch.distributed as dist
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
from repro_torch.optim.compress import compressed_psum
fast = [dist.new_group([0, 1]), dist.new_group([2, 3])]      # ranks one fast link joins
slow = [dist.new_group([0, 2]), dist.new_group([1, 3])]      # one rank of each fast group
rng = np.random.RandomState(0)
grads = rng.randn(4, *{shape}).astype(np.float32) * np.float32(3.0)
errors = rng.randn(4, *{shape}).astype(np.float32) * np.float32(1e-2)
red, res = compressed_psum(torch.from_numpy(grads[rank]), torch.from_numpy(errors[rank]),
                           fast_group=fast[rank // 2], slow_group=slow[rank % 2])
np.savez(out, reduced=red.numpy(), residual=res.numpy())
dist.destroy_process_group()
"""

_PSUM_JAX = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.optim.compress import compressed_psum
mesh = jax.make_mesh((2, 2), ("slow", "fast"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
rng = np.random.RandomState(0)
grads = rng.randn(4, *{shape}).astype(np.float32) * np.float32(3.0)
errors = rng.randn(4, *{shape}).astype(np.float32) * np.float32(1e-2)
spec = P(("slow", "fast"))
def fn(g, e):
    r, s = compressed_psum(g[0], e[0], fast_axis="fast", slow_axis="slow")
    return r[None], s[None]
f = jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                  check_vma=False)
with jax.set_mesh(mesh):
    red, res = jax.jit(f)(jnp.asarray(grads), jnp.asarray(errors))
np.savez("{out}", reduced=np.asarray(red), residual=np.asarray(res))
"""


def test_compressed_psum_equals_jax_on_four_ranks(tmp_path):
    """Four gloo ranks in two fast groups of two (slow groups across them)
    against JAX's ``compressed_psum`` in ``shard_map`` on a (slow, fast) =
    (2, 2) mesh of XLA host devices, rank r at mesh position (r // 2,
    r % 2): the reduced gradient bitwise, the new error to an ulp."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_PSUM_WORKER).format(shape=PSUM_SHAPE))
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"),
                               str(tmp_path / f"rank{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(PSUM_WORLD)]
    jenv = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={PSUM_WORLD}")
    jax_run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_PSUM_JAX).format(shape=PSUM_SHAPE,
                                                                 out=tmp_path / "jax.npz")],
        env=jenv, capture_output=True, text=True, timeout=300)
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    assert jax_run.returncode == 0, jax_run.stderr
    want = np.load(tmp_path / "jax.npz")
    for r in range(PSUM_WORLD):
        got = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(got["reduced"].view(np.int32),
                                      want["reduced"][r].view(np.int32), err_msg=f"rank {r}")
        # XLA fuses q·scale into the residual's subtraction (one rounding
        # fewer): the residual is held to an ulp of the values it came from
        np.testing.assert_allclose(got["residual"], want["residual"][r], rtol=0,
                                   atol=2.0 ** -22 * np.abs(want["reduced"][r]).max(),
                                   err_msg=f"rank {r}")
    # the ranks of a slow group share one reduced gradient (each group's
    # own error feedback makes the two groups' differ)
    red = [np.load(tmp_path / f"rank{r}.npz")["reduced"] for r in range(PSUM_WORLD)]
    assert np.array_equal(red[0], red[2]) and np.array_equal(red[1], red[3])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(rng):
    """A train state of both packages from the same numpy arrays (float32
    params and moments, an int32 step)."""
    params = {"embed": {"tok": rng.randn(6, 4).astype(np.float32)},
              "blocks": [{"w": rng.randn(2, 3, 5).astype(np.float32)}],
              "tail": []}
    mom = lambda: jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), params)
    step = np.asarray(7, np.int32)
    jstate = JTrainState(jax.tree.map(jnp.asarray, params),
                         jadamw.AdamWState(jnp.asarray(step), jax.tree.map(jnp.asarray, mom()),
                                           jax.tree.map(jnp.asarray, mom())))
    return jstate, convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate))


def _assert_bitwise(got_tree, want_tree):
    gl, wl = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                      np.atleast_1d(w).view(np.uint8))


def test_checkpoints_cross_read_bitwise(tmp_path):
    jstate, tstate = _state(np.random.RandomState(0))
    tckpt.save_checkpoint(tmp_path / "port", 7, tstate)
    jckpt.save_checkpoint(tmp_path / "jax", 7, jstate)
    mj = json.loads((tmp_path / "jax" / "step_00000007" / "manifest.json").read_text())
    mt = json.loads((tmp_path / "port" / "step_00000007" / "manifest.json").read_text())
    assert mt["leaves"] == mj["leaves"]                  # keys, keystr paths, shapes, dtypes
    assert mt["step"] == mj["step"] and mt["n_hosts"] == mj["n_hosts"] == 1
    assert ".params['blocks'][0]['w']" in [rec["path"] for rec in mt["leaves"]]
    for d in ("port", "jax"):
        assert (tmp_path / d / "step_00000007" / "COMMIT").exists()
        assert (tmp_path / d / "step_00000007" / "host_00000.npz").exists()
    # JAX reads the port's checkpoint, the port JAX's
    jgot, jstep = jckpt.load_checkpoint(tmp_path / "port", jstate)
    tgot, tstep = tckpt.load_checkpoint(tmp_path / "jax", tstate)
    assert jstep == tstep == 7
    _assert_bitwise(tgot, jgot)
    _assert_bitwise(tgot, jstate)
    assert isinstance(tgot, TrainState) and tgot.opt.master is None
    assert tckpt.latest_step(tmp_path / "jax") == jckpt.latest_step(tmp_path / "port") == 7


def test_checkpoint_bfloat16_bitwise(tmp_path):
    """bfloat16 leaves (NaN, inf, -0 and subnormal bit patterns too) go to
    disk as their uint16 bits under ``"dtype": "bfloat16"`` and come back
    bitwise, onto the device and dtype of ``like``; a meta ``like`` restores
    on the CPU."""
    bits = np.array([0x7FC1, 0x7F80, 0xFF80, 0x8000, 0x0001, 0x3F80, 0xC2F7], np.uint16)
    state = {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
             "f": torch.randn(3, 4), "s": torch.tensor(5, dtype=torch.int32)}
    tckpt.save_checkpoint(tmp_path, 3, state)
    meta = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert [rec["dtype"] for rec in meta["leaves"]] == ["float32", "int32", "bfloat16"]
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    got, step = tckpt.load_checkpoint(tmp_path, like)
    assert step == 3 and got["w"].dtype == torch.bfloat16 and got["w"].device.type == "cpu"
    np.testing.assert_array_equal(_np(got["w"]), bits)
    assert torch.equal(got["f"], state["f"]) and torch.equal(got["s"], state["s"])


def test_checkpoint_save_is_atomic(tmp_path):
    """An interrupted save (a tmp dir, or a step dir with no COMMIT) is never
    reported or read; saving again replaces the tmp dir; a committed step is
    not written twice."""
    _, tstate = _state(np.random.RandomState(1))
    tckpt.save_checkpoint(tmp_path, 4, tstate)
    (tmp_path / ".tmp_step_00000008").mkdir()
    (tmp_path / ".tmp_step_00000008" / "junk").write_text("x")
    (tmp_path / "step_00000009").mkdir()                  # no COMMIT: a crash mid-rename
    assert tckpt.latest_step(tmp_path) == jckpt.latest_step(tmp_path) == 4
    got, step = tckpt.load_checkpoint(tmp_path, tstate)
    assert step == 4
    tckpt.save_checkpoint(tmp_path, 8, tstate)
    assert not (tmp_path / ".tmp_step_00000008").exists()
    assert tckpt.latest_step(tmp_path) == 8
    before = (tmp_path / "step_00000008" / "manifest.json").stat().st_mtime_ns
    tckpt.save_checkpoint(tmp_path, 8, tstate)            # idempotent replay
    assert (tmp_path / "step_00000008" / "manifest.json").stat().st_mtime_ns == before
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(tmp_path / "none", tstate)


def test_checkpoint_manager_async_saves_and_gc(tmp_path):
    """Async saves keep the last ``max_to_keep``; each holds the state as it
    was at ``save`` (the host copy is taken before the call returns), even
    though the caller updates the state in place right after."""
    mgr = tckpt.CheckpointManager(tmp_path, max_to_keep=2, async_saves=True)
    state = {"w": torch.zeros(1000)}
    for step in range(1, 6):
        state["w"].fill_(step)
        mgr.save(step, state)
        state["w"].fill_(-1)                              # an in-place update racing the save
    mgr.wait()
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["step_00000004", "step_00000005"]
    assert mgr.latest_step() == 5
    for step in (4, 5):
        got, _ = mgr.restore(state, step)
        assert bool((got["w"] == step).all())


# ---------------------------------------------------------------------------
# the supervisor, beside JAX's
# ---------------------------------------------------------------------------

def _jax_toy_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    return {"w": w}, {"loss": jnp.mean((w - batch) ** 2)}


def _port_toy_step(state, batch):
    w = state["w"] - 0.1 * (state["w"] - batch)
    return {"w": w}, {"loss": ((w - batch) ** 2).mean()}


SCHEDULES = {
    # name: (fail_at, loop config, with a remesh hook)
    "retry-and-restore": ({5: 1, 12: 10}, dict(total_steps=20, checkpoint_every=4,
                                               max_retries_per_step=2, max_restores=30), False),
    "resume": ({}, dict(total_steps=10, checkpoint_every=5), False),
    "elastic-remesh": ({3: 999}, dict(total_steps=6, checkpoint_every=100,
                                      max_retries_per_step=0, max_restores=1), True),
}


def _run_supervisor(pkg, name, ckpt_dir):
    fail_at, loop_kw, remesh = SCHEDULES[name]
    sup_mod, step, arr = ((jsup, _jax_toy_step, lambda x: jnp.asarray(x, jnp.float32))
                          if pkg == "jax" else
                          (tsup, _port_toy_step, lambda x: torch.tensor(x, dtype=torch.float32)))
    sleeps, remeshes = [], []

    def remesh_fn(state):
        remeshes.append(1)
        return state

    loop = sup_mod.TrainLoopConfig(checkpoint_dir=str(ckpt_dir), log_every=1, **loop_kw)
    out = {}
    for run in range(2 if name == "resume" else 1):      # resume: a second run on the dir
        sup = sup_mod.Supervisor(step, lambda s: arr(float(s)), loop,
                                 fault_injector=sup_mod.FaultInjector(fail_at=dict(fail_at)),
                                 remesh_fn=remesh_fn if remesh else None,
                                 sleep_fn=sleeps.append)
        try:
            state = sup.run({"w": arr(0.0 if run == 0 else 123.0)})
            out["w"] = float(state["w"])
        except RuntimeError as e:
            out["error"] = str(e)
    out.update(stats=dict(sup.stats), steps=[h["step"] for h in sup.history],
               losses=[h["loss"] for h in sup.history], sleeps=sleeps, remeshes=len(remeshes),
               latest=sup.ckpt.latest_step())
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_supervisor_equals_jax_under_fault_schedules(name, tmp_path):
    """The JAX tests' fault schedules through both supervisors: the same
    stats (retries, restores, re-meshes), history steps (the
    replayed ones included), backoff sleeps, last checkpoint and result."""
    want = _run_supervisor("jax", name, tmp_path / "jax")
    got = _run_supervisor("port", name, tmp_path / "port")
    losses_w, losses_g = want.pop("losses"), got.pop("losses")
    w_w, w_g = want.pop("w", None), got.pop("w", None)
    # a straggler is a step slower than twice the median: wall-clock noise
    # at these sub-millisecond steps, counted in neither
    got["stats"].pop("stragglers"), want["stats"].pop("stragglers")
    assert got == want
    np.testing.assert_allclose(losses_g, losses_w, rtol=1e-6)
    if w_w is not None:
        assert w_g == pytest.approx(w_w, rel=1e-6)
    if name == "retry-and-restore":
        assert got["stats"]["retries"] >= 1 and got["stats"]["restores"] >= 1
        assert got["latest"] == 20
    if name == "resume":
        assert w_g != 123.0                              # restored, not reinitialized
    if name == "elastic-remesh":
        assert got["remeshes"] and "budgets exhausted" in got["error"]


def test_supervisor_syncs_on_the_first_metric(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(tsup, "_block_until_ready", seen.append)
    sup = tsup.Supervisor(lambda s, b: (s, {"b": torch.ones(()), "a": torch.zeros(())}),
                          lambda s: None,
                          tsup.TrainLoopConfig(total_steps=2, checkpoint_every=100,
                                               checkpoint_dir=str(tmp_path)))
    sup.ckpt.save = lambda step, state: None
    sup.run({"w": torch.zeros(())})
    assert [float(x) for x in seen] == [0.0, 0.0]         # "a" sorts first, as jax.tree.leaves


def _adamw_toy_run(ckpt_dir, fault=None):
    """Six AdamW steps of a two-leaf quadratic under the supervisor,
    checkpoints every 2 steps; ``fault(step, state)`` is called when a step
    starts and may arm a failure. Returns (supervisor, final state)."""
    tc = TrainConfig(weight_decay=0.1)

    def step(state, target):
        grads = tree_map(lambda p: 2 * (p - target), state.params)
        loss = sum(float(((p - target) ** 2).sum()) for p in tree_leaves(state.params))
        params, opt, m = tadamw.adamw_update(grads, state.opt, state.params, tc, 0.1)
        return TrainState(params, opt), {"loss": torch.tensor(loss), **m}

    def batch_fn(i):
        return torch.tensor(float(i))

    def run_step(state, target):
        if fault is not None:
            fault(int(target), state)
        return step(state, target)

    params = {"a": torch.arange(3, dtype=torch.float32), "b": torch.ones(2, 2)}
    sup = tsup.Supervisor(run_step, batch_fn,
                          tsup.TrainLoopConfig(total_steps=6, checkpoint_every=2,
                                               checkpoint_dir=str(ckpt_dir), log_every=1,
                                               max_retries_per_step=2),
                          sleep_fn=lambda s: None)
    return sup, sup.run(TrainState(params, tadamw.adamw_init(params, tc)))


@pytest.mark.parametrize("where", ["inside adamw_update", "at the metrics' wait"])
def test_supervisor_restores_a_state_consumed_by_a_failed_step(where, tmp_path, monkeypatch):
    """The port's step updates its state in place, so a failure after the
    update began is not retried on that state (a retry would apply a second
    update on top of a partial one): the supervisor restores the last
    checkpoint and replays, and ends where a run without the fault ends.
    The fault strikes once, at step 3: inside ``adamw_update`` after its
    first leaf is written, or at the wait for the returned metrics (where a
    card's asynchronous error surfaces)."""
    _, want = _adamw_toy_run(tmp_path / "clean")
    seen = {}

    def fault(step, state):
        if step == 3 and "state" not in seen:
            seen.update(state=state, a=state.params["a"].clone(), calls=0)

    def strike():
        """Record the state as the fault found it, then fail."""
        state = seen["state"]
        seen["at_fault"] = (int(state.opt.step), not torch.equal(state.params["a"], seen["a"]))
        raise RuntimeError(f"injected fault {where}")

    if where == "inside adamw_update":
        slices = tadamw._slices

        def failing(t):
            if "at_fault" not in seen and "calls" in seen:
                seen["calls"] += 1
                if seen["calls"] == 8:      # global_norm's two leaves, leaf a's five operands
                    strike()
            return slices(t)

        monkeypatch.setattr(tadamw, "_slices", failing)
    else:
        wait = tsup._block_until_ready

        def failing(x):
            if "state" in seen and "at_fault" not in seen:
                strike()
            return wait(x)

        monkeypatch.setattr(tsup, "_block_until_ready", failing)

    sup, got = _adamw_toy_run(tmp_path / "faulty", fault)
    assert seen["at_fault"] == (4, True)        # the update had begun: step 3 -> 4, leaf a written
    assert sup.stats["retries"] == 1 and sup.stats["restores"] == 1
    assert [h["step"] for h in sup.history] == [0, 1, 2, 2, 3, 4, 5]
    for x, y in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(x, y)


def test_supervisor_raises_on_a_consumed_state_without_a_checkpoint(tmp_path):
    """With no checkpoint to restore, a consumed state stops the loop."""
    tc = TrainConfig()

    def step(state, batch):                    # a gradient of the wrong shape
        tadamw.adamw_update({"w": torch.ones(4)}, state.opt, state.params, tc, 0.1)

    params = {"w": torch.ones(3)}
    sup = tsup.Supervisor(step, lambda i: None,
                          tsup.TrainLoopConfig(total_steps=2, checkpoint_every=100,
                                               checkpoint_dir=str(tmp_path)),
                          sleep_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="no checkpoint to restore"):
        sup.run(TrainState(params, tadamw.adamw_init(params, tc)))
    assert sup.stats == {"retries": 1, "restores": 1, "stragglers": 0, "remeshes": 0}


# ---------------------------------------------------------------------------
# the other step builders and the abstract state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params_dtype", ["float32", "bfloat16"])
def test_abstract_state_equals_jax(params_dtype):
    """``abstract_state`` on meta tensors: the shapes and dtypes of JAX's
    ``ShapeDtypeStruct`` tree, leaf for leaf, the master only for bfloat16
    params."""
    from repro.configs import get_config as jget
    from repro.launch import steps as JS
    from repro.models import model as JM
    from repro_torch.configs import get_config as tget
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM

    kw = dict(params_dtype=params_dtype, moments_dtype="bfloat16")
    want = JS.abstract_state(JM.decl_model(jget("dbrx-132b")), JTrainConfig(**kw))
    got = TS.abstract_state(TM.decl_model(tget("dbrx-132b")), TrainConfig(**kw))
    assert (got.opt.master is None) == (want.opt.master is None) == (params_dtype == "float32")
    wl, gl = jax.tree.leaves(want), tree_leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape) and str(g.dtype)[6:] == str(w.dtype)


def test_prefill_and_decode_steps_equal_the_model():
    """``make_prefill_step`` is the last position's logits of ``forward``;
    ``make_decode_step`` is ``decode_step``."""
    from repro_torch.configs import get_config as tget
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as TM
    from repro_torch.parallel.sharding import init_params

    cfg = tget("tinyllama-1.1b").smoke()
    p = init_params(TM.decl_model(cfg), torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _, _ = TM.forward(p, cfg, tokens=tokens)
        last = TS.make_prefill_step(cfg)(p, {"tokens": tokens})
        torch.testing.assert_close(last, logits[:, -1], rtol=1e-5, atol=1e-6)
        cache = TM.init_cache(p, cfg, 2, 4)
        got, _ = TS.make_decode_step(cfg)(p, cache, tokens[:, :1], 0)
        want, _ = TM.decode_step(p, cfg, TM.init_cache(p, cfg, 2, 4), tokens[:, :1], 0)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the JAX init's gradient growth with depth
# ---------------------------------------------------------------------------

def test_gradient_norm_grows_with_depth_as_in_jax():
    """At the JAX package's init a dense stack's gradient norm grows by
    orders of magnitude with depth, in JAX's model and the port's alike
    (tinyllama's smoke config widened to d_model 256, 2 against 12
    layers: about 3e2 against 1e7). At tinyllama's full config (22 layers)
    the norm is about 1e17 on the card, 99 % of it the embedding's, so the
    clip at 1.0 shrinks 93 % of the gradients below AdamW's eps and a few
    steps barely move the loss (``chip_smoke.py``'s training phase;
    ``tools/grad_norm_depth.py`` compares the two packages at full width);
    the port keeps the rule."""
    import dataclasses

    from repro.configs import get_config as jget
    from repro.models import model as JM
    from repro.parallel.sharding import init_params as jinit
    from repro_torch.launch import steps as TS

    rs = np.random.RandomState(0)
    t = rs.randint(0, 512, (2, 65)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    norms = {}
    for layers in (2, 12):
        jc = dataclasses.replace(jget("tinyllama-1.1b").smoke(), n_layers=layers, d_model=256,
                                 n_heads=8, n_kv=2, head_dim=32)
        jp = jinit(JM.decl_model(jc), jax.random.PRNGKey(0))
        _, jg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jc, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        (_, _), tg = TS.grads_of(convert.params_from_numpy(jax.tree.map(np.asarray, jp)),
                                 convert.convert_config(jc),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
        norms[layers] = (float(jadamw.global_norm(jg)), float(tadamw.global_norm(tg)))
    (j2, t2), (j12, t12) = norms[2], norms[12]
    assert t2 == pytest.approx(j2, rel=1e-4)           # two layers: well conditioned
    assert j12 > 1e3 * j2 and t12 > 1e3 * t2, norms


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,argv,drop", [
    ("tinyllama-1.1b", ["--steps", "30", "--seq", "96"], 0.2),
    ("dbrx-132b", ["--steps", "50", "--seq", "64", "--dispatch", "multisplit"], 0.1),
], ids=["tinyllama", "dbrx-multisplit"])
def test_train_launcher_learns(arch, argv, drop, tmp_path, capsys):
    """``launch.train.main`` on the CPU: config, params, data pipeline,
    supervisor; the loss falls by JAX's margins (``tests/test_system.py``)."""
    sup = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
                       "--lr", "3e-3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "100",
                       *argv])
    losses = [h["loss"] for h in sup.history]
    assert len(losses) >= 2 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - drop, f"no learning: {losses}"
    assert sup.ckpt.latest_step() == int(argv[1])
    assert "[train] done" in capsys.readouterr().out


def test_train_launcher_needs_the_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--arch", "tinyllama-1.1b", "--smoke"])


def test_training_path_loads_neither_jax_nor_repro():
    """A step of ``make_train_step`` (dbrx's smoke config, the multisplit
    dispatch, B11's route through the door on CPU tensors) and a
    checkpoint save, in a fresh process, import no module of JAX and none
    of the JAX package."""
    code = (
        "import sys, tempfile, torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.configs.base import TrainConfig\n"
        "from repro_torch.launch import steps as S\n"
        "from repro_torch.models import model as M\n"
        "from repro_torch.optim import adamw_init\n"
        "from repro_torch.checkpoint import save_checkpoint\n"
        "from repro_torch.parallel.sharding import init_params\n"
        "cfg = get_config('dbrx-132b').smoke()\n"
        "p = init_params(M.decl_model(cfg), torch.Generator().manual_seed(0))\n"
        "tc = TrainConfig()\n"
        "st = S.TrainState(p, adamw_init(p, tc))\n"
        "g = torch.Generator().manual_seed(1)\n"
        "b = {'tokens': torch.randint(0, cfg.vocab, (2, 32), generator=g),\n"
        "     'labels': torch.randint(0, cfg.vocab, (2, 32), generator=g)}\n"
        "st, m = S.make_train_step(cfg, tc)(st, b)\n"
        "assert torch.isfinite(m['loss'])\n"
        "save_checkpoint(tempfile.mkdtemp(), 1, st)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
