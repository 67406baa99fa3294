"""The port's sharded training step (``launch.steps.make_train_step`` on a
mesh, with ``optim.adamw_update``, ``checkpoint``, ``runtime.Supervisor``
and ``launch.train``) against the JAX package's jitted, sharded step on
the CPU.

One spawn of eight gloo ranks runs every case in one session
(``python worker.py RANK``, a file store under ``tmp_path``, one npz a
rank); ranks 0-3 and 4-7 form two ``(2, 2)`` ``(data, model)`` meshes
(every rank builds both). One JAX subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` runs
``jax.jit(make_train_step(...), in_shardings=(state_shardings,
batch_sharding), out_shardings=(state_shardings, None))`` under the same
meshes. The inputs are JAX's ``init_params`` and seeded numpy batches,
drawn once here; the port receives the state through
``convert.train_state_from_numpy(..., shardings=...)``.

* Steps (``STEPS`` of them, (4, 32) tokens, float32 ``smoke()`` configs):
  tinyllama; tinyllama with ``fsdp``, with ``accum_steps=2`` and with
  ``params_dtype="bfloat16"`` (the float32 master); dbrx with
  ``dispatch="multisplit_ep"``. After each step the loss and every metric
  are held to ``LOSS_RTOL`` (``tests/test_torch_train_grads.py``'s; the
  norm and moments of bfloat16 gradients to one bfloat16 unit,
  ``BF16_NORM_RTOL`` and ``BF16_MOMENT_RTOL``, and the master they update
  to the rate, ``BF16_PARAM_ATOL``), the
  step counter exactly, the moments to ``MOMENT_RTOL`` of each leaf's
  largest and the float32 parameters (the master where there is one) to
  ``PARAM_ATOL``, a tenth of the rate (``tests/test_torch_train_grads.py``'s
  train step: Adam's update of an element whose gradient is rounding noise
  is a coin flip of up to the rate); bfloat16 parameters are their
  master's cast. The same against the port's own one-process step.
* The collectives of a step (``CommDebugMode``): all-reduces, c10d's
  gathers and reduce-scatters, no functional all-gather (gloo does not run
  that one on CUDA tensors).
* A checkpoint of dbrx's sharded state: one npz a rank and one COMMIT;
  restored on its mesh, on a ``(1, 4)`` mesh and in one process, bitwise.
* ``place`` leaves a leaf placed by its sharding alone and refuses one
  placed by another.
* The supervisor with a fault on rank 1 alone, mid-step (after the step's
  collectives, before its update) and after its update began
  (``StateConsumedError``), in a world of ranks 0-3 started after the
  cases above: every rank restores the same step, and the final state is
  bitwise a clean run's.
* ``launch.train.main`` on four ranks (``--smoke --device cpu``, ranks 4-7
  in a world of their own after their cases): rank 0 alone prints, and a
  second run resumes from the rank-sharded checkpoint.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.parallel.sharding import init_params as jinit
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init
from repro_torch.parallel.sharding import tree_leaves

import _torch_threads

_torch_threads.pin()

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 8
B, S, STEPS = 4, 32, 2
STEP_KW = dict(lr=1e-2, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
MOMENT_RTOL = 1e-4
PARAM_ATOL = 0.1 * STEP_KW["lr"]
# a bfloat16 parameter's gradient is bfloat16 (JAX's too): an element whose
# float32 sum differs in its last bits may round to the neighbouring value,
# one unit, 2^-8 to 2^-7 of it. So the norm of those gradients is held to
# 2^-8, their first moment to 2^-7 and their second (a square) to 2^-6 of
# the leaf's largest.
BF16_NORM_RTOL = 2.0 ** -8
BF16_MOMENT_RTOL = (2.0 ** -7, 2.0 ** -6)
# an element whose two gradients nearly cancel in the first moment takes an
# Adam step of any size up to the rate when a gradient moves by that unit:
# the bfloat16 case's master is held to the rate itself
BF16_PARAM_ATOL = STEP_KW["lr"]
# case -> (arch, half of the ranks, fsdp, TrainConfig fields)
CASES = {
    "tinyllama": ("tinyllama-1.1b", 0, False, {}),
    "fsdp": ("tinyllama-1.1b", 0, True, {}),
    "accum": ("tinyllama-1.1b", 0, False, {"accum_steps": 2}),
    "bf16": ("tinyllama-1.1b", 1, False, {"params_dtype": "bfloat16"}),
    "dbrx": ("dbrx-132b", 1, False, {}),
}
ONE_PROCESS = ("tinyllama", "dbrx")
JAX_SPLIT = (("tinyllama", "fsdp", "accum"), ("dbrx", "bf16"))   # two JAX processes


def _cfg(arch: str):
    cfg = jget_config(arch).smoke()
    if cfg.moe.num_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit_ep"))
    return cfg


_JAX = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import ModelConfig, MoEConfig, ParallelConfig, SSMConfig, TrainConfig
from repro.launch import steps as S
from repro.models import model as M
from repro.optim import adamw_init
from repro.parallel.sharding import is_decl
import os, time
while not os.path.exists("{inputs}"):          # drawn while this process starts
    time.sleep(0.05)
inp = np.load("{inputs}")
cfgs, cases = json.loads('{cfgs}'), json.loads('{cases}')
auto = (jax.sharding.AxisType.Auto,) * 2
meshes = [jax.sharding.Mesh(np.array(jax.devices()[4 * i:4 * i + 4]).reshape(2, 2),
                            ("data", "model"), axis_types=auto) for i in (0, 1)]
out = {{}}
for name in {names}:
    arch, half, fsdp, kw = cases[name]
    d = cfgs[arch]
    cfg = ModelConfig(**dict(d, moe=MoEConfig(**d["moe"]), ssm=SSMConfig(**d["ssm"])))
    decls = M.decl_model(cfg)
    n = len(jax.tree.leaves(decls, is_leaf=is_decl))
    tc = TrainConfig(**dict({step_kw}, **kw))
    params = jax.tree.unflatten(jax.tree.structure(decls, is_leaf=is_decl),
                                [jnp.asarray(inp[f"{{arch}}:{{i}}"]) for i in range(n)])
    params = jax.tree.map(lambda a: a.astype(tc.params_dtype), params)
    mesh = meshes[half]
    with jax.set_mesh(mesh):
        st_sh = S.state_shardings(decls, ParallelConfig(fsdp=fsdp), mesh, tc)
        b_sh = S.batch_sharding(cfg, mesh, {{"tokens": inp["tokens0"], "labels": inp["labels0"]}})
        step = jax.jit(S.make_train_step(cfg, tc), in_shardings=(st_sh, b_sh),
                       out_shardings=(st_sh, None))
        state = jax.device_put(S.TrainState(params, adamw_init(params, tc)), st_sh)
        for t in range({steps}):
            batch = {{"tokens": inp[f"tokens{{t}}"], "labels": inp[f"labels{{t}}"]}}
            state, m = step(state, jax.device_put(batch, b_sh))
            for k, v in m.items():
                out[f"{{name}}:{{t}}:m:{{k}}"] = np.asarray(v, np.float64)
            for i, leaf in enumerate(jax.tree.leaves(state)):
                out[f"{{name}}:{{t}}:s:{{i}}"] = np.asarray(leaf).astype(np.float32)
np.savez("{out}", **out)
"""

_WORKER = """
import json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, inputs, out, tmp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4], sys.argv[5], sys.argv[6])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
import ml_dtypes
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig, MoEConfig, ParallelConfig, SSMConfig, TrainConfig
from repro_torch.launch import steps as St
from repro_torch.models import model as M
from repro_torch.optim import AdamWState, adamw as A
from repro_torch.parallel import sharding as S
from repro_torch.runtime import supervisor as sup_mod
import os, time
while not os.path.exists(inputs):                # drawn while the ranks start
    time.sleep(0.05)
inp = np.load(inputs)
cfgs, cases = json.loads('{cfgs}'), json.loads('{cases}')
half = rank // 4
lead = rank % 4 == 0
meshes = [DeviceMesh("cpu", torch.arange(4 * i, 4 * i + 4).view(2, 2),
                     mesh_dim_names=("data", "model")) for i in (0, 1)]
other = DeviceMesh("cpu", torch.arange(4, 8).view(1, 4), mesh_dim_names=("data", "model"))
mesh = meshes[half]
got = {{}}

def cfg_of(arch):
    d = cfgs[arch]
    return ModelConfig(**dict(d, moe=MoEConfig(**d["moe"]), ssm=SSMConfig(**d["ssm"])))

def batch_at(t):
    return {{"tokens": torch.from_numpy(inp[f"tokens{{t}}"]),
             "labels": torch.from_numpy(inp[f"labels{{t}}"])}}

def numpy_state(arch, tc, decls):
    # JAX's train state at init as numpy arrays, in the abstract state's tree
    n = len(S.tree_leaves(decls))
    p = [inp[f"{{arch}}:{{i}}"] for i in range(n)]
    if tc.params_dtype == "bfloat16":
        p = [a.astype(ml_dtypes.bfloat16) for a in p]
    zeros = [np.zeros(a.shape, np.float32) for a in p]
    master = [a.astype(np.float32) for a in p] if tc.params_dtype != "float32" else None
    unflat = lambda leaves: S.tree_unflatten(decls, leaves)
    return St.TrainState(unflat(p), AdamWState(np.asarray(0, np.int32), unflat(zeros),
                                               unflat(list(zeros)),
                                               None if master is None else unflat(master)))

def gathered(state):
    # copies: the state is updated in place by the next step
    return [S.gather_full(x).float().numpy().copy() for x in S.tree_leaves(state)]

def comm_counts(mode):
    return {{str(k): v for k, v in mode.get_comm_counts().items()}}

# ---- the train steps
for name, (arch, h, fsdp, kw) in cases.items():
    if h != half:
        continue
    cfg = cfg_of(arch)
    decls = M.decl_model(cfg)
    tc = TrainConfig(**dict({step_kw}, **kw))
    sh = St.state_shardings(decls, ParallelConfig(fsdp=fsdp), mesh, tc)
    state = convert.train_state_from_numpy(numpy_state(arch, tc, decls), shardings=sh)
    step = St.make_train_step(cfg, tc, backend="vmap")
    with S.set_mesh(mesh):
        for t in range({steps}):
            mode = CommDebugMode()
            with mode:
                batch = S.place(batch_at(t), St.batch_sharding(cfg, mesh, batch_at(t)))
                state, m = step(state, batch)
            for k, v in m.items():
                got[f"{{name}}:{{t}}:m:{{k}}"] = np.asarray(float(v))
            leaves = gathered(state)
            if lead:
                for i, a in enumerate(leaves):
                    got[f"{{name}}:{{t}}:s:{{i}}"] = a
        got[f"{{name}}:comms"] = np.asarray(json.dumps(comm_counts(mode)))
        got[f"{{name}}:placements"] = np.asarray(json.dumps(
            [str(x.placements) for x in S.tree_leaves(state.params)]))
    if name == "dbrx":
        dbrx_state, dbrx_decls, dbrx_tc = state, decls, tc

# ---- a checkpoint of dbrx's sharded state (ranks 4-7)
if half == 1:
    ck = tmp + "/ckpt"
    save_checkpoint(ck, 2, dbrx_state, group=dist.new_group(
        ranks=list(range(4, 8)), backend="gloo", use_local_synchronization=True))
    with S.set_mesh(mesh):
        back, step_no = load_checkpoint(ck, dbrx_state)
        same = all(torch.equal(S.local_shard(a)[0], S.local_shard(b)[0])
                   for a, b in zip(S.tree_leaves(back), S.tree_leaves(dbrx_state)))
        whole = gathered(dbrx_state)
    like = S.place(St.abstract_state(dbrx_decls, dbrx_tc), St.state_shardings(
        dbrx_decls, ParallelConfig(), other, dbrx_tc))
    with S.set_mesh(other):
        moved, _ = load_checkpoint(ck, like)
        on_other = gathered(moved)
    got["ckpt:same_mesh"] = np.asarray(same and step_no == 2)
    # a nested mesh on another thread (remat's recompute on the card's
    # autograd thread) leaves the outer block's implicit replication on
    import threading
    leaf = S.tree_leaves(dbrx_state.params)[0]
    with S.set_mesh(mesh):
        def nested():
            with S.set_mesh(mesh):
                pass
        worker = threading.Thread(target=nested)
        worker.start()
        worker.join()
        try:
            got["implicit:after_thread"] = np.asarray(
                bool(torch.equal(S.gather_full(leaf + torch.zeros(leaf.shape)),
                                 S.gather_full(leaf))))
        except Exception as e:
            got["implicit:after_thread"] = np.asarray(str(e)[:300])
    placed = S.place(dbrx_state, St.state_shardings(dbrx_decls, ParallelConfig(), mesh, dbrx_tc))
    got["place:same"] = np.asarray(all(a is b for a, b in zip(S.tree_leaves(placed),
                                                              S.tree_leaves(dbrx_state))))
    try:
        S.place(dbrx_state, St.state_shardings(dbrx_decls, ParallelConfig(fsdp=True), mesh,
                                               dbrx_tc))
        got["place:other"] = np.asarray("placed")
    except ValueError as e:
        got["place:other"] = np.asarray(str(e))
    got["ckpt:other_mesh"] = np.asarray(all(np.array_equal(a.view(np.int32), b.view(np.int32))
                                            for a, b in zip(on_other, whole)))
    if lead:
        for i, a in enumerate(whole):
            got[f"ckpt:whole:{{i}}"] = a
        got["ckpt:dir"] = np.asarray(tmp + "/ckpt")

# ---- the supervisor, a fault on rank 1 only (ranks 0-3, a world of their own)
def supervised(fault, ckpt_dir):
    cfg = cfg_of("tinyllama-1.1b")
    decls = M.decl_model(cfg)
    tc = TrainConfig(**{step_kw})
    state = convert.train_state_from_numpy(numpy_state("tinyllama-1.1b", tc, decls),
                                           shardings=St.state_shardings(decls, ParallelConfig(),
                                                                        mesh, tc))
    step = St.make_train_step(cfg, tc, backend="vmap")
    seen = {{}}

    def run_step(st, batch):
        if fault is not None and rank == 1 and int(S.local_shard(st.opt.step)[0]) == 3 \\
                and "struck" not in seen:
            seen["struck"] = fault
        return step(st, batch)

    loop = sup_mod.TrainLoopConfig(total_steps=5, checkpoint_every=2, checkpoint_dir=ckpt_dir,
                                   log_every=1)
    sup = sup_mod.Supervisor(run_step, lambda i: S.place(batch_at(i % {steps}), St.batch_sharding(
        cfg, mesh, batch_at(i % {steps}))), loop, sleep_fn=lambda s: None)
    norm, slices = A.global_norm, A._slices

    def after_norm(tree):
        out = norm(tree)
        if seen.get("struck") == "mid-step" and "done" not in seen:
            seen["done"] = True
            raise RuntimeError("injected fault mid-step")
        return out

    calls = [0]

    def in_update(t):
        if seen.get("struck") == "consumed" and "done" not in seen:
            calls[0] += 1
            if calls[0] == 40:
                seen["done"] = True
                raise RuntimeError("injected fault inside the update")
        return slices(t)

    A.global_norm, A._slices = after_norm, in_update
    try:
        with S.set_mesh(mesh):
            final = sup.run(state)
            leaves = gathered(final)
    finally:
        A.global_norm, A._slices = norm, slices
    return sup, leaves, seen

dist.destroy_process_group()
dist.init_process_group("gloo", init_method="file://" + store + ("_sup", "_launch")[half],
                        rank=rank % 4, world_size=4)
if half == 0:
    mesh = DeviceMesh("cpu", torch.arange(4).view(2, 2), mesh_dim_names=("data", "model"))
    for fault in (None, "mid-step", "consumed"):
        sup, leaves, seen = supervised(fault, f"{{tmp}}/sup_{{fault}}")
        got[f"sup:{{fault}}:stats"] = np.asarray(json.dumps(
            [sup.stats["retries"], sup.stats["restores"], [h["step"] for h in sup.history],
             seen.get("done", False)]))
        if lead:
            for i, a in enumerate(leaves):
                got[f"sup:{{fault}}:s:{{i}}"] = a

# ---- the launcher on four ranks (ranks 4-7, a world of their own)
if half == 1:
    import contextlib, io
    from repro_torch.launch import steps as steps_mod, train
    calls = [0]
    make = steps_mod.make_train_step

    def counting(*a, **k):
        fn = make(*a, **k)

        def step(*x):
            calls[0] += 1
            return fn(*x)
        return step

    steps_mod.make_train_step = counting
    argv = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--batch", "4", "--seq",
            "32", "--ckpt-every", "2", "--ckpt-dir", tmp + "/launch"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        first = train.main(argv + ["--steps", "4"])
        done = calls[0]
        second = train.main(argv + ["--steps", "6"])
    np.savez(out.replace(".npz", "_launch.npz"), text=np.asarray(text.getvalue()),
             calls=np.asarray([done, calls[0] - done]),
             loss=np.asarray([h["loss"] for h in first.history]),
             latest=np.asarray(second.ckpt.latest_step()))
np.savez(out, **got)
dist.destroy_process_group()
"""


def _inputs():
    """JAX's parameters of both smoke configs (``init_params`` jitted: one
    compile a config) and the seeded batches."""
    inputs = {}
    for arch in sorted({a for a, *_ in CASES.values()}):
        decls = JM.decl_model(_cfg(arch))
        params = jax.jit(lambda key: jinit(decls, key))(jax.random.PRNGKey(0))
        for i, a in enumerate(jax.tree.leaves(params)):
            inputs[f"{arch}:{i}"] = np.asarray(a)
    rs = np.random.RandomState(0)
    for t in range(STEPS):
        tok = rs.randint(0, 512, (B, S + 1)).astype(np.int32)
        lab = tok[:, 1:].copy()
        lab[0, :3] = -1                                  # unlabelled positions count in no mean
        inputs[f"tokens{t}"], inputs[f"labels{t}"] = tok[:, :-1].copy(), lab
    return inputs


def _one_process(inputs, name):
    """The port's one-process step on the same inputs: the metrics and the
    state's leaves after each step."""
    arch, _, _, kw = CASES[name]
    cfg = convert.convert_config(_cfg(arch))
    if cfg.moe.num_experts:                       # multisplit_ep with no mesh: multisplit
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit"))
    tc = TrainConfig(**STEP_KW, **kw)
    n = len(tree_leaves(TM.decl_model(cfg)))
    from repro_torch.parallel.sharding import tree_unflatten
    params = tree_unflatten(TM.decl_model(cfg), [torch.from_numpy(inputs[f"{arch}:{i}"].copy())
                                                 for i in range(n)])
    state = TS.TrainState(params, adamw_init(params, tc))
    step = TS.make_train_step(cfg, tc, backend="vmap")
    out = {}
    for t in range(STEPS):
        batch = {k: torch.from_numpy(inputs[f"{k}{t}"]) for k in ("tokens", "labels")}
        state, m = step(state, batch)
        for k, v in m.items():
            out[f"{name}:{t}:m:{k}"] = np.asarray(float(v))
        for i, leaf in enumerate(tree_leaves(state)):
            out[f"{name}:{t}:s:{i}"] = leaf.float().numpy().copy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, the port's one-process results, each rank's results,
    ranks 4-7's launcher results, the work directory)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    cfgs = {arch: dataclasses.asdict(_cfg(arch)) for arch in {a for a, *_ in CASES.values()}}
    fmt = dict(inputs=tmp / "inputs.npz", cfgs=json.dumps(cfgs), cases=json.dumps(CASES),
               step_kw=STEP_KW, steps=STEPS)
    path = str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", "")
    # the JAX twins compile at LLVM's lowest optimization level (no change
    # of float semantics, a third less compile time), in two processes
    jax_env = dict(os.environ, PYTHONPATH=path, XLA_FLAGS=(
        "--xla_force_host_platform_device_count=8 --xla_backend_optimization_level=0 "
        "--xla_llvm_disable_expensive_passes=true"))
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX).format(out=tmp / f"jax{i}.npz",
                                                            names=list(names), **fmt)],
        env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, names in enumerate(JAX_SPLIT)]
    script = tmp / "worker.py"
    script.write_text(textwrap.dedent(_WORKER).format(**fmt))
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp / "inputs.npz"),
                               str(tmp / f"rank{r}.npz"), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    inputs = _inputs()
    np.savez(tmp / "drawn.npz", **inputs)
    os.replace(tmp / "drawn.npz", tmp / "inputs.npz")     # the processes wait for this name
    one = {}
    for name in ONE_PROCESS:
        one.update(_one_process(inputs, name))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    jax_outs = [p.communicate(timeout=600)[0] for p in jax_procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-5000:]}"
    for p, out in zip(jax_procs, jax_outs):
        assert p.returncode == 0, out[-5000:]
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    launch = [dict(np.load(tmp / f"rank{r}_launch.npz")) for r in range(4, 8)]
    want = {}
    for i in range(len(JAX_SPLIT)):
        want.update(np.load(tmp / f"jax{i}.npz"))
    return want, one, ranks, launch, tmp


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _n_params(name):
    return len(tree_leaves(TM.decl_model(convert.convert_config(_cfg(CASES[name][0])))))


def _check_state(got, want, name, t, what):
    """The state's leaves after step ``t`` of case ``name`` against
    ``want``'s, at the tolerances stated above."""
    n = _n_params(name)
    bf16 = CASES[name][3].get("params_dtype") == "bfloat16"
    leaves = sorted(int(k.rsplit(":", 1)[1]) for k in want if k.startswith(f"{name}:{t}:s:"))
    assert len(leaves) == 4 * n + 1 if bf16 else 3 * n + 1
    for i in leaves:
        g, w = got[f"{name}:{t}:s:{i}"], want[f"{name}:{t}:s:{i}"]
        assert g.shape == w.shape, (what, i)
        if i == n:                                        # the step counter
            assert g == w == t + 1, (what, i)
        elif n < i <= 3 * n:                              # the moments
            tol = BF16_MOMENT_RTOL[i > 2 * n] if bf16 else MOMENT_RTOL
            assert _rel(g, w) <= tol, (what, name, t, i, _rel(g, w))
        elif not (bf16 and i < n):                        # float32 parameters or the master
            np.testing.assert_allclose(g, w, atol=BF16_PARAM_ATOL if bf16 else PARAM_ATOL,
                                       rtol=0, err_msg=f"{what} {i}")
    if bf16:                                              # the parameters are the master's cast
        for i in range(n):
            master = torch.from_numpy(got[f"{name}:{t}:s:{3 * n + 1 + i}"])
            np.testing.assert_array_equal(got[f"{name}:{t}:s:{i}"],
                                          master.to(torch.bfloat16).float().numpy())


def _check_metrics(got, want, name, t):
    keys = sorted(k for k in want if k.startswith(f"{name}:{t}:m:"))
    assert len(keys) == 7                                 # JAX's metrics and AdamW's two
    bf16 = CASES[name][3].get("params_dtype") == "bfloat16"
    for k in keys:
        tol = BF16_NORM_RTOL if bf16 and k.endswith(":grad_norm") else LOSS_RTOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol, atol=0, err_msg=k)


def _half(ranks, name):
    return ranks[4 * CASES[name][1]:4 * CASES[name][1] + 4]


@pytest.mark.parametrize("t", range(STEPS))
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_jax(runs, name, t):
    """Each of the mesh's ranks reports JAX's metrics; the gathered state
    is JAX's."""
    want, _, ranks, _, _ = runs
    mine = _half(ranks, name)
    for got in mine:
        _check_metrics(got, want, name, t)
    _check_state(mine[0], want, name, t, "jax")


@pytest.mark.parametrize("t", range(STEPS))
@pytest.mark.parametrize("name", ONE_PROCESS)
def test_sharded_step_equals_the_one_process_step(runs, name, t):
    _, one, ranks, _, _ = runs
    got = _half(ranks, name)[0]
    _check_metrics(got, one, name, t)
    _check_state(got, one, name, t, "one process")


@pytest.mark.parametrize("name", list(CASES))
def test_a_step_reduces_and_never_gathers_functionally(runs, name):
    """The collectives of a step: all-reduces (the gradients over the
    data axes, the norm, the partial sums of the forward), c10d's gathers
    (an fsdp weight at use, ``multisplit_ep``'s experts' whole view) and
    reduce-scatters (an fsdp gradient to its shard); no functional
    all-gather, which gloo does not run on CUDA tensors."""
    _, _, ranks, _, _ = runs
    for got in _half(ranks, name):
        counts = json.loads(str(got[f"{name}:comms"]))
        allowed = ("all_reduce", "allreduce", "_allgather_base_", "_reduce_scatter_base_")
        assert all(any(a in k for a in allowed) for k in counts), counts
        assert not any("functional" in k and "gather" in k for k in counts), counts
        assert any("reduce" in k for k in counts)
        assert ("_reduce_scatter_base_" in json.dumps(counts)) == (name == "fsdp")


def test_fsdp_shards_the_state_over_data(runs):
    _, _, ranks, _, _ = runs
    plain = json.loads(str(ranks[0]["tinyllama:placements"]))
    fsdp = json.loads(str(ranks[0]["fsdp:placements"]))
    assert not any("Shard" in p.split(",")[0] for p in plain)
    assert sum("Shard" in p.split(",")[0] for p in fsdp) == len(fsdp)


def test_checkpoint_restores_on_the_mesh_on_another_and_in_one_process(runs):
    """dbrx's sharded state saved on its (2, 2) mesh: one npz a rank and one
    COMMIT, each element written once; restored on the mesh and on a
    (1, 4) mesh bitwise, and in one process bitwise the gathered state."""
    _, _, ranks, _, _ = runs
    half = ranks[4:]
    assert all(bool(r["ckpt:same_mesh"]) and bool(r["ckpt:other_mesh"]) for r in half)
    d = Path(str(half[0]["ckpt:dir"])) / "step_00000002"
    assert sorted(p.name for p in d.iterdir()) == (
        ["COMMIT"] + [f"host_{r:05d}.npz" for r in range(4, 8)] + ["manifest.json"])
    assert sorted(p.name for p in d.parent.iterdir()) == ["step_00000002"]
    meta = json.loads((d / "manifest.json").read_text())
    assert meta["n_hosts"] == 4
    for rec in meta["leaves"]:                            # the pieces tile the leaf once
        sizes = [np.prod([b - a for a, b in sl]) for _, sl in rec["shards"]]
        assert sum(sizes) == np.prod(rec["shape"]), rec["path"]
    cfg = convert.convert_config(_cfg("dbrx-132b"))
    like = TS.abstract_state(TM.decl_model(cfg), TrainConfig(**STEP_KW))
    whole, step = load_checkpoint(d.parent, like)
    assert step == 2
    leaves = tree_leaves(whole)
    assert len(leaves) == len([k for k in half[0] if k.startswith("ckpt:whole:")])
    for i, leaf in enumerate(leaves):
        want = half[0][f"ckpt:whole:{i}"]
        np.testing.assert_array_equal(leaf.float().numpy().view(np.int32), want.view(np.int32))


def test_a_nested_mesh_on_another_thread_keeps_implicit_replication(runs):
    """After a ``set_mesh`` block on another thread has come and gone, a
    plain tensor still meets a sharded DTensor as a replicated one in the
    outer block (gloo ranks, dbrx's first leaf)."""
    _, _, ranks, _, _ = runs
    for r in ranks[4:]:
        assert str(r["implicit:after_thread"]) == "True", str(r["implicit:after_thread"])


def test_place_keeps_a_placed_leaf_and_refuses_another_layout(runs):
    """``place`` of dbrx's sharded state by its own shardings returns every
    leaf as it is; by the ``fsdp`` shardings it raises, naming both
    layouts, where it would have kept the wrong one."""
    _, _, ranks, _, _ = runs
    for r in ranks[4:]:
        assert bool(r["place:same"])
        assert "asked for" in str(r["place:other"]), str(r["place:other"])


@pytest.mark.parametrize("fault", ["mid-step", "consumed"])
def test_supervisor_recovers_a_fault_on_one_rank(runs, fault):
    """Rank 1 alone fails at step 3: after the step's collectives and before
    its update, or inside its update (``StateConsumedError``). The ranks
    agree: every rank counts one retry and one restore, replays from step 2
    (the others had updated their state), and ends bitwise where a clean
    run ends."""
    _, _, ranks, _, _ = runs
    for r in range(4):
        retries, restores, steps, done = json.loads(str(ranks[r][f"sup:{fault}:stats"]))
        assert (retries, restores, steps) == (1, 1, [0, 1, 2, 2, 3, 4]), (r, retries, restores)
        assert done == (r == 1)
    clean = json.loads(str(ranks[0]["sup:None:stats"]))
    assert clean[:3] == [0, 0, [0, 1, 2, 3, 4]]
    keys = [k for k in ranks[0] if k.startswith("sup:None:s:")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k.replace("None", fault)].view(np.int32),
                                      ranks[0][k].view(np.int32), err_msg=k)


def test_train_launcher_on_four_ranks(runs):
    """``launch.train.main`` on four gloo ranks: a (4,) data mesh, rank 0
    alone prints (the mesh first, the losses last); a second run of six
    steps resumes from the rank-sharded checkpoint of step 4 and runs two."""
    *_, launch, _ = runs
    text = str(launch[0]["text"])
    assert text.splitlines()[0] == "[train] mesh {'data': 4} over 4 rank(s), gloo on cpu"
    assert "last loss=" in text and text.count("[train] done") == 2
    assert all(str(r["text"]) == "" for r in launch[1:])
    for r in launch:
        assert r["calls"].tolist() == [4, 2] and int(r["latest"]) == 6
        assert np.isfinite(r["loss"]).all()


class _MeshShape:
    """What ``set_mesh`` and ``placements_of`` read of a mesh: its size,
    axis names and shape."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self):
        return int(np.prod(self.shape))


def test_nested_set_mesh_keeps_the_outer_implicit_replication():
    """remat's recomputation enters the mesh again inside the backward, on
    this thread or on the card's autograd thread; on leaving, the outer
    block must still treat plain tensors as replicated (DTensor's own
    context manager clears the switch on exit). The switch is read where
    DTensor keeps it: a torch that moves it fails here."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import get_mesh, set_mesh

    outer, inner = _MeshShape((2, 2), ("data", "model")), _MeshShape((2, 2), ("data", "model"))
    switch = lambda: DTensor._op_dispatcher._allow_implicit_replication
    assert not switch()
    def recompute():                     # the card's autograd thread, a context of its own
        with set_mesh(inner):
            seen.append(get_mesh() is inner)

    seen = []
    with set_mesh(outer):
        assert switch() and get_mesh() is outer
        with set_mesh(inner):
            assert switch() and get_mesh() is inner
        assert switch() and get_mesh() is outer
        with set_mesh(None):
            assert get_mesh() is None
        assert switch()
        worker = threading.Thread(target=recompute)
        worker.start()
        worker.join()
        assert seen == [True]
        assert switch() and get_mesh() is outer
    assert not switch() and get_mesh() is None


def test_a_one_wide_axis_shards_nothing():
    """A (1, 2) mesh (dbrx's expert-parallel training on two ranks): the
    ``data`` axis of size 1 places ``Replicate``, as JAX's sharding over a
    one-device axis splits nothing; DTensor would refuse to reshape a
    dimension it holds sharded over it."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import P, placements_of

    assert placements_of(P("data", None, "model"), _MeshShape((1, 2), ("data", "model"))) == (
        Replicate(), Shard(2))
    assert placements_of(P("data", None, "model"), _MeshShape((2, 2), ("data", "model"))) == (
        Shard(0), Shard(2))
