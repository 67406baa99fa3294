"""The port's model layers over a process group on the CPU: ``multisplit_ep``
(``models.moe._dispatch_multisplit_ep``), the ``tp > 1`` branches of
``models.layers.multihead_attention``, and a sharded forward and decode of
two smoke models, each against the JAX package under a mesh of XLA host
devices.

One spawn of eight gloo ranks runs every case in one session
(``python worker.py RANK``, a file store under ``tmp_path``, one npz a
rank), and one JAX subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` computes JAX's side
under the same meshes. The inputs (JAX's ``init_params`` and seeded numpy
draws) are made once here and read by both.

* ``multisplit_ep`` on a ``(2, 4)`` ``(data, model)`` mesh with
  ``tests/test_moe_ep.py``'s config (d 64, 8 experts top-2) at capacity
  factors 8.0 (nothing drops) and 1.0 (tokens drop: the capacity is a data
  shard's): output, drop fraction and the gradients of ``sum(y**2)`` (every
  parameter and the input) against JAX's ``multisplit_ep``; at 8.0 also
  against the port's one-process ``multisplit`` dispatch. The
  ``multisplit`` dispatch under the same mesh (whole tensors on every
  rank) against JAX's GSPMD one.
* ``multihead_attention`` with ``tp = 4``: the kv-repeat branch (8 heads,
  kv 2), the pad branch (6 heads, ``pad_heads``), the head-dim fallback (6
  heads, no pad). JAX's pad branch fails to lower under the ``(2, 4)`` mesh
  at 6 heads (a sharding of a 2-wide dimension over ``model`` = 4;
  ``ROADMAP.md`` §C), so the pad case is held to JAX's function with no
  mesh: the padded heads are cut, so the value is the same.
* A ``(2, 2)`` mesh: tinyllama and dbrx ``smoke()`` (dbrx with
  ``dispatch="multisplit_ep"``) and a GQA variant of dbrx's smoke config (12
  heads over kv 2: the full config's branch, kv heads over ``model`` and q
  heads grouped with them), forward on (2, 64) tokens and 4 decode steps on
  a time-sharded cache, against JAX's ``forward`` and ``decode_step`` under
  its own (2, 2) mesh at ``tests/test_torch_models.py``'s tolerance. Ranks
  0-3 and 4-7 form two such meshes at once. The collectives the forward and
  a decode step issue are counted (``CommDebugMode``): only all-reduces,
  and no functional all-gather (gloo does not run that one on CUDA
  tensors; the port gathers by c10d's).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig, MoEConfig
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.parallel.sharding import init_params as jinit
from repro_torch import convert
from repro_torch.models import moe as tmoe

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 8
ATOL = 1e-5                     # multisplit_ep's output and drop against JAX's
GRAD_TOL = 1e-4                 # its gradients, relative to each leaf's largest
ATTN_TOL = 2e-5                 # the attention branches
LOGIT_RTOL = 2e-4               # tests/test_torch_models.py's
CAPACITY_FACTORS = (8.0, 1.0)
ATTN_CASES = {"repeat": (8, 2, False), "pad": (6, 2, True), "head_dim": (6, 2, False)}
MODELS = {"tinyllama-1.1b": {}, "dbrx-132b": {}, "dbrx-gqa": {"n_heads": 12, "n_kv": 2}}
B, S, DECODE_STEPS, MAX_LEN = 2, 64, 4, 8


def _moe_cfg(cf: float, dispatch: str = "multisplit_ep") -> ModelConfig:
    return ModelConfig(name="t", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv=4,
                       d_ff=128, vocab=128, dtype="float32",
                       moe=MoEConfig(num_experts=8, top_k=2, dispatch=dispatch,
                                     capacity_factor=cf))


def _model_cfg(name: str) -> ModelConfig:
    arch = "dbrx-132b" if name == "dbrx-gqa" else name
    cfg = dataclasses.replace(jget_config(arch).smoke(), **MODELS[name])
    if cfg.moe.num_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit_ep"))
    return cfg


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


_JAX = """
import json, dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro.models import layers, moe, model as M
from repro.parallel.sharding import init_params, is_decl
inp = np.load("{inputs}")
cfgs = json.loads('{cfgs}')
def cfg_of(d, **moe_kw):
    return ModelConfig(**dict(d, moe=MoEConfig(**dict(d["moe"], **moe_kw)),
                              ssm=SSMConfig(**d["ssm"])))
auto = lambda n: (jax.sharding.AxisType.Auto,) * n
mesh24 = jax.make_mesh((2, 4), ("data", "model"), axis_types=auto(2))
mesh22 = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
                           axis_types=auto(2))
def tree(decl, prefix):
    leaves = [jnp.asarray(inp[f"{{prefix}}:{{i}}"])
              for i in range(len(jax.tree.leaves(decl, is_leaf=is_decl)))]
    return jax.tree.unflatten(jax.tree.structure(decl, is_leaf=is_decl), leaves)
out = {{}}
x = jnp.asarray(inp["moe:x"])
for cf in {factors}:
    cfg = cfg_of(cfgs["moe"], capacity_factor=cf)
    params = tree(moe.moe_decl(cfg), "moe")
    f = lambda p, x: moe.moe_block(p, x, cfg)
    with jax.set_mesh(mesh24):
        y, aux = jax.jit(f)(params, x)
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x)[0] ** 2), argnums=(0, 1)))(params, x)
    out[f"moe{{cf}}:y"], out[f"moe{{cf}}:drop"] = np.asarray(y), np.asarray(aux.drop_fraction)
    for i, g in enumerate(jax.tree.leaves(gp)):
        out[f"moe{{cf}}:g{{i}}"] = np.asarray(g)
    out[f"moe{{cf}}:gx"] = np.asarray(gx)
cfg = cfg_of(cfgs["moe"], dispatch="multisplit")
with jax.set_mesh(mesh24):
    y, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg))(tree(moe.moe_decl(cfg), "moe"), x)
out["gspmd:y"], out["gspmd:drop"] = np.asarray(y), np.asarray(aux.drop_fraction)
for name, (h, kv, pad) in {attn}.items():
    q, k, v = (jnp.asarray(inp[f"attn:{{name}}:{{t}}"]) for t in "qkv")
    fn = jax.jit(lambda q, k, v: layers.multihead_attention(q, k, v, causal=True, chunk=32,
                                                            pad_heads=pad))
    if pad:      # JAX's pad branch does not lower on this mesh: its function without one
        out[f"attn:{{name}}"] = np.asarray(fn(q, k, v))
        continue
    with jax.set_mesh(mesh24):
        out[f"attn:{{name}}"] = np.asarray(fn(q, k, v))
for name in {models}:
    cfg = cfg_of(cfgs[name])
    params = tree(M.decl_model(cfg), name)
    tokens = jnp.asarray(inp["tokens"])
    with jax.set_mesh(mesh22):
        logits, _, _ = jax.jit(lambda p, t: M.forward(p, cfg, tokens=t))(params, tokens)
        step = jax.jit(lambda p, c, t, pos: M.decode_step(p, cfg, c, t, pos))
        cache = M.init_cache(params, cfg, {b}, max_len={max_len})
        dec = []
        for t in range({steps}):
            lg, cache = step(params, cache, tokens[:, t:t + 1], jnp.asarray(t, jnp.int32))
            dec.append(np.asarray(lg[:, 0]))
    out[f"{{name}}:logits"], out[f"{{name}}:decode"] = np.asarray(logits), np.stack(dec, 1)
np.savez("{out}", **out)
"""

_WORKER = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, store, inputs, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs.base import ModelConfig, MoEConfig, ParallelConfig, SSMConfig
from repro_torch.models import layers, moe, model as M
from repro_torch.parallel import sharding as S
inp = np.load(inputs)
cfgs = json.loads('{cfgs}')
got = {{}}

def cfg_of(d, **moe_kw):
    return ModelConfig(**dict(d, moe=MoEConfig(**dict(d["moe"], **moe_kw)),
                              ssm=SSMConfig(**d["ssm"])))

def params_of(decl, prefix, mesh):
    n = len(S.tree_leaves(decl))
    full = S.tree_unflatten(decl, [torch.from_numpy(inp[f"{{prefix}}:{{i}}"]) for i in range(n)])
    return S.place(full, S.decl_to_sharding(decl, ParallelConfig(), mesh))

def comm_counts(mode):
    return {{str(k): v for k, v in mode.get_comm_counts().items()}}

mesh24 = DeviceMesh("cpu", torch.arange(8).view(2, 4), mesh_dim_names=("data", "model"))
halves = [DeviceMesh("cpu", torch.arange(4 * i, 4 * i + 4).view(2, 2),
                     mesh_dim_names=("data", "model")) for i in (0, 1)]

# ---- multisplit_ep on (2, 4)
for cf in {factors}:
    cfg = cfg_of(cfgs["moe"], capacity_factor=cf)
    p = params_of(moe.moe_decl(cfg), "moe", mesh24)
    for leaf in S.tree_leaves(p):
        leaf.requires_grad_()
    x = torch.from_numpy(inp["moe:x"]).requires_grad_()
    with S.set_mesh(mesh24):
        y, aux = moe.moe_block(p, S.distribute_input(x, "dp", None, None), cfg, backend="vmap")
        whole = S.replicate(y)       # the loss of the whole output, on every rank
        (whole * whole).sum().to_local().backward()
        got[f"moe{{cf}}:y"] = S.gather_full(y).detach().numpy()
        got[f"moe{{cf}}:drop"] = np.asarray(float(aux.drop_fraction))
        for i, leaf in enumerate(S.tree_leaves(p)):
            got[f"moe{{cf}}:g{{i}}"] = S.gather_full(leaf.grad).numpy()
    got[f"moe{{cf}}:gx"] = x.grad.numpy()

# ---- the multisplit dispatch under the mesh: whole tensors on every rank
cfg = cfg_of(cfgs["moe"], dispatch="multisplit")
p = params_of(moe.moe_decl(cfg), "moe", mesh24)
with S.set_mesh(mesh24), torch.no_grad():
    y, aux = moe.moe_block(p, S.distribute_input(torch.from_numpy(inp["moe:x"]), "dp", None, None),
                           cfg, backend="vmap")
    got["gspmd:y"], got["gspmd:drop"] = S.gather_full(y).numpy(), np.asarray(float(
        S.gather_full(aux.drop_fraction)))

# ---- multihead_attention with tp = 4
for name, (h, kv, pad) in {attn}.items():
    q, k, v = (torch.from_numpy(inp[f"attn:{{name}}:{{t}}"]) for t in "qkv")
    with S.set_mesh(mesh24), torch.no_grad():
        q, k, v = (S.distribute_input(t, "dp", None, None, None) for t in (q, k, v))
        o = layers.multihead_attention(q, k, v, causal=True, chunk=32, pad_heads=pad,
                                       backend="vmap")
        got[f"attn:{{name}}"] = S.gather_full(o).numpy()

# ---- models on (2, 2): ranks 0-3 the first list, ranks 4-7 the second
mine = {models}[rank // 4]
mesh = halves[rank // 4]
tokens = torch.from_numpy(inp["tokens"])
for name in mine:
    cfg = cfg_of(cfgs[name])
    params = params_of(M.decl_model(cfg), name, mesh)
    with S.set_mesh(mesh), torch.no_grad():
        fwd = CommDebugMode()
        with fwd:
            logits, _, _ = M.forward(params, cfg, tokens=tokens, backend="vmap")
        got[f"{{name}}:logits"] = S.gather_full(logits).numpy()
        cache = M.init_cache(params, cfg, {b}, {max_len})
        got[f"{{name}}:cache_k"] = np.asarray([p.dim if p.is_shard() else -1
                                              for p in cache["pattern"][0]["k"].placements])
        dec, step = [], CommDebugMode()
        for t in range({steps}):
            with step:
                lg, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
            dec.append(S.gather_full(lg)[:, 0].numpy())
        got[f"{{name}}:decode"] = np.stack(dec, 1)
        got[f"{{name}}:comms"] = np.asarray(json.dumps([comm_counts(fwd), comm_counts(step)]))
np.savez(out, **got)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's results, each rank's results): the inputs drawn here, then the
    JAX subprocess and the eight gloo ranks run side by side."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs, cfgs = {}, {"moe": dataclasses.asdict(_moe_cfg(8.0))}
    for i, a in enumerate(_leaves(jinit(jmoe.moe_decl(_moe_cfg(8.0)), jax.random.PRNGKey(0)))):
        inputs[f"moe:{i}"] = a
    inputs["moe:x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 64, 64)))
    rng = np.random.RandomState(5)
    for name, (h, kv, _) in ATTN_CASES.items():
        for t, heads in (("q", h), ("k", kv), ("v", kv)):
            inputs[f"attn:{name}:{t}"] = rng.randn(2, 64, heads, 16).astype(np.float32)
    for name in MODELS:
        cfg = _model_cfg(name)
        cfgs[name] = dataclasses.asdict(cfg)
        for i, a in enumerate(_leaves(jinit(JM.decl_model(cfg), jax.random.PRNGKey(0)))):
            inputs[f"{name}:{i}"] = a
    inputs["tokens"] = np.random.RandomState(0).randint(0, 512, (B, S)).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inputs)
    fmt = dict(inputs=tmp / "inputs.npz", cfgs=json.dumps(cfgs), factors=CAPACITY_FACTORS,
               attn=ATTN_CASES, b=B, max_len=MAX_LEN, steps=DECODE_STEPS)

    path = str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", "")
    jax_env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=path)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX).format(models=list(MODELS),
                                                            out=tmp / "jax.npz", **fmt)],
        env=jax_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    script = tmp / "worker.py"
    halves = [["tinyllama-1.1b", "dbrx-gqa"], ["dbrx-132b"]]
    script.write_text(textwrap.dedent(_WORKER).format(models=halves, **fmt))
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD),
                               str(tmp / "store"), str(tmp / "inputs.npz"),
                               str(tmp / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    jax_out = jax_proc.communicate(timeout=600)[0]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-5000:]}"
    assert jax_proc.returncode == 0, jax_out[-5000:]
    return dict(np.load(tmp / "jax.npz")), [dict(np.load(tmp / f"rank{r}.npz"))
                                            for r in range(WORLD)]


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_multisplit_ep_equals_jax(runs, cf):
    want, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"moe{cf}:y"], want[f"moe{cf}:y"], rtol=0, atol=ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got[f"moe{cf}:drop"], want[f"moe{cf}:drop"], rtol=0,
                                   atol=ATOL)
    assert (float(want[f"moe{cf}:drop"]) > 0) == (cf == 1.0)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_multisplit_ep_gradients_equal_jax(runs, cf):
    want, ranks = runs
    got = ranks[0]
    names = sorted(k for k in want if k.startswith(f"moe{cf}:g"))
    assert len(names) == 6                     # norm, router, three experts' weights, x
    for k in names:
        g, w = got[k], want[k]
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        assert _rel(g, w) < GRAD_TOL, (k, _rel(g, w))


def test_multisplit_dispatch_under_a_mesh_equals_jax(runs):
    """A dispatch other than the expert-parallel one runs on whole tensors
    on every rank under the mesh: JAX's GSPMD ``multisplit`` under its
    own."""
    want, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["gspmd:y"], want["gspmd:y"], rtol=0, atol=ATOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["gspmd:drop"], want["gspmd:drop"], rtol=0, atol=ATOL)


def test_multisplit_ep_equals_the_one_process_dispatch(runs):
    """Nothing drops at capacity factor 8: the expert-parallel output is the
    port's own ``multisplit`` dispatch on one process."""
    _, ranks = runs
    cfg = convert.convert_config(_moe_cfg(8.0, "multisplit"))
    params = convert.params_from_numpy(jax.tree.map(
        np.asarray, jinit(jmoe.moe_decl(_moe_cfg(8.0)), jax.random.PRNGKey(0))))
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 64, 64))))
    with torch.inference_mode():
        y, aux = tmoe.moe_block(params, x, cfg, backend="vmap")
    assert float(aux.drop_fraction) == 0.0 and float(ranks[0]["moe8.0:drop"]) == 0.0
    assert _rel(ranks[0]["moe8.0:y"], y.numpy()) < 1e-4


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_tp_branches_equal_jax(runs, case):
    want, ranks = runs
    for r, got in enumerate(ranks):
        assert got[f"attn:{case}"].shape == want[f"attn:{case}"].shape
        np.testing.assert_allclose(got[f"attn:{case}"], want[f"attn:{case}"], rtol=0,
                                   atol=ATTN_TOL, err_msg=f"rank {r}")


def _model_ranks(ranks, name):
    return [got for got in ranks if f"{name}:logits" in got]


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_forward_equals_jax(runs, name):
    want, ranks = runs
    mine = _model_ranks(ranks, name)
    assert len(mine) == 4
    for got in mine:
        assert got[f"{name}:logits"].shape == (B, S, 512)
        assert _rel(got[f"{name}:logits"], want[f"{name}:logits"]) < LOGIT_RTOL


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_decode_equals_jax(runs, name):
    want, ranks = runs
    for got in _model_ranks(ranks, name):
        assert _rel(got[f"{name}:decode"], want[f"{name}:decode"]) < LOGIT_RTOL
        # the stacked cache's K (layer, batch, time, ...): batch over data, time over model
        assert got[f"{name}:cache_k"].tolist() == [1, 2]


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_steps_reduce_and_never_gather(runs, name):
    """The collectives of the forward and of the decode steps: all-reduces
    only — DTensor's functional all-gather never runs (gloo crashes on it
    with CUDA tensors); every gather is c10d's (``_Gather``)."""
    _, ranks = runs
    fwd, step = json.loads(str(_model_ranks(ranks, name)[0][f"{name}:comms"]))
    for counts in (fwd, step):
        assert not any("all_gather_into_tensor" in k and "functional" in k for k in counts), counts
        assert not any("reduce_scatter" in k or "all_to_all" in k for k in counts), counts
    assert any("all_reduce" in k for k in fwd)
