"""The port's loss and gradients (``repro_torch.models.model.loss_fn``, the
differentiable B11 route, ``launch.steps.make_train_step``) against the
JAX package's on the CPU.

Float32 ``smoke()`` configs at B = 2, S = 64 (the shapes of
``tests/test_torch_models.py``; zamba2 and xlstm at ``ssd_chunk=16``, as
``tests/test_torch_families.py`` runs them). Parameters are drawn by the
JAX package's ``init_params`` and carried across by
``convert.params_from_numpy``; tokens, frame embeddings, patch embeddings
and labels (-1 in places) come from a seeded numpy generator.
``jax.value_and_grad(loss_fn)`` is jitted once an architecture (a
module-scoped fixture), with the multisplit dispatch for dbrx, against
which the port's multisplit and sort dispatches are both held (the two
give the same routing).

Every gradient leaf is held to ``GRAD_RTOL`` of the largest magnitude of
JAX's gradient of that leaf; the loss and the metrics to ``LOSS_RTOL``.
One exception, measured in every run: the vision stack magnifies float32
rounding about 1e4 times (``tests/test_torch_families.py``), so its
gradients are held to the movement of JAX's own gradients when every
parameter is perturbed by a relative 1e-6, and its loss likewise.
Every routed token's top-k margin is held above ``ROUTER_MARGIN``, so no
tolerance hides a flipped expert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import adamw_init as j_adamw_init
from repro.parallel.sharding import init_params as jinit
from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import steps as TS
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.parallel.sharding import tree_leaves, tree_map

import _torch_threads

_torch_threads.pin()

GRAD_RTOL = 1e-3
LOSS_RTOL = 1e-5
PERTURB = 1e-6
ROUTER_MARGIN = 1e-5
B, S = 2, 64
ARCHS = {
    "tinyllama-1.1b": {},
    "dbrx-132b": {},                             # every block MoE, top-2 of 8
    "zamba2-1.2b": {"ssd_chunk": 16},
    "xlstm-350m": {"ssd_chunk": 16},
    "musicgen-large": {},                        # frame embeddings
    "llama-3.2-vision-90b": {},                  # 16 patch embeddings
}
ILL_CONDITIONED = {"llama-3.2-vision-90b"}
# dbrx's batch: a seed whose every routed token's top-2 margin clears
# ROUTER_MARGIN tenfold (at seed 0 one token's is 2.8e-6)
BATCH_SEED = {"dbrx-132b": 10}


def _batch(jc, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"labels": rng.randint(-1, jc.vocab, (B, S)).astype(np.int32)}
    if jc.embed_frontend_stub:
        batch["embeds"] = rng.randn(B, S, jc.d_model).astype(np.float32)
    else:
        batch["tokens"] = rng.randint(0, jc.vocab, (B, S)).astype(np.int32)
    if jc.n_vis_tokens:
        batch["vis_embeds"] = rng.randn(B, jc.n_vis_tokens, jc.d_model).astype(np.float32)
    return batch


def _perturbed(jp, seed=1):
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        leaf * (1 + PERTURB * rng.randn(*leaf.shape).astype(np.float32)) for leaf in leaves])


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def router_gaps():
    """The smallest top-k gap of every call of the port's router."""
    gaps = []
    router = tmoe._router

    def recording(p, xn, cfg, **kw):
        logits = torch.einsum("nd,de->ne", xn, p["router"].to(xn.dtype)).float()
        probs = torch.softmax(logits, -1).sort(-1, descending=True).values
        k = cfg.moe.top_k
        gaps.append((probs[:, k - 1] - probs[:, k]).min().item())
        return router(p, xn, cfg, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tmoe, "_router", recording)
    yield gaps
    mp.undo()


def _port_grads(tp, tc, batch, backend="cuda"):
    """(loss, metrics, gradient leaves) of the port, in JAX's leaf order."""
    (loss, metrics), grads = TS.grads_of(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         backend=backend)
    return float(loss), {k: float(v) for k, v in metrics.items()}, [
        g.numpy() for g in tree_leaves(grads)]


_RUNS = {}


@pytest.fixture(scope="module", params=list(ARCHS))
def grad_run(request, router_gaps):
    """One architecture's loss and gradients through both packages, computed
    once (a test that takes one architecture by indirect parametrization
    reads the same run)."""
    if request.param not in _RUNS:
        _RUNS[request.param] = _grad_run(request.param, router_gaps)
    return _RUNS[request.param]


def _grad_run(arch, router_gaps):
    jc = dataclasses.replace(get_config(arch).smoke(), **ARCHS[arch])
    if jc.moe.num_experts:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, dispatch="multisplit"))
    tc = convert.convert_config(jc)
    jp = jinit(JM.decl_model(jc), jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = _batch(jc, BATCH_SEED.get(arch, 0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(lambda p, b: JM.loss_fn(p, jc, b), has_aux=True))
    (j_loss, j_metrics), j_grads = vg(jp, jb)
    moved = None
    if arch in ILL_CONDITIONED:
        (m_loss, _), m_grads = vg(_perturbed(jp), jb)
        moved = (float(m_loss), [np.asarray(g) for g in jax.tree.leaves(m_grads)])
    del router_gaps[:]
    dispatches = ("multisplit", "sort") if jc.moe.num_experts else (None,)
    port = {}
    for disp in dispatches:
        c = tc if disp is None else dataclasses.replace(
            tc, moe=dataclasses.replace(tc.moe, dispatch=disp))
        port[disp] = _port_grads(tp, c, batch)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree.flatten_with_path(j_grads)[0]]
    return dict(arch=arch, jc=jc, tc=tc, jp=jp, tp=tp, batch=batch, paths=paths,
                j_loss=float(j_loss), j_metrics={k: float(v) for k, v in j_metrics.items()},
                j_grads=[np.asarray(g) for g in jax.tree.leaves(j_grads)], moved=moved,
                gaps=list(router_gaps), port=port)


def _limits(run):
    """(loss limit, gradient limit a leaf): the fixed ones, or for an
    ill-conditioned stack what a 1e-6 perturbation moves JAX itself."""
    if run["moved"] is None:
        return LOSS_RTOL, [GRAD_RTOL] * len(run["j_grads"])
    m_loss, m_grads = run["moved"]
    loss_lim = abs(m_loss - run["j_loss"]) / abs(run["j_loss"])
    lims = [max(GRAD_RTOL, _rel(m, g)) for m, g in zip(m_grads, run["j_grads"])]
    assert max(lims) > GRAD_RTOL, max(lims)          # the stack is ill-conditioned indeed
    return max(loss_lim, LOSS_RTOL), lims


def test_loss_and_metrics_equal_jax(grad_run):
    run = grad_run
    if run["jc"].moe.num_experts:
        assert run["gaps"] and min(run["gaps"]) > ROUTER_MARGIN, run["gaps"]
    loss_lim, _ = _limits(run)
    for disp, (loss, metrics, _) in run["port"].items():
        assert np.isfinite(loss)
        assert abs(loss - run["j_loss"]) <= loss_lim * abs(run["j_loss"]), (disp, loss)
        assert set(metrics) == set(run["j_metrics"])
        for k, v in run["j_metrics"].items():
            assert abs(metrics[k] - v) <= max(loss_lim * abs(v), 1e-6), (disp, k, metrics[k], v)


def test_gradients_equal_jax(grad_run):
    run = grad_run
    _, lims = _limits(run)
    for disp, (_, _, grads) in run["port"].items():
        assert len(grads) == len(run["j_grads"])
        for path, got, want, lim in zip(run["paths"], grads, run["j_grads"], lims):
            assert got.shape == want.shape, path
            err = _rel(got, want)
            assert err <= lim, f"{run['arch']} {disp} {path}: {err:.3e} (limit {lim:.3e})"


@pytest.mark.parametrize("grad_run", ["dbrx-132b"], indirect=True)
def test_moe_dispatches_give_the_same_gradients(grad_run):
    """multisplit and sort route the same tokens the same way (both
    stable), so the port's two gradients are bitwise equal."""
    (la, _, ga), (lb, _, gb) = grad_run["port"]["multisplit"], grad_run["port"]["sort"]
    assert la == lb
    for a, b in zip(ga, gb):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the B11 route's gradient, and the fault it repairs
# ---------------------------------------------------------------------------

def _qkv(b=2, s=96, h=8, kh=2, hd=16, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, n, hd), generator=g).to(dtype).requires_grad_()
            for n in (h, kh, kh)]


@pytest.mark.parametrize("backend", ["cuda", "vmap"])
@pytest.mark.parametrize("s,chunk", [(96, 32), (64, 1024), (300, 128)])
def test_b11_attention_gradient_is_the_block_schedules(backend, s, chunk):
    """``_B11Attention``: the forward is the door's (the plain version on a
    CPU tensor), the gradient autograd of ``_attention_blocks`` with the
    same chunk, for q, k and v (GQA, ragged chunks)."""
    q, k, v = _qkv(s=s)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    assert tlayers.b11_route(q, k, causal=True, window=None, q_offset=0, probs_bf16=False)
    out = tlayers.multihead_attention(q, k, v, causal=True, chunk=chunk, backend=backend)
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = tlayers._attention_blocks(q, k, v, causal=True, chunk=chunk, window=None, q_offset=0,
                                    probs_bf16=False)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=2e-5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b", [1, 2])
def test_b11_route_hands_the_door_contiguous_tensors(b, monkeypatch):
    """The kernel takes contiguous (B·H, S, hd) tensors only; at batch 1 the
    fold of (B, S, H, hd) by a reshape alone would be a strided view."""
    seen = []
    door = tlayers.kops.flash_attention

    def checking(q, k, v, *a, **kw):
        seen.append(all(x.is_contiguous() for x in (q, k, v)))
        return door(q, k, v, *a, **kw)

    monkeypatch.setattr(tlayers.kops, "flash_attention", checking)
    q, k, v = _qkv(b=b, s=64)
    tlayers.multihead_attention(q, k, v, causal=True, chunk=32).sum().backward()
    assert seen == [True]
    assert all(x.grad is not None for x in (q, k, v))


def test_door_raises_under_grad():
    """The door refuses to run where its output would cut a gradient, on
    every backend, and runs under no_grad."""
    q, k, v = (x.transpose(1, 2).reshape(-1, 96, 16).detach() for x in _qkv(kh=8))
    for door in (tfa.flash_attention, tlayers.kops.flash_attention):
        with pytest.raises(RuntimeError, match="no gradient"):
            door(q.requires_grad_(), k, v, True, 32, 32)
        with torch.no_grad():
            out = door(q, k, v, True, 32, 32)
        assert out.grad_fn is None
        torch.testing.assert_close(out, tfa.flash_attention_plain(q, k, v, True, 32, 32))
        q = q.detach()


def _card_like_door(calls):
    """A stand-in for the door on the card: the plain result computed under
    ``torch.no_grad()``, with no autograd history, as the ``ctypes`` launch
    fills its output."""
    def door(q, k, v, *a, **kw):
        calls.append(tuple(q.shape))
        with torch.no_grad():
            return tfa.flash_attention_plain(q, k, v, *a, **kw)
    return door


def _wq_paths(paths):
    return [i for i, p in enumerate(paths) if p.endswith("['wq']") or p.endswith("['wk']")
            or p.endswith("['wv']")]


@pytest.mark.parametrize("grad_run", ["tinyllama-1.1b"], indirect=True)
def test_card_door_keeps_the_attention_gradients(grad_run, monkeypatch):
    """The fault's own test: with the door returning a tensor with no
    history (the card's behaviour), the model's wq, wk and wv gradients
    still equal JAX's, because the backward never reads the door's output.
    With ``_B11Attention`` bypassed, the same door would cut them to zero."""
    run = grad_run
    calls = []
    monkeypatch.setattr(tlayers.kops, "flash_attention", _card_like_door(calls))
    _, _, grads = _port_grads(run["tp"], run["tc"], run["batch"], backend="cuda")
    assert len(calls) == 2 * run["jc"].n_layers           # remat: forward and recompute
    idx = _wq_paths(run["paths"])
    assert len(idx) == 3
    for i in idx:
        assert np.abs(grads[i]).max() > 0, run["paths"][i]
        assert _rel(grads[i], run["j_grads"][i]) <= GRAD_RTOL, run["paths"][i]

    monkeypatch.setattr(tlayers._B11Attention, "apply",
                        lambda q, k, v, backend, chunk: tlayers._attention_b11(q, k, v, backend))
    _, _, cut = _port_grads(run["tp"], run["tc"], run["batch"], backend="cuda")
    for i in idx:
        assert not np.abs(cut[i]).any(), run["paths"][i]


@pytest.mark.parametrize("grad_run", ["tinyllama-1.1b"], indirect=True)
def test_transformer_module_loss(grad_run):
    """``Transformer.loss`` is ``loss_fn`` on the registered parameters, and
    ``backward`` fills every parameter's ``.grad`` with JAX's gradient."""
    run = grad_run
    model = TM.Transformer(run["tc"], params=tree_map(torch.clone, run["tp"]))
    loss, metrics = model.loss({k: torch.from_numpy(v) for k, v in run["batch"].items()})
    assert abs(loss.item() - run["j_loss"]) <= LOSS_RTOL * abs(run["j_loss"])
    loss.backward()
    grads = [g.grad.numpy() for g in tree_leaves(model.params)]
    for path, got, want in zip(run["paths"], grads, run["j_grads"]):
        assert _rel(got, want) <= GRAD_RTOL, path


# ---------------------------------------------------------------------------
# one train step, with and without microbatches
# ---------------------------------------------------------------------------

STEP_KW = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def test_train_step_equals_jax_with_and_without_accumulation():
    """Two steps of ``make_train_step`` (the first at the warmup's zero rate,
    the second at ``lr``) on tinyllama's smoke config and a (4, 64) batch,
    for ``accum_steps`` 1 and 4, against JAX's jitted step: the moments to
    1e-4 of their largest, the parameters to a tenth of ``lr`` (Adam's
    update of an element whose gradient is rounding noise is a coin flip
    of size up to ``lr``, so the parameters are the loosest check), the step
    counter exactly; and 1 against 4 to JAX's own 1e-4
    (``tests/test_substrate.py``)."""
    jc = get_config("tinyllama-1.1b").smoke()
    tc_model = convert.convert_config(jc)
    jp = jinit(JM.decl_model(jc), jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    nb = {"tokens": rs.randint(0, jc.vocab, (4, 64)).astype(np.int32),
          "labels": rs.randint(0, jc.vocab, (4, 64)).astype(np.int32)}
    out = {}
    for a in (1, 4):
        jtc = JTrainConfig(accum_steps=a, **STEP_KW)
        js = JS.TrainState(jp, j_adamw_init(jp, jtc))
        ts = convert.train_state_from_numpy(jax.tree.map(np.asarray, js))
        jstep = jax.jit(JS.make_train_step(jc, jtc))
        tstep = TS.make_train_step(tc_model, TrainConfig(accum_steps=a, **STEP_KW))
        for _ in range(2):
            js, jm = jstep(js, {k: jnp.asarray(v) for k, v in nb.items()})
            ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in nb.items()})
        assert int(ts.opt.step) == int(js.opt.step) == 2
        assert set(tm) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        for name, j_tree, t_tree, tol in (("mu", js.opt.mu, ts.opt.mu, None),
                                          ("nu", js.opt.nu, ts.opt.nu, None),
                                          ("params", js.params, ts.params, 0.1 * STEP_KW["lr"])):
            for w, g in zip(jax.tree.leaves(j_tree), tree_leaves(t_tree)):
                w, g = np.asarray(w), g.numpy()
                if tol is None:
                    assert _rel(g, w) <= 1e-4, name
                else:
                    np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
        out[a] = ts
    for a, b in zip(tree_leaves(out[1].params), tree_leaves(out[4].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)
