"""The port's model serving path (``repro_torch.configs``,
``parallel.sharding``, ``models.layers``, ``models.moe``, ``models.model``,
the ``--arch`` decode demo) against the JAX package's on the CPU, for the
dense and MoE families (the others: ``tests/test_torch_families.py``).

Float32 ``smoke()`` configs; the parameters are drawn by the JAX package's
``init_params`` and carried across by ``convert.params_from_numpy``, the
config by ``convert.convert_config``. JAX's ``forward`` and ``decode_step``
are jitted once an architecture (a module-scoped fixture). Logits are held
to ``LOGIT_RTOL`` of their largest magnitude: both sides are float32, and
their matmuls and softmaxes round in other orders. MoE routing could flip
an expert where two router probabilities nearly tie, which no tolerance
should hide: every routed token's gap between its k-th and (k+1)-th
probability is asserted above ``ROUTER_MARGIN``, far above the float32
rounding the two routers differ by.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.parallel.sharding import init_params as jinit
from repro.parallel.sharding import param_bytes as jbytes
from repro.parallel.sharding import param_count as jcount
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.parallel import sharding as tsharding

import _torch_threads

_torch_threads.pin()

LOGIT_RTOL = 2e-4
ROUTER_MARGIN = 1e-5
B, S, S_DEC = 2, 64, 24
ARCHS = {
    "tinyllama-1.1b": {},
    "stablelm-1.6b": {},                         # layernorm, rope_pct 0.25
    "h2o-danube-1.8b": {"window": 16},           # window < S_DEC: the ring cache wraps
    "minicpm-2b": {},                            # tied embeddings
    "dbrx-132b": {},                             # every block MoE, top-2 of 8
    "llama4-maverick-400b-a17b": {},             # every=2, shared expert
}


def _params(jc, seed=0):
    jp = jinit(JM.decl_model(jc), jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def router_gaps(monkeypatch_module):
    """The smallest top-k gap of every call of the port's router."""
    gaps = []
    router = tmoe._router

    def recording(p, xn, cfg, **kw):
        logits = torch.einsum("nd,de->ne", xn, p["router"].to(xn.dtype)).float()
        probs = torch.softmax(logits, -1).sort(-1, descending=True).values
        k = cfg.moe.top_k
        gaps.append((probs[:, k - 1] - probs[:, k]).min().item())
        return router(p, xn, cfg, **kw)

    monkeypatch_module.setattr(tmoe, "_router", recording)
    return gaps


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_run(request, router_gaps):
    """One architecture through both packages: forward on (B, S) tokens and
    S_DEC decode steps, JAX jitted once each."""
    arch = request.param
    jc = dataclasses.replace(get_config(arch).smoke(), **ARCHS[arch])
    tc = convert.convert_config(jc)
    jp, tp = _params(jc)
    tokens = np.random.RandomState(0).randint(0, jc.vocab, (B, S)).astype(np.int32)
    del router_gaps[:]

    j_fwd = jax.jit(lambda p, t: JM.forward(p, jc, tokens=t))
    j_logits, _, j_aux = j_fwd(jp, jnp.asarray(tokens))
    j_step = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jc, c, t, pos))
    cache = JM.init_cache(jp, jc, 1, max_len=S_DEC)
    j_dec = []
    for t in range(S_DEC):
        lg, cache = j_step(jp, cache, jnp.asarray(tokens[:1, t:t + 1]), jnp.asarray(t, jnp.int32))
        j_dec.append(np.asarray(lg[:, 0]))

    toks = torch.from_numpy(tokens)
    with torch.inference_mode():
        t_logits, _, t_aux = TM.forward(tp, tc, tokens=toks)
        t_short, _, _ = TM.forward(tp, tc, tokens=toks[:1, :S_DEC])
        cache = TM.init_cache(tp, tc, 1, S_DEC)
        t_dec = []
        for t in range(S_DEC):
            lg, cache = TM.decode_step(tp, tc, cache, toks[:1, t:t + 1], t)
            t_dec.append(lg[:, 0])
    return dict(arch=arch, jc=jc, tc=tc, tp=tp, tokens=toks, gaps=list(router_gaps),
                j_logits=np.asarray(j_logits), j_aux=[float(a) for a in j_aux],
                j_dec=np.stack(j_dec, 1), t_logits=t_logits.numpy(),
                t_aux=[float(a) for a in t_aux], t_short=t_short.numpy(),
                t_dec=torch.stack(t_dec, 1).numpy())


def _assert_close(got, want, what):
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert err < LOGIT_RTOL, f"{what}: relative error {err:.3e}"


def _assert_routing_margin(run):
    if run["jc"].moe.num_experts:
        assert run["gaps"] and min(run["gaps"]) > ROUTER_MARGIN, (run["arch"], run["gaps"])
    else:
        assert not run["gaps"]


def test_forward_equals_jax(arch_run):
    _assert_routing_margin(arch_run)
    assert arch_run["t_logits"].shape == (B, S, arch_run["jc"].vocab)
    _assert_close(arch_run["t_logits"], arch_run["j_logits"], arch_run["arch"])
    np.testing.assert_allclose(arch_run["t_aux"], arch_run["j_aux"], rtol=1e-5, atol=1e-6)


def test_decode_equals_jax(arch_run):
    _assert_routing_margin(arch_run)
    _assert_close(arch_run["t_dec"], arch_run["j_dec"], arch_run["arch"])


def test_decode_equals_forward(arch_run):
    """The port's own check, as ``tests/test_models.py`` holds JAX's: S_DEC
    single-token steps through the cache give the logits of one forward."""
    _assert_close(arch_run["t_dec"], arch_run["t_short"], arch_run["arch"])


def test_transformer_module_runs_the_functions(arch_run):
    model = TM.Transformer(arch_run["tc"], params=arch_run["tp"])
    n = sum(p.numel() for p in model.parameters())
    assert n == tsharding.param_count(TM.decl_model(arch_run["tc"]))
    with torch.inference_mode():
        logits, _, _ = model(arch_run["tokens"])
    np.testing.assert_array_equal(logits.numpy(), arch_run["t_logits"])


# ---------------------------------------------------------------------------
# configs and the parameter half of sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_jax(arch):
    jc, tc = get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.smoke()) == dataclasses.asdict(jc.smoke())
    assert convert.convert_config(jc) == tc
    assert tc.hd() == jc.hd() and tc.padded_vocab() == jc.padded_vocab()
    assert TM.block_pattern(tc) == JM.block_pattern(jc)


def test_config_registry():
    assert tconfigs.ARCH_IDS == ARCH_IDS
    assert set(tconfigs.all_configs()) == set(ARCH_IDS)
    for alias, mod in tconfigs.ALIASES.items():
        assert tconfigs.get_config(alias) == tconfigs.get_config(mod)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_declarations_equal_jax(arch):
    """The full config's tree, name for name and shape for shape, and its
    counts; no allocation (meta tensors)."""
    jd, td = JM.decl_model(get_config(arch)), TM.decl_model(tconfigs.get_config(arch))
    shapes = lambda tree, leaves: [tuple(d.shape) for d in leaves(tree)]
    assert shapes(td, tsharding.tree_leaves) == shapes(
        jd, lambda t: jax.tree.leaves(t, is_leaf=lambda x: hasattr(x, "axes")))
    assert tsharding.param_count(td) == jcount(jd)
    assert tsharding.param_bytes(td) == jbytes(jd)
    abstract = tsharding.decl_to_abstract(td)
    assert all(t.is_meta for t in tsharding.tree_leaves(abstract))


def test_init_params_rules():
    decls = {"w": tsharding.ParamDecl((64, 256), ("embed", "ff")),
             "e": tsharding.ParamDecl((512, 64), ("vocab", "embed"), scale=0.02),
             "z": [tsharding.ParamDecl((8,), ("embed",), init="zeros")],
             "o": tsharding.ParamDecl((8,), ("embed",), init="ones")}
    g = torch.Generator().manual_seed(0)
    p = tsharding.init_params(decls, g)
    assert abs(p["w"].std().item() * 8 - 1) < 0.05             # 1/sqrt(fan_in = 64)
    assert abs(p["e"].std().item() / 0.02 - 1) < 0.05
    assert not p["z"][0].any() and bool((p["o"] == 1).all())
    again = tsharding.init_params(decls, torch.Generator().manual_seed(0), torch.bfloat16)
    assert again["w"].dtype == torch.bfloat16
    assert torch.equal(again["w"], p["w"].to(torch.bfloat16))
    assert tsharding.tp_size() == 1 and tsharding.constrain(p["w"], "dp", None) is p["w"]


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _attention_inputs(b, s, t, h, kh, hd, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, heads, hd).astype(np.float32)
            for n, heads in ((s, h), (t, kh), (t, kh))]


ATTENTION_CASES = {
    # name: (b, s, t, h, kh, hd, kwargs, takes B11)
    "causal-gqa": (2, 64, 64, 8, 2, 16, dict(causal=True), True),
    "causal-ragged-chunks": (1, 300, 300, 4, 4, 32, dict(causal=True, chunk=128), True),
    "window": (2, 96, 96, 4, 2, 16, dict(causal=True, window=24, chunk=32), False),
    "cross": (2, 24, 40, 4, 4, 16, dict(causal=False, chunk=16), False),
    "probs-bf16": (1, 64, 64, 4, 4, 16, dict(causal=True, probs_bf16=True), False),
    "head-width-12": (1, 32, 32, 2, 2, 12, dict(causal=True), False),
}


@pytest.mark.parametrize("name", list(ATTENTION_CASES))
def test_multihead_attention_routes_equal_jax(name):
    """Each shape's route (B11's door, or the plain block schedule), chosen
    by shape, against JAX's ``multihead_attention``; on the ``vmap`` backend
    the B11 route runs the door's plain version."""
    b, s, t, h, kh, hd, kw, b11 = ATTENTION_CASES[name]
    q, k, v = _attention_inputs(b, s, t, h, kh, hd)
    want = np.asarray(jlayers.multihead_attention(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    route = tlayers.b11_route(tq, tk, causal=kw["causal"], window=kw.get("window"), q_offset=0,
                              probs_bf16=kw.get("probs_bf16", False))
    assert route == b11
    for backend in ("cuda", "vmap"):
        got = tlayers.multihead_attention(tq, tk, tv, backend=backend, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=backend)


def test_b11_route_is_the_door(monkeypatch):
    """Inside B11's contract the ``cuda`` backend calls the kernel door once
    with (B·H, S, hd) tensors; outside it the door is never called."""
    calls = []
    door = tlayers.kops.flash_attention

    def counting(q, k, v, *a, **kw):
        calls.append(tuple(q.shape))
        return door(q, k, v, *a, **kw)

    monkeypatch.setattr(tlayers.kops, "flash_attention", counting)
    for name, (b, s, t, h, kh, hd, kw, b11) in ATTENTION_CASES.items():
        q, k, v = map(torch.from_numpy, _attention_inputs(b, s, t, h, kh, hd))
        del calls[:]
        tlayers.multihead_attention(q, k, v, **kw)
        assert calls == ([(b * h, s, hd)] if b11 else []), name


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_and_rope_equal_jax(norm):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(), norm=norm)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 64).astype(np.float32)
    p = {"scale": rng.randn(64).astype(np.float32), "bias": rng.randn(64).astype(np.float32)}
    want = np.asarray(jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(x), cfg))
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                             convert.convert_config(cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xr = rng.randn(2, 16, 4, 16).astype(np.float32)
    pos = np.arange(3, 19, dtype=np.int32)[None]
    for pct in (1.0, 0.25):
        want = np.asarray(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e4, pct))
        got = tlayers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e4, pct)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cross_attention_block_equals_jax():
    cfg = get_config("tinyllama-1.1b").smoke()
    decl = jlayers.attention_decl(cfg, cross=True)
    jp = jinit(decl, jax.random.PRNGKey(3))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.RandomState(2)
    x, src = rng.randn(2, 16, 64).astype(np.float32), rng.randn(2, 24, 64).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    want, _ = jlayers.attention_block(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                                      kv_src=jnp.asarray(src), cross=True)
    got, _ = tlayers.attention_block(tp, torch.from_numpy(x), convert.convert_config(cfg),
                                     positions=torch.from_numpy(pos),
                                     kv_src=torch.from_numpy(src), cross=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _moe_cfg(dispatch="multisplit", e=8, k=2, capf=4.0, shared=False):
    from repro.configs.base import ModelConfig, MoEConfig
    return ModelConfig(
        name="t", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
        vocab=128, dtype="float32",
        moe=MoEConfig(num_experts=e, top_k=k, dispatch=dispatch, capacity_factor=capf,
                      shared_expert=shared))


def _with(cfg, dispatch):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


@pytest.mark.parametrize("e,k,capf,shared", [(8, 1, 4.0, False), (8, 2, 4.0, True),
                                             (16, 4, 4.0, False), (8, 2, 0.5, False)])
def test_moe_dispatches_agree_and_equal_jax(router_gaps, e, k, capf, shared):
    """``multisplit`` and ``sort`` bitwise (both stable: the same tokens
    dropped), ``dense`` to 1e-4 where nothing drops, ``multisplit_ep`` with
    no group equal to ``multisplit``; each against JAX's ``moe_block``."""
    jc = _moe_cfg(e=e, k=k, capf=capf, shared=shared)
    jp = jinit(jmoe.moe_decl(jc), jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 64, 64), jnp.float32))
    del router_gaps[:]
    outs = {}
    for disp in ("multisplit", "sort", "dense", "multisplit_ep"):
        y, aux = tmoe.moe_block(tp, torch.from_numpy(x), convert.convert_config(_with(jc, disp)))
        outs[disp] = (y.numpy(), [float(a) for a in aux])
    assert min(router_gaps) > ROUTER_MARGIN, router_gaps
    np.testing.assert_array_equal(outs["multisplit"][0], outs["sort"][0])
    np.testing.assert_array_equal(outs["multisplit_ep"][0], outs["multisplit"][0])
    assert outs["multisplit"][1] == outs["sort"][1] == outs["multisplit_ep"][1]
    assert (outs["multisplit"][1][2] > 0) == (capf < 1)
    if capf >= 1:
        np.testing.assert_allclose(outs["multisplit"][0], outs["dense"][0], atol=1e-4)
    for disp in ("multisplit", "dense"):
        y, aux = jax.jit(lambda p, x_: jmoe.moe_block(p, x_, _with(jc, disp)))(jp, jnp.asarray(x))
        np.testing.assert_allclose(outs[disp][0], np.asarray(y), rtol=2e-4, atol=2e-5,
                                   err_msg=disp)
        np.testing.assert_allclose(outs[disp][1], [float(a) for a in aux], rtol=1e-5,
                                   atol=1e-6, err_msg=disp)


def test_moe_router_load_count_is_a_counts_only_call(monkeypatch):
    """The router's top-1 load is ``expert_load_stats`` (a ``counts_only``
    multisplit), on the block's backend."""
    seen = []
    stats = tmoe.expert_load_stats

    def recording(ids, e, *a, **kw):
        seen.append((tuple(ids.shape), e, kw.get("backend")))
        return stats(ids, e, *a, **kw)

    monkeypatch.setattr(tmoe, "expert_load_stats", recording)
    cfg = convert.convert_config(_moe_cfg())
    tp = tsharding.init_params(tmoe.moe_decl(cfg), torch.Generator().manual_seed(0))
    tmoe.moe_block(tp, torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1)), cfg,
                   backend="vmap")
    assert seen == [((16,), 8, "vmap")]


# ---------------------------------------------------------------------------
# the decode demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "dbrx-132b"])
def test_serve_decode_demo(arch, capsys):
    gen = tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen-len", "5"])
    assert gen.shape == (2, 5) and gen.dtype == torch.int32
    vocab = tconfigs.get_config(arch).smoke().vocab
    assert bool(((gen >= 0) & (gen < vocab)).all())
    out = capsys.readouterr().out
    assert "ms/step" in out and "tok/s" in out and "sample continuation" in out
    again = tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "4", "--gen-len", "5"])
    assert torch.equal(again, gen)                    # drawn from --seed


def test_serve_needs_an_arch_or_traffic():
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu"])
