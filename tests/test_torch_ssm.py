"""The port's Mamba2 and xLSTM blocks (``repro_torch.models.ssm``,
``repro_torch.models.xlstm``) and the caches of the hybrid, ssm and vlm
block kinds against the JAX package's on the CPU.

Float32, the ``smoke()`` dims of zamba2-1.2b and xlstm-350m; parameters
drawn by the JAX package's ``init_params`` and carried across by
``convert.params_from_numpy``, inputs drawn from a seeded numpy generator.
Every block is held to ``rtol=2e-4, atol=2e-5`` (both sides are float32;
their matmuls and exponentials round in other orders). The chunked forms
run at chunk 16 over S = 40: two whole chunks and one padded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.parallel.sharding import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.parallel.sharding import tree_leaves

TOL = dict(rtol=2e-4, atol=2e-5)
B, S, CHUNK = 2, 40, 16
FAMILY_ARCHS = ["zamba2-1.2b", "xlstm-350m", "llama-3.2-vision-90b", "musicgen-large"]


def _cfgs(arch):
    jc = dataclasses.replace(get_config(arch).smoke(), ssd_chunk=CHUNK)
    return jc, convert.convert_config(jc)


def _params(decl, seed=0):
    jp = jinit(decl, jax.random.PRNGKey(seed))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def _randn(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


def _cache(tree_np):
    """A block's cache for both packages from one dict of numpy arrays."""
    return ({k: jnp.asarray(v) for k, v in tree_np.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree_np.items()})


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_equals_jax(carried):
    k, c = 4, 48
    x, w, b = _randn(B, S, c, seed=1), _randn(k, c, seed=2), _randn(c, seed=3)
    state = _randn(B, k - 1, c, seed=4) if carried else None
    jy, js = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if state is None else jnp.asarray(state))
    ty, ts = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               None if state is None else torch.from_numpy(state))
    _close(ty, jy, "y")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))       # a copy of inputs


def test_ssd_chunked_equals_jax():
    """Chunk 16 over S = 40: the carry across two boundaries and the pad."""
    nh, hd, st = 4, 8, 16
    xs, b_in, c_in = _randn(B, S, nh, hd, seed=1), _randn(B, S, st, seed=2), _randn(B, S, st,
                                                                                   seed=3)
    dt = np.log1p(np.exp(_randn(B, S, nh, seed=4)))                  # softplus > 0
    log_decay = (-dt * np.exp(_randn(nh, seed=5))[None, None]).astype(np.float32)
    args = (xs, b_in, c_in, dt.astype(np.float32), log_decay)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, args), nh, hd, st, chunk=CHUNK)
    ty, th = tssm._ssd_chunked(*map(torch.from_numpy, args), nh, hd, st, chunk=CHUNK)
    assert ty.shape == (B, S, nh, hd) and th.shape == (B, nh, hd, st)
    _close(ty, jy, "y")
    _close(th, jh, "last state")


def _mamba(seed=0):
    jc, tc = _cfgs("zamba2-1.2b")
    jp, tp = _params(jssm.mamba2_decl(jc), seed)
    return jc, tc, jp, tp


def test_mamba2_block_prefill_equals_jax():
    jc, tc, jp, tp = _mamba()
    x = _randn(B, S, jc.d_model, seed=6)
    jy, jcache = jssm.mamba2_block(jp, jnp.asarray(x), jc)
    ty, tcache = tssm.mamba2_block(tp, torch.from_numpy(x), tc)
    assert jcache is None and tcache is None
    _close(ty, jy)


def test_mamba2_block_decode_equals_jax():
    """One token from a carried state; the port writes the new state into
    the cache it was given."""
    jc, tc, jp, tp = _mamba()
    d_inner, nh, hd, st = tssm._dims(tc)
    state = {"conv": _randn(B, jc.ssm.conv - 1, d_inner + 2 * st, seed=7),
             "ssm": _randn(B, nh, hd, st, seed=8, scale=0.5), "pos": np.int32(5)}
    jcache, tcache = _cache(state)
    x = _randn(B, 1, jc.d_model, seed=9)
    jy, jnew = jssm.mamba2_block(jp, jnp.asarray(x), jc, cache=jcache)
    ty, tnew = tssm.mamba2_block(tp, torch.from_numpy(x), tc, cache=tcache)
    assert tnew is tcache
    _close(ty, jy, "y")
    for name in ("conv", "ssm", "pos"):
        _close(tcache[name], jnew[name], name)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------

def test_mlstm_chunked_equals_jax():
    """(h, c, n, m) with chunk 16 over S = 40 (a chunk that does not divide
    S: the pad's log_i and log_f are 0)."""
    nh, hd = 4, 8
    q, k, v = (_randn(B, S, nh, hd, seed=s) for s in (1, 2, 3))
    log_i = _randn(B, S, nh, seed=4)
    log_f = np.array(jax.nn.log_sigmoid(_randn(B, S, nh, seed=5) + 2.0))
    args = (q, k, v, log_i, log_f)
    jout = jxl._mlstm_chunked(*map(jnp.asarray, args), nh, hd, chunk=CHUNK)
    tout = txl._mlstm_chunked(*map(torch.from_numpy, args), nh, hd, chunk=CHUNK)
    for what, got, want in zip("hcnm", tout, jout):
        _close(got, want, what)


def _xlstm(decl_fn, seed=0):
    jc, tc = _cfgs("xlstm-350m")
    jp, tp = _params(decl_fn(jc), seed)
    return jc, tc, jp, tp


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_block_prefill_equals_jax(block):
    decl = {"mlstm": jxl.mlstm_decl, "slstm": jxl.slstm_decl}[block]
    jc, tc, jp, tp = _xlstm(decl)
    x = _randn(B, S, jc.d_model, seed=6)
    jy, _ = getattr(jxl, f"{block}_block")(jp, jnp.asarray(x), jc)
    ty, _ = getattr(txl, f"{block}_block")(tp, torch.from_numpy(x), tc)
    _close(ty, jy)


def _xlstm_state(block, tc):
    if block == "mlstm":
        _, nh, hd = txl._mdims(tc)
        return {"c": _randn(B, nh, hd, hd, seed=7), "n": _randn(B, nh, hd, seed=8),
                "m": _randn(B, nh, seed=9), "pos": np.int32(3)}
    nh = tc.n_heads
    shp = (B, nh, tc.d_model // nh)
    return {"c": _randn(*shp, seed=7), "n": np.abs(_randn(*shp, seed=8)) + 0.5,
            "h": _randn(*shp, seed=9), "m": _randn(*shp, seed=10), "pos": np.int32(3)}


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_block_decode_equals_jax(block):
    decl = {"mlstm": jxl.mlstm_decl, "slstm": jxl.slstm_decl}[block]
    jc, tc, jp, tp = _xlstm(decl)
    state = _xlstm_state(block, tc)
    jcache, tcache = _cache(state)
    x = _randn(B, 1, jc.d_model, seed=11)
    jy, jnew = getattr(jxl, f"{block}_block")(jp, jnp.asarray(x), jc, cache=jcache)
    ty, tnew = getattr(txl, f"{block}_block")(tp, torch.from_numpy(x), tc, cache=tcache)
    assert tnew is tcache
    _close(ty, jy, "y")
    for name in state:
        _close(tcache[name], jnew[name], name)


def test_slstm_step_equals_jax():
    jc, tc, jp, tp = _xlstm(jxl.slstm_decl)
    nh, hd = tc.n_heads, tc.d_model // tc.n_heads
    state = _xlstm_state("slstm", tc)
    carry = [state[k] for k in ("c", "n", "h", "m")]
    gx = _randn(B, 4 * tc.d_model, seed=12)
    jnew = jxl._slstm_step(jnp.asarray(jp["r"]), tuple(map(jnp.asarray, carry)),
                           jnp.asarray(gx), nh, hd)
    tnew = txl._slstm_step(tp["r"], tuple(map(torch.from_numpy, carry)), torch.from_numpy(gx),
                           nh, hd)
    for what, got, want in zip("cnhm", tnew, jnew):
        _close(got, want, what)


def test_geglu_is_the_tanh_gelu():
    """JAX's ``gelu`` defaults to the tanh form, which the sLSTM block's
    GEGLU keeps; PyTorch's default (erf) differs by about 1e-3."""
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_xlstm_dims_and_decls_equal_jax():
    shapes = lambda d: sorted((k, tuple(v.shape)) for k, v in _flat(d))
    for jc in (get_config("xlstm-350m"), get_config("xlstm-350m").smoke()):
        tc = convert.convert_config(jc)
        assert txl._mdims(tc) == jxl._mdims(jc)
        for name in ("mlstm_decl", "slstm_decl"):
            assert shapes(getattr(txl, name)(tc)) == shapes(getattr(jxl, name)(jc)), name
    assert (txl.MLSTM_CHUNK, txl.MLSTM_EXPAND, txl.SLSTM_FF) == (
        jxl.MLSTM_CHUNK, jxl.MLSTM_EXPAND, jxl.SLSTM_FF)
    assert tssm.SSD_CHUNK == jssm.SSD_CHUNK
    jc = get_config("zamba2-1.2b")
    assert tssm._dims(convert.convert_config(jc)) == jssm._dims(jc)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

CACHE_KINDS = [("zamba2-1.2b", "mamba"), ("zamba2-1.2b", "shared_attn"),
               ("xlstm-350m", "mlstm"), ("xlstm-350m", "slstm"),
               ("llama-3.2-vision-90b", "cross")]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch,kind", CACHE_KINDS)
def test_block_cache_decl_equals_jax(arch, kind, smoke):
    """Each new kind's cache: names, shapes and dtypes (``meta`` tensors)."""
    jc = get_config(arch).smoke() if smoke else get_config(arch)
    tc = convert.convert_config(jc)
    want = JM._block_cache_decl(kind, jc, 3, 40)
    got = TM._block_cache_decl(kind, tc, 3, 40)
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype), name
        assert got[name].is_meta


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_decl_tree_equals_jax(arch):
    jc = get_config(arch).smoke()
    want = jax.tree.leaves(JM.cache_decl(jc, 2, 24))
    got = tree_leaves(TM.cache_decl(convert.convert_config(jc), 2, 24))
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]


def _inputs(cfg, s, seed=0):
    rng = np.random.RandomState(seed)
    if cfg.embed_frontend_stub:
        return torch.from_numpy(rng.randn(1, s, cfg.d_model).astype(np.float32))
    return torch.from_numpy(rng.randint(0, cfg.vocab, (1, s)).astype(np.int32))


def _named(tree, name):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == name:
                yield v
            else:
                yield from _named(v, name)
    elif isinstance(tree, list):
        for v in tree:
            yield from _named(v, name)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_decode_step_advances_the_stacked_cache_in_place(arch):
    """Two decode steps in a row write every recurrent state and ``pos``
    into the stacked cache tensors themselves (the leaves keep their
    storage), and the second step's logits are the forward's."""
    cfg = tconfigs.get_config(arch).smoke()
    params = TM.init_params(TM.decl_model(cfg), torch.Generator().manual_seed(0))
    x = _inputs(cfg, 2)
    vis = (torch.randn(1, cfg.n_vis_tokens, cfg.d_model, generator=torch.Generator().manual_seed(1))
           if cfg.n_vis_tokens else None)
    with torch.inference_mode():
        cache = TM.init_cache(params, cfg, 1, 8, vis_embeds=vis)
        leaves = tree_leaves(cache)
        ptrs = [t.data_ptr() for t in leaves]
        before = [t.clone() for t in leaves]
        for t in range(2):
            logits, out = TM.decode_step(params, cfg, cache, x[:, t:t + 1], t)
            assert out is cache
        full, _, _ = TM.forward(params, cfg, vis_embeds=vis,
                                **{"embeds" if cfg.embed_frontend_stub else "tokens": x})
    after = tree_leaves(cache)
    assert [t.data_ptr() for t in after] == ptrs
    pos = list(_named(cache, "pos"))
    assert len(pos) == len(TM.block_pattern(cfg)[0]) + len(TM.block_pattern(cfg)[2]) - sum(
        k == "cross" for k in TM.block_pattern(cfg)[0])
    assert all(bool((t == 2).all()) for t in pos), [t.tolist() for t in pos]
    moved = sum(not torch.equal(a, b) for a, b in zip(after, before))
    fixed = sum(torch.equal(a, b) for a, b in zip(after, before))
    n_cross = sum(2 for k in TM.block_pattern(cfg)[0] if k == "cross")
    assert moved == len(after) - n_cross and fixed == n_cross
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 1].numpy(), rtol=2e-4, atol=2e-5)
