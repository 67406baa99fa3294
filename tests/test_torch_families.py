"""The hybrid, ssm, vlm and audio families through the port's model stack
(``repro_torch.models.model``, the ``--arch`` decode demo) against the JAX
package's on the CPU.

Float32 ``smoke()`` configs of zamba2-1.2b, xlstm-350m,
llama-3.2-vision-90b and musicgen-large; zamba2 and xlstm at
``ssd_chunk=16``, so that S = 64 and the S_DEC = 24 decode steps cross
chunk boundaries and a padded chunk. Parameters are drawn by the JAX
package's ``init_params`` and carried across by
``convert.params_from_numpy``; tokens, frame embeddings (musicgen) and
patch embeddings (vision) come from a seeded numpy generator. JAX's
``forward`` and ``decode_step`` are jitted once an architecture (a
module-scoped fixture). Logits are held to ``LOGIT_RTOL`` of their largest
magnitude, and every block of the stack, fed JAX's own activations, to
``BLOCK_RTOL`` of its output's largest magnitude.

One exception, measured in every run: the vision stack (10 layers of
attention at S = 64) magnifies float32 rounding so much that the JAX
package itself moves by about 1e-2 of its largest logit when each
parameter is perturbed by a relative 1e-6 (zamba2 8e-4, the others below
1e-4). Its whole-stack forward is held to that movement instead of
``LOGIT_RTOL``; its blocks, its decode and its decode against its forward
keep the tight limits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.parallel.sharding import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as tsharding

import _torch_threads

_torch_threads.pin()

LOGIT_RTOL = 2e-4
BLOCK_RTOL = 2e-5
PERTURB = 1e-6
B, S, S_DEC = 2, 64, 24
ARCHS = {
    "zamba2-1.2b": {"ssd_chunk": 16},            # mamba x5 + shared attention, x2
    "xlstm-350m": {"ssd_chunk": 16},             # mlstm + slstm, x2
    "llama-3.2-vision-90b": {},                  # attn x4 + cross, x2; 16 patch embeddings
    "musicgen-large": {},                        # frame embeddings, no token table
}
ILL_CONDITIONED = {"llama-3.2-vision-90b"}


def _inputs(jc, seed=0):
    """Tokens or frame embeddings (B, S), and patch embeddings for a vlm."""
    rng = np.random.RandomState(seed)
    if jc.embed_frontend_stub:
        x = rng.randn(B, S, jc.d_model).astype(np.float32)
    else:
        x = rng.randint(0, jc.vocab, (B, S)).astype(np.int32)
    vis = rng.randn(B, jc.n_vis_tokens, jc.d_model).astype(np.float32) if jc.n_vis_tokens else None
    return x, vis


def _perturbed(jp, seed=1):
    leaves, tree = jax.tree.flatten(jp)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [
        leaf * (1 + PERTURB * rng.randn(*leaf.shape).astype(np.float32)) for leaf in leaves])


@pytest.fixture(scope="module", params=list(ARCHS))
def arch_run(request):
    """One architecture through both packages: forward on (B, S) inputs and
    S_DEC decode steps (batch 1), JAX jitted once each."""
    arch = request.param
    jc = dataclasses.replace(get_config(arch).smoke(), **ARCHS[arch])
    tc = convert.convert_config(jc)
    jp = jinit(JM.decl_model(jc), jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    x, vis = _inputs(jc)
    key = "embeds" if jc.embed_frontend_stub else "tokens"
    jvis = None if vis is None else jnp.asarray(vis)
    tvis = None if vis is None else torch.from_numpy(vis)

    j_fwd = jax.jit(lambda p, x_, v: JM.forward(p, jc, vis_embeds=v, **{key: x_})[0])
    j_logits = np.asarray(j_fwd(jp, jnp.asarray(x), jvis))
    moved = np.asarray(j_fwd(_perturbed(jp), jnp.asarray(x), jvis))
    cond = float(np.abs(moved - j_logits).max() / np.abs(j_logits).max())
    j_step = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jc, c, t, pos))
    cache = JM.init_cache(jp, jc, 1, max_len=S_DEC, vis_embeds=None if vis is None else jvis[:1])
    j_dec = []
    for t in range(S_DEC):
        lg, cache = j_step(jp, cache, jnp.asarray(x[:1, t:t + 1]), jnp.asarray(t, jnp.int32))
        j_dec.append(np.asarray(lg[:, 0]))

    tx = torch.from_numpy(x)
    with torch.inference_mode():
        t_logits, _, _ = TM.forward(tp, tc, vis_embeds=tvis, **{key: tx})
        t_short, _, _ = TM.forward(tp, tc, vis_embeds=None if vis is None else tvis[:1],
                                   **{key: tx[:1, :S_DEC]})
        cache = TM.init_cache(tp, tc, 1, S_DEC, vis_embeds=None if vis is None else tvis[:1])
        t_dec = []
        for t in range(S_DEC):
            lg, cache = TM.decode_step(tp, tc, cache, tx[:1, t:t + 1], t)
            t_dec.append(lg[:, 0])
    return dict(arch=arch, jc=jc, tc=tc, jp=jp, tp=tp, key=key, x=x, vis=vis, cond=cond,
                j_logits=j_logits, j_dec=np.stack(j_dec, 1), t_logits=t_logits.numpy(),
                t_short=t_short.numpy(), t_dec=torch.stack(t_dec, 1).numpy())


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def test_forward_equals_jax(arch_run):
    run = arch_run
    assert run["t_logits"].shape == (B, S, run["jc"].vocab)
    assert np.isfinite(run["t_logits"]).all()
    limit = LOGIT_RTOL
    if run["arch"] in ILL_CONDITIONED:
        assert run["cond"] > LOGIT_RTOL, run["cond"]
        limit = run["cond"]
    err = _rel(run["t_logits"], run["j_logits"])
    assert err < limit, f"{run['arch']}: relative error {err:.3e}, limit {limit:.3e}"


def test_decode_equals_jax(arch_run):
    err = _rel(arch_run["t_dec"], arch_run["j_dec"])
    assert err < LOGIT_RTOL, f"{arch_run['arch']}: relative error {err:.3e}"


def test_decode_equals_forward(arch_run):
    """The port's own check: S_DEC single-token steps through the cache
    (the recurrent states and the vision K/V of ``init_cache``) give the
    logits of one forward."""
    err = _rel(arch_run["t_dec"], arch_run["t_short"])
    assert err < LOGIT_RTOL, f"{arch_run['arch']}: relative error {err:.3e}"


def test_blocks_equal_jax_layer_by_layer(arch_run):
    """Every block of the stack, the shared attention's occurrences and the
    tail included, fed the JAX block's input, against the JAX block."""
    run = arch_run
    jc, tc, jp, tp = run["jc"], run["tc"], run["jp"], run["tp"]
    pattern, n_super, tail = JM.block_pattern(jc)
    slots = JM._pattern_param_slots(pattern)
    pos = np.arange(S, dtype=np.int32)
    if run["key"] == "embeds":
        jx = jnp.asarray(run["x"])
    else:
        jx = jlayers.embed_tokens(jp["embed"], jnp.asarray(run["x"]), jc)
    jvis = None if run["vis"] is None else jnp.asarray(run["vis"])
    tvis = None if run["vis"] is None else torch.from_numpy(run["vis"])
    layers = [(kind, slots[pi], i) for i in range(n_super) for pi, kind in enumerate(pattern)]
    layers += [(kind, "tail", ti) for ti, kind in enumerate(tail)]
    jitted = {kind: jax.jit(lambda p, x_, sp, v, kind=kind: JM.apply_block(
        kind, p, x_, jc, positions=jnp.asarray(pos), vis_embeds=v, shared_params=sp)[0])
        for kind in set(pattern + tail)}
    for kind, slot, i in layers:
        if slot == "tail":
            jpl, tpl = jp["tail"][i], tp["tail"][i]
        elif slot is None:
            jpl = tpl = None
        else:
            jpl = jax.tree.map(lambda a: a[i], jp["blocks"][slot])
            tpl = TM._layer(tp["blocks"][slot], i)
        with torch.inference_mode():
            ty, _, _ = TM.apply_block(kind, tpl, torch.from_numpy(np.array(jx)), tc,
                                      positions=torch.from_numpy(pos), vis_embeds=tvis,
                                      shared_params=tp.get("shared_attn"))
        jx = jitted[kind](jpl, jx, jp.get("shared_attn"), jvis)
        err = _rel(ty.numpy(), np.asarray(jx))
        assert err < BLOCK_RTOL, f"{kind} {slot} {i}: relative error {err:.3e}"


def test_transformer_module_runs_the_functions(arch_run):
    run = arch_run
    model = TM.Transformer(run["tc"], params=run["tp"])
    n = sum(p.numel() for p in model.parameters())
    assert n == tsharding.param_count(TM.decl_model(run["tc"]))
    vis = None if run["vis"] is None else torch.from_numpy(run["vis"])
    x = torch.from_numpy(run["x"])
    with torch.inference_mode():
        logits, _, _ = model(vis_embeds=vis, **{run["key"]: x})
        cache = model.init_cache(1, S_DEC, vis_embeds=None if vis is None else vis[:1])
        step, _ = model.decode_step(cache, x[:1, :1], 0)
    np.testing.assert_array_equal(logits.numpy(), run["t_logits"])
    np.testing.assert_array_equal(step[:, 0].numpy(), run["t_dec"][:, 0])


def test_shared_attention_is_one_parameter_set():
    """zamba2's shared block: one ``shared_attn`` tree, no stacked slot for
    it in ``blocks``; its six occurrences each get a KV cache slot stacked
    over ``n_super``."""
    cfg = tconfigs.get_config("zamba2-1.2b")
    decl = TM.decl_model(cfg)
    pattern, n_super, tail = TM.block_pattern(cfg)
    assert pattern == ["mamba"] * 5 + ["shared_attn"] and n_super == 6 and tail == ["mamba"] * 2
    assert len(decl["blocks"]) == 5 and set(decl["shared_attn"]) == {"attn", "mlp"}
    cache = TM.cache_decl(cfg, 2, 16)
    assert tuple(cache["pattern"][5]["k"].shape) == (6, 2, 16, cfg.n_kv, cfg.hd())


# ---------------------------------------------------------------------------
# the decode demo
# ---------------------------------------------------------------------------

DEMO = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_decode_demo(arch, capsys):
    gen_len = "1" if arch == "musicgen-large" else "5"
    argv = ["--arch", arch, *DEMO, "--gen-len", gen_len]
    gen = tserve.main(argv)
    assert gen.shape == (2, int(gen_len)) and gen.dtype == torch.int32
    vocab = tconfigs.get_config(arch).smoke().vocab
    assert bool(((gen >= 0) & (gen < vocab)).all())
    out = capsys.readouterr().out
    assert "ms/step" in out and "tok/s" in out and "sample continuation" in out
    assert torch.equal(tserve.main(argv), gen)            # drawn from --seed


def test_serve_frame_embeddings_exit_on_generation():
    """musicgen has no token table to feed a generated token back through:
    as in the JAX demo, a generation past the prompt exits."""
    with pytest.raises(SystemExit, match="frontend-stub"):
        tserve.main(["--arch", "musicgen-large", *DEMO, "--gen-len", "2"])


def test_serve_draws_the_patch_embeddings_after_the_prompts(monkeypatch):
    """The vlm's (batch, n_vis_tokens, d_model) patch embeddings come from
    the prompts' RandomState(seed), right after the prompts, and fill the
    cache's cross slots."""
    seen = []
    init_cache = TM.init_cache

    def recording(params, cfg, batch, max_len, vis_embeds=None):
        seen.append(vis_embeds)
        return init_cache(params, cfg, batch, max_len, vis_embeds=vis_embeds)

    monkeypatch.setattr(TM, "init_cache", recording)
    tserve.main(["--arch", "llama-3.2-vision-90b", *DEMO, "--gen-len", "2", "--seed", "3"])
    cfg = tconfigs.get_config("llama-3.2-vision-90b").smoke()
    rng = np.random.RandomState(3)
    rng.randint(1, cfg.vocab, size=(2, 4), dtype=np.int32)
    want = rng.randn(2, cfg.n_vis_tokens, cfg.d_model).astype(np.float32)
    assert len(seen) == 1 and seen[0].dtype == torch.float32
    np.testing.assert_array_equal(seen[0].numpy(), want)
