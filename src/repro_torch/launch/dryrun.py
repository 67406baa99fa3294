"""Multi-pod dry-run: trace every (architecture x input shape) cell on the
production meshes of a fake process group and record its per-device
flops, bytes, collectives, memory and roofline (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single --device cpu          # one cell, on the host
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # everything, fake CUDA tensors
    PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the records' roofline table

A cell starts a ``fake`` process group of 256 (``single``, a ``(16, 16)``
``(data, model)`` mesh) or 512 ranks (``multi``, ``(2, 16, 16)`` ``(pod,
data, model)``) inside :func:`lower_cell`, never at import, and ends it on
the way out. It places the abstract train state, batch and decode cache as
``DTensor`` s of ``FakeTensor`` shards by ``launch.steps``' shardings
(each leaf is rank 0's slice: shape, dtype and device, no storage), and
runs the port's own ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` on the card's backend (``backend="cuda"``: B11 for
attention, K1 and K3 for MoE routing) under
``launch.hlo_analysis.CountingMode``. The doors launch nothing on fake
tensors and report their work from their formulas. A MoE config's
``multisplit`` dispatch is taken as ``multisplit_ep`` on the mesh, as the
launchers take it (``launch.mesh.expert_parallel``).

``--device`` is ``cuda`` by default: fake CUDA tensors, which need a torch
built with CUDA (and the card's machine); on a torch without CUDA it
raises. ``--device cpu`` traces on fake CPU tensors anywhere; the counts
are the same.

An eager trace runs every layer, so the counts are exact at full depth:
there is no loop body that XLA's cost analysis counts once, and no
two-point delta over the block pattern (``"accounting": "full-depth
trace"`` in every record). One loop is not traced at its length: the sLSTM
time loop (``models.xlstm._slstm_time``), ``S`` host steps a block, where
the JAX package counts its body once and folds the rest into
``MODEL_FLOPS``. The trace runs the real loop at ``FIT_STEPS`` lengths on
fake tensors of the call's shapes, forward and, where the call takes a
gradient, backward; the counts are a quadratic in the length (steps alike,
and each step's backward writes a gates-sized gradient), which the fit
must predict exactly at ``CHECK_STEPS`` or the trace raises; the quadratic
at ``S`` is added to the counts, and the loop's outputs and gradients are
allocated without data (``"loop_fitted"`` in the record: the calls and
the lengths). The fit's values are exact; the memory peak misses the
loop's own transient tensors.

Artifacts: ``artifacts/dryrun_torch/{arch}__{shape}__{mesh}.json``, one a
cell. The record keeps the JAX record's keys where they mean the same
(per-device counts scaled by the chip count: ``hlo_flops``, ``hlo_bytes``,
``collective_bytes``; ``collectives_full_graph``, ``roofline``,
``dominant``, ``model_flops``, ``useful_fraction``, ``n_params``, ...).
Its own keys: ``trace_s`` (the trace's wall seconds, in place of
``lower_s`` and ``compile_s``), ``per_device`` (the unscaled counts),
``door_work`` (each door's reported work a device), ``device``,
``dispatch``, ``accounting``, ``loop_fitted``; ``memory_analysis`` holds
``argument_size_in_bytes`` (the local state, batch and cache),
``output_size_in_bytes``, ``peak_size_in_bytes`` (arguments plus the
most bytes the step's own allocations held at once: the storages it made,
counted until freed) and
``temp_size_in_bytes`` (peak less arguments). The roofline times are
estimates from counts and H100 data-sheet constants.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ALIASES, ARCH_IDS, get_config  # noqa: F401  (ARCH_IDS: JAX's names)
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch import steps as S
from repro_torch.launch.hlo_analysis import CountingMode, dominant_term, roofline_terms
from repro_torch.launch.input_specs import (
    SHAPES,
    shape_applicable,
    sized_batch_specs,
    sized_decode_specs,
)
from repro_torch.launch.mesh import expert_parallel, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import xlstm
from repro_torch.parallel.sharding import (
    param_count,
    set_mesh,
    shard_slices,
    tree_leaves,
    tree_map,
)

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

FSDP_THRESHOLD = 50e9      # params; larger archs shard params/opt over data
BF16_MOMENTS_THRESHOLD = 300e9


def parallel_config(cfg, mesh, n_params: int) -> ParallelConfig:
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return ParallelConfig(fsdp=n_params > FSDP_THRESHOLD, dp_axes=dp)


def train_config(n_params: int) -> TrainConfig:
    return TrainConfig(
        moments_dtype="bfloat16" if n_params > BF16_MOMENTS_THRESHOLD else "float32"
    )


def model_flops_estimate(cfg, decls, shape: str) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for inference."""
    n_active = active_param_count(cfg, decls)
    info = SHAPES[shape]
    if info["kind"] == "train":
        tokens = info["batch"] * info["seq"]
        return 6.0 * n_active * tokens
    if info["kind"] == "prefill":
        tokens = info["batch"] * info["seq"]
        return 2.0 * n_active * tokens
    return 2.0 * n_active * info["batch"]          # decode: one token per row


def active_param_count(cfg, decls) -> float:
    n_total = param_count(decls)
    if not cfg.moe.num_experts:
        return float(n_total)
    # subtract non-routed fraction of expert params
    expert_params = 0
    for blk in decls["blocks"]:
        if "moe" in blk:
            for key in ("w_gate", "w_up", "w_down"):
                expert_params += int(np.prod(blk["moe"][key].shape))
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return float(n_total - expert_params * (1.0 - frac))


# ---------------------------------------------------------------------------
# One trace
# ---------------------------------------------------------------------------

def _check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry-run traces on fake CUDA tensors by default, and this torch "
                           "has no CUDA: pass --device cpu (device='cpu') to trace on the host")


def _fake_placed(meta_tree, shardings, device):
    """Each ``meta`` leaf as rank 0's shard under its :class:`NamedSharding`:
    an empty tensor on ``device`` (a ``FakeTensor`` inside the fake mode),
    wrapped as a ``DTensor`` on a mesh of several devices (on one device a
    plain tensor, as ``parallel.sharding.place`` leaves it; with no
    shardings, the whole leaf)."""
    def one(leaf, sh=None):
        if sh is None or sh.mesh.size() == 1:
            return torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        mesh = sh.mesh
        sl = shard_slices(leaf.shape, mesh, sh.placements, mesh.get_coordinate())
        local = torch.empty(tuple(s.stop - s.start for s in sl), dtype=leaf.dtype, device=device)
        return DTensor.from_local(local, mesh, sh.placements, run_check=False)

    return tree_map(one, meta_tree) if shardings is None else tree_map(one, meta_tree, shardings)


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            x = x.to_local() if isinstance(x, DTensor) else x
            total += x.numel() * x.element_size()
    return total


@contextlib.contextmanager
def _cached_sharding_propagation():
    """DTensor caches each op's sharding decision, except while it thinks a
    compiler traces (a fake mode is on), where shapes may be symbolic. A
    dry-run's shapes are static, so the cache is kept on for the block: the
    trace then propagates each distinct op once (a cell traces in a fraction
    of the time)."""
    from torch.distributed.tensor import _sharding_prop

    tracing = _sharding_prop._are_we_tracing
    _sharding_prop._are_we_tracing = lambda: False
    try:
        yield
    finally:
        _sharding_prop._are_we_tracing = tracing


FIT_STEPS = (2, 3, 4)      # the sLSTM loop's lengths its quadratic is fitted at
CHECK_STEPS = 5            # ... and the length it must then predict exactly
_LOOP_FITS: dict = {}      # the call's shapes, dtypes, device and grad -> its fit


def _at(points, values, x: int) -> int:
    """The polynomial through ``(points, values)`` (integers) at the
    integer ``x``, exactly (Lagrange's form in fractions: a whole number,
    since the points are consecutive)."""
    total = Fraction(0)
    for i, (xi, yi) in enumerate(zip(points, values)):
        term = Fraction(int(yi))
        for j, xj in enumerate(points):
            if j != i:
                term *= Fraction(x - xj, xi - xj)
        total += term
    return int(total)


def _empty_laid_out_as(t, shape):
    """An empty tensor of ``shape`` whose dimensions lie in memory in the
    order that ``t``'s strides give them (``t`` dense in some order)."""
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))     # outermost first
    if not t.permute(order).is_contiguous():
        raise RuntimeError(f"the sLSTM loop's fit takes dense tensors, got strides {t.stride()}")
    x = torch.empty([shape[d] for d in order], dtype=t.dtype, device=t.device)
    return x.permute([order.index(d) for d in range(t.dim())])


def _loop_counts(outer: CountingMode, loop, p_r, gates_x, nh: int, hd: int, grad: bool):
    """(forward, backward) of the sLSTM ``loop``, as (flops, bytes) pairs,
    at each length of ``FIT_STEPS + (CHECK_STEPS,)``: on new fake tensors of
    the call's shapes, dtypes and ``requires_grad``, unseen by ``outer``;
    the backward takes the gradient of ``h`` as the step does. Returns the
    runs and ``h``'s dtype."""
    b, _, g = gates_x.shape
    runs = []
    outer.hidden += 1
    # the fit's own graph keeps its tensors: inside a checkpointed block,
    # checkpoint's hooks would recompute the block in the fit's backward
    keep = torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)
    try:
        for s in FIT_STEPS + (CHECK_STEPS,):
            r = _empty_laid_out_as(p_r, p_r.shape)
            x = _empty_laid_out_as(gates_x, (b, s, g))
            ins = [t.requires_grad_(like.requires_grad and grad)
                   for t, like in ((r, p_r), (x, gates_x))]
            with torch.set_grad_enabled(grad), keep, CountingMode() as fwd:
                h, = loop(ins[0], ins[1], nh, hd)
            need = [t for t in ins if t.requires_grad]
            bwd = CountingMode()
            if need:
                dh = torch.empty_like(h)
                with keep, bwd:
                    torch.autograd.grad(h, need, dh)
            if fwd.collectives or bwd.collectives or fwd.door_work or bwd.door_work:
                raise RuntimeError("the sLSTM loop issued a collective or a door: it is not "
                                   "a local loop of alike steps")
            runs.append(((fwd.flops, fwd.bytes), (bwd.flops, bwd.bytes)))
    finally:
        outer.hidden -= 1
    return runs, h.dtype


class _FittedLoop(torch.autograd.Function):
    """The sLSTM loop's place in the autograd graph: ``h`` and the
    gradients are allocated without data, and ``backward`` counts the
    fitted backward when the graph reaches it."""

    @staticmethod
    def forward(ctx, count_backward, p_r, gates_x, h_shape, h_dtype):
        ctx.count_backward = count_backward
        ctx.like = tuple((t.shape, t.dtype) for t in (p_r, gates_x))
        return gates_x.new_empty(h_shape, dtype=h_dtype)

    @staticmethod
    def backward(ctx, dh):
        ctx.count_backward()
        return (None, *(dh.new_empty(shape, dtype=dtype) if need else None
                        for need, (shape, dtype) in zip(ctx.needs_input_grad[1:3], ctx.like)),
                None, None)


@contextlib.contextmanager
def _fitted_slstm_loop(counts: CountingMode):
    """Inside the block a call of ``models.xlstm._slstm_time`` from the
    initial carry longer than ``CHECK_STEPS`` is counted from its fit
    (module docstring) and runs no step; a shorter call, or one from a
    cache's carry, runs as it is. Yields the record's ``loop_fitted``."""
    real = xlstm._slstm_time
    fits = _LOOP_FITS
    record = {"calls": 0, "fit_steps": list(FIT_STEPS), "check_steps": CHECK_STEPS}

    def fitted(p_r, gates_x, nh: int, hd: int, *carry):
        b, s = gates_x.shape[:2]
        if carry or s <= CHECK_STEPS:
            return real(p_r, gates_x, nh, hd, *carry)
        grad = torch.is_grad_enabled() and (p_r.requires_grad or gates_x.requires_grad)
        key = (tuple(p_r.shape), b, gates_x.shape[2], p_r.dtype, gates_x.dtype,
               gates_x.device.type, p_r.stride(), gates_x.stride()[::2], gates_x.stride(1) == 1,
               p_r.requires_grad, gates_x.requires_grad, grad, nh, hd)
        if key not in fits:
            runs, h_dtype = _loop_counts(counts, real, p_r, gates_x, nh, hd, grad)
            fit = []
            for part in (0, 1):
                pair = []
                for k in (0, 1):
                    vals = [run[part][k] for run in runs]
                    if _at(FIT_STEPS, vals[:-1], CHECK_STEPS) != vals[-1]:
                        raise RuntimeError("the sLSTM loop's count is not a quadratic in its "
                                           f"length: {vals}")
                    pair.append(vals[:-1])
                fit.append(pair)
            fits[key] = {"counts": fit, "h_dtype": h_dtype}
        (ff, fb), (bf, bb) = fits[key]["counts"]
        record["calls"] += 1
        counts.add("slstm time loop (fitted)", _at(FIT_STEPS, ff, s), _at(FIT_STEPS, fb, s))
        h_shape, h_dtype = (b, s, nh, hd), fits[key]["h_dtype"]
        if not grad:
            return (gates_x.new_empty(h_shape, dtype=h_dtype),)
        count_backward = lambda: counts.add("slstm time loop backward (fitted)",
                                            _at(FIT_STEPS, bf, s), _at(FIT_STEPS, bb, s))
        return (_FittedLoop.apply(count_backward, p_r, gates_x, h_shape, h_dtype),)

    xlstm._slstm_time = fitted
    try:
        yield record
    finally:
        xlstm._slstm_time = real


def trace_step(cfg, kind: str, batch: int, seq: int, mesh=None, tc=None, pcfg=None, *,
               device: str = "cuda", capture_ops_to=None) -> dict:
    """Trace one step of ``kind`` (``train``, ``prefill`` or ``decode``) of
    ``cfg`` on ``batch`` sequences of ``seq`` (a decode: one token a row
    over a cache of ``seq``) on fake tensors under a counting mode, and
    return the per-device counts: flops, bytes, collectives, the doors'
    work, memory and the trace's seconds. ``mesh`` None is one process
    (plain tensors); on a mesh the state, batch and cache are placed by
    ``launch.steps``' shardings (``pcfg``: ``fsdp`` off over the mesh's data
    axes by default). ``tc``: the train state's dtypes (``TrainConfig()``
    by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    tc = tc or TrainConfig()
    if mesh is not None and pcfg is None:
        pcfg = ParallelConfig(dp_axes=tuple(a for a in mesh.mesh_dim_names
                                            if a in ("pod", "data")))
    decls = M.decl_model(cfg)
    counts = CountingMode(track_memory=True)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        sh = (lambda fn, *a: None) if mesh is None else (lambda fn, *a: fn(*a))
        st_sh = sh(S.state_shardings, decls, pcfg, mesh, tc)
        st_abs = S.abstract_state(decls, tc)
        if kind == "train":
            state = _fake_placed(st_abs, st_sh, device)
            batch_abs = sized_batch_specs(cfg, batch, seq, with_labels=True)
            args = (state, _fake_placed(batch_abs, sh(S.batch_sharding, cfg, mesh, batch_abs),
                                        device))
            step = S.make_train_step(cfg, tc, backend="cuda")
        elif kind == "prefill":
            params = _fake_placed(st_abs.params, st_sh and st_sh.params, device)
            batch_abs = sized_batch_specs(cfg, batch, seq, with_labels=False)
            args = (params, _fake_placed(batch_abs, sh(S.batch_sharding, cfg, mesh, batch_abs),
                                         device))
            step = S.make_prefill_step(cfg, backend="cuda")
        elif kind == "decode":
            params = _fake_placed(st_abs.params, st_sh and st_sh.params, device)
            cache_abs, token_abs, _ = sized_decode_specs(cfg, batch, seq)
            cache = _fake_placed(cache_abs, sh(S.cache_shardings, cfg, mesh, batch), device)
            token = _fake_placed(token_abs, sh(S.batch_sharding, cfg, mesh, token_abs), device)
            position = torch.empty((), dtype=torch.int32, device=device)
            args = (params, cache, token, position)
            step = S.make_decode_step(cfg)
        else:
            raise ValueError(f"kind must be train, prefill or decode, got {kind!r}")
        arg_bytes = local_bytes(args)
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        with set_mesh(mesh), grad, _cached_sharding_propagation(), counts, \
                _fitted_slstm_loop(counts) as fitted:
            out = step(*args)
        out_bytes = local_bytes(out)
        peak = arg_bytes + counts.peak_bytes
    trace_s = time.perf_counter() - t0
    if capture_ops_to:
        Path(capture_ops_to).write_text("".join(
            f"{r['count']:10d} {r['flops']:14.6g} {r['bytes']:14.6g} {op}\n"
            for op, r in sorted(counts.ops.items(), key=lambda kv: -kv[1]["bytes"])))
    rec = counts.record()
    rec["memory"] = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
                     "peak_size_in_bytes": peak, "temp_size_in_bytes": peak - arg_bytes}
    rec["trace_s"] = round(trace_s, 2)
    rec["loop_fitted"] = fitted if fitted["calls"] else {}
    return rec


def _apply_overrides(cfg, cfg_overrides):
    if not cfg_overrides:
        return cfg
    moe_over = {k[4:]: v for k, v in cfg_overrides.items() if k.startswith("moe_")}
    plain = {k: v for k, v in cfg_overrides.items() if not k.startswith("moe_")}
    if plain:
        cfg = dataclasses.replace(cfg, **plain)
    if moe_over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
    return cfg


def lower_cell(arch: str, shape: str, mesh_kind: str, capture_hlo_to=None,
               cfg_overrides=None, tc_overrides=None, *, device: str = "cuda"):
    """Trace one cell (module docstring) and return its record.
    ``capture_hlo_to``: the port has no HLO; the trace's aten ops with
    their counts, flops and bytes are written there instead."""
    cfg = _apply_overrides(get_config(arch), cfg_overrides)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
                "reason": "full-attention arch; long_500k requires sub-quadratic attention"}
    _check_device(device)
    if dist.is_initialized():
        raise RuntimeError("lower_cell starts its own fake process group; one is running")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n_chips = 512 if mesh_kind == "multi" else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_chips)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type=torch.device(device).type)
        cfg = expert_parallel(cfg, mesh)
        decls = M.decl_model(cfg)
        n_params = param_count(decls)
        pcfg = parallel_config(cfg, mesh, n_params)
        tc = train_config(n_params)
        if tc_overrides:
            tc = dataclasses.replace(tc, **tc_overrides)
        info = SHAPES[shape]
        full = trace_step(cfg, info["kind"], info["batch"], info["seq"], mesh, tc, pcfg,
                          device=device, capture_ops_to=capture_hlo_to)
    finally:
        dist.destroy_process_group()

    # the counts are PER DEVICE; scaled to global so that
    # HLO_FLOPs / (chips * peak) is the per-chip time, as the JAX records are
    glob = {key: full[key] * n_chips for key in ("flops", "bytes", "collective_bytes")}
    terms = roofline_terms(glob["flops"], glob["bytes"], glob["collective_bytes"], n_chips)
    mflops = model_flops_estimate(cfg, decls, shape)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "ok",
        "device": torch.device(device).type,
        "n_chips": n_chips,
        "n_params": int(n_params),
        "n_params_active": int(active_param_count(cfg, decls)),
        "fsdp": pcfg.fsdp,
        "moments_dtype": tc.moments_dtype,
        "dispatch": cfg.moe.dispatch if cfg.moe.num_experts else None,
        "trace_s": full["trace_s"],
        "accounting": "full-depth trace" + ("; the sLSTM time loop fitted"
                                             if full["loop_fitted"] else ""),
        "loop_fitted": full["loop_fitted"],
        "hlo_flops": glob["flops"], "hlo_bytes": glob["bytes"],
        "collective_bytes": glob["collective_bytes"],
        "per_device": {k: full[k] for k in ("flops", "bytes", "collective_bytes")},
        "collectives_full_graph": full["collectives"],
        "door_work": full["door_work"],
        "memory_analysis": full["memory"],
        "roofline": terms,
        "dominant": dominant_term(terms),
        "model_flops": mflops,
        "useful_fraction": (mflops / glob["flops"]) if glob["flops"] else None,
    }


def run_cells(cells, out_dir: Path, hlo_dir=None, variant: str = "",
              cfg_overrides=None, tc_overrides=None, *, device: str = "cuda"):
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    for arch, shape, mesh_kind in cells:
        name = f"{arch}__{shape}__{mesh_kind}{suffix}"
        out_path = out_dir / f"{name}.json"
        if out_path.exists():
            print(f"[skip cached] {name}")
            continue
        print(f"[dryrun] {name} ...", flush=True)
        try:
            ops_to = (Path(hlo_dir) / f"{name}.ops.txt") if hlo_dir else None
            rec = lower_cell(arch, shape, mesh_kind, capture_hlo_to=ops_to,
                             cfg_overrides=cfg_overrides, tc_overrides=tc_overrides,
                             device=device)
            if variant:
                rec["variant"] = variant
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
        out_path.write_text(json.dumps(rec, indent=2, default=str))
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" trace={rec['trace_s']}s dominant={rec['dominant']} "
                     f"flops={rec['hlo_flops']:.3g}")
        print(f"[done] {name}: {status}{extra}", flush=True)


def roofline_table(out_dir: Path, mesh_kind: str = "single") -> str:
    """A markdown table of the records in ``out_dir`` for ``mesh_kind``: a
    row an arch, a column a shape, each cell the dominant term and the
    roofline's compute / memory / collective milliseconds a step
    (estimates: counts over H100 data-sheet rates), then the trace's
    seconds; ``skipped`` or the error's type where the cell has no
    roofline."""
    recs = {}
    for path in sorted(Path(out_dir).glob(f"*__{mesh_kind}.json")):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"])] = rec
    archs = [a for a in ALIASES if any(k[0] == a for k in recs)]
    rows = ["| arch | " + " | ".join(SHAPES) + " |", "| --- |" + " --- |" * len(SHAPES)]
    for arch in archs:
        cells = []
        for shape in SHAPES:
            rec = recs.get((arch, shape))
            if rec is None:
                cells.append("not run")
            elif rec["status"] != "ok":
                cells.append(rec["status"] if rec["status"] == "skipped"
                             else rec["error"].split(":")[0])
            else:
                t = rec["roofline"]
                cells.append(f"{rec['dominant'][:3]} {t['compute_s'] * 1e3:.3g} / "
                             f"{t['memory_s'] * 1e3:.3g} / {t['collective_s'] * 1e3:.3g} ms; "
                             f"{rec['trace_s']} s")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", help="architecture id (repeatable)")
    ap.add_argument("--shape", action="append", choices=list(SHAPES))
    ap.add_argument("--mesh", action="append", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--hlo-dir", default=None,
                    help="also write each trace's aten ops and their counts (the port has no HLO)")
    ap.add_argument("--variant", default="", help="artifact suffix for perf variants")
    ap.add_argument("--cfg-set", action="append", default=[],
                    help="ModelConfig override k=v (moe_* targets the MoE sub-config)")
    ap.add_argument("--tc-set", action="append", default=[],
                    help="TrainConfig override k=v")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (default; needs a torch with CUDA) "
                         "or cpu")
    ap.add_argument("--table", action="store_true",
                    help="print the roofline table of the records in --out (each --mesh, "
                         "single by default) and trace nothing")
    args = ap.parse_args(argv)
    if args.table:
        for mesh_kind in args.mesh or ["single"]:
            print(roofline_table(Path(args.out), mesh_kind))
        return

    def parse_kv(items):
        out = {}
        for it in items:
            k, v = it.split("=", 1)
            if v in ("true", "True"):
                v = True
            elif v in ("false", "False"):
                v = False
            else:
                try:
                    v = int(v)
                except ValueError:
                    try:
                        v = float(v)
                    except ValueError:
                        pass
            out[k] = v
        return out

    _check_device(args.device)
    archs = args.arch or (list(ALIASES) if args.all or not args.arch else [])
    shapes = args.shape or list(SHAPES)
    meshes = args.mesh or ["single", "multi"]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    run_cells(cells, Path(args.out), hlo_dir=args.hlo_dir, variant=args.variant,
              cfg_overrides=parse_kv(args.cfg_set) or None,
              tc_overrides=parse_kv(args.tc_set) or None, device=args.device)


if __name__ == "__main__":
    main()
