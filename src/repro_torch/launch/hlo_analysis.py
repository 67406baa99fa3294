"""Per-device accounting of a traced step: flops, bytes, collectives, and
the roofline terms (counterpart of ``repro/launch/hlo_analysis.py``).

The JAX package reads XLA's post-SPMD cost analysis and parses the
collectives out of the optimized HLO text. The port has no HLO: it counts
the aten ops that a step issues, eagerly, on real or fake tensors, with
:class:`CountingMode` (a ``TorchDispatchMode``):

* **flops**: ``torch.utils.flop_counter``'s formulas (matmuls, batched
  matmuls, convolutions, attention); elementwise ops count no flops there.
* **bytes**: each op's inputs plus its outputs (an output that aliases an
  input counted once), views and metadata ops zero bytes.
* **collectives**: every c10d and ``_c10d_functional`` collective, as the
  JAX record ``{kind: {"count", "operand_bytes", "result_bytes"}}``.

Counts are PER DEVICE, as XLA's are after partitioning: an op on a
``DTensor`` is let through to DTensor (the mode returns ``NotImplemented``
for it), which issues it on each rank's local tensors and adds the
collectives its redistributions need; those local ops and collectives are
what the mode counts. An op on a plain tensor counts as it is.

Work counted apart from the trace comes in through :meth:`CountingMode.add`
(``launch.dryrun``'s fitted sLSTM time loop).

A kernel door (``repro_torch.kernels``' B11, K1 and K3) reports its own
work from its formula to the modes in force, once, on its local shapes,
and the ops inside it are not counted (``kernels.build.counted``): the
same count whether the door launches its kernel, runs its plain version
or, on fake tensors, only gives its outputs' shapes.

Hardware constants: NVIDIA H100 SXM data sheet. ``ICI_BW`` is the
bandwidth a GPU has on the link the production mesh's collectives cross:
the 16-wide ``model`` axis spans two 8-GPU nodes and every ``data``
collective crosses nodes, so it is NDR InfiniBand's 400 Gb/s a GPU (50
GB/s). Within one node NVLink gives 450 GB/s a direction.
"""

from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build

PEAK_FLOPS = 989e12          # dense bf16 tensor cores per GPU
HBM_BW = 3.35e12             # bytes/s per GPU (HBM3)
ICI_BW = 50e9                # bytes/s per GPU: NDR InfiniBand across nodes

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "all-reduce-start",
    "all-gather-start", "collective-permute-start",
)

# c10d (in place) and _c10d_functional op names -> JAX's kinds
_KINDS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "_allgather_base_": "all-gather", "all_gather_into_tensor": "all-gather",
    "allgather_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# c10d's argument names: what a collective reads, what it writes
_OPERANDS = ("tensors", "input_tensor", "input_tensors", "input")
_RESULTS = ("tensors", "output_tensor", "output_tensors", "output")
# ops that move no data: allocation without a write, and metadata
_NO_BYTES = frozenset({
    "empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like", "detach",
    "_unsafe_view", "device",
    "alias", "lift_fresh", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "_local_scalar_dense", "set_", "resize_", "wait_tensor",
})


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _uncounted(fn):
    """``fn`` unseen by every counting mode in force: no counts, no memory."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        sinks = list(build.WORK_SINKS)
        for sink in sinks:
            sink.hidden += 1
        try:
            return fn(*args, **kwargs)
        finally:
            for sink in sinks:
                sink.hidden -= 1

    return run


def _pause_in_sharding_propagation():
    """DTensor derives an op's output shape by running the op on fake
    tensors of the GLOBAL shapes (``ShardingPropagator``), inside the modes
    in force; those runs are no device's work, so the counting pauses in
    them. Installed by the outermost :class:`CountingMode` on entry; returns
    what puts DTensor's own methods back, which it calls on exit."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if hasattr(ShardingPropagator, n)]
    if not names:
        raise RuntimeError("this torch's DTensor has no _propagate_tensor_meta: the counting "
                           "mode cannot tell its global-shape propagation from local work")
    own = {name: getattr(ShardingPropagator, name) for name in names}
    for name, fn in own.items():
        setattr(ShardingPropagator, name, _uncounted(fn))

    def restore():
        for name, fn in own.items():
            setattr(ShardingPropagator, name, fn)

    return restore


class CountingMode(TorchDispatchMode):
    """Counts the ops a block issues, per device (module docstring):
    :attr:`flops`, :attr:`bytes`, :attr:`collectives` (JAX's record) and
    :attr:`door_work` (kernel name -> {"calls", "flops", "bytes"} that the
    doors reported) and, with ``track_memory``, :attr:`peak_bytes`: the most
    bytes of the storages the block allocated that were alive at once.
    Enter it inside any ``FakeTensorMode``, so it sees each op before the
    fake mode runs it."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.track_memory = track_memory
        self.live_bytes = self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, dict] = defaultdict(
            lambda: {"count": 0, "operand_bytes": 0, "result_bytes": 0})
        self.door_work: Dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        # aten op -> {"count", "flops", "bytes"}
        self.ops: Dict[str, dict] = defaultdict(lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})
        self.paused = 0                     # a door's body: its work is its formula's
        self.hidden = 0                     # DTensor's propagation: nothing is seen

    _in_force = 0                           # modes entered and not yet left
    _restore = None                         # puts DTensor's propagation back

    def __enter__(self):
        if CountingMode._in_force == 0:
            CountingMode._restore = _pause_in_sharding_propagation()
        CountingMode._in_force += 1
        build.WORK_SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.WORK_SINKS.remove(self)
        CountingMode._in_force -= 1
        if CountingMode._in_force == 0:
            CountingMode._restore()
        return super().__exit__(*exc)

    # a door's report (kernels.build.counted)
    def add_work(self, kernel: str, flops: float, nbytes: float) -> None:
        rec = self.door_work[kernel]
        rec["calls"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def add(self, name: str, flops: float, nbytes: float) -> None:
        """Work counted apart (``launch.dryrun``'s fitted loop), recorded
        under ``name`` among :attr:`ops`."""
        rec = self.ops[name]
        rec["count"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    @property
    def collective_bytes(self) -> int:
        """Operand bytes of every collective (the JAX package's
        ``collective_bytes``)."""
        return sum(v["operand_bytes"] for v in self.collectives.values())

    def record(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "collectives": {k: dict(v) for k, v in self.collectives.items()},
                "door_work": {k: dict(v) for k, v in self.door_work.items()}}

    def _allocated(self, func, out) -> None:
        """Each new storage among ``out`` (not a view, not an alias of an
        input, not seen before) adds its bytes to :attr:`live_bytes` until
        it is freed; :attr:`peak_bytes` is the most live at once."""
        if func.is_view:
            return
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor) or (
                    i < len(func._schema.returns) and func._schema.returns[i].alias_info):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def _collective(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[1]
        if name == "wait_tensor":
            return
        bound = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
        operand = sum(_nbytes(t) for a in _OPERANDS if a in bound for t in _tensors(bound[a]))
        result = sum(_nbytes(t) for a in _RESULTS if a in bound for t in _tensors(bound[a]))
        if func.namespace == "_c10d_functional":
            result = sum(_nbytes(t) for t in _tensors(out))
        rec = self.collectives[_KINDS.get(name, name)]
        rec["count"] += 1
        rec["operand_bytes"] += operand
        rec["result_bytes"] += result

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor issues it again on local tensors
        out = func(*args, **kwargs)
        if self.hidden:
            return out
        if self.track_memory and func.namespace != "c10d":
            self._allocated(func, out)
        if self.paused:
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._collective(func, args, kwargs, out)
            return out
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        flops = formula(*args, **kwargs, out_val=out) if formula is not None else 0
        nbytes = 0
        if not (func.is_view or packet.__name__ in _NO_BYTES):
            aliased = {i for i, r in enumerate(func._schema.returns) if r.alias_info is not None}
            outs = [t for i, t in enumerate(out if isinstance(out, (tuple, list)) else (out,))
                    if i not in aliased]
            nbytes = sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, _tensors(outs)))
        rec = self.ops[str(packet)]
        rec["count"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        return out


def roofline_terms(flops: float, bytes_accessed: float, collective_bytes: float, n_chips: int):
    """The three roofline terms, in seconds (brief's formulas)."""
    return {
        "compute_s": flops / (n_chips * PEAK_FLOPS),
        "memory_s": bytes_accessed / (n_chips * HBM_BW),
        "collective_s": collective_bytes / (n_chips * ICI_BW),
    }


def dominant_term(terms: dict) -> str:
    return max(
        (("compute", terms["compute_s"]), ("memory", terms["memory_s"]),
         ("collective", terms["collective_s"])),
        key=lambda kv: kv[1],
    )[0]
