"""Atomic, async checkpointing with step management and integrity marks
(counterpart of ``repro/checkpoint/manager.py``, on its on-disk layout).

Fault-tolerance contract (``runtime/supervisor.py``):
  * saves are atomic (write to a tmp dir, fsync the manifest, rename);
  * an interrupted save never corrupts the previous checkpoint;
  * ``latest_step`` only reports checkpoints whose COMMIT mark exists;
  * async mode overlaps the file writes with the next train steps and is
    drained before the next save (or by ``wait``).

The layout is the JAX package's: ``step_XXXXXXXX/`` holding one
``host_XXXXX.npz`` a host (the ``torch.distributed`` rank, 0 without a
process group) with one ``leaf_XXXXX`` array a leaf, ``manifest.json``
(step, time, host count, and each leaf's key, path, shape and dtype) and
the empty ``COMMIT`` mark. Leaves are in JAX's tree order, their paths
JAX's ``keystr`` (``.params['blocks'][0]['attn']['wq']``), so either
package reads a float32 / int32 checkpoint the other wrote. numpy has no
bfloat16 without an extension, so a bfloat16 leaf is stored as its uint16
bit patterns under ``"dtype": "bfloat16"`` and restored bitwise.

Over several ranks (a state of DTensors on a mesh) each rank writes its own
``host_{rank:05d}.npz`` holding the shards it writes, each element of a
leaf written by one rank only, and each leaf's manifest record lists its
``shards``: the writing rank and the slice it wrote. Rank 0 commits once,
after a barrier. A restore reads the slices it needs from whichever files
hold them, so a checkpoint comes back on the mesh that saved it, on another
mesh, or whole in one process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import shard_slices, tree_leaves_with_path, tree_unflatten


def _host(group=None) -> Tuple[int, int, int]:
    """(this host's index, the host count, the leading host): the rank in
    the default group, the size of ``group`` (the ranks that save together;
    the default group if None) and the rank of its first member; (0, 1, 0)
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(group), dist.get_global_rank(
            group or dist.group.WORLD, 0)
    return 0, 1, 0


def gloo_group():
    """A gloo group over every rank, or None without a process group of
    several ranks: the checkpoint manager's barriers and the supervisor's
    agreement run on groups of their own, apart from the train step's
    collectives (and on the host under nccl). Every rank makes it at the
    same point."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return None
    return dist.new_group(backend="gloo")


@dataclasses.dataclass(frozen=True)
class HostShard:
    """A leaf as one rank saves it: ``data`` the host copy of the part this
    rank writes (None when another rank writes it), ``shape`` the whole
    leaf's, ``dtype`` its torch dtype, and ``writers`` the ``(rank,
    ((start, stop), ...))`` of every rank that writes a piece; the pieces
    tile the leaf and no element is in two. A leaf of the tree walkers (not
    a named tuple, which they would walk into)."""
    data: Optional[torch.Tensor]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    writers: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]


def _writers(leaf, index: int):
    """The ranks that write DTensor ``leaf`` and their slices: of the ranks
    that hold one shard (they differ only on the leaf's replicated mesh
    dimensions), the one at replica ``index mod`` their count writes it, so
    the leaves of a replicated state are spread over the replicas."""
    mesh, placements = leaf.device_mesh, tuple(leaf.placements)
    ranks = mesh.mesh.cpu().numpy()
    rep = [i for i, p in enumerate(placements) if not p.is_shard()]
    n_rep = int(np.prod([ranks.shape[i] for i in rep])) if rep else 1
    pick = np.unravel_index(index % n_rep, [ranks.shape[i] for i in rep]) if rep else ()
    out = []
    for coord in np.ndindex(*ranks.shape):
        if all(coord[i] == c for i, c in zip(rep, pick)):
            sl = shard_slices(leaf.shape, mesh, placements, coord)
            out.append((int(ranks[coord]), tuple((s.start, s.stop) for s in sl)))
    return tuple(out)


def _host_copy(leaf, index: int = 0):
    """A copy on the host that later in-place updates of ``leaf`` leave
    alone: a plain tensor whole, a numpy value as an array, a DTensor as a
    :class:`HostShard` (this rank's piece copied only where it writes it)."""
    if isinstance(leaf, DTensor):
        writers = _writers(leaf, index)
        mine = dist.get_rank() in {r for r, _ in writers}
        data = leaf.to_local().detach().to("cpu", copy=True) if mine else None
        return HostShard(data, tuple(leaf.shape), leaf.dtype, writers)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array stored and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else str(torch.empty((), dtype=dtype).numpy().dtype)


def _barrier(group) -> None:
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


def save_checkpoint(ckpt_dir: str | Path, step: int, state: Any, *, group=None) -> Path:
    """Atomic synchronous save, by every rank of ``group`` together (the
    ranks that hold the state; the default group if None; one process
    without a group).

    Each rank writes ``host_{rank:05d}.npz`` with the pieces it writes: a
    plain leaf whole, from the group's first rank only; a DTensor leaf (or the
    :class:`HostShard` of one) as its shard, from one rank of each set that
    holds it, so every element is written once, and the manifest records
    each leaf's ``shards`` (the writing rank and its slice). After a barrier
    the first rank alone writes the manifest and the COMMIT mark and
    renames the directory; a last barrier lets no rank return before the
    step is committed. One process writes JAX's single-host
    layout byte for byte (no ``shards``)."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    if (final / "COMMIT").exists():
        # idempotent: this step is already durably saved (replay after a
        # restore re-reaches the same checkpoint boundary deterministically)
        return final
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    host, n_hosts, leader = _host(group)
    if host == leader:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    _barrier(group)

    arrays = {}
    meta = {"step": step, "leaves": [], "time": time.time(), "n_hosts": n_hosts}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(state)):
        key = f"leaf_{i:05d}"
        if isinstance(leaf, DTensor):
            leaf = _host_copy(leaf, i)
        if isinstance(leaf, HostShard):
            rec = {"key": key, "path": path, "shape": list(leaf.shape),
                   "dtype": _dtype_name(leaf.dtype),
                   "shards": [[r, [list(s) for s in sl]] for r, sl in leaf.writers]}
            if leaf.data is not None:
                arrays[key] = _to_numpy(leaf.data)[0]
        else:
            arr, dtype = _to_numpy(leaf)
            rec = {"key": key, "path": path, "shape": list(arr.shape), "dtype": dtype}
            if n_hosts > 1:
                rec["shards"] = [[leader, [[0, n] for n in arr.shape]]]
            if host == leader:
                arrays[key] = arr
        meta["leaves"].append(rec)
    np.savez(tmp / f"host_{host:05d}.npz", **arrays)
    _barrier(group)
    if host == leader:
        with open(tmp / "manifest.json", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        (tmp / "COMMIT").touch()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    _barrier(group)
    return final


def _restore_leaf(arr: np.ndarray, dtype: str, want) -> torch.Tensor:
    """The stored array as a tensor of ``want``'s dtype, on its device (the
    CPU for a ``meta`` stand-in)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(want, torch.Tensor):
        device = "cpu" if want.is_meta else want.device
        return t.to(device=device, dtype=want.dtype)
    return t


def _assemble(rec: dict, target: Tuple[slice, ...], read: Callable[[int, str], np.ndarray]
              ) -> np.ndarray:
    """The ``target`` slice of a leaf saved in pieces (``rec["shards"]``),
    copied out of every piece that overlaps it; raises if the pieces leave
    an element of it unwritten."""
    out, filled = None, 0
    for h, piece in rec["shards"]:
        lo = [max(a, t.start) for (a, _), t in zip(piece, target)]
        hi = [min(b, t.stop) for (_, b), t in zip(piece, target)]
        if any(a >= b for a, b in zip(lo, hi)) and len(target):
            continue
        arr = read(h, rec["key"])
        if out is None:
            out = np.empty([t.stop - t.start for t in target], dtype=arr.dtype)
        src = tuple(slice(a - p0, b - p0) for a, b, (p0, _) in zip(lo, hi, piece))
        dst = tuple(slice(a - t.start, b - t.start) for a, b, t in zip(lo, hi, target))
        out[dst] = arr[src]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if out is None or filled != out.size:
        raise ValueError(f"checkpoint pieces of {rec['path']} do not cover {target}")
    return out


def load_checkpoint(ckpt_dir: str | Path, like: Any, step: Optional[int] = None
                    ) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (used for dtype, shape and
    device). A DTensor leaf of ``like`` is restored as its own shard on its
    own mesh and placements, whatever mesh saved it; a plain leaf whole,
    assembled from every rank's pieces when several ranks saved it."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())
    flat_like = tree_leaves_with_path(like)
    if len(flat_like) != len(meta["leaves"]):
        raise ValueError(f"checkpoint {d} holds {len(meta['leaves'])} leaves, the state "
                         f"{len(flat_like)}")
    files = {}

    def read(h: int, key: str) -> np.ndarray:
        if h not in files:
            files[h] = np.load(d / f"host_{h:05d}.npz")
        return files[h][key]

    # a single-host checkpoint holds every leaf whole on host 0 (JAX's
    # layout); this process's own file first, as JAX reads it
    own = _host()[0] if (d / f"host_{_host()[0]:05d}.npz").exists() else 0
    leaves = []
    try:
        for (path, want), rec in zip(flat_like, meta["leaves"]):
            assert tuple(rec["shape"]) == tuple(want.shape), (rec["path"], rec["shape"],
                                                                want.shape)
            if isinstance(want, DTensor):
                target = shard_slices(want.shape, want.device_mesh, want.placements,
                                      want.device_mesh.get_coordinate())
            else:
                target = tuple(slice(0, n) for n in want.shape)
            if "shards" in rec:
                arr = _assemble(rec, target, read)
            else:
                arr = read(own, rec["key"])[target]
            t = _restore_leaf(arr, rec["dtype"], want.to_local() if isinstance(want, DTensor)
                              else want)
            if isinstance(want, DTensor):
                t = DTensor.from_local(t.contiguous(), want.device_mesh, want.placements,
                                       run_check=False)
            leaves.append(t)
    finally:
        for f in files.values():
            f.close()
    return tree_unflatten(like, leaves), step


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_") and (p / "COMMIT").exists()]
    return max(steps) if steps else None


class CheckpointManager:
    """Keeps the last ``max_to_keep`` checkpoints; optional async saves.

    In a process group of several ranks every rank saves its own pieces
    (:func:`save_checkpoint`), and the barriers of an async save run on a
    gloo group of the manager's own (:func:`gloo_group`, made when the
    manager is built, by every rank together), so they never meet the
    train step's collectives; rank 0 commits and, once the save has
    returned, collects the old steps."""

    def __init__(self, ckpt_dir: str | Path, max_to_keep: int = 3, async_saves: bool = True):
        self.dir = Path(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.async_saves = async_saves
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = gloo_group()

    def save(self, step: int, state: Any):
        self.wait()
        # the host copies on the main thread (the state may be updated in
        # place by the next step), the file writes on the worker thread
        flat = tree_leaves_with_path(state)
        host_state = tree_unflatten(state, [_host_copy(leaf, i) for i, (_, leaf)
                                            in enumerate(flat)])
        if self.async_saves:
            def work():
                try:
                    save_checkpoint(self.dir, step, host_state, group=self._group)
                    self._gc()
                except BaseException as e:  # pragma: no cover
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.dir, step, host_state, group=self._group)
            self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like: Any, step: Optional[int] = None):
        return load_checkpoint(self.dir, like, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.dir)

    def _gc(self):
        if _host()[0] != 0:            # rank 0 collects for every rank
            return
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.iterdir()
            if p.name.startswith("step_") and (p / "COMMIT").exists()
        )
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
