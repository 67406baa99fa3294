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
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import tree_leaves_with_path, tree_unflatten


def _host() -> Tuple[int, int]:
    """(this host's index, the host count): the process group's rank and
    size, or (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def _host_copy(leaf):
    """A copy on the host that later in-place updates of ``leaf`` leave alone."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str | Path, step: int, state: Any) -> Path:
    """Atomic synchronous save."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    if (final / "COMMIT").exists():
        # idempotent: this step is already durably saved (replay after a
        # restore re-reaches the same checkpoint boundary deterministically)
        return final
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    host, n_hosts = _host()
    arrays = {}
    meta = {"step": step, "leaves": [], "time": time.time(), "n_hosts": n_hosts}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(state)):
        arr, dtype = _to_numpy(leaf)
        key = f"leaf_{i:05d}"
        arrays[key] = arr
        meta["leaves"].append({"key": key, "path": path, "shape": list(arr.shape),
                               "dtype": dtype})
    np.savez(tmp / f"host_{host:05d}.npz", **arrays)
    with open(tmp / "manifest.json", "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    (tmp / "COMMIT").touch()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
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


def load_checkpoint(ckpt_dir: str | Path, like: Any, step: Optional[int] = None
                    ) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (used for dtype, shape and
    device)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    meta = json.loads((d / "manifest.json").read_text())
    host, _ = _host()
    flat_like = tree_leaves_with_path(like)
    if len(flat_like) != len(meta["leaves"]):
        raise ValueError(f"checkpoint {d} holds {len(meta['leaves'])} leaves, the state "
                         f"{len(flat_like)}")
    leaves = []
    with np.load(d / f"host_{host:05d}.npz") as data:
        for (path, want), rec in zip(flat_like, meta["leaves"]):
            arr = data[rec["key"]]
            assert tuple(arr.shape) == tuple(want.shape), (rec["path"], arr.shape, want.shape)
            leaves.append(_restore_leaf(arr, rec["dtype"], want))
    return tree_unflatten(like, leaves), step


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_") and (p / "COMMIT").exists()]
    return max(steps) if steps else None


class CheckpointManager:
    """Keeps the last ``max_to_keep`` checkpoints; optional async saves."""

    def __init__(self, ckpt_dir: str | Path, max_to_keep: int = 3, async_saves: bool = True):
        self.dir = Path(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.async_saves = async_saves
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any):
        self.wait()
        # the host copies on the main thread (the state may be updated in
        # place by the next step), the file writes on the worker thread
        flat = tree_leaves_with_path(state)
        host_state = tree_unflatten(state, [_host_copy(leaf) for _, leaf in flat])
        if self.async_saves:
            def work():
                try:
                    save_checkpoint(self.dir, step, host_state)
                    self._gc()
                except BaseException as e:  # pragma: no cover
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.dir, step, host_state)
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
        steps = sorted(
            int(p.name.split("_")[1])
            for p in self.dir.iterdir()
            if p.name.startswith("step_") and (p / "COMMIT").exists()
        )
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
