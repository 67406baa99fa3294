"""Deterministic, shard-aware synthetic token pipeline with multisplit
length bucketing (counterpart of ``repro/data/pipeline.py``).

Each data-parallel host pulls only its shard, deterministic from (seed,
step, host); a background thread prefetches; variable-length documents are
packed into fixed (batch, seq) windows after a length bucketing that is a
multisplit (buckets are length ranges, paper §7.3).

The bucketing of many steps is ONE segmented ``positions_only`` call on
``device`` (one segment a step): only the int32 permutation comes back to
the host, and no reordered length array exists anywhere. The documents come
from the JAX package's numpy ``RandomState`` streams, so every batch is
bitwise the JAX package's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch import ops


class DataPipeline:
    def __init__(
        self,
        vocab: int,
        seq_len: int,
        batch_per_host: int,
        seed: int = 0,
        host_index: int = 0,
        n_hosts: int = 1,
        bucket_lengths: tuple = (64, 256, 1024, 4096),
        frontend_stub_dim: Optional[int] = None,
        device="cuda",
    ):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch_per_host
        self.seed = seed
        self.host = host_index
        self.n_hosts = n_hosts
        self.bucket_lengths = bucket_lengths
        self.frontend_stub_dim = frontend_stub_dim
        self.device = device

    # -- synthetic documents ------------------------------------------------
    def _docs(self, step: int, n_docs: int):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step * 131 + self.host) % (2**31 - 1)
        )
        lengths = np.clip(
            (rng.pareto(1.2, size=n_docs) * 64).astype(np.int64) + 8, 8, self.seq_len
        )
        docs = []
        for ln in lengths:
            topic = rng.randint(0, 64)
            # Zipf unigrams, shifted per topic: structured enough to learn
            z = rng.zipf(1.6, size=int(ln)).astype(np.int64)
            toks = (z * 769 + topic * 31) % max(self.vocab - 2, 1) + 1
            docs.append(toks.astype(np.int32))
        return docs, lengths

    # -- multisplit length bucketing ------------------------------------------
    def _bucket_orders(self, lengths_list) -> List[np.ndarray]:
        """The stable bucket-major document order of many steps from ONE
        segmented ``positions_only`` call (a segment a step) over a
        :class:`~repro_torch.ops.RangeSpec`. Only the segment-local eq. (2)
        permutation comes back; ``order[perm[i]] = i`` inverts it into each
        step's visiting order."""
        bf = ops.range_buckets(self.bucket_lengths[:-1])
        sizes = [len(ln) for ln in lengths_list]
        flat = np.concatenate([np.asarray(ln, np.int32) for ln in lengths_list])
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        perm = ops.segmented_multisplit(
            flat, bf, starts, method="dms", mode="positions_only", device=self.device,
        ).permutation.cpu().numpy()
        orders = []
        for a, sz in zip(starts, sizes):
            order = np.empty(sz, np.int64)
            order[perm[a : a + sz]] = np.arange(sz)
            orders.append(order)
        return orders

    def _pack(self, docs, order) -> np.ndarray:
        # pack bucket-ordered docs (similar lengths adjacent => little padding)
        out = np.zeros((self.batch, self.seq_len), np.int32)
        row, col = 0, 0
        for di in order:
            d = docs[int(di)]
            while d.size and row < self.batch:
                take = min(d.size, self.seq_len - col)
                out[row, col : col + take] = d[:take]
                d = d[take:]
                col += take
                if col >= self.seq_len:
                    row, col = row + 1, 0
            if row >= self.batch:
                break
        return out

    def _finalize(self, step: int, tokens: np.ndarray) -> Dict[str, np.ndarray]:
        labels = np.concatenate(
            [tokens[:, 1:], np.full((self.batch, 1), -1, np.int32)], axis=1
        )
        labels = np.where(tokens > 0, labels, -1)
        batch = {"tokens": tokens, "labels": labels}
        if self.frontend_stub_dim:
            rng = np.random.RandomState((self.seed + step) % (2**31 - 1))
            batch["embeds"] = rng.randn(
                self.batch, self.seq_len, self.frontend_stub_dim
            ).astype(np.float32)
            del batch["tokens"]
        return batch

    def batches_at(self, start_step: int, num_steps: int) -> List[Dict[str, np.ndarray]]:
        """Deterministic batches for ``num_steps`` consecutive steps, the
        length bucketing of all of them in one segmented launch.
        ``batches_at(s, k)[i]`` is bitwise ``batch_at(s + i)``."""
        n_docs = self.batch * max(self.seq_len // 256, 4)
        per_step = [self._docs(start_step + i, n_docs) for i in range(num_steps)]
        orders = self._bucket_orders([lengths for _, lengths in per_step])
        return [
            self._finalize(start_step + i, self._pack(docs, order))
            for i, ((docs, _), order) in enumerate(zip(per_step, orders))
        ]

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a global step (restart-safe)."""
        return self.batches_at(step, 1)[0]


def make_batch_iterator(pipeline: DataPipeline, start_step: int = 0, prefetch: int = 2
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator, resumable at ``start_step``:
    the worker takes ``prefetch`` steps a time through
    :meth:`DataPipeline.batches_at`, one segmented launch a window. Closing
    the iterator stops the worker and waits for it, so no thread is left
    running device work when the process exits."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    chunk = max(prefetch, 1)

    def put(batch) -> bool:
        while not stop.is_set():
            try:
                q.put(batch, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        step = start_step
        while not stop.is_set():
            for batch in pipeline.batches_at(step, chunk):
                if not put(batch):
                    return
            step += chunk

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
        t.join()
