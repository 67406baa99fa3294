"""The torch thread count of the port's CPU tests.

The tier-1 run spreads the test files over six pytest workers on the
machine's cores. A torch process starts one intra-op thread a core by
default, so six of them oversubscribe the cores many times over, and the
port's small tensors then wait on each other's threads (a smoke train step
of dbrx took 0.12 s at one thread and 0.55-1.34 s at eight, in a run of six
workers). :func:`pin` gives each worker its share of the cores. The gloo
ranks and other subprocesses that the tests start set their own count (one
thread: ``OMP_NUM_THREADS=1`` and ``torch.set_num_threads(1)``).
"""

import os

import torch

WORKERS = 6


def pin() -> int:
    """Set this process's torch thread count to its share of the cores."""
    threads = max(1, (os.cpu_count() or 1) // WORKERS)
    torch.set_num_threads(threads)
    return threads
