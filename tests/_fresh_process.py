"""A check that runs in a fresh Python process (the port's paths import no
module of JAX and none of the JAX package).

Such a process spends seconds importing torch while its pytest worker
would wait. :func:`started` makes a module-scoped autouse fixture that
starts the process with the module's first test, so that it runs beside
the module's other tests; the test that holds the check then reads its
result with :func:`finished`. The process runs on one thread
(``OMP_NUM_THREADS=1``), as the tests' gloo ranks do, and is killed at
the module's end if no test read it.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"


def started(code: str):
    """A module-scoped autouse fixture: ``python -c code`` with the port
    on its path, started with the module's first test."""
    @pytest.fixture(scope="module", autouse=True)
    def fresh_process():
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        yield proc
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    return fresh_process


def finished(proc, timeout: float = 120):
    """(return code, stdout, stderr) of a process from :func:`started`."""
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err
