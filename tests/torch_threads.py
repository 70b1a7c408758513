"""torch on one intra-op thread, for the port's test files.

Their tensors are small, and in a run of several test processes on the
same cores more threads only contend.  A file puts all its tests on one
thread with ``from torch_threads import one_thread``, a module-scoped
autouse fixture; a file that does so for some tests only, or also for
the processes they spawn, builds its own fixture on
:func:`one_torch_thread`.
"""

import contextlib
import os

import pytest
import torch


@contextlib.contextmanager
def one_torch_thread(spawned: bool = False):
    """torch on one intra-op thread inside, and with ``spawned`` also in
    the processes started meanwhile (they read ``OMP_NUM_THREADS`` when
    torch starts); both are restored after."""
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    if spawned:
        os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if spawned and env is None:
            del os.environ["OMP_NUM_THREADS"]
        elif spawned:
            os.environ["OMP_NUM_THREADS"] = env


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Every test of the module that imports this on one torch thread."""
    with one_torch_thread():
        yield
