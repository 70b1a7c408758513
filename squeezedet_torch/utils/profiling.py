"""Profiler traces and device memory snapshots (counterpart of
``squeezedet_tpu/utils/profiling.py``), over ``torch.profiler``: CPU
activity always, CUDA kernels when a card is present.  A trace is a
Chrome trace file, readable in Perfetto."""

from __future__ import annotations

import contextlib
import os
import pickle


def _start(logdir: str):
    """A started ``torch.profiler.profile`` writing into ``logdir``."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop(prof, path: str) -> None:
    """Stop ``prof`` once the card's queued work is done and write its
    Chrome trace to ``path``."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block into ``logdir/trace.json``."""
    prof = _start(logdir)
    try:
        yield prof
    finally:
        _stop(prof, os.path.join(logdir, "trace.json"))


def save_device_memory_profile(path: str) -> None:
    """Write the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``: its segments, blocks and, when
    ``torch.cuda.memory._record_memory_history`` is on, their stacks) to
    ``path`` as a pickle, which PyTorch's memory viewer reads.  Raises
    RuntimeError without a CUDA device, writing nothing."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("save_device_memory_profile needs a CUDA device; "
                           "torch sees none")
    snapshot = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)


class StepTracer:
    """Trace steps [start, stop) of a training loop into ``logdir``."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None

    def on_step(self, step: int) -> None:
        if step == self.start and self._prof is None:
            self._prof = _start(self.logdir)
        elif step == self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        _stop(self._prof, os.path.join(
            self.logdir, "trace_steps_{}_{}.json".format(self.start,
                                                          self.stop)))
        self._prof = None
