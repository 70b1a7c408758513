"""Profiler traces of chosen train steps (counterpart of
``squeezedet_tpu/utils/profiling.py``'s ``StepTracer``), over
``torch.profiler``: CPU activity always, CUDA kernels when a card is
present.  The trace is a Chrome trace file, readable in Perfetto."""

from __future__ import annotations

import os


class StepTracer:
    """Trace steps [start, stop) of a training loop into ``logdir``."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None

    def on_step(self, step: int) -> None:
        if step == self.start and self._prof is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif step == self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(os.path.join(
            self.logdir, "trace_steps_{}_{}.json".format(self.start,
                                                          self.stop)))
        self._prof = None
