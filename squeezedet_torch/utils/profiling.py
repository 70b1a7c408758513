"""Profiler traces, the program's spans and device memory snapshots
(counterpart of ``squeezedet_tpu/utils/profiling.py``), over
``torch.profiler``: CPU activity always, CUDA kernels when a card is
present.  A trace is a Chrome trace file, readable in Perfetto.

:class:`span` names a phase of the program in such a trace: a host range
``squeezedet.<name>`` while a profiler records, and for a device span a
pair of empty marker kernels, ``squeezedet_span_<name>_begin`` and
``..._end``, around the phase's work on its stream.  The markers are
what shows the phases of a captured CUDA graph, whose replay the host's
ranges do not reach: a graph captured with spans holds their markers.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import pickle
from typing import Optional

import torch

PREFIX = "squeezedet."
# The device spans, in the order of their marker kernels in
# csrc/conv1_pool1.cu (built with K1): span i begins with marker 2 i and
# ends with marker 2 i + 1.
DEVICE_SPANS = ("ingest", "matcher", "forward", "backward", "optimizer",
                "backbone", "interpret", "postprocess", "res2", "res3",
                "res4")
_MARKER = {name: 2 * i for i, name in enumerate(DEVICE_SPANS)}
_MARKER_LIB = "conv1_pool1"
# the CUDA devices whose contexts hold the marker kernels
_MARKERS_LOADED: set = set()


def load_markers(device: torch.device) -> None:
    """Build (if needed) and load the marker kernels into ``device``'s
    context, each function loaded, so that the first launch of one may
    lie inside a stream capture (which may load no module)."""
    from squeezedet_torch.ops import _cuda
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _cuda.function(_MARKER_LIB, "sdt_span_markers_load",
                             (ctypes.c_void_p,))(ctypes.byref(count))
        _cuda.check(_MARKER_LIB, err, "span markers' load")
        if count.value != 2 * len(DEVICE_SPANS):
            raise RuntimeError("csrc/{}.cu holds {} span markers, "
                               "DEVICE_SPANS {}".format(
                                   _MARKER_LIB, count.value,
                                   2 * len(DEVICE_SPANS)))
        _MARKERS_LOADED.add(torch.cuda.current_device())


def _mark(index: int, device: torch.device) -> None:
    """Enqueue marker ``index`` on ``device``'s current stream."""
    from squeezedet_torch.ops import _cuda
    with torch.cuda.device(device):
        if torch.cuda.current_device() not in _MARKERS_LOADED:
            load_markers(device)
        fn = _cuda.function(_MARKER_LIB, "sdt_span_marker",
                            (ctypes.c_int, ctypes.c_void_p))
        err = fn(index, torch.cuda.current_stream().cuda_stream)
    _cuda.check(_MARKER_LIB, err, "span marker launch")


class span:
    """``with span(name[, device]):`` marks the enclosed work as the
    program's phase ``name``.

    While a profiler records (``torch.autograd.profiler``'s flag), the
    block is the host range ``squeezedet.<name>``; with no profiler it
    enters nothing.  With ``device`` (where the phase's work runs; its
    name one of :data:`DEVICE_SPANS`) a CUDA device, the phase's begin
    and end markers are enqueued on the device's current stream around
    the work: in eager code only while a profiler records, and always
    while the stream is captured into a CUDA graph, since a capture
    cannot know whether a replay will be traced.  The markers are empty
    ``<<<1, 1>>>`` kernels and count in no ``LAUNCHES``; on the CPU
    there are none."""

    __slots__ = ("name", "device", "_range", "_marker")

    def __init__(self, name: str, device: Optional[torch.device] = None):
        if device is not None and name not in _MARKER:
            raise ValueError("{!r} is not a device span ({})".format(
                name, ", ".join(DEVICE_SPANS)))
        self.name, self.device = name, device
        self._range = self._marker = None

    def __enter__(self) -> "span":
        recording = torch.autograd.profiler._is_profiler_enabled
        if recording:
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        if self.device is not None and self.device.type == "cuda" and (
                recording or torch.cuda.is_current_stream_capturing()):
            self._marker = _MARKER[self.name]
            _mark(self._marker, self.device)
        return self

    def __exit__(self, *exc) -> bool:
        if self._marker is not None and exc[0] is None:
            _mark(self._marker + 1, self.device)
        self._marker = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def _start(logdir: str):
    """A started ``torch.profiler.profile`` writing into ``logdir``."""
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
