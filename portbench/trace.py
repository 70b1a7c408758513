"""The traced window: ``torch.profiler`` over CPU and CUDA activity,
kept in memory (never written out), reduced to what the per-layer
readers take: device intervals by name, their union (busy time), the
kernels counted, and the idle gaps named by what the host was doing."""

from __future__ import annotations

import time

# what the device does: kernels, copies and fills (not annotations)
_DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}


def _kind(e):
    try:
        return str(e.activity_type()).lower().rsplit(".", 1)[-1]
    except (AttributeError, RuntimeError):
        return ""


def _ns(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def _union(intervals):
    """Merged, sorted [start, end] pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Summary:
    """The reduced trace of one window."""

    def __init__(self, device, host, window_s, chips):
        self.window_s = window_s
        self.chips = chips
        self.device = device  # [(name, start_ns, end_ns, kind)]
        self.kernels = [d for d in device if d[3] != "copy"]
        busy = _union((s, e) for _, s, e, _ in device)
        self.busy_s = sum(e - s for s, e in busy) / 1e9 / chips
        self._busy = busy
        self._host = host  # [(name, start_ns, end_ns)]

    def device_seconds(self, match):
        """Summed device seconds of the kernels whose name holds
        ``match``."""
        return sum(e - s for n, s, e, _ in self.kernels if match in n) / 1e9

    def count(self, match=None):
        return sum(1 for n, _, _, _ in self.kernels
                   if match is None or match in n)

    def top_ops(self, n=10):
        by = {}
        for name, s, e, _ in self.device:
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """The longest gaps between device work, each named by the
        innermost host activity under its middle."""
        gaps = [(b[0] - a[1], a[1], b[0])
                for a, b in zip(self._busy, self._busy[1:])]
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) // 2
            under = [h for h in self._host if h[1] <= mid <= h[2]]
            name = min(under, key=lambda h: h[2] - h[1])[0] if under \
                else "host idle"
            out.append([name, length / 1e9])
        return out


class Window:
    """``with Window(chips) as w:`` profiles the block; ``w.summary``
    after it.  The card's queued work is waited for before the clock
    stops."""

    def __init__(self, chips=1, on_card=True):
        self.chips, self.on_card = chips, on_card
        self.summary = None

    def _sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.on_card:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._sync()
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        if exc[0] is None:
            self.summary = reduce(self._prof, window_s, self.chips)
        return False


def reduce(prof, window_s, chips):
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = _ns(e)
        kind = _kind(e)
        if str(e.device_type()).endswith("CUDA"):
            if kind and kind not in _DEVICE_KINDS:
                continue
            if not kind and e.is_user_annotation():
                continue
            name = e.name()
            copy = kind in ("gpu_memcpy", "gpu_memset") or (
                not kind and name.startswith("Mem"))
            device.append((name, s, t, "copy" if copy else "kernel"))
        else:
            host.append((e.name(), s, t))
    return Summary(device, host, window_s, chips)
