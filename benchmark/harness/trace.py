"""Reading ``torch.profiler``'s events: device busy time, idle gaps and
what the host was doing in them, the heaviest device operations, and the
device time inside the benchmark's own spans (``record_function`` ranges
named ``bench.<layer>``).

Times in the profiler's events are microseconds on one clock for host
and device events.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

SPAN = "bench."
WINDOW = "bench.window"


@contextlib.contextmanager
def profiled(device):
    """Profile the enclosed block (host ops always, CUDA work on a card)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, device, out: dict):
    """A host-clock span of one layer call, its device work finished at
    its end; ``out[name]`` collects the host seconds."""
    sync(device)
    t0 = time.perf_counter()
    with torch.profiler.record_function(SPAN + name):
        yield
        sync(device)
    out.setdefault(name, []).append(time.perf_counter() - t0)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Events:
    """The device and host events of one profile."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device, self.host = [], []
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith(SPAN):  # the device copy of a span's range is no work
                    self.device.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                self.host.append((tr.start, tr.end, e.name))
        self.host.sort()
        self.busy = _merge([(s, e) for s, e, _ in self.device])
        self._starts = [b[0] for b in self.busy]

    def ranges(self, name: str):
        return [(s, e) for s, e, n in self.host if n == name]

    def busy_in(self, lo: float, hi: float) -> float:
        """Device-busy microseconds inside [lo, hi]."""
        i = max(bisect.bisect_right(self._starts, lo) - 1, 0)
        total = 0.0
        for s, e in self.busy[i:]:
            if s >= hi:
                break
            total += max(0.0, min(e, hi) - max(s, lo))
        return total

    def top_ops(self, lo: float, hi: float, n: int = 10):
        """The ``n`` device operations with the most time in [lo, hi] →
        ``[[name, seconds], ...]``."""
        acc = defaultdict(float)
        for s, e, name in self.device:
            if e > lo and s < hi:
                acc[name[:160]] += (min(e, hi) - max(s, lo)) * 1e-6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, lo: float, hi: float, n: int = 10, min_us: float = 1.0):
        """Idle device time in [lo, hi] summed by what the host was doing
        at each gap's middle (the innermost host event there) → the ``n``
        largest ``[[host activity, seconds], ...]``."""
        starts = [h[0] for h in self.host]
        acc = defaultdict(float)

        def gap(a, b):
            if b - a >= min_us:
                acc[self._host_at(0.5 * (a + b), starts)] += (b - a) * 1e-6

        prev = lo
        for s, e in self.busy:
            if e <= lo:
                continue
            if s >= hi:
                break
            gap(prev, max(s, lo))
            prev = max(prev, min(e, hi))
        gap(prev, hi)
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float, starts) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for s, e, name in reversed(self.host[max(0, i - 4000):i + 1]):
            if e >= t and name != WINDOW:
                return name[:160]
        return "host Python between operations"


def device_seconds_in_spans(events: Events) -> dict:
    """Per span name (``bench.<name>``), the device-busy seconds of each
    occurrence."""
    out = defaultdict(list)
    for s, e, name in events.host:
        if name.startswith(SPAN) and name != WINDOW:
            out[name[len(SPAN):]].append(events.busy_in(s, e) * 1e-6)
    return dict(out)
