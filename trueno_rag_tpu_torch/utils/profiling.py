"""Profiling and observability.

PyTorch counterpart of ``trueno_rag_tpu/utils/profiling.py``:

- :func:`device_trace` records the enclosed block with ``torch.profiler``
  and writes a Chrome trace (``chrome://tracing``, Perfetto) into
  ``log_dir``: CPU activity always, CUDA kernels too when the card is
  there;
- :class:`StageTimer` accumulates host wall time per named stage, each
  stage ending with a synchronize of the device it times, so a stage owns
  the device work it launched. A failed synchronize raises: a timing that
  silently measured only the launches would be a wrong number.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List

import torch


@contextlib.contextmanager
def device_trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Record the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace.json`` (the directory is created).
    CUDA activity is recorded when ``device`` (default: the card when
    there is one) is a CUDA device. Yields the profiler, whose
    ``key_averages()`` sums time by operator and kernel."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulating per-stage wall timer with a device synchronize.

    Usage::

        timer = StageTimer()
        with timer.stage("embed"):
            q = embedder.embed_queries(queries)
        with timer.stage("retrieve"):
            out = retriever.retrieve_batch(queries, k)
        print(timer.report())

    ``device`` is the device whose work a stage owns (default: the card
    when there is one, else the CPU, which needs no synchronize)."""

    def __init__(self, device=None) -> None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._acc: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._order: List[str] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self._sync()  # work launched before the stage is not its time
        t0 = time.perf_counter()
        try:
            yield
            self._sync()
        finally:
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._counts[name] = 0
                self._order.append(name)
            self._acc[name] += dt
            self._counts[name] += 1

    def totals(self) -> Dict[str, float]:
        return dict(self._acc)

    def report(self) -> str:
        total = sum(self._acc.values()) or 1.0
        lines = ["stage                 total_s   calls   share"]
        for name in self._order:
            t = self._acc[name]
            lines.append(f"{name:<20s} {t:8.4f} {self._counts[name]:7d} {100 * t / total:6.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self._acc.clear()
        self._counts.clear()
        self._order.clear()
