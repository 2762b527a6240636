"""Profiling and observability.

PyTorch counterpart of ``trueno_rag_tpu/utils/profiling.py``:

- :func:`device_trace` records the enclosed block with ``torch.profiler``
  and writes a Chrome trace (``chrome://tracing``, Perfetto) into
  ``log_dir``: CPU activity always, CUDA kernels too when the card is
  there;
- :class:`StageTimer` accumulates host wall time per named stage, each
  stage ending with a synchronize of the device it times, so a stage owns
  the device work it launched. A failed synchronize raises: a timing that
  silently measured only the launches would be a wrong number;
- :func:`spans` turns on a :class:`SpanRecorder` for its block: the
  retrievers' stages (``rag.retrieve``, ``rag.encode``, ``rag.scan``,
  ``rag.hydrate`` and their children, :func:`span`) and counters
  (:meth:`SpanRecorder.count`) are then kept in memory, nothing is
  synchronized, and under an active ``torch.profiler`` each span is also a
  ``record_function`` range on the profiler's clock. Off, which is the
  default, a span site costs one check of a module variable.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """One closed span. ``parent`` is 0 at a root; ``root`` is the root
    span's id, which every span of one ``retrieve_batch`` call shares.
    Times are ``time.perf_counter_ns``; ``thread`` is
    ``threading.get_ident()``."""

    id: int
    parent: int
    root: int
    name: str
    t0_ns: int
    t1_ns: int
    thread: int
    attrs: dict


class _OpenSpan:
    """A span while it is open: on its thread's stack, and inside a
    ``record_function`` range when a profiler is active."""

    __slots__ = ("_rec", "name", "attrs", "id", "parent", "root", "_t0", "_rf")

    def __init__(self, rec: "SpanRecorder", name: str) -> None:
        self._rec, self.name, self.attrs = rec, name, {}

    def __enter__(self) -> "_OpenSpan":
        stack = self._rec._stack()
        self.id = next(self._rec._ids)
        self.parent = stack[-1].id if stack else 0
        self.root = stack[0].id if stack else self.id
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        # the clock starts after everything that may allocate, and the span
        # goes on the stack last: a collection (``rag.gc``) that runs before
        # is its sibling, one that runs later its child inside its interval
        self._t0 = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        self._rec._stack().pop()
        self._rec._keep(Span(self.id, self.parent, self.root, self.name, self._t0, t1,
                             threading.get_ident(), self.attrs))


class SpanRecorder:
    """The spans and counters recorded while :func:`spans` has this
    recorder on: ``spans`` (closed :class:`Span` records, at most
    ``capacity``; ``dropped`` counts the rest), ``counters`` (name → int)
    and :meth:`self_times`. Each thread keeps its own stack of open spans,
    so spans of concurrent callers (a server's batcher and workers) never
    nest in each other. A garbage collection is a ``rag.gc`` span
    (attr ``generation``), the child of whatever span its thread has open."""

    def __init__(self, capacity: int = 1 << 20) -> None:
        self.capacity = capacity
        self.spans: List[Span] = []
        self.dropped = 0
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        # reentrant: a collection's span may close while another is kept
        self._lock = threading.RLock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.capacity:
                self.spans.append(span)
            else:
                self.dropped += 1

    def span(self, name: str) -> _OpenSpan:
        return _OpenSpan(self, name)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def self_times(self) -> Dict[int, int]:
        """Span id → self time in ns: its duration less the part of it that
        its child spans cover."""
        children: Dict[int, list] = {}
        for s in self.spans:
            if s.parent:
                children.setdefault(s.parent, []).append((s.t0_ns, s.t1_ns))
        out = {}
        for s in self.spans:
            covered, end = 0, s.t0_ns
            for c0, c1 in sorted(children.get(s.id, ())):
                c0, c1 = max(c0, end), min(c1, s.t1_ns)
                if c1 > c0:
                    covered += c1 - c0
                    end = c1
            out[s.id] = s.t1_ns - s.t0_ns - covered
        return out

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            s = self.span("rag.gc")
            s.attrs["generation"] = info["generation"]
            s.__enter__()
        else:
            stack = self._stack()
            if stack and stack[-1].name == "rag.gc":
                stack[-1].__exit__(None, None, None)


_active: Optional[SpanRecorder] = None  # the recorder spans() has on
_OFF = contextlib.nullcontext()  # every span site's context while recording is off


def span(name: str):
    """A context manager around one stage of the program, ``name`` as in
    ``rag.scan.wait``; it yields the open span (set attributes on its
    ``attrs``), or None while no recorder is on."""
    rec = _active
    return _OFF if rec is None else rec.span(name)


def active() -> Optional[SpanRecorder]:
    """The recorder that :func:`spans` has on, or None."""
    return _active


@contextlib.contextmanager
def spans(capacity: int = 1 << 20) -> Iterator[SpanRecorder]:
    """Record the program's spans and counters in the enclosed block, from
    every thread, and yield the :class:`SpanRecorder` that holds them. Inside
    a block that already records, the recorder that is on is yielded."""
    global _active
    if _active is not None:
        yield _active
        return
    rec = SpanRecorder(capacity)
    _active = rec
    gc.callbacks.append(rec._on_gc)
    try:
        yield rec
    finally:
        gc.callbacks.remove(rec._on_gc)
        _active = None


@contextlib.contextmanager
def device_trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """Record the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace.json`` (the directory is created).
    CUDA activity is recorded when ``device`` (default: the card when
    there is one) is a CUDA device. The span recorder is on for the block
    (:func:`spans`), so the retrievers' stages (``rag.*`` ranges) sit in the
    trace above the operators and kernels they launched. Yields the
    profiler, whose ``key_averages()`` sums time by operator and kernel."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with spans(), torch.profiler.profile(activities=acts) as prof:
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
