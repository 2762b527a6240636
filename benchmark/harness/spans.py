"""The program pass: one cell's traced batches with the program's own span
recorder on (``spans`` in ``trueno_rag_tpu_torch/utils/profiling.py``),
read per stage of ``retrieve_batch``.

    python3 benchmark/program_pass.py --workload <name> --seed <n> [--pairs P --seconds S]

The pass builds the cell's system as a run does (set-up, warm-up, a full
collection), then runs the traffic's ``trace_batches`` batches twice as the
window runs them, with no synchronize between stages: first without the
profiler, then under it. The recorder gives each span's tree, host times
and the counters; while the profiler is active it also opens a
``record_function`` range per span, and those ``rag.*`` ranges place the
spans on the device trace's clock. Per span name the pass reads:

- host self time: the span's duration less what its child spans cover,
  computed here from the recorded spans (not taken from the program, so
  the yardstick stays the benchmark's), in both runs. The readings
  (:func:`summary`) take the first run's: the profiler's own cost per
  operator lengthens every host span (on an H100 host, late's
  ``rag.scan`` read 14 ms a batch without it and 22-28 ms under it);
- device time of the kernels and copies launched under it: each device
  operation is matched to the runtime call that launched it by the
  profiler's correlation id, and goes to the innermost ``rag.*`` range
  open at the launch;
- device-idle time under it: each moment of the pass with no device
  operation running goes to the innermost ``rag.*`` range open then
  (``None``: between calls, outside any span).

With ``--pairs P`` it first measures what the recorder costs when on:
``P`` pairs of closed-loop windows of ``S`` seconds, one with the recorder
off and one with it on, in alternating order. A ``--trace 1`` run of
``benchmark/run.py`` does not run the pass: its result line is the
benchmark's as it stands. On the CPU the operators run inside the host
spans, so no span time there says what the card's host path costs.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import sys
from collections import defaultdict

import torch

from benchmark.harness import cell, inputs, trace

PASS = "bench.program"
STAGE = "rag."
ROOT = "rag.retrieve"
RUNTIME = "cu"  # CUDA API calls (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...)


def run(bench, name: str, seed: int, device, pairs: int = 0, seconds: float = 10.0) -> dict:
    """Cell ``name`` built as a run builds it → its program pass
    (:func:`program_pass`), with the recorder's cost (:func:`recorder_cost`)
    under ``"cost"`` when ``pairs`` is above 0."""
    device = torch.device(device)
    c = bench.cell(name)
    traffic, stages = c.traffic, cell.StageLog()
    if device.type == "cuda":
        with stages.stage("kernels (built on a checkout's first run, loaded after)"):
            from trueno_rag_tpu_torch.ops.kernels import build

            build.build_library()
    system = c.system().System(c.config, traffic, seed, device, stages)
    try:
        with stages.stage("query pool"):
            pool = inputs.query_batches(c.config["word_law"], traffic, seed, device)
        with stages.stage("warm-up"):
            for j in range(traffic["warmup_batches"]):
                system.run(pool[len(pool) - 1 - j])
            trace.sync(device)
            gc.collect()
        cost = recorder_cost(system, pool, pairs, seconds, seed) if pairs > 0 else None
        out = program_pass(system, pool, traffic["trace_batches"], device)
    finally:
        system.close()
    out["cost"] = cost
    return out


def recorder_cost(system, pool, pairs: int, seconds: float, seed: int) -> list:
    """``pairs`` pairs of closed-loop windows of ``seconds``, the recorder
    off in one and on in the other (off first in even pairs, on first in
    odd ones) → each pair's queries/s as ``(off, on)``."""
    from trueno_rag_tpu_torch.utils import profiling

    def qps(on: bool) -> float:
        gc.collect()
        with profiling.spans() if on else contextlib.nullcontext():
            w = cell.closed_loop(system.run, pool, seconds, 0, seed)
        return w.queries / w.seconds

    out = []
    for i in range(pairs):
        if i % 2:
            on, off = qps(True), qps(False)
        else:
            off, on = qps(False), qps(True)
        out.append((off, on))
        cell.log(f"recorder cost: pair {i}: off {off:.2f} queries/s, on {on:.2f} ({100 * (on / off - 1):+.2f}%)")
    return out


def program_pass(system, pool, n: int, device) -> dict:
    """``n`` batches with the program's spans on, then again under the
    profiler → the second run's reading (:func:`read`) with the first's
    under ``"quiet"``."""
    from trueno_rag_tpu_torch.utils import profiling

    trace.sync(device)
    # the earlier batches' garbage, collected now as the warm-up's is: else a
    # full collection of set-up's millions of objects can land in a batch
    gc.collect()
    with profiling.spans() as first:
        for j in range(n):
            system.run(pool[j % len(pool)])
        trace.sync(device)
    quiet = read(list(first.spans), dict(first.counters), [], [], n)
    gc.collect()
    with trace.profiled(device) as prof:
        # the recorder is on for the batches alone: the profiler's own start
        # and stop make garbage whose collections are no stage of the program
        with profiling.spans() as rec, torch.profiler.record_function(PASS):
            for j in range(n):
                system.run(pool[j % len(pool)])
            trace.sync(device)
    host, dev = events_of(prof)
    out = read(list(rec.spans), dict(rec.counters), host, dev, n)
    out.update(quiet=quiet, dropped=first.dropped + rec.dropped)
    log(out)
    return out


def events_of(prof):
    """A profile → host events ``(start_us, end_us, name, id, thread)`` and
    device events ``(start_us, end_us, name, id)``; ``id`` is the
    profiler's correlation id, shared by a device operation and the
    runtime call that launched it."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name, e.id))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name, e.id, e.thread))
    return host, dev


def self_ns(spans) -> dict:
    """Span id → its duration less the part its child spans cover (ns)."""
    children = defaultdict(list)
    for s in spans:
        if s.parent:
            children[s.parent].append((s.t0_ns, s.t1_ns))
    out = {}
    for s in spans:
        covered, end = 0, s.t0_ns
        for c0, c1 in sorted(children[s.id]):
            c0, c1 = max(c0, end), min(c1, s.t1_ns)
            if c1 > c0:
                covered += c1 - c0
                end = c1
        out[s.id] = s.t1_ns - s.t0_ns - covered
    return out


def innermost(ranges, lo: float, hi: float):
    """Nested ranges ``(start, end, name)`` → segments ``(a, b, name)``
    covering [lo, hi], each named after the innermost range open in it
    (None where none is)."""
    out, stack, cur = [], [], lo

    def emit(to, name):
        nonlocal cur
        to = min(max(to, lo), hi)
        if to > cur:
            out.append((cur, to, name))
            cur = to

    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0], stack[-1][1])
            stack.pop()
        emit(s, stack[-1][1] if stack else None)
        stack.append((e, name))
    while stack:
        emit(stack[-1][0], stack[-1][1])
        stack.pop()
    emit(hi, None)
    return out


def _busy_in(busy, starts, a: float, b: float) -> float:
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0.0
    for s, e in busy[i:]:
        if s >= b:
            break
        total += max(0.0, min(e, b) - max(s, a))
    return total


def read(spans, counters: dict, host, device, batches: int) -> dict:
    """The pass's reading from its recorded ``spans`` and ``counters`` and
    its profile's ``host`` and ``device`` events (:func:`events_of`) →
    per span name the mean per batch of ``calls``, host ``self_ms``,
    ``device_ms`` launched under it and ``idle_ms`` under it, the
    ``counters``, the mean duration of ``rag.retrieve`` (``root_ms``), and
    the share of idle time under a named stage (``idle_named_share``:
    not under ``rag.retrieve``'s own time, not between calls)."""
    per = 1.0 / batches
    calls, self_ms = defaultdict(float), defaultdict(float)
    st = self_ns(spans)
    for s in spans:
        calls[s.name] += per
        self_ms[s.name] += st[s.id] * 1e-6 * per
    roots = [s for s in spans if s.name == ROOT and not s.parent]
    root_ms = sum(s.t1_ns - s.t0_ns for s in roots) * 1e-6 / len(roots) if roots else None

    out = {"batches": batches, "roots": len(roots), "root_ms": root_ms, "calls": dict(calls),
           "self_ms": dict(self_ms), "device_ms": {}, "idle_ms": {}, "counters": dict(counters),
           "window_ms": None, "busy_ms": None, "idle_named_share": None, "unmatched_device_ms": None,
           "copy_lag_ms": None}
    window = [(s, e, th) for s, e, name, _, th in host if name == PASS]
    if not window:
        return out
    lo, hi, thread = window[0]
    work = [(s, e, i) for s, e, name, i in device
            if not name.startswith((STAGE, trace.SPAN)) and e > lo and s < hi]
    busy = trace._merge([(max(s, lo), min(e, hi)) for s, e, _ in work])
    starts = [b[0] for b in busy]
    segs = innermost([(s, e, name) for s, e, name, _, th in host
                      if name.startswith(STAGE) and th == thread and e > lo and s < hi], lo, hi)
    idle = defaultdict(float)
    for a, b, name in segs:
        idle[name] += (b - a - _busy_in(busy, starts, a, b)) * 1e-3 * per
    launch = {i: (s, e) for s, e, name, i, _ in host if name.startswith(RUNTIME)}
    seg_starts = [a for a, _, _ in segs]
    dev_ms, unmatched = defaultdict(float), 0.0
    for s, e, i in work:
        t = launch.get(i, (None,))[0]
        if t is None or not lo <= t <= hi:
            unmatched += (e - s) * 1e-3 * per
            continue
        dev_ms[segs[max(bisect.bisect_right(seg_starts, t) - 1, 0)][2]] += (e - s) * 1e-3 * per
    # a copy to pageable host memory returns once the copy is done: the
    # host's return less the copy's device end shows how the clocks line up
    lags = [launch[i][1] - e for s, e, name, i in device
            if name.startswith("Memcpy DtoH") and "Pageable" in name and i in launch]
    total_idle = sum(idle.values())
    named = sum(v for k, v in idle.items() if k not in (None, ROOT))
    out.update(device_ms=dict(dev_ms), idle_ms=dict(idle), unmatched_device_ms=unmatched,
               copy_lag_ms=[1e-3 * min(lags), 1e-3 * sorted(lags)[len(lags) // 2], 1e-3 * max(lags)] if lags else None,
               window_ms=(hi - lo) * 1e-3 * per, busy_ms=sum(e - s for s, e in busy) * 1e-3 * per,
               idle_named_share=100.0 * named / total_idle if total_idle > 0 else None)
    return out


def log(p: dict) -> None:
    """The reading as a table on standard error."""
    def f(x):
        return "-" if x is None else f"{x:.3f}"

    w, q = sys.stderr.write, p["quiet"]
    w(f"program pass: {p['batches']} batches, {q['roots']} rag.retrieve, {f(q['root_ms'])} ms each "
      f"({f(p['root_ms'])} under the profiler); a batch under the profiler: window {f(p['window_ms'])} ms, "
      f"device busy {f(p['busy_ms'])} ms, launches not matched {f(p['unmatched_device_ms'])} ms; idle under a named "
      f"stage {f(p['idle_named_share'])}%; spans dropped {p['dropped']}; copies to pageable host memory return after "
      f"their device end by {p['copy_lag_ms']} ms (min, median, max)\n")
    w(f"{'span (a batch)':<28}{'calls':>8}{'host self ms':>14}{'(profiled)':>12}{'device ms':>12}{'idle ms':>10}\n")
    names = sorted(set(q["self_ms"]) | set(p["self_ms"]) | {k for k in p["idle_ms"] if k}
                   | {k for k in p["device_ms"] if k})
    for name in names:
        w(f"{name:<28}{q['calls'].get(name, 0):>8.2f}{q['self_ms'].get(name, 0):>14.3f}"
          f"{p['self_ms'].get(name, 0):>12.3f}{p['device_ms'].get(name, 0):>12.3f}{p['idle_ms'].get(name, 0):>10.3f}\n")
    w(f"{'(between calls)':<28}{'':>34}{p['device_ms'].get(None, 0):>12.3f}{p['idle_ms'].get(None, 0):>10.3f}\n")
    total = sum(part_ms(q, m) or 0.0 for m in PARTS) + q["self_ms"].get(ROOT, 0.0)
    w(f"the five span readings and rag.retrieve's self time: {total:.3f} ms of {f(q['root_ms'])} ms a batch "
      f"(collections: {q['self_ms'].get('rag.gc', 0.0):.3f} ms)\n")
    w("counters: " + " ".join(f"{k} {v}" for k, v in sorted(q["counters"].items())) + "\n")
    sys.stderr.flush()


# the span readings: which spans' self time each one sums
PARTS = {
    "tokenize_ms": lambda n: n == "rag.encode.tokenize",
    "encode_host_ms": lambda n: n in ("rag.encode", "rag.encode.forward"),
    "scan_host_ms": lambda n: n in ("rag.scan", "rag.scan.fallback"),
    "hydrate_ms": lambda n: n == "rag.hydrate",
    "host_wait_ms": lambda n: n.endswith(".wait"),
}


def part_ms(p: dict, metric: str):
    """The self milliseconds a batch of the spans that ``metric`` sums, in
    the reading ``p``, or None when none of them ran."""
    hits = [v for k, v in p["self_ms"].items() if PARTS[metric](k)]
    return sum(hits) if hits else None


def summary(p: dict) -> dict:
    """A run's reading ``p`` → the mean per batch of each :data:`PARTS`
    sum, ``encode_token_share`` (``rag.encode.tokens`` over
    ``rag.encode.padded_tokens``, in %), ``root_self_ms`` and ``root_ms``;
    a reading with nothing to read is None."""
    out = {m: part_ms(p, m) for m in PARTS}
    c = p["counters"]
    out["encode_token_share"] = (100.0 * c.get("rag.encode.tokens", 0) / c["rag.encode.padded_tokens"]
                                 if c.get("rag.encode.padded_tokens") else None)
    out["root_self_ms"] = p["self_ms"].get(ROOT)
    out["root_ms"] = p["root_ms"]
    return out
