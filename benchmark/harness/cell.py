"""One run of one cell: set-up, warm-up, the measured window, the traced
window and staged pass (``--trace 1``), the comparison with the plain
reference, and the result line.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark.harness import inputs, trace
from benchmark.reference import compare
from benchmark.reference.scores import top_k

FORBIDDEN = ("jax", "jaxlib", "flax", "trueno_rag_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class StageLog:
    """Set-up stages, each logged with its host seconds as it ends."""

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        log(f"setup: {name} {time.perf_counter() - t0:.3f} s")


@dataclass
class Window:
    """The measured window: each batch's host-clock start and end, its
    pool index and size, and the results of a sample of its batches."""

    start: float = 0.0
    end: float = 0.0
    batches: list = field(default_factory=list)  # (t0, t1, pool index, queries)
    kept: dict = field(default_factory=dict)  # batch index -> results
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def queries(self) -> int:
        return sum(b[3] for b in self.batches)

    @property
    def latencies(self):
        return [b[1] - b[0] for b in self.batches]


def closed_loop(run, pool, seconds: float, keep: int, seed: int) -> Window:
    """One caller: the next batch goes when the last has returned, until
    ``seconds`` have passed; the window ends when the last batch returns.
    The results of ``keep`` batches, a uniform sample of the window's drawn
    from ``seed`` (reservoir sampling), are kept for the check; the others
    are dropped as they come."""
    r = inputs.rng(seed, inputs.STREAM_SAMPLE)
    w = Window(start=time.perf_counter())
    deadline = w.start + seconds
    slots = []  # batch index in each reservoir slot
    i = seen = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        qs = pool[i % len(pool)]
        try:
            res = run(qs)
        except Exception:  # a failed batch counts its queries as failed; the window goes on
            if not w.failed:
                log(traceback.format_exc())
            res = None
            w.failed += len(qs)
        w.batches.append((t0, time.perf_counter(), i, len(qs)))
        if res is not None:
            seen += 1
            if len(slots) < keep:
                slots.append(i)
                w.kept[i] = res
            else:
                j = int(r.integers(0, seen))
                if j < keep:
                    del w.kept[slots[j]]
                    slots[j] = i
                    w.kept[i] = res
        i += 1
    w.end = w.batches[-1][1] if w.batches else time.perf_counter()
    return w


def traced_window(system, pool, n: int, device) -> dict:
    """``n`` batches as the window runs them, under the profiler → the
    device's busy seconds, the window's seconds, the queries answered and
    the breakdown."""
    trace.sync(device)
    with trace.profiled(device) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for j in range(n):
                system.run(pool[j % len(pool)])
            trace.sync(device)
    ev = trace.Events(prof)
    lo, hi = ev.ranges(trace.WINDOW)[0]
    return {"busy_s": ev.busy_in(lo, hi) * 1e-6, "window_s": (hi - lo) * 1e-6,
            "queries": sum(len(pool[j % len(pool)]) for j in range(n)),
            "device_ops": ev.top_ops(lo, hi), "idle_gaps": ev.idle_gaps(lo, hi)}


def staged_pass(system, pool, n: int, device) -> dict:
    """The same ``n`` batches layer by layer, a span around each layer call
    → host seconds and device seconds per span, and each batch's shapes."""
    host, shapes = {}, []
    with trace.profiled(device) as prof:
        for j in range(n):
            shapes.append(system.staged(pool[j % len(pool)], lambda name: trace.span(name, device, host)))
    dev = trace.device_seconds_in_spans(trace.Events(prof)) if device.type == "cuda" else {}
    return {"host": host, "device": dev, "shapes": shapes}


def forbidden_modules():
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    """What a metric's reader reads. ``trace`` is the traced window of a
    ``--trace 1`` run, or in a ``--trace 0`` run the device segment that
    an end-to-end metric from the device trace reads."""

    cell: object
    setup_s: float
    window: Window
    counters: dict
    on_device: bool
    trace: dict = None
    staged: dict = None


def check(cell, reference, weights, texts, batches, answers, seed: int, device) -> dict:
    """The reference's readings of the program's ``answers`` to ``batches``
    (lists of query texts)."""
    k = cell.traffic["k"]
    parts = []
    for qs, ans in zip(batches, answers):
        s = reference.scores(cell.config, weights, qs, seed, device, "bf16")
        parts.append(compare.readings(ans, s, top_k(s, k)[0], k, texts))
        del s
    return compare.merge(parts)


def run_cell(bench, name: str, seed: int, seconds: float, traced: bool, device, t_start: float,
             system_hook=None) -> dict:
    """One run of cell ``name`` → the result line's object. ``system_hook``
    (tests) receives the built system before the warm-up."""
    device = torch.device(device)
    cell = bench.cell(name)
    sysmod, reference = cell.system(), cell.reference()
    traffic = cell.traffic
    stages = StageLog()
    if device.type == "cuda":
        with stages.stage("kernels (built on a checkout's first run, loaded after)"):
            from trueno_rag_tpu_torch.ops.kernels import build

            build.build_library()
    system = sysmod.System(cell.config, traffic, seed, device, stages)
    if system_hook is not None:
        system_hook(system)
    with stages.stage("query pool"):
        pool = inputs.query_batches(cell.config["word_law"], traffic, seed, device)
    with stages.stage("warm-up"):
        for j in range(traffic["warmup_batches"]):
            system.run(pool[len(pool) - 1 - j])
        trace.sync(device)
        # collect set-up's garbage now: else the first full collection of
        # the millions of objects set-up made lands somewhere in the window
        gc.collect()
    setup_s = time.perf_counter() - t_start
    log(f"setup: total {setup_s:.3f} s")

    before = system.counters()
    window = closed_loop(system.run, pool, seconds, traffic["check_batches"], seed)
    after = system.counters()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    lat = sorted(window.latencies) or [0.0]
    log(f"window: {len(window.batches)} batches, {window.queries} queries in {window.seconds:.3f} s, "
        f"failed {window.failed}; batch ms min {lat[0] * 1e3:.3f}, median {lat[len(lat) // 2] * 1e3:.3f}, "
        f"max {lat[-1] * 1e3:.3f}")
    bins = {}
    for t0, t1, _, n in window.batches:
        bins[int((t1 - window.start) // 2)] = bins.get(int((t1 - window.start) // 2), 0) + n
    log("window: queries/s in 2-s bins " + " ".join(f"{n / 2:.0f}" for _, n in sorted(bins.items())))
    ctx = Context(cell=cell, setup_s=setup_s, window=window, on_device=device.type == "cuda",
                  counters={"before": before, "after": after})
    if traced:
        ctx.trace = traced_window(system, pool, traffic["trace_batches"], device)
        ctx.staged = staged_pass(system, pool, traffic["trace_batches"], device)
    elif any(m["source"] == "device_trace" for m in cell.end_to_end):
        # an end-to-end metric read from the device trace: the traffic's
        # first ``device_batches`` batches again, under the profiler, after
        # the window has closed and its peak memory been read
        ctx.trace = traced_window(system, pool, traffic["device_batches"], device)
        log(f"device segment: {traffic['device_batches']} batches, {ctx.trace['queries']} queries, "
            f"device busy {ctx.trace['busy_s']:.6f} s of {ctx.trace['window_s']:.6f} s")

    picks = sorted(window.kept)
    batches = [pool[i % len(pool)] for i in picks]
    answers = [system.answers(window.kept[i]) for i in picks]
    weights, texts = system.weights, system.texts
    system.close()
    del system
    window.kept = {}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = check(cell, reference, weights, texts, batches, answers, seed, device) if batches else {}
    log(f"reference check: {len(batches)} batches in {time.perf_counter() - t0:.3f} s")
    correct = bool(batches) and window.failed == 0 and compare.verdict(readings, cell.limits)

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": window.queries, "failed": window.failed, "metrics": metrics,
           "device": dev}
    if traced and ctx.on_device:
        dev.update(busy_s=ctx.trace["busy_s"], window_s=ctx.trace["window_s"])
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"], "idle_gaps": ctx.trace["idle_gaps"]}
    out["checks"] = {key: {"value": _num(readings.get(key, math.inf)), "limit": lim}
                     for key, lim in cell.limits.items()}
    for key, c in out["checks"].items():
        log(f"check {key}: {c['value']!r} (limit {c['limit']!r})")
    return out


def _num(x):
    """A reading as JSON can carry it: inf and NaN as strings."""
    x = float(x) if not isinstance(x, (int, np.integer)) else int(x)
    return x if isinstance(x, int) or math.isfinite(x) else str(x)
