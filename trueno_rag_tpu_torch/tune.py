"""Serving autotuner: pick micro-batching parameters from measurement.

PyTorch counterpart of ``trueno_rag_tpu/tune.py``. The best serving
batch size depends on the corpus, the tier and the device, so this module
calibrates at index-load time: it runs the actual retriever over
calibration queries sampled from the indexed chunks at each candidate
batch size, measures end-to-end wall latency (host staging + device work
+ hydration — what a caller experiences; ``retrieve_batch`` returns host
results, so the device has finished), and picks the throughput-maximizing
batch size under an optional latency budget. On a clustered store it then
sweeps the probe budget, on a certified token store the MaxSim rescore
budget, at the chosen batch size.

Only semantics-preserving knobs are tuned: batch size, straggler wait,
probe and rescore budgets change WHEN and at what cost queries run, never
what they return (the exactness contracts are untouched).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

__all__ = ["TuneResult", "autotune_serving", "calibration_queries"]


@dataclass
class BatchPoint:
    """One calibration measurement."""

    batch_size: int
    p50_ms: float
    qps: float


@dataclass
class ProbePoint:
    """One clustered-tier probe-budget measurement."""

    probe_tiles: int
    p50_ms: float
    qps: float


@dataclass
class RescorePoint:
    """One MaxSim-tier rescore-budget measurement."""

    rescore: int
    p50_ms: float
    qps: float


@dataclass
class TuneResult:
    """Chosen serving parameters plus the full measurement table."""

    max_batch: int
    max_wait_ms: float
    table: List[BatchPoint] = field(default_factory=list)
    probe_tiles: Optional[int] = None  # clustered stores only
    probe_table: List[ProbePoint] = field(default_factory=list)
    rescore: Optional[int] = None  # token (MaxSim) tiered stores only
    rescore_table: List[RescorePoint] = field(default_factory=list)

    def as_dict(self) -> dict:
        out = {
            "max_batch": self.max_batch,
            "max_wait_ms": round(self.max_wait_ms, 3),
            "table": [
                {"batch": p.batch_size, "p50_ms": round(p.p50_ms, 3), "qps": round(p.qps, 1)}
                for p in self.table
            ],
        }
        if self.probe_tiles is not None:
            out["probe_tiles"] = self.probe_tiles
            out["probe_table"] = [
                {"probe": p.probe_tiles, "p50_ms": round(p.p50_ms, 3),
                 "qps": round(p.qps, 1)}
                for p in self.probe_table
            ]
        if self.rescore is not None:
            out["rescore"] = self.rescore
            out["rescore_table"] = [
                {"rescore": p.rescore, "p50_ms": round(p.p50_ms, 3),
                 "qps": round(p.qps, 1)}
                for p in self.rescore_table
            ]
        return out


def calibration_queries(retriever, n: int, seed: int = 0, terms_per_query: int = 4) -> List[str]:
    """Build realistic calibration queries by sampling words from the
    indexed chunks themselves — term statistics (and therefore BM25
    gather-list lengths) then match live traffic far better than random
    strings, which would hit no postings at all."""
    import random

    rng = random.Random(seed)
    registry = getattr(retriever, "registry", None)
    words: List[str] = []
    if registry is not None and len(registry) > 0:
        rows = list(range(len(registry)))
        rng.shuffle(rows)
        for row in rows[:256]:
            chunk = registry.chunk_of(row)
            if chunk is not None:
                words.extend(chunk.content.split())
            if len(words) > 50_000:
                break
    if not words:
        words = ["calibration"]
    return [
        " ".join(rng.choice(words) for _ in range(terms_per_query)) for _ in range(n)
    ]


def _measure(retriever, queries: Sequence[str], k: int, iters: int) -> float:
    """Median wall seconds for one retrieve_batch over ``queries``."""
    retriever.retrieve_batch(list(queries), k)  # first-use set-up + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        retriever.retrieve_batch(list(queries), k)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def autotune_serving(
    retriever,
    k: int = 5,
    batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128),
    iters: int = 5,
    latency_budget_ms: Optional[float] = None,
    seed: int = 0,
    probe_tiles: Optional[Sequence[int]] = None,
    rescore: Optional[Sequence[int]] = None,
) -> TuneResult:
    """Calibrate micro-batching for ``retriever`` by measurement.

    Args:
      retriever: anything with ``retrieve_batch(queries, k)`` (the
        HybridRetriever, a LateInteractionRetriever, a SpladeRetriever).
      k: result count used during calibration (match production).
      batch_sizes: candidate micro-batch sizes (powers of two, the
        buckets the micro-batcher's traffic fills).
      iters: timed repetitions per point (median is reported).
      latency_budget_ms: if set, batch sizes whose p50 exceeds the
        budget are excluded (unless none fit, in which case the fastest
        point wins so the server still starts).
      seed: calibration query sampling seed.
      probe_tiles: clustered-store probe budgets to sweep (default
        (4, 8, 16, 32, 64); only when the store serves the clustered
        tier).
      rescore: MaxSim tiered-store rescore budgets to sweep (default
        (64, 128, 256, 512, 1024), filtered to ≥ k; only when the
        retriever's token store runs a certified tier).

    Returns a :class:`TuneResult`; ``max_wait_ms`` is set to ~30% of the
    chosen point's batch latency — waiting longer for stragglers than a
    third of the compute it saves costs more latency than it buys
    throughput.
    """
    from trueno_rag_tpu_torch.errors import InvalidConfigError

    if not batch_sizes:
        raise InvalidConfigError("batch_sizes must be non-empty")
    queries = calibration_queries(retriever, max(batch_sizes), seed=seed)
    table: List[BatchPoint] = []
    for bsz in sorted(set(int(b) for b in batch_sizes)):
        if bsz <= 0:
            raise InvalidConfigError(f"batch size must be positive, got {bsz}")
        t = _measure(retriever, queries[:bsz], k, iters)
        table.append(BatchPoint(batch_size=bsz, p50_ms=t * 1e3, qps=bsz / t))

    feasible = table
    if latency_budget_ms is not None:
        feasible = [p for p in table if p.p50_ms <= latency_budget_ms]
        if not feasible:  # nothing fits the budget: least-bad point
            feasible = [min(table, key=lambda p: p.p50_ms)]
    best = max(feasible, key=lambda p: (p.qps, -p.batch_size))
    result = TuneResult(
        max_batch=best.batch_size,
        max_wait_ms=0.3 * best.p50_ms,
        table=table,
    )

    # -- clustered stores: sweep the probe budget at the chosen batch ----
    # probe_tiles trades scan work against certification rate (misses
    # host-patch — results stay EXACT either way, so this knob is
    # semantics-preserving like the others; the patch cost shows up in
    # the measured wall latency, which is exactly why measuring picks
    # the right value for the live corpus)
    store = getattr(retriever, "vector_store", None)
    tier = getattr(store, "_effective_tier", lambda: "")() if store else ""
    if tier == "clustered":
        candidates = probe_tiles or (4, 8, 16, 32, 64)
        ptable: List[ProbePoint] = []
        original = store.config.cluster_probe_tiles
        try:
            for p in sorted(set(int(x) for x in candidates)):
                if p < 1:
                    raise InvalidConfigError(
                        f"probe_tiles must be >= 1, got {p}"
                    )
                store.config.cluster_probe_tiles = p
                t = _measure(retriever, queries[: best.batch_size], k, iters)
                ptable.append(ProbePoint(probe_tiles=p, p50_ms=t * 1e3, qps=best.batch_size / t))
        except BaseException:
            store.config.cluster_probe_tiles = original
            raise
        # the sweep honors the same latency budget as the batch table,
        # and the straggler wait re-derives from the WINNING point —
        # otherwise the sweep could install a probe whose p50 violates
        # the caller's budget while max_wait_ms stays pinned to the
        # stale pre-sweep latency
        pfeasible = ptable
        if latency_budget_ms is not None:
            pfeasible = [x for x in ptable if x.p50_ms <= latency_budget_ms]
            if not pfeasible:
                pfeasible = [min(ptable, key=lambda x: x.p50_ms)]
        # prefer the LARGER probe on a throughput tie: more queries
        # certify on-device, fewer ride the host patch
        win = max(pfeasible, key=lambda x: (x.qps, x.probe_tiles))
        store.config.cluster_probe_tiles = win.probe_tiles
        result.probe_tiles = win.probe_tiles
        result.probe_table = ptable
        result.max_wait_ms = 0.3 * win.p50_ms

    # -- token (MaxSim) stores: sweep the rescore budget -----------------
    # rescore trades the candidate-gather/rescore tail (B·rescore token
    # slabs — the measured tail at 1M once the bound pass amortizes over
    # the batch) against certification rate; uncertified queries re-run
    # the exact scan, so results stay EXACT at any value and the knob is
    # semantics-preserving. The fallback's cost is in the measured wall
    # latency, which is why measurement picks the right budget for the
    # live corpus.
    tstore = getattr(retriever, "store", None)
    tcfg = getattr(tstore, "config", None)
    if (
        tcfg is not None
        and hasattr(tcfg, "rescore")
        and getattr(tcfg, "scan", "") in ("tiered", "token")
    ):
        candidates = tuple(
            r for r in (rescore or (64, 128, 256, 512, 1024)) if r >= k
        ) or (k,)
        rtable: List[RescorePoint] = []
        original_r = tcfg.rescore
        try:
            for r in sorted(set(int(x) for x in candidates)):
                tcfg.rescore = r
                t = _measure(retriever, queries[: best.batch_size], k, iters)
                rtable.append(
                    RescorePoint(rescore=r, p50_ms=t * 1e3,
                                 qps=best.batch_size / t)
                )
        except BaseException:
            tcfg.rescore = original_r
            raise
        rfeasible = rtable
        if latency_budget_ms is not None:
            rfeasible = [x for x in rtable if x.p50_ms <= latency_budget_ms]
            if not rfeasible:
                rfeasible = [min(rtable, key=lambda x: x.p50_ms)]
        # prefer the LARGER rescore on a throughput tie: more queries
        # certify on-device, fewer ride the exact-scan fallback
        rwin = max(rfeasible, key=lambda x: (x.qps, x.rescore))
        tcfg.rescore = rwin.rescore
        result.rescore = rwin.rescore
        result.rescore_table = rtable
        result.max_wait_ms = 0.3 * rwin.p50_ms
    return result
