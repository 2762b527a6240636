"""IR evaluation metrics.

PyTorch-port counterpart of ``trueno_rag_tpu/metrics.py`` (host code, the
same). Capability-equivalent to the reference's ``src/metrics.rs``: per-query
``RetrievalMetrics`` (recall@k, precision@k, NDCG@k, MRR, MAP —
metrics.rs:22-145) plus the free ``f1_at_k`` / ``hit_rate_at_k``
functions (metrics.rs:147-169) and fleet-level ``AggregatedMetrics``
means (metrics.rs:189-226).

Semantics preserved exactly, including the regression-driven NDCG fix:
retrieved ids are **deduplicated** before DCG so NDCG ≤ 1.0 even when a
retriever returns the same id twice (reference: metrics.rs:103-116 and
proptest-regressions/metrics.txt).

A batched device implementation for fleet evaluation over padded id
matrices lives in :mod:`trueno_rag_tpu_torch.ops.metrics`; this host module is
the oracle.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Set


def _dedup_keep_order(ids: Sequence[str]) -> List[str]:
    seen: Set[str] = set()
    out: List[str] = []
    for i in ids:
        if i not in seen:
            seen.add(i)
            out.append(i)
    return out


def recall_at_k(retrieved: Sequence[str], relevant: Set[str], k: int) -> float:
    """|relevant ∩ retrieved@k| / |relevant|; 0.0 when relevant is empty
    (reference: metrics.rs:45-58)."""
    if not relevant:
        return 0.0
    hits = len(set(retrieved[:k]) & relevant)  # set semantics: duplicate
    return hits / len(relevant)  # retrieved ids count once (metrics.rs:49-58)


def precision_at_k(retrieved: Sequence[str], relevant: Set[str], k: int) -> float:
    """|relevant ∩ retrieved@k| / k; 0.0 when k == 0 (metrics.rs:60-73)."""
    if k == 0:
        return 0.0
    hits = len(set(retrieved[:k]) & relevant)
    return hits / k


def mean_reciprocal_rank(retrieved: Sequence[str], relevant: Set[str]) -> float:
    """1 / (rank of first relevant + 1), 0-based ranks; 0.0 if no hit
    (metrics.rs:75-86)."""
    for rank, i in enumerate(retrieved):
        if i in relevant:
            return 1.0 / (rank + 1)
    return 0.0


def ndcg_at_k(retrieved: Sequence[str], relevant: Set[str], k: int) -> float:
    """Binary-gain NDCG@k over the top-k WINDOW: each relevant id gains
    at most once, at its first occurrence's ORIGINAL rank (the
    reference regression fix, metrics.rs:103-116 — take(k) then dedup).
    Deduplicating before truncating would slide ids ranked beyond k
    into the window, making NDCG@k report hits recall@k/precision@k say
    were never retrieved."""
    if not relevant or k == 0:
        return 0.0
    seen: Set[str] = set()
    dcg = 0.0
    for rank, i in enumerate(retrieved[:k]):
        if i in relevant and i not in seen:
            seen.add(i)
            dcg += 1.0 / math.log2(rank + 2)
    ideal_hits = min(len(relevant), k)
    idcg = sum(1.0 / math.log2(rank + 2) for rank in range(ideal_hits))
    return dcg / idcg if idcg > 0.0 else 0.0


def average_precision(retrieved: Sequence[str], relevant: Set[str]) -> float:
    """MAP component: mean of precision-at-each-hit (metrics.rs:125-145)."""
    if not relevant:
        return 0.0
    hits = 0
    acc = 0.0
    seen: Set[str] = set()
    for rank, i in enumerate(retrieved):
        if i in relevant and i not in seen:  # each relevant id scores once
            seen.add(i)
            hits += 1
            acc += hits / (rank + 1)
    return acc / len(relevant)


def f1_at_k(retrieved: Sequence[str], relevant: Set[str], k: int) -> float:
    """Harmonic mean of precision@k and recall@k (metrics.rs:147-158)."""
    p = precision_at_k(retrieved, relevant, k)
    r = recall_at_k(retrieved, relevant, k)
    if p + r == 0.0:
        return 0.0
    return 2.0 * p * r / (p + r)


def hit_rate_at_k(retrieved: Sequence[str], relevant: Set[str], k: int) -> float:
    """1.0 if any of the top-k is relevant else 0.0 (metrics.rs:160-169)."""
    return 1.0 if any(i in relevant for i in retrieved[:k]) else 0.0


@dataclass
class RetrievalMetrics:
    """Per-query metric bundle (reference: metrics.rs:22-43)."""

    recall: Dict[int, float] = field(default_factory=dict)
    precision: Dict[int, float] = field(default_factory=dict)
    ndcg: Dict[int, float] = field(default_factory=dict)
    mrr: float = 0.0
    map: float = 0.0

    @classmethod
    def compute(
        cls,
        retrieved: Sequence[str],
        relevant: Iterable[str],
        k_values: Sequence[int] = (1, 5, 10),
    ) -> "RetrievalMetrics":
        rel = set(relevant)
        m = cls()
        for k in k_values:
            m.recall[k] = recall_at_k(retrieved, rel, k)
            m.precision[k] = precision_at_k(retrieved, rel, k)
            m.ndcg[k] = ndcg_at_k(retrieved, rel, k)
        m.mrr = mean_reciprocal_rank(retrieved, rel)
        m.map = average_precision(retrieved, rel)
        return m


@dataclass
class AggregatedMetrics:
    """Means over a fleet of queries; the k set is taken from the first
    query's maps (reference: metrics.rs:189-226)."""

    mean_recall: Dict[int, float] = field(default_factory=dict)
    mean_precision: Dict[int, float] = field(default_factory=dict)
    mean_ndcg: Dict[int, float] = field(default_factory=dict)
    mean_mrr: float = 0.0
    mean_map: float = 0.0
    num_queries: int = 0

    @classmethod
    def aggregate(cls, per_query: Sequence[RetrievalMetrics]) -> "AggregatedMetrics":
        agg = cls(num_queries=len(per_query))
        if not per_query:
            return agg
        n = len(per_query)
        for k in per_query[0].recall:
            agg.mean_recall[k] = sum(q.recall.get(k, 0.0) for q in per_query) / n
        for k in per_query[0].precision:
            agg.mean_precision[k] = sum(q.precision.get(k, 0.0) for q in per_query) / n
        for k in per_query[0].ndcg:
            agg.mean_ndcg[k] = sum(q.ndcg.get(k, 0.0) for q in per_query) / n
        agg.mean_mrr = sum(q.mrr for q in per_query) / n
        agg.mean_map = sum(q.map for q in per_query) / n
        return agg
