"""Rerankers — second-stage scoring over retrieved candidates.

Capability-equivalent to the reference's ``src/rerank.rs``: the
``Reranker`` interface (rerank.rs:7-15), ``LexicalReranker``
(rerank.rs:17-122), ``MockCrossEncoderReranker`` (rerank.rs:124-191),
``CompositeReranker`` (rerank.rs:193-264) and ``NoOpReranker``
(rerank.rs:266-287).

These host rerankers operate on strings, so they stay host-side. The
neural cross-encoder reranker (the real capability the mock stands in
for) runs on the card: ``models.cross_encoder.CrossEncoderReranker``.

All scoring rerankers return NEW result lists with ``rerank_score``
attached and results ordered (score desc, chunk id asc), truncated to
``top_k``; ``NoOpReranker`` alone passes the top_k slice through in the
ORIGINAL order with no score (rerank.rs:266-287 — its contract is
"don't touch the ranking").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, runtime_checkable

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.retrieve import RetrievalResult
from trueno_rag_tpu_torch.text import _NON_ALNUM, tokenize_simple


@runtime_checkable
class Reranker(Protocol):
    def rerank(
        self, query: str, candidates: Sequence[RetrievalResult], top_k: int
    ) -> List[RetrievalResult]: ...


def _clone_with_score(r: RetrievalResult, score: float) -> RetrievalResult:
    return RetrievalResult(
        chunk=r.chunk,
        dense_score=r.dense_score,
        sparse_score=r.sparse_score,
        fused_score=r.fused_score,
        rerank_score=score,
    )


def _sort_desc(results: List[RetrievalResult]) -> List[RetrievalResult]:
    return sorted(results, key=lambda r: (-(r.rerank_score or 0.0), r.chunk.id))


class NoOpReranker:
    """Pass-through: take(top_k) in the original order
    (reference: rerank.rs:266-287)."""

    def rerank(self, query: str, candidates: Sequence[RetrievalResult], top_k: int) -> List[RetrievalResult]:
        return list(candidates[:top_k])


@dataclass
class LexicalReranker:
    """Lexical feature mix (reference: rerank.rs:17-122):

    ``score = w_exact * [query is a substring of content]
            + w_coverage * (fraction of query terms present in content)
            + w_position * mean(1 / (1 + first_pos/100)) over found terms``

    with default weights (0.3, 0.5, 0.2) and case-insensitive matching.
    """

    exact_match_weight: float = 0.3
    coverage_weight: float = 0.5
    position_weight: float = 0.2
    case_sensitive: bool = False

    def score(self, query: str, content: str) -> float:
        q = query if self.case_sensitive else query.lower()
        c = content if self.case_sensitive else content.lower()
        exact = 1.0 if q and q in c else 0.0
        # q/c are already lowercased unless case_sensitive; split must not
        # re-lowercase or case-sensitive mode would silently match anyway.
        terms = [t for t in _NON_ALNUM.split(q) if t]
        if not terms:
            return self.exact_match_weight * exact
        found_positions = []
        hits = 0
        for t in terms:
            pos = c.find(t)
            if pos >= 0:
                hits += 1
                found_positions.append(1.0 / (1.0 + pos / 100.0))
        coverage = hits / len(terms)
        position = sum(found_positions) / len(found_positions) if found_positions else 0.0
        return (
            self.exact_match_weight * exact
            + self.coverage_weight * coverage
            + self.position_weight * position
        )

    def rerank(self, query: str, candidates: Sequence[RetrievalResult], top_k: int) -> List[RetrievalResult]:
        scored = [_clone_with_score(r, self.score(query, r.chunk.content)) for r in candidates]
        return _sort_desc(scored)[:top_k]


class MockCrossEncoderReranker:
    """Term-set overlap / |query terms| — deterministic stand-in for a
    neural cross-encoder (reference: rerank.rs:124-191)."""

    def score(self, query: str, content: str) -> float:
        q_terms = set(tokenize_simple(query))
        if not q_terms:
            return 0.0
        c_terms = set(tokenize_simple(content))
        return len(q_terms & c_terms) / len(q_terms)

    def rerank(self, query: str, candidates: Sequence[RetrievalResult], top_k: int) -> List[RetrievalResult]:
        scored = [_clone_with_score(r, self.score(query, r.chunk.content)) for r in candidates]
        return _sort_desc(scored)[:top_k]


class CompositeReranker:
    """Weighted sum of member rerankers' scores, matched by chunk id.

    The reference does an O(n²) index lookup per member
    (rerank.rs:236-248); here the member scores join through a dict.
    """

    def __init__(self, rerankers: Sequence[Reranker], weights: Optional[Sequence[float]] = None) -> None:
        if not rerankers:
            raise InvalidConfigError("CompositeReranker needs at least one member")
        self.rerankers = list(rerankers)
        self.weights = list(weights) if weights is not None else [1.0] * len(self.rerankers)
        if len(self.weights) != len(self.rerankers):
            raise InvalidConfigError("weights must match rerankers in length")

    def rerank(self, query: str, candidates: Sequence[RetrievalResult], top_k: int) -> List[RetrievalResult]:
        # dedup by chunk id first (keep the first occurrence): member
        # scores for EACH duplicate would otherwise accumulate into one
        # acc entry, letting a duplicated candidate outrank a genuinely
        # better unique one (duplicate retrieved ids are a recognized
        # input class — see metrics.py's NDCG dedup)
        seen = set()
        uniq = []
        for r in candidates:
            if r.chunk.id not in seen:
                seen.add(r.chunk.id)
                uniq.append(r)
        acc = {r.chunk.id: 0.0 for r in uniq}
        for reranker, w in zip(self.rerankers, self.weights):
            member = reranker.rerank(query, uniq, len(uniq))
            for res in member:
                acc[res.chunk.id] = acc.get(res.chunk.id, 0.0) + w * (res.rerank_score or 0.0)
        scored = [_clone_with_score(r, acc[r.chunk.id]) for r in uniq]
        return _sort_desc(scored)[:top_k]


@dataclass
class MMRReranker:
    """Maximal Marginal Relevance: diversity-aware candidate selection.

    Greedy selection maximizing ``lambda_ * relevance - (1 - lambda_) *
    max_similarity_to_already_selected`` — the classic remedy for result
    lists full of near-identical chunks (complements ingest dedup, which
    only removes NEAR-duplicates; MMR also spreads topically clustered
    results). Relevance is each candidate's ``best_score()``, min-max
    normalized; redundancy is cosine over the chunks' stored embeddings
    (candidates without embeddings contribute zero redundancy). The
    candidate sets reaching rerankers are tiny (2k), so this runs as a
    NumPy greedy loop — no device dispatch. Beyond the reference
    (rerank.rs has no diversity notion).

    ``lambda_=1.0`` reduces to pure relevance ordering; ``0.0`` to pure
    diversity.
    """

    lambda_: float = 0.7

    def __post_init__(self) -> None:
        if not (0.0 <= self.lambda_ <= 1.0):
            raise InvalidConfigError("MMR lambda_ must be in [0, 1]")

    def rerank(
        self, query: str, candidates: Sequence[RetrievalResult], top_k: int
    ) -> List[RetrievalResult]:
        import numpy as np

        cands = list(candidates)
        if not cands:
            return []
        rel = np.asarray([r.best_score() for r in cands], dtype=np.float32)
        lo, hi = float(rel.min()), float(rel.max())
        rel = (rel - lo) / (hi - lo) if hi > lo else np.ones_like(rel)

        dim = next(
            (len(r.chunk.embedding) for r in cands if r.chunk.embedding is not None),
            0,
        )
        embs = np.zeros((len(cands), dim or 1), dtype=np.float32)
        have = np.zeros(len(cands), dtype=bool)
        for i, r in enumerate(cands):
            e = r.chunk.embedding
            if e is not None and dim and len(e) == dim:
                v = np.asarray(e, dtype=np.float32)
                n = float(np.linalg.norm(v))
                if n > 0:
                    embs[i] = v / n
                    have[i] = True
        sims = embs @ embs.T  # cosine between candidates (0 where absent)

        selected: List[int] = []
        remaining = set(range(len(cands)))
        while remaining and len(selected) < top_k:
            best_i, best_val = -1, -np.inf
            for i in sorted(remaining):
                redundancy = (
                    max((float(sims[i, j]) for j in selected if have[i] and have[j]),
                        default=0.0)
                    if selected
                    else 0.0
                )
                val = self.lambda_ * float(rel[i]) - (1.0 - self.lambda_) * redundancy
                # ties break by chunk id asc — the module's documented
                # order — not by candidate position
                if val > best_val or (
                    val == best_val
                    and best_i >= 0
                    and cands[i].chunk.id < cands[best_i].chunk.id
                ):
                    best_i, best_val = i, val
            selected.append(best_i)
            remaining.discard(best_i)
            cands[best_i] = _clone_with_score(cands[best_i], float(best_val))
        return [cands[i] for i in selected]
