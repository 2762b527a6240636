"""Adaptive preprocessing: route queries by analyzed intent.

PyTorch-port counterpart of ``trueno_rag_tpu/preprocess_adaptive.py``.
Composes the :mod:`trueno_rag_tpu_torch.preprocess` pieces the way the
reference's docs imagine but never wire up: the
:class:`~trueno_rag_tpu.preprocess.QueryAnalyzer` picks an expansion
strategy per query — troubleshooting queries get synonym expansion
(error/fix/crash vocabularies vary wildly), definition/informational
queries get HyDE (a hypothetical answer retrieves better than a
question), how-to queries get keyword variants, everything else passes
through.

The analyzer also conditions FUSION: troubleshooting queries carry
exact tokens (error strings, flag names) that BM25 matches far better
than embeddings, so fusion leans sparse; definition/informational
queries are paraphrase-shaped, so fusion leans dense. Low-confidence
analyses keep the retriever's configured strategy (``fusion_for``
returns None). Fusion routing never changes candidate generation —
only how the two exact rankings merge.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.preprocess import (
    HydePreprocessor,
    KeywordExpander,
    MultiQueryPreprocessor,
    PassthroughPreprocessor,
    QueryAnalyzer,
    QueryIntent,
    QueryPreprocessor,
    SynonymExpander,
)


#: Intent → fusion mapping used when the analyzer is confident. RRF for
#: comparison/how-to (both sources contribute evenly); linear leaning
#: sparse for troubleshooting (exact token matches dominate); linear
#: leaning dense for definition/informational (paraphrase retrieval).
DEFAULT_FUSION_ROUTES: Dict[QueryIntent, FusionStrategy] = {
    QueryIntent.TROUBLESHOOTING: FusionStrategy.linear(dense_weight=0.3),
    QueryIntent.DEFINITION: FusionStrategy.linear(dense_weight=0.7),
    QueryIntent.INFORMATIONAL: FusionStrategy.linear(dense_weight=0.7),
    QueryIntent.HOW_TO: FusionStrategy.rrf(),
    QueryIntent.COMPARISON: FusionStrategy.rrf(),
}


class AdaptivePreprocessor:
    """Intent-routed preprocessing (QueryPreprocessor protocol)."""

    name = "adaptive"

    def __init__(
        self,
        routes: Optional[Dict[QueryIntent, QueryPreprocessor]] = None,
        fusion_routes: Optional[Dict[QueryIntent, FusionStrategy]] = None,
        min_fusion_confidence: float = 0.5,
    ) -> None:
        self.analyzer = QueryAnalyzer()
        self.routes: Dict[QueryIntent, QueryPreprocessor] = routes or {
            QueryIntent.TROUBLESHOOTING: MultiQueryPreprocessor(SynonymExpander()),
            QueryIntent.DEFINITION: HydePreprocessor(augment=True),
            QueryIntent.INFORMATIONAL: HydePreprocessor(augment=True),
            QueryIntent.HOW_TO: MultiQueryPreprocessor(KeywordExpander()),
        }
        self.fusion_routes = (
            dict(DEFAULT_FUSION_ROUTES) if fusion_routes is None else fusion_routes
        )
        self.min_fusion_confidence = min_fusion_confidence
        self._fallback = PassthroughPreprocessor()

    def preprocess(self, query: str) -> List[str]:
        intent = self.analyzer.analyze(query).intent
        return self.routes.get(intent, self._fallback).preprocess(query)

    def fusion_for(self, query: str) -> Optional[FusionStrategy]:
        """Fusion strategy for ``query``'s analyzed intent, or None when
        the analysis is below ``min_fusion_confidence`` (caller keeps its
        configured strategy). The pipeline consults this per query."""
        analysis = self.analyzer.analyze(query)
        if analysis.confidence < self.min_fusion_confidence:
            return None
        return self.fusion_routes.get(analysis.intent)
