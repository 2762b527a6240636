"""Query preprocessing: HyDE, multi-query expansion, analysis.

PyTorch-port counterpart of ``trueno_rag_tpu/preprocess.py`` (host
string code, the same variants). The reference ships this whole subsystem as **dead code** —
``src/preprocess.rs`` (838 lines) is never declared in lib.rs's module
tree (SURVEY §0.3) — while the CHANGELOG still advertises it. Here it is
a live, wired-in feature: ``RagPipelineBuilder.with_preprocessor`` routes
every query through a preprocessor, the variant queries retrieve as ONE
device batch (the variants share one corpus scan on the card), and
the per-variant rankings fuse by reciprocal rank before reranking.

Component parity (reference file:line):
- ``QueryPreprocessor`` protocol             preprocess.rs:10-16
- ``PassthroughPreprocessor``                preprocess.rs:18-30
- ``HydePreprocessor`` + generators          preprocess.rs:32-108
- ``MultiQueryPreprocessor``                 preprocess.rs:110-177
- ``KeywordExpander``                        preprocess.rs:179-238
- ``SynonymExpander``                        preprocess.rs:240-317
- ``ChainedPreprocessor``                    preprocess.rs:319-390
- ``QueryAnalyzer`` / ``QueryIntent``        preprocess.rs:392-528
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

from trueno_rag_tpu_torch.errors import QueryError
from trueno_rag_tpu_torch.text import STOPWORDS, tokenize_simple


@runtime_checkable
class QueryPreprocessor(Protocol):
    def preprocess(self, query: str) -> List[str]:
        """Transform one query into one or more retrieval queries."""
        ...

    @property
    def name(self) -> str: ...


class PassthroughPreprocessor:
    """Identity (preprocess.rs:18-30)."""

    name = "passthrough"

    def preprocess(self, query: str) -> List[str]:
        if not query.strip():
            raise QueryError("empty query")
        return [query]


# ---------------------------------------------------------------------------
# HyDE (preprocess.rs:32-108)
# ---------------------------------------------------------------------------


@runtime_checkable
class HypotheticalGenerator(Protocol):
    def generate(self, query: str) -> str: ...


class MockHypotheticalGenerator:
    """Deterministic stand-in: prefixes "The answer is:" like the
    reference's mock (preprocess.rs:84-98)."""

    def generate(self, query: str) -> str:
        return f"The answer is: {query}"


class HydePreprocessor:
    """Hypothetical Document Embeddings: retrieve with a *generated
    answer* instead of (or alongside) the query. ``augment=True`` keeps
    the original query too (reference's augment flag)."""

    def __init__(self, generator: Optional[HypotheticalGenerator] = None, augment: bool = False) -> None:
        self.generator = generator or MockHypotheticalGenerator()
        self.augment = augment

    name = "hyde"

    def preprocess(self, query: str) -> List[str]:
        if not query.strip():
            raise QueryError("empty query")
        hypothetical = self.generator.generate(query)
        if self.augment:
            return [query, hypothetical]
        return [hypothetical]


# ---------------------------------------------------------------------------
# Expanders (preprocess.rs:179-317)
# ---------------------------------------------------------------------------


@runtime_checkable
class QueryExpander(Protocol):
    def expand(self, query: str) -> List[str]: ...


class KeywordExpander:
    """Stopword-filtered keyword variants: the keywords joined as one
    query plus "{query} {kw}" for the top ``max_keyword_variants``
    keywords (preprocess.rs:179-238)."""

    def __init__(self, max_keyword_variants: int = 3) -> None:
        self.max_keyword_variants = max_keyword_variants

    def expand(self, query: str) -> List[str]:
        keywords = [t for t in tokenize_simple(query) if t not in STOPWORDS and len(t) >= 2]
        if not keywords:
            return []
        out = [" ".join(keywords)]
        for kw in keywords[: self.max_keyword_variants]:
            out.append(f"{query} {kw}")
        return out


DEFAULT_SYNONYMS: Dict[str, List[str]] = {
    "error": ["failure", "exception", "fault"],
    "fix": ["repair", "resolve", "solve"],
    "fast": ["quick", "rapid", "speedy"],
    "slow": ["sluggish", "laggy"],
    "create": ["make", "build", "generate"],
    "delete": ["remove", "erase", "drop"],
    "install": ["setup", "deploy"],
    "config": ["configuration", "settings"],
    "doc": ["document", "documentation"],
    "search": ["query", "lookup", "retrieval"],
}


class SynonymExpander:
    """Word-substitution variants from a synonym map; ships a small
    technical-synonyms default like the reference (preprocess.rs:240-317).

    Lookup semantics match the reference exactly: the query splits on
    whitespace and each token lowercases for the map lookup — a word
    with attached punctuation ("error!") does not match, and at most
    TWO synonyms substitute per word (preprocess.rs:299-316). Custom
    map keys are lowercased at construction (a convenience the
    reference's all-lowercase built-in map never needed)."""

    def __init__(self, synonyms: Optional[Dict[str, List[str]]] = None) -> None:
        base = synonyms if synonyms is not None else DEFAULT_SYNONYMS
        self.synonyms = {k.lower(): list(v) for k, v in base.items()}

    def expand(self, query: str) -> List[str]:
        words = query.split()
        out: List[str] = []
        for i, w in enumerate(words):
            for syn in self.synonyms.get(w.lower(), [])[:2]:
                variant = words[:i] + [syn] + words[i + 1 :]
                out.append(" ".join(variant))
        return out


class MultiQueryPreprocessor:
    """Original + expansions, deduplicated, capped at ``max_queries``
    (reference default 5, preprocess.rs:110-177)."""

    def __init__(self, expander: QueryExpander, max_queries: int = 5) -> None:
        self.expander = expander
        self.max_queries = max_queries

    name = "multi_query"

    def preprocess(self, query: str) -> List[str]:
        if not query.strip():
            raise QueryError("empty query")
        seen = {query}
        out = [query]
        for variant in self.expander.expand(query):
            # cap BEFORE appending (reference preprocess.rs:163-167:
            # max_queries=1 returns the original only)
            if len(out) >= self.max_queries:
                break
            if variant not in seen:
                seen.add(variant)
                out.append(variant)
        return out


class ChainedPreprocessor:
    """Run several preprocessors, dedupe, cap at ``max_total``
    (reference default 10, preprocess.rs:319-390)."""

    def __init__(self, preprocessors: Sequence[QueryPreprocessor], max_total: int = 10) -> None:
        self.preprocessors = list(preprocessors)
        self.max_total = max_total

    name = "chained"

    def preprocess(self, query: str) -> List[str]:
        if not self.preprocessors:
            # reference semantics (preprocess.rs:366-368): an empty
            # chain passes the original through — returning [] would
            # silently retrieve zero variants for every query
            return [query]
        seen = set()
        out: List[str] = []
        for p in self.preprocessors:
            for q in p.preprocess(query):
                # cap BEFORE appending (preprocess.rs:375-377)
                if len(out) >= self.max_total:
                    return out
                if q not in seen:
                    seen.add(q)
                    out.append(q)
        return out


# ---------------------------------------------------------------------------
# Query analysis (preprocess.rs:392-528)
# ---------------------------------------------------------------------------


class QueryIntent(str, enum.Enum):
    HOW_TO = "how_to"
    DEFINITION = "definition"
    TROUBLESHOOTING = "troubleshooting"
    COMPARISON = "comparison"
    INFORMATIONAL = "informational"
    UNKNOWN = "unknown"


_INTENT_KEYWORDS = {
    QueryIntent.HOW_TO: ["how", "steps", "guide", "tutorial", "setup", "install", "configure"],
    QueryIntent.DEFINITION: ["what", "define", "definition", "meaning", "explain"],
    QueryIntent.TROUBLESHOOTING: ["error", "fix", "broken", "fail", "failing", "crash", "debug", "issue", "problem"],
    QueryIntent.COMPARISON: ["vs", "versus", "compare", "difference", "better", "between"],
    QueryIntent.INFORMATIONAL: ["why", "when", "where", "who", "which", "overview"],
}


@dataclass
class QueryAnalysis:
    intent: QueryIntent
    keywords: List[str] = field(default_factory=list)
    confidence: float = 0.3


class QueryAnalyzer:
    """Keyword-vote intent detection + keyword extraction with
    confidence in [0.3, 1.0] (preprocess.rs:392-528)."""

    def analyze(self, query: str) -> QueryAnalysis:
        tokens = tokenize_simple(query)
        votes: Dict[QueryIntent, int] = {}
        for intent, kws in _INTENT_KEYWORDS.items():
            votes[intent] = sum(1 for t in tokens if t in kws)
        best_intent, best_votes = max(votes.items(), key=lambda kv: (kv[1], kv[0].value))
        if best_votes == 0:
            best_intent = QueryIntent.UNKNOWN
        keywords = [t for t in tokens if t not in STOPWORDS and len(t) >= 2]
        confidence = min(1.0, 0.3 + 0.35 * best_votes) if best_votes else 0.3
        return QueryAnalysis(intent=best_intent, keywords=keywords, confidence=confidence)
