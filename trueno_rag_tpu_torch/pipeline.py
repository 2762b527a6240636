"""RAG pipeline: orchestration, context assembly and citations.

PyTorch-port counterpart of ``trueno_rag_tpu/pipeline.py`` (the host
orchestration is the same code; retrieval runs through the port's
:class:`~trueno_rag_tpu_torch.retrieve.HybridRetriever`, with tag filters
at ingest and query time, query preprocessing
(:mod:`~trueno_rag_tpu_torch.preprocess`: the variants of a query retrieve
as one device batch and fuse by reciprocal rank) and ingest
near-duplicate dedup (:mod:`~trueno_rag_tpu_torch.ops.dedup`) and the
learned-sparse third source (``with_learned_sparse``). Capability-equivalent
to the reference's ``src/pipeline.rs``:
``Citation`` (pipeline.rs:16-30), ``ContextChunk``/``AssembledContext``
with the three formatters (pipeline.rs:33-148), ``AssemblyStrategy``
(pipeline.rs:150-160), ``ContextAssembler`` with greedy token budgeting
(pipeline.rs:162-286), ``RagPipeline`` with the retrieve(2k)→rerank(k)
query contract (pipeline.rs:372-380) and the builder that requires an
embedder and a reranker (pipeline.rs:419-538).

Two deliberate upgrades over the reference:

- ``DocumentGrouped`` assembly orders groups by first appearance instead
  of HashMap iteration order (the reference is nondeterministic here,
  pipeline.rs:240-274).
- ``Interleaved`` actually interleaves round-robin across documents; the
  reference silently falls back to Sequential (pipeline.rs:276-279).

Token estimates use the reference's chars/4 heuristic
(pipeline.rs:76-77).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from trueno_rag_tpu_torch.chunking import Chunk, Chunker, RecursiveChunker
from trueno_rag_tpu_torch.document import Document
from trueno_rag_tpu_torch.embed import Embedder
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.index import VectorStoreConfig
from trueno_rag_tpu_torch.retrieve import HybridRetriever, HybridRetrieverConfig, RetrievalResult
from trueno_rag_tpu_torch.rerank import NoOpReranker, Reranker

# ---------------------------------------------------------------------------
# Citations & assembled context (reference: pipeline.rs:16-148)
# ---------------------------------------------------------------------------


@dataclass
class Citation:
    id: int  # 1-based citation number
    document_id: str
    chunk_id: str
    title: Optional[str] = None
    url: Optional[str] = None
    page: Optional[int] = None
    # Best-matching sentence of the cited chunk for the query that
    # produced this context (None when assembly ran without a query).
    # Beyond the reference: its Citation carries no snippet
    # (pipeline.rs:16-30).
    snippet: Optional[str] = None


def _best_snippet(query: str, content: str, max_chars: int = 240) -> Optional[str]:
    """The sentence of ``content`` sharing the most query terms (ties:
    earliest), clipped to ``max_chars`` — host string work, no device
    involvement."""
    from trueno_rag_tpu_torch.chunking import split_sentences
    from trueno_rag_tpu_torch.text import tokenize_simple

    terms = set(tokenize_simple(query))
    if not terms:
        return None
    best, best_hits = None, 0
    for s0, e0 in split_sentences(content):
        sent = content[s0:e0].strip()
        if not sent:
            continue
        hits = len(terms & set(tokenize_simple(sent)))
        if hits > best_hits:
            best, best_hits = sent, hits
    if best is None:
        return None
    return best if len(best) <= max_chars else best[: max_chars - 1] + "…"


@dataclass
class ContextChunk:
    content: str
    citation_id: int
    chunk_id: str
    document_id: str
    score: float


@dataclass
class AssembledContext:
    chunks: List[ContextChunk] = field(default_factory=list)
    citations: List[Citation] = field(default_factory=list)
    total_tokens: int = 0

    def format_with_citations(self) -> str:
        """"content [n]" blocks joined by blank lines (pipeline.rs:99-118)."""
        return "\n\n".join(
            f"{c.content} [{c.citation_id}]" if c.citation_id else c.content
            for c in self.chunks
        )

    def format_plain(self) -> str:
        return "\n\n".join(c.content for c in self.chunks)

    def citation_list(self) -> str:
        """"[n] Title" lines (pipeline.rs:132-148)."""
        lines = []
        for cit in self.citations:
            title = cit.title or "Untitled"
            suffix = f" (p. {cit.page})" if cit.page is not None else ""
            lines.append(f"[{cit.id}] {title}{suffix}")
        return "\n".join(lines)


class AssemblyStrategy:
    SEQUENTIAL = "sequential"
    DOCUMENT_GROUPED = "document_grouped"
    INTERLEAVED = "interleaved"

    ALL = (SEQUENTIAL, DOCUMENT_GROUPED, INTERLEAVED)


@dataclass
class ContextAssemblerConfig:
    """Reference defaults: 4096-token budget, citations on, sequential
    (pipeline.rs:162-181)."""

    max_tokens: int = 4096
    include_citations: bool = True
    strategy: str = AssemblyStrategy.SEQUENTIAL

    def __post_init__(self) -> None:
        if self.max_tokens <= 0:
            raise InvalidConfigError("max_tokens must be positive")
        if self.strategy not in AssemblyStrategy.ALL:
            raise InvalidConfigError(f"unknown assembly strategy {self.strategy!r}")


class ContextAssembler:
    """Greedy token-budget filling: chunks are added in strategy order
    until the first one that would exceed the budget, which stops
    assembly (no truncation — reference behavior, pipeline.rs:215-238)."""

    def __init__(self, config: Optional[ContextAssemblerConfig] = None) -> None:
        self.config = config or ContextAssemblerConfig()

    def assemble(self, results: Sequence[RetrievalResult],
                 query: Optional[str] = None) -> AssembledContext:
        ordered = self._order(results)
        ctx = AssembledContext()
        citation_ids: Dict[str, int] = {}  # chunk_id -> citation id
        for res in ordered:
            chunk = res.chunk
            tokens = chunk.token_estimate()
            if ctx.total_tokens + tokens > self.config.max_tokens:
                break
            if self.config.include_citations:
                cit_id = citation_ids.get(chunk.id)
                if cit_id is None:
                    cit_id = len(ctx.citations) + 1
                    citation_ids[chunk.id] = cit_id
                    ctx.citations.append(
                        Citation(
                            id=cit_id,
                            document_id=chunk.document_id,
                            chunk_id=chunk.id,
                            title=chunk.metadata.title,
                            page=chunk.metadata.page,
                            snippet=_best_snippet(query, chunk.content)
                            if query else None,
                        )
                    )
            else:
                cit_id = 0  # reference: citation_id 0 when citations off
            ctx.chunks.append(
                ContextChunk(
                    content=chunk.content,
                    citation_id=cit_id,
                    chunk_id=chunk.id,
                    document_id=chunk.document_id,
                    score=res.best_score(),
                )
            )
            ctx.total_tokens += tokens
        return ctx

    def _order(self, results: Sequence[RetrievalResult]) -> List[RetrievalResult]:
        strat = self.config.strategy
        if strat == AssemblyStrategy.SEQUENTIAL:
            return list(results)
        # group per document in first-appearance order
        groups: Dict[str, List[RetrievalResult]] = {}
        for r in results:
            groups.setdefault(r.chunk.document_id, []).append(r)
        if strat == AssemblyStrategy.DOCUMENT_GROUPED:
            return [r for group in groups.values() for r in group]
        # interleaved: round-robin across documents
        out: List[RetrievalResult] = []
        queues = [list(g) for g in groups.values()]
        while queues:
            next_round = []
            for q in queues:
                out.append(q.pop(0))
                if q:
                    next_round.append(q)
            queues = next_round
        return out


# ---------------------------------------------------------------------------
# Pipeline (reference: pipeline.rs:288-416)
# ---------------------------------------------------------------------------


@dataclass
class RagPipelineConfig:
    """Informational config snapshot (the reference builds it but the
    builder doesn't consume it either, pipeline.rs:288-313)."""

    chunk_size: int = 512
    chunk_overlap: int = 50
    embedding_dimension: int = 384
    retrieval: HybridRetrieverConfig = field(default_factory=HybridRetrieverConfig)
    context: ContextAssemblerConfig = field(default_factory=ContextAssemblerConfig)


class RagPipeline:
    """End-to-end RAG: index documents, answer queries.

    Query contract matches the reference: retrieve ``k*2`` hybrid
    candidates, then rerank down to ``k`` (pipeline.rs:372-380).
    """

    def __init__(
        self,
        embedder: Embedder,
        reranker: Reranker,
        chunker: Chunker,
        retriever: HybridRetriever,
        assembler: ContextAssembler,
        preprocessor=None,
        dedup_threshold: Optional[float] = None,
    ) -> None:
        self.embedder = embedder
        self.reranker = reranker
        self.chunker = chunker
        self.retriever = retriever
        self.assembler = assembler
        self.preprocessor = preprocessor  # optional QueryPreprocessor
        self.dedup_threshold = dedup_threshold
        self.document_count = 0
        self.chunk_count = 0
        self.duplicates_skipped = 0

    def _drop_near_duplicates(self, chunks: List[Chunk]) -> List[Chunk]:
        """Ingest-time near-duplicate filter (one pass of two products on
        the store's device, :mod:`~trueno_rag_tpu_torch.ops.dedup`): drops
        chunks whose cosine similarity to the existing index or an earlier
        chunk of the batch reaches the threshold."""
        if self.dedup_threshold is None or not chunks:
            return chunks
        import numpy as np

        from trueno_rag_tpu_torch.index.vector_store import DistanceMetric
        from trueno_rag_tpu_torch.ops.dedup import near_duplicates

        store = self.retriever.vector_store
        emb = np.stack([np.asarray(c.embedding, dtype=np.float32) for c in chunks])
        if len(store) > 0 and not store.is_compact:
            matrix, valid = store.device_matrix, store.device_valid
        elif len(store) > 0:  # compact/clustered: no fp32 device matrix
            matrix, valid = store._host, store._valid
        else:
            matrix = np.zeros((0, emb.shape[1]), np.float32)
            valid = np.zeros((0,), bool)
        is_dup, _, _ = near_duplicates(
            emb, matrix, valid, threshold=self.dedup_threshold,
            rows_normalized=(store.config.metric == DistanceMetric.COSINE), device=store.device,
        )
        is_dup = is_dup.cpu().numpy()
        self.duplicates_skipped += int(is_dup.sum())
        return [c for c, d in zip(chunks, is_dup) if not d]

    # -- ingest -----------------------------------------------------------------

    def index_document(self, document: Document, tags: Optional[Sequence[str]] = None) -> int:
        """Chunk → embed (one batched call) → index both stores.
        Returns the number of chunks indexed (reference: pipeline.rs:333-347).
        ``tags`` label every chunk for tag-filtered retrieval."""
        chunks = self.chunker.chunk(document)
        self.embedder.embed_chunks(chunks)
        chunks = self._drop_near_duplicates(chunks)
        self.retriever.index_batch(chunks, tags=tags)
        self.document_count += 1
        self.chunk_count += len(chunks)
        return len(chunks)

    def index_documents(self, documents: Sequence[Document],
                        tags: Optional[Sequence[Sequence[str]]] = None) -> int:
        """Bulk ingest: chunk every document first, then embed ALL chunks
        in one batched embedder call, then index both stores. ``tags``:
        optional per-document tag lists (parallel to ``documents``) for
        tag-filtered retrieval."""
        if tags is not None:
            if len(tags) != len(documents):
                raise InvalidConfigError(
                    f"got {len(tags)} tag lists for {len(documents)} documents"
                )
            if any(isinstance(t, str) for t in tags):
                # a flat ['news', 'sports'] would register each CHARACTER
                # of a string as a tag: fail closed
                raise InvalidConfigError(
                    "tags must be one tag LIST per document, e.g. "
                    "[['news'], ['sports']] — got a flat string entry"
                )
        all_chunks: List[Chunk] = []
        chunk_tags: List[Optional[Sequence[str]]] = []
        for i, d in enumerate(documents):
            doc_chunks = self.chunker.chunk(d)
            all_chunks.extend(doc_chunks)
            chunk_tags.extend([None if tags is None else tags[i]] * len(doc_chunks))
        self.embedder.embed_chunks(all_chunks)
        if self.dedup_threshold is not None:
            kept = self._drop_near_duplicates(all_chunks)
            kept_ids = {c.id for c in kept}
            chunk_tags = [t for c, t in zip(all_chunks, chunk_tags) if c.id in kept_ids]
            all_chunks = kept
        self.retriever.index_batch(all_chunks)
        if tags is not None:
            reg = self.retriever.registry
            for chunk, t in zip(all_chunks, chunk_tags):
                if t:
                    reg.set_tags(chunk.id, t)
        self.document_count += len(documents)
        self.chunk_count += len(all_chunks)
        return len(all_chunks)

    # -- query ------------------------------------------------------------------

    def query(self, query: str, k: int = 5, tag_filter=None) -> List[RetrievalResult]:
        if self.preprocessor is not None:
            return self._query_preprocessed(query, k, tag_filter=tag_filter)
        candidates = self.retriever.retrieve(query, k * 2, tag_filter=tag_filter)
        return self.reranker.rerank(query, candidates, k)

    def _query_preprocessed(self, query: str, k: int, tag_filter=None) -> List[RetrievalResult]:
        """Multi-query retrieval: preprocess into variants, retrieve all
        variants as ONE device batch, fuse the per-variant rankings by
        reciprocal rank (RRF 60), then rerank against the original query.
        A preprocessor with ``fusion_for`` (AdaptivePreprocessor) picks the
        merge strategy per query; None keeps the configured one."""
        variants = self.preprocessor.preprocess(query)
        fusion_for = getattr(self.preprocessor, "fusion_for", None)
        fusion = fusion_for(query) if fusion_for is not None else None
        per_variant = self.retriever.retrieve_batch(variants, k * 2, fusion=fusion, tag_filter=tag_filter)
        rrf_k = 60.0
        acc: dict = {}
        best: dict = {}
        for results in per_variant:
            for rank, res in enumerate(results):
                cid = res.chunk.id
                acc[cid] = acc.get(cid, 0.0) + 1.0 / (rrf_k + rank + 1.0)
                prev = best.get(cid)
                if prev is None or res.best_score() > prev.best_score():
                    best[cid] = res
        ranked = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))[: k * 2]
        fused = []
        for cid, score in ranked:
            res = best[cid]
            res.fused_score = score
            fused.append(res)
        return self.reranker.rerank(query, fused, k)

    def query_batch(self, queries: Sequence[str], k: int = 5,
                    tag_filter=None) -> List[List[RetrievalResult]]:
        """Batched :meth:`query` — the same results per query as the
        single path, including the configured preprocessor (each query's
        variants retrieve as one batch), with one device batch for
        retrieval otherwise. ``tag_filter`` is one
        :class:`~trueno_rag_tpu_torch.retrieve.TagFilter` for every query
        or a list with one per query."""
        if self.preprocessor is not None:
            return [
                self._query_preprocessed(
                    q, k, tag_filter=tag_filter[i] if isinstance(tag_filter, (list, tuple)) else tag_filter,
                )
                for i, q in enumerate(queries)
            ]
        batches = self.retriever.retrieve_batch(queries, k * 2, tag_filter=tag_filter)
        return [self.reranker.rerank(q, cands, k) for q, cands in zip(queries, batches)]

    def query_with_context(self, query: str, k: int = 5, tag_filter=None) -> AssembledContext:
        return self.assembler.assemble(self.query(query, k, tag_filter=tag_filter), query=query)

    def query_with_context_batch(self, queries: Sequence[str], k: int = 5,
                                 tag_filter=None) -> List[AssembledContext]:
        return [
            self.assembler.assemble(results, query=q)
            for q, results in zip(queries, self.query_batch(queries, k, tag_filter=tag_filter))
        ]


# ---------------------------------------------------------------------------
# Builder (reference: pipeline.rs:419-538)
# ---------------------------------------------------------------------------


class RagPipelineBuilder:
    """Requires an embedder and a reranker (build errors otherwise,
    pipeline.rs:494-501); everything else defaults like the reference:
    RecursiveChunker(512,50), vector store sized to the embedder's
    dimension, BM25 defaults, RRF(60) fusion."""

    def __init__(self) -> None:
        self._embedder: Optional[Embedder] = None
        self._reranker: Optional[Reranker] = None
        self._chunker: Optional[Chunker] = None
        self._fusion: Optional[FusionStrategy] = None
        self._retriever_config: Optional[HybridRetrieverConfig] = None
        self._vector_config: Optional[VectorStoreConfig] = None
        self._assembler_config: Optional[ContextAssemblerConfig] = None
        self._device = None
        self._preprocessor = None
        self._dedup_threshold: Optional[float] = None
        self._learned_encoder = None

    def with_embedder(self, embedder: Embedder) -> "RagPipelineBuilder":
        self._embedder = embedder
        return self

    def with_reranker(self, reranker: Reranker) -> "RagPipelineBuilder":
        self._reranker = reranker
        return self

    def with_chunker(self, chunker: Chunker) -> "RagPipelineBuilder":
        self._chunker = chunker
        return self

    def with_fusion(self, fusion: FusionStrategy) -> "RagPipelineBuilder":
        self._fusion = fusion
        return self

    def with_retriever_config(self, config: HybridRetrieverConfig) -> "RagPipelineBuilder":
        self._retriever_config = config
        return self

    def with_vector_config(self, config: VectorStoreConfig) -> "RagPipelineBuilder":
        self._vector_config = config
        return self

    def with_assembler_config(self, config: ContextAssemblerConfig) -> "RagPipelineBuilder":
        self._assembler_config = config
        return self

    def with_preprocessor(self, preprocessor) -> "RagPipelineBuilder":
        """Route queries through a QueryPreprocessor (HyDE, multi-query,
        chained, adaptive — :mod:`trueno_rag_tpu_torch.preprocess`)."""
        self._preprocessor = preprocessor
        return self

    def with_dedup(self, threshold: float = 0.97) -> "RagPipelineBuilder":
        """Skip near-duplicate chunks at ingest (cosine ≥ threshold vs the
        index or an earlier chunk of the same batch); skips count in
        ``pipeline.duplicates_skipped``."""
        if not (0.0 < threshold <= 1.0):
            raise InvalidConfigError("dedup threshold must be in (0, 1]")
        self._dedup_threshold = threshold
        return self

    def with_learned_sparse(self, encoder) -> "RagPipelineBuilder":
        """Attach a SPLADE-class expansion encoder as a third candidate
        source (the tri-hybrid: dense + BM25 + learned-sparse fused N-way;
        see :meth:`HybridRetriever.attach_learned_sparse`)."""
        self._learned_encoder = encoder
        return self

    def with_device(self, device) -> "RagPipelineBuilder":
        """Where the indexes' tensors live (default: the CUDA device;
        "cpu" must be asked for)."""
        self._device = device
        return self

    def build(self) -> RagPipeline:
        if self._embedder is None:
            raise InvalidConfigError("pipeline requires an embedder")
        if self._reranker is None:
            raise InvalidConfigError("pipeline requires a reranker")
        chunker = self._chunker or RecursiveChunker(chunk_size=512, overlap=50)
        retr_cfg = self._retriever_config or HybridRetrieverConfig()
        if self._fusion is not None:
            # replace, don't mutate: the caller's config object may be
            # shared with other pipelines (or reused to build another)
            import dataclasses

            retr_cfg = dataclasses.replace(retr_cfg, fusion=self._fusion)
        retriever = HybridRetriever(
            self._embedder,
            config=retr_cfg,
            vector_config=self._vector_config,
            device=self._device,
        )
        if self._learned_encoder is not None:
            retriever.attach_learned_sparse(self._learned_encoder)
        assembler = ContextAssembler(self._assembler_config)
        return RagPipeline(
            self._embedder, self._reranker, chunker, retriever, assembler,
            preprocessor=self._preprocessor, dedup_threshold=self._dedup_threshold,
        )


def pipeline_builder() -> RagPipelineBuilder:
    """Convenience: a builder preloaded with the mock embedder and no-op
    reranker (reference: pipeline.rs:540-544)."""
    from trueno_rag_tpu_torch.embed import MockEmbedder

    return RagPipelineBuilder().with_embedder(MockEmbedder(384)).with_reranker(NoOpReranker())
