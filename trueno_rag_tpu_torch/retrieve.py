"""Retrievers: hybrid dense+sparse with on-device fusion.

PyTorch counterpart of ``trueno_rag_tpu/retrieve.py``. Capability-
equivalent to the reference's ``src/retrieve.rs``: ``RetrievalResult``
with the four-score model and ``best_score`` priority,
``HybridRetrieverConfig`` and ``HybridRetriever``.

Query plan: embed the query batch on the host → dense top-C and BM25
top-C over the *shared row space* (both stores use one
:class:`ChunkRegistry`) → device fusion over the padded candidate
arrays → one hydration step back on the host. With a scan tier engaged
the dense stage is the certified bf16 tile scan (staged: dense, then
BM25, then fusion); otherwise dense, BM25 and fusion run as
:func:`~trueno_rag_tpu_torch.ops.hybrid.hybrid_query_arrays`.

Not ported yet (each raises, see ROADMAP): tag filters, the learned-
sparse third source and the encoder-fused one-program path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder
from trueno_rag_tpu_torch.errors import InvalidConfigError, QueryError
from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.index import BM25Index, ChunkRegistry, VectorStore, VectorStoreConfig


@dataclass
class RetrievalResult:
    """A retrieved chunk plus its per-source scores."""

    chunk: Chunk
    dense_score: Optional[float] = None
    sparse_score: Optional[float] = None
    fused_score: Optional[float] = None
    rerank_score: Optional[float] = None

    def best_score(self) -> float:
        """Priority: rerank > fused > dense > sparse > 0.0."""
        for s in (self.rerank_score, self.fused_score, self.dense_score, self.sparse_score):
            if s is not None:
                return s
        return 0.0

    def with_rerank_score(self, score: float) -> "RetrievalResult":
        self.rerank_score = score
        return self


@dataclass
class HybridRetrieverConfig:
    """Reference defaults: 50 candidates per source, RRF(60) fusion,
    both sources enabled. ``fused`` mirrors the JAX package's field; the
    encoder-fused path it selects is not ported yet (``fused=True``
    raises)."""

    candidates_per_source: int = 50
    fusion: FusionStrategy = field(default_factory=FusionStrategy.rrf)
    use_dense: bool = True
    use_sparse: bool = True
    fused: Optional[bool] = None


class HybridRetriever:
    """Owns a VectorStore + BM25Index over one shared row registry, with
    every device tensor on ``device``."""

    def __init__(
        self,
        embedder: Embedder,
        config: Optional[HybridRetrieverConfig] = None,
        vector_config: Optional[VectorStoreConfig] = None,
        device=None,
    ) -> None:
        self.embedder = embedder
        self.config = config or HybridRetrieverConfig()
        self.device = resolve_device(device)
        self.registry = ChunkRegistry()
        vcfg = vector_config or VectorStoreConfig(dimension=embedder.dimension)
        self.vector_store = VectorStore(vcfg, registry=self.registry, device=self.device)
        self.sparse_index = BM25Index(registry=self.registry, device=self.device)

    def attach_learned_sparse(self, encoder, encode_batch: int = 128) -> None:
        raise InvalidConfigError("the learned-sparse source is not ported yet (ROADMAP)")

    # -- indexing -------------------------------------------------------------

    def index(self, chunk: Chunk) -> None:
        """Add a chunk to both stores. The sparse index goes FIRST (a
        replaced chunk's OLD content clears its postings before the
        vector store swaps the new chunk into the shared registry); the
        embedding is validated before either store mutates."""
        self.vector_store.validate_chunk(chunk)
        self.sparse_index.add(chunk)
        self.vector_store.insert(chunk)

    def index_batch(self, chunks: Sequence[Chunk]) -> None:
        """Bulk add: one native BM25 build call when available, then one
        vectorized dense insert (same ordering and atomicity as index)."""
        for chunk in chunks:
            self.vector_store.validate_chunk(chunk)
        self.sparse_index.add_batch(chunks)
        self.vector_store.insert_many(chunks)

    def remove(self, chunk_id: str) -> bool:
        """Remove from both stores and free the shared row."""
        found_sparse = self.sparse_index.remove(chunk_id)
        found_dense = self.vector_store.remove(chunk_id)
        if found_dense or found_sparse:
            self.registry.remove(chunk_id)
        return found_dense or found_sparse

    def ensure_ready(self) -> None:
        """Apply pending mutations to the device state now instead of on
        the next query."""
        self.vector_store.ensure_ready()
        self.sparse_index.ensure_ready()

    # -- retrieval ---------------------------------------------------------------

    def retrieve(self, query: str, k: int,
                 fusion: Optional[FusionStrategy] = None) -> List[RetrievalResult]:
        return self.retrieve_batch([query], k, fusion=fusion)[0]

    def retrieve_batch(self, queries: Sequence[str], k: int,
                       fusion: Optional[FusionStrategy] = None,
                       tag_filter=None) -> List[List[RetrievalResult]]:
        """Hybrid retrieval for a query batch; hydration maps the final
        top-k rows back to chunks exactly once. ``fusion`` overrides the
        configured strategy for this call only."""
        if tag_filter is not None:
            raise QueryError("tag filters are not ported yet (ROADMAP)")
        if not queries:
            return []
        if any(not q.strip() for q in queries):
            raise QueryError("empty query")
        use_dense = self.config.use_dense
        use_sparse = self.config.use_sparse
        if not use_dense and not use_sparse:
            raise QueryError("all retrieval sources disabled")
        if self.config.fused is True:
            raise QueryError("the encoder-fused path (fused=True) is not ported yet (ROADMAP)")
        if len(self.registry) == 0:
            return [[] for _ in queries]
        cand = self.config.candidates_per_source
        strategy = fusion or self.config.fusion

        # (the JAX package pads the batch to a power of two to bound its
        # compiled programs; eager PyTorch needs no bucket, and a padded
        # zero query would only fail certification and re-run on fp32)
        b = len(queries)
        if use_dense:
            qvecs = np.asarray(self.embedder.embed_queries(queries), dtype=np.float32)

        if use_dense and use_sparse:
            from trueno_rag_tpu_torch.ops.fusion import fuse_topk

            if self.vector_store._effective_tier() != "none":
                # staged: certified dense scan (exact: checked fallback),
                # then BM25, then device fusion on the candidate arrays
                d_scores, d_rows = self.vector_store.search_arrays(qvecs, cand)
                s_scores, s_rows = self.sparse_index.search_arrays(queries, cand)
                f_rows, f_scores = fuse_topk(
                    d_rows, d_scores, s_rows, s_scores,
                    kind=strategy.kind, param=strategy.device_param,
                )
            else:
                import torch

                from trueno_rag_tpu_torch.ops.dense import require_fp32
                from trueno_rag_tpu_torch.ops.hybrid import hybrid_query_arrays

                require_fp32()
                self.sparse_index._refresh_snapshot()
                bids, blo, bhi = self.sparse_index.gather_block_tensors(queries)
                f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays(
                    torch.from_numpy(qvecs).to(self.device),
                    self.vector_store.device_matrix,
                    self.vector_store.device_valid,
                    bids, blo, bhi,
                    self.sparse_index._snap["blocks"],
                    cand=cand,
                    metric=self.vector_store.config.metric,
                    fusion_kind=strategy.kind,
                    fusion_param=strategy.device_param,
                )
        elif use_dense:
            d_scores, d_rows = self.vector_store.search_arrays(qvecs, cand)
            f_rows, f_scores = d_rows, d_scores
        else:
            s_scores, s_rows = self.sparse_index.search_arrays(queries, cand)
            f_rows, f_scores = s_rows, s_scores

        f_rows = f_rows.cpu().numpy()
        f_scores = f_scores.cpu().numpy()
        d_maps = self._score_maps(d_rows, d_scores) if use_dense else [{}] * b
        s_maps = self._score_maps(s_rows, s_scores) if use_sparse else [{}] * b

        out: List[List[RetrievalResult]] = []
        fused_is_real = use_dense and use_sparse
        for i in range(b):
            results: List[RetrievalResult] = []
            for row, score in zip(f_rows[i], f_scores[i]):
                if row < 0 or len(results) >= k:
                    continue
                chunk = self.registry.chunk_of(int(row))
                if chunk is None:
                    continue
                results.append(
                    RetrievalResult(
                        chunk=chunk,
                        dense_score=d_maps[i].get(int(row)),
                        sparse_score=s_maps[i].get(int(row)),
                        fused_score=float(score) if fused_is_real else None,
                    )
                )
            out.append(results)
        return out

    @staticmethod
    def _score_maps(rows, scores) -> List[Dict[int, float]]:
        rows = rows.cpu().numpy()
        scores = scores.cpu().numpy()
        return [
            {int(r): float(s) for r, s in zip(rows[i], scores[i]) if r >= 0}
            for i in range(rows.shape[0])
        ]

    def retrieve_dense(self, query: str, k: int) -> List[RetrievalResult]:
        """Vector-only retrieval."""
        qvec = self.embedder.embed_query(query)
        hits = self.vector_store.search(qvec, k)
        return [
            RetrievalResult(chunk=self.vector_store.get(cid), dense_score=s)
            for cid, s in hits
            if self.vector_store.get(cid) is not None
        ]

    def retrieve_sparse(self, query: str, k: int) -> List[RetrievalResult]:
        """BM25-only retrieval."""
        hits = self.sparse_index.search(query, k)
        return [
            RetrievalResult(chunk=self.registry.get_chunk(cid), sparse_score=s)
            for cid, s in hits
            if self.registry.get_chunk(cid) is not None
        ]

    def __len__(self) -> int:
        return len(self.registry)
