"""Retrievers: hybrid dense+sparse with on-device fusion.

PyTorch counterpart of ``trueno_rag_tpu/retrieve.py``. Capability-
equivalent to the reference's ``src/retrieve.rs``: ``RetrievalResult``
with the four-score model and ``best_score`` priority,
``HybridRetrieverConfig`` and ``HybridRetriever``.

Query plan: embed the query batch on the host → dense top-C and BM25
top-C over the *shared row space* (both stores use one
:class:`ChunkRegistry`) → device fusion over the padded candidate
arrays → one hydration step back on the host. With a scan tier engaged
the dense stage is the certified tile scan (staged: dense, then BM25,
then fusion); otherwise dense, BM25 and fusion run as
:func:`~trueno_rag_tpu_torch.ops.hybrid.hybrid_query_arrays`.

Tag filters (:class:`TagFilter`) ride the scan kernel on the compact and
bf16 tile tiers; elsewhere the dense scores are masked before their
top-k (:mod:`~trueno_rag_tpu_torch.ops.tags`). BM25 candidates are
filtered after their top-k, before fusion.

Not ported yet (each raises, see ROADMAP): the learned-sparse third
source and the encoder-fused one-program path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder
from trueno_rag_tpu_torch.errors import InvalidConfigError, QueryError
from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.index import BM25Index, ChunkRegistry, VectorStore, VectorStoreConfig
from trueno_rag_tpu_torch.index.base import IMPOSSIBLE_BIT


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


@dataclass(frozen=True)
class TagFilter:
    """Metadata filter over chunk tags (strings; see
    :meth:`ChunkRegistry.set_tags`): results must carry ALL of ``all``,
    at least one of ``any`` (when non-empty), and NONE of ``none``.
    Resolution to 32-bit masks happens per dispatch; an unknown tag in
    ``all`` matches nothing (empty results); an unknown tag in ``any``
    matches nothing itself but KNOWN alternatives still match (only an
    all-unknown ``any`` empties the results); an unknown tag in
    ``none`` is a no-op."""

    all: Tuple[str, ...] = ()
    any: Tuple[str, ...] = ()
    none: Tuple[str, ...] = ()


def resolve_tag_filters(registry, tag_filter, b: int):
    """Resolve one :class:`TagFilter` (for every query) or a list of them
    (one per query, None = unfiltered) to three int32 mask arrays of
    length ``b``: (t_all, t_any, t_none). An unknown tag in ``all`` makes
    the filter impossible (the reserved bit-31 marker matches no chunk);
    an unknown tag in ``any`` matches nothing, and only an all-unknown
    ``any`` is impossible; unknown tags in ``none`` exclude nothing."""
    filters = (
        list(tag_filter) if isinstance(tag_filter, (list, tuple))
        else [tag_filter] * b
    )
    if len(filters) != b:
        raise QueryError(f"got {len(filters)} tag filters for {b} queries")
    t_all = np.zeros((b,), np.int64)
    t_any = np.zeros((b,), np.int64)
    t_none = np.zeros((b,), np.int64)
    for i, f in enumerate(filters):
        if f is None:
            continue
        impossible = False
        for t in f.all:
            bit = registry.bit_for(t, create=False)
            if bit is None:
                impossible = True
                break
            t_all[i] |= bit
        if not impossible and f.any:
            known = [registry.bit_for(t, create=False) for t in f.any]
            known = [x for x in known if x is not None]
            if not known:
                impossible = True
            else:
                for x in known:
                    t_any[i] |= x
        for t in f.none:
            bit = registry.bit_for(t, create=False)
            if bit is not None:
                t_none[i] |= bit
        if impossible:
            t_all[i] = IMPOSSIBLE_BIT
            t_any[i] = 0
            t_none[i] = 0
    # int64 -> int32 bit patterns (bit 31 wraps to the sign bit)
    return (t_all.astype(np.uint32).astype(np.int32),
            t_any.astype(np.uint32).astype(np.int32),
            t_none.astype(np.uint32).astype(np.int32))


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

    def index(self, chunk: Chunk, tags: Optional[Sequence[str]] = None) -> None:
        """Add a chunk to both stores, labelled with ``tags`` for
        tag-filtered retrieval. The sparse index goes FIRST (a replaced
        chunk's OLD content clears its postings before the vector store
        swaps the new chunk into the shared registry); the embedding is
        validated before either store mutates."""
        self.vector_store.validate_chunk(chunk)
        self.sparse_index.add(chunk)
        self.vector_store.insert(chunk)
        if tags is not None:
            self.registry.set_tags(chunk.id, tags)

    def index_batch(self, chunks: Sequence[Chunk], tags: Optional[Sequence[str]] = None) -> None:
        """Bulk add: one native BM25 build call when available, then one
        vectorized dense insert (same ordering and atomicity as index);
        ``tags`` label every chunk."""
        for chunk in chunks:
            self.vector_store.validate_chunk(chunk)
        self.sparse_index.add_batch(chunks)
        self.vector_store.insert_many(chunks)
        if tags is not None:
            for chunk in chunks:
                self.registry.set_tags(chunk.id, tags)

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
        self.vector_store._device_tag_bits()  # lazy per-row tag masks

    # -- tag filters -----------------------------------------------------------

    def _device_masks(self, masks):
        """Host filter words → (t_all, t_any, t_none) int32 tensors."""
        return tuple(torch.from_numpy(np.asarray(m, np.int32)).to(self.device) for m in masks)

    # -- retrieval ---------------------------------------------------------------

    def retrieve(self, query: str, k: int,
                 fusion: Optional[FusionStrategy] = None,
                 tag_filter: Optional[TagFilter] = None) -> List[RetrievalResult]:
        return self.retrieve_batch([query], k, fusion=fusion, tag_filter=tag_filter)[0]

    def retrieve_batch(self, queries: Sequence[str], k: int,
                       fusion: Optional[FusionStrategy] = None,
                       tag_filter=None) -> List[List[RetrievalResult]]:
        """Hybrid retrieval for a query batch; hydration maps the final
        top-k rows back to chunks exactly once. ``fusion`` overrides the
        configured strategy for this call only. ``tag_filter`` is one
        :class:`TagFilter` for every query, or a list with one per query
        (None = unfiltered)."""
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
        masks = None if tag_filter is None else resolve_tag_filters(self.registry, tag_filter, b)
        store = self.vector_store
        staged_tier = store._effective_tier() != "none" and (
            masks is None or store.supports_tagged_scan
        )

        if use_dense and use_sparse:
            from trueno_rag_tpu_torch.ops.fusion import fuse_topk

            if staged_tier:
                # staged: certified dense scan (exact: checked fallback on
                # the bf16/int8 tiers, host patch on compact; a filter
                # rides the scan kernel), then BM25, then device fusion
                d_scores, d_rows = store.search_arrays(qvecs, cand, tag_masks=masks)
                s_scores, s_rows = self._sparse_candidates(queries, cand, masks)
                f_rows, f_scores = fuse_topk(
                    d_rows, d_scores, s_rows, s_scores,
                    kind=strategy.kind, param=strategy.device_param,
                )
            else:
                from trueno_rag_tpu_torch.ops.dense import require_fp32

                require_fp32()
                self.sparse_index._refresh_snapshot()
                bids, blo, bhi = self.sparse_index.gather_block_tensors(queries)
                q_t = torch.from_numpy(qvecs).to(self.device)
                kw = dict(
                    cand=cand, metric=store.config.metric,
                    fusion_kind=strategy.kind, fusion_param=strategy.device_param,
                )
                blocks = self.sparse_index._snap["blocks"]
                if masks is not None:
                    from trueno_rag_tpu_torch.ops.tags import hybrid_query_arrays_tagged

                    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays_tagged(
                        q_t, store.device_matrix, store.device_valid, store._device_tag_bits(),
                        *self._device_masks(masks), bids, blo, bhi, blocks, **kw,
                    )
                else:
                    from trueno_rag_tpu_torch.ops.hybrid import hybrid_query_arrays

                    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays(
                        q_t, store.device_matrix, store.device_valid, bids, blo, bhi, blocks, **kw,
                    )
        elif use_dense:
            d_scores, d_rows = self._dense_candidates(qvecs, cand, masks)
            f_rows, f_scores = d_rows, d_scores
        else:
            s_scores, s_rows = self._sparse_candidates(queries, cand, masks)
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

    # -- per-source candidate stages -------------------------------------------

    def _dense_candidates(self, qvecs, cand: int, masks):
        """Dense top-C candidates, the tag filter riding the scan kernel
        where the tier supports it and masking the fp32 scores
        (ops.tags.dense_topk_tagged) otherwise."""
        store = self.vector_store
        if masks is None or store.supports_tagged_scan:
            return store.search_arrays(qvecs, cand, tag_masks=masks)
        from trueno_rag_tpu_torch.ops.dense import require_fp32
        from trueno_rag_tpu_torch.ops.tags import dense_topk_tagged

        require_fp32()
        return dense_topk_tagged(
            torch.from_numpy(qvecs).to(self.device), store.device_matrix, store.device_valid,
            store._device_tag_bits(), *self._device_masks(masks),
            min(cand, len(self.registry)), store.config.metric,
        )

    def _sparse_candidates(self, queries, cand: int, masks):
        """BM25 top-C candidates; tag filters drop disallowed rows
        post-top-k (slots are not refilled — the contract of the tagged
        one-dispatch path, ops/tags.py)."""
        s_scores, s_rows = self.sparse_index.search_arrays(queries, cand)
        if masks is not None:
            from trueno_rag_tpu_torch.ops.tags import filter_candidates_by_tags

            s_rows, s_scores = filter_candidates_by_tags(
                s_rows, s_scores, self.vector_store._device_tag_bits(), *self._device_masks(masks)
            )
        return s_scores, s_rows

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
