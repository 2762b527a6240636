"""Retrievers: hybrid dense+sparse with on-device fusion.

PyTorch counterpart of ``trueno_rag_tpu/retrieve.py``. Capability-
equivalent to the reference's ``src/retrieve.rs``: ``RetrievalResult``
with the four-score model and ``best_score`` priority,
``HybridRetrieverConfig``, ``HybridRetriever`` and the single-source
``DenseRetriever`` and ``SparseRetriever``.

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

With an :class:`~trueno_rag_tpu_torch.models.encoder.EncoderEmbedder` the
query may take the encoder-fused path (:meth:`HybridRetriever.retrieve_batch_fused`):
token ids go to the card, the encoder's output feeds the dense scan
directly. ``HybridRetrieverConfig.fused`` selects it as the JAX package
does: ``None`` takes it only on tier "none" (past the tier crossover the
staged certified scan is faster), ``True`` forces it over the fp32 matrix
or the compact bf16r replicas, ``False`` never takes it.

A learned-sparse (SPLADE-class) third source
(:meth:`HybridRetriever.attach_learned_sparse`) makes the query a
tri-hybrid: dense, BM25 and learned-sparse candidates fused N-way
(:func:`~trueno_rag_tpu_torch.ops.fusion.fuse_topk_many`), staged source
by source on every tier; results carry ``learned_score``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.embed import Embedder
from trueno_rag_tpu_torch.errors import QueryError
from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.index import BM25Index, ChunkRegistry, VectorStore, VectorStoreConfig
from trueno_rag_tpu_torch.index.base import IMPOSSIBLE_BIT
from trueno_rag_tpu_torch.utils import profiling


@dataclass
class RetrievalResult:
    """A retrieved chunk plus its per-source scores; ``learned_score`` is
    the learned-sparse source's, when one is attached."""

    chunk: Chunk
    dense_score: Optional[float] = None
    sparse_score: Optional[float] = None
    fused_score: Optional[float] = None
    rerank_score: Optional[float] = None
    learned_score: Optional[float] = None

    def best_score(self) -> float:
        """Priority: rerank > fused > dense > sparse > learned > 0.0."""
        for s in (self.rerank_score, self.fused_score, self.dense_score, self.sparse_score,
                  self.learned_score):
            if s is not None:
                return s
        return 0.0

    def with_rerank_score(self, score: float) -> "RetrievalResult":
        self.rerank_score = score
        return self


@dataclass
class HybridRetrieverConfig:
    """Reference defaults: 50 candidates per source, RRF(60) fusion,
    both sources enabled. ``use_learned`` takes effect once
    :meth:`HybridRetriever.attach_learned_sparse` installs a third source.
    ``fused``: the encoder-fused query path — None (auto: fused on tier
    "none" with an encoder embedder), True (always; raises where it cannot
    run) or False (never)."""

    candidates_per_source: int = 50
    fusion: FusionStrategy = field(default_factory=FusionStrategy.rrf)
    use_dense: bool = True
    use_sparse: bool = True
    use_learned: bool = True
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
        # the optional learned-sparse (SPLADE-class) third source
        self.learned_encoder = None
        self.learned_index = None
        self._learned_encode_batch = 128

    def attach_learned_sparse(self, encoder, encode_batch: int = 128) -> None:
        """Install a SPLADE-class expansion encoder (e.g.
        :class:`~trueno_rag_tpu_torch.models.splade.SpladeEncoder`) as a
        third candidate source: queries then fuse dense + BM25 +
        learned-sparse candidates N-way and results carry
        ``learned_score``. Chunks already indexed are expanded now; later
        ``index``/``index_batch`` calls feed all three stores."""
        from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex

        self.learned_encoder = encoder
        self.learned_index = LearnedSparseIndex(registry=self.registry, device=self.device)
        self._learned_encode_batch = int(encode_batch)
        live = [c for c in (self.registry.chunk_of(r) for r in range(self.registry.capacity_rows))
                if c is not None]
        if live:
            self._learned_add(live)

    def _learned_add(self, chunks: Sequence[Chunk]) -> None:
        eb = self._learned_encode_batch
        for lo in range(0, len(chunks), eb):
            batch = chunks[lo:lo + eb]
            terms, w = self.learned_encoder.expand_documents([c.content for c in batch])
            self.learned_index.add_batch(batch, terms, w)

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
        if self.learned_index is not None:
            self._learned_add([chunk])
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
        if self.learned_index is not None:
            self._learned_add(list(chunks))
        if tags is not None:
            for chunk in chunks:
                self.registry.set_tags(chunk.id, tags)

    def remove(self, chunk_id: str) -> bool:
        """Remove from every store and free the shared row."""
        found_sparse = self.sparse_index.remove(chunk_id)
        found_dense = self.vector_store.remove(chunk_id)
        found_learned = self.learned_index.remove(chunk_id) if self.learned_index is not None else False
        if found_dense or found_sparse or found_learned:
            self.registry.remove(chunk_id)
        return found_dense or found_sparse or found_learned

    def ensure_ready(self) -> None:
        """Apply pending mutations to the device state now instead of on
        the next query (a server warms a reloaded index with it before the
        swap)."""
        self.vector_store.ensure_ready()
        self.sparse_index.ensure_ready()
        if self.learned_index is not None:
            self.learned_index.ensure_ready()
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
        (None = unfiltered). The call is one ``rag.retrieve`` span of the
        span recorder (:func:`~trueno_rag_tpu_torch.utils.profiling.spans`)."""
        with profiling.span("rag.retrieve") as sp:
            if sp is not None:
                sp.attrs.update(queries=len(queries), k=k)
            return self._retrieve_batch(queries, k, fusion, tag_filter)

    def _retrieve_batch(self, queries, k: int, fusion, tag_filter) -> List[List[RetrievalResult]]:
        if not queries:
            return []
        if any(not q.strip() for q in queries):
            raise QueryError("empty query")
        use_dense = self.config.use_dense
        use_sparse = self.config.use_sparse
        use_learned = (self.learned_index is not None and self.config.use_learned
                       and len(self.learned_index) > 0)
        if not use_dense and not use_sparse and not use_learned:
            raise QueryError("all retrieval sources disabled")
        if self.config.fused is True and use_learned:
            raise QueryError(
                "fused=True is the two-source one-program path; the "
                "learned-sparse source serves the staged tri-hybrid "
                "(leave fused=None or set use_learned=False)"
            )
        if self.config.fused is True and not (use_dense and use_sparse):
            # a disabled source must not silently degrade the explicit
            # fused contract to the staged path
            raise QueryError(
                "fused=True requires BOTH sources (use_dense and "
                "use_sparse); disable fused or enable the source"
            )
        if len(self.registry) == 0:
            return [[] for _ in queries]
        if use_dense and use_sparse and not use_learned and self.config.fused is not False:
            from trueno_rag_tpu_torch.models.encoder import EncoderEmbedder

            if isinstance(self.embedder, EncoderEmbedder):
                tier = self.vector_store._effective_tier()
                if self.config.fused is True:
                    if tier == "clustered":
                        # the fused compact query reads the row-order
                        # replicas; the clustered layout stages
                        raise QueryError(
                            "fused=True is not available on scan_tier='clustered' "
                            "(leave fused=None; the staged path serves it)"
                        )
                    if self.vector_store.is_compact and tag_filter is not None:
                        raise QueryError(
                            "fused=True on a compact store does not support tag "
                            "filters; leave fused=None (the staged compact path "
                            "serves filters)"
                        )
                    return self.retrieve_batch_fused(queries, k, fusion=fusion, tag_filter=tag_filter)
                # fused=None: the fused query scans the fp32 matrix — right
                # below the tier crossover; once a scan tier is engaged the
                # staged certified scan serves the query, and so it does
                # once the corpus outgrew the block-table BM25 layout
                self.sparse_index._refresh_snapshot()
                if tier == "none" and self.sparse_index._snap["blocks"] is not None:
                    return self.retrieve_batch_fused(queries, k, fusion=fusion, tag_filter=tag_filter)
            elif self.config.fused is True:
                raise QueryError("fused=True requires an EncoderEmbedder")
        cand = self.config.candidates_per_source
        strategy = fusion or self.config.fusion

        # (the JAX package pads the batch to a power of two to bound its
        # compiled programs; eager PyTorch needs no bucket, and a padded
        # zero query would only fail certification and re-run on fp32)
        b = len(queries)
        if use_dense:
            with profiling.span("rag.encode"):
                qvecs = np.asarray(self.embedder.embed_queries(queries), dtype=np.float32)
        masks = None if tag_filter is None else resolve_tag_filters(self.registry, tag_filter, b)
        store = self.vector_store
        staged_tier = store._effective_tier() != "none" and (
            masks is None or store.supports_tagged_scan
        )

        l_rows = l_scores = None
        if use_learned:
            f_rows, f_scores, d_rows, d_scores, s_rows, s_scores, l_rows, l_scores = self._tri_candidates(
                queries, qvecs if use_dense else None, cand, masks, strategy, use_dense, use_sparse)
        elif use_dense and use_sparse:
            from trueno_rag_tpu_torch.ops.fusion import fuse_topk

            if staged_tier:
                # staged: certified dense scan (exact: checked fallback on
                # the bf16/int8 tiers, host patch on compact; a filter
                # rides the scan kernel), then BM25, then device fusion
                with profiling.span("rag.scan"):
                    d_scores, d_rows = store.search_arrays(qvecs, cand, tag_masks=masks)
                with profiling.span("rag.sparse"):
                    s_scores, s_rows = self._sparse_candidates(queries, cand, masks)
                with profiling.span("rag.fuse"):
                    f_rows, f_scores = fuse_topk(
                        d_rows, d_scores, s_rows, s_scores,
                        kind=strategy.kind, param=strategy.device_param,
                    )
            else:
                from trueno_rag_tpu_torch.ops.dense import require_fp32

                require_fp32()
                sparse = self.sparse_index
                sparse._refresh_snapshot()
                q_t = torch.from_numpy(qvecs).to(self.device)
                kw = dict(
                    cand=cand, metric=store.config.metric,
                    fusion_kind=strategy.kind, fusion_param=strategy.device_param,
                )
                blocks = sparse._snap["blocks"]
                if blocks is not None and masks is not None:
                    from trueno_rag_tpu_torch.ops.tags import hybrid_query_arrays_tagged

                    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays_tagged(
                        q_t, store.device_matrix, store.device_valid, store._device_tag_bits(),
                        *self._device_masks(masks), *sparse.gather_block_tensors(queries), blocks, **kw,
                    )
                elif blocks is not None:
                    from trueno_rag_tpu_torch.ops.hybrid import hybrid_query_arrays

                    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays(
                        q_t, store.device_matrix, store.device_valid,
                        *sparse.gather_block_tensors(queries), blocks, **kw,
                    )
                elif masks is not None:
                    raise QueryError(
                        "tag filters are not supported on the segment BM25 path "
                        "(corpora past the f32-exact block range)"
                    )
                else:  # rows past the f32-exact block range: segment path
                    from trueno_rag_tpu_torch.ops.hybrid import hybrid_query_arrays_segments

                    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays_segments(
                        q_t, store.device_matrix, store.device_valid,
                        *sparse.gather_segment_tensors(queries), sparse._snap["packed"],
                        sparse._snap["avgdl"], k1=sparse.k1, b=sparse.b, **kw,
                    )
        elif use_dense:
            with profiling.span("rag.scan"):
                d_scores, d_rows = self._dense_candidates(qvecs, cand, masks)
            f_rows, f_scores = d_rows, d_scores
        else:
            with profiling.span("rag.sparse"):
                s_scores, s_rows = self._sparse_candidates(queries, cand, masks)
            f_rows, f_scores = s_rows, s_scores

        with profiling.span("rag.hydrate"):
            d_maps = self._score_maps(d_rows, d_scores) if use_dense else [{}] * b
            s_maps = self._score_maps(s_rows, s_scores) if use_sparse else [{}] * b
            l_maps = self._score_maps(l_rows, l_scores) if use_learned else None
            with profiling.span("rag.hydrate.wait"):
                f_rows, f_scores = f_rows.cpu().numpy(), f_scores.cpu().numpy()
            return self._hydrate(b, k, f_rows, f_scores, d_maps, s_maps,
                                 fused_is_real=int(use_dense) + int(use_sparse) + int(use_learned) >= 2,
                                 l_maps=l_maps)

    def _hydrate(self, b: int, k: int, f_rows, f_scores, d_maps, s_maps,
                 fused_is_real: bool = True, l_maps=None) -> List[List[RetrievalResult]]:
        """The first ``b`` queries' final rows (host arrays, -1 = none) →
        results with their per-source scores, at most ``k`` per query."""
        out: List[List[RetrievalResult]] = []
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
                        learned_score=None if l_maps is None else l_maps[i].get(int(row)),
                    )
                )
            out.append(results)
        return out

    # -- the tri-hybrid (learned-sparse third source) ---------------------------

    def _tri_candidates(self, queries, qvecs, cand: int, masks, strategy, use_dense: bool,
                        use_sparse: bool):
        """The tri-hybrid's lists → ``(f_rows, f_scores, d_rows, d_scores,
        s_rows, s_scores, l_rows, l_scores)`` (a disabled source's pair is
        None): each source staged, then the lists fused N-way (a lone learned
        list is the answer). Eager PyTorch runs the same launches as
        :func:`~trueno_rag_tpu_torch.ops.hybrid.tri_query_arrays` either way,
        so every tier takes this path; the learned source's panels keep
        :meth:`LearnedSparseIndex.search_arrays`'s grouping."""
        from trueno_rag_tpu_torch.ops.fusion import fuse_topk_many

        d = s = (None, None)
        lists = []
        if use_dense:
            d = self._dense_candidates(qvecs, cand, masks)
            lists.append(d)
        if use_sparse:
            s = self._sparse_candidates(queries, cand, masks)
            lists.append(s)
        l_scores, l_rows = self._learned_candidates(queries, cand, masks)
        if not lists:
            f_rows, f_scores = l_rows, l_scores
        else:
            lists.append((l_scores, l_rows))
            weights = (tuple(strategy.resolve_weights(len(lists)))
                       if strategy.kind in ("linear", "convex") else ())
            f_rows, f_scores = fuse_topk_many(
                [r for _, r in lists], [x for x, _ in lists],
                kind=strategy.kind, param=strategy.device_param, weights=weights,
            )
        return f_rows, f_scores, d[1], d[0], s[1], s[0], l_rows, l_scores

    def _learned_candidates(self, queries, cand: int, masks):
        """Learned-sparse top-C candidates; a tag filter's allowed-row mask
        rides the weighted scoring op, so the filtered top-k is exact."""
        from trueno_rag_tpu_torch.models.splade import allowed_rows

        q_terms, q_w = self.learned_encoder.expand_queries(list(queries))
        allowed = None if masks is None else allowed_rows(self.registry, masks, self.learned_index.capacity_rows)
        return self.learned_index.search_arrays(q_terms, q_w, cand, allowed_rows=allowed)

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
        with profiling.span("rag.hydrate.wait"):
            rows = rows.cpu().numpy()
            scores = scores.cpu().numpy()
        return [
            {int(r): float(s) for r, s in zip(rows[i], scores[i]) if r >= 0}
            for i in range(rows.shape[0])
        ]

    # -- the encoder-fused path -------------------------------------------------

    def retrieve_batch_submit(self, queries: Sequence[str], k: int,
                              fusion: Optional[FusionStrategy] = None,
                              tag_filter=None):
        """Two-phase retrieval, phase 1: launch the device work and return
        without waiting for results; :meth:`retrieve_batch_collect` fetches,
        patches and hydrates. The split applies on the fused compact path
        (encoder embedder + compact bf16r store, no tag filter), so a
        serving loop can overlap one batch's host patch with the next
        batch's device scan; every other configuration completes inline
        here. Do not mutate the index between submit and collect."""
        from trueno_rag_tpu_torch.models.encoder import EncoderEmbedder

        store = self.vector_store
        splittable = (
            self.config.fused is not False
            and self.config.use_dense and self.config.use_sparse
            and self.learned_index is None
            and tag_filter is None
            and bool(queries)
            and len(self.registry) > 0
            and store._effective_tier() == "compact"
            and store.config.compact_scan == "bf16r"
            and isinstance(self.embedder, EncoderEmbedder)
        )
        if splittable:
            if any(not q.strip() for q in queries):
                raise QueryError("empty query")
            out, ctx = self._fused_compact_submit(queries, k, *self._fused_preamble(queries), fusion, None)
            return ("fused_compact", out, ctx)
        return ("done", self.retrieve_batch(queries, k, fusion=fusion, tag_filter=tag_filter), None)

    def retrieve_batch_collect(self, handle) -> List[List[RetrievalResult]]:
        """Two-phase retrieval, phase 2: the host side of a
        :meth:`retrieve_batch_submit` (fetch, exact patch, hydration)."""
        kind, payload, ctx = handle
        if kind == "done":
            return payload
        return self._fused_compact_collect(payload, ctx)

    def _fused_preamble(self, queries: Sequence[str]):
        """Host half of the fused query: tokenize (the batch padded to a
        power of two with all-PAD rows, as in the JAX package), refresh the
        BM25 snapshot and build the block slot lists (padded queries get
        none) → (token_ids, bids, blo, bhi) on the device. Raises
        QueryError past the block-table BM25 layout."""
        emb = self.embedder
        ids = emb.tokenizer.encode_batch([emb.config.query_prefix + q for q in queries])
        b_pad = 1
        while b_pad < len(queries):
            b_pad *= 2
        if b_pad != ids.shape[0]:
            ids = np.pad(ids, ((0, b_pad - ids.shape[0]), (0, 0)))
        self.sparse_index._refresh_snapshot()
        if self.sparse_index._snap["blocks"] is None:
            raise QueryError(
                "fused path requires the block-table BM25 layout "
                "(corpus rows must stay below 2**24); use the staged path"
            )
        bids, blo, bhi = self.sparse_index.gather_block_tensors(
            list(queries) + ["\0"] * (b_pad - len(queries))
        )
        return torch.from_numpy(ids).to(self.device), bids, blo, bhi

    def retrieve_batch_fused(self, queries: Sequence[str], k: int,
                             fusion: Optional[FusionStrategy] = None,
                             tag_filter=None) -> List[List[RetrievalResult]]:
        """The encoder-fused query path (needs an EncoderEmbedder):
        tokenization and BM25 slot lists on the host, then encoder forward +
        dense scan + BM25 + fusion + top-k on the card
        (:func:`~trueno_rag_tpu_torch.ops.hybrid.fused_hybrid_query`, its
        tagged sibling, or on a compact store
        :func:`~trueno_rag_tpu_torch.ops.hybrid.fused_hybrid_query_compact`)."""
        from trueno_rag_tpu_torch.models.encoder import EncoderEmbedder
        from trueno_rag_tpu_torch.ops.dense import require_fp32

        if not isinstance(self.embedder, EncoderEmbedder):
            raise QueryError("fused path requires an EncoderEmbedder")
        if not queries:
            return []
        if any(not q.strip() for q in queries):
            raise QueryError("empty query")
        if len(self.registry) == 0:
            return [[] for _ in queries]
        pre = self._fused_preamble(queries)
        if self.vector_store.is_compact:
            out, ctx = self._fused_compact_submit(queries, k, *pre, fusion, tag_filter)
            return self._fused_compact_collect(out, ctx)
        require_fp32()
        emb, store = self.embedder, self.vector_store
        token_ids, bids, blo, bhi = pre
        strategy = fusion or self.config.fusion
        kw = dict(
            encoder_config=emb.encoder_config, cand=self.config.candidates_per_source, k=k,
            metric=store.config.metric, fusion_kind=strategy.kind, fusion_param=strategy.device_param,
        )
        blocks = self.sparse_index._snap["blocks"]
        if tag_filter is not None:
            from trueno_rag_tpu_torch.ops.tags import fused_hybrid_query_tagged

            b_pad = token_ids.shape[0]
            masks = tuple(np.pad(m, (0, b_pad - len(queries)))
                          for m in resolve_tag_filters(self.registry, tag_filter, len(queries)))
            out = fused_hybrid_query_tagged(
                emb.params, token_ids, store.device_matrix, store.device_valid,
                store._device_tag_bits(), *self._device_masks(masks), bids, blo, bhi, blocks, **kw,
            )
        else:
            from trueno_rag_tpu_torch.ops.hybrid import fused_hybrid_query

            out = fused_hybrid_query(
                emb.params, token_ids, store.device_matrix, store.device_valid,
                bids, blo, bhi, blocks, **kw,
            )
        f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = out
        return self._hydrate(len(queries), k, f_rows.cpu().numpy(), f_scores.cpu().numpy(),
                             self._score_maps(d_rows, d_scores), self._score_maps(s_rows, s_scores))

    def _fused_compact_submit(self, queries, k, token_ids, bids, blo, bhi, fusion, tag_filter):
        """Device half of the fused compact query: one launch sequence, no
        host sync → (device outputs, ctx) for :meth:`_fused_compact_collect`."""
        from trueno_rag_tpu_torch.ops.hybrid import fused_hybrid_query_compact

        store = self.vector_store
        if tag_filter is not None:
            raise QueryError(
                "the fused compact path does not support tag filters; "
                "use the staged path (fused=None)"
            )
        if store._effective_tier() != "compact" or store.config.compact_scan != "bf16r":
            # the fused compact query takes the six bf16r replica arrays in
            # row order; other layouts would misalign them
            raise QueryError(
                "the fused compact path requires scan_tier='compact' with "
                f"compact_scan='bf16r' (store has {store._effective_tier()!r}, "
                f"{store.config.compact_scan!r}); use the staged path (fused=None)"
            )
        store._refresh_device()  # materialize the compact replicas
        cand = self.config.candidates_per_source
        strategy = fusion or self.config.fusion
        out = fused_hybrid_query_compact(
            self.embedder.params, token_ids, *store._tier, store._device_valid, bids, blo, bhi,
            self.sparse_index._snap["blocks"], encoder_config=self.embedder.encoder_config,
            cand=cand, k=k, metric=store.config.metric, fusion_kind=strategy.kind,
            fusion_param=strategy.device_param, tile_n=store.config.scan_tile_n,
        )
        return out, (list(queries), k, cand, strategy)

    def _fused_compact_collect(self, out, ctx) -> List[List[RetrievalResult]]:
        """Host half of the fused compact query: fetch, the store's staged
        exact patch of uncertified queries (candidate containment → widened
        retry → host GEMM, using the query's own encoder outputs), host
        re-fusion of only the patched queries, hydration."""
        queries, k, cand, strategy = ctx
        store = self.vector_store
        (f_rows, f_scores, d_rows, d_scores, s_rows, s_scores, ok, cand_rows, thr, qvecs) = out
        b = len(queries)
        f_rows, f_scores = f_rows.cpu().numpy().copy(), f_scores.cpu().numpy().copy()
        ok_np = ok.cpu().numpy()[:b]
        d_maps = self._score_maps(d_rows, d_scores)
        s_maps = self._score_maps(s_rows, s_scores)
        if not ok_np.all():
            store.compact_uncertified += int((~ok_np).sum())
            ok_pad = np.concatenate([ok_np, np.ones(d_rows.shape[0] - b, bool)])
            d_s, d_r = store._compact_exact_patch(
                qvecs, d_scores.cpu().numpy(), d_rows.cpu().numpy(), ok_pad, cand,
                cand_rows.cpu().numpy(), thr.cpu().numpy(), None,
                containment_retry=store.config.compact_retry is not False,
            )
            store.tier_fallbacks += 1
            s_r, s_s = s_rows.cpu().numpy(), s_scores.cpu().numpy()
            for qi in np.flatnonzero(~ok_np):
                # the host fusion oracle over the exact dense list and the
                # device BM25 list
                dense_list = [(int(r), float(x)) for r, x in zip(d_r[qi], d_s[qi]) if r >= 0]
                sparse_list = [(int(r), float(x)) for r, x in zip(s_r[qi], s_s[qi]) if r >= 0]
                fused = strategy.fuse(dense_list, sparse_list)[:k]
                f_rows[qi, :] = -1
                f_scores[qi, :] = float("-inf")
                for j, (rid, sc) in enumerate(fused):
                    f_rows[qi, j] = rid
                    f_scores[qi, j] = sc
                d_maps[qi] = dict(dense_list)
        return self._hydrate(b, k, f_rows, f_scores, d_maps, s_maps)

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


# ---------------------------------------------------------------------------
# Single-source conveniences
# ---------------------------------------------------------------------------


class DenseRetriever:
    """Vector-only retriever over its own :class:`VectorStore` on
    ``device`` (default: the card)."""

    def __init__(self, embedder: Embedder, vector_config: Optional[VectorStoreConfig] = None,
                 device=None) -> None:
        self.embedder = embedder
        self.store = VectorStore(vector_config or VectorStoreConfig(dimension=embedder.dimension),
                                 device=device)

    def index(self, chunk: Chunk) -> None:
        self.store.insert(chunk)

    def index_batch(self, chunks: Sequence[Chunk]) -> None:
        self.store.insert_many(chunks)

    def retrieve(self, query: str, k: int) -> List[RetrievalResult]:
        qvec = self.embedder.embed_query(query)
        return [
            RetrievalResult(chunk=self.store.get(cid), dense_score=s)
            for cid, s in self.store.search(qvec, k)
        ]

    def __len__(self) -> int:
        return len(self.store)


class SparseRetriever:
    """BM25-only retriever with its own chunk registry, so sparse-only
    deployments work standalone; the index lives on ``device`` (default:
    the card)."""

    def __init__(self, device=None) -> None:
        self.index_ = BM25Index(device=device)

    def index(self, chunk: Chunk) -> None:
        self.index_.add(chunk)

    def index_batch(self, chunks: Sequence[Chunk]) -> None:
        self.index_.add_batch(chunks)

    def retrieve(self, query: str, k: int) -> List[RetrievalResult]:
        return [
            RetrievalResult(chunk=self.index_.registry.get_chunk(cid), sparse_score=s)
            for cid, s in self.index_.search(query, k)
        ]

    def __len__(self) -> int:
        return len(self.index_)
