"""Sharded hybrid serving: sharded dense + sharded sparse + fusion.

PyTorch counterpart of ``trueno_rag_tpu/parallel/hybrid.py``: a hybrid
(dense + BM25, optionally + learned sparse) index whose memory scales as
total/s per device on every side. The ``[N, d]`` matrix shards row-wise;
the BM25 postings shard by DOCUMENT over the same row partition
(``parallel/sparse.py``). Query plan per batch:

  dense:   replicated queries → per-shard scan → local top-k → merge;
           ``dense_mode`` "fp32" (exact), "compact" (certified sets,
           bf16rr when the store's ``compact_scan`` is) or "clustered"
           (certified sets over pruned scans); the host patch makes every
           compact or clustered answer exact
  sparse:  per-shard BM25 over the shard's own postings → the same merge
           (``sparse_mode="sharded"``), or the single-host index
           (``"replicated"``)
  learned: the retriever's learned-sparse source (when
           ``config.use_learned``), sharded by document
  fuse:    any fusion strategy over the candidate lists (N-way with the
           learned source)

Built from a :class:`~trueno_rag_tpu_torch.retrieve.HybridRetriever`
snapshot or from shard builds; serving-oriented: mutate the single-host
retriever, then :meth:`ShardedHybridIndex.refresh`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.ops.fusion import fuse_topk, fuse_topk_many
from trueno_rag_tpu_torch.ops.tags import filter_candidates_by_tags
from trueno_rag_tpu_torch.parallel.mesh import Mesh, shard_rows
from trueno_rag_tpu_torch.parallel.sharded import ShardedVectorIndex, tag_words_on
from trueno_rag_tpu_torch.parallel.sparse import ShardedBM25, ShardedLearnedSparse
from trueno_rag_tpu_torch.retrieve import RetrievalResult


class ShardedHybridIndex:
    """Read-optimized multi-device hybrid index."""

    def __init__(
        self,
        retriever,
        mesh: Mesh,
        fusion: Optional[FusionStrategy] = None,
        candidates_per_source: Optional[int] = None,
        sparse_mode: str = "sharded",
        dense_mode: str = "fp32",
    ) -> None:
        if sparse_mode not in ("sharded", "replicated"):
            raise InvalidConfigError(f"unknown sparse_mode {sparse_mode!r}")
        if dense_mode not in ("fp32", "compact", "clustered"):
            raise InvalidConfigError(f"unknown dense_mode {dense_mode!r}")
        self.dense_mode = dense_mode
        self.sparse_mode = sparse_mode
        self.mesh = mesh
        self.registry = retriever.registry
        self.embedder = retriever.embedder
        self.fusion = fusion or retriever.config.fusion
        self.candidates = candidates_per_source or retriever.config.candidates_per_source
        self._store = retriever.vector_store
        self.dense = self._build_dense()
        self._tags_version_seen = self.registry.tags_version
        self._rep_tags = None
        self._bm25 = retriever.sparse_index
        self.sparse = ShardedBM25(self._bm25, mesh) if sparse_mode == "sharded" else None
        # the learned third source, gated on config.use_learned as the
        # single-host retrieve_batch gates it (else the mesh would fuse three
        # lists where the host fuses two)
        self.learned = None
        self.learned_encoder = None
        self._learned_index = retriever.learned_index if retriever.config.use_learned else None
        if self._learned_index is not None and len(self._learned_index) > 0:
            self.learned = ShardedLearnedSparse(self._learned_index, mesh)
            self.learned_encoder = retriever.learned_encoder

    def _build_dense(self):
        store = self._store
        host = store._host
        tags = self.registry.tags_host(host.shape[0])
        kw = dict(metric=store.config.metric, valid=store._valid, rows_normalized=True, tags=tags)  # normalized at insert
        if self.dense_mode == "compact":
            from trueno_rag_tpu_torch.parallel.compact import ShardedCompactIndex

            # the store's compact layout: bf16rr shards as such; the
            # single-card bf16/int8 layouts have no sharded scan and compose as bf16r
            return ShardedCompactIndex(host, self.mesh, layout="bf16rr" if store.config.compact_scan == "bf16rr"
                                       else "bf16r", **kw)
        if self.dense_mode == "clustered":
            from trueno_rag_tpu_torch.parallel.clustered import ShardedClusteredIndex

            return ShardedClusteredIndex(host, self.mesh, tile_n=max(store.config.scan_tile_n, 1024),
                                         probe_tiles=store.config.cluster_probe_tiles,
                                         fetch=store.config.cluster_fetch, **kw)
        return ShardedVectorIndex(host, self.mesh, **kw)

    @classmethod
    def from_shard_builds(
        cls,
        embedder,
        dense_blocks: Sequence[np.ndarray],
        sparse_builds: Sequence[object],
        mesh: Mesh,
        chunks_per_shard: Optional[Sequence[Sequence[object]]] = None,
        fusion: Optional[FusionStrategy] = None,
        candidates_per_source: Optional[int] = None,
        axis: str = "data",
        k1: float = 1.2,
        b: float = 0.75,
        rows_normalized: bool = False,
        stopwords=None,
        min_token_len: int = 2,
    ) -> "ShardedHybridIndex":
        """Multi-host ingest: assemble the serving index from per-host
        artifacts — shard ``i``'s embedding block ``dense_blocks[i]`` ([n_i,
        d] f32), its BM25 :class:`~trueno_rag_tpu_torch.parallel.ingest.ShardBuild`
        (or ``to_payload()`` dict) and optionally its chunks. Shard ``i``'s
        documents occupy global rows ``[i·rps, i·rps + n_i)`` with ``rps =
        max n_i``; every shard but the last must be full, so registry rows
        stay dense. Immutable: :meth:`refresh` raises."""
        from trueno_rag_tpu_torch.index.base import ChunkRegistry
        from trueno_rag_tpu_torch.retrieve import HybridRetrieverConfig

        s = mesh.shape[axis]
        if len(dense_blocks) != s or len(sparse_builds) != s:
            raise InvalidConfigError(f"need exactly {s} dense blocks and sparse builds for a {s}-shard '{axis}' axis")
        dense_blocks = [np.asarray(blk, dtype=np.float32) for blk in dense_blocks]
        sizes = [blk.shape[0] for blk in dense_blocks]
        rps = max(sizes)
        for i, n_i in enumerate(sizes[:-1]):
            if n_i != rps:
                raise InvalidConfigError(
                    f"shard {i} has {n_i} rows but shard capacity is {rps}; only the LAST shard may be partial "
                    "(registry rows must stay dense)"
                )
        cfg = HybridRetrieverConfig()
        self = cls.__new__(cls)
        self.dense_mode = "fp32"
        self.sparse_mode = "sharded"
        self.mesh = mesh
        self.embedder = embedder
        self.fusion = fusion or cfg.fusion
        self.candidates = candidates_per_source or cfg.candidates_per_source
        self._store = None
        self._bm25 = None
        self._rep_tags = None
        self.learned = None
        self.learned_encoder = None
        self._learned_index = None
        self.registry = ChunkRegistry()
        if chunks_per_shard is not None:
            if len(chunks_per_shard) != s:
                raise InvalidConfigError(f"got {len(chunks_per_shard)} chunk lists for {s} shards")
            for i, (cs, n_i) in enumerate(zip(chunks_per_shard, sizes)):
                if len(cs) != n_i:
                    raise InvalidConfigError(f"shard {i} has {len(cs)} chunks but {n_i} dense rows")
            self.registry.add_batch([c for cs in chunks_per_shard for c in cs])
        tags_host = self.registry.tags_host(max(rps * s, 1))
        self.dense = ShardedVectorIndex.from_shard_matrices(
            dense_blocks, mesh, metric="cosine", axis=axis, rows_normalized=rows_normalized,
            tags=[tags_host[i * rps:i * rps + n_i] for i, n_i in enumerate(sizes)],
        )
        self.sparse = ShardedBM25.from_shard_builds(sparse_builds, mesh, axis=axis, k1=k1, b=b, stopwords=stopwords,
                                                    min_token_len=min_token_len, rows_per_shard=rps)
        self._tags_version_seen = self.registry.tags_version
        return self

    def refresh(self, rows: Optional[Sequence[int]] = None) -> None:
        """Propagate retriever mutations to the sharded replicas.

        ``rows``: the chunk rows that changed since the last build or
        refresh. On the fp32 shards just those rows are written into their
        owning shards; ``rows=None``, rows past the sharded capacity, and the
        compact and clustered modes rebuild the dense shards. The sparse
        shards re-derive either way (their CSR shifts on any posting
        change)."""
        if self._store is None:
            raise InvalidConfigError(
                "this index was assembled from shard builds (multi-host ingest) and is immutable — "
                "rebuild from new shard builds"
            )
        host = self._store._host
        if rows is not None:
            rows = np.asarray(sorted(set(int(r) for r in rows)), dtype=np.int64)
        if rows is None or rows.size:
            if (self.dense_mode != "fp32" or rows is None
                    or int(rows.max()) >= self.dense.matrix.shape[0]):
                self.dense = self._build_dense()
            else:
                self.dense.update_rows(rows, host[rows], self._store._valid[rows], rows_normalized=True,
                                       tags=self.registry.tags_host(host.shape[0])[rows])
            self._rep_tags = None
            self._tags_version_seen = self.registry.tags_version
        if self.sparse_mode == "sharded":
            self.sparse = ShardedBM25(self._bm25, self.mesh)
        if self._learned_index is not None and len(self._learned_index) > 0:
            self.learned = ShardedLearnedSparse(self._learned_index, self.mesh)

    def _refresh_tags_if_stale(self) -> None:
        """Tag edits since the last build or refresh re-upload the tag words
        once (keyed by the registry's version), so filtered searches never
        ship O(N) masks per batch."""
        if self.registry.tags_version == self._tags_version_seen:
            return
        if self.dense_mode in ("compact", "clustered"):
            self.dense.set_tags(self.registry.tags_host(self._store._host.shape[0]))
        else:
            self.dense.tags = shard_rows(self.registry.tags_host(self.dense.matrix.shape[0]), self.mesh,
                                         self.dense.axis)
        self._rep_tags = None
        self._tags_version_seen = self.registry.tags_version

    def _replicated_tags(self) -> torch.Tensor:
        """Per-row tag words on the mesh's first device, for the sparse
        candidate filter (cached; candidates carry GLOBAL rows)."""
        if self._rep_tags is None:
            self._rep_tags = torch.from_numpy(
                self.registry.tags_host(max(self.registry.capacity_rows, 1))).to(self.mesh.lead)
        return self._rep_tags

    def _filtered(self, rows, scores, masks):
        """Drop candidates failing the filter (after their top-k, as the
        single-host BM25 path does)."""
        if masks is None:
            return rows, scores
        return filter_candidates_by_tags(rows, scores, self._replicated_tags(), *tag_words_on(masks, self.mesh.lead))

    def search_arrays(self, queries: Sequence[str], k: int, tag_filter=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched hybrid search → global ``(rows, scores) [B, k]`` on the
        mesh's first device. ``tag_filter``: a TagFilter (or one per query);
        the dense predicate evaluates shard-locally, sparse candidates
        filter before fusion."""
        cand = self.candidates
        lead = self.mesh.lead
        qvecs = np.asarray(self.embedder.embed_queries(list(queries)), dtype=np.float32)
        masks = None
        if tag_filter is not None:
            from trueno_rag_tpu_torch.retrieve import resolve_tag_filters

            self._refresh_tags_if_stale()
            masks = resolve_tag_filters(self.registry, tag_filter, len(queries))
        d_scores, d_rows = self.dense.search(qvecs, cand, tag_masks=masks)[:2]  # host patch per keep_host
        if self.sparse is not None:
            s_scores, s_rows = self.sparse.search_arrays(list(queries), cand)
        else:
            s_scores, s_rows = (x.to(lead) for x in self._bm25.search_arrays(list(queries), cand))
        s_rows, s_scores = self._filtered(s_rows, s_scores, masks)
        if self.learned is not None:
            # tri-hybrid: expand once on the host, score the document-sharded
            # postings, merge, fuse the three lists N-way. Filters drop
            # disallowed learned candidates after their top-k (the BM25
            # treatment; the single-host path filters inside the op, so
            # selective filters can differ in the tail)
            l_scores, l_rows = self.learned.search_arrays(*self.learned_encoder.expand_queries(list(queries)), cand)
            l_rows, l_scores = self._filtered(l_rows, l_scores, masks)
            weights = (tuple(self.fusion.resolve_weights(3)) if self.fusion.kind in ("linear", "convex") else ())
            f_rows, f_scores = fuse_topk_many((d_rows, s_rows, l_rows), (d_scores, s_scores, l_scores),
                                              kind=self.fusion.kind, param=self.fusion.device_param, weights=weights)
        else:
            f_rows, f_scores = fuse_topk(d_rows, d_scores, s_rows, s_scores, kind=self.fusion.kind,
                                         param=self.fusion.device_param)
        return f_rows[:, :k], f_scores[:, :k]

    def search(self, query: str, k: int, tag_filter=None) -> List[RetrievalResult]:
        rows, scores = self.search_arrays([query], k, tag_filter=tag_filter)
        out: List[RetrievalResult] = []
        for row, score in zip(rows[0].cpu().numpy(), scores[0].cpu().numpy()):
            if row < 0:
                continue
            chunk = self.registry.chunk_of(int(row))
            if chunk is not None:
                out.append(RetrievalResult(chunk=chunk, fused_score=float(score)))
        return out
