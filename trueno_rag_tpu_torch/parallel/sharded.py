"""Corpus-sharded dense retrieval: a local top-k per shard, then a merge.

PyTorch counterpart of ``trueno_rag_tpu/parallel/sharded.py``. The
``[N, d]`` matrix shards row-wise over the mesh's ``data`` axis; a query
batch is replicated; each shard scores its rows and keeps a local top-k;
the ``k·s`` candidates gather on the mesh's first device and a final
top-k gives the exact global result (the global top-k is a subset of the
union of the local ones).

The shard-local step is the single-card exact path's:
``similarity_scores`` (fp32, TF32 off), then the best ``2k`` rows
re-ranked by the float64 dot rounded once (``ops.dense.topk_masked``), so
a sharded answer reports the scores of ``dense_topk``. Every selection is
``topk_desc``, and shards concatenate in row order, so ties keep (score
desc, global row asc).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import NEG_INF, _pad_k, require_fp32, similarity_scores, topk_desc, topk_masked
from trueno_rag_tpu_torch.ops.tags import tag_pred
from trueno_rag_tpu_torch.parallel.ingest import _check_blocks, _to_device
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded, all_gather

INT32_MAX = torch.iinfo(torch.int32).max


def as_queries(queries) -> torch.Tensor:
    """A ``[B, d]`` f32 query tensor from numpy, a list or a tensor."""
    if isinstance(queries, torch.Tensor):
        return torch.atleast_2d(queries.float())
    return torch.from_numpy(np.atleast_2d(np.asarray(queries, dtype=np.float32)))


def global_rows(r_loc: torch.Tensor, shard: int, rps: int) -> torch.Tensor:
    """Shard-local rows (-1 = none) → global row ids, ``INT32_MAX`` in
    empty slots (what :func:`merge_local_topk` expects)."""
    return torch.where(r_loc >= 0, r_loc.to(torch.int64) + shard * rps, INT32_MAX).to(torch.int32)


def merge_local_topk(s_loc: Sequence[torch.Tensor], r_glob: Sequence[torch.Tensor], k: int, mesh: Mesh):
    """Merge each shard's local top-k into the global top-k → ``(scores
    [B,k], rows [B,k] int32, -1 invalid)`` on the mesh's first device.
    ``r_glob`` carries GLOBAL row ids with ``INT32_MAX`` in empty slots.
    Shared by the dense, BM25, learned-sparse and MaxSim sharded paths (the
    bounded-candidate form is ``parallel.compact.merge_bounded_candidates``)."""
    s_all = all_gather(s_loc, mesh)  # [B, k·s]
    r_all = all_gather(r_glob, mesh)
    k_out = min(k, s_all.shape[1])
    s_top, idx = topk_desc(s_all, k_out)
    r_top = torch.gather(r_all, 1, idx)
    r_top = torch.where(torch.isneginf(s_top), -1, r_top).to(torch.int32)
    return _pad_k(s_top, r_top, k)


def _local_dense(q, m, v, k: int, metric: str, tag_words=None):
    """One shard's exact top-k → (scores, local rows)."""
    scores = similarity_scores(q, m, metric)
    allowed = v[None, :]
    if tag_words is not None:
        bits, ta, ty, tn = tag_words
        allowed = allowed & tag_pred(bits[None, :], ta[:, None], ty[:, None], tn[:, None])
    return topk_masked(q, m, torch.where(allowed, scores, NEG_INF), min(k, m.shape[0]), metric)


def _sharded_dense(queries, matrix: RowSharded, valid_mask: RowSharded, k, mesh, metric, axis, tags=None):
    require_fp32()
    q = as_queries(queries)
    rps = matrix.rows_per_shard
    s_loc, r_glob = [], []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        tag_words = None if tags is None else (tags[0].shards[i], *tag_words_on(tags[1:], dev))
        s, r = _local_dense(q.to(dev), matrix.shards[i], valid_mask.shards[i], k, metric, tag_words)
        s_loc.append(s)
        r_glob.append(global_rows(r, i, rps))
    return merge_local_topk(s_loc, r_glob, k, mesh)


def sharded_dense_topk(
    queries,
    matrix: RowSharded,
    valid_mask: RowSharded,
    k: int,
    mesh: Mesh,
    metric: str = "cosine",
    axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a row-sharded corpus: ``queries [B, d]``
    (replicated), ``matrix [N, d]`` and ``valid_mask [N]`` row-sharded →
    ``(scores [B,k], rows [B,k])`` with GLOBAL row ids, on the mesh's first
    device."""
    return _sharded_dense(queries, matrix, valid_mask, k, mesh, metric, axis)


def sharded_dense_topk_tagged(
    queries,
    matrix: RowSharded,
    valid_mask: RowSharded,
    tag_bits: RowSharded,  # [N] int32, sharded with the rows
    t_all,  # [B] replicated
    t_any,
    t_none,
    k: int,
    mesh: Mesh,
    metric: str = "cosine",
    axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tag-filtered sibling of :func:`sharded_dense_topk`: the predicate
    evaluates on each shard's own tag slice, so filtering adds nothing to
    the merge."""
    return _sharded_dense(queries, matrix, valid_mask, k, mesh, metric, axis, (tag_bits, t_all, t_any, t_none))


def _normalized(block: np.ndarray, metric: str, rows_normalized: bool) -> np.ndarray:
    if metric == "cosine" and not rows_normalized:
        norms = np.linalg.norm(block, axis=1, keepdims=True)
        return block / np.where(norms == 0.0, 1.0, norms)
    return block


def _padded(block: np.ndarray, rows: int, fill=0) -> np.ndarray:
    if block.shape[0] == rows:
        return block
    return np.pad(block, ((0, rows - block.shape[0]),) + ((0, 0),) * (block.ndim - 1), constant_values=fill)


class ShardedVectorIndex:
    """A read-optimized, corpus-sharded dense index.

    Built once from a host matrix (a :class:`VectorStore` snapshot or a
    loaded artifact); rows pad up to a multiple of the data-axis size and
    shard across the mesh, one block at a time. Query batches return the
    exact global top-k. :meth:`update_rows` scatters changed rows into the
    owning shards; capacity growth means a rebuild."""

    def __init__(
        self,
        matrix: np.ndarray,
        mesh: Mesh,
        metric: str = "cosine",
        valid: Optional[np.ndarray] = None,
        axis: str = "data",
        rows_normalized: bool = False,
        tags: Optional[np.ndarray] = None,
    ) -> None:
        matrix = np.asarray(matrix, dtype=np.float32)
        n = matrix.shape[0]
        s = mesh.shape[axis]
        rps = max(-(-n // s), 1)
        v = np.zeros(rps * s, dtype=bool)
        v[:n] = True if valid is None else np.asarray(valid, dtype=bool)[:n]
        t = np.zeros(rps * s, dtype=np.int32)
        if tags is not None:
            t[:n] = np.asarray(tags, dtype=np.int32)[:n]
        # normalization skipped for rows a VectorStore normalized at insert:
        # a second one moves values by an ulp and reorders near-ties
        blocks = (_padded(_normalized(matrix[i * rps:(i + 1) * rps], metric, rows_normalized), rps)
                  for i in range(s))
        self._init(n, metric, mesh, axis, blocks, np.split(v, s), np.split(t, s))

    def _init(self, n, metric, mesh, axis, blocks, valid_blocks, tag_blocks) -> None:
        self.n, self.metric, self.mesh, self.axis = n, metric, mesh, axis
        devs = mesh.axis_devices(axis)
        self.matrix = RowSharded([_to_device(b, dev) for b, dev in zip(blocks, devs)], mesh, axis)
        self.valid = RowSharded([_to_device(b, dev) for b, dev in zip(valid_blocks, devs)], mesh, axis)
        self.tags = RowSharded([_to_device(b, dev) for b, dev in zip(tag_blocks, devs)], mesh, axis)

    @classmethod
    def from_shard_matrices(
        cls,
        blocks,
        mesh: Mesh,
        metric: str = "cosine",
        valids=None,
        axis: str = "data",
        rows_normalized: bool = False,
        tags=None,
    ) -> "ShardedVectorIndex":
        """Multi-host ingest: build from per-host row blocks, the full
        ``[N, d]`` matrix never on one host. ``blocks[i]`` is shard ``i``'s
        ``[rps_i, d]`` f32 rows, owning global rows ``[i·rps, i·rps +
        rps_i)`` with ``rps = max rps_i``; shorter blocks pad with invalid
        rows. ``valids``/``tags`` are optional per-shard ``[rps_i]`` masks
        and int32 words. Answers equal a build from the concatenated
        matrix."""
        s = _check_blocks(len(blocks), mesh, axis)
        d = np.asarray(blocks[0]).shape[1]
        rps = max(np.asarray(blk).shape[0] for blk in blocks)
        n = sum(np.asarray(blk).shape[0] for blk in blocks)
        v_blocks, t_blocks = [], []
        for i, blk in enumerate(blocks):
            n_i, d_i = np.asarray(blk).shape
            if d_i != d:
                raise InvalidConfigError(f"shard {i} has dimension {d_i}, expected {d}")
            v = np.zeros(rps, dtype=bool)
            v[:n_i] = True if valids is None else np.asarray(valids[i], dtype=bool)[:n_i]
            t = np.zeros(rps, dtype=np.int32)
            if tags is not None:
                t[:n_i] = np.asarray(tags[i], dtype=np.int32)[:n_i]
            v_blocks.append(v)
            t_blocks.append(t)
        self = cls.__new__(cls)
        mats = (_padded(_normalized(np.asarray(blk, dtype=np.float32), metric, rows_normalized), rps)
                for blk in blocks)
        self._init(n, metric, mesh, axis, mats, v_blocks, t_blocks)
        return self

    def search(self, queries, k: int, tag_masks=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ ``(scores [B,k], rows [B,k])``. ``tag_masks``: optional
        ``(t_all, t_any, t_none)`` int32 arrays of length B."""
        if tag_masks is not None:
            return sharded_dense_topk_tagged(queries, self.matrix, self.valid, self.tags, *tag_masks, k,
                                             self.mesh, self.metric, self.axis)
        return sharded_dense_topk(queries, self.matrix, self.valid, k, self.mesh, self.metric, self.axis)

    def update_rows(
        self,
        rows: np.ndarray,
        vectors: np.ndarray,
        valid: Optional[np.ndarray] = None,
        rows_normalized: bool = False,
        tags: Optional[np.ndarray] = None,
    ) -> None:
        """Incremental refresh: write changed rows into the shards that own
        them, in place. Rows must fit the existing padded capacity —
        capacity growth means a rebuild."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        n_pad = self.matrix.shape[0]
        if int(rows.max()) >= n_pad:
            raise InvalidConfigError(f"row {int(rows.max())} exceeds sharded capacity {n_pad}; rebuild")
        vectors = _normalized(np.asarray(vectors, dtype=np.float32), self.metric, rows_normalized)
        v_flags = np.ones(len(rows), dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
        t_words = None if tags is None else np.asarray(tags, dtype=np.int32)
        rps = self.matrix.rows_per_shard
        for i, dev in enumerate(self.mesh.axis_devices(self.axis)):
            mine = np.flatnonzero(rows // rps == i)
            if not len(mine):
                continue
            local = torch.from_numpy(rows[mine] - i * rps).to(dev)
            self.matrix.shards[i][local] = torch.from_numpy(vectors[mine]).to(dev)
            self.valid.shards[i][local] = torch.from_numpy(v_flags[mine]).to(dev)
            if t_words is not None:
                self.tags.shards[i][local] = torch.from_numpy(t_words[mine]).to(dev)
        self.n = max(self.n, int(rows.max()) + 1)


def tag_words_on(tag_masks, dev) -> Optional[List[torch.Tensor]]:
    """Per-query ``(t_all, t_any, t_none)`` words as int32 tensors on
    ``dev`` (None passes through)."""
    if tag_masks is None:
        return None
    return [torch.as_tensor(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, np.int32)).to(dev)
            for t in tag_masks]
