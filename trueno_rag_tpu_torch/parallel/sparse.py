"""Document-sharded BM25 and learned sparse: shard-local candidate scoring
and the merge.

PyTorch counterpart of ``trueno_rag_tpu/parallel/sparse.py``:

- **Document-sharded**: shard ``i`` owns every posting whose row lies in
  ``[i·rps, (i+1)·rps)``, the dense shards' partition, so hybrid serving
  keeps one row space and each device holds its share of the postings.
- **Exact**: a document's postings all live on its shard, so a
  shard-local sum is its complete score. BM25's global statistics (df →
  idf, avgdl) are taken once over the whole corpus and baked into the
  per-posting contributions (``ops.bm25.pack_posting_blocks``), as in the
  single-host snapshot: every shard table entry equals the single-host
  table's for the same posting. The candidate tail's f32 prefix sum runs
  over the shard's own panel, so a score can differ from the single-host
  panel's by the prefix's rounding (ROADMAP "BM25 rounding").
- **Merge**: each shard's local top-k (global rows) goes through
  ``parallel.sharded.merge_local_topk``; ties stay (score desc, row asc).

Both candidate tails go through ``ops.bm25._row_cumsum``, so a query
answers alike alone or in a batch on the card.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.bm25 import (
    BLOCK_LEN,
    bm25_topk_blocks,
    bucket_len,
    pack_posting_blocks,
    pack_weighted_blocks,
    weighted_topk_blocks,
)
from trueno_rag_tpu_torch.parallel.ingest import ShardBuild, merge_shard_stats
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded
from trueno_rag_tpu_torch.parallel.sharded import global_rows, merge_local_topk
from trueno_rag_tpu_torch.text import STOPWORDS, tokenize

_PANEL_LANES = 1 << 25  # learned candidate lanes (queries x slots x BLOCK_LEN) per device call


def _term_of(indptr: np.ndarray, n_postings: int) -> np.ndarray:
    """The term id of every posting of a CSR."""
    counts = np.maximum(np.diff(indptr), 0)
    if int(counts.sum()) != n_postings:  # degenerate empty-index shapes
        return np.zeros(n_postings, dtype=np.int64)
    return np.repeat(np.arange(len(counts), dtype=np.int64), counts)


def _split_by_row(rows: np.ndarray, term_of: np.ndarray, n_terms: int, s: int, rps: int):
    """Per shard: ``(mask of its postings, local rows, term ids, local
    indptr)``; within a term the postings keep their (row-ascending)
    order."""
    for i in range(s):
        m = (rows >= i * rps) & (rows < (i + 1) * rps)
        to_s = term_of[m]
        ip = np.zeros(n_terms + 1, dtype=np.int64)
        if n_terms:
            np.cumsum(np.bincount(to_s, minlength=n_terms), out=ip[1:])
        yield m, rows[m] - i * rps, to_s, ip


def _slots(t_lo: np.ndarray, t_hi: np.ndarray, weights: Optional[np.ndarray] = None):
    """Term runs ``[s, B, T]`` (``t_hi <= t_lo``: nothing on that shard) →
    BLOCK_LEN-aligned slots ``(block, lo, hi[, weight])``, each ``[s, B,
    S]``: per query in its term order, each run's blocks ascending, S the
    power-of-two bucket (at least 64) of the longest list over every shard
    and query; padding slots are ``(0, 0, 0)``, an empty lane mask."""
    s, b, t = t_lo.shape
    b_lo = t_lo // BLOCK_LEN
    nblk = np.where(t_hi > t_lo, (t_hi - 1) // BLOCK_LEN - b_lo + 1, 0)
    S = bucket_len(max(1, int(nblk.sum(axis=2).max(initial=0))), minimum=64)
    out = [np.zeros((s * b, S), dtype=np.int32) for _ in range(3)]
    w_out = np.zeros((s * b, S), dtype=np.float32)
    flat = nblk.reshape(-1)
    total = int(flat.sum())
    if total:
        rep = np.repeat(np.arange(flat.size), flat)  # (shard, query, term) of every slot
        j = np.arange(total) - (np.cumsum(flat) - flat)[rep]  # block within its run
        row = rep // t
        slot = (np.cumsum(nblk, axis=2) - nblk).reshape(-1)[rep] + j
        blk = b_lo.reshape(-1)[rep] + j
        base = blk * BLOCK_LEN
        out[0][row, slot] = blk
        out[1][row, slot] = np.maximum(t_lo.reshape(-1)[rep] - base, 0)
        out[2][row, slot] = np.minimum(t_hi.reshape(-1)[rep] - base, BLOCK_LEN)
        if weights is not None:
            w_out[row, slot] = np.broadcast_to(weights, (s, b, t)).reshape(-1)[rep]
    out = [x.reshape(s, b, S) for x in out]
    return tuple(out) if weights is None else (*out, w_out.reshape(s, b, S))


def _runs(indptrs: np.ndarray, tids: np.ndarray):
    """Per-shard CSR runs ``[s, B, T]`` of term ids ``tids [B, T]`` (-1 =
    none) over the stacked local indptrs ``[s, G+1]``."""
    safe = np.clip(tids, 0, None)
    t_lo = np.where(tids >= 0, indptrs[:, safe], 0)
    t_hi = np.where(tids >= 0, indptrs[:, safe + 1], 0)
    return t_lo, t_hi


class ShardedBM25:
    """Read-optimized document-sharded BM25 built from a
    :class:`~trueno_rag_tpu_torch.index.bm25.BM25Index`'s host CSR."""

    def __init__(self, bm25_index, mesh: Mesh, axis: str = "data") -> None:
        self.mesh = mesh
        self.axis = axis
        self._k1 = bm25_index.k1
        self._b = bm25_index.b
        self._tokenize = bm25_index._tokenize
        vocab, indptr, rows, tfs, idf, doc_len, n_rows = bm25_index._csr()
        self.vocab = vocab
        p = int(indptr[-1])
        rows, tfs = rows[:p], tfs[:p]
        avgdl = np.float32(bm25_index.avg_doc_length)  # as the single-host snapshot takes it

        s = mesh.shape[axis]
        self.n_shards = s
        self.rows_per_shard = rps = max(-(-n_rows // s), 1)
        n_terms = len(indptr) - 1
        dl_pad = np.zeros(rps * s, dtype=np.float32)
        dl_pad[:len(doc_len)] = doc_len[:rps * s]
        self.indptrs: List[np.ndarray] = []
        tables = []
        for i, (m, r_s, to_s, ip) in enumerate(_split_by_row(rows, _term_of(indptr, p), n_terms, s, rps)):
            self.indptrs.append(ip)
            # global idf/avgdl and the row's true doc_len: the single-host contribution
            tables.append(pack_posting_blocks(r_s, tfs[m], dl_pad[i * rps:(i + 1) * rps], idf, to_s, avgdl,
                                              k1=self._k1, b=self._b))
        self._place_tables(tables)
        self.total_postings = p

    def _place_tables(self, tables: Sequence[np.ndarray]) -> None:
        """Pad the per-shard block tables to a common block count and copy
        each to its shard's device as ``[1, NB, 2, BLOCK_LEN]`` (the stacked
        table never exists on the host)."""
        nb_max = max(t.shape[0] for t in tables)
        shards = []
        for t, dev in zip(tables, self.mesh.axis_devices(self.axis)):
            pad = np.zeros((nb_max - t.shape[0], 2, BLOCK_LEN), np.float32)
            shards.append(torch.from_numpy(np.concatenate([t, pad])[None]).to(dev))
        self.blocks = RowSharded(shards, self.mesh, self.axis)
        self.max_shard_postings = int(max((ip[-1] for ip in self.indptrs), default=0))
        stacked = np.stack(self.indptrs)  # [s, G+1]; one more end column keeps term 0's run in range at G = 0
        self._stacked_indptrs = np.concatenate([stacked, stacked[:, -1:]], axis=1)

    @classmethod
    def from_shard_builds(
        cls,
        builds: Sequence[object],
        mesh: Mesh,
        axis: str = "data",
        k1: float = 1.2,
        b: float = 0.75,
        stopwords=None,
        min_token_len: int = 2,
        rows_per_shard: Optional[int] = None,
    ) -> "ShardedBM25":
        """Multi-host ingest: assemble the sharded index from per-host
        :class:`~trueno_rag_tpu_torch.parallel.ingest.ShardBuild`s (or their
        ``to_payload()`` dicts, either package's). ``builds[i]`` owns global
        rows ``[i·rps, i·rps + builds[i].n_rows)`` with ``rps =
        rows_per_shard or max(n_rows)``; global df/avgdl/idf come from
        :func:`~trueno_rag_tpu_torch.parallel.ingest.merge_shard_stats`, so
        the shard tables equal a single-host build's over the same
        partition. ``k1``/``b`` and the tokenizer settings must match the
        shards' build."""
        builds = [ShardBuild.from_payload(bd) if isinstance(bd, dict) else bd for bd in builds]
        s = mesh.shape[axis]
        if len(builds) != s:
            raise InvalidConfigError(f"got {len(builds)} shard builds for a {s}-shard '{axis}' axis")
        rps = max((bd.n_rows for bd in builds), default=1) if rows_per_shard is None else rows_per_shard
        if rps < 1:
            raise InvalidConfigError(f"rows_per_shard must be >= 1, got {rps}")
        for i, bd in enumerate(builds):
            if bd.n_rows > rps:
                raise InvalidConfigError(f"shard {i} has n_rows={bd.n_rows} > rows_per_shard={rps}")
            if len(bd.rows) and int(np.max(bd.rows)) >= bd.n_rows:
                # a malformed payload would score those postings with doc_len 0
                raise InvalidConfigError(
                    f"shard {i} has a posting row {int(np.max(bd.rows))} >= n_rows={bd.n_rows} "
                    "(corrupt ShardBuild payload?)"
                )
        terms, vocab, idf, _n_docs, avgdl = merge_shard_stats(builds)
        g = len(terms)

        self = cls.__new__(cls)
        self.mesh, self.axis = mesh, axis
        self._k1, self._b = float(k1), float(b)
        self.vocab = vocab
        self._tokenize = functools.partial(tokenize, stopwords=STOPWORDS if stopwords is None else stopwords,
                                           min_len=min_token_len)
        self.n_shards = s
        self.rows_per_shard = rps
        self.indptrs = []
        tables = []
        total = 0
        for bd in builds:
            # local term ids -> global, postings regrouped by global id
            # (a stable sort keeps rows ascending within a term)
            to_l = _term_of(np.asarray(bd.indptr, np.int64), len(bd.rows))
            gid = np.asarray([vocab[t] for t in bd.terms], dtype=np.int64)
            to_g = gid[to_l] if len(gid) else np.zeros(len(bd.rows), np.int64)
            order = np.argsort(to_g, kind="stable")
            to_s = to_g[order]
            ip = np.zeros(g + 1, dtype=np.int64)
            if g:
                np.cumsum(np.bincount(to_s, minlength=g), out=ip[1:])
            self.indptrs.append(ip)
            dl = np.zeros(rps, dtype=np.float32)
            dl[:min(len(bd.doc_len), rps)] = bd.doc_len[:rps]
            tables.append(pack_posting_blocks(np.asarray(bd.rows, np.int32)[order], np.asarray(bd.tfs, np.float32)[order],
                                              dl, idf, to_s, avgdl, k1=k1, b=b))
            total += len(order)
        self._place_tables(tables)
        self.total_postings = total
        return self

    def _gather_blocks(self, queries: Sequence[str]):
        """Per-shard slots ``(block, lo, hi)``, each ``[s, B, S]``, over each
        shard's own block table: ``BM25Index._gather_blocks``' walk on every
        shard's local CSR (a repeated query term contributes each time)."""
        tids = [[self.vocab[t] for t in self._tokenize(q) if t in self.vocab] for q in queries]
        width = max((len(t) for t in tids), default=0)
        arr = np.full((len(queries), max(width, 1)), -1, dtype=np.int64)
        for i, t in enumerate(tids):
            arr[i, :len(t)] = t
        return _slots(*_runs(self._stacked_indptrs, arr))

    def search_arrays(self, queries: Sequence[str], k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched sharded search → global ``(scores [B,k], rows [B,k])`` on
        the mesh's first device."""
        bids, lo, hi = self._gather_blocks(queries)
        s_loc, r_glob = [], []
        for i, dev in enumerate(self.mesh.axis_devices(self.axis)):
            s, r = bm25_topk_blocks(*(torch.from_numpy(x[i]).to(dev) for x in (bids, lo, hi)),
                                    self.blocks.shards[i][0], k=k)
            s_loc.append(s)
            r_glob.append(global_rows(r, i, self.rows_per_shard))
        return merge_local_topk(s_loc, r_glob, k, self.mesh)


class ShardedLearnedSparse:
    """Document-sharded learned-sparse (SPLADE-class) index, with
    :class:`ShardedBM25`'s plan: shard ``i`` owns every posting whose row
    lies in ``[i·rps, (i+1)·rps)`` (expansion weights carry no global
    statistics, so nothing merges at build). Queries are expanded once on
    the host; each shard walks its local CSR for the expansion's terms and
    scores through ``ops.bm25.weighted_topk_blocks``. Built from a
    :class:`~trueno_rag_tpu_torch.index.learned_sparse.LearnedSparseIndex`
    snapshot (mutation: rebuild)."""

    def __init__(self, sparse_index, mesh: Mesh, axis: str = "data", n_rows: Optional[int] = None) -> None:
        self.mesh = mesh
        self.axis = axis
        sparse_index._refresh_snapshot()
        snap = sparse_index._snap
        self.term_ids = np.asarray(snap["term_ids"], dtype=np.int64)  # sorted global term ids
        indptr = np.asarray(snap["indptr"], dtype=np.int64)
        rows = np.asarray(snap["rows"], dtype=np.int32)
        w = np.asarray(snap["weights"], dtype=np.float32)
        n_terms = len(self.term_ids)
        s = mesh.shape[axis]
        self.n_shards = s
        if n_rows is None:
            n_rows = sparse_index.capacity_rows
        self.rows_per_shard = rps = max(-(-max(n_rows, 1) // s), 1)
        self.indptrs: List[np.ndarray] = []
        tables = []
        for m, r_s, _to, ip in _split_by_row(rows, _term_of(indptr, len(rows)), n_terms, s, rps):
            self.indptrs.append(ip)
            tables.append(pack_weighted_blocks(r_s, w[m]))
        ShardedBM25._place_tables(self, tables)
        self.total_postings = len(rows)

    def _gather_blocks(self, q_terms: np.ndarray, q_weights: np.ndarray):
        """Per-shard slots ``(block, lo, hi, weight)``, each ``[s, B, S]``:
        :class:`ShardedBM25`'s walk plus the per-slot query weight; terms
        with a negative id, a weight <= 0 or no postings are skipped."""
        qt = np.asarray(q_terms, np.int64)
        qw = np.asarray(q_weights, np.float32)
        pos = np.searchsorted(self.term_ids, qt)
        pos_c = np.minimum(pos, max(len(self.term_ids) - 1, 0))
        found = (qt >= 0) & (qw > 0.0) & (pos < len(self.term_ids))
        if len(self.term_ids):
            found &= self.term_ids[pos_c] == qt
        return _slots(*_runs(self._stacked_indptrs, np.where(found, pos_c, -1)), qw)

    def search_arrays(self, q_terms: np.ndarray, q_weights: np.ndarray, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched sharded search over expanded queries → global ``(scores
        [B,k], rows [B,k])`` on the mesh's first device, the single-host
        index's rankings. Each shard scores its queries in groups whose
        panels stay within ``_PANEL_LANES`` lanes (rows are independent)."""
        bids, lo, hi, qw = self._gather_blocks(q_terms, q_weights)
        _, b, S = bids.shape
        step = max(1, _PANEL_LANES // (S * BLOCK_LEN))
        s_loc, r_glob = [], []
        for i, dev in enumerate(self.mesh.axis_devices(self.axis)):
            parts = [weighted_topk_blocks(*(torch.from_numpy(x[i, g:g + step]).to(dev) for x in (bids, lo, hi, qw)),
                                          self.blocks.shards[i][0], k=k)
                     for g in range(0, b, step)]
            s_loc.append(torch.cat([p[0] for p in parts]))
            r_glob.append(global_rows(torch.cat([p[1] for p in parts]), i, self.rows_per_shard))
        return merge_local_topk(s_loc, r_glob, k, self.mesh)
