"""Learned-sparse posting index: host-mutable integer-term expansions with
weighted block-gather scoring on the device.

PyTorch counterpart of ``trueno_rag_tpu/index/learned_sparse.py``, the
sibling of :class:`~trueno_rag_tpu_torch.index.bm25.BM25Index` for
SPLADE-class expansion models (:mod:`~trueno_rag_tpu_torch.models.splade`):

- terms are model-vocabulary integers; the index stores each row's
  expansion (terms ascending, one weight each) and nothing else — no
  df/avgdl statistics, the model learned its own term weighting;
- the per-posting payload is the document weight; the query weight is
  applied on the device (:func:`~trueno_rag_tpu_torch.ops.bm25.weighted_topk_blocks`),
  so the block table serves every query;
- the CSR snapshot (terms ascending, rows ascending within a term) and its
  block table are rebuilt lazily on the dirty flag, in bulk numpy: the
  rows' expansions concatenated and sorted by term.

``search_host`` is the float64 oracle the device path is pinned to.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import VectorStoreError
from trueno_rag_tpu_torch.index.base import ChunkRegistry
from trueno_rag_tpu_torch.ops.bm25 import BLOCK_LEN, bucket_len

_PANEL_LANES = 1 << 25  # candidate lanes (queries x slots x BLOCK_LEN) scored per device call


def _first_of_runs(sorted_keys: np.ndarray) -> np.ndarray:
    """Mask of the first element of each run of equal keys (along the last axis)."""
    first = np.ones(sorted_keys.shape, dtype=bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return first


class LearnedSparseIndex:
    """Per-row expansions ``row → (terms, weights)`` on the host; the
    snapshot's block table on ``device`` (default: the card)."""

    def __init__(self, registry: Optional[ChunkRegistry] = None, device=None) -> None:
        self.device = resolve_device(device)
        self._owns_registry = registry is None
        self.registry = ChunkRegistry() if registry is None else registry
        self._row_terms: Dict[int, np.ndarray] = {}  # int64, ascending, unique
        self._row_weights: Dict[int, np.ndarray] = {}  # f32, aligned with the terms
        self._dirty = True
        self._snap = None

    # -- mutation ------------------------------------------------------------

    def add(self, chunk: Chunk, terms: np.ndarray, weights: np.ndarray) -> None:
        """Store one chunk's expansion (``-1`` terms and non-positive weights
        are empty slots, the splade_topt convention)."""
        self.add_batch([chunk], np.asarray(terms)[None], np.asarray(weights)[None])

    def add_batch(self, chunks: Sequence[Chunk], terms: np.ndarray, weights: np.ndarray) -> None:
        """Store expansions ``terms [N, T]`` / ``weights [N, T]``. Negative
        weights on live terms are refused (the candidate tail's segment sums
        are exact only for non-negative contributions); a term repeated in
        a row keeps its largest weight; a chunk id already indexed is
        replaced."""
        terms = np.asarray(terms, np.int64)
        weights = np.asarray(weights, np.float32)
        if terms.shape != weights.shape or terms.ndim != 2 or terms.shape[0] != len(chunks):
            raise VectorStoreError("terms/weights shapes do not match chunks")
        if ((terms >= 0) & (weights < 0.0)).any():
            raise VectorStoreError(
                "learned-sparse weights must be non-negative (segment-sum scoring exactness)"
            )
        for c in chunks:
            row = self.registry.row_of(c.id)
            if row is not None and row in self._row_terms:
                self._remove_row(row)
        rows = self.registry.add_batch(list(chunks))
        live = (terms >= 0) & (weights > 0.0)
        key = np.where(live, terms, np.iinfo(np.int64).max)
        order = np.lexsort((-weights, key), axis=-1)  # term asc, the largest weight first
        t_s = np.take_along_axis(key, order, axis=-1)
        w_s = np.take_along_axis(weights, order, axis=-1)
        keep = np.take_along_axis(live, order, axis=-1) & _first_of_runs(t_s)
        counts = keep.sum(axis=1)
        t_rows = np.split(t_s[keep], np.cumsum(counts)[:-1])
        w_rows = np.split(w_s[keep], np.cumsum(counts)[:-1])
        for row, t, w in zip(rows, t_rows, w_rows):
            self._row_terms[row] = t
            self._row_weights[row] = w
        self._dirty = True

    def load_rows(self, chunks: Sequence[Chunk], indptr: np.ndarray, terms: np.ndarray,
                  weights: np.ndarray) -> None:
        """Bulk-restore a ragged-CSR expansion set (the persistence load
        path): chunk i's expansion is ``terms/weights[indptr[i]:indptr[i+1]]``,
        weight bytes untouched (a repeated term keeps its last weight, as
        the JAX package's dict writes do)."""
        indptr = np.asarray(indptr, np.int64)
        terms = np.asarray(terms, np.int64)
        weights = np.asarray(weights, np.float32)
        if len(indptr) != len(chunks) + 1 or int(indptr[-1]) != len(terms):
            raise VectorStoreError("indptr does not match chunks/terms")
        if len(terms) != len(weights):
            raise VectorStoreError("terms/weights lengths differ")
        rows = self.registry.add_batch(list(chunks))
        ascending = np.ones(len(terms), dtype=bool)
        ascending[1:] = terms[1:] > terms[:-1]
        ascending[indptr[:-1][indptr[:-1] < len(terms)]] = True
        for i, row in enumerate(rows):
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            t, w = terms[lo:hi], weights[lo:hi]
            if row in self._row_terms:  # a duplicate id within the restore
                self._remove_row(row)
            if not ascending[lo:hi].all():
                order = np.argsort(t, kind="stable")[::-1]  # the last of each run first
                t_r, w_r = t[order], w[order]
                keep = _first_of_runs(t_r)
                t, w = t_r[keep][::-1], w_r[keep][::-1]
            self._row_terms[row] = t
            self._row_weights[row] = w
        self._dirty = True

    def _remove_row(self, row: int) -> None:
        self._row_terms.pop(row, None)
        self._row_weights.pop(row, None)

    def remove(self, chunk_id: str) -> bool:
        row = self.registry.row_of(chunk_id)
        if row is None or row not in self._row_terms:
            return False
        self._remove_row(row)
        if self._owns_registry:
            self.registry.remove(chunk_id)
        self._dirty = True
        return True

    def __len__(self) -> int:
        return len(self._row_terms)

    def is_empty(self) -> bool:
        return not self._row_terms

    @property
    def capacity_rows(self) -> int:
        return self.registry.capacity_rows

    def row_expansions(self, rows: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The expansions of ``rows`` (in that order) as a ragged CSR →
        ``(indptr [M+1] int64, terms [P] int32, weights [P] f32)``, terms
        ascending per row (the artifacts' wire layout)."""
        t = [self._row_terms.get(r, np.zeros(0, np.int64)) for r in rows]
        w = [self._row_weights.get(r, np.zeros(0, np.float32)) for r in rows]
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([len(x) for x in t], out=indptr[1:])
        terms = np.concatenate(t).astype(np.int32) if t else np.zeros(0, np.int32)
        weights = np.concatenate(w).astype(np.float32) if w else np.zeros(0, np.float32)
        return indptr, terms, weights

    # -- device snapshot -------------------------------------------------------

    def ensure_ready(self) -> None:
        self._refresh_snapshot()

    def _refresh_snapshot(self) -> None:
        """CSR over terms (ascending; rows ascending within a term) and its
        block table on the device, rebuilt when the expansions changed."""
        if not self._dirty and self._snap is not None:
            return
        from trueno_rag_tpu_torch.ops.bm25 import pack_weighted_blocks

        rows_in = sorted(self._row_terms)
        counts = np.array([len(self._row_terms[r]) for r in rows_in], dtype=np.int64)
        terms = (np.concatenate([self._row_terms[r] for r in rows_in]) if rows_in
                 else np.zeros(0, np.int64))
        weights = (np.concatenate([self._row_weights[r] for r in rows_in]) if rows_in
                   else np.zeros(0, np.float32))
        rows = np.repeat(np.asarray(rows_in, dtype=np.int32), counts)
        # a stable sort by term keeps rows ascending within each term; 16-bit
        # keys take numpy's radix sort (every vocabulary of the presets fits)
        keys = terms.astype(np.uint16) if len(terms) and terms.max() < (1 << 16) else terms
        order = np.argsort(keys, kind="stable")
        terms, weights, rows = terms[order], weights[order], rows[order]
        first = _first_of_runs(terms)
        term_ids = terms[first]
        indptr = np.append(np.flatnonzero(first), len(terms)).astype(np.int64)
        self._snap = {
            "term_ids": term_ids,
            "indptr": indptr,
            "rows": rows,
            "weights": weights,
            "blocks": torch.from_numpy(pack_weighted_blocks(rows, weights)).to(self.device),
        }
        self._dirty = False

    def _gather_blocks(self, q_terms: np.ndarray, q_weights: np.ndarray):
        """Expanded queries ``[B, T]`` → BLOCK_LEN-aligned slots ``(block,
        lo, hi, weight)``, each ``[B, S]`` numpy (S the power-of-two bucket
        of the longest slot list, at least 64): per query in its term order,
        each term's blocks ascending; a term spanning several blocks repeats
        its weight per slot; padding slots name the always-masked sentinel
        block."""
        snap = self._snap
        term_ids, indptr = snap["term_ids"], snap["indptr"]
        qt = np.asarray(q_terms, np.int64)
        qw = np.asarray(q_weights, np.float32)
        b = qt.shape[0]
        pos = np.searchsorted(term_ids, qt)
        pos_c = np.minimum(pos, max(len(term_ids) - 1, 0))
        found = (qt >= 0) & (qw > 0.0) & (pos < len(term_ids))
        if len(term_ids):
            found &= term_ids[pos_c] == qt
        t_lo = np.where(found, indptr[pos_c] if len(term_ids) else 0, 0)
        t_hi = np.where(found, indptr[np.minimum(pos_c + 1, len(indptr) - 1)], 0)
        found &= t_hi > t_lo
        b_lo = t_lo // BLOCK_LEN
        nblk = np.where(found, (t_hi - 1) // BLOCK_LEN - b_lo + 1, 0)
        per_query = nblk.sum(axis=1)
        S = bucket_len(max(1, int(per_query.max(initial=0))), minimum=64)
        sentinel = int(indptr[-1]) // BLOCK_LEN
        bids = np.full((b, S), sentinel, dtype=np.int32)
        lo = np.zeros((b, S), dtype=np.int32)
        hi = np.zeros((b, S), dtype=np.int32)
        w_out = np.zeros((b, S), dtype=np.float32)
        flat = nblk.reshape(-1)
        total = int(flat.sum())
        if total:
            rep = np.repeat(np.arange(flat.size), flat)  # (query, term) of every slot
            first_slot = np.cumsum(flat) - flat
            j = np.arange(total) - first_slot[rep]  # block index within its term
            qi = rep // qt.shape[1]
            slot = (np.cumsum(nblk, axis=1) - nblk).reshape(-1)[rep] + j
            blk = b_lo.reshape(-1)[rep] + j
            base = blk * BLOCK_LEN
            bids[qi, slot] = blk
            lo[qi, slot] = np.maximum(t_lo.reshape(-1)[rep] - base, 0)
            hi[qi, slot] = np.minimum(t_hi.reshape(-1)[rep] - base, BLOCK_LEN)
            w_out[qi, slot] = qw.reshape(-1)[rep]
        return bids, lo, hi, w_out

    def search_arrays(self, q_terms: np.ndarray, q_weights: np.ndarray, k: int,
                      allowed_rows: Optional[np.ndarray] = None):
        """Device-level batched search of expanded queries → ``(scores [B, k],
        rows [B, k])`` tensors on the device, (score desc, row asc), ``-1`` /
        ``-inf`` past the hits; only scores > 0 (a shared expansion term).
        ``allowed_rows`` (``[N]`` or ``[B, N]`` bool) rides the scoring op, so
        the filtered top-k is exact. Queries are scored in groups whose
        candidate panels stay within ``_PANEL_LANES`` lanes (rows are
        independent, so the grouping does not change any answer)."""
        from trueno_rag_tpu_torch.ops.bm25 import weighted_topk_blocks

        self._refresh_snapshot()
        bids, lo, hi, qw = self._gather_blocks(q_terms, q_weights)
        b, s = bids.shape
        allowed = None
        if allowed_rows is not None:
            allowed = torch.from_numpy(np.ascontiguousarray(allowed_rows, dtype=bool)).to(self.device)
        step = max(1, _PANEL_LANES // (s * BLOCK_LEN))
        out_s, out_r = [], []
        for g in range(0, b, step):
            sl = slice(g, g + step)
            a = allowed[sl] if allowed is not None and allowed.dim() == 2 else allowed
            sc, rw = weighted_topk_blocks(
                *(torch.from_numpy(x[sl]).to(self.device) for x in (bids, lo, hi, qw)),
                self._snap["blocks"], k=k, allowed=a,
            )
            out_s.append(sc)
            out_r.append(rw)
        return torch.cat(out_s), torch.cat(out_r)

    def search_host(self, q_terms: np.ndarray, q_weights: np.ndarray, k: int) -> List[Tuple[int, float]]:
        """Float64 oracle for one expanded query: per candidate row the sum of
        ``q_w · d_w`` (f32 inputs, products and sums in float64, in the
        query's term order), score > 0, (score desc, row asc), the first
        ``k`` → ``[(row, score)]``."""
        self._refresh_snapshot()
        snap = self._snap
        term_ids, indptr = snap["term_ids"], snap["indptr"]
        rows_l, vals_l = [], []
        for t, wq in zip(np.asarray(q_terms).tolist(), np.asarray(q_weights, np.float32).tolist()):
            if t < 0 or wq <= 0.0:
                continue
            i = int(np.searchsorted(term_ids, t))
            if i >= len(term_ids) or term_ids[i] != t:
                continue
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            rows_l.append(snap["rows"][lo:hi])
            vals_l.append(wq * snap["weights"][lo:hi].astype(np.float64))
        if not rows_l:
            return []
        sums = np.bincount(np.concatenate(rows_l), weights=np.concatenate(vals_l))
        cand = np.flatnonzero(sums > 0.0)
        s = sums[cand]
        if 0 < k < len(cand):  # keep the k-th score's ties, then order them
            keep = s >= np.partition(s, len(s) - k)[len(s) - k]
            cand, s = cand[keep], s[keep]
        order = np.lexsort((cand, -s))[:k]
        return [(int(cand[i]), float(s[i])) for i in order]

    # -- persistence hooks -----------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """The JAX package's layout: ``postings`` term → {row: weight} and
        ``row_terms`` row → [terms], keys as strings."""
        postings: Dict[str, Dict[str, float]] = {}
        for r in sorted(self._row_terms):
            for t, w in zip(self._row_terms[r].tolist(), self._row_weights[r].tolist()):
                postings.setdefault(str(t), {})[str(r)] = float(w)
        return {
            "postings": postings,
            "row_terms": {str(r): [int(t) for t in ts] for r, ts in self._row_terms.items()},
        }

    def load_state_dict(self, d: Dict[str, object]) -> None:
        """Restore :meth:`state_dict`'s layout (either package's)."""
        postings = {int(t): {int(r): float(w) for r, w in p.items()} for t, p in d["postings"].items()}
        self._row_terms, self._row_weights = {}, {}
        for r, ts in d["row_terms"].items():
            t = np.asarray(sorted(int(x) for x in ts), dtype=np.int64)
            self._row_terms[int(r)] = t
            self._row_weights[int(r)] = np.asarray([postings[int(x)][int(r)] for x in t], np.float32)
        self._dirty = True
