"""BM25 sparse index: host-built inverted index, device block-table scoring.

PyTorch counterpart of ``trueno_rag_tpu/index/bm25.py``. Capability-
equivalent to the reference's ``BM25Index`` (reference: index.rs:30-280)
with the same ranking math, tokenizer and parameters (k1=1.2, b=0.75,
~100 stopwords, min token length 2), and this execution plan:

- The host maintains the mutable inverted index (term → {row: tf}) plus
  per-row token counts for O(terms) removal — the reference instead
  rescans posting lists (index.rs:245-275).
- ``avg_doc_length`` is maintained O(1) from a running total; the
  reference recomputes it over all docs on every add (index.rs:157-164,
  an O(N²) index build).
- On search, a CSR snapshot is pushed to ``device`` lazily (dirty flag):
  the block table of precomputed contributions while the row capacity
  stays below 2**24 (the query becomes block slots and the scoring runs
  in :func:`trueno_rag_tpu_torch.ops.bm25.bm25_topk_blocks`), past it the
  packed postings (the query becomes ``(start, len)`` runs, fetched with
  the contribution computed on device:
  :func:`trueno_rag_tpu_torch.ops.kernels.bm25_fetch.bm25_topk_fetch`).

``search_host`` is the scalar oracle with loop-level reference
semantics, used by tests to pin the device path to exact parity.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.index.base import ChunkRegistry
from trueno_rag_tpu_torch.ops.bm25 import bucket_len
from trueno_rag_tpu_torch.text import STOPWORDS, tokenize


def _term_of(indptr, n_postings: int) -> np.ndarray:
    """The term id of every posting of the CSR layout ``indptr`` (zeros
    for the degenerate empty-index shapes)."""
    n_terms = len(indptr) - 1
    term_of = np.repeat(np.arange(max(n_terms, 0), dtype=np.int32), np.maximum(np.diff(indptr), 0))
    return term_of if len(term_of) == n_postings else np.zeros(n_postings, dtype=np.int32)


class BM25Index:
    def __init__(
        self,
        k1: float = 1.2,
        b: float = 0.75,
        registry: Optional[ChunkRegistry] = None,
        stopwords=STOPWORDS,
        min_token_len: int = 2,
        use_native: Optional[bool] = None,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.k1 = float(k1)
        self.b = float(b)
        self.stopwords = stopwords
        self.min_token_len = min_token_len
        self._owns_registry = registry is None
        self.registry = ChunkRegistry() if registry is None else registry
        # term -> {row: tf}
        self._postings: Dict[str, Dict[int, int]] = {}
        # row -> token count (doc length); also marks membership
        self._doc_len: Dict[int, int] = {}
        self._total_len = 0
        # device snapshot
        self._dirty = True
        self._snap = None  # {vocab, indptr, avgdl, blocks | packed (device)}
        # Native bulk-build path: postings accumulate inside the C++
        # builder (trueno_rag_tpu_torch.native); Python dicts materialize
        # lazily only when the index is mutated (remove / re-add) or
        # serialized. use_native=None -> auto-detect.
        self._native_builder = None
        self._use_native = use_native
        if use_native is not False:
            try:
                from trueno_rag_tpu_torch.native import NativeBM25Builder, native_available

                if native_available():
                    self._native_builder = NativeBM25Builder(
                        min_token_len=min_token_len, stopwords=stopwords
                    )
                elif use_native is True:
                    # an explicit demand must not silently degrade to
                    # the O(n)-Python ingest path
                    from trueno_rag_tpu_torch.errors import InvalidConfigError
                    from trueno_rag_tpu_torch.native import native_build_error

                    raise InvalidConfigError(
                        f"use_native=True but the native builder is "
                        f"unavailable: {native_build_error()}"
                    )
            except Exception:
                if use_native is True:
                    raise

    @property
    def native_active(self) -> bool:
        """True while postings live in the C++ builder only."""
        return self._native_builder is not None

    def _materialize_postings(self) -> None:
        """Pull postings out of the native builder into Python dicts so
        mutation/serialization can proceed; drops the builder."""
        if self._native_builder is None:
            return
        export = self._native_builder.export()
        postings: Dict[str, Dict[int, int]] = {}
        indptr = export["indptr"]
        rows = export["rows"]
        tfs = export["tfs"]
        for ti, term in enumerate(export["terms"]):
            lo, hi = int(indptr[ti]), int(indptr[ti + 1])
            postings[term] = {
                int(rows[j]): int(tfs[j]) for j in range(lo, hi)
            }
        self._postings = postings
        self._native_builder = None
        self._dirty = True

    # -- mutation ------------------------------------------------------------

    def _tokenize(self, text: str) -> List[str]:
        return tokenize(text, stopwords=self.stopwords, min_len=self.min_token_len)

    def add(self, chunk: Chunk) -> None:
        # Replacement must clear the OLD content's postings before the
        # registry swaps in the new chunk (remove re-tokenizes the stored
        # chunk), so resolve the row first.
        existing_row = self.registry.row_of(chunk.id)
        if existing_row is not None and existing_row in self._doc_len:
            self._materialize_postings()
            self._remove_row(existing_row)
        row = self.registry.add(chunk)
        if self._native_builder is not None:
            count = self._native_builder.add(row, chunk.content)
            self._doc_len[row] = count
            self._total_len += count
            self._dirty = True
            return
        toks = self._tokenize(chunk.content)
        self._doc_len[row] = len(toks)
        self._total_len += len(toks)
        tf: Dict[str, int] = {}
        for t in toks:
            tf[t] = tf.get(t, 0) + 1
        for term, count in tf.items():
            self._postings.setdefault(term, {})[row] = count
        self._dirty = True

    def add_batch(self, chunks: Sequence[Chunk]) -> None:
        if self._native_builder is not None:
            # The fast path must be detected BEFORE registering anything:
            # registry.add() swaps the stored chunk, after which a
            # replacement can no longer clear the old content's postings.
            # Intra-batch duplicate ids would also double-count postings.
            ids = [c.id for c in chunks]
            clean = len(set(ids)) == len(ids) and not any(
                (row := self.registry.row_of(cid)) is not None and row in self._doc_len
                for cid in ids
            )
            if clean:
                rows = self.registry.add_batch(chunks)
                counts = self._native_builder.add_batch(rows, [c.content for c in chunks])
                for r, n in zip(rows, counts):
                    self._doc_len[r] = int(n)
                self._total_len += int(counts.sum())
                self._dirty = True
                return
        for c in chunks:
            self.add(c)

    def _remove_row(self, row: int) -> None:
        """Clear a row's postings given its stored chunk is still in the
        registry (needed to re-tokenize) or via full posting sweep."""
        chunk = self.registry.chunk_of(row)
        if chunk is not None:
            for term in set(self._tokenize(chunk.content)):
                plist = self._postings.get(term)
                if plist is not None:
                    plist.pop(row, None)
                    if not plist:
                        del self._postings[term]  # empty-term GC (index.rs:268-273)
        else:  # fallback sweep
            for term in list(self._postings):
                self._postings[term].pop(row, None)
                if not self._postings[term]:
                    del self._postings[term]
        self._total_len -= self._doc_len.pop(row, 0)

    def remove(self, chunk_id: str) -> bool:
        row = self.registry.row_of(chunk_id)
        if row is None or row not in self._doc_len:
            return False
        self._materialize_postings()
        self._remove_row(row)
        if self._owns_registry:
            self.registry.remove(chunk_id)
        self._dirty = True
        return True

    def __len__(self) -> int:
        return len(self._doc_len)

    def is_empty(self) -> bool:
        return not self._doc_len

    @property
    def avg_doc_length(self) -> float:
        return self._total_len / len(self._doc_len) if self._doc_len else 0.0

    def _idf(self, term: str) -> float:
        """Okapi idf with +1 smoothing: ln((N - df + 0.5)/(df + 0.5) + 1)
        (reference: index.rs:136-145)."""
        df = len(self._postings.get(term, ()))
        if df == 0:
            return 0.0
        n = len(self._doc_len)
        return math.log((n - df + 0.5) / (df + 0.5) + 1.0)

    # -- device snapshot --------------------------------------------------------

    def ensure_ready(self) -> None:
        """Build the device CSR snapshot NOW instead of on the next
        query (serving warm-up after an ingest/reload window)."""
        self._refresh_snapshot()

    def _refresh_snapshot(self) -> None:
        if not self._dirty and self._snap is not None:
            return
        self._finish_snapshot(*self._csr())

    def _csr(self):
        """The host CSR of the current postings → ``(vocab, indptr, rows,
        tfs, idf, doc_len, n_rows)``, terms sorted, rows ascending within
        a term."""
        n_rows = self.registry.capacity_rows
        if self._native_builder is not None:
            export = self._native_builder.export()
            terms = export["terms"]
            vocab = {t: i for i, t in enumerate(terms)}
            indptr = np.asarray(export["indptr"], dtype=np.int64)
            rows = np.asarray(export["rows"], dtype=np.int32)
            tfs = np.asarray(export["tfs"], dtype=np.float32)
            n = max(len(self._doc_len), 1)
            df = np.maximum(np.diff(indptr), 1).astype(np.float64)
            idf = np.log((n - df + 0.5) / (df + 0.5) + 1.0).astype(np.float32)
            if idf.size == 0:
                idf = np.zeros(1, dtype=np.float32)
                rows = np.zeros(1, dtype=np.int32)
                tfs = np.zeros(1, dtype=np.float32)
            doc_len = np.zeros(max(n_rows, 1), dtype=np.float32)
            doc_len[export["doc_len_rows"]] = export["doc_len_vals"]
            return vocab, indptr, rows, tfs, idf, doc_len, n_rows
        terms = sorted(self._postings.keys())
        vocab = {t: i for i, t in enumerate(terms)}
        sizes = [len(self._postings[t]) for t in terms]
        indptr = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(sizes, out=indptr[1:])
        total = int(indptr[-1])
        rows = np.zeros(max(total, 1), dtype=np.int32)
        tfs = np.zeros(max(total, 1), dtype=np.float32)
        for t in terms:
            lo = indptr[vocab[t]]
            plist = sorted(self._postings[t].items())  # row-asc for determinism
            for j, (row, tf) in enumerate(plist):
                rows[lo + j] = row
                tfs[lo + j] = tf
        idf = np.asarray([self._idf(t) for t in terms] or [0.0], dtype=np.float32)
        doc_len = np.zeros(max(n_rows, 1), dtype=np.float32)
        for row, ln in self._doc_len.items():
            doc_len[row] = ln
        return vocab, indptr, rows, tfs, idf, doc_len, n_rows

    def _finish_snapshot(self, vocab, indptr, rows, tfs, idf, doc_len, n_rows) -> None:
        """Common snapshot tail, on ``self.device``: the block table for
        the block-gather path (ops.bm25.bm25_topk_blocks) while the row
        capacity stays below ``ops.bm25.MAX_BLOCK_ROWS`` (read now, so the
        threshold can be moved); past it, the packed postings of the
        segment path (ops.bm25.pack_postings), whose lane 0 carries row
        bits exact for any row count."""
        from trueno_rag_tpu_torch.ops.bm25 import MAX_BLOCK_ROWS, pack_posting_blocks, pack_postings

        term_of = _term_of(indptr, len(rows))
        avgdl = np.float32(self.avg_doc_length)
        if max(n_rows, 1) < MAX_BLOCK_ROWS:
            table = pack_posting_blocks(rows, tfs, doc_len, idf, term_of, avgdl, k1=self.k1, b=self.b)
            layout = {"blocks": torch.from_numpy(table).to(self.device), "packed": None}
        else:
            packed = pack_postings(rows, tfs, doc_len, idf, term_of)
            layout = {"blocks": None, "packed": torch.from_numpy(packed).to(self.device)}
        self._snap = {"vocab": vocab, "indptr": indptr, "avgdl": float(avgdl), **layout}
        self._dirty = False

    def _get_packed(self) -> torch.Tensor:
        """The segment path's packed postings on ``self.device``; below
        the block threshold built on demand from the index's postings (the
        on-device oracle of the block path) and kept until the next
        snapshot."""
        from trueno_rag_tpu_torch.ops.bm25 import pack_postings

        self._refresh_snapshot()
        snap = self._snap
        if snap["packed"] is None:
            _, indptr, rows, tfs, idf, doc_len, _ = self._csr()
            packed = pack_postings(rows, tfs, doc_len, idf, _term_of(indptr, len(rows)))
            snap["packed"] = torch.from_numpy(packed).to(self.device)
        return snap["packed"]

    def _gather_segments(self, queries: Sequence[str]):
        """Compile queries into contiguous-run (start, len) pairs over the
        packed postings (long posting lists split into SEGMENT_LEN runs)
        → int32 ``(starts [B, S], lens [B, S])``, the input of
        ops.bm25.bm25_topk_segments. The JAX package's arrays, built with
        numpy: each query's runs in term order, ``S`` a power-of-two
        bucket of at least 64, unused slots at the padding row
        (``indptr[-1]``) with length 0."""
        from trueno_rag_tpu_torch.ops.bm25 import SEGMENT_LEN

        snap = self._snap
        indptr = np.asarray(snap["indptr"], dtype=np.int64)
        vocab = snap["vocab"]
        tids = [[t for t in map(vocab.get, self._tokenize(q)) if t is not None] for q in queries]
        q_of = np.repeat(np.arange(len(queries)), [len(t) for t in tids])
        tid = np.asarray([t for ts in tids for t in ts], dtype=np.int64)
        t_lo, t_hi = indptr[tid], indptr[tid + 1]
        n_seg = (t_hi - t_lo + SEGMENT_LEN - 1) // SEGMENT_LEN  # 0 for an empty term
        per_query = np.bincount(q_of, weights=n_seg, minlength=len(queries)).astype(np.int64)
        S = bucket_len(max(1, int(per_query.max(initial=0))), minimum=64)  # compile-key floor
        pair = np.repeat(np.arange(len(tid)), n_seg)
        seg_i = np.arange(len(pair)) - np.repeat(np.cumsum(n_seg) - n_seg, n_seg)
        start = t_lo[pair] + seg_i * SEGMENT_LEN
        q = q_of[pair]
        slot = np.arange(len(pair)) - (np.cumsum(per_query) - per_query)[q]
        starts = np.full((len(queries), S), int(indptr[-1]), dtype=np.int32)
        lens = np.zeros((len(queries), S), dtype=np.int32)
        starts[q, slot] = start
        lens[q, slot] = np.minimum(SEGMENT_LEN, t_hi[pair] - start)
        return starts, lens

    def _gather_blocks(self, queries: Sequence[str]):
        """Compile queries into BLOCK_LEN-aligned (block, lo, hi) slot
        triples over the block table — the input of
        ops.bm25.bm25_topk_blocks. Duplicate query terms contribute one
        slot set each (the reference scores per term occurrence)."""
        from trueno_rag_tpu_torch.ops.bm25 import BLOCK_LEN

        snap = self._snap
        indptr = snap["indptr"]
        sentinel = int(indptr[-1]) // BLOCK_LEN  # always-masked padding block
        per_query: List[List[Tuple[int, int, int]]] = []
        max_slots = 1
        for q in queries:
            slots: List[Tuple[int, int, int]] = []
            for term in self._tokenize(q):
                tid = snap["vocab"].get(term)
                if tid is None:
                    continue
                t_lo, t_hi = int(indptr[tid]), int(indptr[tid + 1])
                if t_hi <= t_lo:
                    continue
                for blk in range(t_lo // BLOCK_LEN, (t_hi - 1) // BLOCK_LEN + 1):
                    base = blk * BLOCK_LEN
                    slots.append(
                        (blk, max(t_lo - base, 0), min(t_hi - base, BLOCK_LEN))
                    )
            per_query.append(slots)
            max_slots = max(max_slots, len(slots))
        S = bucket_len(max_slots, minimum=64)  # compile-key floor, see above
        B = len(queries)
        bids = np.full((B, S), sentinel, dtype=np.int32)
        lo = np.zeros((B, S), dtype=np.int32)
        hi = np.zeros((B, S), dtype=np.int32)
        for i, slots in enumerate(per_query):
            for j, (blk, l, h) in enumerate(slots[:S]):
                bids[i, j] = blk
                lo[i, j] = l
                hi[i, j] = h
        return bids, lo, hi

    def gather_block_tensors(self, queries: Sequence[str]):
        """Block slots of ``queries`` as int32 tensors on ``self.device``."""
        return tuple(
            torch.from_numpy(a).to(self.device) for a in self._gather_blocks(queries)
        )

    def gather_segment_tensors(self, queries: Sequence[str]):
        """Segment runs of ``queries`` as int32 tensors on ``self.device``."""
        return tuple(
            torch.from_numpy(a).to(self.device) for a in self._gather_segments(queries)
        )

    def search_arrays(self, queries: Sequence[str], k: int):
        """Device-level batched search → ``(scores [B,k], rows [B,k])``
        via the block-gather path, or past the block threshold the segment
        path (the fetch kernel on the card, ops.kernels.bm25_fetch)."""
        from trueno_rag_tpu_torch.ops.bm25 import bm25_topk_blocks
        from trueno_rag_tpu_torch.ops.kernels.bm25_fetch import bm25_topk_fetch

        self._refresh_snapshot()
        snap = self._snap
        if snap["blocks"] is not None:
            bids, lo, hi = self.gather_block_tensors(queries)
            return bm25_topk_blocks(bids, lo, hi, snap["blocks"], k=k)
        starts, lens = self.gather_segment_tensors(queries)
        return bm25_topk_fetch(starts, lens, snap["packed"], snap["avgdl"], k, k1=self.k1, b=self.b)

    def search(self, query: str, k: int) -> List[Tuple[str, float]]:
        """Host-facing search: ``[(chunk_id, score)]``, score>0 only,
        (score desc, row asc) — reference semantics (index.rs:212-243)."""
        if self.is_empty() or k <= 0:
            return []
        scores, rows = self.search_arrays([query], k)
        out: List[Tuple[str, float]] = []
        for s, r in zip(scores[0].cpu().numpy(), rows[0].cpu().numpy()):
            if r < 0:
                continue
            cid = self.registry.id_of(int(r))
            if cid is not None:
                out.append((cid, float(s)))
        return out

    def search_host(self, query: str, k: int) -> List[Tuple[str, float]]:
        """Scalar oracle with the reference's exact loop semantics:
        candidate union of posting lists → per-candidate term sum →
        score>0 filter → sort desc → truncate (index.rs:212-243).
        Materializes native postings (test/debug path)."""
        self._materialize_postings()
        terms = self._tokenize(query)
        if not terms or self.is_empty():
            return []
        candidates: Dict[int, float] = {}
        avgdl = self.avg_doc_length
        cand_rows = set()
        for t in terms:
            cand_rows.update(self._postings.get(t, ()))
        for row in cand_rows:
            score = 0.0
            dl = self._doc_len[row]
            for t in terms:
                tf = self._postings.get(t, {}).get(row, 0)
                if tf == 0:
                    continue
                idf = self._idf(t)
                denom = tf + self.k1 * (1.0 - self.b + self.b * dl / max(avgdl, 1e-9))
                score += idf * tf * (self.k1 + 1.0) / max(denom, 1e-9)
            if score > 0.0:
                candidates[row] = score
        ranked = sorted(candidates.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        out = []
        for row, s in ranked:
            cid = self.registry.id_of(row)
            if cid is not None:
                out.append((cid, s))
        return out

    # -- persistence hooks ---------------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        self._materialize_postings()
        return {
            "k1": self.k1,
            "b": self.b,
            "min_token_len": self.min_token_len,
            # the stopword set is part of the index's tokenization
            # contract: without it a reloaded index strips different
            # terms from queries/removals than it indexed (silently
            # wrong scores, stale postings on replacement)
            "stopwords": sorted(self.stopwords),
            "postings": {t: {str(r): tf for r, tf in p.items()} for t, p in self._postings.items()},
            "doc_len": {str(r): l for r, l in self._doc_len.items()},
            "total_len": self._total_len,
        }

    def load_state_dict(self, d: Dict[str, object]) -> None:
        self._native_builder = None  # dicts become the source of truth
        self.k1 = float(d["k1"])
        self.b = float(d["b"])
        self.min_token_len = int(d.get("min_token_len", 2))
        if "stopwords" in d:  # absent in pre-round-2 artifacts: keep current
            self.stopwords = frozenset(d["stopwords"])
        self._postings = {
            t: {int(r): int(tf) for r, tf in p.items()} for t, p in d["postings"].items()
        }
        self._doc_len = {int(r): int(l) for r, l in d["doc_len"].items()}
        self._total_len = int(d["total_len"])
        self._dirty = True
