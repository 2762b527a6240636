"""Multi-host ingest: shard-local BM25 builds merged into exact global
sharded indexes.

PyTorch counterpart of ``trueno_rag_tpu/parallel/ingest.py``. Each host
ingests only its own row range:

1. **Shard-local build** (:func:`build_shard`): a host tokenizes its
   documents into a :class:`ShardBuild` (local vocabulary, local CSR
   postings, local document lengths), through the native bulk builder when
   it is available. :meth:`ShardBuild.to_payload` is the wire form (a
   dict of bytes and strings for ``persist.serialize_compressed``); a
   payload written by the JAX package loads here.
2. **Exact merge** (:func:`merge_shard_stats` and
   :meth:`~trueno_rag_tpu_torch.parallel.sparse.ShardedBM25.from_shard_builds`):
   documents partition across shards, so ``df(term)`` is the sum of the
   local counts, ``N`` the sum of the documents and ``avgdl`` the global
   length total over ``N``; idf is recomputed from the global df with
   ``BM25Index``'s float64 → f32 recipe, so the packed contributions equal
   a single-host build's.
3. **Dense side**: each host's embedding block goes straight to its
   shard's device (:func:`assemble_row_sharded`), so the full ``[N, d]``
   matrix never exists on one host.

Row space: shard ``i`` of ``s`` owns global rows ``[i·rps, (i+1)·rps)``,
the partition every sharded index uses, so hybrid fusion needs no row
translation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError, SerializationError
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded
from trueno_rag_tpu_torch.text import STOPWORDS, tokenize

_DTYPES = {"indptr": "<i8", "rows": "<i4", "tfs": "<f4", "doc_len": "<f4"}


@dataclass
class ShardBuild:
    """One host's shard-local BM25 build.

    ``terms`` are this shard's vocabulary (ids = positions); ``indptr`` is
    the local CSR over those ids; ``rows`` are SHARD-LOCAL row ids
    (``global = shard_index · rps + local``), ascending within a term;
    ``doc_len`` is dense per local row (0 = no document)."""

    terms: List[str]
    indptr: np.ndarray  # [T+1] int64
    rows: np.ndarray  # [P] int32, shard-local
    tfs: np.ndarray  # [P] float32
    doc_len: np.ndarray  # [n_rows] float32
    n_docs: int
    total_len: int
    n_rows: int

    def to_payload(self) -> Dict[str, object]:
        """The wire form: arrays as raw little-endian bytes with their
        declared dtypes, the JAX package's layout key for key."""
        return {
            "version": 1,
            "dtypes": dict(_DTYPES),
            "terms": list(self.terms),
            **{key: np.ascontiguousarray(getattr(self, key), dtype=dt).tobytes() for key, dt in _DTYPES.items()},
            "n_docs": int(self.n_docs),
            "total_len": int(self.total_len),
            "n_rows": int(self.n_rows),
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, object]) -> "ShardBuild":
        declared = payload.get("dtypes", _DTYPES)
        if dict(declared) != _DTYPES:
            raise SerializationError(f"ShardBuild payload declares dtypes {declared}, this build expects {_DTYPES}")

        def arr(key: str) -> np.ndarray:
            v = payload[key]
            if isinstance(v, (bytes, bytearray)):
                return np.frombuffer(v, dtype=_DTYPES[key])
            return np.asarray(v, dtype=_DTYPES[key])

        return cls(
            terms=list(payload["terms"]),
            indptr=arr("indptr"),
            rows=arr("rows"),
            tfs=arr("tfs"),
            doc_len=arr("doc_len"),
            n_docs=int(payload["n_docs"]),
            total_len=int(payload["total_len"]),
            n_rows=int(payload["n_rows"]),
        )


def build_shard(
    texts: Sequence[str],
    n_rows: Optional[int] = None,
    stopwords=STOPWORDS,
    min_token_len: int = 2,
    use_native: Optional[bool] = None,
) -> ShardBuild:
    """Tokenize one shard's documents into a :class:`ShardBuild`:
    ``texts[i]`` occupies shard-local row ``i``; ``n_rows`` reserves a
    larger local row space. ``use_native=None`` takes the native bulk
    builder when it loads and the Python tokenizer otherwise; both give
    the same build."""
    n_docs = len(texts)
    cap = n_docs if n_rows is None else int(n_rows)
    if cap < n_docs:
        raise InvalidConfigError(f"n_rows={cap} smaller than the {n_docs} documents provided")

    native = None
    if use_native is not False:
        try:
            from trueno_rag_tpu_torch.native import NativeBM25Builder, native_available

            if native_available():
                native = NativeBM25Builder(min_token_len=min_token_len, stopwords=stopwords)
        except Exception:
            if use_native is True:
                raise
    if use_native is True and native is None:
        raise InvalidConfigError("use_native=True but the native builder is unavailable")

    doc_len = np.zeros(max(cap, 1), dtype=np.float32)
    if native is not None:
        counts = native.add_batch(np.arange(n_docs, dtype=np.int64), list(texts)) if n_docs else np.zeros(0, np.int32)
        export = native.export()
        doc_len[export["doc_len_rows"]] = export["doc_len_vals"]
        return ShardBuild(
            terms=list(export["terms"]),
            indptr=np.asarray(export["indptr"], dtype=np.int64),
            rows=np.asarray(export["rows"], dtype=np.int32),
            tfs=np.asarray(export["tfs"], dtype=np.float32),
            doc_len=doc_len,
            n_docs=n_docs,
            total_len=int(counts.sum()),
            n_rows=cap,
        )

    # Python path: BM25Index.add's accumulation without a registry
    postings: Dict[str, Dict[int, int]] = {}
    total_len = 0
    for row, text in enumerate(texts):
        toks = tokenize(text, stopwords=stopwords, min_len=min_token_len)
        doc_len[row] = len(toks)
        total_len += len(toks)
        tf: Dict[str, int] = {}
        for t in toks:
            tf[t] = tf.get(t, 0) + 1
        for term, count in tf.items():
            postings.setdefault(term, {})[row] = count
    terms = sorted(postings)
    indptr = np.zeros(len(terms) + 1, dtype=np.int64)
    np.cumsum([len(postings[t]) for t in terms], out=indptr[1:])
    pairs = [sorted(postings[t].items()) for t in terms]
    rows = np.asarray([r for p in pairs for r, _ in p], dtype=np.int32)
    tfs = np.asarray([c for p in pairs for _, c in p], dtype=np.float32)
    return ShardBuild(terms=terms, indptr=indptr, rows=rows, tfs=tfs, doc_len=doc_len,
                      n_docs=n_docs, total_len=total_len, n_rows=cap)


def _check_blocks(n_blocks: int, mesh: Mesh, axis: str) -> int:
    s = mesh.shape[axis]
    if n_blocks != s:
        raise InvalidConfigError(f"got {n_blocks} shard blocks for a {s}-shard '{axis}' axis")
    return s


def assemble_row_sharded(blocks: Sequence, mesh: Mesh, axis: str = "data") -> RowSharded:
    """A row-sharded value from per-shard host blocks (numpy or tensors),
    each copied straight to its shard's device: the full array never
    exists on the host, so peak host memory is the caller's one block at
    a time. All blocks must share a shape; dim 0 concatenates across
    shards."""
    _check_blocks(len(blocks), mesh, axis)
    bshape = tuple(blocks[0].shape)
    if bshape[0] == 0:
        raise InvalidConfigError(
            "shard blocks have zero rows — build the index after the first documents arrive "
            "(an empty sharded index has no row space to partition)"
        )
    for blk in blocks:
        if tuple(blk.shape) != bshape:
            raise InvalidConfigError(f"shard blocks must share a shape, got {tuple(blk.shape)} vs {bshape}")
    return RowSharded([_to_device(blk, dev) for blk, dev in zip(blocks, mesh.axis_devices(axis))], mesh, axis)


def _to_device(block, dev: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A fresh copy of one host block on ``dev`` (never a view of the
    caller's array, also on the CPU)."""
    t = block if isinstance(block, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(block))
    return t.to(dev, dtype=dtype or t.dtype, copy=True)


def merge_shard_stats(builds: Sequence[ShardBuild]) -> Tuple[List[str], Dict[str, int], np.ndarray, int, float]:
    """Exact global statistics from shard-local builds → ``(terms, vocab,
    idf [G] f32, n_docs, avgdl)``: per-term df is the sum of the local
    posting counts, avgdl the global length total over the global document
    count; idf is ``BM25Index``'s float64 ``ln((N − df + 0.5)/(df + 0.5) +
    1)`` rounded once to f32, with the ``max(df, 1)`` guard. Global term
    ids are the sorted terms."""
    df_by_term: Dict[str, int] = {}
    n_docs = 0
    total_len = 0
    for b in builds:
        for t, c in zip(b.terms, np.diff(b.indptr)):
            df_by_term[t] = df_by_term.get(t, 0) + int(c)
        n_docs += b.n_docs
        total_len += b.total_len
    terms = sorted(df_by_term)
    vocab = {t: i for i, t in enumerate(terms)}
    n = max(n_docs, 1)
    df = np.maximum(np.asarray([df_by_term[t] for t in terms], dtype=np.float64), 1.0)
    idf = np.log((n - df + 0.5) / (df + 0.5) + 1.0).astype(np.float32)
    if idf.size == 0:
        idf = np.zeros(1, dtype=np.float32)
    avgdl = total_len / n_docs if n_docs else 0.0
    return terms, vocab, idf, n_docs, avgdl
