"""Persistence: compressed index artifacts and model checkpoints.

PyTorch-port counterpart of ``trueno_rag_tpu/persist.py``, in the same
wire formats, so an artifact written by either package loads in the
other:

- index artifacts: v1 is one MessagePack payload (chunks, BM25 state,
  tags, cluster layout, config, embedder identity, the embedding matrix as
  raw float32 bytes) in a codec frame ``MAGIC | codec\\0 | compressed
  payload``; v2 (:func:`save_index_streaming`) is a header plus
  independently compressed matrix frames;
- token-index artifacts (:func:`save_token_index`) and learned-sparse
  (SPLADE) index artifacts (:func:`save_splade_index`); an index
  artifact of a tri-hybrid carries the learned expansions too, re-attached
  on load when the caller passes the encoder (its weights' fingerprint
  checked);
- model checkpoints: safetensors files (:func:`save_params`).

Codecs: ``zlib`` (stdlib), ``lz4`` (the system liblz4 via ctypes,
probed), ``zstd`` when the ``zstandard`` package imports (then the
default, else zlib). A codec that is missing raises
:class:`SerializationError`; nothing is decoded another way. MessagePack
is :mod:`trueno_rag_tpu_torch._msgpack` and the safetensors layout is read
and written here, so no ``msgpack`` or ``safetensors`` package is needed.

Large artifacts: the BM25 postings are encoded and decoded in bulk (numpy),
the chunk list is encoded in one pass per chunk, and a large zlib payload
and the v2 matrix frames are compressed on a thread pool; the bytes are
what the one-entry-at-a-time path would give.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import enum
import json
import os
import zlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from trueno_rag_tpu_torch import _msgpack
from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.errors import IndexNotFoundError, InvalidConfigError, SerializationError

MAGIC = b"TRAGv1\x00"
MAGIC2 = b"TRAGv2\x00"  # streaming container: header + framed matrix

_zstd_module = None


def _zstd():
    """The ``zstandard`` module, or None where it does not import."""
    global _zstd_module
    if _zstd_module is None:
        try:
            import zstandard

            _zstd_module = zstandard
        except ImportError:
            _zstd_module = False
    return _zstd_module or None


_ZLIB_BLOCK = 1 << 22  # bytes per deflate block of a large payload


def _zlib_compress(data: bytes, level: int) -> bytes:
    """A zlib stream of ``data``; past a few blocks, deflated block by
    block on a thread pool (pigz's scheme): each block raw-deflated with
    the previous 32 KiB as its dictionary and flushed to a byte boundary,
    the last one finished, behind the zlib header and before the Adler-32
    of the whole payload. Any zlib inflater reads it; the bytes depend on
    the data and level only."""
    if len(data) < 4 * _ZLIB_BLOCK:
        return zlib.compress(data, level)
    view = memoryview(data)
    starts = list(range(0, len(data), _ZLIB_BLOCK))

    def block(lo: int) -> bytes:
        kw = {"zdict": view[lo - 32768:lo]} if lo else {}
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, zlib.Z_DEFAULT_STRATEGY, **kw)
        last = lo + _ZLIB_BLOCK >= len(data)
        return co.compress(view[lo:lo + _ZLIB_BLOCK]) + co.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)

    body = _msgpack.map_slabs(block, starts)
    flevel = 0 if level in (0, 1) else 1 if 2 <= level <= 5 else 2 if level in (-1, 6) else 3
    cmf, flg = 0x78, flevel << 6
    flg |= 31 - ((cmf << 8) | flg) % 31
    return bytes((cmf, flg)) + b"".join(body) + zlib.adler32(data).to_bytes(4, "big")


class Compression(str, enum.Enum):
    """Codec selection: zstd (the default where ``zstandard`` imports),
    lz4 (the system liblz4, the u32-LE size-prefixed block format, probed
    at runtime), zlib (always there) or none."""

    NONE = "none"
    ZLIB = "zlib"
    ZSTD = "zstd"
    LZ4 = "lz4"

    def compress(self, data: bytes, level: Optional[int] = None) -> bytes:
        if not data:
            return b""  # empty in -> empty out
        if self is Compression.NONE:
            return data
        if self is Compression.ZLIB:
            return _zlib_compress(data, level if level is not None else 6)
        if self is Compression.LZ4:
            from trueno_rag_tpu_torch import _lz4

            return _lz4.compress(data)
        if self is Compression.ZSTD:
            zstd = _zstd()
            if zstd is None:
                raise SerializationError("zstandard not available")
            return zstd.ZstdCompressor(level=level if level is not None else 3).compress(data)
        raise SerializationError(f"unknown codec {self}")

    def decompress(self, data: bytes) -> bytes:
        if not data:
            return b""
        if self is Compression.NONE:
            return data
        if self is Compression.ZLIB:
            return zlib.decompress(data)
        if self is Compression.LZ4:
            from trueno_rag_tpu_torch import _lz4

            return _lz4.decompress(data)
        if self is Compression.ZSTD:
            zstd = _zstd()
            if zstd is None:
                raise SerializationError("zstandard not available")
            return zstd.ZstdDecompressor().decompress(data)
        raise SerializationError(f"unknown codec {self}")

    @property
    def is_available(self) -> bool:
        if self is Compression.LZ4:
            from trueno_rag_tpu_torch import _lz4

            return _lz4.available()
        if self is Compression.ZSTD:
            return _zstd() is not None
        return True


def default_compression() -> Compression:
    return Compression.ZSTD if _zstd() is not None else Compression.ZLIB


# ---------------------------------------------------------------------------
# Generic compressed (de)serialization
# ---------------------------------------------------------------------------


def serialize_compressed(obj: Any, codec: Optional[Compression] = None) -> bytes:
    """MessagePack + codec with a self-describing frame."""
    codec = codec or default_compression()
    try:
        payload = _msgpack.pack(obj)
    except (TypeError, ValueError) as e:
        raise SerializationError(f"cannot serialize: {e}") from e
    return MAGIC + codec.value.encode() + b"\x00" + codec.compress(payload)


def deserialize_compressed(data: bytes, hooks=None) -> Any:
    """The object of :func:`serialize_compressed`'s frame (``hooks``: bulk
    decoders by key path, :func:`_msgpack.unpack`)."""
    if not data.startswith(MAGIC):
        raise SerializationError("bad magic: not a trueno_rag_tpu artifact")
    rest = data[len(MAGIC):]
    try:
        sep = rest.index(b"\x00")
        codec = Compression(rest[:sep].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise SerializationError(f"corrupt codec frame: {e}") from e
    try:
        return _msgpack.unpack(codec.decompress(rest[sep + 1:]), hooks=hooks)
    except Exception as e:
        raise SerializationError(f"cannot deserialize: {e}") from e


# ---------------------------------------------------------------------------
# Bulk sections
# ---------------------------------------------------------------------------

_CHUNK_KEYS = [_msgpack.pack(k) for k in ("id", "document_id", "content", "start_offset",
                                          "end_offset", "metadata")]


def _chunk_to_wire(c: Chunk) -> Dict[str, Any]:
    """``Chunk.to_dict()`` without the embedding (embeddings travel in the
    matrix, not per chunk)."""
    return {
        "id": c.id,
        "document_id": c.document_id,
        "content": c.content,
        "start_offset": c.start_offset,
        "end_offset": c.end_offset,
        "metadata": c.metadata.to_dict(),
    }


def _pack_chunks(chunks: Sequence[Chunk]) -> _msgpack.Raw:
    """``[_chunk_to_wire(c) for c in chunks]`` as MessagePack, each chunk's
    pieces laid out in one pass."""
    keys, pack_str, pack_int = _CHUNK_KEYS, _msgpack.pack_str, _msgpack.pack_int
    out = [_msgpack.array_header(len(chunks))]
    for c in chunks:
        cid, doc, text, start, end, md = c.id, c.document_id, c.content, c.start_offset, c.end_offset, c.metadata
        if not (type(cid) is type(doc) is type(text) is str and type(start) is type(end) is int):
            out.append(_msgpack.pack(_chunk_to_wire(c)))  # subclasses: the generic encoder
            continue
        out.extend((
            b"\x86", keys[0], pack_str(cid), keys[1], pack_str(doc), keys[2], pack_str(text),
            keys[3], pack_int(start), keys[4], pack_int(end), keys[5], _msgpack.pack(md.to_dict()),
        ))
    return _msgpack.Raw(b"".join(out))


_HEADER_HOOKS = {
    ("bm25", "postings"): _msgpack.postings_hook,
    ("bm25", "doc_len"): _msgpack.int_map_hook,
    ("bm25_rows",): _msgpack.int_map_hook,
}


def _int_pairs(m):
    """An int map decoded by :func:`_msgpack.int_map_hook` (or as a dict)
    → (keys int64, values int64)."""
    if isinstance(m, dict):
        return (np.fromiter((int(k) for k in m), dtype=np.int64, count=len(m)),
                np.fromiter((int(v) for v in m.values()), dtype=np.int64, count=len(m)))
    return m


# ---------------------------------------------------------------------------
# Index artifacts
# ---------------------------------------------------------------------------


def _tag_wire(reg, ordered_ids) -> Dict[str, Any]:
    vocab, rows = reg.tag_state(ordered_ids)
    return {"vocab": vocab, "rows": rows}


def _cluster_wire(store, rows) -> Optional[Dict[str, Any]]:
    """Clustered tier: the k-means layout, remapped to saved-chunk order,
    so a load with scan_tier="clustered" skips re-clustering. Only when
    the store is clean: a mutation since the last clustered build leaves
    ``_cluster`` describing stale rows. ``order`` entries are store rows;
    the artifact re-inserts chunks in saved order (saved index i → loaded
    row i), so store rows map to saved indices; holes become -1."""
    if getattr(store, "_cluster", None) is None or store._dirty:
        return None
    order = np.asarray(store._cluster[0], dtype=np.int64)
    size = max(int(order.max()) + 1 if len(order) else 0, max(rows) + 1 if rows else 0, 1)
    saved_of_row = np.full(size, -1, np.int64)
    saved_of_row[np.asarray(rows, dtype=np.int64)] = np.arange(len(rows))
    order_saved = np.where(order >= 0, saved_of_row[np.maximum(order, 0)], -1).astype(np.int32)
    cent = store._cluster[2].float().cpu().numpy()
    radii = store._cluster[3].float().cpu().numpy()
    return {
        "tile": int(order.shape[0] // len(radii)),
        "order": order_saved.tobytes(),
        "centroids": np.ascontiguousarray(cent, dtype=np.float32).tobytes(),
        "centroids_dim": int(cent.shape[1]),
        "radii": np.ascontiguousarray(radii, dtype=np.float32).tobytes(),
    }


def _bm25_wire(sparse) -> Dict[str, Any]:
    """The BM25 ``state_dict()`` with the postings and lengths encoded in
    bulk from the index's CSR (terms sorted, rows ascending)."""
    st = sparse.csr_state()
    return {
        "k1": sparse.k1,
        "b": sparse.b,
        "min_token_len": sparse.min_token_len,
        "stopwords": sorted(sparse.stopwords),
        "postings": _msgpack.pack_postings(st["terms"], st["indptr"], st["rows"], st["tfs"]),
        "doc_len": _msgpack.pack_int_map(st["doc_len_rows"], st["doc_len_vals"]),
        "total_len": int(st["total_len"]),
    }


def _learned_wire(retriever, rows) -> Optional[Dict[str, Any]]:
    """A tri-hybrid's learned-sparse expansions as a ragged CSR in saved
    chunk order (weight bytes round-trip, so scores after a load are
    identical) with the encoder's expansion config and identity (seed,
    weights fingerprint). The encoder's weights travel separately."""
    li = getattr(retriever, "learned_index", None)
    if li is None:
        return None
    enc = retriever.learned_encoder
    indptr, terms, weights = li.row_expansions(rows)
    return {
        "encoder": {
            "max_len": enc.max_len,
            "doc_top": enc.doc_top,
            "query_top": enc.query_top,
            "seed": getattr(enc, "seed", None),
            "params_fingerprint": enc.params_fingerprint(),
        },
        "indptr": indptr.tobytes(),
        "terms": terms.tobytes(),
        "weights": weights.tobytes(),
    }


def _build_header(retriever, embedder_info) -> tuple:
    """Everything an index artifact carries except the embedding matrix
    (shared by the v1 and v2 writers) → (header, chunk ids in saved order,
    their store rows)."""
    reg = retriever.registry
    store = retriever.vector_store
    ids = list(reg.ids())
    rows = [reg.row_of(cid) for cid in ids]
    header = {
        "format": "trueno-rag-tpu-index",
        "dimension": store.dimension,
        "metric": store.config.metric,
        # layout choices the load must not silently downgrade
        "compact_scan": store.config.compact_scan,
        "chunks": _pack_chunks([reg.get_chunk(cid) for cid in ids]),
        "bm25": _bm25_wire(retriever.sparse_index),
        "bm25_rows": _msgpack.pack_int_map(rows, np.arange(len(rows))),
        "retriever_config": {
            "candidates_per_source": retriever.config.candidates_per_source,
            "fusion": retriever.config.fusion.to_dict(),
            "use_dense": retriever.config.use_dense,
            "use_sparse": retriever.config.use_sparse,
            "use_learned": retriever.config.use_learned,
        },
        "embedder": embedder_info or {},
        "tags": _tag_wire(reg, ids),
    }
    cluster = _cluster_wire(store, rows)
    if cluster is not None:
        header["cluster"] = cluster
    learned = _learned_wire(retriever, rows)
    if learned is not None:
        header["learned"] = learned
    return header, ids, rows


def _atomic_writer(path: str):
    """Write to path+'.tmp' then os.replace: a crash or a full disk
    mid-write must not destroy the previous good artifact."""

    @contextlib.contextmanager
    def cm():
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                yield f
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    return cm()


def save_index(path: str, retriever, embedder_info: Optional[Dict[str, Any]] = None,
               codec: Optional[Compression] = None) -> Dict[str, Any]:
    """Persist a HybridRetriever (chunks, dense matrix, BM25 state, tags,
    a clean clustered layout) as one v1 blob. The matrix is stored
    row-aligned with the saved chunk order, so a load reconstructs the same
    rows and scores. Atomic write (tmp + rename). → stats (sizes)."""
    store = retriever.vector_store
    payload, ids, rows = _build_header(retriever, embedder_info)
    payload["version"] = 1
    matrix = store._host[rows] if rows else np.zeros((0, store.dimension), np.float32)
    payload["embeddings_raw"] = np.ascontiguousarray(matrix, dtype=np.float32).tobytes()
    blob = serialize_compressed(payload, codec)
    with _atomic_writer(path) as f:
        f.write(blob)
    reg = retriever.registry
    raw = len(payload["embeddings_raw"]) + sum(len(reg.get_chunk(c).content) for c in ids)
    return {"compressed_bytes": len(blob), "raw_bytes_estimate": raw, "chunks": len(ids)}


def _loaded_vector_config(dimension: int, scan_tier: Optional[str], metric: str,
                          compact_scan: Optional[str] = None):
    """VectorStoreConfig for a loaded artifact: the saved ``metric`` and
    ``compact_scan`` layout, and ``scan_tier`` when given."""
    from trueno_rag_tpu_torch.index.vector_store import VectorStoreConfig

    kw = {"dimension": dimension, "metric": metric}
    if scan_tier is not None:
        kw["scan_tier"] = scan_tier
    if compact_scan is not None:  # absent in older artifacts
        kw["compact_scan"] = compact_scan
    return VectorStoreConfig(**kw)


def _retriever_from_header(header, embedder, scan_tier, device):
    """The empty retriever of an artifact header."""
    from trueno_rag_tpu_torch.fusion import FusionStrategy
    from trueno_rag_tpu_torch.retrieve import HybridRetriever, HybridRetrieverConfig

    if header.get("format") != "trueno-rag-tpu-index":
        raise SerializationError("not a trueno-rag-tpu index artifact")
    rcfg = header["retriever_config"]
    config = HybridRetrieverConfig(
        candidates_per_source=rcfg["candidates_per_source"],
        fusion=FusionStrategy.from_dict(rcfg["fusion"]),
        use_dense=rcfg["use_dense"],
        use_sparse=rcfg["use_sparse"],
        use_learned=rcfg.get("use_learned", True),
    )
    return HybridRetriever(
        embedder, config=config,
        vector_config=_loaded_vector_config(
            header["dimension"], scan_tier, header.get("metric", "cosine"), header.get("compact_scan"),
        ),
        device=device,
    )


def _chunks_of(chunk_dicts, start: int, n: int):
    return [Chunk.from_dict(chunk_dicts[i]) for i in range(start, start + n)]


def _insert_block(retr, chunk_dicts, block: np.ndarray, start: int) -> None:
    """Restore one matrix block's chunks at rows ``start..`` (saved index
    i == row i), the rows as saved (no re-normalization)."""
    chunks = _chunks_of(chunk_dicts, start, block.shape[0])
    for r, chunk in enumerate(chunks):
        chunk.embedding = block[r]
    retr.vector_store.load_rows(chunks, block)


def _bm25_csr(state: Dict[str, Any], row_remap: np.ndarray):
    """A saved BM25 state's postings and lengths (bulk-decoded or dicts)
    → CSR arrays at the loaded rows."""
    post = state["postings"]
    if isinstance(post, dict):  # decoded without the hook
        post = _msgpack.postings_hook(_msgpack.pack(post), 0)[0]
    terms, indptr, rows, tfs = post
    dl_rows, dl_vals = _int_pairs(state["doc_len"])

    def remap(r):
        if len(r) and (r.min() < 0 or r.max() >= len(row_remap) or (row_remap[r] < 0).any()):
            raise SerializationError("BM25 state names a row the artifact does not hold")
        return row_remap[r]

    return terms, indptr, remap(rows), tfs, remap(dl_rows), dl_vals


def _finish_load(retr, header, scan_tier, learned_encoder=None):
    """BM25 state remap, tags, the clustered preset and, with
    ``learned_encoder``, the learned-sparse expansions (shared by both
    loaders; saved order is row order because the loads allocate rows
    0..n-1 in sequence)."""
    keys, vals = _int_pairs(header["bm25_rows"])
    row_remap = np.full(int(keys.max()) + 1 if len(keys) else 0, -1, dtype=np.int64)
    row_remap[keys] = vals
    state = header["bm25"]
    terms, indptr, rows, tfs, dl_rows, dl_vals = _bm25_csr(state, row_remap)
    retr.sparse_index.load_csr(
        terms, indptr, rows, tfs, dl_rows, dl_vals, int(state["total_len"]),
        k1=float(state["k1"]), b=float(state["b"]),
        min_token_len=int(state.get("min_token_len", 2)),
        stopwords=state.get("stopwords"),
    )
    tags = header.get("tags")
    if tags:
        retr.registry.load_tag_state(tags["vocab"], tags["rows"])
    cluster = header.get("cluster")
    if cluster and scan_tier == "clustered":
        # installed after the inserts (each insert clears the preset); the
        # layout is tile-coupled, so the store adopts the artifact's tile
        d = cluster["centroids_dim"]
        retr.vector_store.config.scan_tile_n = max(int(cluster["tile"]), 128)
        retr.vector_store._cluster_preset = {
            "tile": int(cluster["tile"]),
            "order": np.frombuffer(cluster["order"], dtype=np.int32).copy(),
            "centroids": np.frombuffer(cluster["centroids"], dtype=np.float32).reshape(-1, d).copy(),
            "radii": np.frombuffer(cluster["radii"], dtype=np.float32).copy(),
        }
    learned = header.get("learned")
    if learned is not None and learned_encoder is not None:
        # the postings are the SAVED encoder's document expansions: a query
        # encoder with other weights would score them as noise, silently
        saved_fp = (learned.get("encoder") or {}).get("params_fingerprint")
        if saved_fp is not None:
            got_fp = learned_encoder.params_fingerprint()
            if got_fp != saved_fp:
                raise InvalidConfigError(
                    "learned_encoder does not match this artifact's learned-sparse model "
                    f"(saved fingerprint {saved_fp}, supplied {got_fp}); rebuild the encoder "
                    "with the original seed/params (read_index_info()['learned'])"
                )
        from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex

        indptr = np.frombuffer(learned["indptr"], np.int64)
        li = LearnedSparseIndex(registry=retr.registry, device=retr.device)
        li.load_rows([retr.registry.chunk_of(i) for i in range(len(indptr) - 1)], indptr,
                     np.frombuffer(learned["terms"], np.int32), np.frombuffer(learned["weights"], np.float32))
        retr.learned_encoder = learned_encoder
        retr.learned_index = li
    # without an encoder a learned section is skipped: a two-source hybrid
    return retr


def read_index_info(path: str) -> Dict[str, Any]:
    """Artifact metadata without rebuilding the index: embedder identity,
    dimension, metric, chunk dicts, format version, the learned-sparse
    expansion config (v1 and v2; v2's matrix frames are never read)."""
    if not os.path.exists(path):
        raise IndexNotFoundError(f"no index at {path}")
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC2))
        if magic == MAGIC2:
            _, payload = _read_streaming_header(f)
        else:
            payload = deserialize_compressed(magic + f.read(), hooks=_HEADER_HOOKS)
    if payload.get("format") != "trueno-rag-tpu-index":
        raise SerializationError("not a trueno-rag-tpu index artifact")
    return {
        "embedder": payload.get("embedder", {}),
        "dimension": payload.get("dimension"),
        "metric": payload.get("metric", "cosine"),
        "version": payload.get("version", 1),
        "chunks": payload.get("chunks", []),
        "learned": (payload.get("learned") or {}).get("encoder"),
    }


def load_index(path: str, embedder, codec: Optional[Compression] = None,
               scan_tier: Optional[str] = None, learned_encoder=None, device=None):
    """Rebuild a HybridRetriever from a saved artifact (either package's,
    v1 or v2) on ``device`` (default: the card) → ``(retriever, embedder
    info)``. ``embedder`` is supplied by the caller (the artifact's
    ``embedder`` dict says which; :func:`read_index_info` peeks without
    loading). ``scan_tier`` configures the store's tier (default fp32); a
    saved clustered layout is the preset of ``scan_tier="clustered"`` (no
    k-means on load). ``learned_encoder`` (a SpladeEncoder with the weights
    the index was built with; ``read_index_info()['learned']`` gives its
    expansion config) re-attaches a saved learned-sparse section, its
    expansions restored verbatim, after checking its weights' fingerprint;
    without one such an artifact loads as a two-source hybrid."""
    if not os.path.exists(path):
        raise IndexNotFoundError(f"no index at {path}")
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC2))
        if magic == MAGIC2:  # v2 streaming container
            return _load_index_streaming(f, embedder, scan_tier, device, learned_encoder)
        payload = deserialize_compressed(magic + f.read(), hooks=_HEADER_HOOKS)
    retr = _retriever_from_header(payload, embedder, scan_tier, device)
    dim = payload["dimension"]
    n = len(payload["chunks"])
    try:
        matrix = np.frombuffer(payload["embeddings_raw"], dtype=np.float32).reshape(n, dim)
    except ValueError as e:
        raise SerializationError(f"corrupt embedding matrix: {e}") from e
    _insert_block(retr, payload["chunks"], matrix, 0)
    _finish_load(retr, payload, scan_tier, learned_encoder)
    return retr, payload.get("embedder", {})


# ---------------------------------------------------------------------------
# Streaming index artifacts (multi-GB indexes)
# ---------------------------------------------------------------------------


_WORKERS = _msgpack.WORKERS  # threads that compress matrix frames


def _pool():
    return concurrent.futures.ThreadPoolExecutor(max_workers=_WORKERS)


def save_index_streaming(
    path: str,
    retriever,
    embedder_info: Optional[Dict[str, Any]] = None,
    codec: Optional[Compression] = None,
    frame_rows: int = 65536,
) -> Dict[str, Any]:
    """Persist a HybridRetriever with the embedding matrix written as
    independent compressed frames of ``frame_rows`` rows each (compressed
    on a thread pool, written in order; a few frames in memory at a time).
    Atomic write (tmp + rename). Layout::

        MAGIC2 | codec\\0 | u64 header_len | compressed header |
        { u64 comp_len | u64 raw_len | compressed rows }*

    :func:`load_index` reads both formats."""
    codec = codec or default_compression()
    header, ids, id_rows = _build_header(retriever, embedder_info)
    header["version"] = 2
    store = retriever.vector_store
    n = len(ids)
    header["n_rows"] = n
    header["frame_rows"] = frame_rows
    hdr_c = codec.compress(_msgpack.pack(header))
    rows = np.asarray(id_rows, dtype=np.int64)
    total_c = 0

    def frame(lo: int) -> Tuple[bytes, int]:
        raw = np.ascontiguousarray(store._host[rows[lo:lo + frame_rows]], dtype=np.float32).tobytes()
        return codec.compress(raw), len(raw)

    with _atomic_writer(path) as f, _pool() as pool:
        f.write(MAGIC2 + codec.value.encode() + b"\x00")
        f.write(len(hdr_c).to_bytes(8, "little"))
        f.write(hdr_c)
        starts = list(range(0, n, frame_rows))
        width = 2 * _WORKERS
        pending = [pool.submit(frame, lo) for lo in starts[:width]]
        for i in range(len(starts)):
            comp, raw_len = pending[i].result()
            pending[i] = None
            if i + width < len(starts):
                pending.append(pool.submit(frame, starts[i + width]))
            f.write(len(comp).to_bytes(8, "little"))
            f.write(raw_len.to_bytes(8, "little"))
            f.write(comp)
            total_c += len(comp)
    return {
        "compressed_bytes": os.path.getsize(path),
        "matrix_frames": -(-n // frame_rows) if n else 0,
        "matrix_compressed_bytes": total_c,
        "chunks": n,
    }


def _read_exact(f, nbytes: int, what: str) -> bytes:
    """Read exactly nbytes or raise: a short read means a truncated
    artifact."""
    data = f.read(nbytes)
    if len(data) != nbytes:
        raise SerializationError(f"truncated artifact ({what})")
    return data


def _read_streaming_header(f, hooks=None):
    """After MAGIC2: parse (codec, header dict)."""
    codec_bytes = b""
    while True:
        ch = f.read(1)
        if not ch:
            raise SerializationError("truncated artifact (codec id)")
        if ch == b"\x00":
            break
        codec_bytes += ch
    try:
        codec = Compression(codec_bytes.decode())
    except ValueError as e:
        raise SerializationError(f"unknown codec id: {e}") from e
    hdr_len = int.from_bytes(_read_exact(f, 8, "header length"), "little")
    header = _msgpack.unpack(codec.decompress(_read_exact(f, hdr_len, "header")),
                             hooks=hooks or _HEADER_HOOKS)
    return codec, header


def _load_index_streaming(f, embedder, scan_tier, device, learned_encoder=None):
    """Resume after MAGIC2: codec id, compressed header, then each matrix
    frame decompressed and inserted in order."""
    codec, header = _read_streaming_header(f)
    retr = _retriever_from_header(header, embedder, scan_tier, device)
    dim = header["dimension"]
    n = header["n_rows"]
    chunk_dicts = header["chunks"]
    loaded = 0
    while loaded < n:
        comp_len = int.from_bytes(_read_exact(f, 8, "frame length"), "little")
        raw_len = int.from_bytes(_read_exact(f, 8, "frame length"), "little")
        if raw_len == 0:
            # a zero-row frame can never advance: fail rather than spin
            raise SerializationError("empty matrix frame (truncated artifact?)")
        raw = codec.decompress(_read_exact(f, comp_len, "matrix frame"))
        if len(raw) != raw_len or raw_len % (4 * dim):
            raise SerializationError("corrupt matrix frame")
        block = np.frombuffer(raw, dtype=np.float32).reshape(-1, dim)
        _insert_block(retr, chunk_dicts, block[: n - loaded], loaded)
        loaded += block.shape[0]
    _finish_load(retr, header, scan_tier, learned_encoder)
    return retr, header.get("embedder", {})


# ---------------------------------------------------------------------------
# Token (late-interaction) index artifacts
# ---------------------------------------------------------------------------


def save_token_index(path: str, retriever, codec: Optional[Compression] = None) -> Dict[str, Any]:
    """Persist a LateInteractionRetriever's token store (chunks, the
    ``[M, Lt, H]`` token matrix, masks, tags, store config). Token bytes
    round-trip exactly (the loader does not re-normalize), so MaxSim
    scores and certificates are identical after load. Encoder weights
    travel separately (:func:`save_params`). Atomic write."""
    store = retriever.store
    reg = store.registry
    cfg = store.config
    ids = [cid for cid in reg.ids() if reg.row_of(cid) is not None and store._valid[reg.row_of(cid)]]
    rows = [reg.row_of(cid) for cid in ids]
    tok = (np.ascontiguousarray(store._host[rows], dtype=np.float32) if rows
           else np.zeros((0, cfg.max_tokens, cfg.hidden_dim), np.float32))
    tm = np.ascontiguousarray(store._t_mask[rows]) if rows else np.zeros((0, cfg.max_tokens), bool)
    payload = {
        "format": "trueno-rag-tpu-token-index",
        "version": 1,
        "store_config": {
            "hidden_dim": cfg.hidden_dim,
            "max_tokens": cfg.max_tokens,
            "storage_dtype": cfg.storage_dtype,
            "scan": cfg.scan,
            "scan_dtype": cfg.scan_dtype,
            "scan_kernel": cfg.scan_kernel,
            "t_hits": cfg.t_hits,
            "rescore": cfg.rescore,
            "scan_block": cfg.scan_block,
            "normalize": cfg.normalize,
        },
        "encoder": {"max_len": retriever.max_len},
        "chunks": _pack_chunks([reg.get_chunk(cid) for cid in ids]),
        "tokens_raw": tok.tobytes(),
        "t_mask_raw": np.packbits(tm).tobytes() if len(rows) else b"",
        "tags": _tag_wire(reg, ids),
    }
    blob = serialize_compressed(payload, codec)
    with _atomic_writer(path) as f:
        f.write(blob)
    return {"compressed_bytes": len(blob), "raw_bytes_estimate": tok.nbytes, "chunks": len(ids)}


def load_token_index(path: str, encoder_config=None, params: Optional[Dict[str, Any]] = None,
                     seed: int = 0, scan: Optional[str] = None, device=None):
    """Rebuild a LateInteractionRetriever from :func:`save_token_index`
    (either package's) on ``device``. The encoder identity (the port's
    ``EncoderConfig``, its parameters or a seed) is supplied by the
    caller; ``scan`` overrides the stored scan tier."""
    if not os.path.exists(path):
        raise IndexNotFoundError(f"no token index at {path}")
    with open(path, "rb") as f:
        payload = deserialize_compressed(f.read())
    if payload.get("format") != "trueno-rag-tpu-token-index":
        raise SerializationError(f"not a token-index artifact: {payload.get('format')!r}")
    from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig
    from trueno_rag_tpu_torch.models.late_interaction import LateInteractionRetriever

    sc = dict(payload["store_config"])
    if scan is not None:
        sc["scan"] = scan
    store_config = TokenStoreConfig(**sc)
    retr = LateInteractionRetriever(
        config=encoder_config, params=params, seed=seed,
        max_len=int(payload["encoder"]["max_len"]), store_config=store_config, device=device,
    )
    chunk_dicts = payload["chunks"]
    m = len(chunk_dicts)
    lt, h = store_config.max_tokens, store_config.hidden_dim
    try:
        tok = np.frombuffer(payload["tokens_raw"], dtype=np.float32).reshape(m, lt, h)
        tm = (np.unpackbits(np.frombuffer(payload["t_mask_raw"], dtype=np.uint8), count=m * lt)
              .astype(bool).reshape(m, lt) if m else np.zeros((0, lt), bool))
    except ValueError as e:
        raise SerializationError(f"corrupt token matrix: {e}") from e
    retr.store.load_rows(_chunks_of(chunk_dicts, 0, m), tok.copy(), tm)
    tags = payload.get("tags")
    if tags:
        retr.store.registry.load_tag_state(tags["vocab"], tags["rows"])
    return retr


# ---------------------------------------------------------------------------
# Learned-sparse (SPLADE) index artifacts
# ---------------------------------------------------------------------------


def save_splade_index(path: str, retriever, codec: Optional[Compression] = None) -> Dict[str, Any]:
    """Persist a SpladeRetriever's posting index (chunks, each chunk's
    expansion as a ragged CSR, tags, the expansion config). Weights
    round-trip exactly (f32 bytes), so scores after a load are identical.
    Encoder weights travel separately (:func:`save_params`). Atomic write
    → stats (bytes, postings, chunks)."""
    idx = retriever.index_store
    reg = idx.registry
    ids = [cid for cid in reg.ids() if reg.row_of(cid) in idx._row_terms]
    indptr, terms, weights = idx.row_expansions([reg.row_of(cid) for cid in ids])
    enc = retriever.encoder
    payload = {
        "format": "trueno-rag-tpu-splade-index",
        "version": 1,
        "encoder": {"max_len": enc.max_len, "doc_top": enc.doc_top, "query_top": enc.query_top},
        "chunks": _pack_chunks([reg.get_chunk(cid) for cid in ids]),
        "indptr": indptr.tobytes(),
        "terms": terms.tobytes(),
        "weights": weights.tobytes(),
        "tags": _tag_wire(reg, ids),
    }
    blob = serialize_compressed(payload, codec)
    with _atomic_writer(path) as f:
        f.write(blob)
    return {"compressed_bytes": len(blob), "postings": len(terms), "chunks": len(ids)}


def load_splade_index(path: str, encoder_config=None, params: Optional[Dict[str, Any]] = None,
                      seed: int = 0, device=None):
    """Rebuild a SpladeRetriever from :func:`save_splade_index` (either
    package's) on ``device``. The encoder identity (the port's
    ``EncoderConfig``, its parameters or a seed) is supplied by the caller
    and must be the one the index was built with."""
    if not os.path.exists(path):
        raise IndexNotFoundError(f"no splade index at {path}")
    with open(path, "rb") as f:
        payload = deserialize_compressed(f.read())
    if payload.get("format") != "trueno-rag-tpu-splade-index":
        raise SerializationError(f"not a splade-index artifact: {payload.get('format')!r}")
    from trueno_rag_tpu_torch.models.splade import SpladeRetriever

    enc = payload["encoder"]
    retr = SpladeRetriever(config=encoder_config, params=params, seed=seed, max_len=int(enc["max_len"]),
                           doc_top=int(enc["doc_top"]), query_top=int(enc["query_top"]), device=device)
    chunk_dicts = payload["chunks"]
    retr.index_store.load_rows(
        _chunks_of(chunk_dicts, 0, len(chunk_dicts)), np.frombuffer(payload["indptr"], np.int64),
        np.frombuffer(payload["terms"], np.int32), np.frombuffer(payload["weights"], np.float32),
    )
    tags = payload.get("tags")
    if tags:
        retr.registry.load_tag_state(tags["vocab"], tags["rows"])
    return retr


# ---------------------------------------------------------------------------
# Model checkpoints (safetensors)
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8, "BOOL": np.bool_,
}
_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def save_params(path: str, params: Dict[str, Any], meta: Optional[Dict[str, str]] = None) -> None:
    """Write ``{name: array}`` as a safetensors file: a u64-LE header
    length, a JSON header (each tensor's dtype, shape and byte range, with
    ``__metadata__``), then the little-endian tensor bytes in name order,
    the header padded with spaces to 8 bytes (as ``safetensors.numpy``
    writes it)."""
    arrays = {}
    for k, v in params.items():
        a = np.asarray(v)
        arrays[k] = np.asarray(a.astype(a.dtype.newbyteorder("<"), copy=False), order="C")
    header: Dict[str, Any] = {}
    if meta:
        header["__metadata__"] = {str(k): str(v) for k, v in meta.items()}
    offset = 0
    order = sorted(arrays, key=lambda k: (-arrays[k].dtype.alignment, k))
    for k in order:
        a = arrays[k]
        if a.dtype not in _ST_NAMES:
            raise SerializationError(f"cannot save tensor {k!r} of dtype {a.dtype}")
        header[k] = {"dtype": _ST_NAMES[a.dtype], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with _atomic_writer(path) as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for k in order:
            f.write(arrays[k].tobytes())


def load_params(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Read a safetensors file → ``({name: array}, metadata)``."""
    if not os.path.exists(path):
        raise SerializationError(f"no checkpoint at {path}")
    with open(path, "rb") as f:
        data = f.read()
    try:
        n = int.from_bytes(data[:8], "little")
        header = json.loads(data[8:8 + n].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise SerializationError(f"corrupt safetensors header: {e}") from e
    if len(data) < 8 or 8 + n > len(data) or not isinstance(header, dict):
        raise SerializationError("truncated safetensors file")
    meta = {str(k): str(v) for k, v in (header.pop("__metadata__", None) or {}).items()}
    body = memoryview(data)[8 + n:]
    params = {}
    for k, spec in header.items():
        dt = _ST_DTYPES.get(spec.get("dtype"))
        lo, hi = spec["data_offsets"]
        shape = tuple(spec["shape"])
        if dt is None:
            raise SerializationError(f"tensor {k!r}: unsupported dtype {spec.get('dtype')!r}")
        if not 0 <= lo <= hi <= len(body) or hi - lo != int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize:
            raise SerializationError(f"tensor {k!r}: bad byte range")
        params[k] = np.frombuffer(body[lo:hi], dtype=np.dtype(dt).newbyteorder("<")).reshape(shape).copy()
    return params, meta
