"""The port's persistence against the JAX package's and the reference
packages: the MessagePack codec byte for byte against ``msgpack`` (nested
objects drawn by hypothesis, every length and int boundary, the bulk BM25
maps), the safetensors reader and writer against ``safetensors.numpy``;
index artifacts cross-loaded in both directions for every codec and both
formats (tags, ``metric="dot"``, the compact ``bf16rr`` layout, the
clustered layout), the JAX package's error types on damaged artifacts,
token-index artifacts, BM25 snapshots and model checkpoints in both
directions, and the port's persistence with none of ``msgpack``,
``zstandard`` or ``safetensors`` importable.

Answers are compared on the tie-free queries of ``test_torch_pipeline``
with its tolerances (documents of distinct lengths, so no two BM25 scores
tie)."""

import os
import pathlib
import subprocess
import sys
import zlib

import msgpack
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import trueno_rag_tpu as jrag
from trueno_rag_tpu import persist as jp
from trueno_rag_tpu.index.bm25 import BM25Index as JBM25

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import _msgpack
from trueno_rag_tpu_torch import persist as tp
from trueno_rag_tpu_torch.index.bm25 import BM25Index as TBM25

from test_torch_pipeline import QUERIES, _IdChunker, _same_results, _texts

ROOT = pathlib.Path(__file__).resolve().parents[1]
DIM = 32
K = 6


# -- MessagePack ------------------------------------------------------------------

def _ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(data):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


_scalars = (st.none() | st.booleans() | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
_objects = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=6)
    | st.dictionaries(st.text(max_size=8) | st.integers(-1000, 1000), inner, max_size=6),
    max_leaves=40,
)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_objects)
def test_pack_is_msgpacks_bytes_on_drawn_objects(obj):
    data = _msgpack.pack(obj)
    assert data == _ref_pack(obj)
    assert _msgpack.unpack(data) == _ref_unpack(data)


_INT_EDGES = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
              -1, -32, -33, -128, -129, -(2 ** 15), -(2 ** 15) - 1, -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)]
_LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("obj", _INT_EDGES + [1.5, -0.0, float("inf"), True, False, None, (1, "a")])
def test_pack_scalar_boundaries(obj):
    assert _msgpack.pack(obj) == _ref_pack(obj)
    assert _msgpack.unpack(_ref_pack(obj)) == _ref_unpack(_ref_pack(obj))


@pytest.mark.parametrize("kind", ["str", "utf8", "bytes", "list", "map"])
def test_pack_length_boundaries(kind):
    for n in _LENGTHS:
        obj = {"str": lambda: "a" * n, "utf8": lambda: "é" * (n // 2), "bytes": lambda: b"x" * n,
               "list": lambda: [i % 7 for i in range(n)], "map": lambda: {str(i): i for i in range(n)}}[kind]()
        data = _msgpack.pack(obj)
        assert data == _ref_pack(obj), n
        assert _msgpack.unpack(data) == _ref_unpack(data)


def test_pack_and_unpack_errors_match_msgpack():
    for bad in ({1, 2}, np.int64(3), object()):
        with pytest.raises(TypeError):
            _ref_pack(bad)
        with pytest.raises(TypeError):
            _msgpack.pack(bad)
    for big in (2 ** 64, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            _msgpack.pack(big)
    data = _ref_pack({"a": [1, 2, "xyz"]})
    for damaged in (data[:-1], data + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            _ref_unpack(damaged)
        with pytest.raises(ValueError):
            _msgpack.unpack(damaged)


@pytest.mark.parametrize("hi", [10, 1000, 10 ** 7, 10 ** 12, 2 ** 62])
def test_bulk_int_map_is_the_dicts_bytes(hi):
    rng = np.random.default_rng(hi % 97)
    keys = np.unique(rng.integers(0, hi, 2000))
    rng.shuffle(keys)
    vals = rng.integers(0, min(hi, 2 ** 63 - 1), len(keys))
    obj = {"m": {str(int(k)): int(v) for k, v in zip(keys, vals)}}
    data = _msgpack.pack({"m": _msgpack.pack_int_map(keys, vals)})
    assert data == _ref_pack(obj)
    (k2, v2) = _msgpack.unpack(data, hooks={("m",): _msgpack.int_map_hook})["m"]
    np.testing.assert_array_equal(k2, keys)
    np.testing.assert_array_equal(v2, vals)


@pytest.mark.parametrize("hi,tf_hi", [(60, 5), (10 ** 6, 127), (10 ** 9, 300), (10 ** 17, 3)])
def test_bulk_postings_are_the_dicts_bytes(hi, tf_hi):
    rng = np.random.default_rng(tf_hi)
    terms = sorted({f"t{i}" for i in range(60)} | {"é" * 40, "z" * 300})
    counts = rng.integers(0, 50, len(terms))
    indptr = np.concatenate([[0], np.cumsum(counts)])
    rows = np.concatenate([np.sort(rng.choice(hi, size=c, replace=False)) for c in counts])
    tfs = rng.integers(1, tf_hi + 1, len(rows))
    obj = {"p": {t: {str(int(r)): int(f) for r, f in zip(rows[indptr[i]:indptr[i + 1]], tfs[indptr[i]:indptr[i + 1]])}
                 for i, t in enumerate(terms)}}
    data = _msgpack.pack({"p": _msgpack.pack_postings(terms, indptr, rows, tfs, slab=97)})
    assert data == _ref_pack(obj)
    got_terms, got_indptr, got_rows, got_tfs = _msgpack.unpack(data, hooks={("p",): _msgpack.postings_hook})["p"]
    assert got_terms == terms
    np.testing.assert_array_equal(got_indptr, indptr)
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_tfs, tfs)


# -- safetensors ------------------------------------------------------------------

def _tensors():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "d": rng.standard_normal(4),
        "h": rng.standard_normal((2, 2)).astype(np.float16),
        "i": rng.integers(-9, 9, (7,)).astype(np.int32),
        "l": rng.integers(-9, 9, (2, 1, 3)).astype(np.int64),
        "u": rng.integers(0, 255, (5,)).astype(np.uint8),
        "b": rng.random(6) > 0.5,
        "s": np.array(2.5, dtype=np.float32),
        "e": np.zeros((0, 3), np.float32),
    }


def test_safetensors_both_directions(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import load_file, save_file

    ref = _tensors()
    meta = {"model_name": "x", "n": "3"}
    tp.save_params(str(tmp_path / "port.safetensors"), ref, meta=meta)
    got = load_file(str(tmp_path / "port.safetensors"))
    with safe_open(str(tmp_path / "port.safetensors"), framework="numpy") as f:
        assert dict(f.metadata()) == meta
    save_file(ref, str(tmp_path / "lib.safetensors"), metadata=meta)
    back, back_meta = tp.load_params(str(tmp_path / "lib.safetensors"))
    assert back_meta == meta
    for k, v in ref.items():
        for other in (got[k], back[k]):
            assert other.dtype == v.dtype and other.shape == v.shape
            np.testing.assert_array_equal(other, v)
    with pytest.raises(trag.SerializationError):
        tp.load_params(str(tmp_path / "missing.safetensors"))
    (tmp_path / "bad.safetensors").write_bytes(b"\x10" + b"\x00" * 7 + b"{not json")
    with pytest.raises(trag.SerializationError):
        tp.load_params(str(tmp_path / "bad.safetensors"))


# -- index artifacts --------------------------------------------------------------

def _pipeline(rag, n=300, metric="dot", tier="none", **vkw):
    b = (rag.RagPipelineBuilder()
         .with_embedder(rag.MockEmbedder(DIM))
         .with_reranker(rag.LexicalReranker())
         .with_chunker(_IdChunker(rag.RecursiveChunker(chunk_size=8192, overlap=0)))
         .with_retriever_config(rag.HybridRetrieverConfig(candidates_per_source=12))
         .with_vector_config(rag.VectorStoreConfig(dimension=DIM, metric=metric, scan_tier=tier,
                                                   scan_tile_n=1024, **vkw)))
    if rag is trag:
        b = b.with_device("cpu")
    p = b.build()
    texts = _texts(n=n)
    tags = [["even" if i % 2 == 0 else "odd"] + (["third"] if i % 3 == 0 else []) for i in range(len(texts))]
    p.index_documents([rag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(texts)], tags=tags)
    p.retriever.ensure_ready()
    return p


def _filters(rag):
    return [None, rag.TagFilter(all=("even",)), rag.TagFilter(any=("third",), none=("odd",))]


@pytest.fixture(scope="module")
def dot_pipelines():
    return {"port": _pipeline(trag), "jax": _pipeline(jrag)}


def _save(writer, pipe, path, codec, fmt):
    mod = tp if writer == "port" else jp
    c = mod.Compression(codec)
    info = {"type": "mock", "dimension": DIM}
    if fmt == "v1":
        mod.save_index(path, pipe.retriever, embedder_info=info, codec=c)
    else:
        mod.save_index_streaming(path, pipe.retriever, embedder_info=info, codec=c, frame_rows=64)


def _load(reader, path, scan_tier=None):
    if reader == "port":
        return tp.load_index(path, trag.MockEmbedder(DIM), scan_tier=scan_tier, device="cpu")
    return jp.load_index(path, jrag.MockEmbedder(DIM), scan_tier=scan_tier)


def _answers(rag, retr):
    out = retr.retrieve_batch(QUERIES, K)
    for f in _filters(rag)[1:3]:
        out += retr.retrieve_batch(QUERIES[:4], K, tag_filter=f)
    return out


_CROSS = [(w, r, c, f) for c in ("none", "zlib", "zstd", "lz4") for f in ("v1", "v2")
          for w, r in (("port", "jax"), ("jax", "port"))]
_CROSS += [("port", "port", c, f) for c, f in (("none", "v1"), ("zlib", "v2"))]


@pytest.mark.parametrize("writer,reader,codec,fmt", _CROSS)
def test_index_artifacts_cross_load(dot_pipelines, tmp_path, writer, reader, codec, fmt):
    """An index written by one package (tags, metric "dot") loads in the
    other with the writer's answers, filtered or not; the embedder info
    round-trips and ``read_index_info`` reads both formats."""
    path = str(tmp_path / "index.trag")
    wpipe = dot_pipelines[writer]
    _save(writer, wpipe, path, codec, fmt)
    retr, info = _load(reader, path)
    assert info == {"type": "mock", "dimension": DIM}
    assert retr.vector_store.config.metric == "dot"
    rrag, wrag = (trag if reader == "port" else jrag), (trag if writer == "port" else jrag)
    _same_results(_answers(rrag, retr), _answers(wrag, wpipe.retriever))
    meta = (tp if reader == "port" else jp).read_index_info(path)
    assert meta["version"] == (1 if fmt == "v1" else 2) and meta["dimension"] == DIM
    assert [c["id"] for c in meta["chunks"]] == wpipe.retriever.registry.ids()
    if writer == reader == "port":  # rows and BM25 scores round-trip exactly
        np.testing.assert_array_equal(retr.vector_store._host[:len(retr)], wpipe.retriever.vector_store._host[:len(retr)])
        a = retr.sparse_index.search_arrays(QUERIES, 10)
        b = wpipe.retriever.sparse_index.search_arrays(QUERIES, 10)
        assert all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(a, b))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_compact_bf16rr_layout_cross_loads(tmp_path, writer):
    """A compact store's ``compact_scan="bf16rr"`` survives the artifact in
    either direction (not downgraded to the default bf16r)."""
    wpipe = _pipeline(trag if writer == "port" else jrag, n=120, metric="cosine", tier="compact",
                      compact_scan="bf16rr")
    path = str(tmp_path / "index.trag")
    _save(writer, wpipe, path, "zlib", "v2")
    reader = "jax" if writer == "port" else "port"
    retr, _ = _load(reader, path, scan_tier="compact")
    assert retr.vector_store.config.compact_scan == "bf16rr"
    _same_results(retr.retrieve_batch(QUERIES, K), wpipe.retriever.retrieve_batch(QUERIES, K))


def _count_builds(monkeypatch, module):
    calls = []
    for name in ("prepare_clustered", "prepare_clustered_device", "prepare_clustered_stream"):
        fn = getattr(module, name, None)
        if fn is not None:
            monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    return calls


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_clustered_layout_cross_loads(tmp_path, monkeypatch, writer):
    """A clean clustered store's layout travels in the artifact: the other
    package loads it with ``scan_tier="clustered"`` as its preset (no
    k-means) and answers as the writer does."""
    from trueno_rag_tpu.ops import clustered as jcl
    from trueno_rag_tpu_torch.ops import clustered as tcl

    wpipe = _pipeline(trag if writer == "port" else jrag, n=300, metric="cosine", tier="clustered")
    assert wpipe.retriever.vector_store._cluster is not None
    path = str(tmp_path / "index.trag")
    _save(writer, wpipe, path, "zstd", "v1")
    reader = "jax" if writer == "port" else "port"
    calls = _count_builds(monkeypatch, tcl if reader == "port" else jcl)
    retr, _ = _load(reader, path, scan_tier="clustered")
    retr.ensure_ready()
    assert calls == []
    order = retr.vector_store._cluster[0]
    np.testing.assert_array_equal(np.asarray(order), np.asarray(wpipe.retriever.vector_store._cluster[0]))
    _same_results(retr.retrieve_batch(QUERIES, K), wpipe.retriever.retrieve_batch(QUERIES, K))


def _error_cases(path):
    """Damaged copies of the v1 and v2 artifacts at ``path``(.v1/.v2)."""
    v1 = open(path + ".v1", "rb").read()
    v2 = open(path + ".v2", "rb").read()
    hdr_end = v2.index(b"\x00", len(tp.MAGIC2)) + 1
    hdr_len = int.from_bytes(v2[hdr_end:hdr_end + 8], "little")
    frames = hdr_end + 8 + hdr_len
    return {
        "v1 truncated": v1[: len(v1) // 2],
        "bad magic": b"NOTMAGIC" + v1[8:],
        "v1 unknown codec": tp.MAGIC + b"brotli\x00" + v1[len(tp.MAGIC) + 5:],
        "v2 truncated in a frame": v2[:-10],
        "v2 truncated at a frame boundary": v2[:frames],
        "v2 truncated header": v2[:hdr_end + 20],
        "v2 zero-row frame": v2[:frames] + (0).to_bytes(8, "little") * 2 + v2[frames:],
        "v2 unknown codec": tp.MAGIC2 + b"brotli\x00" + v2[hdr_end:],
    }


def test_damaged_artifacts_raise_the_jax_error_types(dot_pipelines, tmp_path):
    path = str(tmp_path / "a")
    tp.save_index(path + ".v1", dot_pipelines["port"].retriever, codec=tp.Compression.ZLIB)
    tp.save_index_streaming(path + ".v2", dot_pipelines["port"].retriever, codec=tp.Compression.ZLIB,
                            frame_rows=64)
    for name, data in _error_cases(path).items():
        bad = str(tmp_path / "bad.trag")
        with open(bad, "wb") as f:
            f.write(data)
        with pytest.raises(Exception) as j:
            jp.load_index(bad, jrag.MockEmbedder(DIM))
        with pytest.raises(Exception) as t:
            tp.load_index(bad, trag.MockEmbedder(DIM), device="cpu")
        assert type(t.value).__name__ == type(j.value).__name__ == "SerializationError", (name, j.value, t.value)
        assert isinstance(t.value, trag.SerializationError)
    with pytest.raises(trag.IndexNotFoundError):
        tp.load_index(str(tmp_path / "none.trag"), trag.MockEmbedder(DIM), device="cpu")
    with pytest.raises(trag.IndexNotFoundError):
        tp.read_index_info(str(tmp_path / "none.trag"))
    # an artifact without a learned-sparse section ignores the encoder, as
    # the JAX package does: a two-source hybrid
    plain, _ = tp.load_index(path + ".v1", trag.MockEmbedder(DIM), learned_encoder=object(), device="cpu")
    assert plain.learned_index is None


def test_zstd_artifact_without_zstandard_raises(dot_pipelines, tmp_path, monkeypatch):
    path = str(tmp_path / "z.trag")
    tp.save_index(path, dot_pipelines["port"].retriever, codec=tp.Compression.ZSTD)
    monkeypatch.setattr(tp, "_zstd_module", False)
    assert tp.default_compression() is tp.Compression.ZLIB
    assert not tp.Compression.ZSTD.is_available
    with pytest.raises(trag.SerializationError, match="zstandard not available"):
        tp.load_index(path, trag.MockEmbedder(DIM), device="cpu")


_BLOCK = 4096  # the block deflate's block size in these tests (16 KiB payloads and up)


def _block_payload(size, seed=0):
    """Text-like bytes with repeats across block boundaries (the 32 KiB
    dictionary is what finds them) and some noise."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d} " for i in range(300)])
    text = "".join(words[rng.integers(0, 300, size=size // 3)]).encode()
    noise = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    return bytes(a if i % 7 else b for i, (a, b) in enumerate(zip(text[:size], noise)))


@pytest.mark.parametrize("size", [4 * _BLOCK, 4 * _BLOCK + 1, 5 * _BLOCK - 1, 7 * _BLOCK + 123])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_block_deflate_is_a_zlib_stream(monkeypatch, size, level):
    """Past four blocks the zlib codec deflates block by block; the stream
    is one standard zlib stream of the whole payload, ending on or off a
    block boundary."""
    monkeypatch.setattr(tp, "_ZLIB_BLOCK", _BLOCK)
    payload = _block_payload(size, seed=size)
    assert len(payload) == size
    comp = tp.Compression.ZLIB.compress(payload, level)
    assert comp != zlib.compress(payload, level)  # the block path ran
    assert zlib.decompress(comp) == payload
    assert tp.Compression.ZLIB.decompress(comp) == payload
    assert comp[:2] == zlib.compress(payload, level)[:2]  # the same zlib header


@pytest.mark.parametrize("fmt", ["v1", "v2"])
def test_block_deflated_artifacts_load_in_jax(dot_pipelines, tmp_path, monkeypatch, fmt):
    """A zlib artifact whose header (and, in v2, frames) were block-deflated
    loads in the JAX package with the port's answers."""
    monkeypatch.setattr(tp, "_ZLIB_BLOCK", _BLOCK)
    path = str(tmp_path / "index.trag")
    wpipe = dot_pipelines["port"]
    if fmt == "v1":
        tp.save_index(path, wpipe.retriever, embedder_info={"type": "mock"}, codec=tp.Compression.ZLIB)
    else:  # frames of 256 rows x 32 dims = 32 KiB: block-deflated too
        tp.save_index_streaming(path, wpipe.retriever, embedder_info={"type": "mock"},
                                codec=tp.Compression.ZLIB, frame_rows=256)
    retr, info = jp.load_index(path, jrag.MockEmbedder(DIM))
    assert info == {"type": "mock"}
    _same_results(_answers(jrag, retr), _answers(trag, wpipe.retriever))
    assert [c["id"] for c in jp.read_index_info(path)["chunks"]] == wpipe.retriever.registry.ids()


@pytest.mark.parametrize("titled", [False, True])
def test_chunk_list_is_msgpacks_bytes(titled):
    """The chunk list's one-pass encoder writes ``msgpack.packb`` of the
    chunk dicts, with and without metadata."""
    docs = [trag.Document(t, id=f"doc{i}", **({"title": f"T{i}", "source": f"s{i}.md"} if titled else {}))
            for i, t in enumerate(_texts(n=20))]
    chunks = [c for d in docs for c in trag.RecursiveChunker(chunk_size=64, overlap=8).chunk(d)]
    data = tp._pack_chunks(chunks).data
    assert data == _ref_pack([tp._chunk_to_wire(c) for c in chunks])
    assert _msgpack.unpack(data) == _ref_unpack(data)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_untitled_chunks_cross_load(tmp_path, writer, reader):
    """Chunks with empty metadata (documents without a title) round-trip
    between the packages, v2 under zlib, with the writer's answers."""
    rags = {"port": trag, "jax": jrag}
    wrag = rags[writer]
    b = (wrag.RagPipelineBuilder().with_embedder(wrag.MockEmbedder(DIM)).with_reranker(wrag.LexicalReranker())
         .with_chunker(_IdChunker(wrag.RecursiveChunker(chunk_size=8192, overlap=0)))
         .with_retriever_config(wrag.HybridRetrieverConfig(candidates_per_source=12))
         .with_vector_config(wrag.VectorStoreConfig(dimension=DIM)))
    wpipe = (b.with_device("cpu") if wrag is trag else b).build()
    wpipe.index_documents([wrag.Document(t, id=f"doc{i}") for i, t in enumerate(_texts(n=120))])
    path = str(tmp_path / "index.trag")
    _save(writer, wpipe, path, "zlib", "v2")
    retr, _ = _load(reader, path)
    _same_results(retr.retrieve_batch(QUERIES, K), wpipe.retriever.retrieve_batch(QUERIES, K))
    meta = (tp if reader == "port" else jp).read_index_info(path)
    want = [wpipe.retriever.registry.get_chunk(c).to_dict() for c in wpipe.retriever.registry.ids()]
    assert [{k: c[k] for k in ("id", "content", "metadata")} for c in meta["chunks"]] == \
        [{k: c[k] for k in ("id", "content", "metadata")} for c in want]


def test_mutated_index_round_trips(tmp_path):
    """Removals and a replaced chunk before the save: the artifact holds
    the live chunks only, and a re-saved loaded index (whose postings are
    still the loaded arrays) thaws them on mutation."""
    p = _pipeline(trag, n=120)
    retr = p.retriever
    for i in (3, 50, 77):
        assert retr.remove(f"doc{i}:0")
    path = str(tmp_path / "m.trag")
    tp.save_index(path, retr, codec=tp.Compression.LZ4)
    back, _ = tp.load_index(path, trag.MockEmbedder(DIM), device="cpu")
    assert len(back) == len(retr) == 117
    _same_results(back.retrieve_batch(QUERIES, K), retr.retrieve_batch(QUERIES, K))
    assert back.sparse_index.native_active
    doc = trag.Document("w001 w002 w003 w004", title="new", id="docnew")
    chunk = trag.RecursiveChunker(chunk_size=8192, overlap=0).chunk(doc)[0]
    chunk.set_embedding(trag.MockEmbedder(DIM).embed(chunk.content))
    back.index(chunk)
    assert not back.sparse_index.native_active
    ref = {c: s for c, s in back.sparse_index.search_host("w001 w002", 5)}
    assert chunk.id in ref
    jback, _ = jp.load_index(path, jrag.MockEmbedder(DIM))
    _same_results(jback.retrieve_batch(QUERIES, K), retr.retrieve_batch(QUERIES, K))


def test_bm25_compressed_bytes_cross_load():
    chunks = [(f"c{i}", t) for i, t in enumerate(_texts(n=80))]
    j = JBM25()
    t = TBM25(device="cpu")
    for cid, text in chunks:
        j.add(jrag.Chunk(document_id="d", content=text, start_offset=0, end_offset=len(text), id=cid))
        t.add(trag.Chunk(document_id="d", content=text, start_offset=0, end_offset=len(text), id=cid))
    for q in QUERIES:
        a = TBM25.from_compressed_bytes(j.to_compressed_bytes(jp.Compression.ZLIB), registry=t.registry,
                                        device="cpu").search_host(q, 8)
        b = JBM25.from_compressed_bytes(t.to_compressed_bytes(tp.Compression.LZ4), registry=j.registry).search_host(q, 8)
        want = j.search_host(q, 8)
        for got in (a, b):
            assert [c for c, _ in got] == [c for c, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-9)


# -- token-index artifacts and checkpoints ------------------------------------------

def test_token_index_cross_loads(tmp_path):
    """A JAX token index loads in the port with its exact token bytes,
    masks and tags, and a port one in the JAX package: both stores answer
    the same query tokens with the same rows."""
    from trueno_rag_tpu.index.token_store import TokenStoreConfig as JConfig
    from trueno_rag_tpu.models import encoder as je
    from trueno_rag_tpu.models import late_interaction as jli
    from trueno_rag_tpu_torch.convert import encoder_params_from_jax, params_to_jax
    from trueno_rag_tpu_torch.models import encoder as te

    from test_torch_token_store import PARAMS, _chunk
    from test_torch_token_store import _texts as token_texts

    texts = token_texts(60)
    jr = jli.LateInteractionRetriever(config=je.EncoderConfig.tiny(), params=PARAMS, max_len=32,
                                      store_config=JConfig(hidden_dim=64, max_tokens=32, scan="tiered"))
    jr.index_batch([_chunk(jrag, i, t) for i, t in enumerate(texts)], encode_batch=32)
    for i in range(0, 60, 3):
        jr.store.registry.set_tags(_chunk(jrag, i).id, ["third"])
    jpath = str(tmp_path / "j.trag")
    jp.save_token_index(jpath, jr, codec=jp.Compression.ZLIB)
    tr = tp.load_token_index(jpath, encoder_config=te.EncoderConfig.tiny(),
                             params=encoder_params_from_jax(PARAMS, "cpu"), device="cpu")
    n = len(jr.store)
    np.testing.assert_array_equal(tr.store._host[:n], jr.store._host[:n])
    np.testing.assert_array_equal(tr.store._t_mask[:n], jr.store._t_mask[:n])
    assert tr.store.config.scan == "tiered" and tr.max_len == jr.max_len
    assert tr.store.registry.tag_names_of(_chunk(trag, 3).id) == ["third"]
    q, qm = jr._encode(texts[:6])
    a_s, a_r = jr.store.search_arrays(q, qm, 5)
    b_s, b_r = tr.store.search_arrays(np.asarray(q), np.asarray(qm), 5)
    np.testing.assert_array_equal(b_r, a_r)
    np.testing.assert_allclose(b_s, a_s, atol=1e-5)

    tpath = str(tmp_path / "t.trag")
    tp.save_token_index(tpath, tr, codec=tp.Compression.LZ4)
    back = jp.load_token_index(tpath, encoder_config=je.EncoderConfig.tiny(), params=params_to_jax(tr.params))
    np.testing.assert_array_equal(back.store._host[:n], jr.store._host[:n])
    c_s, c_r = back.store.search_arrays(q, qm, 5)
    np.testing.assert_array_equal(c_r, a_r)
    again = tp.load_token_index(tpath, encoder_config=te.EncoderConfig.tiny(), params=tr.params, device="cpu",
                                scan="exact")
    assert again.store.config.scan == "exact"
    d_s, d_r = again.store.search_arrays(np.asarray(q), np.asarray(qm), 5)
    np.testing.assert_array_equal(d_r, a_r)


def _cos_close(a, b, tol=1e-2):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol, np.abs(a - b).max()


@pytest.mark.parametrize("model", ["encoder", "nemotron"])
def test_model_checkpoints_load_in_either_package(tmp_path, model):
    """A checkpoint written by either package loads in the other (the JAX
    layout, f32) with embeddings within 1e-2 on unit vectors; a port
    checkpoint reloaded by the port gives bit-identical embeddings."""
    from trueno_rag_tpu.models import encoder as je
    from trueno_rag_tpu.models import nemotron as jn
    from trueno_rag_tpu_torch.models import encoder as te
    from trueno_rag_tpu_torch.models import nemotron as tn

    texts = ["alpha beta gamma", "the quick brown fox jumps", "w001 w002 w003 w004 w005", "x"]
    if model == "encoder":
        jm = je.JaxEncoderEmbedder(config=je.EncoderConfig.tiny(), seed=3, model_name="tiny-enc")
        tcls, tcfg, jcls, jcfg = te.EncoderEmbedder, te.EncoderConfig.tiny(), je.JaxEncoderEmbedder, je.EncoderConfig.tiny()
    else:
        jm = jn.NemotronEmbedder(config=jn.NemotronConfig.tiny(), seed=3)
        tcls, tcfg, jcls, jcfg = tn.NemotronEmbedder, tn.NemotronConfig.tiny(), jn.NemotronEmbedder, jn.NemotronConfig.tiny()
    jpath = str(tmp_path / "j.safetensors")
    jm.save_checkpoint(jpath)
    tm = tcls.load_checkpoint(jpath, config=tcfg, device="cpu")
    _cos_close(tm.embed_batch(texts), jm.embed_batch(texts))
    if model == "encoder":
        assert tm.model_id == "tiny-enc"
    tpath = str(tmp_path / "t.safetensors")
    tm.save_checkpoint(tpath)
    back = jcls.load_checkpoint(tpath, config=jcfg)
    _cos_close(back.embed_batch(texts), tm.embed_batch(texts))
    again = tcls.load_checkpoint(tpath, config=tcfg, device="cpu")
    np.testing.assert_array_equal(again.embed_batch(texts), tm.embed_batch(texts))


# -- without the reference packages ------------------------------------------------

def test_persistence_runs_without_msgpack_zstandard_or_safetensors(tmp_path):
    code = f"""
import sys
for name in ("msgpack", "zstandard", "safetensors", "safetensors.numpy"):
    sys.modules[name] = None
import numpy as np
import trueno_rag_tpu_torch as rag
from trueno_rag_tpu_torch import persist
assert persist.default_compression() is persist.Compression.ZLIB
try:
    persist.Compression.ZSTD.compress(b"x")
    raise SystemExit("zstd without zstandard")
except rag.SerializationError as e:
    assert "zstandard not available" in str(e)
p = (rag.RagPipelineBuilder().with_embedder(rag.MockEmbedder(16)).with_reranker(rag.NoOpReranker())
     .with_vector_config(rag.VectorStoreConfig(dimension=16)).with_device("cpu").build())
p.index_documents([rag.Document(f"w{{i}} w{{i+1}} w{{i+2}} text", id=f"d{{i}}") for i in range(40)])
path = {str(tmp_path / "idx.trag")!r}
persist.save_index(path, p.retriever)
persist.save_index_streaming(path + "2", p.retriever, frame_rows=16)
for f in (path, path + "2"):
    r, _ = persist.load_index(f, rag.MockEmbedder(16), device="cpu")
    a = [x.chunk.id for x in r.retrieve("w3 w4", 5)]
    assert a == [x.chunk.id for x in p.retriever.retrieve("w3 w4", 5)], a
params = {{"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
persist.save_params({str(tmp_path / "p.safetensors")!r}, params, meta={{"m": "x"}})
back, meta = persist.load_params({str(tmp_path / "p.safetensors")!r})
assert meta == {{"m": "x"}} and np.array_equal(back["w"], params["w"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("msgpack", "zstandard", "safetensors", "jax")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
