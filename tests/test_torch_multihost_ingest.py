"""Multi-host ingest (``trueno_rag_tpu_torch.parallel.ingest`` and the
``from_shard_builds``/``from_shard_matrices`` constructors) against the JAX
package's ``test_multihost_ingest.py`` cases, on a 4 x 2 mesh in both
packages.

Tolerances: the port's shard-build path bit for bit equal to the port's
index built from a single-host BM25 index over the same partition (the
same tables, the same tail); the JAX package's sharded answers rows equal
and scores within rel 1e-5 (its f32 prefix-sum tail); ShardBuild payloads
byte for byte and loadable across the packages; merged statistics (terms,
idf bits, avgdl) equal to both single-host indexes'; dense shard blocks
bit for bit equal to the concatenated build.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings, strategies as st

import trueno_rag_tpu as jrag
import trueno_rag_tpu_torch as trag
from trueno_rag_tpu.parallel import ingest as jing
from trueno_rag_tpu.parallel.mesh import create_mesh as jcreate
from trueno_rag_tpu.parallel.sharded import ShardedVectorIndex as JVector
from trueno_rag_tpu.parallel.sparse import ShardedBM25 as JSharded
from trueno_rag_tpu.persist import deserialize_compressed as jload, serialize_compressed as jsave
from trueno_rag_tpu_torch.index.bm25 import BM25Index as TIndex
from trueno_rag_tpu_torch.parallel import ingest as ting
from trueno_rag_tpu_torch.parallel.mesh import create_mesh
from trueno_rag_tpu_torch.parallel.sharded import ShardedVectorIndex
from trueno_rag_tpu_torch.parallel.sparse import ShardedBM25
from trueno_rag_tpu_torch.persist import deserialize_compressed, serialize_compressed

S = 4


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _corpus(n=220, seed=0):
    """Zipf-ish documents over a small vocabulary (tf > 1, df varies)."""
    rng = np.random.default_rng(seed)
    words = [f"term{i:03d}" for i in range(150)]
    return [" ".join(words[i] for i in rng.zipf(1.5, size=int(rng.integers(5, 40))) % len(words))
            for _ in range(n)]


QUERIES = ["term001 term002 term003", "term000", "term120 term140", "nosuchterm whatsoever",
           "term005 term005 term007 term050 term099"]


@pytest.fixture(scope="module")
def meshes():
    return jcreate(data=S, model=2), create_mesh(data=S, model=2, devices=[torch.device("cpu")] * 8)


def _single(texts, mesh):
    idx = TIndex(use_native=False, device="cpu")
    for i, t in enumerate(texts):
        idx.add(trag.Chunk(id=f"c{i}", document_id="d", content=t, start_offset=0, end_offset=len(t)))
    return ShardedBM25(idx, mesh)


def _multi(texts, mesh, rps, use_native=False, via_payload=False):
    builds = [ting.build_shard(texts[i * rps:(i + 1) * rps], n_rows=rps, use_native=use_native) for i in range(S)]
    if via_payload:
        builds = [deserialize_compressed(serialize_compressed(b.to_payload())) for b in builds]
    return ShardedBM25.from_shard_builds(builds, mesh, rows_per_shard=rps)


def _jax_multi(texts, mesh, rps):
    builds = [jing.build_shard(texts[i * rps:(i + 1) * rps], n_rows=rps, use_native=False) for i in range(S)]
    return JSharded.from_shard_builds(builds, mesh, rows_per_shard=rps)


def _bit_equal(a, b):
    for x, y in zip(a, b):
        assert _np(x).tobytes() == _np(y).tobytes()


def _close(got, want, rtol=1e-5):
    """Scores within ``rtol``; rows equal but inside groups of scores tied
    within ``rtol`` (the zipf corpus ties exactly, and the two packages'
    tails round such ties apart by an ulp), whose row sets must agree
    unless the group straddles the k cut."""
    s_t, r_t = (_np(x) for x in got)
    s_j, r_j = (_np(x) for x in want)
    np.testing.assert_array_equal(r_t >= 0, r_j >= 0)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=rtol)
    for st_, rt_, rj_ in zip(s_t, r_t, r_j):
        k = int((rt_ >= 0).sum())
        lo = 0
        while lo < k:
            hi = lo + 1
            while hi < k and abs(st_[hi] - st_[hi - 1]) <= rtol * abs(st_[lo]):
                hi += 1
            if hi < k or lo == 0:
                assert set(rt_[lo:hi]) == set(rj_[lo:hi]), (lo, hi)
            lo = hi


def test_sparse_multihost_parity(meshes):
    jm, tm = meshes
    texts = _corpus()
    rps = -(-len(texts) // S)
    single, multi = _single(texts, tm), _multi(texts, tm, rps)
    jmulti = _jax_multi(texts, jm, rps)
    assert multi.total_postings == single.total_postings == jmulti.total_postings
    assert multi.rows_per_shard == single.rows_per_shard == rps
    for k in (1, 10, 37):
        got = multi.search_arrays(QUERIES, k)
        _bit_equal(got, single.search_arrays(QUERIES, k))
        _close(got, jmulti.search_arrays(QUERIES, k))
    for a, b in zip(multi.blocks.shards, single.blocks.shards):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sparse_multihost_parity_via_payload(meshes, writer):
    """Shard builds shipped as payloads (the last shard short); payloads of
    the JAX package load in the port."""
    jm, tm = meshes
    texts = _corpus(n=97, seed=3)
    rps = -(-len(texts) // S)
    if writer == "port":
        multi = _multi(texts, tm, rps, via_payload=True)
    else:
        builds = [jload(jsave(jing.build_shard(texts[i * rps:(i + 1) * rps], n_rows=rps, use_native=False)
                              .to_payload())) for i in range(S)]
        multi = ShardedBM25.from_shard_builds(builds, tm, rows_per_shard=rps)
    _bit_equal(multi.search_arrays(QUERIES, 10), _single(texts, tm).search_arrays(QUERIES, 10))
    _close(multi.search_arrays(QUERIES, 10), _jax_multi(texts, jm, rps).search_arrays(QUERIES, 10))


def test_native_and_python_builds_agree(meshes):
    from trueno_rag_tpu_torch.native import native_available

    if not native_available():
        pytest.skip("native builder unavailable")
    _, tm = meshes
    texts = _corpus(n=120, seed=7)
    rps = -(-len(texts) // S)
    _bit_equal(_multi(texts, tm, rps).search_arrays(QUERIES, 10),
               _multi(texts, tm, rps, use_native=True).search_arrays(QUERIES, 10))


def test_empty_shard(meshes):
    jm, tm = meshes
    texts = _corpus(n=30, seed=11)
    rps = 16  # shard 0 full, shard 1 partial, shards 2-3 EMPTY
    builds = [ting.build_shard(texts[i * rps:(i + 1) * rps], n_rows=rps) for i in range(S)]
    assert builds[2].n_docs == 0 and builds[3].n_docs == 0
    multi = ShardedBM25.from_shard_builds(builds, tm, rows_per_shard=rps)
    _close(multi.search_arrays(QUERIES, 10), _jax_multi(texts, jm, rps).search_arrays(QUERIES, 10))
    # a different split of the single-host index (rps 8): the same row sets
    s1, r1 = (_np(x) for x in _single(texts, tm).search_arrays(QUERIES, 10))
    s2, r2 = (_np(x) for x in multi.search_arrays(QUERIES, 10))
    np.testing.assert_allclose(s1, s2, rtol=3e-6, atol=0)
    for q in range(r1.shape[0]):
        assert set(r1[q].tolist()) == set(r2[q].tolist())


def test_merge_stats_match_both_single_hosts():
    from trueno_rag_tpu.index.bm25 import BM25Index as JIndex

    texts = _corpus(n=64, seed=5)
    builds = [ting.build_shard(texts[i * 16:(i + 1) * 16], n_rows=16) for i in range(S)]
    terms, vocab, idf, n_docs, avgdl = ting.merge_shard_stats(builds)
    jt, jv, jidf, jn, javg = jing.merge_shard_stats(
        [jing.build_shard(texts[i * 16:(i + 1) * 16], n_rows=16) for i in range(S)])
    assert (terms, vocab, n_docs, avgdl) == (jt, jv, jn, javg) and idf.tobytes() == jidf.tobytes()
    t = TIndex(use_native=False, device="cpu")
    j = JIndex(use_native=False)
    for i, text in enumerate(texts):
        t.add(trag.Chunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=len(text)))
        j.add(jrag.Chunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=len(text)))
    assert n_docs == 64 and avgdl == t.avg_doc_length
    t_vocab, _, _, _, t_idf, _, _ = t._csr()
    assert terms == sorted(t_vocab) and idf.tobytes() == t_idf.tobytes()
    j._refresh_snapshot()
    assert idf.tobytes() == np.asarray(j._snap["idf"]).tobytes()


@pytest.mark.parametrize("n_rows", [4, 2])
def test_shard_build_payload_roundtrip_and_jax_bytes(n_rows):
    b = ting.build_shard(["alpha beta beta", "gamma alpha"], n_rows=n_rows)
    p = b.to_payload()
    jp = jing.build_shard(["alpha beta beta", "gamma alpha"], n_rows=n_rows, use_native=False).to_payload()
    assert p == jp  # the same wire form, byte for byte
    b2 = ting.ShardBuild.from_payload(deserialize_compressed(serialize_compressed(p)))
    assert b2.terms == b.terms and b2.n_docs == 2 and b2.n_rows == n_rows
    for key in ("rows", "tfs", "indptr", "doc_len"):
        np.testing.assert_array_equal(getattr(b2, key), getattr(b, key))
    bad = dict(p, dtypes={**p["dtypes"], "rows": ">i4"})
    with pytest.raises(trag.SerializationError):
        ting.ShardBuild.from_payload(bad)


def test_dense_from_shard_matrices(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(2)
    n, d, k = 210, 32, 9
    rps = -(-n // S)
    full = rng.standard_normal((n, d)).astype(np.float32)
    blocks = [full[i * rps:(i + 1) * rps] for i in range(S)]
    tags = rng.integers(0, 8, size=n).astype(np.int32)
    tag_blocks = [tags[i * rps:(i + 1) * rps] for i in range(S)]
    ref = ShardedVectorIndex(full, tm, metric="cosine", tags=tags)
    multi = ShardedVectorIndex.from_shard_matrices(blocks, tm, metric="cosine", tags=tag_blocks)
    jmulti = JVector.from_shard_matrices(blocks, jm, metric="cosine", tags=tag_blocks)
    assert multi.n == n
    for a, b in zip(multi.matrix.shards, ref.matrix.shards):
        assert torch.equal(a, b)
    queries = rng.standard_normal((5, d)).astype(np.float32)
    masks = (np.full(5, 1, np.int32), np.zeros(5, np.int32), np.zeros(5, np.int32))
    for kw in ({}, {"tag_masks": masks}):
        got = multi.search(queries, k, **kw)
        _bit_equal(got, ref.search(queries, k, **kw))
        s_j, r_j = (_np(x) for x in jmulti.search(queries, k, **kw))
        np.testing.assert_array_equal(_np(got[1]), r_j)
        np.testing.assert_allclose(_np(got[0]), s_j, rtol=0, atol=1e-6)
    with pytest.raises(trag.InvalidConfigError):
        ShardedVectorIndex.from_shard_matrices([full[:5, :8]] + blocks[1:], tm)


def test_hybrid_from_shard_builds_parity(meshes):
    """Per-shard (chunks, embeddings, BM25 builds) assemble into an index
    answering as the single-host retriever's sharded index, and as the JAX
    package's built the same way."""
    from trueno_rag_tpu.parallel.hybrid import ShardedHybridIndex as JHybrid
    from trueno_rag_tpu_torch.parallel.hybrid import ShardedHybridIndex

    jm, tm = meshes
    texts = _corpus(n=120, seed=9)
    rps = -(-len(texts) // S)
    out = []
    for mod, ing, cls, mesh, kw in ((jrag, jing, JHybrid, jm, {}), (trag, ting, ShardedHybridIndex, tm, {"device": "cpu"})):
        emb = mod.MockEmbedder(dimension=48)

        def make():
            return [mod.Chunk(document_id=f"doc{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i}")
                    for i, t in enumerate(texts)]

        retr = mod.HybridRetriever(emb, **kw)
        chunks = make()
        emb.embed_chunks(chunks)
        embs = np.asarray([c.embedding for c in chunks], np.float32)
        retr.index_batch(chunks)
        single = cls(retr, mesh)
        multi_chunks = make()
        builds = [ing.build_shard(texts[i * rps:(i + 1) * rps], n_rows=min(rps, len(texts) - i * rps))
                  for i in range(S)]
        multi = cls.from_shard_builds(emb, [embs[i * rps:(i + 1) * rps] for i in range(S)], builds, mesh,
                                      chunks_per_shard=[multi_chunks[i * rps:(i + 1) * rps] for i in range(S)])
        out.append((single, multi))
        with pytest.raises(mod.InvalidConfigError):
            multi.refresh()
    (_, jmulti), (single, multi) = out
    for q in QUERIES[:3]:
        r1, r2, rj = single.search(q, 10), multi.search(q, 10), jmulti.search(q, 10)
        assert [x.chunk.id for x in r1] == [x.chunk.id for x in r2] == [x.chunk.id for x in rj]
        np.testing.assert_allclose([x.fused_score for x in r1], [x.fused_score for x in r2], rtol=1e-6)
        np.testing.assert_allclose([x.fused_score for x in r2], [x.fused_score for x in rj], rtol=1e-6)


def test_assemble_row_sharded_layout(meshes):
    _, tm = meshes
    blocks = [np.full((3, 2), i, np.float32) for i in range(S)]
    arr = ting.assemble_row_sharded(blocks, tm, "data")
    assert arr.shape == (12, 2) and arr.shards[2].device == torch.device("cpu")
    np.testing.assert_array_equal(arr.numpy(), np.concatenate(blocks, axis=0))


def test_shard_count_mismatch_raises(meshes):
    _, tm = meshes
    with pytest.raises(trag.InvalidConfigError):
        ShardedBM25.from_shard_builds([ting.build_shard(["a b c"])], tm, rows_per_shard=4)
    with pytest.raises(trag.InvalidConfigError):
        ting.assemble_row_sharded([np.zeros((2, 2), np.float32)], tm, "data")
    with pytest.raises(trag.InvalidConfigError):
        ting.assemble_row_sharded([np.zeros((0, 2), np.float32)] * S, tm, "data")
    bad = ting.build_shard(["alpha beta"], n_rows=1)
    bad.rows = np.array([3], np.int32)
    with pytest.raises(trag.InvalidConfigError, match="corrupt"):
        ShardedBM25.from_shard_builds([bad] * S, tm, rows_per_shard=4)


_WORD = st.sampled_from(["alpha", "beta", "gamma", "delta", "fox", "data", "index", "rank", "query", "model",
                         "tpu", "chip", "shard", "merge", "vocab"])
_DOC = st.lists(_WORD, min_size=1, max_size=15).map(" ".join)


@settings(max_examples=10, deadline=None)
@example(docs=["alpha"] * 9, q="alpha", k=3)  # all identical: full ties
@example(docs=["alpha beta", "gamma"], q="delta", k=5)  # an unknown query term
@given(docs=st.lists(_DOC, min_size=1, max_size=40), q=st.lists(_WORD, min_size=1, max_size=4).map(" ".join),
       k=st.integers(1, 12))
def test_property_multihost_merge_parity(meshes, docs, q, k):
    """Any corpus, any contiguous equal-capacity split: the merged shard
    builds answer bit for bit as the single-host index split alike, and the
    JAX package's rows agree up to exact ties."""
    jm, tm = meshes
    rps = -(-len(docs) // S)
    builds = [ting.build_shard(docs[i * rps:(i + 1) * rps], n_rows=rps) for i in range(S)]
    got = ShardedBM25.from_shard_builds(builds, tm, rows_per_shard=rps).search_arrays([q], k)
    _bit_equal(got, _single(docs, tm).search_arrays([q], k))
    s_t, r_t = (_np(x)[0] for x in got)
    s_j, r_j = (_np(x)[0] for x in _jax_multi(docs, jm, rps).search_arrays([q], k))
    np.testing.assert_allclose(np.where(np.isneginf(s_t), 0, s_t), np.where(np.isneginf(s_j), 0, s_j), rtol=1e-5)
    for j in range(k):
        if r_t[j] != r_j[j]:
            assert (np.abs(s_t - s_t[j]) <= 1e-5 * abs(s_t[j])).sum() > 1  # rows differ only inside a tie
