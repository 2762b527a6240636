"""The sharded serving path (``trueno_rag_tpu_torch.parallel``) against the
JAX package's ``parallel`` on an 8-shard mesh: the same seeded numpy inputs
go to the JAX function on ``create_mesh(data=8)`` (the conftest's eight
virtual CPU devices) and to the port on ``create_mesh(devices=[cpu] * 8)``.

Tolerances: fp32 dense rows equal on tie-free data and scores within 1e-6
(the port reports the float64 dot rounded once, the JAX package the f32
matmul); planted exact ties across shard boundaries keep (score desc, row
asc) in both; BM25 rows equal and scores within rel 1e-5 of the JAX
package's (its f32 prefix-sum tail), the shard tables bit for bit equal to
the single-host table's entries, and the sharded index built from a
retriever bit for bit equal to the one built from shard builds; learned
sparse as BM25; hybrid results chunk for chunk, fused scores within 1e-5.
The ``cuda`` cases run the same paths on a 4-shard mesh over one card.
"""

import numpy as np
import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.ops import dense as tdense
from trueno_rag_tpu_torch.parallel import mesh as tmesh_mod
from trueno_rag_tpu_torch.parallel import sharded as tsh
from trueno_rag_tpu_torch.parallel.hybrid import ShardedHybridIndex
from trueno_rag_tpu_torch.parallel.sparse import ShardedBM25, ShardedLearnedSparse

try:  # the card's machine has no JAX: only the cuda cases run there
    import trueno_rag_tpu as jrag
    from trueno_rag_tpu.parallel import mesh as jmesh_mod
    from trueno_rag_tpu.parallel import sharded as jsh
except ImportError:
    jrag = jmesh_mod = jsh = None

S = 8
CPU8 = [torch.device("cpu")] * S


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def meshes():
    return jmesh_mod.create_mesh(data=S, model=1), tmesh_mod.create_mesh(devices=CPU8)


def _same_dense(got, want, atol=1e-6):
    s_t, r_t = (_np(x) for x in got)
    s_j, r_j = (_np(x) for x in want)
    np.testing.assert_array_equal(r_t, r_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-6, atol=atol)


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------


def test_create_mesh_shapes(monkeypatch):
    mesh = tmesh_mod.create_mesh(devices=CPU8)
    assert mesh.shape["data"] == 8 and mesh.shape["model"] == 1
    mesh = tmesh_mod.create_mesh(data=4, model=2, devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2} and len(mesh.axis_devices("data")) == 4
    assert mesh.lead == torch.device("cpu")
    with pytest.raises(trag.InvalidConfigError):
        tmesh_mod.create_mesh(data=3, model=2, devices=CPU8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(trag.InvalidConfigError, match="CPU mesh"):
        tmesh_mod.create_mesh()


def test_row_sharded_values_and_collectives(meshes):
    _, mesh = meshes
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    rs = tmesh_mod.shard_rows(x, mesh)
    assert rs.shape == (16, 2) and rs.rows_per_shard == 2 and rs.nbytes == x.nbytes
    np.testing.assert_array_equal(rs.numpy(), x)
    x[0, 0] = -1.0  # the shards are copies
    assert rs.shards[0][0, 0] == 0.0
    parts = [torch.full((3, 2), float(i)) for i in range(S)]
    gathered = tmesh_mod.all_gather(parts, mesh)
    assert gathered.shape == (3, 2 * S) and gathered[0, 2 * 5] == 5.0
    assert torch.equal(tmesh_mod.shard_max([torch.tensor([1.0, -2.0]), torch.tensor([0.0, 3.0])] * 4, mesh),
                       torch.tensor([1.0, 3.0]))
    with pytest.raises(trag.InvalidConfigError):
        tmesh_mod.shard_rows(np.zeros((9, 2), np.float32), mesh)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def _rows(n, d, seed, metric="cosine"):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m, rng


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_sharded_topk_matches_jax_and_the_single_card(meshes, metric):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    jm, tm = meshes
    n, d, b, k = 512, 32, 4, 10
    matrix, rng = _rows(n, d, 0, metric)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[100:140] = False
    want = jsh.sharded_dense_topk(
        jnp.asarray(queries), jax.device_put(jnp.asarray(matrix), NamedSharding(jm, P("data", None))),
        jax.device_put(jnp.asarray(valid), NamedSharding(jm, P("data"))), k, jm, metric)
    got = tsh.sharded_dense_topk(queries, tmesh_mod.shard_rows(matrix, tm), tmesh_mod.shard_rows(valid, tm), k, tm,
                                 metric)
    _same_dense(got, want)
    # the single card's exact path: same rows, same scores bit for bit
    one = tdense.dense_topk(torch.from_numpy(queries), torch.from_numpy(matrix), torch.from_numpy(valid), k, metric)
    for a, w in zip(got, one):
        assert torch.equal(a, w)


def test_sharded_vector_index_unpadded_n_matches_jax(meshes):
    jm, tm = meshes
    matrix, _ = _rows(101, 16, 1, "none")  # 101 % 8 != 0
    j = jsh.ShardedVectorIndex(matrix, jm, metric="cosine")
    t = tsh.ShardedVectorIndex(matrix, tm, metric="cosine")
    got = t.search(matrix[:3], 8)
    _same_dense(got, j.search(matrix[:3], 8))
    assert _np(got[1]).max() < 101 and list(_np(got[1])[:, 0]) == [0, 1, 2]
    assert t.matrix.shape == (104, 16) and not t.valid.numpy()[101:].any()


def test_sharded_index_k_larger_than_shard_matches_jax(meshes):
    jm, tm = meshes
    matrix, _ = _rows(16, 8, 2, "none")
    got = tsh.ShardedVectorIndex(matrix, tm).search(matrix[:2], k=10)
    _same_dense(got, jsh.ShardedVectorIndex(matrix, jm).search(matrix[:2], k=10))
    rows = _np(got[1])
    assert rows.shape == (2, 10)
    for qrow in rows:
        live = qrow[qrow >= 0]
        assert len(set(live.tolist())) == len(live)


def test_planted_ties_across_shards_keep_row_order(meshes):
    """Identical rows on four shards score exactly alike: the merge keeps
    them row-ascending, as lax.top_k and the single card do."""
    jm, tm = meshes
    n, d, k = 256, 16, 6
    matrix, rng = _rows(n, d, 3)
    for r in (31, 32, 95, 200):  # the last row of shard 0, the first of shard 1, shards 2 and 6
        matrix[r] = matrix[7]
    q = matrix[7:8] + 1e-3 * rng.standard_normal((1, d)).astype(np.float32)
    got = tsh.ShardedVectorIndex(matrix, tm, rows_normalized=True).search(q, k)
    want = jsh.ShardedVectorIndex(matrix, jm, rows_normalized=True).search(q, k)
    np.testing.assert_array_equal(_np(got[1])[0, :5], [7, 31, 32, 95, 200])
    _same_dense(got, want)
    one = tdense.dense_topk(torch.from_numpy(q), torch.from_numpy(matrix), torch.ones(n, dtype=torch.bool), k)
    assert torch.equal(got[1], one[1]) and torch.equal(got[0], one[0])


def test_sharded_euclidean_matches_jax(meshes):
    jm, tm = meshes
    matrix, rng = _rows(96, 16, 4, "none")
    q = rng.standard_normal((3, 16)).astype(np.float32)
    got = tsh.ShardedVectorIndex(matrix, tm, metric="euclidean").search(q, 5)
    _same_dense(got, jsh.ShardedVectorIndex(matrix, jm, metric="euclidean").search(q, 5), atol=1e-5)


def test_tagged_search_and_update_rows_match_jax(meshes):
    jm, tm = meshes
    n, d, k = 203, 24, 7
    matrix, rng = _rows(n, d, 5, "none")
    tags = rng.integers(0, 8, size=n).astype(np.int32)
    valid = rng.random(n) > 0.1
    j = jsh.ShardedVectorIndex(matrix, jm, valid=valid, tags=tags)
    t = tsh.ShardedVectorIndex(matrix, tm, valid=valid, tags=tags)
    q = rng.standard_normal((5, d)).astype(np.float32)
    masks = (np.array([1, 0, 2, 0, 4], np.int32), np.array([0, 6, 0, 0, 0], np.int32),
             np.array([0, 0, 1, 2, 0], np.int32))
    _same_dense(t.search(q, k, tag_masks=masks), j.search(q, k, tag_masks=masks))
    rows = np.array([3, 40, 41, 150, 207], np.int64)  # 207: a padding row inside the capacity
    vecs = rng.standard_normal((5, d)).astype(np.float32)
    flags = np.array([True, False, True, True, True])
    new_tags = np.array([1, 1, 2, 4, 7], np.int32)
    j.update_rows(rows, vecs, flags, tags=new_tags)
    t.update_rows(rows, vecs, flags, tags=new_tags)
    assert t.n == j.n == 208
    _same_dense(t.search(q, k), j.search(q, k))
    _same_dense(t.search(vecs, k, tag_masks=masks), j.search(vecs, k, tag_masks=masks))
    with pytest.raises(trag.InvalidConfigError):
        t.update_rows(np.array([208]), vecs[:1])


# ---------------------------------------------------------------------------
# BM25 and learned sparse
# ---------------------------------------------------------------------------


def _texts(n, seed=0, vocab=60):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(vocab)])
    lengths = rng.permutation(np.arange(4, 4 + n))  # distinct lengths: no two BM25 scores tie
    return [" ".join(words[rng.integers(0, vocab, size=ln)]) for ln in lengths]


BM25_QUERIES = ["w001 w002 w003", "w010 w050", "w025 w026 w027 w028", "w007", "w042 w042 w059", "zzz", "the of"]


def _bm25_pair(texts):
    from trueno_rag_tpu.chunking import Chunk as JChunk
    from trueno_rag_tpu.index.bm25 import BM25Index as JIndex
    from trueno_rag_tpu_torch.index.bm25 import BM25Index as TIndex

    j, t = JIndex(use_native=False), TIndex(use_native=False, device="cpu")
    for i, text in enumerate(texts):
        j.add(JChunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=1))
        t.add(trag.Chunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=1))
    return j, t


def _same_sparse(got, want, rtol=1e-5):
    s_t, r_t = (_np(x) for x in got)
    s_j, r_j = (_np(x) for x in want)
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(np.isneginf(s_t), np.isneginf(s_j))
    fin = np.isfinite(s_j)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=rtol)


@pytest.mark.parametrize("n", [40, 5, 130])
def test_sharded_bm25_matches_jax(meshes, n):
    """n = 5: three of the eight shards hold no document."""
    from trueno_rag_tpu.parallel.sparse import ShardedBM25 as JSharded

    jm, tm = meshes
    j, t = _bm25_pair(_texts(n, seed=n))
    js, ts = JSharded(j, jm), ShardedBM25(t, tm)
    assert ts.rows_per_shard == js.rows_per_shard and ts.total_postings == js.total_postings
    for k in (1, min(10, n), 37):
        _same_sparse(ts.search_arrays(BM25_QUERIES, k), js.search_arrays(BM25_QUERIES, k))
    # the same answers as the single-host index (rows; scores up to the tail's rounding)
    _same_sparse(ts.search_arrays(BM25_QUERIES, 10), t.search_arrays(BM25_QUERIES, 10))


def test_sharded_bm25_tables_are_the_single_host_entries(meshes):
    """Every shard's block-table entry is the single-host table's
    contribution for the same posting, bit for bit (global idf and avgdl
    baked in), and each shard's scores equal the single-host tail run on
    that shard's own table."""
    from trueno_rag_tpu_torch.ops.bm25 import BLOCK_LEN, bm25_topk_blocks

    _, tm = meshes
    _, t = _bm25_pair(_texts(130, seed=7))
    t._refresh_snapshot()
    sb = ShardedBM25(t, tm)
    single = t._snap["blocks"].numpy()
    p = int(t._snap["indptr"][-1])
    flat = single.transpose(0, 2, 1).reshape(-1, 2)[:p]
    want = {(int(r), round(float(c), 12)): c for r, c in flat}
    seen = 0
    for i, shard in enumerate(sb.blocks.shards):
        n_i = int(sb.indptrs[i][-1])
        local = shard[0].numpy().transpose(0, 2, 1).reshape(-1, 2)[:n_i]
        for r, c in local:
            key = (int(r) + i * sb.rows_per_shard, round(float(c), 12))
            assert key in want and want[key].tobytes() == np.float32(c).tobytes()
        seen += n_i
    assert seen == p
    bids, lo, hi = sb._gather_blocks(BM25_QUERIES)
    s_all, r_all = sb.search_arrays(BM25_QUERIES, 10)
    for i in range(S):
        s_i, r_i = bm25_topk_blocks(*(torch.from_numpy(x[i]) for x in (bids, lo, hi)), sb.blocks.shards[i][0], k=10)
        for qi in range(len(BM25_QUERIES)):
            for sc, row in zip(s_i[qi].tolist(), r_i[qi].tolist()):
                hit = np.flatnonzero(_np(r_all)[qi] == row + i * sb.rows_per_shard)
                if row >= 0 and len(hit):
                    assert _np(s_all)[qi, hit[0]].tobytes() == np.float32(sc).tobytes()
    assert BLOCK_LEN == 256


def test_sharded_bm25_memory_is_sharded(meshes):
    _, tm = meshes
    _, t = _bm25_pair(_texts(128, seed=9))
    sb = ShardedBM25(t, tm)
    assert 0 < sb.max_shard_postings <= sb.total_postings / 2
    assert sb.blocks.shape[0] == 8


def test_sharded_bm25_gather_blocks_match_jax(meshes):
    from trueno_rag_tpu.parallel.sparse import ShardedBM25 as JSharded

    jm, tm = meshes
    j, t = _bm25_pair(_texts(300, seed=2))
    long_query = " ".join(f"w{i:03d}" for i in range(60))
    for qs in (BM25_QUERIES, [long_query, "w001"], ["zzz"]):
        for a, w in zip(ShardedBM25(t, tm)._gather_blocks(qs), JSharded(j, jm)._gather_blocks(qs)):
            assert a.dtype == np.int32 and np.array_equal(a, w)


def _learned_pair(n_rows=530, vocab=60, seed=12):
    from trueno_rag_tpu.index.learned_sparse import LearnedSparseIndex as JIndex
    from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex as TIndex

    rng = np.random.default_rng(seed)
    terms = np.stack([rng.choice(vocab, size=6, replace=False) for _ in range(n_rows)]).astype(np.int64)
    weights = rng.uniform(0.05, 2.0, size=(n_rows, 6)).astype(np.float32)
    j, t = JIndex(), TIndex(device="cpu")
    j.add_batch([jrag.Chunk(id=f"c{i}", document_id="d", content="x", start_offset=0, end_offset=1)
                 for i in range(n_rows)], terms, weights)
    t.add_batch([trag.Chunk(id=f"c{i}", document_id="d", content="x", start_offset=0, end_offset=1)
                 for i in range(n_rows)], terms, weights)
    return j, t


def test_sharded_learned_sparse_matches_jax_and_single_host(meshes):
    """530 rows: ragged across 8 shards (test_splade.py's sharded cases)."""
    from trueno_rag_tpu.parallel.sparse import ShardedLearnedSparse as JSharded

    jm, tm = meshes
    j, t = _learned_pair()
    js, ts = JSharded(j, jm), ShardedLearnedSparse(t, tm)
    assert ts.max_shard_postings < ts.total_postings == js.total_postings
    rng = np.random.default_rng(13)
    q_terms = rng.integers(-1, 60, size=(4, 7)).astype(np.int32)
    q_w = rng.uniform(0.0, 1.2, size=(4, 7)).astype(np.float32)
    for a, w in zip(ts._gather_blocks(q_terms, q_w), js._gather_blocks(q_terms, q_w)):
        np.testing.assert_array_equal(a, w)
    got = ts.search_arrays(q_terms, q_w, k=9)
    _same_sparse(got, js.search_arrays(q_terms, q_w, k=9))
    _same_sparse(got, t.search_arrays(q_terms, q_w, k=9), rtol=2e-4)


def test_sharded_learned_sparse_tie_order_and_empty_query(meshes):
    from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex

    _, tm = meshes
    idx = LearnedSparseIndex(device="cpu")
    # identical expansions across shard boundaries → global row-asc ties
    idx.add_batch([trag.Chunk(id=f"c{i}", document_id="d", content="x", start_offset=0, end_offset=1)
                   for i in range(16)], np.full((16, 1), 5, np.int64), np.ones((16, 1), np.float32))
    sh = ShardedLearnedSparse(idx, tm)
    s, r = sh.search_arrays(np.array([[5], [-1]], np.int32), np.array([[1.0], [1.0]], np.float32), k=5)
    assert _np(r)[0].tolist() == [0, 1, 2, 3, 4]
    assert (_np(r)[1] == -1).all() and np.isneginf(_np(s)[1]).all()


# ---------------------------------------------------------------------------
# hybrid
# ---------------------------------------------------------------------------


def _chunks(mod, texts, emb, start=0, vectors=None):
    out = []
    for i, t in enumerate(texts):
        c = mod.Chunk(document_id="d", content=t, start_offset=0, end_offset=len(t), metadata=mod.ChunkMetadata(),
                      id=mod.chunk_id_from_int(start + i))
        c.set_embedding(emb.embed_document(t) if vectors is None else vectors[i])
        out.append(c)
    return out


def _vectors(n, dim, seed):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _retrievers(texts, embedder="tfidf", dim=32, cand=20, vectors=None):
    """A JAX and a port retriever over the same chunks (``vectors``: the
    chunks' embeddings, else the embedder's)."""
    pair = []
    for mod, kw in ((jrag, {}), (trag, {"device": "cpu"})):
        emb = mod.TfIdfEmbedder(dim).fit(texts) if embedder == "tfidf" else mod.MockEmbedder(dimension=dim)
        retr = mod.HybridRetriever(emb, **kw)
        retr.config.candidates_per_source = cand
        retr.index_batch(_chunks(mod, texts, emb, vectors=vectors))
        pair.append(retr)
    return pair


def _same_results(got, want, rel=1e-5):
    assert [r.chunk.id for r in got] == [r.chunk.id for r in want]
    for a, b in zip(got, want):
        assert a.fused_score == pytest.approx(b.fused_score, rel=rel, abs=1e-6)


TEMPLATE = [f"document number {i} about {'foxes' if i % 3 == 0 else 'data'} and "
            f"{'retrieval' if i % 2 == 0 else 'ranking'} systems" for i in range(40)]


MOCK_TEXTS = _texts(64, seed=5, vocab=200)  # distinct lengths: no BM25 ties
MOCK_VECTORS = _vectors(64, 32, 5)  # random chunk vectors: no dense ties


@pytest.mark.parametrize("corpus", ["template", "mock"])
@pytest.mark.parametrize("kind", ["rrf", "linear", "dbsf"])
def test_sharded_hybrid_replicated_matches_single_host_and_jax(meshes, kind, corpus):
    """sparse_mode="replicated" keeps the single-host BM25 arrays: equal
    rankings even on the tie-heavy template corpus (TfIdf vectors tie
    exactly; the two packages break such dense ties by different f32 sums,
    so the JAX index is compared on a corpus of random chunk vectors and
    distinct document lengths, whose dense and BM25 scores are tie-free)."""
    from trueno_rag_tpu.parallel.hybrid import ShardedHybridIndex as JHybrid

    jm, tm = meshes
    texts = TEMPLATE if corpus == "template" else MOCK_TEXTS
    jr, tr = _retrievers(texts, "tfidf" if corpus == "template" else "mock",
                         vectors=None if corpus == "template" else MOCK_VECTORS)
    fusion = {"rrf": lambda m: m.FusionStrategy.rrf(), "linear": lambda m: m.FusionStrategy.linear(0.5),
              "dbsf": lambda m: m.FusionStrategy.dbsf()}[kind]
    jr.config.fusion, tr.config.fusion = fusion(jrag), fusion(trag)
    jh = JHybrid(jr, jm, fusion=fusion(jrag), candidates_per_source=20, sparse_mode="replicated")
    th = ShardedHybridIndex(tr, tm, fusion=fusion(trag), candidates_per_source=20, sparse_mode="replicated")
    queries = (["foxes retrieval", "data ranking", "document systems"] if corpus == "template"
               else [" ".join(MOCK_TEXTS[5].split()[:4]), "w003 w077 w150", "w010 w011"])
    for q in queries:
        got = th.search(q, 8)
        _same_results(got, tr.retrieve(q, 8))
        if corpus == "mock":
            _same_results(got, jh.search(q, 8))


def test_sharded_sparse_hybrid_matches_single_host_and_jax(meshes):
    """sparse_mode="sharded" on documents whose BM25 scores are distinct
    beyond the tail's rounding: rankings equal exactly."""
    from trueno_rag_tpu.parallel.hybrid import ShardedHybridIndex as JHybrid

    jm, tm = meshes
    rng = np.random.default_rng(9)
    vocab = [f"tok{j}" for j in range(120)]
    corpus = [" ".join(rng.choice(vocab, size=5 + (i * 3) % 29, replace=False)) for i in range(48)]
    jr, tr = _retrievers(corpus, cand=16)
    jh = JHybrid(jr, jm, candidates_per_source=16, sparse_mode="sharded")
    th = ShardedHybridIndex(tr, tm, candidates_per_source=16, sparse_mode="sharded")
    assert th.sparse is not None and th.sparse.rows_per_shard == jh.sparse.rows_per_shard
    for q in ["tok3 tok40 tok77", "tok10 tok11 tok95", "tok50 tok1 tok62"]:
        got = th.search(q, 6)
        _same_results(got, tr.retrieve(q, 6))
        _same_results(got, jh.search(q, 6))
    rows, scores = th.search_arrays(["tok3 tok40 tok77", "tok10 tok11 tok95"], 6)
    assert rows.shape == scores.shape == (2, 6) and rows.dtype == torch.int32


def test_sharded_hybrid_incremental_refresh_matches_jax(meshes):
    """refresh(rows) writes the changed rows into their shards: answers equal
    a rebuild, the mutated single-host retriever and the JAX index after the
    same mutations (replace row 4, add a chunk, remove chunk 7, then one
    more chunk), on tie-free data."""
    from trueno_rag_tpu.parallel.hybrid import ShardedHybridIndex as JHybrid

    jm, tm = meshes
    texts = _texts(36, seed=11, vocab=80)
    vecs = _vectors(36, 32, 11)
    runs = []
    for mod, mesh, cls, kw in ((jrag, jm, JHybrid, {}), (trag, tm, ShardedHybridIndex, {"device": "cpu"})):
        emb = mod.MockEmbedder(dimension=32)
        retr = mod.HybridRetriever(emb, **kw)
        retr.config.candidates_per_source = 16
        retr.index_batch(_chunks(mod, texts[:32], emb, vectors=vecs))
        sharded = cls(retr, mesh, candidates_per_source=16, sparse_mode="replicated")
        new4 = _chunks(mod, texts[32:33], emb, start=4, vectors=vecs[32:])[0]
        retr.index(new4)
        add = _chunks(mod, texts[33:34], emb, start=100, vectors=vecs[33:])[0]
        retr.index(add)
        row7 = retr.registry.row_of(mod.chunk_id_from_int(7))
        retr.remove(mod.chunk_id_from_int(7))
        sharded.refresh(rows=[retr.registry.row_of(new4.id), retr.registry.row_of(add.id), row7])
        runs.append((mod, retr, sharded, emb))
    (_, jretr, jh, _), (_, tretr, th, _) = runs
    rebuilt = ShardedHybridIndex(tretr, tm, candidates_per_source=16, sparse_mode="replicated")
    queries = [" ".join(texts[32].split()[:3]), " ".join(texts[7].split()[:3]), "w001 w020 w033"]
    for q in queries:
        got = th.search(q, 6)
        _same_results(got, rebuilt.search(q, 6))
        _same_results(got, tretr.retrieve(q, 6))
        _same_results(got, jh.search(q, 6))
        assert mod.chunk_id_from_int(7) not in [r.chunk.id for r in got]
    for mod, retr, sharded, emb in runs:
        big = _chunks(mod, texts[34:35], emb, start=200)[0]  # its own text's embedding: the query finds it
        retr.index(big)
        sharded.refresh(rows=[retr.registry.row_of(big.id)])
    q = texts[34]
    assert runs[1][0].chunk_id_from_int(200) in [r.chunk.id for r in th.search(q, 4)]
    _same_results(th.search(q, 4), jh.search(q, 4))
    _same_results(th.search(q, 4), tretr.retrieve(q, 4))


def test_sharded_hybrid_tag_filter_matches_single_host(meshes):
    """test_tags.py's sharded case: filters on the 8-shard index equal the
    single-host filtered retriever and the JAX index; a refresh carries a
    new chunk's tags."""
    from trueno_rag_tpu.parallel.hybrid import ShardedHybridIndex as JHybrid

    jm, tm = meshes
    texts = {"en": ["the quick brown fox jumps", "a lazy dog sleeps soundly"],
             "de": ["der schnelle braune fuchs", "ein fauler hund schlaeft"]}
    pair = []
    for mod, mesh, cls, kw in ((jrag, jm, JHybrid, {}), (trag, tm, ShardedHybridIndex, {"device": "cpu"})):
        emb = mod.MockEmbedder(dimension=32)
        retr = mod.HybridRetriever(emb, **kw)
        i = 0
        for lang, docs in texts.items():
            for t in docs:
                retr.index(mod.Chunk(document_id="d", content=t, start_offset=0, end_offset=len(t),
                                     metadata=mod.ChunkMetadata(), id=mod.chunk_id_from_int(i),
                                     embedding=np.asarray(emb.embed(t))), tags=[f"lang:{lang}", "src:test"])
                i += 1
        pair.append((mod, retr, cls(retr, mesh), emb))
    flt = [mod.TagFilter(all=("lang:de",)) for mod, *_ in pair]
    (_, jr, jh, _), (_, tr, th, temb) = pair
    got = th.search("fox schnelle", k=4, tag_filter=flt[1])
    assert got
    _same_results(got, tr.retrieve("fox schnelle", k=4, tag_filter=flt[1]))
    _same_results(got, jh.search("fox schnelle", k=4, tag_filter=flt[0]))
    for (mod, retr, sharded, emb), f in zip(pair, flt):
        c = mod.Chunk(document_id="d", content="noch ein fuchs text hier", start_offset=0, end_offset=24,
                      metadata=mod.ChunkMetadata(), id=mod.chunk_id_from_int(99),
                      embedding=np.asarray(emb.embed("noch ein fuchs text hier")))
        retr.index(c, tags=["lang:de"])
        sharded.refresh(rows=[retr.registry.row_of(c.id)])
        assert any(x.chunk.id == c.id for x in sharded.search("fuchs", k=6, tag_filter=f))
    _same_results(th.search("fuchs", k=6, tag_filter=flt[1]), jh.search("fuchs", k=6, tag_filter=flt[0]))
    # a tag-only edit is picked up by the registry's version key
    for (mod, retr, sharded, _), f in zip(pair, flt):
        retr.registry.set_tags(mod.chunk_id_from_int(0), ["lang:de"])
    _same_results(th.search("quick fox", k=6, tag_filter=flt[1]), tr.retrieve("quick fox", k=6, tag_filter=flt[1]))
    _same_results(th.search("quick fox", k=6, tag_filter=flt[1]), jh.search("quick fox", k=6, tag_filter=flt[0]))


@pytest.mark.parametrize("sparse_mode", ["replicated", "sharded"])
def test_sharded_tri_hybrid_matches_single_host_and_jax(meshes, sparse_mode):
    """test_tri_hybrid.py's sharded cases: the index picks up the
    retriever's learned source and answers as the single-host tri-hybrid
    and the JAX index (replicated BM25 there, as in the JAX test), on the
    JAX package's SPLADE weights carried across; rows equal, fused scores
    within rel 1e-4."""
    from test_torch_tri_hybrid import CAND, QUERIES, _jax_retriever, _port_retriever, _strategy
    from trueno_rag_tpu.parallel.hybrid import ShardedHybridIndex as JHybrid

    jm, tm = meshes
    jr, tr = _jax_retriever(), _port_retriever()
    for kind in ("rrf", "linear"):
        jr.config.fusion, tr.config.fusion = _strategy(jrag, kind), _strategy(trag, kind)
        th = ShardedHybridIndex(tr, tm, fusion=_strategy(trag, kind), candidates_per_source=CAND,
                                sparse_mode=sparse_mode)
        assert th.learned is not None and th.learned.n_shards == S
        jh = JHybrid(jr, jm, fusion=_strategy(jrag, kind), candidates_per_source=CAND, sparse_mode="replicated")
        for q in QUERIES:
            got = th.search(q, 6)
            _same_results(got, tr.retrieve(q, 6), rel=1e-4)
            _same_results(got, jh.search(q, 6), rel=1e-4)


def test_sharded_tri_refresh_rebuilds_learned_and_honors_use_learned(meshes):
    from test_torch_tri_hybrid import CAND, _port_retriever

    _, tm = meshes
    tr = _port_retriever()
    sharded = ShardedHybridIndex(tr, tm, candidates_per_source=CAND, sparse_mode="replicated")
    q = "w010 w020 w030 w040"
    before = [r.chunk.id for r in sharded.search(q, 6)]
    tr.remove(before[0])
    sharded.refresh(rows=[tr.registry.capacity_rows])  # past the capacity: the rebuild path
    sharded.refresh()  # a full rebuild: the learned shards re-derive
    after = sharded.search(q, 6)
    assert before[0] not in [r.chunk.id for r in after]
    _same_results(after, tr.retrieve(q, 6), rel=1e-4)
    tr.config.use_learned = False
    assert ShardedHybridIndex(tr, tm, candidates_per_source=CAND, sparse_mode="replicated").learned is None


def test_hybrid_modes_raise_on_unknown_names(meshes):
    _, tm = meshes
    _, tr = _retrievers(TEMPLATE[:8])
    with pytest.raises(trag.InvalidConfigError):
        ShardedHybridIndex(tr, tm, sparse_mode="mirrored")
    with pytest.raises(trag.InvalidConfigError):
        ShardedHybridIndex(tr, tm, dense_mode="int8")


# ---------------------------------------------------------------------------
# on the card: a 4-shard mesh over cuda:0
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cuda_four_shards_on_one_card_match_the_single_card():
    mesh = tmesh_mod.create_mesh(devices=[torch.device("cuda", 0)] * 4)
    matrix, rng = _rows(40_000, 64, 21)
    q = rng.standard_normal((32, 64)).astype(np.float32)
    got = tsh.ShardedVectorIndex(matrix, mesh, rows_normalized=True).search(q, 10)
    one = tdense.dense_topk(torch.from_numpy(q).cuda(), torch.from_numpy(matrix).cuda(),
                            torch.ones(40_000, dtype=torch.bool, device="cuda"), 10)
    assert got[0].device.type == "cuda"
    assert torch.equal(got[1], one[1]) and torch.equal(got[0], one[0])
