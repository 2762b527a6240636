"""The sharded compact tier (``parallel/compact.py``) against the JAX
package's on an 8-shard mesh (Pallas in interpret mode there, K1's plain
version here): every shard's compact scan composes into one global set
certificate, sound and failing closed on planted boundary ties.

Both packages scan in 1,024-row selection tiles (``tile_n=1024``: the
port's K1 emits per 1,024 rows whatever ``tile_n`` asks, so the JAX
tests' 64- and 128-row tiles become 1,024 here, and shard sizes grow to
hold enough tiles for k). Tolerances: certified flags and rows equal
(hence the certified fractions), scores within 1e-6 (relative past 1), every certified set
the float64 exact top-k set; after the host patch every answer the exact
set, the patch counters equal to the JAX index's.
"""

import numpy as np
import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.ops import dense_tiered as tdt
from trueno_rag_tpu_torch.parallel import compact as tc
from trueno_rag_tpu_torch.parallel.hybrid import ShardedHybridIndex
from trueno_rag_tpu_torch.parallel.mesh import create_mesh, shard_rows

try:  # the card's machine has no JAX: only the cuda cases run there
    import jax.numpy as jnp
    from trueno_rag_tpu.ops import dense_tiered as jdt
    from trueno_rag_tpu.parallel import compact as jc
    from trueno_rag_tpu.parallel.mesh import create_mesh as jcreate
except ImportError:
    jnp = jdt = jc = jcreate = None

S = 8
TILE = 1024


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def meshes():
    return jcreate(data=S, model=1), create_mesh(devices=[torch.device("cpu")] * S)


def _oracle(queries, matrix, valid, k, metric="cosine"):
    """float64 true-score top-k rows, (score desc, row asc)."""
    q = np.asarray(queries, dtype=np.float64)
    if metric == "cosine":
        q = q / np.where((n := np.linalg.norm(q, axis=1, keepdims=True)) == 0.0, 1.0, n)
    scores = q @ np.asarray(matrix, dtype=np.float64).T
    scores[:, ~valid] = -np.inf
    return np.argsort(-scores, axis=1, kind="stable")[:, :k]


def _both(queries, matrix, valid, k, meshes, metric="cosine", tile_n=TILE):
    """The JAX and the port sharded_compact_topk on the same replicas."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    jm, tm = meshes
    jparts = jdt.prepare_tiered(jnp.asarray(matrix)) + jdt.prepare_residual(jnp.asarray(matrix))
    row, vec = NamedSharding(jm, P("data", None)), NamedSharding(jm, P("data"))
    jparts = [jax.device_put(x, row if x.ndim == 2 else vec) for x in jparts]
    want = jc.sharded_compact_topk(jnp.asarray(queries), *jparts, jax.device_put(jnp.asarray(valid), vec), k, jm,
                                   metric=metric, tile_n=tile_n, interpret=True)
    tm_ = torch.from_numpy(matrix)
    tparts = [shard_rows(x, tm) for x in tdt.prepare_tiered(tm_) + tdt.prepare_residual(tm_)]
    got = tc.sharded_compact_topk(queries, *tparts, shard_rows(valid, tm), k, tm, metric=metric, tile_n=tile_n)
    return got, want


def _same(got, want):
    s_t, r_t, ok_t = (_np(x) for x in got)
    s_j, r_j, ok_j = (_np(x) for x in want)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(r_t, r_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_sharded_compact_certified_sets_exact(meshes, metric):
    rng = np.random.default_rng(0)
    n, d, b, k = 16384, 32, 8, 5  # 2,048 rows (2 tiles, 8 candidates) per shard
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[50:80] = False
    got, want = _both(queries, matrix, valid, k, meshes, metric)
    _same(got, want)
    s, r, ok = (_np(x) for x in got)
    assert ok.sum() >= b // 2, f"only {ok.sum()}/{b} certified"
    oracle = _oracle(queries, matrix, valid, k, metric)
    for i in np.flatnonzero(ok):
        assert set(r[i].tolist()) == set(oracle[i].tolist()), i
        assert np.all(np.diff(s[i]) <= 1e-6)


def test_sharded_compact_fails_closed_on_boundary_tie(meshes):
    """An exact duplicate pair at ranks 3 and 4, on shards 0 and 7: no
    interval certificate separates them, so the query must not certify."""
    rng = np.random.default_rng(1)
    n, d, k = 512, 32, 3
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    q = rng.standard_normal((1, d)).astype(np.float32)
    base = (q / np.linalg.norm(q))[0]
    matrix[0] = base
    matrix[1] = 0.99 * base + 0.01 * matrix[1]
    matrix[1] /= np.linalg.norm(matrix[1])
    tie = 0.95 * base + 0.05 * matrix[2]
    matrix[2] = tie / np.linalg.norm(tie)
    matrix[448] = matrix[2]  # the same vector on shard 7
    got, want = _both(q, matrix, np.ones(n, bool), k, meshes)
    _same(got, want)
    assert not bool(_np(got[2])[0]), "a tie at the k boundary must fail closed"


def _indexes(matrix, meshes, **kw):
    jm, tm = meshes
    return jc.ShardedCompactIndex(matrix, jm, interpret=True, **kw), tc.ShardedCompactIndex(matrix, tm, **kw)


def _same_index(tidx, jidx):
    assert (tidx.uncertified, tidx.candidate_patched, tidx.gemm_patched) == (
        jidx.uncertified, jidx.candidate_patched, jidx.gemm_patched)


def test_sharded_compact_index_host_patch_and_counters(meshes):
    rng = np.random.default_rng(2)
    n, d, b, k = 700, 48, 8, 7  # n % 8 != 0: padding rows must not surface
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((b, d)).astype(np.float32)
    j, t = _indexes(matrix, meshes, tile_n=TILE)
    got, want = t.search(queries, k), j.search(queries, k)
    _same(got, want)
    _same_index(t, j)
    s, r, ok = (_np(x) for x in got)
    assert ok.all() and (r >= 0).all() and (r < n).all()
    oracle = _oracle(queries, matrix / np.linalg.norm(matrix, axis=1, keepdims=True), np.ones(n, bool), k)
    for i in range(b):
        assert set(r[i].tolist()) == set(oracle[i].tolist()), i
    # without the host matrix: flags surface, the counter still counts
    j2, t2 = _indexes(matrix, meshes, tile_n=TILE, keep_host=False)
    got2 = t2.search(queries, k)
    _same(got2, j2.search(queries, k))
    ok2 = _np(got2[2]).astype(bool)
    for i in np.flatnonzero(ok2):
        assert set(_np(got2[1])[i].tolist()) == set(oracle[i].tolist())
    assert t2.uncertified == j2.uncertified == int((~ok2).sum())


def test_sharded_containment_patch_resolves_near_ties_without_gemm(meshes):
    """Near-duplicates (gaps at f32 rounding level) spread across shards
    defeat the composed certificate; the union of the shards' candidates
    and the largest shard threshold prove containment, so the float64
    patch resolves them from ~s·W rows, never the full pass."""
    rng = np.random.default_rng(4)
    n, d, b, k = 16384, 32, 4, 10
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    base = matrix[0].astype(np.float64)
    base /= np.linalg.norm(base)
    for j in range(1, 15):
        row = base + rng.standard_normal(d) * 2e-5
        matrix[j * 1100] = (row / np.linalg.norm(row)).astype(np.float32)
    queries = np.stack([base.astype(np.float32)] * b)
    jidx, tidx = _indexes(matrix, meshes, tile_n=TILE, rows_normalized=True)
    got = tidx.search(queries, k)
    _same(got, jidx.search(queries, k))
    _same_index(tidx, jidx)
    assert _np(got[2]).astype(bool).all()
    assert tidx.uncertified >= 1 and tidx.candidate_patched >= 1 and tidx.gemm_patched == 0
    oracle = _oracle(queries, matrix, np.ones(n, bool), k)
    for i in range(b):  # patched queries carry the exact float64 ORDER
        assert _np(got[1])[i].tolist() == oracle[i].tolist(), i


def test_host_exact_patch_matches_jax_with_filters(meshes):
    """The float64 full pass alone (every query uncertified), with and
    without a per-query tag filter, against the JAX package's."""
    rng = np.random.default_rng(8)
    n, d, b, k = 3000, 16, 5, 6
    host = rng.standard_normal((n, d)).astype(np.float32)
    valid = rng.random(n) > 0.05
    tags = rng.integers(0, 8, n).astype(np.int32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    s0 = np.zeros((b, k), np.float32)
    r0 = np.zeros((b, k), np.int32)
    ok = np.array([False, True, False, False, False])
    masks = (np.array([1, 0, 2, 8, 0], np.int32), np.array([0, 6, 0, 0, 0], np.int32),
             np.array([0, 0, 1, 0, 4], np.int32))
    for tm in (None, masks):
        got = tc.host_exact_patch(host, valid, tags, "cosine", q, torch.from_numpy(s0), torch.from_numpy(r0), ok,
                                  k, tag_masks=tm)
        want = jc.host_exact_patch(host, valid, tags, "cosine", jnp.asarray(q), jnp.asarray(s0), jnp.asarray(r0),
                                   ok, k, tag_masks=tm)
        np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    assert (_np(got[1])[3] == -1).all()  # t_all = 8: no row carries bit 3


def test_sharded_compact_memory_is_3_bytes_per_element(meshes):
    rng = np.random.default_rng(3)
    n, d = 1024, 64
    idx = tc.ShardedCompactIndex(rng.standard_normal((n, d)).astype(np.float32), meshes[1], keep_host=False)
    assert idx.m_bf16.nbytes + idx.r_i8.nbytes == 3 * n * d
    assert idx.m_bf16.shards[0].dtype == torch.bfloat16 and idx.r_i8.shards[0].dtype == torch.int8
    aux = sum(a.nbytes for a in (idx.e_l2, idx.a_l2, idx.r_scale, idx.e2_l2, idx.valid))
    assert aux <= n * 4 * 5 and idx._host is None


def test_sharded_bf16rr_resolves_gaps_bf16r_cannot(meshes):
    """Rank-boundary gaps of 6e-6 spread over every shard: inside bf16r's
    ~2.2e-5 composed interval (fails closed), above bf16rr's ~1.5e-6
    (certifies with no host patch); certified sets equal the oracle."""
    rng = np.random.default_rng(41)
    n, d, bq, k = 16384, 384, 4, 8  # 2 tiles (8 candidates) per shard
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = rng.standard_normal((bq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    used = set()
    for b in range(bq):
        for i in range(k + 4):
            row = (31 + b * 97 + i * 1361) % n  # scattered over the shards
            assert row not in used
            used.add(row)
            target = 0.9 - 6e-6 * i
            u = rng.standard_normal(d).astype(np.float32)
            u -= (u @ q[b]) * q[b]
            u /= np.linalg.norm(u)
            m[row] = target * q[b] + np.sqrt(1.0 - target * target) * u
    tm = meshes[1]
    idx_r = tc.ShardedCompactIndex(m, tm, rows_normalized=True, tile_n=TILE, keep_host=False)
    idx_rr = tc.ShardedCompactIndex(m, tm, rows_normalized=True, tile_n=TILE, keep_host=False, layout="bf16rr")
    _, _, ok_r = idx_r.search(q, k)
    s2, r2, ok_rr = idx_rr.search(q, k)
    assert not bool(_np(ok_r).any()), "bf16r must fail closed at 6e-6"
    assert bool(_np(ok_rr).all()), "bf16rr must certify 6e-6 gaps"
    oracle = _oracle(q, m, np.ones(n, bool), k)
    for b in range(bq):
        assert set(_np(r2)[b].tolist()) == set(oracle[b].tolist()), b


def test_sharded_bf16rr_matches_jax_memory_and_validation(meshes):
    rng = np.random.default_rng(42)
    n, d = 1024, 64
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    j, t = _indexes(matrix, meshes, keep_host=False, layout="bf16rr", tile_n=TILE)
    assert sum(a.nbytes for a in (t.m_bf16, t.r_i8, t.r2_i8)) == 4 * n * d
    q = rng.standard_normal((4, d)).astype(np.float32)
    got = t.search(q, 3)
    _same(got, j.search(q, 3))
    assert _np(got[1]).shape == (4, 3)
    with pytest.raises(trag.InvalidConfigError):
        tc.ShardedCompactIndex(matrix, meshes[1], layout="int8")
    with pytest.raises(trag.InvalidConfigError):
        tc.ShardedCompactIndex(matrix, meshes[1], metric="euclidean")


def _mock_retriever(n, seed, dim=32, tags=False, compact_scan="bf16r"):
    rng = np.random.default_rng(seed)
    words = [f"term{i:03d}" for i in range(200)]
    emb = trag.MockEmbedder(dimension=dim)
    retr = trag.HybridRetriever(emb, device="cpu")
    retr.config.candidates_per_source = 12
    retr.vector_store.config.compact_scan = compact_scan
    chunks = []
    for i in range(n):
        t = " ".join(rng.choice(words, size=10, replace=False))
        c = trag.Chunk(document_id="d", content=t, start_offset=0, end_offset=len(t),
                       metadata=trag.ChunkMetadata(), id=trag.chunk_id_from_int(i))
        c.set_embedding(emb.embed_document(t))
        chunks.append(c)
        if tags:
            retr.index(c, tags=["en" if i % 2 else "fr", f"tenant{i % 3}"])
    if not tags:
        retr.index_batch(chunks)
    return retr, chunks


def _ids(results):
    return [r.chunk.id for r in results]


@pytest.mark.parametrize("compact_scan", ["bf16r", "bf16rr"])
def test_sharded_hybrid_compact_dense_matches_single_host(meshes, compact_scan):
    """dense_mode="compact" (the store's bf16rr layout followed) with
    replicated BM25 ranks as the single-host retriever (the host patch
    makes uncertified dense lists exact); then a mutation and refresh."""
    _, tm = meshes
    retr, chunks = _mock_retriever(96, 7, compact_scan=compact_scan)
    sharded = ShardedHybridIndex(retr, tm, candidates_per_source=12, dense_mode="compact", sparse_mode="replicated")
    assert sharded.dense.layout == compact_scan
    for q in [chunks[5].content[:40], "term003 term077 term150"]:
        assert _ids(sharded.search(q, 5)) == _ids(retr.retrieve(q, 5)), q
    new = trag.Chunk(document_id="d", content="term001 term002 term005 fresh words", start_offset=0, end_offset=35,
                     metadata=trag.ChunkMetadata(), id=trag.chunk_id_from_int(500))
    new.set_embedding(retr.embedder.embed_document(new.content))
    retr.index(new)
    sharded.refresh(rows=[retr.registry.row_of(new.id)])
    q = "term001 term002 term005"
    assert _ids(sharded.search(q, 5)) == _ids(retr.retrieve(q, 5))
    assert new.id in _ids(sharded.search(q, 5))


def test_sharded_compact_tag_filters_match_single_host(meshes):
    """Filters ride each shard's scan; filtered hybrid answers equal the
    single-host tagged path, a tag-only edit is picked up by the version
    key, and a filter allowing one row corpus-wide certifies through the
    short-result rule (no host patch)."""
    _, tm = meshes
    retr, _ = _mock_retriever(120, 9, tags=True)
    sharded = ShardedHybridIndex(retr, tm, candidates_per_source=12, dense_mode="compact", sparse_mode="replicated")
    filters = [trag.TagFilter(all=["en"]), trag.TagFilter(none=["fr"]), trag.TagFilter(any=["tenant0", "tenant2"]),
               trag.TagFilter(all=["en"], none=["tenant1"])]
    for f in filters:
        for q in ["term001 term050 term099", "term120 term007"]:
            assert _ids(sharded.search(q, 5, tag_filter=f)) == _ids(retr.retrieve(q, 5, tag_filter=f)), (f, q)
    retr.registry.set_tags(trag.chunk_id_from_int(7), ["rare"])
    before = sharded.dense.uncertified
    f = trag.TagFilter(all=["rare"])
    got = _ids(sharded.search("term001", 5, tag_filter=f))
    assert got == _ids(retr.retrieve("term001", 5, tag_filter=f)) and len(got) == 1
    assert sharded.dense.uncertified == before


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cuda_four_shards_on_one_card_launch_k1_per_shard():
    """On a 4-shard mesh over cuda:0 each shard's compact scan is one K1
    launch; certified sets are exact and the host patch covers the rest."""
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss

    rng = np.random.default_rng(5)
    n, d, b, k = 65_536, 64, 32, 10
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = tc.ShardedCompactIndex(m, create_mesh(devices=[torch.device("cuda", 0)] * 4), rows_normalized=True)
    ss.scan_select_v3.launches = 0
    s, r, ok = idx.search(q, k)
    assert ss.scan_select_v3.launches == 4 and bool(ok.all()) and r.device.type == "cuda"
    oracle = _oracle(q, m, np.ones(n, bool), k)
    for i in range(b):
        assert set(_np(r)[i].tolist()) == set(oracle[i].tolist()), i
