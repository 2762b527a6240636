"""The sharded cluster-pruned tier (``parallel/clustered.py``) against the
JAX package's on a 4 x 2 mesh: per-shard pruned scans composing a global
exact-set certificate. The two packages' host k-means agree only on
well-separated blobs, so the parity cases carry the JAX index's per-shard
layout across (``convert.sharded_clustered_from_jax``) and compare the
query path; the port's own build is held to the float64 oracle.

Tolerances: certified flags and rows equal (so the certified fractions
are), scores within 2e-6 (the residual-corrected rescore sums its
correction dot in another order; its interval is ~2e-5); every certified
set, and every answer after the host patch, the float64 exact top-k set
over the whole corpus.
"""

import numpy as np
import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import sharded_clustered_from_jax
from trueno_rag_tpu_torch.parallel.clustered import ShardedClusteredIndex
from trueno_rag_tpu_torch.parallel.compact import ShardedCompactIndex
from trueno_rag_tpu_torch.parallel.mesh import create_mesh

try:  # the card's machine has no JAX: only the cuda cases run there
    from trueno_rag_tpu.parallel.clustered import ShardedClusteredIndex as JClustered
    from trueno_rag_tpu.parallel.mesh import create_mesh as jcreate
except ImportError:
    JClustered = jcreate = None

S = 4
TILE = 1024


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _corpus(n=16_000, d=96, blobs=16, seed=0, planted=5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = np.repeat(np.arange(blobs), -(-n // blobs))[:n]
    m = centers[which] + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    for bi in range(blobs):
        rows = np.flatnonzero(which == bi)[:planted]
        m[rows] = centers[bi] + 0.01 * rng.standard_normal((len(rows), d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m.astype(np.float32), centers


def _oracle(m, queries, k, allowed=None):
    q = np.asarray(queries, np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = q @ m.astype(np.float64).T
    if allowed is not None:
        s[:, ~allowed] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


@pytest.fixture(scope="module")
def meshes():
    return jcreate(data=S, model=2), create_mesh(data=S, model=2, devices=[torch.device("cpu")] * 8)


def _pair(m, meshes, **kw):
    """The JAX index (its own k-means) and the port's over its layout."""
    jm, tm = meshes
    j = JClustered(m, jm, tile_n=TILE, interpret=True, **kw)
    return j, sharded_clustered_from_jax(j, tm, matrix=m)


def _same(got, want):
    s_t, r_t, ok_t = (_np(x) for x in got)
    s_j, r_j, ok_j = (_np(x) for x in want)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(r_t, r_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    np.testing.assert_allclose(s_t[fin], s_j[fin], rtol=0, atol=2e-6)


def test_sharded_clustered_certified_sets_exact(meshes):
    m, centers = _corpus()
    queries = centers[:4].astype(np.float32)
    k = 5
    j, t = _pair(m, meshes, probe_tiles=2, keep_host=False)
    assert t._host is None and t.rows_per_shard == j.rows_per_shard
    got = t.search(queries, k)
    _same(got, j.search(queries, k))
    rx = _oracle(m, queries, k)
    ok = _np(got[2]).astype(bool)
    assert ok.any(), "nothing certified on planted blob data"
    for i in np.flatnonzero(ok):
        assert set(_np(got[1])[i].tolist()) == set(rx[i].tolist()), i
    # the port's own per-shard k-means: certified sets exact too
    own = ShardedClusteredIndex(m, meshes[1], tile_n=TILE, probe_tiles=2, keep_host=False)
    s, r, ok = (_np(x) for x in own.search(queries, k))
    assert ok.any()
    for i in np.flatnonzero(ok):
        assert set(r[i].tolist()) == set(rx[i].tolist()), i


def test_sharded_clustered_host_patch_makes_all_exact(meshes):
    m, centers = _corpus(seed=2)
    rng = np.random.default_rng(3)
    # off-center queries: some fail the certificate
    queries = (centers[:3] + 0.3 * rng.standard_normal((3, m.shape[1]))).astype(np.float32)
    rx = _oracle(m, queries, 5)
    j, t = _pair(m, meshes, probe_tiles=1)
    got, want = t.search(queries, 5), j.search(queries, 5)
    assert t.uncertified == j.uncertified
    for idx, (s, r, ok) in ((t, got), (j, want)):
        assert bool(_np(ok).all())
        for i in range(3):
            assert set(_np(r)[i].tolist()) == set(rx[i].tolist()), i
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))
    own = ShardedClusteredIndex(m, meshes[1], tile_n=TILE, probe_tiles=1)
    s, r, ok = (_np(x) for x in own.search(queries, 5))
    assert ok.all()
    for i in range(3):
        assert set(r[i].tolist()) == set(rx[i].tolist()), i


def test_sharded_clustered_tags(meshes):
    m, centers = _corpus(seed=5)
    tag_bits = np.random.default_rng(6).integers(0, 4, size=m.shape[0]).astype(np.int32)
    b = 3
    queries = centers[:b].astype(np.float32)
    masks = (np.full(b, 1, np.int32), np.zeros(b, np.int32), np.zeros(b, np.int32))
    allowed = (tag_bits & 1) != 0
    rx = _oracle(m, queries, 5, allowed=allowed)
    j, t = _pair(m, meshes, probe_tiles=3, tags=tag_bits, keep_host=False)
    got = t.search(queries, 5, tag_masks=masks)
    _same(got, j.search(queries, 5, tag_masks=masks))
    for i in np.flatnonzero(_np(got[2])):
        assert set(_np(got[1])[i].tolist()) == set(rx[i].tolist())
    own = ShardedClusteredIndex(m, meshes[1], tile_n=TILE, probe_tiles=3, tags=tag_bits)
    s, r, ok = (_np(x) for x in own.search(queries, 5, tag_masks=masks))
    assert ok.all()
    for i in range(b):
        assert all(allowed[x] for x in r[i] if x >= 0), "filter leaked"
        assert set(r[i].tolist()) == set(rx[i].tolist()), i
    # re-uploaded tags are permuted into each shard's layout again
    own.set_tags(np.zeros_like(tag_bits))
    assert (_np(own.search(queries, 5, tag_masks=masks)[1]) == -1).all()
    with pytest.raises(trag.InvalidConfigError):
        ShardedClusteredIndex(m[:2048], meshes[1], tile_n=TILE).search(queries, 5, tag_masks=masks)
    with pytest.raises(trag.InvalidConfigError):
        ShardedClusteredIndex(m[:2048], meshes[1], metric="euclidean")


def test_sharded_clustered_matches_sharded_compact(meshes):
    """The pruned tier's certified sets agree with the full-stream compact
    tier's on the same corpus (both prove the same global set)."""
    m, centers = _corpus(seed=8, n=8192, blobs=8)
    m = m[np.random.default_rng(9).permutation(m.shape[0])]
    _, tm = meshes
    clustered = ShardedClusteredIndex(m, tm, tile_n=TILE, probe_tiles=2, keep_host=False)
    compact = ShardedCompactIndex(m, tm, tile_n=TILE, keep_host=False)
    queries = centers[:3].astype(np.float32)
    _, r1, ok1 = clustered.search(queries, 5)
    _, r2, ok2 = compact.search(queries, 5)
    both = _np(ok1).astype(bool) & _np(ok2).astype(bool)
    assert both.any()
    for i in np.flatnonzero(both):
        assert set(_np(r1)[i].tolist()) == set(_np(r2)[i].tolist())


def test_hybrid_dense_mode_clustered(meshes):
    """dense_mode="clustered": pruned dense shards + BM25 + fusion answer as
    the single-host retriever, with and without a tag filter."""
    from trueno_rag_tpu_torch.parallel.hybrid import ShardedHybridIndex

    _, tm = meshes
    rng = np.random.default_rng(12)
    n, dim, blobs = 8192, 48, 8
    centers = rng.standard_normal((blobs, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = np.repeat(np.arange(blobs), n // blobs)
    m = centers[which] + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    retr = trag.HybridRetriever(trag.MockEmbedder(dimension=dim), device="cpu",
                                vector_config=trag.VectorStoreConfig(dimension=dim, scan_tile_n=1024,
                                                                     cluster_probe_tiles=2))
    retr.config.candidates_per_source = 12
    chunks = []
    for i in range(n):
        c = trag.Chunk(document_id="d", content=f"topic{which[i]} item {i} data", start_offset=0, end_offset=5,
                       metadata=trag.ChunkMetadata(), id=trag.chunk_id_from_int(i))
        c.set_embedding(m[i])
        chunks.append(c)
    retr.index_batch(chunks)
    for i in range(0, n, 2):
        retr.registry.set_tags(chunks[i].id, ["even"])
    hybrid = ShardedHybridIndex(retr, tm, candidates_per_source=12, dense_mode="clustered", sparse_mode="replicated")
    assert hybrid.dense.fetch == "auto" and hybrid.dense.probe_tiles == 2
    q = "topic3 item data"
    assert [r.chunk.id for r in hybrid.search(q, 5)] == [r.chunk.id for r in retr.retrieve(q, 5)]
    f = trag.TagFilter(all=["even"])
    assert ([r.chunk.id for r in hybrid.search(q, 5, tag_filter=f)]
            == [r.chunk.id for r in retr.retrieve(q, 5, tag_filter=f)])


def test_sharded_clustered_concentrated_runners_up_certify(meshes):
    """With t_top sized to exactly k a scanned tile's exclusion threshold
    sits above the k-th score of a corpus whose top-k concentrates in one
    tile; the +4 runner-up slack makes it certify end to end."""
    rng = np.random.default_rng(41)
    d, k = 64, 10
    n = 16 * TILE  # 4 tiles per shard, one natural blob per tile
    blobs = n // TILE
    centers = rng.standard_normal((blobs, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    per = n // blobs
    which = np.repeat(np.arange(blobs), per)
    sig = np.where(np.arange(n) % per < k, 0.005, 0.04)
    m = (centers[which] + sig[:, None] * rng.standard_normal((n, d))).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    queries = centers[rng.choice(blobs, size=6, replace=False)].astype(np.float32)
    rx = _oracle(m, queries, k)
    j, t = _pair(m, meshes, probe_tiles=2, keep_host=False)
    got = t.search(queries, k)
    _same(got, j.search(queries, k))
    own = ShardedClusteredIndex(m, meshes[1], tile_n=TILE, probe_tiles=2, keep_host=False)
    for s, r, ok in (got, own.search(queries, k)):
        assert bool(_np(ok).all()), f"only {int(_np(ok).sum())}/6 certified"
        for i in range(len(queries)):
            assert set(_np(r)[i].tolist()) == set(rx[i].tolist()), i


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cuda_four_shards_on_one_card_scan_with_k5():
    """On a 4-shard mesh over cuda:0 each shard's pruned scan is one K5
    launch (fetch "auto" resolves to dma on the card)."""
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss

    m, centers = _corpus(n=32_768, d=96, blobs=32)
    idx = ShardedClusteredIndex(m, create_mesh(devices=[torch.device("cuda", 0)] * 4), tile_n=TILE, probe_tiles=2)
    ss.scan_select_v3_indirect.launches = 0
    s, r, ok = idx.search(centers[:8].astype(np.float32), 5)
    assert ss.scan_select_v3_indirect.launches == 4 and bool(ok.all())
    rx = _oracle(m, centers[:8], 5)
    for i in range(8):
        assert set(_np(r)[i].tolist()) == set(rx[i].tolist()), i
