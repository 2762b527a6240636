"""The clustered tier through the port's store, retriever and pipeline,
against the JAX package: a JAX store's layout carried across with
``convert.retriever_from_state(cluster=...)`` answers exactly as the JAX
store does, through inserts, removals and updates (the incremental path),
tag filters and the host patches; the port's own builds re-cluster where
the JAX store would, and every answer stays exact.

Tolerances: dense scores 1e-6 absolute (fp32 rescores of the same stored
values, summed in another order); pipeline results as in
tests/test_torch_pipeline.py."""

import numpy as np
import pytest

import trueno_rag_tpu as jrag
import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import retriever_from_state
from trueno_rag_tpu_torch.ops import clustered as tcl

DIM = 32
TILE = 1024


def _blob_matrix(n, blobs, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((blobs, DIM)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    which = np.repeat(np.arange(blobs), n // blobs)[:n]
    m = centers[which] + sigma * rng.standard_normal((n, DIM)).astype(np.float32)
    return m.astype(np.float32), centers


def _chunk(rag, i, emb, words=None):
    c = rag.Chunk(
        id=f"c{i}", document_id=f"d{i}", content=words or f"w{i % 97:03d} w{i % 89:03d} body",
        start_offset=0, end_offset=7, metadata=rag.ChunkMetadata(), embedding=np.asarray(emb).tolist(),
    )
    return c


def _cfg(rag, **kw):
    kw = dict(dict(dimension=DIM, scan_tier="clustered", scan_tile_n=TILE, cluster_probe_tiles=2), **kw)
    return rag.VectorStoreConfig(**kw)


def _carried_pair(n=4000, blobs=4, seed=0, ready=True, **kw):
    """A JAX retriever on the clustered tier (its layout built) and the
    port's retriever carrying its state and its layout (consumed by the
    port's first build unless ``ready`` is False)."""
    m, centers = _blob_matrix(n, blobs, seed)
    jr = jrag.HybridRetriever(jrag.MockEmbedder(DIM), vector_config=_cfg(jrag, **kw))
    jr.index_batch([_chunk(jrag, i, m[i]) for i in range(n)])
    js = jr.vector_store
    js.ensure_ready()
    order, _, cent, radii = js._cluster
    chunks = [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)]
    tr = retriever_from_state(
        trag.MockEmbedder(DIM), chunks, js._host, js._valid, jr.sparse_index.state_dict(),
        vector_config=_cfg(trag, **kw), device="cpu",
        cluster=(order, np.asarray(cent), np.asarray(radii)),
    )
    if ready:
        tr.vector_store.ensure_ready()
    return jr, tr, centers


@pytest.fixture
def builds(monkeypatch):
    """Counts the port's full k-means builds (outermost calls only: a build
    over a store with holes recurses into itself for the live rows)."""
    calls = []
    depth = [0]
    for name in ("prepare_clustered", "prepare_clustered_device", "prepare_clustered_stream"):
        fn = getattr(tcl, name)

        def counted(*a, _fn=fn, _name=name, **k):
            if depth[0] == 0:
                calls.append(_name)
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1

        monkeypatch.setattr(tcl, name, counted)
    return calls


COUNTERS = ("compact_uncertified", "compact_candidate_patched", "compact_gemm_patched", "tier_fallbacks")


def _same_search(js, ts, queries, k, tag_masks=None):
    js_s, js_r = js.search_arrays(queries, k, tag_masks=tag_masks)
    ts_s, ts_r = ts.search_arrays(queries, k, tag_masks=tag_masks)
    np.testing.assert_array_equal(ts_r.numpy(), np.asarray(js_r))
    np.testing.assert_allclose(ts_s.numpy(), np.asarray(js_s), rtol=0, atol=1e-6)
    assert [getattr(ts, c) for c in COUNTERS] == [getattr(js, c) for c in COUNTERS]
    return ts_r.numpy()


def _queries(centers, rng):
    return np.concatenate([centers, rng.standard_normal((2, DIM))]).astype(np.float32)


def test_carried_layout_answers_like_jax_without_kmeans(builds):
    jr, tr, centers = _carried_pair(seed=1)
    js, ts = jr.vector_store, tr.vector_store
    queries = _queries(centers, np.random.default_rng(2))
    _same_search(js, ts, queries, 7)
    assert builds == []  # the carried layout was used as it is
    np.testing.assert_array_equal(ts._cluster[0], js._cluster[0])
    assert ts._device_matrix is None and ts._tier_built_for == "clustered"


def test_carried_layout_is_voided_by_a_mutation(builds):
    jr, tr, centers = _carried_pair(seed=3, ready=False)
    tr.index(_chunk(trag, 9000, centers[0]))
    assert tr.vector_store._cluster_preset is None
    tr.vector_store.ensure_ready()
    assert builds == ["prepare_clustered_stream"]
    plain = trag.VectorStore(trag.VectorStoreConfig(dimension=DIM), device="cpu")
    plain._host, plain._valid = tr.vector_store._host.copy(), tr.vector_store._valid.copy()
    q = centers.astype(np.float32)
    s, r = tr.vector_store.search_arrays(q, 5)
    ps, pr = plain.search_arrays(q, 5)
    assert all(set(a) == set(b) for a, b in zip(r.tolist(), pr.tolist()))


def test_cluster_argument_is_checked():
    jr, _, _ = _carried_pair(n=2048, blobs=2, seed=4, ready=False)
    js = jr.vector_store
    order, _, cent, radii = js._cluster
    chunks = [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)]
    for vcfg, cl in (
        (trag.VectorStoreConfig(dimension=DIM), (order, cent, radii)),  # not the clustered tier
        (_cfg(trag, scan_tile_n=2048), (order, cent, radii)),  # another tile
        (_cfg(trag), (order, np.asarray(cent)[:1], radii)),
    ):
        with pytest.raises(trag.InvalidConfigError):
            retriever_from_state(trag.MockEmbedder(DIM), chunks, js._host, js._valid,
                                 jr.sparse_index.state_dict(), vector_config=vcfg, device="cpu", cluster=cl)


def test_mutations_match_jax_on_the_incremental_path(builds):
    """Inserts into holes, a removal and an in-place update: both stores
    fold them into the layout (no k-means), keep the same order and radii,
    and answer alike."""
    jr, tr, centers = _carried_pair(seed=5)
    js, ts = jr.vector_store, tr.vector_store
    rng = np.random.default_rng(6)
    q = centers[2:3].astype(np.float32)
    for i in range(10):
        emb = (centers[2] + 0.001 * rng.standard_normal(DIM)).astype(np.float32)
        jr.index(_chunk(jrag, 10_000 + i, emb))
        tr.index(_chunk(trag, 10_000 + i, emb))
    rows = _same_search(js, ts, q, 8)
    assert builds == [] and ts._cluster_incremental == js._cluster_incremental == 10
    assert set(rows[0]) & {tr.registry.row_of(f"c{10_000 + i}") for i in range(10)}, "new rows invisible"
    top = tr.registry.id_of(int(rows[0, 0]))
    assert jr.remove(top) and tr.remove(top)
    _same_search(js, ts, q, 8)
    for r in (jr, tr):  # an existing chunk becomes the query itself
        r.index(_chunk(jrag if r is jr else trag, 7, q[0]))
    rows = _same_search(js, ts, q, 8)
    assert rows[0, 0] == tr.registry.row_of("c7")
    assert builds == []
    np.testing.assert_array_equal(ts._cluster[0], js._cluster[0])
    np.testing.assert_array_equal(ts._cluster[3].numpy(), np.asarray(js._cluster[3]))
    assert ts._cluster_version == 4  # the carried build + three folds


def test_tag_filters_match_jax_and_fp32():
    jr, tr, centers = _carried_pair(seed=7)
    js, ts = jr.vector_store, tr.vector_store
    for r in (jr, tr):
        for i in range(4000):
            r.registry.set_tags(f"c{i}", ["even" if i % 2 == 0 else "odd"])
    plain = trag.VectorStore(trag.VectorStoreConfig(dimension=DIM), device="cpu")
    plain._host, plain._valid = ts._host.copy(), ts._valid.copy()
    plain.registry = tr.registry
    from trueno_rag_tpu_torch.ops.tags import dense_topk_tagged
    import torch

    q = centers.astype(np.float32)
    for masks in ((np.ones(4, np.int32), np.zeros(4, np.int32), np.zeros(4, np.int32)),
                  (np.zeros(4, np.int32), np.zeros(4, np.int32), np.ones(4, np.int32))):
        rows = _same_search(js, ts, q, 7, tag_masks=masks)
        ps, pr = dense_topk_tagged(
            torch.from_numpy(q), plain.device_matrix, plain.device_valid, plain._device_tag_bits(),
            *(torch.from_numpy(x) for x in masks), 7, "cosine")
        np.testing.assert_array_equal(rows, pr.numpy())


def test_incremental_budget_forces_recluster(builds):
    m, centers = _blob_matrix(4000, 4, seed=8)
    store = trag.VectorStore(_cfg(trag, cluster_incremental_limit=0.002), device="cpu")
    store.insert_many([_chunk(trag, i, m[i]) for i in range(4000)])
    q = centers[1:2].astype(np.float32)
    store.search_arrays(q, 3)
    assert builds == ["prepare_clustered_stream"]
    for i in range(5):  # budget 0.002 * 4000 = 8 rows
        store.insert(_chunk(trag, 30_000 + i, centers[1]))
    store.search_arrays(q, 3)
    assert store._cluster_incremental == 5 and len(builds) == 1
    for i in range(5, 11):
        store.insert(_chunk(trag, 30_000 + i, centers[1]))
    store.search_arrays(q, 3)
    assert store._cluster_incremental == 0 and len(builds) == 2

    off = trag.VectorStore(_cfg(trag, cluster_incremental_limit=0.0), device="cpu")
    off.insert_many([_chunk(trag, i, m[i]) for i in range(4000)])
    off.search_arrays(q, 3)
    off.insert(_chunk(trag, 40_000, centers[1]))
    off.search_arrays(q, 3)
    assert off._cluster_incremental == 0 and len(builds) == 4  # every mutation re-clusters


def test_full_tiles_recluster_and_stay_exact(builds):
    m, centers = _blob_matrix(4096, 4, seed=9)
    store = trag.VectorStore(_cfg(trag, initial_capacity=8192), device="cpu")
    plain = trag.VectorStore(trag.VectorStoreConfig(dimension=DIM), device="cpu")
    for s in (store, plain):
        s.insert_many([_chunk(trag, i, m[i]) for i in range(4096)])
    q = centers[3].astype(np.float32)
    store.search(q, 3)
    v1 = store._cluster_version
    for s in (store, plain):
        s.insert(_chunk(trag, 50_000, q))
    got = store.search(q, 3)
    assert got[0][0] == "c50000"
    assert [g[0] for g in got] == [w[0] for w in plain.search(q, 3)]
    assert store._cluster_version == v1 + 1 and store._cluster_incremental == 0
    assert len(builds) == 2  # no hole anywhere: a full re-cluster


def test_incremental_radii_stay_sound(builds):
    m, centers = _blob_matrix(4000, 4, seed=10)
    store = trag.VectorStore(_cfg(trag), device="cpu")
    store.insert_many([_chunk(trag, i, m[i]) for i in range(4000)])
    store.search_arrays(centers[:1].astype(np.float32), 3)
    for i in range(20):  # far from every center
        store.insert(_chunk(trag, 20_000 + i, -centers[i % 4]))
    store.search_arrays(centers[:1].astype(np.float32), 3)
    assert len(builds) == 1
    order, _, cent, radii = store._cluster
    for c in range(len(radii)):
        rows = order[c * TILE:(c + 1) * TILE]
        live = rows[(rows >= 0)]
        live = live[store._valid[live]]
        if len(live):
            diff = store._host[live].astype(np.float64) - cent[c].numpy().astype(np.float64)
            assert np.sqrt((diff * diff).sum(axis=1)).max() <= float(radii[c])


def test_tier_switch_to_compact_rebuilds_and_back():
    m, centers = _blob_matrix(4096, 4, seed=11)
    store = trag.VectorStore(_cfg(trag), device="cpu")
    store.insert_many([_chunk(trag, i, m[i]) for i in range(4096)])
    q = centers.astype(np.float32)
    _, r_cl = store.search_arrays(q, 5)
    assert store._cluster is not None
    store.config.scan_tier = "compact"
    _, r_co = store.search_arrays(q, 5)
    assert store._cluster is None and store._tier_built_for == "compact"
    assert all(set(a) == set(b) for a, b in zip(r_cl.tolist(), r_co.tolist()))
    store.config.scan_tier = "clustered"
    _, r_back = store.search_arrays(q, 5)
    assert store._cluster is not None and store._tier_built_for == "clustered"
    assert all(set(a) == set(b) for a, b in zip(r_cl.tolist(), r_back.tolist()))


def test_clustered_store_holds_no_fp32_matrix():
    store = trag.VectorStore(_cfg(trag), device="cpu")
    assert store.is_compact and store.supports_tagged_scan
    with pytest.raises(trag.InvalidConfigError, match="clustered"):
        _ = store.device_matrix


# -- the slice -------------------------------------------------------------------


def test_pipeline_contexts_match_jax_with_the_carried_layout():
    """A RagPipeline on the clustered tier: the same documents through the
    JAX package, whose layout is then carried into the port's retriever;
    both answer with the same results and contexts."""
    from tests.test_torch_pipeline import QUERIES, _IdChunker, _same_contexts, _same_results, _texts

    k = 4
    vkw = dict(dimension=DIM, scan_tier="clustered", scan_tile_n=TILE, cluster_probe_tiles=1)
    jp = (
        jrag.RagPipelineBuilder().with_embedder(jrag.MockEmbedder(DIM)).with_reranker(jrag.LexicalReranker())
        .with_chunker(_IdChunker(jrag.RecursiveChunker(chunk_size=8192, overlap=0)))
        .with_retriever_config(jrag.HybridRetrieverConfig(candidates_per_source=12))
        .with_vector_config(jrag.VectorStoreConfig(**vkw)).build()
    )
    texts = _texts(n=1100, seed=3)  # two tiles; probe_tiles=1 prunes one
    jp.index_documents([jrag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(texts)])
    jr = jp.retriever
    jr.ensure_ready()
    js = jr.vector_store
    order, _, cent, radii = js._cluster
    retr = retriever_from_state(
        trag.MockEmbedder(DIM), [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)],
        js._host, js._valid, jr.sparse_index.state_dict(),
        config=trag.HybridRetrieverConfig(candidates_per_source=12),
        vector_config=trag.VectorStoreConfig(**vkw), device="cpu",
        cluster=(order, np.asarray(cent), np.asarray(radii)),
    )
    _same_results(retr.retrieve_batch(QUERIES, 2 * k), jr.retrieve_batch(QUERIES, 2 * k))
    tp = trag.RagPipeline(
        retr.embedder, trag.LexicalReranker(), _IdChunker(trag.RecursiveChunker()), retr, trag.ContextAssembler()
    )
    _same_contexts(tp.query_with_context_batch(QUERIES, k=k), jp.query_with_context_batch(QUERIES, k=k))
    assert [getattr(retr.vector_store, c) for c in COUNTERS] == [getattr(js, c) for c in COUNTERS]
