"""The BM25 segment path through the index, the retriever and the pipeline,
against the JAX package: corpora whose BM25 row capacity crosses
``MAX_BLOCK_ROWS``. The threshold (2**24 rows) is moved to 128 in both
packages' ``ops.bm25`` for this module, so a few hundred documents cross
it; both packages read it when they take a snapshot.

Results are compared by (document id, start offset) with chunk ids made
equal, as in test_torch_pipeline.py. Documents have distinct lengths, so
no two BM25 scores tie exactly. Tolerances: rows equal; BM25 scores within
rel 1e-4 (the f32 prefix-sum tail, whose rounding scales with the panel's
mass: ROADMAP Queue 3, "BM25 rounding"), dense 1e-5, fused 1e-6, rerank
1e-9, as in the pipeline tests.
"""

import numpy as np
import pytest
import torch

import trueno_rag_tpu as jrag
import trueno_rag_tpu.ops.bm25 as jops
import trueno_rag_tpu_torch as trag
import trueno_rag_tpu_torch.ops.bm25 as tops
from trueno_rag_tpu.chunking import Chunk as JChunk
from trueno_rag_tpu.index.bm25 import BM25Index as JIndex
from trueno_rag_tpu_torch.chunking import Chunk as TChunk
from trueno_rag_tpu_torch.convert import retriever_from_state
from trueno_rag_tpu_torch.index.bm25 import BM25Index as TIndex

THRESHOLD = 128
DIM = 32
K = 4
CAND = 12


@pytest.fixture(scope="module", autouse=True)
def _past_threshold():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jops, "MAX_BLOCK_ROWS", THRESHOLD)
        mp.setattr(tops, "MAX_BLOCK_ROWS", THRESHOLD)
        yield


def _texts(n=300, vocab=60, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(vocab)])
    lengths = rng.permutation(np.arange(8, 8 + n))  # distinct document lengths
    return [" ".join(words[rng.integers(0, vocab, size=ln)]) for ln in lengths]


QUERIES = ["w001 w002 w003", "w010 w050", "w025 w026 w027 w028", "w007", "w042 w042 w059",
           "w015 w003 w020", "zzz w000", "the of"]


def _indexes(n=300, seed=0):
    texts = _texts(n, seed=seed)
    j, t = JIndex(use_native=False), TIndex(use_native=False, device="cpu")
    for i, text in enumerate(texts):
        j.add(JChunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=1))
        t.add(TChunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=1))
    return j, t


def _same_arrays(got, want, k_rows=None):
    s_t, r_t = (x.cpu().numpy() for x in got)
    s_j, r_j = (np.asarray(x) for x in want)
    assert np.array_equal(r_t[:, :k_rows], r_j[:, :k_rows])
    np.testing.assert_allclose(np.where(np.isneginf(s_t), 0, s_t), np.where(np.isneginf(s_j), 0, s_j),
                               rtol=1e-4, atol=1e-4)


def test_snapshot_past_threshold_holds_packed_postings_only():
    j, t = _indexes()
    j._refresh_snapshot()
    t._refresh_snapshot()
    assert t._snap["blocks"] is None and j._snap["blocks"] is None
    assert isinstance(t._snap["packed"], torch.Tensor) and t._snap["packed"].device.type == "cpu"
    assert t._snap["packed"].numpy().tobytes() == np.asarray(j._snap["packed"]).tobytes()
    assert t._snap["avgdl"] == float(np.asarray(j._snap["avgdl"]))


def test_gather_segments_matches_jax():
    """Repeated, unknown and stopword-only terms; a query of many terms
    whose runs pass the 64-slot floor of the slot bucket."""
    j, t = _indexes()
    j._refresh_snapshot()
    t._refresh_snapshot()
    long_query = " ".join(f"w{i:03d}" for i in range(60))
    for qs in (QUERIES, [long_query, "w001"], ["zzz"]):
        got = t._gather_segments(qs)
        want = j._gather_segments(qs)
        for a, w in zip(got, want):
            assert a.dtype == np.int32 and np.array_equal(a, w)
    assert t._gather_segments([long_query])[0].shape[1] == 128


def test_search_arrays_matches_jax_and_the_block_path(monkeypatch):
    j, t = _indexes()
    _same_arrays(t.search_arrays(QUERIES, 10), j.search_arrays(QUERIES, 10))
    _same_arrays(t.search_arrays(QUERIES[:3], 500), j.search_arrays(QUERIES[:3], 500), k_rows=10)
    monkeypatch.setattr(tops, "MAX_BLOCK_ROWS", 1 << 24)
    _, blk = _indexes()
    blk._refresh_snapshot()
    assert blk._snap["blocks"] is not None
    _same_arrays(t.search_arrays(QUERIES, 10), blk.search_arrays(QUERIES, 10))


def test_get_packed_below_threshold_is_the_block_paths_oracle(monkeypatch):
    """Below the threshold the snapshot holds the block table only;
    ``_get_packed`` builds JAX's packed postings on demand, the segment
    top-k over them answers as the block path does, and a mutation
    rebuilds them."""
    monkeypatch.setattr(jops, "MAX_BLOCK_ROWS", 1 << 24)
    monkeypatch.setattr(tops, "MAX_BLOCK_ROWS", 1 << 24)
    j, t = _indexes()
    for victim in ("c7", "c8"):
        j._refresh_snapshot()
        t._refresh_snapshot()
        assert t._snap["blocks"] is not None and t._snap["packed"] is None
        packed = t._get_packed()
        assert packed.numpy().tobytes() == np.asarray(j._get_packed()).tobytes()
        seg = tops.bm25_topk_segments(*t.gather_segment_tensors(QUERIES), packed, t._snap["avgdl"], 10)
        _same_arrays(seg, t.search_arrays(QUERIES, 10))
        assert j.remove(victim) and t.remove(victim)


def test_search_and_search_host_agree():
    _, t = _indexes()
    for q in QUERIES:
        dev = t.search(q, 8)
        host = t.search_host(q, 8)
        assert [d[0] for d in dev] == [h[0] for h in host]
        assert all(abs(d[1] - h[1]) <= 1e-4 * max(1.0, h[1]) for d, h in zip(dev, host))


def test_threshold_is_on_row_capacity():
    """Removing rows leaves the capacity: 140 rows with 20 holes have 120
    live rows, below the threshold, and still take the segments."""
    j, t = _indexes(n=140, seed=3)
    for i in range(0, 40, 2):
        assert j.remove(f"c{i}") and t.remove(f"c{i}")
    assert len(t) == len(j) == 120 and t.registry.capacity_rows == 140
    _same_arrays(t.search_arrays(QUERIES, 10), j.search_arrays(QUERIES, 10))
    assert t._snap["blocks"] is None and j._snap["blocks"] is None


# -- the retriever and the pipeline ------------------------------------------------


class _IdChunker:
    """Wraps a chunker; chunk ids become '<document id>:<start offset>'."""

    def __init__(self, inner):
        self.inner = inner

    def chunk(self, document):
        out = self.inner.chunk(document)
        for c in out:
            c.id = f"{c.document_id}:{c.start_offset}"
        return out


def _jax_pipeline(tier, embedder=None, dim=DIM, n=300):
    p = (
        jrag.RagPipelineBuilder()
        .with_embedder(embedder or jrag.MockEmbedder(dim))
        .with_reranker(jrag.LexicalReranker())
        .with_chunker(_IdChunker(jrag.RecursiveChunker(chunk_size=8192, overlap=0)))
        .with_retriever_config(jrag.HybridRetrieverConfig(candidates_per_source=CAND))
        .with_vector_config(jrag.VectorStoreConfig(dimension=dim, scan_tier=tier, scan_tile_n=1024))
        .build()
    )
    tags = [[f"t{i % 3}"] for i in range(n)]
    p.index_documents([jrag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(_texts(n))],
                      tags=tags)
    return p


def _port_pipeline(jp, tier, embedder=None, dim=DIM):
    jr = jp.retriever
    reg = jr.registry
    retr = retriever_from_state(
        embedder or trag.MockEmbedder(dim), [reg.chunk_of(r) for r in range(reg.capacity_rows)],
        jr.vector_store._host, jr.vector_store._valid, jr.sparse_index.state_dict(),
        config=trag.HybridRetrieverConfig(candidates_per_source=CAND),
        vector_config=trag.VectorStoreConfig(dimension=dim, scan_tier=tier, scan_tile_n=1024),
        device="cpu", tag_bits=reg.tags_host(reg.capacity_rows), tag_vocab=reg.tag_state([])[0],
    )
    return trag.RagPipeline(retr.embedder, trag.LexicalReranker(),
                            _IdChunker(trag.RecursiveChunker(chunk_size=8192, overlap=0)), retr,
                            trag.ContextAssembler())


def _key(res):
    return (res.chunk.document_id, res.chunk.start_offset)


def _same_results(tr, jr):
    assert [[_key(r) for r in q] for q in tr] == [[_key(r) for r in q] for q in jr]
    for tq, jq in zip(tr, jr):
        for a, b in zip(tq, jq):
            for name, tol in (("dense_score", 1e-5), ("sparse_score", 1e-4),
                              ("fused_score", 1e-6), ("rerank_score", 1e-9)):
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None), name
                if x is not None:
                    assert abs(x - y) <= tol * max(1.0, abs(y)), (name, x, y)


@pytest.fixture(scope="module", params=["none", "bf16"])
def pipelines(request):
    jp = _jax_pipeline(request.param)
    return _port_pipeline(jp, request.param), jp


def test_retrieve_batch_past_threshold_matches_jax(pipelines, monkeypatch):
    """Tier none answers through hybrid_query_arrays_segments, tier bf16
    through the staged certified scan and the index's segment path."""
    from trueno_rag_tpu_torch.ops import hybrid as thybrid

    tp, jp = pipelines
    calls = []
    real = thybrid.hybrid_query_arrays_segments
    monkeypatch.setattr(thybrid, "hybrid_query_arrays_segments", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tr = tp.retriever.retrieve_batch(QUERIES, 2 * K)
    assert tp.retriever.sparse_index._snap["blocks"] is None
    assert len(calls) == (1 if tp.retriever.vector_store._effective_tier() == "none" else 0)
    _same_results(tr, jp.retriever.retrieve_batch(QUERIES, 2 * K))


def test_single_source_retrieval_past_threshold_matches_jax(pipelines):
    tp, jp = pipelines
    for q in QUERIES[:4]:
        _same_results([tp.retriever.retrieve_sparse(q, 2 * K)], [jp.retriever.retrieve_sparse(q, 2 * K)])
        _same_results([tp.retriever.retrieve_dense(q, 2 * K)], [jp.retriever.retrieve_dense(q, 2 * K)])


def test_query_with_context_batch_past_threshold_matches_jax(pipelines):
    tp, jp = pipelines
    tc = tp.query_with_context_batch(QUERIES, k=K)
    jc = jp.query_with_context_batch(QUERIES, k=K)
    for t, j in zip(tc, jc):
        assert t.format_with_citations() == j.format_with_citations()
        assert t.citation_list() == j.citation_list()
        np.testing.assert_allclose([c.score for c in t.chunks], [c.score for c in j.chunks], atol=1e-6)


def test_tag_filters_past_threshold(pipelines):
    """The staged tiers filter BM25 candidates after their top-k; the one
    dispatch on tier none has no tagged segment path, and raises as the
    JAX package does."""
    tp, jp = pipelines
    tf, jf = trag.TagFilter(all=("t1",)), jrag.TagFilter(all=("t1",))
    if tp.retriever.vector_store._effective_tier() == "none":
        for retr, f, rag in ((tp.retriever, tf, trag), (jp.retriever, jf, jrag)):
            with pytest.raises(rag.QueryError, match="tag filters are not supported on the segment"):
                retr.retrieve_batch(QUERIES, K, tag_filter=f)
        return
    tr = tp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=tf)
    _same_results(tr, jp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=jf))
    assert all("t1" in tp.retriever.registry.tag_names_of(r.chunk.id) for q in tr for r in q)


def test_mutation_past_threshold_resnapshots():
    """Remove then re-add a document on both sides: the segment snapshot
    is rebuilt and the answers stay equal."""
    jp = _jax_pipeline("bf16", n=200)
    tp = _port_pipeline(jp, "bf16")
    _same_results(tp.retriever.retrieve_batch(QUERIES, 2 * K), jp.retriever.retrieve_batch(QUERIES, 2 * K))
    first = tp.retriever.sparse_index._snap["packed"]
    doc = jp.retriever.registry.chunk_of(jp.retriever.registry.row_of("doc5:0"))
    for p, rag in ((tp, trag), (jp, jrag)):
        assert p.retriever.remove("doc5:0")
        p.index_documents([rag.Document(doc.content + " w001 w001", title="T5", id="doc5")])
    _same_results(tp.retriever.retrieve_batch(QUERIES, 2 * K), jp.retriever.retrieve_batch(QUERIES, 2 * K))
    assert tp.retriever.sparse_index._snap["packed"] is not first


def test_fused_rule_past_threshold():
    """With an encoder embedder on tier none, fused=None takes the staged
    path once the block table is gone (the same answers as fused=False),
    and fused=True raises the JAX package's QueryError in both packages."""
    import jax

    from trueno_rag_tpu.models import encoder as je
    from trueno_rag_tpu_torch.convert import encoder_params_from_jax
    from trueno_rag_tpu_torch.models import encoder as te

    cfg = je.EncoderConfig.tiny()
    params = {k: np.asarray(v) for k, v in je.init_encoder_params(jax.random.PRNGKey(0), cfg).items()}
    jemb = je.JaxEncoderEmbedder(config=cfg, params={k: jax.numpy.asarray(v) for k, v in params.items()})
    temb = te.EncoderEmbedder(config=te.EncoderConfig.tiny(), params=encoder_params_from_jax(params, "cpu"),
                              device="cpu")
    jp = _jax_pipeline("none", embedder=jemb, dim=cfg.hidden_dim, n=160)
    tp = _port_pipeline(jp, "none", embedder=temb, dim=cfg.hidden_dim)
    retr = tp.retriever
    assert retr.config.fused is None and retr.vector_store._effective_tier() == "none"

    def no_fused(*a, **kw):
        raise AssertionError("fused=None took the fused path past the block table")

    retr.retrieve_batch_fused = no_fused
    auto = retr.retrieve_batch(QUERIES, K)
    assert retr.sparse_index._snap["blocks"] is None
    retr.config.fused = False
    staged = retr.retrieve_batch(QUERIES, K)
    assert [[_key(r) for r in q] for q in auto] == [[_key(r) for r in q] for q in staged]
    del retr.retrieve_batch_fused
    for p, rag in ((tp, trag), (jp, jrag)):
        p.retriever.config.fused = True
        with pytest.raises(rag.QueryError, match="fused path requires the block-table BM25 layout"):
            p.retriever.retrieve_batch(QUERIES, K)
