"""The slice end to end: the same documents through the JAX package's
RagPipeline and the port's, on the bf16 tier (staged: certified scan,
BM25, fusion) and on the fp32 path (one dispatch), plus the port's
retriever built from the JAX package's index state (convert.py).

Results are compared by (document id, start offset): chunk ids are
random uuids. The chunker below gives both packages the same ids, since
the rerankers break score ties by chunk id. Documents have distinct
lengths, so no two BM25 scores tie exactly — an exact tie would be
ordered by each framework's f32 prefix-sum rounding."""

import numpy as np
import pytest

import trueno_rag_tpu as jrag
import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import retriever_from_state

DIM = 32
K = 4


class _IdChunker:
    """Wraps a chunker; chunk ids become '<document id>:<start offset>'."""

    def __init__(self, inner):
        self.inner = inner

    def chunk(self, document):
        out = self.inner.chunk(document)
        for c in out:
            c.id = f"{c.document_id}:{c.start_offset}"
        return out


def _texts(n=900, vocab=300, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(vocab)])
    lengths = rng.permutation(np.arange(8, 8 + n))  # distinct document lengths
    return [" ".join(words[rng.integers(0, vocab, size=ln)]) for ln in lengths]


QUERIES = ["w001 w002 w003", "w010 w100", "w250 w251 w252 w253", "w007", "w042 w042 w099",
           "w150 w003 w200", "w299 w000", "w123 w321 w111"]


def _pipeline(rag, tier, **kw):
    b = (
        rag.RagPipelineBuilder()
        .with_embedder(rag.MockEmbedder(DIM))
        .with_reranker(rag.LexicalReranker())
        .with_chunker(_IdChunker(rag.RecursiveChunker(chunk_size=8192, overlap=0)))
        .with_retriever_config(rag.HybridRetrieverConfig(candidates_per_source=12))
        .with_vector_config(rag.VectorStoreConfig(dimension=DIM, scan_tier=tier, scan_tile_n=1024))
    )
    if rag is trag:
        b = b.with_device("cpu")
    p = b.build()
    texts = _texts(**kw)
    p.index_documents([rag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(texts)])
    return p


def _key(res):
    return (res.chunk.document_id, res.chunk.start_offset)


def _same_results(tr, jr):
    assert [[_key(r) for r in q] for q in tr] == [[_key(r) for r in q] for q in jr]
    for tq, jq in zip(tr, jr):
        for a, b in zip(tq, jq):
            # BM25 sums equal-row runs as a difference of f32 prefix sums
            # over the whole candidate panel, so its rounding scales with
            # the panel's mass (ops/bm25.py); the JAX package's own BM25
            # parity tests allow rel 1e-4 for the same reason
            for name, tol in (("dense_score", 1e-5), ("sparse_score", 1e-4),
                              ("fused_score", 1e-6), ("rerank_score", 1e-9)):
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None), name
                if x is not None:
                    assert abs(x - y) <= tol * max(1.0, abs(y)), (name, x, y)


def _same_contexts(tc, jc):
    for t, j in zip(tc, jc):
        assert t.format_with_citations() == j.format_with_citations()
        assert t.citation_list() == j.citation_list()
        assert t.total_tokens == j.total_tokens
        assert [(c.document_id, c.citation_id, c.content) for c in t.chunks] == [
            (c.document_id, c.citation_id, c.content) for c in j.chunks
        ]
        np.testing.assert_allclose([c.score for c in t.chunks], [c.score for c in j.chunks], atol=1e-6)
        assert [(c.id, c.document_id, c.title, c.snippet) for c in t.citations] == [
            (c.id, c.document_id, c.title, c.snippet) for c in j.citations
        ]


@pytest.fixture(scope="module", params=["bf16", "none"])
def pipelines(request):
    return _pipeline(trag, request.param), _pipeline(jrag, request.param)


def test_retrieval_matches_jax(pipelines):
    tp, jp = pipelines
    tier = tp.retriever.vector_store._effective_tier()
    assert tier == jp.retriever.vector_store._effective_tier()
    _same_results(tp.retriever.retrieve_batch(QUERIES, 2 * K), jp.retriever.retrieve_batch(QUERIES, 2 * K))


def test_contexts_and_citations_match_jax(pipelines):
    tp, jp = pipelines
    _same_contexts(tp.query_with_context_batch(QUERIES, k=K), jp.query_with_context_batch(QUERIES, k=K))
    _same_contexts([tp.query_with_context(QUERIES[0], k=K)], [jp.query_with_context(QUERIES[0], k=K)])


def test_removal_matches_jax(pipelines):
    tp, jp = _pipeline(trag, "bf16", n=400, seed=1), _pipeline(jrag, "bf16", n=400, seed=1)
    for i in (0, 5, 77):
        assert tp.retriever.remove(f"doc{i}:0") and jp.retriever.remove(f"doc{i}:0")
    _same_results(tp.retriever.retrieve_batch(QUERIES, 2 * K), jp.retriever.retrieve_batch(QUERIES, 2 * K))
    assert len(tp.retriever) == len(jp.retriever) == 397


def test_retriever_from_jax_state_answers_like_jax():
    jp = _pipeline(jrag, "bf16", seed=2)
    jr = jp.retriever
    jr.remove("doc3:0")  # a free row carried across
    chunks = [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)]
    retr = retriever_from_state(
        trag.MockEmbedder(DIM), chunks, jr.vector_store._host, jr.vector_store._valid,
        jr.sparse_index.state_dict(),
        config=trag.HybridRetrieverConfig(candidates_per_source=12),
        vector_config=trag.VectorStoreConfig(dimension=DIM, scan_tier="bf16", scan_tile_n=1024),
        device="cpu",
    )
    assert len(retr) == len(jr) and retr.registry.row_of("doc10:0") == jr.registry.row_of("doc10:0")
    _same_results(retr.retrieve_batch(QUERIES, 2 * K), jr.retrieve_batch(QUERIES, 2 * K))
    tp = trag.RagPipeline(
        retr.embedder, trag.LexicalReranker(), _IdChunker(trag.RecursiveChunker()), retr, trag.ContextAssembler()
    )
    _same_contexts(tp.query_with_context_batch(QUERIES, k=K), jp.query_with_context_batch(QUERIES, k=K))


def test_unported_paths_raise():
    """The learned-sparse source is not ported; the fused path (ported,
    tests/test_torch_fused.py) keeps the JAX package's contract that
    fused=True needs an encoder embedder."""
    p = _pipeline(trag, "none", n=50)
    jp = _pipeline(jrag, "none", n=50)
    for pipe, rag in ((p, trag), (jp, jrag)):
        pipe.retriever.config.fused = True
        with pytest.raises(rag.QueryError, match="fused=True requires"):
            pipe.retriever.retrieve_batch(QUERIES, K)
    with pytest.raises(trag.InvalidConfigError, match="ROADMAP"):
        p.retriever.attach_learned_sparse(object())


def test_single_source_retrieval_matches_jax(pipelines):
    tp, jp = pipelines
    for q in QUERIES[:4]:
        for name in ("retrieve_dense", "retrieve_sparse"):
            t = getattr(tp.retriever, name)(q, 2 * K)
            j = getattr(jp.retriever, name)(q, 2 * K)
            _same_results([t], [j])
    _same_results([tp.query(QUERIES[1], k=K)], [jp.query(QUERIES[1], k=K)])
