"""The encoder-fused query path against the JAX package: the fp32 fused
query, its tagged sibling and the fused compact query (through the
retrievers), the ``fused=None/True/False`` selection and its QueryErrors,
the two-phase submit/collect split, and a pipeline with the encoder
embedder and the cross-encoder reranker.

Both retrievers hold the JAX package's index (the port's is carried across
with ``retriever_from_state``) and the same encoder weights. The two
frameworks' query embeddings differ (bf16 rounding, ‖Δq‖ ~1e-2), so each
row's dense score differs by some δ (~2e-3, computed per query over every
row); the queries are the ones whose JAX dense top-(c+1) scores are all more
than 2δ apart (tie-free data): their candidate lists, ranks and fused
scores must be equal, dense scores within δ, BM25 scores within 1e-4
relative (f32 prefix sums, as test_torch_pipeline.py).
"""

import numpy as np
import pytest
import torch

import jax
import trueno_rag_tpu as jrag
from trueno_rag_tpu.models import cross_encoder as jce
from trueno_rag_tpu.models import encoder as je

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import (
    cross_encoder_params_from_jax,
    encoder_params_from_jax,
    retriever_from_state,
)
from trueno_rag_tpu_torch.models import cross_encoder as tce
from trueno_rag_tpu_torch.models import encoder as te
from trueno_rag_tpu_torch.ops import hybrid as thybrid
from trueno_rag_tpu_torch.ops import tags as ttags

CAND = 6
K = 4
N_DOCS = 240


class _IdChunker:
    """Wraps a chunker; chunk ids become '<document id>:<start offset>'."""

    def __init__(self, inner):
        self.inner = inner

    def chunk(self, document):
        out = self.inner.chunk(document)
        for c in out:
            c.id = f"{c.document_id}:{c.start_offset}"
        return out


def _encoder_params(seed=0):
    """Tiny encoder weights with sharper attention than the 0.02 init, so
    that embeddings vary by text."""
    cfg = je.EncoderConfig.tiny()
    p = je.init_encoder_params(jax.random.PRNGKey(seed), cfg)
    p["tok_emb"] = p["tok_emb"] * 20.0
    p["qkv_w"] = p["qkv_w"] * 10.0
    return {k: np.asarray(v) for k, v in p.items()}


PARAMS = _encoder_params()


def _embedders():
    j = je.JaxEncoderEmbedder(config=je.EncoderConfig.tiny(), params={k: jax.numpy.asarray(v) for k, v in PARAMS.items()})
    t = te.EncoderEmbedder(config=te.EncoderConfig.tiny(), params=encoder_params_from_jax(PARAMS, "cpu"),
                           device="cpu")
    return j, t


def _texts(seed=0):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(300)])
    lengths = rng.permutation(np.arange(8, 8 + N_DOCS))  # distinct lengths: no BM25 ties
    return [" ".join(words[rng.integers(0, 300, size=ln)]) for ln in lengths]


def _jax_pipeline(tier, reranker=None):
    jemb, _ = _embedders()
    p = (
        jrag.RagPipelineBuilder()
        .with_embedder(jemb)
        .with_reranker(reranker or jrag.LexicalReranker())
        .with_chunker(_IdChunker(jrag.RecursiveChunker(chunk_size=8192, overlap=0)))
        .with_retriever_config(jrag.HybridRetrieverConfig(candidates_per_source=CAND))
        .with_vector_config(jrag.VectorStoreConfig(dimension=64, scan_tier=tier, scan_tile_n=1024))
        .build()
    )
    tags = [[f"t{i % 3}"] for i in range(N_DOCS)]
    p.index_documents([jrag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(_texts())], tags=tags)
    return p


def _port_retriever(jp, tier, **vcfg):
    jr = jp.retriever
    _, temb = _embedders()
    reg = jr.registry
    return retriever_from_state(
        temb, [reg.chunk_of(r) for r in range(reg.capacity_rows)], jr.vector_store._host,
        jr.vector_store._valid, jr.sparse_index.state_dict(),
        config=trag.HybridRetrieverConfig(candidates_per_source=CAND),
        vector_config=trag.VectorStoreConfig(dimension=64, scan_tier=tier, scan_tile_n=1024, **vcfg),
        device="cpu", tag_bits=reg.tags_host(reg.capacity_rows), tag_vocab=reg.tag_state([])[0],
    )


def _tie_free_queries(jp, n=8):
    """Queries whose JAX dense top-(CAND+1) scores are more than twice the
    query's largest score difference between the two frameworks apart →
    (queries, that difference's maximum over them)."""
    jemb, temb = _embedders()
    rng = np.random.default_rng(7)
    pool = [" ".join(f"w{i:03d}" for i in rng.integers(0, 300, size=int(ln)))
            for ln in rng.integers(2, 6, size=160)]
    store = jp.retriever.vector_store
    m = store._host[store._valid].astype(np.float64)
    sj = jemb.embed_queries(pool).astype(np.float64) @ m.T
    diff = np.abs(temb.embed_queries(pool).astype(np.float64) @ m.T - sj).max(axis=1)
    top = -np.sort(-sj, axis=1)[:, : CAND + 1]
    ok = (-np.diff(top, axis=1)).min(axis=1) > 2 * diff + 1e-6
    chosen = np.flatnonzero(ok)[:n]
    assert len(chosen) == n, f"only {int(ok.sum())} tie-free queries"
    return [pool[i] for i in chosen], float(diff[chosen].max())


def _key(res):
    return (res.chunk.document_id, res.chunk.start_offset)


def _same_results(tr, jr, delta):
    assert [[_key(r) for r in q] for q in tr] == [[_key(r) for r in q] for q in jr]
    assert all(len(q) > 0 for q in tr)
    for tq, jq in zip(tr, jr):
        for a, b in zip(tq, jq):
            for name, tol in (("dense_score", delta + 1e-6), ("sparse_score", 1e-4 * max(1.0, abs(b.sparse_score or 0))),
                              ("fused_score", 1e-6)):
                x, y = getattr(a, name), getattr(b, name)
                assert (x is None) == (y is None), name
                if x is not None:
                    assert abs(x - y) <= tol, (name, x, y)


class _Spy:
    """Counts the calls of one module function (monkeypatched)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        inner = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return inner(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def jax_none():
    return _jax_pipeline("none")


def test_fused_query_matches_jax(jax_none, monkeypatch):
    queries, delta = _tie_free_queries(jax_none)
    retr = _port_retriever(jax_none, "none")
    spy = _Spy(monkeypatch, thybrid, "fused_hybrid_query")
    got = retr.retrieve_batch(queries, K)  # fused=None on tier "none": the fused path
    assert spy.calls == 1
    _same_results(got, jax_none.retriever.retrieve_batch(queries, K), delta)
    _same_results(retr.retrieve_batch_fused(queries[:3], K),
                  jax_none.retriever.retrieve_batch_fused(queries[:3], K), delta)


def test_fused_tagged_query_matches_jax(jax_none, monkeypatch):
    queries, delta = _tie_free_queries(jax_none)
    retr = _port_retriever(jax_none, "none")
    spy = _Spy(monkeypatch, ttags, "fused_hybrid_query_tagged")
    filters_t = [trag.TagFilter(all=("t1",)), None, trag.TagFilter(none=("t0",)), trag.TagFilter(any=("t2", "nope"))] * 2
    filters_j = [jrag.TagFilter(all=("t1",)), None, jrag.TagFilter(none=("t0",)), jrag.TagFilter(any=("t2", "nope"))] * 2
    got = retr.retrieve_batch(queries, K, tag_filter=filters_t)
    assert spy.calls == 1
    want = jax_none.retriever.retrieve_batch(queries, K, tag_filter=filters_j)
    # a filter changes the dense candidates: compare the queries whose
    # filtered JAX lists are tie-free too (the unfiltered ones always are)
    assert [[_key(r) for r in q] for q in got[1::4]] == [[_key(r) for r in q] for q in want[1::4]]
    for res, f in zip(got, filters_t):
        names = [set(retr.registry.tag_names_of(r.chunk.id)) for r in res]
        if f is not None and f.all:
            assert all(set(f.all) <= n for n in names)
        if f is not None and f.none:
            assert all(not set(f.none) & n for n in names)
    _same_results([got[i] for i in range(len(got)) if filters_t[i] is None],
                  [want[i] for i in range(len(want)) if filters_j[i] is None], delta)


def test_fused_compact_query_matches_jax(monkeypatch):
    jp = _jax_pipeline("compact")
    jp.retriever.config.fused = True
    queries, delta = _tie_free_queries(jp)
    retr = _port_retriever(jp, "compact")
    retr.config.fused = True
    spy = _Spy(monkeypatch, thybrid, "fused_hybrid_query_compact")
    got = retr.retrieve_batch(queries, K)
    assert spy.calls == 1
    _same_results(got, jp.retriever.retrieve_batch(queries, K), delta)
    # the exact contract: each dense list is the float64 top-CAND set of
    # the query's own encoder output
    _, temb = _embedders()
    qv = temb.embed_queries(queries).astype(np.float64)
    store = retr.vector_store
    s = np.where(store._valid[None, :], qv @ store._host.astype(np.float64).T, -np.inf)
    want_sets = [set(np.argsort(-row, kind="stable")[:CAND].tolist()) for row in s]
    handle = retr.retrieve_batch_submit(queries, K)
    assert handle[0] == "fused_compact"
    d_rows = handle[1][2].numpy()
    ok = handle[1][6].numpy()
    for i in np.flatnonzero(ok[: len(queries)]):
        assert set(d_rows[i].tolist()) == want_sets[i]
    collected = retr.retrieve_batch_collect(handle)
    assert [[_key(r) for r in q] for q in collected] == [[_key(r) for r in q] for q in got]


def test_fused_selection_rule_and_query_errors(jax_none, monkeypatch):
    queries = ["w001 w002", "w010"]
    spy = _Spy(monkeypatch, thybrid, "fused_hybrid_query")
    retr = _port_retriever(jax_none, "none")
    retr.config.fused = False
    retr.retrieve_batch(queries, K)
    assert spy.calls == 0  # fused=False: staged (one dispatch over host-embedded queries)
    bf16 = _port_retriever(jax_none, "bf16")
    bf16.retrieve_batch(queries, K)
    assert spy.calls == 0  # fused=None on a scan tier: staged
    bf16.config.fused = True
    bf16.retrieve_batch(queries, K)
    assert spy.calls == 1  # fused=True: the fused query over the fp32 matrix
    handle = bf16.retrieve_batch_submit(queries, K)
    assert handle[0] == "done" and len(bf16.retrieve_batch_collect(handle)) == 2

    clustered = _port_retriever(jax_none, "clustered")
    clustered.config.fused = True
    with pytest.raises(trag.QueryError, match="clustered"):
        clustered.retrieve_batch(queries, K)
    compact = _port_retriever(jax_none, "compact")
    compact.config.fused = True
    with pytest.raises(trag.QueryError, match="tag filters"):
        compact.retrieve_batch(queries, K, tag_filter=trag.TagFilter(all=("t1",)))
    compact_bf16 = _port_retriever(jax_none, "compact", compact_scan="bf16")
    compact_bf16.config.fused = True
    with pytest.raises(trag.QueryError, match="bf16r"):
        compact_bf16.retrieve_batch(queries, K)
    retr.config.fused = True
    retr.config.use_sparse = False
    with pytest.raises(trag.QueryError, match="BOTH sources"):
        retr.retrieve_batch(queries, K)
    mock = retriever_from_state(
        trag.MockEmbedder(64), [None], np.zeros((1, 64), np.float32), np.zeros(1, bool),
        jax_none.retriever.sparse_index.state_dict(),
        config=trag.HybridRetrieverConfig(fused=True), device="cpu",
    )
    with pytest.raises(trag.QueryError, match="EncoderEmbedder"):
        mock.retrieve_batch_fused(queries, K)


def test_pipeline_with_encoder_and_cross_encoder_matches_jax(jax_none):
    """The whole pipeline: fused retrieval with the encoder embedder, then
    the cross-encoder's rerank (scores within 1e-2; the order pinned for
    queries whose candidates' JAX scores are more than twice the two
    frameworks' largest score difference apart)."""
    queries, delta = _tie_free_queries(jax_none)
    cfg = je.EncoderConfig.tiny()
    pj = jce.init_cross_encoder_params(jax.random.PRNGKey(3), cfg)
    for key, scale in (("tok_emb", 20.0), ("qkv_w", 10.0), ("score_w", 5.0)):
        pj[key] = pj[key] * scale
    jrr = jce.CrossEncoderReranker(config=cfg, params=pj)
    trr = tce.CrossEncoderReranker(config=te.EncoderConfig.tiny(),
                                   params=cross_encoder_params_from_jax({k: np.asarray(v) for k, v in pj.items()}, "cpu"),
                                   device="cpu")
    jp = jax_none
    retr = _port_retriever(jp, "none")
    tp = trag.RagPipeline(retr.embedder, trr, _IdChunker(trag.RecursiveChunker()), retr, trag.ContextAssembler())
    jp_cross = jrag.RagPipeline(jp.embedder, jrr, jp.chunker, jp.retriever, jp.assembler)
    t_res, j_res = tp.query_batch(queries, k=K), jp_cross.query_batch(queries, k=K)
    checked = 0
    for tq, jq, q in zip(t_res, j_res, queries):
        contents = [c.chunk.content for c in jp.retriever.retrieve(q, 2 * K)]
        js, ts = jrr.score_batch(q, contents), trr.score_batch(q, contents)
        np.testing.assert_allclose(ts, js, atol=1e-2)
        if np.diff(np.sort(js)).min() > 2 * np.abs(ts - js).max():
            assert [_key(r) for r in tq] == [_key(r) for r in jq]
            checked += 1
    assert checked >= 2, checked
    contexts = tp.query_with_context_batch(queries[:2], k=K)
    assert all(len(c.chunks) > 0 and len(c.citations) == len(c.chunks) for c in contexts)
