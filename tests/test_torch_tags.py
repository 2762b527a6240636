"""Tag filters in the port against the JAX package on the same inputs:
the predicate, the bf16 scan's tag variant (the Pallas kernel in
interpret mode), the tagged ops, the bf16 tile tier with tags, filter
resolution, and TagFilter retrieval through the pipeline on the tiers
none, bf16 and compact, plus retriever_from_state carrying tags.

Tolerances: bf16 scan values 2e-5 absolute (f32 sums of bf16 products in
another order, as test_torch_scan_select.py); dense scores 1e-5; BM25
scores 1e-4 relative and fused scores 1e-6 (as test_torch_pipeline.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import trueno_rag_tpu as jrag
import trueno_rag_tpu_torch as trag
from trueno_rag_tpu.ops import dense_tiered as jdt
from trueno_rag_tpu.ops import tags as jtags
from trueno_rag_tpu.ops.pallas.scan_select_v2 import scan_select_v3 as jax_scan_select_v3
from trueno_rag_tpu.retrieve import TagFilter as JTagFilter
from trueno_rag_tpu.retrieve import resolve_tag_filters as jresolve
from trueno_rag_tpu_torch.convert import retriever_from_state
from trueno_rag_tpu_torch.ops import dense_tiered as tdt
from trueno_rag_tpu_torch.ops import tags as ttags
from trueno_rag_tpu_torch.ops.kernels.scan_select import BLOCK, scan_select_v3_reference
from trueno_rag_tpu_torch.retrieve import resolve_tag_filters as tresolve


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_tag_pred_matches_oracle_and_jax():
    rng = np.random.default_rng(0)
    bits = rng.integers(-(2**31), 2**31, size=64, dtype=np.int64).astype(np.int32)
    bits[:8] = [0, 1, 2, 3, 5, 8, -1, 2**30]
    masks = [rng.integers(0, 16, size=24).astype(np.int32) for _ in range(3)]
    masks[0][0] = np.int32(-(2**31))  # the impossible-filter bit
    t = ttags.tag_pred(_t(bits)[None, :], *(_t(m)[:, None] for m in masks)).numpy()
    j = np.asarray(jtags.tag_pred(jnp.asarray(bits)[None, :], *(jnp.asarray(m)[:, None] for m in masks)))
    np.testing.assert_array_equal(t, j)
    for i in range(24):
        for r in range(64):
            assert t[i, r] == ttags.tag_pred_oracle(int(bits[r]), *(int(m[i]) for m in masks))
    assert not t[0].any()


def _filters(b):
    t_all = np.array([1, 0, 2, 0, 1, 0, 4, 0][:b], np.int32)
    t_any = np.array([0, 6, 0, 0, 0, 9, 0, 0][:b], np.int32)
    t_none = np.array([0, 0, 1, 8, 0, 0, 0, 3][:b], np.int32)
    return t_all, t_any, t_none


@pytest.mark.parametrize("pattern", ["blocks", "rows"])
def test_bf16_scan_with_tags_matches_jax_kernel(pattern):
    """A filter that masks whole 128-row blocks (one tag word per block)
    and one that masks scattered rows."""
    rng = np.random.default_rng(17)
    n, d, b = 4096, 32, 8
    m, q = _unit(rng, n, d), _unit(rng, b, d)
    valid = np.ones(n, bool)
    valid[700:760] = False
    if pattern == "blocks":
        bits = np.repeat(rng.integers(0, 16, size=n // BLOCK), BLOCK).astype(np.int32)
    else:
        bits = rng.integers(0, 16, size=n).astype(np.int32)
    tags = (bits,) + _filters(b)
    u = np.full(b, 1.01, np.float32)
    v = np.full(b, 1e-6, np.float32)
    jm = jnp.asarray(m)
    mb, e, a = jdt.prepare_tiered(jm)
    jv, jr = jax_scan_select_v3(
        jnp.asarray(q).astype(jnp.bfloat16), mb, e, a, jnp.asarray(valid).astype(jnp.int32),
        jnp.asarray(u), jnp.asarray(v), tile_n=2048, t_top=4, interpret=True,
        tags=tuple(jnp.asarray(x) for x in tags),
    )
    tmb, te, ta = tdt.prepare_tiered(_t(m))
    tv, tr = scan_select_v3_reference(
        _t(q).to(torch.bfloat16), tmb, te, ta, _t(valid).to(torch.int32), _t(u), _t(v), 4,
        tuple(_t(x) for x in tags),
    )
    jv, jr, tv, tr = np.asarray(jv), np.asarray(jr), tv.numpy(), tr.numpy()
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tr, jr)
    # every emitted row passes its query's filter
    for i in range(b):
        rows = tr[i][np.isfinite(tv[i, :4])]
        assert ttags.tag_pred(_t(bits[rows]), *(_t(f[i:i + 1]) for f in _filters(b))).all()


def _tagged_corpus(seed, n=3000, d=32, b=8):
    rng = np.random.default_rng(seed)
    m = _unit(rng, n, d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[100:180] = False
    bits = rng.integers(0, 16, size=n).astype(np.int32)
    return m, q, valid, bits


def test_dense_topk_tagged_and_candidate_filter_match_jax():
    m, q, valid, bits = _tagged_corpus(2)
    f = _filters(8)
    j_s, j_r = jtags.dense_topk_tagged(*(jnp.asarray(x) for x in (q, m, valid, bits) + f), 15)
    t_s, t_r = ttags.dense_topk_tagged(*(_t(x) for x in (q, m, valid, bits) + f), 15)
    np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-5)
    rows = np.asarray(j_r)[:, ::-1].copy()  # out of order on purpose
    rows[0, :3] = -1
    scores = np.where(rows >= 0, np.linspace(1.0, 0.1, 15, dtype=np.float32)[None, :], -np.inf).astype(np.float32)
    f2 = (np.array([0, 4, 0, 0, 0, 0, 0, 2], np.int32),) + f[1:]
    j = jtags.filter_candidates_by_tags(*(jnp.asarray(x) for x in (rows, scores, bits) + f2))
    t = ttags.filter_candidates_by_tags(*(_t(x) for x in (rows, scores, bits) + f2))
    for ja, ta in zip(j, t):
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("margin,rescore_rows", [(32, 96), (1, 24)])
def test_tiered2_with_tags_matches_jax_and_is_exact(margin, rescore_rows):
    m, q, valid, bits = _tagged_corpus(3, n=6144, d=48)
    tags = (bits,) + _filters(8)
    kw = dict(margin_tiles=margin, tile_n=1024, rescore_rows=rescore_rows)
    jm = jnp.asarray(m)
    js, jr, jok = jdt.dense_topk_tiered2(
        jnp.asarray(q), jm, *jdt.prepare_tiered(jm), jnp.asarray(valid), 10, interpret=True,
        tags=tuple(jnp.asarray(x) for x in tags), **kw,
    )
    tm = _t(m)
    pack = tdt.prepare_tiered(tm)
    t_tags = tuple(_t(x) for x in tags)
    ts, tr, tok = tdt.dense_topk_tiered2(_t(q), tm, *pack, _t(valid), 10, tags=t_tags, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_allclose(ts.numpy()[fin], np.asarray(js)[fin], rtol=0, atol=1e-5)
    # checked: equal to the tagged fp32 path, per query
    cs, cr, n_fb = tdt.dense_topk_tiered2_checked(_t(q), tm, *pack, _t(valid), 10, tags=t_tags, **kw)
    assert n_fb == int((~tok).sum())
    xs, xr = ttags.dense_topk_tagged(_t(q), tm, _t(valid), *t_tags, 10)
    np.testing.assert_array_equal(cr.numpy(), xr.numpy())
    np.testing.assert_array_equal(cs.numpy(), xs.numpy())


def test_resolve_tag_filters_matches_jax():
    jreg, treg = jrag.ChunkRegistry(), trag.ChunkRegistry()
    for reg in (jreg, treg):
        for t in ("news", "sports", "en", "fr"):
            reg.bit_for(t)
    cases = [
        (JTagFilter(all=("news", "en")), trag.TagFilter(all=("news", "en"))),
        (JTagFilter(any=("fr", "nope")), trag.TagFilter(any=("fr", "nope"))),
        (JTagFilter(any=("nope",)), trag.TagFilter(any=("nope",))),  # impossible
        (JTagFilter(all=("nope",)), trag.TagFilter(all=("nope",))),  # impossible
        (JTagFilter(none=("sports", "nope")), trag.TagFilter(none=("sports", "nope"))),
        (None, None),
    ]
    j = jresolve(jreg, [c[0] for c in cases], len(cases))
    t = tresolve(treg, [c[1] for c in cases], len(cases))
    for ja, ta in zip(j, t):
        np.testing.assert_array_equal(ta, ja)
    one = tresolve(treg, cases[0][1], 3)
    assert all(len(x) == 3 for x in one)
    with pytest.raises(trag.QueryError):
        tresolve(treg, [cases[0][1]], 2)


# -- TagFilter retrieval through the pipeline ------------------------------------

DIM = 32
K = 4
QUERIES = ["w001 w002 w003", "w010 w100", "w250 w251 w252 w253", "w007", "w042 w042 w099",
           "w150 w003 w200", "w299 w000", "w123 w321 w111"]


class _IdChunker:
    """Wraps a chunker; chunk ids become '<document id>:<start offset>'."""

    def __init__(self, inner):
        self.inner = inner

    def chunk(self, document):
        out = self.inner.chunk(document)
        for c in out:
            c.id = f"{c.document_id}:{c.start_offset}"
        return out


def _pipeline(rag, tier, n=900, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d}" for i in range(300)])
    lengths = rng.permutation(np.arange(8, 8 + n))  # distinct lengths: no BM25 ties
    texts = [" ".join(words[rng.integers(0, 300, size=ln)]) for ln in lengths]
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
    tags = [[f"t{i % 4}"] + (["even"] if i % 2 == 0 else []) for i in range(n)]
    p.index_documents([rag.Document(t, title=f"T{i}", id=f"doc{i}") for i, t in enumerate(texts)], tags=tags)
    return p


def _filters_for(rag):
    F = rag.TagFilter
    return [F(all=("t1",)), F(none=("t0",)), F(any=("t2", "t3")), F(all=("even",), none=("t2",)),
            F(all=("nope",)), None, F(any=("t1", "nope")), F(all=("t3", "even"))]


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


def _passes(tp, res, f):
    if f is None:
        return True
    names = set(tp.retriever.registry.tag_names_of(res.chunk.id))
    return (set(f.all) <= names and (not f.any or bool(set(f.any) & names))
            and not set(f.none) & names)


@pytest.fixture(scope="module", params=["none", "bf16", "compact"])
def tagged_pipelines(request):
    return _pipeline(trag, request.param), _pipeline(jrag, request.param)


def test_tag_filtered_retrieval_matches_jax(tagged_pipelines):
    tp, jp = tagged_pipelines
    t_res = tp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=_filters_for(trag))
    j_res = jp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=_filters_for(jrag))
    _same_results(t_res, j_res)
    for res, f in zip(t_res, _filters_for(trag)):
        assert all(_passes(tp, r, f) for r in res)
    assert t_res[4] == []  # an unknown tag in "all" matches nothing
    one = trag.TagFilter(none=("t0",))
    _same_results(tp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=one),
                  jp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=JTagFilter(none=("t0",))))


def test_tag_filtered_contexts_match_jax(tagged_pipelines):
    tp, jp = tagged_pipelines
    tc = tp.query_with_context_batch(QUERIES, k=K, tag_filter=_filters_for(trag))
    jc = jp.query_with_context_batch(QUERIES, k=K, tag_filter=_filters_for(jrag))
    for t, j in zip(tc, jc):
        assert t.format_with_citations() == j.format_with_citations()
        assert [c.chunk_id for c in t.chunks] == [c.chunk_id for c in j.chunks]
        np.testing.assert_allclose([c.score for c in t.chunks], [c.score for c in j.chunks], atol=1e-6)
    f = trag.TagFilter(all=("t1",))
    t1 = tp.query_with_context(QUERIES[0], k=K, tag_filter=f)
    j1 = jp.query_with_context(QUERIES[0], k=K, tag_filter=JTagFilter(all=("t1",)))
    assert t1.format_with_citations() == j1.format_with_citations()
    assert t1.chunks and all("t1" in tp.retriever.registry.tag_names_of(c.chunk_id) for c in t1.chunks)


def test_dense_only_and_sparse_only_filters_match_jax(tagged_pipelines):
    tp, jp = tagged_pipelines
    for use_dense, use_sparse in ((True, False), (False, True)):
        for p in (tp, jp):
            p.retriever.config.use_dense, p.retriever.config.use_sparse = use_dense, use_sparse
        try:
            _same_results(tp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=_filters_for(trag)),
                          jp.retriever.retrieve_batch(QUERIES, 2 * K, tag_filter=_filters_for(jrag)))
        finally:
            for p in (tp, jp):
                p.retriever.config.use_dense, p.retriever.config.use_sparse = True, True


def test_retriever_from_state_carries_tags():
    jp = _pipeline(jrag, "bf16", n=400, seed=4)
    jr = jp.retriever
    jr.remove("doc3:0")
    chunks = [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)]
    retr = retriever_from_state(
        trag.MockEmbedder(DIM), chunks, jr.vector_store._host, jr.vector_store._valid,
        jr.sparse_index.state_dict(),
        config=trag.HybridRetrieverConfig(candidates_per_source=12),
        vector_config=trag.VectorStoreConfig(dimension=DIM, scan_tier="bf16", scan_tile_n=1024),
        device="cpu",
        tag_bits=jr.registry.tags_host(jr.registry.capacity_rows),
        tag_vocab=jr.registry.tag_state([])[0],
    )
    assert retr.registry.tag_names_of("doc10:0") == jr.registry.tag_names_of("doc10:0")
    assert set(retr.registry.tag_names_of("doc10:0")) == {"t2", "even"}
    _same_results(retr.retrieve_batch(QUERIES, 2 * K, tag_filter=_filters_for(trag)),
                  jr.retrieve_batch(QUERIES, 2 * K, tag_filter=_filters_for(jrag)))
    with pytest.raises(trag.InvalidConfigError):
        retriever_from_state(trag.MockEmbedder(DIM), chunks, jr.vector_store._host, jr.vector_store._valid,
                             jr.sparse_index.state_dict(), device="cpu", tag_bits=np.zeros(3, np.int32))


def test_index_tags_validation_and_single_document():
    p = _pipeline(trag, "none", n=20)
    docs = [trag.Document("w001 w002 w003 w004", id="a"), trag.Document("w005 w006 w007 w008", id="b")]
    with pytest.raises(trag.InvalidConfigError):
        p.index_documents(docs, tags=[["x"]])  # one list per document
    with pytest.raises(trag.InvalidConfigError):
        p.index_documents(docs, tags=["x", "y"])  # flat strings
    p.index_document(trag.Document("w009 w010 w011", id="c"), tags=["solo"])
    res = p.retriever.retrieve("w009 w010", 3, tag_filter=trag.TagFilter(all=("solo",)))
    assert [r.chunk.document_id for r in res] == ["c"]
