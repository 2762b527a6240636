"""The port's single-source retrievers (``DenseRetriever``,
``SparseRetriever``) against the JAX package's on the same chunks, and
the port's top-level names against the JAX package's ``__all__``."""

import numpy as np

import trueno_rag_tpu as jrag
import trueno_rag_tpu_torch as trag

from test_torch_pipeline import QUERIES, _texts

DIM = 32


def _chunks(rag, embed):
    emb = rag.MockEmbedder(DIM)
    out = []
    for i, t in enumerate(_texts(n=150)):
        c = rag.Chunk(document_id=f"doc{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i}")
        if embed:
            c.set_embedding(emb.embed(t))
        out.append(c)
    return out


def _same(a, b, field, tol):
    assert [r.chunk.id for r in a] == [r.chunk.id for r in b]
    np.testing.assert_allclose([getattr(r, field) for r in a], [getattr(r, field) for r in b], rtol=tol, atol=tol)


def test_dense_retriever_matches_jax():
    t = trag.DenseRetriever(trag.MockEmbedder(DIM), device="cpu")
    j = jrag.DenseRetriever(jrag.MockEmbedder(DIM))
    tc, jc = _chunks(trag, True), _chunks(jrag, True)
    t.index(tc[0])
    j.index(jc[0])
    t.index_batch(tc[1:])
    j.index_batch(jc[1:])
    assert len(t) == len(j) == 150
    for q in QUERIES:
        _same(t.retrieve(q, 7), j.retrieve(q, 7), "dense_score", 1e-5)


def test_sparse_retriever_matches_jax():
    t = trag.SparseRetriever(device="cpu")
    j = jrag.SparseRetriever()
    tc, jc = _chunks(trag, False), _chunks(jrag, False)
    t.index(tc[0])
    j.index(jc[0])
    t.index_batch(tc[1:])
    j.index_batch(jc[1:])
    assert len(t) == len(j) == 150
    for q in QUERIES:
        a, b = t.retrieve(q, 7), j.retrieve(q, 7)
        assert a and all(r.dense_score is None for r in a)
        _same(a, b, "sparse_score", 1e-4)


def test_the_port_exports_every_name_of_the_jax_package():
    assert set(jrag.__all__) <= set(trag.__all__)
    for name in trag.__all__:
        assert getattr(trag, name) is not None
