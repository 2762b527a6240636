"""The port's ingest near-duplicate detection against the JAX package's:
``near_duplicates`` (two fp32 products, TF32 off) equals the JAX function
and the scalar oracle on seeded data whose similarities all lie at least
1e-4 away from the threshold, against a corpus, within a batch, with
invalid rows, raw corpus rows and an empty corpus; and a pipeline
``with_dedup`` keeps the same chunks as the JAX pipeline."""

import numpy as np
import pytest
import torch

import trueno_rag_tpu as jrag
from trueno_rag_tpu.ops.dedup import near_duplicates as jnear

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.ops.dedup import near_duplicates, near_duplicates_oracle

D = 24


def _data(seed, m=40, n=60, rows_normalized=True):
    """Incoming rows and a corpus with planted near-copies (of corpus rows
    and of earlier batch entries), plus a threshold with every cosine at
    least 1e-4 away from it."""
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n, D)).astype(np.float32)
    if rows_normalized:
        corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    emb = rng.standard_normal((m, D)).astype(np.float32)
    for i in range(0, m, 5):  # near-copies of corpus rows
        emb[i] = corpus[rng.integers(n)] * 3.0 + 0.01 * rng.standard_normal(D)
    for i in range(3, m, 7):  # near-copies of an earlier batch entry
        emb[i] = emb[i - 2] + 0.005 * rng.standard_normal(D)
    emb[m - 1] = 0.0  # a zero row stays unnormalized
    valid = rng.random(n) > 0.1
    e = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-30)
    c = corpus / np.maximum(np.linalg.norm(corpus, axis=1, keepdims=True), 1e-30)
    sims = np.concatenate([(e @ c.T)[:, valid].ravel(), (e @ e.T)[np.tril_indices(m, -1)]]).astype(np.float64)
    for thr in np.linspace(0.95, 0.999, 200):
        if np.abs(sims - thr).min() > 1e-4:
            return emb, corpus, valid, float(thr)
    raise AssertionError("no threshold clear of every similarity")


@pytest.mark.parametrize("rows_normalized", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_near_duplicates_matches_jax(seed, rows_normalized):
    emb, corpus, valid, thr = _data(seed, rows_normalized=rows_normalized)
    got = near_duplicates(emb, corpus, valid, threshold=thr, rows_normalized=rows_normalized, device="cpu")
    want = jnear(emb, corpus, valid, threshold=thr, rows_normalized=rows_normalized)
    oracle = near_duplicates_oracle(emb, corpus, valid, thr, rows_normalized)
    assert got[0].sum() > 3
    for g, w, o in zip(got, want, oracle):
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
            np.testing.assert_allclose(g.numpy(), o, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), o)


def test_near_duplicates_empty_corpus_and_tensor_inputs():
    emb, _, _, thr = _data(3)
    empty = np.zeros((0, D), np.float32)
    got = near_duplicates(emb, empty, np.zeros(0, bool), threshold=thr, device="cpu")
    want = jnear(emb, empty, np.zeros(0, bool), threshold=thr)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1][got[0]] < -1).all()  # batch duplicates only: -(j + 2)
    t = near_duplicates(torch.from_numpy(emb), torch.from_numpy(empty), torch.zeros(0, dtype=torch.bool),
                        threshold=thr)
    assert t[0].device.type == "cpu" and torch.equal(t[0], got[0])


def _pipeline(rag, dedup):
    rng = np.random.default_rng(0)
    words = [f"w{i:03d}" for i in range(300)]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(8, 30)))) for _ in range(80)]
    texts += [texts[i] for i in range(0, 80, 9)]  # exact re-crawls
    texts += [texts[i] + " extra" for i in range(4, 80, 11)]  # near copies
    b = (rag.RagPipelineBuilder().with_embedder(rag.TfIdfEmbedder(64).fit(texts))
         .with_reranker(rag.NoOpReranker())
         .with_chunker(rag.RecursiveChunker(chunk_size=8192, overlap=0)))
    if dedup is not None:
        b = b.with_dedup(dedup)
    if rag is trag:
        b = b.with_device("cpu")
    p = b.build()
    docs = [rag.Document(t, id=f"d{i}") for i, t in enumerate(texts)]
    p.index_documents(docs[:60], tags=[["a"]] * 60)
    for d in docs[60:]:
        p.index_document(d, tags=["b"])
    return p


@pytest.mark.parametrize("threshold", [0.97, 0.9])
def test_pipeline_with_dedup_keeps_the_jax_chunks(threshold):
    tp, jp = _pipeline(trag, threshold), _pipeline(jrag, threshold)
    assert tp.duplicates_skipped == jp.duplicates_skipped > 0
    assert sorted(c.document_id for c in tp.retriever.registry._chunks if c is not None) == sorted(
        c.document_id for c in jp.retriever.registry._chunks if c is not None)
    assert tp.chunk_count == jp.chunk_count == len(tp.retriever)
    none = _pipeline(trag, None)
    assert none.duplicates_skipped == 0 and len(none.retriever) == tp.chunk_count + tp.duplicates_skipped
    with pytest.raises(trag.InvalidConfigError):
        trag.RagPipelineBuilder().with_dedup(0.0)
