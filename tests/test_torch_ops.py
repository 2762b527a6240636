"""Parity of the port's device ops with the JAX package on the same
inputs (made with numpy): exact dense top-k, block-table BM25 top-k,
the six fusions, and the one-dispatch hybrid query."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from trueno_rag_tpu.ops import bm25 as jbm25
from trueno_rag_tpu.ops import dense as jdense
from trueno_rag_tpu.ops import fusion as jfusion
from trueno_rag_tpu.ops import hybrid as jhybrid
from trueno_rag_tpu_torch.ops import bm25 as tbm25
from trueno_rag_tpu_torch.ops import dense as tdense
from trueno_rag_tpu_torch.ops import fusion as tfusion
from trueno_rag_tpu_torch.ops import hybrid as thybrid


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _corpus(n, d, b, seed, ties=True):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d)).astype(np.float32)
    if ties:  # exact duplicates: equal scores, resolved row-asc
        m[7] = m[3]
        m[n - 2] = m[3]
        m[200] = m[3]
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[1] = m[3]  # the duplicated rows top this query together
    valid = np.ones(n, bool)
    valid[50:90] = False  # tombstones
    valid[7] = False
    return m, q, valid


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("algorithm", ["blockwise", "full"])
def test_dense_topk_matches_jax(metric, algorithm):
    m, q, valid = _corpus(1000, 32, 8, seed=1)
    if metric == "cosine":
        m /= np.linalg.norm(m, axis=1, keepdims=True)
    if metric == "euclidean":  # |x|^2 + |q|^2 - 2 q.x cancels: keep magnitudes ~1
        m *= 0.15
        q *= 0.15
    k = 10
    js, jr = jdense.dense_topk(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), k, metric, algorithm)
    ts, tr = tdense.dense_topk(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid), k, metric, algorithm)
    np.testing.assert_array_equal(_np(tr), _np(jr))
    np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=1e-5)
    # the duplicated live rows 3, 200, n-2 tie at the top of query 1, row-asc
    assert list(_np(tr)[1][:3]) == [3, 200, 998]


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_dense_topk_matches_the_numpy_oracle(metric):
    m, q, valid = _corpus(600, 16, 5, seed=8, ties=False)
    m[9] = 0.0  # a zero row scores 0 under cosine (reference semantics)
    if metric == "cosine":
        nrm = np.linalg.norm(m, axis=1, keepdims=True)
        m = m / np.where(nrm == 0.0, 1.0, nrm)
    os_, or_ = tdense.dense_topk_oracle(q, m, valid, 12, metric)
    ts, tr = tdense.dense_topk(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid), 12, metric)
    np.testing.assert_array_equal(_np(tr), or_)
    np.testing.assert_allclose(_np(ts), os_, rtol=1e-5, atol=1e-5)


def test_dense_topk_short_corpus_pads_with_invalid_slots():
    m, q, valid = _corpus(40, 16, 3, seed=2, ties=False)
    valid[:] = True
    valid[5:] = False
    js, jr = jdense.dense_topk(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), 8, "dot")
    ts, tr = tdense.dense_topk(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid), 8, "dot")
    np.testing.assert_array_equal(_np(tr), _np(jr))
    assert (_np(tr)[:, 5:] == -1).all() and np.isneginf(_np(ts)[:, 5:]).all()


def _bm25_inputs(seed, n_rows=3000, vocab=300, b=8, block=256, slots=64):
    """A block table of random postings and the block slots of ``b``
    three-term queries, laid out exactly as ``BM25Index`` lays them out
    (term-major CSR, BLOCK_LEN-aligned blocks, a masked padding block).
    Contributions are continuous random values, so no two candidate sums
    tie; posting lists are short (4-16 rows) because the candidate tail
    sums equal-row runs as a difference of f32 prefix sums, whose
    rounding grows with the panel's total mass — light panels keep the
    two frameworks within rtol 1e-5."""
    rng = np.random.default_rng(seed)
    lists = [np.sort(rng.choice(n_rows, size=rng.integers(4, 16), replace=False)) for _ in range(vocab)]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in lists])])
    rows = np.concatenate(lists).astype(np.int32)
    contrib = rng.uniform(1.0, 3.0, size=len(rows)).astype(np.float32)
    nb = len(rows) // block + 1
    table = np.zeros((nb, 2, block), np.float32)
    table[:, 0, :].flat[: len(rows)] = rows.astype(np.float32)
    table[:, 1, :].flat[: len(rows)] = contrib
    table = table.reshape(nb, 2, block)
    bids = np.full((b, slots), len(rows) // block, np.int32)
    lo = np.zeros((b, slots), np.int32)
    hi = np.zeros((b, slots), np.int32)
    for i in range(b):
        j = 0
        for t in rng.choice(vocab, size=3, replace=False):
            t_lo, t_hi = int(indptr[t]), int(indptr[t + 1])
            for blk in range(t_lo // block, (t_hi - 1) // block + 1):
                bids[i, j] = blk
                lo[i, j] = max(t_lo - blk * block, 0)
                hi[i, j] = min(t_hi - blk * block, block)
                j += 1
    return bids, lo, hi, table


@pytest.mark.parametrize("k", [5, 40])
def test_bm25_topk_blocks_matches_jax(k):
    bids, lo, hi, table = _bm25_inputs(seed=3)
    js, jr = jbm25.bm25_topk_blocks(jnp.asarray(bids), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(table), k=k)
    ts, tr = tbm25.bm25_topk_blocks(*(torch.from_numpy(a) for a in (bids, lo, hi, table)), k=k)
    np.testing.assert_array_equal(_np(tr), _np(jr))
    js, ts = _np(js), _np(ts)
    np.testing.assert_array_equal(np.isneginf(ts), np.isneginf(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-5)


def test_pack_posting_blocks_matches_jax():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 5000, size=1000).astype(np.int32)
    tfs = rng.integers(1, 5, size=1000).astype(np.float32)
    doc_len = rng.integers(1, 50, size=5000).astype(np.float32)
    idf = rng.random(40).astype(np.float32)
    term_of = np.sort(rng.integers(0, 40, size=1000))
    args = (rows, tfs, doc_len, idf, term_of, np.float32(17.5))
    np.testing.assert_array_equal(tbm25.pack_posting_blocks(*args), np.asarray(jbm25.pack_posting_blocks(*args)))


def _candidate_lists(seed, b=8, kd=12, ks=10):
    rng = np.random.default_rng(seed)
    rows_d = np.stack([rng.permutation(40)[:kd] for _ in range(b)]).astype(np.int32)
    rows_s = np.stack([rng.permutation(40)[:ks] for _ in range(b)]).astype(np.int32)
    scores_d = -np.sort(-rng.random((b, kd)), axis=1).astype(np.float32)
    scores_s = -np.sort(-rng.random((b, ks)) * 8.0, axis=1).astype(np.float32)
    # invalid tail slots, one empty sparse list, one single-entry list
    rows_d[0, 9:] = -1
    scores_d[0, 9:] = -np.inf
    rows_s[2, :] = -1
    scores_s[2, :] = -np.inf
    rows_s[3, 1:] = -1
    scores_s[3, 1:] = -np.inf
    return rows_d, scores_d, rows_s, scores_s


@pytest.mark.parametrize(
    "kind,param",
    [("rrf", 60.0), ("linear", 0.3), ("convex", 0.7), ("dbsf", 0.0), ("union", 0.0), ("intersection", 0.0)],
)
def test_fuse_topk_matches_jax(kind, param):
    arrs = _candidate_lists(seed=5)
    jr, js = jfusion.fuse_topk(*(jnp.asarray(a) for a in arrs), kind=kind, param=param)
    tr, ts = tfusion.fuse_topk(*(torch.from_numpy(a) for a in arrs), kind=kind, param=param)
    np.testing.assert_array_equal(_np(tr), _np(jr))
    js, ts = _np(js), _np(ts)
    np.testing.assert_array_equal(np.isneginf(ts), np.isneginf(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=1e-6)


def test_hybrid_query_arrays_matches_jax():
    bids, lo, hi, table = _bm25_inputs(seed=6)
    m, q, valid = _corpus(3000, 32, 8, seed=6, ties=False)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    j = jhybrid.hybrid_query_arrays(
        *(jnp.asarray(a) for a in (q, m, valid, bids, lo, hi, table)), cand=20
    )
    t = thybrid.hybrid_query_arrays(
        *(torch.from_numpy(a) for a in (q, m, valid, bids, lo, hi, table)), cand=20
    )
    for name, ja, ta in zip(("f_rows", "f_scores", "d_rows", "d_scores", "s_rows", "s_scores"), j, t):
        ja, ta = _np(ja), _np(ta)
        if name.endswith("rows"):
            np.testing.assert_array_equal(ta, ja, err_msg=name)
        else:
            fin = np.isfinite(ja)
            np.testing.assert_array_equal(np.isfinite(ta), fin, err_msg=name)
            np.testing.assert_allclose(ta[fin], ja[fin], rtol=1e-5, atol=1e-6, err_msg=name)
