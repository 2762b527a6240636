"""The learned-sparse scoring ops and index against the JAX package:
``pack_weighted_blocks`` byte for byte, ``weighted_topk_blocks`` with and
without an allowed-row filter (one for the batch and one per query),
``fuse_topk_many`` in all six kinds over two and three lists with interior
``-1`` holes (and equal to ``fuse_topk`` on two lists),
``tri_query_arrays`` against the JAX program, and ``LearnedSparseIndex``
through adds, replacements, removes and ``load_rows`` against the JAX
index's state, slot lists and answers, and its float64 oracle.

Weights are drawn from a continuous law, so no two candidate scores tie
(tie-free data): rows must be equal and scores within rel 1e-4 — the
candidate tail sums a row's run as a difference of f32 prefix sums over the
whole panel (~mass·2⁻²³, the BM25 parity tests' tolerance); the float64
oracle likewise. Fused scores: rel 1e-6 with an absolute 1e-6 (a z-score
sum near 0 cancels to a few f32 ulps of its terms); over lists of
different frameworks' scores, whose min-max or z normalization magnifies
the inputs' 1e-4, absolute 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trueno_rag_tpu.chunking import Chunk as JChunk
from trueno_rag_tpu.chunking import ChunkMetadata as JMeta
from trueno_rag_tpu.index.learned_sparse import LearnedSparseIndex as JIndex
from trueno_rag_tpu.ops import bm25 as jbm25
from trueno_rag_tpu.ops import fusion as jfusion
from trueno_rag_tpu.ops import hybrid as jhybrid

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.chunking import Chunk as TChunk
from trueno_rag_tpu_torch.chunking import ChunkMetadata as TMeta
from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex as TIndex
from trueno_rag_tpu_torch.ops import bm25 as tbm25
from trueno_rag_tpu_torch.ops import fusion as tfusion
from trueno_rag_tpu_torch.ops import hybrid as thybrid

BL = tbm25.BLOCK_LEN
VOCAB = 60


def _chunks(mod_chunk, mod_meta, ids):
    return [mod_chunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=1,
                      metadata=mod_meta(title=""), id=f"c{i}") for i in ids]


def _expansions(rng, n, per_row=8, hot=True):
    """Per-row distinct terms; term 0 in every row (a posting list spanning
    several blocks past 2·BLOCK_LEN rows) when ``hot``."""
    t = np.stack([rng.choice(VOCAB, size=per_row, replace=False) for _ in range(n)]).astype(np.int64)
    if hot:
        t[:, 0] = 0
    w = rng.uniform(0.05, 2.0, size=t.shape).astype(np.float32)
    return t, w


def _pair(n, seed, **kw):
    rng = np.random.default_rng(seed)
    t, w = _expansions(rng, n, **kw)
    j, p = JIndex(), TIndex(device="cpu")
    j.add_batch(_chunks(JChunk, JMeta, range(n)), t, w)
    p.add_batch(_chunks(TChunk, TMeta, range(n)), t, w)
    return j, p, rng


def _queries(rng, b=6, t=10):
    qt = rng.integers(-1, VOCAB, size=(b, t)).astype(np.int32)
    qw = rng.uniform(0.0, 1.5, size=(b, t)).astype(np.float32)
    qw[0] = 0.0  # no live term: no hits
    return qt, qw


def _same(js, jr, ts, tr, atol=0.0):
    jr, js = np.asarray(jr), np.asarray(js)
    tr, ts = tr.numpy(), ts.numpy()
    np.testing.assert_array_equal(tr, jr)
    live = jr >= 0
    np.testing.assert_allclose(ts[live], js[live], rtol=1e-4, atol=atol)
    assert np.isneginf(ts[~live]).all() and np.isneginf(js[~live]).all()


def test_pack_weighted_blocks_byte_for_byte():
    rng = np.random.default_rng(0)
    for p in (0, 5, BL, 3 * BL + 17):
        rows = rng.integers(0, 1 << 20, size=p).astype(np.int32)
        w = rng.uniform(0, 3, size=p).astype(np.float32)
        np.testing.assert_array_equal(tbm25.pack_weighted_blocks(rows, w),
                                      np.asarray(jbm25.pack_weighted_blocks(rows, w)))
    with pytest.raises(trag.InvalidConfigError):
        tbm25.pack_weighted_blocks(np.array([1 << 24], np.int32), np.ones(1, np.float32))


@pytest.mark.parametrize("allowed_kind", ["none", "batch", "per_query"])
def test_weighted_topk_blocks_matches_jax(allowed_kind):
    j, p, rng = _pair(700, seed=1)
    j._refresh_snapshot()
    p._refresh_snapshot()
    np.testing.assert_array_equal(p._snap["blocks"].numpy(), np.asarray(j._snap["blocks"]))
    qt, qw = _queries(rng)
    slots = p._gather_blocks(qt, qw)
    for a, b in zip(slots, j._gather_blocks(qt, qw)):
        np.testing.assert_array_equal(a, b)  # the slot lists, bucket and padding included
    cap = p.capacity_rows
    allowed = {"none": None, "batch": rng.random(cap) < 0.6,
               "per_query": rng.random((qt.shape[0], cap)) < 0.5}[allowed_kind]
    js, jr = jbm25.weighted_topk_blocks(*(jnp.asarray(x) for x in slots), j._snap["blocks"], k=12,
                                        allowed=None if allowed is None else jnp.asarray(allowed))
    ts, tr = tbm25.weighted_topk_blocks(*(torch.from_numpy(x) for x in slots), p._snap["blocks"], k=12,
                                        allowed=None if allowed is None else torch.from_numpy(allowed))
    _same(js, jr, ts, tr)
    assert (tr[0] == -1).all()  # the query without a live term
    if allowed is not None:
        ok = allowed if allowed.ndim == 2 else np.broadcast_to(allowed, (qt.shape[0], cap))
        r = tr.numpy()
        assert all(ok[i, x] for i in range(r.shape[0]) for x in r[i] if x >= 0)


def test_weighted_search_against_float64_oracle():
    _, p, rng = _pair(600, seed=2)
    qt, qw = _queries(rng, b=5)
    s, r = p.search_arrays(qt, qw, 15)
    for i in range(qt.shape[0]):
        want = p.search_host(qt[i], qw[i], 15)
        got = [(int(x), float(y)) for x, y in zip(r[i].numpy(), s[i].numpy()) if x >= 0]
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], rtol=1e-4)
    # the sentinel-only query and exact ties ordered row asc
    ties = TIndex(device="cpu")
    ties.add_batch(_chunks(TChunk, TMeta, range(3)), np.full((3, 1), 7), np.ones((3, 1), np.float32))
    _, r = ties.search_arrays(np.array([[7]]), np.array([[1.0]], np.float32), 3)
    assert r[0].tolist() == [0, 1, 2]


def test_index_mutations_match_jax_state():
    j, p, rng = _pair(300, seed=3, hot=False)
    # replacement, a repeated term (its largest weight kept), dead slots
    t = np.array([[5, 9, 5, -1], [2, 3, 4, 6]])
    w = np.array([[0.5, 1.0, 2.0, 3.0], [1.0, 0.0, 0.25, 0.75]], np.float32)
    for idx, C, M in ((j, JChunk, JMeta), (p, TChunk, TMeta)):
        idx.add_batch(_chunks(C, M, [3, 1000]), t, w)
        assert idx.remove("c10") and not idx.remove("c10") and idx.remove("c1000")
    assert p.state_dict() == j.state_dict()
    assert len(p) == len(j)
    with pytest.raises(trag.VectorStoreError):
        p.add(_chunks(TChunk, TMeta, [1])[0], np.array([3]), np.array([-0.5], np.float32))
    qt, qw = _queries(rng)
    js, jr = j.search_arrays(qt, qw, 10)
    ts, tr = p.search_arrays(qt, qw, 10)
    _same(js, jr, ts, tr)
    for i in range(qt.shape[0]):
        got = p.search_host(qt[i], qw[i], 10)
        want = j.search_host(qt[i], qw[i], 10)
        assert [g[0] for g in got] == [x[0] for x in want]
        np.testing.assert_allclose([g[1] for g in got], [x[1] for x in want], rtol=1e-12)


def test_load_rows_and_state_dict_round_trip():
    j, p, rng = _pair(200, seed=4)
    indptr, terms, weights = p.row_expansions(list(range(200)))
    j2, p2 = JIndex(), TIndex(device="cpu")
    j2.load_rows(_chunks(JChunk, JMeta, range(200)), indptr, terms, weights)
    p2.load_rows(_chunks(TChunk, TMeta, range(200)), indptr, terms, weights)
    assert p2.state_dict() == j2.state_dict() == j.state_dict()
    # a restore whose rows hold unsorted and repeated terms (the last weight wins)
    ip = np.array([0, 3, 5])
    tt = np.array([9, 2, 9, 4, 1], np.int32)
    ww = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    for idx, C, M in ((JIndex(), JChunk, JMeta), (TIndex(device="cpu"), TChunk, TMeta)):
        idx.load_rows(_chunks(C, M, [0, 1]), ip, tt, ww)
        assert idx.state_dict()["postings"] == {"9": {"0": 3.0}, "2": {"0": 2.0}, "4": {"1": 4.0},
                                                "1": {"1": 5.0}}
    p3 = TIndex(registry=p.registry, device="cpu")
    p3.load_state_dict(j.state_dict())
    qt, qw = _queries(rng)
    s_a, r_a = p.search_arrays(qt, qw, 8)
    s_b, r_b = p3.search_arrays(qt, qw, 8)
    assert torch.equal(r_a, r_b) and torch.equal(s_a, s_b)


def _lists(rng, b, k, n_rows, holes):
    """One candidate list [B, k]: distinct rows per query, scores desc,
    interior -1 holes (a post-filter list) when ``holes``."""
    rows = np.stack([rng.choice(n_rows, size=k, replace=False) for _ in range(b)]).astype(np.int32)
    scores = -np.sort(-rng.uniform(0.1, 5.0, size=(b, k)), axis=1).astype(np.float32)
    if holes:
        dead = rng.random((b, k)) < 0.25
        rows[dead] = -1
        scores[dead] = -np.inf
    return rows, scores


@pytest.mark.parametrize("kind", tfusion.FUSION_KINDS)
@pytest.mark.parametrize("n_lists", [2, 3])
def test_fuse_topk_many_matches_jax(kind, n_lists):
    rng = np.random.default_rng(7)
    lists = [_lists(rng, 6, k, 24, holes=True) for k in (8, 6, 7)[:n_lists]]
    weights = tuple(rng.uniform(0.1, 1.0, size=n_lists).round(3)) if kind in ("linear", "convex") else ()
    jr, js = jfusion.fuse_topk_many(tuple(jnp.asarray(r) for r, _ in lists),
                                    tuple(jnp.asarray(s) for _, s in lists),
                                    kind=kind, param=60.0, weights=weights)
    tr, ts = tfusion.fuse_topk_many([torch.from_numpy(r) for r, _ in lists],
                                    [torch.from_numpy(s) for _, s in lists],
                                    kind=kind, param=60.0, weights=weights)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    live = np.asarray(jr) >= 0
    np.testing.assert_allclose(ts.numpy()[live], np.asarray(js)[live], rtol=1e-6, atol=1e-6)
    assert np.isneginf(ts.numpy()[~live]).all()
    if n_lists == 2:  # two lists: the two-list fusion
        param = weights[0] if weights else 60.0
        fr, fs = tfusion.fuse_topk(*(torch.from_numpy(x) for x in (*lists[0], *lists[1])), kind=kind,
                                   param=param)
        mr, ms = tfusion.fuse_topk_many([torch.from_numpy(r) for r, _ in lists],
                                        [torch.from_numpy(s) for _, s in lists], kind=kind, param=param,
                                        weights=(param, 1.0 - param) if weights else ())
        assert torch.equal(fr, mr)
        np.testing.assert_allclose(fs.numpy(), ms.numpy(), rtol=1e-6, atol=1e-6)
    if kind in ("linear", "convex"):
        with pytest.raises(trag.InvalidConfigError):
            tfusion.fuse_topk_many([torch.from_numpy(r) for r, _ in lists],
                                   [torch.from_numpy(s) for _, s in lists], kind=kind, weights=(1.0,))


def test_tri_query_arrays_matches_jax():
    rng = np.random.default_rng(8)
    n, d, b = 500, 16, 4
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    valid = rng.random(n) < 0.95
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    # a BM25-shaped block table: postings of 20 terms over the rows
    rows = np.concatenate([np.sort(rng.choice(n, size=60, replace=False)) for _ in range(20)]).astype(np.int32)
    contrib = rng.uniform(0.1, 3.0, size=rows.size).astype(np.float32)
    blocks = np.asarray(jbm25.pack_weighted_blocks(rows, contrib))  # same lane layout as pack_posting_blocks
    bids = np.stack([[t * 60 // BL for t in rng.choice(20, 3, replace=False)] for _ in range(b)]).astype(np.int32)
    lo = np.zeros_like(bids)
    hi = np.full_like(bids, BL)
    _, p, _ = _pair(n, seed=9)
    p._refresh_snapshot()
    qt, qw = _queries(rng, b=b)
    lb, ll, lh, lw = p._gather_blocks(qt, qw)
    for kind, weights in (("rrf", ()), ("linear", (0.5, 0.3, 0.2)), ("union", ())):
        args = (q, m, valid, bids, lo, hi, blocks, lb, ll, lh, lw, p._snap["blocks"].numpy())
        jo = jhybrid.tri_query_arrays(*(jnp.asarray(x) for x in args), cand=10, fusion_kind=kind,
                                      fusion_weights=weights)
        to = thybrid.tri_query_arrays(*(torch.from_numpy(np.array(x)) for x in args), cand=10,
                                      fusion_kind=kind, fusion_weights=weights)
        assert len(jo) == len(to) == 8
        for i in range(0, 8, 2):
            _same(jo[i + 1], jo[i], to[i + 1], to[i], atol=1e-4 if i == 0 else 0.0)

