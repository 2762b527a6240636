"""The BM25 segment path's operations against the JAX package: the packed
postings byte for byte, ``bm25_topk_segments``, the gather and scatter
oracles, the fetch kernels' plain versions against the Pallas kernels
``fetch_contribs``/``fetch_contribs8`` (interpret mode, as
``tests/test_pallas.py`` runs them), ``bm25_topk_dma`` and
``gather_aligned_segments``; and (on a card only) the CUDA kernels K12a/K12b
against their plain versions.

Tolerances, and why:
- fetched rows: equal (int32 bits carried through f32 lane 0).
- contributions against interpret mode: within 4 ulps. XLA folds the
  static constants of the denominator into one factor (``dl·(k1·b/avgdl)``
  for ``k1·(b·dl/avgdl)``) and may contract the add into an fma, so the
  denominator, a sum of positive terms, is rounded a few times otherwise
  (≤ 2 ulps apart) and the quotient ≤ 4 ulps (2 seen). The port rounds
  each step as the Pallas source is written: bit for bit a numpy
  emulation of that order.
- top-k rows: equal on the top 10 (tie-free there); scores within rel
  1e-4 and abs 1e-4, the JAX package's own BM25 parity tolerance (the f32
  prefix-sum tail's rounding scales with the panel's mass, not a row's
  score: ROADMAP Queue 3, "BM25 rounding"). Deeper ranks (hundreds of
  candidates) may swap at such near-ties, so there the sets are equal.
- on the card, kernel against plain version: rows and contributions bit
  for bit (both round each step in IEEE f32, in the same order).
JAX is imported inside the CPU tests: the card's machine runs the
``cuda``-marked ones without it.
"""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import bm25 as tbm25
from trueno_rag_tpu_torch.ops.kernels import bm25_fetch as tfetch

SEG = tbm25.SEGMENT_LEN
INTMAX = np.iinfo(np.int32).max


def _postings(seed, p=4096, n=700, v=37):
    """Random CSR postings sorted by term: (rows, tfs, doc_len, idf, term_of)."""
    rng = np.random.default_rng(seed)
    term_of = np.sort(rng.integers(0, v, p))
    rows = rng.integers(0, n, p).astype(np.int32)
    tfs = rng.integers(1, 6, p).astype(np.float32)
    idf = (rng.random(v) + 0.1).astype(np.float32)
    doc_len = rng.integers(5, 50, n).astype(np.float32)
    return rows, tfs, doc_len, idf, term_of


def _slots(rng, p, n_slots):
    """Aligned slots over ``p`` postings: full, ragged lo/hi, empty (hi <=
    lo), the last real slab and the sentinel block; ``n_slots`` a multiple
    of 8, as the Pallas kernels need."""
    nb = p // SEG + 1
    bids = rng.integers(0, nb, n_slots).astype(np.int32)
    lo = rng.integers(0, SEG, n_slots).astype(np.int32)
    hi = np.clip(lo + rng.integers(-8, SEG, n_slots), 0, SEG).astype(np.int32)
    bids[:4] = [(p - 1) // SEG, p // SEG, 0, 0]
    lo[:4] = [0, 0, 0, 200]
    hi[:4] = [SEG, SEG, SEG, 100]
    return bids, lo, hi


def _numpy_contrib(g, avgdl, k1, b):
    """The contribution of packed rows ``g [..., 4]``, op by op in f32 in
    the Pallas source's order."""
    f = np.float32
    tf, dl, idf = g[..., 1], g[..., 2], g[..., 3]
    t = f(1.0 - b) + (f(b) * dl) / f(max(float(avgdl), 1e-9))
    return ((idf * tf) * f(k1 + 1.0)) / np.maximum(tf + f(k1) * t, f(1e-9))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_pack_postings_matches_jax_byte_for_byte():
    from trueno_rag_tpu.ops import bm25 as jbm25

    for seed, p in ((0, 4096), (1, 1000), (2, 0)):
        args = _postings(seed, p=p)
        want = np.asarray(jbm25.pack_postings(*args))
        got = tbm25.pack_postings(*args)
        assert got.shape == (p + SEG, 4) and got.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert (got[p:, 0].view(np.int32) == INTMAX).all()  # sentinel row bits


@pytest.mark.parametrize("seed,k1,b", [(0, 1.2, 0.75), (1, 0.9, 0.4), (2, 2.0, 1.0)])
def test_fetch_plain_versions_match_pallas(seed, k1, b):
    import jax.numpy as jnp

    from trueno_rag_tpu.ops import bm25 as jbm25
    from trueno_rag_tpu.ops.pallas import bm25_fetch as jfetch

    args = _postings(seed)
    packed = tbm25.pack_postings(*args)
    avgdl = float(np.float32(args[2].mean()))
    rng = np.random.default_rng(seed + 10)
    bids, lo, hi = _slots(rng, len(args[0]), 64)
    jin = [jnp.asarray(x) for x in (bids, lo, hi)] + [jnp.asarray(np.asarray(jbm25.pack_postings(*args)))]
    r_j, c_j = (np.asarray(x) for x in jfetch.fetch_contribs(*jin, avgdl, k1=k1, b=b, interpret=True))
    r_j8, c_j8 = (np.asarray(x) for x in jfetch.fetch_contribs8(*jin, avgdl, k1=k1, b=b, interpret=True))
    assert np.array_equal(r_j8, r_j) and c_j8.tobytes() == c_j.tobytes()
    tin = [torch.from_numpy(x) for x in (bids, lo, hi, packed)]
    for fn in (tfetch.fetch_contribs, tfetch.fetch_contribs8):
        before = fn.launches
        r_t, c_t = (x.numpy() for x in fn(*tin, avgdl, k1=k1, b=b))
        assert fn.launches == before  # the CPU runs the plain version
        assert r_t.dtype == np.int32 and r_t.shape == (64, SEG)
        assert np.array_equal(r_t, r_j)
        lane = np.arange(SEG)
        mask = (lane >= lo[:, None]) & (lane < hi[:, None])
        assert (r_t[~mask] == INTMAX).all() and (c_t[~mask] == 0).all()
        g = packed[bids[:, None].astype(np.int64) * SEG + lane]
        assert np.array_equal(np.where(mask, _numpy_contrib(g, avgdl, k1, b), 0).view(np.int32),
                              c_t.view(np.int32))
        assert _ulps(c_t, c_j).max() <= 4


def _index(seed=0, n_docs=400, n_words=30):
    """A JAX BM25 index over documents of distinct lengths (terms past one
    segment: every word sits in most documents)."""
    from trueno_rag_tpu.chunking import Chunk
    from trueno_rag_tpu.index.bm25 import BM25Index

    rng = np.random.default_rng(seed)
    words = [f"w{i:02d}" for i in range(n_words)]
    idx = BM25Index(use_native=False)
    for i, ln in enumerate(rng.permutation(np.arange(4, 4 + n_docs))):
        idx.add(Chunk(id=f"c{i}", document_id="d", content=" ".join(rng.choice(words, size=ln)),
                      start_offset=0, end_offset=1))
    idx._refresh_snapshot()
    return idx, words


QUERIES = ["w01 w02 w03", "w04 w04 w29", "w10", "zzz unknown", "w05 zzz w06 w07 w08",
           "w11 w12 w13 w14 w15 w16", "the of", "w20 w21"]


def test_bm25_topk_segments_matches_jax():
    """Several queries with repeated, unknown and stopword-only terms;
    terms longer than one segment; k past the candidates and past the
    panel."""
    import jax.numpy as jnp

    from trueno_rag_tpu.ops import bm25 as jbm25

    idx, _ = _index()
    snap = idx._snap
    starts, lens = idx._gather_segments(QUERIES)
    assert (lens > 0).sum(axis=1).max() > 3 and starts.shape[1] == 64
    packed = np.array(idx._get_packed())
    avgdl = float(np.asarray(snap["avgdl"]))
    for k in (10, 450, 16400):  # 16,400 > the 64·256 panel
        s_j, r_j = (np.asarray(x) for x in jbm25.bm25_topk_segments(
            jnp.asarray(starts), jnp.asarray(lens), jnp.asarray(packed), snap["avgdl"], k=k))
        s_t, r_t = (x.numpy() for x in tbm25.bm25_topk_segments(
            torch.from_numpy(starts), torch.from_numpy(lens), torch.from_numpy(packed), avgdl, k))
        assert s_t.shape == (len(QUERIES), k) and r_t.dtype == np.int32
        assert np.array_equal(np.isneginf(s_t), np.isneginf(s_j))
        live = np.isfinite(s_j)
        np.testing.assert_allclose(s_t[live], s_j[live], rtol=1e-4, atol=1e-4)
        if k == 10:
            assert np.array_equal(r_t, r_j)
        else:  # past the top 10, near-ties among hundreds of candidates
            assert all(set(r_t[i]) == set(r_j[i]) for i in range(len(QUERIES)))
    assert (r_t[3] == -1).all() and (r_t[6] == -1).all()  # unknown / stopwords only


def _gather_lists(seed=7):
    rng = np.random.default_rng(seed)
    n, v, p, bsz, L = 500, 40, 2000, 3, 256
    term_sorted = np.sort(rng.integers(0, v, p))
    rows = rng.integers(0, n, p).astype(np.int32)
    tfs = rng.integers(1, 6, p).astype(np.float32)
    indptr = np.searchsorted(term_sorted, np.arange(v + 1))
    idf = rng.random(v).astype(np.float32) + 0.1
    doc_len = rng.integers(5, 50, n).astype(np.float32)
    positions = np.zeros((bsz, L), np.int32)
    terms = np.zeros((bsz, L), np.int32)
    mask = np.zeros((bsz, L), bool)
    for i in range(bsz):
        parts_p, parts_t = [], []
        for t in rng.choice(v, 4, replace=False):
            lo, hi = int(indptr[t]), int(indptr[t + 1])
            parts_p.append(np.arange(lo, hi, dtype=np.int32))
            parts_t.append(np.full(hi - lo, t, np.int32))
        pos = np.concatenate(parts_p)[:L]
        positions[i, : len(pos)] = pos
        terms[i, : len(pos)] = np.concatenate(parts_t)[:L]
        mask[i, : len(pos)] = True
    return (positions, terms, mask, rows, tfs, idf, doc_len, np.float32(doc_len.mean())), n


def test_candidates_and_scatter_match_jax_and_each_other():
    """The element-gather and dense-scatter oracles on the data of
    tests/test_index.py::test_bm25_candidates_matches_scatter."""
    import jax.numpy as jnp

    from trueno_rag_tpu.ops import bm25 as jbm25

    args, n = _gather_lists()
    k = 20
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args[:-1]] + [float(args[-1])]
    s_jc, r_jc = (np.asarray(x) for x in jbm25.bm25_topk_candidates(*jargs, k=k))
    s_js, r_js = (np.asarray(x) for x in jbm25.bm25_topk_scatter(*jargs, k=k, n_rows=n))
    s_tc, r_tc = (x.numpy() for x in tbm25.bm25_topk_candidates(*targs, k=k))
    s_ts, r_ts = (x.numpy() for x in tbm25.bm25_topk_scatter(*targs, k=k, n_rows=n))
    for s, r in ((s_tc, r_tc), (s_ts, r_ts), (s_js, r_js)):
        np.testing.assert_allclose(s, s_jc, rtol=1e-4, atol=1e-5)
        # same candidate sets; adjacent ranks may swap at sub-ulp gaps
        assert all(set(r[i]) == set(r_jc[i]) for i in range(r.shape[0]))
    assert np.array_equal(r_tc, r_jc)
    # k past the corpus pads with (-inf, -1)
    s_big, r_big = tbm25.bm25_topk_scatter(*targs, k=n + 5, n_rows=n)
    assert r_big.shape == (3, n + 5) and (r_big[:, n:] == -1).all()


@pytest.mark.parametrize("seed,nwords,ndocs,nq", [(0, 50, 200, 5), (1, 20, 800, 9), (2, 300, 100, 3)])
def test_dma_and_aligned_plan_match_jax(seed, nwords, ndocs, nq):
    """gather_aligned_segments gives the JAX arrays; bm25_topk_dma (plain on
    the CPU) answers as the JAX one in interpret mode; and the aligned
    plan gives the segment plan's top-k (the cases of
    tests/test_pallas.py::test_bm25_dma_matches_segments)."""
    import jax.numpy as jnp

    from trueno_rag_tpu.chunking import Chunk
    from trueno_rag_tpu.index.bm25 import BM25Index
    from trueno_rag_tpu.ops.pallas import bm25_fetch as jfetch

    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(nwords)]
    idx = BM25Index(use_native=False)
    for i, ln in enumerate(rng.permutation(np.arange(5, 5 + ndocs))):  # distinct lengths
        text = " ".join(rng.choice(words, size=ln))
        idx.add(Chunk(id=f"c{i}", document_id="d", content=text, start_offset=0, end_offset=1))
    idx._refresh_snapshot()
    snap = idx._snap
    queries = [" ".join(rng.choice(words, size=rng.integers(1, 6))) for _ in range(nq)]
    queries.append("zzz unknown terms only")
    plan_args = (snap["indptr"], None, snap["vocab"], idx._tokenize, queries, int(snap["indptr"][-1]))
    want = jfetch.gather_aligned_segments(*plan_args)
    got = tfetch.gather_aligned_segments(*plan_args)
    for a, w in zip(got[:3], want[:3]):
        assert a.dtype == np.int32 and np.array_equal(a, w)
    assert got[3:] == want[3:]
    bids, lo, hi, s_slots, _ = got
    packed = np.array(idx._get_packed())
    avgdl = float(np.asarray(snap["avgdl"]))
    k = 10
    s_j, r_j = (np.asarray(x) for x in jfetch.bm25_topk_dma(
        jnp.asarray(bids), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(packed), avgdl,
        k=k, s_slots=s_slots, interpret=True))
    t_in = [torch.from_numpy(x) for x in (bids, lo, hi, packed)]
    starts, lens = idx._gather_segments(queries)
    s_seg, r_seg = (x.numpy() for x in tbm25.bm25_topk_segments(
        torch.from_numpy(starts), torch.from_numpy(lens), t_in[3], avgdl, k))
    for wide in (False, True):
        s_t, r_t = (x.numpy() for x in tfetch.bm25_topk_dma(*t_in, avgdl, k=k, s_slots=s_slots, wide=wide))
        assert np.array_equal(r_t, r_j)
        np.testing.assert_allclose(np.where(np.isneginf(s_t), 0, s_t), np.where(np.isneginf(s_j), 0, s_j),
                                   rtol=1e-4)
        nq_all = len(queries)
        assert np.array_equal(r_t[:nq_all], r_seg)
        np.testing.assert_allclose(np.where(np.isneginf(s_t[:nq_all]), 0, s_t[:nq_all]),
                                   np.where(np.isneginf(s_seg), 0, s_seg), rtol=1e-4)


def test_fetch_rejects_what_the_kernel_does_not_take():
    args = _postings(0)
    packed = torch.from_numpy(tbm25.pack_postings(*args))
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(InvalidConfigError, match="int32"):
        tfetch.fetch_contribs(ids.long(), ids, ids, packed, 10.0)
    with pytest.raises(InvalidConfigError, match="packed"):
        tfetch.fetch_contribs(ids, ids, ids, packed[:, :3], 10.0)
    with pytest.raises(InvalidConfigError, match=r"\[B, S\]"):
        tfetch.bm25_topk_fetch(ids, ids[:4], packed, 10.0, 5)


# -- on the card -----------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,p", [(0, 1 << 16), (1, 70001)])
def test_cuda_k12_matches_plain_version(seed, p):
    """On the card: K12a and K12b against their plain versions on aligned
    slots with ragged lo/hi, empty slots, the last slab before the
    sentinel and the sentinel block (n_slots not a multiple of 8), and the
    segment plan from unaligned starts; rows and contributions bit for bit,
    and bm25_topk_fetch equal to the plain bm25_topk_segments."""
    _cuda_or_skip()
    args = _postings(seed, p=p, n=5000, v=300)
    packed = torch.from_numpy(tbm25.pack_postings(*args)).cuda()
    avgdl = float(np.float32(args[2].mean()))
    rng = np.random.default_rng(seed)
    bids, lo, hi = (torch.from_numpy(x).cuda() for x in _slots(rng, p, 1001))
    want = tfetch.fetch_contribs_reference(bids, lo, hi, packed, avgdl)
    for fn in (tfetch.fetch_contribs, tfetch.fetch_contribs8):
        before = fn.launches
        got = fn(bids, lo, hi, packed, avgdl)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    starts = torch.from_numpy(rng.integers(0, p + 1, (16, 64)).astype(np.int32)).cuda()
    lens = torch.clamp(torch.from_numpy(rng.integers(0, SEG + 1, (16, 64)).astype(np.int32)).cuda(),
                       max=p - starts)
    s_w, r_w = tbm25.bm25_topk_segments(starts, lens, packed, avgdl, 50)
    s_g, r_g = tfetch.bm25_topk_fetch(starts, lens, packed, avgdl, 50)
    torch.cuda.synchronize()
    assert torch.equal(r_g, r_w) and torch.equal(s_g, s_w)
    with pytest.raises(InvalidConfigError, match="past the packed"):
        tfetch.fetch_contribs(bids + p, lo, hi, packed, avgdl)


@pytest.mark.cuda
def test_cuda_segment_path_launches_its_width_once():
    """bm25_topk_fetch launches fetch_contribs8 (the segment path's width)
    once per call, at one query and at many, and gives the plain answer."""
    _cuda_or_skip()
    args = _postings(0, p=1 << 15, n=5000, v=300)
    packed = torch.from_numpy(tbm25.pack_postings(*args)).cuda()
    rng = np.random.default_rng(5)
    for b in (1, 200):
        starts = torch.from_numpy(rng.integers(0, 1 << 15, (b, 64)).astype(np.int32)).cuda()
        lens = torch.full_like(starts, SEG).clamp(max=(1 << 15) - starts)
        before = (tfetch.fetch_contribs.launches, tfetch.fetch_contribs8.launches)
        got = tfetch.bm25_topk_fetch(starts, lens, packed, 30.0, 10)
        after = (tfetch.fetch_contribs.launches, tfetch.fetch_contribs8.launches)
        assert after == (before[0], before[1] + 1)
        plain = tbm25.bm25_topk_segments(starts, lens, packed, 30.0, 10)
        assert torch.equal(got[1], plain[1])
        # a one-row cumsum is a device-wide scan whose f32 association may
        # change between calls; a batch's per-row scan does not
        torch.testing.assert_close(got[0], plain[0], rtol=0 if b > 1 else 1e-5, atol=0 if b > 1 else 1e-4)
