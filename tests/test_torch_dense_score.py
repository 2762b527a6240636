"""The fp32 block-max kernels K2 (``score_blockmax``) and K2b
(``blockmax_only``) and their top-k functions against the JAX package's
Pallas kernels (interpret mode) and ``pallas_dense_topk(_twopass)`` at the
shapes of ``tests/test_pallas.py``; the certified-selection
``dense_topk_approx(_checked)`` against the JAX package on the data of
``tests/test_edges.py``; and (on a card only) the CUDA kernels against
their plain versions.

Tolerances, and why:
- K2 scores and maxima: 1e-5 absolute (two f32 products of the same unit
  vectors summed in other orders, ~d·2⁻²⁴).
- top-k rows: equal; scores 1e-5 absolute (the port re-ranks by float64
  sums rounded once, the JAX package keeps the f32 HIGHEST product).
- ``dense_topk_approx_checked`` against ``dense_topk``: equal, bit for bit
  (the same re-rank on the same candidates).
JAX is imported inside the tests: the card's machine runs the
``cuda``-marked ones without it.
"""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import dense as tdense
from trueno_rag_tpu_torch.ops.kernels.dense_score import (
    blockmax_only,
    blockmax_only_reference,
    dense_topk_blockmax,
    dense_topk_twopass,
    score_blockmax,
    score_blockmax_reference,
)


def _data(n, d, b, seed, lo=10, hi=5):
    rng = np.random.default_rng(seed)
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n // lo: n // hi] = False
    return matrix, q, valid


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,d,b", [(2048, 64, 8), (4096, 36, 16)])
def test_k2_plain_matches_jax_kernels(n, d, b):
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas.dense_score import blockmax_only as jbo
    from trueno_rag_tpu.ops.pallas.dense_score import score_blockmax as jsb

    m, q, valid = _data(n, d, b, seed=n)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    js, jb = jsb(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), tile_n=1024, interpret=True)
    jb2 = jbo(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), tile_n=1024, interpret=True)
    ts, tb = score_blockmax(_t(q), _t(m), _t(valid))
    tb2 = blockmax_only(_t(q), _t(m), _t(valid))
    js, jb, jb2 = np.asarray(js), np.asarray(jb), np.asarray(jb2)
    assert ts.shape == js.shape and tb.shape == jb.shape == tb2.shape
    np.testing.assert_array_equal(np.isneginf(ts.numpy()), np.isneginf(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb2.numpy(), jb2, rtol=0, atol=1e-5)
    # the maxima are the exact max of the scores
    assert torch.equal(tb, ts.view(b, -1, 128).amax(dim=2))


def test_k2_ragged_rows_and_any_width():
    """N not a multiple of 128 and d = 36: the last block's maximum is
    over its real rows; the plain versions take any shape."""
    m, q, valid = _data(1000, 36, 3, seed=2)
    s, bm = score_blockmax_reference(_t(q), _t(m), _t(valid))
    assert s.shape == (3, 1000) and bm.shape == (3, 8)
    want = np.where(valid[None, :], q @ m.T, -np.inf)
    np.testing.assert_allclose(s.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(bm.numpy()[:, 7], s.numpy()[:, 896:].max(axis=1))
    assert torch.equal(blockmax_only_reference(_t(q), _t(m), _t(valid)), bm)


def _jax_topk(fn_name, q, m, valid, k, metric):
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas import dense_score as jds

    fn = getattr(jds, fn_name)
    s, r = fn(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), k, metric, interpret=True)
    return np.asarray(s), np.asarray(r)


@pytest.mark.parametrize("n,d,b,k", [(1000, 64, 5, 13), (4096, 128, 16, 50), (300, 32, 3, 7), (128, 384, 1, 5)])
def test_blockmax_topk_matches_pallas_dense_topk(n, d, b, k):
    m, q, valid = _data(n, d, b, seed=n)
    s_j, r_j = _jax_topk("pallas_dense_topk", q, m, valid, k, "cosine")
    s_t, r_t = dense_topk_blockmax(_t(q), _t(m), _t(valid), k, "cosine")
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-5, rtol=1e-5)
    s_x, r_x = tdense.dense_topk(_t(q), _t(m), _t(valid), k, "cosine")
    assert torch.equal(r_t, r_x) and torch.equal(s_t, s_x)


@pytest.mark.parametrize("n,d,b,k", [(1000, 64, 5, 13), (4096, 128, 16, 50)])
def test_twopass_topk_matches_pallas_twopass(n, d, b, k):
    m, q, valid = _data(n, d, b, seed=n, lo=7, hi=5)
    s_j, r_j = _jax_topk("pallas_dense_topk_twopass", q, m, valid, k, "cosine")
    s_t, r_t = dense_topk_twopass(_t(q), _t(m), _t(valid), k, "cosine")
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    np.testing.assert_allclose(s_t.numpy(), s_j, atol=1e-5, rtol=1e-5)
    s_x, r_x = tdense.dense_topk(_t(q), _t(m), _t(valid), k, "cosine")
    assert torch.equal(r_t, r_x) and torch.equal(s_t, s_x)


@pytest.mark.parametrize("fn", [dense_topk_blockmax, dense_topk_twopass])
def test_topk_functions_dot_metric_short_corpus_and_euclidean(fn):
    rng = np.random.default_rng(1)
    m = rng.standard_normal((512, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    valid = np.ones(512, bool)
    s_t, r_t = fn(_t(q), _t(m), _t(valid), 9, "dot")
    s_x, r_x = tdense.dense_topk(_t(q), _t(m), _t(valid), 9, "dot")
    assert torch.equal(r_t, r_x) and torch.equal(s_t, s_x)
    # fewer valid rows than k: (-inf, -1) slots, as dense_topk
    few = np.zeros(512, bool)
    few[[3, 200, 400]] = True
    s_t, r_t = fn(_t(q), _t(m), _t(few), 5, "dot")
    s_x, r_x = tdense.dense_topk(_t(q), _t(m), _t(few), 5, "dot")
    assert torch.equal(r_t, r_x) and torch.equal(s_t, s_x)
    assert (r_t[:, 3:] == -1).all()
    with pytest.raises(InvalidConfigError):
        fn(torch.zeros((1, 8)), torch.zeros((16, 8)), torch.ones(16, dtype=torch.bool), 2, "euclidean")


def test_kernel_wrappers_check_and_dispatch():
    m, q, valid = _data(512, 16, 2, seed=3)
    before = (score_blockmax.launches, blockmax_only.launches)
    score_blockmax(_t(q), _t(m), _t(valid))
    blockmax_only(_t(q), _t(m), _t(valid))
    assert (score_blockmax.launches, blockmax_only.launches) == before  # the CPU runs the plain versions
    with pytest.raises(InvalidConfigError, match="float32"):
        score_blockmax(_t(q).double(), _t(m), _t(valid))
    with pytest.raises(InvalidConfigError, match="bool"):
        blockmax_only(_t(q), _t(m), _t(valid).int())
    with pytest.raises(InvalidConfigError, match="cpu or cuda"):
        score_blockmax(_t(q).to("meta"), _t(m).to("meta"), _t(valid).to("meta"))


# -- certified selection (dense_topk_approx) ----------------------------------


def test_dense_topk_approx_matches_jax_and_the_exact_path():
    """The data of tests/test_edges.py: random corpora with tombstones,
    then duplicated rows tying at the k boundary (fail closed)."""
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops import dense as jdense

    rng = np.random.default_rng(7)
    for n, d, bq, k in ((5000, 48, 6, 10), (1000, 32, 3, 50), (300, 16, 2, 7)):
        m = rng.standard_normal((n, d)).astype(np.float32)
        m /= np.linalg.norm(m, axis=1, keepdims=True)
        q = rng.standard_normal((bq, d)).astype(np.float32)
        valid = np.ones(n, bool)
        valid[n // 7: n // 5] = False
        js, jr, jok = jdense.dense_topk_approx(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), k)
        ts, tr, tok = tdense.dense_topk_approx(_t(q), _t(m), _t(valid), k)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
        s_c, r_c, fb = tdense.dense_topk_approx_checked(_t(q), _t(m), _t(valid), k)
        s_x, r_x = tdense.dense_topk(_t(q), _t(m), _t(valid), k)
        assert torch.equal(r_c, r_x) and torch.equal(s_c, s_x)
        assert fb == (not bool(tok.all()))

    m = rng.standard_normal((1000, 24)).astype(np.float32)
    m[400:420] = m[0]
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = m[0][None, :].copy()
    valid = np.ones(1000, bool)
    _, _, jok = jdense.dense_topk_approx(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), 5)
    _, _, tok = tdense.dense_topk_approx(_t(q), _t(m), _t(valid), 5)
    assert not bool(np.asarray(jok).all()) and not bool(tok.all())  # ties defeat the certificate
    s_c, r_c, fb = tdense.dense_topk_approx_checked(_t(q), _t(m), _t(valid), 5)
    assert fb
    _, jr_x = jdense.dense_topk(jnp.asarray(q), jnp.asarray(m), jnp.asarray(valid), 5)
    np.testing.assert_array_equal(r_c.numpy(), np.asarray(jr_x))


def test_blockwise_topk_approx_thresholds():
    """thr1 and thr2 are the maxima of what was not selected: a gap above
    them certifies; an exact tie at the boundary does not."""
    scores = torch.full((2, 300), float("-inf"))
    scores[0, [5, 150, 299]] = torch.tensor([0.9, 0.8, 0.1])
    scores[1, [5, 150, 299]] = torch.tensor([0.9, 0.8, 0.8])
    s, r, ok = tdense.blockwise_topk_approx(scores, 2)
    assert r.tolist() == [[5, 150], [5, 150]]
    assert ok.tolist() == [True, False]
    s, r, ok = tdense.blockwise_topk_approx(scores, 5)  # more than the live rows
    assert ok.all() and r[0, 3:].tolist() == [-1, -1]


def test_bf16_matrix_scores_accumulate_in_f32(monkeypatch):
    """A bf16 corpus scores as its f32 widening, slab by slab."""
    monkeypatch.setattr(tdense, "_SLAB_ROWS", 100)
    m, q, _ = _data(450, 20, 3, seed=4)
    mb = _t(m).to(torch.bfloat16)
    for metric in ("cosine", "dot", "euclidean"):
        got = tdense.similarity_scores(_t(q), mb, metric)
        want = tdense.similarity_scores(_t(q), mb.float(), metric)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# -- on the card -----------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    tdense.require_fp32()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b", [
    (65536, 384, 200), (65500, 100, 200),  # the top-k functions' shapes
    (65536, 384, 256), (65536, 384, 1), (65500, 384, 65), (65531, 100, 129),  # query tiles of 128, ragged
    (1000, 1, 256), (130, 384, 129), (4100, 100, 1), (384, 384, 65),  # N ragged to the 128-row block, N % 4
])
def test_cuda_k2_matches_plain_version(n, d, b):
    """On the card: K2 and K2b against their plain versions (scores within
    2(d+1)·2⁻²⁴ for unit vectors: f32 sums in other orders; -inf where the
    plain version has it; K2's maxima exactly the max of its own scores;
    K2b's equal to K2's), and both top-k functions equal to dense_topk.
    B crosses the 128-query tile's edge; N leaves a ragged last block, with
    N % 4 != 0 taking the scalar score stores; d = 100 reads unaligned rows
    byte by byte and d = 1 is one column; whole 128-row blocks are masked."""
    _cuda_or_skip()
    m, q, valid = _data(n, d, b, seed=d + b)
    valid[128:256] = False  # a masked block (or, at n = 130, a masked ragged tail)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qt, mt, vt = _t(q).cuda(), _t(m).cuda(), _t(valid).cuda()
    before = (score_blockmax.launches, blockmax_only.launches)
    s, bm = score_blockmax(qt, mt, vt)
    bm2 = blockmax_only(qt, mt, vt)
    torch.cuda.synchronize()
    assert (score_blockmax.launches, blockmax_only.launches) == (before[0] + 1, before[1] + 1)
    s_r, _ = score_blockmax_reference(qt, mt, vt)
    assert torch.equal(torch.isneginf(s), torch.isneginf(s_r))
    fin = torch.isfinite(s_r)
    assert (s[fin] - s_r[fin]).abs().max().item() <= 2 * (d + 1) * 2.0**-24
    pad = -n % 128
    sp = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    assert torch.equal(bm, sp.view(b, -1, 128).amax(dim=2))
    assert torch.equal(bm2, bm)
    if n > 256:
        assert bool(torch.isneginf(bm[:, 1]).all())  # the masked block
    if d == 1:
        return  # one column: every score is ±|q|, and top-k order is a tie order, not the kernel's
    s_x, r_x = tdense.dense_topk(qt, mt, vt, 10, "cosine")
    for fn in (dense_topk_blockmax, dense_topk_twopass):
        s_t, r_t = fn(qt, mt, vt, 10, "cosine")
        assert torch.equal(r_t, r_x) and torch.equal(s_t, s_x)
