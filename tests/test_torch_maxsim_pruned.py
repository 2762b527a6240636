"""The centroid-pruned MaxSim tier of the port — ``_kmeans_tokens_device``,
``prepare_maxsim_bounds`` (K centroids per chunk with covering radii) and
``maxsim_topk_pruned`` (the bound ``Σᵢ max_g (⟨qᵢ,c_g⟩ + ‖qᵢ‖·r_g)``, then
the shared rescore-and-certify tail) — against the JAX package on the same
numpy inputs and against a float64 oracle.

Tolerances, and why:
- k-means centroids and bounds on well-separated tokens: rtol 1e-5. The
  assignments agree (no score sits near a tie), the centroid sums run in
  another f32 order, and the radii come from float64 distances cast once.
- ``maxsim_topk_pruned`` fed the JAX package's own ``btok/brad/bmask`` (so
  the bound is held apart from the k-means): the same rows and certified
  flags, scores rtol 1e-6 (the port rescores in float64 rounded once, the
  JAX package in f32).
- Soundness is exact: every stored token lies within its group's radius,
  checked in float64, and every certified answer equals the float64 exact
  top-k."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import maxsim as pm


def build(n, lt, h, b, lq, seed, ragged=True, tombstones=True):
    """The JAX package's test data: unit tokens, ragged masks (some chunks
    empty), unit queries with padding tokens, tombstones."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((n, lt, h)).astype(np.float32)
    tokens /= np.linalg.norm(tokens, axis=2, keepdims=True)
    if ragged:
        lens = rng.integers(0, lt + 1, size=n)
        t_mask = np.arange(lt)[None, :] < lens[:, None]
    else:
        t_mask = np.ones((n, lt), bool)
    q = rng.standard_normal((b, lq, h)).astype(np.float32)
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    q_mask = np.arange(lq)[None, :] < rng.integers(1, lq + 1, size=b)[:, None]
    valid = np.ones(n, bool)
    if tombstones:
        valid[n // 7: n // 5] = False
    return tokens, t_mask, q, q_mask, valid


def separated(n, lt, h, seed, topics=4, noise=0.02):
    """Each chunk's tokens near at most ``topics`` unit directions of its
    own, ragged masks with an empty chunk: clusters far apart, so no
    assignment sits near a tie."""
    rng = np.random.default_rng(seed)
    cen = rng.standard_normal((n, topics, h)).astype(np.float32)
    cen /= np.linalg.norm(cen, axis=2, keepdims=True)
    pick = rng.integers(0, topics, size=(n, lt))
    tok = np.take_along_axis(cen, pick[:, :, None], axis=1) + noise * rng.standard_normal((n, lt, h)).astype(
        np.float32)
    tok /= np.linalg.norm(tok, axis=2, keepdims=True)
    tm = np.arange(lt)[None, :] < rng.integers(1, lt + 1, size=n)[:, None]
    tm[2] = False
    return tok.astype(np.float32), tm


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax():
    return pytest.importorskip("jax.numpy")


def _covered(tok, tm, btok, brad, bmask):
    """Every valid token within some valid group's radius, in float64."""
    d = np.linalg.norm(tok[:, :, None, :].astype(np.float64) - btok[:, None, :, :].astype(np.float64), axis=3)
    covered = (d <= brad[:, None, :].astype(np.float64)) & bmask[:, None, :]
    return bool(covered.any(axis=2)[tm].all())


def _oracle64(q, qm, tokens, t_mask, valid, k):
    """float64 MaxSim top-k rounded to f32 once, (score desc, row asc)."""
    sims = np.einsum("bqh,nth->bqnt", q.astype(np.float64), tokens.astype(np.float64))
    sims = np.where(t_mask[None, None], sims, -np.inf)
    best = sims.max(axis=3)
    best = np.where(qm[:, :, None] & np.isfinite(best), best, 0.0)
    s = np.where(valid[None, :], best.sum(axis=1), -np.inf).astype(np.float32)
    rows = np.stack([np.lexsort((np.arange(s.shape[1]), -s[i]))[:k] for i in range(s.shape[0])])
    top = np.take_along_axis(s, rows, axis=1)
    return top, np.where(np.isneginf(top), -1, rows)


# ---------------------------------------------------------------------------
# the covering radii: sound whatever the k-means found
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from([1, 3, 8]))
def test_every_token_lies_within_its_radius(seed, k_bound):
    """Random widths, scales, duplicate tokens and chunks, empty chunks:
    every valid token is covered, masked groups carry zero centroid and
    radius."""
    rng = np.random.default_rng(seed)
    n, lt, h = int(rng.integers(1, 60)), int(rng.integers(1, 10)), int(rng.integers(2, 40))
    tok = (rng.standard_normal((n, lt, h)) * rng.choice([1e-3, 1.0, 50.0])).astype(np.float32)
    if lt > 2:
        tok[:, 1] = tok[:, 0]  # duplicate tokens inside every chunk
    if n > 2:
        tok[1] = tok[0]  # a duplicate chunk
    tm = rng.random((n, lt)) < 0.7
    tm[0] = False  # an empty chunk
    btok, brad, bmask = (x.numpy() for x in pm.prepare_maxsim_bounds(*_t(tok, tm), k_bound=k_bound, slab=16))
    assert btok.shape == (n, min(k_bound, lt), h) and brad.dtype == np.float32
    assert _covered(tok, tm, btok, brad, bmask)
    assert (brad[~bmask] == 0).all() and (btok[~bmask] == 0).all() and not bmask[0].any()
    assert (bmask.any(axis=1) == tm.any(axis=1)).all()


def test_numpy_bounds_input_raises_without_cuda(monkeypatch):
    """Numpy input goes to the port's default device, the card: without one
    the call raises instead of running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok, tm, _, _, _ = build(40, 5, 16, 1, 1, seed=5)
    with pytest.raises(InvalidConfigError, match="device='cpu'"):
        pm.prepare_maxsim_bounds(tok, tm)
    assert all(x.device.type == "cpu" for x in pm.prepare_maxsim_bounds(*_t(tok, tm)))


@pytest.mark.cuda
def test_numpy_bounds_input_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (numpy input runs on the card)")
    tok, tm, _, _, _ = build(300, 7, 24, 1, 1, seed=6)
    on_card = pm.prepare_maxsim_bounds(tok, tm, k_bound=3)
    assert all(x.is_cuda for x in on_card)
    btok, brad, bmask = (x.cpu().numpy() for x in on_card)
    assert _covered(tok, tm, btok, brad, bmask)
    assert (bmask.any(axis=1) == tm.any(axis=1)).all()


@pytest.mark.parametrize("k_bound", [1, 3, 8])
def test_bounds_cover_bf16_stored_tokens(k_bound):
    """bf16 storage: the stored values are the f32 upcast, and they are
    what the radii cover."""
    tok, tm, _, _, _ = build(200, 7, 24, 1, 1, seed=3)
    tok16 = torch.from_numpy(tok).to(torch.bfloat16)
    btok, brad, bmask = (x.numpy() for x in pm.prepare_maxsim_bounds(tok16, torch.from_numpy(tm), k_bound=k_bound))
    assert _covered(tok16.float().numpy(), tm, btok, brad, bmask)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_bound,iters", [(4, 8), (8, 3), (1, 2)])
def test_kmeans_and_bounds_match_jax(k_bound, iters):
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    tok, tm = separated(300, 12, 32, seed=k_bound + iters)
    cent = pm._kmeans_tokens_device(*_t(tok, tm), k_bound, iters).numpy()
    want = np.asarray(jm._kmeans_tokens_device(jnp.asarray(tok), jnp.asarray(tm), k_bound, iters))
    np.testing.assert_allclose(cent, want, rtol=1e-5, atol=1e-6)
    got = [x.numpy() for x in pm.prepare_maxsim_bounds(*_t(tok, tm), k_bound=k_bound, iters=iters, slab=128)]
    jb = jm.prepare_maxsim_bounds(tok, tm, k_bound=k_bound, iters=iters, slab=128)
    np.testing.assert_array_equal(got[2], jb[2])
    np.testing.assert_allclose(got[0], jb[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1], jb[1], rtol=1e-5, atol=1e-6)
    assert _covered(tok, tm, *got)


def _pruned_both(q, qm, tok, tm, valid, k, rescore, select="auto", bounds=None):
    """The port's and the JAX package's ``maxsim_topk_pruned`` on the JAX
    package's bounds → (port results, JAX results) as numpy."""
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    if bounds is None:
        bounds = jm.prepare_maxsim_bounds(tok, tm)
    j = jm.maxsim_topk_pruned(*(jnp.asarray(x) for x in (q, qm, tok, tm, *bounds, valid)), k, rescore,
                              select=select)
    p = pm.maxsim_topk_pruned(*_t(q, qm, tok, tm, *bounds, valid), k, rescore, select=select)
    return [x.numpy() for x in p], [np.asarray(x) for x in j]


def _same(p, j):
    (s, r, c), (js, jr, jc) = p, j
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(r, jr)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], js[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("select", ["auto", "approx"])
@pytest.mark.parametrize("n,lt,h,b,lq,k,rescore", [
    (400, 6, 32, 4, 5, 8, 64),
    (150, 4, 16, 3, 3, 5, 16),
    (50, 3, 8, 2, 2, 10, 64),  # rescore > n, k close to n
])
def test_pruned_matches_jax_and_certified_is_exact(n, lt, h, b, lq, k, rescore, select):
    """The JAX package's parametrization: rows, scores and certified flags
    equal to the JAX package's on its own bounds; every certified answer
    equal to the float64 exact top-k; the port's own bounds certify too."""
    tok, tm, q, qm, valid = build(n, lt, h, b, lq, seed=n + 1)
    p, j = _pruned_both(q, qm, tok, tm, valid, k, rescore, select)
    _same(p, j)
    s, r, cert = p
    o_s, o_r = _oracle64(q, qm, tok, tm, valid, k)
    assert cert.any()
    for i in np.flatnonzero(cert):
        np.testing.assert_array_equal(r[i], o_r[i])
        np.testing.assert_array_equal(s[i], o_s[i])
    own = pm.prepare_maxsim_bounds(*_t(tok, tm))
    s2, r2, c2 = (x.numpy() for x in pm.maxsim_topk_pruned(*_t(q, qm, tok, tm), *own, torch.from_numpy(valid), k,
                                                           rescore, select=select))
    assert c2.any()
    for i in np.flatnonzero(c2):
        np.testing.assert_array_equal(r2[i], o_r[i])


@pytest.mark.parametrize("select", ["exact", "approx"])
def test_pruned_short_corpus_certifies_truncated_results(select):
    """Fewer valid chunks than k: nothing is excluded, so the result is
    certified with -1 padding, as in the JAX package."""
    tok, tm, q, qm, _ = build(6, 3, 8, 2, 2, seed=9, tombstones=False)
    valid = np.array([True, True, True, False, False, False])
    p, j = _pruned_both(q, qm, tok, tm, valid, 5, 8, select)
    _same(p, j)
    _, r, cert = p
    assert cert.all() and (r[:, 3:] == -1).all() and set(r[0, :3]) == {0, 1, 2}


def test_pruned_rescore_below_k_and_unknown_select_are_rejected():
    tok, tm, q, qm, valid = build(20, 2, 8, 1, 1, seed=1)
    bounds = pm.prepare_maxsim_bounds(*_t(tok, tm))
    with pytest.raises(InvalidConfigError):
        pm.maxsim_topk_pruned(*_t(q, qm, tok, tm), *bounds, torch.from_numpy(valid), 8, 4)
    with pytest.raises(InvalidConfigError):
        pm.maxsim_topk_pruned(*_t(q, qm, tok, tm), *bounds, torch.from_numpy(valid), 2, 8, select="nonsense")


@pytest.mark.parametrize("select", ["exact", "approx"])
def test_pruned_tight_rescore_stays_sound(select):
    """Concentrated chunks and a rescore budget of k: bounds overlap, some
    queries stay uncertified, and none is certified wrong (the JAX
    package's case), on the port's own bounds."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1, 1, 24)).astype(np.float32)
    tok = base + 0.01 * rng.standard_normal((500, 4, 24)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=2, keepdims=True)
    tm, valid = np.ones((500, 4), bool), np.ones(500, bool)
    q = rng.standard_normal((6, 3, 24)).astype(np.float32)
    qm = np.ones((6, 3), bool)
    bounds = pm.prepare_maxsim_bounds(*_t(tok, tm))
    _, r, cert = (x.numpy() for x in pm.maxsim_topk_pruned(*_t(q, qm, tok, tm), *bounds, torch.from_numpy(valid), 10,
                                                           10, select=select))
    _, o_r = _oracle64(q, qm, tok, tm, valid, 10)
    for i in np.flatnonzero(cert):
        np.testing.assert_array_equal(r[i], o_r[i])


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 12), st.integers(8, 40), st.sampled_from(["exact", "approx"]))
def test_pruned_certificate_fail_closed_property(seed, k, rescore, select):
    """Arbitrary data (duplicates, empties, tombstones, scales from 1e-3
    to 50): every certified query's rows equal the float64 oracle's."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(k, 120))
    lt, h = int(rng.integers(1, 6)), int(rng.integers(4, 24))
    b, lq = int(rng.integers(1, 4)), int(rng.integers(1, 5))
    rescore = max(rescore, k)
    tok = (rng.standard_normal((n, lt, h)) * rng.choice([1e-3, 1.0, 50.0])).astype(np.float32)
    if n > 3 and bool(rng.integers(0, 2)):
        tok[1] = tok[0]
    tm = rng.random((n, lt)) < 0.8
    q = rng.standard_normal((b, lq, h)).astype(np.float32)
    qm = rng.random((b, lq)) < 0.9
    qm[:, 0] = True
    valid = rng.random(n) < 0.9
    bounds = pm.prepare_maxsim_bounds(*_t(tok, tm))
    _, r, cert = (x.numpy() for x in pm.maxsim_topk_pruned(*_t(q, qm, tok, tm), *bounds, torch.from_numpy(valid), k,
                                                           rescore, select=select))
    _, o_r = _oracle64(q, qm, tok, tm, valid, k)
    for i in np.flatnonzero(cert):
        np.testing.assert_array_equal(r[i], o_r[i])
