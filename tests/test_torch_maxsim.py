"""The late-interaction ops of the port against the JAX package on the same
numpy inputs: K6's and K7's plain versions against the Pallas kernels in
interpret mode, the packs and the query-side bound math, every tier, the
token-pruned and exact scans, and (on a card only) the CUDA kernels
against their plain versions.

Shapes are small but awkward: N ≈ 300 with a ragged tail, Lt = 20 (no
multiple of 32), H = 64, B = 3, Lq = 5 with padding query tokens, empty
and tombstoned chunks."""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import maxsim as pm
from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import (
    _k6_program,
    maxsim_scan16_scores,
    maxsim_scan16_scores_reference,
    maxsim_scan_int8_scores,
    maxsim_scan_int8_scores_reference,
)

EPS23 = 2.0**-23
# port and JAX sum the same f32 products in other orders: ≤ ~(H+Lq)·2⁻²⁴
# relative to the score's magnitude (≤ Lq for unit tokens)
SCORE_TOL = 1e-5


def build(n=301, lt=20, h=64, b=3, lq=5, seed=0, structured=False):
    """Unit tokens (topic-clustered when ``structured``), ragged token
    masks with some empty chunks, tombstones, padded query tokens."""
    rng = np.random.default_rng(seed)
    if structured:
        topics = rng.standard_normal((32, h)).astype(np.float32)
        tok = topics[rng.integers(0, 32, size=(n, lt))] + 0.15 * rng.standard_normal((n, lt, h)).astype(np.float32)
        q = topics[rng.integers(0, 32, size=(b, lq))] + 0.15 * rng.standard_normal((b, lq, h)).astype(np.float32)
    else:
        tok = rng.standard_normal((n, lt, h)).astype(np.float32)
        q = rng.standard_normal((b, lq, h)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=2, keepdims=True)
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    lens = rng.integers(0 if not structured else 1, lt + 1, size=n)
    t_mask = np.arange(lt)[None, :] < lens[:, None]
    t_mask[5] = False  # an empty chunk, valid
    q_mask = np.arange(lq)[None, :] < rng.integers(min(2, lq), lq + 1, size=b)[:, None]
    q_mask[0] = True
    valid = np.ones(n, bool)
    valid[n // 7:n // 5] = False
    return tok.astype(np.float32), t_mask, q.astype(np.float32), q_mask, valid


def T(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    return jnp


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _oracle64(q, qm, tokens, t_mask, valid, k):
    """float64 MaxSim top-k of the stored values, rounded to f32 once:
    the port's exact scan by definition."""
    sims = np.einsum("bqh,nth->bqnt", q.astype(np.float64), tokens.astype(np.float64))
    sims = np.where(t_mask[None, None], sims, -np.inf)
    best = sims.max(axis=3)
    best = np.where(qm[:, :, None] & np.isfinite(best), best, 0.0)
    s = np.where(valid[None, :], best.sum(axis=1), -np.inf).astype(np.float32)
    rows = np.stack([np.lexsort((np.arange(s.shape[1]), -s[i]))[:k] for i in range(s.shape[0])])
    top = np.take_along_axis(s, rows, axis=1)
    return top, np.where(np.isneginf(top), -1, rows)


# ---------------------------------------------------------------------------
# K6 / K7 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(301, 20, 64, 3, 5), (130, 7, 16, 2, 9), (40, 3, 8, 1, 70)],
                         ids=["ragged", "lt7", "lq70"])
def test_k6_plain_matches_jax_kernel(shape):
    """Within 2·κ·C1·n_max per entry: each of the two f32 programs may use
    one κ = (H+Lq)·2⁻²³ share of its dot-and-sum rounding."""
    jnp = _jax()
    from trueno_rag_tpu.ops.pallas.maxsim_scan import maxsim_scan16_scores as jax_k6

    n, lt, h, b, lq = shape
    tok, tm, q, qm, valid = build(n, lt, h, b, lq, seed=n)
    q16 = np.where(qm[:, :, None], q, 0.0).astype(np.float32)
    want = np.asarray(jax_k6(jnp.asarray(q16).astype(jnp.bfloat16), jnp.asarray(tok).astype(jnp.bfloat16),
                             jnp.asarray(tm), jnp.asarray(valid), interpret=True))
    q16t, tokt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q16, tok))
    got = maxsim_scan16_scores_reference(q16t, tokt, *T(tm, valid)).numpy()
    assert got.shape == (b, n)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[:, ~valid]).all() and np.isfinite(got[:, valid]).all()
    c1 = np.linalg.norm(_bf16(q16), axis=2).sum(axis=1)  # [B]
    n_max = np.where(tm, np.linalg.norm(_bf16(tok), axis=2), 0.0).max(axis=1)  # [N]
    tol = 2 * (h + lq) * EPS23 * c1[:, None] * n_max[None, :] + 1e-7
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()
    # the wrapper takes the plain version on the CPU
    before = maxsim_scan16_scores.launches
    np.testing.assert_array_equal(maxsim_scan16_scores(q16t, tokt, *T(tm, valid)).numpy(), got)
    assert maxsim_scan16_scores.launches == before


def _int8_inputs(shape, seed):
    n, lt, h, b, lq = shape
    tok, tm, q, qm, valid = build(n, lt, h, b, lq, seed=seed)
    tok8, s_tok, _, _ = pm.prepare_maxsim_int8(*T(tok, tm))
    _, q8, t_q, _, _, _ = pm._int8_query_pack(*T(q, qm))
    return q8, t_q, tok8, s_tok, tm, valid


@pytest.mark.parametrize("shape", [(301, 20, 64, 3, 5), (130, 7, 16, 2, 9), (301, 20, 384, 3, 5), (130, 7, 33, 2, 9)],
                         ids=["ragged", "lt7", "h384", "h33"])
def test_k7_plain_matches_jax_kernel(shape):
    """Within f32 rounding of the Lq-sum: the Pallas kernel sums
    ``Σᵢ t_qᵢ·bestᵢ`` as a selection matmul in its own order, the port in
    ascending i, so they may differ by Lq·2⁻²⁴·Σᵢ|t_qᵢ·bestᵢ|; the integer
    dot and the token-scale multiply are exact or rounded once alike."""
    jnp = _jax()
    from trueno_rag_tpu.ops.pallas.maxsim_scan import maxsim_scan_int8_scores as jax_k7

    q8, t_q, tok8, s_tok, tm, valid = _int8_inputs(shape, shape[0] + 1)
    want = np.asarray(jax_k7(*(jnp.asarray(x.numpy()) for x in (q8, t_q, tok8, s_tok)), jnp.asarray(tm),
                             jnp.asarray(valid), interpret=True))
    got = maxsim_scan_int8_scores_reference(q8, t_q, tok8, s_tok, *T(tm, valid)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    # the magnitude Σᵢ |t_qᵢ·bestᵢ| in float64
    dots = np.einsum("bqh,nth->bqnt", q8.numpy().astype(np.int64), tok8.numpy().astype(np.int64))
    sims = np.where(tm[None, None], dots.astype(np.float32) * s_tok.numpy()[None, None], -np.inf)
    best = sims.max(axis=3)
    best = np.where(np.isfinite(best), best, 0.0)
    mag = np.abs(t_q.numpy()[:, :, None].astype(np.float64) * best).sum(axis=1)
    fin = np.isfinite(want)
    assert (np.abs(got[fin] - want[fin]) <= (shape[4] * 2.0**-24 * mag)[fin]).all()


def test_k7_plain_follows_the_fixed_order_bit_for_bit():
    """The plain version is ``f32(dot)·s_tok``, the masked max, then
    ``s = s + t_qᵢ·bestᵢ`` over i ascending, each step rounded to f32 —
    the order the CUDA kernel follows, so the two agree bit for bit."""
    q8, t_q, tok8, s_tok, tm, valid = _int8_inputs((301, 20, 64, 3, 5), 3)
    got = maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, *T(tm, valid)).numpy()
    dots = np.einsum("bqh,nth->bqnt", q8.numpy().astype(np.int64), tok8.numpy().astype(np.int64))
    sims = np.where(tm[None, None], dots.astype(np.float32) * s_tok.numpy()[None, None], -np.inf)
    best = sims.max(axis=3)
    best = np.where(np.isfinite(best), best, np.float32(0.0)).astype(np.float32)
    s = np.zeros(best.shape[::2], np.float32)
    for i in range(best.shape[1]):
        s = (s + (t_q.numpy()[:, i, None] * best[:, i, :]).astype(np.float32)).astype(np.float32)
    want = np.where(valid[None, :], s, -np.inf).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,program", [(1, "cp.async"), (8, "wgmma"), (15, "cp.async"), (16, "wgmma"),
                                       (100, "cp.async"), (128, "wgmma"), (384, "wgmma"), (520, "wgmma")])
def test_k6_program_follows_the_width(h, program):
    """K6 runs its wgmma program wherever rows are 16-byte aligned (H a
    multiple of 8, which TMA needs) and its cp.async program elsewhere."""
    assert _k6_program(h) == program


def test_kernel_wrappers_check_their_inputs():
    q8, t_q, tok8, s_tok, tm, valid = _int8_inputs((40, 4, 16, 2, 3), 1)
    tm_t, v_t = T(tm, valid)
    with pytest.raises(InvalidConfigError):
        maxsim_scan_int8_scores(q8, t_q, tok8, s_tok[:, :2], tm_t, v_t)
    with pytest.raises(InvalidConfigError):
        maxsim_scan_int8_scores(q8.float(), t_q, tok8, s_tok, tm_t, v_t)
    with pytest.raises(InvalidConfigError):
        maxsim_scan16_scores(q8.to(torch.bfloat16), tok8.to(torch.bfloat16), tm_t.int(), v_t)
    with pytest.raises(InvalidConfigError):
        maxsim_scan16_scores(q8.to(torch.bfloat16), tok8.to(torch.bfloat16)[:, :, :8], tm_t, v_t)


# ---------------------------------------------------------------------------
# packs and query-side bound math
# ---------------------------------------------------------------------------


def test_packs_match_jax():
    """The bf16 and int8 replicas equal the JAX package's bit for bit; the
    residual and norm bounds agree to f32 rounding and cover every valid
    token's float64 residual and norm."""
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    tok, tm, _, _, _ = build(seed=4)
    tok16, e16, n16 = (x.float().numpy() for x in pm.prepare_maxsim_scan16(*T(tok, tm), slab=64))
    j16 = jm.prepare_maxsim_scan16(jnp.asarray(tok), jnp.asarray(tm), slab=64)
    np.testing.assert_array_equal(tok16, np.asarray(j16[0]).astype(np.float32))
    np.testing.assert_allclose(e16, np.asarray(j16[1]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(n16, np.asarray(j16[2]), rtol=1e-6, atol=0)
    tok8, s_tok, e8, n8 = (x.numpy() for x in pm.prepare_maxsim_int8(*T(tok, tm), slab=100))
    j8 = jm.prepare_maxsim_int8(jnp.asarray(tok), jnp.asarray(tm), slab=100)
    np.testing.assert_array_equal(tok8, np.asarray(j8[0]))
    np.testing.assert_array_equal(s_tok, np.asarray(j8[1]))
    np.testing.assert_allclose(e8, np.asarray(j8[2]), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(n8, np.asarray(j8[3]), rtol=1e-6, atol=0)

    t64 = tok.astype(np.float64)
    for a, e_max, n_max in ((tok16.astype(np.float64), e16, n16),
                            (tok8.astype(np.float64) * s_tok[:, :, None], e8, n8)):
        e_l2 = np.linalg.norm(t64 - a, axis=2)
        a_l2 = np.linalg.norm(a, axis=2)
        assert (np.where(tm, e_l2, 0).max(axis=1) <= e_max).all()
        assert (np.where(tm, a_l2 + e_l2, 0).max(axis=1) <= n_max * (1 + 1e-6)).all()
    assert (e16[tm.any(axis=1)] > 0).all()  # the residual is real: no folded round trip

    b16 = torch.from_numpy(tok).to(torch.bfloat16)
    e_s, n_s = pm.prepare_maxsim_self16(b16, torch.from_numpy(tm), slab=50)
    je, jn = jm.prepare_maxsim_self16(jnp.asarray(tok).astype(jnp.bfloat16), jnp.asarray(tm), slab=50)
    assert not e_s.any() and not np.asarray(je).any()
    np.testing.assert_allclose(n_s.numpy(), np.asarray(jn), rtol=1e-6, atol=0)
    with pytest.raises(InvalidConfigError):
        pm.prepare_maxsim_self16(*T(tok, tm))


def test_query_packs_match_jax():
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    tok, tm, q, qm, _ = build(seed=5)
    qt, qmt = T(q, qm)
    got = pm._scan16_query_pack(qt, qmt)
    want = jm._scan16_query_pack(jnp.asarray(q), jnp.asarray(qm))
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want[0]).astype(np.float32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert (got[1].numpy() > 0).all()  # the query residual is real
    _, e_max, n_max = pm.prepare_maxsim_scan16(*T(tok, tm))
    w = pm._scan16_fused_widths(*got[1:], e_max, n_max, 64, 5).numpy()
    jw = np.asarray(jm._scan16_fused_widths(*want[1:], jnp.asarray(e_max.numpy()), jnp.asarray(n_max.numpy()),
                                            64, 5))
    np.testing.assert_allclose(w, jw, rtol=1e-6)
    _, qn_w = pm._widened_query_norms(qt, qmt)
    np.testing.assert_allclose(qn_w.numpy(), np.asarray(jm._widened_query_norms(*(jnp.asarray(x) for x in
                                                                                  (q, qm)))[1]), rtol=1e-6)
    assert pm._tier_rounding_coeff(5, 64) == pytest.approx(float(jm._tier_rounding_coeff(5, 64)), rel=1e-7)


# ---------------------------------------------------------------------------
# tiers and scans
# ---------------------------------------------------------------------------


def _port_tier(name, tok, tm, q, qm, valid, k, rescore, select="auto"):
    qt, qmt, tokt, tmt, vt = T(q, qm, tok, tm, valid)
    if name == "exact":
        s, r = pm.maxsim_scan_topk(qt, qmt, tokt, tmt, vt, k, block=64)
        return s, r, torch.ones(q.shape[0], dtype=torch.bool)
    if name == "token":
        return pm.maxsim_topk_token_pruned(qt, qmt, tokt, tmt, vt, k, t_hits=512, rescore=rescore)
    if name in ("scan16", "fused"):
        pack = pm.prepare_maxsim_scan16(tokt, tmt)
        if name == "scan16":  # the blockwise tier, at the JAX side's block
            return pm.maxsim_topk_scan16(qt, qmt, tokt, tmt, *pack, vt, k, rescore, 64, select)
        return pm.maxsim_topk_scan16_fused(qt, qmt, tokt, tmt, *pack, vt, k, rescore, select)
    if name == "self16":
        b16 = tokt.to(torch.bfloat16)
        return pm.maxsim_topk_scan16_fused(qt, qmt, b16, tmt, b16, *pm.prepare_maxsim_self16(b16, tmt), vt, k,
                                           rescore, select)
    pack = pm.prepare_maxsim_int8(tokt, tmt)
    if name == "int8_store":
        return pm.maxsim_topk_int8_store(qt, qmt, pack[0], pack[1], tmt, pack[3], vt, k, rescore, select)
    if name == "int8":
        return pm.maxsim_topk_int8(qt, qmt, tokt, tmt, *pack, vt, k, rescore, 64, select)
    return pm.maxsim_topk_int8_fused(qt, qmt, tokt, tmt, *pack, vt, k, rescore, select)


def _jax_tier(name, tok, tm, q, qm, valid, k, rescore, select="auto"):
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    qd, qmd, td, tmd, vd = (jnp.asarray(x) for x in (q, qm, tok, tm, valid))
    if name == "exact":
        s, r = jm.maxsim_scan_topk(qd, qmd, td, tmd, vd, k, 64)
        return s, r, np.ones(q.shape[0], bool)
    if name == "token":
        return jm.maxsim_topk_token_pruned(qd, qmd, td, tmd, vd, k, t_hits=512, rescore=rescore)
    if name in ("scan16", "fused"):
        pack = jm.prepare_maxsim_scan16(td, tmd)
        if name == "scan16":
            return jm.maxsim_topk_scan16(qd, qmd, td, tmd, *pack, vd, k, rescore, 64, select=select)
        return jm.maxsim_topk_scan16_fused(qd, qmd, td, tmd, *pack, vd, k, rescore, interpret=True, select=select)
    if name == "self16":
        b16 = td.astype(jnp.bfloat16)
        return jm.maxsim_topk_scan16_fused(qd, qmd, b16, tmd, b16, *jm.prepare_maxsim_self16(b16, tmd), vd, k,
                                           rescore, interpret=True, select=select)
    pack = jm.prepare_maxsim_int8(td, tmd)
    if name == "int8_store":
        return jm.maxsim_topk_int8_store(qd, qmd, pack[0], pack[1], tmd, pack[3], vd, k, rescore, interpret=True,
                                         select=select)
    if name == "int8":
        return jm.maxsim_topk_int8(qd, qmd, td, tmd, *pack, vd, k, rescore, 64, select=select)
    return jm.maxsim_topk_int8_fused(qd, qmd, td, tmd, *pack, vd, k, rescore, interpret=True, select=select)


def _stored(name, tok, tm):
    """The stored values a tier's exactness is defined over."""
    if name == "self16":
        return _bf16(tok)
    if name == "int8_store":
        tok8, s_tok, _, _ = pm.prepare_maxsim_int8(*T(tok, tm))
        return (tok8.float() * s_tok[:, :, None]).numpy()
    return tok


TIERS = ["exact", "token", "scan16", "fused", "self16", "int8", "fused8", "int8_store"]


@pytest.mark.parametrize("name", TIERS)
@pytest.mark.parametrize("structured", [False, True], ids=["random", "structured"])
def test_tier_matches_jax_and_the_oracle(name, structured):
    """Every port-certified result equals the JAX package's oracle rows
    (``maxsim_scan_oracle``) and the float64 exact top-k of the stored
    values; where both packages certify, rows agree and scores agree to
    f32 rounding; the port certifies where the JAX package does."""
    k, rescore = 8, 64
    tok, tm, q, qm, valid = build(seed=21 + structured, structured=structured)
    stored = _stored(name, tok, tm)
    s, r, cert = (x.numpy() for x in _port_tier(name, tok, tm, q, qm, valid, k, rescore))
    js, jr, jcert = (np.asarray(x) for x in _jax_tier(name, tok, tm, q, qm, valid, k, rescore))
    _, o_r = pm.maxsim_scan_oracle(q, qm, stored, tm, valid, k)
    o64_s, o64_r = _oracle64(q, qm, stored, tm, valid, k)
    assert cert.any()
    for i in np.flatnonzero(cert):
        np.testing.assert_array_equal(r[i], o_r[i])
        np.testing.assert_array_equal(r[i], o64_r[i])
        np.testing.assert_array_equal(s[i], o64_s[i])  # scores: float64, rounded once
    both = cert & jcert
    assert both.sum() >= min(cert.sum(), jcert.sum()) - 1
    for i in np.flatnonzero(both):
        np.testing.assert_array_equal(r[i], jr[i])
        fin = np.isfinite(js[i])
        np.testing.assert_allclose(s[i][fin], js[i][fin], atol=SCORE_TOL, rtol=SCORE_TOL)


def test_exact_scan_conventions():
    """Ties go to the lower row; an empty chunk scores exactly 0 and
    outranks negative chunks; invalid chunks never appear; k beyond the
    valid rows pads with (-inf, -1)."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((1, 4, 16)).astype(np.float32)
    tokens = np.repeat(base, 6, axis=0)
    q = rng.standard_normal((2, 3, 16)).astype(np.float32)
    _, rows = pm.maxsim_scan_topk(*T(q, np.ones((2, 3), bool), tokens, np.ones((6, 4), bool), np.ones(6, bool)), 4)
    np.testing.assert_array_equal(rows.numpy(), [[0, 1, 2, 3]] * 2)

    tokens = np.zeros((3, 2, 8), np.float32)
    tokens[0, :, 0] = -1.0  # negative match
    tokens[2, 0, 0] = 1.0  # positive match
    t_mask = np.array([[True, True], [False, False], [True, False]])
    q = np.zeros((1, 1, 8), np.float32)
    q[0, 0, 0] = 1.0
    s, r = pm.maxsim_scan_topk(*T(q, np.ones((1, 1), bool), tokens, t_mask, np.array([True, True, False])), 5)
    np.testing.assert_array_equal(r.numpy(), [[1, 0, -1, -1, -1]])
    np.testing.assert_array_equal(s.numpy()[0, :2], [0.0, -1.0])
    assert np.isneginf(s.numpy()[0, 2:]).all()


@pytest.mark.parametrize("name", ["scan16", "fused", "int8", "fused8", "int8_store", "token"])
def test_short_corpus_certifies_truncated(name):
    tok, tm, q, qm, _ = build(6, 3, 16, 2, 2, seed=9)
    tm[:] = True
    valid = np.array([True, True, True, False, False, False])
    _, r, cert = (x.numpy() for x in _port_tier(name, tok, tm, q, qm, valid, 5, 8))
    assert cert.all()
    assert (r[:, 3:] == -1).all() and set(r[0, :3]) == {0, 1, 2}


def test_duplicate_chunks_fail_closed_or_exact():
    """Near-duplicate chunks sit inside one another's widening band: the
    certificate refuses or returns the exact rows."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1, 1, 24)).astype(np.float32)
    tok = base + 1e-4 * rng.standard_normal((300, 4, 24)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=2, keepdims=True)
    tm = np.ones((300, 4), bool)
    q = rng.standard_normal((4, 3, 24)).astype(np.float32)
    qm, valid = np.ones((4, 3), bool), np.ones(300, bool)
    _, o_r = _oracle64(q, qm, tok, tm, valid, 10)
    for name in ("scan16", "int8", "fused", "token"):
        _, r, cert = (x.numpy() for x in _port_tier(name, tok, tm, q, qm, valid, 10, 16))
        for i in np.flatnonzero(cert):
            np.testing.assert_array_equal(r[i], o_r[i])


@pytest.mark.parametrize("n", [200, 1000])
def test_exact_scan_preselection_widens_over_near_ties(n, monkeypatch):
    """Chunks whose scores lie within the f32 scan's rounding of one
    another: the preselection widens past ``2k`` until nothing left out
    can reach the top-k, and the answer is the float64 exact top-k."""
    rng = np.random.default_rng(n)
    base = rng.standard_normal((1, 4, 32)).astype(np.float32)
    tok = base + 1e-6 * rng.standard_normal((n, 4, 32)).astype(np.float32)
    tm, valid = np.ones((n, 4), bool), np.ones(n, bool)
    q = rng.standard_normal((2, 3, 32)).astype(np.float32)
    qm = np.ones((2, 3), bool)
    widths = []
    topk = pm.blockwise_topk
    monkeypatch.setattr(pm, "blockwise_topk", lambda s, k, *a: widths.append(k) or topk(s, k, *a))
    s, r = pm.maxsim_scan_topk(*T(q, qm, tok, tm, valid), 5, block=64)
    assert widths[0] == 11 and max(widths) > 11
    o_s, o_r = _oracle64(q, qm, tok, tm, valid, 5)
    np.testing.assert_array_equal(r.numpy(), o_r)
    np.testing.assert_array_equal(s.numpy(), o_s)


def test_exact_scan_preselection_stays_at_2k_on_clear_gaps(monkeypatch):
    tok, tm, q, qm, valid = build(seed=2)
    widths = []
    topk = pm.blockwise_topk
    monkeypatch.setattr(pm, "blockwise_topk", lambda s, k, *a: widths.append(k) or topk(s, k, *a))
    _, r = pm.maxsim_scan_topk(*T(q, qm, tok, tm, valid), 8, block=64)
    assert widths == [17]
    np.testing.assert_array_equal(r.numpy(), _oracle64(q, qm, tok, tm, valid, 8)[1])


def test_rescore_below_k_and_approx_select_are_rejected():
    """``rescore < k`` and an unknown select mode raise; ``approx`` answers
    (the JAX package's branch over an exact selector) with ``exact``'s rows
    and scores, and fails closed where the selection boundary is a tie:
    here the 8th to 15th bounds are the empty chunks' equal ``_BOUND_EPS``,
    which ``exact``'s (C+1)-th bound certifies past and the count trick
    cannot; ``auto`` is ``exact``."""
    tok, tm, q, qm, valid = build(20, 2, 8, 1, 1, seed=1)
    with pytest.raises(InvalidConfigError):
        _port_tier("fused", tok, tm, q, qm, valid, 8, 4)
    pack = pm.prepare_maxsim_scan16(*T(tok, tm))
    with pytest.raises(InvalidConfigError):
        pm.maxsim_topk_scan16_fused(*T(q, qm, tok, tm), *pack, torch.from_numpy(valid), 2, 8, select="nonsense")
    got = pm.maxsim_topk_scan16_fused(*T(q, qm, tok, tm), *pack, torch.from_numpy(valid), 2, 8, select="approx")
    want = pm.maxsim_topk_scan16_fused(*T(q, qm, tok, tm), *pack, torch.from_numpy(valid), 2, 8, select="exact")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(got[2][0]) and bool(want[2][0])
    assert pm._resolve_select("auto") == "exact" and pm._resolve_select("approx") == "approx"


@pytest.mark.parametrize("allowed", ["tags", "short"])
@pytest.mark.parametrize("name", ["fused", "self16", "fused8", "int8_store"])
def test_approx_select_matches_jax(name, allowed):
    """``select="approx"`` against the JAX package's approx branch on the
    CPU (where ``approx_max_k`` selects exactly): the same rows and
    certified flags, scores to f32 rounding, every certified answer the
    float64 exact top-k. ``tags``: a tag filter's ``valid`` passing about
    half the chunks; ``short``: 5 allowed chunks, fewer than k, which only
    the short-allowed-set rule (every finite bound selected) certifies."""
    k, rescore = 8, 64
    tok, tm, q, qm, valid = build(seed=31, structured=True)
    rng = np.random.default_rng(5)
    if allowed == "tags":
        valid &= rng.random(valid.shape[0]) < 0.5
    else:
        valid[:] = False
        valid[rng.choice(valid.shape[0], 5, replace=False)] = True
    s, r, cert = (x.numpy() for x in _port_tier(name, tok, tm, q, qm, valid, k, rescore, "approx"))
    js, jr, jcert = (np.asarray(x) for x in _jax_tier(name, tok, tm, q, qm, valid, k, rescore, "approx"))
    np.testing.assert_array_equal(cert, jcert)
    np.testing.assert_array_equal(r, jr)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], js[fin], atol=SCORE_TOL, rtol=SCORE_TOL)
    o64_s, o64_r = _oracle64(q, qm, _stored(name, tok, tm), tm, valid, k)
    assert cert.any() and (allowed == "tags" or cert.all())
    for i in np.flatnonzero(cert):
        np.testing.assert_array_equal(r[i], o64_r[i])
        np.testing.assert_array_equal(s[i], o64_s[i])


def test_pair_scores_are_float64_rounded_once():
    tok, tm, q, qm, _ = build(12, 5, 32, 2, 4, seed=3)
    cand = np.array([[0, 3, 5], [11, 2, 7]])
    got = pm.maxsim_pair_scores(*T(q, qm, tok[cand], tm[cand])).numpy()
    sims = np.einsum("bqh,bcth->bcqt", q.astype(np.float64), tok[cand].astype(np.float64))
    best = np.where(tm[cand][:, :, None, :], sims, -np.inf).max(axis=3)
    best = np.where(qm[:, None, :] & np.isfinite(best), best, 0.0)
    np.testing.assert_array_equal(got, best.sum(axis=2).astype(np.float32))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5000, 32, 128, 8, 8), (3001, 20, 64, 3, 5), (700, 7, 384, 5, 70)],
                         ids=["serving", "ragged", "lq70"])
def test_cuda_k6_matches_plain_version(shape):
    """K6 against its plain version within 2·κ·C1·n_max per entry."""
    _cuda_or_skip()
    n, lt, h, b, lq = shape
    tok, tm, q, qm, valid = build(n, lt, h, b, lq, seed=n)
    q16 = torch.from_numpy(np.where(qm[:, :, None], q, 0.0)).to(torch.bfloat16).cuda()
    tok16 = torch.from_numpy(tok).to(torch.bfloat16).cuda()
    tm_d, v_d = (x.cuda() for x in T(tm, valid))
    before = maxsim_scan16_scores.launches
    got = maxsim_scan16_scores(q16, tok16, tm_d, v_d)
    torch.cuda.synchronize()
    assert maxsim_scan16_scores.launches == before + 1
    want = maxsim_scan16_scores_reference(q16, tok16, tm_d, v_d)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    c1 = torch.linalg.vector_norm(q16.float(), dim=2).sum(dim=1)
    n_max = torch.where(tm_d, torch.linalg.vector_norm(tok16.float(), dim=2), 0.0).amax(dim=1)
    tol = 2 * (h + lq) * EPS23 * c1[:, None] * n_max[None, :] + 1e-7
    fin = torch.isfinite(want)
    assert bool(((got - want).abs()[fin] <= tol[fin]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5000, 32, 128, 8, 8), (3001, 20, 64, 3, 5), (700, 7, 384, 5, 70)],
                         ids=["serving", "ragged", "lq70"])
def test_cuda_k7_is_bit_identical_to_plain_version(shape):
    _cuda_or_skip()
    q8, t_q, tok8, s_tok, tm, valid = _int8_inputs(shape, 2)
    args = [x.cuda() for x in (q8, t_q, tok8, s_tok, *T(tm, valid))]
    before = maxsim_scan_int8_scores.launches
    got = maxsim_scan_int8_scores(*args)
    torch.cuda.synchronize()
    assert maxsim_scan_int8_scores.launches == before + 1
    assert torch.equal(got, maxsim_scan_int8_scores_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [15, 16, 17, 100, 520])
def test_cuda_k6_at_widths_around_the_mma_depth(h):
    """K6's tensor-core dot at widths below, at and past one 16-column mma
    slice, one no vector divides, and one whose query rows stream beside the
    tokens (past 512), over a ragged Lt: within 2·κ·C1·n_max of its plain
    version."""
    _cuda_or_skip()
    n, lt, b, lq = 2049, 13, 5, 9
    tok, tm, q, qm, valid = build(n, lt, h, b, lq, seed=h)
    q16 = torch.from_numpy(np.where(qm[:, :, None], q, 0.0)).to(torch.bfloat16).cuda()
    tok16 = torch.from_numpy(tok).to(torch.bfloat16).cuda()
    tm_d, v_d = (x.cuda() for x in T(tm, valid))
    before = maxsim_scan16_scores.launches
    got = maxsim_scan16_scores(q16, tok16, tm_d, v_d)
    torch.cuda.synchronize()
    assert maxsim_scan16_scores.launches == before + 1
    want = maxsim_scan16_scores_reference(q16, tok16, tm_d, v_d)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    c1 = torch.linalg.vector_norm(q16.float(), dim=2).sum(dim=1)
    n_max = torch.where(tm_d, torch.linalg.vector_norm(tok16.float(), dim=2), 0.0).amax(dim=1)
    tol = 2 * (h + lq) * EPS23 * c1[:, None] * n_max[None, :] + 1e-7
    fin = torch.isfinite(want)
    assert bool(((got - want).abs()[fin] <= tol[fin]).all())


def _k7_cuda_case(n, lt, h, b, lq, seed, masked_position=False):
    """K7 on the card against its plain version, bit for bit, on
    :func:`build`'s inputs (ragged Lt, an empty chunk, invalid chunks,
    padded query tokens); ``masked_position`` masks the last token position
    of every chunk."""
    _cuda_or_skip()
    q8, t_q, tok8, s_tok, tm, valid = _int8_inputs((n, lt, h, b, lq), seed)
    if masked_position:
        tm = tm.copy()
        tm[:, -1] = False
    args = [x.cuda() for x in (q8, t_q, tok8, s_tok, *T(tm, valid))]
    before = maxsim_scan_int8_scores.launches
    got = maxsim_scan_int8_scores(*args)
    torch.cuda.synchronize()
    assert maxsim_scan_int8_scores.launches == before + 1
    want = maxsim_scan_int8_scores_reference(*args)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [15, 16, 31, 32, 33, 100, 384, 520])
def test_cuda_k7_at_widths_around_the_mma_depth(h):
    """K7's s8 tensor-core dot (32 int8 of depth per mma) below, at and past
    one k32 slice, at a width no vector divides, at MiniLM's 384 and past
    the width whose query rows stay resident (512): bit-identical to its
    plain version, with a token position masked in every chunk."""
    _k7_cuda_case(2049, 13, h, 5, 9, seed=h, masked_position=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b, lq", [(32, 8), (8, 32), (3, 5)], ids=["b32-lq8", "b8-lq32", "b3-lq5"])
def test_cuda_k7_query_groups(b, lq):
    """B·Lq over several query groups (64 query-token rows per group):
    bit-identical to its plain version at a ragged Lt, with empty and
    invalid chunks."""
    _k7_cuda_case(1537, 20, 128, b, lq, seed=b * 100 + lq)
