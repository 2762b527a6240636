"""The l-major v2 MaxSim scans of the port — K11a ``maxsim_scan16_scores_v2``
over the l-major pack and K11b ``maxsim_scan16_scores_self_v2`` over the
primary tokens, the padding excluded by an additive bias — with their
packs ``prepare_maxsim_bias_l`` and ``prepare_maxsim_scan16_opt``, against
the JAX package on the same numpy inputs; and, on a card only, the CUDA
kernels against their plain versions and the bf16 scan K6.

Data as the JAX package's parity test has it (n = 600, Lt = 4, H = 32,
B = 3, Lq = 5, unit tokens, an empty chunk and an invalid chunk), plus a
ragged n = 601 with Lt = 3 (so the pack pads Lt to 4), at groups 128, 256
and 100 (no power of two).

Tolerances, and why:
- packs: ``tok_l`` and ``bias_l`` bit for bit (a bf16 cast and a layout);
  ``e_max``/``n_max`` rtol 1e-6 (f32 norms summed in another order);
- scores against the JAX kernels in interpret mode: atol 2e-6, rtol 1e-6.
  Both dot 32 exact bf16 products in f32 in some order (~H·2⁻²⁴ of the
  product magnitudes) and sum Lq bests (the JAX kernel as a selection
  matmul, the port in ascending order); -inf in the same places and the
  empty chunk exactly 0;
- against the port's K6: within 2·κ·C1·n_max, κ = (H+Lq)·2⁻²³, the share
  the certificate gives each f32 program (on the card the kernels are
  bit-identical instead).

JAX is imported inside the CPU tests only: the card's machine runs the
``cuda``-marked tests without JAX (``--noconftest``)."""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import maxsim as pm
from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import (
    maxsim_scan16_scores,
    maxsim_scan16_scores_reference,
    maxsim_scan16_scores_self_v2,
    maxsim_scan16_scores_self_v2_reference,
    maxsim_scan16_scores_v2,
    maxsim_scan16_scores_v2_reference,
)

EPS23 = 2.0**-23
ATOL, RTOL = 2e-6, 1e-6
CASES = [(600, 4), (601, 3)]  # (n, Lt): the JAX test's shape, then ragged with a padded Lt
GROUPS = [128, 256, 100]


def build(n, lt, h=32, b=3, lq=5, seed=3):
    """Unit tokens with ragged masks, chunk 7 empty, chunk 3 invalid, and
    queries with padding tokens zeroed → (tok f32, tm, q16 as f32, valid)."""
    rng = np.random.default_rng(seed + n + lt)
    tok = rng.normal(size=(n, lt, h)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=2, keepdims=True)
    lens = rng.integers(1, lt + 1, size=n)
    lens[7] = 0
    tm = np.arange(lt)[None, :] < lens[:, None]
    valid = np.ones(n, bool)
    valid[3] = False
    q = rng.normal(size=(b, lq, h)).astype(np.float32)
    qm = np.arange(lq)[None, :] < rng.integers(1, lq + 1, size=b)[:, None]
    return tok, tm, np.where(qm[:, :, None], q, 0.0).astype(np.float32), valid


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bf16(x):
    return _t(x).to(torch.bfloat16)


def _jax():
    return pytest.importorskip("jax.numpy")


def _k6_tol(q16, tok16, tm, lq):
    """2·κ·C1·n_max per [B, N] entry."""
    h = q16.shape[2]
    c1 = torch.linalg.vector_norm(q16.float(), dim=2).sum(dim=1)
    n_max = torch.where(tm, torch.linalg.vector_norm(tok16.float(), dim=2), 0.0).amax(dim=1)
    return 2 * (h + lq) * EPS23 * c1[:, None] * n_max[None, :] + 1e-7


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# packs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("n,lt", CASES)
def test_bias_l_matches_jax_bit_for_bit(n, lt, group):
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    _, tm, _, _ = build(n, lt)
    got = pm.prepare_maxsim_bias_l(_t(tm), group).numpy()
    want = np.asarray(jm.prepare_maxsim_bias_l(jnp.asarray(tm), group))
    assert got.dtype == np.float32 and got.shape == (-(-n // group) * lt * group,)
    np.testing.assert_array_equal(got, want)
    # chunk c's position l at ((c // group)·Lt + l)·group + c % group
    c, l_ = 7 + group, lt - 1
    assert got[((c // group) * lt + l_) * group + c % group] == (0.0 if tm[c, l_] else -(2.0**30))


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("n,lt", CASES)
def test_opt_pack_matches_jax(n, lt, group):
    """``tok_l`` and ``bias_l`` bit for bit, built over several slabs (the
    port writes whole groups a slab at a time); ``e_max``/``n_max`` to f32
    rounding and equal to the plain bf16 pack's."""
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm

    tok, tm, _, _ = build(n, lt)
    tok_l, bias_l, e_max, n_max = pm.prepare_maxsim_scan16_opt(_t(tok), _t(tm), group=group, slab=250)
    j = jm.prepare_maxsim_scan16_opt(jnp.asarray(tok), jnp.asarray(tm), group=group, slab=250)
    lt_p = -(-lt // 4) * 4
    assert tuple(tok_l.shape) == (-(-n // group) * lt_p * group, 32) and tok_l.dtype == torch.bfloat16
    np.testing.assert_array_equal(tok_l.float().numpy(), np.asarray(j[0]).astype(np.float32))
    np.testing.assert_array_equal(bias_l.numpy(), np.asarray(j[1]))
    np.testing.assert_allclose(e_max.numpy(), np.asarray(j[2]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(n_max.numpy(), np.asarray(j[3]), rtol=1e-6, atol=0)
    _, e16, n16 = pm.prepare_maxsim_scan16(_t(tok), _t(tm))
    assert torch.equal(e_max, e16) and torch.equal(n_max, n16)


# ---------------------------------------------------------------------------
# K11a / K11b plain versions against the JAX kernels and K6
# ---------------------------------------------------------------------------


def _jax_scores(tok, tm, q16, valid, group):
    """The JAX kernels in interpret mode → (K11a, K11b or None where its
    TPU block rule ``(group·Lt) % 1024 == 0`` refuses the shape)."""
    jnp = _jax()
    from trueno_rag_tpu.ops import maxsim as jm
    from trueno_rag_tpu.ops.pallas import maxsim_scan as jk

    q_j, tok_j = jnp.asarray(q16).astype(jnp.bfloat16), jnp.asarray(tok).astype(jnp.bfloat16)
    tm_j, v_j = jnp.asarray(tm), jnp.asarray(valid)
    tok_l, bias_l, _, _ = jm.prepare_maxsim_scan16_opt(tok_j, tm_j, group=group)
    lt_p = -(-tm.shape[1] // 4) * 4
    s_a = np.asarray(jk.maxsim_scan16_scores_v2(q_j, tok_l, bias_l, v_j, lt=lt_p, group=group, interpret=True))
    s_b = None
    if (group * tm.shape[1]) % 1024 == 0:
        s_b = np.asarray(jk.maxsim_scan16_scores_self_v2(
            q_j, tok_j, jm.prepare_maxsim_bias_l(tm_j, group), v_j, group=group, interpret=True))
    return s_a, s_b


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("n,lt", CASES)
def test_k11_plain_versions_match_jax_kernels(n, lt, group):
    """K11a's plain version against the JAX K11a, K11b's against the JAX
    K11b (or, where the TPU block rule refuses the shape, the JAX K11a on
    the same values); -inf at the invalid chunk, exactly 0 at the empty."""
    tok, tm, q16, valid = build(n, lt)
    s_a, s_b = _jax_scores(tok, tm, q16, valid, group)
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(_t(tok), _t(tm), group=group)
    lt_p = -(-lt // 4) * 4
    got_a = maxsim_scan16_scores_v2_reference(_bf16(q16), tok_l, bias_l, _t(valid), lt_p, group).numpy()
    got_b = maxsim_scan16_scores_self_v2_reference(_bf16(q16), _bf16(tok), pm.prepare_maxsim_bias_l(_t(tm), group),
                                                   _t(valid), group).numpy()
    _close(got_a, s_a)
    _close(got_b, s_b if s_b is not None else s_a)
    for got in (got_a, got_b):
        assert np.isneginf(got[:, 3]).all() and (got[:, 7] == 0.0).all()
        assert np.isfinite(np.delete(got, 3, axis=1)).all()


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("n,lt", CASES)
def test_k11_plain_versions_match_k6(n, lt, group):
    """Both v2 plain versions within 2·κ·C1·n_max of K6's plain version on
    the same bf16 values; and the wrappers take the plain versions on the
    CPU without counting a launch."""
    tok, tm, q16, valid = build(n, lt)
    q, tok16, tm_t, v_t = _bf16(q16), _bf16(tok), _t(tm), _t(valid)
    want = maxsim_scan16_scores_reference(q, tok16, tm_t, v_t)
    tol = _k6_tol(q, tok16, tm_t, q16.shape[1])
    fin = torch.isfinite(want)
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(_t(tok), tm_t, group=group)
    bias = pm.prepare_maxsim_bias_l(tm_t, group)
    lt_p = -(-lt // 4) * 4
    before = (maxsim_scan16_scores_v2.launches, maxsim_scan16_scores_self_v2.launches)
    for got in (maxsim_scan16_scores_v2(q, tok_l, bias_l, v_t, lt_p, group),
                maxsim_scan16_scores_self_v2(q, tok16, bias, v_t, group)):
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        assert bool(((got - want).abs()[fin] <= tol[fin]).all())
    assert (maxsim_scan16_scores_v2.launches, maxsim_scan16_scores_self_v2.launches) == before


def test_v2_wrappers_check_their_inputs():
    tok, tm, q16, valid = build(600, 4)
    q, tok16, tm_t, v_t = _bf16(q16), _bf16(tok), _t(tm), _t(valid)
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(_t(tok), tm_t, group=256)
    bias = pm.prepare_maxsim_bias_l(tm_t, 256)
    bad_a = [
        (q.float(), tok_l, bias_l, v_t, 4, 256),  # f32 query
        (q, tok_l.float(), bias_l, v_t, 4, 256),  # f32 pack
        (q, tok_l, bias_l[:-1], v_t, 4, 256),  # bias shorter than the pack
        (q, tok_l, bias_l.double(), v_t, 4, 256),  # f64 bias
        (q, tok_l[:1024], bias_l[:1024], v_t, 4, 256),  # one group cannot cover 600 chunks
        (q, tok_l, bias_l, v_t, 5, 256),  # rows not whole groups of 5 x 256
        (q, tok_l, bias_l, v_t, 2, 256),  # lt 2 on an Lt_p 4 pack: whole groups, the wrong rows
        (q, torch.cat([tok_l, tok_l[:1024]]), torch.cat([bias_l, bias_l[:1024]]), v_t, 4, 256),  # an extra group
        (q, tok_l, bias_l, v_t.int(), 4, 256),  # int valid
        (q, tok_l, bias_l, v_t, 4, 0),  # group 0
        (q[:, :, :16], tok_l, bias_l, v_t, 4, 256),  # H mismatch
    ]
    for args in bad_a:
        with pytest.raises(InvalidConfigError):
            maxsim_scan16_scores_v2(*args)
    bad_b = [
        (q, tok16[:-1], bias, v_t, 256),  # tokens and valid disagree
        (q, tok16, bias[:-4], v_t, 256),  # bias not whole groups
        (q, tok16, bias[:1024], v_t, 256),  # bias covering one group of 600 chunks
        (q, tok16, torch.cat([bias, bias[:1024]]), v_t, 256),  # bias of one group too many
        (q, tok16.reshape(600, -1), bias, v_t, 256),  # 2-D tokens
    ]
    for args in bad_b:
        with pytest.raises(InvalidConfigError):
            maxsim_scan16_scores_self_v2(*args)
    with pytest.raises(InvalidConfigError):
        pm.prepare_maxsim_bias_l(tm_t, 0)
    with pytest.raises(InvalidConfigError):
        pm.prepare_maxsim_scan16_opt(_t(tok), tm_t, group=0)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions and K6
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,group", [((5000, 32, 128, 8, 8), 256), ((3001, 30, 64, 3, 5), 128),
                                         ((3001, 30, 64, 3, 5), 512), ((700, 7, 384, 5, 70), 100),
                                         ((1000, 4, 36, 2, 3), 96)],
                         ids=["serving", "ragged-128", "ragged-512", "lq70-100", "h36-96"])
def test_cuda_k11_matches_plain_and_k6(shape, group):
    """K11a and K11b within 2·κ·C1·n_max of their plain versions, and bit
    for bit equal to K6 on the same bf16 values and valid tokens."""
    _cuda_or_skip()
    n, lt, h, b, lq = shape
    tok, tm, q16, valid = build(n, lt, h, b, lq, seed=n)
    q, tok16 = _bf16(q16).cuda(), _bf16(tok).cuda()
    tm_d, v_d = _t(tm).cuda(), _t(valid).cuda()
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(tok16, tm_d, group=group)
    bias = pm.prepare_maxsim_bias_l(tm_d, group)
    lt_p = -(-lt // 4) * 4
    k6 = maxsim_scan16_scores(q, tok16, tm_d, v_d)
    before = (maxsim_scan16_scores_v2.launches, maxsim_scan16_scores_self_v2.launches)
    got_a = maxsim_scan16_scores_v2(q, tok_l, bias_l, v_d, lt_p, group)
    got_b = maxsim_scan16_scores_self_v2(q, tok16, bias, v_d, group)
    torch.cuda.synchronize()
    assert (maxsim_scan16_scores_v2.launches, maxsim_scan16_scores_self_v2.launches) == (before[0] + 1,
                                                                                         before[1] + 1)
    assert torch.equal(got_a, k6) and torch.equal(got_b, k6)
    tol = _k6_tol(q, tok16, tm_d, lq)
    for got, want in ((got_a, maxsim_scan16_scores_v2_reference(q, tok_l, bias_l, v_d, lt_p, group)),
                      (got_b, maxsim_scan16_scores_self_v2_reference(q, tok16, bias, v_d, group))):
        assert torch.equal(torch.isneginf(got), torch.isneginf(want))
        fin = torch.isfinite(want)
        assert bool(((got - want).abs()[fin] <= tol[fin]).all())
    assert bool((got_a[:, 7] == 0).all()) and bool(torch.isneginf(got_a[:, 3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h", [15, 16, 17, 100, 520])
def test_cuda_k11_equals_k6_at_widths_around_the_mma_depth(h):
    """K11a and K11b bit for bit equal to K6 at widths below, at and past
    one 16-column mma slice, one no vector divides, and one whose query rows
    stream (past 512), over a ragged Lt that the l-major pack pads."""
    _cuda_or_skip()
    n, lt, b, lq, group = 1500, 11, 4, 7, 128
    tok, tm, q16, valid = build(n, lt, h, b, lq, seed=h)
    q, tok16 = _bf16(q16).cuda(), _bf16(tok).cuda()
    tm_d, v_d = _t(tm).cuda(), _t(valid).cuda()
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(tok16, tm_d, group=group)
    bias = pm.prepare_maxsim_bias_l(tm_d, group)
    lt_p = -(-lt // 4) * 4
    k6 = maxsim_scan16_scores(q, tok16, tm_d, v_d)
    got_a = maxsim_scan16_scores_v2(q, tok_l, bias_l, v_d, lt_p, group)
    got_b = maxsim_scan16_scores_self_v2(q, tok16, bias, v_d, group)
    torch.cuda.synchronize()
    assert torch.equal(got_a, k6) and torch.equal(got_b, k6)
    assert bool((k6[:, 7] == 0).all()) and bool(torch.isneginf(k6[:, 3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,group", [((5003, 32, 384, 32, 16), 256), ((700, 7, 384, 3, 150), 128),
                                         ((600, 5, 1032, 9, 16), 100)],
                         ids=["late-b32", "lq150", "h1032"])
def test_cuda_k6_wgmma_program_equals_k11(shape, group):
    """K6's wgmma program at late-262k.b32's launch shape (B 32, Lq 16, H
    384, Lt 32, masked tokens, an empty and an invalid chunk), over two
    128-row tiles of one query, and with its query rows streaming: bit for
    bit K11a's and K11b's cp.async program, within 2·κ·C1·n_max of its
    plain version, one launch counted on the program."""
    _cuda_or_skip()
    n, lt, h, b, lq = shape
    tok, tm, q16, valid = build(n, lt, h, b, lq, seed=n + lq)
    q, tok16 = _bf16(q16).cuda(), _bf16(tok).cuda()
    tm_d, v_d = _t(tm).cuda(), _t(valid).cuda()
    tok_l, bias_l, _, _ = pm.prepare_maxsim_scan16_opt(tok16, tm_d, group=group)
    bias = pm.prepare_maxsim_bias_l(tm_d, group)
    lt_p = -(-lt // 4) * 4
    before = (maxsim_scan16_scores.launches, maxsim_scan16_scores.wgmma_launches)
    k6 = maxsim_scan16_scores(q, tok16, tm_d, v_d)
    torch.cuda.synchronize()
    assert (maxsim_scan16_scores.launches, maxsim_scan16_scores.wgmma_launches) == (before[0] + 1, before[1] + 1)
    got_a = maxsim_scan16_scores_v2(q, tok_l, bias_l, v_d, lt_p, group)
    got_b = maxsim_scan16_scores_self_v2(q, tok16, bias, v_d, group)
    torch.cuda.synchronize()
    assert torch.equal(got_a, k6) and torch.equal(got_b, k6)
    want = maxsim_scan16_scores_reference(q, tok16, tm_d, v_d)
    assert torch.equal(torch.isneginf(k6), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert bool(((k6 - want).abs()[fin] <= _k6_tol(q, tok16, tm_d, lq)[fin]).all())
    assert bool((k6[:, 7] == 0).all()) and bool(torch.isneginf(k6[:, 3]).all())
