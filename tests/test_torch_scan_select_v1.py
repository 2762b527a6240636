"""The block-kernel scans (K8 ``scan_select``, K9 ``scan_select_int8``):
their plain PyTorch versions against the JAX package's Pallas kernels
(interpret mode) at top 1, 2 and 4 with masked rows and planted ties
(K9 also at d = 1040 on +-127 data and on planted int8 ties, bit for bit),
the wrappers' dispatch and checks, and (on a card only) the CUDA kernels
against the plain versions at d = 384 and d = 100, both tensor-core dots
at widths 15-520 (K9 to 1040), batches 1-256 and tops 1-8, and bit for bit
on exact data.

Tolerances, and why:
- K8 values: 1e-5 absolute. Both frameworks sum d bf16 products in f32 in
  some order (~d·2⁻²⁴ for unit vectors) before the bound terms.
- K9 values on random data: 1e-6 absolute. The integer dot is exact, but
  XLA's CPU code contracts the bound's multiply-adds into fmas
  (``fma(a_l2, v_q, fma(dot·s_row, t_q, e_l2·u_q))``), where the port
  rounds each product and sum as the Pallas source writes them (|bound
  terms| < 1e-2, so ~1e-9). On data whose every product and sum is exact
  in f32, K9 equals the Pallas kernel bit for bit.
- lanes: equal, on data without near-ties (and on exact ties, where both
  take the largest lane).
JAX is imported inside the tests: the card's machine runs the
``cuda``-marked ones without it.
"""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import dense_tiered as dt
from trueno_rag_tpu_torch.ops.kernels.scan_select import SEL
from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import (
    BLOCK,
    scan_select,
    scan_select_int8,
    scan_select_int8_reference,
    scan_select_reference,
)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(n, d, b, seed):
    """Unit rows with a partly masked block, a fully masked block and a
    planted exact tie: row 9 copied into row 5 of the same block, and
    query 0 equal to them, so both lead block 0 for query 0."""
    rng = np.random.default_rng(seed)
    m, q = _unit(rng, n, d), _unit(rng, b, d)
    m[5] = m[9]
    q[0] = m[9]
    valid = np.ones(n, np.int32)
    valid[200:240] = 0
    valid[3 * BLOCK:4 * BLOCK] = 0
    return m, q, valid


def _bf16_args(m, q, valid):
    mb, e, a = dt.prepare_tiered(_t(m))
    qb, u, v = dt._bf16_query_bounds(_t(q))
    return [qb, mb, e, a, _t(valid), u, v]


def _int8_args(m, q, valid):
    m_i8, s_row, e, a = dt.prepare_int8(_t(m))
    q_i8, t_q, u, v = dt._int8_query_bounds(_t(q))
    return [q_i8, m_i8, s_row, e, a, _t(valid), t_q, u, v]


def _jax_scan(name, args, top):
    jnp = pytest.importorskip("jax.numpy")
    if name == "bf16":
        from trueno_rag_tpu.ops.pallas.scan_select import scan_select as jfn
    else:
        from trueno_rag_tpu.ops.pallas.scan_select_int8 import scan_select_int8 as jfn
    conv = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())
            for x in args]
    return [np.asarray(o) for o in jfn(*conv, tile_n=1024, top=top, interpret=True)]


def _compare(jo, to, top, atol):
    assert len(to) == len(jo) == 2 * top + 1
    for t, (j, p) in enumerate(zip(jo, to)):
        p = p.numpy()
        assert p.shape == j.shape and p.dtype == j.dtype
        if t <= top:
            np.testing.assert_array_equal(np.isneginf(p), np.isneginf(j))
            fin = np.isfinite(j)
            np.testing.assert_allclose(p[fin], j[fin], rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("top", [1, 2, 4])
def test_k8_plain_matches_jax_kernel(top):
    m, q, valid = _inputs(4096, 32, 8, seed=1)
    args = _bf16_args(m, q, valid)
    to = scan_select_reference(*args, tile_n=1024, top=top)
    _compare(_jax_scan("bf16", args, top), to, top, atol=1e-5)
    # the planted tie: rows 5 and 9 lead block 0 for query 0 with equal
    # values, so the larger lane comes first
    assert to[top + 1][0, 0].item() == 9
    if top > 1:
        assert to[top + 2][0, 0].item() == 5
        assert to[0][0, 0].item() == to[1][0, 0].item()


@pytest.mark.parametrize("top", [1, 2, 4])
def test_k9_plain_matches_jax_kernel(top):
    m, q, valid = _inputs(4096, 32, 8, seed=2)
    args = _int8_args(m, q, valid)
    to = scan_select_int8_reference(*args, tile_n=1024, top=top)
    _compare(_jax_scan("int8", args, top), to, top, atol=1e-6)


@pytest.mark.parametrize("top", [1, 2, 4])
def test_k9_plain_matches_jax_kernel_bit_for_bit_on_exact_data(top):
    """Integer-grid rows and queries with power-of-two scales and bound
    terms: every product and sum is exact in f32, ties are exact and
    frequent, and both versions must agree bit for bit — values, and lanes
    (the largest among equal values; an all-masked block emits lane 127 in
    every pass)."""
    rng = np.random.default_rng(12)
    n, d, b = 4096, 32, 8
    m_i8 = rng.integers(-2, 3, size=(n, d)).astype(np.int8)
    q_i8 = rng.integers(-2, 3, size=(b, d)).astype(np.int8)
    s_row = np.full(n, 0.25, np.float32)
    e_l2 = (rng.integers(0, 4, size=n) / 8.0).astype(np.float32)
    a_l2 = np.full(n, 0.5, np.float32)
    t_q = np.full(b, 0.5, np.float32)
    u_q = np.full(b, 0.25, np.float32)
    v_q = np.full(b, 0.125, np.float32)
    valid = np.ones(n, np.int32)
    valid[BLOCK:2 * BLOCK] = 0  # an all-masked block
    valid[700:705] = 0
    args = [_t(x) for x in (q_i8, m_i8, s_row, e_l2, a_l2, valid, t_q, u_q, v_q)]
    jo = _jax_scan("int8", args, top)
    to = scan_select_int8_reference(*args, tile_n=1024, top=top)
    for j, p in zip(jo, to):
        np.testing.assert_array_equal(p.numpy(), j)
    for lanes in to[top + 1:]:
        assert (lanes[:, 1] == BLOCK - 1).all()


@pytest.mark.parametrize("top", [2, 4])
def test_k8_plain_matches_jax_kernel_with_exact_ties(top):
    """Grid data exact in bf16 (multiples of 1/4): scores are exact
    multiples of 1/16, e_l2 is 0 — both versions must pick the same lanes
    through every tie."""
    rng = np.random.default_rng(11)
    n, d, b = 2048, 32, 8
    m = (rng.integers(-2, 3, size=(n, d)) / 4.0).astype(np.float32)
    q = (rng.integers(-2, 3, size=(b, d)) / 4.0).astype(np.float32)
    valid = np.ones(n, np.int32)
    valid[BLOCK:2 * BLOCK] = 0
    mb, e, a = dt.prepare_tiered(_t(m))
    args = [_t(q).to(torch.bfloat16), mb, e, a, _t(valid), torch.full((b,), 1.01), torch.full((b,), 1e-6)]
    jo = _jax_scan("bf16", args, top)
    to = scan_select_reference(*args, tile_n=1024, top=top)
    for j, p in zip(jo, to):
        np.testing.assert_array_equal(p.numpy(), j)


def _tie_args(d, n=2048, b=8, seed=13, int8=False):
    """Exact data for K8 (bf16) or, with ``int8``, K9, K3 and K10c:
    small-integer rows and queries in [-3, 3] (every product and every
    partial sum an integer, so each dot is exact in any order), dyadic bound
    terms (each upper exact in f32), a partly and a fully masked block, and
    planted equal uppers: row 9 copied into rows 5 and 100 of block 0 with
    the same norms, and query 0 equal to it. In int8 the row and query
    scales are dyadic too, and row 9 is all +-3 at the largest row scale and
    norms: the largest upper any row can have with query 0. → torch
    tensors in the kernel's argument order."""
    rng = np.random.default_rng(seed + d)
    m = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    q = rng.integers(-3, 4, size=(b, d)).astype(np.float32)
    if int8:
        m[9] = np.where(rng.random(d) < 0.5, -3, 3)
        s_row = np.array([0.125, 0.25, 0.5], np.float32)[rng.integers(0, 3, n)]
    e_l2 = (rng.integers(0, 4, size=n) / 8.0).astype(np.float32)
    a_l2 = (rng.integers(1, 5, size=n) / 4.0).astype(np.float32)
    for r in (5, 100):
        m[r], e_l2[r], a_l2[r] = m[9], e_l2[9], a_l2[9]
    q[0] = m[9]
    valid = np.ones(n, np.int32)
    valid[300:330] = 0
    valid[2 * BLOCK:3 * BLOCK] = 0
    u_q = np.full(b, 0.25, np.float32)
    v_q = np.full(b, 0.125, np.float32)
    if not int8:
        qb, mb = (_t(x).to(torch.bfloat16) for x in (q, m))
        return [qb, mb] + [_t(x) for x in (e_l2, a_l2, valid, u_q, v_q)]
    s_row[[5, 9, 100]], e_l2[[5, 9, 100]], a_l2[[5, 9, 100]] = 0.5, 0.375, 1.0
    t_q = np.array([1.0, 2.0], np.float32)[rng.integers(0, 2, b)]
    return [_t(x) for x in (q.astype(np.int8), m.astype(np.int8), s_row, e_l2, a_l2, valid, t_q, u_q, v_q)]


@pytest.mark.parametrize("d", [17, 100])
def test_k8_plain_matches_jax_kernel_bit_for_bit_on_planted_ties(d):
    """On exact data both versions compute every upper exactly, so they
    must agree bit for bit, values and lanes, through the planted three-way
    tie (lanes 100, 9, 5 in that order) and the all-masked block (lane 127
    in every pass)."""
    top = 4
    args = _tie_args(d)
    jo = _jax_scan("bf16", args, top)
    to = scan_select_reference(*args, tile_n=1024, top=top)
    for j, p in zip(jo, to):
        np.testing.assert_array_equal(p.numpy(), j)
    assert [to[top + 1 + t][0, 0].item() for t in range(3)] == [100, 9, 5]
    assert to[0][0, 0].item() == to[1][0, 0].item() == to[2][0, 0].item()
    for lanes in to[top + 1:]:
        assert (lanes[:, 2] == BLOCK - 1).all()


def test_wrappers_run_the_plain_versions_for_cpu_tensors():
    m, q, valid = _inputs(2048, 24, 5, seed=3)
    for fn, ref, args in ((scan_select, scan_select_reference, _bf16_args(m, q, valid)),
                          (scan_select_int8, scan_select_int8_reference, _int8_args(m, q, valid))):
        before = fn.launches
        got = fn(*args, tile_n=256, top=2)
        want = ref(*args, tile_n=256, top=2)
        assert fn.launches == before  # no kernel launch on the CPU
        assert len(got) == 5 and got[0].shape == (5, 2048 // BLOCK)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("mutate", [
    lambda a: a.__setitem__(1, a[1][:1000]),  # N not a multiple of tile_n
    lambda a: a.__setitem__(0, a[0].float()),  # wrong dtype
    lambda a: a.__setitem__(2, a[2][:-1]),  # short per-row vector
    lambda a: a.__setitem__(5, a[5][:-1]),  # short per-query vector
])
def test_wrappers_reject_what_the_kernels_do_not_take(mutate):
    m, q, valid = _inputs(2048, 16, 4, seed=4)
    args = _bf16_args(m, q, valid)
    mutate(args)
    with pytest.raises(InvalidConfigError):
        scan_select(*args, tile_n=1024, top=2)


def test_wrappers_check_top_tile_and_the_int8_range():
    m, q, valid = _inputs(2048, 16, 4, seed=5)
    args = _bf16_args(m, q, valid)
    for top in (0, 9):
        with pytest.raises(InvalidConfigError, match="top"):
            scan_select(*args, top=top)
    with pytest.raises(InvalidConfigError, match="tile_n"):
        scan_select(*args, tile_n=100)
    rng = np.random.default_rng(0)
    wide = _int8_args(_unit(rng, 1024, 1041), _unit(rng, 2, 1041), np.ones(1024, np.int32))
    with pytest.raises(InvalidConfigError, match="2\\^24"):
        scan_select_int8(*wide)


def test_wrappers_raise_on_devices_they_have_no_kernel_for():
    m, q, valid = _inputs(2048, 16, 4, seed=6)
    args = [x.to("meta") for x in _bf16_args(m, q, valid)]
    with pytest.raises(InvalidConfigError, match="cpu or cuda"):
        scan_select(*args)


def test_plain_bounds_are_sound_against_float64():
    """Every emitted value is at least the float64 true score of its row,
    and v_{top+1} is at least every row of the block that was not
    emitted (the certificate's two obligations)."""
    m, q, valid = _inputs(4096, 48, 6, seed=7)
    for name, args, ref in (("bf16", _bf16_args(m, q, valid), scan_select_reference),
                            ("int8", _int8_args(m, q, valid), scan_select_int8_reference)):
        top = 2
        out = ref(*args, tile_n=1024, top=top)
        true = np.where(valid[:, None] != 0, m.astype(np.float64) @ q.astype(np.float64).T, -np.inf)
        tb = true.reshape(-1, BLOCK, q.shape[0])  # [G, 128, B]
        lanes = np.stack([x.numpy().T for x in out[top + 1:]])  # [top, G, B]
        vals = np.stack([x.numpy().T for x in out[:top + 1]]).astype(np.float64)
        g_idx, b_idx = np.meshgrid(np.arange(tb.shape[0]), np.arange(tb.shape[2]), indexing="ij")
        seen = np.zeros(tb.shape, bool)
        for t in range(top):
            emitted = tb[g_idx, lanes[t], b_idx]
            ok = np.isneginf(emitted) | (vals[t] >= emitted)
            assert ok.all(), name
            seen[g_idx, lanes[t], b_idx] = True
        rest = np.where(seen, -np.inf, tb).max(axis=1)
        assert (np.isneginf(rest) | (vals[top] >= rest)).all(), name


# -- on the card -----------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 100])
@pytest.mark.parametrize("top", [2, 4])
def test_cuda_k8_matches_plain_version(d, top):
    """On the card: K8 against its plain version (values within 1e-4, the
    f32 summation order; lanes equal except at near-ties of the two
    orders). d = 100 reads unaligned rows through the byte-wise loads."""
    _cuda_or_skip()
    m, q, valid = _inputs(65536, d, 200, seed=8)
    args = [x.cuda() for x in _bf16_args(m, q, valid)]
    before = scan_select.launches
    got = scan_select(*args, tile_n=1024, top=top)
    torch.cuda.synchronize()
    assert scan_select.launches == before + 1
    want = scan_select_reference(*args, tile_n=1024, top=top)
    for t in range(top + 1):
        assert torch.equal(torch.isneginf(got[t]), torch.isneginf(want[t]))
        fin = torch.isfinite(want[t])
        assert (got[t][fin] - want[t][fin]).abs().max().item() <= 1e-4
    for t in range(top + 1, 2 * top + 1):
        assert (got[t] != want[t]).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 100])
@pytest.mark.parametrize("top", [2, 4])
def test_cuda_k9_is_bit_identical_to_plain_version(d, top):
    """On the card: K9 against its plain version, bit for bit (exact
    integer dot, the same rounding of every product and sum)."""
    _cuda_or_skip()
    m, q, valid = _inputs(65536, d, 200, seed=9)
    args = [x.cuda() for x in _int8_args(m, q, valid)]
    before = scan_select_int8.launches
    got = scan_select_int8(*args, tile_n=1024, top=top)
    torch.cuda.synchronize()
    assert scan_select_int8.launches == before + 1
    want = scan_select_int8_reference(*args, tile_n=1024, top=top)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [15, 16, 17, 100, 384, 520])
@pytest.mark.parametrize("b", [1, 65, 200, 256])
@pytest.mark.parametrize("top", [1, 2, 4, 8])
def test_cuda_k8_at_widths_batches_and_tops(d, b, top):
    """K8's tensor-core dot (mma_bf16.cuh) at widths below, at and past one
    16-column slice, one no vector divides, 384 and past 512, at batches
    that fill part of one, two, four and all four 64-query groups, every
    top: values within 1e-4 of its plain version (the f32 summation
    order), -inf slots equal, lanes equal except at near-ties (1e-3)."""
    _cuda_or_skip()
    m, q, valid = _inputs(65536, d, b, seed=d * 1000 + b)
    args = [x.cuda() for x in _bf16_args(m, q, valid)]
    got = scan_select(*args, tile_n=1024, top=top)
    torch.cuda.synchronize()
    want = scan_select_reference(*args, tile_n=1024, top=top)
    for t in range(top + 1):
        assert torch.equal(torch.isneginf(got[t]), torch.isneginf(want[t]))
        fin = torch.isfinite(want[t])
        assert (got[t][fin] - want[t][fin]).abs().max().item() <= 1e-4
    for t in range(top + 1, 2 * top + 1):
        assert (got[t] != want[t]).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 100, 384])
@pytest.mark.parametrize("top", [2, 8])
def test_cuda_k8_is_bit_identical_on_exact_data(d, top):
    """On exact data (small-integer bf16, dyadic bound terms) the tensor-core
    dot is exact, so K8 equals its plain version bit for bit, values and
    lanes, through the planted tie and the all-masked block: the score
    tile's way through shared memory into the selection keeps every row at
    its lane."""
    _cuda_or_skip()
    args = [x.cuda() for x in _tie_args(d, n=8192, b=70)]
    got = scan_select(*args, tile_n=1024, top=top)
    torch.cuda.synchronize()
    want = scan_select_reference(*args, tile_n=1024, top=top)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [got[top + 1 + t][0, 0].item() for t in range(2)] == [100, 9]


# -- K9 on exact int8 data ------------------------------------------------------------


def _int8_sign_args(d, n=2048, b=8, seed=17):
    """Rows and queries of +-127 only, with query i (1-3, if b > i and the
    row exists) copied into row i*1024 + 7i at the largest row scale, so
    its dot reaches d*127^2 (just below 2^24 at d = 1040, the widest width
    the int8 kernels take) and leads its block and tile for query i; many
    other dots tie exactly. Power-of-two scales and zero bound norms keep
    every value exact. → torch tensors in the int8 kernels' argument order."""
    rng = np.random.default_rng(seed + d)
    m = np.where(rng.random((n, d)) < 0.5, -127, 127).astype(np.int8)
    q = np.where(rng.random((b, d)) < 0.5, -127, 127).astype(np.int8)
    s_row = np.array([0.25, 0.5], np.float32)[rng.integers(0, 2, n)]
    for i in range(1, min(b, 4, n // SEL)):
        m[i * SEL + 7 * i], s_row[i * SEL + 7 * i] = q[i], 0.5
    valid = np.ones(n, np.int32)
    valid[300:330] = 0
    valid[2 * BLOCK:3 * BLOCK] = 0
    t_q = np.array([1.0, 2.0], np.float32)[rng.integers(0, 2, b)]
    zeros = np.zeros(n, np.float32)
    return [_t(x) for x in (q, m, s_row, zeros, zeros.copy(), valid, t_q, np.full(b, 0.25, np.float32),
                            np.full(b, 0.125, np.float32))]


@pytest.mark.parametrize("top", [2, 4])
def test_k9_plain_matches_jax_kernel_at_the_widest_width(top):
    """At d = 1040 on +-127 data (sums up to d*127^2 < 2^24, exact), K9's
    plain version equals the Pallas kernel bit for bit, values and lanes,
    through the many exact ties; the planted copy leads its block."""
    args = _int8_sign_args(1040)
    to = scan_select_int8_reference(*args, tile_n=1024, top=top)
    for j, p in zip(_jax_scan("int8", args, top), to):
        np.testing.assert_array_equal(p.numpy(), j)
    assert to[top + 1][1, 1031 // BLOCK].item() == 1031 % BLOCK
    assert to[0][1, 1031 // BLOCK].item() == 1040 * 127 * 127 * 0.5 * args[6][1].item()


@pytest.mark.parametrize("d", [17, 100])
def test_k9_plain_matches_jax_kernel_bit_for_bit_on_planted_ties(d):
    """On exact int8 data both versions compute every upper exactly, so they
    agree bit for bit, values and lanes, through the planted three-way tie
    (lanes 100, 9, 5 in that order) and the all-masked block (lane 127 in
    every pass)."""
    top = 4
    args = _tie_args(d, int8=True)
    to = scan_select_int8_reference(*args, tile_n=1024, top=top)
    for j, p in zip(_jax_scan("int8", args, top), to):
        np.testing.assert_array_equal(p.numpy(), j)
    assert [to[top + 1 + t][0, 0].item() for t in range(3)] == [100, 9, 5]
    assert to[0][0, 0].item() == to[1][0, 0].item() == to[2][0, 0].item()
    for lanes in to[top + 1:]:
        assert (lanes[:, 2] == BLOCK - 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [15, 16, 17, 32, 33, 100, 384, 520, 1040])
@pytest.mark.parametrize("b", [1, 65, 200, 256])
@pytest.mark.parametrize("top", [1, 2, 4, 8])
def test_cuda_k9_at_widths_batches_and_tops(d, b, top):
    """K9 (K8's program on mma_s8.cuh's exact dot) bit for bit against its
    plain version at widths below, at and past one 32-column mma slice, ones
    no 16-byte vector divides, 384, past 512 and the widest (1040, +-127
    rows whose dots approach 2^24), at batches that fill part of one, two,
    four and all four 64-query groups, every top."""
    _cuda_or_skip()
    n = 16384
    if d == 1040:
        args = [x.cuda() for x in _int8_sign_args(d, n=n, b=b, seed=b)]
    else:
        m, q, valid = _inputs(n, d, b, seed=d * 1000 + b)
        args = [x.cuda() for x in _int8_args(m, q, valid)]
    before = scan_select_int8.launches
    got = scan_select_int8(*args, tile_n=1024, top=top)
    torch.cuda.synchronize()
    assert scan_select_int8.launches == before + 1
    want = scan_select_int8_reference(*args, tile_n=1024, top=top)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [17, 100, 384])
@pytest.mark.parametrize("top", [2, 8])
def test_cuda_k9_is_bit_identical_on_planted_ties(d, top):
    """K9 on the planted-tie data: bit for bit against its plain version,
    values and lanes, the tie resolved to lanes 100 then 9 and the
    all-masked block to lane 127: the s32 tile's way through shared memory
    into the selection keeps every row at its lane."""
    _cuda_or_skip()
    args = [x.cuda() for x in _tie_args(d, n=8192, b=70, int8=True)]
    got = scan_select_int8(*args, tile_n=1024, top=top)
    torch.cuda.synchronize()
    want = scan_select_int8_reference(*args, tile_n=1024, top=top)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [got[top + 1 + t][0, 0].item() for t in range(2)] == [100, 9]
    assert all(bool((lanes[:, 2] == BLOCK - 1).all()) for lanes in got[top + 1:])
