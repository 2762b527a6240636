"""The plain PyTorch version of scan_select_v3 against the JAX package's
Pallas kernel (interpret mode), its soundness against float64, the
wrapper's dispatch rule, and (on a card only) the CUDA kernel against
the plain version; then K3 ``scan_select_int8_v3`` and K10c
``scan_select_int8_v2``: their plain versions against the Pallas kernels
(interpret mode) on exact int8 data (d = 1040 at +-127, planted ties at
d = 17 and 100), bit for bit, and on a card K3 at widths 15-1040, batches
1-256 and both tag patterns, both on the planted ties."""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import dense_tiered as dt
from trueno_rag_tpu_torch.ops.kernels.scan_select import (
    BLOCK,
    SEL,
    block_bound_maxes,
    scan_select_v3,
    scan_select_v3_reference,
)

from test_torch_scan_select_v1 import _int8_sign_args, _tie_args

T_TOP = 4
# Scores are compared across frameworks whose f32 sums of d = 32 bf16
# products differ by at most ~d*2^-24 ≈ 2e-6 for unit vectors; data whose
# deciding values are >= GAP apart must select identical rows.
GAP = 2e-5


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy().astype(np.float64)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _min_gap(q, m, valid, u, v):
    """Smallest gap among the values that decide the selection: each
    block's top-3 raw scores and each tile's 16 pool values (f64)."""
    mb, qb = _bf16(m), _bf16(q)
    s = np.where(valid[:, None], mb @ qb.T, -np.inf)  # [N, B]
    e = np.linalg.norm(m.astype(np.float64) - mb, axis=1)
    a = np.linalg.norm(mb, axis=1)
    corr = e.reshape(-1, BLOCK).max(1)[:, None] * u[None, :] + a.reshape(-1, BLOCK).max(1)[:, None] * v[None, :]
    blocks = -np.sort(-s.reshape(-1, BLOCK, s.shape[1]), axis=1)[:, :3, :]  # [G, 3, B]
    pool = np.concatenate([blocks[:, 0, :] + corr, blocks[:, 1, :] + corr]).reshape(2, -1, SEL // BLOCK, s.shape[1])
    pool = -np.sort(-pool.transpose(1, 0, 2, 3).reshape(-1, 2 * SEL // BLOCK, s.shape[1]), axis=1)
    with np.errstate(invalid="ignore"):  # -inf - -inf in masked blocks
        gaps = [np.diff(-x, axis=1)[np.isfinite(x[:, 1:, :])] for x in (blocks, pool)]
    return min(g.min() for g in gaps if g.size)


def _random_inputs(n=4096, d=32, b=8):
    """The first seed whose data has no near-tie (gap >= GAP)."""
    for seed in range(200):
        rng = np.random.default_rng(seed)
        m, q = _unit(rng, n, d), _unit(rng, b, d)
        valid = np.ones(n, bool)
        valid[100:140] = False  # a partly masked block
        valid[5 * BLOCK:6 * BLOCK] = False  # a fully masked block
        u = np.full(b, 1.01, np.float32)
        v = np.full(b, 1e-6, np.float32)
        if _min_gap(q, m, valid, u.astype(np.float64), v.astype(np.float64)) >= GAP:
            return m, q, valid, u, v
    raise AssertionError("no seed without near-ties")


def _both(m, q, valid, u, v, t_top=T_TOP):
    # JAX is imported here, not at module level: the card's machine runs
    # the cuda-marked test below without JAX installed
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.dense_tiered import prepare_tiered as jax_prepare_tiered
    from trueno_rag_tpu.ops.pallas.scan_select_v2 import scan_select_v3 as jax_scan_select_v3

    jm = jnp.asarray(m)
    mb, e, a = jax_prepare_tiered(jm)
    jv, jr = jax_scan_select_v3(
        jnp.asarray(q).astype(jnp.bfloat16), mb, e, a, jnp.asarray(valid).astype(jnp.int32),
        jnp.asarray(u), jnp.asarray(v), tile_n=2048, t_top=t_top, interpret=True,
    )
    tm = torch.from_numpy(m)
    tmb, te, ta = dt.prepare_tiered(tm)
    tv, tr = scan_select_v3_reference(
        torch.from_numpy(q).to(torch.bfloat16), tmb, te, ta, torch.from_numpy(valid).to(torch.int32),
        torch.from_numpy(u), torch.from_numpy(v), t_top=t_top,
    )
    return np.asarray(jv), np.asarray(jr), tv.numpy(), tr.numpy()


def test_reference_matches_jax_kernel_on_separated_data():
    m, q, valid, u, v = _random_inputs()
    jv, jr, tv, tr = _both(m, q, valid, u, v)
    assert tv.shape == jv.shape == (8, T_TOP + 1, 4) and tr.shape == jr.shape
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("t_top", [1, 4, 16])
def test_reference_matches_jax_kernel_with_exact_ties(t_top):
    """Grid data: entries are multiples of 1/4 in [-1/2, 1/2], exact in
    bf16, so every score is an exact multiple of 1/16 in f32 and e_l2 is
    0 — ties are exact and frequent, and both versions must break them
    the same way (highest lane in a block, highest slot in a tile; taken
    entries are replaced by -inf, so an all-masked block emits lane 127
    twice)."""
    rng = np.random.default_rng(11)
    n, d, b = 4096, 32, 8
    m = (rng.integers(-2, 3, size=(n, d)) / 4.0).astype(np.float32)
    q = (rng.integers(-2, 3, size=(b, d)) / 4.0).astype(np.float32)
    valid = np.ones(n, bool)
    valid[SEL:SEL + BLOCK] = False
    valid[2 * SEL:3 * SEL] = False  # an all-masked tile
    u = np.full(b, 1.01, np.float32)
    v = np.full(b, 1e-6, np.float32)
    jv, jr, tv, tr = _both(m, q, valid, u, v, t_top)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    assert (tr[:, :, 2] == 2 * SEL + 7 * BLOCK + 127).all()  # slot 15 of the masked tile


def test_reference_bounds_are_sound_against_float64():
    """With the production bound coefficients, every emitted value and
    every tile threshold bounds the float64 true score of the rows it
    covers."""
    rng = np.random.default_rng(5)
    n, d, b = 8192, 64, 8
    m, q = _unit(rng, n, d), _unit(rng, b, d)
    valid = np.ones(n, bool)
    valid[300:700] = False
    tm, tq = torch.from_numpy(m), torch.from_numpy(q)
    mb, e, a = dt.prepare_tiered(tm)
    qb, u, v = dt._bf16_query_bounds(tq)
    vp, rp = scan_select_v3_reference(qb, mb, e, a, torch.from_numpy(valid).to(torch.int32), u, v, t_top=T_TOP)
    vp, rp = vp.numpy().astype(np.float64), rp.numpy()
    true = np.where(valid[:, None], m.astype(np.float64) @ q.astype(np.float64).T, -np.inf)
    for bi in range(b):
        for g in range(n // SEL):
            tile = np.arange(g * SEL, (g + 1) * SEL)
            live = np.isfinite(vp[bi, :T_TOP, g])
            rows = rp[bi, :T_TOP, g][live]
            assert ((rows >= g * SEL) & (rows < (g + 1) * SEL)).all()
            assert (vp[bi, :T_TOP, g][live] >= true[rows, bi]).all()
            rest = np.setdiff1d(tile, rows)
            assert vp[bi, T_TOP, g] >= true[rest, bi].max()


def _small_args(n=2048, d=16, b=8, seed=0):
    rng = np.random.default_rng(seed)
    tm = torch.from_numpy(_unit(rng, n, d))
    mb, e, a = dt.prepare_tiered(tm)
    qb, u, v = dt._bf16_query_bounds(torch.from_numpy(_unit(rng, b, d)))
    return [qb, mb, e, a, torch.ones(n, dtype=torch.int32), u, v]


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    args = _small_args()
    before = scan_select_v3.launches
    got = scan_select_v3(*args, t_top=3)
    want = scan_select_v3_reference(*args, t_top=3)
    assert scan_select_v3.launches == before  # nothing launched on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "mutate",
    [
        lambda a: a.__setitem__(1, a[1].half()),  # f16 corpus (bf16 and f32 are taken)
        lambda a: a.__setitem__(1, a[1][:1000]),  # N not a multiple of 1024
        lambda a: a.__setitem__(4, a[4].bool()),  # valid must be int32
        lambda a: a.__setitem__(5, a[5][:3]),  # u_q of the wrong length
        lambda a: a.__setitem__(0, a[0][:, :12]),  # width mismatch
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(mutate):
    args = _small_args()
    mutate(args)
    with pytest.raises(InvalidConfigError):
        scan_select_v3(*args)


@pytest.mark.parametrize("t_top", [0, 17])
def test_wrapper_rejects_t_top_outside_the_pool(t_top):
    with pytest.raises(InvalidConfigError):
        scan_select_v3(*_small_args(), t_top=t_top)


def test_wrapper_raises_on_devices_it_has_no_kernel_for():
    args = [t.to("meta") for t in _small_args()]
    with pytest.raises(InvalidConfigError):
        scan_select_v3(*args)


def test_block_bound_maxes_are_per_128_rows():
    e = torch.arange(1024, dtype=torch.float32)
    eb, ab = block_bound_maxes(e, -e)
    assert torch.equal(eb, torch.arange(127, 1024, 128, dtype=torch.float32))
    assert torch.equal(ab, -torch.arange(0, 1024, 128, dtype=torch.float32))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()


def _cuda_tags(n, b, seed):
    """A filter masking whole 128-row blocks in the first 4096 rows and
    scattered rows after them."""
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 16, (n,), generator=g, dtype=torch.int32)
    bits[:4096] = torch.randint(0, 16, (32,), generator=g, dtype=torch.int32).repeat_interleave(BLOCK)
    words = [torch.randint(0, 16, (b,), generator=g, dtype=torch.int32) & m for m in (1, 6, 8)]
    return tuple(t.cuda() for t in (bits, *words))


@pytest.mark.cuda
@pytest.mark.parametrize("tagged", [False, True])
def test_cuda_kernel_matches_plain_version(tagged):
    """On the card: the CUDA kernel against the plain version, both on
    CUDA tensors, at d = 384, untagged and with a tag filter (values
    within 1e-4; rows equal except at near-ties of the two summation
    orders)."""
    _cuda_or_skip()
    args = [t.cuda() for t in _small_args(n=65536, d=384, b=200, seed=3)]
    args[4][5000:5300] = 0
    tags = _cuda_tags(65536, 200, 4) if tagged else None
    before = scan_select_v3.launches
    vk, rk = scan_select_v3(*args, t_top=T_TOP, tags=tags)
    torch.cuda.synchronize()
    assert scan_select_v3.launches == before + 1
    vr, rr = scan_select_v3_reference(*args, t_top=T_TOP, tags=tags)
    assert torch.equal(torch.isneginf(vk), torch.isneginf(vr))
    fin = torch.isfinite(vr)
    assert (vk[fin] - vr[fin]).abs().max().item() <= 1e-4
    assert (rk != rr).float().mean().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("tagged", [False, True])
def test_cuda_int8_kernel_is_bit_identical_to_plain_version(tagged):
    """On the card: the int8 kernel against its plain version. The integer
    dot is exact and both apply the same two scale multiplies, so values
    and rows must agree bit for bit."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels.scan_select import (
        scan_select_int8_v3,
        scan_select_int8_v3_reference,
    )

    rng = np.random.default_rng(6)
    m = torch.from_numpy(_unit(rng, 65536, 384)).cuda()
    q = torch.from_numpy(_unit(rng, 200, 384)).cuda()
    valid = torch.ones(65536, dtype=torch.int32, device="cuda")
    valid[5000:5300] = 0
    m_i8, s_row, e_l2, a_l2 = dt.prepare_int8(m)
    q_i8, t_q, u_q, v_q = dt._int8_query_bounds(q)
    args = [q_i8, m_i8, s_row, e_l2, a_l2, valid, t_q, u_q, v_q]
    tags = _cuda_tags(65536, 200, 5) if tagged else None
    before = scan_select_int8_v3.launches
    vk, rk = scan_select_int8_v3(*args, t_top=T_TOP, tags=tags)
    torch.cuda.synchronize()
    assert scan_select_int8_v3.launches == before + 1
    vr, rr = scan_select_int8_v3_reference(*args, t_top=T_TOP, tags=tags)
    assert torch.equal(vk, vr)
    assert torch.equal(rk, rr)


@pytest.mark.cuda
@pytest.mark.parametrize("tagged", [False, True])
def test_cuda_indirect_kernel_matches_plain_version(tagged):
    """On the card: K5 against its plain version at d = 384 over a tile
    list with pads and a repeated id (values within 1e-4; rows equal except
    at near-ties of the two summation orders; pad slots equal)."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels.scan_select import (
        scan_select_v3_indirect,
        scan_select_v3_indirect_reference,
    )

    rng = np.random.default_rng(8)
    n, d, b, tile_n = 65536, 384, 8, 4096
    mb, e, a = dt.prepare_tiered(torch.from_numpy(_unit(rng, n, d)).cuda())
    qb, u, v = dt._bf16_query_bounds(torch.from_numpy(_unit(rng, b, d)).cuda())
    valid = torch.ones(n, dtype=torch.int32, device="cuda")
    valid[5000:5300] = 0
    ids = torch.tensor([0, 3, 3, 7, 15, 16, 40], dtype=torch.int32, device="cuda")
    tags = None
    if tagged:
        g = torch.Generator().manual_seed(9)
        tags = tuple(x.cuda() for x in (
            torch.randint(0, 16, (n,), generator=g, dtype=torch.int32),
            *(torch.randint(0, 16, (b,), generator=g, dtype=torch.int32) & w for w in (1, 6, 8))))
    before = scan_select_v3_indirect.launches
    vk, rk = scan_select_v3_indirect(qb, mb, e, a, valid, u, v, ids, tile_n=tile_n, t_top=8, tags=tags)
    torch.cuda.synchronize()
    assert scan_select_v3_indirect.launches == before + 1
    vr, rr = scan_select_v3_indirect_reference(qb, mb, e, a, valid, u, v, ids, tile_n, 8, tags)
    assert torch.equal(torch.isneginf(vk), torch.isneginf(vr))
    fin = torch.isfinite(vr)
    assert (vk[fin] - vr[fin]).abs().max().item() <= 1e-4
    assert (rk != rr).float().mean().item() <= 1e-3
    assert torch.equal(rk[:, :, 20:], rr[:, :, 20:])  # the pad slots


@pytest.mark.cuda
@pytest.mark.parametrize("d", [15, 16, 17, 100, 520])
def test_cuda_tile_scans_at_widths_around_the_mma_depth(d):
    """K1, K5, K10a and K10b (the four entry points of one template, each on
    bf16 and on f32 rows) against their plain versions at widths below, at
    and past one 16-column mma slice, one no vector divides, and one whose
    queries stream beside the rows (past 512): values within 1e-4, rows
    equal except at near-ties, K5's and K10b's pad slots equal, and the f32
    rows bit-identical to the bf16 replica."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss

    rng = np.random.default_rng(d)
    n, b, tile_n = 16384, 70, 2048
    m = torch.from_numpy(_unit(rng, n, d)).cuda()
    mb, e, a = dt.prepare_tiered(m)
    qb, u, v = dt._bf16_query_bounds(torch.from_numpy(_unit(rng, b, d)).cuda())
    valid = torch.ones(n, dtype=torch.int32, device="cuda")
    valid[1000:1300] = 0
    ids = torch.tensor([0, 3, 3, 7, 8], dtype=torch.int32, device="cuda")
    direct = (("v3", ss.scan_select_v3, ss.scan_select_v3_reference, {}),
              ("v2", ss.scan_select_v2, ss.scan_select_v2_reference, {"tile_n": tile_n}))
    indirect = ((ss.scan_select_v3_indirect, ss.scan_select_v3_indirect_reference),
                (ss.scan_select_v2_indirect, ss.scan_select_v2_indirect_reference))
    for _, kern, ref, kw in direct:
        before = kern.launches
        vk, rk = kern(qb, mb, e, a, valid, u, v, t_top=T_TOP, **kw)
        vf, rf = kern(qb, m, e, a, valid, u, v, t_top=T_TOP, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert torch.equal(vk, vf) and torch.equal(rk, rf)
        vr, rr = ref(qb, mb, e, a, valid, u, v, T_TOP)
        assert torch.equal(torch.isneginf(vk), torch.isneginf(vr))
        fin = torch.isfinite(vr)
        assert (vk[fin] - vr[fin]).abs().max().item() <= 1e-4
        assert (rk != rr).float().mean().item() <= 1e-3
    for kern, ref in indirect:
        before = kern.launches
        vk, rk = kern(qb, mb, e, a, valid, u, v, ids, tile_n=tile_n, t_top=8)
        vf, rf = kern(qb, m, e, a, valid, u, v, ids, tile_n=tile_n, t_top=8)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert torch.equal(vk, vf) and torch.equal(rk, rf)
        vr, rr = ref(qb, mb, e, a, valid, u, v, ids, tile_n, 8)
        assert torch.equal(torch.isneginf(vk), torch.isneginf(vr))
        fin = torch.isfinite(vr)
        assert (vk[fin] - vr[fin]).abs().max().item() <= 1e-4
        assert (rk != rr).float().mean().item() <= 1e-3
        assert torch.equal(rk[:, :, 8:], rr[:, :, 8:])  # the pad slot


# -- K3 and K10c (the int8 tile scans) on exact data --------------------------------

INT8_TILE = ("scan_select_int8_v3", "scan_select_int8_v2")  # K3, K10c


def _jax_int8_tile(name, args, t_top):
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas import scan_select_v2 as jss

    jv, jr = getattr(jss, name)(*(jnp.asarray(x) for x in args), tile_n=2048, t_top=t_top, use_int8_mxu=False,
                                interpret=True)
    return np.asarray(jv), np.asarray(jr)


def _port_int8_tile(name, args, t_top):
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss

    v, r = getattr(ss, name + "_reference")(*(torch.from_numpy(x) for x in args), t_top=t_top)
    return v.numpy(), r.numpy()


@pytest.mark.parametrize("name", INT8_TILE)
def test_int8_tile_plain_matches_jax_kernel_at_the_widest_width(name):
    """K3's and K10c's plain versions against the Pallas kernels (interpret
    mode) at d = 1040 on +-127 data: sums up to d*127^2 < 2^24 stay exact,
    so values and rows agree bit for bit through the many exact ties."""
    args = [x.numpy() for x in _int8_sign_args(1040, n=4096)]
    jv, jr = _jax_int8_tile(name, args, T_TOP)
    tv, tr = _port_int8_tile(name, args, T_TOP)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    for i in (1, 2, 3):  # the planted copies: d*127^2 = 16,774,160, exact through both scales
        assert tr[i, 0, i] == i * SEL + 7 * i
        assert tv[i, 0, i] == 1040 * 127 * 127 * 0.5 * args[6][i]


@pytest.mark.parametrize("name", INT8_TILE)
@pytest.mark.parametrize("d", [17, 100])
def test_int8_tile_plain_matches_jax_kernel_on_planted_ties(name, d):
    """On exact data both versions compute every value exactly, so they agree
    bit for bit, values and rows; the planted tie resolves as the JAX code
    resolves it: rows 100 and 9 lead block 0, the tournament takes the
    higher slot (block 0's second candidate, row 9) first, and row 5, block
    0's third value, sets the tile threshold to the same value."""
    args = [x.numpy() for x in _tie_args(d, int8=True)]
    jv, jr = _jax_int8_tile(name, args, T_TOP)
    tv, tr = _port_int8_tile(name, args, T_TOP)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    assert tr[0, :2, 0].tolist() == [9, 100]
    assert tv[0, 0, 0] == tv[0, 1, 0] == tv[0, T_TOP, 0]


def _cuda_tag_pattern(pattern, n, b, seed):
    """None, or a filter with one tag word per 128-row block ("blocks") or
    per row ("rows"), as the smoke's two patterns."""
    if pattern is None:
        return None
    g = torch.Generator().manual_seed(seed)
    if pattern == "blocks":
        bits = torch.randint(0, 16, (n // BLOCK,), generator=g, dtype=torch.int32).repeat_interleave(BLOCK)
    else:
        bits = torch.randint(0, 16, (n,), generator=g, dtype=torch.int32)
    words = [torch.randint(0, 16, (b,), generator=g, dtype=torch.int32) & w for w in (1, 6, 8)]
    return tuple(t.cuda() for t in (bits, *words))


def _cuda_int8_args(d, b, n, seed):
    """Quantized unit rows (prepare_int8) with masked rows; at d = 1040 the
    +-127 rows of _int8_sign_args instead, whose dots approach 2^24."""
    if d == 1040:
        return [x.cuda() for x in _int8_sign_args(d, n=n, b=b, seed=seed)]
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(_unit(rng, n, d)).cuda()
    q = torch.from_numpy(_unit(rng, b, d)).cuda()
    valid = torch.ones(n, dtype=torch.int32, device="cuda")
    valid[1000:1300] = 0
    m_i8, s_row, e_l2, a_l2 = dt.prepare_int8(m)
    q_i8, t_q, u_q, v_q = dt._int8_query_bounds(q)
    return [q_i8, m_i8, s_row, e_l2, a_l2, valid, t_q, u_q, v_q]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [15, 16, 17, 32, 33, 100, 384, 520, 1040])
@pytest.mark.parametrize("b", [1, 65, 200, 256])
@pytest.mark.parametrize("tags", [None, "blocks", "rows"])
def test_cuda_int8_tile_scan_at_widths_and_batches(d, b, tags):
    """K3 (mma_s8.cuh's exact dot in the tile-scan program) bit for bit
    against its plain version at widths below, at and past one 32-column
    mma slice, ones no 16-byte vector divides, 384, past 512 and the widest
    (1040, sums near 2^24), at batches that fill part of one, two, four and
    all four 64-query groups, untagged and under both tag patterns."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels.scan_select import (
        scan_select_int8_v3,
        scan_select_int8_v3_reference,
    )

    n = 16384
    args = _cuda_int8_args(d, b, n, seed=d * 1000 + b)
    tg = _cuda_tag_pattern(tags, n, b, seed=d + b)
    before = scan_select_int8_v3.launches
    vk, rk = scan_select_int8_v3(*args, t_top=T_TOP, tags=tg)
    torch.cuda.synchronize()
    assert scan_select_int8_v3.launches == before + 1
    vr, rr = scan_select_int8_v3_reference(*args, t_top=T_TOP, tags=tg)
    assert torch.equal(vk, vr)
    assert torch.equal(rk, rr)


@pytest.mark.cuda
@pytest.mark.parametrize("name", INT8_TILE)
@pytest.mark.parametrize("d", [17, 100, 384])
def test_cuda_int8_tile_scans_are_bit_identical_on_planted_ties(name, d):
    """K3 and K10c on the planted-tie data: bit for bit against their plain
    versions, values and rows, with the tie resolved as the plain version
    does (rows 9, 100 at equal values, the threshold equal to them): the
    s32 tile's way through shared memory keeps every row at its lane."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ss

    args = [x.cuda() for x in _tie_args(d, n=8192, b=70, int8=True)]
    vk, rk = getattr(ss, name)(*args, t_top=T_TOP)
    torch.cuda.synchronize()
    vr, rr = getattr(ss, name + "_reference")(*args, t_top=T_TOP)
    assert torch.equal(vk, vr) and torch.equal(rk, rr)
    assert rk[0, :2, 0].tolist() == [9, 100]
