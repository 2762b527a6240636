"""The v2 tile scans of the port — K10a ``scan_select_v2``, K10b
``scan_select_v2_indirect`` and K10c ``scan_select_int8_v2``, with the
per-row bound ``upper = (s + e_l2·u) + a_l2·v`` before selection — and the
inline-cast scan layout (an f32 corpus read by the bf16-query kernels,
``dense_topk_tiered2(m_bf16=None)``), against the JAX package on the same
numpy inputs; and, on a card only, the CUDA kernels against their plain
versions.

Tolerances, and why:
- K10a/K10b values on random data: 2e-5 absolute. The two frameworks sum
  d bf16 products in f32 in another order (~d·2⁻²⁴ for unit rows), and
  XLA's CPU code contracts ``s + e·u`` into an fma (one rounding fewer).
- K10c values on random data: 1e-6 absolute. The integer dot is exact and
  the scale multiplies round alike; only the bound's adds may be
  contracted by XLA (|e·u| <~ 1e-2, so ~1e-9).
- Exact data (grid values, bound norms and coefficients that are
  multiples of powers of two): bit for bit, values and rows.
- Rows on random data: equal, on seeds whose deciding values (each
  block's top-3 upper bounds and each tile's 16 pool values) are at least
  GAP apart.

JAX is imported inside the CPU tests only: the card's machine runs the
``cuda``-marked tests without JAX (``--noconftest``)."""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import dense as tdense
from trueno_rag_tpu_torch.ops import dense_tiered as tdt
from trueno_rag_tpu_torch.ops.kernels import scan_select as ss
from trueno_rag_tpu_torch.ops.kernels.scan_select import BLOCK, SEL

from test_torch_scan_select_v1 import _int8_sign_args

T_TOP = 4
GAP = 2e-5
SOUND_EPS = 1e-5  # the JAX package's own soundness pin: f32 rounding of the kernel's upper


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _tags(rng, n, b=8):
    """Random 4-bit tag words and per-query filters mixing all/any/none."""
    bits = rng.integers(0, 16, size=n).astype(np.int32)
    t_all = np.array([1, 0, 2, 0, 1, 0, 0, 4][:b], np.int32)
    t_any = np.array([0, 6, 0, 0, 0, 9, 0, 0][:b], np.int32)
    t_none = np.array([0, 0, 1, 8, 0, 0, 2, 0][:b], np.int32)
    return bits, t_all, t_any, t_none


def _keep(valid, tags, b=8):
    """[N, B] bool: the (row, query) pairs a scan does not mask."""
    keep = np.repeat(valid[:, None], b, axis=1)
    if tags is not None:
        bits, t_all, t_any, t_none = (x.astype(np.int64) for x in tags)
        bt = bits[:, None]
        keep = keep & ((bt & t_all) == t_all) & ((t_any == 0) | ((bt & t_any) != 0)) & ((bt & t_none) == 0)
    return keep


def _min_gap(upper):
    """Smallest gap among the values that decide a v2 selection: each
    block's top-3 upper bounds and each tile's 16 pool values (f64,
    -inf where masked)."""
    b = upper.shape[1]
    blocks = -np.sort(-upper.reshape(-1, BLOCK, b), axis=1)[:, :3, :]  # [G, 3, B]
    bpt = SEL // BLOCK
    pool = np.stack([blocks[:, 0, :].reshape(-1, bpt, b), blocks[:, 1, :].reshape(-1, bpt, b)], axis=1)
    pool = -np.sort(-pool.reshape(-1, 2 * bpt, b), axis=1)
    with np.errstate(invalid="ignore"):  # -inf - -inf in masked blocks
        gaps = [np.diff(-x, axis=1)[np.isfinite(x[:, 1:, :])] for x in (blocks, pool)]
    return min(g.min() for g in gaps if g.size)


def _upper64(s64, e, a, u, v, keep):
    up = s64 + e.astype(np.float64)[:, None] * u.astype(np.float64)[None, :]
    up = up + a.astype(np.float64)[:, None] * v.astype(np.float64)[None, :]
    return np.where(keep, up, -np.inf)


def _bf16_pack(m):
    """The port's prepare_tiered as numpy: (bf16 values in f32, e_l2, a_l2)."""
    mb, e, a = tdt.prepare_tiered(_t(m))
    return mb.float().numpy(), e.numpy(), a.numpy()


def _bf16_vals(x):
    return _t(x).to(torch.bfloat16).float().numpy()


def _bf16_inputs(n, d, tagged, seed0):
    """The first seed whose per-row upper bounds have no near-tie: unit
    rows, 8 unit queries, a partly and a fully masked block, bound
    coefficients that differ per query."""
    for seed in range(seed0, seed0 + 200):
        rng = np.random.default_rng(seed)
        m, q = _unit(rng, n, d), _unit(rng, 8, d)
        valid = np.ones(n, bool)
        valid[100:140] = False
        valid[5 * BLOCK:6 * BLOCK] = False
        u = rng.uniform(0.5, 1.5, 8).astype(np.float32)
        v = rng.uniform(0.0, 1e-2, 8).astype(np.float32)
        tags = _tags(rng, n) if tagged else None
        mb, e, a = _bf16_pack(m)
        qb = _bf16_vals(q)
        s64 = mb.astype(np.float64) @ qb.astype(np.float64).T
        if _min_gap(_upper64(s64, e, a, u, v, _keep(valid, tags))) >= GAP:
            return dict(m=m, q=q, mb=mb, qb=qb, e=e, a=a, valid=valid, u=u, v=v, tags=tags)
    raise AssertionError("no seed without near-ties")


def _grid_inputs(n, seed, b=8):
    """Exact data: entries multiples of 1/4 in [-1/2, 1/2] (exact in bf16),
    norms in {0, 1/4, 1/2, 1} and coefficients in {1/8, 1/4, 1/2}, so every
    upper bound is an exact multiple of 1/32 in f32 whatever the order of
    the sums and whether a multiply-add is fused; ties are exact and
    frequent. A masked block and an all-masked tile."""
    rng = np.random.default_rng(seed)
    d = 32
    m = (rng.integers(-2, 3, size=(n, d)) / 4.0).astype(np.float32)
    q = (rng.integers(-2, 3, size=(b, d)) / 4.0).astype(np.float32)
    levels = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    coeffs = np.array([0.125, 0.25, 0.5], np.float32)
    valid = np.ones(n, bool)
    valid[SEL:SEL + BLOCK] = False
    valid[2 * SEL:3 * SEL] = False
    return dict(m=m, q=q, mb=m, qb=q, e=levels[rng.integers(0, 4, n)], a=levels[rng.integers(0, 4, n)],
                valid=valid, u=coeffs[rng.integers(0, 3, b)], v=coeffs[rng.integers(0, 3, b)], tags=None,
                rng=rng)


# -- the bf16 scans: K10a and K10b -------------------------------------------------


def _jax_bf16(fn_name, x, t_top, **kw):
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas import scan_select_v2 as jss

    fn = getattr(jss, fn_name)
    args = [jnp.asarray(x["qb"]).astype(jnp.bfloat16), jnp.asarray(x["mb"]).astype(jnp.bfloat16),
            jnp.asarray(x["e"]), jnp.asarray(x["a"]), jnp.asarray(x["valid"].astype(np.int32)),
            jnp.asarray(x["u"]), jnp.asarray(x["v"])]
    if "tile_ids" in kw:
        args.append(jnp.asarray(kw.pop("tile_ids")))
    tags = None if x["tags"] is None else tuple(jnp.asarray(t) for t in x["tags"])
    jv, jr = fn(*args, t_top=t_top, interpret=True, tags=tags, **kw)
    return np.asarray(jv), np.asarray(jr)


def _port_bf16(fn, x, t_top, *extra):
    args = [_t(x["qb"]).to(torch.bfloat16), _t(x["mb"]).to(torch.bfloat16), _t(x["e"]), _t(x["a"]),
            _t(x["valid"].astype(np.int32)), _t(x["u"]), _t(x["v"])]
    tags = None if x["tags"] is None else tuple(_t(t) for t in x["tags"])
    v, r = fn(*args, *extra, t_top=t_top, tags=tags)
    return v.numpy(), r.numpy()


def _assert_close(tv, tr, jv, jr, atol):
    assert tv.shape == jv.shape and tr.shape == jr.shape
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=atol)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("d", [32, 96, 100])
@pytest.mark.parametrize("tagged", [False, True])
def test_v2_reference_matches_jax_kernel(d, tagged):
    x = _bf16_inputs(4096, d, tagged, seed0=d)
    jv, jr = _jax_bf16("scan_select_v2", x, T_TOP, tile_n=2048)
    tv, tr = _port_bf16(ss.scan_select_v2_reference, x, T_TOP)
    assert tv.shape == (8, T_TOP + 1, 4)
    _assert_close(tv, tr, jv, jr, 2e-5)


@pytest.mark.parametrize("t_top,tagged", [(1, False), (4, True), (16, False)])
def test_v2_reference_matches_jax_kernel_with_exact_ties(t_top, tagged):
    """Grid data: both versions break the many exact ties alike (highest
    lane in a block, highest slot in a tile; a taken entry is replaced by
    -inf, so an all-masked tile emits its last lane from slot 15)."""
    x = _grid_inputs(4096, seed=7)
    if tagged:
        x["tags"] = _tags(x["rng"], 4096)
    jv, jr = _jax_bf16("scan_select_v2", x, t_top, tile_n=1024)
    tv, tr = _port_bf16(ss.scan_select_v2_reference, x, t_top)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    assert (tr[:, :, 2] == 2 * SEL + 7 * BLOCK + 127).all()


def _indirect_ids():
    return np.array([3, 0, 4, 3, 9], np.int32)  # 4 corpus tiles of 2048: 4 and 9 pad, 3 repeated


@pytest.mark.parametrize("tagged", [False, True])
def test_v2_indirect_reference_matches_jax_kernel(tagged):
    """A ragged tile list: unsorted, a repeated id and two pad slots."""
    x = _bf16_inputs(8192, 32, tagged, seed0=300)
    ids = _indirect_ids()
    jv, jr = _jax_bf16("scan_select_v2_indirect", x, T_TOP, tile_ids=ids, tile_n=2048)
    tv, tr = _port_bf16(ss.scan_select_v2_indirect_reference, x, T_TOP, _t(ids), 2048)
    assert tv.shape == (8, T_TOP + 1, len(ids) * 2)
    _assert_close(tv, tr, jv, jr, 2e-5)
    # pad slots: -inf values and rows from the unclamped id
    assert np.isneginf(tv[:, :, 4:6]).all() and np.isneginf(tv[:, :, 8:10]).all()
    assert (tr[:, :, 9] == 9 * 2048 + SEL + 7 * BLOCK + 127).all()


@pytest.mark.parametrize("t_top", [1, 16])
def test_v2_indirect_reference_matches_jax_kernel_with_exact_ties(t_top):
    x = _grid_inputs(8192, seed=21)
    ids = np.array([2, 5, 5, 7, 8], np.int32)  # 8 tiles of 1024: 8 pads, 2 all masked
    jv, jr = _jax_bf16("scan_select_v2_indirect", x, t_top, tile_ids=ids, tile_n=1024)
    tv, tr = _port_bf16(ss.scan_select_v2_indirect_reference, x, t_top, _t(ids), 1024)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)


# -- the int8 scan: K10c ------------------------------------------------------------


def _jax_int8(x, t_top):
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops.pallas.scan_select_v2 import scan_select_int8_v2

    tags = None if x["tags"] is None else tuple(jnp.asarray(t) for t in x["tags"])
    jv, jr = scan_select_int8_v2(
        *(jnp.asarray(x[k]) for k in ("q8", "m8", "s_row", "e", "a")),
        jnp.asarray(x["valid"].astype(np.int32)), *(jnp.asarray(x[k]) for k in ("t_q", "u", "v")),
        tile_n=2048, t_top=t_top, use_int8_mxu=False, interpret=True, tags=tags,
    )
    return np.asarray(jv), np.asarray(jr)


def _int8_args(x):
    return [_t(x[k]) for k in ("q8", "m8", "s_row", "e", "a")] + [
        _t(x["valid"].astype(np.int32))] + [_t(x[k]) for k in ("t_q", "u", "v")]


def _port_int8(x, t_top, fn=ss.scan_select_int8_v2_reference):
    tags = None if x["tags"] is None else tuple(_t(t) for t in x["tags"])
    v, r = fn(*_int8_args(x), t_top=t_top, tags=tags)
    return v.numpy(), r.numpy()


def _int8_inputs(n, d, tagged, seed0):
    for seed in range(seed0, seed0 + 200):
        rng = np.random.default_rng(seed)
        m, q = _unit(rng, n, d), _unit(rng, 8, d)
        m8, s_row, e, a = (t.numpy() for t in tdt.prepare_int8(_t(m)))
        q8, t_q, u, v = (t.numpy() for t in tdt._int8_query_bounds(_t(q)))
        valid = np.ones(n, bool)
        valid[100:300] = False
        tags = _tags(rng, n) if tagged else None
        s64 = (m8.astype(np.float64) @ q8.astype(np.float64).T) * s_row[:, None] * t_q[None, :]
        if _min_gap(_upper64(s64, e, a, u, v, _keep(valid, tags))) >= GAP:
            return dict(m=m, q=q, m8=m8, q8=q8, s_row=s_row, t_q=t_q, e=e, a=a, u=u, v=v, valid=valid,
                        tags=tags)
    raise AssertionError("no seed without near-ties")


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("tagged", [False, True])
def test_int8_v2_reference_matches_jax_kernel(d, tagged):
    x = _int8_inputs(4096, d, tagged, seed0=40 + d)
    jv, jr = _jax_int8(x, T_TOP)
    tv, tr = _port_int8(x, T_TOP)
    assert tv.shape == (8, T_TOP + 1, 4)
    _assert_close(tv, tr, jv, jr, 1e-6)


@pytest.mark.parametrize("t_top,tagged", [(1, False), (4, True), (16, False)])
def test_int8_v2_reference_matches_jax_kernel_with_exact_ties(t_top, tagged):
    """Integer grid codes with scales in {1/2, 1} and {1, 2}: every upper
    bound is an exact multiple of 1/32, so both versions agree bit for
    bit and break the many exact ties alike."""
    x = _grid_inputs(4096, seed=12)
    rng = x["rng"]
    x.update(m8=(x["m"] * 4).astype(np.int8), q8=(x["q"] * 4).astype(np.int8),
             s_row=np.array([0.5, 1.0], np.float32)[rng.integers(0, 2, 4096)],
             t_q=np.array([1.0, 2.0], np.float32)[rng.integers(0, 2, 8)])
    if tagged:
        x["tags"] = _tags(rng, 4096)
    jv, jr = _jax_int8(x, t_top)
    tv, tr = _port_int8(x, t_top)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    assert (tr[:, :, 2] == 2 * SEL + 7 * BLOCK + 127).all()


# -- soundness ------------------------------------------------------------------------


def _check_dominates(vp, rp, upper, row0, t_top, eps):
    """Every emitted value >= its row's upper - eps, every tile threshold
    >= the upper of every row of its tile not emitted - eps; rows inside
    their tile. ``upper [N, B]`` f64 (-inf where masked)."""
    b, _, g = vp.shape
    for bi in range(b):
        for col in range(g):
            r0 = row0(col)
            live = np.isfinite(vp[bi, :t_top, col])
            rows = rp[bi, :t_top, col][live]
            assert ((rows >= r0) & (rows < r0 + SEL)).all()
            assert (vp[bi, :t_top, col][live].astype(np.float64) >= upper[rows, bi] - eps).all()
            rest = np.setdiff1d(np.arange(r0, r0 + SEL), rows)
            assert float(vp[bi, t_top, col]) >= upper[rest, bi].max() - eps


@pytest.mark.parametrize("kernel", ["scan_select_v2", "scan_select_v2_indirect", "scan_select_int8_v2"])
def test_v2_packs_dominate_the_per_row_float64_upper(kernel):
    """Ported from the JAX package's v3 soundness pin, for the per-row
    form: with u = 1.01 and v = 1e-6, every emitted value and every tile
    threshold dominates the per-row float64 upper bound s + e·u + a·v of
    the rows it covers (within the f32 rounding of the kernel's own
    upper); and with the production bound coefficients they dominate the
    float64 true score outright."""
    rng = np.random.default_rng(3)
    n, d, b = 4096, 32, 8
    m, q = _unit(rng, n, d), _unit(rng, b, d)
    valid = np.ones(n, bool)
    valid[100:140] = False
    keep = np.repeat(valid[:, None], b, axis=1)
    tm, tq, tv_ = _t(m), _t(q), _t(valid.astype(np.int32))
    ids = _t(np.array([1, 0, 3, 7], np.int32))  # tiles of 1024; 7 pads
    row0 = (lambda g: g * SEL) if kernel != "scan_select_v2_indirect" else (lambda g: [1, 0, 3][g] * SEL)
    true = np.where(keep, m.astype(np.float64) @ q.astype(np.float64).T, -np.inf)

    def run(u, v):
        if kernel == "scan_select_int8_v2":
            m8, s_row, e, a = tdt.prepare_int8(tm)
            q8, t_q, _, _ = tdt._int8_query_bounds(tq)
            vp, rp = ss.scan_select_int8_v2_reference(q8, m8, s_row, e, a, tv_, t_q, u, v, T_TOP)
            s64 = (m8.double() @ q8.double().T) * s_row.double()[:, None] * t_q.double()[None, :]
        else:
            mb, e, a = tdt.prepare_tiered(tm)
            qb = tq.to(torch.bfloat16)
            if kernel == "scan_select_v2":
                vp, rp = ss.scan_select_v2_reference(qb, mb, e, a, tv_, u, v, T_TOP)
            else:
                vp, rp = ss.scan_select_v2_indirect_reference(qb, mb, e, a, tv_, u, v, ids, 1024, T_TOP)
            s64 = mb.double() @ qb.double().T
        return vp.numpy(), rp.numpy(), _upper64(s64.numpy(), e.numpy(), a.numpy(), u.numpy(), v.numpy(), keep)

    vp, rp, upper = run(torch.full((b,), 1.01), torch.full((b,), 1e-6))
    cols = 3 if kernel == "scan_select_v2_indirect" else n // SEL
    _check_dominates(vp[:, :, :cols], rp[:, :, :cols], upper, row0, T_TOP, SOUND_EPS)
    if kernel == "scan_select_int8_v2":
        _, _, u, v = tdt._int8_query_bounds(tq)
    else:
        _, u, v = tdt._bf16_query_bounds(tq)
    vp, rp, _ = run(u, v)
    _check_dominates(vp[:, :, :cols], rp[:, :, :cols], true, row0, T_TOP, 0.0)
    if kernel == "scan_select_v2_indirect":
        assert np.isneginf(vp[:, :, 3]).all()


# -- the inline-cast layout -------------------------------------------------------------


def _bf16_kernel(name, x, m, ids=None):
    fn = getattr(ss, name)
    args = [_t(x["q"]).to(torch.bfloat16), m, _t(x["e"]), _t(x["a"]), _t(x["valid"].astype(np.int32)),
            _t(x["u"]), _t(x["v"])]
    if ids is not None:
        return fn(*args, _t(ids), tile_n=2048, t_top=T_TOP)
    return fn(*args, t_top=T_TOP)


@pytest.mark.parametrize("d", [32, 100])
@pytest.mark.parametrize("name", ["scan_select_v3", "scan_select_v3_indirect", "scan_select_v2",
                                  "scan_select_v2_indirect"])
def test_packs_on_f32_rows_equal_the_bf16_replicas(name, d):
    """K1, K5, K10a and K10b over the f32 corpus (rounded to bf16 as it is
    read, the same round-to-nearest-even as prepare_tiered) give the packs
    of the same scan over the bf16 replica, bit for bit."""
    x = _bf16_inputs(8192, d, False, seed0=500 + d)
    ids = _indirect_ids() if "indirect" in name else None
    v32, r32 = _bf16_kernel(name, x, _t(x["m"]), ids)
    v16, r16 = _bf16_kernel(name, x, _t(x["m"]).to(torch.bfloat16), ids)
    assert torch.equal(v32, v16) and torch.equal(r32, r16)


def _store(n, d, b, seed):
    rng = np.random.default_rng(seed)
    m = _unit(rng, n, d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n // 10: n // 8] = False
    return m, q, valid


def test_tiered2_inline_cast_bit_identical_to_replica():
    """Ported from the JAX package's pin: m_bf16=None streams the fp32
    matrix through the scan, so scores, rows and certificates are
    bit-identical to the replica layout's; and both equal the JAX
    package's inline-cast run (rows, certificates; scores within 1e-5)."""
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops import dense_tiered as jdt

    m, q, valid = _store(8192, 96, 6, seed=31)
    tm = _t(m)
    _, e, a = tdt.prepare_tiered(tm)
    rep = tdt.dense_topk_tiered2(_t(q), tm, tm.to(torch.bfloat16), e, a, _t(valid), 12, tile_n=1024)
    inl = tdt.dense_topk_tiered2(_t(q), tm, None, e, a, _t(valid), 12, tile_n=1024)
    for x, y in zip(rep, inl):
        assert torch.equal(x, y)
    jm = jnp.asarray(m)
    _, je, ja = jdt.prepare_tiered(jm)
    js, jr, jok = jdt.dense_topk_tiered2(jnp.asarray(q), jm, None, je, ja, jnp.asarray(valid), 12,
                                         tile_n=1024, interpret=True)
    np.testing.assert_array_equal(inl[1].numpy(), np.asarray(jr))
    np.testing.assert_array_equal(inl[2].numpy(), np.asarray(jok))
    np.testing.assert_allclose(inl[0].numpy(), np.asarray(js), rtol=0, atol=1e-5)


def test_tiered2_checked_inline_matches_oracle():
    """Ported from the JAX package's pin: the checked inline-cast tier
    equals the exact fp32 path, rows and scores."""
    m, q, valid = _store(5000, 64, 7, seed=41)
    tm = _t(m)
    _, e, a = tdt.prepare_tiered(tm)
    s_c, r_c, n_fb = tdt.dense_topk_tiered2_checked(_t(q), tm, None, e, a, _t(valid), 10, tile_n=1024)
    s_x, r_x = tdense.dense_topk(_t(q), tm, _t(valid), 10, "cosine")
    assert torch.equal(r_c, r_x) and torch.equal(s_c, s_x)
    assert 0 <= n_fb <= 7


# -- the keywords of the JAX signatures --------------------------------------------------


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_approx_select_false_matches_jax(tier):
    """``approx_select=False`` (exact selectors with the (k+1)-th value as
    the threshold) on both tile tiers against the JAX package: rows and
    certificates equal, scores within 1e-5; a trim below the candidate
    width runs the trim's selector too. The checked wrappers take the
    keyword (and ``use_int8_mxu`` on int8) and stay exact."""
    jnp = pytest.importorskip("jax.numpy")
    from trueno_rag_tpu.ops import dense_tiered as jdt

    m, q, valid = _store(6144, 48, 8, seed=17)
    tm, jm = _t(m), jnp.asarray(m)
    kw = dict(margin_tiles=4, rescore_rows=24, approx_select=False)
    if tier == "bf16":
        tpack, jpack = tdt.prepare_tiered(tm), jdt.prepare_tiered(jm)
        t_fn, t_chk, j_fn = tdt.dense_topk_tiered2, tdt.dense_topk_tiered2_checked, jdt.dense_topk_tiered2
    else:
        tpack = tdt.prepare_int8(tm)
        jpack = tuple(jnp.asarray(x.numpy()) for x in tpack)
        t_fn, t_chk, j_fn = tdt.dense_topk_int8_tiered2, tdt.dense_topk_int8_tiered2_checked, jdt.dense_topk_int8_tiered2
        kw["use_int8_mxu"] = False
    js, jr, jok = j_fn(jnp.asarray(q), jm, *jpack, jnp.asarray(valid), 10, interpret=True, **kw)
    ts, tr, tok = t_fn(_t(q), tm, *tpack, _t(valid), 10, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    cs, cr, n_fb = t_chk(_t(q), tm, *tpack, _t(valid), 10, **kw)
    xs, xr = tdense.dense_topk(_t(q), tm, _t(valid), 10, "cosine")
    assert torch.equal(cr, xr) and torch.equal(cs, xs)
    assert n_fb == int((~tok).sum())


# -- the wrappers -------------------------------------------------------------------------


def _small(n=4096, d=16, b=8, seed=0):
    rng = np.random.default_rng(seed)
    m, q = _unit(rng, n, d), _unit(rng, b, d)
    mb, e, a = tdt.prepare_tiered(_t(m))
    qb, u, v = tdt._bf16_query_bounds(_t(q))
    m8, s_row, e8, a8 = tdt.prepare_int8(_t(m))
    q8, t_q, u8, v8 = tdt._int8_query_bounds(_t(q))
    valid = torch.ones(n, dtype=torch.int32)
    return dict(bf16=[qb, mb, e, a, valid, u, v], int8=[q8, m8, s_row, e8, a8, valid, t_q, u8, v8],
                ids=torch.tensor([1, 0, 5], dtype=torch.int32))


@pytest.mark.parametrize("name", ["scan_select_v2", "scan_select_v2_indirect", "scan_select_int8_v2"])
def test_v2_wrappers_run_the_plain_versions_for_cpu_tensors(name):
    s = _small()
    fn, ref = getattr(ss, name), getattr(ss, name + "_reference")
    args = s["int8"] if "int8" in name else s["bf16"] + ([s["ids"]] if "indirect" in name else [])
    extra = (1024,) if "indirect" in name else ()
    before = fn.launches
    got = fn(*args, tile_n=1024, t_top=3)
    want = ref(*args, *extra, t_top=3)
    assert fn.launches == before  # nothing launched on the CPU
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(InvalidConfigError):  # a device without a kernel
        fn(*(x.to("meta") for x in args), tile_n=1024)


@pytest.mark.parametrize("case", ["tile_n_not_1024", "tile_n_not_dividing", "f16_corpus", "int8_wrong_e",
                                  "t_top_17"])
def test_v2_wrappers_reject_what_the_kernels_do_not_take(case):
    s = _small()
    bf, i8 = s["bf16"], s["int8"]
    with pytest.raises(InvalidConfigError):
        if case == "tile_n_not_1024":
            ss.scan_select_v2(*bf, tile_n=1536)
        elif case == "tile_n_not_dividing":
            ss.scan_select_v2_indirect(*bf, s["ids"], tile_n=8192)
        elif case == "f16_corpus":
            ss.scan_select_v2(bf[0], bf[1].half(), *bf[2:])
        elif case == "int8_wrong_e":
            ss.scan_select_int8_v2(*i8[:3], i8[3][:100], *i8[4:])
        else:
            ss.scan_select_int8_v2(*i8, t_top=17)


# -- on the card ------------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()


def _cuda_tags(n, b, seed):
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 16, (n,), generator=g, dtype=torch.int32)
    words = [torch.randint(0, 16, (b,), generator=g, dtype=torch.int32) & w for w in (1, 6, 8)]
    return tuple(t.cuda() for t in (bits, *words))


def _cuda_bf16(d, seed, n=65536, b=200):
    rng = np.random.default_rng(seed)
    m = _t(_unit(rng, n, d)).cuda()
    mb, e, a = tdt.prepare_tiered(m)
    qb, u, v = tdt._bf16_query_bounds(_t(_unit(rng, b, d)).cuda())
    valid = torch.ones(n, dtype=torch.int32, device="cuda")
    valid[5000:5300] = 0
    return m, [qb, mb, e, a, valid, u, v]


_IDS = [0, 3, 3, 7, 15, 16, 40]  # 16 tiles of 4096: a repeated id, two pads


@pytest.mark.cuda
@pytest.mark.parametrize("name,tagged,d", [
    ("scan_select_v2", False, 384), ("scan_select_v2", True, 384), ("scan_select_v2", False, 100),
    ("scan_select_v2_indirect", False, 384), ("scan_select_v2_indirect", True, 384),
])
def test_cuda_v2_kernels_match_plain_versions(name, tagged, d):
    """On the card: K10a/K10b against their plain versions on CUDA tensors
    (values within 1e-4; rows equal except at near-ties of the two
    summation orders; K10b's pad slots equal)."""
    _cuda_or_skip()
    _, args = _cuda_bf16(d, seed=3)
    b = args[0].shape[0]
    tags = _cuda_tags(65536, b, 4) if tagged else None
    fn, ref = getattr(ss, name), getattr(ss, name + "_reference")
    extra = (torch.tensor(_IDS, dtype=torch.int32, device="cuda"), 4096) if "indirect" in name else ()
    before = fn.launches
    if extra:
        vk, rk = fn(*args, extra[0], tile_n=4096, t_top=8, tags=tags)
        vr, rr = ref(*args, *extra, t_top=8, tags=tags)
    else:
        vk, rk = fn(*args, t_top=T_TOP, tags=tags)
        vr, rr = ref(*args, t_top=T_TOP, tags=tags)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(torch.isneginf(vk), torch.isneginf(vr))
    fin = torch.isfinite(vr)
    assert (vk[fin] - vr[fin]).abs().max().item() <= 1e-4
    assert (rk != rr).float().mean().item() <= 1e-3
    if extra:
        assert torch.equal(rk[:, :, 20:], rr[:, :, 20:])  # the pad slots


@pytest.mark.cuda
@pytest.mark.parametrize("tagged,d", [(False, 384), (True, 384), (False, 100)])
def test_cuda_int8_v2_kernel_is_bit_identical_to_plain_version(tagged, d):
    """On the card: K10c against its plain version, bit for bit (exact
    integer dot; the scale multiplies and the bound's products and sums
    rounded one by one in both)."""
    _cuda_or_skip()
    rng = np.random.default_rng(6)
    m = _t(_unit(rng, 65536, d)).cuda()
    q = _t(_unit(rng, 200, d)).cuda()
    valid = torch.ones(65536, dtype=torch.int32, device="cuda")
    valid[5000:5300] = 0
    m8, s_row, e, a = tdt.prepare_int8(m)
    q8, t_q, u, v = tdt._int8_query_bounds(q)
    args = [q8, m8, s_row, e, a, valid, t_q, u, v]
    tags = _cuda_tags(65536, 200, 5) if tagged else None
    before = ss.scan_select_int8_v2.launches
    vk, rk = ss.scan_select_int8_v2(*args, t_top=T_TOP, tags=tags)
    torch.cuda.synchronize()
    assert ss.scan_select_int8_v2.launches == before + 1
    vr, rr = ss.scan_select_int8_v2_reference(*args, t_top=T_TOP, tags=tags)
    assert torch.equal(vk, vr) and torch.equal(rk, rr)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [384, 100])
@pytest.mark.parametrize("name", ["scan_select_v3", "scan_select_v3_indirect", "scan_select_v2",
                                  "scan_select_v2_indirect"])
def test_cuda_f32_rows_are_bit_identical_to_the_bf16_replica(name, d):
    """On the card: K1, K5, K10a and K10b over the f32 corpus give the
    packs of the same kernel over its bf16 replica, bit for bit."""
    _cuda_or_skip()
    m, args = _cuda_bf16(d, seed=9)
    fn = getattr(ss, name)
    extra = (torch.tensor(_IDS, dtype=torch.int32, device="cuda"),) if "indirect" in name else ()
    kw = dict(tile_n=4096) if extra else {}
    v16, r16 = fn(*args, *extra, t_top=T_TOP, **kw)
    v32, r32 = fn(args[0], m, *args[2:], *extra, t_top=T_TOP, **kw)
    torch.cuda.synchronize()
    assert torch.equal(v32, v16) and torch.equal(r32, r16)


@pytest.mark.cuda
def test_cuda_tiered2_inline_cast_equals_replica():
    """On the card: ``dense_topk_tiered2_checked(m_bf16=None)`` equals the
    replica run (scores, rows, fallback count) and the exact path."""
    _cuda_or_skip()
    rng = np.random.default_rng(13)
    m = _t(_unit(rng, 65536, 384)).cuda()
    q = _t(rng.standard_normal((64, 384)).astype(np.float32)).cuda()
    valid = torch.ones(65536, dtype=torch.bool, device="cuda")
    mb, e, a = tdt.prepare_tiered(m)
    rep = tdt.dense_topk_tiered2_checked(q, m, mb, e, a, valid, 20)
    inl = tdt.dense_topk_tiered2_checked(q, m, None, e, a, valid, 20)
    assert torch.equal(rep[0], inl[0]) and torch.equal(rep[1], inl[1]) and rep[2] == inl[2]
    xs, xr = tdense.dense_topk(q, m, valid, 20, "cosine")
    assert torch.equal(inl[1], xr) and torch.equal(inl[0], xs)


def _cuda_int8_sweep_args(d, b, n, seed):
    """K10c's sweep data: quantized unit rows (prepare_int8) with masked
    rows; at d = 1040 the +-127 rows of _int8_sign_args instead, whose dots
    approach 2^24."""
    if d == 1040:
        return [x.cuda() for x in _int8_sign_args(d, n=n, b=b, seed=seed)]
    rng = np.random.default_rng(seed)
    valid = torch.ones(n, dtype=torch.int32, device="cuda")
    valid[1000:1300] = 0
    m8, s_row, e, a = tdt.prepare_int8(_t(_unit(rng, n, d)).cuda())
    q8, t_q, u, v = tdt._int8_query_bounds(_t(_unit(rng, b, d)).cuda())
    return [q8, m8, s_row, e, a, valid, t_q, u, v]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [15, 16, 17, 32, 33, 100, 384, 520, 1040])
@pytest.mark.parametrize("b", [1, 65, 200, 256])
@pytest.mark.parametrize("tagged", [False, True])
def test_cuda_int8_v2_at_widths_and_batches(d, b, tagged):
    """K10c (K3's tile-scan program with the per-row bound, on mma_s8.cuh's
    exact dot) bit for bit against its plain version at widths around the
    32-column mma slice and the 16-byte vector, 384, past 512 and the widest
    (1040), at batches filling part of one to all four 64-query groups,
    untagged and with a per-row tag filter."""
    _cuda_or_skip()
    n = 16384
    args = _cuda_int8_sweep_args(d, b, n, seed=d * 1000 + b)
    tags = _cuda_tags(n, b, d + b) if tagged else None
    before = ss.scan_select_int8_v2.launches
    vk, rk = ss.scan_select_int8_v2(*args, t_top=T_TOP, tags=tags)
    torch.cuda.synchronize()
    assert ss.scan_select_int8_v2.launches == before + 1
    vr, rr = ss.scan_select_int8_v2_reference(*args, t_top=T_TOP, tags=tags)
    assert torch.equal(vk, vr) and torch.equal(rk, rr)
