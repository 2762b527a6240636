"""The int8 and compact dense tiers of the port against the JAX package on
the same numpy inputs: the int8 scan's plain version against the Pallas
kernel (interpret mode), the replica preps, the int8 query bounds, the
int8 tile tier, the four compact layouts, and the store's compact tier
(streamed build, mutations, host patches, counters).

Tolerances, and why:
- int8 scan values: 1e-6 absolute. The dot is exact and both scale
  multiplies round alike; only the bound correction's multiply-add may be
  contracted into an fma by XLA (|corr| <~ 1e-2, so ~1e-9).
- replica norms: 1e-6 relative (sums of d squares in another order).
- compact scores: 1e-6 absolute (fp32 rescores of the same stored values:
  the JAX package's dot sums in another order, ~d·2⁻²⁴).
- exact-tier scores: 1e-5 absolute, as the bf16 tier's parity test."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from trueno_rag_tpu.chunking import Chunk as JChunk
from trueno_rag_tpu.index.vector_store import VectorStore as JVectorStore
from trueno_rag_tpu.index.vector_store import VectorStoreConfig as JVectorStoreConfig
from trueno_rag_tpu.ops import dense_tiered as jdt
from trueno_rag_tpu.ops.pallas.scan_select_v2 import scan_select_int8_v3 as jax_int8_v3
from trueno_rag_tpu_torch.chunking import Chunk as TChunk
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.index.vector_store import VectorStore as TVectorStore
from trueno_rag_tpu_torch.index.vector_store import VectorStoreConfig as TVectorStoreConfig
from trueno_rag_tpu_torch.ops import dense as tdense
from trueno_rag_tpu_torch.ops import dense_tiered as tdt
from trueno_rag_tpu_torch.ops.kernels.scan_select import (
    BLOCK,
    SEL,
    scan_select_int8_v3,
    scan_select_int8_v3_reference,
)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tags(rng, n, b):
    """Random 4-bit tag words and per-query filters mixing all/any/none."""
    bits = rng.integers(0, 16, size=n).astype(np.int32)
    t_all = np.array([1, 0, 2, 0, 1, 0, 0, 4][:b], np.int32)
    t_any = np.array([0, 6, 0, 0, 0, 9, 0, 0][:b], np.int32)
    t_none = np.array([0, 0, 1, 8, 0, 0, 2, 0][:b], np.int32)
    return bits, t_all, t_any, t_none


# -- the int8 scan (K3) ---------------------------------------------------------


def _int8_scan_both(q_i8, m_i8, s_row, e_l2, a_l2, valid, t_q, u_q, v_q, t_top, tags):
    jv, jr = jax_int8_v3(
        *(jnp.asarray(x) for x in (q_i8, m_i8, s_row, e_l2, a_l2, valid.astype(np.int32), t_q, u_q, v_q)),
        tile_n=2048, t_top=t_top, use_int8_mxu=False, interpret=True,
        tags=None if tags is None else tuple(jnp.asarray(x) for x in tags),
    )
    tv, tr = scan_select_int8_v3_reference(
        *(_t(x) for x in (q_i8, m_i8, s_row, e_l2, a_l2, valid.astype(np.int32), t_q, u_q, v_q)),
        t_top, None if tags is None else tuple(_t(x) for x in tags),
    )
    return np.asarray(jv), np.asarray(jr), tv.numpy(), tr.numpy()


@pytest.mark.parametrize("tagged", [False, True])
def test_int8_scan_reference_matches_jax_kernel(tagged):
    rng = np.random.default_rng(4)
    n, d, b = 4096, 64, 8
    m, q = _unit(rng, n, d), _unit(rng, b, d)
    m_i8, s_row, e_l2, a_l2 = (x.numpy() for x in tdt.prepare_int8(_t(m)))
    q_i8, t_q, u_q, v_q = (x.numpy() for x in tdt._int8_query_bounds(_t(q)))
    valid = np.ones(n, bool)
    valid[100:300] = False
    tags = _tags(rng, n, b) if tagged else None
    jv, jr, tv, tr = _int8_scan_both(q_i8, m_i8, s_row, e_l2, a_l2, valid, t_q, u_q, v_q, 4, tags)
    assert tv.shape == jv.shape == (b, 5, n // SEL)
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("t_top", [1, 4, 16])
def test_int8_scan_reference_matches_jax_kernel_with_exact_ties(t_top):
    """Integer grid data with unit scales and zero bound terms: every
    score is a small integer, ties are exact and frequent, and both
    versions must break them alike (highest lane in a block, highest slot
    in a tile; an all-masked block emits lane 127 twice)."""
    rng = np.random.default_rng(12)
    n, d, b = 4096, 32, 8
    m_i8 = rng.integers(-2, 3, size=(n, d)).astype(np.int8)
    q_i8 = rng.integers(-2, 3, size=(b, d)).astype(np.int8)
    ones_n, zeros_n = np.ones(n, np.float32), np.zeros(n, np.float32)
    ones_b = np.ones(b, np.float32)
    valid = np.ones(n, bool)
    valid[SEL:SEL + BLOCK] = False
    valid[2 * SEL:3 * SEL] = False  # an all-masked tile
    jv, jr, tv, tr = _int8_scan_both(q_i8, m_i8, ones_n, zeros_n, zeros_n, valid, ones_b, ones_b, ones_b, t_top, None)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)
    assert (tr[:, :, 2] == 2 * SEL + 7 * BLOCK + 127).all()  # slot 15 of the masked tile


def test_int8_scan_wrapper_dispatch_and_checks():
    rng = np.random.default_rng(0)
    n, d, b = 2048, 32, 8
    m_i8, s_row, e_l2, a_l2 = tdt.prepare_int8(_t(_unit(rng, n, d)))
    q_i8, t_q, u_q, v_q = tdt._int8_query_bounds(_t(_unit(rng, b, d)))
    args = [q_i8, m_i8, s_row, e_l2, a_l2, torch.ones(n, dtype=torch.int32), t_q, u_q, v_q]
    before = scan_select_int8_v3.launches
    got = scan_select_int8_v3(*args, t_top=3, use_int8_mxu=False)
    assert scan_select_int8_v3.launches == before  # the CPU runs the plain version
    for g, w in zip(got, scan_select_int8_v3_reference(*args, t_top=3)):
        assert torch.equal(g, w)
    bad = list(args)
    bad[1] = m_i8.float()
    with pytest.raises(InvalidConfigError):
        scan_select_int8_v3(*bad)
    wide = [torch.zeros(b, 1056, dtype=torch.int8), torch.zeros(n, 1056, dtype=torch.int8)] + args[2:]
    with pytest.raises(InvalidConfigError, match="2\\^24"):
        scan_select_int8_v3(*wide)
    with pytest.raises(InvalidConfigError):
        scan_select_int8_v3(*args, tags=(torch.zeros(n, dtype=torch.int32),) * 2)
    with pytest.raises(InvalidConfigError):
        scan_select_int8_v3(*[t.to("meta") for t in args])


# -- replica preps and query bounds ------------------------------------------------


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


def test_prepare_int8_and_residual_match_jax():
    rng = np.random.default_rng(3)
    m = _unit(rng, 3000, 64)
    m[7] = 0.0  # an all-zero row: scale 1
    for jfn, tfn in ((jdt.prepare_int8, tdt.prepare_int8), (jdt.prepare_residual, tdt.prepare_residual)):
        j = [np.asarray(x) for x in jfn(jnp.asarray(m))]
        t = [x.numpy() for x in tfn(_t(m))]
        np.testing.assert_array_equal(t[0], j[0])  # int8 codes
        np.testing.assert_array_equal(t[1], j[1])  # scales
        for jn, tn in zip(j[2:], t[2:]):
            assert _rel(tn, jn) <= 1e-6


def test_prepare_residual2_matches_jax():
    """Both levels: codes and scales equal, norms within 1e-6 relative;
    and e3_l2 is the float64 norm of what the two levels leave."""
    rng = np.random.default_rng(5)
    m = _unit(rng, 3000, 64)
    j = [np.asarray(x) for x in jdt.prepare_residual2(jnp.asarray(m))]
    t = [x.numpy() for x in tdt.prepare_residual2(_t(m))]
    for i in (0, 1, 3, 4):
        np.testing.assert_array_equal(t[i], j[i])
    for i in (2, 5):
        assert _rel(t[i], j[i]) <= 1e-6
    e = m.astype(np.float64) - torch.from_numpy(m).to(torch.bfloat16).double().numpy()
    rest = e - t[0] * t[1][:, None].astype(np.float64) - t[3] * t[4][:, None].astype(np.float64)
    np.testing.assert_allclose(t[5], np.linalg.norm(rest, axis=1), rtol=1e-4, atol=1e-9)
    assert (t[5] < 0.05 * t[2]).all()  # the second level shrinks the interval


def test_int8_query_bounds_match_jax():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((16, 96)).astype(np.float32)
    q[3] = 0.0
    j = [np.asarray(x) for x in jdt._int8_query_bounds(jnp.asarray(q))]
    t = [x.numpy() for x in tdt._int8_query_bounds(_t(q))]
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    for jn, tn in zip(j[2:], t[2:]):
        assert _rel(tn, jn) <= 1e-6


# -- the int8 tile tier ------------------------------------------------------------


def _store_data(n, d, b, seed, metric="cosine"):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n // 10: n // 8] = False
    return m, q, valid


@pytest.mark.parametrize("n,d,b,k,metric,rescore_rows,margin", [
    (6144, 48, 8, 10, "cosine", 96, 32),
    (5000, 64, 7, 10, "cosine", None, 1),  # a thin margin: some queries fail closed
    (3000, 32, 5, 20, "dot", 24, 4),  # trim below the candidate width
])
def test_int8_tiered2_checked_matches_jax(n, d, b, k, metric, rescore_rows, margin):
    m, q, valid = _store_data(n, d, b, seed=n + d + 1, metric=metric)
    kw = dict(margin_tiles=margin, metric=metric, tile_n=1024, rescore_rows=rescore_rows)
    jm = jnp.asarray(m)
    js, jr, jok = jdt.dense_topk_int8_tiered2(
        jnp.asarray(q), jm, *jdt.prepare_int8(jm), jnp.asarray(valid), k,
        use_int8_mxu=False, interpret=True, **kw,
    )
    tm = _t(m)
    tpack = tdt.prepare_int8(tm)
    ts, tr, tok = tdt.dense_topk_int8_tiered2(_t(q), tm, *tpack, _t(valid), k, **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    fin = np.isfinite(np.asarray(js))
    np.testing.assert_allclose(ts.numpy()[fin], np.asarray(js)[fin], rtol=0, atol=1e-5)
    # the checked wrapper is exact: it equals the exact fp32 path
    ts_c, tr_c, n_fb = tdt.dense_topk_int8_tiered2_checked(_t(q), tm, *tpack, _t(valid), k, **kw)
    assert n_fb == int((~tok).sum())
    ts_x, tr_x = tdense.dense_topk(_t(q), tm, _t(valid), k, metric)
    np.testing.assert_array_equal(tr_c.numpy(), tr_x.numpy())
    np.testing.assert_array_equal(ts_c.numpy(), ts_x.numpy())


# -- the compact layouts -----------------------------------------------------------


def _compact_args(pkg, layout, m):
    """The layout's replica arrays, prepared by ``pkg``'s own preps."""
    if pkg is jdt:
        m = jnp.asarray(m)
    else:
        m = _t(m)
    base = pkg.prepare_tiered(m)
    if layout == "bf16r":
        return base + pkg.prepare_residual(m)
    if layout == "bf16rr":
        return base + pkg.prepare_residual2(m)
    if layout == "int8":
        return base + pkg.prepare_int8(m)
    return base


_COMPACT = {
    "bf16r": "dense_topk_compact_bf16r",
    "bf16rr": "dense_topk_compact_bf16rr",
    "bf16": "dense_topk_compact_bf16",
    "int8": "dense_topk_compact",
}


@pytest.mark.parametrize("tagged", [False, True])
@pytest.mark.parametrize("layout", ["bf16r", "bf16rr", "bf16", "int8"])
def test_compact_layouts_match_jax(layout, tagged):
    """Rows, certified flags and scores, plus the candidates (and for
    bf16r/bf16rr the interval bounds) that feed the host patch and the
    sharded composition."""
    rng = np.random.default_rng(21)
    n, d, b, k = 8192, 32, 8, 10
    m = _unit(rng, n, d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[500:900] = False
    tags = _tags(rng, n, b) if tagged else None
    t_args = _compact_args(tdt, layout, m)
    j_args = _compact_args(jdt, layout, m)
    bounds = layout in ("bf16r", "bf16rr")
    kw = dict(tile_n=1024, rescore_rows=24, return_candidates=True)
    if bounds:
        kw["return_bounds"] = True
    if layout == "int8":
        kw["use_int8_mxu"] = False
    jout = getattr(jdt, _COMPACT[layout])(
        jnp.asarray(q), *j_args, jnp.asarray(valid), k, interpret=True,
        tags=None if tags is None else tuple(jnp.asarray(x) for x in tags), **kw,
    )
    tout = getattr(tdt, _COMPACT[layout])(
        _t(q), *t_args, _t(valid), k, tags=None if tags is None else tuple(_t(x) for x in tags), **kw,
    )
    js, jr, jok = (np.asarray(x) for x in jout[:3])
    ts, tr, tok = (x.numpy() for x in tout[:3])
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tr, jr)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), fin)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=0, atol=1e-6)
    rest = list(zip(jout[3:], tout[3:]))
    if bounds:
        (je, te), (jh, th) = rest[:2]
        np.testing.assert_allclose(_np(te), np.asarray(je), rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=0, atol=1e-6)
        rest = rest[2:]
    (jc, tc), (jt, tt) = rest
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_allclose(_np(tt), np.asarray(jt), rtol=0, atol=2e-5)
    # certified sets are the exact (filtered) top-k sets
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    true = np.where(valid[None, :], qn.astype(np.float64) @ m.T.astype(np.float64), -np.inf)
    if tags is not None:
        bits, t_all, t_any, t_none = tags
        ok = ((bits[None] & t_all[:, None]) == t_all[:, None]) & (
            (t_any[:, None] == 0) | ((bits[None] & t_any[:, None]) != 0)) & ((bits[None] & t_none[:, None]) == 0)
        true = np.where(ok, true, -np.inf)
    for i in np.flatnonzero(tok):
        assert set(tr[i].tolist()) == set(np.argsort(-true[i], kind="stable")[:k].tolist())


def test_compact_pairwise_tree_pairs_adjacent_elements():
    """The certificate's rescore rounds once per tree level, pairing
    elements (2i, 2i+1) and padding odd levels with a zero."""
    q = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0]])
    rows = torch.tensor([[[1.0, 1e8, -1e8, 1.0, 1.0]]])
    tree, levels = tdt._pairwise_tree_dot(q, rows)
    # ((1 + 2e8) + (-3e8 + 4)) + (5 + 0) in f32, level by level
    a = torch.tensor(1.0) + torch.tensor(2e8)
    b = torch.tensor(-3e8) + torch.tensor(4.0)
    want = (a + b) + torch.tensor(5.0)
    assert levels == 4 and tree.item() == want.item()


# -- the store's compact tier ----------------------------------------------------


def _chunks(cls, embs, ids):
    return [
        cls(document_id="doc", content=f"c{i}", start_offset=0, end_offset=2, embedding=e, id=cid)
        for i, (e, cid) in enumerate(zip(embs, ids))
    ]


_COUNTERS = ("compact_uncertified", "compact_candidate_patched", "compact_gemm_patched",
             "compact_retry_certified", "tier_fallbacks")


@pytest.mark.parametrize("layout,extra", [
    ("bf16r", {}),
    ("bf16rr", {}),
    ("bf16", dict(scan_margin_tiles=0)),  # thin margin: containment fails, the host GEMM patches
    ("int8", {}),
    # thin margin, no host fallback: the widened device retry and its bound
    ("bf16r", dict(compact_fallback="none", compact_retry=True, scan_margin_tiles=0)),
])
def test_compact_store_matches_jax_through_mutations(layout, extra):
    """A streamed build in several slabs (compact_prep_rows=2048 over a
    4096-row capacity), then updates, removals and inserts that scatter
    re-prepared rows: rows and counters equal the JAX store's; with the
    host fallback every result is the exact fp32 top-k."""
    rng = np.random.default_rng(31)
    n, d = 3500, 32
    embs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"id{i}" for i in range(n)]
    cfg = dict(dimension=d, scan_tier="compact", compact_scan=layout, compact_prep_rows=2048,
               scan_tile_n=1024, initial_capacity=512, **extra)
    js = JVectorStore(JVectorStoreConfig(**cfg))
    ts = TVectorStore(TVectorStoreConfig(**cfg), device="cpu")
    exact = TVectorStore(TVectorStoreConfig(dimension=d, initial_capacity=512), device="cpu")
    for cls, store in ((JChunk, js), (TChunk, ts), (TChunk, exact)):
        store.insert_many(_chunks(cls, embs, ids))
    q = rng.standard_normal((8, d)).astype(np.float32)

    def same(k):
        j_s, j_r = js.search_arrays(q, k)
        t_s, t_r = ts.search_arrays(q, k)
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-6)
        for c in _COUNTERS:
            assert getattr(ts, c) == getattr(js, c), c
        assert ts.compact_uncertified_bound == pytest.approx(js.compact_uncertified_bound, abs=1e-6)
        if ts.config.compact_fallback == "host":  # exact sets, in exact order
            _, x_r = exact.search_arrays(q, k)
            np.testing.assert_array_equal(t_r.numpy(), x_r.numpy())

    same(10)
    assert ts._tier[0].shape[0] == 4096 and ts._device_matrix is None
    with pytest.raises(InvalidConfigError):
        ts.device_matrix
    for i in (3, 400, 1999):  # tombstones
        for store in (js, ts, exact):
            assert store.remove(ids[i])
    upd = rng.standard_normal((2, d)).astype(np.float32)
    new = rng.standard_normal((3, d)).astype(np.float32)
    for cls, store in ((JChunk, js), (TChunk, ts), (TChunk, exact)):
        for c in _chunks(cls, upd, [ids[10], ids[11]]):
            store.insert(c)  # in-place updates
        store.insert_many(_chunks(cls, new, ["n0", "n1", "n2"]))  # recycled rows
    same(12)
    # the patches (or, with fallback "none", the retry) were exercised
    assert ts.compact_uncertified + ts.compact_retry_certified > 0
    # the incremental scatter equals a fresh build of the same host rows
    fresh = TVectorStore(TVectorStoreConfig(**cfg), device="cpu")
    fresh._host, fresh._valid, fresh._count = ts._host.copy(), ts._valid.copy(), ts._count
    fresh.ensure_ready()
    for a, b in zip(ts._tier, fresh._tier):
        assert torch.equal(a, b)
