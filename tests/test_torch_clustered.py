"""The clustered tier's ops in the port against the JAX package on the same
numpy inputs: the tile-indirect scan K5's plain version against the Pallas
kernel (interpret mode), the three builds (host, device, stream) and their
contract, and the pruned query op with both fetches.

Tolerances, and why:
- scan values: 2e-5 absolute on data without near-ties, bit equality on
  exact-tie grid data (as tests/test_torch_scan_select.py for K1);
- centroids: 1e-6 absolute and radii 1e-6 relative (the same f64 host
  arithmetic; the device builds sum their f32 passes in another order);
- query scores: 1e-6 absolute (fp32 rescores of the same stored values,
  the JAX package's dots summing in another order, ~d·2⁻²⁴)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from trueno_rag_tpu.ops import clustered as jcl
from trueno_rag_tpu.ops import dense_tiered as jdt
from trueno_rag_tpu.ops.pallas.scan_select_v2 import scan_select_v3_indirect as jax_indirect
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops import clustered as tcl
from trueno_rag_tpu_torch.ops import dense_tiered as tdt
from trueno_rag_tpu_torch.ops.kernels.scan_select import (
    BLOCK,
    SEL,
    scan_select_v3_indirect,
    scan_select_v3_indirect_reference,
)

TILE = 1024  # the kernel's SEL floor: the smallest legal tile
T_TOP = 4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _blobs(n=16_384, d=32, blobs=16, seed=0, sigma=0.05, planted=0):
    """Balanced unit-norm Gaussian blobs, one per TILE rows (as
    tests/test_clustered.py); ``planted`` near-duplicates of each center
    clear the blob mass, so a query at a center certifies."""
    rng = np.random.default_rng(seed)
    centers = _unit(rng, blobs, d)
    which = np.repeat(np.arange(blobs), n // blobs)[:n]
    m = centers[which] + sigma * rng.standard_normal((n, d)).astype(np.float32)
    for b in range(blobs):
        rows = np.flatnonzero(which == b)[:planted]
        m[rows] = centers[b] + 0.01 * rng.standard_normal((len(rows), d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m.astype(np.float32), centers


# -- K5: the tile-indirect scan --------------------------------------------------


def _indirect_both(m, q, valid, u, v, tile_ids, tile_n, t_top, tags=None):
    mb, e, a = jdt.prepare_tiered(jnp.asarray(m))
    jv, jr = jax_indirect(
        jnp.asarray(q).astype(jnp.bfloat16), mb, e, a, jnp.asarray(valid.astype(np.int32)),
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(tile_ids), tile_n=tile_n, t_top=t_top,
        interpret=True, tags=None if tags is None else tuple(jnp.asarray(x) for x in tags),
    )
    tmb, te, ta = tdt.prepare_tiered(_t(m))
    tv, tr = scan_select_v3_indirect_reference(
        _t(q).to(torch.bfloat16), tmb, te, ta, _t(valid.astype(np.int32)), _t(u), _t(v),
        _t(tile_ids), tile_n, t_top, None if tags is None else tuple(_t(x) for x in tags),
    )
    return np.asarray(jv), np.asarray(jr), tv.numpy(), tr.numpy()


@pytest.mark.parametrize("tagged", [False, True])
def test_indirect_reference_matches_jax_kernel(tagged):
    """Separated data (the seed is checked for near-ties by the K1 test's
    helper), a tile list with a repeated id and two pad slots."""
    from tests.test_torch_scan_select import GAP, _min_gap

    n, d, b, tile_n = 8192, 32, 8, 2048
    for seed in range(200):
        rng = np.random.default_rng(seed)
        m, q = _unit(rng, n, d), _unit(rng, b, d)
        valid = np.ones(n, bool)
        valid[100:140] = False
        valid[5 * BLOCK:6 * BLOCK] = False
        u = np.full(b, 1.01, np.float32)
        v = np.full(b, 1e-6, np.float32)
        if _min_gap(q, m, valid, u.astype(np.float64), v.astype(np.float64)) >= GAP:
            break
    tile_ids = np.array([3, 0, 4, 3, 9], np.int32)  # 4 and 9: pads (4 tiles)
    tags = None
    if tagged:
        tags = (rng.integers(0, 16, size=n).astype(np.int32), np.array([1, 0, 2, 0, 1, 0, 4, 0], np.int32),
                np.array([0, 6, 0, 0, 0, 9, 0, 0], np.int32), np.array([0, 0, 1, 8, 0, 0, 0, 3], np.int32))
    jv, jr, tv, tr = _indirect_both(m, q, valid, u, v, tile_ids, tile_n, T_TOP, tags)
    assert tv.shape == jv.shape == (b, T_TOP + 1, len(tile_ids) * tile_n // SEL)
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tr, jr)
    # pad slots: -inf values and rows from the unclamped id
    assert np.isneginf(tv[:, :, 4:6]).all() and np.isneginf(tv[:, :, 8:10]).all()
    assert (tr[:, :, 9] == 9 * tile_n + SEL + 7 * BLOCK + 127).all()


@pytest.mark.parametrize("t_top", [1, 16])
def test_indirect_reference_matches_jax_kernel_with_exact_ties(t_top):
    """Grid data (exact multiples of 1/16 in f32, e_l2 = 0): exact ties
    everywhere, broken alike (highest lane, highest slot)."""
    rng = np.random.default_rng(21)
    n, d, b, tile_n = 8192, 32, 8, 1024
    m = (rng.integers(-2, 3, size=(n, d)) / 4.0).astype(np.float32)
    q = (rng.integers(-2, 3, size=(b, d)) / 4.0).astype(np.float32)
    valid = np.ones(n, bool)
    valid[2 * SEL:3 * SEL] = False  # an all-masked tile
    u = np.full(b, 1.01, np.float32)
    v = np.full(b, 1e-6, np.float32)
    tile_ids = np.array([2, 5, 5, 7, 8], np.int32)
    jv, jr, tv, tr = _indirect_both(m, q, valid, u, v, tile_ids, tile_n, t_top)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tr, jr)


def test_indirect_wrapper_dispatch_and_checks():
    rng = np.random.default_rng(0)
    n, d, b = 4096, 16, 8
    mb, e, a = tdt.prepare_tiered(_t(_unit(rng, n, d)))
    qb, u, v = tdt._bf16_query_bounds(_t(_unit(rng, b, d)))
    args = [qb, mb, e, a, torch.ones(n, dtype=torch.int32), u, v]
    ids = torch.tensor([1, 0, 4], dtype=torch.int32)
    before = scan_select_v3_indirect.launches
    got = scan_select_v3_indirect(*args, ids, tile_n=1024, t_top=3)
    want = scan_select_v3_indirect_reference(*args, ids, 1024, 3)
    assert scan_select_v3_indirect.launches == before  # nothing launched on the CPU
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for bad in (dict(tile_ids=ids.long()), dict(tile_ids=ids[:0]), dict(tile_n=1536),
                dict(tile_n=8192)):
        kw = dict(tile_ids=ids, tile_n=1024) | bad
        with pytest.raises(InvalidConfigError):
            scan_select_v3_indirect(*args, kw["tile_ids"], tile_n=kw["tile_n"])
    with pytest.raises(InvalidConfigError):
        scan_select_v3_indirect(*(x.to("meta") for x in args), ids.to("meta"), tile_n=1024)


def test_indirect_equals_k1_over_the_gathered_tiles():
    """Row for row, K5 over a tile list is K1 over a copy of those tiles,
    with rows mapped from copy positions to corpus rows."""
    from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3_reference

    rng = np.random.default_rng(3)
    n, d, b, tile_n = 8192, 32, 8, 2048
    mb, e, a = tdt.prepare_tiered(_t(_unit(rng, n, d)))
    qb, u, v = tdt._bf16_query_bounds(_t(_unit(rng, b, d)))
    valid = torch.ones(n, dtype=torch.int32)
    ids = torch.tensor([2, 0, 3], dtype=torch.int32)
    kv, kr = scan_select_v3_indirect_reference(qb, mb, e, a, valid, u, v, ids, tile_n, T_TOP)
    g = torch.cat([torch.arange(i * tile_n, (i + 1) * tile_n) for i in ids.tolist()])
    cv, cr = scan_select_v3_reference(qb, mb[g], e[g], a[g], valid[g], u, v, T_TOP)
    assert torch.equal(kv, cv)
    assert torch.equal(kr, g[cr.long()].to(torch.int32))


# -- the builds ------------------------------------------------------------------


def _check_contract(m, order, cent, radii, tile, valid=None):
    """Every live row placed once, holes are -1, tile capacity holds, and
    each radius bounds its members' float64 distances to the centroid."""
    live_rows = np.flatnonzero(np.ones(len(m), bool) if valid is None else valid)
    t = len(radii)
    assert order.dtype == np.int32 and len(order) == t * tile and cent.shape == (t, m.shape[1])
    placed = order[order >= 0]
    assert len(np.unique(placed)) == len(placed) == len(live_rows)
    assert set(placed.tolist()) == set(live_rows.tolist())
    assert (order >= -1).all()
    for c in range(t):
        rows = order[c * tile:(c + 1) * tile]
        rows = rows[rows >= 0]
        if len(rows):
            diff = m[rows].astype(np.float64) - cent[c].astype(np.float64)
            assert np.sqrt((diff * diff).sum(axis=1)).max() <= radii[c], f"tile {c}"


def test_greedy_fill_matches_jax_on_contended_preferences():
    rng = np.random.default_rng(1)
    for _ in range(20):
        t, tile = int(rng.integers(2, 30)), int(rng.integers(1, 40))
        n = int(rng.integers(1, t * tile + 1))
        n_alt = int(rng.integers(1, min(t, 8) + 1))
        top_alt = np.stack([rng.permutation(t)[:n_alt] for _ in range(n)]).astype(np.int32)
        top_alt[rng.random(n) < 0.5, 0] = 0  # one popular cluster
        margin = np.round(rng.standard_normal(n), 1).astype(np.float32)  # ties
        want = jcl._greedy_fill(top_alt, margin, t, tile)
        got = tcl._greedy_fill(top_alt, margin, t, tile)
        assert [g.tolist() for g in got] == [list(w) for w in want]


def test_host_build_matches_jax_on_separated_blobs():
    m, _ = _blobs(n=8192, blobs=8, seed=2)
    jo, jc, jr = jcl.prepare_clustered(m, tile_n=TILE, iters=4, sample=4096)
    to, tc, tr = tcl.prepare_clustered(m, tile_n=TILE, iters=4, sample=4096)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    _check_contract(m, to, tc, tr, TILE)


def test_host_build_contract_with_holes_and_invalid_rows():
    m, _ = _blobs(n=7000, blobs=7, seed=4, sigma=0.15)
    valid = np.ones(len(m), bool)
    valid[::9] = False
    order, cent, radii = tcl.prepare_clustered(m, tile_n=TILE, iters=3, sample=2048, valid=valid)
    _check_contract(m, order, cent, radii, TILE, valid)
    assert (order == -1).sum() == len(radii) * TILE - valid.sum()
    empty = tcl.prepare_clustered(m, tile_n=TILE, valid=np.zeros(len(m), bool))
    assert (empty[0] == -1).all() and len(empty[0]) == TILE


@pytest.mark.parametrize("form", ["device", "stream"])
def test_device_and_stream_builds_match_jax(form):
    """The device build runs over the stream build with slice reads, in
    both packages; on separated blobs each tile holds the same rows as in
    JAX's layout, and the radii stay sound. (In-tile positions follow f32
    centroid scores summed on the device in another order, so rows whose
    scores tie to the last bit may swap places.)"""
    m, _ = _blobs(n=4096, blobs=4, seed=5, sigma=0.1)
    valid = np.ones(len(m), bool)
    valid[::7] = False
    if form == "device":
        jo, jc, jr = jcl.prepare_clustered_device(jnp.asarray(m), tile_n=TILE, iters=4, sample=2048, valid=valid)
        to, tc, tr = tcl.prepare_clustered_device(_t(m), tile_n=TILE, iters=4, sample=2048, valid=valid)
    else:
        jm, tm = jnp.asarray(m), _t(m)
        jo, jc, jr = jcl.prepare_clustered_stream(
            lambda ids: jnp.take(jm, jnp.asarray(ids, jnp.int32), axis=0), len(m), m.shape[1],
            tile_n=TILE, iters=4, sample=2048, valid=valid)
        to, tc, tr = tcl.prepare_clustered_stream(
            lambda ids: tm[_t(np.asarray(ids, np.int64))], len(m), m.shape[1],
            tile_n=TILE, iters=4, sample=2048, valid=valid)
    np.testing.assert_array_equal(np.sort(to.reshape(-1, TILE), axis=1), np.sort(jo.reshape(-1, TILE), axis=1))
    assert (to == jo).mean() > 0.99
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr, jr, rtol=1e-6)
    _check_contract(m, to, tc, tr, TILE, valid)


def test_stream_build_recon_err_widens_radii_soundly():
    """An approximate source (x̂ = x + noise of norm 0.01) with recon_err
    = 0.01 publishes radii that bound the TRUE rows' distances."""
    m, _ = _blobs(n=4096, blobs=4, seed=3, sigma=0.1)
    rng = np.random.default_rng(3)
    noise = rng.standard_normal(m.shape).astype(np.float32)
    noise *= 0.01 / np.linalg.norm(noise, axis=1, keepdims=True)
    m_hat = _t(m + noise)
    src = lambda ids: m_hat[_t(np.asarray(ids, np.int64))]  # noqa: E731
    order, cent, radii = tcl.prepare_clustered_stream(
        src, len(m), m.shape[1], tile_n=TILE, iters=4, sample=2048, recon_err=0.01)
    _check_contract(m, order, cent, radii, TILE)
    _, _, tight = tcl.prepare_clustered_stream(src, len(m), m.shape[1], tile_n=TILE, iters=4, sample=2048)
    assert (radii > tight).all()


def test_apply_cluster_order_device_matches_host():
    rng = np.random.default_rng(5)
    order = np.full(48, -1, np.int32)
    order[rng.choice(48, size=37, replace=False)] = rng.permutation(37)
    for arr in (rng.standard_normal(37).astype(np.float32), rng.standard_normal((37, 8)).astype(np.float32)):
        host = tcl.apply_cluster_order(arr, order, fill=0)
        np.testing.assert_array_equal(host, jcl.apply_cluster_order(arr, order, fill=0))
        np.testing.assert_array_equal(tcl.apply_cluster_order_device(_t(arr), order, fill=0).numpy(), host)


def test_resolve_cluster_fetch():
    assert tcl.resolve_cluster_fetch("auto", "cpu") == "gather"
    assert tcl.resolve_cluster_fetch("auto", "cuda") == "dma"
    assert tcl.resolve_cluster_fetch("dma", "cpu") == "dma"


# -- the pruned query ------------------------------------------------------------


def _layouts(m, order):
    """The clustered replicas in both packages (from the same values)."""
    mp = tcl.apply_cluster_order(m, order, fill=0).astype(np.float32)
    valid = order >= 0
    jparts = jdt.prepare_tiered(jnp.asarray(mp)) + jdt.prepare_residual(jnp.asarray(mp))
    tparts = tdt.prepare_tiered(_t(mp)) + tdt.prepare_residual(_t(mp))
    return (jparts, jnp.asarray(valid)), (tparts, _t(valid))


def _query_both(m, queries, order, cent, radii, k, probe, fetch, tags=None, **kw):
    (jparts, jvalid), (tparts, tvalid) = _layouts(m, order)
    j = jcl.dense_topk_compact_bf16r_clustered(
        jnp.asarray(queries), *jparts, jvalid, k, jnp.asarray(cent), jnp.asarray(radii),
        probe_tiles=probe, row_map=jnp.asarray(order), tile_n=TILE, interpret=True,
        return_stats=True, fetch=fetch, tags=None if tags is None else tuple(jnp.asarray(x) for x in tags),
        **kw,
    )
    t = tcl.dense_topk_compact_bf16r_clustered(
        _t(queries), *tparts, tvalid, k, _t(cent), _t(radii), probe_tiles=probe,
        row_map=_t(order), tile_n=TILE, return_stats=True, fetch=fetch,
        tags=None if tags is None else tuple(_t(x) for x in tags), **kw,
    )
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _same(j, t, n_int=None):
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.shape == b.shape
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            fin = np.isfinite(a)
            np.testing.assert_allclose(b[fin], a[fin], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("fetch", ["gather", "dma"])
def test_clustered_query_matches_jax(fetch):
    """JAX's layout, both fetches: scores, rows, certificates, the bounds,
    the containment candidates and the scanned-tile count agree; certified
    sets are the float64 exact top-k sets, and pruning scanned fewer tiles
    than the corpus holds."""
    m, centers = _blobs(planted=5, seed=6)
    order, cent, radii = jcl.prepare_clustered(m, tile_n=TILE, iters=4, sample=4096)
    queries = np.concatenate([centers[:5], _unit(np.random.default_rng(7), 3, m.shape[1])]).astype(np.float32)
    j, t = _query_both(m, queries, order, cent, radii, 5, 3, fetch,
                       return_bounds=True, return_candidates=True)
    _same(j, t)
    scores, rows, ok, err, rhs, cand, thr, scanned = t
    assert 0 < int(scanned) < len(radii)
    assert ok[:5].all()
    exact = queries.astype(np.float64) @ m.astype(np.float64).T / np.linalg.norm(queries, axis=1)[:, None]
    for i in np.flatnonzero(ok):
        assert set(rows[i].tolist()) == set(np.argsort(-exact[i], kind="stable")[:5].tolist())


def test_clustered_query_with_tags_matches_jax():
    m, centers = _blobs(seed=8)
    order, cent, radii = jcl.prepare_clustered(m, tile_n=TILE, iters=4, sample=4096)
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 4, size=len(m)).astype(np.int32)
    b = 3
    tags = (tcl.apply_cluster_order(bits, order, fill=0), np.full(b, 1, np.int32),
            np.zeros(b, np.int32), np.array([0, 2, 0], np.int32))
    for fetch in ("gather", "dma"):
        j, t = _query_both(m, centers[:b].astype(np.float32), order, cent, radii, 5, 4, fetch, tags=tags)
        _same(j, t)
        rows = t[1]
        ok_rows = rows[rows >= 0]
        assert ((bits[ok_rows] & 1) != 0).all(), "filter leaked"


def test_clustered_query_fails_closed_on_a_tight_probe():
    """probe_tiles=1 on queries between blobs: both packages certify the
    same queries, and each certified set is the exact one."""
    m, _ = _blobs(seed=3, sigma=0.15)
    order, cent, radii = jcl.prepare_clustered(m, tile_n=TILE, iters=4, sample=4096)
    queries = _unit(np.random.default_rng(4), 4, m.shape[1])
    j, t = _query_both(m, queries, order, cent, radii, 5, 1, "gather")
    _same(j, t)
    _, rows, ok, scanned = t
    assert int(scanned) <= 4
    exact = queries.astype(np.float64) @ m.astype(np.float64).T
    for i in np.flatnonzero(ok):
        assert set(rows[i].tolist()) == set(np.argsort(-exact[i], kind="stable")[:5].tolist())


def test_clustered_query_full_probe_equals_compact_tier():
    """probe_tiles = T disables pruning: the same rows, scores and
    certificates as the compact bf16r tier over the same layout."""
    m, centers = _blobs(seed=11)
    order, cent, radii = tcl.prepare_clustered(m, tile_n=TILE, iters=4, sample=4096)
    _, (tparts, tvalid) = _layouts(m, order)
    q = _t(centers[:2].astype(np.float32))
    s1, r1, ok1, n_sc = tcl.dense_topk_compact_bf16r_clustered(
        q, *tparts, tvalid, 5, _t(cent), _t(radii), probe_tiles=len(radii), row_map=_t(order),
        tile_n=TILE, return_stats=True)
    assert int(n_sc) == len(radii)
    s2, r2, ok2 = tdt.dense_topk_compact_bf16r(q, *tparts, tvalid, 5, tile_n=TILE, t_top=8)
    r2 = torch.where(r2 >= 0, _t(order)[r2.clamp(min=0).long()], r2)
    assert torch.equal(r1, r2) and torch.equal(ok1, ok2)
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=0)


def test_clustered_query_rejects_bad_inputs():
    m, _ = _blobs(n=4096, blobs=4)
    order, cent, radii = tcl.prepare_clustered(m, tile_n=TILE, iters=2, sample=1024)
    _, (tparts, tvalid) = _layouts(m, order)
    q = _t(m[:2])
    with pytest.raises(InvalidConfigError):
        tcl.dense_topk_compact_bf16r_clustered(q, *tparts, tvalid, 5, _t(cent), _t(radii), fetch="bogus")
    with pytest.raises(InvalidConfigError):
        tcl.dense_topk_compact_bf16r_clustered(q, *tparts, tvalid, 5, _t(cent[:2]), _t(radii[:2]), tile_n=TILE)

