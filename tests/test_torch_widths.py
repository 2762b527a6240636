"""Feature widths that are not a multiple of the kernels' 16-byte vector
(8 bf16, 16 int8): every certified dense tier and the token store answer
at d (H) = 36 and 100 as the JAX package does, and (on a card only) the
scan kernels K1, K3 and K5 at d = 100 and K6, K7 at H = 36 and 100 against
their plain versions (K8 and K9 at d = 100:
tests/test_torch_scan_select_v1.py).

The JAX package answers at any width; the port's kernels read such rows
byte by byte with zero columns past the width (``csrc/row_load.cuh``),
and its plain versions take any width. Tolerances: dense scores 1e-5
absolute (the tier tests' own), token-store scores as
tests/test_torch_token_store.py. JAX is imported inside the CPU tests: the
card's machine runs the ``cuda``-marked ones without it.
"""

import numpy as np
import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import retriever_from_state
from trueno_rag_tpu_torch.ops import dense_tiered as dt

TIERS = [
    dict(scan_tier="none"),
    dict(scan_tier="bf16"),
    dict(scan_tier="int8"),
    dict(scan_tier="auto", scan_tier_auto_rows=1000),
    dict(scan_tier="compact", compact_scan="bf16r"),
    dict(scan_tier="compact", compact_scan="bf16rr"),
    dict(scan_tier="compact", compact_scan="bf16"),
    dict(scan_tier="compact", compact_scan="int8"),
    dict(scan_tier="clustered", cluster_probe_tiles=2),
    dict(scan_tier="bf16", scan_kernel="block"),
    dict(scan_tier="int8", scan_kernel="block"),
]


def _ids(cfg):
    return "-".join(str(v) for k, v in cfg.items() if k in ("scan_tier", "compact_scan", "scan_kernel"))


def _pair(cfg, d, n=2048, seed=0):
    """A JAX retriever on tier ``cfg`` at width d (its device state built)
    and the port's retriever carrying its state (and, on the clustered
    tier, its layout)."""
    jrag = pytest.importorskip("trueno_rag_tpu")
    rng = np.random.default_rng(seed + d)
    centers = rng.standard_normal((8, d)).astype(np.float32)
    m = centers[np.arange(n) % 8] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    kw = dict(dict(dimension=d, scan_tile_n=1024), **cfg)
    jr = jrag.HybridRetriever(jrag.MockEmbedder(d), vector_config=jrag.VectorStoreConfig(**kw))
    jr.index_batch([
        jrag.Chunk(id=f"c{i}", document_id=f"d{i}", content=f"w{i}", start_offset=0, end_offset=2,
                   embedding=m[i].tolist())
        for i in range(n)
    ])
    js = jr.vector_store
    js.ensure_ready()
    cluster = None
    if cfg["scan_tier"] == "clustered":
        order, _, cent, radii = js._cluster
        cluster = (order, np.asarray(cent), np.asarray(radii))
    chunks = [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)]
    tr = retriever_from_state(
        trag.MockEmbedder(d), chunks, js._host, js._valid, jr.sparse_index.state_dict(),
        vector_config=trag.VectorStoreConfig(**kw), device="cpu", cluster=cluster,
    )
    q = np.concatenate([centers[:3], rng.standard_normal((3, d))]).astype(np.float32)
    return js, tr.vector_store, q


@pytest.mark.parametrize("d", [36, 100])
@pytest.mark.parametrize("cfg", TIERS, ids=_ids)
def test_every_tier_answers_at_odd_widths_like_jax(cfg, d):
    js, ts, q = _pair(cfg, d)
    for k in (5, 12):
        j_s, j_r = js.search_arrays(q, k)
        t_s, t_r = ts.search_arrays(q, k)
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-5)
    assert ts._effective_tier() == js._effective_tier()


H_ODD, LT = 36, 12
TOKEN_SCANS = [
    dict(scan="tiered", rescore=16),
    dict(scan="tiered", rescore=16, scan_dtype="bfloat16"),
    dict(scan="tiered", rescore=16, scan_dtype="int8"),
]


def _token_rows(rng, n, h):
    toks = rng.standard_normal((n, LT, h)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=2, keepdims=True)
    tm = np.arange(LT)[None, :] < rng.integers(1, LT + 1, size=n)[:, None]
    return toks, tm


@pytest.mark.parametrize("h", [H_ODD, 100])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", TOKEN_SCANS, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_token_store_answers_at_odd_widths_like_jax(scan, storage, h):
    jrag = pytest.importorskip("trueno_rag_tpu")
    from trueno_rag_tpu.index.token_store import TokenStoreConfig as JConfig
    from trueno_rag_tpu.index.token_store import TokenVectorStore as JStore
    from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig, TokenVectorStore

    rng = np.random.default_rng(h)
    toks, tm = _token_rows(rng, 300, h)
    stores = []
    for pkg, cfg_cls, store_cls, kw in ((jrag, JConfig, JStore, {}), (trag, TokenStoreConfig, TokenVectorStore,
                                                                      dict(device="cpu"))):
        cfg = cfg_cls(hidden_dim=h, max_tokens=LT, storage_dtype=storage, **scan)
        store = store_cls(cfg, **kw)
        store.load_rows([pkg.Chunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=2,
                                   id=pkg.chunk_id_from_int(i)) for i in range(300)], toks, tm)
        stores.append(store)
    js, ts = stores
    q = np.concatenate([toks[[5, 77]][:, :4], rng.standard_normal((2, 4, h)).astype(np.float32)])
    qm = np.ones((4, 4), bool)
    qm[3, 2:] = False
    jsc, jr = js.search_arrays(q, qm, 6)
    s, r = ts.search_arrays(q, qm, 6)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_allclose(s, jsc, atol=1e-5, rtol=1e-5)
    assert r[0, 0] == 5 and r[1, 0] == 77  # the planted queries find their chunks


# -- on the card -----------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dense_cuda(n, d, b, seed):
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(_unit(rng, n, d)).cuda()
    q = torch.from_numpy(_unit(rng, b, d)).cuda()
    valid = torch.ones(n, dtype=torch.int32, device="cuda")
    valid[5000:5300] = 0
    return m, q, valid


def _close(vk, rk, vr, rr):
    assert torch.equal(torch.isneginf(vk), torch.isneginf(vr))
    fin = torch.isfinite(vr)
    assert (vk[fin] - vr[fin]).abs().max().item() <= 1e-4
    assert (rk != rr).float().mean().item() <= 1e-3


@pytest.mark.cuda
def test_cuda_k1_k3_k5_at_d100():
    """K1 and K5 within 1e-4 of their plain versions (f32 summation order),
    K3 bit for bit, at d = 100."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels import scan_select as ks

    m, q, valid = _dense_cuda(65536, 100, 200, seed=10)
    mb, e, a = dt.prepare_tiered(m)
    qb, u, v = dt._bf16_query_bounds(q)
    n1 = ks.scan_select_v3.launches
    vk, rk = ks.scan_select_v3(qb, mb, e, a, valid, u, v, t_top=4)
    torch.cuda.synchronize()
    assert ks.scan_select_v3.launches == n1 + 1
    _close(vk, rk, *ks.scan_select_v3_reference(qb, mb, e, a, valid, u, v, 4))
    ids = torch.tensor([0, 3, 7, 15, 16], dtype=torch.int32, device="cuda")
    vk, rk = ks.scan_select_v3_indirect(qb[:8], mb, e, a, valid, u[:8], v[:8], ids, tile_n=4096, t_top=8)
    _close(vk, rk, *ks.scan_select_v3_indirect_reference(qb[:8], mb, e, a, valid, u[:8], v[:8], ids, 4096, 8))
    m_i8, s_row, e8, a8 = dt.prepare_int8(m)
    q_i8, t_q, u8, v8 = dt._int8_query_bounds(q)
    args = (q_i8, m_i8, s_row, e8, a8, valid, t_q, u8, v8)
    vk, rk = ks.scan_select_int8_v3(*args, t_top=4)
    vr, rr = ks.scan_select_int8_v3_reference(*args, 4)
    assert torch.equal(vk, vr) and torch.equal(rk, rr)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [36, 100])
def test_cuda_k6_k7_at_odd_widths(h):
    """K6 within 1e-4 of its plain version (f32 summation order), K7 bit
    for bit, at H = 36 and 100: the zero-copy pack read in place at an
    unaligned width."""
    _cuda_or_skip()
    from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as km

    g = torch.Generator(device="cuda").manual_seed(11)
    n, lt, b, lq = 4096, 16, 8, 8
    tok = torch.randn((n, lt, h), device="cuda", generator=g)
    tok /= torch.linalg.vector_norm(tok, dim=2, keepdim=True)
    q = torch.randn((b, lq, h), device="cuda", generator=g)
    t_mask = torch.rand((n, lt), device="cuda", generator=g) < 0.8
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    valid[100:120] = False
    tok16, q16 = tok.to(torch.bfloat16), q.to(torch.bfloat16)
    got = km.maxsim_scan16_scores(q16, tok16, t_mask, valid)
    want = km.maxsim_scan16_scores_reference(q16, tok16, t_mask, valid)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert (got[fin] - want[fin]).abs().max().item() <= 1e-4
    tok8, s_tok, _ = dt._quantize_rows(tok.reshape(-1, h), clip=True)
    q8, t_q, _ = dt._quantize_rows(q.reshape(-1, h), clip=True)
    args = (q8.view(b, lq, h), t_q.view(b, lq), tok8.view(n, lt, h), s_tok.view(n, lt), t_mask, valid)
    assert torch.equal(km.maxsim_scan_int8_scores(*args), km.maxsim_scan_int8_scores_reference(*args))
