"""The certified bf16 tile tier: the port's dense_topk_tiered2(_checked)
against the JAX package's on the same store, and the port's VectorStore
on the bf16 tier (with inserts, removals and updates) against the JAX
VectorStore."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from trueno_rag_tpu.chunking import Chunk as JChunk
from trueno_rag_tpu.index.vector_store import VectorStore as JVectorStore
from trueno_rag_tpu.index.vector_store import VectorStoreConfig as JVectorStoreConfig
from trueno_rag_tpu.ops import dense as jdense
from trueno_rag_tpu.ops import dense_tiered as jdt
from trueno_rag_tpu_torch.chunking import Chunk as TChunk
from trueno_rag_tpu_torch.index.vector_store import VectorStore as TVectorStore
from trueno_rag_tpu_torch.index.vector_store import VectorStoreConfig as TVectorStoreConfig
from trueno_rag_tpu_torch.ops import dense as tdense
from trueno_rag_tpu_torch.ops import dense_tiered as tdt


def _store(n, d, b, seed, metric):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, d)).astype(np.float32)
    if metric == "cosine":
        m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[n // 10: n // 8] = False
    return m, q, valid


CASES = [
    # n, d, b, k, metric, rescore_rows, margin_tiles, tile_n
    (6144, 48, 8, 10, "cosine", 96, 32, 2048),
    (5000, 64, 7, 10, "cosine", None, 1, 1024),  # a thin margin: some queries fail closed
    (3000, 32, 5, 20, "dot", 24, 4, 4096),  # trim below the candidate width
    (700, 16, 3, 12, "cosine", 96, 32, 1024),  # fewer tiles than k + margin
]


@pytest.mark.parametrize("n,d,b,k,metric,rescore_rows,margin,tile_n", CASES)
def test_tiered2_matches_jax(n, d, b, k, metric, rescore_rows, margin, tile_n):
    m, q, valid = _store(n, d, b, seed=n + d, metric=metric)
    kw = dict(margin_tiles=margin, metric=metric, tile_n=tile_n, rescore_rows=rescore_rows)
    jm = jnp.asarray(m)
    js, jr, jok = jdt.dense_topk_tiered2(
        jnp.asarray(q), jm, *jdt.prepare_tiered(jm), jnp.asarray(valid), k, interpret=True, **kw
    )
    tm = torch.from_numpy(m)
    ts, tr, tok = tdt.dense_topk_tiered2(
        torch.from_numpy(q), tm, *tdt.prepare_tiered(tm), torch.from_numpy(valid), k, **kw
    )
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    js = np.asarray(js)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
    np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=0, atol=1e-5)

    # the checked wrappers are exact: both equal their exact fp32 path
    ts_c, tr_c, n_fb = tdt.dense_topk_tiered2_checked(
        torch.from_numpy(q), tm, *tdt.prepare_tiered(tm), torch.from_numpy(valid), k, **kw
    )
    assert n_fb == int((~tok).sum())
    ts_x, tr_x = tdense.dense_topk(torch.from_numpy(q), tm, torch.from_numpy(valid), k, metric)
    np.testing.assert_array_equal(tr_c.numpy(), tr_x.numpy())
    np.testing.assert_array_equal(ts_c.numpy(), ts_x.numpy())  # one arithmetic for both paths
    _, jr_c, _ = jdt.dense_topk_tiered2_checked(
        jnp.asarray(q), jm, *jdt.prepare_tiered(jm), jnp.asarray(valid), k, interpret=True, **kw
    )
    _, jr_x = jdense.dense_topk(jnp.asarray(q), jm, jnp.asarray(valid), k, metric)
    np.testing.assert_array_equal(np.asarray(jr_c), np.asarray(jr_x))
    np.testing.assert_array_equal(tr_c.numpy(), np.asarray(jr_c))


def test_prepare_tiered_matches_jax_and_keeps_the_residual():
    m, _, _ = _store(1000, 32, 1, seed=2, metric="cosine")
    jb, je, ja = jdt.prepare_tiered(jnp.asarray(m))
    tb, te, ta = tdt.prepare_tiered(torch.from_numpy(m))
    np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb.astype(jnp.float32)))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    assert (te.numpy() > 0).all()


def _chunks(cls, embs, ids):
    return [
        cls(document_id="doc", content=f"c{i}", start_offset=0, end_offset=2, embedding=e, id=cid)
        for i, (e, cid) in enumerate(zip(embs, ids))
    ]


def test_vector_store_bf16_tier_matches_jax_through_mutations():
    rng = np.random.default_rng(7)
    n, d = 2500, 32
    embs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"id{i}" for i in range(n)]
    cfg = dict(dimension=d, scan_tier="bf16", scan_tile_n=1024, initial_capacity=256)
    js = JVectorStore(JVectorStoreConfig(**cfg))
    ts = TVectorStore(TVectorStoreConfig(**cfg), device="cpu")
    js.insert_many(_chunks(JChunk, embs, ids))
    ts.insert_many(_chunks(TChunk, embs, ids))
    q = rng.standard_normal((6, d)).astype(np.float32)

    def same(k):
        j_s, j_r = js.search_arrays(q, k)
        t_s, t_r = ts.search_arrays(q, k)
        np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
        np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-5)
        assert ts._effective_tier() == "bf16"

    same(10)
    for i in (3, 400, 1999):  # tombstones
        assert js.remove(ids[i]) and ts.remove(ids[i])
    upd = rng.standard_normal((2, d)).astype(np.float32)
    for cls, store in ((JChunk, js), (TChunk, ts)):  # in-place updates of two rows
        for c in _chunks(cls, upd, [ids[10], ids[11]]):
            store.insert(c)
    same(10)
    assert len(ts) == len(js) == n - 3
    new = rng.standard_normal((3, d)).astype(np.float32)  # recycled rows
    js.insert_many(_chunks(JChunk, new, ["n0", "n1", "n2"]))
    ts.insert_many(_chunks(TChunk, new, ["n0", "n1", "n2"]))
    same(25)
    assert [c for c, _ in ts.search(q[0], 3)] == [c for c, _ in js.search(q[0], 3)]


@pytest.mark.parametrize(
    "cfg",
    [
        dict(scan_tier="int8", scan_kernel="block"),
        dict(scan_tier="auto", scan_kernel="block"),
        dict(storage_dtype="bfloat16", metric="dot"),
        dict(scan_tier="bf16", scan_kernel="block"),
        dict(storage_dtype="bfloat16"),
    ],
)
def test_unported_store_configurations_raise(cfg):
    """These five configurations raised in the port until the block
    kernels (K8, K9) and bf16 storage were ported; each must now answer as
    the JAX store does (auto past its crossover, so it runs the block
    kernel). Scores within 1e-5, as the tier tests above."""
    rng = np.random.default_rng(9)
    n, d = 1500, 16
    kw = dict(dimension=d, initial_capacity=512, scan_tier_auto_rows=1000, **cfg)
    js = JVectorStore(JVectorStoreConfig(**kw))
    ts = TVectorStore(TVectorStoreConfig(**kw), device="cpu")
    embs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"id{i}" for i in range(n)]
    js.insert_many(_chunks(JChunk, embs, ids))
    ts.insert_many(_chunks(TChunk, embs, ids))
    assert js.remove(ids[7]) and ts.remove(ids[7])
    q = rng.standard_normal((5, d)).astype(np.float32)
    j_s, j_r = js.search_arrays(q, 9)
    t_s, t_r = ts.search_arrays(q, 9)
    np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=1e-5)
    assert ts._effective_tier() == js._effective_tier()
