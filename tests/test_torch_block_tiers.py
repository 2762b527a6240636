"""The block-kernel tiers (``scan_kernel="block"``: K8 bf16, K9 int8) and
bf16 storage, against the JAX package on the same numpy inputs:
``dense_topk_tiered(_checked)`` and ``dense_topk_int8(_checked)``, the
store on the bf16, int8 and auto tiers with ``scan_kernel="block"`` and
with ``storage_dtype="bfloat16"`` through inserts, removals and updates,
and ``convert.retriever_from_state`` for both options.

Tolerances, and why:
- tier scores: 1e-5 absolute, as the tile tier's parity test. The port
  re-ranks by float64 sums rounded once (``ops.dense.exact_scores``), the
  JAX package by an fp32 HIGHEST product; they differ by ~d·2⁻²⁴ relative
  (the dot-metric case has scores near 17).
- certified flags and rows: equal, on random (tie-free) data.
- stores: scores 1e-5 absolute (the same sums; with bf16 storage, of the
  same bf16-rounded rows), rows equal on tie-free data.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import trueno_rag_tpu as jrag
import trueno_rag_tpu_torch as trag
from trueno_rag_tpu.index.vector_store import VectorStore as JVectorStore
from trueno_rag_tpu.index.vector_store import VectorStoreConfig as JVectorStoreConfig
from trueno_rag_tpu.ops import dense_tiered as jdt
from trueno_rag_tpu_torch.convert import retriever_from_state
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
    # n, d, b, k, metric, rescore_rows, margin_blocks, tile_n, block_top
    (4096, 48, 8, 10, "cosine", None, 64, 1024, 4),
    (5000, 32, 7, 10, "cosine", 96, 2, 256, 2),  # a thin margin: some queries fail closed
    (3000, 24, 5, 20, "dot", 24, 16, 512, 2),  # trim below the candidate width
    (700, 16, 3, 12, "cosine", None, 64, 128, 1),  # fewer blocks than k + margin
]


def _jax_tier(kind, q, m, valid, k, kw):
    jm = jnp.asarray(m)
    if kind == "bf16":
        fn, fn_c, packs = jdt.dense_topk_tiered, jdt.dense_topk_tiered_checked, jdt.prepare_tiered(jm)
    else:
        fn, fn_c, packs = jdt.dense_topk_int8, jdt.dense_topk_int8_checked, jdt.prepare_int8(jm)
    args = (jnp.asarray(q), jm, *packs, jnp.asarray(valid), k)
    return fn(*args, interpret=True, **kw), fn_c(*args, interpret=True, **kw)


def _port_tier(kind, q, m, valid, k, kw):
    tm = torch.from_numpy(m)
    if kind == "bf16":
        fn, fn_c, packs = tdt.dense_topk_tiered, tdt.dense_topk_tiered_checked, tdt.prepare_tiered(tm)
    else:
        fn, fn_c, packs = tdt.dense_topk_int8, tdt.dense_topk_int8_checked, tdt.prepare_int8(tm)
    args = (torch.from_numpy(q), tm, *packs, torch.from_numpy(valid), k)
    return fn(*args, **kw), fn_c(*args, **kw)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,b,k,metric,rescore_rows,margin,tile_n,top", CASES)
def test_block_tier_matches_jax(kind, n, d, b, k, metric, rescore_rows, margin, tile_n, top):
    m, q, valid = _store(n, d, b, seed=n + d, metric=metric)
    kw = dict(margin_blocks=margin, metric=metric, tile_n=tile_n, rescore_rows=rescore_rows, block_top=top)
    (js, jr, jok), (_, jr_c, _) = _jax_tier(kind, q, m, valid, k, kw)
    (ts, tr, tok), (ts_c, tr_c, n_fb) = _port_tier(kind, q, m, valid, k, kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    js = np.asarray(js)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), fin)
    np.testing.assert_allclose(ts.numpy()[fin], js[fin], rtol=0, atol=1e-5)
    # the checked forms are exact: both equal their exact fp32 paths
    assert n_fb == int((~tok).sum())
    ts_x, tr_x = tdense.dense_topk(torch.from_numpy(q), torch.from_numpy(m), torch.from_numpy(valid), k, metric)
    np.testing.assert_array_equal(tr_c.numpy(), tr_x.numpy())
    np.testing.assert_array_equal(ts_c.numpy(), ts_x.numpy())  # one arithmetic for both paths
    np.testing.assert_array_equal(tr_c.numpy(), np.asarray(jr_c))


def test_thin_margin_fails_closed_and_falls_back():
    """The thin-margin case must leave some queries uncertified in both
    packages (else it would not test the fallback)."""
    n, d, b, k = 5000, 32, 7, 10
    m, q, valid = _store(n, d, b, seed=n + d, metric="cosine")
    kw = dict(margin_blocks=0, metric="cosine", tile_n=256, rescore_rows=None, block_top=1)
    (_, _, jok), _ = _jax_tier("bf16", q, m, valid, k, kw)
    (_, _, tok), (_, _, n_fb) = _port_tier("bf16", q, m, valid, k, kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < n_fb < b


def _chunks(rag, embs, ids):
    return [
        rag.Chunk(document_id="doc", content=f"c{i}", start_offset=0, end_offset=2, embedding=e, id=cid)
        for i, (e, cid) in enumerate(zip(embs, ids))
    ]


STORE_CONFIGS = [
    dict(scan_tier="bf16", scan_kernel="block", scan_tile_n=256),
    dict(scan_tier="int8", scan_kernel="block", scan_tile_n=256),
    dict(scan_tier="auto", scan_kernel="block", scan_tile_n=256, scan_tier_auto_rows=1000),
    dict(scan_tier="bf16", scan_kernel="block", scan_block_top=4, scan_tile_n=384, scan_rescore_rows=None),
    dict(storage_dtype="bfloat16"),
    dict(storage_dtype="bfloat16", metric="dot"),
]


def _pair(cfg, n, d, seed):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"id{i}" for i in range(n)]
    kw = dict(dict(dimension=d, initial_capacity=256), **cfg)
    js = JVectorStore(JVectorStoreConfig(**kw))
    ts = TVectorStore(TVectorStoreConfig(**kw), device="cpu")
    js.insert_many(_chunks(jrag, embs, ids))
    ts.insert_many(_chunks(trag, embs, ids))
    return js, ts, ids, rng


def _same(js, ts, q, k, atol):
    j_s, j_r = js.search_arrays(q, k)
    t_s, t_r = ts.search_arrays(q, k)
    np.testing.assert_array_equal(t_r.numpy(), np.asarray(j_r))
    np.testing.assert_allclose(t_s.numpy(), np.asarray(j_s), rtol=0, atol=atol)


@pytest.mark.parametrize("cfg", STORE_CONFIGS, ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()))
def test_store_matches_jax_through_mutations(cfg):
    d = 32
    js, ts, ids, rng = _pair(cfg, 2500, d, seed=7)
    atol = 1e-5
    q = rng.standard_normal((6, d)).astype(np.float32)
    _same(js, ts, q, 10, atol)
    if "storage_dtype" in cfg:
        assert ts.device_matrix.dtype == torch.bfloat16
    else:
        assert ts._effective_tier() == cfg["scan_tier"].replace("auto", "bf16")
    for i in (3, 400, 1999):  # tombstones
        assert js.remove(ids[i]) and ts.remove(ids[i])
    upd = rng.standard_normal((2, d)).astype(np.float32)
    for rag, store in ((jrag, js), (trag, ts)):  # in-place updates of two rows
        for c in _chunks(rag, upd, [ids[10], ids[11]]):
            store.insert(c)
    _same(js, ts, q, 10, atol)
    new = rng.standard_normal((3, d)).astype(np.float32)  # recycled rows
    js.insert_many(_chunks(jrag, new, ["n0", "n1", "n2"]))
    ts.insert_many(_chunks(trag, new, ["n0", "n1", "n2"]))
    q2 = np.concatenate([q, upd, new[:1]])  # queries at the updated and new rows
    _same(js, ts, q2, 25, atol)
    assert [c for c, _ in ts.search(q[0], 3)] == [c for c, _ in js.search(q[0], 3)]


def test_block_store_counts_fallbacks_like_jax():
    """A store whose margin forces fallbacks: both packages count them."""
    cfg = dict(scan_tier="bf16", scan_kernel="block", scan_block_top=1, scan_tile_n=256)
    js, ts, _, rng = _pair(cfg, 3000, 16, seed=3)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    for k in (5, 40):
        _same(js, ts, q, k, 1e-5)
    assert ts.tier_fallbacks == js.tier_fallbacks == 2  # both batches had a query re-run
    assert ts.tier_fallback_queries > ts.tier_fallbacks


def test_block_stores_call_the_block_tiers(monkeypatch):
    """The store runs the K8 tier on the bf16 block tier and the K9 tier on
    the int8 one (the kernels' launch counters stay 0 on the CPU, so the
    tier functions are counted)."""
    calls = []
    for cfg, name in ((dict(scan_tier="bf16", scan_kernel="block", scan_tile_n=256), "dense_topk_tiered_checked"),
                      (dict(scan_tier="int8", scan_kernel="block", scan_tile_n=256), "dense_topk_int8_checked")):
        _, ts, _, rng = _pair(cfg, 1500, 16, seed=4)
        orig = getattr(tdt, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(tdt, name, counted)
        ts.search_arrays(rng.standard_normal((2, 16)).astype(np.float32), 4)
    assert calls == ["dense_topk_tiered_checked", "dense_topk_int8_checked"]


@pytest.mark.parametrize("cfg", [
    dict(scan_tier="bf16", scan_kernel="block", scan_tile_n=256),
    dict(storage_dtype="bfloat16"),
], ids=["block", "bf16-storage"])
def test_retriever_from_state_carries_both_options(cfg):
    """A JAX retriever's state with either option, carried into the port:
    the same dense answers, and hybrid queries with the same hits. The
    chunks have distinct lengths, so no two BM25 scores tie exactly."""
    d, n = 24, 700
    rng = np.random.default_rng(5)
    embs = rng.standard_normal((n, d)).astype(np.float32)
    words = np.array([f"w{i:03d}" for i in range(300)])
    lengths = rng.permutation(np.arange(8, 8 + n))
    kw = dict(dimension=d, **cfg)
    jr = jrag.HybridRetriever(jrag.MockEmbedder(d), vector_config=jrag.VectorStoreConfig(**kw))
    jr.index_batch([
        jrag.Chunk(id=f"c{i}", document_id=f"d{i}", content=" ".join(words[rng.integers(0, 300, size=ln)]),
                   start_offset=0, end_offset=4, embedding=embs[i].tolist())
        for i, ln in enumerate(lengths)
    ])
    js = jr.vector_store
    chunks = [jr.registry.chunk_of(r) for r in range(jr.registry.capacity_rows)]
    tr = retriever_from_state(
        trag.MockEmbedder(d), chunks, js._host, js._valid, jr.sparse_index.state_dict(),
        vector_config=trag.VectorStoreConfig(**kw), device="cpu",
    )
    ts = tr.vector_store
    q = rng.standard_normal((5, d)).astype(np.float32)
    _same(js, ts, q, 8, 1e-5)
    texts = ["w007 body", "w013 w021"]
    jres = jr.retrieve_batch(texts, 5)
    tres = tr.retrieve_batch(texts, 5)
    assert [[r.chunk.id for r in x] for x in tres] == [[r.chunk.id for r in x] for x in jres]
