"""Sharded late interaction (``parallel/maxsim.py``) against the JAX
package's ``ShardedTokenIndex`` on an 8-shard mesh, the float64 oracle and
the single-card token store.

The port reports the float64 MaxSim rounded once (the JAX package the f32
scan), a kept divergence; the queries are random unit tokens, tie-free.
Tolerances: rows equal to the JAX index's, to the oracle's and to the
single-card store's; scores within 1e-5 of the JAX index's and the
oracle's, equal to the single-card port store's. The tiered scan (K6's
plain version here) falls back to the exact scan where its certificate
fails, so its rows equal the exact ones too.
"""

import numpy as np
import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig, TokenVectorStore
from trueno_rag_tpu_torch.ops.maxsim import maxsim_scan_oracle
from trueno_rag_tpu_torch.ops.tags import tag_pred_oracle
from trueno_rag_tpu_torch.parallel.maxsim import ShardedTokenIndex
from trueno_rag_tpu_torch.parallel.mesh import create_mesh

try:  # the card's machine has no JAX: only the cuda cases run there
    from trueno_rag_tpu.chunking import Chunk as JChunk, ChunkMetadata as JMeta, chunk_id_from_int as jid
    from trueno_rag_tpu.index import TokenStoreConfig as JConfig, TokenVectorStore as JStore
    from trueno_rag_tpu.parallel.maxsim import ShardedTokenIndex as JIndex
    from trueno_rag_tpu.parallel.mesh import create_mesh as jcreate
except ImportError:
    JChunk = JMeta = jid = JConfig = JStore = JIndex = jcreate = None

S = 8


@pytest.fixture(scope="module")
def meshes():
    return jcreate(data=S, model=1), create_mesh(devices=[torch.device("cpu")] * S)


def build(n, lt, h, b, lq, seed, ragged=True):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((n, lt, h)).astype(np.float32)
    tok /= np.linalg.norm(tok, axis=2, keepdims=True)
    lens = rng.integers(1, lt + 1, size=n) if ragged else np.full(n, lt)
    tm = np.arange(lt)[None, :] < lens[:, None]
    q = rng.standard_normal((b, lq, h)).astype(np.float32)
    q /= np.linalg.norm(q, axis=2, keepdims=True)
    valid = np.ones(n, bool)
    valid[n // 6:n // 4] = False
    return tok, tm, q, np.ones((b, lq), bool), valid


def _same(got, want, exact_scores=False):
    s_t, r_t = got
    s_j, r_j = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(r_t, r_j)
    fin = np.isfinite(s_j)
    np.testing.assert_array_equal(np.isfinite(s_t), fin)
    if exact_scores:
        np.testing.assert_array_equal(s_t, s_j)
    else:
        np.testing.assert_allclose(s_t[fin], s_j[fin], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scan", ["exact", "tiered"])
@pytest.mark.parametrize("n", [491, 512])  # not divisible, divisible by 8
def test_sharded_maxsim_matches_jax_and_oracle(meshes, n, scan):
    jm, tm = meshes
    tok, t_mask, q, qm, valid = build(n, 5, 16, 4, 3, seed=n + (7 if scan == "tiered" else 0))
    kw = dict(valid=valid, tokens_normalized=True, scan=scan, rescore=64)
    idx = ShardedTokenIndex(tok, t_mask, tm, **kw)
    got = idx.search(q, qm, k=9)
    _same(got, JIndex(tok, t_mask, jm, interpret=True, **kw).search(q, qm, k=9))
    _same(got, maxsim_scan_oracle(q, qm, tok, t_mask, valid, 9))
    if scan == "tiered":
        assert idx.uncertified < 4, "expected mostly certified on random data"


@pytest.mark.parametrize("scan", ["exact", "tiered"])
def test_sharded_maxsim_tagged_matches_filtered_oracle(meshes, scan):
    jm, tm = meshes
    tok, t_mask, q, qm, valid = build(300, 4, 16, 3, 3, seed=3 if scan == "exact" else 11)
    tags = np.random.default_rng(0).integers(0, 8, size=300).astype(np.int32)
    kw = dict(valid=valid, tokens_normalized=True, tags=tags, scan=scan, rescore=64)
    words = (np.array([1, 0, 2], np.int32), np.array([0, 4, 0], np.int32), np.array([0, 0, 1], np.int32))
    got = ShardedTokenIndex(tok, t_mask, tm, **kw).search_tagged(q, *words, qm, k=7)
    _same(got, JIndex(tok, t_mask, jm, interpret=True, **kw).search_tagged(q, *words, qm, k=7))
    for b in range(3):
        allowed = valid & np.array([tag_pred_oracle(int(t), *(int(w[b]) for w in words)) for t in tags])
        s_o, r_o = maxsim_scan_oracle(q[b:b + 1], qm[b:b + 1], tok, t_mask, allowed, 7)
        np.testing.assert_array_equal(got[1][b:b + 1], r_o)


def _stores(n, h, lt, seed, **cfg):
    """A port and a JAX token store over the same chunks."""
    rng = np.random.default_rng(seed)
    t = TokenVectorStore(TokenStoreConfig(hidden_dim=h, max_tokens=lt, **cfg), device="cpu")
    j = JStore(JConfig(hidden_dim=h, max_tokens=lt, **cfg))
    for i in range(n):
        toks = rng.standard_normal((int(rng.integers(1, lt + 1)), h)).astype(np.float32)
        toks *= float(rng.uniform(0.1, 10.0))
        t.insert(trag.Chunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=2,
                            metadata=trag.ChunkMetadata(title=""), id=trag.chunk_id_from_int(i)), toks)
        j.insert(JChunk(document_id="d", content=f"c{i}", start_offset=0, end_offset=2, metadata=JMeta(title=""),
                        id=jid(i)), toks)
    return t, j, rng


@pytest.mark.parametrize("cfg", [
    dict(initial_capacity=8),
    dict(storage_dtype="bfloat16", initial_capacity=8),
    dict(normalize=False, initial_capacity=8),
    dict(scan="tiered", rescore=32),
])
def test_from_token_store_matches_the_single_card_store_and_jax(meshes, cfg):
    """The sharded snapshot serves the store's rows as they are (raw on a
    normalize=False store) and answers as the single-card store."""
    jm, tm = meshes
    t, j, rng = _stores(100, 12, 4, seed=5, **cfg)
    for s in (t, j):
        s.remove(s.registry.id_of(17))
    q = rng.standard_normal((2, 3, 12)).astype(np.float32)
    scan = cfg.get("scan", "exact")
    idx = ShardedTokenIndex.from_token_store(t, tm, scan=scan, rescore=cfg.get("rescore", 256))
    got = idx.search(q, None, k=6)
    _same(got, t.search_arrays(q, None, 6), exact_scores=True)
    _same(got, JIndex.from_token_store(j, jm, scan=scan, rescore=cfg.get("rescore", 256)).search(q, None, k=6))
    assert (got[1] != 17).all()


def test_sharded_tiered_bf16_storage_zero_copy(meshes):
    """bf16 storage + the tiered scan: the shard's replica IS its primary,
    and answers are exact over the stored bf16 values."""
    jm, tm = meshes
    tok, t_mask, q, qm, valid = build(280, 4, 16, 3, 3, seed=21)
    kw = dict(valid=valid, tokens_normalized=True, storage_dtype="bfloat16", scan="tiered", rescore=64)
    idx = ShardedTokenIndex(tok, t_mask, tm, **kw)
    assert idx._tier[0] is idx.tokens and idx.tokens.shards[0].dtype == torch.bfloat16
    got = idx.search(q, qm, k=7)
    tok16 = torch.from_numpy(tok).to(torch.bfloat16).float().numpy()
    s_o, r_o = maxsim_scan_oracle(q, qm, tok16, t_mask, valid, 7)
    np.testing.assert_array_equal(got[1], r_o)
    _same(got, JIndex(tok, t_mask, jm, interpret=True, **kw).search(q, qm, k=7))


def test_sharded_k_exceeds_corpus_and_planted_ties(meshes):
    jm, tm = meshes
    tok, t_mask, q, qm, valid = build(20, 3, 8, 2, 2, seed=9)
    got = ShardedTokenIndex(tok, t_mask, tm, valid=valid, tokens_normalized=True).search(q, qm, k=30)
    _same(got, maxsim_scan_oracle(q, qm, tok, t_mask, valid, 30))
    _same(got, JIndex(tok, t_mask, jm, valid=valid, tokens_normalized=True).search(q, qm, k=30))
    # identical chunks on four shards (rps 8): row-ascending among the tie
    tok, t_mask, q, qm, _ = build(64, 3, 8, 1, 2, seed=10, ragged=False)
    for r in (7, 8, 33, 60):
        tok[r] = tok[2]
    q[0] = tok[2, :2]
    s, r = ShardedTokenIndex(tok, t_mask, tm, tokens_normalized=True, scan="tiered", rescore=16).search(q, qm, k=6)
    assert r[0, :5].tolist() == [2, 7, 8, 33, 60] and len(set(s[0, :5].tolist())) == 1
    _same((s, r), maxsim_scan_oracle(q, qm, tok, t_mask, np.ones(64, bool), 6))


def test_sharded_token_index_validation(meshes):
    tok, t_mask, *_ = build(16, 2, 4, 1, 1, seed=1)
    with pytest.raises(trag.InvalidConfigError):
        ShardedTokenIndex(tok, t_mask, meshes[1], scan="token")


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
def test_cuda_four_shards_on_one_card_launch_k6_per_shard():
    from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as km

    tok, t_mask, q, qm, valid = build(8192, 32, 128, 8, 8, seed=31)
    idx = ShardedTokenIndex(tok, t_mask, create_mesh(devices=[torch.device("cuda", 0)] * 4), valid=valid,
                            tokens_normalized=True, storage_dtype="bfloat16", scan="tiered")
    km.maxsim_scan16_scores.launches = 0
    s, r = idx.search(q, qm, k=10)
    assert km.maxsim_scan16_scores.launches == 4
    tok16 = torch.from_numpy(tok).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(r, maxsim_scan_oracle(q, qm, tok16, t_mask, valid, 10)[1])
