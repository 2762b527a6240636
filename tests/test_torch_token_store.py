"""The port's token store, late-interaction retriever and reranker against
the JAX package's on the same inputs: the store through inserts, removes,
``load_rows``, growth and tag filters under every scan (exact, token,
tiered × auto/bfloat16/int8, and the JAX package's blockwise
``scan_kernel="xla"`` tiers, which the port runs on K6/K7, on float32 and
bfloat16 storage);
a JAX retriever carried across by ``convert.late_interaction_from_state``;
the reranker on the same weights.

The store tests feed identical token matrices to both packages, so their
results must agree row for row (scores to f32 rounding: the port reports
float64 MaxSim rounded once, the JAX package an f32 einsum). The retriever
tests encode queries in both frameworks, whose token states differ by bf16
rounding; the queries are the ones whose JAX top-(k+1) scores lie more
than twice the frameworks' largest score difference apart (tie-free)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import trueno_rag_tpu as jrag
from trueno_rag_tpu.index.token_store import TokenStoreConfig as JConfig
from trueno_rag_tpu.index.token_store import TokenVectorStore as JStore
from trueno_rag_tpu.models import encoder as je
from trueno_rag_tpu.models import late_interaction as jli

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.convert import encoder_params_from_jax, late_interaction_from_state, token_store_from_state
from trueno_rag_tpu_torch.errors import DimensionMismatchError, InvalidConfigError, VectorStoreError
from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig, TokenVectorStore
from trueno_rag_tpu_torch.models import encoder as te
from trueno_rag_tpu_torch.models import late_interaction as tli
from trueno_rag_tpu_torch.ops.kernels import maxsim_scan as ks

H, LT = 64, 20
SCORE_TOL = 1e-5


def _chunk(pkg, i, content=""):
    text = content or f"chunk number {i}"
    return pkg.Chunk(document_id=f"doc{i % 3}", content=text, start_offset=0, end_offset=len(text),
                     metadata=pkg.ChunkMetadata(title=f"t{i}"), id=pkg.chunk_id_from_int(i))


def _mutate(store, pkg, seed=0, n=150):
    """The same sequence of mutations on either package's store: inserts
    past the initial capacity (growth), a batch, removals, a recycled row,
    a truncated row and a bulk ``load_rows``."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(n):
        mats.append(rng.standard_normal((int(rng.integers(1, LT + 1)), H)).astype(np.float32))
    for i in range(100):
        store.insert(_chunk(pkg, i), mats[i])
    store.insert_many([_chunk(pkg, i) for i in range(100, n)], mats[100:],
                      [np.arange(len(m)) % 5 != 4 for m in mats[100:]])  # masked-out tokens
    for i in (3, 17, 18, 60, 149):
        assert store.remove(_chunk(pkg, i).id)
    assert not store.remove(_chunk(pkg, 3).id)
    store.insert(_chunk(pkg, 500), rng.standard_normal((LT + 7, H)).astype(np.float32))  # truncated, recycled
    toks = rng.standard_normal((12, LT, H)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=2, keepdims=True)
    tm = np.arange(LT)[None, :] < rng.integers(1, LT + 1, size=12)[:, None]
    tm[4] = False  # an empty chunk
    store.load_rows([_chunk(pkg, 600 + i) for i in range(12)], toks, tm)
    return store


def _queries(seed=1, b=3, lq=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, H)).astype(np.float32)
    qm = np.arange(lq)[None, :] < np.array([lq, 3, 4])[:b, None]
    return q, qm


def _allowed(cap):
    return (np.arange(cap) % 3) != 1


SCANS = [
    dict(scan="exact"),
    dict(scan="token", t_hits=64, rescore=32),
    dict(scan="tiered", rescore=32),
    dict(scan="tiered", rescore=32, scan_dtype="bfloat16"),
    dict(scan="tiered", rescore=32, scan_dtype="int8"),
    dict(scan="tiered", rescore=32, scan_kernel="xla"),
    dict(scan="tiered", rescore=32, scan_kernel="xla", scan_dtype="int8"),
]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", SCANS, ids=lambda s: "-".join(str(v) for v in s.values()))
def test_store_matches_jax_through_mutations(scan, storage):
    jcfg = JConfig(hidden_dim=H, max_tokens=LT, initial_capacity=16, storage_dtype=storage, **scan)
    tcfg = TokenStoreConfig(hidden_dim=H, max_tokens=LT, initial_capacity=16, storage_dtype=storage, **scan)
    js = _mutate(JStore(jcfg), jrag)
    ts = _mutate(TokenVectorStore(tcfg, device="cpu"), trag)
    np.testing.assert_array_equal(ts._host, js._host)
    np.testing.assert_array_equal(ts._t_mask, js._t_mask)
    np.testing.assert_array_equal(ts._valid, js._valid)
    assert len(ts) == len(js) == 158 and ts._host.shape[0] == js._host.shape[0] == 256
    q, qm = _queries()
    for allowed in (None, _allowed(ts._host.shape[0])):
        s, r = ts.search_arrays(q, qm, 7, allowed_rows=allowed)
        jsc, jr = js.search_arrays(q, qm, 7, allowed_rows=allowed)
        np.testing.assert_array_equal(r, jr)
        np.testing.assert_allclose(s, jsc, atol=SCORE_TOL, rtol=SCORE_TOL)
        if allowed is not None:
            assert allowed[r[r >= 0]].all()
    # the port's results are its exact scan's, whatever the certificate said
    exact = TokenVectorStore(TokenStoreConfig(hidden_dim=H, max_tokens=LT, storage_dtype=storage), device="cpu")
    exact.load_rows([_chunk(trag, i) for i in range(ts._host.shape[0])], ts._host, ts._t_mask)
    exact._valid[:] = ts._valid
    s_e, r_e = exact.search_arrays(q, qm, 7)
    s, r = ts.search_arrays(q, qm, 7)
    np.testing.assert_array_equal(r, r_e)
    np.testing.assert_array_equal(s, s_e)


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
def test_xla_scan_kernel_runs_the_fused_tiers(scan_dtype, monkeypatch):
    """``scan_kernel="xla"`` loads (a JAX package configuration) and scans
    with the K6/K7 tiers, answering as ``"fused"`` does."""
    from trueno_rag_tpu_torch.index import token_store as mod

    name = "maxsim_topk_int8_fused" if scan_dtype == "int8" else "maxsim_topk_scan16_fused"
    calls = []
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    out = []
    for kernel in ("xla", "fused"):
        cfg = TokenStoreConfig(hidden_dim=H, max_tokens=LT, initial_capacity=16, scan="tiered", rescore=32,
                               scan_dtype=scan_dtype, scan_kernel=kernel)
        out.append(_mutate(TokenVectorStore(cfg, device="cpu"), trag).search_arrays(*_queries(), 7))
    assert len(calls) == 2
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_store_fallback_counts_uncertified_and_stays_exact():
    """Near-duplicate chunks defeat the certificate: those queries re-run
    on the exact scan (counted) and answer as it does."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((1, H)).astype(np.float32)
    cfg = dict(hidden_dim=H, max_tokens=4, scan="tiered", rescore=8)
    ts = TokenVectorStore(TokenStoreConfig(**cfg), device="cpu")
    ex = TokenVectorStore(TokenStoreConfig(**{**cfg, "scan": "exact"}), device="cpu")
    for i in range(200):
        m = base + 1e-4 * rng.standard_normal((4, H)).astype(np.float32)
        ts.insert(_chunk(trag, i), m)
        ex.insert(_chunk(trag, i), m)
    q = rng.standard_normal((4, 3, H)).astype(np.float32)
    s, r = ts.search_arrays(q, None, 10)
    assert ts.uncertified > 0
    s_e, r_e = ex.search_arrays(q, None, 10)
    np.testing.assert_array_equal(r, r_e)
    np.testing.assert_array_equal(s, s_e)


def test_store_validation_and_edges():
    with pytest.raises(InvalidConfigError):
        TokenStoreConfig(scan="pruned")
    with pytest.raises(InvalidConfigError):
        TokenStoreConfig(scan_kernel="pallas")
    with pytest.raises(InvalidConfigError):
        TokenStoreConfig(storage_dtype="int8")
    with pytest.raises(InvalidConfigError):
        TokenStoreConfig(rescore=0)
    assert TokenStoreConfig(storage_dtype="bfloat16").resolved_scan_dtype() == "int8"
    assert TokenStoreConfig().resolved_scan_dtype() == "bfloat16"
    store = TokenVectorStore(TokenStoreConfig(hidden_dim=8, max_tokens=4), device="cpu")
    assert store.is_empty() and store.search_tokens(np.ones((2, 8), np.float32), 3) == []
    with pytest.raises(DimensionMismatchError):
        store.insert(_chunk(trag, 0), np.ones((2, 9), np.float32))
    with pytest.raises(VectorStoreError):
        store.insert(_chunk(trag, 0), np.ones((0, 8), np.float32))
    with pytest.raises(VectorStoreError):
        store.insert_many([_chunk(trag, 0)], [])
    with pytest.raises(VectorStoreError):
        store.load_rows([_chunk(trag, 0)], np.ones((1, 3, 8), np.float32), np.ones((1, 3), bool))
    store.insert(_chunk(trag, 1), np.eye(8, dtype=np.float32)[:2])
    hits = store.search_tokens(np.eye(8, dtype=np.float32)[:1], 5)
    assert hits == [(_chunk(trag, 1).id, 1.0)]
    assert store.search_tokens(np.eye(8, dtype=np.float32)[:1], 0) == []
    with pytest.raises(DimensionMismatchError):
        store.search_arrays(np.ones((1, 2, 9), np.float32))
    with pytest.raises(VectorStoreError):
        store.search_arrays(np.ones((1, 2, 8), np.float32), allowed_rows=np.ones(3, bool))


def test_store_and_retriever_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(InvalidConfigError):
        TokenVectorStore(TokenStoreConfig())
    with pytest.raises(InvalidConfigError):
        tli.LateInteractionRetriever()
    with pytest.raises(InvalidConfigError):
        tli.LateInteractionReranker()


def test_tiered_store_on_cpu_takes_the_plain_versions():
    """On CPU tensors the fused tiers run K6's and K7's plain versions: no
    kernel launch is counted."""
    before = (ks.maxsim_scan16_scores.launches, ks.maxsim_scan_int8_scores.launches)
    for storage in ("float32", "bfloat16"):
        ts = _mutate(TokenVectorStore(TokenStoreConfig(hidden_dim=H, max_tokens=LT, scan="tiered",
                                                       storage_dtype=storage), device="cpu"), trag)
        ts.search_arrays(*_queries(), 5)
        assert ts._tier[0] == ("int8" if storage == "bfloat16" else "bfloat16")
    assert (ks.maxsim_scan16_scores.launches, ks.maxsim_scan_int8_scores.launches) == before


def test_token_store_from_state_carries_a_jax_store_with_tags():
    js = _mutate(JStore(JConfig(hidden_dim=H, max_tokens=LT, scan="tiered", rescore=32)), jrag)
    reg = js.registry
    for i in range(0, 150, 2):
        if reg.row_of(_chunk(jrag, i).id) is not None:
            reg.set_tags(_chunk(jrag, i).id, ["even"])
    cap = reg.capacity_rows
    ts = token_store_from_state([reg.chunk_of(r) for r in range(cap)], js._host, js._t_mask, js._valid,
                                js.config, device="cpu", tag_bits=reg.tags_host(cap),
                                tag_vocab=reg.tag_state([])[0])
    assert ts.config == TokenStoreConfig(hidden_dim=H, max_tokens=LT, scan="tiered", rescore=32)
    assert len(ts) == len(js)
    q, qm = _queries(3)
    s, r = ts.search_arrays(q, qm, 6)
    jsc, jr = js.search_arrays(q, qm, 6)
    np.testing.assert_array_equal(r, jr)
    allowed = ts.registry.tag_bits_array(ts._host.shape[0]) & ts.registry.bit_for("even", create=False) != 0
    s, r = ts.search_arrays(q, qm, 6, allowed_rows=allowed)
    jsc, jr = js.search_arrays(q, qm, 6, allowed_rows=allowed)
    np.testing.assert_array_equal(r, jr)
    assert [c for c, _ in ts._hydrate(s[0], r[0])] == [c for c, _ in js._hydrate(jsc[0], jr[0])]
    with pytest.raises(InvalidConfigError):
        token_store_from_state([], js._host[:, :3], js._t_mask, js._valid, js.config, device="cpu")


# ---------------------------------------------------------------------------
# the retriever and the reranker on the JAX package's weights
# ---------------------------------------------------------------------------


def _encoder_params(seed=0):
    """Tiny encoder weights with sharper attention than the 0.02 init, so
    that token states vary by text."""
    cfg = je.EncoderConfig.tiny()
    p = je.init_encoder_params(jax.random.PRNGKey(seed), cfg)
    p["tok_emb"] = p["tok_emb"] * 20.0
    p["qkv_w"] = p["qkv_w"] * 10.0
    return {k: np.asarray(v) for k, v in p.items()}


PARAMS = _encoder_params()
WORDS = np.array([f"w{i:03d}" for i in range(200)])


def _texts(n, seed=0, lo=6, hi=14):
    rng = np.random.default_rng(seed)
    return [" ".join(WORDS[rng.integers(0, len(WORDS), size=int(ln))]) for ln in rng.integers(lo, hi, size=n)]


def _jax_retriever(**store_kw):
    retr = jli.LateInteractionRetriever(
        config=je.EncoderConfig.tiny(), params={k: jnp.asarray(v) for k, v in PARAMS.items()}, max_len=32,
        store_config=JConfig(hidden_dim=64, max_tokens=32, **store_kw))
    chunks = [_chunk(jrag, i, t) for i, t in enumerate(_texts(120))]
    retr.index_batch(chunks, encode_batch=32)
    for i, c in enumerate(chunks):
        retr.store.registry.set_tags(c.id, ["even" if i % 2 == 0 else "odd"])
    return retr


def _carried(jr, **store_kw):
    reg, st = jr.store.registry, jr.store
    cap = reg.capacity_rows
    return late_interaction_from_state(
        [reg.chunk_of(r) for r in range(cap)], st._host, st._t_mask, st._valid,
        store_config=JConfig(hidden_dim=64, max_tokens=32, **store_kw), encoder_params=PARAMS,
        encoder_config=te.EncoderConfig.tiny(), max_len=32, device="cpu", tag_bits=reg.tags_host(cap),
        tag_vocab=reg.tag_state([])[0])


def _tie_free_queries(jr, tr, k, n=6):
    """Spans of indexed texts whose JAX top-(k+1) MaxSim scores are more
    than twice the two frameworks' largest score difference apart."""
    pool = [" ".join(t.split()[1:5]) for t in _texts(120)] + _texts(60, seed=9, lo=3, hi=6)
    cap = jr.store._host.shape[0]
    jq, jm = jr._encode(pool)
    tq, tm = tr._encode(pool)
    full_j, rows_j = jr.store.search_arrays(jq, jm, cap)
    full_t, rows_t = tr.store.search_arrays(tq, tm, cap)
    sj = np.full((len(pool), cap), -np.inf)
    st_ = np.full((len(pool), cap), -np.inf)
    for i in range(len(pool)):
        ok_j, ok_t = rows_j[i] >= 0, rows_t[i] >= 0
        sj[i, rows_j[i][ok_j]] = full_j[i][ok_j]
        st_[i, rows_t[i][ok_t]] = full_t[i][ok_t]
    fin = np.isfinite(sj)
    diff = np.abs(np.where(fin, st_, 0.0) - np.where(fin, sj, 0.0)).max(axis=1)
    top = -np.sort(-np.where(fin, sj, -np.inf), axis=1)[:, : k + 1]
    ok = (-np.diff(top, axis=1)).min(axis=1) > 2 * diff + 1e-6
    chosen = np.flatnonzero(ok)[:n]
    assert len(chosen) == n, f"only {int(ok.sum())} tie-free queries"
    return [pool[i] for i in chosen], float(diff[chosen].max())


def _ids(results):
    return [[r.chunk.id for r in q] for q in results]


@pytest.mark.parametrize("store_kw", [dict(), dict(scan="tiered", rescore=16),
                                      dict(scan="tiered", rescore=16, storage_dtype="bfloat16"),
                                      dict(scan="token", t_hits=64, rescore=16)],
                         ids=["exact", "tiered", "tiered-bf16", "token"])
def test_carried_retriever_matches_jax(store_kw):
    k = 4
    jr = _jax_retriever(**store_kw)
    tr = _carried(jr, **store_kw)
    assert len(tr) == len(jr) == 120 and tr.registry.capacity_rows == 120
    queries, delta = _tie_free_queries(jr, tr, k)
    got, want = tr.retrieve_batch(queries, k), jr.retrieve_batch(queries, k)
    assert _ids(got) == _ids(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([r.dense_score for r in g], [r.dense_score for r in w], atol=delta + 1e-6)
    single = tr.retrieve(queries[0], k)
    assert [r.chunk.id for r in single] == _ids(got)[0]
    # per-query filters group by their tag words; an unknown tag matches nothing
    filters = [trag.TagFilter(all=("even",)), None, trag.TagFilter(all=("nosuchtag",))]
    jfilters = [jrag.TagFilter(all=("even",)), None, jrag.TagFilter(all=("nosuchtag",))]
    got = tr.retrieve_batch(queries[:3], k, tag_filter=filters)
    want = jr.retrieve_batch(queries[:3], k, tag_filter=jfilters)
    even = {c.id for c in tr.registry._chunks if c is not None and tr.registry.tag_names_of(c.id) == ["even"]}
    assert got[0] and {r.chunk.id for r in got[0]} <= even
    assert got[1] and got[2] == [] == want[2]
    assert [r.chunk.id for r in got[0][:1]] == [r.chunk.id for r in want[0][:1]]
    assert _ids(got[1:2]) == _ids(want[1:2])


def test_retriever_indexes_and_retrieves_on_its_own():
    """A port retriever built from texts (JAX weights carried by
    ``encoder_params_from_jax``): its stored tokens agree with the JAX
    retriever's to bf16 rounding, each text retrieves itself first, and the
    tiered scan warms with ``ensure_ready``."""
    jr = _jax_retriever()
    tr = tli.LateInteractionRetriever(config=te.EncoderConfig.tiny(), params=encoder_params_from_jax(PARAMS, "cpu"),
                                      max_len=32, device="cpu",
                                      store_config=TokenStoreConfig(hidden_dim=64, max_tokens=32, scan="tiered",
                                                                    rescore=16))
    texts = _texts(120)
    tr.index(_chunk(trag, 0, texts[0]))
    tr.index_batch([_chunk(trag, i, t) for i, t in enumerate(texts)][1:], encode_batch=24)
    assert len(tr) == 120 and tr.store._tier is None
    np.testing.assert_array_equal(tr.store._t_mask[:120], jr.store._t_mask[:120])
    np.testing.assert_allclose(tr.store._host[:120], jr.store._host[:120], atol=0.05)
    tr.ensure_ready()
    assert tr.store._tier is not None
    for i in (0, 33, 71):
        assert tr.retrieve(texts[i], 3)[0].chunk.id == _chunk(trag, i).id
    assert tr.retrieve_batch([], 3) == [] and tr.retrieve("w001", 0) == []
    with pytest.raises(InvalidConfigError):
        tli.LateInteractionRetriever(max_len=8, device="cpu",
                                     store_config=TokenStoreConfig(hidden_dim=999, max_tokens=8))


def test_reranker_matches_jax():
    """Scores within the encoders' difference (Lq tokens of cosines each
    within ~1e-2); the order of tie-free candidates is the JAX one."""
    jrr = jli.LateInteractionReranker(config=je.EncoderConfig.tiny(),
                                      params={k: jnp.asarray(v) for k, v in PARAMS.items()}, max_len=32)
    trr = tli.LateInteractionReranker(config=te.EncoderConfig.tiny(), params=encoder_params_from_jax(PARAMS, "cpu"),
                                      max_len=32, device="cpu")
    docs = _texts(11, seed=4)
    query = " ".join(docs[2].split()[:5])
    s_t, s_j = trr.score_batch(query, docs), jrr.score_batch(query, docs)
    assert s_t.shape == (11,) and trr.score_batch(query, []).shape == (0,)
    delta = float(np.abs(s_t - s_j).max())
    assert delta <= 0.02
    cands = [jrag.RetrievalResult(chunk=_chunk(jrag, i, t)) for i, t in enumerate(docs)]
    tcands = [trag.RetrievalResult(chunk=_chunk(trag, i, t)) for i, t in enumerate(docs)]
    got = [r.chunk.id for r in trr.rerank(query, tcands, 5)]
    want = [r.chunk.id for r in jrr.rerank(query, cands, 5)]
    order = np.sort(s_j)[::-1]
    clear = int(np.argmax(np.append(-np.diff(order) <= 2 * delta, True)))  # the leading tie-free prefix
    assert got[0] == want[0] == _chunk(trag, 2).id
    assert got[:clear] == want[:clear]


def test_maxsim_matches_oracle_and_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    d = rng.standard_normal((5, 11, 16)).astype(np.float32)
    qm, dm = rng.random(7) < 0.8, rng.random((5, 11)) < 0.8
    qm[0], dm[1] = True, False  # an all-padding candidate
    got = tli.maxsim(*(torch.from_numpy(x) for x in (q, qm, d, dm))).numpy()
    np.testing.assert_allclose(got, tli.maxsim_oracle(q, qm, d, dm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jli.maxsim(*(jnp.asarray(x) for x in (q, qm, d, dm)))),
                               rtol=1e-5, atol=1e-5)
    assert got[1] == 0.0
    np.testing.assert_array_equal(tli.maxsim_oracle(q, qm, d, dm), jli.maxsim_oracle(q, qm, d, dm))
