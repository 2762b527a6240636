"""The tri-hybrid (dense + BM25 + learned-sparse, fused N-way) against the
JAX package, on the JAX package's SPLADE weights carried across (an f32
trunk in both, so the two encoders expand alike):

- the staged tri-hybrid on tier "bf16" (the tile scan's plain version on
  the CPU) and on tier "none" (the fp32 matrix), every fusion kind, against
  the JAX retriever and against the host oracle ``FusionStrategy.fuse_many``;
  the learned panels split into groups on tier "none" answer alike;
- tag filters, ``use_learned=False``, learned-only, dense + learned,
  ``fused=True`` → QueryError, an empty learned store, ``remove``;
- a pipeline built ``with_learned_sparse`` against the JAX pipeline;
- tri-hybrid index artifacts (v1 and v2) written by either package and
  loaded by the other with the encoder, answers equal; a mismatched
  encoder refused by the fingerprint check; without an encoder the
  two-source hybrid;
- the CLI's ``index --learned-sparse`` and ``--with-learned-sparse`` on
  the CPU against in-memory retrievers.

Documents have distinct word counts (no two BM25 scores tie) and the
queries' dense lists are tie-free; rows must be equal, scores within rel
1e-4 (the candidate tails' f32 prefix sums)."""

import contextlib
import dataclasses
import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import trueno_rag_tpu as jrag
from trueno_rag_tpu import cli as jcli
from trueno_rag_tpu import persist as jpersist
from trueno_rag_tpu.models import splade as js
from trueno_rag_tpu.models.encoder import EncoderConfig as JConfig

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import cli as tcli
from trueno_rag_tpu_torch import persist as tpersist
from trueno_rag_tpu_torch.convert import splade_params_from_jax
from trueno_rag_tpu_torch.models import splade as ts
from trueno_rag_tpu_torch.models.encoder import EncoderConfig as TConfig
from trueno_rag_tpu_torch.index import learned_sparse as tls
from trueno_rag_tpu_torch.ops import bm25 as tbm25

DIM = 48
CAND = 8
N_DOCS = 64
WORDS = [f"w{i:03d}" for i in range(220)]
FIELDS = ("dense_score", "sparse_score", "fused_score", "learned_score")
STRATEGIES = ("rrf", "linear", "dbsf", "union", "intersection")


def _texts():
    rng = np.random.default_rng(11)
    return [" ".join(rng.choice(WORDS, size=6 + i)) for i in range(N_DOCS)]


QUERIES = [" ".join(t.split()[1:5]) for t in _texts()[::9]] + ["w010 w020 w030 w040"]


def _strategy(mod, kind):
    return {"rrf": lambda: mod.FusionStrategy.rrf(60.0), "linear": lambda: mod.FusionStrategy.linear(0.5),
            "dbsf": mod.FusionStrategy.dbsf, "union": mod.FusionStrategy.union,
            "intersection": mod.FusionStrategy.intersection}[kind]()


@functools.lru_cache(maxsize=None)
def _encoders(seed=0):
    """The JAX encoder and the port's over its weights, made once per seed
    (neither holds state past its weights)."""
    je = js.SpladeEncoder(config=dataclasses.replace(JConfig.tiny(), compute_dtype=jnp.float32), seed=seed,
                          max_len=64, doc_top=32, query_top=12)
    te = ts.SpladeEncoder(config=dataclasses.replace(TConfig.tiny(), compute_dtype=torch.float32),
                          params=splade_params_from_jax(je.params, "cpu"), max_len=64, doc_top=32, query_top=12,
                          device="cpu")
    return je, te


def _chunks(rag, emb):
    out = []
    for i, t in enumerate(_texts()):
        c = rag.Chunk(document_id=f"d{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i:03d}")
        out.append(c)
    emb.embed_chunks(out)
    return out


def _tagged(retr, chunks):
    for i, c in enumerate(chunks):
        retr.registry.set_tags(c.id, ["even" if i % 2 == 0 else "odd"] + (["x"] if i % 3 == 0 else []))


def _jax_retriever(config=None, seed=0, attach=True):
    emb = jrag.MockEmbedder(dimension=DIM)
    retr = jrag.HybridRetriever(emb, config=config or jrag.HybridRetrieverConfig(candidates_per_source=CAND))
    chunks = _chunks(jrag, emb)
    retr.index_batch(chunks)
    _tagged(retr, chunks)
    if attach:
        retr.attach_learned_sparse(_encoders(seed)[0])
    return retr


def _port_retriever(tier="none", config=None, seed=0, attach=True):
    emb = trag.MockEmbedder(dimension=DIM)
    retr = trag.HybridRetriever(emb, config=config or trag.HybridRetrieverConfig(candidates_per_source=CAND),
                                vector_config=trag.VectorStoreConfig(dimension=DIM, scan_tier=tier,
                                                                     scan_tier_auto_rows=16), device="cpu")
    chunks = _chunks(trag, emb)
    retr.index_batch(chunks)
    _tagged(retr, chunks)
    if attach:
        retr.attach_learned_sparse(_encoders(seed)[1])
    return retr


def _same(a_lists, b_lists):
    for a, b in zip(a_lists, b_lists):
        assert [r.chunk.id for r in a] == [r.chunk.id for r in b]
        for x, y in zip(a, b):
            for f in FIELDS:
                xv, yv = getattr(x, f), getattr(y, f)
                assert (xv is None) == (yv is None), f
                if xv is not None:
                    assert xv == pytest.approx(yv, rel=1e-4, abs=1e-6), f


@pytest.fixture(scope="module")
def jax_tri_module():
    return _jax_retriever()


@pytest.fixture
def jax_tri(jax_tri_module):
    """The module's JAX tri-hybrid, its config reset after each test."""
    yield jax_tri_module
    jax_tri_module.config = jrag.HybridRetrieverConfig(candidates_per_source=CAND)


@pytest.fixture(scope="module")
def port_tri_module():
    return {}


@pytest.fixture
def port_tri(port_tri_module):
    """The module's port tri-hybrids, one per tier, built on first use; their
    configs reset after each test (tests that mutate the index build their
    own)."""

    def get(tier="none"):
        if tier not in port_tri_module:
            port_tri_module[tier] = _port_retriever(tier)
        return port_tri_module[tier]

    yield get
    for retr in port_tri_module.values():
        retr.config = trag.HybridRetrieverConfig(candidates_per_source=CAND)


@pytest.mark.parametrize("kind", STRATEGIES)
@pytest.mark.parametrize("tier", ["none", "bf16"])
def test_tri_hybrid_matches_jax_and_host_oracle(jax_tri, port_tri, tier, kind, monkeypatch):
    tr = port_tri(tier)
    assert tr.learned_index.state_dict()["row_terms"] == jax_tri.learned_index.state_dict()["row_terms"]
    assert tr.vector_store._effective_tier() == tier
    calls = []
    real = tr.learned_index.search_arrays
    monkeypatch.setattr(tr.learned_index, "search_arrays", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tr.config.fusion = _strategy(trag, kind)
    jax_tri.config.fusion = _strategy(jrag, kind)
    got = tr.retrieve_batch(QUERIES, 6)
    assert calls == [1]  # staged on every tier: the learned source through the index's grouped search
    _same(got, jax_tri.retrieve_batch(QUERIES, 6))
    assert sum(r.learned_score is not None for res in got for r in res) > 0
    for q, res in zip(QUERIES, got):  # the host oracle over the port's own lists
        qv = np.asarray(tr.embedder.embed_query(q), np.float32)
        m = tr.vector_store._host[: tr.registry.capacity_rows]
        sc = m @ qv
        dense = sorted(((i, float(s)) for i, s in enumerate(sc)), key=lambda kv: (-kv[1], kv[0]))[:CAND]
        sparse = [(tr.registry.row_of(cid), s) for cid, s in tr.sparse_index.search_host(q, CAND)]
        qt, qw = tr.learned_encoder.expand_queries([q])
        learned = tr.learned_index.search_host(qt[0], qw[0], CAND)
        want = [r for r, _ in tr.config.fusion.fuse_many([dense, sparse, learned])]
        assert [tr.registry.row_of(r.chunk.id) for r in res] == want[: len(res)], (kind, q)


def test_filters_sources_and_errors_match_jax(jax_tri, port_tri):
    for tier in ("none", "bf16"):
        tr = port_tri(tier)
        f_t, f_j = trag.TagFilter(all=("even",)), jrag.TagFilter(all=("even",))
        got = tr.retrieve_batch(QUERIES, 5, tag_filter=f_t)
        _same(got, jax_tri.retrieve_batch(QUERIES, 5, tag_filter=f_j))
        assert all(int(r.chunk.id[1:]) % 2 == 0 for res in got for r in res)
        per_t = [trag.TagFilter(any=("x",)) if i % 2 else None for i in range(len(QUERIES))]
        per_j = [jrag.TagFilter(any=("x",)) if i % 2 else None for i in range(len(QUERIES))]
        _same(tr.retrieve_batch(QUERIES, 5, tag_filter=per_t), jax_tri.retrieve_batch(QUERIES, 5, tag_filter=per_j))
    for kw in ({"use_learned": False}, {"use_dense": False, "use_sparse": False}, {"use_sparse": False},
               {"use_dense": False}):
        jr, tr = jax_tri, port_tri()
        jr.config = jrag.HybridRetrieverConfig(candidates_per_source=CAND, **kw)
        tr.config = trag.HybridRetrieverConfig(candidates_per_source=CAND, **kw)
        got = tr.retrieve_batch(QUERIES, 5)
        _same(got, jr.retrieve_batch(QUERIES, 5))
        if kw == {"use_learned": False}:
            assert all(r.learned_score is None for res in got for r in res)
        if "use_dense" in kw and "use_sparse" in kw:
            assert all(r.fused_score is None and r.learned_score is not None for res in got for r in res)
    for mod, retr in ((trag, port_tri()), (jrag, jax_tri)):
        retr.config = mod.HybridRetrieverConfig(candidates_per_source=CAND)
        retr.config.fused = True
        with pytest.raises(mod.QueryError, match="fused=True"):
            retr.retrieve_batch(QUERIES, 3)
        retr.config.fused = None
        retr.config.use_dense = retr.config.use_sparse = retr.config.use_learned = False
        with pytest.raises(mod.QueryError, match="disabled"):
            retr.retrieve_batch(QUERIES, 3)
        retr.config.use_dense = retr.config.use_sparse = retr.config.use_learned = True
    tr = _port_retriever()  # its own: the removal below mutates it
    assert tr.retrieve_batch_submit(QUERIES, 3)[0] == "done"
    tr.config.fused = False  # the tri-hybrid is staged either way: the same answers
    _same(tr.retrieve_batch(QUERIES, 5), jax_tri.retrieve_batch(QUERIES, 5))
    victim = tr.retrieve(QUERIES[0], 1)[0].chunk.id
    assert tr.remove(victim) and victim not in [r.chunk.id for r in tr.retrieve(QUERIES[0], 6)]
    assert all(victim not in [r.chunk.id for r in res] for res in tr.retrieve_batch(QUERIES, 6))


def test_learned_panels_split_into_groups_on_tier_none(port_tri, monkeypatch):
    """A panel cap below one query's panel scores each query alone; the
    answers (unfiltered and under per-query filters) equal the one-group
    run's, bit for bit."""
    tr = port_tri("none")
    per_q = [trag.TagFilter(any=("x",)) if i % 2 else None for i in range(len(QUERIES))]
    want = [tr.retrieve_batch(QUERIES, 6), tr.retrieve_batch(QUERIES, 6, tag_filter=per_q)]
    calls = []
    real = tbm25.weighted_topk_blocks
    monkeypatch.setattr(tbm25, "weighted_topk_blocks", lambda *a, **kw: calls.append(a[0].shape[0]) or real(*a, **kw))
    monkeypatch.setattr(tls, "_PANEL_LANES", tbm25.BLOCK_LEN)
    got = [tr.retrieve_batch(QUERIES, 6), tr.retrieve_batch(QUERIES, 6, tag_filter=per_q)]
    assert calls == [1] * (2 * len(QUERIES))
    for a, b in zip(got, want):
        assert [[(r.chunk.id, r.dense_score, r.sparse_score, r.fused_score, r.learned_score) for r in res]
                for res in a] == [[(r.chunk.id, r.dense_score, r.sparse_score, r.fused_score, r.learned_score)
                                   for r in res] for res in b]


def test_attach_backfills_and_empty_learned_store():
    tr = _port_retriever(attach=False)
    jr = _jax_retriever(attach=False)
    tr.attach_learned_sparse(_encoders()[1], encode_batch=7)
    jr.attach_learned_sparse(_encoders()[0], encode_batch=7)
    assert len(tr.learned_index) == N_DOCS
    _same(tr.retrieve_batch(QUERIES, 5), jr.retrieve_batch(QUERIES, 5))
    emb = trag.MockEmbedder(dimension=DIM)
    empty = trag.HybridRetriever(emb, device="cpu")
    empty.attach_learned_sparse(_encoders()[1])
    chunks = _chunks(trag, emb)
    empty.sparse_index.add_batch(chunks)
    empty.vector_store.insert_many(chunks)
    res = empty.retrieve(QUERIES[0], 3)
    assert res and all(r.learned_score is None for r in res)
    r = trag.RetrievalResult(chunk=chunks[0], learned_score=2.0)
    assert r.best_score() == 2.0
    r.sparse_score = 1.0
    assert r.best_score() == 1.0


def test_pipeline_with_learned_sparse_matches_jax():
    docs = [(t, f"doc{i}") for i, t in enumerate(_texts()[:24])]
    pipes = []
    for rag, enc in ((jrag, _encoders()[0]), (trag, _encoders()[1])):
        b = (rag.RagPipelineBuilder().with_embedder(rag.MockEmbedder(dimension=DIM))
             .with_reranker(rag.NoOpReranker()).with_learned_sparse(enc)
             .with_retriever_config(rag.HybridRetrieverConfig(candidates_per_source=CAND)))
        if rag is trag:
            b = b.with_device("cpu")
        p = b.build()
        p.index_documents([rag.Document(t, id=i) for t, i in docs])
        pipes.append(p)
    jp, tp = pipes
    assert len(tp.retriever.learned_index) == len(jp.retriever.learned_index) > 0
    for a, b in zip(tp.query_with_context_batch(QUERIES, k=4), jp.query_with_context_batch(QUERIES, k=4)):
        assert [c.content for c in a.chunks] == [c.content for c in b.chunks]  # chunk ids are random
        np.testing.assert_allclose([c.score for c in a.chunks], [c.score for c in b.chunks], rtol=1e-4)


@pytest.mark.parametrize("streaming", [False, True], ids=["v1", "v2"])
def test_tri_artifacts_load_in_either_package(jax_tri, port_tri, tmp_path, streaming):
    tr = port_tri()
    je, te = _encoders()
    j_path, t_path = str(tmp_path / "j.trag"), str(tmp_path / "t.trag")
    if streaming:
        jpersist.save_index_streaming(j_path, jax_tri, frame_rows=16)
        tpersist.save_index_streaming(t_path, tr, frame_rows=16)
    else:
        jpersist.save_index(j_path, jax_tri)
        tpersist.save_index(t_path, tr)
    for path, seed in ((j_path, 0), (t_path, None)):  # the port's encoder holds carried weights: no seed
        info = tpersist.read_index_info(path)["learned"]
        assert info == jpersist.read_index_info(path)["learned"]
        assert (info["max_len"], info["doc_top"], info["query_top"], info["seed"]) == (64, 32, 12, seed)
        assert info["params_fingerprint"] == te.params_fingerprint() == je.params_fingerprint()
    t_from_j, _ = tpersist.load_index(j_path, trag.MockEmbedder(dimension=DIM), learned_encoder=te, device="cpu")
    j_from_t, _ = jpersist.load_index(t_path, jrag.MockEmbedder(dimension=DIM), learned_encoder=je)
    assert t_from_j.learned_index.state_dict() == jax_tri.learned_index.state_dict()
    assert j_from_t.learned_index.state_dict() == tr.learned_index.state_dict()
    want = jax_tri.retrieve_batch(QUERIES, 6)
    _same(t_from_j.retrieve_batch(QUERIES, 6), want)
    _same(j_from_t.retrieve_batch(QUERIES, 6), want)
    f = trag.TagFilter(any=("x",))
    _same(t_from_j.retrieve_batch(QUERIES, 6, tag_filter=f), tr.retrieve_batch(QUERIES, 6, tag_filter=f))
    wrong = ts.SpladeEncoder(config=te.config, seed=4, max_len=64, doc_top=32, query_top=12, device="cpu")
    with pytest.raises(trag.InvalidConfigError, match="fingerprint"):
        tpersist.load_index(j_path, trag.MockEmbedder(dimension=DIM), learned_encoder=wrong, device="cpu")
    plain, _ = tpersist.load_index(t_path, trag.MockEmbedder(dimension=DIM), device="cpu")
    assert plain.learned_index is None
    assert all(r.learned_score is None for r in plain.retrieve(QUERIES[0], 4))


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def test_cli_learned_sparse_indexes(tmp_path):
    docs = tmp_path / "docs"
    for i, t in enumerate(_texts()[:30]):
        sub = docs / ("a" if i % 2 else "")
        sub.mkdir(parents=True, exist_ok=True)
        (sub / f"f{i:02d}.md").write_text(t)
    q = QUERIES[1]
    cpu = ["--device", "cpu"]
    tri_dir, sp_dir = str(tmp_path / "tri"), str(tmp_path / "sp")
    rc, out = _run(tcli, cpu + ["index", "--path", str(docs), "--output", tri_dir, "--with-learned-sparse",
                                "--dimension", "64", "--tag-by-dir"])
    assert rc == 0 and "indexed 30 documents" in out
    rc, out = _run(tcli, cpu + ["index", "--path", str(docs), "--output", sp_dir, "--learned-sparse"])
    assert rc == 0 and "learned-sparse" in out and "postings" in out
    got = json.loads(_run(tcli, cpu + ["query", q, "--index", tri_dir, "--format", "json"])[1])
    assert got and any(r["learned_score"] is not None for r in got)
    filtered = json.loads(_run(tcli, cpu + ["query", q, "--index", tri_dir, "--format", "json",
                                            "--filter-all", "dir:a"])[1])
    in_a = {t for i, t in enumerate(_texts()[:30]) if i % 2}
    assert filtered and all(r["content"] in in_a for r in filtered)
    # the in-memory references: the same files, chunker, embedder and seed-0 encoder
    ref = (trag.RagPipelineBuilder().with_embedder(tcli._build_embedder("tfidf", 64, None))
           .with_reranker(trag.NoOpReranker()).with_chunker(trag.RecursiveChunker(chunk_size=512, overlap=64))
           .with_learned_sparse(ts.SpladeEncoder(seed=0, device="cpu")).with_device("cpu").build())
    walked = tcli._walk_documents(str(docs))
    ref.embedder.fit([d.content for d in walked])
    ref.index_documents(walked)
    want = ref.retriever.retrieve(q, 5)
    assert [(r["content"], r["learned_score"]) for r in got] == [(r.chunk.content, r.learned_score) for r in want]
    sp = ts.SpladeRetriever(seed=0, device="cpu")
    chunker = trag.RecursiveChunker(chunk_size=512, overlap=64)
    for d in walked:
        sp.index_batch(chunker.chunk(d))
    got = json.loads(_run(tcli, cpu + ["query", q, "--index", sp_dir, "--format", "json"])[1])
    assert [(r["content"], r["sparse_score"]) for r in got] == [
        (r.chunk.content, r.sparse_score) for r in sp.retrieve(q, 5)]
    # the JAX CLI's seed-0 encoder is another model: its tri-hybrid index is
    # refused rather than scored as noise
    j_dir = str(tmp_path / "jax")
    assert _run(jcli, ["index", "--path", str(docs), "--output", j_dir, "--with-learned-sparse"])[0] == 0
    with pytest.raises(trag.InvalidConfigError, match="fingerprint"):
        _run(tcli, cpu + ["query", q, "--index", j_dir])
