"""The span recorder (``utils/profiling.py``) on the CPU: the tree of spans
that one ``retrieve_batch`` of the hybrid retriever (dense only, and the
staged hybrid on the bf16 tier) and of the late-interaction retriever
records, self times, threads, the token counters, ``rag.gc``, the bounded
buffer, nothing recorded or profiled while the recorder is off,
``device_trace``'s Chrome trace, and results equal with spans on and off."""

import gc
import json
import os
import threading

import numpy as np
import pytest
import torch

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig
from trueno_rag_tpu_torch.models.encoder import EncoderConfig, count_tokens, pad_batch_pow2
from trueno_rag_tpu_torch.models.late_interaction import LateInteractionRetriever
from trueno_rag_tpu_torch.utils import device_trace, profiling

WORDS = ["array", "kernel", "vector", "sparse", "dense", "fusion", "chunk", "token", "query", "index", "tile", "scan"]
QUERIES = ["dense vector scan", "sparse token index query", "kernel fusion", "chunk tile array kernel dense"]

# each span name → the names its parent may have (None: a root)
PARENTS = {
    "rag.retrieve": {None},
    "rag.encode": {"rag.retrieve"},
    "rag.encode.tokenize": {"rag.encode"},
    "rag.encode.forward": {"rag.encode"},
    "rag.encode.forward.wait": {"rag.encode.forward"},
    "rag.encode.wait": {"rag.encode"},
    "rag.scan": {"rag.retrieve"},
    "rag.scan.wait": {"rag.scan", "rag.scan.fallback"},
    "rag.scan.fallback": {"rag.scan"},
    "rag.sparse": {"rag.retrieve"},
    "rag.fuse": {"rag.retrieve"},
    "rag.hydrate": {"rag.retrieve"},
    "rag.hydrate.wait": {"rag.hydrate"},
}
ENCODE = {"rag.retrieve", "rag.encode", "rag.encode.tokenize", "rag.encode.forward", "rag.encode.forward.wait",
          "rag.encode.wait", "rag.scan", "rag.scan.wait", "rag.hydrate"}
EXPECTED = {
    "dense": ENCODE | {"rag.hydrate.wait"},
    "hybrid": ENCODE | {"rag.hydrate.wait", "rag.sparse", "rag.fuse"},
    "late": ENCODE,
}


def _texts(n):
    return [" ".join(WORDS[(i * j + j) % len(WORDS)] for j in range(1, 6)) + f" item{i}" for i in range(n)]


def _chunks(n):
    return [trag.Chunk(document_id=f"d{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i}")
            for i, t in enumerate(_texts(n))]


def _hybrid(use_sparse: bool):
    emb = trag.EncoderEmbedder(config=EncoderConfig.tiny(), seed=3, device="cpu")
    r = trag.HybridRetriever(
        emb, trag.HybridRetrieverConfig(use_sparse=use_sparse, candidates_per_source=12),
        vector_config=trag.VectorStoreConfig(dimension=64, scan_tier="bf16", scan_tile_n=1024), device="cpu")
    chunks = _chunks(300)
    emb.embed_chunks(chunks)
    r.index_batch(chunks)
    r.ensure_ready()
    return r


def _late():
    r = LateInteractionRetriever(config=EncoderConfig.tiny(), seed=4, max_len=16, device="cpu",
                                 store_config=TokenStoreConfig(hidden_dim=64, max_tokens=16, scan="tiered",
                                                               rescore=16))
    r.index_batch(_chunks(200), encode_batch=64)
    r.ensure_ready()
    return r


@pytest.fixture(scope="module")
def retrievers():
    return {"dense": _hybrid(False), "hybrid": _hybrid(True), "late": _late()}


def _ids_fed(kind, retr, queries):
    """The padded ids the retriever's encoder is fed for ``queries``."""
    if kind == "late":
        return pad_batch_pow2(retr.tokenizer.encode_batch(queries))
    emb = retr.embedder
    return pad_batch_pow2(emb.tokenizer.encode_batch([emb.config.query_prefix + q for q in queries]))


def _fallbacks(retr):
    if isinstance(retr, LateInteractionRetriever):
        return retr.store.uncertified
    return retr.vector_store.tier_fallback_queries


def _answers(results):
    return [[(r.chunk.id, r.dense_score, r.sparse_score, r.fused_score) for r in res] for res in results]


@pytest.mark.parametrize("kind", ["dense", "hybrid", "late"])
def test_one_call_records_one_tree(retrievers, kind):
    retr = retrievers[kind]
    before = _fallbacks(retr)
    with profiling.spans() as rec:
        retr.retrieve_batch(QUERIES, 3)
        retr.retrieve_batch(QUERIES[:2], 2)
    spans = [s for s in rec.spans if s.name != "rag.gc"]
    # a fallback span copies the store's count of the batch's re-run queries
    fallbacks = [s for s in spans if s.name == "rag.scan.fallback"]
    assert sum(s.attrs["queries"] for s in fallbacks) == _fallbacks(retr) - before
    spans = [s for s in spans if s.name != "rag.scan.fallback"]
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in spans if s.name == "rag.retrieve"]
    assert len(roots) == 2 and all(s.parent == 0 and s.root == s.id for s in roots)
    assert [r.attrs for r in sorted(roots, key=lambda s: s.t0_ns)] == [{"queries": 4, "k": 3}, {"queries": 2, "k": 2}]
    for root in roots:
        tree = [s for s in spans if s.root == root.id]
        assert {s.name for s in tree} == EXPECTED[kind]
        assert sum(s.name == "rag.retrieve" for s in tree) == 1
    assert {s.root for s in spans} == {r.id for r in roots}
    for s in rec.spans:
        parent = by_id.get(s.parent)
        if s.name != "rag.gc":
            assert (parent.name if parent else None) in PARENTS[s.name], (s.name, parent)
        if parent is not None:
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
            assert parent.thread == s.thread and parent.root == s.root
    fed = [_ids_fed(kind, retr, qs) for qs in (QUERIES, QUERIES[:2])]
    assert rec.counters == {"rag.encode.tokens": sum(int(np.count_nonzero(i)) for i in fed),
                            "rag.encode.padded_tokens": sum(i.size for i in fed)}
    assert rec.dropped == 0


@pytest.mark.parametrize("kind", ["dense", "hybrid", "late"])
def test_self_times_are_positive_and_add_up_to_the_root(retrievers, kind):
    with profiling.spans() as rec:
        retrievers[kind].retrieve_batch(QUERIES, 3)
    own = rec.self_times()
    assert set(own) == {s.id for s in rec.spans} and all(v >= 0 for v in own.values())
    root = next(s for s in rec.spans if s.name == "rag.retrieve")
    assert sum(own[s.id] for s in rec.spans if s.root == root.id) == root.t1_ns - root.t0_ns


@pytest.mark.parametrize("kind", ["dense", "hybrid", "late"])
def test_results_are_the_same_with_spans_on_and_off(retrievers, kind):
    retr = retrievers[kind]
    off = _answers(retr.retrieve_batch(QUERIES, 3))
    with profiling.spans():
        on = _answers(retr.retrieve_batch(QUERIES, 3))
    assert on == off and all(len(r) == 3 for r in on)


def test_spans_of_two_threads_do_not_nest(retrievers):
    barrier = threading.Barrier(2)
    errors = []

    def work(kind):
        try:
            barrier.wait(timeout=30)
            for _ in range(3):
                retrievers[kind].retrieve_batch(QUERIES, 3)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    with profiling.spans() as rec:
        threads = [threading.Thread(target=work, args=(kind,)) for kind in ("dense", "late")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    by_id = {s.id: s for s in rec.spans}
    roots = [s for s in rec.spans if s.name == "rag.retrieve"]
    assert len(roots) == 6 and len({s.thread for s in roots}) == 2
    for s in rec.spans:
        if s.parent:
            assert by_id[s.parent].thread == s.thread
        assert by_id[s.root].thread == s.thread


def test_nothing_is_recorded_or_profiled_while_off(retrievers):
    retr = retrievers["hybrid"]
    with profiling.spans() as rec:
        retr.retrieve_batch(QUERIES, 3)
    n, counters = len(rec.spans), dict(rec.counters)
    assert profiling.active() is None and rec._on_gc not in gc.callbacks
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        retr.retrieve_batch(QUERIES, 3)
    names = [e.name for e in prof.events()]
    assert any(name.startswith("aten::") for name in names)
    assert not any(name.startswith("rag.") for name in names)
    assert len(rec.spans) == n and rec.counters == counters
    with profiling.spans(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        retr.retrieve_batch(QUERIES, 3)
    assert {"rag.retrieve", "rag.scan", "rag.sparse", "rag.hydrate.wait"} <= {e.name for e in prof.events()}


def test_device_trace_shows_the_retrievers_stages(retrievers, tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir, device="cpu"):
        retrievers["late"].retrieve_batch(QUERIES, 3)
    assert profiling.active() is None
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rag.retrieve", "rag.encode.forward", "rag.scan.wait", "rag.hydrate"} <= names


def test_recorder_nesting_buffer_gc_and_counters():
    ids = np.array([[1, 5, 2, 0], [1, 2, 0, 0]], np.int32)
    count_tokens(ids)  # off: nothing to count into
    with profiling.spans(capacity=4) as rec:
        with profiling.spans() as inner:
            assert inner is rec and profiling.active() is rec
        with profiling.span("rag.retrieve") as root:
            root.attrs["queries"] = 2
            with profiling.span("rag.encode"):
                count_tokens(ids)
            gc.collect()
            with pytest.raises(ValueError):
                with profiling.span("rag.scan"):
                    raise ValueError("x")
        for _ in range(3):
            with profiling.span("rag.hydrate"):
                pass
    assert profiling.active() is None and profiling.span("rag.scan").__enter__() is None
    assert rec.counters == {"rag.encode.tokens": 5, "rag.encode.padded_tokens": 8}
    # spans are kept as they close: encode, gc, scan, retrieve; the rest are dropped
    assert [s.name for s in rec.spans] == ["rag.encode", "rag.gc", "rag.scan", "rag.retrieve"] and rec.dropped == 3
    encode, collect, scan, retrieve = rec.spans
    assert collect.attrs == {"generation": 2} and retrieve.attrs == {"queries": 2}
    assert {encode.parent, collect.parent, scan.parent} == {retrieve.id} and retrieve.parent == 0
    assert {s.root for s in rec.spans} == {retrieve.id}
    assert rec._stack() == []
