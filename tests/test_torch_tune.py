"""The serving autotuner and stage timing on the CPU: ``calibration_queries``
equal to the JAX package's on the same registry (hybrid, token and
learned-sparse retrievers); ``autotune_serving`` on a tiny store (its
table, the latency budget, bad inputs, the clustered probe sweep and the
MaxSim rescore sweep, each winner installed on the live config and every
candidate's answers unchanged); ``run_server(max_batch="auto")`` handing
the tuned values to the batcher; ``prewarm``; ``StageTimer`` and
``device_trace`` (a Chrome trace of the CPU activity)."""

import json
import os

import numpy as np
import pytest
import torch

import trueno_rag_tpu as jrag
from trueno_rag_tpu import tune as jtune

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import serve as tserve
from trueno_rag_tpu_torch import tune as ttune
from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig
from trueno_rag_tpu_torch.models.encoder import EncoderConfig
from trueno_rag_tpu_torch.models.late_interaction import LateInteractionRetriever
from trueno_rag_tpu_torch.models.splade import SpladeRetriever
from trueno_rag_tpu_torch.utils import StageTimer, device_trace

TEXTS = [
    "array programs compile for the accelerator through one toolchain",
    "BM25 ranks documents with term frequency and inverse document frequency",
    "hybrid retrieval fuses dense vector search with sparse lexical search",
    "context assembly fits retrieved chunks into a model token budget",
]


def _hybrid(rag, **vcfg):
    emb = rag.MockEmbedder(dimension=32)
    kw = {"device": "cpu"} if rag is trag else {}
    if vcfg:
        kw["vector_config"] = rag.VectorStoreConfig(dimension=32, **vcfg)
    r = rag.HybridRetriever(emb, **kw)
    chunks = []
    for i in range(64):
        t = f"{TEXTS[i % 4]} item{i}"
        chunks.append(rag.Chunk(document_id="d", content=t, start_offset=0, end_offset=len(t), id=f"c{i}"))
    emb.embed_chunks(chunks)
    r.index_batch(chunks)
    return r


@pytest.fixture(scope="module")
def retriever():
    return _hybrid(trag)


def test_calibration_queries_equal_jax(retriever):
    jr = _hybrid(jrag)
    for n, seed in ((8, 1), (40, 7)):
        assert ttune.calibration_queries(retriever, n, seed=seed) == jtune.calibration_queries(jr, n, seed=seed)
    corpus = set(" ".join(TEXTS).split())
    assert all(w in corpus or w.startswith("item") for q in ttune.calibration_queries(retriever, 8, seed=1)
               for w in q.split())
    li = LateInteractionRetriever(config=EncoderConfig.tiny(), max_len=8, device="cpu")
    sp = SpladeRetriever(seed=0, device="cpu")
    for r in (li, sp):
        r.index_batch([trag.Chunk(document_id="d", content=f"quokka{i} marsupial", start_offset=0, end_offset=6,
                                  id=f"q{i}") for i in range(6)])
        assert any(w.startswith("quokka") for q in ttune.calibration_queries(r, 4) for w in q.split())
    assert ttune.calibration_queries(trag.HybridRetriever(trag.MockEmbedder(8), device="cpu"), 2) == [
        "calibration calibration calibration calibration"] * 2


def test_autotune_table_budget_and_inputs(retriever):
    res = ttune.autotune_serving(retriever, k=3, batch_sizes=(1, 2, 4), iters=2)
    assert res.max_batch in (1, 2, 4) and [p.batch_size for p in res.table] == [1, 2, 4]
    assert all(p.p50_ms > 0 and p.qps > 0 for p in res.table)
    assert res.max_wait_ms == pytest.approx(0.3 * next(p for p in res.table if p.batch_size == res.max_batch).p50_ms)
    assert res.as_dict()["max_batch"] == res.max_batch and res.probe_tiles is None and res.rescore is None
    assert ttune.autotune_serving(retriever, k=3, batch_sizes=(1, 2), iters=1, latency_budget_ms=1e-9).max_batch in (
        1, 2)
    with pytest.raises(trag.InvalidConfigError):
        ttune.autotune_serving(retriever, batch_sizes=())
    with pytest.raises(trag.InvalidConfigError):
        ttune.autotune_serving(retriever, batch_sizes=(0,), iters=1)


def test_autotune_probe_sweep_on_clustered_store():
    rng = np.random.default_rng(41)
    n, dim = 4096, 32
    centers = rng.standard_normal((4, dim)).astype(np.float32)
    m = centers[np.repeat(np.arange(4), n // 4)] + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    r = trag.HybridRetriever(trag.MockEmbedder(dimension=dim), device="cpu",
                             vector_config=trag.VectorStoreConfig(dimension=dim, scan_tier="clustered",
                                                                  scan_tile_n=1024, cluster_probe_tiles=2))
    chunks = []
    for i in range(n):
        c = trag.Chunk(document_id="d", content=f"term{i % 37} item {i}", start_offset=0, end_offset=4, id=f"c{i}")
        c.set_embedding(m[i])
        chunks.append(c)
    r.index_batch(chunks)
    qs = ttune.calibration_queries(r, 2)
    before = [[x.chunk.id for x in res] for res in r.retrieve_batch(qs, 3)]
    res = ttune.autotune_serving(r, k=3, batch_sizes=(1, 2), iters=1, probe_tiles=(1, 2, 4))
    assert res.probe_tiles in (1, 2, 4) and [p.probe_tiles for p in res.probe_table] == [1, 2, 4]
    assert r.vector_store.config.cluster_probe_tiles == res.probe_tiles and "probe_table" in res.as_dict()
    assert [[x.chunk.id for x in res] for res in r.retrieve_batch(qs, 3)] == before  # exact at every budget


def test_autotune_rescore_sweep_on_token_store():
    cfg = EncoderConfig.tiny()
    r = LateInteractionRetriever(config=cfg, max_len=8, device="cpu",
                                 store_config=TokenStoreConfig(hidden_dim=cfg.hidden_dim, max_tokens=8,
                                                               scan="tiered"))
    r.index_batch([trag.Chunk(document_id="d", content=f"topic{i % 5} clause {i} of text", start_offset=0,
                              end_offset=5, id=f"c{i}") for i in range(24)])
    res = ttune.autotune_serving(r, k=3, batch_sizes=(1, 2), iters=1, rescore=(4, 8))
    assert res.rescore in (4, 8) and [p.rescore for p in res.rescore_table] == [4, 8]
    assert r.store.config.rescore == res.rescore and "rescore_table" in res.as_dict()
    exact = LateInteractionRetriever(config=cfg, max_len=8, device="cpu")
    exact.index_batch([trag.Chunk(document_id="d", content=f"item {i}", start_offset=0, end_offset=4, id=f"c{i}")
                       for i in range(6)])
    res = ttune.autotune_serving(exact, k=2, batch_sizes=(1,), iters=1)
    assert res.rescore is None and res.rescore_table == []


def test_run_server_auto_wires_tuned_values_and_prewarm(retriever, monkeypatch):
    captured = {}

    class FakeServer:
        server_address = ("127.0.0.1", 1)

        def __init__(self, addr, handler):
            captured["addr"] = addr

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            captured["closed"] = True

    real = tserve.MicroBatcher

    def spy(retr, max_batch, max_wait_ms):
        captured["max_batch"], captured["max_wait_ms"] = max_batch, max_wait_ms
        return real(retr, max_batch=max_batch, max_wait_ms=max_wait_ms)

    calls = []
    monkeypatch.setattr(tserve, "RagHTTPServer", FakeServer)
    monkeypatch.setattr(tserve, "MicroBatcher", spy)
    monkeypatch.setattr(ttune, "autotune_serving",
                        lambda r, k=5, latency_budget_ms=None: ttune.TuneResult(max_batch=4, max_wait_ms=2.5))
    monkeypatch.setattr(retriever, "retrieve_batch", lambda qs, k, **kw: calls.append(len(qs)) or [[]] * len(qs),
                        raising=False)
    tserve.run_server(retriever, port=0, max_batch="auto")
    assert (captured["max_batch"], captured["max_wait_ms"], captured["closed"]) == (4, 2.5, True)
    assert calls == [1, 1, 1, 2, 2, 2, 4, 4, 4]  # prewarm: three batches of each size up to max_batch


def test_stage_timer_and_device_trace(retriever, tmp_path):
    timer = StageTimer(device="cpu")
    for _ in range(2):
        with timer.stage("retrieve"):
            retriever.retrieve_batch(["dense vector search"], 3)
        with timer.stage("embed"):
            retriever.embedder.embed_queries(["dense vector search"])
    with pytest.raises(ValueError):
        with timer.stage("fails"):
            raise ValueError("x")
    tot = timer.totals()
    assert set(tot) == {"retrieve", "embed", "fails"} and all(v >= 0 for v in tot.values())
    rep = timer.report().splitlines()
    assert rep[0].startswith("stage") and [line.split()[0] for line in rep[1:]] == ["retrieve", "embed", "fails"]
    assert [line.split()[2] for line in rep[1:]] == ["2", "2", "1"]
    timer.reset()
    assert timer.totals() == {}
    if not torch.cuda.is_available():  # the default device is the card when there is one
        assert StageTimer().device.type == "cpu"
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir, device="cpu") as prof:
        retriever.retrieve_batch(["hybrid retrieval"], 3)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::topk" or e.get("name", "").startswith("aten::") for e in events)
    assert any(ev.key.startswith("aten::") for ev in prof.key_averages())
