"""Hybrid retrieval as a RAG deployment builds it: ``HybridRetriever`` over
an ``EncoderEmbedder`` and a ``VectorStore`` (``scan_tier`` from the
configuration), the corpus's unit rows loaded with ``VectorStore.load_rows``.

The traffic's ``sources`` say which candidate sources serve it; set-up
builds only what they need. With ``["dense"]`` the retriever runs with
``use_sparse=False`` and no BM25 index is built.
"""

from __future__ import annotations

import torch

from benchmark.harness import inputs
from benchmark.systems.common import chunks_of, encoder_config, row_of


class System:
    """The retriever under test, built from the seed (set-up)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        import trueno_rag_tpu_torch as rag

        if traffic["sources"] != ["dense"]:
            raise ValueError(f"sources {traffic['sources']} are not served by this system")
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        corpus, d = cfg["corpus"], cfg["hidden_size"]
        n = corpus["chunks"]
        with log.stage("weights"):
            self.weights = inputs.encoder_weights(cfg, seed, self.device)
        with log.stage("texts"):
            self.texts = inputs.doc_texts(cfg["word_law"], n, corpus["words"], seed, self.device)
            chunks = chunks_of(self.texts)
        with log.stage("corpus rows"):
            rows = inputs.host_rows(n, (d,), seed, self.device, corpus["row_slab"])
        embedder = rag.EncoderEmbedder(config=encoder_config(cfg), params=self.weights, device=self.device)
        vcfg = rag.VectorStoreConfig(dimension=d, initial_capacity=n, **cfg["vector_store"])
        rcfg = rag.HybridRetrieverConfig(use_sparse=False, candidates_per_source=traffic["candidates"])
        self.retriever = rag.HybridRetriever(embedder, rcfg, vector_config=vcfg, device=self.device)
        with log.stage("load_rows"):
            self.retriever.vector_store.load_rows(chunks, rows)
            del rows, chunks
        with log.stage("device matrix and tier"):
            self.retriever.ensure_ready()
            if self.device.type == "cuda":
                torch.cuda.synchronize()

    def run(self, queries):
        return self.retriever.retrieve_batch(queries, self.traffic["k"])

    def answers(self, results):
        """Results → per query ``[(row, score, text)]``."""
        return [[(row_of(r.chunk.id), r.dense_score, r.chunk.content) for r in res] for res in results]

    def counters(self) -> dict:
        from trueno_rag_tpu_torch.ops.kernels.scan_select import scan_select_v3

        return {"tier_fallback_queries": self.retriever.vector_store.tier_fallback_queries,
                "scan_launches": scan_select_v3.launches}

    def staged(self, queries, span) -> dict:
        """One batch layer by layer, each call inside ``span(name)`` → the
        shapes the work arithmetic needs."""
        retr = self.retriever
        store = retr.vector_store
        with span("encode"):
            qv = retr.embedder.embed_queries(queries)
        with span("scan"):
            store.search_arrays(qv, self.traffic["candidates"])
        ids = retr.embedder.tokenizer.encode_batch(queries)
        tier = store._effective_tier()
        return {"b": len(queries), "n": len(store), "d": self.cfg["hidden_size"],
                "tier_bytes": {"bf16": 2, "int8": 1}.get(tier, 4), "enc_lengths": (ids != 0).sum(axis=1).tolist()}

    def close(self) -> None:
        self.retriever = None
