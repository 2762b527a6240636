"""Late-interaction (MaxSim) retrieval as the port's CLI builds it:
``LateInteractionRetriever`` over a MiniLM-class encoder and a tiered
``TokenVectorStore``, its corpus token rows loaded with ``load_rows``.

The rows are the benchmark's seeded unit tokens (``assumed`` in the
configuration: they stand for an ingest through the encoder), ``valid``
tokens a chunk, where ``valid`` follows from the chunk text's length.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.systems.common import chunks_of, encoder_config, row_of


class System:
    """The retriever under test, built from the seed (set-up)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        import trueno_rag_tpu_torch as rag

        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        corpus, lt, h = cfg["corpus"], cfg["chunk_tokens"], cfg["hidden_size"]
        n = corpus["chunks"]
        with log.stage("weights"):
            self.weights = inputs.encoder_weights(cfg, seed, self.device)
        with log.stage("texts"):
            self.texts = inputs.doc_texts(cfg["word_law"], n, corpus["words"], seed, self.device)
            chunks = chunks_of(self.texts)
        with log.stage("token rows"):
            rows = inputs.host_rows(n, (lt, h), seed, self.device, corpus["row_slab"])
            t_mask = np.zeros((n, lt), bool)
            t_mask[:, :inputs.chunk_tokens(cfg)] = True
        store_cfg = rag.TokenStoreConfig(hidden_dim=h, max_tokens=lt, initial_capacity=n, **cfg["token_store"])
        self.retriever = rag.LateInteractionRetriever(config=encoder_config(cfg), params=self.weights, max_len=lt,
                                                      store_config=store_cfg, device=self.device)
        with log.stage("load_rows"):
            self.retriever.store.load_rows(chunks, rows, t_mask)
            del rows, chunks
        with log.stage("device replica and tier pack"):
            self.retriever.ensure_ready()
            if self.device.type == "cuda":
                torch.cuda.synchronize()

    def run(self, queries):
        return self.retriever.retrieve_batch(queries, self.traffic["k"])

    def answers(self, results):
        """Results → per query ``[(row, score, text)]``."""
        return [[(row_of(r.chunk.id), r.dense_score, r.chunk.content) for r in res] for res in results]

    def counters(self) -> dict:
        from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import maxsim_scan16_scores, maxsim_scan_int8_scores

        return {"uncertified": self.retriever.store.uncertified,
                "maxsim_launches": maxsim_scan16_scores.launches + maxsim_scan_int8_scores.launches}

    def staged(self, queries, span) -> dict:
        """One batch layer by layer, each call inside ``span(name)`` → the
        shapes the work arithmetic needs."""
        store = self.retriever.store
        with span("encode"):
            q, qm = self.retriever._encode(queries)
        with span("scan"):
            store.search_arrays(q, qm, self.traffic["k"])
        tier = store._device_tier()[0] if store.config.scan == "tiered" else "float32"
        return {"b": len(queries), "q_tokens": int(qm.sum()), "n": len(store), "lt": self.cfg["chunk_tokens"], "h": self.cfg["hidden_size"],
                "tier_bytes": {"bfloat16": 2, "int8": 1}.get(tier, 4), "enc_lengths": qm.sum(axis=1).tolist()}

    def close(self) -> None:
        self.retriever = None

