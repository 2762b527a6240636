"""Dense retrieval with DeepSeek-V2-Lite as the query embedder, as a RAG
deployment builds it: ``HybridRetriever`` over a ``DeepseekV2Embedder`` and
a ``VectorStore`` (``scan_tier`` from the configuration), the corpus's unit
rows loaded with ``VectorStore.load_rows``, ``use_sparse=False`` (no BM25
index is built).

The model's weights are drawn here from the seed, in the port's layout
(:func:`weights`); the plain reference reads the same dict.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.systems.common import chunks_of, row_of
from trueno_rag_tpu_torch.models.deepseek_v2 import (
    DeepseekV2Config, dense_mlp, embed, mla_attention, moe_mlp, pool_last_token, real_token_index, yarn_inv_freq,
)
from trueno_rag_tpu_torch.models.encoder import pad_batch_pow2

# what the port implements of DeepSeek-V2's options; another value is refused
SUPPORTED = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy", "norm_topk_prob": False,
             "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "hidden_act": "silu", "attention_bias": False}


def model_config(cfg: dict) -> DeepseekV2Config:
    """The port's configuration from DeepSeek-V2's ``config.json`` keys."""
    for key, want in SUPPORTED.items():
        if cfg.get(key, want) != want:
            raise ValueError(f"{key}={cfg[key]!r} is not supported (the port implements {want!r})")
    rs = cfg["rope_scaling"]
    if rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs.get('type')!r} is not supported (the port implements yarn)")
    return DeepseekV2Config(
        vocab_size=cfg["vocab_size"], hidden_dim=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        first_k_dense=cfg["first_k_dense_replace"], num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"], mlp_dim=cfg["intermediate_size"],
        expert_dim=cfg["moe_intermediate_size"], n_routed_experts=cfg["n_routed_experts"],
        experts_per_token=cfg["num_experts_per_tok"], n_shared_experts=cfg["n_shared_experts"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]), rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), rope_factor=float(rs["factor"]),
        rope_original_max=rs["original_max_position_embeddings"], rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]), rope_mscale=rs["mscale"], rope_mscale_all_dim=rs["mscale_all_dim"],
        max_len=cfg["tokenizer_max_len"])


def weights(cfg: dict, seed: int, device) -> dict:
    """Seeded weights in the port's layout (``init_deepseek_v2_params``'s
    keys): matrices ``[in, out]`` and the token table N(0, 0.02²), drawn in
    f32 and rounded to bf16 once, one tensor a draw; norm scales ``1 +
    N(0, 0.02²)`` in f32; the routed experts stacked ``[E, …]``."""
    c = model_config(cfg)
    h, nh, e, m = c.hidden_dim, c.num_heads, c.n_routed_experts, c.expert_dim
    gen = inputs.generator(seed, inputs.STREAM_WEIGHTS, device)

    def mat(*shape):
        return torch.randn(shape, generator=gen, device=device).mul_(0.02).to(torch.bfloat16)

    def scale(n):
        return torch.randn(n, generator=gen, device=device).mul_(0.02).add_(1.0)

    layers = []
    for i in range(c.num_layers):
        lp = {"attn_norm": scale(h), "q_w": mat(h, nh * c.qk_head_dim),
              "kv_a_w": mat(h, c.kv_lora_rank + c.qk_rope_head_dim), "kv_a_norm": scale(c.kv_lora_rank),
              "kv_b_w": mat(c.kv_lora_rank, nh * (c.qk_nope_head_dim + c.v_head_dim)),
              "o_w": mat(nh * c.v_head_dim, h), "mlp_norm": scale(h)}
        if i < c.first_k_dense:
            lp.update(gate_w=mat(h, c.mlp_dim), up_w=mat(h, c.mlp_dim), down_w=mat(c.mlp_dim, h))
        else:
            lp.update(router_w=mat(h, e), experts_w13=mat(e, h, 2 * m), experts_w2=mat(e, m, h),
                      gate_w=mat(h, c.shared_dim), up_w=mat(h, c.shared_dim), down_w=mat(c.shared_dim, h))
        layers.append(lp)
    return {"tok_emb": mat(c.vocab_size, h), "layers": layers, "final_norm": scale(h)}


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
            self.weights = weights(cfg, seed, self.device)
        with log.stage("texts"):
            self.texts = inputs.doc_texts(cfg["word_law"], n, corpus["words"], seed, self.device)
            chunks = chunks_of(self.texts)
        with log.stage("corpus rows"):
            rows = inputs.host_rows(n, (d,), seed, self.device, corpus["row_slab"])
        embedder = rag.DeepseekV2Embedder(model_config(cfg), params=self.weights, device=self.device,
                                          embedding_config=rag.EmbeddingConfig(query_prefix=cfg["query_prefix"]))
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

        emb = self.retriever.embedder
        return {"tier_fallback_queries": self.retriever.vector_store.tier_fallback_queries,
                "scan_launches": scan_select_v3.launches, "expert_tokens": emb.expert_tokens.tolist(),
                "routed_tokens": int(emb.routed_tokens)}

    def staged(self, queries, span) -> dict:
        """One batch layer by layer, as the embedder's forward composes the
        model's functions, each call inside ``span(name)``: ``attention``
        and ``mlp`` or ``moe`` per layer, then ``scan`` → the shapes the
        work arithmetic needs (real lengths, each MoE layer's tokens per
        expert, the scan's)."""
        retr = self.retriever
        emb, store = retr.embedder, retr.vector_store
        c, params = emb.model_config, emb.params
        ids_np = pad_batch_pow2(emb.tokenizer.encode_batch([emb.config.query_prefix + q for q in queries]))
        n_real = int(np.count_nonzero(ids_np))
        ids = torch.from_numpy(ids_np).to(self.device)
        counts = torch.zeros(c.num_layers - c.first_k_dense, c.n_routed_experts, dtype=torch.int64,
                             device=self.device)
        mask = ids != 0
        real, inv_freq = real_token_index(mask, n_real), yarn_inv_freq(c, self.device)
        x = embed(params, ids)
        for i, lp in enumerate(params["layers"]):
            with span("attention"):
                x = mla_attention(x, mask, lp, c, inv_freq)
            if i < c.first_k_dense:
                with span("mlp"):
                    x = dense_mlp(x, lp, c)
            else:
                with span("moe"):
                    x = moe_mlp(x, lp, c, real, counts[i - c.first_k_dense])
        qv = pool_last_token(x, mask, params["final_norm"], c)[: len(queries)].cpu().numpy()
        with span("scan"):
            store.search_arrays(qv, self.traffic["candidates"])
        tier = store._effective_tier()
        return {"b": len(queries), "n": len(store), "d": self.cfg["hidden_size"],
                "tier_bytes": {"bf16": 2, "int8": 1}.get(tier, 4),
                "lengths": np.count_nonzero(ids_np, axis=1)[: len(queries)].tolist(),
                "expert_tokens": counts.tolist()}

    def close(self) -> None:
        self.retriever = None
