"""Neural cross-encoder reranker: joint (query, passage) scoring on the card.

PyTorch counterpart of ``trueno_rag_tpu/models/cross_encoder.py``. Query
and passage concatenate as ``[CLS] query [SEP] passage [SEP]``, run
through the encoder trunk (:mod:`trueno_rag_tpu_torch.models.encoder`,
always with its learned position table), and a scalar head on the CLS
state — optionally after a BERT pooler (dense + tanh) — yields the
relevance logit; scores are its sigmoid. All (query, candidate) pairs
score in one batched forward. The head runs in f32 on the f32 CLS state,
as in the JAX package, so its weights stay f32.

Implements the ``Reranker`` protocol.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.models.encoder import (
    PAD_ID,
    SEP_ID,
    EncoderConfig,
    HashTokenizer,
    _normal,
    _pool,
    _round_up,
    encoder_trunk,
    init_encoder_params,
    pad_batch_pow2,
)
from trueno_rag_tpu_torch.retrieve import RetrievalResult


def init_cross_encoder_params(config: EncoderConfig, generator: torch.Generator,
                              device=None) -> Dict[str, Any]:
    """The encoder's parameters plus the f32 scalar head ``score_w [H, 1]``,
    ``score_b [1]``."""
    params = init_encoder_params(config, generator, device)
    device = params["tok_emb"].device
    params["score_w"] = _normal((config.hidden_dim, 1), generator, device)
    params["score_b"] = torch.zeros(1, dtype=torch.float32, device=device)
    return params


@torch.no_grad()
def cross_encoder_scores(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """``[B, T]`` pair token ids → ``[B]`` relevance scores (sigmoid logits)."""
    x, mask = encoder_trunk(params, token_ids, config, position="learned")
    cls = _pool(x, mask, "cls")  # [B, H] f32
    if "pooler_w" in params:  # HF BERT pooler (dense + tanh) before the head
        cls = torch.tanh(cls @ params["pooler_w"] + params["pooler_b"])
    logits = cls @ params["score_w"] + params["score_b"]
    return torch.sigmoid(logits[:, 0])


class CrossEncoderReranker:
    """Neural second-stage reranker (Reranker protocol): scores all
    candidates against the query in one device batch on ``device``
    (default: the card; raises without one) and returns results ordered
    (score desc, chunk id asc)."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        max_len: int = 256,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or EncoderConfig.tiny()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_cross_encoder_params(self.config, gen, self.device)
        self.params = params
        self.max_len = min(max_len, self.config.max_len)
        self.tokenizer = HashTokenizer(self.config.vocab_size, self.max_len)

    def _encode_pairs(self, query: str, contents: Sequence[str]) -> np.ndarray:
        q_ids = self.tokenizer.encode(query)[:-1]  # keep CLS, drop SEP; re-added below
        rows = []
        for content in contents:
            c_ids = self.tokenizer.encode(content)[1:]  # drop CLS, keep ... SEP
            rows.append((q_ids + [SEP_ID] + c_ids)[: self.max_len])
        longest = max(len(r) for r in rows)
        t = min(_round_up(longest, 16), self.max_len)
        out = np.full((len(rows), t), PAD_ID, dtype=np.int32)
        for i, r in enumerate(rows):
            r = r[:t]
            out[i, : len(r)] = r
        return out

    def score_batch(self, query: str, contents: Sequence[str]) -> np.ndarray:
        if not contents:
            return np.zeros((0,), dtype=np.float32)
        ids = torch.from_numpy(pad_batch_pow2(self._encode_pairs(query, contents))).to(self.device)
        return cross_encoder_scores(self.params, ids, self.config)[: len(contents)].cpu().numpy()

    def rerank(self, query: str, candidates: Sequence[RetrievalResult], top_k: int) -> List[RetrievalResult]:
        scores = self.score_batch(query, [r.chunk.content for r in candidates])
        rescored = [
            RetrievalResult(
                chunk=r.chunk,
                dense_score=r.dense_score,
                sparse_score=r.sparse_score,
                fused_score=r.fused_score,
                rerank_score=float(s),
            )
            for r, s in zip(candidates, scores)
        ]
        rescored.sort(key=lambda r: (-(r.rerank_score or 0.0), r.chunk.id))
        return rescored[:top_k]
