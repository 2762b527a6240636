"""Late-interaction (ColBERT-style MaxSim) reranking and retrieval.

PyTorch counterpart of ``trueno_rag_tpu/models/late_interaction.py``.
Query and documents are encoded SEPARATELY into per-token vectors by the
shared encoder trunk (:mod:`trueno_rag_tpu_torch.models.encoder`) and
scored

    MaxSim(q, d) = Σ_{i ∈ q tokens} max_{j ∈ d tokens} ⟨q_i, d_j⟩

with L2-normalized tokens (cosine MaxSim), padding doc tokens masked to
-inf before the max and padding query tokens contributing zero.

- :class:`LateInteractionReranker` (the ``Reranker`` protocol) scores a
  query's candidates in one batched forward.
- :class:`LateInteractionRetriever` indexes documents into a
  :class:`~trueno_rag_tpu_torch.index.token_store.TokenVectorStore` and
  answers with its exact, token-pruned or tiered scan (on the card the
  tiered scan runs the CUDA kernels K6/K7).

Seeded weights come from a ``torch.Generator`` on the model's device, as
:class:`~trueno_rag_tpu_torch.models.encoder.EncoderEmbedder` draws them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import (
    EncoderConfig,
    HashTokenizer,
    encoder_token_states,
    init_encoder_params,
    pad_batch_pow2,
)
from trueno_rag_tpu_torch.ops.dense import require_fp32
from trueno_rag_tpu_torch.retrieve import RetrievalResult

NEG_INF = float("-inf")


def _l2_tokens(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0.0, torch.ones_like(n), n)


def maxsim(
    q_tok: torch.Tensor,  # [Tq, H] f32 (normalized)
    q_mask: torch.Tensor,  # [Tq] bool
    d_tok: torch.Tensor,  # [K, Td, H] f32 (normalized)
    d_mask: torch.Tensor,  # [K, Td] bool
) -> torch.Tensor:
    """→ ``[K]`` f32 MaxSim scores of one query against K candidates (one
    f32 product, TF32 off as everywhere in the port); an all-padding
    candidate scores 0."""
    sim = torch.einsum("qh,kth->kqt", q_tok, d_tok)
    sim = sim.masked_fill(~d_mask[:, None, :], NEG_INF)
    best = sim.amax(dim=2)  # [K, Tq]
    best = torch.where(q_mask[None, :] & torch.isfinite(best), best, 0.0)
    return best.sum(dim=1)


def maxsim_oracle(q_tok, q_mask, d_tok, d_mask) -> np.ndarray:
    """Scalar NumPy oracle for :func:`maxsim` (parity tests)."""
    q_tok, d_tok = np.asarray(q_tok, np.float32), np.asarray(d_tok, np.float32)
    q_mask, d_mask = np.asarray(q_mask, bool), np.asarray(d_mask, bool)
    out = np.zeros((d_tok.shape[0],), np.float32)
    for k in range(d_tok.shape[0]):
        total = 0.0
        for i in range(q_tok.shape[0]):
            if not q_mask[i]:
                continue
            best = NEG_INF
            for j in range(d_tok.shape[1]):
                if not d_mask[k, j]:
                    continue
                best = max(best, float(q_tok[i] @ d_tok[k, j]))
            if best != NEG_INF:
                total += best
        out[k] = total
    return out


@torch.no_grad()
def late_interaction_scores(
    params: Dict[str, Any],
    q_ids: torch.Tensor,  # [1, Tq] int32
    d_ids: torch.Tensor,  # [K, Td] int32
    config: EncoderConfig,
) -> torch.Tensor:
    """Encode the query and the candidates through the shared trunk,
    normalize the tokens, MaxSim → ``[K]`` scores."""
    require_fp32()
    q_tok, q_mask = encoder_token_states(params, q_ids, config)
    d_tok, d_mask = encoder_token_states(params, d_ids, config)
    return maxsim(_l2_tokens(q_tok[0]), q_mask[0], _l2_tokens(d_tok), d_mask)


def _init_params(config: EncoderConfig, params, seed: int, device: torch.device):
    if params is not None:
        return params
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_encoder_params(config, gen, device)


class LateInteractionReranker:
    """Reranker-protocol wrapper around MaxSim scoring on ``device``
    (default: the card; raises without one). Shares weights with a
    bi-encoder when ``params`` is passed; otherwise draws its own."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        max_len: int = 128,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or EncoderConfig.tiny()
        self.params = _init_params(self.config, params, seed, self.device)
        self.max_len = min(max_len, self.config.max_len)
        self.tokenizer = HashTokenizer(self.config.vocab_size, self.max_len)

    def score_batch(self, query: str, contents: Sequence[str]) -> np.ndarray:
        if not contents:
            return np.zeros((0,), dtype=np.float32)
        q_ids = torch.from_numpy(self.tokenizer.encode_batch([query])).to(self.device)
        d_ids = torch.from_numpy(pad_batch_pow2(self.tokenizer.encode_batch(contents))).to(self.device)
        scores = late_interaction_scores(self.params, q_ids, d_ids, self.config)
        return scores[: len(contents)].cpu().numpy()

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


class LateInteractionRetriever:
    """Corpus-scale MaxSim retrieval (ColBERT-class) on ``device``
    (default: the card; raises without one).

    The shared encoder trunk produces per-token vectors for both sides;
    documents index into a
    :class:`~trueno_rag_tpu_torch.index.token_store.TokenVectorStore`, and
    queries run its exact, token-pruned or tiered scan
    (``TokenStoreConfig.scan``). Results are ``RetrievalResult`` with the
    MaxSim score in ``dense_score``. Token L2-normalization happens inside
    the store (insert and query)."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        max_len: int = 32,
        store_config=None,
        registry=None,
        device=None,
    ) -> None:
        from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig, TokenVectorStore

        self.device = resolve_device(device)
        self.config = config or EncoderConfig.tiny()
        self.params = _init_params(self.config, params, seed, self.device)
        self.max_len = min(max_len, self.config.max_len)
        self.tokenizer = HashTokenizer(self.config.vocab_size, self.max_len)
        sc = store_config or TokenStoreConfig(hidden_dim=self.config.hidden_dim, max_tokens=self.max_len)
        if sc.hidden_dim != self.config.hidden_dim:
            raise InvalidConfigError(
                f"store hidden_dim {sc.hidden_dim} != encoder hidden_dim {self.config.hidden_dim}"
            )
        self.store = TokenVectorStore(sc, registry=registry, device=self.device)

    @property
    def registry(self):
        """The chunk registry (the store owns it)."""
        return self.store.registry

    def _encode(self, texts: Sequence[str]):
        """texts → ``(tokens [B, T, H] f32, mask [B, T] bool)`` numpy; the
        batch is padded to a power of two (the JAX package's buckets)."""
        ids = torch.from_numpy(pad_batch_pow2(self.tokenizer.encode_batch(texts))).to(self.device)
        tok, mask = encoder_token_states(self.params, ids, self.config)
        n = len(texts)
        return tok[:n].cpu().numpy(), mask[:n].cpu().numpy()

    def index(self, chunk: Chunk) -> None:
        tok, mask = self._encode([chunk.content])
        self.store.insert(chunk, tok[0], mask[0])

    def index_batch(self, chunks: Sequence[Chunk], encode_batch: int = 128) -> None:
        for lo in range(0, len(chunks), encode_batch):
            batch = chunks[lo:lo + encode_batch]
            tok, mask = self._encode([c.content for c in batch])
            self.store.insert_many(batch, list(tok), list(mask))

    def retrieve(self, query: str, k: int, tag_filter=None) -> List[RetrievalResult]:
        return self.retrieve_batch([query], k, tag_filter=None if tag_filter is None else [tag_filter])[0]

    def retrieve_batch(self, queries: Sequence[str], k: int, tag_filter=None) -> List[List[RetrievalResult]]:
        """Batched MaxSim retrieval. ``tag_filter`` (one TagFilter or a
        per-query list) resolves on the host to an allowed-row mask that
        joins the tombstone mask before the scan, so every scan searches
        the FILTERED corpus exactly; queries sharing a filter search
        together."""
        if not queries or len(self.store) == 0 or k <= 0:
            return [[] for _ in queries]
        q_tok, q_mask = self._encode(list(queries))
        b = len(queries)
        out: List[List[RetrievalResult]] = [[] for _ in range(b)]
        if tag_filter is None:
            groups = [(None, list(range(b)))]
        else:
            from trueno_rag_tpu_torch.retrieve import resolve_tag_filters

            t_all, t_any, t_none = resolve_tag_filters(self.store.registry, tag_filter, b)
            by_words: Dict[tuple, List[int]] = {}
            for i in range(b):
                by_words.setdefault((int(t_all[i]), int(t_any[i]), int(t_none[i])), []).append(i)
            bits = self.store.registry.tag_bits_array(self.store._host.shape[0])
            groups = []
            for (wa, wy, wn), idxs in by_words.items():
                if wa == 0 and wy == 0 and wn == 0:
                    groups.append((None, idxs))
                    continue
                allowed = ((bits & wa) == wa) & ((wy == 0) | ((bits & wy) != 0)) & ((bits & wn) == 0)
                groups.append((allowed, idxs))
        for allowed, idxs in groups:
            scores, rows = self.store.search_arrays(q_tok[idxs], q_mask[idxs], k, allowed_rows=allowed)
            for j, i in enumerate(idxs):
                out[i] = [RetrievalResult(chunk=self.store.get(cid), dense_score=s)
                          for cid, s in self.store._hydrate(scores[j], rows[j])]
        return out

    def ensure_ready(self) -> None:
        """Build the device replica (and the tier pack, when one is
        configured) before the first query."""
        self.store._device()
        if self.store.config.scan == "tiered":
            self.store._device_tier()

    def __len__(self) -> int:
        return len(self.store)
