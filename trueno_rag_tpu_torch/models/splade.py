"""Learned sparse retrieval (SPLADE-class): a vocabulary expansion model
whose sparse activations score through the block-gather posting path.

PyTorch counterpart of ``trueno_rag_tpu/models/splade.py``. The encoder
expands each text into a sparse vector over the vocabulary,

    w(x)[v] = max_i  mask_i · log(1 + relu(z_iv)),     z = MLM head

(SPLADE-max), and scoring is the weighted sparse dot
``score(q, d) = Σ_v w(q)[v] · w(d)[v]`` over the top-T terms of each side
(:func:`~trueno_rag_tpu_torch.ops.bm25.weighted_topk_blocks`):

- the trunk is the encoder's (:func:`encoder_token_states`, bf16 products
  at the default ``compute_dtype``); the head runs in f32 with TF32 off:
  a dense transform with exact GELU, a layer norm, the vocabulary
  projection TIED to ``tok_emb`` plus a per-vocabulary bias;
- reserved ids (PAD/CLS/SEP, the tokenizer's first ``_RESERVED`` slots)
  are zeroed, so padding never becomes a scoring term; activations are
  >= 0, which the candidate tail's segment sums rely on;
- top-T sparsification orders (weight desc, term asc), as ``lax.top_k``.

Seeded weights come from a ``torch.Generator`` on the model's device;
``convert.splade_params_from_jax`` carries the JAX package's across (in
f32, so :meth:`SpladeEncoder.params_fingerprint` gives the JAX digest).
The SPLADE training losses are in ``train/`` (:func:`splade_head_grad`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.models.encoder import (
    _RESERVED,
    EncoderConfig,
    HashTokenizer,
    _layer_norm,
    _normal,
    encoder_token_states,
    init_encoder_params,
    pad_batch_pow2,
)
from trueno_rag_tpu_torch.ops.dense import require_fp32, topk_desc
from trueno_rag_tpu_torch.retrieve import RetrievalResult, resolve_tag_filters

_EXPAND_BYTES = 1 << 31  # f32 vocabulary logits one expansion forward may hold


def init_splade_params(config: EncoderConfig, generator: torch.Generator, device=None,
                       matrix_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Trunk parameters (:func:`init_encoder_params`, its matrices in
    ``matrix_dtype``) + the MLM-style expansion head: a dense ``[H, H]``
    transform (N(0, 0.02²)), its layer norm and a per-vocabulary bias, all
    f32. The vocabulary projection is tied to ``tok_emb``."""
    device = torch.device(device) if device is not None else generator.device
    h = config.hidden_dim
    params = init_encoder_params(config, generator, device, matrix_dtype)
    params.update({
        "splade_tr_w": _normal((h, h), generator, device),
        "splade_tr_b": torch.zeros(h, device=device),
        "splade_ln_scale": torch.ones(h, device=device),
        "splade_ln_bias": torch.zeros(h, device=device),
        "splade_vocab_bias": torch.zeros(config.vocab_size, device=device),
    })
    return params


def splade_head_grad(params: Dict[str, Any], states: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Token states ``[B, T, H]`` + mask ``[B, T]`` → sparse vocabulary
    activations ``[B, V]`` f32: transform (+exact GELU) + LN, tied
    projection to vocabulary logits, ``max_t log1p(relu(z))`` over valid
    tokens, reserved ids zeroed. All f32, TF32 off. Differentiable (the
    SPLADE training losses); without grad the ``[B, T, V]`` logits are
    transformed in place."""
    require_fp32()
    x = states.float()
    x = F.gelu(x @ params["splade_tr_w"].float() + params["splade_tr_b"].float(), approximate="none")
    x = _layer_norm(x, params["splade_ln_scale"], params["splade_ln_bias"])
    logits = torch.matmul(x, params["tok_emb"].float().t())  # [B, T, V]
    if torch.is_grad_enabled():
        act = torch.log1p(torch.relu(logits + params["splade_vocab_bias"].float()))
        act = act.masked_fill(~mask[:, :, None], 0.0)
    else:
        logits += params["splade_vocab_bias"].float()
        act = torch.log1p_(torch.relu_(logits))
        act.masked_fill_(~mask[:, :, None], 0.0)
    out = act.amax(dim=1)  # SPLADE-max pooling (activations >= 0)
    keep = torch.arange(out.shape[1], device=out.device) >= _RESERVED
    return torch.where(keep, out, 0.0)


@torch.no_grad()
def splade_head(params: Dict[str, Any], states: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`splade_head_grad` without grad: the inference activations."""
    return splade_head_grad(params, states, mask)


@torch.no_grad()
def splade_activations(params: Dict[str, Any], token_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """ids ``[B, T]`` → sparse vocabulary activations ``[B, V]`` f32 (the
    encoder trunk, then :func:`splade_head`)."""
    states, mask = encoder_token_states(params, token_ids, config)
    return splade_head(params, states, mask)


def splade_head_oracle(params: Dict[str, Any], states, mask) -> np.ndarray:
    """Float64 numpy oracle of :func:`splade_head` (exact erf GELU)."""
    from scipy.special import erf

    def host(name):
        return np.asarray(torch.as_tensor(params[name]).detach().double().cpu().numpy())

    x = np.asarray(states, np.float64) @ host("splade_tr_w") + host("splade_tr_b")
    x = 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    x = (x - mean) / np.sqrt(var + 1e-12) * host("splade_ln_scale") + host("splade_ln_bias")
    act = np.log1p(np.maximum(x @ host("tok_emb").T + host("splade_vocab_bias"), 0.0))
    act = np.where(np.asarray(mask, bool)[:, :, None], act, 0.0).max(axis=1)
    act[:, :_RESERVED] = 0.0
    return act.astype(np.float32)


def splade_topt(acts: torch.Tensor, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparsify activations ``[B, V]`` → ``(terms [B, t] int32, weights
    [B, t] f32)``, ordered (weight desc, term asc); empty slots (weight 0,
    or past V) are term ``-1``, weight ``0``."""
    t_eff = min(t, acts.shape[1])
    w, terms = topk_desc(acts, t_eff)
    live = w > 0.0
    terms = torch.where(live, terms, -1).to(torch.int32)
    w = torch.where(live, w, 0.0)
    if t_eff < t:
        terms = F.pad(terms, (0, t - t_eff), value=-1)
        w = F.pad(w, (0, t - t_eff))
    return terms, w


class SpladeEncoder:
    """Texts → top-T (term, weight) expansions on ``device`` (default: the
    card; raises without one). ``doc_top``/``query_top`` bound the
    expansion widths (documents keep more terms than queries)."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        max_len: int = 64,
        doc_top: int = 128,
        query_top: int = 32,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.config = config or EncoderConfig.tiny()
        # artifact identity only; with params passed in the fingerprint is it
        self.seed = seed if params is None else None
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_splade_params(self.config, gen, self.device)
        if "splade_vocab_bias" not in params:
            raise InvalidConfigError("params lack the SPLADE head (init_splade_params)")
        self.params = params
        self.max_len = min(max_len, self.config.max_len)
        self.doc_top = min(doc_top, self.config.vocab_size)
        self.query_top = min(query_top, self.config.vocab_size)
        self.tokenizer = HashTokenizer(self.config.vocab_size, self.max_len)

    def params_fingerprint(self) -> str:
        """16-hex blake2b digest of the weights in the JAX package's layout
        (``convert.params_to_jax``: names sorted, numpy shapes, f32 bytes),
        so both packages give one digest for the same weights. Index
        artifacts store it beside the learned postings; a load refuses a
        query encoder whose digest differs."""
        import hashlib

        from trueno_rag_tpu_torch.convert import params_to_jax

        flat = params_to_jax(self.params)
        h = hashlib.blake2b(digest_size=8)
        for name in sorted(flat):
            arr = np.asarray(flat[name])
            h.update(name.encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr, np.float32).tobytes())
        return h.hexdigest()

    def _expand(self, texts: Sequence[str], top: int):
        """One forward per slice of texts (a power of two of rows, each
        slice's f32 logits within ``_EXPAND_BYTES``; rows are independent)
        → numpy ``(terms [n, top] int32, weights [n, top] f32)``."""
        ids = self.tokenizer.encode_batch(texts)
        per_row = 4 * ids.shape[1] * self.config.vocab_size
        rows = 1 << max(0, (max(1, _EXPAND_BYTES // per_row)).bit_length() - 1)
        terms, weights = [], []
        for lo in range(0, len(texts), rows):
            part = ids[lo:lo + rows]
            acts = splade_activations(self.params, torch.from_numpy(pad_batch_pow2(part)).to(self.device),
                                      self.config)
            t, w = splade_topt(acts[: len(part)], top)
            terms.append(t.cpu().numpy())
            weights.append(w.cpu().numpy())
        return np.concatenate(terms), np.concatenate(weights)

    def expand_documents(self, texts: Sequence[str]):
        """→ ``(terms [N, doc_top] int32, weights [N, doc_top] f32)``."""
        return self._expand(texts, self.doc_top)

    def expand_queries(self, texts: Sequence[str]):
        """→ ``(terms [B, query_top] int32, weights [B, query_top] f32)``."""
        return self._expand(texts, self.query_top)


class SpladeRetriever:
    """Learned-sparse retrieval end to end: the expansion model + the
    posting index (:class:`~trueno_rag_tpu_torch.index.learned_sparse.LearnedSparseIndex`)
    on ``device``. Results carry the score in ``sparse_score``."""

    def __init__(
        self,
        config: Optional[EncoderConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        max_len: int = 64,
        doc_top: int = 128,
        query_top: int = 32,
        registry=None,
        device=None,
    ) -> None:
        from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex

        self.encoder = SpladeEncoder(config=config, params=params, seed=seed, max_len=max_len,
                                     doc_top=doc_top, query_top=query_top, device=device)
        self.device = self.encoder.device
        self.index_store = LearnedSparseIndex(registry=registry, device=self.device)

    @property
    def params(self):
        return self.encoder.params

    @property
    def registry(self):
        return self.index_store.registry

    def index(self, chunk: Chunk) -> None:
        self.index_batch([chunk])

    def index_batch(self, chunks: Sequence[Chunk], encode_batch: int = 128) -> None:
        for lo in range(0, len(chunks), encode_batch):
            batch = chunks[lo:lo + encode_batch]
            terms, w = self.encoder.expand_documents([c.content for c in batch])
            self.index_store.add_batch(batch, terms, w)

    def remove(self, chunk_id: str) -> bool:
        return self.index_store.remove(chunk_id)

    def retrieve(self, query: str, k: int, tag_filter=None) -> List[RetrievalResult]:
        return self.retrieve_batch([query], k, tag_filter=None if tag_filter is None else [tag_filter])[0]

    def retrieve_batch(self, queries: Sequence[str], k: int, tag_filter=None) -> List[List[RetrievalResult]]:
        """Batched learned-sparse retrieval. ``tag_filter`` (one TagFilter or
        a per-query list) resolves to an allowed-row mask that rides the
        scoring op, so the filtered top-k is exact."""
        if not queries or len(self.index_store) == 0 or k <= 0:
            return [[] for _ in queries]
        q_terms, q_w = self.encoder.expand_queries(list(queries))
        allowed = None
        if tag_filter is not None:
            masks = resolve_tag_filters(self.registry, tag_filter, len(queries))
            allowed = allowed_rows(self.registry, masks, self.index_store.capacity_rows)
        scores, rows = (x.cpu().numpy() for x in self.index_store.search_arrays(q_terms, q_w, k,
                                                                              allowed_rows=allowed))
        out: List[List[RetrievalResult]] = []
        for i in range(len(queries)):
            hits: List[RetrievalResult] = []
            for s, r in zip(scores[i], rows[i]):
                cid = self.registry.id_of(int(r)) if r >= 0 else None
                if cid is not None:
                    hits.append(RetrievalResult(chunk=self.registry.get_chunk(cid), sparse_score=float(s)))
            out.append(hits)
        return out

    def ensure_ready(self) -> None:
        self.index_store.ensure_ready()

    def __len__(self) -> int:
        return len(self.index_store)


def allowed_rows(registry, masks, capacity: int) -> np.ndarray:
    """Resolved filter words ``(t_all, t_any, t_none)`` (one per query) →
    the ``[B, capacity]`` allowed-row mask of the learned scoring op."""
    t_all, t_any, t_none = masks
    bits = registry.tag_bits_array(capacity)
    return np.stack([
        ((bits & t_all[i]) == t_all[i]) & ((t_any[i] == 0) | ((bits & t_any[i]) != 0)) & ((bits & t_none[i]) == 0)
        for i in range(len(t_all))
    ])
