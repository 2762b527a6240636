"""Embedders — pluggable text → vector backends.

Capability-equivalent to the reference's ``src/embed.rs``: the
``Embedder`` interface with query/document asymmetry (embed.rs:54-89),
``EmbeddingConfig``/``PoolingStrategy`` (embed.rs:8-51), the deterministic
``MockEmbedder`` test workhorse (embed.rs:91-197), the trainable
``TfIdfEmbedder`` (embed.rs:199-308) and the free similarity functions
(embed.rs:310-342).

Neural encoders (:mod:`trueno_rag_tpu_torch.models`) subclass
:class:`Embedder` so the whole pipeline is backend-agnostic.

All embedders return host ``np.ndarray`` float32; device-resident
matrices are owned by the indexes (``trueno_rag_tpu_torch.index``).
"""

from __future__ import annotations

import enum
import hashlib
import math
from collections import Counter
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence

import numpy as np

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.errors import EmbeddingError, InvalidConfigError
from trueno_rag_tpu_torch.text import tokenize_simple

# ---------------------------------------------------------------------------
# Config (reference: embed.rs:8-51)
# ---------------------------------------------------------------------------


class PoolingStrategy(str, enum.Enum):
    CLS = "cls"
    MEAN = "mean"
    WEIGHTED_MEAN = "weighted_mean"
    LAST_TOKEN = "last_token"


@dataclass
class EmbeddingConfig:
    """Shared embedder knobs: L2 normalization, asymmetric prefixes for
    retrieval (query vs document), truncation length and pooling."""

    normalize: bool = True
    query_prefix: str = ""
    document_prefix: str = ""
    max_length: int = 512
    pooling: PoolingStrategy = PoolingStrategy.MEAN

    def with_query_prefix(self, p: str) -> "EmbeddingConfig":
        return replace(self, query_prefix=p)

    def with_document_prefix(self, p: str) -> "EmbeddingConfig":
        return replace(self, document_prefix=p)


# ---------------------------------------------------------------------------
# Embedder base (reference: trait Embedder, embed.rs:54-89)
# ---------------------------------------------------------------------------


class Embedder:
    """Base embedder. Subclasses implement :meth:`embed` (and usually a
    batched :meth:`embed_batch`); defaults mirror the reference's trait
    default methods: ``embed_query``/``embed_document`` apply the
    configured prefixes, ``embed_chunks`` batch-embeds chunk contents and
    writes each embedding back onto the chunk."""

    config: EmbeddingConfig

    def __init__(self, config: Optional[EmbeddingConfig] = None) -> None:
        self.config = config or EmbeddingConfig()

    # -- required ----------------------------------------------------------

    @property
    def dimension(self) -> int:
        raise NotImplementedError

    @property
    def model_id(self) -> str:
        raise NotImplementedError

    def embed(self, text: str) -> np.ndarray:
        raise NotImplementedError

    # -- defaults ------------------------------------------------------------

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self.dimension), dtype=np.float32)
        return np.stack([self.embed(t) for t in texts]).astype(np.float32)

    def embed_query(self, query: str) -> np.ndarray:
        return self.embed(self.config.query_prefix + query)

    def embed_document(self, text: str) -> np.ndarray:
        return self.embed(self.config.document_prefix + text)

    def embed_queries(self, queries: Sequence[str]) -> np.ndarray:
        return self.embed_batch([self.config.query_prefix + q for q in queries])

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        return self.embed_batch([self.config.document_prefix + t for t in texts])

    def embed_chunks(self, chunks: Sequence[Chunk]) -> None:
        """Batch-embed chunk contents and set each chunk's embedding
        in place (reference: embed.rs:79-88)."""
        if not chunks:
            return
        embs = self.embed_documents([c.content for c in chunks])
        for chunk, emb in zip(chunks, embs):
            chunk.set_embedding(emb)

    # -- helpers -------------------------------------------------------------

    def _maybe_normalize(self, v: np.ndarray) -> np.ndarray:
        if not self.config.normalize:
            return v.astype(np.float32)
        return l2_normalize(v)


def l2_normalize(v: np.ndarray) -> np.ndarray:
    # norm in float64: for denormal-magnitude vectors (norm ~1e-22) the
    # f32 norm+divide loses enough precision that the result's norm
    # lands visibly off 1.0 (hypothesis-found: [0, 4e-22] -> 0.9986)
    v = np.asarray(v, dtype=np.float32)
    n = np.linalg.norm(v.astype(np.float64), axis=-1, keepdims=True)
    return (v / np.where(n == 0.0, 1.0, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# MockEmbedder (reference: embed.rs:91-197)
# ---------------------------------------------------------------------------


class MockEmbedder(Embedder):
    """Deterministic hash-derived embeddings in [-1, 1] — the universal
    test/demo backend (reference: hash_to_vector, embed.rs:124-145).

    The reference derives component ``i`` from a progressive
    ``DefaultHasher`` over ``(text, i)``; we derive the whole vector from
    a single BLAKE2b digest of the text used to seed a PCG64 stream,
    which is equally deterministic (stable across processes and
    platforms, unlike Rust's ``DefaultHasher``) and vectorizes the
    per-text work. Respects prefixes and normalization.
    """

    def __init__(self, dimension: int = 384, config: Optional[EmbeddingConfig] = None) -> None:
        super().__init__(config)
        if dimension <= 0:
            raise InvalidConfigError("dimension must be positive")
        self._dimension = dimension

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def model_id(self) -> str:
        return f"mock-{self._dimension}"

    def _raw(self, text: str) -> np.ndarray:
        digest = hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest()
        seed = int.from_bytes(digest, "little")
        rng = np.random.Generator(np.random.PCG64(seed))
        return (rng.random(self._dimension, dtype=np.float64) * 2.0 - 1.0).astype(np.float32)

    def embed(self, text: str) -> np.ndarray:
        return self._maybe_normalize(self._raw(text))

    def embed_batch(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            return np.zeros((0, self._dimension), dtype=np.float32)
        out = np.stack([self._raw(t) for t in texts])
        return self._maybe_normalize(out) if self.config.normalize else out


# ---------------------------------------------------------------------------
# TfIdfEmbedder (reference: embed.rs:199-308)
# ---------------------------------------------------------------------------


class TfIdfEmbedder(Embedder):
    """Trainable sparse-ish embedder: ``fit`` builds a vocabulary of the
    top-``dimension`` terms by document frequency with smoothed idf
    ``ln(N / df) + 1`` (reference: embed.rs:219-254); ``embed`` produces an
    L2-normalized tf·idf vector (embed.rs:271-295). Raises
    :class:`EmbeddingError` when used before :meth:`fit`.
    """

    def __init__(self, dimension: int = 128, config: Optional[EmbeddingConfig] = None) -> None:
        super().__init__(config)
        if dimension <= 0:
            raise InvalidConfigError("dimension must be positive")
        self._dimension = dimension
        self.vocab: Dict[str, int] = {}
        self.idf: Optional[np.ndarray] = None

    @property
    def dimension(self) -> int:
        return self._dimension

    @property
    def model_id(self) -> str:
        return f"tfidf-{self._dimension}"

    @property
    def is_fitted(self) -> bool:
        return self.idf is not None

    def fit(self, corpus: Sequence[str]) -> "TfIdfEmbedder":
        if not corpus:
            raise EmbeddingError("cannot fit TfIdfEmbedder on an empty corpus")
        df: Counter = Counter()
        for text in corpus:
            df.update(set(tokenize_simple(text)))
        # Top-`dimension` terms by DF; ties broken alphabetically so the
        # fit is fully deterministic over a given corpus (the CLI's
        # re-fit-on-load pattern depends on this; reference main.rs:468-477).
        terms = sorted(df.items(), key=lambda kv: (-kv[1], kv[0]))[: self._dimension]
        self.vocab = {t: i for i, (t, _) in enumerate(terms)}
        n = float(len(corpus))
        idf = np.zeros(self._dimension, dtype=np.float32)
        for t, i in self.vocab.items():
            idf[i] = math.log(n / float(df[t])) + 1.0
        self.idf = idf
        return self

    def embed(self, text: str) -> np.ndarray:
        if self.idf is None:
            raise EmbeddingError("TfIdfEmbedder used before fit()")
        vec = np.zeros(self._dimension, dtype=np.float32)
        for tok, count in Counter(tokenize_simple(text)).items():
            i = self.vocab.get(tok)
            if i is not None:
                vec[i] = float(count) * self.idf[i]
        return l2_normalize(vec)  # reference always L2-normalizes tf·idf

    # -- persistence hooks ------------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        return {
            "dimension": self._dimension,
            "vocab": dict(self.vocab),
            "idf": None if self.idf is None else self.idf.tolist(),
            # the EmbeddingConfig is part of the fitted state: prefixes
            # fold their tokens into the indexed vectors, so dropping
            # them on reload puts query vectors in a different token
            # space than the stored matrix (silently wrong retrieval)
            "config": {
                "normalize": self.config.normalize,
                "query_prefix": self.config.query_prefix,
                "document_prefix": self.config.document_prefix,
                "max_length": self.config.max_length,
                "pooling": self.config.pooling.value,
            },
        }

    @classmethod
    def from_state_dict(cls, d: Dict[str, object]) -> "TfIdfEmbedder":
        cfg = None
        cd = d.get("config")  # absent in pre-round-2 artifacts
        if cd:
            cfg = EmbeddingConfig(
                normalize=bool(cd["normalize"]),
                query_prefix=str(cd["query_prefix"]),
                document_prefix=str(cd["document_prefix"]),
                max_length=int(cd["max_length"]),
                pooling=PoolingStrategy(cd["pooling"]),
            )
        emb = cls(dimension=int(d["dimension"]), config=cfg)
        emb.vocab = dict(d["vocab"])  # type: ignore[arg-type]
        idf = d.get("idf")
        emb.idf = None if idf is None else np.asarray(idf, dtype=np.float32)
        return emb


# ---------------------------------------------------------------------------
# Similarity functions (reference: embed.rs:310-342)
# ---------------------------------------------------------------------------


def cosine_similarity(a: Sequence[float], b: Sequence[float]) -> float:
    """Cosine similarity; returns 0.0 on length mismatch or zero norm,
    matching the reference's lenient contract."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return 0.0
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(a @ b / (na * nb))


def dot_product(a: Sequence[float], b: Sequence[float]) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return 0.0
    return float(a @ b)


def euclidean_distance(a: Sequence[float], b: Sequence[float]) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape:
        return float("inf")
    return float(np.linalg.norm(a - b))
