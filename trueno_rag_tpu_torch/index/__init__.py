"""Indexes: device-resident dense vector store, the multi-vector token
store of late interaction, block-table BM25 and the learned-sparse
posting index,
bridged by a shared :class:`ChunkRegistry` that assigns dense int32 row
ids so the dense and sparse candidate lists fuse on device without id
translation."""

from trueno_rag_tpu_torch.index.base import ChunkRegistry, SparseIndex
from trueno_rag_tpu_torch.index.bm25 import BM25Index
from trueno_rag_tpu_torch.index.learned_sparse import LearnedSparseIndex
from trueno_rag_tpu_torch.index.token_store import TokenStoreConfig, TokenVectorStore
from trueno_rag_tpu_torch.index.vector_store import DistanceMetric, VectorStore, VectorStoreConfig

__all__ = [
    "ChunkRegistry",
    "SparseIndex",
    "BM25Index",
    "LearnedSparseIndex",
    "VectorStore",
    "VectorStoreConfig",
    "DistanceMetric",
    "TokenStoreConfig",
    "TokenVectorStore",
]
