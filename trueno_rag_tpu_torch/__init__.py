"""trueno_rag_tpu_torch — the PyTorch + CUDA port of ``trueno_rag_tpu``.

The hybrid RAG query path of the JAX package, for one NVIDIA H100:
chunking, embedders (hash, TF-IDF and the neural models of
:mod:`~trueno_rag_tpu_torch.models`: the MiniLM/BGE-class encoder, the
4096-d Nemotron-class embedder, the cross-encoder reranker and the
late-interaction (MaxSim) reranker and retriever over a multi-vector
token store, and the SPLADE-class learned-sparse encoder), a
device-resident dense store (exact fp32; the certified
bf16 and int8 tile tiers; the compact and clustered tiers, which keep no
fp32 matrix on the card), tag filters, BM25 over the block table and,
past 2**24 rows, over the packed segment layout, learned-sparse postings
(the tri-hybrid's third source), on-device rank fusion,
the encoder-fused query path, query preprocessing, ingest dedup,
reranking and context assembly with citations, IR metrics, index
artifacts and model checkpoints that load in either package
(:mod:`~trueno_rag_tpu_torch.persist`), the micro-batched HTTP server
with its autotuner (:mod:`~trueno_rag_tpu_torch.serve`,
:mod:`~trueno_rag_tpu_torch.tune`), stage timing and device traces
(:mod:`~trueno_rag_tpu_torch.utils`) and the CLI
(``python -m trueno_rag_tpu_torch.cli``). The tile scans, the long-context attention, the MaxSim scans
and the BM25 segment fetch are the hand-written CUDA kernels in
``csrc/``. The JAX package stays the reference; this package imports
``torch`` and never ``jax``.
"""

from trueno_rag_tpu_torch.errors import (
    ChunkTooLargeError,
    DimensionMismatchError,
    EmbeddingError,
    EmptyDocumentError,
    IndexNotFoundError,
    InvalidConfigError,
    QueryError,
    RagError,
    SerializationError,
    VectorStoreError,
)
from trueno_rag_tpu_torch.document import Document, new_document_id
from trueno_rag_tpu_torch.chunking import (
    Chunk,
    ChunkMetadata,
    Chunker,
    ChunkingStrategy,
    FixedSizeChunker,
    ParagraphChunker,
    RecursiveChunker,
    SemanticChunker,
    SentenceChunker,
    StructuralChunker,
    chunk_id_from_int,
    new_chunk_id,
)
from trueno_rag_tpu_torch.embed import (
    Embedder,
    EmbeddingConfig,
    MockEmbedder,
    PoolingStrategy,
    TfIdfEmbedder,
    cosine_similarity,
    dot_product,
    euclidean_distance,
)
from trueno_rag_tpu_torch.fusion import FusionStrategy
from trueno_rag_tpu_torch.index import (
    BM25Index,
    ChunkRegistry,
    DistanceMetric,
    SparseIndex,
    TokenStoreConfig,
    TokenVectorStore,
    VectorStore,
    VectorStoreConfig,
)
from trueno_rag_tpu_torch.metrics import AggregatedMetrics, RetrievalMetrics
from trueno_rag_tpu_torch.pipeline import (
    AssembledContext,
    AssemblyStrategy,
    Citation,
    ContextAssembler,
    ContextAssemblerConfig,
    ContextChunk,
    RagPipeline,
    RagPipelineBuilder,
    RagPipelineConfig,
    pipeline_builder,
)
from trueno_rag_tpu_torch.rerank import (
    CompositeReranker,
    LexicalReranker,
    MMRReranker,
    MockCrossEncoderReranker,
    NoOpReranker,
    Reranker,
)
from trueno_rag_tpu_torch.retrieve import (
    DenseRetriever,
    HybridRetriever,
    HybridRetrieverConfig,
    RetrievalResult,
    SparseRetriever,
    TagFilter,
)
from trueno_rag_tpu_torch.preprocess import (
    ChainedPreprocessor,
    HydePreprocessor,
    KeywordExpander,
    MultiQueryPreprocessor,
    PassthroughPreprocessor,
    QueryAnalysis,
    QueryAnalyzer,
    QueryIntent,
    SynonymExpander,
)
from trueno_rag_tpu_torch.preprocess_adaptive import AdaptivePreprocessor
from trueno_rag_tpu_torch.models import (
    CrossEncoderReranker,
    EncoderConfig,
    EncoderEmbedder,
    LateInteractionReranker,
    LateInteractionRetriever,
    NemotronConfig,
    NemotronEmbedder,
)

__version__ = "0.1.0"

__all__ = [
    "RagError",
    "EmptyDocumentError",
    "ChunkTooLargeError",
    "DimensionMismatchError",
    "IndexNotFoundError",
    "VectorStoreError",
    "SerializationError",
    "InvalidConfigError",
    "QueryError",
    "EmbeddingError",
    "Document",
    "new_document_id",
    "Chunk",
    "ChunkMetadata",
    "Chunker",
    "ChunkingStrategy",
    "RecursiveChunker",
    "FixedSizeChunker",
    "SemanticChunker",
    "StructuralChunker",
    "ParagraphChunker",
    "SentenceChunker",
    "new_chunk_id",
    "chunk_id_from_int",
    "Embedder",
    "EmbeddingConfig",
    "PoolingStrategy",
    "MockEmbedder",
    "TfIdfEmbedder",
    "cosine_similarity",
    "dot_product",
    "euclidean_distance",
    "BM25Index",
    "ChunkRegistry",
    "DistanceMetric",
    "SparseIndex",
    "VectorStore",
    "VectorStoreConfig",
    "TokenStoreConfig",
    "TokenVectorStore",
    "FusionStrategy",
    "DenseRetriever",
    "HybridRetriever",
    "HybridRetrieverConfig",
    "RetrievalResult",
    "TagFilter",
    "SparseRetriever",
    "CompositeReranker",
    "LexicalReranker",
    "MMRReranker",
    "MockCrossEncoderReranker",
    "NoOpReranker",
    "Reranker",
    "CrossEncoderReranker",
    "EncoderConfig",
    "EncoderEmbedder",
    "LateInteractionReranker",
    "LateInteractionRetriever",
    "NemotronConfig",
    "NemotronEmbedder",
    "AssembledContext",
    "AssemblyStrategy",
    "Citation",
    "ContextAssembler",
    "ContextAssemblerConfig",
    "ContextChunk",
    "RagPipeline",
    "RagPipelineBuilder",
    "RagPipelineConfig",
    "pipeline_builder",
    "RetrievalMetrics",
    "AggregatedMetrics",
    "AdaptivePreprocessor",
    "ChainedPreprocessor",
    "HydePreprocessor",
    "KeywordExpander",
    "MultiQueryPreprocessor",
    "PassthroughPreprocessor",
    "QueryAnalysis",
    "QueryAnalyzer",
    "QueryIntent",
    "SynonymExpander",
    "__version__",
]
