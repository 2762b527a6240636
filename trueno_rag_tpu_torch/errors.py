"""Error taxonomy for trueno_rag_tpu_torch.

Mirrors the reference's 11-variant ``Error`` enum (reference:
src/error.rs:9-64) as a Python exception hierarchy rooted at
:class:`RagError`. Code that can fail raises one of these; nothing in the
library raises bare ``ValueError``/``RuntimeError`` for domain failures.
"""

from __future__ import annotations


class RagError(Exception):
    """Base class for every trueno_rag_tpu_torch domain error."""


class EmptyDocumentError(RagError):
    """A chunker was given a document with no usable content."""

    def __init__(self, message: str = "document is empty") -> None:
        super().__init__(message)


class ChunkTooLargeError(RagError):
    """A produced chunk exceeded a configured hard size limit."""

    def __init__(self, size: int, limit: int) -> None:
        super().__init__(f"chunk of size {size} exceeds limit {limit}")
        self.size = size
        self.limit = limit


class DimensionMismatchError(RagError):
    """An embedding's dimension does not match the index/store dimension.

    Carries ``expected`` and ``actual`` like the reference's
    ``DimensionMismatch {expected, actual}`` (src/error.rs).
    """

    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(f"dimension mismatch: expected {expected}, got {actual}")
        self.expected = expected
        self.actual = actual


class IndexNotFoundError(RagError):
    """A named index / persisted index path does not exist."""


class VectorStoreError(RagError):
    """Vector store invariant violation (e.g. inserting a chunk without an embedding)."""


class SerializationError(RagError):
    """Index/artifact (de)serialization failure."""


class InvalidConfigError(RagError):
    """A configuration object is internally inconsistent."""


class QueryError(RagError):
    """A query could not be executed (e.g. empty query string)."""


class EmbeddingError(RagError):
    """An embedder failed (untrained TF-IDF, missing model weights, ...)."""
