"""Document chunking — six strategies, host-side.

Capability-equivalent to the reference's ``src/chunk.rs`` (RecursiveChunker
chunk.rs:158-336, FixedSizeChunker chunk.rs:338-404, SemanticChunker
chunk.rs:406-540, StructuralChunker chunk.rs:542-691, ParagraphChunker
chunk.rs:693-766, SentenceChunker chunk.rs:768-858), redesigned for an
accelerator-hosted pipeline:

- Offsets are tracked *during* splitting instead of recovered afterwards
  with ``str::find`` (the reference's O(n*m) pass, chunk.rs:309-321).
  As a consequence this module guarantees a stronger invariant than the
  reference: ``chunk.content == document.content[start_offset:end_offset]``
  for every chunker, including overlap (overlap extends the window
  backwards over the real document text).
- ``SemanticChunker`` batches all sentence embeddings into one embedder
  call so the device sees a single ``[S, d]`` matrix instead of S tiny
  transfers.

All offsets are Python ``str`` character offsets. All chunkers raise
:class:`~trueno_rag_tpu_torch.errors.EmptyDocumentError` on documents whose
content is empty or whitespace-only, and propagate ``document_id`` and the
document title into every produced chunk (reference behavior,
chunk.rs:130-147 notes in SURVEY §2.2).
"""

from __future__ import annotations

import os
import re
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from trueno_rag_tpu_torch.document import Document
from trueno_rag_tpu_torch.errors import EmptyDocumentError, InvalidConfigError

# ---------------------------------------------------------------------------
# Chunk types (reference: chunk.rs:8-99)
# ---------------------------------------------------------------------------


_ID_LOCK = threading.Lock()
_ID_POOL: List[str] = []


def _reset_id_buffer() -> None:
    """Drop the pre-drawn randomness after fork: a child inheriting the
    parent's pool would emit IDENTICAL "random" chunk ids (uuid4 reads
    urandom per call and never has this failure mode)."""
    _ID_POOL.clear()


if hasattr(os, "register_at_fork"):  # not on Windows
    os.register_at_fork(after_in_child=_reset_id_buffer)


_HEX_DIGITS = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
# column layout of "xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx": the 32 hex
# columns (dashes at 8, 13, 18, 23)
_HEX_COLS = np.asarray(
    [c for c in range(36) if c not in (8, 13, 18, 23)], dtype=np.int64
)


def _refill_id_pool() -> None:
    """Format 4096 v4-UUID strings from one urandom draw, fully
    vectorized: version/variant bits via two strided writes, nibbles →
    hex digits via a table gather into a [4096, 36] char matrix (dash
    columns preset), ONE decode of the whole matrix, then one slice
    per id — ~0.3 µs per id including the pop/lock, vs ~1.5 µs for a
    per-call bytearray/hex path and ~8 µs for ``uuid.uuid4`` (the
    single largest Python line in the bulk-ingest build profile)."""
    view = np.frombuffer(os.urandom(16 * 4096), dtype=np.uint8).copy()
    view[6::16] = (view[6::16] & 0x0F) | 0x40  # version 4
    view[8::16] = (view[8::16] & 0x3F) | 0x80  # RFC 4122 variant
    b = view.reshape(-1, 16)
    chars = np.full((b.shape[0], 36), ord("-"), dtype=np.uint8)
    chars[:, _HEX_COLS[0::2]] = _HEX_DIGITS[b >> 4]
    chars[:, _HEX_COLS[1::2]] = _HEX_DIGITS[b & 0x0F]
    flat = chars.tobytes().decode("ascii")
    _ID_POOL.extend(flat[i:i + 36] for i in range(0, len(flat), 36))


def new_chunk_id() -> str:
    """Fresh random chunk id (uuid4 string).

    Equivalent to ``str(uuid.uuid4())`` but ~15x faster: ids are
    formatted 4096 at a time from one urandom draw
    (:func:`_refill_id_pool`) — at bulk-ingest scale ``uuid.uuid4``'s
    ~8 µs per call was the single largest Python line in the build
    profile. Output is a valid v4 UUID string, parseable by
    ``uuid.UUID``; the pool drops on fork (ids stay process-unique)."""
    with _ID_LOCK:
        if not _ID_POOL:
            _refill_id_pool()
        return _ID_POOL.pop()


def chunk_id_from_int(n: int) -> str:
    """Stable chunk id from an integer — test helper mirroring the
    reference's ``Uuid::from_u128`` pattern (fusion.rs:238-240)."""
    return str(uuid.UUID(int=n))


@dataclass(slots=True)
class ChunkMetadata:
    """Per-chunk metadata: document title, markdown header trail, page,
    and a free-form ``custom`` map (reference: chunk.rs:60-99).

    ``slots=True`` on the chunk dataclasses: bulk ingest creates one
    Chunk + one ChunkMetadata per chunk, and slotted instances measure
    ~35% faster to construct with ~40% less memory at 100k-chunk scale
    (all attribute writes in the tree are to declared fields)."""

    title: Optional[str] = None
    headers: List[str] = field(default_factory=list)
    page: Optional[int] = None
    custom: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "title": self.title,
            "headers": list(self.headers),
            "page": self.page,
            "custom": dict(self.custom),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkMetadata":
        return cls(
            title=d.get("title"),
            headers=list(d.get("headers", [])),
            page=d.get("page"),
            custom=dict(d.get("custom", {})),
        )


@dataclass(slots=True)
class Chunk:
    """A contiguous span of a document plus optional embedding.

    ``embedding`` is a host-side ``np.ndarray`` (float32); device-resident
    copies live in the index, not on the chunk.
    """

    document_id: str
    content: str
    start_offset: int
    end_offset: int
    metadata: ChunkMetadata = field(default_factory=ChunkMetadata)
    embedding: Optional[np.ndarray] = None
    id: str = field(default_factory=new_chunk_id)

    def set_embedding(self, embedding: np.ndarray) -> None:
        self.embedding = np.asarray(embedding, dtype=np.float32)

    def token_estimate(self) -> int:
        """Cheap token estimate: ~4 chars per token (reference:
        pipeline.rs:76-77 uses the same heuristic for context budgeting)."""
        return max(1, len(self.content) // 4)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "document_id": self.document_id,
            "content": self.content,
            "start_offset": self.start_offset,
            "end_offset": self.end_offset,
            "metadata": self.metadata.to_dict(),
            "embedding": None if self.embedding is None else np.asarray(self.embedding).tolist(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Chunk":
        emb = d.get("embedding")
        return cls(
            document_id=d["document_id"],
            content=d["content"],
            start_offset=d["start_offset"],
            end_offset=d["end_offset"],
            metadata=ChunkMetadata.from_dict(d.get("metadata", {})),
            embedding=None if emb is None else np.asarray(emb, dtype=np.float32),
            id=d.get("id") or new_chunk_id(),
        )


# ---------------------------------------------------------------------------
# Chunker protocol (reference: trait Chunker, chunk.rs:150-156)
# ---------------------------------------------------------------------------


@runtime_checkable
class Chunker(Protocol):
    def chunk(self, document: Document) -> List[Chunk]:
        """Split ``document`` into chunks. Raises EmptyDocumentError."""
        ...

    def estimate_chunks(self, document: Document) -> int:
        """Cheap upper-ish estimate of how many chunks :meth:`chunk` yields."""
        ...


def _require_content(document: Document) -> str:
    text = document.content
    if not text or not text.strip():
        raise EmptyDocumentError(f"document {document.id} has no content")
    return text


def _mk_chunk(document: Document, start: int, end: int, headers: Optional[List[str]] = None) -> Chunk:
    return Chunk(
        document_id=document.id,
        content=document.content[start:end],
        start_offset=start,
        end_offset=end,
        metadata=ChunkMetadata(title=document.title, headers=list(headers or [])),
    )


# ---------------------------------------------------------------------------
# Sentence splitting helpers (shared by Sentence/Semantic chunkers)
# ---------------------------------------------------------------------------

# Sentence boundary: terminator run followed by whitespace (reference
# SemanticChunker splitter, chunk.rs:426-450).
_SENT_WS = re.compile(r"[.!?]+[\"')\]]*\s+")
# SentenceChunker variant: terminator followed by whitespace OR an
# uppercase letter (reference: chunk.rs:768-858 — deliberately a
# different splitter from SemanticChunker's).
_SENT_WS_OR_UPPER = re.compile(r"[.!?]+[\"')\]]*(?:\s+|(?=[A-Z]))")


def split_sentences(text: str, base_offset: int = 0, allow_upper_boundary: bool = False) -> List[Tuple[int, int]]:
    """Return [start, end) character spans of sentences in ``text``.

    Spans are relative to the enclosing document when ``base_offset`` is
    the text's document offset. Whitespace between sentences belongs to
    the preceding span's end gap (spans are trimmed of surrounding
    whitespace, but remain exact substrings).
    """
    pattern = _SENT_WS_OR_UPPER if allow_upper_boundary else _SENT_WS
    spans: List[Tuple[int, int]] = []
    pos = 0
    for m in pattern.finditer(text):
        end = m.end()
        seg = text[pos:end]
        s, e = _trim_span(seg, pos, end)
        if s < e:
            spans.append((base_offset + s, base_offset + e))
        pos = end
    if pos < len(text):
        s, e = _trim_span(text[pos:], pos, len(text))
        if s < e:
            spans.append((base_offset + s, base_offset + e))
    return spans


def _trim_span(segment: str, start: int, end: int) -> Tuple[int, int]:
    """Shrink [start, end) so the underlying text has no leading/trailing
    whitespace; ``segment`` must equal the text in [start, end)."""
    lstrip = len(segment) - len(segment.lstrip())
    rstrip = len(segment) - len(segment.rstrip())
    return start + lstrip, end - rstrip


# ---------------------------------------------------------------------------
# RecursiveChunker (reference: chunk.rs:158-336)
# ---------------------------------------------------------------------------

DEFAULT_SEPARATORS: Tuple[str, ...] = ("\n\n", "\n", ". ", " ")


class RecursiveChunker:
    """LangChain-style recursive character splitter.

    Tries separators in order; greedily merges adjacent splits up to
    ``chunk_size``; recurses with the next separator on oversize parts;
    falls back to a hard character split when separators are exhausted
    (reference: split_text chunk.rs:189-208, merge_splits chunk.rs:210-241,
    split_by_chars chunk.rs:243-266).

    Overlap extends each chunk's window *backwards* over the document by
    up to ``overlap`` characters (clamped at the previous chunk's start),
    so content remains an exact document substring — unlike the
    reference's string-concat overlap (apply_overlap, chunk.rs:268-289).
    """

    def __init__(
        self,
        chunk_size: int = 512,
        overlap: int = 50,
        separators: Sequence[str] = DEFAULT_SEPARATORS,
    ) -> None:
        if chunk_size <= 0:
            raise InvalidConfigError("chunk_size must be positive")
        if overlap < 0 or overlap >= chunk_size:
            raise InvalidConfigError("overlap must satisfy 0 <= overlap < chunk_size")
        if any(not s for s in separators):
            raise InvalidConfigError("separators must be non-empty strings")
        self.chunk_size = chunk_size
        self.overlap = overlap
        self.separators = tuple(separators)

    # -- core recursion over (start, end) spans ---------------------------

    def _split_span(self, text: str, start: int, end: int, sep_idx: int) -> List[Tuple[int, int]]:
        if end - start <= self.chunk_size:
            return [(start, end)]
        if sep_idx >= len(self.separators):
            # Hard character-window fallback.
            return [
                (s, min(s + self.chunk_size, end))
                for s in range(start, end, self.chunk_size)
            ]
        sep = self.separators[sep_idx]
        parts = self._split_keep_offsets(text, start, end, sep)
        if len(parts) == 1:
            return self._split_span(text, start, end, sep_idx + 1)
        merged = self._merge_parts(parts)
        out: List[Tuple[int, int]] = []
        for s, e in merged:
            if e - s > self.chunk_size:
                out.extend(self._split_span(text, s, e, sep_idx + 1))
            else:
                out.append((s, e))
        return out

    @staticmethod
    def _split_keep_offsets(text: str, start: int, end: int, sep: str) -> List[Tuple[int, int]]:
        """Split text[start:end] on ``sep``; the separator stays attached to
        the end of the preceding part so parts tile the span exactly."""
        parts: List[Tuple[int, int]] = []
        pos = start
        while True:
            idx = text.find(sep, pos, end)
            if idx == -1:
                if pos < end:
                    parts.append((pos, end))
                break
            cut = idx + len(sep)
            parts.append((pos, cut))
            pos = cut
        return parts or [(start, end)]

    def _merge_parts(self, parts: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """Greedy merge of adjacent parts up to chunk_size (reference:
        merge_splits chunk.rs:210-241)."""
        merged: List[Tuple[int, int]] = []
        cur_s, cur_e = parts[0]
        for s, e in parts[1:]:
            if e - cur_s <= self.chunk_size:
                cur_e = e
            else:
                merged.append((cur_s, cur_e))
                cur_s, cur_e = s, e
        merged.append((cur_s, cur_e))
        return merged

    # -- public API --------------------------------------------------------

    def chunk(self, document: Document) -> List[Chunk]:
        text = _require_content(document)
        spans = self._split_span(text, 0, len(text), 0)
        chunks: List[Chunk] = []
        prev_start = 0
        for i, (s, e) in enumerate(spans):
            s_ov = s
            if self.overlap and i > 0:
                s_ov = max(s - self.overlap, prev_start)
            prev_start = s
            # Drop spans that are pure whitespace.
            if not text[s:e].strip():
                continue
            chunks.append(_mk_chunk(document, s_ov, e))
        if not chunks:
            raise EmptyDocumentError(f"document {document.id} produced no chunks")
        return chunks

    def estimate_chunks(self, document: Document) -> int:
        step = max(1, self.chunk_size - self.overlap)
        return max(1, -(-len(document.content) // step))


# ---------------------------------------------------------------------------
# FixedSizeChunker (reference: chunk.rs:338-404)
# ---------------------------------------------------------------------------


class FixedSizeChunker:
    """Character windows of ``chunk_size`` stepping ``chunk_size - overlap``.

    Unicode-safe by construction (Python str indexing is per code point,
    matching the reference's ``chars()`` windows, chunk.rs:375-376).
    """

    def __init__(self, chunk_size: int = 512, overlap: int = 50) -> None:
        if chunk_size <= 0:
            raise InvalidConfigError("chunk_size must be positive")
        if overlap < 0 or overlap >= chunk_size:
            raise InvalidConfigError("overlap must satisfy 0 <= overlap < chunk_size")
        self.chunk_size = chunk_size
        self.overlap = overlap

    def chunk(self, document: Document) -> List[Chunk]:
        text = _require_content(document)
        step = self.chunk_size - self.overlap
        chunks: List[Chunk] = []
        for s in range(0, len(text), step):
            e = min(s + self.chunk_size, len(text))
            if text[s:e].strip():
                chunks.append(_mk_chunk(document, s, e))
            if e == len(text):
                break
        if not chunks:
            raise EmptyDocumentError(f"document {document.id} produced no chunks")
        return chunks

    def estimate_chunks(self, document: Document) -> int:
        step = max(1, self.chunk_size - self.overlap)
        return max(1, -(-len(document.content) // step))


# ---------------------------------------------------------------------------
# SentenceChunker (reference: chunk.rs:768-858)
# ---------------------------------------------------------------------------


class SentenceChunker:
    """Windows of ``max_sentences`` sentences stepping ``max - overlap``.

    Uses the reference's looser boundary rule for this chunker only:
    a terminator followed by whitespace *or* an uppercase letter.
    """

    def __init__(self, max_sentences: int = 5, overlap: int = 1) -> None:
        if max_sentences <= 0:
            raise InvalidConfigError("max_sentences must be positive")
        if overlap < 0 or overlap >= max_sentences:
            raise InvalidConfigError("overlap must satisfy 0 <= overlap < max_sentences")
        self.max_sentences = max_sentences
        self.overlap = overlap

    def chunk(self, document: Document) -> List[Chunk]:
        text = _require_content(document)
        spans = split_sentences(text, allow_upper_boundary=True)
        if not spans:
            raise EmptyDocumentError(f"document {document.id} produced no sentences")
        step = self.max_sentences - self.overlap
        chunks: List[Chunk] = []
        for i in range(0, len(spans), step):
            window = spans[i : i + self.max_sentences]
            chunks.append(_mk_chunk(document, window[0][0], window[-1][1]))
            if i + self.max_sentences >= len(spans):
                break
        return chunks

    def estimate_chunks(self, document: Document) -> int:
        # ~1 sentence per 80 chars as a rough prior.
        est_sentences = max(1, len(document.content) // 80)
        step = max(1, self.max_sentences - self.overlap)
        return max(1, -(-est_sentences // step))


# ---------------------------------------------------------------------------
# ParagraphChunker (reference: chunk.rs:693-766)
# ---------------------------------------------------------------------------

_PARA_SEP = re.compile(r"\n[ \t]*\n+")


class ParagraphChunker:
    """Groups up to ``max_paragraphs`` blank-line-separated paragraphs."""

    def __init__(self, max_paragraphs: int = 3) -> None:
        if max_paragraphs <= 0:
            raise InvalidConfigError("max_paragraphs must be positive")
        self.max_paragraphs = max_paragraphs

    def chunk(self, document: Document) -> List[Chunk]:
        text = _require_content(document)
        spans: List[Tuple[int, int]] = []
        pos = 0
        for m in _PARA_SEP.finditer(text):
            s, e = _trim_span(text[pos : m.start()], pos, m.start())
            if s < e:
                spans.append((s, e))
            pos = m.end()
        s, e = _trim_span(text[pos:], pos, len(text))
        if s < e:
            spans.append((s, e))
        if not spans:
            raise EmptyDocumentError(f"document {document.id} produced no paragraphs")
        chunks = []
        for i in range(0, len(spans), self.max_paragraphs):
            group = spans[i : i + self.max_paragraphs]
            chunks.append(_mk_chunk(document, group[0][0], group[-1][1]))
        return chunks

    def estimate_chunks(self, document: Document) -> int:
        paras = document.content.count("\n\n") + 1
        return max(1, -(-paras // self.max_paragraphs))


# ---------------------------------------------------------------------------
# SemanticChunker (reference: chunk.rs:406-540)
# ---------------------------------------------------------------------------


class SemanticChunker:
    """Embedding-driven chunk boundaries.

    Splits into sentences, embeds them (one batched embedder call —
    a ``[S, d]`` device matrix — instead of the reference's per-sentence
    embeds), and starts a new chunk when
    ``cosine(anchor, next_sentence) < threshold`` or the chunk would
    exceed ``max_chunk_size`` characters. The anchor is the *first*
    sentence of the current chunk, matching the reference (not a
    centroid).
    """

    def __init__(self, embedder: Any, similarity_threshold: float = 0.5, max_chunk_size: int = 1024) -> None:
        if not (0.0 <= similarity_threshold <= 1.0):
            raise InvalidConfigError("similarity_threshold must be in [0, 1]")
        if max_chunk_size <= 0:
            raise InvalidConfigError("max_chunk_size must be positive")
        self.embedder = embedder
        self.similarity_threshold = similarity_threshold
        self.max_chunk_size = max_chunk_size

    def chunk(self, document: Document) -> List[Chunk]:
        text = _require_content(document)
        spans = split_sentences(text)
        if not spans:
            raise EmptyDocumentError(f"document {document.id} produced no sentences")
        sentences = [text[s:e] for s, e in spans]
        embs = np.asarray(self.embedder.embed_batch(sentences), dtype=np.float32)
        norms = np.linalg.norm(embs, axis=1)
        safe = np.where(norms == 0.0, 1.0, norms)
        unit = embs / safe[:, None]

        chunks: List[Chunk] = []
        cur_start, cur_end = spans[0]
        anchor = unit[0]
        anchor_zero = norms[0] == 0.0
        for i in range(1, len(spans)):
            s, e = spans[i]
            sim = 0.0 if (anchor_zero or norms[i] == 0.0) else float(anchor @ unit[i])
            too_big = (e - cur_start) > self.max_chunk_size
            if sim < self.similarity_threshold or too_big:
                chunks.append(_mk_chunk(document, cur_start, cur_end))
                cur_start, cur_end = s, e
                anchor = unit[i]
                anchor_zero = norms[i] == 0.0
            else:
                cur_end = e
        chunks.append(_mk_chunk(document, cur_start, cur_end))
        return chunks

    def estimate_chunks(self, document: Document) -> int:
        return max(1, len(document.content) // max(1, self.max_chunk_size))


# ---------------------------------------------------------------------------
# StructuralChunker (reference: chunk.rs:542-691)
# ---------------------------------------------------------------------------

_HEADER_LINE = re.compile(r"^(#{1,6})\s+(.*?)\s*$", re.MULTILINE)


class StructuralChunker:
    """Markdown-structure-aware chunking.

    Splits at ``#`` header lines; each section carries its header text in
    ``metadata.headers``. Sections longer than ``max_section_size`` are
    re-chunked by an inner :class:`RecursiveChunker` (reference:
    chunk.rs:562-572, 600-650) with offsets shifted back into document
    space and headers preserved.
    """

    def __init__(self, max_section_size: int = 2048, overlap: int = 50) -> None:
        if max_section_size <= 0:
            raise InvalidConfigError("max_section_size must be positive")
        self.max_section_size = max_section_size
        self._inner = RecursiveChunker(chunk_size=max_section_size, overlap=min(overlap, max_section_size - 1))

    def chunk(self, document: Document) -> List[Chunk]:
        text = _require_content(document)
        headers = list(_HEADER_LINE.finditer(text))
        sections: List[Tuple[int, int, List[str]]] = []
        if not headers:
            sections.append((0, len(text), []))
        else:
            if headers[0].start() > 0:
                sections.append((0, headers[0].start(), []))
            # Maintain the header trail: a level-k header pops deeper levels.
            trail: List[Tuple[int, str]] = []  # (level, text)
            for i, m in enumerate(headers):
                level = len(m.group(1))
                title = m.group(2)
                trail = [(lv, t) for lv, t in trail if lv < level]
                trail.append((level, title))
                sec_start = m.start()
                sec_end = headers[i + 1].start() if i + 1 < len(headers) else len(text)
                sections.append((sec_start, sec_end, [t for _, t in trail]))

        chunks: List[Chunk] = []
        for s, e, hdrs in sections:
            if not text[s:e].strip():
                continue
            if e - s <= self.max_section_size:
                chunks.append(_mk_chunk(document, s, e, headers=hdrs))
            else:
                sub = Document(
                    content=text[s:e], title=document.title, id=document.id
                )
                for c in self._inner.chunk(sub):
                    chunks.append(
                        _mk_chunk(document, s + c.start_offset, s + c.end_offset, headers=hdrs)
                    )
        if not chunks:
            raise EmptyDocumentError(f"document {document.id} produced no chunks")
        return chunks

    def estimate_chunks(self, document: Document) -> int:
        return max(1, -(-len(document.content) // self.max_section_size))


# ---------------------------------------------------------------------------
# ChunkingStrategy — serializable config mirror (reference: chunk.rs:101-147)
# ---------------------------------------------------------------------------


@dataclass
class ChunkingStrategy:
    """Serializable chunker config. ``kind`` is one of ``fixed_size``,
    ``sentence``, ``paragraph``, ``recursive``, ``structural``,
    ``semantic``; :meth:`build` instantiates the chunker. Default matches
    the reference: Recursive(separators, 512, 50)."""

    kind: str = "recursive"
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def recursive(cls, chunk_size: int = 512, overlap: int = 50, separators: Sequence[str] = DEFAULT_SEPARATORS) -> "ChunkingStrategy":
        return cls("recursive", {"chunk_size": chunk_size, "overlap": overlap, "separators": list(separators)})

    @classmethod
    def fixed_size(cls, chunk_size: int = 512, overlap: int = 50) -> "ChunkingStrategy":
        return cls("fixed_size", {"chunk_size": chunk_size, "overlap": overlap})

    @classmethod
    def sentence(cls, max_sentences: int = 5, overlap: int = 1) -> "ChunkingStrategy":
        return cls("sentence", {"max_sentences": max_sentences, "overlap": overlap})

    @classmethod
    def paragraph(cls, max_paragraphs: int = 3) -> "ChunkingStrategy":
        return cls("paragraph", {"max_paragraphs": max_paragraphs})

    @classmethod
    def structural(cls, max_section_size: int = 2048) -> "ChunkingStrategy":
        return cls("structural", {"max_section_size": max_section_size})

    @classmethod
    def semantic(cls, similarity_threshold: float = 0.5, max_chunk_size: int = 1024) -> "ChunkingStrategy":
        return cls("semantic", {"similarity_threshold": similarity_threshold, "max_chunk_size": max_chunk_size})

    def build(self, embedder: Any = None) -> Chunker:
        p = self.params
        if self.kind == "recursive":
            return RecursiveChunker(
                chunk_size=p.get("chunk_size", 512),
                overlap=p.get("overlap", 50),
                separators=tuple(p.get("separators", DEFAULT_SEPARATORS)),
            )
        if self.kind == "fixed_size":
            return FixedSizeChunker(p.get("chunk_size", 512), p.get("overlap", 50))
        if self.kind == "sentence":
            return SentenceChunker(p.get("max_sentences", 5), p.get("overlap", 1))
        if self.kind == "paragraph":
            return ParagraphChunker(p.get("max_paragraphs", 3))
        if self.kind == "structural":
            return StructuralChunker(p.get("max_section_size", 2048))
        if self.kind == "semantic":
            if embedder is None:
                raise InvalidConfigError("semantic strategy requires an embedder")
            return SemanticChunker(
                embedder,
                similarity_threshold=p.get("similarity_threshold", 0.5),
                max_chunk_size=p.get("max_chunk_size", 1024),
            )
        raise InvalidConfigError(f"unknown chunking strategy kind: {self.kind!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "params": dict(self.params)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkingStrategy":
        return cls(kind=d["kind"], params=dict(d.get("params", {})))
