"""Document model.

Equivalent capability to the reference's ``Document``/``DocumentId``
(reference: src/lib.rs:115-180): a UUID-identified document carrying
content, optional title/source and a free-form metadata map, with a
builder-flavored construction API.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def new_document_id() -> str:
    """Fresh random document id (uuid4 string)."""
    return str(uuid.uuid4())


@dataclass
class Document:
    """A source document to be chunked, embedded and indexed.

    ``Document("text")`` mirrors ``Document::new``;
    :meth:`with_title` / :meth:`with_source` / :meth:`with_metadata`
    mirror the reference's builder methods and return ``self`` so they
    chain.
    """

    content: str
    title: Optional[str] = None
    source: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    id: str = field(default_factory=new_document_id)

    def with_title(self, title: str) -> "Document":
        self.title = title
        return self

    def with_source(self, source: str) -> "Document":
        self.source = source
        return self

    def with_metadata(self, key: str, value: Any) -> "Document":
        self.metadata[key] = value
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "content": self.content,
            "title": self.title,
            "source": self.source,
            "metadata": dict(self.metadata),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Document":
        return cls(
            content=d["content"],
            title=d.get("title"),
            source=d.get("source"),
            metadata=dict(d.get("metadata", {})),
            id=d.get("id") or new_document_id(),
        )
