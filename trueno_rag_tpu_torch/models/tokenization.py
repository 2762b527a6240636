"""WordPiece tokenization for BERT-family checkpoints, on the host.

Counterpart of ``trueno_rag_tpu/models/tokenization.py``: minimal,
dependency-free WordPiece (greedy longest-match with ``##``
continuations) so locally-available MiniLM/BGE checkpoints run with
their real vocabularies. Same interface as
:class:`~trueno_rag_tpu_torch.models.encoder.HashTokenizer` (``encode`` /
``encode_batch``), so it drops into :class:`EncoderEmbedder`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def basic_tokenize(text: str) -> List[str]:
    """BERT basic tokenization: lowercase, strip accents-ish, split on
    whitespace and punctuation (punctuation becomes its own token)."""
    out: List[str] = []
    word: List[str] = []
    for ch in text.lower():
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif not ch.isalnum():
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Dict[str, int],
        max_len: int = 256,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        max_chars_per_word: int = 100,
    ) -> None:
        self.vocab = vocab
        self.max_len = max_len
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, max_len: int = 256) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, max_len=max_len)

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for word in basic_tokenize(text):
            ids.extend(self._wordpiece(word))
            if len(ids) >= self.max_len - 1:
                break
        ids = ids[: self.max_len - 1]
        ids.append(self.sep_id)
        return ids

    def encode_batch(self, texts: Sequence[str], pad_multiple: int = 16) -> np.ndarray:
        encoded = [self.encode(t) for t in texts]
        longest = max((len(e) for e in encoded), default=2)
        t = min(-(-longest // pad_multiple) * pad_multiple, self.max_len)
        out = np.full((len(texts), t), self.pad_id, dtype=np.int32)
        for i, e in enumerate(encoded):
            e = e[:t]
            out[i, : len(e)] = e
        return out
