"""The hashed word tokenizer, frozen here so the reference imports nothing
of the program: lowercase alphanumeric words, ``id = 3 + blake2b-64(word)
mod (vocab - 3)`` (little-endian digest), ``[CLS] words [SEP]`` cut to
``max_len``, padded with 0 to a multiple of 16 (at most ``max_len``) and
to a power-of-two row count of at least 8."""

from __future__ import annotations

import hashlib
import re

import numpy as np

PAD, CLS, SEP, RESERVED = 0, 1, 2, 3
_WORD = re.compile(r"[^0-9A-Za-z]+")


def words(text: str):
    return [t.lower() for t in _WORD.split(text) if t]


def word_id(word: str, vocab: int) -> int:
    digest = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
    return RESERVED + int.from_bytes(digest, "little") % (vocab - RESERVED)


def encode(texts, vocab: int, max_len: int) -> np.ndarray:
    """``texts`` → ``[rows, T]`` int32 ids, rows a power of two ≥ 8."""
    seqs = [[CLS] + [word_id(w, vocab) for w in words(t)[: max_len - 2]] + [SEP] for t in texts]
    longest = max(len(s) for s in seqs)
    t = min(-(-longest // 16) * 16, max_len)
    rows = 8
    while rows < len(seqs):
        rows *= 2
    out = np.full((rows, t), PAD, np.int32)
    for i, s in enumerate(seqs):
        s = s[:t]
        out[i, : len(s)] = s
    return out
