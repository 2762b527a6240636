"""Training-pair generation for contrastive encoder fine-tuning.

PyTorch-port counterpart of ``trueno_rag_tpu/train/data.py``: unsupervised
pairs built from the corpus itself, with the same ``random.Random`` draws,
so one seed gives the same pairs and batches in both packages.

- **Inverse Cloze Task (ICT)**: a sentence of a chunk is the pseudo-query,
  the rest of the chunk the positive passage.
- **Span cropping**: two random word windows of the same chunk form a
  positive pair (SimCSE-style augmentation).

:class:`PairBatcher` tokenizes pairs into fixed-shape ``(query_ids,
doc_ids)`` numpy batches for :func:`~trueno_rag_tpu_torch.train.contrastive.train_step`.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from trueno_rag_tpu_torch.chunking import Chunk, split_sentences
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.text import tokenize_simple


def ict_pairs(chunks: Sequence[Chunk], rng: random.Random) -> Iterator[Tuple[str, str]]:
    """Inverse Cloze Task pairs: (sentence, chunk without the sentence),
    drawn from the chunks with >= 2 sentences; raises up front when none
    has them."""
    eligible = [c for c in chunks if len(split_sentences(c.content)) >= 2]
    if not eligible:
        raise InvalidConfigError(
            "ICT pairs need at least one chunk with >= 2 sentences "
            "(a sentence must be held out as the pseudo-query); use "
            "longer chunks or pair_kind='crop'"
        )
    while True:
        chunk = rng.choice(eligible)
        spans = split_sentences(chunk.content)
        s, e = spans[rng.randrange(len(spans))]
        query = chunk.content[s:e]
        passage = (chunk.content[:s] + chunk.content[e:]).strip()
        if query.strip() and passage:
            yield query, passage


def crop_pairs(chunks: Sequence[Chunk], rng: random.Random, min_words: int = 4) -> Iterator[Tuple[str, str]]:
    """Span-crop pairs: two random word windows of the same chunk, drawn
    from the chunks of >= ``2 * min_words`` words; raises when none is that
    long."""
    eligible = [(c, tokenize_simple(c.content)) for c in chunks
                if len(tokenize_simple(c.content)) >= 2 * min_words]
    if not eligible:
        raise InvalidConfigError(
            f"crop pairs need at least one chunk with >= {2 * min_words} "
            "words; use longer chunks or a smaller min_words"
        )
    while True:
        _, words = rng.choice(eligible)

        def window():
            w = rng.randint(min_words, max(min_words, len(words) // 2))
            start = rng.randrange(0, len(words) - w + 1)
            return " ".join(words[start:start + w])

        yield window(), window()


class PairBatcher:
    """Turns a pair stream into fixed-shape token batches: both sides padded
    (or cut) to one width, at least 16 and at most ``max_len``."""

    def __init__(self, tokenizer, batch_size: int = 32, max_len: int = 64) -> None:
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_len = max_len

    def batches(self, pair_stream: Iterator[Tuple[str, str]]) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            qs: List[str] = []
            ds: List[str] = []
            for _ in range(self.batch_size):
                q, d = next(pair_stream)
                qs.append(q)
                ds.append(d)
            q_ids = self.tokenizer.encode_batch(qs)
            d_ids = self.tokenizer.encode_batch(ds)
            t = min(max(q_ids.shape[1], d_ids.shape[1], 16), self.max_len)

            def pad(a):
                if a.shape[1] < t:
                    a = np.pad(a, ((0, 0), (0, t - a.shape[1])))
                return a[:, :t]

            yield pad(q_ids), pad(d_ids)
