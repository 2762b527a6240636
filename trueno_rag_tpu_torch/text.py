"""Host-side text tokenization shared by BM25, TF-IDF and lexical rerankers.

Reproduces the reference's BM25 tokenizer semantics exactly (reference:
src/index.rs:111-124): split on non-alphanumeric characters, lowercase,
drop stopwords, drop tokens shorter than 2 characters. The stopword list
mirrors the reference's ~100 hardcoded common-English stopwords
(src/index.rs:93-108).

This is the hot host-side string path for index builds; it is written to
be replaceable by the native C++ tokenizer (``trueno_rag_tpu_torch.native``)
with identical output.
"""

from __future__ import annotations

import re
from typing import FrozenSet, List, Optional

STOPWORDS: FrozenSet[str] = frozenset(
    """
    a about above after again against all am an and any are aren't as at be
    because been before being below between both but by can't cannot could
    couldn't did didn't do does doesn't doing don't down during each few for
    from further had hadn't has hasn't have haven't having he he'd he'll he's
    her here here's hers herself him himself his how how's i i'd i'll i'm
    i've if in into is isn't it it's its itself let's me more most mustn't my
    myself no nor not of off on once only or other ought our ours ourselves
    out over own same shan't she she'd she'll she's should shouldn't so some
    such than that that's the their theirs them themselves then there there's
    these they they'd they'll they're they've this those through to too under
    until up very was wasn't we we'd we'll we're we've were weren't what
    what's when when's where where's which while who who's whom why why's
    with won't would wouldn't you you'd you'll you're you've your yours
    yourself yourselves
    """.split()
)

_NON_ALNUM = re.compile(r"[^0-9A-Za-z]+")


def tokenize(
    text: str,
    stopwords: Optional[FrozenSet[str]] = STOPWORDS,
    min_len: int = 2,
) -> List[str]:
    """BM25-style tokenization (reference: index.rs:111-124).

    Splits on non-alphanumeric runs, lowercases, removes ``stopwords``
    (pass ``None`` to keep them) and tokens shorter than ``min_len``.
    """
    toks = []
    for raw in _NON_ALNUM.split(text):
        if len(raw) < min_len:
            continue
        t = raw.lower()
        if stopwords is not None and t in stopwords:
            continue
        toks.append(t)
    return toks


def tokenize_simple(text: str) -> List[str]:
    """Permissive tokenization for TF-IDF / lexical features: lowercase
    alphanumeric terms with no stopword or length filtering."""
    return [t.lower() for t in _NON_ALNUM.split(text) if t]
