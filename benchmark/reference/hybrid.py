"""The plain reference of dense retrieval: the encoder's mean-pooled unit
embedding of each query (:mod:`benchmark.reference.encoder`) and its
cosine with every seeded corpus row."""

from __future__ import annotations

import torch

from benchmark.reference import encoder as ref_encoder
from benchmark.reference import scores as ref_scores
from benchmark.reference import tokenizer as ref_tokenizer


def scores(cfg: dict, weights: dict, queries, seed: int, device, precision: str) -> torch.Tensor:
    """The reference's (``precision="bf16"``, scores in float64) or the
    control's (``"fp8"``, float32) cosine of ``queries`` with the whole
    corpus → ``[B, N]``."""
    ids = torch.from_numpy(ref_tokenizer.encode(queries, cfg["vocab_size"], cfg["max_position_embeddings"]))
    states, mask = ref_encoder.token_states(weights, ids.to(device), cfg, precision)
    b = len(queries)
    dtype = torch.float64 if precision == "bf16" else torch.float32
    if precision == "bf16":
        q = ref_encoder.mean_pooled(states[:b], mask[:b])
    else:
        m = mask[:b].float()[..., None]
        q = ref_scores.unit((states[:b] * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0))
    return ref_scores.cosine_all(q, cfg["corpus"]["chunks"], cfg["hidden_size"], seed, cfg["corpus"]["row_slab"],
                                 dtype)
