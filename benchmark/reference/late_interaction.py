"""The plain reference of late-interaction retrieval: the encoder's token
states of each query (:mod:`benchmark.reference.encoder`), unit length,
and their MaxSim against every seeded corpus chunk."""

from __future__ import annotations

import torch

from benchmark.harness import inputs
from benchmark.reference import encoder as ref_encoder
from benchmark.reference import scores as ref_scores
from benchmark.reference import tokenizer as ref_tokenizer


def scores(cfg: dict, weights: dict, queries, seed: int, device, precision: str) -> torch.Tensor:
    """The reference's (``precision="bf16"``, scores in float64) or the
    control's (``"fp8"``, float32) MaxSim of ``queries`` against the whole
    corpus → ``[B, N]``."""
    lt, h = cfg["chunk_tokens"], cfg["hidden_size"]
    ids = torch.from_numpy(ref_tokenizer.encode(queries, cfg["vocab_size"], lt)).to(device)
    states, mask = ref_encoder.token_states(weights, ids, cfg, precision)
    b = len(queries)
    dtype = torch.float64 if precision == "bf16" else torch.float32
    q = ref_scores.unit(states[:b].to(dtype))
    return ref_scores.maxsim_all(q, mask[:b], cfg["corpus"]["chunks"], lt, h, inputs.chunk_tokens(cfg), seed,
                                 cfg["corpus"]["row_slab"], dtype)
