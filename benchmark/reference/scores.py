"""Plain scoring of queries against the whole corpus, in float64 (the
reference) or float32 (the control, TF32 off).

The corpus rows come from the benchmark's seeded generator, drawn again
slab by slab (:func:`benchmark.harness.inputs.unit_rows`), never from the
program's store.
"""

from __future__ import annotations

import torch

from benchmark.harness import inputs
from benchmark.reference.encoder import tf32


def unit(x: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` scaled to unit length (zero rows stay zero)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


@torch.no_grad()
def maxsim_all(q_tok, q_mask, n: int, lt: int, h: int, valid: int, seed: int, slab: int, dtype=torch.float64):
    """MaxSim of each query (``q_tok [B, Lq, H]``, unit tokens; ``q_mask``)
    against every seeded chunk of ``lt`` unit tokens, of which the first
    ``valid`` are the chunk's → ``[B, n]`` in ``dtype``: per query token
    the best dot over the chunk's tokens, summed over the query's unmasked
    tokens."""
    b, lq, _ = q_tok.shape
    q = q_tok.to(dtype).reshape(b * lq, h)
    keep = q_mask.reshape(b * lq).to(dtype)
    out = torch.empty((b, n), dtype=dtype, device=q_tok.device)
    with tf32(False):
        for lo, tok in inputs.unit_rows(n, (lt, h), seed, q_tok.device, slab):
            m = tok.shape[0]
            tok = tok[:, :valid].to(dtype).reshape(m * valid, h)
            best = (tok @ q.T).reshape(m, valid, b * lq).amax(dim=1)
            out[:, lo:lo + m] = (best * keep).reshape(m, b, lq).sum(dim=2).T
    return out


@torch.no_grad()
def cosine_all(q, n: int, d: int, seed: int, slab: int, dtype=torch.float64):
    """Cosine of each query ``[B, d]`` with every seeded unit row → ``[B, n]``."""
    qd = unit(q.to(dtype))
    out = torch.empty((q.shape[0], n), dtype=dtype, device=q.device)
    with tf32(False):
        for lo, rows in inputs.unit_rows(n, (d,), seed, q.device, slab):
            out[:, lo:lo + rows.shape[0]] = qd @ rows.to(dtype).T
    return out


def top_k(scores: torch.Tensor, k: int):
    """(scores desc, rows) of the best ``k`` per query; ties go to the lower
    row (a stable sort of the negated scores)."""
    s, idx = torch.sort(-scores, dim=1, stable=True)
    return -s[:, :k], idx[:, :k]
