"""Near-duplicate detection for ingest: two products on the device
instead of pairwise host loops.

PyTorch counterpart of ``trueno_rag_tpu/ops/dedup.py`` (plain XLA
matmuls there, no Pallas kernel; ``torch.matmul`` in fp32 here, TF32
off). Corpora scraped at scale carry near-identical chunks (mirrored
pages, boilerplate, re-crawls); duplicates waste index memory and crowd
result lists. Detection:

- **within the incoming batch**: ``sim = E·Eᵀ``; a chunk duplicates an
  EARLIER batch entry when similarity ≥ threshold (strictly lower
  triangle, so the first occurrence always survives and chains collapse
  onto their earliest member);
- **against the existing corpus**: ``E·Mᵀ`` masked by the valid rows,
  max and argmax per incoming chunk.

One ``[M, N+M]`` score pass per ingest batch, never on the query path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.device import resolve_device

NEG_INF = float("-inf")


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x / torch.where(norms == 0.0, 1.0, norms)


def near_duplicates(
    embeddings,  # [M, d] f32 (rows need not be normalized)
    matrix,  # [N, d] corpus (N may be 0)
    valid_mask,  # [N] bool
    threshold: float = 0.97,
    rows_normalized: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ ``(is_dup [M] bool, dup_of [M] int32, score [M] f32)`` on the
    device of the tensor inputs (or ``device``; default the card).

    ``dup_of`` is the corpus ROW of the duplicate, or ``-(j+2)`` when the
    duplicate is batch entry j (-1 = not a duplicate). Similarity is
    cosine whatever the store's metric: incoming embeddings normalize
    here; pass ``rows_normalized=False`` when the corpus rows are raw."""
    from trueno_rag_tpu_torch.ops.dense import require_fp32

    require_fp32()
    tensors = [x for x in (matrix, embeddings) if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else resolve_device(device)
    e = _unit_rows(torch.as_tensor(np.asarray(embeddings) if not isinstance(embeddings, torch.Tensor)
                                   else embeddings, dtype=torch.float32, device=dev))
    m = e.shape[0]
    mat = torch.as_tensor(matrix, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid_mask, dtype=torch.bool, device=dev)

    if mat.shape[0] > 0:  # vs the existing corpus
        if not rows_normalized:
            mat = _unit_rows(mat)
        sim_c = torch.where(valid[None, :], e @ mat.T, NEG_INF)
        best_c, row_c = torch.max(sim_c, dim=1)
        row_c = row_c.to(torch.int32)
    else:
        best_c = torch.full((m,), NEG_INF, device=dev)
        row_c = torch.full((m,), -1, dtype=torch.int32, device=dev)

    # within the batch: earlier entries win (strictly lower triangle)
    earlier = torch.ones((m, m), dtype=torch.bool, device=dev).tril(-1)
    sim_b = torch.where(earlier, e @ e.T, NEG_INF)
    best_b, row_b = (torch.max(sim_b, dim=1) if m else
                     (torch.zeros(0, device=dev), torch.zeros(0, dtype=torch.int64, device=dev)))
    row_b = row_b.to(torch.int32)

    use_corpus = best_c >= best_b
    score = torch.maximum(best_c, best_b)
    dup_of = torch.where(use_corpus, row_c, -(row_b + 2))
    is_dup = score >= threshold
    dup_of = torch.where(is_dup, dup_of, torch.full_like(dup_of, -1))
    score = torch.where(torch.isneginf(score), 0.0, score)
    return is_dup, dup_of, score


def near_duplicates_oracle(embeddings, matrix, valid_mask, threshold=0.97, rows_normalized=True):
    """Scalar NumPy oracle (same earlier-entry-wins semantics)."""
    e = np.asarray(embeddings, np.float32).copy()
    norms = np.linalg.norm(e, axis=1, keepdims=True)
    e = e / np.where(norms == 0.0, 1.0, norms)
    mat = np.asarray(matrix, np.float32)
    if not rows_normalized and len(mat):
        mn = np.linalg.norm(mat, axis=1, keepdims=True)
        mat = mat / np.where(mn == 0.0, 1.0, mn)
    valid = np.asarray(valid_mask, bool)
    m = len(e)
    is_dup = np.zeros(m, bool)
    dup_of = np.full(m, -1, np.int32)
    score = np.zeros(m, np.float32)
    for i in range(m):
        best, who = NEG_INF, -1
        for r in range(len(mat)):
            if valid[r]:
                s = float(e[i] @ mat[r])
                if s > best:
                    best, who = s, r
        for j in range(i):
            s = float(e[i] @ e[j])
            if s > best:
                best, who = s, -(j + 2)
        if best != NEG_INF:
            score[i] = best
            if best >= threshold:
                is_dup[i] = True
                dup_of[i] = who
    return is_dup, dup_of, score
