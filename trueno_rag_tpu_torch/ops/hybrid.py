"""The one-dispatch hybrid query for host-embedded queries.

PyTorch counterpart of ``trueno_rag_tpu/ops/hybrid.py::hybrid_query_arrays``:
dense top-c + BM25 top-c + fusion over device tensors. The encoder-fused
variants of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.ops.bm25 import bm25_topk_blocks
from trueno_rag_tpu_torch.ops.dense import dense_topk
from trueno_rag_tpu_torch.ops.fusion import fuse_topk


def hybrid_query_arrays(
    qvecs: torch.Tensor,  # [B, d] query vectors (any embedder)
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    block_ids: torch.Tensor,  # [B, S] BM25 block slots
    block_lo: torch.Tensor,  # [B, S]
    block_hi: torch.Tensor,  # [B, S]
    blocks: torch.Tensor,  # [NB, 2, BLOCK_LEN] precomputed-contribution table
    cand: int = 50,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
) -> Tuple[torch.Tensor, ...]:
    """→ (f_rows, f_scores, d_rows, d_scores, s_rows, s_scores), so the
    caller can attach per-source scores."""
    d_scores, d_rows = dense_topk(qvecs, matrix, valid_mask, cand, metric)
    s_scores, s_rows = bm25_topk_blocks(block_ids, block_lo, block_hi, blocks, k=cand)
    f_rows, f_scores = fuse_topk(
        d_rows, d_scores, s_rows, s_scores, kind=fusion_kind, param=fusion_param
    )
    return f_rows, f_scores, d_rows, d_scores, s_rows, s_scores
