"""Tag-filtered retrieval ops: metadata filters as device bit tests.

PyTorch counterpart of ``trueno_rag_tpu/ops/tags.py``. Every chunk row
carries a 32-bit tag mask (string tags map to bits in
:class:`~trueno_rag_tpu_torch.index.base.ChunkRegistry`'s vocabulary); a
filter is three per-query int32 masks

- ``t_all``: rows must have ALL these bits,
- ``t_any``: rows must have at least one (0 = no constraint),
- ``t_none``: rows must have NONE,

and the predicate masks the dense scores before their top-k, so "top-k
among allowed rows" stays exact. BM25 candidates filter after their top-k
and before fusion, so fused ranks are computed over the filtered list.
The certified scan tiers apply the same predicate inside the scan kernels
(``ops/kernels/scan_select.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.ops.bm25 import bm25_topk_blocks
from trueno_rag_tpu_torch.ops.dense import NEG_INF, similarity_scores, topk_masked
from trueno_rag_tpu_torch.ops.fusion import _sort_desc, fuse_topk


def tag_pred(tag_bits: torch.Tensor, t_all: torch.Tensor, t_any: torch.Tensor,
             t_none: torch.Tensor) -> torch.Tensor:
    """Elementwise predicate on integer tensors or numpy arrays; shapes
    broadcast (typically ``[N]`` bits vs ``[B, 1]`` masks → ``[B, N]``)."""
    ok = (tag_bits & t_all) == t_all
    ok = ok & ((t_any == 0) | ((tag_bits & t_any) != 0))
    return ok & ((tag_bits & t_none) == 0)


def tag_pred_oracle(bits: int, t_all: int, t_any: int, t_none: int) -> bool:
    """Scalar host oracle for :func:`tag_pred`."""
    if (bits & t_all) != t_all:
        return False
    if t_any != 0 and (bits & t_any) == 0:
        return False
    return (bits & t_none) == 0


def dense_topk_tagged(
    queries: torch.Tensor,  # [B, d]
    matrix: torch.Tensor,  # [N, d]
    valid_mask: torch.Tensor,  # [N] bool
    tag_bits: torch.Tensor,  # [N] int32
    t_all: torch.Tensor,  # [B] int32
    t_any: torch.Tensor,  # [B] int32
    t_none: torch.Tensor,  # [B] int32
    k: int,
    metric: str = "cosine",
    algorithm: str = "blockwise",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k among rows passing each query's tag filter, with the
    same selection and exact re-rank as :func:`ops.dense.dense_topk`."""
    scores = similarity_scores(queries, matrix, metric)
    allowed = valid_mask[None, :] & tag_pred(
        tag_bits[None, :], t_all[:, None], t_any[:, None], t_none[:, None]
    )
    return topk_masked(queries, matrix, torch.where(allowed, scores, NEG_INF), k, metric, algorithm)


def filter_candidates_by_tags(
    rows: torch.Tensor,  # [B, K] int32, -1 padded
    scores: torch.Tensor,  # [B, K] f32, -inf padded
    tag_bits: torch.Tensor,  # [N] int32
    t_all: torch.Tensor,  # [B]
    t_any: torch.Tensor,  # [B]
    t_none: torch.Tensor,  # [B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop candidates failing the filter, re-packed to the canonical
    (score desc, row asc, invalid-last) order so downstream rank-based
    fusion sees correct filtered ranks. Returns (rows, scores)."""
    safe = torch.clamp(rows, min=0).long()
    bits = tag_bits[safe]  # [B, K]
    keep = (rows >= 0) & tag_pred(bits, t_all[:, None], t_any[:, None], t_none[:, None])
    scores = torch.where(keep, scores, NEG_INF)
    rows = torch.where(keep, rows, -1)
    return _sort_desc(rows, scores)


def fused_hybrid_query_tagged(
    encoder_params,
    token_ids: torch.Tensor,  # [B, T]
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    tag_bits: torch.Tensor,
    t_all: torch.Tensor,
    t_any: torch.Tensor,
    t_none: torch.Tensor,
    block_ids: torch.Tensor,
    block_lo: torch.Tensor,
    block_hi: torch.Tensor,
    blocks: torch.Tensor,
    encoder_config,
    cand: int = 50,
    k: int = 10,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
):
    """Tag-filtered sibling of :func:`ops.hybrid.fused_hybrid_query`:
    encoder forward + filtered dense top-c + BM25 top-c (post-filtered) +
    fusion + final top-k → (f_rows [B,k], f_scores [B,k], d_rows, d_scores,
    s_rows, s_scores)."""
    from trueno_rag_tpu_torch.models.encoder import encoder_forward

    q = encoder_forward(encoder_params, token_ids, encoder_config)
    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays_tagged(
        q, matrix, valid_mask, tag_bits, t_all, t_any, t_none,
        block_ids, block_lo, block_hi, blocks,
        cand=cand, metric=metric, fusion_kind=fusion_kind, fusion_param=fusion_param,
    )
    return f_rows[:, :k], f_scores[:, :k], d_rows, d_scores, s_rows, s_scores


def hybrid_query_arrays_tagged(
    qvecs: torch.Tensor,  # [B, d]
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    tag_bits: torch.Tensor,  # [N] int32
    t_all: torch.Tensor,  # [B]
    t_any: torch.Tensor,  # [B]
    t_none: torch.Tensor,  # [B]
    block_ids: torch.Tensor,
    block_lo: torch.Tensor,
    block_hi: torch.Tensor,
    blocks: torch.Tensor,
    cand: int = 50,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
):
    """Tag-filtered sibling of :func:`ops.hybrid.hybrid_query_arrays`:
    dense scoring masks disallowed rows before its top-k (exact filtered
    top-k); BM25 candidates filter after theirs (slots spent on
    disallowed rows are not refilled); fusion runs on the filtered lists.
    → (f_rows, f_scores, d_rows, d_scores, s_rows, s_scores)."""
    d_scores, d_rows = dense_topk_tagged(
        qvecs, matrix, valid_mask, tag_bits, t_all, t_any, t_none, cand, metric
    )
    s_scores, s_rows = bm25_topk_blocks(block_ids, block_lo, block_hi, blocks, k=cand)
    s_rows, s_scores = filter_candidates_by_tags(s_rows, s_scores, tag_bits, t_all, t_any, t_none)
    f_rows, f_scores = fuse_topk(
        d_rows, d_scores, s_rows, s_scores, kind=fusion_kind, param=fusion_param
    )
    return f_rows, f_scores, d_rows, d_scores, s_rows, s_scores
