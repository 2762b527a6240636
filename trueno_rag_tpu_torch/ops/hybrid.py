"""The hybrid query programs: dense top-c + BM25 top-c + fusion over
device tensors, and the encoder-fused variants that take query token ids.

PyTorch counterpart of ``trueno_rag_tpu/ops/hybrid.py``'s
``hybrid_query_arrays``, ``hybrid_query_arrays_segments`` (the BM25
segment path, for corpora past the block table's f32-exact row range),
``tri_query_arrays`` (the tri-hybrid's dense + BM25 + learned-sparse
candidates with one N-way fusion), ``fused_hybrid_query`` and
``fused_hybrid_query_compact``. The fused variants run the encoder forward
on the card and hand its output straight to the dense scan, so no query
vector crosses to the host on the way (eager PyTorch, so no single
compiled program as in the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.models.encoder import EncoderConfig, encoder_forward
from trueno_rag_tpu_torch.ops.bm25 import bm25_topk_blocks, weighted_topk_blocks
from trueno_rag_tpu_torch.ops.dense import dense_topk
from trueno_rag_tpu_torch.ops.kernels.bm25_fetch import bm25_topk_fetch
from trueno_rag_tpu_torch.ops.fusion import fuse_topk, fuse_topk_many


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


def hybrid_query_arrays_segments(
    qvecs: torch.Tensor,  # [B, d] query vectors (any embedder)
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    seg_starts: torch.Tensor,  # [B, S] BM25 segment runs
    seg_lens: torch.Tensor,  # [B, S]
    packed: torch.Tensor,  # [P + SEGMENT_LEN, 4] packed postings
    avgdl,
    cand: int = 50,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, ...]:
    """Segment-path variant of :func:`hybrid_query_arrays` for corpora
    whose row ids exceed the f32-exact block-table range; on the card its
    BM25 half runs the fetch kernel (``ops.kernels.bm25_fetch``)."""
    d_scores, d_rows = dense_topk(qvecs, matrix, valid_mask, cand, metric)
    s_scores, s_rows = bm25_topk_fetch(seg_starts, seg_lens, packed, avgdl, cand, k1=k1, b=b)
    f_rows, f_scores = fuse_topk(
        d_rows, d_scores, s_rows, s_scores, kind=fusion_kind, param=fusion_param
    )
    return f_rows, f_scores, d_rows, d_scores, s_rows, s_scores


def fused_hybrid_query(
    encoder_params,
    token_ids: torch.Tensor,  # [B, T] query token ids
    matrix: torch.Tensor,  # [N, d] corpus (cosine rows pre-normalized)
    valid_mask: torch.Tensor,  # [N]
    block_ids: torch.Tensor,  # [B, S] BM25 block slots
    block_lo: torch.Tensor,  # [B, S]
    block_hi: torch.Tensor,  # [B, S]
    blocks: torch.Tensor,  # [NB, 2, BLOCK_LEN] precomputed-contribution table
    encoder_config: EncoderConfig,
    cand: int = 50,
    k: int = 10,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
):
    """Encoder forward + dense top-c + BM25 top-c + fusion + final top-k →
    ``(f_rows [B,k], f_scores [B,k], d_rows, d_scores, s_rows, s_scores)``."""
    q = encoder_forward(encoder_params, token_ids, encoder_config)  # [B, d] f32
    f_rows, f_scores, d_rows, d_scores, s_rows, s_scores = hybrid_query_arrays(
        q, matrix, valid_mask, block_ids, block_lo, block_hi, blocks,
        cand=cand, metric=metric, fusion_kind=fusion_kind, fusion_param=fusion_param,
    )
    return f_rows[:, :k], f_scores[:, :k], d_rows, d_scores, s_rows, s_scores


def fused_hybrid_query_compact(
    encoder_params,
    token_ids: torch.Tensor,  # [B, T] query token ids
    m_bf16: torch.Tensor,  # [N, d] bf16 compact replica (prepare_tiered)
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    r_i8: torch.Tensor,  # [N, d] int8 residual (prepare_residual)
    r_scale: torch.Tensor,  # [N] f32
    e2_l2: torch.Tensor,  # [N] f32
    valid_mask: torch.Tensor,  # [N]
    block_ids: torch.Tensor,  # [B, S] BM25 block slots
    block_lo: torch.Tensor,  # [B, S]
    block_hi: torch.Tensor,  # [B, S]
    blocks: torch.Tensor,  # [NB, 2, BLOCK_LEN]
    encoder_config: EncoderConfig,
    cand: int = 50,
    k: int = 10,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
    tile_n: int = 4096,
):
    """The fused query over the COMPACT bf16r store (no fp32 matrix on the
    card): encoder forward + the certified compact scan (K1) + BM25 + fusion
    + top-k → ``(f_rows [B,k], f_scores [B,k], d_rows, d_scores, s_rows,
    s_scores, ok [B], cand_rows [B,W], thr [B], qvecs [B,d])``. ``ok`` flags
    queries whose dense set the certificate proved; the candidate rows, the
    tile threshold and the encoder outputs feed the store's exact host patch
    of the rest (``HybridRetriever.retrieve_batch_fused``)."""
    from trueno_rag_tpu_torch.ops.dense_tiered import dense_topk_compact_bf16r

    q = encoder_forward(encoder_params, token_ids, encoder_config)  # [B, d]
    d_scores, d_rows, ok, cand_rows, thr = dense_topk_compact_bf16r(
        q, m_bf16, e_l2, a_l2, r_i8, r_scale, e2_l2, valid_mask, cand,
        metric=metric, tile_n=tile_n, return_candidates=True,
    )
    s_scores, s_rows = bm25_topk_blocks(block_ids, block_lo, block_hi, blocks, k=cand)
    f_rows, f_scores = fuse_topk(
        d_rows, d_scores, s_rows, s_scores, kind=fusion_kind, param=fusion_param
    )
    return (f_rows[:, :k], f_scores[:, :k], d_rows, d_scores, s_rows,
            s_scores, ok, cand_rows, thr, q)


def tri_query_arrays(
    qvecs: torch.Tensor,  # [B, d] query vectors (any embedder)
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    block_ids: torch.Tensor,  # [B, S] BM25 block slots
    block_lo: torch.Tensor,  # [B, S]
    block_hi: torch.Tensor,  # [B, S]
    blocks: torch.Tensor,  # [NB, 2, BLOCK_LEN] BM25 contribution table
    l_block_ids: torch.Tensor,  # [B, Sl] learned-sparse block slots
    l_lo: torch.Tensor,  # [B, Sl]
    l_hi: torch.Tensor,  # [B, Sl]
    l_qw: torch.Tensor,  # [B, Sl] per-slot query expansion weights
    l_blocks: torch.Tensor,  # [NBl, 2, BLOCK_LEN] learned weight table
    cand: int = 50,
    metric: str = "cosine",
    fusion_kind: str = "rrf",
    fusion_param: float = 60.0,
    fusion_weights: Tuple[float, ...] = (),
) -> Tuple[torch.Tensor, ...]:
    """The tri-hybrid candidates over the fp32 matrix and the two block
    tables: dense top-c + BM25 top-c + learned-sparse top-c + one N-way
    fusion → ``(f_rows, f_scores, d_rows, d_scores, s_rows, s_scores,
    l_rows, l_scores)``, so the caller can attach per-source scores. The
    learned panel is scored whole, without ``LearnedSparseIndex``'s lane
    grouping; the retriever makes the same calls source by source
    (``HybridRetriever._tri_candidates``)."""
    d_scores, d_rows = dense_topk(qvecs, matrix, valid_mask, cand, metric)
    s_scores, s_rows = bm25_topk_blocks(block_ids, block_lo, block_hi, blocks, k=cand)
    l_scores, l_rows = weighted_topk_blocks(l_block_ids, l_lo, l_hi, l_qw, l_blocks, k=cand)
    f_rows, f_scores = fuse_topk_many(
        (d_rows, s_rows, l_rows), (d_scores, s_scores, l_scores),
        kind=fusion_kind, param=fusion_param, weights=fusion_weights,
    )
    return f_rows, f_scores, d_rows, d_scores, s_rows, s_scores, l_rows, l_scores
