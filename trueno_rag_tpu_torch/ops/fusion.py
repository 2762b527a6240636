"""Rank fusion on device over padded top-k candidate arrays.

PyTorch counterpart of ``trueno_rag_tpu/ops/fusion.py::fuse_topk``, with
the batch dimension written out. Candidate lists arrive as fixed-width
``(rows, scores)`` pairs (row ``-1`` + score ``-inf`` = empty slot),
exactly what :func:`~trueno_rag_tpu_torch.ops.dense.dense_topk` and
:func:`~trueno_rag_tpu_torch.ops.bm25.bm25_topk_blocks` emit. Id matching
between the two lists uses a ``[B, Kd, Ks]`` equality tensor.

Semantics per variant match the reference: RRF ``Σ 1/(k + rank + 1)``;
Linear min-max normalizes each list (all-equal → all 1.0) then weights;
Convex = Linear(alpha); DBSF z-scores each list (σ=0 → 0.0) and sums;
Union keeps dense entries (score, rank) and appends unmatched sparse at
rank offset ``|dense|``; Intersection keeps matched ids at the mean of
the two scores.

Output ordering is deterministic: (score desc, row asc); Union orders by
(rank asc, row asc) and carries original scores.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import NEG_INF

FUSION_KINDS = ("rrf", "linear", "convex", "dbsf", "union", "intersection")
_INT_MAX = torch.iinfo(torch.int32).max


def _minmax_norm(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Min-max to [0,1] over each row's valid entries; all-equal → 1.0."""
    mx = torch.where(valid, scores, NEG_INF).amax(dim=1, keepdim=True)
    mn = torch.where(valid, scores, float("inf")).amin(dim=1, keepdim=True)
    rng = mx - mn
    pos = rng > 0.0
    return torch.where(pos, (scores - mn) / torch.where(pos, rng, 1.0), 1.0)


def _zscore_norm(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Z-score over each row's valid entries; zero variance → 0.0."""
    n = torch.clamp(valid.sum(dim=1, keepdim=True), min=1).to(scores.dtype)
    mean = torch.where(valid, scores, 0.0).sum(dim=1, keepdim=True) / n
    var = torch.where(valid, (scores - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / n
    std = torch.sqrt(var)
    pos = std > 0.0
    return torch.where(pos, (scores - mean) / torch.where(pos, std, 1.0), 0.0)


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Permutation sorting each row by (primary asc, secondary asc)."""
    order = torch.sort(secondary, dim=1, stable=True).indices
    order2 = torch.sort(torch.gather(primary, 1, order), dim=1, stable=True).indices
    return torch.gather(order, 1, order2)


def _sort_desc(rows: torch.Tensor, scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic (score desc, row asc) ordering; invalid slots last."""
    key1 = torch.where(torch.isneginf(scores), float("inf"), -scores)
    perm = _lexsort(key1, rows)
    rows_s = torch.gather(rows, 1, perm)
    scores_s = torch.gather(scores, 1, perm)
    return torch.where(torch.isneginf(scores_s), -1, rows_s), scores_s


def fuse_topk(
    rows_d: torch.Tensor,
    scores_d: torch.Tensor,
    rows_s: torch.Tensor,
    scores_s: torch.Tensor,
    kind: str = "rrf",
    param: float = 60.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fusion: ``[B, Kd]`` + ``[B, Ks]`` → ``[B, Kd+Ks]`` (rows,
    scores) deterministically ordered, invalid slots ``(-1, -inf)``.
    ``param`` is the RRF k / Linear dense weight / Convex alpha."""
    if kind not in FUSION_KINDS:
        raise InvalidConfigError(f"unknown fusion kind: {kind!r}")
    rows_d = rows_d.to(torch.int32)
    rows_s = rows_s.to(torch.int32)
    bsz, kd = rows_d.shape
    ks = rows_s.shape[1]
    dev = rows_d.device
    valid_d = rows_d >= 0
    valid_s = rows_s >= 0
    # match[b, i, j]: dense slot i and sparse slot j name the same row
    match = (
        (rows_d[:, :, None] == rows_s[:, None, :])
        & valid_d[:, :, None]
        & valid_s[:, None, :]
    )
    matched_d = match.any(dim=2)
    matched_s = match.any(dim=1)

    def from_sparse(vals_s):
        """For each dense slot, the matched sparse value (or 0)."""
        return torch.where(match, vals_s[:, None, :], 0.0).sum(dim=2)

    rank_d = torch.arange(kd, device=dev, dtype=torch.int32)[None, :].expand(bsz, kd)
    rank_s = torch.arange(ks, device=dev, dtype=torch.int32)[None, :].expand(bsz, ks)

    if kind == "rrf":
        v_d = 1.0 / (param + rank_d.to(torch.float32) + 1.0)
        v_s = 1.0 / (param + rank_s.to(torch.float32) + 1.0)
        f_d = v_d + from_sparse(v_s)
        f_s = v_s
    elif kind in ("linear", "convex"):
        w = param
        nd = _minmax_norm(scores_d, valid_d)
        ns = _minmax_norm(scores_s, valid_s)
        f_d = w * nd + (1.0 - w) * from_sparse(ns)
        f_s = (1.0 - w) * ns
    elif kind == "dbsf":
        zd = _zscore_norm(scores_d, valid_d)
        zs = _zscore_norm(scores_s, valid_s)
        f_d = zd + from_sparse(zs)
        f_s = zs
    elif kind == "union":
        n_dense = valid_d.sum(dim=1, keepdim=True, dtype=torch.int32)
        include_s = valid_s & ~matched_s
        # dense first, unmatched sparse offset by |dense|; dense wins
        # ties and original scores are kept
        keys = torch.cat(
            [
                torch.where(valid_d, rank_d, _INT_MAX),
                torch.where(include_s, n_dense + rank_s, _INT_MAX),
            ],
            dim=1,
        )
        rows_all = torch.cat(
            [torch.where(valid_d, rows_d, -1), torch.where(include_s, rows_s, -1)], dim=1
        )
        scores_all = torch.cat(
            [
                torch.where(valid_d, scores_d, NEG_INF),
                torch.where(include_s, scores_s, NEG_INF),
            ],
            dim=1,
        )
        perm = _lexsort(keys, rows_all)
        return torch.gather(rows_all, 1, perm), torch.gather(scores_all, 1, perm)
    else:  # intersection
        f_d = torch.where(matched_d, (scores_d + from_sparse(scores_s)) / 2.0, NEG_INF)
        rows_all = torch.cat([rows_d, torch.full_like(rows_s, -1)], dim=1)
        scores_all = torch.cat(
            [
                torch.where(matched_d & valid_d, f_d, NEG_INF),
                torch.full_like(scores_s, NEG_INF),
            ],
            dim=1,
        )
        return _sort_desc(rows_all, scores_all)

    # rrf/linear/dbsf: dense slots fused, sparse slots only when not
    # already represented by a dense slot
    scores_all = torch.cat(
        [
            torch.where(valid_d, f_d, NEG_INF),
            torch.where(valid_s & ~matched_s, f_s, NEG_INF),
        ],
        dim=1,
    )
    rows_all = torch.cat([rows_d, torch.where(matched_s, -1, rows_s)], dim=1)
    return _sort_desc(rows_all, scores_all)
