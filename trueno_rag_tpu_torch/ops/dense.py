"""Dense retrieval ops: batched similarity scoring + exact top-k.

PyTorch counterpart of ``trueno_rag_tpu/ops/dense.py``. The corpus is
one device-resident ``[N, d]`` matrix; a query batch ``[B, d]`` scores
in a single fp32 matmul and an exact selection extracts candidates, so
recall@k is identical to the brute-force oracle by construction.

Determinism: the scan is fp32 with TF32 disabled (:func:`require_fp32`);
for cosine/dot the selected candidates are then re-ranked by
:func:`exact_scores` (float64 sums rounded once to f32), so a row's
reported score does not depend on which matmul kernel, and so which
summation order, produced it — the certified tier reports the same
scores. Every selection goes through :func:`topk_desc`, a stable
descending sort. ``torch.topk`` makes no promise about the order of equal values;
the stable sort keeps them in index order, which is exactly
``lax.top_k``'s lower-index preference and yields the (score desc,
row asc) total order the framework guarantees when the candidates sit
in row order.

Padding/tombstones: callers pass a boolean ``valid_mask`` over rows;
invalid rows (capacity padding, removed chunks) are masked to ``-inf``
and reported as row ``-1``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError

NEG_INF = float("-inf")


def require_fp32() -> None:
    """Turn TF32 off for matmuls and convolutions and check that it
    stayed off: a TF32 product keeps ~10 mantissa bits, which silently
    breaks the exact fp32 contract (and the tiered certificate's
    rescore)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise InvalidConfigError("fp32 matmul precision must be 'highest' (TF32 off)")


def topk_desc(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis → (values, indices), ordered value
    desc and, among equal values, index asc (``lax.top_k`` semantics)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def exact_scores(queries: torch.Tensor, matrix: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Dot products of ``matrix[rows]`` (``rows [B, W]``, in range) with
    each query ``[B, d]``, summed in float64 and rounded to f32 once: the
    correctly rounded score, up to a ~d·2⁻⁵³ error before the rounding."""
    gathered = matrix[rows.long()].double()  # [B, W, d]
    return torch.bmm(gathered, queries.double()[:, :, None])[:, :, 0].float()


def _exact_rerank(queries, matrix, top_r, k):
    """Re-rank ``[B, W]`` candidate rows (-1 = none) by
    :func:`exact_scores` → the best ``k`` as (scores, rows), ties
    row-asc, invalid slots (-inf, -1)."""
    pad = torch.iinfo(torch.int32).max
    key, _ = torch.sort(torch.where(top_r < 0, pad, top_r), dim=1)  # row order
    live = key != pad
    s = torch.where(live, exact_scores(queries, matrix, torch.where(live, key, 0)), NEG_INF)
    s, idx = topk_desc(s, k)
    rows = torch.where(torch.isneginf(s), -1, torch.gather(key, 1, idx))
    return s, rows.to(torch.int32)


def _pad_k(top_scores: torch.Tensor, rows: torch.Tensor, k: int):
    """Pad ``[B, k_eff]`` results out to ``k`` columns with (-inf, -1)."""
    short = k - top_scores.shape[1]
    if short <= 0:
        return top_scores, rows
    top_scores = torch.nn.functional.pad(top_scores, (0, short), value=NEG_INF)
    rows = torch.nn.functional.pad(rows, (0, short), value=-1)
    return top_scores, rows


def normalize_queries(queries: torch.Tensor) -> torch.Tensor:
    """L2-normalize query rows; zero rows stay zero."""
    qn = torch.linalg.vector_norm(queries, dim=-1, keepdim=True)
    return queries / torch.where(qn == 0.0, torch.ones_like(qn), qn)


_SLAB_ROWS = 1 << 18  # rows of a bf16 matrix widened to f32 at a time


def _f32_slabs(matrix: torch.Tensor):
    """``(first row, f32 rows)`` slabs of ``matrix``: the matrix itself when
    it is f32; a bf16 matrix (``storage_dtype="bfloat16"``) widened a slab
    at a time, so its products accumulate in f32 without a full f32 copy."""
    if matrix.dtype == torch.float32:
        yield 0, matrix
        return
    for lo in range(0, matrix.shape[0], _SLAB_ROWS):
        yield lo, matrix[lo:lo + _SLAB_ROWS].float()


def _cross(queries: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """``queries @ matrix.T`` in f32 over :func:`_f32_slabs`."""
    if matrix.dtype == torch.float32:
        return queries @ matrix.T
    out = torch.empty((queries.shape[0], matrix.shape[0]), dtype=torch.float32, device=queries.device)
    for lo, slab in _f32_slabs(matrix):
        out[:, lo:lo + slab.shape[0]] = queries @ slab.T
    return out


def similarity_scores(queries: torch.Tensor, matrix: torch.Tensor, metric: str = "cosine") -> torch.Tensor:
    """Score a query batch ``[B, d]`` against a corpus ``[N, d]`` → ``[B, N]``
    (f32 accumulation; the corpus may be float32 or bfloat16).

    - ``cosine``: stored rows are L2-normalized at insert; queries are
      normalized here, so the score is one matmul.
    - ``dot``: raw inner product.
    - ``euclidean``: the *negated* L2 distance, so higher is better.
    """
    if metric == "cosine":
        return _cross(normalize_queries(queries), matrix)
    if metric == "dot":
        return _cross(queries, matrix)
    if metric == "euclidean":
        cross = _cross(queries, matrix)
        sq_m = torch.cat([torch.sum(slab * slab, dim=-1) for _, slab in _f32_slabs(matrix)])
        sq_q = torch.sum(queries * queries, dim=-1, keepdim=True)
        d2 = torch.clamp(sq_q + sq_m[None, :] - 2.0 * cross, min=0.0)
        return -torch.sqrt(d2)
    raise InvalidConfigError(f"unknown metric: {metric!r}")


def blockwise_topk(scores: torch.Tensor, k: int, block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over ``[B, N]`` scores via block-max pre-selection:
    per-128-row block maxima, the best ``min(k, G)`` blocks (a superset
    of the true top-k's blocks), then the final selection over those
    blocks' scores gathered in global-row order — the same algorithm and
    tie behaviour as the JAX package's ``blockwise_topk``."""
    b, n = scores.shape
    g = -(-n // block)
    if g * block != n:
        scores = torch.nn.functional.pad(scores, (0, g * block - n), value=NEG_INF)
    sb = scores.view(b, g, block)
    bmax = sb.amax(dim=2)
    nb = min(k, g)
    _, bidx = topk_desc(bmax, nb)
    bidx, _ = torch.sort(bidx, dim=1)  # candidates in global-row order
    cand = torch.gather(sb, 1, bidx[:, :, None].expand(b, nb, block)).reshape(b, nb * block)
    k_eff = min(k, nb * block)
    top_scores, flat_idx = topk_desc(cand, k_eff)
    blk = torch.gather(bidx, 1, flat_idx // block)
    rows = (blk * block + flat_idx % block).to(torch.int32)
    rows = torch.where(torch.isneginf(top_scores), -1, rows)
    return _pad_k(top_scores, rows, k)


def dense_topk(
    queries: torch.Tensor,
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    metric: str = "cosine",
    algorithm: str = "blockwise",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dense retrieval.

    ``queries [B, d]`` f32, ``matrix [N, d]`` (invalid rows are zeros),
    ``valid_mask [N]`` bool. Returns ``(scores [B, k], rows [B, k])``
    sorted score-desc with row-asc tie-break; invalid slots are
    ``(-inf, -1)``. For cosine/dot the best ``2k`` rows of the fp32 scan
    are re-ranked by :func:`exact_scores`."""
    scores = similarity_scores(queries, matrix, metric)
    masked = torch.where(valid_mask[None, :], scores, NEG_INF)
    return topk_masked(queries, matrix, masked, k, metric, algorithm)


def topk_masked(queries, matrix, masked, k: int, metric: str = "cosine", algorithm: str = "blockwise"):
    """The selection of :func:`dense_topk` on ``masked [B, N]`` scores
    (-inf where a row may not be returned): the best ``2k`` rows, re-ranked
    by :func:`exact_scores` for cosine/dot."""
    width = k if metric == "euclidean" else min(2 * k, matrix.shape[0])
    if algorithm == "blockwise":
        top_scores, top_rows = blockwise_topk(masked, width)
    elif algorithm == "full":
        top_scores, idx = topk_desc(masked, width)
        top_rows = idx.to(torch.int32)
    else:
        raise InvalidConfigError(f"unknown top-k algorithm {algorithm!r}")
    top_rows = torch.where(torch.isneginf(top_scores), -1, top_rows).to(torch.int32)
    if metric != "euclidean":
        q = normalize_queries(queries) if metric == "cosine" else queries
        top_scores, top_rows = _exact_rerank(q, matrix, top_rows, k)
    return _pad_k(top_scores, top_rows, k)


def blockwise_topk_approx(scores: torch.Tensor, k: int, block: int = 128):
    """:func:`blockwise_topk` with an on-device certificate, the
    counterpart of the JAX package's ``blockwise_topk_approx``: both
    exclusion thresholds are the max over what was actually NOT selected —
    thr1 over the unselected blocks' maxima, thr2 over the unselected
    rows of the selected blocks — and ``certified = kth > max(thr1, thr2)``
    (or nothing was excluded) proves the returned set is the exact top-k
    of ``scores``; an exact tie at the k boundary fails closed. The JAX
    code selects with ``approx_max_k``; PyTorch has none, so both
    selections here are exact (:func:`topk_desc`) and can return no
    duplicate. → (scores [B,k], rows [B,k], certified [B] bool)."""
    b, n = scores.shape
    g = -(-n // block)
    if g * block != n:
        scores = torch.nn.functional.pad(scores, (0, g * block - n), value=NEG_INF)
    sb = scores.view(b, g, block)
    bmax = sb.amax(dim=2)
    nb = min(k, g)
    _, bidx = topk_desc(bmax, nb)
    thr1 = bmax.scatter(1, bidx, NEG_INF).amax(dim=1)
    bidx, _ = torch.sort(bidx, dim=1)  # candidates in global-row order
    cand = torch.gather(sb, 1, bidx[:, :, None].expand(b, nb, block)).reshape(b, nb * block)
    k_eff = min(k, nb * block)
    top_scores, flat_idx = topk_desc(cand, k_eff)  # (score desc, row asc)
    thr2 = cand.scatter(1, flat_idx, NEG_INF).amax(dim=1)
    blk = torch.gather(bidx, 1, flat_idx // block)
    rows = (blk * block + flat_idx % block).to(torch.int32)
    rows = torch.where(torch.isneginf(top_scores), -1, rows)
    threshold = torch.maximum(thr1, thr2)
    certified = (top_scores[:, k_eff - 1] > threshold) | torch.isneginf(threshold)
    top_scores, rows = _pad_k(top_scores, rows, k)
    return top_scores, rows, certified


def dense_topk_approx(
    queries: torch.Tensor,
    matrix: torch.Tensor,
    valid_mask: torch.Tensor,
    k: int,
    metric: str = "cosine",
):
    """Full f32 scoring + certified selection (:func:`blockwise_topk_approx`)
    → (scores, rows, certified [B]). For cosine/dot the certified set is
    the best ``min(2k, N)`` rows of the scan, re-ranked by
    :func:`exact_scores` as :func:`dense_topk` does, so a certified query
    answers exactly as :func:`dense_topk`."""
    masked = torch.where(valid_mask[None, :], similarity_scores(queries, matrix, metric), NEG_INF)
    if metric == "euclidean":
        return blockwise_topk_approx(masked, k)
    _, top_rows, ok = blockwise_topk_approx(masked, min(2 * k, matrix.shape[0]))
    q = normalize_queries(queries) if metric == "cosine" else queries
    top_scores, top_rows = _pad_k(*_exact_rerank(q, matrix, top_rows, k), k)
    return top_scores, top_rows, ok


def dense_topk_approx_checked(queries, matrix, valid_mask, k, metric="cosine"):
    """Exactness-contract wrapper: the certified path, with the
    uncertified queries (ties at the selection boundary) re-run on
    :func:`dense_topk` → (scores, rows, used_fallback)."""
    s, r, ok = dense_topk_approx(queries, matrix, valid_mask, k, metric)
    bad = torch.nonzero(~ok).flatten()
    if bad.numel() == 0:
        return s, r, False
    fb_s, fb_r = dense_topk(queries[bad], matrix, valid_mask, k, metric)
    s, r = s.clone(), r.clone()
    s[bad], r[bad] = fb_s, fb_r
    return s, r, True


def dense_topk_oracle(queries, matrix, valid_mask, k, metric="cosine"):
    """NumPy reference implementation (scalar semantics of the reference
    brute-force scan, incl. cosine zero-norm → 0.0) used to assert
    device-path exactness in tests."""
    queries = np.asarray(queries, dtype=np.float32)
    matrix = np.asarray(matrix, dtype=np.float32)
    valid = np.asarray(valid_mask, dtype=bool)
    out_scores = np.full((queries.shape[0], k), NEG_INF, dtype=np.float32)
    out_rows = np.full((queries.shape[0], k), -1, dtype=np.int32)
    for bq, q in enumerate(queries):
        if metric == "cosine":
            qn = np.linalg.norm(q)
            mn = np.linalg.norm(matrix, axis=1)
            denom = np.where((qn == 0.0) | (mn == 0.0), 1.0, qn * mn)
            s = np.where((qn == 0.0) | (mn == 0.0), 0.0, matrix @ q / denom)
        elif metric == "dot":
            s = matrix @ q
        elif metric == "euclidean":
            s = -np.linalg.norm(matrix - q[None, :], axis=1)
        else:
            raise ValueError(metric)
        s = np.where(valid, s, NEG_INF)
        order = np.lexsort((np.arange(len(s)), -s))[:k]
        picked = s[order]
        keep = ~np.isneginf(picked)
        out_scores[bq, : len(order)] = picked
        out_rows[bq, : len(order)] = np.where(keep, order, -1)
    return out_scores, out_rows
