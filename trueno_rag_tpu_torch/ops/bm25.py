"""BM25 scoring on device over the CSR postings: the block-table layout
and, past the f32-exact row range, the packed segment layout.

PyTorch counterpart of ``trueno_rag_tpu/ops/bm25.py``. The host owns the
vocabulary and CSR layout (``indptr``); the device holds one of two
layouts of the postings:

- the **block table** ``[NB, 2, BLOCK_LEN]`` (rows below 2**24): lane 0
  carries each posting's row id as an f32 value and lane 1 its
  precomputed Okapi BM25 contribution. A query becomes BLOCK_LEN-aligned
  ``(block, lo, hi)`` slots, fetched with one row gather
  (:func:`bm25_topk_blocks`);
- the **packed postings** ``[P + SEGMENT_LEN, 4]`` f32 (any row count):
  per posting the row id's int32 BITS, tf, the row's document length and
  the term's idf. A query becomes ``(start, len)`` runs of at most
  SEGMENT_LEN postings, and the contribution is computed after the fetch
  (:func:`bm25_topk_segments`; on the card the fetch is the CUDA kernel
  of :mod:`~trueno_rag_tpu_torch.ops.kernels.bm25_fetch`).

Both end in the same candidate tail: sort by row, segment-sum equal-row
runs and take an exact top-k. :func:`bm25_topk_candidates` (element
gather) and :func:`bm25_topk_scatter` (dense scatter) are the oracles.

Scoring math matches the reference exactly:
``idf = ln((N - df + 0.5) / (df + 0.5) + 1)`` and
``tf_norm = tf * (k1 + 1) / (tf + k1 * (1 - b + b * len/avglen))``;
only candidates with score > 0 are returned.

Precision note: the candidate tail sums equal-row runs as an f32 cumsum
DIFFERENCE across the whole candidate panel, so a row's score carries
rounding proportional to the panel's cumulative contribution mass
(~mass·2⁻²³); near-ties inside that envelope may order differently from
a per-row oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import NEG_INF, _pad_k, blockwise_topk, topk_desc

# Postings per fetched segment of the packed layout.
SEGMENT_LEN = 256
# Postings per block in the block-gather layout.
BLOCK_LEN = 256
# Row ids ride the block tables as f32 VALUES; exact only below 2**24. The
# index reads this at snapshot time, so past it a corpus takes the segments.
MAX_BLOCK_ROWS = 1 << 24
_ROW_PAD = torch.iinfo(torch.int32).max


def _candidate_topk(r_key: torch.Tensor, contrib: torch.Tensor, k: int):
    """Batched candidate tail: per query, (row-key, contribution) pairs
    ``[B, L]`` → exact ``(scores [B, k], rows [B, k])`` with the (score
    desc, row asc) contract. ``r_key`` is int32-max on invalid slots and
    ``contrib`` 0 there. Sort by row, segment-sum equal-row runs via the
    cumsum difference (contrib >= 0, so the running max of run-end
    cumsums IS the previous run's end), score > 0 filter."""
    bsz, L = r_key.shape
    r_sorted, perm = torch.sort(r_key, dim=1, stable=True)
    c_sorted = torch.gather(contrib, 1, perm)
    csum = torch.cumsum(c_sorted, dim=1)
    nxt = torch.cat([r_sorted[:, 1:], torch.full_like(r_sorted[:, :1], -1)], dim=1)
    is_end = r_sorted != nxt
    run_max = torch.cummax(torch.where(is_end, csum, NEG_INF), dim=1).values
    prev_csum = torch.cat([torch.full_like(csum[:, :1], NEG_INF), run_max[:, :-1]], dim=1)
    base = torch.where(torch.isneginf(prev_csum), 0.0, prev_csum)
    seg_sum = csum - base
    valid = is_end & (r_sorted != _ROW_PAD) & (seg_sum > 0.0)
    scores_c = torch.where(valid, seg_sum, NEG_INF)
    k_eff = min(k, L)
    top_s, top_i = topk_desc(scores_c, k_eff)
    top_r = torch.where(torch.isneginf(top_s), -1, torch.gather(r_sorted, 1, top_i)).to(torch.int32)
    return _pad_k(top_s, top_r, k)


def pack_posting_blocks(
    rows, tfs, doc_len, idf, term_of_posting, avgdl, k1: float = 1.2, b: float = 0.75
) -> np.ndarray:
    """Host: pack postings into the ``[NB, 2, BLOCK_LEN]`` f32 block
    table — lane 0 = row id as an f32 VALUE (exact below 2**24 rows),
    lane 1 = the full precomputed Okapi BM25 contribution
    idf·tf·(k1+1)/(tf + k1(1−b+b·dl/avgdl)), all in float32. The block
    after the last posting is the always-masked padding target."""
    rows = np.asarray(rows, dtype=np.int32)
    p = len(rows)
    if p and int(rows.max()) >= MAX_BLOCK_ROWS:
        raise InvalidConfigError("row ids exceed the f32-exact range; use the segment path")
    tfs32 = np.asarray(tfs, dtype=np.float32)
    dl32 = np.asarray(doc_len, dtype=np.float32)[rows]
    idf32 = np.asarray(idf, dtype=np.float32)[np.asarray(term_of_posting, dtype=np.int64)]
    k1f, bf = np.float32(k1), np.float32(b)
    av = np.maximum(np.float32(avgdl), np.float32(1e-9))
    denom = tfs32 + k1f * (np.float32(1.0) - bf + bf * dl32 / av)
    contrib = idf32 * tfs32 * (k1f + np.float32(1.0)) / np.maximum(denom, np.float32(1e-9))
    nb = p // BLOCK_LEN + 1
    table = np.zeros((nb, 2, BLOCK_LEN), dtype=np.float32)
    fb, rem = divmod(p, BLOCK_LEN)
    if fb:
        table[:fb, 0, :] = rows[: fb * BLOCK_LEN].astype(np.float32).reshape(fb, BLOCK_LEN)
        table[:fb, 1, :] = contrib[: fb * BLOCK_LEN].reshape(fb, BLOCK_LEN)
    if rem:
        table[fb, 0, :rem] = rows[fb * BLOCK_LEN:].astype(np.float32)
        table[fb, 1, :rem] = contrib[fb * BLOCK_LEN:]
    return table


def bm25_topk_blocks(
    block_ids: torch.Tensor,  # [B, S] int32 — block index per slot
    lo: torch.Tensor,  # [B, S] int32 — first valid lane within the block
    hi: torch.Tensor,  # [B, S] int32 — one past the last valid lane
    blocks: torch.Tensor,  # [NB, 2, BLOCK_LEN] f32 — see pack_posting_blocks
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-gather BM25 top-k → ``(scores [B, k], rows [B, k])``. Blocks
    are BLOCK_LEN-aligned, so a term's run may start or end mid-block;
    (lo, hi) mask off the neighbours' postings."""
    bsz, s = block_ids.shape
    bl = blocks.shape[-1]
    g = blocks[block_ids.reshape(-1).long()].view(bsz, s, 2, bl)
    lane = torch.arange(bl, device=blocks.device, dtype=torch.int32)
    mask = (lane >= lo[:, :, None]) & (lane < hi[:, :, None])
    r = g[:, :, 0, :].to(torch.int32)  # f32 row VALUES — exact < 2**24
    contrib = torch.where(mask, g[:, :, 1, :], 0.0).reshape(bsz, s * bl)
    r_key = torch.where(mask, r, _ROW_PAD).reshape(bsz, s * bl)
    return _candidate_topk(r_key, contrib, k)


def bucket_len(n: int, minimum: int = 64) -> int:
    """Round a gather-list length up to a power-of-two bucket, so slot
    counts (and the shapes downstream) take O(log L) distinct values."""
    m = minimum
    while m < n:
        m *= 2
    return m


def okapi_contrib(tf, dl, idf_t, avgdl, k1: float, b: float) -> torch.Tensor:
    """The Okapi BM25 contribution of postings ``(tf, dl, idf_t)`` (f32
    tensors), in the JAX package's operation order, each step rounded once
    in f32: ``t = (1−b) + (b·dl)/max(avgdl, 1e-9)``, ``denom = tf + k1·t``,
    ``((idf·tf)·(k1+1)) / max(denom, 1e-9)``. ``1−b`` and ``k1+1`` are
    formed in double and rounded to f32, as JAX folds its Python-float
    constants; ``avgdl`` is one f32 value (a float or a 0-d tensor)."""

    def c(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=tf.device)

    t = c(1.0 - b) + (c(b) * dl) / c(max(float(avgdl), 1e-9))
    denom = tf + c(k1) * t
    return ((idf_t * tf) * c(k1 + 1.0)) / torch.maximum(denom, c(1e-9))


def pack_postings(rows, tfs, doc_len, idf, term_of_posting) -> np.ndarray:
    """Host: pre-join per-posting (row, tf, doc_len[row], idf[term]) into
    the ``[P + SEGMENT_LEN, 4]`` f32 record of the segment path. Lane 0
    holds the row id's int32 BITS (exact for any row count). The
    SEGMENT_LEN padding rows carry the int32-max sentinel bits (zeros
    would bit-cast to real row 0), so a segment read never runs past the
    array and padding lanes can never name a row."""
    rows = np.asarray(rows, dtype=np.int32)
    p = len(rows)
    packed = np.zeros((p + SEGMENT_LEN, 4), dtype=np.float32)
    packed[p:, 0] = np.full(SEGMENT_LEN, _ROW_PAD, np.int32).view(np.float32)
    packed[:p, 0] = rows.view(np.float32)
    packed[:p, 1] = np.asarray(tfs, dtype=np.float32)
    packed[:p, 2] = np.asarray(doc_len, dtype=np.float32)[rows]
    packed[:p, 3] = np.asarray(idf, dtype=np.float32)[np.asarray(term_of_posting)]
    return packed


def slab_contribs(
    first_rows: torch.Tensor,  # [BS] int — packed row of each slot's lane 0
    lo: torch.Tensor,  # [BS] int — first valid lane
    hi: torch.Tensor,  # [BS] int — one past the last valid lane
    packed: torch.Tensor,  # [P + SEGMENT_LEN, 4] f32 — see pack_postings
    avgdl,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain fetch of SEGMENT_LEN posting rows per slot from
    ``first_rows[s]`` on, with the masked Okapi contribution → (rows
    ``[BS, SEGMENT_LEN]`` int32, int32-max on lanes outside ``[lo, hi)``;
    contribs ``[BS, SEGMENT_LEN]`` f32, 0 there). Every slot's
    ``first_row + SEGMENT_LEN`` must be within ``packed``."""
    lane = torch.arange(SEGMENT_LEN, device=packed.device)
    g = packed[first_rows.long()[:, None] + lane]  # [BS, SEGMENT_LEN, 4]
    mask = (lane >= lo[:, None]) & (lane < hi[:, None])
    r = g[:, :, 0].contiguous().view(torch.int32)  # row BITS, not values
    contrib = okapi_contrib(g[:, :, 1], g[:, :, 2], g[:, :, 3], avgdl, k1, b)
    return torch.where(mask, r, _ROW_PAD), torch.where(mask, contrib, 0.0)


def bm25_topk_segments(
    seg_starts: torch.Tensor,  # [B, S] int32 — posting offsets of contiguous runs
    seg_lens: torch.Tensor,  # [B, S] int32 — run lengths (<= SEGMENT_LEN)
    packed: torch.Tensor,  # [P + SEGMENT_LEN, 4] f32 — see pack_postings
    avgdl,
    k: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment BM25 top-k, the plain version on any device →
    ``(scores [B, k], rows [B, k])``: each ``(start, len)`` run fetches
    SEGMENT_LEN rows from ``start`` with lanes past ``len`` masked, and the
    flattened ``[B, S·SEGMENT_LEN]`` panel goes through the candidate tail.
    On the card :func:`~trueno_rag_tpu_torch.ops.kernels.bm25_fetch.bm25_topk_fetch`
    computes the same panel with the fetch kernel."""
    bsz, s = seg_starts.shape
    flat = seg_starts.reshape(-1)
    r_key, contrib = slab_contribs(flat, torch.zeros_like(flat), seg_lens.reshape(-1), packed, avgdl, k1, b)
    return _candidate_topk(r_key.view(bsz, -1), contrib.view(bsz, -1), k)


def _posting_contribs(positions, pos_terms, pos_mask, rows, tfs, idf, doc_len, avgdl, k1, b):
    """Element gather of (row, contribution) per posting position."""
    pos = positions.long()
    r = rows[pos]
    contrib = okapi_contrib(tfs[pos], doc_len[r.long()], idf[pos_terms.long()], avgdl, k1, b)
    return r, torch.where(pos_mask, contrib, 0.0)


def bm25_topk_candidates(
    positions: torch.Tensor,  # [B, L] int — indices into the postings arrays
    pos_terms: torch.Tensor,  # [B, L] int — term id per position
    pos_mask: torch.Tensor,  # [B, L] bool — False for padding slots
    rows: torch.Tensor,  # [P] int32 — chunk row per posting
    tfs: torch.Tensor,  # [P] f32 — term frequency per posting
    idf: torch.Tensor,  # [V] f32 — per-term idf
    doc_len: torch.Tensor,  # [N] f32 — token count per chunk row
    avgdl,
    k: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate-set BM25 top-k over per-position gathers (the oracle of
    the gather layouts): contributions per position, then the candidate
    tail → ``(scores [B, k], rows [B, k])``."""
    r, contrib = _posting_contribs(positions, pos_terms, pos_mask, rows, tfs, idf, doc_len, avgdl, k1, b)
    return _candidate_topk(torch.where(pos_mask, r, _ROW_PAD), contrib, k)


def bm25_topk_scatter(
    positions: torch.Tensor,
    pos_terms: torch.Tensor,
    pos_mask: torch.Tensor,
    rows: torch.Tensor,
    tfs: torch.Tensor,
    idf: torch.Tensor,
    doc_len: torch.Tensor,
    avgdl,
    k: int,
    k1: float = 1.2,
    b: float = 0.75,
    n_rows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-scatter BM25 top-k (the oracle of :func:`bm25_topk_candidates`):
    contributions scatter-added into ``[B, n_rows]`` scores, score > 0
    kept, exact top-k → ``(scores [B, k], rows [B, k])``, (-inf, -1) past
    the hits."""
    n = n_rows or doc_len.shape[0]
    r, contrib = _posting_contribs(positions, pos_terms, pos_mask, rows, tfs, idf, doc_len, avgdl, k1, b)
    scores = torch.zeros((r.shape[0], n), dtype=torch.float32, device=r.device)
    scores.scatter_add_(1, r.long(), contrib)  # padding positions add 0
    top_s, top_r = blockwise_topk(torch.where(scores > 0.0, scores, NEG_INF), min(k, n))
    top_r = torch.where(torch.isneginf(top_s), -1, top_r).to(torch.int32)
    return _pad_k(top_s, top_r, k)
