"""BM25 scoring on device over the block-table postings layout.

PyTorch counterpart of ``trueno_rag_tpu/ops/bm25.py`` (block-gather
path). The host owns the vocabulary and CSR layout; the device holds
one ``[NB, 2, BLOCK_LEN]`` table whose lane 0 carries each posting's row
id as an f32 value and lane 1 its precomputed Okapi BM25 contribution.
A query becomes BLOCK_LEN-aligned ``(block, lo, hi)`` slots; one row
gather fetches them, and the candidate tail sorts by row, segment-sums
equal-row runs and takes an exact top-k.

Scoring math matches the reference exactly:
``idf = ln((N - df + 0.5) / (df + 0.5) + 1)`` and
``tf_norm = tf * (k1 + 1) / (tf + k1 * (1 - b + b * len/avglen))``;
only candidates with score > 0 are returned.

Precision note: the candidate tail sums equal-row runs as an f32 cumsum
DIFFERENCE across the whole candidate panel, so a row's score carries
rounding proportional to the panel's cumulative contribution mass
(~mass·2⁻²³); near-ties inside that envelope may order differently from
a per-row oracle.

Rows at or past 2**24 are not exact as f32 values; the JAX package's
segment path for such corpora is not ported, and packing raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import NEG_INF, _pad_k, topk_desc

# Postings per block in the block-gather layout.
BLOCK_LEN = 256
# Row ids ride the block tables as f32 VALUES; exact only below 2**24.
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
        raise InvalidConfigError(
            "row ids exceed the f32-exact range (2**24); the segment BM25 "
            "path for such corpora is not ported yet (ROADMAP)"
        )
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
