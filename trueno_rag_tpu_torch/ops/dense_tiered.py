"""Tiered dense top-k: bf16 tile scan + verified fp32 rescore — exact
results without the full fp32 scan.

PyTorch counterpart of the bf16 tile tier of
``trueno_rag_tpu/ops/dense_tiered.py`` (``dense_topk_tiered2`` and its
checked wrapper). One pass over a bf16 replica of the corpus
(:func:`~trueno_rag_tpu_torch.ops.kernels.scan_select.scan_select_v3`)
emits, per 1024-row tile, a few candidate rows with rigorous upper
bounds on their true fp32 scores plus a bound on every other row of the
tile; exactness is recovered with interval arithmetic:

1. **Bound**: with M = A + E (A = bf16(M)) and q = b + f,
   |m·q − a·b| ≤ ‖E_i‖‖b‖ + ‖A_i‖‖f‖ + ‖E_i‖‖f‖ plus an f32-accumulation
   term d·2⁻²³·‖A_i‖‖b‖ and a safety factor — two rank-1 coefficients.
2. **Select**: the top-(k+margin) tiles by their best upper bound; the
   exclusion threshold is the larger of the best unselected tile bound
   and the selected tiles' own thresholds.
3. **Rescore**: the best ``rescore_rows`` candidates rescore with
   :func:`~trueno_rag_tpu_torch.ops.dense.exact_scores` — the exact
   path's own arithmetic — ordered (score desc, row asc).
4. **Verify**: certified iff the k-th exact score STRICTLY beats the
   threshold. :func:`dense_topk_tiered2_checked` re-runs uncertified
   queries on the exact fp32 path — results are ALWAYS exact.

Selection is an exact top-k with the count-trick threshold of the JAX
code's ``approx_select=True`` path, which stays fail-closed.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import (
    NEG_INF, _pad_k, dense_topk, exact_scores, normalize_queries, topk_desc,
)
from trueno_rag_tpu_torch.ops.kernels.scan_select import SEL, scan_select_v3

# Safety inflation on the analytic bound: absorbs f32 rounding in the
# bound arithmetic itself (a handful of multiply-adds).
_BOUND_SLACK = 1.0001
_BOUND_EPS = 1e-7
_ROW_SENTINEL = 1 << 30  # marks empty candidate slots; kept distinct


def prepare_tiered(matrix: torch.Tensor):
    """Pack the scan tier: (m_bf16 [N,d], e_l2 [N], a_l2 [N]) with
    e_l2 = ‖M_i − bf16(M_i)‖₂ and a_l2 = ‖bf16(M_i)‖₂ in f32. Eager
    PyTorch does not fold the f32→bf16→f32 round trip, so the residual
    is real (the JAX code needs an optimization barrier for that)."""
    m_bf16 = matrix.to(torch.bfloat16)
    a = m_bf16.float()
    e = matrix - a
    e_l2 = torch.sqrt(torch.sum(e * e, dim=1))
    a_l2 = torch.sqrt(torch.sum(a * a, dim=1))
    return m_bf16, e_l2, a_l2


def _bf16_query_bounds(q: torch.Tensor):
    """Quantize the query batch to bf16 and build the rank-1 bound
    coefficients → (qb [B,d] bf16, u_q [B], v_q [B]) with bound =
    e_l2·u_q + a_l2·v_q. acc_eps covers f32 accumulation rounding
    (d·2⁻²³ per unit ‖A‖‖b‖); slack inflates both coefficients and the
    flat eps rides v_q. CERTIFICATE-CRITICAL — same math as the JAX
    package's ``_bf16_query_bounds``."""
    d = q.shape[1]
    qb = q.to(torch.bfloat16)
    f = q - qb.float()
    b_l2 = torch.linalg.vector_norm(qb.float(), dim=1)
    f_l2 = torch.linalg.vector_norm(f, dim=1)
    acc_eps = float(d) * 2.0**-23
    u_q = (b_l2 + f_l2) * _BOUND_SLACK + _BOUND_EPS
    v_q = (f_l2 + acc_eps * b_l2) * _BOUND_SLACK + _BOUND_EPS
    return qb, u_q, v_q


def _topk_select(values: torch.Tensor, k: int):
    """Select top-k indices of ``values [B, G]`` plus a RIGOROUS per-row
    upper bound on every non-selected entry, by the JAX code's
    scatter-free count trick: with vmin = min(selected), if EXACTLY k
    entries are >= vmin the selected set IS {v >= vmin} and the bound is
    max(v < vmin); a tie at the boundary fails closed via a +inf
    threshold."""
    vals, idx = topk_desc(values, k)
    vmin = vals.amin(dim=1)
    ge = values >= vmin[:, None]
    count = ge.sum(dim=1)
    thr_exact = torch.where(ge, NEG_INF, values).amax(dim=1)
    return idx, torch.where(count == k, thr_exact, float("inf"))


def _trim_rescore_verify(
    cand_rows, cand_vals, threshold, q, matrix, valid_mask, n, bsz, b_pad,
    k_req, rescore_rows,
):
    """Certificate tail: optional trim of the explicit candidate set,
    exact fp32 rescore, deterministic (score desc, row asc) top-k and
    the strict-beat verification. ``cand_rows`` must already map -inf
    candidates to distinct ``_ROW_SENTINEL`` slots."""
    width = cand_rows.shape[1]
    if rescore_rows is not None and rescore_rows < width:
        # fewer than k_req rescored rows could certify an incomplete set
        rescore_rows = max(rescore_rows, k_req)
        if rescore_rows < width:
            # the bound over un-rescored explicit candidates joins the
            # certificate threshold: none of them can beat it
            v_idx, thr_exp = _topk_select(cand_vals, rescore_rows)
            threshold = torch.maximum(threshold, thr_exp)
            cand_rows = torch.gather(cand_rows, 1, v_idx)
    cand_rows, _ = torch.sort(cand_rows, dim=1)  # row-asc tie order
    # defensive dedup: a repeated candidate row must not occupy two
    # top-k slots — sentinel the repeat, which rescores as (-inf, -1)
    dup = torch.cat(
        [torch.zeros_like(cand_rows[:, :1], dtype=torch.bool), cand_rows[:, 1:] == cand_rows[:, :-1]],
        dim=1,
    )
    slot_w = torch.arange(cand_rows.shape[1], device=cand_rows.device, dtype=cand_rows.dtype)
    cand_rows = torch.where(dup, _ROW_SENTINEL + slot_w, cand_rows)

    # -- exact rescore of the candidates (the exact path's arithmetic) -----
    safe_rows = torch.clamp(cand_rows, max=n - 1).long()
    q_p = q if bsz == b_pad else torch.nn.functional.pad(q, (0, 0, 0, b_pad - bsz))
    exact = exact_scores(q_p, matrix, safe_rows)  # [B, W]
    live = (cand_rows < n) & valid_mask[safe_rows]
    exact = torch.where(live, exact, NEG_INF)
    k = min(k_req, cand_rows.shape[1])
    top_s, idx = topk_desc(exact, k)
    top_r = torch.gather(cand_rows, 1, idx).to(torch.int32)
    top_r = torch.where(torch.isneginf(top_s), -1, top_r)
    top_s, top_r = _pad_k(top_s, top_r, k_req)

    # -- verify: k-th exact must STRICTLY beat every excluded upper -------
    kth = top_s[:, k - 1]
    per_q = (kth > threshold) | torch.isneginf(threshold)
    if k < k_req:
        # short candidate width: certify only when no row was excluded
        # anywhere (the short result is then the complete valid set)
        per_q = per_q & torch.isneginf(threshold)
    return top_s[:bsz], top_r[:bsz], per_q[:bsz]


def _metric_queries(queries, metric, kinds=("cosine", "dot")):
    if metric == "cosine":
        return normalize_queries(queries)
    if metric == "dot":
        return queries
    raise InvalidConfigError(f"tiered scan supports {'/'.join(kinds)}, got {metric!r}")


def _tile_candidates(outs, b_pad, k, margin_tiles, t_top):
    """Tile selection over the packed scan outputs → (cand_rows,
    cand_vals, threshold). ``outs`` = (v_pack [B_pad, T+1, G'], r_pack
    [B_pad, T, G']); rows are already global."""
    v_pack, r_pack = outs
    g = v_pack.shape[2]
    kb = min(k + margin_tiles, g)
    t_idx, thr_out = _topk_select(v_pack[:, 0, :], kb)
    t_idx, _ = torch.sort(t_idx, dim=1)
    vg = torch.gather(v_pack, 2, t_idx[:, None, :].expand(b_pad, t_top + 1, kb))
    rg = torch.gather(r_pack, 2, t_idx[:, None, :].expand(b_pad, t_top, kb))
    thr_in = vg[:, t_top, :].amax(dim=1)
    threshold = torch.maximum(thr_out, thr_in)

    cand_vals = vg[:, :t_top, :].reshape(b_pad, t_top * kb)
    cand_rows = rg.reshape(b_pad, t_top * kb)
    slot = torch.arange(t_top * kb, device=cand_rows.device, dtype=cand_rows.dtype)
    cand_rows = torch.where(torch.isneginf(cand_vals), _ROW_SENTINEL + slot, cand_rows)
    return cand_rows, cand_vals, threshold


def _select_rescore_verify_tiles(
    outs, q, matrix, valid_mask, n, bsz, b_pad, k, margin_tiles,
    rescore_rows, t_top,
):
    """Tile selection + exact fp32 rescore + strict-beat certificate."""
    cand_rows, cand_vals, threshold = _tile_candidates(outs, b_pad, k, margin_tiles, t_top)
    return _trim_rescore_verify(
        cand_rows, cand_vals, threshold, q, matrix, valid_mask, n, bsz,
        b_pad, k, rescore_rows,
    )


def dense_topk_tiered2(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    m_bf16: torch.Tensor,  # [N, d] bf16 scan copy
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    rescore_rows: int | None = 96,
    t_top: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified bf16 tile scan → (scores [B,k], rows [B,k], certified
    [B] bool). Where ``certified[i]`` holds, query i's result is provably
    the exact fp32 top-k in (score desc, row asc) order. The corpus pads
    to a multiple of ``tile_n`` rows and the batch to a multiple of 8,
    as in the JAX package."""
    q = _metric_queries(queries, metric)
    n = matrix.shape[0]
    bsz = q.shape[0]
    qb, u_q, v_q = _bf16_query_bounds(q)

    b_pad = max(8, -(-bsz // 8) * 8)
    tile = max(tile_n, SEL)
    n_pad = max(-(-n // tile) * tile, tile)
    pad = torch.nn.functional.pad
    if b_pad != bsz:
        qb = pad(qb, (0, 0, 0, b_pad - bsz))
        u_q = pad(u_q, (0, b_pad - bsz))
        v_q = pad(v_q, (0, b_pad - bsz))
    valid_p = valid_mask
    if n_pad != n:
        m_bf16 = pad(m_bf16, (0, 0, 0, n_pad - n))
        e_l2 = pad(e_l2, (0, n_pad - n))
        a_l2 = pad(a_l2, (0, n_pad - n))
        valid_p = pad(valid_mask, (0, n_pad - n), value=False)

    outs = scan_select_v3(
        qb.contiguous(), m_bf16, e_l2, a_l2, valid_p.to(torch.int32),
        u_q.contiguous(), v_q.contiguous(), t_top=t_top,
    )
    return _select_rescore_verify_tiles(
        outs, q, matrix, valid_mask, n, bsz, b_pad, k, margin_tiles,
        rescore_rows, t_top,
    )


def dense_topk_tiered2_checked(
    queries, matrix, m_bf16, e_l2, a_l2, valid_mask, k,
    margin_tiles=32, metric="cosine", tile_n=2048, rescore_rows=96, t_top=4,
):
    """Exactness-contract wrapper: uncertified queries re-run on the fp32
    path. Returns (scores, rows, n_fallback) — the number of queries
    that fell back (0 when every query certified)."""
    s, r, ok = dense_topk_tiered2(
        queries, matrix, m_bf16, e_l2, a_l2, valid_mask, k,
        margin_tiles=margin_tiles, metric=metric, tile_n=tile_n,
        rescore_rows=rescore_rows, t_top=t_top,
    )
    return _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric)


def _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric):
    """Re-run ONLY uncertified queries on the exact fp32 path and patch
    their rows in. Returns (scores, rows, number of re-run queries)."""
    bad = torch.nonzero(~ok).flatten()
    if bad.numel() == 0:
        return s, r, 0
    fb_s, fb_r = dense_topk(queries[bad], matrix, valid_mask, min(k, matrix.shape[0]), metric)
    fb_s, fb_r = _pad_k(fb_s, fb_r, k)
    s = s.clone()
    r = r.clone()
    s[bad] = fb_s
    r[bad] = fb_r
    return s, r, int(bad.numel())
