"""Tiered dense top-k: a quantized tile scan + a verified rescore — exact
results without the full fp32 scan.

PyTorch counterpart of ``trueno_rag_tpu/ops/dense_tiered.py``. One pass
over a quantized replica of the corpus emits, per 1024-row tile, a few
candidate rows with rigorous upper bounds on their true scores plus a
bound on every other row of the tile
(:mod:`~trueno_rag_tpu_torch.ops.kernels.scan_select`: the bf16 kernel
``scan_select_v3`` or the int8 kernel ``scan_select_int8_v3``) — or, on
the block tiers (:func:`dense_topk_tiered`, :func:`dense_topk_int8`), per
128-row block the top rows by per-row bound and a bound on the rest
(:mod:`~trueno_rag_tpu_torch.ops.kernels.scan_select_v1`);
exactness is recovered with interval arithmetic:

1. **Bound**: with M = A + E (A = the dequantized row) and q = b + f,
   |m·q − a·b| ≤ ‖E_i‖‖b‖ + ‖A_i‖‖f‖ + ‖E_i‖‖f‖ plus an accumulation
   term and a safety factor — two rank-1 coefficients.
2. **Select**: the top-(k+margin) tiles by their best upper bound; the
   exclusion threshold is the larger of the best unselected tile bound
   and the selected tiles' own thresholds.
3. **Rescore**: the best ``rescore_rows`` candidates rescore with
   :func:`~trueno_rag_tpu_torch.ops.dense.exact_scores` — the exact
   path's own arithmetic — ordered (score desc, row asc).
4. **Verify**: certified iff the k-th exact score STRICTLY beats the
   threshold. The ``_checked`` wrappers re-run uncertified queries on the
   exact fp32 path — results are ALWAYS exact.

The **compact** tiers (:func:`dense_topk_compact_bf16r` and siblings)
keep no fp32 matrix on the device. Their certificate is about the top-k
row SET by true scores: the rescore reads the bf16 copy (plus int8
residual corrections in the bf16r/bf16rr layouts), each candidate
carries an interval, and the set certifies when every selected lower
bound beats every excluded upper bound. Uncertified queries are flagged
for the store's host patch.

``tags=(tag_bits [N], t_all [B], t_any [B], t_none [B])`` (int32) masks
disallowed (row, query) pairs inside the scan kernel, so a certified
result is exact among the rows passing each query's filter.

Selection is an exact top-k with the count-trick threshold of the JAX
code's ``approx_select=True`` path, or with ``approx_select=False`` the
(k+1)-th value; both stay fail-closed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import (
    NEG_INF, _pad_k, dense_topk, exact_scores, normalize_queries, require_fp32, topk_desc,
)
from trueno_rag_tpu_torch.ops.kernels.scan_select import SEL, scan_select_int8_v3, scan_select_v3
from trueno_rag_tpu_torch.ops.kernels.scan_select_v1 import BLOCK, TOP, scan_select, scan_select_int8
from trueno_rag_tpu_torch.ops.tags import dense_topk_tagged, tag_pred
from trueno_rag_tpu_torch.utils import profiling

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


def _quantize_rows(x: torch.Tensor, clip: bool, fused: bool = True):
    """Tightest symmetric int8 quantization per row (scale amax/127, 1
    for an all-zero row) → (codes int8, scale f32, rest f32) with
    rest = x − codes·scale, in the arithmetic the JAX package's version
    runs, so both store the same codes and scales. Under ``jax.jit``
    (``fused``) XLA compiles ``amax / 127.0`` to ``amax · f32(1/127)``
    and fuses the multiply-subtract, rounding it once (here: product and
    difference are exact in float64, then one rounding to f32); op by op
    it divides and rounds the product and the difference separately."""
    amax = torch.amax(torch.abs(x), dim=1)
    scale = torch.where(amax > 0.0, amax * (1.0 / 127.0) if fused else amax / 127.0, 1.0)
    codes = torch.round(x / scale[:, None])
    if clip:
        codes = torch.clamp(codes, -127, 127)
    codes = codes.to(torch.int8)
    if fused:
        rest = (x.double() - codes.double() * scale.double()[:, None]).float()
    else:
        rest = x - codes.float() * scale[:, None]
    return codes, scale, rest


def _row_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=1))


def prepare_int8(matrix: torch.Tensor):
    """Pack the int8 scan tier → ``(m_i8 [N,d] int8, s_row [N] f32,
    e_l2 [N] f32, a_l2 [N] f32)``: ``s_row = amax/127`` per-row scales,
    ``e_l2 = ‖M_i − s_i·m_i8_i‖₂`` and ``a_l2 = ‖s_i·m_i8_i‖₂``."""
    m_i8, s, rest = _quantize_rows(matrix, clip=True)
    return m_i8, s, _row_norm(rest), _row_norm(m_i8.float() * s[:, None])


def prepare_residual(matrix: torch.Tensor):
    """Pack the int8 residual correction of the bf16r compact layout →
    (r_i8 [N,d] int8, r_scale [N] f32, e2_l2 [N] f32): the bf16 residual
    E_i = M_i − bf16(M_i) quantized with the tightest symmetric scale,
    and e2_l2 = ‖E_i − scale_i·r_i8_i‖₂, the rescore interval's
    half-width per unit query."""
    e = matrix - matrix.to(torch.bfloat16).float()
    r_i8, scale, e2 = _quantize_rows(e, clip=False)
    return r_i8, scale, _row_norm(e2)


def prepare_residual2(matrix: torch.Tensor):
    """Pack both int8 residual levels of the bf16rr compact layout →
    (r_i8, r_scale, e2_l2, r2_i8, r2_scale, e3_l2): level 1 quantizes
    E = M − bf16(M) as :func:`prepare_residual` does; level 2 quantizes
    what level 1 left, E₂ = E − s₁·r₁, with its own tightest symmetric
    scale. One function, so the two levels are consistent by
    construction. The JAX package runs this one op by op (not jitted),
    so its arithmetic is the unfused one."""
    e = matrix - matrix.to(torch.bfloat16).float()
    r1, s1, e2 = _quantize_rows(e, clip=False, fused=False)
    r2, s2, e3 = _quantize_rows(e2, clip=False, fused=False)
    return r1, s1, _row_norm(e2), r2, s2, _row_norm(e3)


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


def _int8_query_bounds(q: torch.Tensor):
    """Quantize the query batch (tightest symmetric amax/127) and build
    the rank-1 bound coefficients of the int8 error model → (q_i8, t_q,
    u_q, v_q): the integer dot is exact, so the bound carries the row
    residual (e_l2·u_q), the query residual against the dequantized rows
    (a_l2·v_q) and the ~2⁻²⁴ scale-multiply rounding folded into v_q.
    CERTIFICATE-CRITICAL — same math as the JAX package's
    ``_int8_query_bounds``."""
    q_i8, t_q, f = _quantize_rows(q, clip=True)
    b_l2 = torch.linalg.vector_norm(q_i8.float() * t_q[:, None], dim=1)
    f_l2 = torch.linalg.vector_norm(f, dim=1)
    u_q = (b_l2 + f_l2) * _BOUND_SLACK + _BOUND_EPS
    v_q = (f_l2 + 4e-7 * b_l2) * _BOUND_SLACK + _BOUND_EPS
    return q_i8, t_q, u_q, v_q


def _topk_select(values: torch.Tensor, k: int, approx: bool = True):
    """Select top-k indices of ``values [B, G]`` plus a RIGOROUS per-row
    upper bound on every non-selected entry. ``approx=True`` is the JAX
    code's ``approx_select`` path, with its scatter-free count trick: with
    vmin = min(selected), if EXACTLY k entries are >= vmin the selected set
    IS {v >= vmin} and the bound is max(v < vmin); a tie at the boundary
    fails closed via a +inf threshold. ``approx=False`` bounds the rest by
    the (k+1)-th value (-inf when nothing is left out), which stays sound
    across a boundary of -inf entries."""
    vals, idx = topk_desc(values, k + 1 if not approx else k)
    if not approx:
        if vals.shape[1] > k:
            return idx[:, :k], vals[:, k]
        return idx, torch.full(values.shape[:1], NEG_INF, device=values.device)
    vmin = vals.amin(dim=1)
    ge = values >= vmin[:, None]
    count = ge.sum(dim=1)
    thr_exact = torch.where(ge, NEG_INF, values).amax(dim=1)
    return idx, torch.where(count == k, thr_exact, float("inf"))


def _pad_to(x: torch.Tensor, size: int, value=0) -> torch.Tensor:
    """``x`` padded along its first axis to ``size`` entries."""
    extra = size - x.shape[0]
    if extra == 0:
        return x
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, extra), value=value)


def _padded_sizes(bsz: int, n: int, tile: int):
    """The kernels' padding, as in the JAX package: the batch to a multiple
    of 8, the corpus to a multiple of ``tile`` rows (at least one tile)."""
    return max(8, -(-bsz // 8) * 8), max(-(-n // tile) * tile, tile)


def _pad_tags(tags, n_pad: int, b_pad: int):
    """Pad the tag-filter arrays to the kernel's row/batch padding:
    padded rows get tag word 0 (they are invalid anyway), padded queries
    get all-zero filter words (unconstrained)."""
    if tags is None:
        return None
    tag_bits, t_all, t_any, t_none = (t.to(torch.int32).contiguous() for t in tags)
    return (_pad_to(tag_bits, n_pad), _pad_to(t_all, b_pad), _pad_to(t_any, b_pad),
            _pad_to(t_none, b_pad))


def _tags_live(tags, safe_rows, b_pad: int) -> torch.Tensor:
    """Fail-closed re-check of the filter on gathered candidate rows (the
    scan kernel already masked disallowed rows): ``[B_pad, W]`` bool."""
    tag_bits, t_all, t_any, t_none = (t.to(torch.int32) for t in tags)
    t_all, t_any, t_none = (_pad_to(t, b_pad) for t in (t_all, t_any, t_none))
    return tag_pred(tag_bits[safe_rows], t_all[:, None], t_any[:, None], t_none[:, None])


def _scan_bf16(q, m_bf16, e_l2, a_l2, valid_mask, tile_n, t_top, tags):
    """Bound coefficients, padding and the bf16 scan (K1) → (packs, b_pad).
    ``m_bf16`` may be the f32 matrix itself (the inline-cast layout: K1
    rounds it to bf16 as it reads it)."""
    b_pad, n_pad = _padded_sizes(q.shape[0], m_bf16.shape[0], max(tile_n, SEL))
    qb, u_q, v_q = _bf16_query_bounds(q)
    outs = scan_select_v3(
        _pad_to(qb, b_pad).contiguous(), _pad_to(m_bf16, n_pad), _pad_to(e_l2, n_pad),
        _pad_to(a_l2, n_pad), _pad_to(valid_mask, n_pad, False).to(torch.int32),
        _pad_to(u_q, b_pad).contiguous(), _pad_to(v_q, b_pad).contiguous(),
        t_top=t_top, tags=_pad_tags(tags, n_pad, b_pad),
    )
    return outs, b_pad


def _scan_int8(q, m_i8, s_row, e_l2, a_l2, valid_mask, tile_n, t_top, tags):
    """Bound coefficients, padding and the int8 scan (K3) → (packs, b_pad).
    Padded rows and queries get scale 1, as in the JAX package."""
    b_pad, n_pad = _padded_sizes(q.shape[0], m_i8.shape[0], max(tile_n, SEL))
    q_i8, t_q, u_q, v_q = _int8_query_bounds(q)
    outs = scan_select_int8_v3(
        _pad_to(q_i8, b_pad).contiguous(), _pad_to(m_i8, n_pad), _pad_to(s_row, n_pad, 1.0),
        _pad_to(e_l2, n_pad), _pad_to(a_l2, n_pad),
        _pad_to(valid_mask, n_pad, False).to(torch.int32),
        _pad_to(t_q, b_pad, 1.0).contiguous(), _pad_to(u_q, b_pad).contiguous(),
        _pad_to(v_q, b_pad).contiguous(), t_top=t_top, tags=_pad_tags(tags, n_pad, b_pad),
    )
    return outs, b_pad


def _trim_and_dedup(cand_rows, cand_vals, threshold, k_req, rescore_rows, approx_select=True):
    """Optional trim of the explicit candidate set to its best
    ``rescore_rows`` (the bound over the rest joins the threshold), then
    row-asc order with repeated rows sentinelled → (cand_rows, threshold)."""
    width = cand_rows.shape[1]
    if rescore_rows is not None and rescore_rows < width:
        # fewer than k_req rescored rows could certify an incomplete set
        rescore_rows = max(rescore_rows, k_req)
        if rescore_rows < width:
            # the bound over un-rescored explicit candidates joins the
            # certificate threshold: none of them can beat it
            v_idx, thr_exp = _topk_select(cand_vals, rescore_rows, approx_select)
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
    return torch.where(dup, _ROW_SENTINEL + slot_w, cand_rows), threshold


def _trim_rescore_verify(
    cand_rows, cand_vals, threshold, q, matrix, valid_mask, n, bsz, b_pad,
    k_req, rescore_rows, tags=None, approx_select=True,
):
    """Certificate tail: optional trim of the explicit candidate set,
    exact fp32 rescore, deterministic (score desc, row asc) top-k and
    the strict-beat verification. ``cand_rows`` must already map -inf
    candidates to distinct ``_ROW_SENTINEL`` slots."""
    cand_rows, threshold = _trim_and_dedup(
        cand_rows, cand_vals, threshold, k_req, rescore_rows, approx_select
    )

    # -- exact rescore of the candidates (the exact path's arithmetic) -----
    safe_rows = torch.clamp(cand_rows, max=n - 1).long()
    exact = exact_scores(_pad_to(q, b_pad), matrix, safe_rows)  # [B, W]
    live = (cand_rows < n) & valid_mask[safe_rows]
    if tags is not None:
        live = live & _tags_live(tags, safe_rows, b_pad)
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


def _tile_candidates(outs, b_pad, k, margin_tiles, t_top, approx_select=True):
    """Tile selection over the packed scan outputs → (cand_rows,
    cand_vals, threshold). ``outs`` = (v_pack [B_pad, T+1, G'], r_pack
    [B_pad, T, G']); rows are already global."""
    v_pack, r_pack = outs
    g = v_pack.shape[2]
    kb = min(k + margin_tiles, g)
    t_idx, thr_out = _topk_select(v_pack[:, 0, :], kb, approx_select)
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
    rescore_rows, t_top, tags=None, approx_select=True,
):
    """Tile selection + exact fp32 rescore + strict-beat certificate."""
    cand_rows, cand_vals, threshold = _tile_candidates(
        outs, b_pad, k, margin_tiles, t_top, approx_select
    )
    return _trim_rescore_verify(
        cand_rows, cand_vals, threshold, q, matrix, valid_mask, n, bsz,
        b_pad, k, rescore_rows, tags=tags, approx_select=approx_select,
    )


def dense_topk_tiered2(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    m_bf16: Optional[torch.Tensor],  # [N, d] bf16 scan copy; None = inline-cast layout
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    rescore_rows: int | None = 96,
    approx_select: bool = True,
    t_top: int = 4,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified bf16 tile scan → (scores [B,k], rows [B,k], certified
    [B] bool). Where ``certified[i]`` holds, query i's result is provably
    the exact fp32 top-k in (score desc, row asc) order — among the rows
    passing its filter when ``tags`` is given. The corpus pads to a
    multiple of ``tile_n`` rows and the batch to a multiple of 8, as in
    the JAX package.

    ``m_bf16=None`` is the inline-cast layout: the scan reads ``matrix``
    itself and rounds it to bf16 as it stages it, the same
    round-to-nearest-even as :func:`prepare_tiered`, so results and
    certificates are identical to the replica layout's; no bf16 copy is
    kept, and the scan streams twice the bytes. ``e_l2``/``a_l2`` are
    still :func:`prepare_tiered`'s. ``approx_select`` picks the
    selection threshold of :func:`_topk_select`."""
    q = _metric_queries(queries, metric)
    scan_m = matrix if m_bf16 is None else m_bf16
    outs, b_pad = _scan_bf16(q, scan_m, e_l2, a_l2, valid_mask, tile_n, t_top, tags)
    return _select_rescore_verify_tiles(
        outs, q, matrix, valid_mask, matrix.shape[0], q.shape[0], b_pad, k, margin_tiles,
        rescore_rows, t_top, tags=tags, approx_select=approx_select,
    )


def dense_topk_tiered2_checked(
    queries, matrix, m_bf16, e_l2, a_l2, valid_mask, k,
    margin_tiles=32, metric="cosine", tile_n=2048, rescore_rows=96, approx_select=True,
    t_top=4, tags=None,
):
    """Exactness-contract wrapper: uncertified queries re-run on the fp32
    path (the tag-filtered fp32 scan when ``tags`` is given). Returns
    (scores, rows, n_fallback) — the number of queries that fell back (0
    when every query certified). ``m_bf16=None``: the inline-cast layout."""
    s, r, ok = dense_topk_tiered2(
        queries, matrix, m_bf16, e_l2, a_l2, valid_mask, k,
        margin_tiles=margin_tiles, metric=metric, tile_n=tile_n,
        rescore_rows=rescore_rows, approx_select=approx_select, t_top=t_top, tags=tags,
    )
    return _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric, tags=tags)


def _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric, tags=None):
    """Re-run ONLY uncertified queries on the exact fp32 path (the tagged
    fp32 scan when ``tags`` is given) and patch their rows in. Returns
    (scores, rows, number of re-run queries)."""
    with profiling.span("rag.scan.wait"):
        bad = torch.nonzero(~ok).flatten()
    if bad.numel() == 0:
        return s, r, 0
    with profiling.span("rag.scan.fallback") as sp:
        if sp is not None:
            sp.attrs["queries"] = int(bad.numel())
        k_eff = min(k, matrix.shape[0])
        if tags is not None:
            tag_bits, t_all, t_any, t_none = (t.to(torch.int32) for t in tags)
            fb_s, fb_r = dense_topk_tagged(
                queries[bad], matrix, valid_mask, tag_bits, t_all[bad], t_any[bad], t_none[bad],
                k_eff, metric,
            )
        else:
            fb_s, fb_r = dense_topk(queries[bad], matrix, valid_mask, k_eff, metric)
        fb_s, fb_r = _pad_k(fb_s, fb_r, k)
        s = s.clone()
        r = r.clone()
        s[bad] = fb_s
        r[bad] = fb_r
        return s, r, int(bad.numel())


# ---------------------------------------------------------------------------
# Block-kernel tiers (scan_kernel="block"): the scan emits, per 128-row
# block, the top+1 per-row upper bounds and the top lanes (K8 bf16, K9
# int8); the tail selects blocks, not tiles.
# ---------------------------------------------------------------------------


def _select_rescore_verify(
    outs, q, matrix, valid_mask, bsz, b_pad, k, margin_blocks, rescore_rows,
    approx_select=True, top=TOP,
):
    """The block tiers' tail: block selection by v1, exact fp32 rescore of
    the selected blocks' top ``top`` rows and the strict-beat certificate.
    ``outs`` = (v1..v_{top+1}, i1..i_top) [B_pad, G] from K8 or K9; ``q`` is
    the f32 query batch (metric applied), unpadded [bsz, d]. Every row is
    covered by one bound: an unselected block → its v1 ≤ thr_out; an
    unseen row of a selected block → its v_{top+1} ≤ thr_in; a candidate
    the trim drops → the trim's own bound (:func:`_trim_and_dedup`)."""
    v_top, i_top = outs[: top + 1], outs[top + 1 :]
    g = v_top[0].shape[1]

    # -- block selection by v1 -------------------------------------------
    kb = min(k + margin_blocks, g)
    b_idx, thr_out = _topk_select(v_top[0], kb, approx_select)
    b_idx, _ = torch.sort(b_idx, dim=1)
    thr_in = torch.gather(v_top[top], 1, b_idx).amax(dim=1)  # unseen rows of selected blocks
    threshold = torch.maximum(thr_out, thr_in)

    # -- candidates: the top rows of each selected block -------------------
    slot = torch.arange(kb, device=b_idx.device) * top
    rows, vals = [], []
    for t in range(top):
        v_t = torch.gather(v_top[t], 1, b_idx)
        r_t = b_idx * BLOCK + torch.gather(i_top[t], 1, b_idx)
        rows.append(torch.where(torch.isneginf(v_t), _ROW_SENTINEL + slot + t, r_t))
        vals.append(v_t)
    cand_rows = torch.cat(rows, dim=1).to(torch.int32)  # [B_pad, top·kb]
    cand_vals = torch.cat(vals, dim=1)
    return _trim_rescore_verify(
        cand_rows, cand_vals, threshold, q, matrix, valid_mask, matrix.shape[0], bsz,
        b_pad, k, rescore_rows, approx_select=approx_select,
    )


def dense_topk_tiered(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    m_bf16: torch.Tensor,  # [N, d] bf16 scan copy
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_blocks: int = 64,
    metric: str = "cosine",
    tile_n: int = 1024,
    rescore_rows: int | None = None,
    approx_select: bool = True,
    block_top: int = TOP,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified bf16 block scan (K8) + exact fp32 rescore → (scores [B,k],
    rows [B,k], certified [B] bool), the counterpart of the JAX package's
    ``dense_topk_tiered``. Where ``certified[i]`` holds, query i's result is
    provably the exact fp32 top-k in (score desc, row asc) order. The
    corpus pads to a multiple of ``tile_n`` (a multiple of 128) rows."""
    q = _metric_queries(queries, metric)
    n = matrix.shape[0]
    b_pad, n_pad = _padded_sizes(q.shape[0], n, tile_n)
    qb, u_q, v_q = _bf16_query_bounds(q)
    outs = scan_select(
        _pad_to(qb, b_pad).contiguous(), _pad_to(m_bf16, n_pad), _pad_to(e_l2, n_pad),
        _pad_to(a_l2, n_pad), _pad_to(valid_mask, n_pad, False).to(torch.int32),
        _pad_to(u_q, b_pad).contiguous(), _pad_to(v_q, b_pad).contiguous(),
        tile_n=tile_n, top=block_top,
    )
    return _select_rescore_verify(
        outs, q, matrix, valid_mask, q.shape[0], b_pad, k, margin_blocks, rescore_rows,
        approx_select, block_top,
    )


def dense_topk_tiered_checked(
    queries, matrix, m_bf16, e_l2, a_l2, valid_mask, k,
    margin_blocks=64, metric="cosine", tile_n=1024, rescore_rows=None,
    approx_select=True, block_top=TOP,
):
    """Exactness-contract wrapper of :func:`dense_topk_tiered`: uncertified
    queries re-run on the fp32 path. Returns (scores, rows, n_fallback)."""
    s, r, ok = dense_topk_tiered(
        queries, matrix, m_bf16, e_l2, a_l2, valid_mask, k,
        margin_blocks=margin_blocks, metric=metric, tile_n=tile_n,
        rescore_rows=rescore_rows, approx_select=approx_select, block_top=block_top,
    )
    return _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric)


def dense_topk_int8(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    m_i8: torch.Tensor,  # [N, d] int8 scan copy (prepare_int8)
    s_row: torch.Tensor,  # [N] f32 row scales
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_blocks: int = 64,
    metric: str = "cosine",
    tile_n: int = 1024,
    use_int8_mxu: bool = True,
    rescore_rows: int | None = None,
    approx_select: bool = True,
    block_top: int = TOP,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 block scan (K9) + exact fp32 rescore — the int8 sibling of
    :func:`dense_topk_tiered`, same contract; counterpart of the JAX
    package's ``dense_topk_int8``. ``use_int8_mxu`` has no effect (see
    :func:`~trueno_rag_tpu_torch.ops.kernels.scan_select_v1.scan_select_int8`).
    Padded rows and queries get scale 1, as in the JAX package."""
    del use_int8_mxu
    q = _metric_queries(queries, metric)
    n = matrix.shape[0]
    b_pad, n_pad = _padded_sizes(q.shape[0], n, tile_n)
    q_i8, t_q, u_q, v_q = _int8_query_bounds(q)
    outs = scan_select_int8(
        _pad_to(q_i8, b_pad).contiguous(), _pad_to(m_i8, n_pad), _pad_to(s_row, n_pad, 1.0),
        _pad_to(e_l2, n_pad), _pad_to(a_l2, n_pad),
        _pad_to(valid_mask, n_pad, False).to(torch.int32),
        _pad_to(t_q, b_pad, 1.0).contiguous(), _pad_to(u_q, b_pad).contiguous(),
        _pad_to(v_q, b_pad).contiguous(), tile_n=tile_n, top=block_top,
    )
    return _select_rescore_verify(
        outs, q, matrix, valid_mask, q.shape[0], b_pad, k, margin_blocks, rescore_rows,
        approx_select, block_top,
    )


def dense_topk_int8_checked(
    queries, matrix, m_i8, s_row, e_l2, a_l2, valid_mask, k,
    margin_blocks=64, metric="cosine", tile_n=1024, use_int8_mxu=True,
    rescore_rows=None, approx_select=True, block_top=TOP,
):
    """Exactness-contract wrapper of :func:`dense_topk_int8`: uncertified
    queries re-run on the fp32 path. Returns (scores, rows, n_fallback)."""
    s, r, ok = dense_topk_int8(
        queries, matrix, m_i8, s_row, e_l2, a_l2, valid_mask, k,
        margin_blocks=margin_blocks, metric=metric, tile_n=tile_n,
        use_int8_mxu=use_int8_mxu, rescore_rows=rescore_rows,
        approx_select=approx_select, block_top=block_top,
    )
    return _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric)


# ---------------------------------------------------------------------------
# int8 tier: half the scan bytes of bf16, with an exact integer dot. The
# bound carries the per-row quantization residual plus a ~2⁻²⁴-relative
# term for the two f32 scale multiplies.
# ---------------------------------------------------------------------------


def dense_topk_int8_tiered2(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    m_i8: torch.Tensor,  # [N, d] int8 scan copy (prepare_int8)
    s_row: torch.Tensor,  # [N] f32 row scales
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    use_int8_mxu: bool = True,
    rescore_rows: int | None = 96,
    approx_select: bool = True,
    t_top: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 scan (K3) + exact fp32 rescore — the int8 sibling of
    :func:`dense_topk_tiered2`, same exactness contract → (scores [B,k],
    rows [B,k], certified [B] bool). ``use_int8_mxu`` is ignored (see
    :func:`~trueno_rag_tpu_torch.ops.kernels.scan_select.scan_select_int8_v3`)."""
    del use_int8_mxu
    q = _metric_queries(queries, metric)
    outs, b_pad = _scan_int8(q, m_i8, s_row, e_l2, a_l2, valid_mask, tile_n, t_top, None)
    return _select_rescore_verify_tiles(
        outs, q, matrix, valid_mask, matrix.shape[0], q.shape[0], b_pad, k, margin_tiles,
        rescore_rows, t_top, approx_select=approx_select,
    )


def dense_topk_int8_tiered2_checked(
    queries, matrix, m_i8, s_row, e_l2, a_l2, valid_mask, k,
    margin_tiles=32, metric="cosine", tile_n=2048, use_int8_mxu=True,
    rescore_rows=96, approx_select=True, t_top=4,
):
    """Exactness-contract wrapper for the int8 tier: uncertified queries
    re-run on the fp32 path. Returns (scores, rows, n_fallback)."""
    s, r, ok = dense_topk_int8_tiered2(
        queries, matrix, m_i8, s_row, e_l2, a_l2, valid_mask, k,
        margin_tiles=margin_tiles, metric=metric, tile_n=tile_n, use_int8_mxu=use_int8_mxu,
        rescore_rows=rescore_rows, approx_select=approx_select, t_top=t_top,
    )
    return _checked_fallback(s, r, ok, queries, matrix, valid_mask, k, metric)


# ---------------------------------------------------------------------------
# Compact tiers: certified top-k SETS with no fp32 matrix on the device.
#
# The returned top-k ROW SET is provably the exact top-k set by TRUE
# (real-arithmetic) scores (interval certificate, fail-closed flag);
# scores, and the order within the set, come from the rescore of the
# stored copy. Layouts:
# - bf16r (default): bf16 scan+rescore copy + int8 residual correction,
#   3 B/element; rescore interval ~e2_l2;
# - bf16rr: two int8 residual levels, 4 B/element; interval ~e3_l2 plus
#   the pairwise tree's rounding;
# - bf16: one bf16 array, 2 B/element; interval ~e_l2;
# - int8: int8 scan copy (K3) + bf16 rescore copy, 3 B/element; interval
#   ~e_l2.
# ---------------------------------------------------------------------------


def dense_topk_compact_bf16rr(
    queries: torch.Tensor,  # [B, d] f32
    m_bf16: torch.Tensor,  # [N, d] bf16 scan+rescore copy (prepare_tiered)
    e_l2: torch.Tensor,  # [N] f32
    a_l2: torch.Tensor,  # [N] f32
    r_i8: torch.Tensor,  # [N, d] int8 level-1 residual
    r_scale: torch.Tensor,  # [N] f32
    e2_l2: torch.Tensor,  # [N] f32
    r2_i8: torch.Tensor,  # [N, d] int8 level-2 residual (prepare_residual2)
    r2_scale: torch.Tensor,  # [N] f32
    e3_l2: torch.Tensor,  # [N] f32 — ‖E − s₁r₁ − s₂r₂‖₂
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    rescore_rows: int | None = 96,
    t_top: int = 4,
    return_bounds: bool = False,
    return_candidates: bool = False,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
):
    """Compact tier with TWO int8 residual levels (4 B/element): the scan
    is :func:`dense_topk_compact_bf16r`'s; the candidate rescore adds the
    second correction dot, so the interval shrinks to ~e3_l2 plus the
    tree rounding. Outputs as :func:`dense_topk_compact_bf16r`."""
    q = _metric_queries(queries, metric)
    outs, b_pad = _scan_bf16(q, m_bf16, e_l2, a_l2, valid_mask, tile_n, t_top, tags)
    cand_rows, cand_vals, threshold = _tile_candidates(outs, b_pad, k, margin_tiles, t_top)
    return _trim_rescore_verify_compact(
        cand_rows, cand_vals, threshold, q, m_bf16, e_l2, a_l2, valid_mask,
        m_bf16.shape[0], q.shape[0], b_pad, k, rescore_rows,
        residual=(r_i8, r_scale, e2_l2), residual2=(r2_i8, r2_scale, e3_l2),
        return_bounds=return_bounds, tags=tags, return_candidates=return_candidates,
    )


def dense_topk_compact_bf16r(
    queries: torch.Tensor,  # [B, d] f32
    m_bf16: torch.Tensor,  # [N, d] bf16 scan+rescore copy (prepare_tiered)
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    r_i8: torch.Tensor,  # [N, d] int8 residual correction (prepare_residual)
    r_scale: torch.Tensor,  # [N] f32
    e2_l2: torch.Tensor,  # [N] f32 — ‖residual − correction‖₂
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    rescore_rows: int | None = 96,
    t_top: int = 4,
    return_bounds: bool = False,
    return_candidates: bool = False,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
):
    """Compact tier with int8 residual correction (3 B/element) →
    (scores [B,k] residual-corrected, rows [B,k], set_certified [B] bool).

    ``return_bounds=True`` appends the per-candidate interval half-widths
    ``err [B,k]`` and the exclusion upper bound ``rhs [B]`` (the largest
    TRUE score any non-returned row could have; +inf when a local failure
    mode fired). ``return_candidates=True`` appends the pre-trim
    candidate rows ``cand [B, W]`` (entries >= N are sentinels) and the
    tile-level exclusion bound ``thr [B]``, a sound upper bound on the
    TRUE score of every row outside ``cand`` — the containment
    certificate the store's host patch uses."""
    q = _metric_queries(queries, metric)
    outs, b_pad = _scan_bf16(q, m_bf16, e_l2, a_l2, valid_mask, tile_n, t_top, tags)
    cand_rows, cand_vals, threshold = _tile_candidates(outs, b_pad, k, margin_tiles, t_top)
    return _trim_rescore_verify_compact(
        cand_rows, cand_vals, threshold, q, m_bf16, e_l2, a_l2, valid_mask,
        m_bf16.shape[0], q.shape[0], b_pad, k, rescore_rows,
        residual=(r_i8, r_scale, e2_l2), return_bounds=return_bounds,
        tags=tags, return_candidates=return_candidates,
    )


def dense_topk_compact_bf16(
    queries: torch.Tensor,  # [B, d] f32
    m_bf16: torch.Tensor,  # [N, d] bf16 — the ONLY matrix copy (prepare_tiered)
    e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    rescore_rows: int | None = 96,
    t_top: int = 4,
    return_candidates: bool = False,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
):
    """Compact tier, bf16-only storage (2 B/element): the scan and the
    certified rescore read the same bf16 array → (scores [B,k]
    bf16-rescored, rows [B,k], set_certified [B] bool), plus the
    candidates as in :func:`dense_topk_compact_bf16r`."""
    q = _metric_queries(queries, metric)
    outs, b_pad = _scan_bf16(q, m_bf16, e_l2, a_l2, valid_mask, tile_n, t_top, tags)
    cand_rows, cand_vals, threshold = _tile_candidates(outs, b_pad, k, margin_tiles, t_top)
    return _trim_rescore_verify_compact(
        cand_rows, cand_vals, threshold, q, m_bf16, e_l2, a_l2, valid_mask,
        m_bf16.shape[0], q.shape[0], b_pad, k, rescore_rows,
        tags=tags, return_candidates=return_candidates,
    )


def dense_topk_compact(
    queries: torch.Tensor,  # [B, d] f32
    m_bf16: torch.Tensor,  # [N, d] bf16 rescore copy (prepare_tiered)
    bf_e_l2: torch.Tensor,  # [N] f32 — ‖row − bf16(row)‖₂
    bf_a_l2: torch.Tensor,  # [N] f32 — ‖bf16(row)‖₂
    m_i8: torch.Tensor,  # [N, d] int8 scan copy (prepare_int8)
    s_row: torch.Tensor,  # [N] f32
    i8_e_l2: torch.Tensor,  # [N] f32
    i8_a_l2: torch.Tensor,  # [N] f32
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    margin_tiles: int = 32,
    metric: str = "cosine",
    tile_n: int = 2048,
    use_int8_mxu: bool = True,
    rescore_rows: int | None = 96,
    t_top: int = 4,
    return_candidates: bool = False,
    tags: Optional[Tuple[torch.Tensor, ...]] = None,
):
    """Compact tier: int8 tile scan (K3) + certified bf16 rescore, no fp32
    matrix → (scores [B,k] bf16-rescored, rows [B,k], set_certified [B]
    bool), plus the candidates as in :func:`dense_topk_compact_bf16r`.
    The int8 quantization only proposes candidates; the bf16 interval
    governs the certificate. ``use_int8_mxu`` is ignored."""
    del use_int8_mxu
    q = _metric_queries(queries, metric)
    outs, b_pad = _scan_int8(q, m_i8, s_row, i8_e_l2, i8_a_l2, valid_mask, tile_n, t_top, tags)
    cand_rows, cand_vals, threshold = _tile_candidates(outs, b_pad, k, margin_tiles, t_top)
    return _trim_rescore_verify_compact(
        cand_rows, cand_vals, threshold, q, m_bf16, bf_e_l2, bf_a_l2, valid_mask,
        m_bf16.shape[0], q.shape[0], b_pad, k, rescore_rows,
        tags=tags, return_candidates=return_candidates,
    )


def _batched_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``[B, d]`` · ``[B, W, d]`` → ``[B, W]``: an fp32 batched product
    (TF32 off: require_fp32), whose rounding is at most (d−1)·2⁻²⁴ per
    unit of the operands' norms in any summation order."""
    return torch.bmm(rows, q[:, :, None])[:, :, 0]


def _pairwise_tree_dot(q: torch.Tensor, rows: torch.Tensor):
    """``[B, d]`` · ``[B, W, d]`` as an explicit pairwise tree: one
    product per element, then one add per level pairing ADJACENT
    elements (2i, 2i+1) exactly as the JAX code's reshape-and-add, with a
    zero appended to an odd level. Each level rounds once, so the error
    is bounded by (levels)·2⁻²⁴ relative — part of the certificate, which
    ``matmul``/``sum``/``einsum`` (unpromised order) could not give.
    → (dot [B, W], levels)."""
    prod = q[:, None, :] * rows  # [B, W, d], one RN rounding
    levels = 1
    while prod.shape[-1] > 1:
        dd = prod.shape[-1]
        if dd % 2:
            prod = torch.nn.functional.pad(prod, (0, 1))
            dd += 1
        prod = prod.reshape(prod.shape[0], prod.shape[1], dd // 2, 2)
        prod = prod[..., 0] + prod[..., 1]  # one RN rounding per level
        levels += 1
    return prod[..., 0], levels


def _trim_rescore_verify_compact(
    cand_rows, cand_vals, threshold, q, m_bf16, bf_e_l2, bf_a_l2,
    valid_mask, n, bsz, b_pad, k_req, rescore_rows,
    residual=None, residual2=None, return_bounds=False, tags=None,
    return_candidates=False, approx_select=True,
):
    """Compact-tier tail: bf16 rescore with per-candidate interval
    bounds and the SET certificate.

    True score s_j = (A_j + E_j)·q with A = f32(bf16 row); the rescore
    computes r_j = A_j·q (f32 accumulation), so
    |s_j − r_j| ≤ ‖E_j‖‖q‖ + d·2⁻²³·‖A_j‖‖q‖ (+slack) = err_j. With
    ``residual`` (bf16r: the int8 quantization Ê of E), the rescore adds
    the dequantized correction, r_j = (A_j + s_j·Ê_j)·q, computing A_j·q
    as a pairwise tree; the interval shrinks to the un-quantized
    remainder ‖E_j − s_j·Ê_j‖‖q‖ plus the tree's and the correction
    dot's rounding. ``residual2`` (bf16rr) adds the second level. Set
    certificate per query:
        min over selected (r_i − err_i)
          > max(threshold, max over unselected candidates (r_j + err_j))
    ⇒ every selected row's TRUE score strictly beats every excluded
    row's TRUE score. Every failure mode only raises the right-hand
    side — fail-closed like the exact tiers."""
    require_fp32()  # the intervals budget IEEE f32 rounding of the batched dots
    d = q.shape[1]
    width = cand_rows.shape[1]
    # Containment certificate inputs, captured BEFORE the rescore trim:
    # ``threshold`` here bounds the TRUE score of every row NOT in
    # ``cand_rows`` (the store's host candidate patch uses it)
    cont_rows, cont_thr = cand_rows, threshold
    cand_rows, threshold = _trim_and_dedup(
        cand_rows, cand_vals, threshold, k_req, rescore_rows, approx_select
    )

    # -- bf16 rescore + per-candidate interval ----------------------------
    safe_rows = torch.clamp(cand_rows, max=n - 1).long()
    gathered = m_bf16[safe_rows].float()  # [B, W, d]
    q_p = _pad_to(q, b_pad)
    q_norm = torch.linalg.vector_norm(q_p, dim=1)  # [B] (1.0 for cosine)
    acc_eps = float(d) * 2.0**-23
    e_g = bf_e_l2[safe_rows]
    a_g = bf_a_l2[safe_rows]
    if residual is None:
        r = _batched_dot(q_p, gathered)  # [B, W]
        err = ((e_g + acc_eps * a_g) * q_norm[:, None]) * _BOUND_SLACK + _BOUND_EPS
    else:
        r_i8, r_scale, e2_l2 = residual
        tree, levels = _pairwise_tree_dot(q_p, gathered)
        # correction dot: its (d−1)u bound scales with the RESIDUAL
        # magnitude (‖s·Ê‖ ≤ e_g + e2_g); the final add is one more level
        r = tree + r_scale[safe_rows] * _batched_dot(q_p, r_i8[safe_rows].float())
        e2_g = e2_l2[safe_rows]
        if residual2 is None:
            tree_eps = float(levels + 1) * 2.0**-23
            err = (
                (e2_g + tree_eps * a_g + acc_eps * (e_g + e2_g)) * q_norm[:, None]
            ) * _BOUND_SLACK + _BOUND_EPS
        else:
            # second correction dot on the level-2 residual: the interval
            # is ‖E₃‖‖q‖ + the tree rounding (one extra final add) + the
            # accumulation rounding of BOTH correction dots (operand
            # norms ‖s₁r₁‖ ≤ e+e₂ and ‖s₂r₂‖ ≤ e₂+e₃)
            r2_i8, r2_scale, e3_l2 = residual2
            r = r + r2_scale[safe_rows] * _batched_dot(q_p, r2_i8[safe_rows].float())
            e3_g = e3_l2[safe_rows]
            tree_eps = float(levels + 2) * 2.0**-23
            err = (
                (e3_g + tree_eps * a_g + acc_eps * (e_g + 2.0 * e2_g + e3_g)) * q_norm[:, None]
            ) * _BOUND_SLACK + _BOUND_EPS
    live = (cand_rows < n) & valid_mask[safe_rows]
    if tags is not None:
        live = live & _tags_live(tags, safe_rows, b_pad)
    r = torch.where(live, r, NEG_INF)
    err = torch.where(live, err, 0.0)

    # -- top-k by rescored value (ties: lowest row, rows sorted asc) ------
    k = min(k_req, width)
    top_s, idx = topk_desc(r, k)
    top_r = torch.gather(cand_rows, 1, idx).to(torch.int32)
    top_err = torch.gather(err, 1, idx)
    top_r = torch.where(torch.isneginf(top_s), -1, top_r)

    # -- SET certificate ---------------------------------------------------
    inf = float("inf")
    sel_lower = torch.where(torch.isneginf(top_s), inf, top_s - top_err).amin(dim=1)
    sel_lower = torch.where(torch.isinf(sel_lower), NEG_INF, sel_lower)  # all-empty
    # excluded-candidate upper bounds by the count trick: selected-by-r =
    # {r >= vmin} only when exactly k entries reach vmin; else fail closed
    vmin = top_s[:, k - 1]
    ge = r >= vmin[:, None]
    count = ge.sum(dim=1)
    excl_upper = torch.where(ge, NEG_INF, r + err).amax(dim=1)
    excl_upper = torch.where(count == k, excl_upper, inf)
    # SHORT results (fewer live candidates than k): no candidate is
    # excluded, so the result is complete iff threshold == -inf
    n_live = (~torch.isneginf(r)).sum(dim=1)
    short = n_live < k
    rhs = torch.where(short, threshold, torch.maximum(threshold, excl_upper))
    per_q = torch.where(short, torch.isneginf(rhs), (sel_lower > rhs) | torch.isneginf(rhs))
    if k < k_req:
        # truncated width: only certify when provably nothing was excluded
        per_q = per_q & torch.isneginf(rhs)
        top_s, top_r = _pad_k(top_s, top_r, k_req)
        top_err = torch.nn.functional.pad(top_err, (0, k_req - k), value=0.0)
    out = (top_s[:bsz], top_r[:bsz], per_q[:bsz])
    if return_bounds:
        out = out + (top_err[:bsz], rhs[:bsz])
    if return_candidates:
        out = out + (cont_rows[:bsz], cont_thr[:bsz])
    return out
