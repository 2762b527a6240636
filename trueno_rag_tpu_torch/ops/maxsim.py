"""Late-interaction (MaxSim) retrieval ops over a device-resident
``[N, Lt, H]`` token tensor — the PyTorch counterpart of
``trueno_rag_tpu/ops/maxsim.py``:

    MaxSim(q, D) = Σ_{i ∈ q tokens} max_{j ∈ D tokens} ⟨q_i, d_j⟩

with the framework's conventions: padding doc tokens are -inf before the
max, an all-padding chunk scores exactly 0, padding query tokens
contribute 0, invalid (tombstoned or filtered) chunks are -inf and row -1,
and ordering is score descending, then row ascending (``ops/dense.topk_desc``,
a stable sort; never ``torch.topk``).

- :func:`maxsim_scan_topk` — the exact scan: an fp32 scan (TF32 off)
  preselects at least ``2k`` chunks, widened until no chunk left out can
  reach the top-k within the scan's rounding budget, and
  :func:`maxsim_pair_scores` re-ranks them.
- :func:`maxsim_topk_scan16_fused` / :func:`maxsim_topk_int8_fused` /
  :func:`maxsim_topk_int8_store` — the tiered scans: a bf16 or int8 scan
  replica bounds every chunk by ``U = s_scan + W`` (W from per-chunk
  residual and norm bounds computed at pack time, plus the budgeted f32
  rounding of the programs), the ``rescore`` best-bounded chunks are
  exactly rescored from primary storage, and a query certifies iff its
  k-th exact score strictly beats the (R+1)-th bound. They scan with the
  CUDA kernels K6 ``maxsim_scan16_scores`` and K7
  ``maxsim_scan_int8_scores`` (``ops/kernels/maxsim_scan.py``).
- :func:`maxsim_topk_scan16` / :func:`maxsim_topk_int8` — the same
  certificates over a blockwise scan of the replica (``block`` chunks at a
  time, the JAX package's "xla" tiers): the bf16 replica against the f32
  query (bound ``Σᵢ‖qᵢ‖·(e_max + κ·n_max)``), the int8 replica against the
  int8 query through an exact integer dot. Their products are
  ``torch.matmul`` in f32 (f64 where an int8 dot could pass 2²⁴), as the
  JAX package computes them outside any Pallas kernel.
- :func:`maxsim_topk_token_pruned` — the token-level certificate: exact
  top-``t_hits`` token matches per query token give candidates and a
  sound threshold.
- :func:`maxsim_topk_pruned` — the centroid-pruned certificate: each
  chunk's tokens compressed to ``K`` centroids with covering radii
  (:func:`prepare_maxsim_bounds`), ``max_g (⟨qᵢ,c_g⟩ + ‖qᵢ‖·r_g)`` summed
  over the query tokens bounds every chunk, and the shared tail rescores
  and certifies.
- The l-major packs of the v2 scans K11a/K11b
  (``ops/kernels/maxsim_scan.py``): :func:`prepare_maxsim_bias_l` and
  :func:`prepare_maxsim_scan16_opt`.

Every final score comes from ONE exact function,
:func:`maxsim_pair_scores`: per-token dots in float64, the masked max and
the Lq-sum in float64, then one rounding to f32 (``ops/dense.exact_scores``'
rule). The JAX package rescores with an f32 einsum; in the port the exact
scan (a large fp32 matmul) and the candidate rescore would otherwise sum
the same products in two orders, and near-tie chunks could swap between a
certified query and a fallback one. The f32 scans only preselect; the
JAX bounds already budget two f32 programs, so an f64 rescore only
tightens them.

``select="approx"`` takes the JAX package's ``approx_max_k`` branch with
an exact selector in its place (``dense_tiered._topk_select``): its recall
is 1.0, an outcome ``approx_max_k`` may give, and the count-trick threshold
and the short-allowed-set rule follow the JAX code. ``auto`` stays
``exact``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import _pad_k, blockwise_topk, require_fp32, topk_desc
from trueno_rag_tpu_torch.ops.dense_tiered import _int8_query_bounds, _quantize_rows, _topk_select
from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import _MASK_BIAS, maxsim_scan16_scores, maxsim_scan_int8_scores
from trueno_rag_tpu_torch.utils import profiling

NEG_INF = float("-inf")

# Query-side multiplicative slack + absolute floor on the bound (the few
# f32 adds and multiplies that combine its terms), as in the JAX package.
_BOUND_SLACK = 1.0001
_BOUND_EPS = 1e-7
_EPS23 = 2.0**-23
_SLAB_ELEMS = 1 << 26  # f32 entries of one slab's largest temporary (256 MiB)
_PACK_SLAB = 8192  # chunks per slab of the packs (the JAX default)
# Build-side widening of the float64 covering radii for their final f32
# cast, as in the JAX package.
_RADIUS_SLACK = 1.0 + 1e-6
_RADIUS_EPS = 1e-7


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def _widen(h: int) -> float:
    """``1 + (h+2)·2⁻²³``: widens an f32-evaluated norm of ``h`` terms UP
    against its own sum-and-sqrt rounding."""
    return 1.0 + (h + 2) * _EPS23


def _slab_chunks(lt: int, width: int) -> int:
    """Chunks per slab so an ``[S·Lt, width]`` f32 temporary stays within
    ``_SLAB_ELEMS``."""
    return max(1, _SLAB_ELEMS // (lt * max(width, 1)))


def _check_rescore(rescore: int, k: int) -> None:
    if rescore < k:
        raise InvalidConfigError(f"rescore={rescore} must be >= k={k}")


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def maxsim_block_scores(
    q_tok: torch.Tensor,  # [B, Lq, H] f32
    q_mask: torch.Tensor,  # [B, Lq] bool
    tok: torch.Tensor,  # [C, Lt, H] float (shared across the batch)
    t_mask: torch.Tensor,  # [C, Lt] bool
) -> torch.Tensor:
    """MaxSim of every query against every chunk of one block → ``[B, C]``
    f32, in f32 (one matmul, TF32 off): the scan side of the tiers and the
    exact scan's preselection."""
    b, lq, h = q_tok.shape
    c, lt = t_mask.shape
    require_fp32()
    sim = (_f32(tok).reshape(c * lt, h) @ _f32(q_tok).reshape(b * lq, h).T).view(c, lt, b, lq)
    sim.masked_fill_(~t_mask[:, :, None, None], NEG_INF)
    best = sim.amax(dim=1)  # [C, B, Lq]
    best = torch.where(q_mask[None] & torch.isfinite(best), best, 0.0)
    return best.sum(dim=2).T


def _stored_f32(tokens, rows: torch.Tensor) -> torch.Tensor:
    """The stored token values of ``rows`` as f32: the primary's upcast, or
    for an ``(tok8, s_tok)`` int8 primary ``f32(tok8)·s_tok`` in f32 (the
    JAX package's dequantization)."""
    if isinstance(tokens, tuple):
        t8, st = tokens
        return t8[rows].float() * st[rows][..., None]
    return _f32(tokens[rows])


def maxsim_pair_scores(
    q_tok: torch.Tensor,  # [B, Lq, H] f32
    q_mask: torch.Tensor,  # [B, Lq] bool
    tok: torch.Tensor,  # [B, C, Lt, H] float (per-query candidates)
    t_mask: torch.Tensor,  # [B, C, Lt] bool
) -> torch.Tensor:
    """Exact MaxSim of each query against ITS OWN ``C`` candidates →
    ``[B, C]`` f32: the per-token dots, the masked max and the Lq-sum in
    float64, rounded to f32 once (the port's one exact score)."""
    out = torch.empty(t_mask.shape[:2], dtype=torch.float32, device=t_mask.device)
    for i in range(q_tok.shape[0]):  # one query at a time: [C, Lt, H] f64 at most
        sim = torch.matmul(tok[i].double(), q_tok[i].double().T)  # [C, Lt, Lq]
        sim.masked_fill_(~t_mask[i][:, :, None], NEG_INF)
        best = sim.amax(dim=1)  # [C, Lq]
        best = torch.where(q_mask[i][None, :] & torch.isfinite(best), best, 0.0)
        out[i] = best.sum(dim=1).float()
    return out


def _exact_rescore(q_tok, q_mask, tokens, t_mask, cand: torch.Tensor, k: int):
    """Re-rank candidate rows ``cand [B, W]`` (-1 = none) by
    :func:`maxsim_pair_scores` → the best ``k`` as (scores, rows) ordered
    (score desc, row asc), invalid slots (-inf, -1)."""
    b, w = cand.shape
    pad = torch.iinfo(torch.int32).max
    key, _ = torch.sort(torch.where(cand < 0, pad, cand.int()), dim=1)  # row order
    live = key != pad
    safe = torch.where(live, key, 0).long()
    tok_c = _stored_f32(tokens, safe.reshape(-1)).view(b, w, *t_mask.shape[1:], -1)
    s = maxsim_pair_scores(q_tok, q_mask, tok_c, t_mask[safe])
    s = torch.where(live, s, NEG_INF)
    k_eff = min(k, w)
    top_s, idx = topk_desc(s, k_eff)
    rows = torch.where(torch.isneginf(top_s), -1, torch.gather(key, 1, idx)).to(torch.int32)
    return _pad_k(top_s, rows, k)


def _scan_scores(q_tok, q_mask, tokens, t_mask, valid, block: int = 512) -> torch.Tensor:
    """f32 MaxSim of every query against every chunk → ``[B, N]``, -inf at
    invalid chunks, in slabs of at least ``block`` chunks."""
    b, lq, h = q_tok.shape
    n, lt = t_mask.shape
    out = torch.empty((b, n), dtype=torch.float32, device=t_mask.device)
    step = max(block, _slab_chunks(lt, max(b * lq, h)))
    for lo in range(0, n, step):
        out[:, lo:lo + step] = maxsim_block_scores(q_tok, q_mask, tokens[lo:lo + step], t_mask[lo:lo + step])
    return out.masked_fill_(~valid[None, :], NEG_INF)


def max_token_norm(tokens: torch.Tensor, t_mask: torch.Tensor) -> torch.Tensor:
    """The largest norm of a valid stored token, widened for its own f32
    evaluation → a 0-d f32 tensor: the ``max‖d‖`` of the exact scan's
    rounding budget. One pass over the tokens, so a store computes it
    once per device replica."""
    if t_mask.shape[0] == 0:
        return torch.zeros((), dtype=torch.float32, device=t_mask.device)
    return _slab_loop(_self16_slab, tokens, t_mask, _PACK_SLAB)[0].amax()


def maxsim_scan_topk(
    q_tok: torch.Tensor,  # [B, Lq, H] f32
    q_mask: torch.Tensor,  # [B, Lq] bool
    tokens: torch.Tensor,  # [N, Lt, H] float
    t_mask: torch.Tensor,  # [N, Lt] bool
    valid: torch.Tensor,  # [N] bool
    k: int,
    block: int = 512,
    d_norm: Optional[torch.Tensor] = None,  # max_token_norm(tokens, t_mask), computed here if None
    allowed: Optional[torch.Tensor] = None,  # [B, N] bool per-query row filter (a tag predicate)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact full-corpus MaxSim top-k → ``(scores [B,k], rows [B,k])``: the
    f32 scan (slabs of at least ``block`` chunks) preselects candidates,
    re-ranked by :func:`maxsim_pair_scores`. ``allowed`` excludes (query,
    chunk) pairs as ``valid`` excludes chunks.

    The preselection starts at ``2k`` chunks and doubles until, for every
    query, the best chunk left out scores below the k-th kept one by more
    than twice the scan's rounding budget ``(H+Lq)·2⁻²³·Σᵢ‖qᵢ‖·max‖d‖``
    plus the final rounding to f32. No chunk left out can then reach the
    exact top-k, so the result is the exact top-k of the whole corpus."""
    b, lq, h = q_tok.shape
    n = t_mask.shape[0]
    if d_norm is None:
        d_norm = max_token_norm(tokens, t_mask)
    scores = _scan_scores(q_tok, q_mask, tokens, t_mask, valid, block)
    if allowed is not None:
        scores.masked_fill_(~allowed, NEG_INF)
    _, qn_w = _widened_query_norms(q_tok, q_mask)
    budget = _tier_rounding_coeff(lq, h) * torch.where(q_mask, qn_w, 0.0).sum(dim=1) * d_norm  # [B]
    w = min(2 * k, n)
    while True:
        top, cand = blockwise_topk(scores, min(w + 1, n))
        if w >= n:
            break
        kth, out = top[:, min(k, w) - 1], top[:, w]
        margin = (budget + kth.abs() * 2.0**-22) * _BOUND_SLACK + _BOUND_EPS
        with profiling.span("rag.scan.wait"):
            done = bool((torch.isneginf(out) | (out < kth - margin)).all())
        if done:
            break
        w = min(2 * w, n)
    return _exact_rescore(q_tok, q_mask, tokens, t_mask, cand[:, :w], k)


# ---------------------------------------------------------------------------
# The shared tail: select by bound, rescore exactly, certify
# ---------------------------------------------------------------------------


def _resolve_select(select: str) -> str:
    """``auto`` → ``exact`` (the JAX package's measured choice); ``exact``
    and ``approx`` as given."""
    if select == "auto":
        return "exact"
    if select not in ("exact", "approx"):
        raise InvalidConfigError(f"unknown select mode: {select!r}")
    return select


def _approx_candidates(u: torch.Tensor, c_n: int):
    """The JAX package's ``select="approx"`` branch → ``(cand [B, C] (-1 =
    none), threshold [B])``: the selection and the count-trick threshold of
    ``_topk_select(approx=True)`` (+inf at a boundary tie: fail closed),
    candidates with a -inf bound re-sentinelled to -1, duplicates set to -1,
    and a -inf threshold when every finite bound was selected once."""
    cand, threshold = _topk_select(u, c_n, approx=True)
    cand = torch.where(torch.isneginf(torch.gather(u, 1, cand)), -1, cand)
    n_fin = torch.isfinite(u).sum(dim=1)
    s_fin = (cand >= 0).sum(dim=1)
    cand, _ = torch.sort(cand, dim=1)
    dup = (cand[:, 1:] == cand[:, :-1]) & (cand[:, 1:] >= 0)
    cand = torch.cat([cand[:, :1], torch.where(dup, -1, cand[:, 1:])], dim=1)
    complete = (s_fin == n_fin) & ~dup.any(dim=1)
    return cand, torch.where(complete, NEG_INF, threshold)


def _select_rescore_threshold(q_tok, q_mask, tokens, t_mask, u: torch.Tensor, k: int, c_n: int,
                              select: str = "exact"):
    """Selection by the sound bounds ``u [B, N]`` (-inf = excluded): the
    exact top-(C+1), or the ``approx`` branch (:func:`_approx_candidates`);
    exact rescore of the C candidates (``tokens`` is the float primary or an
    ``(tok8, s_tok)`` int8 primary) → ``(top_s [B,k], rows [B,k], kth [B],
    threshold [B])``; the threshold bounds every chunk not rescored."""
    b, n = u.shape
    if _resolve_select(select) == "approx":
        cand, threshold = _approx_candidates(u, c_n)
    else:
        sel = min(c_n + 1, n)
        u_top, cand = blockwise_topk(u, sel)
        threshold = u_top[:, c_n] if sel > c_n else torch.full((b,), NEG_INF, device=u.device)
        cand = cand[:, :c_n]
    top_s, rows = _exact_rescore(q_tok, q_mask, tokens, t_mask, cand, k)
    kth = top_s[:, min(k, c_n) - 1]
    return top_s, rows, kth, threshold


def _select_rescore_certify(q_tok, q_mask, tokens, t_mask, u, k: int, c_n: int, select: str = "exact"):
    """→ ``(scores [B,k], rows [B,k], certified [B] bool)``: certified iff
    the k-th exact score strictly beats the threshold, or nothing was
    excluded (a -inf threshold)."""
    top_s, rows, kth, threshold = _select_rescore_threshold(q_tok, q_mask, tokens, t_mask, u, k, c_n, select)
    return top_s, rows, (kth > threshold) | torch.isneginf(threshold)


# ---------------------------------------------------------------------------
# Packs
# ---------------------------------------------------------------------------


def _scan16_slab(tok_s: torch.Tensor, tm_s: torch.Tensor):
    """Per-slab body of :func:`prepare_maxsim_scan16`. Eager PyTorch does
    not fold ``f32(bf16(x))`` back to ``x``, so the residual is real (the
    JAX package needs an optimization barrier for that)."""
    w = _widen(tok_s.shape[2])
    f32 = _f32(tok_s)
    tok16 = f32.to(torch.bfloat16)
    a = tok16.float()
    e = f32 - a
    e_l2 = torch.sqrt(torch.sum(e * e, dim=2)) * w  # [S, Lt]
    a_l2 = torch.sqrt(torch.sum(a * a, dim=2)) * w
    e_max = torch.where(tm_s, e_l2, 0.0).amax(dim=1)
    n_max = torch.where(tm_s, a_l2 + e_l2, 0.0).amax(dim=1)
    return tok16, e_max, n_max


def _int8_slab(tok_s: torch.Tensor, tm_s: torch.Tensor):
    """Per-slab body of :func:`prepare_maxsim_int8`: the tightest symmetric
    per-token scales (``dense_tiered._quantize_rows``, the JAX package's
    jitted arithmetic), and the residual norm with the absolute
    ``(a+e)·2⁻²⁴`` correction for the f32 dequantize multiply."""
    s_n, lt, h = tok_s.shape
    w = _widen(h)
    tok8, s, e = _quantize_rows(_f32(tok_s).reshape(s_n * lt, h), clip=True)
    a = tok8.float() * s[:, None]
    e_raw = torch.sqrt(torch.sum(e * e, dim=1)).view(s_n, lt)
    a_raw = torch.sqrt(torch.sum(a * a, dim=1)).view(s_n, lt)
    e_l2 = (e_raw + (a_raw + e_raw) * 2.0**-24) * w
    a_l2 = a_raw * w
    e_max = torch.where(tm_s, e_l2, 0.0).amax(dim=1)
    n_max = torch.where(tm_s, a_l2 + e_l2, 0.0).amax(dim=1)
    return tok8.view(s_n, lt, h), s.view(s_n, lt), e_max, n_max


def _self16_slab(tok_s: torch.Tensor, tm_s: torch.Tensor):
    """Per-slab body of :func:`prepare_maxsim_self16`."""
    f32 = _f32(tok_s)
    a_l2 = torch.sqrt(torch.sum(f32 * f32, dim=2)) * _widen(tok_s.shape[2])
    return (torch.where(tm_s, a_l2, 0.0).amax(dim=1),)


def _slab_loop(body, tokens: torch.Tensor, t_mask: torch.Tensor, slab: int):
    """Run a per-slab pack body over ``slab``-chunk windows so its
    temporaries (f32 upcast, residual, squared norms) never reach full N;
    outputs are preallocated on the first slab and filled in place."""
    n = t_mask.shape[0]
    if n == 0:
        return body(tokens, t_mask)
    outs = None
    for lo in range(0, n, slab):
        parts = body(tokens[lo:lo + slab], t_mask[lo:lo + slab])
        if outs is None:
            outs = tuple(torch.empty((n, *p.shape[1:]), dtype=p.dtype, device=p.device) for p in parts)
        for o, p in zip(outs, parts):
            o[lo:lo + p.shape[0]] = p
    return outs


def prepare_maxsim_scan16(tokens: torch.Tensor, t_mask: torch.Tensor, slab: int = _PACK_SLAB):
    """Pack the bf16 scan tier → ``(tok16 [N,Lt,H] bf16, e_max [N] f32,
    n_max [N] f32)``: ``e_max`` the largest residual ``‖d − bf16(d)‖`` of a
    chunk's valid tokens and ``n_max`` the largest ``‖bf16(d)‖ + e``, both
    widened for their own f32 evaluation."""
    return _slab_loop(_scan16_slab, tokens, t_mask, slab)


def prepare_maxsim_self16(tokens: torch.Tensor, t_mask: torch.Tensor, slab: int = _PACK_SLAB):
    """Zero-copy bf16 tier pack for a bf16 PRIMARY store → ``(e_max [N] = 0,
    n_max [N])``; the scan replica is the primary itself, which K6 reads
    in place."""
    if tokens.dtype != torch.bfloat16:
        raise InvalidConfigError(f"prepare_maxsim_self16 requires a bfloat16 primary store (got {tokens.dtype})")
    (n_max,) = _slab_loop(_self16_slab, tokens, t_mask, slab)
    return torch.zeros_like(n_max), n_max


def prepare_maxsim_int8(tokens: torch.Tensor, t_mask: torch.Tensor, slab: int = _PACK_SLAB):
    """Pack the int8 scan tier → ``(tok8 [N,Lt,H] int8, s_tok [N,Lt] f32,
    e_max [N], n_max [N])``: per-token scales ``amax/127``, ``e_max`` the
    largest ``‖d − s·d8‖`` and ``n_max`` the largest ``‖s·d8‖ + e``, all
    widened for the f32 evaluation."""
    return _slab_loop(_int8_slab, tokens, t_mask, slab)


def _bias_l(t_mask: torch.Tensor, group: int, lt_out: int) -> torch.Tensor:
    """``[Gp·lt_out·group]`` f32, l-major within each group: 0 at valid
    tokens, -2^30 at padding, at positions past ``Lt`` and at chunks past N."""
    if group < 1:
        raise InvalidConfigError(f"group must be >= 1, got {group}")
    n, lt = t_mask.shape
    gp = max(-(-n // group), 1)
    m = torch.zeros((gp * group, lt_out), dtype=torch.bool, device=t_mask.device)
    m[:n, :lt] = t_mask
    bias = torch.where(m, 0.0, _MASK_BIAS).to(torch.float32)
    return bias.view(gp, group, lt_out).transpose(1, 2).reshape(-1)


def prepare_maxsim_bias_l(t_mask: torch.Tensor, group: int = 256) -> torch.Tensor:
    """l-major grouped mask bias of the v2 scans → ``[Gp·Lt·group]`` f32 on
    ``t_mask``'s device (``Gp = ceil(N/group)``, at least 1): chunk c's
    position l sits at ``((c // group)·Lt + l)·group + c % group``, 0 at a
    valid token, -2^30 at padding, and every entry of the chunks past N
    is bias; the JAX package's layout bit for bit. Any ``group`` >= 1 and
    any Lt (the TPU's ``(group·Lt) % 1024`` rule has no counterpart)."""
    return _bias_l(t_mask, group, t_mask.shape[1])


def prepare_maxsim_scan16_opt(tokens: torch.Tensor, t_mask: torch.Tensor, group: int = 256,
                              slab: int = _PACK_SLAB):
    """Pack the bf16 tier in the l-major layout of K11a → ``(tok_l
    [Gp·Lt_p·group, H] bf16, bias_l [Gp·Lt_p·group] f32, e_max [N] f32,
    n_max [N] f32)`` on the tokens' device, ``Lt_p = Lt`` rounded up to a
    multiple of 4 and ``Gp = ceil(N/group)``: chunk c's position l is row
    ``((c // group)·Lt_p + l)·group + c % group``, zero at the pad
    positions and chunks, whose bias is -2^30; ``e_max``/``n_max`` as
    :func:`prepare_maxsim_scan16`. The JAX package's layout bit for bit.

    Built slab by slab into the preallocated pack: no padded or transposed
    copy of the whole replica (at 1M x 32 x 128 the pack alone is 8.6 GB)."""
    n, lt = t_mask.shape
    h = tokens.shape[2]
    lt_p = -(-lt // 4) * 4
    bias_l = _bias_l(t_mask, group, lt_p)
    gp = max(-(-n // group), 1)
    dev = t_mask.device
    tok_l = torch.zeros((gp * lt_p * group, h), dtype=torch.bfloat16, device=dev)
    tok_g = tok_l.view(gp, lt_p, group, h)
    e_max = torch.empty(n, dtype=torch.float32, device=dev)
    n_max = torch.empty(n, dtype=torch.float32, device=dev)
    step = max(1, slab // group)  # whole groups per slab
    for g0 in range(0, -(-n // group), step):
        g1 = min(g0 + step, -(-n // group))
        lo, hi = g0 * group, min(n, g1 * group)
        tok16, e_max[lo:hi], n_max[lo:hi] = _scan16_slab(tokens[lo:hi], t_mask[lo:hi])
        if hi - lo < (g1 - g0) * group:
            tok16 = torch.cat([tok16, tok16.new_zeros(((g1 - g0) * group - (hi - lo), lt, h))])
        tok_g[g0:g1, :lt] = tok16.view(g1 - g0, group, lt, h).transpose(1, 2)
    return tok_l, bias_l, e_max, n_max


# ---------------------------------------------------------------------------
# Query-side bound math
# ---------------------------------------------------------------------------


def _widened_query_norms(q_tok: torch.Tensor, q_mask: torch.Tensor):
    """``(qv zeroed-padding [B,Lq,H], qn_w [B,Lq] ≥ true ‖qᵢ‖)``."""
    qv = torch.where(q_mask[:, :, None], _f32(q_tok), 0.0)
    return qv, torch.linalg.vector_norm(qv, dim=2) * _widen(q_tok.shape[2])


def _tier_rounding_coeff(lq: int, h: int) -> float:
    """Per-unit ``Σᵢ‖qᵢ‖·n_max`` rounding budget shared by every tier: the
    H-term dot and the Lq-term sum of BOTH the tier's own program and the
    exact-scan program the certificate is stated against (factor 2)."""
    return 2.0 * (h * _EPS23 + lq * _EPS23)


def _scan16_query_pack(q_tok: torch.Tensor, q_mask: torch.Tensor):
    """Query-side pack of the K6 tier → ``(q16 [B,Lq,H] bf16 padding-zeroed,
    A [B], C1 [B], Q [B])``: ``A = Σᵢ‖qᵢ − bf16(qᵢ)‖``, ``C1 = Σᵢ‖bf16(qᵢ)‖``
    and ``Q = Σᵢ‖qᵢ‖``, each norm and Lq-sum widened up against its own f32
    evaluation."""
    lq, h = q_tok.shape[1], q_tok.shape[2]
    qv = torch.where(q_mask[:, :, None], _f32(q_tok), 0.0)
    q16 = qv.to(torch.bfloat16)
    a = q16.float()
    e = qv - a
    w, ws = _widen(h), 1.0 + lq * _EPS23
    m = q_mask.float()
    norms = [torch.linalg.vector_norm(x, dim=2) * w for x in (e, a, qv)]
    return (q16, *(torch.sum(x * m, dim=1) * ws for x in norms))


def _scan16_fused_widths(a_c, c1, q_w, e_max, n_max, h: int, lq: int) -> torch.Tensor:
    """→ ``W [B, C]``, the K6 tier's certificate width
    ``C1·e_max + (A + κ·(C1 + 2Q))·n_max`` with ``κ = (H+Lq)·2⁻²³`` (the
    kernel's own f32 rounding on C1; the exact-scan and rescore programs'
    on Q), slack and floor on top."""
    kappa = (h + lq) * _EPS23
    return (c1[:, None] * e_max[None, :]
            + (a_c + kappa * (c1 + 2.0 * q_w))[:, None] * n_max[None, :]) * _BOUND_SLACK + _BOUND_EPS


def _int8_widths(usum, vsum, qsum_w, e_max, n_max, lq: int, h: int) -> torch.Tensor:
    """→ ``W [B, C]``, the int8 tiers' certificate width: the token residual
    ``Σu_q·e_max``, the query residual ``Σv_q·n_max`` and both programs'
    f32 rounding, slack and floor on top."""
    return (usum[:, None] * e_max[None, :] + vsum[:, None] * n_max[None, :]
            + _tier_rounding_coeff(lq, h) * qsum_w[:, None] * n_max[None, :]) * _BOUND_SLACK + _BOUND_EPS


def _int8_query_pack(q_tok, q_mask):
    """→ ``(qv, q8 [B,Lq,H], t_q [B,Lq], usum [B], vsum [B], qsum_w [B])``:
    the int8 query quantization and its bound coefficients, padding query
    tokens' coefficients zeroed (their q8 rows are already all zero)."""
    b, lq, h = q_tok.shape
    qv, qn_w = _widened_query_norms(q_tok, q_mask)
    q8, t_q, u_q, v_q = _int8_query_bounds(qv.reshape(b * lq, h))
    qm_f = q_mask.reshape(b * lq)
    usum = torch.where(qm_f, u_q, 0.0).view(b, lq).sum(dim=1)
    vsum = torch.where(qm_f, v_q, 0.0).view(b, lq).sum(dim=1)
    qsum_w = torch.where(q_mask, qn_w, 0.0).sum(dim=1)
    return qv, q8.view(b, lq, h), t_q.view(b, lq), usum, vsum, qsum_w


# ---------------------------------------------------------------------------
# Tiered scans
# ---------------------------------------------------------------------------


def maxsim_topk_scan16_fused(q_tok, q_mask, tokens, t_mask, tok16, e_max, n_max, valid, k: int,
                             rescore: int = 1024, select: str = "auto"):
    """Certified bf16-scan MaxSim top-k through K6 → ``(scores [B,k], rows
    [B,k], certified [B] bool)``. The kernel quantizes the query to bf16
    too, so ``U = s_K6 + C1·e_max + (A + κ·(C1 + 2Q))·n_max``
    (:func:`_scan16_fused_widths`). ``tok16 is tokens`` (a bf16 primary
    with :func:`prepare_maxsim_self16`'s pack) is the zero-copy tier: K6
    reads the primary in place."""
    _check_rescore(rescore, k)
    b, lq, h = q_tok.shape
    n = t_mask.shape[0]
    qv = torch.where(q_mask[:, :, None], _f32(q_tok), 0.0)
    q16, a_c, c1, q_w = _scan16_query_pack(q_tok, q_mask)
    wgmma = maxsim_scan16_scores.wgmma_launches
    u = maxsim_scan16_scores(q16, tok16, t_mask, valid)  # [B, N]; -inf at invalid chunks
    rec, wgmma = profiling.active(), maxsim_scan16_scores.wgmma_launches - wgmma
    if rec is not None and wgmma:  # K6 launches on its Hopper program
        rec.count("rag.scan.maxsim_wgmma", wgmma)
    u += _scan16_fused_widths(a_c, c1, q_w, e_max, n_max, h, lq)
    return _select_rescore_certify(qv, q_mask, tokens, t_mask, u, k, min(rescore, n), select)


def maxsim_topk_int8_fused(q_tok, q_mask, tokens, t_mask, tok8, s_tok, e_max, n_max, valid, k: int,
                           rescore: int = 1024, select: str = "auto"):
    """Certified int8-scan MaxSim top-k through K7 → ``(scores [B,k], rows
    [B,k], certified [B] bool)``: the exact integer dot scaled by ``s_tok``
    and ``t_q``; the bound carries the token residual (``e_max·Σu_q``), the
    query residual (``n_max·Σv_q``) and both programs' f32 rounding."""
    _check_rescore(rescore, k)
    b, lq, h = q_tok.shape
    n = t_mask.shape[0]
    qv, q8, t_q, usum, vsum, qsum_w = _int8_query_pack(q_tok, q_mask)
    u = maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid)  # -inf at invalid chunks
    u += _int8_widths(usum, vsum, qsum_w, e_max, n_max, lq, h)
    return _select_rescore_certify(qv, q_mask, tokens, t_mask, u, k, min(rescore, n), select)


def maxsim_topk_int8_store(q_tok, q_mask, tok8, s_tok, t_mask, n_max, valid, k: int,
                           rescore: int = 1024, select: str = "auto"):
    """Certified MaxSim over int8 PRIMARY storage through K7 → ``(scores,
    rows, certified)``. Exactness is over the dequantized stored tokens
    ``f32(tok8)·s_tok``; the token residual term drops (storage IS the int8
    values), so the interval covers the query quantization and both
    programs' f32 rounding. The rescore dequantizes only the candidates."""
    _check_rescore(rescore, k)
    b, lq, h = q_tok.shape
    n = t_mask.shape[0]
    qv, q8, t_q, _, vsum, qsum_w = _int8_query_pack(q_tok, q_mask)
    u = maxsim_scan_int8_scores(q8, t_q, tok8, s_tok, t_mask, valid)
    u += ((vsum + _tier_rounding_coeff(lq, h) * qsum_w)[:, None] * n_max[None, :]) * _BOUND_SLACK + _BOUND_EPS
    return _select_rescore_certify(qv, q_mask, (tok8, s_tok), t_mask, u, k, min(rescore, n), select)


def maxsim_topk_scan16(q_tok, q_mask, tokens, t_mask, tok16, e_max, n_max, valid, k: int,
                       rescore: int = 1024, block: int = 1024, select: str = "auto"):
    """Certified bf16-scan MaxSim top-k over a blockwise scan →
    ``(scores [B,k], rows [B,k], certified [B] bool)``. Each block of
    ``block`` chunks of the replica ``tok16`` is scored against the f32
    query (:func:`maxsim_block_scores`) and bounded by ``U = s16 +
    Σᵢ‖qᵢ‖·(e_max + κ·n_max)`` (κ :func:`_tier_rounding_coeff`); the
    ``rescore`` best-bounded chunks are rescored exactly from ``tokens``.
    ``tok16 is tokens`` (a bf16 primary with
    :func:`prepare_maxsim_self16`'s pack) scans the primary in place."""
    _check_rescore(rescore, k)
    b, lq, h = q_tok.shape
    n = t_mask.shape[0]
    qv, qn_w = _widened_query_norms(q_tok, q_mask)
    qsum_w = torch.where(q_mask, qn_w, 0.0).sum(dim=1)  # [B]
    k_round = _tier_rounding_coeff(lq, h)
    u = torch.empty((b, n), dtype=torch.float32, device=t_mask.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s16 = maxsim_block_scores(qv, q_mask, tok16[lo:hi], t_mask[lo:hi])
        w = (qsum_w[:, None] * (e_max[None, lo:hi] + k_round * n_max[None, lo:hi])) * _BOUND_SLACK + _BOUND_EPS
        u[:, lo:hi] = torch.where(valid[None, lo:hi], s16 + w, NEG_INF)
    return _select_rescore_certify(qv, q_mask, tokens, t_mask, u, k, min(rescore, n), select)


def _int_dot_dtype(h: int) -> torch.dtype:
    """A float type in which an int8 dot of ``h`` terms is exact in any
    summation order: every partial sum is an integer within 127²·h."""
    return torch.float32 if 127 * 127 * h < 2**24 else torch.float64


def maxsim_topk_int8(q_tok, q_mask, tokens, t_mask, tok8, s_tok, e_max, n_max, valid, k: int,
                     rescore: int = 1024, block: int = 512, select: str = "auto"):
    """Certified int8-scan MaxSim top-k over a blockwise scan →
    ``(scores [B,k], rows [B,k], certified [B] bool)``. The integer dot
    ``q8·d8`` is exact (an integer-valued float product, TF32 off), then
    scaled ``f32(dot)·t_q·s_tok``; the bound carries the token residual
    (``e_max·Σu_q``), the query residual (``n_max·Σv_q``) and both
    programs' f32 rounding (:func:`_int8_widths`)."""
    _check_rescore(rescore, k)
    require_fp32()
    b, lq, h = q_tok.shape
    n, lt = t_mask.shape
    qv, q8, t_q, usum, vsum, qsum_w = _int8_query_pack(q_tok, q_mask)
    dot_t = _int_dot_dtype(h)
    q8t = q8.reshape(b * lq, h).to(dot_t).T
    tq = t_q.reshape(b * lq)
    u = torch.empty((b, n), dtype=torch.float32, device=t_mask.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        c = hi - lo
        dots = tok8[lo:hi].reshape(c * lt, h).to(dot_t) @ q8t  # [C·Lt, B·Lq], exact integers
        sim = (dots.float() * tq[None, :] * s_tok[lo:hi].reshape(c * lt)[:, None]).view(c, lt, b, lq)
        sim.masked_fill_(~t_mask[lo:hi, :, None, None], NEG_INF)
        best = sim.amax(dim=1)  # [C, B, Lq]
        best = torch.where(q_mask[None] & torch.isfinite(best), best, 0.0)
        s8 = best.sum(dim=2).T  # [B, C]
        w = _int8_widths(usum, vsum, qsum_w, e_max[lo:hi], n_max[lo:hi], lq, h)
        u[:, lo:hi] = torch.where(valid[None, lo:hi], s8 + w, NEG_INF)
    return _select_rescore_certify(qv, q_mask, tokens, t_mask, u, k, min(rescore, n), select)


# ---------------------------------------------------------------------------
# Token-level pruning
# ---------------------------------------------------------------------------


def _flat_token_scores(qf: torch.Tensor, tokens: torch.Tensor, fvalid: torch.Tensor):
    """``[B·Lq, N·Lt]`` f32 scores of the query tokens against every stored
    token (-inf at padding and invalid chunks) and the widened largest
    valid token norm, the token matrix upcast slab by slab."""
    n, lt, h = tokens.shape
    flat = tokens.reshape(n * lt, h)
    m = n * lt
    out = torch.empty((qf.shape[0], m), dtype=torch.float32, device=qf.device)
    dn = torch.zeros((), dtype=torch.float32, device=qf.device)
    step = _slab_chunks(1, max(qf.shape[0], h))
    require_fp32()
    for lo in range(0, m, step):
        f = _f32(flat[lo:lo + step])
        out[:, lo:lo + step] = qf @ f.T
        dn = torch.maximum(dn, torch.where(fvalid[lo:lo + step], torch.linalg.vector_norm(f, dim=1), 0.0).amax())
    return out.masked_fill_(~fvalid[None, :], NEG_INF), dn * _widen(h)


def _widened_sum(x: torch.Tensor, lq: int) -> torch.Tensor:
    """``Σ`` over dim 1 widened for the Lq-term f32 sum, slack and floor."""
    mag = torch.abs(x).sum(dim=1)
    return x.sum(dim=1) + mag * (lq * _EPS23) + mag * (_BOUND_SLACK - 1.0) + _BOUND_EPS


def maxsim_topk_token_pruned(q_tok, q_mask, tokens, t_mask, valid, k: int, t_hits: int = 256,
                             rescore: int = 256, u_block: int = 512):
    """Certified token-level-pruned MaxSim top-k → ``(scores [B,k], rows
    [B,k], certified [B] bool)``.

    1. Token pass: exact top-``t_hits`` matches per query token over the
       flat ``[N·Lt, H]`` tokens; the T-th hit τᵢ bounds every unretrieved
       token. Both are widened by the cross-program budget
       ``2·H·2⁻²³·‖qᵢ‖·max‖d‖``.
    2. Bounds: a hit chunk ``Σᵢ max(best_hitᵢ, τᵢ)``, a chunk with no hit
       ``Σᵢ τᵢ``; a valid empty chunk scores exactly 0.
    3. The ``rescore`` best-bounded candidates are exactly rescored;
       certified iff the k-th exact score strictly beats max((C+1)-th
       bound, Σᵢτᵢ, the empty floor).

    Memory: the token pass holds ``[B·Lq, N·Lt]`` f32 scores."""
    _check_rescore(rescore, k)
    b, lq, h = q_tok.shape
    n, lt = t_mask.shape
    dev = t_mask.device
    qv, qn_w = _widened_query_norms(q_tok, q_mask)
    qf = qv.reshape(b * lq, h)
    fvalid = (t_mask & valid[:, None]).reshape(n * lt)
    s_tok, dn_w = _flat_token_scores(qf, tokens, fvalid)
    t_eff = min(t_hits, n * lt)
    hs, hid = blockwise_topk(s_tok, t_eff)  # [B·Lq, T]
    del s_tok

    delta = 2.0 * (h * _EPS23) * qn_w.reshape(b * lq) * dn_w  # [B·Lq]
    qm_f = q_mask.reshape(b * lq)
    tau = torch.where(qm_f, hs[:, t_eff - 1] + delta, 0.0)  # -inf stays -inf
    hid = torch.where(qm_f[:, None], hid, -1)
    hc = torch.where(hid >= 0, torch.div(hid, lt, rounding_mode="floor"), -1).to(torch.int32)
    hc3 = hc.view(b, lq, t_eff)
    hs3 = torch.where(hc3 >= 0, (hs + delta[:, None]).view(b, lq, t_eff), NEG_INF)
    tau2 = tau.view(b, lq)

    # Σᵢ τᵢ: a τᵢ = -inf (every valid token retrieved for token i) means no
    # wholly-unhit nonempty chunk exists; clamp before the widened sum
    any_ninf = torch.isneginf(tau2).any(dim=1)
    stau = torch.where(any_ninf, NEG_INF, _widened_sum(torch.where(torch.isneginf(tau2), 0.0, tau2), lq))

    # candidate slots: one per unique hit chunk, -1s first
    w = lq * t_eff
    cand_all, _ = torch.sort(hc.view(b, w), dim=1)
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=dev), cand_all[:, 1:] == cand_all[:, :-1]], 1)
    cand_all = torch.where(dup, -1, cand_all)

    # per-candidate bound U = Σᵢ max(best_hitᵢ, τᵢ)
    u = torch.empty((b, w), dtype=torch.float32, device=dev)
    for lo in range(0, w, u_block):
        cw = cand_all[:, lo:lo + u_block]
        eq = hc3[:, :, :, None] == cw[:, None, None, :]  # [B, Lq, T, u]
        mx = torch.where(eq, hs3[:, :, :, None], NEG_INF).amax(dim=2)  # [B, Lq, u]
        ub = _widened_sum(torch.maximum(mx, tau2[:, :, None]), lq)
        u[:, lo:lo + u_block] = torch.where(cw >= 0, ub, NEG_INF)

    c_n = min(rescore, w)
    sel = min(c_n + 1, w)
    u_top, uidx = blockwise_topk(u, sel)
    thr_cand = u_top[:, c_n] if sel > c_n else torch.full((b,), NEG_INF, device=dev)
    uidx = uidx[:, :c_n]
    rows_c = torch.where(uidx >= 0, torch.gather(cand_all, 1, torch.clamp(uidx, min=0).long()), -1)
    top_s, rows = _exact_rescore(qv, q_mask, tokens, t_mask, rows_c, k)

    # the threshold covers everything not rescored: unselected candidates'
    # bounds, wholly-unhit chunks' Στ, and any valid empty chunk's 0
    has_empty = bool((valid & ~t_mask.any(dim=1)).any())
    threshold = torch.maximum(thr_cand, stau)
    if has_empty:
        threshold = torch.clamp(threshold, min=0.0)
    kth = top_s[:, min(k, c_n) - 1]
    return top_s, rows, (kth > threshold) | torch.isneginf(threshold)


# ---------------------------------------------------------------------------
# Centroid pruning
# ---------------------------------------------------------------------------


def _kmeans_tokens_device(tok: torch.Tensor, mask: torch.Tensor, k_bound: int, iters: int) -> torch.Tensor:
    """Batched per-chunk k-means over each chunk's own tokens ``tok [S, Lt,
    H]`` (f32, on any device; TF32 off) → proposed centroids ``[S, K, H]``
    f32. Quality only: any centroids are sound once the radius pass covers
    every token. Init: the valid tokens of evenly strided ranks (the first
    slot of each rank); assignment by ``⟨t,c⟩ − ½‖c‖²`` (first maximum);
    empty clusters keep their centroid. The JAX package's algorithm."""
    require_fp32()
    s, lt, h = tok.shape
    tok = _f32(tok)
    tokm = torch.where(mask[:, :, None], tok, 0.0)
    cnt = mask.sum(dim=1)
    pos = torch.cumsum(mask.int(), dim=1) - 1  # valid rank per slot
    want = (torch.arange(k_bound, device=tok.device)[None, :] * torch.clamp(cnt - 1, min=0)[:, None]
            // max(k_bound - 1, 1))  # [S, K] target ranks
    hit = (pos[:, :, None] == want[:, None, :]) & mask[:, :, None]  # [S, Lt, K]
    first = torch.argmax(hit.to(torch.uint8), dim=1)  # the first slot of each rank (0 if none)
    cent = torch.gather(tokm, 1, first[:, :, None].expand(s, k_bound, h))
    for _ in range(iters):
        sc = torch.bmm(tok, cent.transpose(1, 2)) - 0.5 * (cent * cent).sum(dim=2)[:, None, :]
        asg = torch.argmax(sc, dim=2)  # [S, Lt]
        one = torch.nn.functional.one_hot(asg, k_bound).float() * mask[:, :, None]
        sums = torch.bmm(one.transpose(1, 2), tokm)  # [S, K, H]
        n_k = one.sum(dim=1)
        new = sums / torch.clamp(n_k, min=1.0)[:, :, None]
        cent = torch.where(n_k[:, :, None] > 0, new, cent)
    return cent


def prepare_maxsim_bounds(tokens, t_mask, k_bound: int = 8, iters: int = 8, slab: int = 4096):
    """Per-chunk compressed token set with covering radii → ``(btok [N, K,
    H] f32, brad [N, K] f32, bmask [N, K] bool)``, the bound inputs of
    :func:`maxsim_topk_pruned`, with ``K = min(k_bound, Lt)`` (at least 1).

    ``tokens [N, Lt, H]`` (any float dtype; the f32 upcast defines the
    stored values) and ``t_mask [N, Lt]`` may be CPU or CUDA tensors or
    numpy arrays; the work runs and the outputs live on the tokens'
    device, slab by slab of ``slab`` chunks. Numpy tokens go to the CUDA
    device (the port's default; without one the call raises
    :class:`InvalidConfigError`), so a CPU run must be asked for with CPU
    tensors.

    Each chunk's tokens go through :func:`_kmeans_tokens_device` on that
    device; then, in float64 there too (the H100 has fp64 units; the JAX
    package does this pass in numpy on the host), every valid token is
    assigned to its nearest f32 centroid and each group's radius covers its
    tokens, widened by ``_RADIUS_SLACK``/``_RADIUS_EPS`` for the f32 cast.
    So ``‖d_j − c_{a(j)}‖ ≤ r_{a(j)}`` holds for every stored token whatever
    the k-means found. Groups with no token are masked out with a zero
    centroid and radius."""
    if not isinstance(tokens, torch.Tensor):
        tokens = torch.as_tensor(np.asarray(tokens, np.float32), device=resolve_device(None))
    if not isinstance(t_mask, torch.Tensor):
        t_mask = torch.as_tensor(np.asarray(t_mask, bool))
    t_mask = t_mask.to(tokens.device)
    n, lt, h = tokens.shape
    k_bound = max(1, min(k_bound, lt))
    dev = tokens.device
    btok = torch.zeros((n, k_bound, h), dtype=torch.float32, device=dev)
    brad = torch.zeros((n, k_bound), dtype=torch.float32, device=dev)
    bmask = torch.zeros((n, k_bound), dtype=torch.bool, device=dev)
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        t32, m = _f32(tokens[lo:hi]), t_mask[lo:hi]
        cent = _kmeans_tokens_device(t32, m, k_bound, iters)
        t64, c64 = t32.double(), cent.double()
        d2 = ((t64 * t64).sum(dim=2)[:, :, None] - 2.0 * torch.bmm(t64, c64.transpose(1, 2))
              + (c64 * c64).sum(dim=2)[:, None, :])  # [S, Lt, K]
        asg = d2.argmin(dim=2)  # [S, Lt]
        dist = torch.sqrt(torch.clamp(torch.gather(d2, 2, asg[:, :, None])[:, :, 0], min=0.0))
        dist = torch.where(m, dist, 0.0)  # padding never sets a radius
        r = torch.zeros((hi - lo, k_bound), dtype=torch.float64, device=dev).scatter_reduce(
            1, asg, dist, reduce="amax")
        used = torch.zeros((hi - lo, k_bound), dtype=torch.int32, device=dev).scatter_add(1, asg, m.int()) > 0
        btok[lo:hi] = torch.where(used[:, :, None], cent, 0.0)
        brad[lo:hi] = torch.where(used, r * _RADIUS_SLACK + _RADIUS_EPS, 0.0).float()
        bmask[lo:hi] = used
    return btok, brad, bmask


def _maxsim_bound_block(q_tok, q_mask, qn_w, btok, brad, bmask) -> torch.Tensor:
    """Sound per-chunk MaxSim upper bounds of one block → ``[B, C]`` f32:
    per query token ``max_g (⟨qᵢ,c_g⟩ + ‖qᵢ‖·(r_g + acc_eps·‖c_g‖))`` over
    the chunk's valid groups (``acc_eps = H·2⁻²³`` carries the dot's f32
    rounding, the centroid norm widened against its own), 0 for a padding
    query token or a chunk with no group; summed over the query tokens and
    widened for the Lq-term sum, ``_BOUND_SLACK`` and ``_BOUND_EPS``. The
    ``[B, Lq, C, K]`` product is one f32 matmul (TF32 off)."""
    require_fp32()
    b, lq, h = q_tok.shape
    c, kb = brad.shape
    acc_eps = h * _EPS23
    sim = (_f32(q_tok).reshape(b * lq, h) @ btok.reshape(c * kb, h).T).view(b, lq, c, kb)
    cn_w = torch.linalg.vector_norm(btok, dim=2) * (1.0 + acc_eps)  # [C, K]
    term = sim + qn_w[:, :, None, None] * (brad + acc_eps * cn_w)[None, None]
    term.masked_fill_(~bmask[None, None], NEG_INF)
    bi = term.amax(dim=3)  # [B, Lq, C]
    bi = torch.where(q_mask[:, :, None] & torch.isfinite(bi), bi, 0.0)
    u = bi.sum(dim=1)
    mag = bi.abs().sum(dim=1)
    u = u + mag * (lq * _EPS23)
    return u + mag * (_BOUND_SLACK - 1.0) + _BOUND_EPS


def maxsim_topk_pruned(q_tok, q_mask, tokens, t_mask, btok, brad, bmask, valid, k: int, rescore: int = 128,
                       bound_block: int = 4096, select: str = "auto"):
    """Certified centroid-pruned MaxSim top-k → ``(scores [B,k], rows [B,k],
    certified [B] bool)``.

    Every chunk is bounded by ``U = Σᵢ max_g (⟨qᵢ,c_g⟩ + ‖qᵢ‖·r_g)`` over
    :func:`prepare_maxsim_bounds`' groups (:func:`_maxsim_bound_block`, in
    slabs of ``bound_block`` chunks; ``‖qᵢ‖`` widened by
    ``1 + (H+2)·2⁻²³``), -inf at invalid chunks; the shared tail rescores
    the ``rescore`` best-bounded chunks exactly and certifies a query iff
    its k-th exact score strictly beats every chunk left out (a -inf
    threshold: nothing finite was left out)."""
    _check_rescore(rescore, k)
    n = t_mask.shape[0]
    _, qn_w = _widened_query_norms(q_tok, q_mask)
    u = torch.empty((q_tok.shape[0], n), dtype=torch.float32, device=t_mask.device)
    for lo in range(0, n, bound_block):
        hi = min(n, lo + bound_block)
        u[:, lo:hi] = _maxsim_bound_block(q_tok, q_mask, qn_w, btok[lo:hi], brad[lo:hi], bmask[lo:hi])
    u.masked_fill_(~valid[None, :], NEG_INF)
    return _select_rescore_certify(q_tok, q_mask, tokens, t_mask, u, k, min(rescore, n), select)


def maxsim_scan_oracle(q_tok, q_mask, tokens, t_mask, valid, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host oracle for :func:`maxsim_scan_topk` (numpy, f32 math as the JAX
    package's; the framework's (score desc, row asc) order, ``-1``/``-inf``
    invalid slots)."""
    q_tok = np.asarray(q_tok, np.float32)
    tokens = np.asarray(tokens, np.float32)
    q_mask = np.asarray(q_mask, bool)
    t_mask = np.asarray(t_mask, bool)
    valid = np.asarray(valid, bool)
    b, n = q_tok.shape[0], tokens.shape[0]
    scores = np.full((b, n), NEG_INF, dtype=np.float32)
    for c in range(n):
        if not valid[c]:
            continue
        tm = t_mask[c]
        total = np.zeros((b,), np.float32)
        if tm.any():
            sim = np.einsum("bqh,th->bqt", q_tok, tokens[c], dtype=np.float32)
            sim = np.where(tm[None, None, :], sim, NEG_INF)
            best = sim.max(axis=2)
            best = np.where(q_mask & np.isfinite(best), best, 0.0)
            total = best.sum(axis=1, dtype=np.float32)
        scores[:, c] = total
    out_s = np.full((b, k), NEG_INF, dtype=np.float32)
    out_r = np.full((b, k), -1, dtype=np.int32)
    for i in range(b):
        order = sorted(range(n), key=lambda c: (-scores[i, c], c))
        kept = [c for c in order if np.isfinite(scores[i, c])][:k]
        out_s[i, : len(kept)] = scores[i, kept]
        out_r[i, : len(kept)] = kept
    return out_s, out_r
