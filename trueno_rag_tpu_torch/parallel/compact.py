"""Corpus-sharded COMPACT dense retrieval: certified top-k SETS over a mesh
with no fp32 matrix on any device.

PyTorch counterpart of ``trueno_rag_tpu/parallel/compact.py``. Each shard
runs the compact tier (``ops.dense_tiered.dense_topk_compact_bf16r`` or
``_bf16rr``: the K1 tile scan, then the residual-corrected rescore) over
its rows with ``return_bounds=True``: its local top-k with
residual-corrected scores, per-candidate interval half-widths ``err`` and
an exclusion bound ``rhs`` (the largest TRUE score any non-returned local
row could have; +inf when a local failure mode fired). After the ``k·s``
gather the global set certificate per query is

    min over selected (s_i − err_i)
      > max( max over shards rhs_shard,
             max over unselected gathered (s_j + err_j) )

so every selected row's true score strictly beats every excluded row's,
whether that row was another shard's candidate or never left its shard. A
shard whose own set is uncertified sends ``rhs = +inf``, so no local flag
is trusted; ties fail closed. Where ``certified[i]`` holds, the row set IS
the global fp32 top-k set; scores are corrected-rescore values.

With the host matrix kept, uncertified queries are patched exactly: first
the containment patch (float64 over the union of the shards' candidate
rows, contained when the exact k-th beats the largest shard threshold),
then :func:`host_exact_patch` (float64 over every row) for the rest.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import NEG_INF, _pad_k, topk_desc
from trueno_rag_tpu_torch.ops.dense_tiered import (
    dense_topk_compact_bf16r,
    dense_topk_compact_bf16rr,
    prepare_residual,
    prepare_residual2,
    prepare_tiered,
)
from trueno_rag_tpu_torch.ops.tags import tag_pred
from trueno_rag_tpu_torch.parallel.ingest import _to_device
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded, all_gather, shard_max
from trueno_rag_tpu_torch.parallel.sharded import (
    INT32_MAX, _normalized, _padded, as_queries, global_rows, tag_words_on,
)

_PATCH_SLAB = 1 << 18  # host rows widened to float64 at a time by the exact patch


def merge_bounded_candidates(s, r_glob, err, rhs, k: int, mesh: Mesh):
    """Merge each shard's ``k`` bounded candidates and exclusion bound into
    the global top-k and the composed SET certificate → ``(scores [B,k],
    rows [B,k] int32, certified [B])`` on the mesh's first device. Each
    argument is a per-shard list; ``r_glob`` carries GLOBAL rows with
    ``INT32_MAX`` in empty slots. Shared by the compact and clustered
    sharded tiers (each shard's ``rhs`` already folds its own failure
    modes)."""
    s_all = all_gather(s, mesh)  # [B, k·s]
    r_all = all_gather(r_glob, mesh)
    e_all = all_gather(err, mesh)
    shard_bound = shard_max(rhs, mesh)  # [B]

    k_out = min(k, s_all.shape[1])
    s_top, idx = topk_desc(s_all, k_out)
    r_top = torch.gather(r_all, 1, idx)
    e_top = torch.gather(e_all, 1, idx)

    inf = float("inf")
    sel_lower = torch.where(torch.isneginf(s_top), inf, s_top - e_top).amin(dim=1)
    sel_lower = torch.where(torch.isinf(sel_lower), NEG_INF, sel_lower)
    vmin = s_top[:, k_out - 1]
    ge = s_all >= vmin[:, None]
    count = ge.sum(dim=1)
    excl_upper = torch.where(ge, NEG_INF, s_all + e_all).amax(dim=1)
    excl_upper = torch.where(count == k_out, excl_upper, inf)
    # SHORT results (fewer live candidates than k, e.g. a selective tag
    # filter): every live candidate is selected, so none is excluded; the
    # set is complete iff no shard can hold an unreturned allowed row
    n_live = (~torch.isneginf(s_all)).sum(dim=1)
    short = n_live < k_out
    rhs_g = torch.where(short, shard_bound, torch.maximum(shard_bound, excl_upper))
    ok = torch.where(short, torch.isneginf(rhs_g), (sel_lower > rhs_g) | torch.isneginf(rhs_g))

    r_out = torch.where(torch.isneginf(s_top), -1, r_top).to(torch.int32)
    s_top, r_out = _pad_k(s_top, r_out, k)
    return s_top, r_out, ok


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_allowed(bits: np.ndarray, tag_masks, qi: np.ndarray) -> np.ndarray:
    """The tag predicate of queries ``qi`` on host tag words ``bits``
    (broadcast against ``[len(qi), 1]``)."""
    t_all, t_any, t_none = (np.asarray(_to_numpy(t), np.int32)[qi, None] for t in tag_masks)
    return tag_pred(bits, t_all, t_any, t_none)


def _host_queries(q, bad: np.ndarray, metric: str) -> np.ndarray:
    qn = np.asarray(_to_numpy(q), dtype=np.float64)[bad]
    if metric == "cosine":
        norms = np.linalg.norm(qn, axis=1, keepdims=True)
        qn = qn / np.where(norms == 0.0, 1.0, norms)
    return qn


def host_exact_patch(
    host: np.ndarray,  # [n, d] f32 original-order rows
    valid_host: np.ndarray,  # [n] bool
    tags_host,  # [n] int32 or None
    metric: str,
    q,  # [B, d]
    s,  # [B, k] scores
    r,  # [B, k] GLOBAL original rows
    ok_np: np.ndarray,  # [B] bool — False entries get patched
    k: int,
    tag_masks=None,
):
    """Exact host re-run of the uncertified queries: float64 sums over every
    row, (score desc, row asc) ties — the true-score order the certificate
    proves for certified queries. Streams the host rows in slabs (no
    float64 copy of the matrix) and scores all patched queries in one
    product per slab. → ``(scores, rows)`` tensors on ``s``'s device."""
    s_np, r_np = _to_numpy(s).copy(), _to_numpy(r).copy()
    bad = np.flatnonzero(~np.asarray(ok_np, bool))
    if len(bad):
        qn = _host_queries(q, bad, metric)
        best_s = np.full((len(bad), k), -np.inf)
        best_r = np.full((len(bad), k), -1, dtype=np.int64)
        for lo in range(0, host.shape[0], _PATCH_SLAB):
            sc = (host[lo:lo + _PATCH_SLAB].astype(np.float64) @ qn.T).T  # [B', rows]
            sc[:, ~valid_host[lo:lo + _PATCH_SLAB]] = -np.inf
            if tag_masks is not None:
                sc[~_host_allowed(tags_host[None, lo:lo + _PATCH_SLAB], tag_masks, bad)] = -np.inf
            for j in range(len(bad)):
                row = sc[j]
                kk = min(k, len(row))
                thr = np.partition(row, len(row) - kk)[len(row) - kk]
                keep = np.flatnonzero((row >= thr) & np.isfinite(row))  # the slab's top k and its ties
                cat_s = np.concatenate([best_s[j], row[keep]])
                cat_r = np.concatenate([best_r[j], keep + lo])
                take = np.lexsort((np.where(np.isfinite(cat_s), cat_r, np.iinfo(np.int64).max), -cat_s))[:k]
                best_s[j], best_r[j] = cat_s[take], cat_r[take]
        live = np.isfinite(best_s)
        r_np[bad] = np.where(live, best_r, -1)
        s_np[bad] = np.where(live, best_s, -np.inf).astype(np.float32)
    dev = s.device if isinstance(s, torch.Tensor) else torch.device("cpu")
    return torch.from_numpy(s_np).to(dev), torch.from_numpy(r_np).to(dev)


def _sharded_compact(queries, parts, valid_mask: RowSharded, k, mesh, metric, axis, tile_n, tags, residual2,
                     with_candidates):
    """Each shard's compact scan, then the bounded merge → ``(scores, rows,
    certified[, cand [B, s·W] (INT32_MAX empties), thr [B]])``.

    ``cand``/``thr`` are the sharded containment inputs: the gathered
    global candidate rows and the largest shard tile-level exclusion bound,
    a sound upper bound on the TRUE score of every row outside ``cand``
    (each row lives on one shard and is either among its candidates or
    under its threshold)."""
    q = as_queries(queries)
    outs = []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        args = [q.to(dev)] + [p.shards[i] for p in parts]
        kw = dict(metric=metric, tile_n=tile_n, return_bounds=True, return_candidates=with_candidates)
        if tags is not None:
            kw["tags"] = (tags[0].shards[i], *tag_words_on(tags[1:], dev))
        if residual2 is None:
            outs.append(dense_topk_compact_bf16r(*args, valid_mask.shards[i], k, **kw))
        else:
            outs.append(dense_topk_compact_bf16rr(*args, *(p.shards[i] for p in residual2), valid_mask.shards[i],
                                                  k, **kw))
    local_n = valid_mask.rows_per_shard
    merged = merge_bounded_candidates(
        [o[0] for o in outs], [global_rows(o[1], i, local_n) for i, o in enumerate(outs)],
        [o[3] for o in outs], [o[4] for o in outs], k, mesh,
    )
    if not with_candidates:
        return merged
    cand = []
    for i, o in enumerate(outs):
        c = o[5].to(torch.int64)
        cand.append(torch.where((c >= 0) & (c < local_n), c + i * local_n, INT32_MAX).to(torch.int32))
    return merged + (all_gather(cand, mesh), shard_max([o[6] for o in outs], mesh))


def sharded_compact_topk(
    queries,  # [B, d] f32, replicated
    m_bf16: RowSharded,  # [N, d] bf16
    e_l2: RowSharded,  # [N] f32
    a_l2: RowSharded,  # [N] f32
    r_i8: RowSharded,  # [N, d] int8
    r_scale: RowSharded,  # [N] f32
    e2_l2: RowSharded,  # [N] f32
    valid_mask: RowSharded,  # [N] bool
    k: int,
    mesh: Mesh,
    metric: str = "cosine",
    axis: str = "data",
    tile_n: int = 2048,
    tags: Optional[Tuple] = None,
    residual2: Optional[Tuple[RowSharded, RowSharded, RowSharded]] = None,
):
    """Certified-set top-k over row-sharded compact (bf16r) replicas →
    ``(scores [B,k], rows [B,k] global ids, certified [B])``.

    ``tags = (tag_bits [N] int32 sharded with the rows, t_all [B], t_any
    [B], t_none [B])``: the filter evaluates inside each shard's scan, and
    a certified set is the exact top-k among allowed rows. ``residual2 =
    (r2_i8, r2_scale, e3_l2)`` (``prepare_residual2``) engages the bf16rr
    two-level rescore (the same scan, a ~15x narrower interval)."""
    return _sharded_compact(queries, (m_bf16, e_l2, a_l2, r_i8, r_scale, e2_l2), valid_mask, k, mesh, metric,
                            axis, tile_n, tags, residual2, False)


class ShardedCompactIndex:
    """Read-optimized sharded compact index: 3 bytes per element of a
    shard (4 with ``layout="bf16rr"``) and no fp32 matrix on any device.

    ``keep_host=True`` keeps the host fp32 matrix (the caller's array, not
    a copy, when it needs no normalization) and patches uncertified
    queries exactly, as the single-card store's ``compact_fallback="host"``;
    ``False`` drops it and serves flagged best-effort results.
    ``layout="bf16rr"`` adds the second int8 residual level: the same
    scan, a rescore interval of ~1.5e-6 instead of ~2e-5."""

    def __init__(
        self,
        matrix: np.ndarray,
        mesh: Mesh,
        metric: str = "cosine",
        valid: Optional[np.ndarray] = None,
        axis: str = "data",
        rows_normalized: bool = False,
        tile_n: int = 2048,
        keep_host: bool = True,
        tags: Optional[np.ndarray] = None,
        layout: str = "bf16r",
    ) -> None:
        if layout not in ("bf16r", "bf16rr"):
            raise InvalidConfigError(f"unknown compact shard layout {layout!r} (bf16r|bf16rr)")
        if metric not in ("cosine", "dot"):
            raise InvalidConfigError("compact sharding supports cosine/dot metrics")
        self.layout = layout
        matrix = np.asarray(matrix, dtype=np.float32)
        n = matrix.shape[0]
        self.n, self.metric, self.mesh, self.axis = n, metric, mesh, axis
        self.tile_n = tile_n
        s = mesh.shape[axis]
        rps = max(-(-n // s), 1)
        v = np.zeros(rps * s, dtype=bool)
        v[:n] = True if valid is None else np.asarray(valid, dtype=bool)[:n]
        self._valid_host = v[:n]
        self._host = _normalized(matrix, metric, rows_normalized) if keep_host else None

        # replica prep is row-wise, so each shard preps its own rows on its
        # own device; the fp32 block is dropped once its replicas exist
        names = ["m_bf16", "e_l2", "a_l2", "r_i8", "r_scale", "e2_l2"]
        if layout == "bf16rr":
            names += ["r2_i8", "r2_scale", "e3_l2"]
        shards = {name: [] for name in names}
        for i, dev in enumerate(mesh.axis_devices(axis)):
            m = _to_device(_padded(_normalized(matrix[i * rps:(i + 1) * rps], metric, rows_normalized), rps), dev)
            parts = prepare_tiered(m) + (prepare_residual2(m) if layout == "bf16rr" else prepare_residual(m))
            for name, part in zip(names, parts):
                shards[name].append(part)
            del m
        for name in names:
            setattr(self, name, RowSharded(shards[name], mesh, axis))
        self.valid = RowSharded([_to_device(b, dev) for b, dev in zip(np.split(v, s), mesh.axis_devices(axis))],
                                mesh, axis)
        self._tags_host = None
        self.tags = None
        if tags is not None:
            self.set_tags(tags)
        self.uncertified = 0  # observability counters
        self.candidate_patched = 0  # exact via the sharded containment patch
        self.gemm_patched = 0  # exact via the full float64 pass

    def set_tags(self, tags: np.ndarray) -> None:
        """(Re-)upload the per-row tag words, sharded with the rows (at build
        and on registry tag edits)."""
        t = np.zeros(self.valid.shape[0], dtype=np.int32)
        t[:min(self.n, len(tags))] = np.asarray(tags, np.int32)[:self.n]
        self._tags_host = t[:self.n]
        self.tags = RowSharded(
            [_to_device(b, dev) for b, dev in zip(np.split(t, len(self.valid.shards)),
                                                  self.mesh.axis_devices(self.axis))],
            self.mesh, self.axis,
        )

    def _residual2(self):
        return (self.r2_i8, self.r2_scale, self.e3_l2) if self.layout == "bf16rr" else None

    def search(self, queries, k: int, tag_masks=None):
        """→ ``(scores [B,k], rows [B,k], certified [B])``; with a host
        matrix, uncertified queries are patched exactly and the flags come
        back all True (:attr:`uncertified` counts the patched ones).
        ``tag_masks`` = per-query ``(t_all, t_any, t_none)`` int32 words
        (needs :meth:`set_tags`)."""
        q = as_queries(queries)
        tags = None
        if tag_masks is not None:
            if self.tags is None:
                raise InvalidConfigError("tag_masks given but no tags were set")
            tags = (self.tags, *tag_masks)
        with_cand = self._host is not None
        out = _sharded_compact(q, (self.m_bf16, self.e_l2, self.a_l2, self.r_i8, self.r_scale, self.e2_l2),
                               self.valid, k, self.mesh, self.metric, self.axis, self.tile_n, tags,
                               self._residual2(), with_cand)
        s, r, ok = out[:3]
        ok_np = ok.cpu().numpy().astype(bool)
        misses = int((~ok_np).sum())
        self.uncertified += misses
        if not (misses and with_cand):
            return s, r, ok
        # containment first: the union of the shards' candidate rows and the
        # largest shard threshold prove the exact top-k lies in the union
        s_p, r_p, unresolved = self._containment_patch(q.cpu().numpy(), s.cpu().numpy(), r.cpu().numpy(), ok_np, k,
                                                       out[3].cpu().numpy(), out[4].cpu().numpy(), tag_masks)
        if len(unresolved):
            gm = np.ones_like(ok_np)
            gm[unresolved] = False
            s_p, r_p = host_exact_patch(self._host, self._valid_host, self._tags_host, self.metric, q, s_p, r_p,
                                        gm, k, tag_masks=tag_masks)
            self.gemm_patched += len(unresolved)
        dev = s.device
        return torch.as_tensor(s_p).to(dev), torch.as_tensor(r_p).to(dev), torch.ones_like(ok)

    def _containment_patch(self, q, s, r, ok_np, k, cand, thr, tag_masks=None):
        """Exact float64 scores over each bad query's gathered candidate rows,
        (score desc, row asc) ties; contained iff the exact k-th strictly
        beats the composed shard threshold → ``(scores, rows,
        unresolved)``."""
        bad = np.flatnonzero(~ok_np)
        n = self._host.shape[0]
        s_np, r_np = s.copy(), r.copy()
        cr = cand[bad].astype(np.int64)  # [B', s·W]
        live = (cr >= 0) & (cr < n)
        safe = np.where(live, cr, 0)
        live &= self._valid_host[safe]
        if tag_masks is not None and self._tags_host is not None:
            live &= _host_allowed(self._tags_host[safe], tag_masks, bad)
        pad_v = np.iinfo(np.int64).max
        # candidate rows repeat only through padding (shards are disjoint
        # row ranges); a repeat keeps its first occurrence
        srt = np.sort(np.where(live, cr, pad_v), axis=1)
        if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != pad_v)).any():
            for bi in range(cr.shape[0]):
                seen = set()
                for wi in np.flatnonzero(live[bi]):
                    if int(cr[bi, wi]) in seen:
                        live[bi, wi] = False
                    seen.add(int(cr[bi, wi]))
        qv = _host_queries(q, bad, self.metric)
        sc = np.einsum("bwd,bd->bw", self._host[safe].astype(np.float64), qv)
        sc[~live] = -np.inf
        kk = min(k, cr.shape[1])
        order = np.lexsort((np.where(live, cr, pad_v), -sc), axis=-1)[:, :kk]
        top_s = np.take_along_axis(sc, order, axis=1)
        top_r = np.take_along_axis(safe, order, axis=1)
        if kk < k:
            top_s = np.pad(top_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
            top_r = np.pad(top_r, ((0, 0), (0, k - kk)))
        thr_b = thr[bad].astype(np.float64)
        contained = np.where(live.sum(axis=1) >= k, thr_b < top_s[:, k - 1] if k > 0 else False,
                             np.isneginf(thr_b))
        dead = np.isneginf(top_s)
        top_r = np.where(dead, -1, top_r)
        top_s32 = top_s.astype(np.float32)
        top_s32[dead] = NEG_INF
        fixed = bad[contained]
        s_np[fixed] = top_s32[contained]
        r_np[fixed] = top_r[contained]
        self.candidate_patched += int(contained.sum())
        return s_np, r_np, bad[~contained]
