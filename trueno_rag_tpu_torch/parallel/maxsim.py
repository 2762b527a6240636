"""Corpus-sharded late-interaction (MaxSim) retrieval.

PyTorch counterpart of ``trueno_rag_tpu/parallel/maxsim.py``, the
multi-vector sibling of ``parallel.sharded``: the ``[N, Lt, H]`` token
tensor shards row-wise over the ``data`` axis, the query tokens are
replicated, each shard answers on its own rows and the per-shard top-k
merge through ``parallel.sharded.merge_local_topk`` (``k·s`` values per
query, independent of N). Ties stay (score desc, global row asc); tag
filters evaluate on each shard's own tag slice.

- The exact scan (:func:`sharded_maxsim_topk`): per shard the single
  card's exact scan, ``ops.maxsim.maxsim_scan_topk`` (the f32 blockwise
  ``maxsim_block_scores`` preselects with a sound widening, candidates are
  rescored in float64 and rounded once). The port's reported scores are
  that float64 MaxSim, as on one card.
- The tiered scan (:func:`sharded_maxsim_topk_scan16_fused`): per shard
  K6 ``maxsim_scan16_scores`` over the shard's bf16 replica (or its bf16
  primary in place), the bound widening, the exact rescore of the shard's
  best-bounded chunks and its exclusion threshold; after the merge the
  global certificate ``merged k-th > max over shards of the threshold``
  proves the merged top-k is the exact full-corpus MaxSim top-k (misses
  fail closed and re-run on the exact scan).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.index.token_store import _upload
from trueno_rag_tpu_torch.ops.dense import NEG_INF
from trueno_rag_tpu_torch.ops.kernels.maxsim_scan import maxsim_scan16_scores
from trueno_rag_tpu_torch.ops.maxsim import (
    _check_rescore,
    _f32,
    _scan16_fused_widths,
    _scan16_query_pack,
    _select_rescore_threshold,
    max_token_norm,
    maxsim_scan_topk,
    prepare_maxsim_scan16,
    prepare_maxsim_self16,
)
from trueno_rag_tpu_torch.ops.tags import tag_pred
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded, shard_max
from trueno_rag_tpu_torch.parallel.sharded import global_rows, merge_local_topk, tag_words_on


def _on(x, dev, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dev, dtype=dtype or t.dtype)


def _allowed(tags, i: int, dev):
    """Shard ``i``'s ``[B, n]`` tag predicate, or None."""
    if tags is None:
        return None
    ta, ty, tn = tag_words_on(tags[1:], dev)
    return tag_pred(tags[0].shards[i][None, :], ta[:, None], ty[:, None], tn[:, None])


def _sharded_exact(q_tok, q_mask, tokens, t_mask, valid, k, mesh, axis, block, tags=None, d_norm=None):
    rps = valid.rows_per_shard
    s_loc, r_glob = [], []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        s, r = maxsim_scan_topk(_on(q_tok, dev, torch.float32), _on(q_mask, dev, torch.bool), tokens.shards[i],
                                t_mask.shards[i], valid.shards[i], k, block,
                                None if d_norm is None else d_norm[i], allowed=_allowed(tags, i, dev))
        s_loc.append(s)
        r_glob.append(global_rows(r, i, rps))
    return merge_local_topk(s_loc, r_glob, k, mesh)


def sharded_maxsim_topk(
    q_tok,  # [B, Lq, H] replicated
    q_mask,  # [B, Lq] replicated
    tokens: RowSharded,  # [N, Lt, H]
    t_mask: RowSharded,  # [N, Lt]
    valid: RowSharded,  # [N]
    k: int,
    mesh: Mesh,
    axis: str = "data",
    block: int = 512,
    d_norm: Optional[List[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MaxSim top-k over a row-sharded token corpus → ``(scores
    [B,k], rows [B,k])`` with GLOBAL row ids. ``d_norm``: each shard's
    ``max_token_norm`` if already known."""
    return _sharded_exact(q_tok, q_mask, tokens, t_mask, valid, k, mesh, axis, block, d_norm=d_norm)


def sharded_maxsim_topk_tagged(
    q_tok,
    q_mask,
    tokens: RowSharded,
    t_mask: RowSharded,
    valid: RowSharded,
    tag_bits: RowSharded,  # [N] int32
    t_all,  # [B] replicated filter words
    t_any,
    t_none,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    block: int = 512,
    d_norm: Optional[List[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tag-filtered sibling of :func:`sharded_maxsim_topk`."""
    return _sharded_exact(q_tok, q_mask, tokens, t_mask, valid, k, mesh, axis, block,
                          (tag_bits, t_all, t_any, t_none), d_norm)


def sharded_maxsim_topk_scan16_fused(
    q_tok,  # [B, Lq, H] replicated
    q_mask,  # [B, Lq] replicated
    tokens: RowSharded,  # [N, Lt, H] primary
    t_mask: RowSharded,  # [N, Lt]
    tok16: RowSharded,  # [N, Lt, H] bf16 replica (or ``tokens`` itself)
    e_max: RowSharded,  # [N] f32
    n_max: RowSharded,  # [N] f32
    valid: RowSharded,  # [N] bool
    k: int,
    mesh: Mesh,
    axis: str = "data",
    rescore: int = 256,
    tags: Optional[Tuple] = None,
    select: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Certified bf16-tier MaxSim top-k over a row-sharded token corpus via
    K6 → ``(scores [B,k], rows [B,k] GLOBAL ids, certified [B])``. ``tags``
    = ``(tag_bits [N] sharded, t_all, t_any, t_none [B])`` makes it an exact
    filtered search. ``tok16 is tokens`` (a bf16 primary with
    ``prepare_maxsim_self16``'s pack) scans the primary in place: each
    device holds its shard once."""
    _check_rescore(rescore, k)
    s_loc, r_glob, thr = [], [], []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        q = _on(q_tok, dev, torch.float32)
        qm = _on(q_mask, dev, torch.bool)
        b, lq, h = q.shape
        tok, tm = tokens.shards[i], t_mask.shards[i]
        n_loc = tm.shape[0]
        qv = torch.where(qm[:, :, None], _f32(q), 0.0)
        q16, a_c, c1, q_w = _scan16_query_pack(q, qm)
        u = maxsim_scan16_scores(q16, tok16.shards[i], tm, valid.shards[i])  # [B, n_loc]
        u += _scan16_fused_widths(a_c, c1, q_w, e_max.shards[i], n_max.shards[i], h, lq)
        allowed = _allowed(tags, i, dev)
        if allowed is not None:
            u = torch.where(allowed, u, NEG_INF)
        top_s, rows, _kth, t = _select_rescore_threshold(qv, qm, tok, tm, u, k, min(rescore, n_loc), select)
        s_loc.append(top_s)
        r_glob.append(global_rows(rows, i, n_loc))
        thr.append(t)
    s_m, r_m = merge_local_topk(s_loc, r_glob, k, mesh)
    thr_g = shard_max(thr, mesh)
    certified = (s_m[:, k - 1] > thr_g) | torch.isneginf(thr_g)
    return s_m, r_m, certified


class ShardedTokenIndex:
    """A read-optimized, corpus-sharded multi-vector index.

    Built once from host token arrays (a :class:`TokenVectorStore`
    snapshot); rows pad to a multiple of the data-axis size and go to
    their shards a slab at a time. ``scan="tiered"`` serves through K6
    with the exact scan for the queries its certificate does not prove; on
    bf16 storage the shard's primary is its scan replica (no second copy).
    Mutation: rebuild (the mutable path is the single-card store)."""

    def __init__(
        self,
        tokens: np.ndarray,  # [N, Lt, H]
        t_mask: np.ndarray,  # [N, Lt]
        mesh: Mesh,
        valid: Optional[np.ndarray] = None,
        axis: str = "data",
        tokens_normalized: bool = False,
        tags: Optional[np.ndarray] = None,
        block: int = 512,
        storage_dtype: str = "float32",
        normalize_queries: bool = True,
        scan: str = "exact",
        rescore: int = 256,
    ) -> None:
        if scan not in ("exact", "tiered"):
            raise InvalidConfigError(f"scan must be exact|tiered, got {scan!r}")
        tokens = np.asarray(tokens, dtype=np.float32)
        n = tokens.shape[0]
        self.n, self.mesh, self.axis, self.block = n, mesh, axis, block
        # cosine MaxSim needs normalized query tokens too (the single-card
        # store normalizes inside search_arrays)
        self.normalize_queries = normalize_queries
        s = mesh.shape[axis]
        rps = max(-(-n // s), 1)
        tm = np.zeros((rps * s, tokens.shape[1]), dtype=bool)
        tm[:n] = np.asarray(t_mask, bool)[:n]
        v = np.zeros(rps * s, dtype=bool)
        v[:n] = True if valid is None else np.asarray(valid, dtype=bool)[:n]
        t = np.zeros(rps * s, dtype=np.int32)
        if tags is not None:
            t[:n] = np.asarray(tags, dtype=np.int32)[:n]
        dtype = torch.bfloat16 if storage_dtype == "bfloat16" else torch.float32
        devs = mesh.axis_devices(axis)
        shards = []
        for i, dev in enumerate(devs):
            blk = tokens[i * rps:(i + 1) * rps]
            if not tokens_normalized:
                norms = np.sqrt(np.einsum("nij,nij->ni", blk, blk))[:, :, None]
                blk = blk / np.where(norms > 0.0, norms, 1.0)
            out = _upload(blk, dtype, dev)
            if blk.shape[0] < rps:
                out = torch.cat([out, out.new_zeros((rps - blk.shape[0],) + out.shape[1:])])
            shards.append(out)
        self.tokens = RowSharded(shards, mesh, axis)
        self.t_mask, self.valid, self.tags = (
            RowSharded([_on(x, dev) for x, dev in zip(np.split(a, s), devs)], mesh, axis) for a in (tm, v, t)
        )
        self._d_norm = [max_token_norm(tok, m) for tok, m in zip(self.tokens.shards, self.t_mask.shards)]
        self.scan, self.rescore = scan, rescore
        self.uncertified = 0
        self._tier = None
        if scan == "tiered":
            if dtype == torch.bfloat16:
                # zero-copy pack: the shard's bf16 primary IS its scan replica
                packs = [prepare_maxsim_self16(tok, m) for tok, m in zip(self.tokens.shards, self.t_mask.shards)]
                self._tier = (self.tokens,) + tuple(RowSharded([p[j] for p in packs], mesh, axis) for j in range(2))
            else:
                packs = [prepare_maxsim_scan16(tok, m) for tok, m in zip(self.tokens.shards, self.t_mask.shards)]
                self._tier = tuple(RowSharded([p[j] for p in packs], mesh, axis) for j in range(3))

    @classmethod
    def from_token_store(cls, store, mesh: Mesh, axis: str = "data", block: int = 512, scan: str = "exact",
                         rescore: int = 256) -> "ShardedTokenIndex":
        """Snapshot a TokenVectorStore: rows stay registry-aligned, so global
        row ids hydrate through the same registry. The store's host rows are
        served as they are (normalized at insert when its config says so,
        raw otherwise: never normalized again). ``scan="tiered"`` serves
        through the K6 tier with the exact-scan fallback."""
        cap = store._host.shape[0]
        return cls(store._host, store._t_mask, mesh, valid=store._valid, axis=axis, tokens_normalized=True,
                   tags=store.registry.tags_host(cap), block=block, storage_dtype=store.config.storage_dtype,
                   normalize_queries=store.config.normalize, scan=scan, rescore=rescore)

    def _queries(self, q_tok: np.ndarray, q_mask: Optional[np.ndarray]):
        q = np.asarray(q_tok, np.float32)
        if self.normalize_queries:
            norms = np.sqrt(np.einsum("bij,bij->bi", q, q))[:, :, None]
            q = q / np.where(norms > 0.0, norms, 1.0)
        qm = np.ones(q.shape[:2], bool) if q_mask is None else np.asarray(q_mask, bool)
        return q, qm

    def _search(self, q_tok, q_mask, k: int, tags=None) -> Tuple[np.ndarray, np.ndarray]:
        q, qm = self._queries(q_tok, q_mask)
        args = (self.tokens, self.t_mask, self.valid)
        if self.scan == "tiered":
            s, r, cert = sharded_maxsim_topk_scan16_fused(q, qm, self.tokens, self.t_mask, *self._tier, self.valid,
                                                          k, self.mesh, self.axis, self.rescore, tags=tags)
            miss = np.flatnonzero(~cert.cpu().numpy())
            if len(miss):
                # fail-closed: the uncertified queries re-run on the exact
                # scan (certified ones are provably identical)
                self.uncertified += len(miss)
                sub = None if tags is None else (tags[0],) + tuple(np.asarray(t)[miss] for t in tags[1:])
                s_e, r_e = _sharded_exact(q[miss], qm[miss], *args, k, self.mesh, self.axis, self.block, sub,
                                          self._d_norm)
                s, r = s.clone(), r.clone()
                idx = torch.from_numpy(miss).to(s.device)
                s[idx], r[idx] = s_e, r_e
        else:
            s, r = _sharded_exact(q, qm, *args, k, self.mesh, self.axis, self.block, tags, self._d_norm)
        return s.cpu().numpy(), r.cpu().numpy()

    def search(self, q_tok: np.ndarray, q_mask: Optional[np.ndarray] = None, k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched MaxSim top-k → ``(scores [B,k], rows [B,k])`` numpy."""
        return self._search(q_tok, q_mask, k)

    def search_tagged(self, q_tok: np.ndarray, t_all: np.ndarray, t_any: np.ndarray, t_none: np.ndarray,
                      q_mask: Optional[np.ndarray] = None, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`search` among the chunks passing each query's tag filter."""
        words = tuple(np.asarray(t, np.int32) for t in (t_all, t_any, t_none))
        return self._search(q_tok, q_mask, k, (self.tags, *words))
