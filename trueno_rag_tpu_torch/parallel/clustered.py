"""Corpus-sharded CLUSTER-PRUNED dense retrieval: certified top-k SETS over a
mesh where each shard scans only the tiles that can matter.

PyTorch counterpart of ``trueno_rag_tpu/parallel/clustered.py``. It
composes two certified mechanisms:

- per shard, the cluster-pruned tier
  (``ops.clustered.dense_topk_compact_bf16r_clustered``: K5 over the
  probed tiles in place on the card, or K1 over a copy of them with
  ``fetch="gather"``) scans the probed tile union of ITS rows and returns
  bounded candidates and an exclusion bound ``rhs`` that already holds the
  largest bound over its pruned tiles;
- across shards, ``parallel.compact.merge_bounded_candidates`` composes the
  global set certificate.

A certified query's set is provably the exact top-k of the whole corpus
even though each shard scanned a few of its tiles; a pruning miss anywhere
raises that shard's ``rhs`` and the certificate fails closed (the host
patch covers it). Each shard clusters ITS OWN rows (``prepare_clustered``,
seeded by the shard index), the layout multi-host ingest produces.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.clustered import (
    apply_cluster_order,
    dense_topk_compact_bf16r_clustered,
    prepare_clustered,
    resolve_cluster_fetch,
)
from trueno_rag_tpu_torch.ops.dense_tiered import prepare_residual, prepare_tiered
from trueno_rag_tpu_torch.parallel.compact import host_exact_patch, merge_bounded_candidates
from trueno_rag_tpu_torch.parallel.ingest import _to_device
from trueno_rag_tpu_torch.parallel.mesh import Mesh, RowSharded
from trueno_rag_tpu_torch.parallel.sharded import _normalized, as_queries, global_rows, tag_words_on

_REPLICAS = ("m_bf16", "e_l2", "a_l2", "r_i8", "r_scale", "e2_l2")


def sharded_clustered_topk(
    queries,  # [B, d] f32, replicated
    m_bf16: RowSharded,  # [s·Np, d] bf16, CLUSTERED per shard
    e_l2: RowSharded,  # [s·Np] f32
    a_l2: RowSharded,
    r_i8: RowSharded,  # [s·Np, d] int8
    r_scale: RowSharded,
    e2_l2: RowSharded,
    valid_mask: RowSharded,  # [s·Np] bool (holes False)
    centroids: RowSharded,  # [s, T, d] f32
    radii: RowSharded,  # [s, T] f32
    row_map: RowSharded,  # [s·Np] int32 shard-LOCAL original rows
    rows_per_shard: int,
    k: int,
    mesh: Mesh,
    probe_tiles: int = 16,
    metric: str = "cosine",
    axis: str = "data",
    tile_n: int = 4096,
    fetch: str = "gather",
    tags: Optional[Tuple] = None,
):
    """Certified-set top-k over row-sharded, per-shard-clustered compact
    replicas → ``(scores [B,k], rows [B,k] GLOBAL original ids, certified
    [B])``. ``tags``: tag bits ``[s·Np]`` in the CLUSTERED layout (sharded)
    and replicated ``[B]`` filter words; the predicate evaluates inside
    each shard's pruned scan. ``fetch`` resolves per shard device
    (``ops.clustered.resolve_cluster_fetch``)."""
    q = as_queries(queries)
    s_loc, r_glob, err, rhs = [], [], [], []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        tag_args = None if tags is None else (tags[0].shards[i], *tag_words_on(tags[1:], dev))
        s, r, _ok, e, h = dense_topk_compact_bf16r_clustered(
            q.to(dev), *(p.shards[i] for p in (m_bf16, e_l2, a_l2, r_i8, r_scale, e2_l2, valid_mask)), k,
            centroids.shards[i][0], radii.shards[i][0], probe_tiles=probe_tiles, row_map=row_map.shards[i],
            metric=metric, tile_n=tile_n, fetch=resolve_cluster_fetch(fetch, dev),
            # t_top >= k plus runner-up slack: a tile's unemitted rows join
            # the threshold at its t_top-th candidate's bf16 upper bound, so
            # at t_top == k a corpus whose (k+1)-th row sits within that
            # interval of the k-th certifies nothing; +4 candidates rescore
            # the runners-up (the kernel's pool caps t_top at 16)
            t_top=min(max(8, k + 4), 16),
            tags=tag_args, return_bounds=True,
        )
        s_loc.append(s)
        r_glob.append(global_rows(r, i, rows_per_shard))
        err.append(e)
        rhs.append(h)
    return merge_bounded_candidates(s_loc, r_glob, err, rhs, k, mesh)


def _equal_tiles(orders, cents, rads, tile: int):
    """Pad each shard's layout with hole tiles (order -1, zero centroid and
    radius: never live) to the largest tile count, so the shards' replicas
    share a shape."""
    t_max = max(len(c) for c in cents)
    out = []
    for order, cent, rad in zip(orders, cents, rads):
        extra = t_max - len(cent)
        out.append((np.concatenate([order, np.full(extra * tile, -1, np.int32)]),
                    np.concatenate([cent, np.zeros((extra, cent.shape[1]), np.float32)]),
                    np.concatenate([rad, np.zeros(extra, np.float32)])))
    return out


class ShardedClusteredIndex:
    """Read-optimized sharded cluster-pruned index: 3 B per element of a
    shard, and per query the probed tile union of each shard is scanned,
    not the whole shard. Per-shard k-means at build; the global exact-set
    certificate composes from the per-shard pruned bounds.

    ``keep_host=True`` keeps the host fp32 matrix and patches uncertified
    queries exactly (float64), as :class:`ShardedCompactIndex`."""

    def __init__(
        self,
        matrix: np.ndarray,
        mesh: Mesh,
        metric: str = "cosine",
        valid: Optional[np.ndarray] = None,
        axis: str = "data",
        rows_normalized: bool = False,
        tile_n: int = 4096,
        probe_tiles: int = 16,
        fetch: str = "auto",
        kmeans_iters: int = 8,
        keep_host: bool = True,
        tags: Optional[np.ndarray] = None,
    ) -> None:
        if metric not in ("cosine", "dot"):
            raise InvalidConfigError("clustered sharding supports cosine/dot metrics")
        matrix = _normalized(np.asarray(matrix, dtype=np.float32), metric, rows_normalized)
        n = matrix.shape[0]
        s = mesh.shape[axis]
        tile = max(tile_n, 1024)
        rps = max(-(-n // s), 1)
        v_host = np.ones(n, dtype=bool) if valid is None else np.asarray(valid, dtype=bool)[:n].copy()

        def build(i: int):
            # each shard k-means only ITS rows (seeded by its index); padding
            # rows are invalid and never join a tile
            bv = np.zeros(rps, dtype=bool)
            bv[:max(min(n - i * rps, rps), 0)] = v_host[i * rps:(i + 1) * rps]
            order, cent, rad = prepare_clustered(self._shard_block(matrix, i, rps), tile_n=tile, metric=metric,
                                                 iters=kmeans_iters, seed=i, valid=bv)
            return order.astype(np.int32), cent, rad

        # the shards' host builds are independent (as on separate hosts): run
        # them side by side, each seeded by its shard, so the layouts are the
        # sequential ones
        with ThreadPoolExecutor(max_workers=s) as pool:
            layouts = list(pool.map(build, range(s)))
        self._place(matrix, v_host, mesh, axis, metric, tile, probe_tiles, fetch, rps,
                    _equal_tiles(*zip(*layouts), tile), keep_host, tags)

    @staticmethod
    def _shard_block(matrix: np.ndarray, i: int, rps: int) -> np.ndarray:
        block = matrix[i * rps:(i + 1) * rps]
        if block.shape[0] < rps:  # equalize shard row spaces
            block = np.pad(block, ((0, rps - block.shape[0]), (0, 0)))
        return block

    def _place(self, matrix, v_host, mesh, axis, metric, tile, probe_tiles, fetch, rps, layouts, keep_host,
               tags) -> None:
        """Permute each shard's rows into its clustered layout and build its
        replicas on its device; ``layouts[i] = (order, centroids, radii)``."""
        self.n, self.metric, self.mesh, self.axis = matrix.shape[0], metric, mesh, axis
        self.tile_n, self.probe_tiles, self.fetch = tile, probe_tiles, fetch
        self.rows_per_shard = rps
        parts = {name: [] for name in _REPLICAS + ("valid", "row_map", "centroids", "radii")}
        for i, ((order, cent, rad), dev) in enumerate(zip(layouts, mesh.axis_devices(axis))):
            bv = np.zeros(rps, dtype=bool)
            bv[:max(min(self.n - i * rps, rps), 0)] = v_host[i * rps:(i + 1) * rps]
            m = _to_device(apply_cluster_order(self._shard_block(matrix, i, rps), order), dev)
            for name, x in zip(_REPLICAS, prepare_tiered(m) + prepare_residual(m)):
                parts[name].append(x)
            del m
            parts["valid"].append(_to_device(apply_cluster_order(bv, order, fill=False), dev))
            parts["row_map"].append(_to_device(order, dev))
            parts["centroids"].append(_to_device(cent[None], dev))
            parts["radii"].append(_to_device(rad[None], dev))
        for name, shards in parts.items():
            setattr(self, name, RowSharded(shards, mesh, axis))
        self._orders = [o for o, _, _ in layouts]  # host copies: tag permutation on set_tags
        self._host = matrix if keep_host else None
        self._valid_host = v_host
        self._tags_host = None
        self.tags = None
        if tags is not None:
            self.set_tags(tags)
        self.uncertified = 0  # observability counter

    def set_tags(self, tags: np.ndarray) -> None:
        """(Re-)upload per-row tag words, permuted into each shard's clustered
        layout and sharded with the rows."""
        rps = self.rows_per_shard
        t = np.zeros(rps * len(self._orders), dtype=np.int32)
        t[:min(self.n, len(tags))] = np.asarray(tags, np.int32)[:self.n]
        self._tags_host = t[:self.n]
        self.tags = RowSharded(
            [_to_device(apply_cluster_order(t[i * rps:(i + 1) * rps], order, fill=0), dev)
             for i, (order, dev) in enumerate(zip(self._orders, self.mesh.axis_devices(self.axis)))],
            self.mesh, self.axis,
        )

    def search(self, queries, k: int, tag_masks=None):
        """→ ``(scores [B,k], rows [B,k] global ids, certified [B])``; with a
        host matrix, uncertified queries are patched exactly (flags all
        True, :attr:`uncertified` counts them)."""
        q = as_queries(queries)
        tags = None
        if tag_masks is not None:
            if self.tags is None:
                raise InvalidConfigError("tag_masks given but no tags were set")
            tags = (self.tags, *tag_masks)
        s, r, ok = sharded_clustered_topk(
            q, *(getattr(self, name) for name in _REPLICAS), self.valid, self.centroids, self.radii,
            self.row_map, self.rows_per_shard, k, self.mesh, self.probe_tiles, self.metric, self.axis,
            self.tile_n, self.fetch, tags=tags,
        )
        ok_np = ok.cpu().numpy().astype(bool)
        misses = int((~ok_np).sum())
        self.uncertified += misses
        if misses and self._host is not None:
            s_p, r_p = host_exact_patch(self._host, self._valid_host, self._tags_host, self.metric, q, s, r, ok_np,
                                        k, tag_masks=tag_masks)
            return s_p, r_p, torch.ones_like(ok)
        return s, r, ok

    @classmethod
    def from_layout(cls, matrix: np.ndarray, mesh: Mesh, layouts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                    metric: str = "cosine", valid: Optional[np.ndarray] = None, axis: str = "data",
                    rows_normalized: bool = False, tile_n: int = 4096, probe_tiles: int = 16, fetch: str = "auto",
                    keep_host: bool = True, tags: Optional[np.ndarray] = None) -> "ShardedClusteredIndex":
        """An index over given per-shard clustered layouts ``(order [T·tile]
        shard-local rows, -1 = hole; centroids [T, d]; radii [T])``, with
        no k-means: a layout built elsewhere (``convert.sharded_clustered_from_jax``)
        carried across."""
        matrix = _normalized(np.asarray(matrix, dtype=np.float32), metric, rows_normalized)
        n = matrix.shape[0]
        s = mesh.shape[axis]
        if len(layouts) != s:
            raise InvalidConfigError(f"got {len(layouts)} shard layouts for a {s}-shard '{axis}' axis")
        tile = max(tile_n, 1024)
        v_host = np.ones(n, dtype=bool) if valid is None else np.asarray(valid, dtype=bool)[:n].copy()
        self = cls.__new__(cls)
        self._place(matrix, v_host, mesh, axis, metric, tile, probe_tiles, fetch, max(-(-n // s), 1),
                    _equal_tiles([np.asarray(o, np.int32) for o, _, _ in layouts],
                                 [np.asarray(c, np.float32) for _, c, _ in layouts],
                                 [np.asarray(r, np.float32) for _, _, r in layouts], tile),
                    keep_host, tags)
        return self
