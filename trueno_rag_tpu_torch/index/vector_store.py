"""Dense vector store: device-resident ``[N, d]`` embedding matrix.

PyTorch counterpart of ``trueno_rag_tpu/index/vector_store.py``, every
scan tier and storage type. Capability-equivalent to the reference's ``VectorStore``
(reference: index.rs:321-437):

- Embeddings live in one capacity-padded device matrix; inserts write a
  host mirror and the device copy refreshes lazily (one transfer per
  mutation batch; bounded mutation sets scatter only the changed rows).
- Cosine metric L2-normalizes rows **once at insert**, so query scoring
  is a single matmul.
- Capacity grows by doubling.
- Removal tombstones the row (mask False + zero row) and recycles it
  through the shared :class:`~trueno_rag_tpu_torch.index.base.ChunkRegistry`.
- ``scan_tier="bf16"`` (or ``"auto"`` past ``scan_tier_auto_rows``)
  keeps a bf16 replica that the certified scan reads (the tile kernel, or
  with ``scan_kernel="block"`` the block kernel), ``"int8"`` an int8 one;
  results stay exactly those of the fp32 path.
- ``storage_dtype="bfloat16"`` stores the device matrix itself in bf16
  (tier "none"), scored with f32 accumulation: approximate, not certified.
- ``scan_tier="compact"`` keeps NO fp32 matrix on the device: the
  replicas of ``compact_scan`` ("bf16r", "bf16rr", "bf16" or "int8")
  build slab by slab from the host rows, certified queries return the
  exact top-k set, and uncertified ones are patched exactly from the host
  matrix (``compact_fallback="host"``).
- ``scan_tier="clustered"`` is the compact bf16r layout reordered by
  balanced k-means, so each storage tile is a cluster with a sound
  centroid+radius bound: a small batch scans only the tiles its queries
  could draw from (``ops/clustered.py``), with the same exact-set
  contract; bounded mutations fold into the layout without a re-cluster.
- Tag filters ride the scan kernels on the compact, clustered and bf16
  tile tiers.

Validation matches the reference: inserting a chunk without an
embedding raises :class:`VectorStoreError`; a wrong-size embedding
raises :class:`DimensionMismatchError`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.chunking import Chunk
from trueno_rag_tpu_torch.device import resolve_device
from trueno_rag_tpu_torch.errors import DimensionMismatchError, InvalidConfigError, VectorStoreError
from trueno_rag_tpu_torch.index.base import ChunkRegistry
from trueno_rag_tpu_torch.ops.dense import dense_topk, require_fp32


class DistanceMetric:
    COSINE = "cosine"
    EUCLIDEAN = "euclidean"
    DOT_PRODUCT = "dot"

    ALL = (COSINE, EUCLIDEAN, DOT_PRODUCT)


@dataclass
class VectorStoreConfig:
    """The JAX package's config, field for field (see its docstrings for
    each knob), every value implemented. ``storage_dtype="bfloat16"``
    keeps the device matrix in bf16 (half the bytes, ~1e-3 relative score
    error; scores accumulate in f32) on ``scan_tier="none"``.
    ``scan_kernel`` "tile" runs the bf16/int8 tiers on the tile kernels
    (K1, K3), "block" on the block kernels (K8, K9).
    ``compact_build`` "auto" and "device" prep the compact replicas on the
    store's device, "host" on the CPU. ``cluster_fetch`` "auto" scans the
    clustered tier's probed tiles in place (K5) on a CUDA device and over
    a copy (K1) on the CPU."""

    dimension: int = 384
    metric: str = DistanceMetric.COSINE
    initial_capacity: int = 1024
    storage_dtype: str = "float32"
    scan_tier: str = "none"
    # store size at which scan_tier="auto" switches fp32 -> bf16 tier
    scan_tier_auto_rows: int = 400_000
    compact_prep_rows: int = 1 << 20
    compact_build: str = "auto"
    compact_scan: str = "bf16r"
    compact_fallback: str = "host"
    compact_retry: bool | None = None
    # candidate-row trim for the tiered rescore; None rescores all
    scan_rescore_rows: int | None = 96
    scan_kernel: str = "tile"
    # candidate rows kept per 1024-row tile
    scan_t_top: int = 4
    # selected tiles beyond k
    scan_margin_tiles: int = 32
    scan_block_top: int = 2
    # corpus padding granule of the tiered scan
    scan_tile_n: int = 4096
    cluster_probe_tiles: int = 16
    cluster_fetch: str = "auto"
    cluster_kmeans_iters: int = 8
    cluster_incremental_limit: float = 0.1

    def __post_init__(self) -> None:
        if self.dimension <= 0:
            raise InvalidConfigError("dimension must be positive")
        if self.metric not in DistanceMetric.ALL:
            raise InvalidConfigError(f"unknown metric {self.metric!r}")
        if self.initial_capacity <= 0:
            raise InvalidConfigError("initial_capacity must be positive")
        if self.storage_dtype not in ("float32", "bfloat16"):
            raise InvalidConfigError(f"unknown storage_dtype {self.storage_dtype!r}")
        if self.scan_tier not in ("none", "auto", "bf16", "int8", "compact", "clustered"):
            raise InvalidConfigError(f"unknown scan_tier {self.scan_tier!r}")
        if self.cluster_fetch not in ("auto", "gather", "dma"):
            raise InvalidConfigError(f"unknown cluster_fetch {self.cluster_fetch!r}")
        if self.cluster_probe_tiles < 1:
            raise InvalidConfigError("cluster_probe_tiles must be >= 1")
        if not 0.0 <= self.cluster_incremental_limit <= 1.0:
            raise InvalidConfigError("cluster_incremental_limit must be in [0, 1]")
        if self.compact_fallback not in ("host", "none"):
            raise InvalidConfigError(f"unknown compact_fallback {self.compact_fallback!r}")
        if self.compact_prep_rows < 1024:
            raise InvalidConfigError("compact_prep_rows must be >= 1024")
        if self.compact_build not in ("auto", "device", "host"):
            raise InvalidConfigError(f"unknown compact_build {self.compact_build!r}")
        if self.compact_scan not in ("bf16r", "bf16rr", "bf16", "int8"):
            raise InvalidConfigError(f"unknown compact_scan {self.compact_scan!r}")
        if self.scan_tile_n <= 0 or self.scan_tile_n % 128 != 0:
            raise InvalidConfigError("scan_tile_n must be a positive multiple of 128")
        if self.scan_block_top < 1:
            raise InvalidConfigError("scan_block_top must be >= 1")
        if self.scan_kernel not in ("tile", "block"):
            raise InvalidConfigError(f"unknown scan_kernel {self.scan_kernel!r}")
        if self.scan_t_top < 1:
            raise InvalidConfigError("scan_t_top must be >= 1")
        if self.scan_margin_tiles < 0:
            raise InvalidConfigError("scan_margin_tiles must be >= 0")
        if self.scan_kernel == "tile" and self.scan_tile_n % 1024 != 0:
            raise InvalidConfigError("scan_kernel='tile' needs scan_tile_n to be a multiple of 1024")
        if self.scan_rescore_rows is not None and self.scan_rescore_rows < 1:
            raise InvalidConfigError("scan_rescore_rows must be None or >= 1")
        if self.scan_tier_auto_rows < 0:
            raise InvalidConfigError("scan_tier_auto_rows must be >= 0")
        if self.scan_tier != "none":
            if self.storage_dtype != "float32":
                raise InvalidConfigError(
                    "scan_tier requires float32 storage (the exact rescore "
                    "reads full-precision rows)"
                )
            if self.metric == DistanceMetric.EUCLIDEAN:
                raise InvalidConfigError("scan_tier supports cosine/dot metrics only")


class VectorStore:
    def __init__(
        self,
        config: Optional[VectorStoreConfig] = None,
        registry: Optional[ChunkRegistry] = None,
        device=None,
    ) -> None:
        self.config = config or VectorStoreConfig()
        self.device = resolve_device(device)
        # a shared registry's lifecycle is owned by the sharer; a private
        # registry is tombstoned directly
        self._owns_registry = registry is None
        self.registry = ChunkRegistry() if registry is None else registry
        cap = self.config.initial_capacity
        self._host = np.zeros((cap, self.config.dimension), dtype=np.float32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._device_matrix: Optional[torch.Tensor] = None
        self._device_valid: Optional[torch.Tensor] = None
        self._dirty = True
        self._dirty_rows: Optional[set] = set()  # None: full re-upload
        self._count = 0
        self._tier = None  # the scan tier's replica arrays, once built
        # which tier's layout ``_tier`` holds: a tier switch rebuilds
        self._tier_built_for = None
        self._tag_bits_cache = None  # (tags_version, device tag words)
        # clustered tier: (order, order on the device, centroids, radii)
        self._cluster = None
        self._cluster_inv = None  # row → permuted position, built lazily
        self._cluster_incremental = 0  # rows placed since the last k-means
        self._cluster_version = 0  # advances with every layout change
        self._tag_bits_clustered_cache = None  # ((tags_version, layout), bits)
        # a clustering carried in (convert.retriever_from_state): consumed
        # by the first clustered build, voided by any mutation, since stale
        # radii would be unsound bounds
        self._cluster_preset = None
        self.tier_fallbacks = 0  # batches with a query re-run or host-patched
        self.tier_fallback_queries = 0  # queries re-run on fp32 (bf16/int8 tiers)
        self.compact_uncertified = 0  # compact-tier queries past the certificate
        self.compact_retry_certified = 0  # rescued by the widened device retry
        # provable worst-case score error of best-effort results: the max
        # over still-uncertified queries of (exclusion upper bound − min
        # selected lower bound); inf when a retry failure mode voided it
        self.compact_uncertified_bound = 0.0
        # host patches: queries resolved exactly from the candidate rows
        # alone vs. queries that needed the full host-matrix GEMM
        self.compact_candidate_patched = 0
        self.compact_gemm_patched = 0

    # -- mutation ------------------------------------------------------------

    def validate_chunk(self, chunk: Chunk) -> None:
        """Raise exactly what :meth:`insert` would, without mutating."""
        if chunk.embedding is None:
            raise VectorStoreError(f"chunk {chunk.id} has no embedding")
        emb = np.asarray(chunk.embedding, dtype=np.float32)
        if emb.shape != (self.config.dimension,):
            raise DimensionMismatchError(self.config.dimension, int(emb.shape[-1]) if emb.ndim else 0)

    def insert(self, chunk: Chunk) -> None:
        self.validate_chunk(chunk)
        emb = np.asarray(chunk.embedding, dtype=np.float32)
        row = self.registry.add(chunk)
        self._ensure_capacity(row + 1)
        if self.config.metric == DistanceMetric.COSINE:
            n = float(np.linalg.norm(emb))
            if n > 0.0:
                emb = emb / n
        if not self._valid[row]:
            self._count += 1
        self._host[row] = emb
        self._valid[row] = True
        self._mark_dirty(row)

    def insert_many(self, chunks: Sequence[Chunk]) -> None:
        """Bulk insert in one vectorized pass. Validation runs before any
        mutation, so a bad chunk leaves the store untouched."""
        if not chunks:
            return
        d = self.config.dimension
        try:
            embs = np.asarray([chunk.embedding for chunk in chunks], dtype=np.float32)
            if embs.ndim != 2 or embs.shape != (len(chunks), d):
                raise ValueError
        except (ValueError, TypeError):
            for chunk in chunks:
                self.validate_chunk(chunk)
            raise VectorStoreError("embeddings could not be stacked")
        rows = np.asarray(self.registry.add_batch(chunks), dtype=np.int64)
        self._ensure_capacity(int(rows.max()) + 1)
        if self.config.metric == DistanceMetric.COSINE:
            norms = np.sqrt(np.einsum("ij,ij->i", embs, embs))[:, None]
            embs /= np.where(norms > 0.0, norms, 1.0)
        # duplicate ids in one batch share a row; count each row once
        # (fancy assignment keeps the LAST write: sequential replace)
        uniq = np.unique(rows)
        self._count += int(np.count_nonzero(~self._valid[uniq]))
        self._host[rows] = embs
        self._valid[rows] = True
        self._dirty = True
        self._cluster_preset = None  # mutated rows void a carried clustering
        if self._dirty_rows is not None:
            if len(self._dirty_rows) + len(uniq) > max(64, self._host.shape[0] // 20):
                self._dirty_rows = None  # full re-upload beats scatter
            else:
                self._dirty_rows.update(int(r) for r in uniq)

    def remove(self, chunk_id: str) -> bool:
        row = self.registry.row_of(chunk_id)
        if row is None or not self._valid[row]:
            return False
        if self._owns_registry:
            self.registry.remove(chunk_id)
        self._host[row] = 0.0
        self._valid[row] = False
        self._count -= 1
        self._mark_dirty(row)
        return True

    def _mark_dirty(self, row: int) -> None:
        self._dirty = True
        self._cluster_preset = None  # mutated rows void a carried clustering
        if self._dirty_rows is not None:
            self._dirty_rows.add(row)
            # beyond ~5% of capacity a full upload is cheaper than scatter
            if len(self._dirty_rows) > max(64, self._host.shape[0] // 20):
                self._dirty_rows = None

    def _ensure_capacity(self, needed: int) -> None:
        cap = self._host.shape[0]
        if needed <= cap:
            return
        while cap < needed:
            cap *= 2
        host = np.zeros((cap, self.config.dimension), dtype=np.float32)
        host[: self._host.shape[0]] = self._host
        valid = np.zeros((cap,), dtype=bool)
        valid[: self._valid.shape[0]] = self._valid
        self._host, self._valid = host, valid
        self._dirty = True
        self._dirty_rows = None  # capacity changed: full re-upload

    # -- device state ----------------------------------------------------------

    def _refresh_device(self) -> None:
        if self._effective_tier() == "compact":
            self._refresh_device_compact()
            return
        if self._effective_tier() == "clustered":
            self._refresh_device_clustered()
            return
        if (
            not self._dirty
            and self._device_matrix is not None
            and self._tier_built_for == self._effective_tier()
        ):
            return
        if (
            self._device_matrix is not None
            and self._dirty_rows  # bounded, non-empty row set
            and self._device_matrix.shape[0] == self._host.shape[0]
        ):
            # incremental: ship only the changed rows and scatter them in
            idx = np.fromiter(self._dirty_rows, dtype=np.int64)
            rows = torch.from_numpy(idx).to(self.device)
            updates = torch.from_numpy(self._host[idx]).to(self.device)
            self._device_matrix[rows] = updates.to(self._device_matrix.dtype)
            self._device_valid[rows] = torch.from_numpy(self._valid[idx]).to(self.device)
            self._refresh_tier(rows=rows, updates=updates)
        else:
            # copy=True: on the CPU a plain .to() would alias the host mirror
            dtype = torch.bfloat16 if self.config.storage_dtype == "bfloat16" else torch.float32
            self._device_matrix = torch.from_numpy(self._host).to(self.device, dtype=dtype, copy=True)
            self._device_valid = torch.from_numpy(self._valid).to(self.device, copy=True)
            self._refresh_tier()
        self._dirty = False
        self._dirty_rows = set()

    def _compact_prep(self, m: torch.Tensor):
        """The compact layout's replica parts of rows ``m`` (f32)."""
        from trueno_rag_tpu_torch.ops import dense_tiered as dt

        parts = dt.prepare_tiered(m)
        extra = {
            "bf16r": dt.prepare_residual,
            "bf16rr": dt.prepare_residual2,
            "int8": dt.prepare_int8,
        }.get(self.config.compact_scan)
        return parts + extra(m) if extra is not None else parts

    def _refresh_device_compact(self) -> None:
        """Compact tier: the fp32 matrix never resides on the device. The
        replicas (the bf16 scan+rescore copy, plus the residual levels or
        the int8 scan copy of the layout, with their norms) build slab by
        slab from host rows; mutations scatter only the changed rows'
        re-prepared replicas."""
        if not self._dirty and self._tier is not None and self._tier_built_for == "compact":
            return
        self._device_matrix = None  # the whole point of this tier
        self._cluster = None  # the compact layout is row order, not clustered
        if (
            self._tier is not None
            and self._tier_built_for == "compact"
            and self._dirty_rows  # bounded, non-empty row set
            and self._tier[0].shape[0] == self._host.shape[0]
        ):
            idx = np.fromiter(self._dirty_rows, dtype=np.int64)
            rows = torch.from_numpy(idx).to(self.device)
            parts = self._compact_prep(torch.from_numpy(self._host[idx]).to(self.device))
            for full, part in zip(self._tier, parts):
                full[rows] = part
            self._device_valid[rows] = torch.from_numpy(self._valid[idx]).to(self.device)
        else:
            self._tier = None  # free the old replicas before the build
            # per compact_build, a slab is prepped on the store's device
            # ("auto" and "device": the upload is raw f32) or on the host
            # CPU ("host"); the caller's choice, never a fallback
            prep_dev = torch.device("cpu") if self.config.compact_build == "host" else self.device
            self._tier = self._stream_build_tier(
                self._host.shape[0],
                lambda lo, hi: torch.from_numpy(self._host[lo:hi]).to(prep_dev),
                self._compact_prep,
            )
            self._device_valid = torch.from_numpy(self._valid).to(self.device, copy=True)
        self._tier_built_for = "compact"
        self._dirty = False
        self._dirty_rows = set()

    def _stream_build_tier(self, n: int, rows_of, prep):
        """Full replica build, streamed: f32 rows ``rows_of(lo, hi)`` are
        prepped slab by slab (``compact_prep_rows`` rows) and copied into
        ``n``-row replicas preallocated on the device, so the transient is
        one slab's parts, not a second copy of every replica. The prep
        code is the same wherever a slab is prepped, so every certificate
        array is computed from the exact replica bytes it will sit next
        to."""
        step = self.config.compact_prep_rows
        dests = None
        for lo in range(0, n, step):
            slab = rows_of(lo, min(lo + step, n))
            parts = prep(slab)
            if dests is None:
                dests = [
                    torch.empty((n,) + p.shape[1:], dtype=p.dtype, device=self.device)
                    for p in parts
                ]
            for dest, part in zip(dests, parts):
                dest[lo : lo + part.shape[0]].copy_(part)  # in place: no second replica
            del parts, slab
        return tuple(dests)

    @staticmethod
    def _clustered_prep(m: torch.Tensor):
        """The clustered layout's replica parts of rows ``m`` (f32): the
        compact bf16r layout."""
        from trueno_rag_tpu_torch.ops import dense_tiered as dt

        return dt.prepare_tiered(m) + dt.prepare_residual(m)

    def _refresh_device_clustered(self) -> None:
        """Clustered tier: the compact bf16r replicas in the balanced
        k-means layout, plus per-tile centroid/radius bounds
        (ops/clustered.py). Bounded mutations fold into the existing layout
        (:meth:`_try_incremental_clustered`, radii only widen); anything
        else re-clusters: from a carried-in clustering if one is set, else
        on the device, reading a fresh fp32 device matrix when one is
        resident and host slabs otherwise. The
        permuted replicas build slab by slab; no fp32 matrix stays on the
        device."""
        if (
            not self._dirty
            and self._tier is not None
            and self._cluster is not None
            and self._tier_built_for == "clustered"
        ):
            return
        from trueno_rag_tpu_torch.ops import clustered as cl

        tile = max(self.config.scan_tile_n, 1024)
        if self._try_incremental_clustered(tile):
            self._dirty = False
            self._dirty_rows = set()
            return
        dev_m = self._device_matrix
        dev_fresh = (
            dev_m is not None
            and not self._dirty
            and dev_m.dtype == torch.float32
            and dev_m.shape[0] == self._host.shape[0]
        )
        preset, self._cluster_preset = self._cluster_preset, None
        kw = dict(
            tile_n=tile, metric=self.config.metric, iters=self.config.cluster_kmeans_iters,
            valid=self._valid,  # capacity padding must not join tiles
        )
        if preset is not None and preset["tile"] == tile:
            # a carried clustering of exactly this host state (any mutation
            # since cleared it) and this tile size: no k-means
            order = np.asarray(preset["order"], dtype=np.int32)
            cent = np.asarray(preset["centroids"], dtype=np.float32)
            radii = np.asarray(preset["radii"], dtype=np.float32)
        elif dev_fresh:
            order, cent, radii = cl.prepare_clustered_device(dev_m, **kw)
        else:  # the host rows stream to the device slab by slab
            host = self._host
            order, cent, radii = cl.prepare_clustered_stream(
                lambda ids: torch.from_numpy(host[ids]).to(self.device), *host.shape, **kw
            )
        self._tier = None  # free the old replicas before the build
        self._device_matrix = None  # no fp32 matrix on the device (compact contract)
        if dev_fresh:  # permute slab by slab: no full permuted f32 copy
            def rows_of(lo, hi):
                return cl.apply_cluster_order_device(dev_m, order[lo:hi])
        else:
            def rows_of(lo, hi):
                return torch.from_numpy(cl.apply_cluster_order(self._host, order[lo:hi])).to(self.device)
        self._tier = self._stream_build_tier(len(order), rows_of, self._clustered_prep)
        del dev_m
        self._device_valid = torch.from_numpy(cl.apply_cluster_order(self._valid, order, fill=False)).to(self.device)
        self._cluster = (
            order,
            torch.from_numpy(order).to(self.device),
            torch.from_numpy(cent).to(self.device),
            torch.from_numpy(radii).to(self.device),
        )
        self._cluster_inv = None  # rebuilt lazily by the incremental path
        self._cluster_incremental = 0  # fresh k-means: the drift budget resets
        self._cluster_version += 1
        self._tier_built_for = "clustered"
        self._dirty = False
        self._dirty_rows = set()

    def _try_incremental_clustered(self, tile: int) -> bool:
        """Fold a bounded set of mutated rows into the EXISTING clustered
        layout instead of re-running k-means: removals become holes,
        in-place updates keep their slot, new rows fill a hole in their
        best-scoring tile, and every touched tile's radius WIDENS to the
        slack-covered f64 distance of the new value, so the tile bound
        stays a true upper bound. What drifts is pruning selectivity;
        ``cluster_incremental_limit`` caps it (past that fraction of live
        rows the caller re-clusters).

        Returns False, and the caller runs the full build, when the budget
        is spent, a new row finds no hole anywhere, the dirty set is
        unbounded (capacity growth, bulk mutation) or no clustered layout
        exists; nothing has been changed then (placement runs on copies and
        applies only once every row has a slot)."""
        if (
            self.config.cluster_incremental_limit <= 0.0
            or self._cluster is None
            or self._tier is None
            or self._tier_built_for != "clustered"
            or not self._dirty_rows  # None (unbounded) or empty
        ):
            return False
        order_np, order_t, cent_t, radii_t = self._cluster
        if self._tier[0].shape[0] != len(order_np):
            return False
        dirty = sorted(self._dirty_rows)
        budget = int(self.config.cluster_incremental_limit * max(self._count, 1))
        if self._cluster_incremental + len(dirty) > budget:
            return False
        from trueno_rag_tpu_torch.ops.dense_tiered import _BOUND_EPS, _BOUND_SLACK

        order = order_np.copy()
        radii = radii_t.cpu().numpy().copy()
        cent = cent_t.cpu().numpy()
        if self._cluster_inv is not None and len(self._cluster_inv) == self._host.shape[0]:
            inv = self._cluster_inv.copy()
        else:
            inv = np.full(self._host.shape[0], -1, dtype=np.int64)
            live = order >= 0
            inv[order[live]] = np.flatnonzero(live)
        holes: dict = {}  # tile → hole positions, pop() gives the lowest
        for p in np.flatnonzero(order < 0)[::-1]:
            holes.setdefault(int(p) // tile, []).append(int(p))

        sets: list = []  # (permuted position, original row): replica rewrites
        clears: list = []  # permuted positions that become holes
        new_rows: list = []
        for r in dirty:
            p = int(inv[r])
            alive = bool(self._valid[r])
            if p >= 0 and not alive:  # removal: a hole; the radius stays sound
                order[p] = -1
                inv[r] = -1
                holes.setdefault(p // tile, []).append(p)
                clears.append(p)
            elif p >= 0:  # in-place update: same slot, widened radius
                sets.append((p, r))
            elif alive:
                new_rows.append(r)
            # else: inserted and removed between refreshes, never placed
        if new_rows:
            xs = self._host[new_rows]  # [M, d] f32
            # the build's shifted-dot preference (argmin ‖x−µ‖²); quality only
            sc = xs @ cent.T - 0.5 * np.einsum("td,td->t", cent, cent)[None, :]
            pref = np.argsort(-sc, axis=1, kind="stable")
            for i, r in enumerate(new_rows):
                pos = -1
                for c in pref[i]:
                    lst = holes.get(int(c))
                    if lst:
                        pos = lst.pop()
                        break
                if pos < 0:
                    return False  # every tile full: re-cluster
                order[pos] = r
                inv[r] = pos
                sets.append((pos, r))
        # widen radii over the exact stored f32 values (f64, the host
        # build's slack form)
        for pos, r in sets:
            c = pos // tile
            diff = self._host[r].astype(np.float64) - cent[c].astype(np.float64)
            need = np.float32(float(np.sqrt((diff * diff).sum())) * _BOUND_SLACK + _BOUND_EPS)
            if need > radii[c]:
                radii[c] = need

        # -- apply (host copies are complete; device scatters follow) ------
        dev = self.device
        if clears:  # before sets: a cleared hole may be refilled in this batch
            self._device_valid[torch.tensor(clears, dtype=torch.long, device=dev)] = False
        if sets:
            pos_t = torch.tensor([p for p, _ in sets], dtype=torch.long, device=dev)
            rows = np.asarray([r for _, r in sets], dtype=np.int64)
            parts = self._clustered_prep(torch.from_numpy(self._host[rows]).to(dev))
            for full, part in zip(self._tier, parts):
                full[pos_t] = part
            self._device_valid[pos_t] = True
        touched = np.asarray([p for p, _ in sets] + clears, dtype=np.int64)
        if len(touched):
            order_t[torch.from_numpy(touched).to(dev)] = torch.from_numpy(order[touched]).to(dev)
        self._cluster = (order, order_t, cent_t, torch.from_numpy(radii).to(dev))
        self._cluster_inv = inv
        self._cluster_incremental += len(dirty)
        self._cluster_version += 1
        return True

    def _effective_tier(self) -> str:
        """Resolve "auto": the bf16 tier once the store holds
        ``scan_tier_auto_rows`` rows (the crossover is a tuned constant of
        the JAX package, not yet measured on this port)."""
        tier = self.config.scan_tier
        if tier == "auto":
            return "bf16" if self._count >= self.config.scan_tier_auto_rows else "none"
        return tier

    @property
    def supports_tagged_scan(self) -> bool:
        """True when :meth:`search_arrays` accepts ``tag_masks``: the
        filter rides the scan kernel (compact or clustered tier, or the
        bf16 tile tier). The retriever keeps filtered queries on the fast
        tier then, instead of the full fp32 tagged scan."""
        tier = self._effective_tier()
        return tier in ("compact", "clustered") or (tier == "bf16" and self.config.scan_kernel == "tile")

    @property
    def is_compact(self) -> bool:
        """True when this store holds no fp32 device matrix (compact or
        clustered tier): callers that need ``device_matrix`` must take a
        staged path instead; hybrid and tag-filtered queries stage
        automatically."""
        return self._effective_tier() in ("compact", "clustered")

    def _refresh_tier(self, rows=None, updates=None) -> None:
        """Maintain the bf16 or int8 replica. The quantization/residual
        math is row-local, so incremental mutations prepare ONLY the
        changed rows and scatter them into the replica arrays."""
        tier = self._effective_tier()
        built_for, self._tier_built_for = self._tier_built_for, tier
        self._cluster = None  # these layouts are row order, not clustered
        if tier == "none":
            self._tier = None
            return
        from trueno_rag_tpu_torch.ops import dense_tiered as dt

        prepare = dt.prepare_tiered if tier == "bf16" else dt.prepare_int8
        if rows is None or self._tier is None or built_for != tier:
            self._tier = prepare(self._device_matrix)
            return
        for full, part in zip(self._tier, prepare(updates)):
            full[rows] = part

    @property
    def device_matrix(self) -> torch.Tensor:
        """The ``[capacity, d]`` device matrix (cosine rows normalized), in
        the ``storage_dtype``."""
        if self.is_compact:
            raise InvalidConfigError(
                f"scan_tier={self._effective_tier()!r} holds no fp32 device matrix "
                "(that is its memory contract); hybrid and tag-filtered queries "
                "run staged automatically"
            )
        self._refresh_device()
        return self._device_matrix

    @property
    def device_valid(self) -> torch.Tensor:
        self._refresh_device()
        return self._device_valid

    def ensure_ready(self) -> None:
        """Apply pending mutations to the device state now instead of on
        the next query."""
        self._refresh_device()

    # -- queries -----------------------------------------------------------------

    def search_arrays(
        self, queries, k: int, tag_masks=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-level search: host ``[B, d]`` queries (array-like) →
        ``(scores, rows) [B, k]`` tensors on ``self.device``.

        ``tag_masks`` = per-query ``(t_all [B], t_any [B], t_none [B])``
        int32 filter words (see
        :func:`trueno_rag_tpu_torch.retrieve.resolve_tag_filters`),
        accepted where the filter rides the scan kernel
        (:attr:`supports_tagged_scan`): the compact and clustered tiers
        (certified exact filtered sets, filter-aware host patch) and the
        bf16 tile tier
        (exact filtered results; uncertified queries fall back to the
        tagged fp32 scan). Other tiers filter in the retriever through
        :func:`trueno_rag_tpu_torch.ops.tags.dense_topk_tagged`."""
        self._refresh_device()
        require_fp32()
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, dtype=np.float32))).to(self.device)
        if q.shape[-1] != self.config.dimension:
            raise DimensionMismatchError(self.config.dimension, int(q.shape[-1]))
        k_eff = min(k, self._host.shape[0])
        if tag_masks is not None and not self.supports_tagged_scan:
            raise InvalidConfigError(
                "search_arrays(tag_masks=...) rides the scan kernel: compact, "
                "clustered or bf16 tile tier only; other tiers filter via "
                "ops.tags.dense_topk_tagged"
            )
        if self._effective_tier() == "compact":
            return self._search_compact(q, k_eff, tag_masks)
        if self._effective_tier() == "clustered":
            return self._search_clustered(q, k_eff, tag_masks)
        if self._tier is None:
            return dense_topk(q, self._device_matrix, self._device_valid, k_eff, self.config.metric)
        from trueno_rag_tpu_torch.ops import dense_tiered as dt

        kw = dict(
            metric=self.config.metric,
            rescore_rows=self.config.scan_rescore_rows,
            tile_n=self.config.scan_tile_n,
        )
        bf16 = self._effective_tier() == "bf16"
        if self.config.scan_kernel == "block":
            checked = dt.dense_topk_tiered_checked if bf16 else dt.dense_topk_int8_checked
            kw.update(block_top=self.config.scan_block_top)
        else:
            checked = dt.dense_topk_tiered2_checked if bf16 else dt.dense_topk_int8_tiered2_checked
            kw.update(t_top=self.config.scan_t_top, margin_tiles=self.config.scan_margin_tiles)
            if bf16:
                kw.update(tags=self._scan_tags(tag_masks))
        scores, rows, n_fallback = checked(q, self._device_matrix, *self._tier, self._device_valid, k_eff, **kw)
        if n_fallback:
            self.tier_fallbacks += 1
            self.tier_fallback_queries += n_fallback
        return scores, rows

    def _compact_fn(self):
        from trueno_rag_tpu_torch.ops import dense_tiered as dt

        return {
            "bf16r": dt.dense_topk_compact_bf16r,
            "bf16rr": dt.dense_topk_compact_bf16rr,
            "bf16": dt.dense_topk_compact_bf16,
            "int8": dt.dense_topk_compact,
        }[self.config.compact_scan]

    def _search_compact(self, q: torch.Tensor, k: int, tag_masks):
        """The compact tier's search: the certified scan, then (per
        ``compact_retry``/``compact_fallback``) the widened device retry
        and the staged exact host patch of uncertified queries."""
        host_fb = self.config.compact_fallback == "host"
        out = self._compact_fn()(
            q, *self._tier, self._device_valid, k,
            metric=self.config.metric,
            rescore_rows=self.config.scan_rescore_rows,
            t_top=self.config.scan_t_top,
            margin_tiles=self.config.scan_margin_tiles,
            tile_n=self.config.scan_tile_n,
            tags=self._scan_tags(tag_masks),
            # candidate rows + tile threshold feed the containment patch
            return_candidates=host_fb,
        )
        scores, rows, ok = out[:3]
        ok_np = ok.cpu().numpy()
        if ok_np.all():
            return scores, rows
        retry = self.config.compact_retry
        # AUTO (None): under the host fallback the cheap exact candidate
        # patch runs first and the widened retry serves its containment
        # failures; under fallback="none" the retry is the only step
        retry_all = retry is True or (retry is None and not host_fb)
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        if retry_all:
            scores, rows, ok_np = self._compact_device_retry(q, scores, rows, ok_np, k, tag_masks)
        if not ok_np.all():
            self.compact_uncertified += int((~ok_np).sum())
            if host_fb:
                scores, rows = self._compact_exact_patch(
                    q, scores, rows, ok_np, k, out[3].cpu().numpy(), out[4].cpu().numpy(),
                    tag_masks, containment_retry=retry is not False,
                )
                self.tier_fallbacks += 1
        return torch.from_numpy(scores).to(self.device), torch.from_numpy(rows).to(self.device)

    def _search_clustered(self, q: torch.Tensor, k: int, tag_masks):
        """The clustered tier's search: the pruned certified scan (K5 in
        place, or K1 over a copy of the union, per ``cluster_fetch``), then
        under ``compact_fallback="host"`` the candidate patch and, only for
        queries the containment cannot settle, the host GEMM patch."""
        from trueno_rag_tpu_torch.ops import clustered as cl

        order_np, order_t, cent_t, radii_t = self._cluster
        tags = None
        if tag_masks is not None:
            tags = (self._device_tag_bits_clustered(order_np),) + tuple(
                torch.from_numpy(np.asarray(m, np.int32)).to(self.device) for m in tag_masks
            )
        host_fb = self.config.compact_fallback == "host"
        out = cl.dense_topk_compact_bf16r_clustered(
            q, *self._tier, self._device_valid, k, cent_t, radii_t,
            return_candidates=host_fb,
            probe_tiles=self.config.cluster_probe_tiles,
            row_map=order_t,  # results in original row ids
            metric=self.config.metric,
            # a clustered corpus concentrates its top-k in few tiles: t_top
            # follows the request, with 4 runner-up slots whose fp32
            # rescore keeps near-duplicates certifiable; the kernel's pool
            # holds 16 per 1024-row tile
            t_top=min(max(self.config.scan_t_top, 8, k + 4), 16),
            margin_tiles=self.config.scan_margin_tiles,
            tile_n=max(self.config.scan_tile_n, 1024),
            fetch=cl.resolve_cluster_fetch(self.config.cluster_fetch, self.device),
            tags=tags,
        )
        scores, rows, ok = out[:3]
        ok_np = ok.cpu().numpy()
        if ok_np.all():
            return scores, rows
        self.compact_uncertified += int((~ok_np).sum())
        if host_fb:
            # the pruned-tile bound is folded into the returned threshold,
            # so the candidates contain the exact top-k wherever it is
            # below the exact k-th score; the GEMM only for the rest
            q_np = q.cpu().numpy()
            s_np, r_np, unresolved = self._host_candidate_patch(
                q_np, scores.cpu().numpy(), rows.cpu().numpy(), ok_np, k,
                out[3].cpu().numpy(), out[4].cpu().numpy(), tag_masks=tag_masks, resolve_rest=False,
            )
            if len(unresolved):
                gm = np.ones_like(ok_np)
                gm[unresolved] = False
                s_np, r_np = self._host_exact_patch(q_np, s_np, r_np, gm, k, tag_masks=tag_masks)
                self.compact_gemm_patched += len(unresolved)
            scores, rows = torch.from_numpy(s_np).to(self.device), torch.from_numpy(r_np).to(self.device)
            self.tier_fallbacks += 1
        return scores, rows

    def _device_tag_bits_clustered(self, order: np.ndarray) -> torch.Tensor:
        """The registry's tag words in the clustered layout (the kernel
        reads permuted rows), cached against (tags_version, layout)."""
        from trueno_rag_tpu_torch.ops.clustered import apply_cluster_order

        version = (self.registry.tags_version, self._cluster_version)
        cached = self._tag_bits_clustered_cache
        if cached is not None and cached[0] == version:
            return cached[1]
        bits = apply_cluster_order(self.registry.tags_host(self._host.shape[0]), order, fill=0)
        bits = torch.from_numpy(bits).to(self.device)
        self._tag_bits_clustered_cache = (version, bits)
        return bits

    def _device_tag_bits(self) -> torch.Tensor:
        """Capacity-sized device copy of the registry's per-row tag
        words, cached against the registry's ``tags_version``."""
        version = self.registry.tags_version
        n = self._host.shape[0]
        cached = self._tag_bits_cache
        if cached is not None and cached[0] == version and cached[1].shape[0] == n:
            return cached[1]
        bits = torch.from_numpy(self.registry.tags_host(n)).to(self.device)
        self._tag_bits_cache = (version, bits)
        return bits

    def _scan_tags(self, tag_masks, sel=None):
        """The scan kernels' ``tags`` argument for host filter words
        (optionally only the queries ``sel``); None without a filter."""
        if tag_masks is None:
            return None
        words = [np.asarray(m, np.int32) for m in tag_masks]
        if sel is not None:
            words = [w[sel] for w in words]
        return (self._device_tag_bits(), *(torch.from_numpy(w).to(self.device) for w in words))

    def _compact_device_retry(self, q, scores, rows, ok_np, k, tag_masks=None,
                              return_candidates=False):
        """Widened device re-scan of just the uncertified compact-tier
        queries (see ``compact_retry``): margin_tiles x4 (>= 128), every
        emitted candidate rescored (no ``rescore_rows`` trim), t_top 8.
        Returns (scores, rows, ok) with rescued queries merged in, plus
        the retry's candidates and thresholds aligned to the full batch
        when ``return_candidates``; for queries that STILL fail, records
        the provable worst-case score error in
        ``compact_uncertified_bound`` (bf16r/bf16rr only — the other
        layouts don't expose bounds)."""
        bad = np.flatnonzero(~ok_np)
        q_bad = q[torch.from_numpy(bad).to(q.device)]
        kwargs = dict(
            metric=self.config.metric,
            rescore_rows=None,
            t_top=max(8, self.config.scan_t_top),
            margin_tiles=max(128, 4 * self.config.scan_margin_tiles),
            tile_n=self.config.scan_tile_n,
            tags=self._scan_tags(tag_masks, bad),
        )
        bound = cand_full = thr_full = None
        if self.config.compact_scan in ("bf16r", "bf16rr"):
            out2 = self._compact_fn()(
                q_bad, *self._tier, self._device_valid, k,
                return_bounds=True, return_candidates=return_candidates, **kwargs,
            )
            s2, r2, ok2, err2, rhs2 = (x.cpu().numpy() for x in out2[:5])
            if return_candidates:
                # the retry's candidates, aligned to the full batch for a
                # second containment patch: the widened threshold sits far
                # below the primary's
                c2, t2 = out2[5].cpu().numpy(), out2[6].cpu().numpy()
                cand_full = np.full((len(ok_np), c2.shape[1]), -1, np.int64)
                thr_full = np.full((len(ok_np),), np.inf, np.float64)
                cand_full[bad] = c2
                thr_full[bad] = t2
            sel_lower = np.where(np.isneginf(s2), np.inf, s2 - err2).min(axis=1)
            bound = np.maximum(rhs2 - np.where(np.isinf(sel_lower), -np.inf, sel_lower), 0.0)
        else:
            out2 = self._compact_fn()(q_bad, *self._tier, self._device_valid, k, **kwargs)
            s2, r2, ok2 = (x.cpu().numpy() for x in out2)
        scores, rows = scores.copy(), rows.copy()
        fixed = bad[ok2]
        scores[fixed] = s2[ok2]
        rows[fixed] = r2[ok2]
        # the widened pass is usually the better best-effort answer even
        # where uncertified, but a concentrated corpus can overflow the
        # per-tile pool and come back SHORTER: adopt it only when it found
        # at least as many valid rows
        still = ~ok2
        better = (r2 >= 0).sum(axis=1) >= (rows[bad] >= 0).sum(axis=1)
        adopt = still & better
        scores[bad[adopt]] = s2[adopt]
        rows[bad[adopt]] = r2[adopt]
        self.compact_retry_certified += int(ok2.sum())
        if bound is not None and still.any():
            # a non-adopted (shorter) widened result leaves the primary
            # best-effort in place, whose error the bounds don't cover
            b_vals = np.where(better, bound, np.inf)[still]
            self.compact_uncertified_bound = max(self.compact_uncertified_bound, float(np.max(b_vals)))
        out_ok = ok_np.copy()
        out_ok[fixed] = True
        if return_candidates:
            return scores, rows, out_ok, cand_full, thr_full
        return scores, rows, out_ok

    def _compact_exact_patch(self, q, scores, rows, ok_np, k, cand, thr,
                             tag_masks=None, containment_retry=True):
        """Staged exact resolution of uncertified compact queries, in
        increasing cost order:

        1. candidate patch — exact f64 rescore of the primary pass's
           candidate rows where the containment certificate holds;
        2. widened device retry (bf16r/bf16rr) WITH its own candidates —
           it either certifies outright or its far lower tile threshold
           restores containment for another candidate patch;
        3. streamed full-matrix host GEMM (counted in
           ``compact_gemm_patched``)."""
        q_np = q.cpu().numpy()
        scores, rows, unresolved = self._host_candidate_patch(
            q_np, scores, rows, ok_np, k, cand, thr, tag_masks=tag_masks, resolve_rest=False)
        if (len(unresolved) and containment_retry
                and self.config.compact_scan in ("bf16r", "bf16rr")):
            nok = np.ones_like(ok_np)
            nok[unresolved] = False
            scores, rows, nok2, cand2, thr2 = self._compact_device_retry(
                q, scores, rows, nok, k, tag_masks, return_candidates=True)
            unresolved = np.flatnonzero(~nok2)
            if len(unresolved):
                scores, rows, unresolved = self._host_candidate_patch(
                    q_np, scores, rows, nok2, k, cand2, thr2,
                    tag_masks=tag_masks, resolve_rest=False)
        if len(unresolved):
            gm = np.ones_like(ok_np)
            gm[unresolved] = False
            scores, rows = self._host_exact_patch(q_np, scores, rows, gm, k, tag_masks=tag_masks)
            self.compact_gemm_patched += len(unresolved)
        return scores, rows

    @staticmethod
    def _host_allowed(bits: np.ndarray, bad: np.ndarray, tag_masks) -> np.ndarray:
        """The tag predicate of the queries ``bad`` on host tag words
        ``bits`` ([len(bad), W] or [1, W])."""
        from trueno_rag_tpu_torch.ops.tags import tag_pred

        return tag_pred(bits, *(np.asarray(m, np.int32)[bad, None] for m in tag_masks))

    def _host_queries(self, q: np.ndarray, bad: np.ndarray) -> np.ndarray:
        """The queries ``bad`` in float64, normalized for cosine."""
        qv = q[bad].astype(np.float64)
        if self.config.metric == DistanceMetric.COSINE:
            nrm = np.linalg.norm(qv, axis=1, keepdims=True)
            qv = qv / np.where(nrm == 0.0, 1.0, nrm)
        return qv

    def _host_candidate_patch(self, q, scores, rows, ok_np, k, cand_rows, cand_thr,
                              tag_masks=None, resolve_rest=True):
        """Exact patch for uncertified compact queries via the
        CONTAINMENT certificate: ``cand_thr`` (the scan's tile-level
        threshold) bounds the TRUE score of every row outside
        ``cand_rows``. The host rescores just the candidate rows in
        float64 ((score desc, row asc) ties); where the k-th exact
        candidate score strictly beats the threshold, the exact top-k set
        lies inside the candidates, and the patched result carries the
        full exact contract at O(W·d) host cost. Containment failures go
        to :meth:`_host_exact_patch`, or with ``resolve_rest=False`` are
        returned as the third element for the caller's next stage."""
        bad = np.flatnonzero(~ok_np)
        n = self._host.shape[0]
        scores = scores.copy()
        rows = rows.copy()
        cr = np.asarray(cand_rows, np.int64)[bad]  # [B', W]
        live = (cr >= 0) & (cr < n)
        cr_safe = np.where(live, cr, 0)
        live &= self._valid[cr_safe]
        if tag_masks is not None:
            # defensive re-filter (the kernel already masked disallowed rows)
            live &= self._host_allowed(self.registry.tags_host(n)[cr_safe], bad, tag_masks)
        # duplicate candidate rows keep their first occurrence only; dead
        # slots all sort to the same padding value, so the check skips them
        pad_v = np.iinfo(np.int64).max
        srt = np.sort(np.where(live, cr, pad_v), axis=1)
        if ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != pad_v)).any():
            for bi in range(cr.shape[0]):
                seen = set()
                for wi in range(cr.shape[1]):
                    if live[bi, wi]:
                        r = int(cr[bi, wi])
                        if r in seen:
                            live[bi, wi] = False
                        seen.add(r)
        gathered = self._host[cr_safe].astype(np.float64)  # [B', W, d]
        s = np.einsum("bwd,bd->bw", gathered, self._host_queries(q, bad))
        s[~live] = -np.inf
        # (score desc, row asc) within candidates; dead slots last
        kk = min(k, cr.shape[1])  # starved selections can have W < k
        order = np.lexsort((np.where(live, cr, pad_v), -s), axis=-1)[:, :kk]
        top_s = np.take_along_axis(s, order, axis=1)
        top_r = np.take_along_axis(cr_safe, order, axis=1)
        if kk < k:
            top_s = np.pad(top_s, ((0, 0), (0, k - kk)), constant_values=-np.inf)
            top_r = np.pad(top_r, ((0, 0), (0, k - kk)), constant_values=0)
        thr_b = np.asarray(cand_thr, np.float64)[bad]
        s_k = top_s[:, -1] if k > 0 else np.full(len(bad), -np.inf)
        # containment: every non-candidate row provably below the k-th
        # exact candidate score; short allowed sets need thr == -inf
        contained = np.where(live.sum(axis=1) >= k, thr_b < s_k, np.isneginf(thr_b))
        dead = np.isneginf(top_s)
        top_r = np.where(dead, -1, top_r)
        fixed = bad[contained]
        scores[fixed] = top_s.astype(np.float32)[contained]
        rows[fixed] = top_r[contained]
        self.compact_candidate_patched += int(contained.sum())
        unresolved = bad[~contained]
        if not resolve_rest:
            return scores, rows, unresolved
        if len(unresolved):
            gemm_mask = np.ones_like(ok_np)
            gemm_mask[unresolved] = False
            scores, rows = self._host_exact_patch(q, scores, rows, gemm_mask, k, tag_masks=tag_masks)
            self.compact_gemm_patched += len(unresolved)
        return scores, rows

    def _host_exact_patch(self, q, scores, rows, ok_np, k, tag_masks=None):
        """Re-run uncertified compact-tier queries on the HOST fp32
        matrix with float64 accumulation — true-score top-k with the
        (score desc, row asc) tie rule, the same set the device
        certificate proves for certified queries. Streams the matrix in
        ``compact_prep_rows`` slabs so no f64 copy of it materializes;
        ``tag_masks`` applies the device scan's filter."""
        bad = np.flatnonzero(~ok_np)
        qs = self._host_queries(q, bad)
        step = self.config.compact_prep_rows
        best_s = np.full((len(bad), k), -np.inf)
        best_r = np.full((len(bad), k), -1, dtype=np.int64)
        if tag_masks is not None:
            tag_bits = self.registry.tags_host(self._host.shape[0])
        for lo in range(0, self._host.shape[0], step):
            slab = self._host[lo : lo + step]
            s = slab.astype(np.float64) @ qs.T  # [rows, B'] f64 accumulation
            s[~self._valid[lo : lo + step]] = -np.inf
            r = np.arange(lo, lo + slab.shape[0], dtype=np.int64)
            if tag_masks is not None:
                s[~self._host_allowed(tag_bits[None, lo : lo + step], bad, tag_masks).T] = -np.inf
            cat_s = np.concatenate([best_s, s.T], axis=1)
            cat_r = np.concatenate([best_r, np.broadcast_to(r, (len(bad), len(r)))], axis=1)
            # merge with (score desc, row asc) on both keys explicitly
            take = np.lexsort((cat_r, -cat_s), axis=-1)[:, :k]
            best_s = np.take_along_axis(cat_s, take, axis=1)
            best_r = np.take_along_axis(cat_r, take, axis=1)
        best_r[np.isneginf(best_s)] = -1
        scores = scores.copy()
        rows = rows.copy()
        scores[bad] = best_s.astype(np.float32)
        rows[bad] = best_r.astype(rows.dtype)
        return scores, rows

    def search(self, query: Sequence[float], k: int) -> List[Tuple[str, float]]:
        """Host-facing search: ``[(chunk_id, score)]`` sorted (score desc,
        row asc), only valid hits."""
        if len(self) == 0 or k <= 0:
            return []
        scores, rows = self.search_arrays(np.asarray(query, dtype=np.float32)[None, :], k)
        return self._hydrate(scores[0].cpu().numpy(), rows[0].cpu().numpy())

    def _hydrate(self, scores: np.ndarray, rows: np.ndarray) -> List[Tuple[str, float]]:
        out: List[Tuple[str, float]] = []
        for s, r in zip(scores, rows):
            if r < 0:
                continue
            cid = self.registry.id_of(int(r))
            if cid is not None:
                out.append((cid, float(s)))
        return out

    # -- accessors ---------------------------------------------------------------

    def get(self, chunk_id: str) -> Optional[Chunk]:
        return self.registry.get_chunk(chunk_id)

    def __len__(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    @property
    def dimension(self) -> int:
        return self.config.dimension
