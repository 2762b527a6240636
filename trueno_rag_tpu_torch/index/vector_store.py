"""Dense vector store: device-resident ``[N, d]`` embedding matrix.

PyTorch counterpart of ``trueno_rag_tpu/index/vector_store.py`` for the
``"none"``, ``"auto"`` and ``"bf16"`` (tile kernel) scan tiers.
Capability-equivalent to the reference's ``VectorStore``
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
  keeps a bf16 replica that the certified tile scan reads; results stay
  exactly those of the fp32 path.

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
    each knob). This store implements ``scan_tier`` "none", "auto" and
    "bf16" with ``scan_kernel="tile"`` and float32 storage; the other
    values pass validation but the store raises on them."""

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


def _check_ported(config: VectorStoreConfig) -> None:
    """Raise on the configurations the port does not implement yet, so
    none silently takes another path."""
    if config.scan_tier in ("int8", "compact", "clustered"):
        raise InvalidConfigError(
            f"scan_tier={config.scan_tier!r} is not ported yet (ROADMAP: "
            "int8/compact/clustered tiers)"
        )
    if config.scan_tier in ("bf16", "auto") and config.scan_kernel != "tile":
        raise InvalidConfigError(
            "scan_kernel='block' (the v1 scan kernel) is not ported yet (ROADMAP)"
        )
    if config.storage_dtype != "float32":
        raise InvalidConfigError(
            "storage_dtype='bfloat16' is not ported yet (ROADMAP); use float32"
        )


class VectorStore:
    def __init__(
        self,
        config: Optional[VectorStoreConfig] = None,
        registry: Optional[ChunkRegistry] = None,
        device=None,
    ) -> None:
        self.config = config or VectorStoreConfig()
        _check_ported(self.config)
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
        self._tier = None  # (m_bf16, e_l2, a_l2) when the bf16 tier is built
        self._tier_built_for = None
        self.tier_fallbacks = 0  # batches with a query re-run on fp32
        self.tier_fallback_queries = 0  # queries re-run on fp32

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
            self._device_matrix[rows] = updates
            self._device_valid[rows] = torch.from_numpy(self._valid[idx]).to(self.device)
            self._refresh_tier(rows=rows, updates=updates)
        else:
            # copy=True: on the CPU a plain .to() would alias the host mirror
            self._device_matrix = torch.from_numpy(self._host).to(self.device, copy=True)
            self._device_valid = torch.from_numpy(self._valid).to(self.device, copy=True)
            self._refresh_tier()
        self._dirty = False
        self._dirty_rows = set()

    def _effective_tier(self) -> str:
        """Resolve "auto": the bf16 tier once the store holds
        ``scan_tier_auto_rows`` rows (the crossover is a tuned constant of
        the JAX package, not yet measured on this port)."""
        tier = self.config.scan_tier
        if tier == "auto":
            return "bf16" if self._count >= self.config.scan_tier_auto_rows else "none"
        return tier

    def _refresh_tier(self, rows=None, updates=None) -> None:
        """Maintain the bf16 replica. The quantization/residual math is
        row-local, so incremental mutations prepare ONLY the changed rows
        and scatter them into the replica arrays."""
        tier = self._effective_tier()
        self._tier_built_for = tier
        if tier == "none":
            self._tier = None
            return
        from trueno_rag_tpu_torch.ops import dense_tiered as dt

        if rows is None or self._tier is None:
            self._tier = dt.prepare_tiered(self._device_matrix)
            return
        for full, part in zip(self._tier, dt.prepare_tiered(updates)):
            full[rows] = part

    @property
    def device_matrix(self) -> torch.Tensor:
        """The ``[capacity, d]`` device matrix (cosine rows normalized)."""
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
        ``(scores, rows) [B, k]`` tensors on ``self.device``."""
        if tag_masks is not None:
            raise InvalidConfigError("tag filters are not ported yet (ROADMAP)")
        self._refresh_device()
        require_fp32()
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, dtype=np.float32))).to(self.device)
        if q.shape[-1] != self.config.dimension:
            raise DimensionMismatchError(self.config.dimension, int(q.shape[-1]))
        k_eff = min(k, self._host.shape[0])
        if self._tier is not None:
            from trueno_rag_tpu_torch.ops import dense_tiered as dt

            scores, rows, n_fallback = dt.dense_topk_tiered2_checked(
                q, self._device_matrix, *self._tier, self._device_valid, k_eff,
                metric=self.config.metric,
                rescore_rows=self.config.scan_rescore_rows,
                t_top=self.config.scan_t_top,
                margin_tiles=self.config.scan_margin_tiles,
                tile_n=self.config.scan_tile_n,
            )
            if n_fallback:
                self.tier_fallbacks += 1
                self.tier_fallback_queries += n_fallback
            return scores, rows
        return dense_topk(q, self._device_matrix, self._device_valid, k_eff, self.config.metric)

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
