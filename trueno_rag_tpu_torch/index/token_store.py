"""Multi-vector (late-interaction) token index: a device-resident
``[N, Lt, H]`` per-chunk token-embedding store with exact MaxSim top-k
search and the certified token-pruned and tiered scans.

PyTorch counterpart of ``trueno_rag_tpu/index/token_store.py``, with the
same contracts:

- a shared :class:`~trueno_rag_tpu_torch.index.base.ChunkRegistry` maps
  chunk ids to stable dense rows; removed rows become tombstones and
  recycle;
- search returns ``(score desc, row asc)``-ordered valid hits;
- the host copy ``[capacity, Lt, H]`` f32 is the source of truth; the
  device replica (and the tier pack) refresh lazily on mutation;
- certified tiers fall back to the exact scan for every query the
  certificate does not prove (counted in :attr:`TokenVectorStore.uncertified`).

On the card, ``scan="tiered"`` scans with the CUDA kernels K6 (bf16
replica, or the bf16 primary in place) and K7 (int8 replica); on CPU
tensors their plain versions run. Scores are the port's
exact MaxSim (float64, rounded once; ``ops/maxsim.py``), so a certified
query and its exact-scan fallback agree row for row.
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
from trueno_rag_tpu_torch.ops.maxsim import (
    max_token_norm,
    maxsim_scan_topk,
    maxsim_topk_int8_fused,
    maxsim_topk_scan16_fused,
    maxsim_topk_token_pruned,
    prepare_maxsim_int8,
    prepare_maxsim_scan16,
    prepare_maxsim_self16,
)

_UPLOAD_ROWS = 1 << 14  # chunks copied to the device per transfer


@dataclass
class TokenStoreConfig:
    """Configuration for :class:`TokenVectorStore` — the JAX package's
    fields, defaults and validation.

    ``scan``: ``"exact"`` (the full MaxSim scan), ``"token"`` (the
    certified token-pruned tier) or ``"tiered"`` (the certified bf16/int8
    scan replica, rescored from primary storage). ``scan_dtype`` picks the
    tiered replica; ``"auto"`` resolves to int8 when the primary storage is
    already bf16 and to bf16 otherwise. The tiers scan with K6/K7
    (``ops/kernels/maxsim_scan.py``) whatever ``scan_kernel`` says: it
    accepts the JAX package's ``"xla"`` so that its configurations load,
    but the blockwise scan behind that name is not ported."""

    hidden_dim: int = 384
    max_tokens: int = 32
    # "float32" | "bfloat16" — the device storage dtype; with bf16,
    # search and certificates are exact over the STORED bf16 values
    storage_dtype: str = "float32"
    scan: str = "exact"
    scan_dtype: str = "auto"  # tiered replica: auto | bfloat16 | int8
    scan_kernel: str = "fused"
    t_hits: int = 256
    rescore: int = 256
    scan_block: int = 512
    initial_capacity: int = 256
    # L2-normalize tokens at insert (cosine MaxSim). Zero tokens stay zero.
    normalize: bool = True

    def __post_init__(self) -> None:
        if self.storage_dtype not in ("float32", "bfloat16"):
            raise InvalidConfigError(f"storage_dtype must be float32|bfloat16, got {self.storage_dtype!r}")
        if self.scan not in ("exact", "token", "tiered"):
            raise InvalidConfigError(f"scan must be exact|token|tiered, got {self.scan!r}")
        if self.scan_dtype not in ("auto", "bfloat16", "int8"):
            raise InvalidConfigError(f"scan_dtype must be auto|bfloat16|int8, got {self.scan_dtype!r}")
        if self.scan_kernel not in ("fused", "xla"):
            raise InvalidConfigError(f"scan_kernel must be fused|xla, got {self.scan_kernel!r}")
        if self.rescore < 1 or self.t_hits < 1:
            raise InvalidConfigError("t_hits and rescore must be positive")

    def resolved_scan_dtype(self) -> str:
        """``"auto"`` → int8 on bf16 storage (a bf16 replica would read the
        same bytes as the exact scan), bf16 otherwise."""
        if self.scan_dtype != "auto":
            return self.scan_dtype
        return "int8" if self.storage_dtype == "bfloat16" else "bfloat16"


def _upload(host: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A fresh device copy of ``host`` in ``dtype``, copied in slabs so a
    bf16 store never holds an f32 device copy of the whole tensor."""
    out = torch.empty(host.shape, dtype=dtype, device=device)
    for lo in range(0, host.shape[0], _UPLOAD_ROWS):
        out[lo:lo + _UPLOAD_ROWS] = torch.from_numpy(host[lo:lo + _UPLOAD_ROWS]).to(device)
    return out


class TokenVectorStore:
    """The token index on ``device`` (default: the card; raises without
    one; pass ``device="cpu"`` to run the plain versions on the CPU)."""

    def __init__(
        self,
        config: Optional[TokenStoreConfig] = None,
        registry: Optional[ChunkRegistry] = None,
        device=None,
    ) -> None:
        self.config = config or TokenStoreConfig()
        self.device = resolve_device(device)
        self._owns_registry = registry is None
        self.registry = ChunkRegistry() if registry is None else registry
        cap = self.config.initial_capacity
        lt, h = self.config.max_tokens, self.config.hidden_dim
        self._host = np.zeros((cap, lt, h), dtype=np.float32)
        self._t_mask = np.zeros((cap, lt), dtype=bool)
        self._valid = np.zeros((cap,), dtype=bool)
        self._count = 0
        self._dirty = True
        self._dev = None  # (tokens, t_mask, valid) on the device
        self._d_norm = None  # max_token_norm of the replica: the exact scan's rounding budget
        self._tier = None  # tiered-scan replica pack (lazy)
        self.uncertified = 0  # certified-tier queries that fell back to the exact scan

    # -- mutation ------------------------------------------------------------

    def _check_tokens(self, chunk_id: str, tokens: np.ndarray) -> np.ndarray:
        t = np.asarray(tokens, dtype=np.float32)
        if t.ndim != 2 or t.shape[1] != self.config.hidden_dim:
            raise DimensionMismatchError(self.config.hidden_dim, int(t.shape[-1]) if t.ndim else 0)
        if t.shape[0] == 0:
            raise VectorStoreError(f"chunk {chunk_id} has no token vectors")
        return t[: self.config.max_tokens]

    def insert(self, chunk: Chunk, tokens: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        """Store ``chunk`` with its per-token vectors ``[L, H]``. ``L`` beyond
        ``max_tokens`` is truncated; shorter rows are padding-masked."""
        t = self._check_tokens(chunk.id, tokens)
        m = (
            np.ones((t.shape[0],), bool)
            if mask is None
            else np.asarray(mask, bool)[: self.config.max_tokens][: t.shape[0]]
        )
        if self.config.normalize:
            norms = np.sqrt(np.einsum("ij,ij->i", t, t))[:, None]
            t = t / np.where(norms > 0.0, norms, 1.0)
        row = self.registry.add(chunk)
        self._ensure_capacity(row + 1)
        if not self._valid[row]:
            self._count += 1
        self._host[row] = 0.0
        self._host[row, : t.shape[0]] = t
        self._t_mask[row] = False
        self._t_mask[row, : m.shape[0]] = m
        self._valid[row] = True
        self._dirty = True

    def insert_many(
        self,
        chunks: Sequence[Chunk],
        token_mats: Sequence[np.ndarray],
        masks: Optional[Sequence[np.ndarray]] = None,
    ) -> None:
        """:meth:`insert` for each chunk, after validating all of them (no
        partial batch on a bad row)."""
        if len(chunks) != len(token_mats):
            raise VectorStoreError("chunks and token_mats lengths differ")
        if masks is not None and len(masks) != len(chunks):
            raise VectorStoreError("masks length differs from chunks")
        for c, t in zip(chunks, token_mats):
            self._check_tokens(c.id, t)
        for i, (c, t) in enumerate(zip(chunks, token_mats)):
            self.insert(c, t, None if masks is None else masks[i])

    def load_rows(self, chunks: Sequence[Chunk], tokens: np.ndarray, t_mask: np.ndarray) -> None:
        """Bulk-restore pre-normalized rows ``[M, Lt, H]`` f32 with their
        masks: token bytes round-trip EXACTLY (no re-normalization). Rows
        allocate sequentially, so index i == store row i on a fresh store."""
        tokens = np.asarray(tokens, np.float32)
        t_mask = np.asarray(t_mask, bool)
        lt, h = self.config.max_tokens, self.config.hidden_dim
        if tokens.shape != (len(chunks), lt, h) or t_mask.shape != (len(chunks), lt):
            raise VectorStoreError("token/mask shapes do not match the config")
        rows = np.asarray(self.registry.add_batch(list(chunks)), dtype=np.int64)
        self._ensure_capacity(int(rows.max()) + 1 if len(rows) else 0)
        self._count += int(np.count_nonzero(~self._valid[np.unique(rows)]))
        self._host[rows] = tokens
        self._t_mask[rows] = t_mask
        self._valid[rows] = True
        self._dirty = True

    def remove(self, chunk_id: str) -> bool:
        row = self.registry.row_of(chunk_id)
        if row is None or not self._valid[row]:
            return False
        if self._owns_registry:
            self.registry.remove(chunk_id)
        self._host[row] = 0.0
        self._t_mask[row] = False
        self._valid[row] = False
        self._count -= 1
        self._dirty = True
        return True

    def _ensure_capacity(self, rows: int) -> None:
        cap = self._host.shape[0]
        if rows <= cap:
            return
        new_cap = max(cap * 2, rows)
        lt, h = self.config.max_tokens, self.config.hidden_dim
        host = np.zeros((new_cap, lt, h), dtype=np.float32)
        host[:cap] = self._host
        tm = np.zeros((new_cap, lt), dtype=bool)
        tm[:cap] = self._t_mask
        valid = np.zeros((new_cap,), dtype=bool)
        valid[:cap] = self._valid
        self._host, self._t_mask, self._valid = host, tm, valid
        self._dirty = True

    # -- device replica ------------------------------------------------------

    def _device(self):
        """``(tokens [cap, Lt, H] in the storage dtype, t_mask, valid)`` on
        the device, rebuilt after a mutation (with its largest token norm,
        which the exact scan's rounding budget needs)."""
        if self._dirty or self._dev is None:
            self._dev = self._tier = None  # free the old replicas before the copy
            dtype = torch.bfloat16 if self.config.storage_dtype == "bfloat16" else torch.float32
            self._dev = (
                _upload(self._host, dtype, self.device),
                _upload(self._t_mask, torch.bool, self.device),
                _upload(self._valid, torch.bool, self.device),
            )
            self._d_norm = max_token_norm(self._dev[0], self._dev[1])
            self._dirty = False
        return self._dev

    def _device_tier(self):
        """The tiered-scan pack, rebuilt on the device whenever the primary
        replica refreshes; it quantizes the STORED values, so the
        certificate is exact over primary storage."""
        tokens, t_mask, _ = self._device()
        if self._tier is None:
            if self.config.resolved_scan_dtype() == "int8":
                self._tier = ("int8",) + tuple(prepare_maxsim_int8(tokens, t_mask))
            elif self.config.storage_dtype == "bfloat16":
                # the replica IS the bf16 primary: no corpus-scale copy
                e_max, n_max = prepare_maxsim_self16(tokens, t_mask)
                self._tier = ("bfloat16", tokens, e_max, n_max)
            else:
                self._tier = ("bfloat16",) + tuple(prepare_maxsim_scan16(tokens, t_mask))
        return self._tier

    # -- search --------------------------------------------------------------

    def search_arrays(
        self,
        q_tok: np.ndarray,  # [B, Lq, H] float32
        q_mask: Optional[np.ndarray] = None,  # [B, Lq] bool
        k: int = 10,
        allowed_rows: Optional[np.ndarray] = None,  # [cap] bool extra filter
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched MaxSim top-k → ``(scores [B,k] f32, rows [B,k] i32)``
        numpy, ``-1``/``-inf`` at invalid slots. ``allowed_rows`` (e.g. a
        resolved tag filter) joins the tombstone mask, so every scan
        searches the FILTERED corpus exactly."""
        q = np.asarray(q_tok, np.float32)
        if q.ndim != 3 or q.shape[2] != self.config.hidden_dim:
            raise DimensionMismatchError(self.config.hidden_dim, int(q.shape[-1]) if q.ndim else 0)
        if self.config.normalize:
            norms = np.sqrt(np.einsum("bij,bij->bi", q, q))[:, :, None]
            q = q / np.where(norms > 0.0, norms, 1.0)
        b, lq = q.shape[0], q.shape[1]
        qm = np.ones((b, lq), bool) if q_mask is None else np.asarray(q_mask, bool)
        tokens, t_mask, valid = self._device()
        if allowed_rows is not None:
            allowed = np.asarray(allowed_rows, bool)
            if allowed.shape[0] != self._host.shape[0]:
                raise VectorStoreError("allowed_rows must cover the store's capacity rows")
            valid = valid & torch.from_numpy(allowed).to(self.device)
        qd = torch.from_numpy(q).to(self.device)
        qmd = torch.from_numpy(qm).to(self.device)
        cfg = self.config
        rescore = max(cfg.rescore, k)

        if cfg.scan == "token":
            s, r, cert = maxsim_topk_token_pruned(qd, qmd, tokens, t_mask, valid, k,
                                                  t_hits=cfg.t_hits, rescore=rescore)
            s, r = self._patch_uncertified(s, r, cert, qd, qmd, tokens, t_mask, valid, k)
        elif cfg.scan == "tiered":
            tier = self._device_tier()
            if tier[0] == "int8":
                _, tok8, s_tok, e_max, n_max = tier
                s, r, cert = maxsim_topk_int8_fused(qd, qmd, tokens, t_mask, tok8, s_tok, e_max, n_max, valid, k,
                                                    rescore=rescore)
            else:
                _, tok16, e_max, n_max = tier
                s, r, cert = maxsim_topk_scan16_fused(qd, qmd, tokens, t_mask, tok16, e_max, n_max, valid, k,
                                                      rescore=rescore)
            s, r = self._patch_uncertified(s, r, cert, qd, qmd, tokens, t_mask, valid, k)
        else:
            s, r = maxsim_scan_topk(qd, qmd, tokens, t_mask, valid, k, cfg.scan_block, self._d_norm)
        return s.cpu().numpy(), r.cpu().numpy()

    def _patch_uncertified(self, s, r, cert, qd, qmd, tokens, t_mask, valid, k):
        """Fail-closed: the uncertified queries re-run on the exact scan,
        counted in :attr:`uncertified`. Both give the exact top-k of
        :func:`~trueno_rag_tpu_torch.ops.maxsim.maxsim_pair_scores`, so a
        certified query and its fallback agree row for row."""
        miss = torch.nonzero(~cert).flatten()
        if miss.numel():
            self.uncertified += int(miss.numel())
            s_e, r_e = maxsim_scan_topk(qd[miss], qmd[miss], tokens, t_mask, valid, k, self.config.scan_block,
                                        self._d_norm)
            s, r = s.clone(), r.clone()
            s[miss], r[miss] = s_e, r_e
        return s, r

    def search_tokens(self, q_tok: np.ndarray, k: int,
                      q_mask: Optional[np.ndarray] = None) -> List[Tuple[str, float]]:
        """Single-query search → ``[(chunk_id, score)]``, valid hits only,
        (score desc, row asc)."""
        if self._count == 0 or k <= 0:
            return []
        qm = None if q_mask is None else np.asarray(q_mask, bool)[None, :]
        scores, rows = self.search_arrays(np.asarray(q_tok, np.float32)[None], qm, k)
        return self._hydrate(scores[0], rows[0])

    def _hydrate(self, scores: np.ndarray, rows: np.ndarray) -> List[Tuple[str, float]]:
        out: List[Tuple[str, float]] = []
        for s, r in zip(scores, rows):
            if r < 0:
                continue
            cid = self.registry.id_of(int(r))
            if cid is not None:
                out.append((cid, float(s)))
        return out

    # -- accessors -------------------------------------------------------------

    def get(self, chunk_id: str) -> Optional[Chunk]:
        return self.registry.get_chunk(chunk_id)

    def __len__(self) -> int:
        return self._count

    def is_empty(self) -> bool:
        return self._count == 0

    @property
    def hidden_dim(self) -> int:
        return self.config.hidden_dim
