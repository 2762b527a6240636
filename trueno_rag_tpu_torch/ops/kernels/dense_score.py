"""The exact fp32 dense scan with per-128-row block maxima as CUDA kernels
for Hopper, their plain PyTorch versions, and the two top-k functions built
on them (``csrc/dense_score.cu``):

- ``score_blockmax``: masked scores ``[B, N]`` and block maxima
  ``[B, ceil(N/128)]``, counterpart of the Pallas TPU kernel
  ``trueno_rag_tpu/ops/pallas/dense_score.py::score_blockmax``;
- ``blockmax_only``: the block maxima alone, counterpart of
  ``dense_score.py::blockmax_only``;
- :func:`dense_topk_blockmax` and :func:`dense_topk_twopass`: the exact
  top-k through them, counterparts of ``pallas_dense_topk`` and
  ``pallas_dense_topk_twopass``.

The kernels compute ``Q·Mᵀ`` in f32 in their own body (no cuBLAS, no
TF32), with invalid rows at -inf and a ragged last block reduced over its
real rows. Dispatch: a CPU tensor goes to the plain version; a CUDA tensor
goes to the kernel, or the call raises. The kernels are built at first use
by :mod:`~trueno_rag_tpu_torch.ops.kernels.build`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.dense import (
    NEG_INF, _exact_rerank, _pad_k, normalize_queries, require_fp32, topk_desc,
)
from trueno_rag_tpu_torch.ops.kernels.build import entry

BLOCK = 128  # rows per block maximum
_GATHER_ELEMS = 1 << 27  # f32 elements of gathered rows per batch chunk (512 MiB)


def _check(q, m, valid) -> None:
    if q.dim() != 2 or m.dim() != 2 or q.shape[1] != m.shape[1]:
        raise InvalidConfigError(f"need queries [B, d] and matrix [N, d], got {tuple(q.shape)}, {tuple(m.shape)}")
    if q.dtype != torch.float32 or m.dtype != torch.float32:
        raise InvalidConfigError(f"queries and matrix must be float32, got {q.dtype}, {m.dtype}")
    if q.shape[0] < 1 or m.shape[0] < 1 or q.shape[1] < 1:
        raise InvalidConfigError(f"empty input {tuple(q.shape)}, {tuple(m.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (m.shape[0],):
        raise InvalidConfigError(f"valid_mask must be bool [{m.shape[0]}], got {valid.dtype} {tuple(valid.shape)}")
    if len({q.device, m.device, valid.device}) != 1:
        raise InvalidConfigError("all inputs must be on one device")


def _launch(name: str, q, m, valid, with_scores: bool):
    """Launch entry point ``name`` on the current stream of the inputs'
    device → (scores or None, bmax); raises if the launch is refused."""
    dev = q.device
    if dev.type != "cuda":
        raise InvalidConfigError(f"{name[:-7]} runs on cpu or cuda tensors, got {dev}")
    q, m, valid = q.contiguous(), m.contiguous(), valid.contiguous()
    if q.data_ptr() % 16 or m.data_ptr() % 16:
        raise InvalidConfigError(f"{name[:-7]}: queries and matrix must be 16-byte aligned")
    (b, d), n = q.shape, m.shape[0]
    bmax = torch.empty((b, -(-n // BLOCK)), dtype=torch.float32, device=dev)
    scores = torch.empty((b, n), dtype=torch.float32, device=dev) if with_scores else None
    outs = [t.data_ptr() for t in (scores, bmax) if t is not None]
    fn = entry(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), m.data_ptr(), valid.data_ptr(), *outs, b, d, n, stream)
    if err != 0:
        raise RuntimeError(f"{name[:-7]} kernel launch failed: cudaError {err}")
    return scores, bmax


def score_blockmax(
    queries: torch.Tensor,  # [B, d] f32 (pre-normalized for cosine)
    matrix: torch.Tensor,  # [N, d] f32
    valid_mask: torch.Tensor,  # [N] bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (masked scores [B, N] f32, block maxima [B, ceil(N/128)] f32).

    CPU tensors run :func:`score_blockmax_reference`; CUDA tensors launch
    the kernel (counted in ``score_blockmax.launches``) or raise."""
    _check(queries, matrix, valid_mask)
    if queries.device.type == "cpu":
        return score_blockmax_reference(queries, matrix, valid_mask)
    out = _launch("score_blockmax_launch", queries, matrix, valid_mask, True)
    score_blockmax.launches += 1
    return out


score_blockmax.launches = 0


def blockmax_only(queries: torch.Tensor, matrix: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
    """→ block maxima [B, ceil(N/128)] f32, with no score output.

    CPU tensors run :func:`blockmax_only_reference`; CUDA tensors launch
    the kernel (counted in ``blockmax_only.launches``) or raise."""
    _check(queries, matrix, valid_mask)
    if queries.device.type == "cpu":
        return blockmax_only_reference(queries, matrix, valid_mask)
    _, bmax = _launch("blockmax_only_launch", queries, matrix, valid_mask, False)
    blockmax_only.launches += 1
    return bmax


blockmax_only.launches = 0


def block_maxima(scores: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` → per-128-row maxima ``[B, ceil(N/128)]`` (a ragged last
    block over its real rows)."""
    b, n = scores.shape
    pad = -n % BLOCK
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG_INF)
    return scores.view(b, -1, BLOCK).amax(dim=2)


def score_blockmax_reference(queries, matrix, valid_mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both kernels, on any device: an f32 matmul
    (TF32 off), the mask, then :func:`block_maxima`."""
    _check(queries, matrix, valid_mask)
    require_fp32()
    s = torch.where(valid_mask[None, :], queries @ matrix.T, NEG_INF)
    return s, block_maxima(s)


def blockmax_only_reference(queries, matrix, valid_mask) -> torch.Tensor:
    return score_blockmax_reference(queries, matrix, valid_mask)[1]


def _metric(queries: torch.Tensor, metric: str, name: str) -> torch.Tensor:
    if metric == "cosine":
        return normalize_queries(queries)
    if metric == "dot":
        return queries
    raise InvalidConfigError(f"{name} supports cosine/dot, got {metric!r}")


def _block_rows(bmax: torch.Tensor, width: int) -> torch.Tensor:
    """The rows of the best ``min(width, G)`` blocks by their maxima, in
    global row order → ``[B, nb·128]`` (entries may pass N at a ragged
    edge). Those blocks hold the best ``width`` rows: a row outside them
    would leave ``width`` blocks each holding a better one."""
    nb = min(width, bmax.shape[1])
    _, bidx = topk_desc(bmax, nb)
    bidx, _ = torch.sort(bidx, dim=1)  # candidates in global-row order
    lane = torch.arange(BLOCK, device=bmax.device)
    return (bidx[:, :, None] * BLOCK + lane).reshape(bmax.shape[0], nb * BLOCK)


def _best_rows(cand_rows: torch.Tensor, cand: torch.Tensor, width: int) -> torch.Tensor:
    """The best ``width`` of the candidates (ties → lower row) → rows
    ``[B, width]``, -1 where the score is -inf."""
    top_s, idx = topk_desc(cand, min(width, cand.shape[1]))
    rows = torch.gather(cand_rows, 1, idx)
    return torch.where(torch.isneginf(top_s), -1, rows)


def dense_topk_blockmax(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    metric: str = "cosine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k through ``score_blockmax`` (K2), the counterpart of the
    JAX package's ``pallas_dense_topk`` (``ops/pallas/dense_score.py``):
    one scan writes the scores and their block maxima, then only the best
    blocks' scores are gathered. As the port's
    :func:`~trueno_rag_tpu_torch.ops.dense.dense_topk` does, the best
    ``min(2k, N)`` rows of the f32 scan are re-ranked by
    :func:`~trueno_rag_tpu_torch.ops.dense.exact_scores`, so both return the
    same rows and scores → (scores [B, k], rows [B, k]), (-inf, -1) slots
    past the valid rows. cosine/dot only."""
    q = _metric(queries, metric, "dense_topk_blockmax")
    n = matrix.shape[0]
    width = min(2 * k, n)
    scores, bmax = score_blockmax(q, matrix, valid_mask)
    cand_rows = _block_rows(bmax, width)
    live = cand_rows < n
    cand = torch.gather(scores, 1, torch.clamp(cand_rows, max=n - 1))
    rows = _best_rows(cand_rows, torch.where(live, cand, NEG_INF), width)
    return _pad_k(*_exact_rerank(q, matrix, rows, k), k)


def dense_topk_twopass(
    queries: torch.Tensor,  # [B, d] f32
    matrix: torch.Tensor,  # [N, d] f32 (cosine rows pre-normalized)
    valid_mask: torch.Tensor,  # [N] bool
    k: int,
    metric: str = "cosine",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k through ``blockmax_only`` (K2b), the counterpart of the
    JAX package's ``pallas_dense_topk_twopass``: pass A writes only the
    block maxima (no ``[B, N]`` score tensor); pass B rescores the rows of
    the best ``min(2k, G)`` blocks in f32, a batch chunk at a time, and the
    best ``min(2k, N)`` are re-ranked by
    :func:`~trueno_rag_tpu_torch.ops.dense.exact_scores`, as in
    :func:`dense_topk_blockmax` → (scores [B, k], rows [B, k]). cosine/dot
    only."""
    q = _metric(queries, metric, "dense_topk_twopass")
    require_fp32()  # pass B's f32 products
    n, d = matrix.shape
    width = min(2 * k, n)
    cand_rows = _block_rows(blockmax_only(q, matrix, valid_mask), width)
    safe = torch.clamp(cand_rows, max=n - 1)
    cand = torch.empty(cand_rows.shape, dtype=torch.float32, device=q.device)
    step = max(1, _GATHER_ELEMS // (cand_rows.shape[1] * d))
    for lo in range(0, q.shape[0], step):
        cand[lo:lo + step] = torch.bmm(matrix[safe[lo:lo + step]], q[lo:lo + step, :, None])[:, :, 0]
    live = (cand_rows < n) & valid_mask[safe]
    rows = _best_rows(cand_rows, torch.where(live, cand, NEG_INF), width)
    return _pad_k(*_exact_rerank(q, matrix, rows, k), k)
