"""The BM25 posting fetch as CUDA kernels for Hopper, their plain PyTorch
versions, and the segment top-k built on them (``csrc/bm25_fetch.cu``):

- ``fetch_contribs``: one ``[SEGMENT_LEN, 4]`` slab of the packed postings
  per slot, with the masked Okapi contribution, counterpart of the Pallas
  TPU kernel ``trueno_rag_tpu/ops/pallas/bm25_fetch.py::fetch_contribs``;
- ``fetch_contribs8``: the same with 8 slots per thread block, counterpart
  of ``bm25_fetch.py::fetch_contribs8``;
- :func:`bm25_topk_dma` and :func:`gather_aligned_segments`: the aligned
  plan's top-k and its host slot lists, as in the JAX module;
- :func:`bm25_topk_fetch`: the segment plan of
  :func:`~trueno_rag_tpu_torch.ops.bm25.bm25_topk_segments` (``(start,
  len)`` runs) through the same kernel, the BM25 half of the index's and
  the hybrid query's segment path.

Both kernels compute the contribution in the JAX package's operation
order, each step rounded once in f32, so they agree bit for bit with
their plain versions (``ops/bm25.okapi_contrib``). Dispatch: a CPU tensor
goes to the plain version; a CUDA tensor goes to the kernel, or the call
raises. The kernels are built at first use by
:mod:`~trueno_rag_tpu_torch.ops.kernels.build`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from trueno_rag_tpu_torch.errors import InvalidConfigError
from trueno_rag_tpu_torch.ops.bm25 import SEGMENT_LEN, _candidate_topk, bm25_topk_segments, slab_contribs
from trueno_rag_tpu_torch.ops.kernels.build import entry

def _check(first, lo, hi, packed, name: str) -> None:
    if packed.dim() != 2 or packed.shape[1] != 4 or packed.dtype != torch.float32:
        raise InvalidConfigError(f"{name}: packed must be f32 [P + {SEGMENT_LEN}, 4], got "
                                 f"{packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] < SEGMENT_LEN:
        raise InvalidConfigError(f"{name}: packed has fewer than {SEGMENT_LEN} rows")
    for t in (first, lo, hi):
        if t is not None and (t.dim() != 1 or t.dtype != torch.int32 or t.shape != first.shape):
            raise InvalidConfigError(f"{name}: slot arrays must be int32 [B*S], got {t.dtype} {tuple(t.shape)}")
        if t is not None and t.device != packed.device:
            raise InvalidConfigError(f"{name}: all inputs must be on one device")


def _launch(name: str, first, lo, hi, packed, scale: int, avgdl, k1: float, b: float, rows, contribs) -> None:
    """Launch entry point ``name`` on the current stream of ``packed``'s
    device into ``rows``/``contribs``; no checks, no host sync. Raises if
    the launch is refused."""
    consts = (1.0 - b, b, k1, k1 + 1.0, max(float(avgdl), 1e-9))
    fn = entry(f"{name}_launch")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(first.data_ptr(), None if lo is None else lo.data_ptr(), hi.data_ptr(),
                 packed.data_ptr(), rows.data_ptr(), contribs.data_ptr(), first.shape[0], scale,
                 *(float(np.float32(c)) for c in consts), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _fetch(kernel, first, lo, hi, packed, scale: int, avgdl, k1: float, b: float):
    """Launch ``kernel`` over slots ``packed[first·scale:]`` (``lo`` None =
    every lo 0) → (rows, contribs), counting the launch on ``kernel``;
    raises on inputs the kernel does not take, a slot that would read past
    ``packed`` among them (one host sync)."""
    name = kernel.__name__
    dev = packed.device
    if dev.type != "cuda":
        raise InvalidConfigError(f"{name} runs on cpu or cuda tensors, got {dev}")
    first, hi, packed = (t.contiguous() for t in (first, hi, packed))
    lo = None if lo is None else lo.contiguous()
    if packed.data_ptr() % 16:
        raise InvalidConfigError(f"{name}: packed must be 16-byte aligned")
    n = first.shape[0]
    if n:
        f_min, f_max = (int(x) for x in torch.aminmax(first))
        if f_min < 0 or f_max * scale + SEGMENT_LEN > packed.shape[0]:
            raise InvalidConfigError(f"{name}: a slot reads past the packed postings")
    rows = torch.empty((n, SEGMENT_LEN), dtype=torch.int32, device=dev)
    contribs = torch.empty((n, SEGMENT_LEN), dtype=torch.float32, device=dev)
    _launch(name, first, lo, hi, packed, scale, avgdl, k1, b, rows, contribs)
    kernel.launches += 1
    return rows, contribs


def fetch_contribs(
    block_ids: torch.Tensor,  # [B*S] int32 — SEGMENT_LEN-aligned block index per slot
    lo: torch.Tensor,  # [B*S] int32 — first valid lane within the block
    hi: torch.Tensor,  # [B*S] int32 — one past the last valid lane
    packed: torch.Tensor,  # [P + SEGMENT_LEN, 4] f32 — ops.bm25.pack_postings
    avgdl,  # one f32 value, fixed per index snapshot
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (rows [B*S, SEGMENT_LEN] int32, int32-max where masked; contribs
    [B*S, SEGMENT_LEN] f32, 0 where masked).

    CPU tensors run :func:`fetch_contribs_reference`; CUDA tensors launch
    the kernel (counted in ``fetch_contribs.launches``) or raise."""
    _check(block_ids, lo, hi, packed, "fetch_contribs")
    if packed.device.type == "cpu":
        return fetch_contribs_reference(block_ids, lo, hi, packed, avgdl, k1, b)
    return _fetch(fetch_contribs, block_ids, lo, hi, packed, SEGMENT_LEN, avgdl, k1, b)


fetch_contribs.launches = 0


def fetch_contribs8(block_ids, lo, hi, packed, avgdl, k1: float = 1.2, b: float = 0.75):
    """:func:`fetch_contribs` with 8 slots per thread block, all eight
    slabs' loads in flight before the arithmetic; the same outputs.

    CPU tensors run :func:`fetch_contribs8_reference`; CUDA tensors launch
    the kernel (counted in ``fetch_contribs8.launches``) or raise."""
    _check(block_ids, lo, hi, packed, "fetch_contribs8")
    if packed.device.type == "cpu":
        return fetch_contribs8_reference(block_ids, lo, hi, packed, avgdl, k1, b)
    return _fetch(fetch_contribs8, block_ids, lo, hi, packed, SEGMENT_LEN, avgdl, k1, b)


fetch_contribs8.launches = 0


def fetch_contribs_reference(block_ids, lo, hi, packed, avgdl, k1: float = 1.2, b: float = 0.75):
    """Plain PyTorch version of both kernels, on any device: the slab of
    block ``block_ids[s]`` per slot, masked to ``[lo, hi)``."""
    return slab_contribs(block_ids.long() * SEGMENT_LEN, lo, hi, packed, avgdl, k1, b)


fetch_contribs8_reference = fetch_contribs_reference


def bm25_topk_dma(
    block_ids: torch.Tensor,  # [B*S] int32 (aligned block per slot, padded)
    lo: torch.Tensor,  # [B*S]
    hi: torch.Tensor,  # [B*S]
    packed: torch.Tensor,
    avgdl,
    k: int,
    s_slots: int,
    k1: float = 1.2,
    b: float = 0.75,
    wide: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full BM25 top-k over the aligned plan of
    :func:`gather_aligned_segments`: the fetch (``wide``: 8 slots per
    block) then the candidate tail → ``(scores [B, k], rows [B, k])``, the
    contract of :func:`~trueno_rag_tpu_torch.ops.bm25.bm25_topk_segments`."""
    fetch = fetch_contribs8 if wide else fetch_contribs
    rows, contribs = fetch(block_ids, lo, hi, packed, avgdl, k1=k1, b=b)
    bsz = block_ids.shape[0] // s_slots
    return _candidate_topk(rows.view(bsz, -1), contribs.view(bsz, -1), k)


def bm25_topk_fetch(
    seg_starts: torch.Tensor,  # [B, S] int32 — posting offsets of contiguous runs
    seg_lens: torch.Tensor,  # [B, S] int32 — run lengths (<= SEGMENT_LEN)
    packed: torch.Tensor,  # [P + SEGMENT_LEN, 4] f32
    avgdl,
    k: int,
    k1: float = 1.2,
    b: float = 0.75,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment BM25 top-k → ``(scores [B, k], rows [B, k])``: CPU tensors
    run the plain :func:`~trueno_rag_tpu_torch.ops.bm25.bm25_topk_segments`;
    on CUDA tensors ``fetch_contribs8`` (8 slots per thread block, faster
    than 1 at 17,825,792 rows in ``chip_smoke.py``: PERF.md §6) fetches each
    run in place from its unaligned start (lo 0, hi len), so the panel is
    laid out exactly as the plain version's, then the same candidate tail."""
    if seg_starts.shape != seg_lens.shape or seg_starts.dim() != 2:
        raise InvalidConfigError("seg_starts and seg_lens must both be [B, S]")
    if packed.device.type == "cpu":
        return bm25_topk_segments(seg_starts, seg_lens, packed, avgdl, k, k1=k1, b=b)
    first, hi = seg_starts.reshape(-1), seg_lens.reshape(-1)
    _check(first, None, hi, packed, "fetch_contribs8")
    rows, contribs = _fetch(fetch_contribs8, first, None, hi, packed, 1, avgdl, k1, b)
    bsz = seg_starts.shape[0]
    return _candidate_topk(rows.view(bsz, -1), contribs.view(bsz, -1), k)


def gather_aligned_segments(indptr, terms, vocab, tokenize_fn, queries, packed_len):
    """Host: compile queries into SEGMENT_LEN-aligned (block, lo, hi) slots
    → ``(block_ids, lo, hi, s_slots, bsz_pad)`` int32 arrays of
    ``bsz_pad·s_slots`` slots. ``packed_len`` = number of real postings
    (the padding block after them is the sentinel target). As in the JAX
    package, the flat slot count is a multiple of 8 (whole padded
    queries), which the Pallas kernels needed; the CUDA kernel does not,
    but the output keeps that shape. ``terms`` is unused, as there."""
    sentinel_block = packed_len // SEGMENT_LEN  # the all-padding block
    per_query = []
    max_slots = 1
    for q in queries:
        slots = []
        for term in tokenize_fn(q):
            tid = vocab.get(term)
            if tid is None:
                continue
            t_lo, t_hi = int(indptr[tid]), int(indptr[tid + 1])
            blk0 = t_lo // SEGMENT_LEN
            blk1 = (t_hi - 1) // SEGMENT_LEN if t_hi > t_lo else blk0 - 1
            for blk in range(blk0, blk1 + 1):
                base = blk * SEGMENT_LEN
                slots.append((blk, max(t_lo - base, 0), min(t_hi - base, SEGMENT_LEN)))
        per_query.append(slots)
        max_slots = max(max_slots, len(slots))
    s_slots = max(2, max_slots)
    step = 8 // math.gcd(s_slots, 8)
    bsz_pad = -(-len(queries) // step) * step
    total = bsz_pad * s_slots
    block_ids = np.full(total, sentinel_block, dtype=np.int32)
    lo = np.zeros(total, dtype=np.int32)
    hi = np.zeros(total, dtype=np.int32)
    for qi, slots in enumerate(per_query):
        for si, (blk, l, h) in enumerate(slots[:s_slots]):
            j = qi * s_slots + si
            block_ids[j] = blk
            lo[j] = l
            hi[j] = h
    return block_ids, lo, hi, s_slots, bsz_pad
