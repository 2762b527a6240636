"""Batched IR metrics on the device.

PyTorch counterpart of ``trueno_rag_tpu/ops/metrics.py`` (a jitted jnp
function there, with no Pallas kernel; plain torch here). The host
:mod:`trueno_rag_tpu_torch.metrics` is the per-query oracle; this module
evaluates a whole query fleet in one pass on the tensors' device.

Inputs are padded integer id matrices: ``retrieved [Q, K]`` (row ids,
-1 = empty slot, already deduplicated by the retriever contract) and
``relevant [Q, R]`` (-1 padded). Outputs are per-query metric vectors
(float32); means over axis 0 give the aggregate.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def batched_metrics(
    retrieved: torch.Tensor,  # [Q, K] int, -1 padded
    relevant: torch.Tensor,  # [Q, R] int, -1 padded
    k_values: Sequence[int] = (1, 5, 10),
) -> Dict[str, torch.Tensor]:
    """recall@k / precision@k / NDCG@k / hit-rate@k / F1@k / MRR / MAP for
    every query, on ``retrieved``'s device."""
    q, kk = retrieved.shape
    dev = retrieved.device
    relevant = relevant.to(dev)
    valid_ret = retrieved >= 0
    valid_rel = relevant >= 0
    n_rel = valid_rel.sum(dim=1)

    # hit[i, j] = retrieved[i, j] ∈ relevant[i]
    match = (retrieved[:, :, None] == relevant[:, None, :]) & valid_rel[:, None, :]
    hit = match.any(dim=2) & valid_ret

    ranks = torch.arange(kk, device=dev)[None, :]
    hits_cum = torch.cumsum(hit.to(torch.int32), dim=1)
    discount = 1.0 / torch.log2(ranks.to(torch.float32) + 2.0)
    zero = torch.zeros((q,), dtype=torch.float32, device=dev)

    out: Dict[str, torch.Tensor] = {}
    safe_rel = torch.clamp(n_rel, min=1).to(torch.float32)
    for k in k_values:
        k_idx = min(k, kk) - 1
        hits_at_k = hits_cum[:, k_idx].to(torch.float32) if k > 0 else zero
        out[f"recall@{k}"] = torch.where(n_rel > 0, hits_at_k / safe_rel, zero)
        out[f"precision@{k}"] = hits_at_k / k if k > 0 else zero
        # binary NDCG@k
        in_k = ranks < k
        dcg = torch.where(hit & in_k, discount, 0.0).sum(dim=1)
        ideal_mask = ranks < torch.clamp(n_rel, max=k)[:, None]
        idcg = torch.where(ideal_mask, discount, 0.0).sum(dim=1)
        out[f"ndcg@{k}"] = torch.where(idcg > 0, dcg / torch.where(idcg > 0, idcg, 1.0), zero)
        out[f"hit_rate@{k}"] = torch.where(n_rel > 0, (hits_at_k > 0).to(torch.float32), zero)
        p = out[f"precision@{k}"]
        r = out[f"recall@{k}"]
        out[f"f1@{k}"] = torch.where(p + r > 0, 2 * p * r / torch.clamp(p + r, min=1e-9), zero)

    # MRR: 1 / (first hit rank + 1)
    first_hit = torch.argmax(hit.to(torch.int32), dim=1)
    out["mrr"] = torch.where(hit.any(dim=1), 1.0 / (first_hit.to(torch.float32) + 1.0), zero)
    # MAP: mean of precision-at-hit over the relevant count
    prec_at = hits_cum.to(torch.float32) / (ranks.to(torch.float32) + 1.0)
    ap = torch.where(hit, prec_at, 0.0).sum(dim=1) / safe_rel
    out["map"] = torch.where(n_rel > 0, ap, zero)
    return out


def pad_ids(id_lists, width: int, mapper=None, device=None) -> torch.Tensor:
    """Host helper: list of id lists → padded int32 ``[len, width]`` tensor
    (-1 fill) on ``device`` (default: the card; pass "cpu" for the host).
    ``mapper`` converts external ids (e.g. chunk id strings) to rows."""
    from trueno_rag_tpu_torch.device import resolve_device

    out = np.full((len(id_lists), width), -1, dtype=np.int32)
    for i, ids in enumerate(id_lists):
        vals = [mapper(x) if mapper else x for x in ids][:width]
        out[i, : len(vals)] = vals
    return torch.from_numpy(out).to(resolve_device(device))
