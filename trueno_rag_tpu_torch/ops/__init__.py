"""Device-side numeric ops on torch tensors.

- :mod:`~trueno_rag_tpu_torch.ops.dense` — fp32 similarity + exact top-k.
- :mod:`~trueno_rag_tpu_torch.ops.bm25` — block-table BM25 top-k.
- :mod:`~trueno_rag_tpu_torch.ops.fusion` — the six rank fusions.
- :mod:`~trueno_rag_tpu_torch.ops.dense_tiered` — the certified bf16 tile tier.
- :mod:`~trueno_rag_tpu_torch.ops.maxsim` — late interaction: the exact
  scan, the packs (bf16, zero-copy, int8, the l-major pack and bias of the
  v2 scans), the certified tiers, the token-pruned and the centroid-pruned
  (``prepare_maxsim_bounds``, ``maxsim_topk_pruned``) MaxSim. As in the
  JAX package, these names are imported from the module itself.
- :mod:`~trueno_rag_tpu_torch.ops.kernels` — hand-written CUDA kernels,
  each beside its plain PyTorch version.

Conventions: candidate lists are fixed-width tensors ``(rows, scores)``
where ``rows`` is int32 (``-1`` = invalid slot) and invalid slots carry
``-inf`` scores; ties sort deterministically (score desc, then row asc).
"""

from trueno_rag_tpu_torch.ops.dense import dense_topk, similarity_scores

__all__ = ["dense_topk", "similarity_scores"]
