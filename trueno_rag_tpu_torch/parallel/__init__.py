"""Sharded serving and training over a device mesh.

PyTorch counterpart of ``trueno_rag_tpu/parallel``:

- :mod:`~trueno_rag_tpu_torch.parallel.mesh` — :class:`Mesh` (a ``(data,
  model)`` grid of devices, one process driving every shard), row-sharded
  values, the collectives (the all-gather along ``data``, the max and the
  sum of per-shard values) and the training layouts
  (``encoder_param_specs``, ``shard_params``, ``shard_batch``);
- :mod:`~trueno_rag_tpu_torch.parallel.sharded` — corpus-sharded exact
  dense top-k: each shard scans its rows and keeps a local top-k, and the
  ``k·s`` candidates merge on the mesh's first device;
- ``sparse``, ``compact``, ``clustered``, ``maxsim``, ``hybrid`` and
  ``ingest`` — BM25 and learned sparse by document, the certified compact
  and cluster-pruned tiers with composed certificates, late interaction,
  hybrid serving, and multi-host ingest;
- :mod:`~trueno_rag_tpu_torch.parallel.train` — the data- and
  tensor-parallel train steps, which ``train/``'s steps and losses run
  when given sharded parameters.
"""

from trueno_rag_tpu_torch.parallel.clustered import ShardedClusteredIndex
from trueno_rag_tpu_torch.parallel.compact import ShardedCompactIndex
from trueno_rag_tpu_torch.parallel.hybrid import ShardedHybridIndex
from trueno_rag_tpu_torch.parallel.maxsim import (
    ShardedTokenIndex,
    sharded_maxsim_topk,
    sharded_maxsim_topk_scan16_fused,
)
from trueno_rag_tpu_torch.parallel.mesh import Mesh, create_mesh, encoder_param_specs
from trueno_rag_tpu_torch.parallel.sharded import ShardedVectorIndex, sharded_dense_topk

__all__ = [
    "create_mesh",
    "encoder_param_specs",
    "Mesh",
    "sharded_dense_topk",
    "ShardedVectorIndex",
    "ShardedTokenIndex",
    "sharded_maxsim_topk",
    "sharded_maxsim_topk_scan16_fused",
    "ShardedHybridIndex",
    "ShardedCompactIndex",
    "ShardedClusteredIndex",
]
