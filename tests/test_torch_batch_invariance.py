"""Batch invariance of the sparse candidate tails on the card: a query row
answers bit for bit as it does alone, whatever the rows batched with it
(a served query then equals itself in any micro-batch). The tail's per-row
cumsum (``ops/bm25._row_cumsum``) relies on how torch shapes its CUDA scan;
these tests pin that for each torch the card runs. No JAX here: the card's
machine runs them with ``--noconftest -m cuda``."""

import numpy as np
import pytest
import torch

from trueno_rag_tpu_torch.ops import bm25 as tbm25

BL = tbm25.BLOCK_LEN


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [64, 128])
def test_cuda_candidate_tails_are_batch_invariant(slots):
    """Each query row through ``_candidate_topk`` (the BM25 and
    learned tail) and through ``weighted_topk_blocks`` answers bit for bit
    as it does alone, at B = 1, 2, 31, 33 and 256 and at two slot buckets.
    The tail's per-row cumsum (``ops/bm25._row_cumsum``) relies on how torch
    shapes its CUDA scan; this pins it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the property is of torch's CUDA scan)")
    rng = np.random.default_rng(slots)
    n_rows, nb, pool = 200_000, 4096, 256
    blocks = np.zeros((nb + 1, 2, BL), np.float32)
    blocks[:nb, 0] = rng.integers(0, n_rows, (nb, BL)).astype(np.float32)
    blocks[:nb, 1] = rng.uniform(0.05, 2.0, (nb, BL)).astype(np.float32)
    blocks = torch.from_numpy(blocks).cuda()
    bids = torch.from_numpy(rng.integers(0, nb + 1, (pool, slots)).astype(np.int32)).cuda()
    lo = torch.from_numpy(rng.integers(0, 64, (pool, slots)).astype(np.int32)).cuda()
    hi = torch.from_numpy(rng.integers(192, BL + 1, (pool, slots)).astype(np.int32)).cuda()
    qw = torch.from_numpy(rng.uniform(0.1, 3.0, (pool, slots)).astype(np.float32)).cuda()
    keys = torch.from_numpy(rng.integers(0, n_rows, (pool, slots * BL)).astype(np.int32)).cuda()
    keys[:, ::7] = torch.iinfo(torch.int32).max  # invalid slots
    contrib = torch.from_numpy(rng.uniform(0.0, 4.0, (pool, slots * BL)).astype(np.float32)).cuda()
    contrib[:, ::7] = 0.0
    weighted = lambda sl: tbm25.weighted_topk_blocks(bids[sl], lo[sl], hi[sl], qw[sl], blocks, k=50)  # noqa: E731
    tail = lambda sl: tbm25._candidate_topk(keys[sl], contrib[sl], 50)  # noqa: E731
    for fn in (weighted, tail):
        alone = [fn(slice(i, i + 1)) for i in range(pool)]
        for b in (2, 31, 33, 256):
            for g in range(0, pool, b):
                s_b, r_b = fn(slice(g, min(g + b, pool)))
                for j in range(s_b.shape[0]):
                    assert torch.equal(r_b[j], alone[g + j][1][0]), (b, g + j)
                    assert torch.equal(s_b[j].view(torch.int32), alone[g + j][0][0].view(torch.int32)), (b, g + j)
