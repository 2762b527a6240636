"""The port's IR metrics against the JAX package's: the host oracle
(``metrics.py``, per query and aggregated, with duplicate retrieved ids)
and ``batched_metrics`` / ``pad_ids`` (plain torch on the tensors'
device; jitted jnp there) on padded id matrices, rtol 1e-6."""

import numpy as np
import pytest
import torch

from trueno_rag_tpu import metrics as jm
from trueno_rag_tpu.ops.metrics import batched_metrics as jbatched
from trueno_rag_tpu.ops.metrics import pad_ids as jpad

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import metrics as tm
from trueno_rag_tpu_torch.ops.metrics import batched_metrics, pad_ids


def _id_lists(seed, n=40, pool=30, k=12, r=5):
    rng = np.random.default_rng(seed)
    retrieved = [[f"c{x}" for x in rng.integers(0, pool, size=int(rng.integers(0, k + 1)))] for _ in range(n)]
    relevant = [{f"c{x}" for x in rng.integers(0, pool, size=int(rng.integers(0, r + 1)))} for _ in range(n)]
    return retrieved, relevant


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_metrics_match_jax(seed):
    retrieved, relevant = _id_lists(seed)
    for ret, rel in zip(retrieved, relevant):
        for k in (0, 1, 3, 5, 10, 20):
            for name in ("recall_at_k", "precision_at_k", "ndcg_at_k", "f1_at_k", "hit_rate_at_k"):
                assert getattr(tm, name)(ret, rel, k) == getattr(jm, name)(ret, rel, k), (name, k)
        assert tm.mean_reciprocal_rank(ret, rel) == jm.mean_reciprocal_rank(ret, rel)
        assert tm.average_precision(ret, rel) == jm.average_precision(ret, rel)
    per_t = [trag.RetrievalMetrics.compute(a, b, (1, 5, 10)) for a, b in zip(retrieved, relevant)]
    per_j = [jm.RetrievalMetrics.compute(a, b, (1, 5, 10)) for a, b in zip(retrieved, relevant)]
    assert [vars(x) for x in per_t] == [vars(x) for x in per_j]
    assert vars(trag.AggregatedMetrics.aggregate(per_t)) == vars(jm.AggregatedMetrics.aggregate(per_j))
    assert vars(trag.AggregatedMetrics.aggregate([])) == vars(jm.AggregatedMetrics.aggregate([]))


@pytest.mark.parametrize("k_values", [(1, 5, 10), (2, 3), (0, 1, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_metrics_match_jax(seed, k_values):
    rng = np.random.default_rng(seed)
    q, kk, r = 64, 16, 6
    retrieved = np.stack([rng.permutation(50)[:kk] for _ in range(q)]).astype(np.int32)
    retrieved[rng.random((q, kk)) < 0.2] = -1  # empty slots
    relevant = rng.integers(0, 50, size=(q, r)).astype(np.int32)
    relevant[rng.random((q, r)) < 0.4] = -1
    relevant[:3] = -1  # no relevant ids at all
    got = batched_metrics(torch.from_numpy(retrieved), torch.from_numpy(relevant), k_values=k_values)
    want = jbatched(retrieved, relevant, k_values=k_values)
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert got[name].dtype == torch.float32 and got[name].shape == (q,)
        np.testing.assert_allclose(got[name].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7, err_msg=name)


def test_batched_metrics_agree_with_the_host_oracle():
    retrieved, relevant = _id_lists(5, n=30)
    rows = {f"c{i}": i for i in range(30)}
    # the device contract: retrieved ids already deduplicated
    dedup = [list(dict.fromkeys(r))[:10] for r in retrieved]
    ret = pad_ids(dedup, 10, mapper=rows.__getitem__, device="cpu")
    rel = pad_ids([sorted(r) for r in relevant], 5, mapper=rows.__getitem__, device="cpu")
    got = batched_metrics(ret, rel)
    for i, (a, b) in enumerate(zip(dedup, relevant)):
        m = trag.RetrievalMetrics.compute(a, b)
        assert abs(got["mrr"][i].item() - m.mrr) <= 1e-6
        assert abs(got["map"][i].item() - m.map) <= 1e-6
        for k in (1, 5, 10):
            assert abs(got[f"recall@{k}"][i].item() - m.recall[k]) <= 1e-6
            assert abs(got[f"precision@{k}"][i].item() - m.precision[k]) <= 1e-6
            assert abs(got[f"ndcg@{k}"][i].item() - m.ndcg[k]) <= 1e-6


def test_pad_ids_matches_jax():
    lists = [[3, 1, 2], [], [9] * 12, [0]]
    got = pad_ids(lists, 8, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpad(lists, 8)))
    names = [["b", "a"], ["c"]]
    m = {"a": 0, "b": 1, "c": 2}.__getitem__
    np.testing.assert_array_equal(pad_ids(names, 3, mapper=m, device="cpu").numpy(), np.asarray(jpad(names, 3, m)))
