"""What decides ``correct``: the plain reference against the port at tiny
sizes, the control (the reference one precision lower) failing the
comparison, and runs whose timed path is broken underneath coming out not
correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cell, inputs
from benchmark.harness.spec import Benchmark
from benchmark.reference import compare
from benchmark.reference import encoder as ref_encoder
from benchmark.reference import scores as ref_scores
from benchmark.reference import tokenizer as ref_tokenizer
from benchmark.reference.scores import top_k

SEED = 2**31 + 7
CELLS = ["late-262k.b32", "dense-1m.b256"]


def tiny_cfg(tiny_root, name="late-262k.b32"):
    return Benchmark(tiny_root).cell(name).config


def test_tokenizer_matches_the_port():
    from trueno_rag_tpu_torch.models.encoder import HashTokenizer, pad_batch_pow2

    texts = ["w00012 w99999 W00012", "", "a-b c", "w00001 " * 40]
    for max_len in (32, 512):
        want = pad_batch_pow2(HashTokenizer(30522, max_len).encode_batch(texts))
        assert np.array_equal(ref_tokenizer.encode(texts, 30522, max_len), want)


def test_reference_encoder_matches_the_port_bit_for_bit(tiny_root):
    from trueno_rag_tpu_torch.models.encoder import encoder_forward, encoder_token_states

    from benchmark.systems.common import encoder_config

    cfg = tiny_cfg(tiny_root)
    weights = inputs.encoder_weights(cfg, SEED, "cpu")
    ids = torch.from_numpy(ref_tokenizer.encode(["w00012 w00400 w07001", "w00002 w00003"], cfg["vocab_size"], 32))
    got, mask = encoder_token_states(weights, ids, encoder_config(cfg))
    want, want_mask = ref_encoder.token_states(weights, ids, cfg)
    assert torch.equal(mask, want_mask) and torch.equal(got, want)
    pooled = encoder_forward(weights, ids, encoder_config(cfg)).double()
    assert torch.allclose(pooled, ref_encoder.mean_pooled(want, mask), rtol=0, atol=1e-6)


def test_maxsim_reference_matches_the_port_oracle():
    from trueno_rag_tpu_torch.ops.maxsim import maxsim_pair_scores

    n, lt, h, valid = 64, 8, 16, 6
    g = torch.Generator().manual_seed(3)
    q = ref_scores.unit(torch.randn(3, 4, h, generator=g))
    qm = torch.tensor([[True, True, False, True], [True] * 4, [True, False, False, False]])
    got = ref_scores.maxsim_all(q, qm, n, lt, h, valid, SEED, 16)
    tok = torch.cat([x for _, x in inputs.unit_rows(n, (lt, h), SEED, "cpu", 16)])
    t_mask = torch.zeros(n, lt, dtype=torch.bool)
    t_mask[:, :valid] = True
    want = maxsim_pair_scores(q, qm, tok[None].expand(3, -1, -1, -1), t_mask[None].expand(3, -1, -1))
    assert torch.allclose(got.float(), want, rtol=0, atol=1e-6)


def test_cosine_reference_matches_the_port_exact_scores():
    from trueno_rag_tpu_torch.ops.dense import exact_scores, normalize_queries

    g = torch.Generator().manual_seed(4)
    q = torch.randn(5, 24, generator=g)
    got = ref_scores.cosine_all(q, 100, 24, SEED, 32)
    rows = torch.cat([x for _, x in inputs.unit_rows(100, (24,), SEED, "cpu", 32)])
    want = exact_scores(normalize_queries(q), rows, torch.arange(100).expand(5, -1))
    assert torch.allclose(got.float(), want, rtol=0, atol=1e-6)


def test_readings_of_exact_missed_and_malformed_answers():
    texts = [f"t{i}" for i in range(6)]
    s = torch.tensor([[0.9, 0.8, 0.1, 0.7, 0.2, 0.0], [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]], dtype=torch.float64)
    top = top_k(s, 2)[0]
    exact = [[(0, 0.9, "t0"), (1, 0.8, "t1")], [(5, 0.6, "t5"), (4, 0.5, "t4")]]
    assert compare.readings(exact, s, top, 2, texts) == {"bad_answers": 0, "score_gap": 0.0, "rank_gap": 0.0}
    missed = [[(0, 0.9, "t0"), (3, 0.7, "t3")], exact[1]]
    r = compare.readings(missed, s, top, 2, texts)
    assert r["bad_answers"] == 0 and r["rank_gap"] == pytest.approx(0.1)
    malformed = [[(0, 0.9, "t0")], [(5, 0.6, "t4"), (4, 0.5, "t4")]]
    assert compare.readings(malformed, s, top, 2, texts)["bad_answers"] == 2


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(tiny_root, name):
    """The reference one precision lower (fp8 encoder products, float32
    scores), in the program's place, at the cell's batch and k."""
    bench = Benchmark(tiny_root)
    c = bench.cell(name)
    reference = c.reference()
    weights = inputs.encoder_weights(c.config, SEED, "cpu")
    texts = inputs.doc_texts(c.config["word_law"], c.config["corpus"]["chunks"], c.config["corpus"]["words"],
                                SEED, "cpu")
    qs = inputs.query_batches(c.config["word_law"], c.traffic, SEED, "cpu")[0]
    answers = calibrate.control_answers(c, reference, weights, texts, qs, SEED, "cpu")
    readings = cell.check(c, reference, weights, texts, [qs], [answers], SEED, "cpu")
    assert not compare.verdict(readings, c.limits), readings


def _stale(store):
    """A search that returns its first answer to every later batch."""
    first = {}
    real = store.search_arrays

    def search(*a, **kw):
        if "out" not in first:
            first["out"] = real(*a, **kw)
        return first["out"]
    return search


def _half(store):
    """Half of the batch left out: the second half gets the first half's answers."""
    real = store.search_arrays

    def search(q, *a, **kw):
        b, h = len(q), (len(q) + 1) // 2
        a = [x[:h] if getattr(x, "ndim", 0) and len(x) == b else x for x in a]
        s, r = real(q[:h], *a, **kw)
        idx = np.arange(b) % h
        return s[idx], r[idx]
    return search


def _altered(store):
    """One answer altered where it is produced: query 0's best row moved."""
    real = store.search_arrays

    def search(*a, **kw):
        s, r = real(*a, **kw)
        r = r.clone() if torch.is_tensor(r) else r.copy()
        r[0, 0] = (r[0, 0] + 1) % len(store)
        return s, r
    return search


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny_root, name, fault):
    def hook(system):
        retr = system.retriever
        store = retr.store if hasattr(retr, "store") else retr.vector_store
        store.search_arrays = fault(store)

    out = cell.run_cell(Benchmark(tiny_root), name, SEED, 0.5, False, "cpu", time.perf_counter(), system_hook=hook)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct_on_several_seeds(tiny_root, name):
    for seed in (1, 2**31 + 1, 2**33 + 5):
        out = cell.run_cell(Benchmark(tiny_root), name, seed, 0.3, False, "cpu", time.perf_counter())
        assert out["correct"] is True, out["checks"]
