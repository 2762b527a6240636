"""The work arithmetic against hand calculations at K1's and K6's shapes."""

import pytest

from benchmark.work import dense, encoder, maxsim, peaks

MINILM = {"hidden_size": 384, "intermediate_size": 1536, "num_hidden_layers": 6}


def test_k1_at_one_million_rows():
    s = {"b": 256, "n": 1 << 20, "d": 384, "tier_bytes": 2}
    assert dense.ops(s) == 2 * 256 * 1048576 * 384 == 206_158_430_208
    assert dense.nbytes(s) == 1048576 * 384 * 2 == 805_306_368
    t, what = dense.least_seconds(s)
    assert what == "bytes" and t == pytest.approx(805_306_368 / 3.35e12)
    assert t * 1e3 == pytest.approx(0.2404, abs=1e-4)


def test_k6_at_the_late_interaction_store():
    s = {"q_tokens": 32 * 10, "n": 262144, "lt": 32, "h": 384, "tier_bytes": 2}
    assert maxsim.ops(s) == 2 * 320 * 262144 * 32 * 384 == 2_061_584_302_080
    assert maxsim.nbytes(s) == 262144 * 32 * 384 * 2 == 6_442_450_944
    t, what = maxsim.least_seconds(s)
    assert what == "operations" and t * 1e3 == pytest.approx(2.0845, abs=1e-4)
    t8, what8 = maxsim.least_seconds(dict(s, q_tokens=80))
    assert what8 == "bytes" and t8 * 1e3 == pytest.approx(1.9231, abs=1e-4)
    assert maxsim.least_seconds(dict(s, tier_bytes=1))[0] == pytest.approx(
        max(2 * 320 * 262144 * 32 * 384 / peaks.INT8_OPS, 262144 * 32 * 384 / peaks.HBM_BYTES_PER_S))


def test_encoder_flops_by_hand():
    # one sequence of 10 tokens: 6 layers x (10 x 2 x (4·384² + 2·384·1536) + 4 x 10² x 384)
    per_layer = 10 * 2 * (4 * 384 * 384 + 2 * 384 * 1536) + 4 * 100 * 384
    assert encoder.flops([10], MINILM) == 6 * per_layer == 213_258_240
    assert encoder.flops([10, 10], MINILM) == 2 * encoder.flops([10], MINILM)
