"""The DeepSeek-V2-Lite cell on the CPU: its work arithmetic at the
published widths, and whole runs of the cell at test widths and a tiny
corpus (a run at the published widths needs the card's 31 GB of weights):
sound runs correct, the control (the reference one precision lower) not,
and the readers of the device metrics silent off the card."""

import json
import os
import time

import pytest

from benchmark import calibrate
from benchmark.harness import cell, inputs
from benchmark.harness.spec import Benchmark
from benchmark.reference import compare
from benchmark.work import deepseek_v2 as work

from .conftest import _edit

CELL = "dsv2lite-1m.b256"
CONFIG = os.path.join("benchmark", "configs", "deepseek-v2-lite-dense-1m.json")
SEED = 2**31 + 23
# test widths: one dense layer, three MoE layers of 8 experts (top 2, two
# shared), the nope, rope and v widths apart
TINY_WIDTHS = {"vocab_size": 512, "hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4,
               "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 12,
               "intermediate_size": 96, "moe_intermediate_size": 24, "n_routed_experts": 8, "num_experts_per_tok": 2}


def published():
    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "deepseek-v2-lite-dense-1m.json")) as f:
        return json.load(f)


@pytest.fixture
def dsv2_root(tiny_root):
    _edit(os.path.join(tiny_root, CONFIG), corpus={"chunks": 4096, "row_slab": 512},
          vector_store={"scan_tier": "bf16"}, **TINY_WIDTHS)
    return tiny_root


def test_work_at_the_published_widths():
    cfg = published()
    assert 2 * work.attention_products(cfg) == 2 * (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048)
    assert 2 * work.attention_products(cfg) / 1e6 == pytest.approx(27.5, abs=0.05)
    assert work.dense_mlp_flops(1, cfg) / 1e6 == pytest.approx(134.5, abs=0.05)
    routed = 2 * 6 * 3 * 2048 * 1408
    assert routed / 1e6 == pytest.approx(103.8, abs=0.05)
    assert work.moe_flops(1, [6] + [0] * 63, cfg) / 1e6 == pytest.approx(138.7, abs=0.05)
    assert work.moe_flops(1, [6] + [0] * 63, cfg) - work.moe_flops(1, [0] * 64, cfg) == routed
    assert work.per_token_flops(cfg) / 1e9 == pytest.approx(4.48, abs=0.005)
    # one sequence of 24 tokens: the linear part plus 27 layers of 2·L²·16·(192 + 128)
    assert work.model_flops([24], cfg) == 24 * work.per_token_flops(cfg) + 27 * 2 * 24 * 24 * 16 * 320
    # a MoE layer's weights: 64 experts and the shared pair, bf16 (1.14 GB); its
    # least time at 6,100 tokens is its operations (0.855 ms)
    assert work.moe_bytes(cfg) == 2 * (2048 * 64 + 3 * 2048 * 2816 + 64 * 3 * 2048 * 1408)
    s = {"lengths": [24] * 254 + [20, 28], "expert_tokens": [[576] * 64] * 26}  # 6 × 6,144 pairs
    t = work.moe_least_seconds(s, cfg) / 26
    assert t == pytest.approx(2 * (6144 * (2048 * 64 + 3 * 2048 * 2816) + 6144 * 6 * 3 * 2048 * 1408) / 989e12)
    assert t * 1e3 == pytest.approx(0.8615, abs=1e-4)
    # a batch of 8 queries is bound by the weights' bytes
    small = {"lengths": [24] * 8, "expert_tokens": [[3] * 64] * 26}
    assert work.moe_least_seconds(small, cfg) / 26 == pytest.approx(work.moe_bytes(cfg) / 3.35e12)


def test_readers_of_device_metrics_are_silent_off_the_card(dsv2_root):
    out = cell.run_cell(Benchmark(dsv2_root), CELL, SEED, 0.5, True, "cpu", time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"routed_share.dsv2"}
    assert out["metrics"]["routed_share.dsv2"]["value"] == 100.0


def test_sound_runs_are_correct_on_several_seeds(dsv2_root):
    for seed in (1, 2**33 + 5):
        out = cell.run_cell(Benchmark(dsv2_root), CELL, seed, 0.3, False, "cpu", time.perf_counter())
        assert out["correct"] is True, out["checks"]
        assert set(out["metrics"]) == {"setup_s", "queries_per_s", "batch_p95_ms"}


def test_the_control_fails_the_comparison(dsv2_root):
    """The reference one precision lower (fp8 products, TF32 logits and
    router, float32 scores), in the program's place, at the cell's batch
    and k."""
    c = Benchmark(dsv2_root).cell(CELL)
    reference = c.reference()
    weights = c.system().weights(c.config, SEED, "cpu")
    texts = inputs.doc_texts(c.config["word_law"], c.config["corpus"]["chunks"], c.config["corpus"]["words"],
                             SEED, "cpu")
    qs = inputs.query_batches(c.config["word_law"], c.traffic, SEED, "cpu")[0]
    answers = calibrate.control_answers(c, reference, weights, texts, qs, SEED, "cpu")
    readings = cell.check(c, reference, weights, texts, [qs], [answers], SEED, "cpu")
    assert not compare.verdict(readings, c.limits), readings
