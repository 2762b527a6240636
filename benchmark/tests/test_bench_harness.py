"""The harness on the CPU at a tiny corpus: what it finds by name, the
shape of its result line, and the check for JAX modules."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark.harness import cell
from benchmark.harness.spec import Benchmark

from .conftest import ROOT

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, name, traced, seconds=0.5, **kw):
    return cell.run_cell(Benchmark(root), name, 2**31 + 99, seconds, traced, "cpu", time.perf_counter(), **kw)


def test_new_cell_and_metric_are_found_from_new_files_only(tiny_root):
    # a cell added later: a new traffic mix, its limits and a new metric's
    # reader, plus entries in BENCHMARK.json; no file of the harness edited
    bdir = os.path.join(tiny_root, "benchmark")
    with open(os.path.join(bdir, "traffic", "late.b32.json")) as f:
        mix = json.load(f)
    mix.update(batch=8, who="a test's small-batch mix")
    with open(os.path.join(bdir, "traffic", "late.b8.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bdir, "checks", "late-262k.b8.json"), "w") as f:
        json.dump({"bad_answers": 0, "score_gap": 1e-5, "rank_gap": 1e-5}, f)
    with open(os.path.join(bdir, "metrics", "batches_in_window.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.window.batches)\n")
    spec_path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "late-262k.b8", "config": "minilm-l6-late-262k", "traffic": "late.b8",
                              "chips": 1, "why": "a test's cell"})
    spec["per_layer"].append({"name": "batches_in_window", "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "retriever", "moves": "queries_per_s",
                              "workloads": ["late-262k.b8"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    bench = Benchmark(tiny_root)
    assert "late-262k.b8" in bench.workloads()
    c = bench.cell("late-262k.b8")
    assert c.traffic["batch"] == 8
    assert [m["name"] for m in c.per_layer] == ["batches_in_window"]
    out = run(tiny_root, "late-262k.b8", traced=True)
    assert out["correct"] is True
    assert out["metrics"]["batches_in_window"]["value"] >= 1
    assert out["attempted"] % 8 == 0


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contract_keys(tiny_root, traced):
    out = run(tiny_root, "late-262k.b32", traced)
    assert list(out)[: len(RESULT_KEYS)] == RESULT_KEYS
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in out["device"]
    names = set(out["metrics"])
    if traced:
        # host-side readings only: the CPU has no device metrics
        assert names == {"encode_ms", "certified_share.maxsim"}
    else:
        assert names == {"setup_s", "queries_per_s", "batch_p95_ms"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_dense_cell_runs_on_the_bf16_tier(tiny_root):
    calls = []

    def hook(system):
        run_batch = system.run
        system.run = lambda qs: calls.append(len(qs)) or run_batch(qs)

    out = run(tiny_root, "dense-1m.b256", traced=False, system_hook=hook)
    assert out["correct"] is True
    # warm-up (1 batch), the window, then the device segment's 2 batches
    # after it; the CPU has no device time, so its metric is left out
    assert len(calls) == 1 + out["attempted"] // 256 + 2
    assert set(out["metrics"]) == {"setup_s"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "trueno_rag_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "trueno_rag_tpu.index", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert cell.forbidden_modules() == ["jax", "trueno_rag_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness.cell as c, benchmark.systems.late_interaction, benchmark.systems.hybrid\n"
            "import benchmark.reference.late_interaction, benchmark.reference.hybrid\n"
            "import trueno_rag_tpu_torch, trueno_rag_tpu_torch.retrieve, trueno_rag_tpu_torch.models.late_interaction\n"
            "print(c.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload", "late-262k.b32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
