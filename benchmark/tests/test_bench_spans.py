"""The program pass's reader (``harness/spans.py``) on a synthetic span list
and synthetic profiler events, and CPU program passes of tiny cells."""

import os
import sys

import pytest

from benchmark.harness import spans
from benchmark.harness.spec import Benchmark
from trueno_rag_tpu_torch.utils.profiling import Span

# one batch on the profiler's clock (us): the pass's range and the rag.*
# ranges on thread 1, the launches (runtime calls, correlation ids 7-9)
HOST = [
    (0, 100, "bench.program", 1, 1),
    (10, 90, "rag.retrieve", 2, 1),
    (10, 40, "rag.encode", 3, 1),
    (10, 20, "rag.encode.tokenize", 4, 1),
    (22, 23, "cudaLaunchKernel", 7, 1),
    (40, 80, "rag.scan", 5, 1),
    (41, 42, "cudaLaunchKernel", 8, 1),
    (60, 80, "rag.scan.wait", 6, 1),
    (61, 62, "cudaMemcpyAsync", 9, 1),
    (30, 70, "rag.hydrate", 10, 2),  # another thread's span: not the pass's
]
DEVICE = [
    (25, 35, "encoder_gemm", 7),
    (45, 60, "maxsim_scan_kernel", 8),
    (62, 64, "Memcpy DtoH (Device -> Pageable)", 9),
    (40, 80, "rag.scan", 5),  # the device copy of a range: no work
    (10, 90, "bench.program", 1),
    (95, 97, "stray_kernel", 99),  # no launch in the profile
]
# the same batch as the recorder kept it (ns)
SPANS = [
    Span(2, 3, 1, "rag.encode.tokenize", 10_000, 20_000, 1, {}),
    Span(3, 1, 1, "rag.encode", 10_000, 40_000, 1, {}),
    Span(4, 5, 1, "rag.scan.wait", 60_000, 80_000, 1, {}),
    Span(5, 1, 1, "rag.scan", 40_000, 80_000, 1, {}),
    Span(6, 1, 1, "rag.gc", 82_000, 84_000, 1, {"generation": 0}),
    Span(7, 1, 1, "rag.hydrate", 84_000, 89_000, 1, {}),
    Span(1, 0, 1, "rag.retrieve", 10_000, 90_000, 1, {"queries": 4, "k": 3}),
]
COUNTERS = {"rag.encode.tokens": 40, "rag.encode.padded_tokens": 64}


def test_reader_on_synthetic_spans_and_events():
    p = spans.read(SPANS, COUNTERS, HOST, DEVICE, 1)
    assert p["roots"] == 1 and p["root_ms"] == pytest.approx(0.08)
    # self time: a span's duration less its children's
    assert p["self_ms"] == pytest.approx({"rag.retrieve": 0.003, "rag.encode": 0.02, "rag.encode.tokenize": 0.01,
                                          "rag.scan": 0.02, "rag.scan.wait": 0.02, "rag.gc": 0.002,
                                          "rag.hydrate": 0.005})
    # device copies of rag.* and bench.* ranges are no work: busy 25-35, 45-60, 62-64 (and 95-97)
    assert p["busy_ms"] == pytest.approx(0.029)
    # each idle moment goes to the innermost range open then; thread 2's range is not the pass's
    assert p["idle_ms"] == pytest.approx({None: 0.018, "rag.encode.tokenize": 0.01, "rag.encode": 0.01,
                                          "rag.scan": 0.005, "rag.scan.wait": 0.018, "rag.retrieve": 0.01})
    assert p["idle_named_share"] == pytest.approx(100 * 43 / 71)
    # device time goes to the range open at the launch; the stray kernel has none
    assert p["device_ms"] == pytest.approx({"rag.encode": 0.01, "rag.scan": 0.015, "rag.scan.wait": 0.002})
    assert p["unmatched_device_ms"] == pytest.approx(0.002)
    assert p["window_ms"] == pytest.approx(0.1) and p["counters"] == COUNTERS
    assert p["copy_lag_ms"] == pytest.approx([-0.002] * 3)  # the copy's call returned at 62, its device end 64


def test_innermost_names_every_moment_once():
    segs = spans.innermost([(10, 90, "a"), (10, 40, "b"), (20, 30, "c"), (50, 80, "d"), (95, 120, "e")], 0, 100)
    assert segs == [(0, 10, None), (10, 20, "b"), (20, 30, "c"), (30, 40, "b"), (40, 50, "a"), (50, 80, "d"),
                    (80, 90, "a"), (90, 95, None), (95, 100, "e")]
    assert spans.innermost([], 0, 5) == [(0, 5, None)]


def test_summary_reads_the_pass():
    p = spans.read(SPANS, COUNTERS, [], [], 2)
    got = spans.summary(p)
    assert got == pytest.approx({"tokenize_ms": 0.005, "encode_host_ms": 0.01, "scan_host_ms": 0.01,
                                 "hydrate_ms": 0.0025, "host_wait_ms": 0.01, "encode_token_share": 62.5,
                                 "root_self_ms": 0.0015, "root_ms": 0.08})
    # the five span readings and the root's self time cover the root less its collections
    parts = sum(got[m] for m in spans.PARTS) + got["root_self_ms"]
    assert parts + p["self_ms"]["rag.gc"] == pytest.approx(got["root_ms"] / 2)


def test_summary_reads_none_without_spans():
    assert all(v is None for v in spans.summary(spans.read([], {}, [], [], 1)).values())


@pytest.mark.parametrize("workload", ["late-262k.b32", "dense-1m.b256"])
def test_a_cpu_program_pass_of_a_tiny_cell(tiny_root, workload):
    bench = Benchmark(tiny_root)
    p = spans.run(bench, workload, 2**31 + 7, "cpu", pairs=1, seconds=0.2)
    n = bench.cell(workload).traffic["trace_batches"]
    assert p["batches"] == n and p["roots"] == p["quiet"]["roots"] == n and p["dropped"] == 0
    assert p["quiet"]["calls"]["rag.encode.tokenize"] == p["calls"]["rag.encode.tokenize"] == 1
    assert p["idle_named_share"] > 0 and p["quiet"]["counters"] == p["counters"]
    ((off, on),) = p["cost"]
    assert off > 0 and on > 0
    got = spans.summary(p["quiet"])
    for name, value in got.items():
        assert isinstance(value, float) and value > 0, name
    parts = sum(got[m] for m in spans.PARTS) + got["root_self_ms"] + p["quiet"]["self_ms"].get("rag.gc", 0.0)
    assert parts == pytest.approx(got["root_ms"], rel=1e-6)


def test_the_command_prints_the_pass(tiny_root, monkeypatch, capsys):
    import json
    import runpy

    monkeypatch.setattr(sys, "argv", ["program_pass.py", "--workload", "late-262k.b32", "--seed", "11"])
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, os.environ.get(var, ""))
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(tiny_root, "benchmark", "program_pass.py"), run_name="__main__")
    assert done.value.code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workload"] == "late-262k.b32" and line["device"] == "cpu" and line["cost"] is None
    assert set(line["readings"]) == set(spans.PARTS) | {"encode_token_share", "root_self_ms", "root_ms"}
