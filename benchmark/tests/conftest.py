"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
configurations hold a tiny corpus, so that a whole run takes seconds on
the CPU (the widths stay the published ones)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CORPUS = {"minilm-l6-late-262k": 1024, "minilm-l6-hybrid-1m": 8192}
TINY_TRAFFIC = {"pool_batches": 4, "trace_batches": 2, "device_batches": 2, "check_batches": 2, "warmup_batches": 1}


def _edit(path, **changes):
    with open(path) as f:
        d = json.load(f)
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(d.get(key), dict):
            d[key].update(value)
        else:
            d[key] = value
    with open(path, "w") as f:
        json.dump(d, f)


def make_tiny(root: str) -> str:
    """Copy ``BENCHMARK.json`` and ``benchmark/`` into ``root``, shrunk."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, n in TINY_CORPUS.items():
        # the bf16 tier, which "auto" engages only past 400,000 rows
        extra = {"vector_store": {"scan_tier": "bf16"}} if "hybrid" in name else {}
        _edit(os.path.join(root, "benchmark", "configs", f"{name}.json"),
              corpus={"chunks": n, "row_slab": 512}, **extra)
    for t in os.listdir(os.path.join(root, "benchmark", "traffic")):
        _edit(os.path.join(root, "benchmark", "traffic", t), **TINY_TRAFFIC)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny(str(tmp_path))
