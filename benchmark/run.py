#!/usr/bin/env python3
"""Run one cell of the benchmark of trueno_rag_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with as many CUDA cards as
the cell asks for (``BENCHMARK.json``). Set-up stages, the window and the
checks go to standard error; the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit. Without enough cards,
or with JAX or the JAX package loaded, it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of compiled kernels at fixed paths inside the checkout (the port's
# own nvcc build goes to build/kernels/ beside them)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell
    from benchmark.harness.spec import Benchmark

    bench = Benchmark(ROOT)
    chips = bench.cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        cell.log(f"needs {chips} CUDA card(s); found "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = cell.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = cell.forbidden_modules()
    if bad:
        cell.log(f"modules loaded that the benchmark may not load: {bad}")
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
