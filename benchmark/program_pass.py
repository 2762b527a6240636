#!/usr/bin/env python3
"""Run one cell's program pass: its traced batches with the program's span
recorder on, read per stage of ``retrieve_batch`` (``harness/spans.py``).

    python3 benchmark/program_pass.py --workload <name> --seed <n> [--pairs P --seconds S]

Run from the root of a checkout, on the card when there is one. Set-up
stages, the recorder's cost (``--pairs``) and the pass's table go to
standard error; the last line of standard output is one JSON object:
``workload``, ``seed``, ``device``, ``readings`` (:func:`spans.summary` of
the run without the profiler), ``idle_named_share``, ``dropped``,
``cost`` (each pair's queries/s off and on, or null) and ``pass`` (the
whole reading).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the same caches of compiled kernels as benchmark/run.py's
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=0, help="windows off and on to measure the recorder's cost")
    ap.add_argument("--seconds", type=float, default=10.0, help="seconds of each of those windows")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spans
    from benchmark.harness.spec import Benchmark

    device = "cuda" if torch.cuda.is_available() else "cpu"
    p = spans.run(Benchmark(ROOT), args.workload, args.seed, device, args.pairs, args.seconds)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name() if device == "cuda" else "cpu",
                      "readings": spans.summary(p["quiet"]), "idle_named_share": p["idle_named_share"],
                      "dropped": p["dropped"], "cost": p["cost"], "pass": p}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
