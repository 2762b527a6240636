#!/usr/bin/env python3
"""The control's readings for a cell whose system draws its own weights
(``weights(cfg, seed, device)`` in ``benchmark/systems/<system>.py``), as
``benchmark/calibrate.py`` reads them for the encoder cells.

    python3 benchmark/calibrate_system.py --workload <name> --seeds 1 2 3 [--out FILE]

The control is the plain reference in the program's place, one precision
below what the configuration states (fp8 products, float32 scores), on
``check_batches`` batches of each seed's query pool, compared with the
reference as a run compares the program's answers. One JSON line per seed
goes to standard output and, with ``--out``, is appended to that file. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_readings(bench, name: str, seed: int, device) -> dict:
    from benchmark import calibrate
    from benchmark.harness import cell, inputs

    c = bench.cell(name)
    reference = c.reference()
    weights = c.system().weights(c.config, seed, device)
    texts = inputs.doc_texts(c.config["word_law"], c.config["corpus"]["chunks"], c.config["corpus"]["words"],
                             seed, device)
    pool = inputs.query_batches(c.config["word_law"], c.traffic, seed, device)
    picks = inputs.rng(seed, inputs.STREAM_SAMPLE).choice(len(pool), c.traffic["check_batches"], replace=False)
    batches = [pool[i] for i in sorted(picks)]
    answers = [calibrate.control_answers(c, reference, weights, texts, qs, seed, device) for qs in batches]
    return cell.check(c, reference, weights, texts, batches, answers, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmark.harness.spec import Benchmark

    bench = Benchmark(ROOT)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = control_readings(bench, args.workload, seed, torch.device("cuda"))
        lines.append(json.dumps({"workload": args.workload, "side": "control", "seed": seed, "readings": readings,
                                 "seconds": time.perf_counter() - t0}))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
