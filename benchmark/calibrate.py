#!/usr/bin/env python3
"""The control's readings, which the limits in ``benchmark/checks/<cell>.json``
are set from beside the program's own.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 [--out FILE]

The control is the plain reference in the program's place, computed one
precision below what the configuration states (fp8 encoder products,
float32 scores). For each seed it answers ``check_batches`` batches of the
seed's query pool, and they are compared with the reference as a run
compares the program's answers. One JSON line per seed goes to standard
output and, with ``--out``, is appended to that file. The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_answers(cell, reference, weights, texts, queries, seed: int, device):
    """The control's answers to ``queries``: per query ``[(row, score, text)]``."""
    from benchmark.reference.scores import top_k

    s = reference.scores(cell.config, weights, queries, seed, device, "fp8")
    vals, rows = top_k(s, cell.traffic["k"])
    return [[(int(r), float(v), texts[int(r)]) for v, r in zip(vs, rs)]
            for vs, rs in zip(vals.cpu().numpy(), rows.cpu().numpy())]


def control_readings(bench, name: str, seed: int, device) -> dict:
    """The control's readings on ``check_batches`` batches drawn from the
    seed's query pool."""
    from benchmark.harness import cell, inputs

    c = bench.cell(name)
    reference = c.reference()
    weights = inputs.encoder_weights(c.config, seed, device)
    texts = inputs.doc_texts(c.config["word_law"], c.config["corpus"]["chunks"], c.config["corpus"]["words"],
                             seed, device)
    pool = inputs.query_batches(c.config["word_law"], c.traffic, seed, device)
    picks = inputs.rng(seed, inputs.STREAM_SAMPLE).choice(len(pool), c.traffic["check_batches"], replace=False)
    batches = [pool[i] for i in sorted(picks)]
    answers = [control_answers(c, reference, weights, texts, qs, seed, device) for qs in batches]
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
