#!/usr/bin/env python3
"""Time persist-1M's save, ``read_index_info`` and load with each host
speed-up of ``trueno_rag_tpu_torch.persist`` switched off in turn.

    cd <repo root> && PYTHONPATH=$PWD python3 tools/persist_ablation.py [--rows 1048576] [--device cuda]

Builds hybrid-1M's pipeline once (``chip_smoke.py``'s corpus: 60-word
documents of its text law, the hash mock embedder at d = 384, the bf16
tier), then for each variant in turn saves it with
``save_index_streaming`` under ``default_compression()``, reads
``read_index_info``, loads it with ``load_index(scan_tier="auto")`` on
``--device`` and builds the loaded store's device state
(``ensure_ready``), checking that every loaded row equals its saved row.
The variants:

- ``all``: the module as it is (run first and last, to show the drift);
- ``gc-off``: the garbage collector switched off around each call (the
  module leaves it on);
- ``zlib``: one ``zlib.compress`` per payload in place of the
  block-parallel deflate (header and matrix frames);
- ``threads``: one worker for the matrix frame pools and the bulk BM25
  codecs.

Prints one line per step as it goes and, last, one JSON object: the card's
name and power limit (``nvidia-smi``), the codec and, per variant, the
seconds of each step and the artifact's bytes.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402  (the smoke's corpus and constants)


def build_pipeline(rows: int, device: str, seed: int):
    import numpy as np

    import trueno_rag_tpu_torch as rag

    rng = np.random.default_rng(seed)
    docs = [rag.Document(t, id=f"doc{i}") for i, t in enumerate(smoke.make_texts(rng, rows, smoke.DOC_WORDS))]
    pipe = (
        rag.RagPipelineBuilder()
        .with_embedder(rag.MockEmbedder(smoke.DIM))
        .with_reranker(rag.LexicalReranker())
        .with_vector_config(rag.VectorStoreConfig(scan_tier="auto"))
        .with_device(device)
        .build()
    )
    t0 = time.perf_counter()
    n = pipe.index_documents(docs)
    smoke.check(n == rows, f"indexed {n} chunks, expected {rows}")
    smoke.log(f"ingest: {n} chunks in {time.perf_counter() - t0:.1f} s")
    return pipe


def _gc_off(fn):
    def run(*args, **kwargs):
        gc.disable()
        try:
            return fn(*args, **kwargs)
        finally:
            gc.enable()

    return run


def variant_settings(name: str):
    """→ (function table, undo): the persist entry points to call and a
    function restoring the module's settings."""
    from trueno_rag_tpu_torch import _msgpack, persist

    fns = {f: getattr(persist, f) for f in ("save_index_streaming", "read_index_info", "load_index")}
    saved = (persist._ZLIB_BLOCK, persist._WORKERS, _msgpack.WORKERS)

    def undo():
        persist._ZLIB_BLOCK, persist._WORKERS, _msgpack.WORKERS = saved

    if name == "gc-off":
        fns = {f: _gc_off(fn) for f, fn in fns.items()}
    elif name == "zlib":
        persist._ZLIB_BLOCK = 1 << 62
    elif name == "threads":
        persist._WORKERS = _msgpack.WORKERS = 1
    elif name != "all":
        raise SystemExit(f"unknown variant {name!r}")
    return fns, undo


def run_variant(name: str, pipe, device: str, tmp: str):
    import numpy as np
    import torch

    import trueno_rag_tpu_torch as rag
    from trueno_rag_tpu_torch import persist

    retr = pipe.retriever
    n = len(retr.registry)
    path = os.path.join(tmp, "index.trag")
    fns, undo = variant_settings(name)
    try:
        sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
        out = {}
        t0 = time.perf_counter()
        fns["save_index_streaming"](path, retr, embedder_info={"type": "mock", "dimension": smoke.DIM},
                                    codec=persist.default_compression())
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        meta = fns["read_index_info"](path)
        out["info_s"] = time.perf_counter() - t0
        smoke.check(len(meta["chunks"]) == n, f"{name}: read_index_info")
        del meta
        t0 = time.perf_counter()
        loaded, _ = fns["load_index"](path, rag.MockEmbedder(smoke.DIM), scan_tier="auto", device=device)
        out["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded.ensure_ready()
        sync()
        out["ready_s"] = time.perf_counter() - t0
        saved_rows = [retr.registry.row_of(c) for c in loaded.registry.ids()]
        smoke.check(bool(np.array_equal(loaded.vector_store._host[:n], retr.vector_store._host[saved_rows])),
                    f"{name}: a loaded row differs from its saved row")
        smoke.log(f"{name}: save {out['save_s']:.2f} s ({out['bytes']} bytes), read_index_info "
                  f"{out['info_s']:.2f} s, load_index {out['load_s']:.2f} s, device build {out['ready_s']:.2f} s")
        del loaded
    finally:
        undo()
        if os.path.exists(path):
            os.unlink(path)
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=smoke.N_ROWS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default="all,gc-off,zlib,threads,all")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from trueno_rag_tpu_torch import persist

    card = "not measured (no GPU)"
    if args.device.startswith("cuda"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
    smoke.log(f"card: {card}")
    pipe = build_pipeline(args.rows, args.device, args.seed)
    tmp = tempfile.mkdtemp(prefix="persist_ablation_")
    runs = []
    try:
        smoke.need_disk(tmp, 2.0 * args.rows * (smoke.DIM * 4 + 1024), "persist ablation")
        for name in args.variants.split(","):
            runs.append({"variant": name, **run_variant(name, pipe, args.device, tmp)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"card": card, "rows": args.rows, "codec": persist.default_compression().value,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
