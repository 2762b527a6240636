"""The benchmark of trueno_rag_tpu_torch: see BENCHMARK.json and run.py."""
