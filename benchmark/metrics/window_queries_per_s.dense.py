"""window_queries_per_s.dense (queries/s, host clock): the dense cell's
throughput over its measured window, read as ``queries_per_s`` is. The
host's Python paces that cell (its device idles ~90% of the window), and
the host's speed moves between machines and over minutes by more than an
end-to-end bound can hold, so here it is a per-layer reading."""

from benchmark.harness.readings import queries_per_s as read  # noqa: F401
