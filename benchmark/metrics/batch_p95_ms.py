"""batch_p95_ms (ms, host clock): the 95th percentile over every batch of
the measured window, call to results on the host."""

from benchmark.harness.readings import batch_p95_ms as read  # noqa: F401
