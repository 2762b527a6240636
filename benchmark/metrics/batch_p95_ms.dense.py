"""batch_p95_ms.dense (ms, host clock): the 95th percentile of the dense
cell's batches, read as ``batch_p95_ms`` is. The device idles most of that
window, so the tail is the host's, and a per-layer reading."""

from benchmark.harness.readings import batch_p95_ms as read  # noqa: F401
