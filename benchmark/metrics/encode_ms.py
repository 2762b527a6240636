"""encode_ms (ms, program span): the query encoder's host milliseconds per
batch in the staged pass (late cell)."""

from benchmark.harness.readings import encode_ms as read  # noqa: F401
