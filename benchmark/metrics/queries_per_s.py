"""queries_per_s (queries/s, host clock), the late cell's throughput: every
query answered in the measured window over the window's seconds."""

from benchmark.harness.readings import queries_per_s as read  # noqa: F401
