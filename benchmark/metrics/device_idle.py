"""device_idle (%, device trace): the share of the traced window with no
device operation running (late cell)."""

from benchmark.harness.readings import device_idle as read  # noqa: F401
