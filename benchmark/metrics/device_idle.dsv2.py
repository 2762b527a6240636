"""device_idle.dsv2 (%, device trace): the share of the traced window with
no device operation running (DeepSeek-V2-Lite cell)."""

from benchmark.harness.readings import device_idle as read  # noqa: F401
