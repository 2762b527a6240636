"""step_mfu (%, host clock with counted work): the window's encoder and
MaxSim operations over its seconds against 989 TFLOP/s (late cell)."""

from benchmark.harness.readings import step_mfu as read  # noqa: F401
