"""step_mfu.dense (%, host clock with counted work): the window's encoder
and dense-scan operations over its seconds against 989 TFLOP/s (dense
cell)."""

from benchmark.harness.readings import step_mfu as read  # noqa: F401
