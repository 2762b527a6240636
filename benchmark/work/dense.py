"""Work of the dense scan (K1 over the bf16 tier): every query against
every stored row.

- operations: 2·B·N·d;
- bytes: the tier's rows read once at its width, N·d·w (w = 2 for bf16,
  1 for int8, 4 for the f32 matrix).

At N = 1,048,576, d = 384, bf16: 805 MB, 0.240 ms at 3.35 TB/s; B = 256
is 206 GFLOP, 0.208 ms at 989 TFLOP/s: the bound is the bytes. The same
work whatever kernel implements it.
"""

from benchmark.work import peaks


def ops(shapes: dict) -> float:
    return 2.0 * shapes["b"] * shapes["n"] * shapes["d"]


def nbytes(shapes: dict) -> float:
    return float(shapes["n"] * shapes["d"] * shapes["tier_bytes"])


def least_seconds(shapes: dict):
    rate = peaks.INT8_OPS if shapes["tier_bytes"] == 1 else peaks.BF16_FLOPS
    return peaks.least_seconds(ops(shapes), nbytes(shapes), rate)
