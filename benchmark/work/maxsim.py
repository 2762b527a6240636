"""Work of the MaxSim scan (K6 over the tiered store's replica): every
query token against every stored token of every chunk.

- operations: 2·Q·N·Lt·H, Q the batch's real query tokens (the query mask's
  sum; padding positions left out), N chunks of Lt tokens of width H;
- bytes: the replica's tokens read once at the tier's width, N·Lt·H·w
  (w = 2 for bf16, 1 for int8); queries, masks and outputs are small.

At N = 262,144, Lt = 32, H = 384, bf16: 6.44 GB, 1.92 ms at 3.35 TB/s. A
batch of 32 queries of 10 real tokens is 2.06 TFLOP, 2.09 ms at 989
TFLOP/s: so at B = 32 the scan's bound is its operations, and at B = 8
(80 tokens, 0.52 ms) its bytes.
"""

from benchmark.work import peaks


def ops(shapes: dict) -> float:
    return 2.0 * shapes["q_tokens"] * shapes["n"] * shapes["lt"] * shapes["h"]


def nbytes(shapes: dict) -> float:
    return float(shapes["n"] * shapes["lt"] * shapes["h"] * shapes["tier_bytes"])


def least_seconds(shapes: dict):
    rate = peaks.INT8_OPS if shapes["tier_bytes"] == 1 else peaks.BF16_FLOPS
    return peaks.least_seconds(ops(shapes), nbytes(shapes), rate)
