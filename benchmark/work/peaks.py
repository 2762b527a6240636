"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W power limit). A card set below 700 W
runs slower under load, so shares are stated against these published
peaks with the card's limit beside them: ``nvidia-smi
--query-gpu=name,power.limit`` read "NVIDIA H100 80GB HBM3, 700.00 W" in
every chip call that set this benchmark's bounds.

- bf16 (and fp16) tensor cores: 989 TFLOP/s;
- int8 tensor cores: 1,979 TOP/s;
- HBM3: 3.35 TB/s.
"""

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float, op_rate: float = BF16_FLOPS):
    """The least time the card could take for work of ``ops`` operations
    that must read or write ``nbytes``: the larger of the two bounds →
    (seconds, "operations" or "bytes")."""
    t_ops, t_bytes = ops / op_rate, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
