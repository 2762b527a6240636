"""Readings that more than one metric takes, each in the cells its
metric lists (``benchmark/metrics/<metric>.py`` names which)."""

import numpy as np

from benchmark.work import dense, encoder, maxsim, peaks


def queries_per_s(ctx):
    """Every query answered in the measured window over the window's
    seconds (first call to last return)."""
    w = ctx.window
    return w.queries / w.seconds if w.batches else None


def batch_p95_ms(ctx):
    """The 95th percentile over every batch of the measured window, each
    timed from the call to its results on the host (numpy's linear
    interpolation between order statistics)."""
    lat = ctx.window.latencies
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None


def encode_ms(ctx):
    """Host milliseconds of the query encoder per batch in the staged pass
    (tokenize, forward, results on the host), each span synchronized at
    its end."""
    spans = (ctx.staged or {}).get("host", {}).get("encode")
    return 1e3 * sum(spans) / len(spans) if spans else None


def device_idle(ctx):
    """The share of the traced window in which no device operation ran, in %."""
    t = ctx.trace
    if not ctx.on_device or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def step_mfu(ctx):
    """The measured window's model and scan operations over its seconds,
    against bf16's 989 TFLOP/s, in %. A batch's operations are the query
    encoder's (``work/encoder.py``) and the scan's (``work/maxsim.py`` or
    ``work/dense.py``), from the staged pass's shapes: their mean over its
    batches times the window's batches."""
    st, w = ctx.staged, ctx.window
    if not ctx.on_device or not st or not st["shapes"] or not w.batches:
        return None
    per_batch = []
    for s in st["shapes"]:
        scan = maxsim.ops(s) if "q_tokens" in s else dense.ops(s)
        per_batch.append(encoder.flops(s["enc_lengths"], ctx.cell.config) + scan)
    return 100.0 * sum(per_batch) / len(per_batch) * len(w.batches) / w.seconds / peaks.BF16_FLOPS
