"""step_mfu.dsv2 (%, host clock with counted work): the measured window's
DeepSeek-V2-Lite forward and dense-scan operations over its seconds,
against bf16's 989 TFLOP/s. A batch's operations are the model's at its
real lengths (``work/deepseek_v2.py``) and K1's (``work/dense.py``), from
the staged pass's shapes: their mean over its batches times the window's
batches."""

from benchmark.work import deepseek_v2, dense, peaks


def read(ctx):
    st, w = ctx.staged, ctx.window
    if not ctx.on_device or not st or not st["shapes"] or "lengths" not in st["shapes"][0] or not w.batches:
        return None
    per_batch = [deepseek_v2.model_flops(s["lengths"], ctx.cell.config) + dense.ops(s) for s in st["shapes"]]
    return 100.0 * sum(per_batch) / len(per_batch) * len(w.batches) / w.seconds / peaks.BF16_FLOPS
