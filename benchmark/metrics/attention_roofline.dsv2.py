"""attention_roofline.dsv2 (%, device trace): the least time of
DeepSeek-V2-Lite's attention sublayers (``benchmark/work/deepseek_v2.py``:
the q, kv_a, kv_b and o products of the real tokens plus 2·L²·16·(192+128)
per sequence of L real tokens, against the four matrices read once) over
the device-busy time inside the staged pass's ``attention`` spans, summed
over the staged batches."""

from benchmark.work import deepseek_v2


def read(ctx):
    st = ctx.staged
    dev = (st or {}).get("device", {}).get("attention")
    if not ctx.on_device or not dev or sum(dev) <= 0 or "lengths" not in st["shapes"][0]:
        return None
    least = sum(deepseek_v2.attention_least_seconds(s, ctx.cell.config) for s in st["shapes"])
    return 100.0 * least / sum(dev)
