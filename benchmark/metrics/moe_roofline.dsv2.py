"""moe_roofline.dsv2 (%, device trace): the least time of DeepSeek-V2-Lite's
MoE layers (``benchmark/work/deepseek_v2.py``: the router, the shared
experts and the routed experts' products at the real tokens each expert
computed, against every expert's weights read once) over the device-busy
time inside the staged pass's ``moe`` spans (norm, router, sort, the two
grouped products, combine, shared experts), summed over the staged
batches."""

from benchmark.work import deepseek_v2


def read(ctx):
    st = ctx.staged
    dev = (st or {}).get("device", {}).get("moe")
    if not ctx.on_device or not dev or sum(dev) <= 0 or "expert_tokens" not in st["shapes"][0]:
        return None
    least = sum(deepseek_v2.moe_least_seconds(s, ctx.cell.config) for s in st["shapes"])
    return 100.0 * least / sum(dev)
