"""maxsim_scan_roofline (%, device trace): the least time of the MaxSim
scan's work (``benchmark/work/maxsim.py``) over the device-busy time
inside the staged pass's ``scan`` spans (the kernel, the bounds, the
float64 rescore and any fallback), summed over the staged batches."""

from benchmark.work import maxsim


def read(ctx):
    st = ctx.staged
    dev = (st or {}).get("device", {}).get("scan")
    if not ctx.on_device or not dev or sum(dev) <= 0 or "q_tokens" not in st["shapes"][0]:
        return None
    least = sum(maxsim.least_seconds(s)[0] for s in st["shapes"])
    return 100.0 * least / sum(dev)
